"""The g++ stand-in for the CUDA builtins, shared by the emulation tests.

A CUDA kernel has no interpret mode, and a machine without a GPU usually
has no ``nvcc``.  So a kernel's C++ is compiled with the host compiler
against a small stand-in for the CUDA builtins it uses: every CUDA thread
of a block becomes a ``std::thread``, warp shuffles and ``__syncthreads``
become barriers, and blocks run one after another.  The library keeps the
kernel's C entry point, which is called with CPU tensors exactly as the
wrapper calls it on the card.  Shared memory starts as NaN, so a read of
an unwritten slot shows.

The tests that use it, one file a kernel source
(``tests/test_torch_kernel_emulation_{paged,flash,ssd,hh}.py``), hold each
kernel's indexing, masking, online softmax and merge to its plain version
before it ever runs on a GPU.  The stand-in says nothing of what ``nvcc``
accepts, of timing, or of the memory model (it is sequentially
consistent).  ``_build_emulated`` skips where no C++20 compiler is found.
"""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels.build import CSRC

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the dtype codes of the kernels' C entry points
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_CUDA_STANDIN = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __uint_as_float(unsigned x) { float f; memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; memcpy(&x, &f, 4); return x; }
struct __nv_bfloat16 { unsigned short v; };
inline float __bfloat162float(__nv_bfloat16 x) {
  return __uint_as_float((unsigned)x.v << 16);
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  if (std::isnan(f)) return {(unsigned short)0x7fc0};
  const unsigned u = __float_as_uint(f);
  return {(unsigned short)((u + 0x7fff + ((u >> 16) & 1)) >> 16)};
}
inline float expf(float x) { return std::exp(x); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;
struct EmuWarp {
  std::barrier<> bar{32};
  float vals[32];
  const void* rows[32];
  uint32_t regs[32][6];
};
thread_local EmuWarp* emu_warp;
thread_local int emu_lane;
thread_local std::barrier<>* emu_block;
thread_local void* emu_shared;
inline float emu_shfl(float v, int src) {
  emu_warp->vals[emu_lane] = v;
  emu_warp->bar.arrive_and_wait();
  const float r = emu_warp->vals[src & 31];
  emu_warp->bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) { return emu_shfl(v, emu_lane ^ o); }
inline float __shfl_sync(unsigned, float v, int src) { return emu_shfl(v, src); }
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar.arrive_and_wait(); }
// The kernels' PTX helpers (flash_attention.cu defines them for nvcc only).
// cp.async is a plain copy, its groups complete at once.
inline void cp_async_16(void* dst, const void* src, bool valid) {
  if (valid) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).v | (uint32_t)__float2bfloat16(hi).v << 16;
}
inline float emu_half(uint32_t reg, int h) {  // bf16 h of a bf16x2, as float
  return __uint_as_float(h ? reg & 0xffff0000u : reg << 16);
}
// ldmatrix .x4 as the PTX ISA tabulates it: lane i publishes the address
// of row i % 8 of matrix i / 8; register m of lane (g, t) = (lane / 4,
// lane % 4) takes row g, columns 2t and 2t + 1 of matrix m (with .trans,
// rows 2t and 2t + 1 of column g), the lower column (row) in the low half.
inline void emu_ldmatrix(uint32_t (&r)[4], const void* row, bool trans) {
  emu_warp->rows[emu_lane] = row;
  emu_warp->bar.arrive_and_wait();
  const int g = emu_lane / 4, t = emu_lane % 4;
  for (int m = 0; m < 4; ++m) {
    uint16_t e[2];
    for (int h = 0; h < 2; ++h) {
      const int i = trans ? 2 * t + h : g, j = trans ? g : 2 * t + h;
      memcpy(&e[h], static_cast<const char*>(emu_warp->rows[8 * m + i]) + 2 * j, 2);
    }
    r[m] = e[0] | (uint32_t)e[1] << 16;
  }
  emu_warp->bar.arrive_and_wait();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) { emu_ldmatrix(r, row, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) { emu_ldmatrix(r, row, true); }
// mma.sync m16n8k16 .row.col bf16 -> f32 by the PTX ISA's fragment tables:
// A(row, k) is half k % 2 of register row / 8 + 2 (k / 8) of lane
// 4 (row % 8) + (k % 8) / 2; B(k, n) half k % 2 of register k / 8 of lane
// 4 n + (k % 8) / 2; D (and C) value i of lane (g, t) is (g + 8 (i / 2),
// 2t + i % 2).  Products and sums in fp32.
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint32_t* mine = emu_warp->regs[emu_lane];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  emu_warp->bar.arrive_and_wait();
  const int g = emu_lane / 4, t = emu_lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) {
      const float av = emu_half(emu_warp->regs[4 * (row % 8) + (k % 8) / 2][row / 8 + 2 * (k / 8)], k % 2);
      const float bv = emu_half(emu_warp->regs[4 * col + (k % 8) / 2][4 + k / 8], k % 2);
      acc += av * bv;
    }
    d[i] += acc;
  }
  emu_warp->bar.arrive_and_wait();
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class K, class... A>
void emu_launch(dim3 grid, int threads, size_t smem, K kernel, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<float> shared(smem / 4 + 16, NAN);
      std::barrier<> block(threads);
      std::vector<std::unique_ptr<EmuWarp>> warps;
      for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new EmuWarp);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          blockIdx = dim3(bx, by, 0);
          threadIdx = dim3(t, 0, 0);
          blockDim = dim3(threads, 1, 1);
          gridDim = grid;
          emu_warp = warps[t / 32].get();
          emu_lane = t % 32;
          emu_block = &block;
          emu_shared = shared.data();
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
"""

# the CUDA-only forms in the source, what they become, and whether every
# kernel has one (a kernel without shared memory or bf16 has neither)
_REWRITES = (
    (r"#include <cuda_runtime\.h>", '#include "cuda_standin.h"', True),
    (r"#include <cuda_bf16\.h>", "", False),
    (r"extern __shared__ (\w+) (\w+)\[\];",
     r"\1* \2 = reinterpret_cast<\1*>(emu_shared);", False),
    (r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(",
     r"emu_launch(\2, \3, \4, \1, ", True),
)


def _build_emulated(name, out, defines=()):
    """Compile ``csrc/<name>.cu`` against the stand-in (with ``-D`` of each
    of ``defines``); returns the library, or skips where no C++20 compiler
    is found."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the emulated kernel")
    src = (CSRC / f"{name}.cu").read_text()
    for pattern, repl, required in _REWRITES:
        src, n = re.subn(pattern, repl, src)
        assert n == 1 or (n == 0 and not required), (
            f"expected one {pattern!r} in the kernel source, found {n}")
    (out / "cuda_standin.h").write_text(_CUDA_STANDIN)
    (out / "kernel.cpp").write_text(src)
    lib = out / "libkernel.so"
    r = subprocess.run([cxx, "-std=c++20", "-O0", "-shared", "-fPIC",
                        "-pthread", *(f"-D{d}" for d in defines), "-o",
                        str(lib), str(out / "kernel.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "barrier" in r.stderr:
        pytest.skip(f"{cxx} lacks C++20 <barrier>")
    assert r.returncode == 0, r.stderr[-4000:]
    return ctypes.CDLL(str(lib))
