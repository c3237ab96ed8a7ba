"""The CUDA kernel's own source, run on the CPU against its plain version.

A CUDA kernel has no interpret mode, and a machine without a GPU usually
has no ``nvcc``.  So the kernel's C++ is compiled with the host compiler
against a small stand-in for the CUDA builtins it uses: every CUDA thread
of a block becomes a ``std::thread``, warp shuffles and ``__syncthreads``
become barriers, and blocks run one after another.  The library keeps the
kernel's C entry point, which is called with CPU tensors exactly as the
wrapper calls it on the card.  Shared memory starts as NaN, so a read of
an unwritten slot shows.

This holds the kernel's indexing, masking, online softmax and merge to
the plain version before it ever runs on a GPU.  It says nothing of what ``nvcc``
accepts, of timing, or of the memory model (the stand-in is sequentially
consistent).  Skips where no C++20 compiler is found.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels.build import CSRC
from repro_torch.kernels.paged_attention import paged_attention_plain

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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
#define __launch_bounds__(x)
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
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
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 blockIdx, threadIdx, blockDim;
struct EmuWarp { std::barrier<> bar{32}; float vals[32]; };
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

# the two CUDA-only forms in the source, and what they become
_REWRITES = (
    (r"#include <cuda_bf16\.h>", '#include "cuda_standin.h"'),
    (r"#include <cuda_runtime\.h>", ""),
    (r"extern __shared__ (\w+) (\w+)\[\];",
     r"\1* \2 = reinterpret_cast<\1*>(emu_shared);"),
    (r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(",
     r"emu_launch(\2, \3, \4, \1, "),
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The paged-attention kernel source built for the CPU stand-in."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the emulated kernel")
    src = (CSRC / "paged_attention.cu").read_text()
    for pattern, repl in _REWRITES:
        src, n = re.subn(pattern, repl, src)
        assert n == 1, f"expected one {pattern!r} in the kernel source"
    out = tmp_path_factory.mktemp("emulated")
    (out / "cuda_standin.h").write_text(_CUDA_STANDIN)
    (out / "kernel.cpp").write_text(src)
    lib = out / "libkernel.so"
    r = subprocess.run([cxx, "-std=c++20", "-O0", "-shared", "-fPIC",
                        "-pthread", "-o", str(lib), str(out / "kernel.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "barrier" in r.stderr:
        pytest.skip(f"{cxx} lacks C++20 <barrier>")
    assert r.returncode == 0, r.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _problem(b, c, kv, g, hd, bs, n_pages, dtype, seed):
    """Ragged lanes on a random pool through a permutation page table: lane
    0 a full chunk ending exactly on a page edge, lane 1 idle, lane 2 a
    single decode row, the rest random."""
    rng = np.random.default_rng(seed)
    n_new = rng.integers(0, c + 1, size=b)
    n_new[0] = c
    n_new[1:3] = [0, 1][:b - 1]
    pos = [int(rng.integers(0, n_pages * bs - max(int(n), 1) + 1))
           for n in n_new]
    pos[0] = max(0, n_pages * bs - c)
    nb = b * n_pages + 3
    pt = rng.permutation(nb)[:b * n_pages].reshape(b, n_pages)
    rand = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32
                                   ).to(dtype)        # noqa: E731
    return (rand(b, c, kv, g, hd), rand(nb, bs, kv, hd), rand(nb, bs, kv, hd),
            torch.tensor(pt, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32),
            torch.tensor(n_new, dtype=torch.int32))


# (b, c, kv, g, hd, bs, n_pages): 16-byte and one-element chunks, 1, 2, 4
# and 8 lanes per key, pages wider than a warp, a GQA group of 7 over two
# row tiles, more than 48 KB of shared memory (head dim 256)
CASES = [(3, 3, 2, 2, 32, 4, 4), (3, 5, 1, 3, 256, 64, 3),
         (2, 2, 1, 7, 128, 16, 3), (3, 2, 1, 1, 36, 12, 3),
         (3, 3, 1, 2, 18, 5, 3), (3, 4, 2, 1, 80, 48, 2)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_plain(emulated, case, dtype):
    q, k, v, pt, pos, n_new = _problem(*case, dtype=dtype, seed=sum(case))
    b, c, kv, g, hd = q.shape
    out = torch.full_like(q, float("nan"))
    rc = emulated(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                  pos.data_ptr(), n_new.data_ptr(), out.data_ptr(), b, c, kv,
                  g, hd, k.shape[1], pt.shape[1], hd ** -0.5,
                  1 if dtype == torch.bfloat16 else 0, None)
    assert rc == 0
    want = paged_attention_plain(q, k, v, pt, pos, n_new)
    for lane, n in enumerate(n_new.tolist()):
        torch.testing.assert_close(out[lane, :n].float(),
                                   want[lane, :n].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        # rows past the lane's live rows are written, as zeros
        assert (out[lane, max(n, 1):] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_caps_n_new_at_chunk(emulated, dtype):
    """A lane that claims more fresh rows than the chunk holds is served as
    a full chunk, as the TPU kernel's block shape serves it: every row
    written, each equal to the plain version's."""
    q, k, v, pt, pos, n_new = _problem(3, 3, 2, 2, 32, 4, 4, dtype=dtype,
                                       seed=11)
    b, c, kv, g, hd = q.shape
    pos[:] = torch.tensor([0, 5, 9], dtype=torch.int32)
    n_new[:] = torch.tensor([c, c + 5, c + 2], dtype=torch.int32)
    out = torch.full_like(q, float("nan"))
    rc = emulated(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                  pos.data_ptr(), n_new.data_ptr(), out.data_ptr(), b, c, kv,
                  g, hd, k.shape[1], pt.shape[1], hd ** -0.5,
                  1 if dtype == torch.bfloat16 else 0, None)
    assert rc == 0
    want = paged_attention_plain(q, k, v, pt, pos, n_new)
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
