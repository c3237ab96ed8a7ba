"""The CUDA kernel's own source, run on the CPU against its plain version.

A CUDA kernel has no interpret mode, and a machine without a GPU usually
has no ``nvcc``.  So the kernel's C++ is compiled with the host compiler
against a small stand-in for the CUDA builtins it uses: every CUDA thread
of a block becomes a ``std::thread``, warp shuffles and ``__syncthreads``
become barriers, and blocks run one after another.  The library keeps the
kernel's C entry point, which is called with CPU tensors exactly as the
wrapper calls it on the card.  Shared memory starts as NaN, so a read of
an unwritten slot shows.

This holds each kernel's indexing, masking, online softmax and merge to
its plain version before it ever runs on a GPU: the paged-attention kernel,
the flash-attention kernel (output and log-sum-exp), the SSD scan kernel
(output and final state), the HH soma kernel (its grid-stride loop and
``_vtrap``'s limit) and the cable epoch kernel (every compartment count
the repo's configs use, spikes exact over 200 steps).  It says nothing of what ``nvcc``
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
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_design,
                                                 logsumexp_plain)
from repro_torch.kernels.hh_neuron import cable_epoch_plain, hh_step_plain
from repro_torch.neuro.cable import C_M, CellConfig, CellState, syn_decay
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_design, paged_splits,
                                                 paged_workspace_elements)
from repro_torch.kernels.ssd_scan import (ssd_design, ssd_scan_plain,
                                          ssd_workspace_elements)

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


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    """The paged-attention kernel source built for the CPU stand-in."""
    lib = _build_emulated("paged_attention", tmp_path_factory.mktemp(
        "emulated"))
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_design.argtypes = [ctypes.c_int] * 4
    lib.paged_attention_design.restype = ctypes.c_int
    for name in ("paged_attention_splits",
                 "paged_attention_workspace_floats"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 8
    lib.paged_attention_splits.restype = ctypes.c_int
    lib.paged_attention_workspace_floats.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def emulated(emulated_lib):
    return emulated_lib.paged_attention_launch


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


_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_DESIGNS = {0: "scalar", 1: "mma"}


def _launch_emulated(fn, q, k, v, pt, pos, n_new, all_rows=False):
    """The kernel's entry point on NaN-filled output and workspace (of
    ``paged_workspace_elements`` floats), as the wrapper calls it."""
    b, c, kv, g, hd = q.shape
    out = torch.full_like(q, float("nan"))
    n_ws = paged_workspace_elements(b, c, kv, g, hd, k.shape[1], pt.shape[1],
                                    q.dtype)
    ws = torch.full((n_ws,), float("nan")) if n_ws else None
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
            pos.data_ptr(), n_new.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, c, kv, g, hd,
            k.shape[1], pt.shape[1], hd ** -0.5, _CODES[q.dtype],
            int(all_rows), None)
    assert rc == 0
    return out


def _check_rows(out, args, tol):
    """Every lane's live rows against the plain version; every row past
    them written, as zeros."""
    want = paged_attention_plain(*args)
    c = out.shape[1]
    for lane, n in enumerate(args[5].tolist()):
        live = min(max(n, 1), c)
        torch.testing.assert_close(out[lane, :live].float(),
                                   want[lane, :live].float(), rtol=tol,
                                   atol=tol)
        assert (out[lane, live:] == 0).all()


# (b, c, kv, g, hd, bs, n_pages): 16-byte and one-element rows, pages of
# 4 to 64 keys, a GQA group of 7 over a chunk, head dim 256 (more than 48 KB
# of shared memory), and 70 rows a kv head at head dim 256 (two row groups
# of the scalar design); one split a lane in each
CASES = [(3, 3, 2, 2, 32, 4, 4), (3, 5, 1, 3, 256, 64, 3),
         (2, 2, 1, 7, 128, 16, 3), (3, 2, 1, 1, 36, 12, 3),
         (3, 3, 1, 2, 18, 5, 3), (3, 4, 2, 1, 80, 48, 2),
         (2, 10, 1, 7, 256, 4, 4)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_plain(emulated, case, dtype):
    args = _problem(*case, dtype=dtype, seed=sum(case))
    _check_rows(_launch_emulated(emulated, *args), args, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_caps_n_new_at_chunk(emulated, dtype):
    """A lane that claims more fresh rows than the chunk holds is served as
    a full chunk, as the TPU kernel's block shape serves it: every row
    written, each equal to the plain version's."""
    q, k, v, pt, pos, n_new = _problem(3, 3, 2, 2, 32, 4, 4, dtype=dtype,
                                       seed=11)
    c = q.shape[1]
    pos[:] = torch.tensor([0, 5, 9], dtype=torch.int32)
    n_new[:] = torch.tensor([c, c + 5, c + 2], dtype=torch.int32)
    out = _launch_emulated(emulated, q, k, v, pt, pos, n_new)
    want = paged_attention_plain(q, k, v, pt, pos, n_new)
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# Several splits a lane: (b, c, kv, g, hd, bs, n_pages, dtype, pos, n_new).
# Lane by lane: many live splits and the last partly live, an idle lane
# whose page 0 is all it reads (every other split wholly past its last
# page), a lane whose keys all fall in the first split, a chunk lane and a
# lane claiming more rows than the chunk.  The scalar design in f32 (one
# row, and a GQA chunk), the tensor-core design in bf16 at hd 64 and 128
# with a group of 7 (a decode row, C*G = 7, and a chunk, C*G = 21: two
# warps, key-parallel where a lane's live rows fit one warp's 16) and at hd
# 32 with C*G = 16; and the engine's GQA decode, a 16-row chunk of a group
# of 7 (seven warps): a decode lane key-parallel over four splits, a full
# chunk within split 0, an idle lane key-parallel within split 0.
SPLIT_CASES = [
    (4, 1, 2, 1, 32, 4, 8, torch.float32, [29, 3, 6, 18], [1, 0, 1, 1]),
    (3, 3, 1, 2, 48, 4, 40, torch.float32, [150, 2, 9], [3, 0, 5]),
    (3, 1, 1, 7, 64, 4, 32, torch.bfloat16, [127, 0, 30], [1, 0, 1]),
    (3, 3, 1, 7, 128, 4, 96, torch.bfloat16, [380, 1, 200], [3, 0, 2]),
    (3, 3, 1, 7, 64, 4, 96, torch.bfloat16, [300, 100, 7], [2, 9, 1]),
    (2, 4, 2, 4, 32, 8, 48, torch.bfloat16, [370, 10], [4, 1]),
    (3, 16, 1, 7, 32, 4, 700, torch.bfloat16, [2780, 5, 30], [1, 16, 0]),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])) + "-"
                         + str(c[7]).replace("torch.", ""))
def test_emulated_kernel_merges_splits(emulated_lib, case):
    """Pages split across blocks and merged in split order: each case's
    design and split count as the wrapper's mirrors name them, the live
    rows against the plain version, the rest zeros, and a second launch
    equal bit for bit."""
    *geom, dtype, pos, n_new = case
    b, c, kv, g, hd, bs, n_pages = geom
    want = "mma" if dtype == torch.bfloat16 else "scalar"
    assert paged_design(dtype, c, g, hd) == want
    assert _PAGED_DESIGNS[emulated_lib.paged_attention_design(
        _CODES[dtype], c, g, hd)] == want
    splits = paged_splits(b, c, kv, g, hd, bs, n_pages, dtype)
    assert splits >= 3
    args = list(_problem(b, c, kv, g, hd, bs, n_pages, dtype, seed=sum(geom)))
    args[4] = torch.tensor(pos, dtype=torch.int32)
    args[5] = torch.tensor(n_new, dtype=torch.int32)
    out = _launch_emulated(emulated_lib.paged_attention_launch, *args)
    _check_rows(out, args, TOL[dtype])
    again = _launch_emulated(emulated_lib.paged_attention_launch, *args)
    assert torch.equal(out, again)


# Every row computed (``all_rows``, the moe family's mode), as
# (b, c, kv, g, hd, bs, n_pages, dtype, pos, n_new): a decoding lane whose
# dead rows cross into the next page, a prefill tail, an idle lane, and a
# lane whose rows run past the table.  The scalar design (f32) and the
# tensor-core one (bf16 chunks, row-parallel), one split a lane and
# several, at the archs' moe geometries cut in kv heads.
ALL_ROWS_CASES = [
    (4, 4, 2, 2, 32, 4, 4, torch.float32, [2, 5, 0, 13], [1, 2, 0, 3]),
    (3, 16, 1, 2, 64, 4, 96, torch.float32, [250, 3, 90], [1, 0, 7]),
    (3, 16, 1, 8, 128, 16, 6, torch.bfloat16, [14, 30, 3], [1, 5, 0]),
    (3, 16, 1, 2, 64, 16, 64, torch.bfloat16, [900, 0, 500], [1, 0, 9]),
]


@pytest.mark.parametrize("case", ALL_ROWS_CASES,
                         ids=lambda c: "x".join(map(str, c[:7])) + "-"
                         + str(c[7]).replace("torch.", ""))
def test_emulated_all_rows_match_plain_on_every_row(emulated_lib, case):
    """With ``all_rows`` every row of every lane, dead rows and idle lanes
    included, equals the plain version's; without it the dead rows are
    zeros, which is what differs; a second launch is equal bit for bit."""
    *geom, dtype, pos, n_new = case
    b, c, kv, g, hd, bs, n_pages = geom
    args = list(_problem(b, c, kv, g, hd, bs, n_pages, dtype, seed=sum(geom)))
    args[4] = torch.tensor(pos, dtype=torch.int32)
    args[5] = torch.tensor(n_new, dtype=torch.int32)
    launch = emulated_lib.paged_attention_launch
    out = _launch_emulated(launch, *args, all_rows=True)
    torch.testing.assert_close(out.float(),
                               paged_attention_plain(*args).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(out, _launch_emulated(launch, *args, all_rows=True))
    _check_rows(_launch_emulated(launch, *args), args, TOL[dtype])


def test_emulated_design_and_splits_match_the_wrapper(emulated_lib):
    """The launcher's design, split count and workspace size (built from
    the kernel source) equal ``paged_design``, ``paged_splits`` and
    ``paged_workspace_elements`` over the archs' geometries and edges, and
    it refuses what it does not take."""
    design = emulated_lib.paged_attention_design
    for hd in (1, 16, 18, 32, 36, 64, 80, 96, 112, 128, 144, 256):
        for c, g in ((1, 1), (1, 3), (1, 4), (2, 2), (1, 7), (16, 1),
                     (16, 7), (64, 4)):
            for dtype in (torch.float32, torch.bfloat16):
                assert _PAGED_DESIGNS[design(_CODES[dtype], c, g, hd)] == \
                    paged_design(dtype, c, g, hd), (hd, c, g, dtype)
    for geom in ((4, 16, 32, 1, 128, 16, 64), (16, 1, 32, 1, 128, 16, 128),
                 (16, 1, 8, 7, 128, 16, 128), (16, 16, 8, 7, 128, 16, 128),
                 (1, 1, 1, 1, 64, 1, 70000), (2, 64, 2, 8, 256, 4, 9),
                 (3, 3, 2, 2, 32, 4, 4), (1, 2, 1, 1, 32, 64, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            code = _CODES[dtype]
            assert emulated_lib.paged_attention_splits(*geom, code) == \
                paged_splits(*geom, dtype), (geom, dtype)
            assert emulated_lib.paged_attention_workspace_floats(
                *geom, code) == paged_workspace_elements(*geom, dtype)
    for hd, code in ((0, 0), (257, 1), (64, 2)):
        assert design(code, 1, 1, hd) == -1
    assert emulated_lib.paged_attention_splits(1, 1, 1, 1, 32, 65, 4, 0) == -1


# ------------------------------------------------------------------ flash


@pytest.fixture(scope="module")
def emulated_flash_lib(tmp_path_factory):
    """The flash-attention kernel source built for the CPU stand-in."""
    lib = _build_emulated("flash_attention", tmp_path_factory.mktemp(
        "emulated_flash"))
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_design.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_design.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated_flash(emulated_flash_lib):
    return emulated_flash_lib.flash_attention_launch


_DESIGNS = {0: "scalar", 1: "mma"}

# (bh, s, d, causal): a tail S below a tile and one that is not a whole
# number of 32-key tiles, two query tiles, head dims that leave lanes
# without a chunk (20, 36) and the widest one.  f32 takes the scalar
# design throughout, bf16 at D 20 and 36 too; bf16 at D 32, 64 and 128
# takes the tensor-core design.
FLASH_CASES = [(2, 100, 32, True), (2, 100, 32, False), (1, 64, 128, True),
               (2, 45, 20, True), (1, 70, 36, False), (3, 33, 64, True)]
# bf16 cases for the tensor-core design alone: D 80 (the hybrid's), whole
# 64-key tiles (S 128), less than one key tile (S 45), and S 200: two
# 128-row query tiles and four key tiles, so the two-stage ring is reused
FLASH_MMA_CASES = [(1, 128, 80, True), (2, 45, 80, False),
                   (1, 128, 128, False), (2, 45, 128, True),
                   (1, 200, 32, True), (1, 200, 64, False)]


def _run_emulated_flash(lib, case, dtype):
    """Launch the emulated kernel on a seeded problem; hold output and
    log-sum-exp to the plain version (f32 2e-5, bf16 2e-2; the log-sum-exp
    is fp32 from the same inputs in both dtypes, so it is held at 2e-5
    relative).  Returns the design the launch took."""
    bh, s, d, causal = case
    code = 1 if dtype == torch.bfloat16 else 0
    rng = np.random.default_rng(sum(case[:3]) + causal)
    q, k, v = (torch.tensor(rng.standard_normal((bh, s, d)),
                            dtype=torch.float32).to(dtype) for _ in range(3))
    out = torch.full_like(q, float("nan"))
    lse = torch.full((bh, s), float("nan"))
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, s, d, d ** -0.5, int(causal), code, None)
    assert rc == 0
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, causal=causal).float(),
        rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, logsumexp_plain(q, k, causal=causal),
                               rtol=2e-5, atol=2e-5)
    design = _DESIGNS[lib.flash_attention_design(d, code)]
    assert design == flash_design(dtype, d)
    return design


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_flash_kernel_matches_plain(emulated_flash_lib, case,
                                             dtype):
    """Output and log-sum-exp against the plain version, through the
    design each case takes."""
    want = ("mma" if dtype == torch.bfloat16 and case[2] in (32, 64, 128)
            else "scalar")
    assert _run_emulated_flash(emulated_flash_lib, case, dtype) == want


@pytest.mark.parametrize("case", FLASH_MMA_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_flash_mma_design_matches_plain(emulated_flash_lib, case):
    """The tensor-core design (bf16) against the plain version."""
    assert _run_emulated_flash(emulated_flash_lib, case,
                               torch.bfloat16) == "mma"


def test_emulated_flash_design_matches_flash_design(emulated_flash_lib):
    """The launcher's choice of design (``flash_attention_design``, built
    from the kernel source) equals ``flash_design``'s on every head dim
    and dtype the kernel takes, and refuses what it does not take."""
    fn = emulated_flash_lib.flash_attention_design
    for d in range(4, 129, 4):
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            assert _DESIGNS[fn(d, code)] == flash_design(dtype, d), (d, code)
    for d, code in ((2, 1), (6, 0), (130, 1), (136, 0), (64, 2)):
        assert fn(d, code) == -1, (d, code)


def test_emulated_flash_kernel_refuses_bad_head_dims(emulated_flash):
    """Head dims the kernel does not take are refused before any launch
    (cudaErrorInvalidValue), never computed wrongly."""
    q = torch.zeros((1, 8, 136))
    for d in (2, 6, 130, 136):
        rc = emulated_flash(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                            q.data_ptr(), q.data_ptr(), 1, 8, d, 1.0, 1, 0,
                            None)
        assert rc != 0, d


_MMA_TILE = r"""
#include "cuda_standin.h"
// One warp: A [16][16], K [16][16] (key by d) and V [16][16] (key by d),
// bf16, staged in shared memory; S = A K^T and O = A V, [16][16] fp32,
// through the same ldmatrix addressing as the flash kernel.
void tile_kernel(const uint16_t* a, const uint16_t* kmat, const uint16_t* vmat,
                 float* s_out, float* o_out) {
  uint16_t* sm = static_cast<uint16_t*>(emu_shared);
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  if (lane == 0) {
    memcpy(sm, a, 512);
    memcpy(sm + 256, kmat, 512);
    memcpy(sm + 512, vmat, 512);
  }
  __syncthreads();
  uint32_t af[4], kb[4], vb[4];
  ldmatrix_x4(af, sm + 16 * (lane & 15) + 8 * (lane >> 4));
  ldmatrix_x4(kb, sm + 256 + 16 * (((lane >> 4) << 3) + (lane & 7))
                  + 8 * ((lane >> 3) & 1));
  ldmatrix_x4_trans(vb, sm + 512 + 16 * ((((lane >> 3) & 1) << 3) + (lane & 7))
                        + 8 * (lane >> 4));
  float s[2][4] = {}, o[2][4] = {};
  mma_bf16(s[0], af, kb[0], kb[1]);
  mma_bf16(s[1], af, kb[2], kb[3]);
  mma_bf16(o[0], af, vb[0], vb[1]);
  mma_bf16(o[1], af, vb[2], vb[3]);
  for (int n = 0; n < 2; ++n)
    for (int i = 0; i < 4; ++i) {
      const int idx = 16 * (g + 8 * (i / 2)) + 8 * n + 2 * t + i % 2;
      s_out[idx] = s[n][i];
      o_out[idx] = o[n][i];
    }
}
extern "C" void mma_tile(const uint16_t* a, const uint16_t* k, const uint16_t* v,
                         float* s, float* o) {
  emu_launch(dim3(1), 32, 1536, tile_kernel, a, k, v, s, o);
}
"""


def test_emulated_ldmatrix_and_mma_make_a_matmul(tmp_path):
    """The stand-in's ldmatrix (plain and .trans) and m16n8k16 mma, as the
    flash kernel addresses them, give A K^T and A V of one 16 x 16 tile:
    their fragment tables agree with a matrix product."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the emulated helpers")
    (tmp_path / "cuda_standin.h").write_text(_CUDA_STANDIN)
    (tmp_path / "tile.cpp").write_text(_MMA_TILE)
    lib = tmp_path / "libtile.so"
    r = subprocess.run([cxx, "-std=c++20", "-O0", "-shared", "-fPIC",
                        "-pthread", "-o", str(lib), str(tmp_path / "tile.cpp")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0 and "barrier" in r.stderr:
        pytest.skip(f"{cxx} lacks C++20 <barrier>")
    assert r.returncode == 0, r.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).mma_tile
    fn.argtypes = [ctypes.c_void_p] * 5
    rng = np.random.default_rng(16)
    a, k, v = (torch.tensor(rng.standard_normal((16, 16)),
                            dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    s_out, o_out = torch.full((16, 16), float("nan")), torch.full(
        (16, 16), float("nan"))
    fn(a.data_ptr(), k.data_ptr(), v.data_ptr(), s_out.data_ptr(),
       o_out.data_ptr())
    torch.testing.assert_close(s_out, torch.matmul(a.float(), k.float().T),
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(o_out, torch.matmul(a.float(), v.float()),
                               rtol=1e-6, atol=1e-5)


# -------------------------------------------------------------------- ssd


def _ssd_lib(tmp_path_factory, defines=()):
    lib = _build_emulated("ssd_scan", tmp_path_factory.mktemp("emulated_ssd"),
                          defines)
    lib.ssd_scan_launch.argtypes = ([ctypes.c_void_p] * 8
                                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_design.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_design.restype = ctypes.c_int
    lib.ssd_scan_heads_per_block.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_heads_per_block.restype = ctypes.c_int
    lib.ssd_scan_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan_workspace_floats.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def emulated_ssd_lib(tmp_path_factory):
    """The SSD scan kernel source built for the CPU stand-in."""
    return _ssd_lib(tmp_path_factory)


@pytest.fixture(scope="module")
def emulated_ssd(emulated_ssd_lib):
    return emulated_ssd_lib.ssd_scan_launch


def _ssd_launch(fn, x, dt, a, b_in, c_in, chunk, ws_floats=None):
    """Launch on NaN-filled outputs; the chunk-parallel design gets a
    NaN-filled workspace (``ssd_workspace_elements`` floats unless
    ``ws_floats`` says otherwise), the scalar design none."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2:]
    y = torch.full_like(x, float("nan"))
    fin = torch.full((bsz, h, p, n), float("nan"))
    ws = None
    if ssd_design(x.dtype, p, n, chunk) == "mma":
        if ws_floats is None:
            ws_floats = ssd_workspace_elements(bsz, s, h, p, n, chunk, g)
        ws = torch.full((ws_floats,), float("nan"))
    rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), fin.data_ptr(),
            None if ws is None else ws.data_ptr(), bsz, s, h, p, g, n, chunk,
            1 if x.dtype == torch.bfloat16 else 0, None)
    return rc, y, fin


def _ssd_problem(case, dtype):
    b, s, h, p, g, n, chunk = case
    rng = np.random.default_rng(sum(case))
    x = torch.tensor(rng.standard_normal((b, s, h, p)),
                     dtype=torch.float32).to(dtype)
    dt = torch.tensor(rng.uniform(0.001, 0.3, (b, s, h)), dtype=torch.float32)
    a = torch.tensor(-rng.uniform(0.1, 1.0, h), dtype=torch.float32)
    b_in, c_in = (torch.tensor(rng.standard_normal((b, s, g, n)),
                               dtype=torch.float32).to(dtype)
                  for _ in range(2))
    return x, dt, a, b_in, c_in


def _ssd_check(fn, case, dtype, ws_floats=None):
    """y and the final state against the plain version (the reference's
    2e-3; in bf16 y is held at one bf16 step plus 1e-3, both sides rounding
    one fp32 result once).  Returns y."""
    args = _ssd_problem(case, dtype)
    rc, y, fin = _ssd_launch(fn, *args, case[-1], ws_floats)
    assert rc == 0
    y_p, fin_p = ssd_scan_plain(*args, case[-1])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), y_p.float(), rtol=2 ** -7,
                                   atol=1e-3)
    else:
        torch.testing.assert_close(y, y_p, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(fin, fin_p, rtol=2e-3, atol=2e-3)
    return y


# (b, s, h, p, g, n, chunk): S = chunk and S = 4 x chunk, G 1 and 2, a
# chunk below one 32-row tile and one that is not a whole number of
# tiles, P and N that are not powers of two (24, 40, 20, 36) beside the
# archs' 32 and 64.  All take the scalar design but the last in bf16.
SSD_CASES = [(2, 64, 4, 32, 2, 16, 16), (1, 48, 2, 24, 1, 20, 48),
             (1, 160, 2, 40, 2, 36, 40), (2, 64, 2, 64, 1, 64, 64)]


@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_ssd_kernel_matches_plain(emulated_ssd, case, dtype):
    """y and the final state against the plain version."""
    _ssd_check(emulated_ssd, case, dtype)


# bf16 cases of the chunk-parallel design: mamba2's P 64 with N 128 and
# zamba2's N 64, chunks of 64 and 256, S = chunk and S = 2 and 4 x chunk, G 1
# and 2, two heads a group (so pass 3 shares one C B^T between them), and
# P 128 with N 48 (the other template, a half group of n columns)
SSD_MMA_CASES = [(1, 64, 4, 64, 2, 128, 64), (2, 256, 2, 64, 1, 64, 64),
                 (1, 256, 2, 64, 1, 128, 256), (1, 512, 4, 64, 2, 64, 256),
                 (1, 128, 2, 128, 1, 48, 64)]


@pytest.mark.parametrize("case", SSD_MMA_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_ssd_chunked_design_matches_plain(emulated_ssd_lib, case):
    """The chunk-parallel tensor-core design against the plain version, at
    the scalar design's band; each case's heads share C B^T in pairs."""
    b, s, h, p, g, n, chunk = case
    assert _SSD_DESIGNS[emulated_ssd_lib.ssd_scan_design(p, n, chunk, 1)] \
        == "mma"
    assert emulated_ssd_lib.ssd_scan_heads_per_block(b, s, h, g, chunk) == 2
    _ssd_check(emulated_ssd_lib.ssd_scan_launch, case, torch.bfloat16)


_SSD_DESIGNS = {0: "scalar", 1: "mma"}


def test_emulated_ssd_plain_order_recompute_matches_plain(tmp_path_factory):
    """The chunk-parallel design built to recompute every y value in the
    plain version's order (a flag scale that takes all of them), once with
    every value handed to pass 4 and once with every value recomputed by
    pass 3 itself: both at the band of the plain version, and equal bit
    for bit (two routes to the same sums).  Two chunks, so the inter-chunk
    sum is in it; two heads a group."""
    case = (1, 128, 4, 64, 2, 128, 64)
    b, s, h, p, g, n, chunk = case
    ys = []
    for cap in ("(16*(P))", "0"):
        lib = _ssd_lib(tmp_path_factory, ("SSD_FLAG_SCALE=1e30f",
                                          f"SSD_FIX_CAP(P)={cap}"))
        ys.append(_ssd_check(lib.ssd_scan_launch, case, torch.bfloat16,
                             lib.ssd_scan_workspace_floats(b, s, h, p, n,
                                                           chunk, g)))
    assert torch.equal(ys[0], ys[1])


def test_emulated_ssd_design_matches_ssd_design(emulated_ssd_lib):
    """The launcher's choice of design (``ssd_scan_design``, built from
    the kernel source) equals ``ssd_design``'s on every P, N, chunk and
    dtype tried, and refuses what the kernel does not take."""
    fn = emulated_ssd_lib.ssd_scan_design
    seen = set()
    for p in (8, 16, 24, 40, 48, 64, 80, 96, 112, 128):
        for n in (8, 16, 20, 32, 48, 64, 128):
            for chunk in (16, 32, 48, 64, 96, 128, 192, 256, 320, 512):
                for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
                    got = _SSD_DESIGNS[fn(p, n, chunk, code)]
                    assert got == ssd_design(dtype, p, n, chunk), (
                        p, n, chunk, code)
                    seen.add(got)
    assert seen == {"mma", "scalar"}
    for p, n, chunk, code in ((0, 16, 64, 1), (136, 16, 64, 1),
                              (64, 0, 64, 0), (64, 136, 64, 1),
                              (64, 64, 0, 1), (64, 64, 64, 2)):
        assert fn(p, n, chunk, code) == -1, (p, n, chunk, code)


def test_emulated_ssd_workspace_matches_ssd_workspace_elements(
        emulated_ssd_lib):
    """The workspace the wrapper allocates (``ssd_workspace_elements``) is
    the one the kernel source lays out, at the archs' calls and the
    emulated cases."""
    fn = emulated_ssd_lib.ssd_scan_workspace_floats
    for b, s, h, p, g, n, chunk in SSD_MMA_CASES + [
            (4, 2048, 80, 64, 1, 128, 256), (1, 512, 80, 64, 1, 64, 256)]:
        assert fn(b, s, h, p, n, chunk, g) == ssd_workspace_elements(
            b, s, h, p, n, chunk, g), (b, s, h, p, n, chunk, g)


def test_emulated_ssd_heads_per_block_fills_the_card(emulated_ssd_lib):
    """Pass 3's heads a block, from the kernel source: 8 at mamba2's
    training call (1,280 blocks), 2 at one request's 512-token prefill
    (320 blocks: E 4 would leave 160 on 132 SMs), 1 where a group has one
    head, and a refusal where the chunk does not divide S."""
    fn = emulated_ssd_lib.ssd_scan_heads_per_block
    assert fn(4, 2048, 80, 1, 256) == 8
    assert fn(1, 512, 80, 1, 256) == 2
    assert fn(1, 512, 2, 2, 256) == 1
    assert fn(1, 500, 80, 1, 256) == -1


def test_emulated_ssd_kernel_refuses_what_it_does_not_take(emulated_ssd):
    """A chunk that does not divide S, groups that do not divide the heads,
    P or N above 128, and the chunk-parallel design without its workspace
    are refused before any launch (cudaErrorInvalidValue), never computed
    wrongly."""
    z = torch.zeros(1 << 16)
    for s, h, p, g, n, chunk in ((48, 2, 8, 1, 8, 32), (32, 3, 8, 2, 8, 16),
                                 (32, 2, 136, 1, 8, 16),
                                 (32, 2, 8, 1, 136, 16)):
        rc = emulated_ssd(*[z.data_ptr()] * 8, 1, s, h, p, g, n, chunk, 0,
                          None)
        assert rc != 0, (s, h, p, g, n, chunk)
    assert emulated_ssd(*[z.data_ptr()] * 7, None, 1, 64, 2, 16, 1, 16, 64,
                        1, None) != 0


# ---------------------------------------------------------------------- hh


@pytest.fixture(scope="module")
def emulated_hh_lib(tmp_path_factory):
    """The HH source (both kernels) built for the CPU stand-in."""
    return _build_emulated("hh_neuron", tmp_path_factory.mktemp(
        "emulated_hh"))


@pytest.fixture(scope="module")
def emulated_hh(emulated_hh_lib):
    fn = emulated_hh_lib.hh_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _hh_launch(fn, args, dt, max_blocks):
    outs = [torch.full_like(args[0], float("nan")) for _ in range(4)]
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), args[0].numel(), dt,
            max_blocks, None)
    return rc, outs


# (cells, max_blocks): one cell, a tail below one 256-thread block, N not
# a multiple of the block over a full grid, and grids cut to 1 and 2
# blocks so the grid-stride loop walks 3 and 4 times
HH_CASES = [(1, 0), (37, 0), (700, 0), (700, 1), (1800, 2)]


@pytest.mark.parametrize("case", HH_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dt", [0.0125, 0.025])
def test_emulated_hh_kernel_matches_plain(emulated_hh, case, dt):
    """Every cell written, each within the reference's 3e-5 of the plain
    version, on tests/test_kernels.py's input distributions."""
    cells, max_blocks = case
    rng = np.random.default_rng(cells + max_blocks)
    args = [torch.tensor(rng.uniform(lo, hi, cells), dtype=torch.float32)
            for lo, hi in ((-90, 30), (0, 1), (0, 1), (0, 1), (0, 8),
                           (-20, 20), (0, 10))]
    rc, outs = _hh_launch(emulated_hh, args, dt, max_blocks)
    assert rc == 0
    for got, want in zip(outs, hh_step_plain(*args, dt=dt)):
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_emulated_hh_kernel_at_the_vtrap_limits(emulated_hh):
    """v exactly -40 and -55, where ``_vtrap``'s quotient is 0/0: the
    kernel takes the limit, finite and equal to the plain version."""
    rng = np.random.default_rng(4)
    v = torch.tensor([-40.0, -55.0] * 150, dtype=torch.float32)
    args = [v] + [torch.tensor(rng.uniform(lo, hi, 300), dtype=torch.float32)
                  for lo, hi in ((0, 1), (0, 1), (0, 1), (0, 8), (-20, 20),
                                 (0, 10))]
    rc, outs = _hh_launch(emulated_hh, args, 0.025, 0)
    assert rc == 0
    for got, want in zip(outs, hh_step_plain(*args, dt=0.025)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_emulated_hh_kernel_refuses_no_cells(emulated_hh):
    z = torch.zeros(4)
    assert emulated_hh(*[z.data_ptr()] * 11, 0, 0.025, 0, None) != 0


# ------------------------------------------------------------- cable epoch


@pytest.fixture(scope="module")
def emulated_epoch(emulated_hh_lib):
    fn = emulated_hh_lib.cable_epoch_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _epoch_launch(fn, state, cfg, incoming, i_stim, stim_left, max_blocks,
                  compartments=None):
    """The C entry point called as ``cable_epoch_cuda`` calls it, on CPU
    tensors; outputs start as NaN (spiked as 2) so an unwritten one
    shows."""
    outs = [torch.full_like(t, float("nan")) for t in state]
    spiked = torch.full(incoming.shape, 2, dtype=torch.uint8)
    cells, comps = state.v.shape
    rc = fn(*(t.data_ptr() for t in (*state, incoming, i_stim, *outs,
                                     spiked)),
            cells, comps if compartments is None else compartments,
            incoming.shape[0], stim_left, cfg.dt, cfg.dt / C_M, cfg.g_axial,
            cfg.g_pas, cfg.e_pas, syn_decay(cfg), cfg.syn_weight, max_blocks,
            None)
    return rc, CellState(*outs), spiked


def _epoch_problem(cells, comps, steps, seed):
    """A state away from rest, incoming spikes at 2% of (step, cell), and
    the stimulus into every third cell, cut halfway through the epoch."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    state = CellState(f32(rng.uniform(-75, -50, (cells, comps))),
                      f32(rng.uniform(0.02, 0.1, cells)),
                      f32(rng.uniform(0.5, 0.7, cells)),
                      f32(rng.uniform(0.3, 0.4, cells)),
                      f32(rng.uniform(0, 2, cells)))
    incoming = f32(rng.uniform(size=(steps, cells)) < 0.02)
    i_stim = f32(rng.uniform(10, 25, cells) * (np.arange(cells) % 3 == 0))
    return state, incoming, i_stim, (steps + 1) // 2


# (cells, compartments, max_blocks) with 128-thread blocks: one cell, a
# tail below one block, a ragged tail over a full grid (300 = 2 x 128 +
# 44), and a grid cut to one block so the grid-stride loop walks 3 times
EPOCH_CASES = [(1, 2, 0), (37, 4, 0), (300, 8, 0), (300, 32, 1),
               (130, 32, 0)]
# The soma's exp comes from the C library here and from PyTorch's
# vectorised exp in the plain version (a few ulp apart), and the plain
# version may raise n to the 4th through pow: after one step the state
# agrees to the soma's 3e-5; over 200 steps an ulp is amplified through
# the spike's upstroke, so the state is held to the ring runs' 1e-3 mV.
EPOCH_TOL = {1: 3e-5, 200: 1e-3}


@pytest.mark.parametrize("steps", [1, 200])
@pytest.mark.parametrize("case", EPOCH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_cable_epoch_matches_plain(emulated_epoch, case, steps):
    """Every cell and step written; the same cells spike at every step as
    in the plain version, the final state within ``EPOCH_TOL``."""
    cells, comps, max_blocks = case
    cfg = CellConfig(n_compartments=comps)
    state, incoming, i_stim, stim_left = _epoch_problem(
        cells, comps, steps, seed=cells * comps + steps)
    rc, got, spiked = _epoch_launch(emulated_epoch, state, cfg, incoming,
                                    i_stim, stim_left, max_blocks)
    assert rc == 0
    want, want_spiked = cable_epoch_plain(state, cfg, incoming, i_stim,
                                          stim_left)
    assert int(spiked.max()) <= 1
    assert torch.equal(spiked.bool(), want_spiked)
    if steps == 200:
        assert bool(want_spiked.any())     # the case reaches a spike
    for name, a, b in zip(CellState._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=EPOCH_TOL[steps],
                                   msg=name)


def test_emulated_cable_epoch_refuses_what_it_does_not_take(emulated_epoch):
    """Compartment counts without an instantiation, no steps, no cells."""
    cfg = CellConfig(n_compartments=4)
    state, incoming, i_stim, _ = _epoch_problem(8, 4, 3, seed=1)
    for comps in (1, 3, 5, 128):
        rc, _, _ = _epoch_launch(emulated_epoch, state, cfg, incoming,
                                 i_stim, 0, 0, compartments=comps)
        assert rc != 0, comps
    rc, _, _ = _epoch_launch(emulated_epoch, state, cfg, incoming[:0],
                             i_stim, 0, 0)
    assert rc != 0
    empty = CellState(*(t[:0] for t in state))
    rc, _, _ = _epoch_launch(emulated_epoch, empty, cfg, incoming[:, :0],
                             i_stim[:0], 0, 0)
    assert rc != 0
