"""The flash-attention kernel's source, run on the CPU against its plain
version through the g++ stand-in (``tests/_torch_emulation.py``): output
and log-sum-exp in both designs, the design choice against
``flash_design``, its refusals, and the stand-in's own PTX helpers
(``ldmatrix``, ``mma_bf16``) making a matmul.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_emulation import TOL, _CUDA_STANDIN, _build_emulated
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_design,
                                                 logsumexp_plain)


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
