"""The SSD scan kernel's source, run on the CPU against its plain version
through the g++ stand-in (``tests/_torch_emulation.py``): output and final
state in both designs, the plain-order recompute built through each of
its paths, and the design, workspace and heads-a-block choices against the
wrapper's.
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_emulation import _build_emulated
from repro_torch.kernels.ssd_scan import (ssd_design, ssd_scan_plain,
                                          ssd_workspace_elements)


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
