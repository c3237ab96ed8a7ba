"""The paged-attention kernel's source, run on the CPU against its plain
version through the g++ stand-in (``tests/_torch_emulation.py``): ragged
lanes through a permutation page table, ``n_new`` capped at the chunk,
pages split across blocks and merged in split order, the every-row mode
(``all_rows``), and the design and split choice against the wrapper's.
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_emulation import TOL, _CODES, _build_emulated
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_design, paged_splits,
                                                 paged_workspace_elements)


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
