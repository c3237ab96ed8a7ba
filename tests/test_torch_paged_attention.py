"""The port's paged attention against the JAX reference, and its CUDA
kernel against its plain version.

* ``paged_attention_plain`` against both reference functions —
  ``paged_attention_ref`` and the Pallas kernel in interpret mode — over
  the sweep of ``tests/test_paged_attention.py``: kv heads {1, 2}, GQA
  group {1, 2, 4}, page size {4, 8, 16}, chunk 1-4, ragged and idle lanes,
  a single token, an exactly full last page, every tail length, finite
  masked rows (f32 2e-5, bf16 2e-2, on each lane's valid rows).
* ``paged_chunk_decode_attention`` against the reference's, including the
  masked write through the page table and the shared-prefix no-write
  guarantee.
* The CUDA kernel against the plain version on the card (``cuda`` marker;
  skips without a GPU), its live rows and, in the every-row mode, every
  row; and the wrapper's argument checks, which run here.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain,
                                                 paged_design, paged_splits)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 on the card: ||kernel - plain|| / ||plain|| over a call's live rows
# (both round one fp32 result to bf16; a wrong mask or merge weight reads
# well above it)
REL_TOL = 1e-3


def _case(b, c, kv, g, hd, bs, n_pages, num_blocks, pos, n_new, seed=0):
    """One problem as numpy: random pool, a random *permutation* page table
    (physical order never equals logical order), per-lane pos/n_new."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, kv, g, hd)).astype(np.float32)
    kp = rng.standard_normal((num_blocks, bs, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((num_blocks, bs, kv, hd)).astype(np.float32)
    pt = rng.permutation(num_blocks)[:b * n_pages].reshape(b, n_pages)
    return (q, kp, vp, pt.astype(np.int32), np.asarray(pos, np.int32),
            np.asarray(n_new, np.int32))


def _torch(case, dtype="float32", device="cpu"):
    q, kp, vp, pt, pos, nn = case
    dt = getattr(torch, dtype)
    return (torch.tensor(q).to(dt).to(device), torch.tensor(kp).to(dt).to(device),
            torch.tensor(vp).to(dt).to(device), torch.tensor(pt).to(device),
            torch.tensor(pos).to(device), torch.tensor(nn).to(device))


def _assert_valid_rows(got, want, n_new, tol):
    for lane, n in enumerate(np.asarray(n_new).tolist()):
        np.testing.assert_allclose(np.asarray(got, np.float32)[lane, :n],
                                   np.asarray(want, np.float32)[lane, :n],
                                   rtol=tol, atol=tol, err_msg=f"lane {lane}")


@functools.lru_cache(maxsize=None)
def _reference_fns():
    """The reference's jnp oracle (jitted: one compile per shape instead of
    one per op) and its Pallas kernel."""
    import jax
    from repro.kernels.paged_attention import (paged_attention_pallas,
                                               paged_attention_ref)
    return jax.jit(paged_attention_ref), paged_attention_pallas


def _against_reference(case, dtype="float32", pallas=True):
    """Port plain vs ``paged_attention_ref`` (and the Pallas kernel in
    interpret mode) on every lane's valid rows."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    paged_attention_ref, paged_attention_pallas = _reference_fns()
    args = _torch(case, dtype)
    got = paged_attention_plain(*args).float().numpy()
    jdt = getattr(jnp, dtype)
    q, kp, vp, pt, pos, nn = case
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(nn))
    _assert_valid_rows(got, paged_attention_ref(*jargs), nn, TOL[dtype])
    if pallas:
        _assert_valid_rows(
            got, paged_attention_pallas(*jargs, interpret=True), nn,
            TOL[dtype])
    assert np.isfinite(got).all()
    return got


def _sweep_states(kv, g, bs, seed):
    """Random ragged lane states (idle lanes allowed) for C = 1..4."""
    rng = np.random.default_rng(seed)
    b, n_pages = 2, 4
    for c in range(1, 5):
        n_new = rng.integers(0, c + 1, size=b)
        pos = [int(rng.integers(0, n_pages * bs - max(int(n), 1) + 1))
               for n in n_new]
        yield c, _case(b, c, kv, g, 32, bs, n_pages, 3 * n_pages, pos, n_new,
                       seed=seed + c)


# ----------------------------------------------------------- property sweep


@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kv", [1, 2])
def test_plain_matches_reference_sweep(kv, g, bs):
    """Head counts x GQA ratios x page sizes, chunk 1-4, random ragged
    (pos, n_new) states with idle lanes.  The Pallas kernel (interpret
    mode) is held on the widest chunk; the jnp reference on every one."""
    for c, case in _sweep_states(kv, g, bs, seed=100 * kv + 10 * g + bs):
        _against_reference(case, pallas=(c == 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtype_sweep(dtype):
    case = _case(2, 4, 2, 2, 32, 8, 4, 12, pos=[13, 27], n_new=[4, 1], seed=7)
    _against_reference(case, dtype)


# -------------------------------------------------------------------- edges


def test_single_token_sequence():
    """pos=0, n_new=1: one valid row; softmax over one key is 1, so the
    output equals the V row the table maps."""
    case = _case(2, 4, 2, 2, 32, 8, 4, 8, pos=[0, 0], n_new=[1, 1], seed=3)
    got = _against_reference(case)
    _, _, vp, pt, _, _ = case
    for b in range(2):
        want = vp[pt[b, 0], 0]                               # [kv, hd]
        np.testing.assert_allclose(got[b, 0], np.repeat(
            want[:, None], got.shape[3], axis=1), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("total_pages", [1, 2, 4])
def test_exactly_full_last_page(total_pages):
    """pos + n_new ending exactly on a page edge must not read the
    following (unallocated) page."""
    bs = 8
    pos = total_pages * bs - 2
    _against_reference(_case(2, 2, 2, 2, 32, bs, 4, 12, pos=[pos, pos],
                             n_new=[2, 2], seed=11 + total_pages))


def test_ragged_last_page_lengths():
    """Every tail length of the last page, one by one."""
    bs = 8
    for tail in range(1, bs + 1):
        pos = bs + tail - 1
        _against_reference(_case(2, 1, 2, 2, 32, bs, 4, 12, pos=[pos, pos],
                                 n_new=[1, 1], seed=100 + tail),
                           pallas=tail in (1, bs))


def test_masked_rows_are_finite():
    """Idle lanes (n_new=0) and garbage chunk rows come out finite."""
    case = _case(2, 4, 2, 2, 32, 8, 4, 8, pos=[0, 5], n_new=[0, 2], seed=5)
    out = paged_attention_plain(*_torch(case))
    assert torch.isfinite(out).all()


def test_shared_pages_read_by_two_lanes():
    """Refcount-shared prefix pages attended by two lanes at once."""
    b, c, kv, g, hd, bs = 2, 2, 2, 2, 32, 8
    rng = np.random.default_rng(21)
    case = (rng.standard_normal((b, c, kv, g, hd)).astype(np.float32),
            rng.standard_normal((10, bs, kv, hd)).astype(np.float32),
            rng.standard_normal((10, bs, kv, hd)).astype(np.float32),
            np.array([[4, 7, 1, 2], [4, 7, 5, 6]], np.int32),
            np.array([2 * bs + 3, 3 * bs + 1], np.int32),
            np.array([2, 1], np.int32))
    _against_reference(case)


# --------------------------------------------------------------- dispatch


def test_ops_dispatch_cpu_takes_plain_and_counts_nothing():
    """A CPU tensor takes the plain version; the launch counter counts
    kernel launches only."""
    ops.reset_launches()
    case = _case(2, 3, 2, 2, 32, 8, 4, 12, pos=[3, 9], n_new=[3, 1], seed=8)
    args = _torch(case)
    assert torch.equal(ops.paged_attention(*args),
                       paged_attention_plain(*args))
    assert ops.LAUNCHES == {"paged_attention": 0, "flash_attention": 0,
                            "ssd_scan": 0, "hh_step": 0, "cable_epoch": 0}


_BAD_ARGS = {
    # name: (argument index, replacement from the good args, message)
    "cpu": (None, None, "CUDA device"),
    "dtype": (0, lambda a: a[0].half(), "dtype"),
    "pool_dtype": (1, lambda a: a[1].bfloat16(), "pool dtypes"),
    "index_dtype": (3, lambda a: a[3].long(), "int32"),
    "lanes": (4, lambda a: a[4][:1], r"pos/n_new"),
    "contiguous": (1, lambda a: a[1].transpose(0, 1).contiguous()
                   .transpose(0, 1), "contiguous"),
    "head_dim": (0, lambda a: torch.zeros(2, 3, 2, 2, 300), "match q|head_dim"),
    "block": (1, lambda a: torch.zeros(2, 65, 2, 32), "v_pool|block_size"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_ARGS))
def test_cuda_wrapper_rejects_bad_arguments(bad):
    """The wrapper refuses what the kernel does not take, before any build
    or launch.  The layout checks come before the device check, so meta
    tensors (shapes and dtypes, no storage) exercise each of them here."""
    case = _case(2, 3, 2, 2, 32, 8, 4, 12, pos=[3, 9], n_new=[3, 1], seed=8)
    good = list(_torch(case))
    idx, make, msg = _BAD_ARGS[bad]
    args = good if idx is None else [
        make(good) if i == idx else a for i, a in enumerate(good)]
    if bad != "cpu":
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match=msg):
        paged_attention_cuda(*args)


def test_ops_dispatch_refuses_other_devices():
    case = _case(2, 3, 2, 2, 32, 8, 4, 12, pos=[3, 9], n_new=[3, 1], seed=8)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_attention(*[t.to("meta") for t in _torch(case)])


# -------------------------------------------------- the attention function


@pytest.fixture(scope="module")
def layer():
    """Reduced deepseek-7b layer-0 attention weights, both frameworks."""
    jax = pytest.importorskip("jax")
    from repro.configs import ALL_ARCHS, reduced
    from repro.models import build

    from repro_torch.configs import ALL_ARCHS as T_ARCHS
    from repro_torch.configs import reduced as t_reduced
    from repro_torch.models import params as TP
    cfg = reduced(ALL_ARCHS["deepseek-7b"])
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    p_j = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    p_t = TP.from_jax(jax.tree.map(np.asarray, p_j))
    return cfg, t_reduced(T_ARCHS["deepseek-7b"]), p_j, p_t


def _attention_both(layer, x, kp, vp, pt, pos, n_new):
    """Reference and port ``paged_chunk_decode_attention`` on the same
    bf16 inputs: (y_ref, k_ref, v_ref, y_port, k_port, v_port) as f32."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import paged_chunk_decode_attention

    ref_fn = jax.jit(paged_chunk_decode_attention, static_argnums=0)

    from repro_torch.models import params as TP
    from repro_torch.models.attention import paged_chunk_decode_attention
    cfg, tcfg, p_j, p_t = layer
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)          # noqa: E731
    y_j, k_j, v_j = ref_fn(cfg, p_j, bf(x), bf(kp), bf(vp), jnp.asarray(pt),
                           jnp.asarray(pos), jnp.asarray(n_new))
    t = TP.from_jax({"x": np.asarray(bf(x)), "k": np.asarray(bf(kp)),
                     "v": np.asarray(bf(vp))})
    y_t = paged_chunk_decode_attention(
        tcfg, p_t, t["x"], t["k"], t["v"], torch.tensor(pt),
        torch.tensor(pos), torch.tensor(n_new))
    f = lambda a: np.asarray(a.astype(jnp.float32))      # noqa: E731
    return (f(y_j), f(k_j), f(v_j), y_t.float().numpy(),
            t["k"].float().numpy(), t["v"].float().numpy())


def test_paged_chunk_attention_matches_reference(layer):
    """Ragged lanes: a prefill chunk, a decode lane, an idle lane, and a
    lane whose chunk runs past its table (those rows are dropped).  Same
    written rows, same attention output on valid rows."""
    cfg = layer[0]
    rng = np.random.default_rng(0)
    bs, c, nb = 8, 4, 12
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kp = rng.standard_normal((nb, bs, kv, hd))
    vp = rng.standard_normal((nb, bs, kv, hd))
    pt = np.array([[3, 5, 0], [7, 1, 0], [2, 0, 0], [9, 4, 6]], np.int32)
    pos = np.array([6, 9, 0, 22], np.int32)
    n_new = np.array([4, 1, 0, 4], np.int32)          # lane 3: rows 24+ drop
    x = rng.standard_normal((4, c, cfg.d_model))
    y_j, k_j, v_j, y_t, k_t, v_t = _attention_both(layer, x, kp, vp, pt, pos,
                                                   n_new)
    np.testing.assert_allclose(k_t, k_j, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-2, atol=2e-2)
    # exactly the rows the reference wrote changed, nothing else
    before = np.asarray(torch.tensor(kp).to(torch.bfloat16).float())
    assert ((k_t != before) == (k_j != before)).all()
    _assert_valid_rows(y_t, y_j, n_new, 2e-2)


def test_shared_prefix_pages_are_never_written(layer):
    """Two lanes sharing a refcounted prefix page write only their private
    pages; the shared page's bits stay identical."""
    cfg = layer[0]
    bs, c, nb = 8, 4, 6
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    kp = rng.standard_normal((nb, bs, kv, hd))
    vp = rng.standard_normal((nb, bs, kv, hd))
    pt = np.array([[0, 1, 0], [0, 2, 0]], np.int32)
    pos = np.array([bs, bs], np.int32)     # writes start past page 0
    n_new = np.array([c, c], np.int32)
    x = rng.standard_normal((2, c, cfg.d_model))
    before = np.asarray(torch.tensor(kp).to(torch.bfloat16).float())
    y_j, k_j, _, y_t, k_t, _ = _attention_both(layer, x, kp, vp, pt, pos,
                                               n_new)
    assert (k_t[0] == before[0]).all(), "shared prefix page was written"
    for page in (1, 2):
        assert not (k_t[page][:c] == before[page][:c]).all()
        assert (k_t[page][c:] == before[page][c:]).all()
    for untouched in (3, 4, 5):
        assert (k_t[untouched] == before[untouched]).all()
    np.testing.assert_allclose(k_t, k_j, rtol=2e-2, atol=2e-2)
    _assert_valid_rows(y_t, y_j, n_new, 2e-2)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _card_cases():
    """The sweep above, wide pages and head dims that are not multiples of
    32, and long lanes whose pages split across blocks (GQA chunks and
    decode rows)."""
    cases = []
    for kv in (1, 2):
        for g in (1, 2, 4):
            for bs in (4, 8, 16):
                cases += [case for _, case in
                          _sweep_states(kv, g, bs, seed=kv * g * bs)]
    for hd, bs in ((80, 16), (96, 32), (128, 64), (256, 16)):
        rng = np.random.default_rng(hd)
        n_new = rng.integers(0, 6, size=3)
        pos = [int(rng.integers(0, 4 * bs - max(int(n), 1) + 1))
               for n in n_new]
        cases.append(_case(3, 5, 2, 3, hd, bs, 4, 14, pos, n_new, seed=hd))
    for c, g, hd in ((1, 1, 128), (1, 7, 128), (16, 7, 128), (4, 4, 64),
                     (16, 1, 80)):
        cases.append(_case(3, c, 2, g, hd, 16, 64, 200, [1000, 3, 500],
                           [c, 0, 1], seed=c * g + hd))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda, dtype):
    """The hand-written kernel against its plain version, on the card,
    over ``_card_cases``; rows past n_new come out as zeros.  f32 takes the
    scalar design throughout; bf16 takes both, as ``paged_design`` names
    them, and some lanes split their pages across blocks."""
    cases = _card_cases()
    ops.reset_launches()
    designs, splits = set(), set()
    for case in cases:
        args = _torch(case, dtype, cuda)
        b, c, kv, g, hd = args[0].shape
        designs.add(paged_design(args[0].dtype, c, g, hd))
        splits.add(paged_splits(b, c, kv, g, hd, args[1].shape[1],
                                args[3].shape[1], args[0].dtype) > 1)
        out = ops.paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        ref = paged_attention_plain(*args).float().cpu()
        _assert_valid_rows(out.float().cpu(), ref, case[5], TOL[dtype])
        live = [(out[lane, :n].float().cpu(), ref[lane, :n])
                for lane, n in enumerate(np.asarray(case[5]).tolist())]
        diff = sum(float(((a - b) ** 2).sum()) for a, b in live)
        norm = sum(float((b ** 2).sum()) for _, b in live)
        if dtype == "bfloat16" and norm:   # a case may have no live row
            assert (diff / norm) ** 0.5 <= REL_TOL, (c, g, hd)
        for lane, n in enumerate(np.asarray(case[5]).tolist()):
            assert (out[lane, max(n, 1):] == 0).all()
    assert ops.LAUNCHES["paged_attention"] == len(cases)
    assert designs == ({"scalar"} if dtype == "float32"
                       else {"scalar", "mma"})
    assert splits == {False, True}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_is_deterministic(cuda, dtype):
    """Two calls on one input give equal bits: the splits' partials are
    merged in a fixed order (the serving replay and the gather-equals-paged
    check rely on it)."""
    for c, g in ((1, 1), (16, 7)):
        args = _torch(_case(3, c, 2, g, 128, 16, 64, 200, [1000, 3, 500],
                            [c, 0, 1], seed=5), dtype, cuda)
        b, c, kv, g, hd = args[0].shape
        assert paged_splits(b, c, kv, g, hd, 16, 64, args[0].dtype) > 1
        first = paged_attention_cuda(*args)
        second = paged_attention_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_all_rows_match_plain_on_every_row(cuda, dtype):
    """The every-row mode (``all_rows``, the moe family's) against the plain
    version on every row of every lane, dead rows and idle lanes included,
    over ``_card_cases`` and qwen3-moe's and granite-moe's geometries with
    dead rows crossing a page edge; both designs in bf16, lanes split
    across blocks, and two calls equal bit for bit."""
    cases = _card_cases()
    for c, kv, g, hd in ((16, 4, 8, 128), (1, 4, 8, 128), (16, 8, 2, 64),
                         (1, 8, 2, 64)):
        cases.append(_case(3, c, kv, g, hd, 16, 64, 200, [1015, 0, 500],
                           [1, 0, min(c, 9)], seed=c + g + hd))
    ops.reset_launches()
    designs, splits = set(), set()
    for case in cases:
        args = _torch(case, dtype, cuda)
        b, c, kv, g, hd = args[0].shape
        designs.add(paged_design(args[0].dtype, c, g, hd))
        splits.add(paged_splits(b, c, kv, g, hd, args[1].shape[1],
                                args[3].shape[1], args[0].dtype) > 1)
        out = ops.paged_attention(*args, all_rows=True)
        again = paged_attention_cuda(*args, all_rows=True)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = paged_attention_plain(*args).float().cpu()
        np.testing.assert_allclose(out.float().cpu().numpy(), ref.numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        diff = float(((out.float().cpu() - ref) ** 2).sum())
        if dtype == "bfloat16":
            assert (diff / float((ref ** 2).sum())) ** 0.5 <= REL_TOL, \
                (c, g, hd)
    assert ops.LAUNCHES["paged_attention"] == len(cases)
    assert designs == ({"scalar"} if dtype == "float32"
                       else {"scalar", "mma"})
    assert splits == {False, True}
