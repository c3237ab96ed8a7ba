"""The port's SSD scan against the JAX reference, and its CUDA kernel
against its plain version.

* ``ssd_scan_plain`` against both reference functions — ``ref.ssd_scan_ref``
  (the model's ``ssd_chunked``) and the Pallas kernel in interpret mode —
  over the sweep of ``tests/test_kernels.py`` (S 64-256, chunks 16-64, G 1
  and 2): f32 at the reference's 2e-3; bf16 at one bf16 step of each value
  (rtol 2^-7) plus 1e-3 for the fp32 sums' order, since both sides round
  one fp32 result to bf16.
* ``ssd_scan_plain`` against ``ref.ssd_sequential_ref`` (2e-3), with and
  without an initial state, and ``ssd_decode_step`` continuing a scan (the
  ``test_ssd_decode_step_matches_scan_tail`` invariant, 2e-3).
* ``ssd_scan_backward`` (the torch-op backward of the autograd function the
  model runs on a card) against autograd through the plain version and
  against ``jax.grad`` of ``ssd_chunked``: f32, 1e-4 relative to each
  gradient's largest entry (fp32 sums in another order); bf16 inputs at
  2e-2 (the gradients are rounded to bf16 once).
* The dispatch, the chunk rule, the wrapper's argument checks and the
  choice of design (``ssd_design``: the chunk-parallel tensor-core design
  at every arch's bf16 call), here; the CUDA kernel against its plain
  version in both designs and ``SsdScan``'s gradients through the
  tensor-core forward on the card (``cuda`` marker; they skip without a
  GPU).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.configs import ALL_ARCHS
from repro_torch.kernels.ssd_scan import (SsdScan, ssd_design,
                                          ssd_scan_backward, ssd_scan_cuda,
                                          ssd_scan_plain,
                                          ssd_workspace_elements)
from repro_torch.models.ssm import ssd_decode_step

# tests/test_kernels.py::test_ssd_matches_chunked_oracle: (s, chunk) x g
SWEEP = [(s, chunk, g) for s, chunk in ((64, 16), (128, 32), (256, 64))
         for g in (1, 2)]
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3


def _problem(b, s, h, p, g, n, seed, dt_hi=0.1):
    """The reference sweep's distributions: x, B, C normal; dt in
    [0.001, dt_hi]; a in [-1, -0.1]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, dt_hi, (b, s, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, h).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32))


def _torch(arrays, dtype="float32", device="cpu"):
    """x, B and C in ``dtype``; dt and a stay fp32."""
    x, dt, a, b_in, c_in = (torch.tensor(t, device=device) for t in arrays)
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, a, b_in.to(dt_), c_in.to(dt_)


def _jax(arrays, dtype="float32"):
    import jax.numpy as jnp
    x, dt, a, b_in, c_in = (jnp.asarray(t) for t in arrays)
    dt_ = getattr(jnp, dtype)
    return x.astype(dt_), dt, a, b_in.astype(dt_), c_in.astype(dt_)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else (
        t.detach().float().cpu().numpy())


def _close(got, want, dtype="float32", tol=2e-3):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _reference():
    import jax
    from repro.kernels import ref
    from repro.kernels.ssd_scan import ssd_scan_pallas
    oracle = jax.jit(ref.ssd_scan_ref, static_argnames="chunk")
    pallas = functools.partial(ssd_scan_pallas, interpret=True)
    return oracle, pallas


# ------------------------------------------------------ plain vs reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,g", SWEEP,
                         ids=[f"s{s}-c{c}-g{g}" for s, c, g in SWEEP])
def test_plain_matches_reference_oracle_and_pallas(s, chunk, g, dtype):
    pytest.importorskip("jax")
    oracle, pallas = _reference()
    arrays = _problem(2, s, 4, 32, g, 16, seed=s + chunk + g)
    y, fin = ssd_scan_plain(*_torch(arrays, dtype), chunk)
    assert y.dtype == getattr(torch, dtype) and fin.dtype == torch.float32
    for fn in (lambda *t: oracle(*t, chunk=chunk),
               lambda *t: pallas(*t, chunk)):
        y_r, fin_r = fn(*_jax(arrays, dtype))
        _close(y, y_r, dtype)
        _close(fin, fin_r)


@pytest.mark.parametrize("with_init", [False, True])
def test_plain_matches_sequential_reference(with_init):
    """The chunked plain version equals the O(S) recurrence; an initial
    state carries into both (the recurrence started from it is the
    chunked scan with ``init_state``)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.models.ssm import ssd_chunked
    arrays = _problem(1, 96, 2, 16, 1, 8, seed=7, dt_hi=0.2)
    init = (np.random.default_rng(8).standard_normal((1, 2, 16, 8))
            .astype(np.float32) if with_init else None)
    y, fin = ssd_scan_plain(*_torch(arrays), 32,
                            init_state=None if init is None
                            else torch.tensor(init))
    y_s, fin_s = ref.ssd_sequential_ref(*_jax(arrays))
    if init is None:
        _close(y, y_s)
        _close(fin, fin_s)
    y_r, fin_r = ssd_chunked(*_jax(arrays), 32, init_state=None
                             if init is None else jnp.asarray(init))
    _close(y, y_r)
    _close(fin, fin_r)


def test_decode_step_continues_the_scan():
    """S tokens through the chunked scan and one ``ssd_decode_step`` give
    the sequential recurrence's output at token S."""
    pytest.importorskip("jax")
    from repro.kernels import ref
    s = 64
    x, dt, a, b_in, c_in = _problem(1, s + 1, 2, 16, 1, 8, seed=9,
                                    dt_hi=0.2)
    y_full, _ = ref.ssd_sequential_ref(*_jax((x, dt, a, b_in, c_in)))
    _, state = ssd_scan_plain(*_torch((x[:, :s], dt[:, :s], a,
                                       b_in[:, :s], c_in[:, :s])), 16)
    xt, dtt, at, bt, ct = _torch((x[:, s], dt[:, s], a, b_in[:, s],
                                  c_in[:, s]))
    y_step, _ = ssd_decode_step(state, xt, dtt, at, bt, ct)
    _close(y_step, np.asarray(y_full)[:, s])


# ----------------------------------------------------------------- backward


def _cotangents(y_shape, fin_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(y_shape).astype(np.float32),
            rng.standard_normal(fin_shape).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s,chunk,g", [(64, 16, 1), (96, 32, 2), (32, 32, 1)])
def test_backward_matches_autograd_through_plain(s, chunk, g, dtype, tol):
    """Gradients of x, dt, a, B and C from cotangents of both outputs,
    relative to each gradient's largest entry."""
    arrays = _problem(2, s, 4, 16, g, 8, seed=s + g, dt_hi=0.3)
    inputs = [t.requires_grad_() for t in _torch(arrays, dtype)]
    y, fin = ssd_scan_plain(*inputs, chunk)
    d_y, d_fin = _cotangents(y.shape, fin.shape, seed=s)
    d_y = torch.tensor(d_y).to(y.dtype)
    d_fin = torch.tensor(d_fin)
    torch.autograd.backward((y, fin), (d_y, d_fin))
    got = ssd_scan_backward(*[t.detach() for t in inputs], chunk, d_y, d_fin)
    for gr, t in zip(got, inputs):
        assert gr.dtype == t.dtype and gr.shape == t.shape
        want = t.grad.float()
        np.testing.assert_allclose(_np(gr), _np(want), rtol=tol,
                                   atol=tol * float(want.abs().max()))
    # with the final state's cotangent absent (training), dy alone
    only_y = ssd_scan_backward(*[t.detach() for t in inputs], chunk, d_y,
                               None)
    for t in inputs:
        t.grad = None
    y, _ = ssd_scan_plain(*inputs, chunk)
    y.backward(d_y)
    for gr, t in zip(only_y, inputs):
        np.testing.assert_allclose(_np(gr), _np(t.grad), rtol=tol,
                                   atol=tol * float(t.grad.float().abs()
                                                    .max()))


def test_backward_matches_jax_grad_of_ssd_chunked():
    """f32 gradients of sum(y * dy) + sum(final * dfinal) against
    ``jax.grad`` of the reference's ``ssd_chunked`` (1e-4 relative to each
    gradient's largest entry)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked
    s, chunk = 64, 16
    arrays = _problem(2, s, 4, 16, 2, 8, seed=21, dt_hi=0.3)
    d_y, d_fin = _cotangents((2, s, 4, 16), (2, 4, 16, 8), seed=22)

    def objective(*args):
        y, fin = ssd_chunked(*args, chunk)
        return jnp.sum(y * d_y) + jnp.sum(fin * d_fin)

    want = jax.jit(jax.grad(objective, argnums=(0, 1, 2, 3, 4)))(
        *_jax(arrays))
    got = ssd_scan_backward(*_torch(arrays), chunk, torch.tensor(d_y),
                            torch.tensor(d_fin))
    for gr, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(gr), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_backward_stays_finite_where_the_dense_decay_overflows():
    """A chunk whose summed dt * a passes 88 overflows exp(seg_q - seg_k)
    above the diagonal in the plain version's dense decay; its forward
    masks that, but autograd through it carries 0 * inf back.  The
    backward takes the decay only where k <= q, so its gradients stay
    finite."""
    arrays = list(_problem(1, 64, 2, 8, 1, 8, seed=31))
    arrays[1][:] = 2.0                 # dt: seg falls by 2-4 a token
    arrays[2][:] = -np.array([1.0, 2.0], np.float32)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    y, fin = ssd_scan_plain(*inputs, 64)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    y.sum().backward()
    assert not all(torch.isfinite(t.grad).all() for t in inputs)
    got = ssd_scan_backward(*[t.detach() for t in inputs], 64,
                            torch.ones_like(y), None)
    assert all(torch.isfinite(gr).all() for gr in got)


# ------------------------------------------------------- dispatch, checks


def test_ops_dispatch_cuts_the_chunk_and_takes_the_plain_version():
    ops.reset_launches()
    args = _torch(_problem(1, 48, 2, 8, 1, 8, seed=41))
    y, fin = ops.ssd_scan(*args, 256)          # chunk cut to S = 48
    y_p, fin_p = ssd_scan_plain(*args, 48)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(fin, fin_p, rtol=0, atol=0)
    assert ops.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*args, 32)                 # 48 % 32
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*[t.to("meta") for t in args], 16)


_BAD_ARGS = {
    "cpu": (None, None, "CUDA device"),
    "x_dtype": (0, lambda t: t.to(torch.float16), "x dtype"),
    "mixed": (3, lambda t: t.to(torch.bfloat16), "must match"),
    "dt_dtype": (1, lambda t: t.to(torch.bfloat16), "float32"),
    "x_rank": (0, lambda t: t[0], "\\[B, S, H, P\\]"),
    "bc_shape": (4, lambda t: t[:, :, :, :4], "one \\[B, S, G, N\\]"),
    "dt_shape": (1, lambda t: t[:, :, :1], "dt must be"),
    "groups": (None, lambda t: t, "bad geometry"),
    "head_dim": (0, lambda t: torch.zeros(1, 32, 4, 136), "head dim"),
    "contiguous": (0, lambda t: t.transpose(1, 2).contiguous()
                   .transpose(1, 2), "contiguous"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_ARGS))
def test_cuda_wrapper_rejects_bad_arguments(bad):
    """The wrapper refuses what the kernel does not take, before any build
    or launch; meta tensors (no storage) exercise the layout checks here,
    which come before the device check."""
    good = list(_torch(_problem(1, 32, 4, 8, 2, 8, seed=51)))
    idx, make, msg = _BAD_ARGS[bad]
    if bad == "groups":        # 3 groups do not divide 4 heads
        good[3] = torch.zeros(1, 32, 3, 8)
        good[4] = torch.zeros(1, 32, 3, 8)
        args = good
    elif make is None:
        args = good
    else:
        args = [make(a) if i == idx else a for i, a in enumerate(good)]
    if bad == "head_dim":
        args[2] = torch.zeros(4)
    if bad != "cpu":
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match=msg):
        ssd_scan_cuda(*args, 16)


def test_cuda_wrapper_rejects_unaligned_tensor_core_inputs():
    """The tensor-core design stages x, B and C with 16-byte copies: the
    wrapper refuses an x that starts 2 bytes off (meta tensors, as
    above)."""
    args = [t.to("meta") for t in _torch(_problem(1, 64, 2, 16, 1, 16,
                                                  seed=52), "bfloat16")]
    args[0] = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                          device="meta")[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan_cuda(*args, 64)


def test_ssd_design_takes_the_tensor_cores_at_every_arch_call():
    """Every ssm and hybrid arch's bf16 scan (P, N, its chunk) takes the
    chunk-parallel tensor-core design; f32 and shapes outside it take the
    scalar design."""
    archs = [c for c in ALL_ARCHS.values() if c.family in ("ssm", "hybrid")]
    assert archs
    for cfg in archs:
        p, n, chunk = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk
        assert ssd_design(torch.bfloat16, p, n, chunk) == "mma", cfg.name
        assert ssd_design(torch.float32, p, n, chunk) == "scalar", cfg.name
    for p, n, chunk in ((40, 24, 32), (64, 128, 32), (64, 128, 320),
                        (24, 64, 64), (64, 20, 64)):
        assert ssd_design(torch.bfloat16, p, n, chunk) == "scalar"


def test_ssd_workspace_at_the_training_call():
    """The tensor-core design's workspace at mamba2's training call: 8
    chunks x 80 heads of [64, 128] states a batch row, once in fp32 (84 MB
    over 4 rows) and once as three bf16 parts (1.5 times as many bytes);
    seg [4, 8, 80, 256]; C·Bᵀ [4, 8, 1, 256, 256]; and a count and 128
    entries for every 16 query rows of a head."""
    states = 4 * 8 * 80 * 64 * 128
    regions = 4 * 2048 * 80 // 16
    assert ssd_workspace_elements(4, 2048, 80, 64, 128, 256, 1) == (
        states + 3 * states // 2 + 4 * 2048 * 80 + 4 * 2048 * 256
        + regions + regions * 128)
    assert 83e6 < 4 * states < 84e6


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# (b, s, h, p, g, n, chunk): the sweep, the full-width shapes of mamba2
# and zamba2 (cut to one batch row and 4 heads), S = chunk, odd P and N
CARD_CASES = ([(2, s, 4, 32, g, 16, c) for s, c, g in SWEEP]
              + [(1, 512, 4, 64, 1, 128, 256), (1, 512, 4, 64, 1, 64, 256),
                 (2, 64, 4, 64, 2, 128, 64), (1, 96, 3, 40, 1, 24, 32)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda, dtype):
    """y and the final state of the kernel against the plain version on
    the card (f32 2e-3; bf16 y one bf16 step plus 1e-3).  In bf16 the
    cases take both designs (the chunk-parallel one at chunks of 64 and
    256, every full-width call among them), in f32 the scalar one."""
    ops.reset_launches()
    designs = {ssd_design(getattr(torch, dtype), p, n, chunk)
               for _, _, _, p, _, n, chunk in CARD_CASES}
    assert designs == ({"mma", "scalar"} if dtype == "bfloat16"
                       else {"scalar"})
    for i, (b, s, h, p, g, n, chunk) in enumerate(CARD_CASES):
        args = _torch(_problem(b, s, h, p, g, n, seed=i), dtype, cuda)
        y, fin = ssd_scan_cuda(*args, chunk)
        y_p, fin_p = ssd_scan_plain(*args, chunk)
        torch.cuda.synchronize()
        _close(y, y_p, dtype)
        _close(fin, fin_p)
        ops.ssd_scan(*args, chunk)
    assert ops.LAUNCHES["ssd_scan"] == len(CARD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_autograd_function_matches_plain_gradients(cuda, dtype, tol,
                                                        chunk):
    """``SsdScan`` (kernel forward, torch-op backward) against autograd
    through the plain version, on the card; the bf16 forward is the
    scalar design at chunk 32 and the chunk-parallel tensor-core design at
    chunk 64."""
    arrays = _problem(2, 128, 4, 32, 2, 16, seed=61, dt_hi=0.3)
    d_y, d_fin = _cotangents((2, 128, 4, 32), (2, 4, 32, 16), seed=62)
    assert ssd_design(getattr(torch, dtype), 32, 16, chunk) == (
        "mma" if dtype == "bfloat16" and chunk == 64 else "scalar")
    grads = []
    for fn in (lambda *t: SsdScan.apply(*t, chunk),
               lambda *t: ssd_scan_plain(*t, chunk)):
        inputs = [t.requires_grad_() for t in _torch(arrays, dtype, cuda)]
        y, fin = fn(*inputs)
        torch.autograd.backward((y, fin), (
            torch.tensor(d_y, device=cuda).to(y.dtype),
            torch.tensor(d_fin, device=cuda)))
        grads.append([t.grad.float().cpu() for t in inputs])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * float(want.abs().max()))
