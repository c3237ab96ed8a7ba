"""The port's flash attention against the JAX reference, and its CUDA
kernel against its plain version.

* ``flash_attention_plain`` against both reference functions —
  ``ref.flash_attention_ref`` and the Pallas kernel in interpret mode —
  over the sweep of ``tests/test_kernels.py`` (S 128-512, block shapes of
  the Pallas kernel, f32 and bf16, causal and not; f32 2e-5, bf16 2e-2).
* Its autograd gradients against ``jax.grad`` of the reference oracle
  (f32, 2e-5 relative to each gradient's largest entry).
* ``flash_attention_backward`` (the torch-op backward of the autograd
  function the model runs on a card) against autograd through the plain
  version, fed the plain version's log-sum-exp: chunked and not, a tail S,
  f32 at 2e-5 and bf16 at 2e-2, each relative to the gradient's largest
  entry.
* ``flash_design``: bf16 at every arch's head dim takes the tensor-core
  design, f32 and other head dims the scalar one.
* The CUDA kernel against its plain version on the card (``cuda`` marker;
  skips without a GPU), both designs; a structured single tile whose
  answer is a permutation, so a misread fragment layout shows as a wrong
  key or column; and the wrapper's argument checks, which run here.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_backward,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 flash_design,
                                                 logsumexp_plain)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py::test_flash_matches_oracle: (s, block_q, block_k)
SWEEP = [(128, 64, 64), (256, 128, 128), (256, 64, 128), (512, 128, 64)]


def _qkv(bh, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((bh, s, d)).astype(np.float32)
                 for _ in range(3))


def _torch(arrays, dtype="float32", device="cpu"):
    return tuple(torch.tensor(a).to(getattr(torch, dtype)).to(device)
                 for a in arrays)


def _close(got, want, tol, rel_to_max=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if rel_to_max else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@functools.lru_cache(maxsize=None)
def _reference():
    import jax
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention_pallas
    oracle = jax.jit(ref.flash_attention_ref, static_argnames="causal")
    return oracle, flash_attention_pallas


# ------------------------------------------------ plain against the reference


@pytest.mark.parametrize("s,bq,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_and_pallas(s, bq, bk, dtype, causal):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    oracle, pallas = _reference()
    arrays = _qkv(3, s, 64, seed=s + bq + bk)
    got = flash_attention_plain(*_torch(arrays, dtype), causal=causal)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    _close(got.float(), oracle(*jargs, causal=causal), TOL[dtype])
    _close(got.float(), pallas(*jargs, causal=causal, block_q=bq,
                               block_k=bk, interpret=True), TOL[dtype])


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_gradients_match_jax_grad(s, causal):
    """Autograd through the plain version against ``jax.grad`` of the
    reference oracle, for a random cotangent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    arrays = _qkv(2, s, 32, seed=s)
    w = np.random.default_rng(1).standard_normal(arrays[0].shape
                                                 ).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, causal=causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    q, k, v = (t.requires_grad_() for t in _torch(arrays))
    (flash_attention_plain(q, k, v, causal=causal) * torch.tensor(w)
     ).sum().backward()
    for got, ref_g in zip((q.grad, k.grad, v.grad), want):
        _close(got, ref_g, 2e-5, rel_to_max=True)


# ------------------------------------------------------ the torch-op backward


@pytest.mark.parametrize("s,chunk", [(256, 64), (256, 1024), (100, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_autograd_through_plain(s, chunk, dtype, causal):
    arrays = _qkv(3, s, 32, seed=7 * s + chunk)
    q, k, v = (t.requires_grad_() for t in _torch(arrays, dtype))
    d_out = _torch((np.random.default_rng(2).standard_normal(
        arrays[0].shape).astype(np.float32),), dtype)[0]
    out = flash_attention_plain(q, k, v, causal=causal)
    out.backward(d_out)
    with torch.no_grad():
        lse = logsumexp_plain(q, k, causal=causal)
        got = flash_attention_backward(q, k, v, lse, d_out, causal=causal,
                                       chunk=chunk)
    for g, want in zip(got, (q.grad, k.grad, v.grad)):
        assert g.dtype == want.dtype
        _close(g.float(), want.float(), TOL[dtype], rel_to_max=True)


def test_ops_dispatch_takes_the_plain_version_on_the_cpu():
    ops.reset_launches()
    args = _torch(_qkv(2, 128, 32, seed=3))
    torch.testing.assert_close(ops.flash_attention(*args, causal=True),
                               flash_attention_plain(*args, causal=True),
                               rtol=0, atol=0)
    assert ops.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(*[t.to("meta") for t in args])


def test_flash_design_takes_the_tensor_cores_at_every_arch_head_dim():
    """bf16 at the head dim of every arch, full width and ``reduced()``,
    runs on the tensor cores; f32, and bf16 at head dims that are not a
    multiple of 16 or are 16, take the scalar design."""
    dims = {c.resolved_head_dim for cfg in ALL_ARCHS.values()
            for c in (cfg, reduced(cfg)) if c.n_heads}
    assert dims == {32, 64, 80, 96, 128}
    for d in dims:
        assert flash_design(torch.bfloat16, d) == "mma"
        assert flash_design(torch.float32, d) == "scalar"
    for d in (4, 16, 20, 36, 100, 124):
        assert flash_design(torch.bfloat16, d) == "scalar"


_BAD_ARGS = {
    "cpu": (None, None, "CUDA device"),
    "dtype": (0, lambda t: t.to(torch.float16), "dtype"),
    "mixed": (1, lambda t: t.to(torch.bfloat16), "must match"),
    "shape": (2, lambda t: t[:, :64], "one \\[BH, S, D\\]"),
    "rank": (0, lambda t: t[0], "one \\[BH, S, D\\]"),
    "contiguous": (1, lambda t: t.transpose(0, 1).contiguous()
                   .transpose(0, 1), "contiguous"),
    "head_dim": (None, lambda t: torch.zeros(2, 128, 136), "head_dim"),
    "odd_head_dim": (None, lambda t: torch.zeros(2, 128, 30), "head_dim"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_ARGS))
def test_cuda_wrapper_rejects_bad_arguments(bad):
    """The wrapper refuses what the kernel does not take, before any build
    or launch.  The layout checks come before the device check, so meta
    tensors (shapes and dtypes, no storage) exercise each of them here."""
    good = list(_torch(_qkv(2, 128, 32, seed=4)))
    idx, make, msg = _BAD_ARGS[bad]
    if make is None:
        args = good
    elif idx is None:
        args = [make(a) for a in good]
    else:
        args = [make(a) if i == idx else a for i, a in enumerate(good)]
    if bad != "cpu":
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match=msg):
        flash_attention_cuda(*args)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# (bh, s, d): the sweep's shapes, the head dims of the dense archs, a tail
# S, and a head dim that takes the scalar design in bf16 too
CARD_CASES = ([(3, s, 64) for s, _, _ in SWEEP]
              + [(2, 256, d) for d in (32, 80, 96, 128)] + [(4, 100, 128),
                                                           (2, 100, 36)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernel_matches_plain(cuda, dtype, causal):
    """Output and log-sum-exp of the kernel against the plain version, on
    the card (output f32 2e-5, bf16 2e-2; log-sum-exp 2e-5 relative)."""
    ops.reset_launches()
    for bh, s, d in CARD_CASES:
        q, k, v = _torch(_qkv(bh, s, d, seed=bh * s + d), dtype, cuda)
        out, lse = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _close(out.float().cpu(),
               flash_attention_plain(q, k, v, causal=causal).float().cpu(),
               TOL[dtype])
        _close(lse.cpu(), logsumexp_plain(q, k, causal=causal).cpu(), 2e-5)
        ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == len(CARD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_autograd_function_matches_plain_gradients(cuda, dtype):
    """``FlashAttention`` (kernel forward, torch-op backward) against
    autograd through the plain version, on the card."""
    arrays = _qkv(4, 256, 64, seed=5)
    d_out = _torch((np.random.default_rng(6).standard_normal(
        arrays[0].shape).astype(np.float32),), dtype, cuda)[0]
    grads = []
    for fn in (lambda q, k, v: FlashAttention.apply(q, k, v, True),
               lambda q, k, v: flash_attention_plain(q, k, v, causal=True)):
        q, k, v = (t.requires_grad_() for t in _torch(arrays, dtype, cuda))
        fn(q, k, v).backward(d_out)
        grads.append([t.grad.float().cpu() for t in (q, k, v)])
    for got, want in zip(*grads):
        _close(got, want, TOL[dtype], rel_to_max=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_mma_fragments_on_a_structured_tile(cuda, d):
    """One 64-key tile (bh 1, S 64, non-causal, bf16: the tensor-core
    design) whose answer is a permutation.  Key j points along d-column
    sigma[j] and carries the one-hot of column tau[j] as its value; query
    i points along sigma[pi[i]], so its scaled scores are 0 except 256 /
    sqrt(d) (22.6 or 32) on key pi[i].  The output row is then the one-hot
    of tau[pi[i]] to within 1e-6: a misread Q, K or V fragment puts the
    peak on another key or the one in another column, not a rounding
    error."""
    s = 64
    rng = np.random.default_rng(d)
    pi, sigma, tau = (rng.permutation(s), rng.permutation(d)[:s],
                      rng.permutation(d)[:s])
    q, k, v = (torch.zeros((1, s, d)) for _ in range(3))
    q[0, np.arange(s), sigma[pi]] = 16.0
    k[0, np.arange(s), sigma] = 16.0
    v[0, np.arange(s), tau] = 1.0
    q, k, v = (t.to(torch.bfloat16).to(cuda) for t in (q, k, v))
    out, lse = flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = torch.zeros((s, d))
    want[np.arange(s), tau[pi]] = 1.0
    assert out.float().cpu()[0].argmax(dim=-1).tolist() == tau[pi].tolist()
    _close(out.float().cpu()[0], want, 1e-6)
    _close(lse.cpu(), logsumexp_plain(q, k, causal=False).cpu(), 2e-5)
    _close(lse.cpu(), np.full((1, s), 256.0 / d ** 0.5, np.float32), 2e-5)
