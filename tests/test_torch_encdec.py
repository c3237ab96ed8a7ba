"""The port's encdec family (whisper) against the JAX reference, on the
CPU, at ``reduced()`` size: 2 encoder and 4 decoder layers, d_model 128,
4 q heads over 2 kv heads of head dim 32, d_ff 256, vocab 512, no RoPE,
sinusoidal positions on both sides, 32 audio frames where a length is not
given.

Both sides run the reference's weights through the bit-exact bridge and
the same numpy inputs.  Tolerances, each with its reason:

* ``gelu`` (the tanh form): bit for bit in bf16, the same ops in the
  same order, each rounded to bf16 in both frameworks; f32 within 1e-6;
* ``sinusoidal_positions`` (an int offset over whisper's 1,500 frames and
  a ``[B, 1]`` position tensor): within 2**-8, one bf16 ulp at 1, and at
  most 0.1% of the values off at all.  XLA's f32 ``exp`` is an ulp off
  the correctly rounded one for 58 of the 512 frequencies (PyTorch's for
  6), which moves an angle near 1,500 rad by up to 2e-4; 0.05% of the
  1,500 x 1,024 table rounds to another bf16 value;
* ``gelu_mlp``, bidirectional self-attention (the flash route's plain
  version at 32 frames, ``_attend`` at 136), cross-attention and the
  encoder: f32 2e-5 (sum orders); bf16 within 2 bf16 ulps of the output's
  scale (4 for the encoder's two layers, whose attention keeps P in fp32
  on the flash route where the reference's jnp path rounds it);
* the read-only ``decode_attention`` of a cross cache: f32 2e-5, bf16 2
  ulps; the cache unchanged;
* ``Model.loss`` and every gradient against ``jax.value_and_grad`` at 32
  and 136 frames: f32 loss 1e-5 and gradients 1e-5 relative (norm;
  caveat f's pin lifted), 5e-5 at 136 frames, where the reference's own
  f32 attention gradients are 3e-5 off an f64 run (``F136_GRAD_TOL``);
  bf16 loss 1e-3 and each gradient within 16 bf16 ulps of its largest
  entry (caveat d).  Under f32 weights the frames are f32 and both sides
  take the reference's position table (``_torch_families.batch`` and
  ``reference_positions`` say why);
* ``prefill`` and four ``decode_step`` calls against the reference's
  compiled functions: f32 logits 1e-4 and caches 2e-5 of their largest
  entry; bf16 both within 8 ulps of their scale, argmax by the near-tie
  rule;
* the contiguous ``ServeEngine``, f32, at 1 and 3 slots: greedy streams
  token for token against the reference's engine with its step inputs
  copied (caveat a); its cross caches stay zero in both packages;
* both CLIs at ``--device cpu``.
"""
import numpy as np
import pytest
import torch

import _torch_families as F
from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import stack as TS

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ARCH = F.ENCDEC
# f32 gradients at 136 frames: the reference's own q and k gradients of the
# encoder's attention and of the cross-attention sit 3.0e-5 (relative norm)
# from an f64 run of the same loss through the port, where the port's f32
# ones sit 8e-7 from it; every other leaf of both is within 1.3e-5
F136_GRAD_TOL = 5e-5


def _close(got, want, dtype, ulps=2):
    if dtype == "float32":
        np.testing.assert_allclose(F.np_(got), F.np_(want), rtol=0,
                                   atol=2e-5)
    else:
        F.ulp_close(got, want, ulps)


def _layer0(dtype, tree="layers"):
    p = F.params(ARCH, dtype)[tree]
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), p),
            F.TP.tree_map(lambda t: t[0], F.to_torch(p)))


def _x(dtype, seed, shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return (x.astype(np.float32) if dtype == "float32"
            else F.bf16_array(x))


# ------------------------------------------------------------------ specs


def test_param_specs_match_reference():
    """24 encoder and 24 decoder layers at full width, 0.811 B
    parameters, as the reference declares them."""
    F.check_param_specs(ARCH)
    from repro_torch.configs import ALL_ARCHS
    assert round(ALL_ARCHS[ARCH].param_count() / 1e9, 3) == 0.811


def test_weight_bridge_carries_the_tree_bit_for_bit():
    F.check_weight_bridge(ARCH)


def test_cache_specs_match_reference():
    F.check_cache_specs(ARCH)


def test_input_specs_and_sample_batch_match_reference():
    F.check_input_specs(ARCH)


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_reference(dtype):
    x = _x(dtype, 1, (65536,), scale=3.0)
    want = jax.nn.gelu(jnp.asarray(x))
    got = TL.gelu(F.to_torch({"x": x})["x"])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(F.np_(got), F.np_(want))
    else:
        np.testing.assert_allclose(F.np_(got), F.np_(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    from repro.models.layers import gelu_mlp
    p_r, p_t = _layer0(dtype)
    x = _x(dtype, 2, (2, 20, 128))
    _close(TL.gelu_mlp(p_t["mlp"], F.to_torch({"x": x})["x"]),
           gelu_mlp(p_r["mlp"], jnp.asarray(x)), dtype)


@pytest.mark.parametrize("offset", [0, 7, "lanes"])
def test_sinusoidal_positions_match_reference(offset):
    from repro.models.layers import sinusoidal_positions
    if offset == "lanes":
        pos = np.array([[0], [3], [447], [1499]], np.int32)
        want = sinusoidal_positions(1, 128, offset=jnp.asarray(pos))
        got = TL.sinusoidal_positions(1, 128, offset=torch.tensor(pos))
        assert tuple(got.shape) == (4, 128)
    else:
        want = sinusoidal_positions(1500, 1024, offset)
        got = TL.sinusoidal_positions(1500, 1024, offset)
    assert got.dtype == torch.bfloat16
    got, want = F.np_(got), F.np_(want)
    assert np.abs(got - want).max() <= 2.0 ** -8
    assert (got != want).mean() <= 1e-3


# -------------------------------------------------------------- attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frames", [32, 136])
def test_bidirectional_attention_matches_reference(frames, dtype):
    """An encoder layer's attention: every key attended.  At 32 frames the
    call takes the flash route non-causally (the plain version here); at
    136, not a multiple of 128, the reference's ``_attend``."""
    from repro.models.attention import full_attention
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _layer0(dtype, "enc_layers")
    x = _x(dtype, 3, (2, frames, 128))
    want = full_attention(cfg_r, p_r["attn"], jnp.asarray(x), causal=False)
    with F.FlashSpy() as spy:
        got = TA.full_attention(cfg_t, p_t["attn"], F.to_torch({"x": x})["x"],
                                causal=False)
    assert spy.calls == ([{"causal": False}] if frames == 32 else [])
    _close(got, want, dtype)
    causal = TA.full_attention(cfg_t, p_t["attn"], F.to_torch({"x": x})["x"])
    assert F.rel(causal, want) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """A decoder layer's cross-attention to the encoder's states: no
    RoPE (whisper has none), no mask, never the flash route."""
    from repro.models.attention import full_attention
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _layer0(dtype)
    x, enc = _x(dtype, 4, (2, 16, 128)), _x(dtype, 5, (2, 32, 128))
    want = full_attention(cfg_r, p_r["cross"], jnp.asarray(x),
                          kv_x=jnp.asarray(enc), causal=False)
    with F.FlashSpy() as spy:
        got = TA.full_attention(cfg_t, p_t["cross"],
                                F.to_torch({"x": x})["x"],
                                kv_x=F.to_torch({"e": enc})["e"],
                                causal=False)
    assert spy.calls == []
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_only_decode_attention_matches_reference(dtype):
    from repro.models.attention import decode_attention
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _layer0(dtype)
    x = _x(dtype, 6, (3, 1, 128))
    kv = _x(dtype, 7, (2, 3, 32, 2, 32))
    pos = np.array([0, 9, 31], np.int32)
    want, k_out, _ = decode_attention(
        cfg_r, p_r["cross"], jnp.asarray(x), jnp.asarray(kv[0]),
        jnp.asarray(kv[1]), jnp.asarray(pos), update_cache=False)
    caches = F.to_torch({"k": kv[0], "v": kv[1]})
    got = TA.decode_attention(cfg_t, p_t["cross"], F.to_torch({"x": x})["x"],
                              caches["k"], caches["v"], torch.tensor(pos),
                              update_cache=False)
    _close(got, want, dtype)
    np.testing.assert_array_equal(F.np_(caches["k"]), F.np_(k_out))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    """Sinusoidal positions on the bf16 frame embeddings, two layers of
    bidirectional attention and GELU MLP, the final norm."""
    from repro.models.stack import _encoder
    cfg_r, cfg_t = F.cfgs(ARCH)
    weights = F.params(ARCH, dtype)
    audio = F.bf16_array(np.random.default_rng(8).standard_normal(
        (2, 32, 128)))
    if dtype == "float32":
        audio = audio.astype(np.float32)   # see _torch_families.batch
    want = _encoder(cfg_r, jax.tree.map(jnp.asarray, weights),
                    jnp.asarray(audio), "none")
    with F.FlashSpy() as spy:
        got = TS.encoder(cfg_t, F.to_torch(weights),
                         F.to_torch({"a": audio})["a"])
    assert spy.calls == [{"causal": False}] * cfg_t.n_encoder_layers
    _close(got, want, dtype, ulps=4)


# --------------------------------------------------------------- training


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("frames", [32, 136])
def test_loss_and_gradients_match_jax_value_and_grad(frames, remat, dtype,
                                                     monkeypatch):
    F.check_loss_and_grads(ARCH, remat, dtype, monkeypatch, seq=16,
                           frames=frames,
                           grad_tol=F136_GRAD_TOL if frames == 136 else 1e-5)


# ------------------------------------------------------- prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_compiled_reference(dtype,
                                                          monkeypatch):
    F.check_prefill_and_decode(ARCH, dtype, monkeypatch, seq=16)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_streams_match_reference_engine(slots):
    F.check_engine_streams(ARCH, slots)


# ------------------------------------------------------------ entry points


def test_serve_cli_serves_contiguously_with_the_reference_audit(capsys):
    F.check_serve_cli(ARCH, capsys)


def test_train_cli_refuses_the_family(tmp_path):
    F.check_train_cli_refuses(ARCH, "audio_embed", tmp_path)
