"""The port's vlm family (llama-3.2-vision) against the JAX reference, on
the CPU, at ``reduced()`` size: 4 self-attention layers in 2 groups, each
group opened by one gated cross-attention block over 16 image tokens,
d_model 128, 4 q heads over 2 kv heads of head dim 32, vocab 512.

Both sides run the reference's weights through the bit-exact bridge, with
every gate drawn nonzero (at init they are zero and each cross block is
the identity), and the same numpy inputs.  Tolerances, each with its
reason:

* cross-attention (q turned by RoPE, keys never) and the cross block:
  f32 2e-5 (sum orders); bf16 within 2 bf16 ulps of the output's scale
  (the same roundings, other sum orders);
* the read-only ``decode_attention`` of a cross cache: f32 2e-5, bf16 2
  ulps; the cache unchanged;
* ``Model.loss`` and every gradient against ``jax.value_and_grad``: f32
  1e-5 relative (norm; caveat f's pin lifted), bf16 loss 1e-3 and each
  gradient within 16 bf16 ulps of its largest entry (caveat d; the self
  layers also keep P in fp32 on the flash route where the reference's jnp
  path rounds it);
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
from repro_torch.models import build as t_build
from repro_torch.models import stack as TS

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ARCH = F.VLM


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(F.np_(got), F.np_(want), rtol=0,
                                   atol=2e-5)
    else:
        F.ulp_close(got, want, 2)


def _cross0(dtype):
    """The first cross block's weights on both sides."""
    p = F.params(ARCH, dtype)["cross"]
    return (jax.tree.map(lambda a: jnp.asarray(a[0]), p),
            F.TP.tree_map(lambda t: t[0], F.to_torch(p)))


def _x_and_img(dtype, seed, s=24):
    cfg_r, _ = F.cfgs(ARCH)
    rng = np.random.default_rng(seed)
    x = F.bf16_array(rng.standard_normal((2, s, cfg_r.d_model)))
    img = F.bf16_array(rng.standard_normal((2, cfg_r.n_image_tokens,
                                            cfg_r.d_model)))
    x = x.astype(np.float32) if dtype == "float32" else x
    return x, img


# ------------------------------------------------------------------ specs


def test_param_specs_match_reference():
    """40 self layers and 8 gated cross blocks at full width, 11.52 B
    parameters, as the reference declares them."""
    F.check_param_specs(ARCH)
    from repro_torch.configs import ALL_ARCHS
    assert round(ALL_ARCHS[ARCH].param_count() / 1e9, 2) == 11.52


def test_weight_bridge_carries_the_tree_bit_for_bit():
    F.check_weight_bridge(ARCH)
    gates = F.params(ARCH)["cross"]["gate_attn"]
    assert gates.dtype == np.float32 and gates.shape == (2, 1)
    assert (np.abs(gates) >= 0.5).all()


def test_cache_specs_match_reference():
    F.check_cache_specs(ARCH)


def test_input_specs_and_sample_batch_match_reference():
    F.check_input_specs(ARCH)


# -------------------------------------------------------------- attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """q from x, turned by RoPE; k and v from the image embeddings,
    unturned; no mask.  Never the flash route, whatever the lengths."""
    from repro.models.attention import full_attention
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _cross0(dtype)
    x, img = _x_and_img(dtype, 1)
    want = full_attention(cfg_r, p_r["attn"], jnp.asarray(x),
                          kv_x=jnp.asarray(img), causal=False)
    with F.FlashSpy() as spy:
        got = TA.full_attention(cfg_t, p_t["attn"], F.to_torch({"x": x})["x"],
                                kv_x=F.to_torch({"i": img})["i"],
                                causal=False)
    assert spy.calls == [] and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_block_matches_reference(dtype):
    """The gated block: ``tanh(gate)`` cast to x's dtype, then times the
    attention and the SwiGLU outputs, as the reference rounds them."""
    from repro.models.stack import _cross_block
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _cross0(dtype)
    x, img = _x_and_img(dtype, 2)
    want = _cross_block(cfg_r, p_r, jnp.asarray(x), jnp.asarray(img))
    got = TS.cross_block(cfg_t, p_t, F.to_torch({"x": x})["x"],
                          F.to_torch({"i": img})["i"])
    _close(got, want, dtype)
    assert F.rel(got, F.to_torch({"x": x})["x"]) > 1e-2   # not the identity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_only_decode_attention_matches_reference(dtype):
    """One token against a cross cache: every row attended, q turned at
    each lane's position, nothing written."""
    from repro.models.attention import decode_attention
    cfg_r, cfg_t = F.cfgs(ARCH)
    p_r, p_t = _cross0(dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg_r.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 3, cfg_r.n_image_tokens, 2, 32)).astype(
        np.float32)
    if dtype == "bfloat16":
        x, kv = F.bf16_array(x), F.bf16_array(kv)
    pos = np.array([0, 5, 17], np.int32)
    want, k_out, _ = decode_attention(
        cfg_r, p_r["attn"], jnp.asarray(x), jnp.asarray(kv[0]),
        jnp.asarray(kv[1]), jnp.asarray(pos), update_cache=False)
    caches = F.to_torch({"k": kv[0], "v": kv[1]})
    got = TA.decode_attention(cfg_t, p_t["attn"], F.to_torch({"x": x})["x"],
                              caches["k"], caches["v"], torch.tensor(pos),
                              update_cache=False)
    _close(got, want, dtype)
    np.testing.assert_array_equal(F.np_(caches["k"]), F.np_(k_out))
    np.testing.assert_array_equal(F.np_(caches["k"]), F.np_(kv[0]))


def test_self_layers_take_the_flash_route_causally():
    """A forward sends each of the 4 self layers to the flash entry point
    (the plain version here), causal, and no cross block."""
    _, cfg_t = F.cfgs(ARCH)
    data = F.to_torch(F.batch(ARCH, 5))
    with F.FlashSpy() as spy:
        t_build(cfg_t).loss(F.to_torch(F.params(ARCH)), data)
    assert spy.calls == [{"causal": True}] * cfg_t.n_layers


# --------------------------------------------------------------- training


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax_value_and_grad(remat, dtype,
                                                     monkeypatch):
    F.check_loss_and_grads(ARCH, remat, dtype, monkeypatch)


# ------------------------------------------------------- prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_compiled_reference(dtype,
                                                          monkeypatch):
    F.check_prefill_and_decode(ARCH, dtype, monkeypatch)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_streams_match_reference_engine(slots):
    F.check_engine_streams(ARCH, slots)


# ------------------------------------------------------------ entry points


def test_serve_cli_serves_contiguously_with_the_reference_audit(capsys):
    F.check_serve_cli(ARCH, capsys)


def test_train_cli_refuses_the_family(tmp_path):
    F.check_train_cli_refuses(ARCH, "image_embed", tmp_path)
