"""What ``tests/test_torch_vlm.py`` and ``tests/test_torch_encdec.py``
share: the reduced configs and weights of both packages, numpy-seeded
batches, the reference's compiled prefill and decode step, the tolerance
helpers, and each check that both families run alike (spec trees, loss
and gradients, prefill and decode, the contiguous engine, both CLIs).

Weights are the reference's ``Model.init_params`` pytree, crossed to the
port through the bit-exact bridge.  A vlm's gates start at zero, which
makes every cross block the identity and would leave the cross path
unheld: ``params`` draws each gate nonzero from a seed, the same numbers
on both sides.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops as kops
from repro_torch.models import build as t_build
from repro_torch.models import params as TP
from repro_torch.serve import Request, ServeEngine

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

VLM, ENCDEC = "llama-3.2-vision-11b", "whisper-medium"
COMPILED_ULPS = 8     # logits and caches against the compiled reference
GRAD_ULPS = 16        # bf16 gradients (caveat d)
LOGIT_TOL = 1e-4      # f32 logits, a logit scale near 3: fp32 sum orders
CACHE_TOL = 2e-5      # f32 cache rows, of the leaf's largest entry
ENGINE_GEOM = dict(max_len=64)


def cfgs(arch):
    from repro.configs import ALL_ARCHS, reduced
    return reduced(ALL_ARCHS[arch]), t_reduced(T_ARCHS[arch])


@functools.lru_cache(maxsize=None)
def params(arch, dtype="bfloat16"):
    """The reference's initial weights as numpy, every vlm gate drawn
    nonzero (|gate| in [0.5, 1.5], either sign, fp32 as declared): as
    initialised for "bfloat16", every leaf cast for "float32"."""
    from repro.models import build
    cfg, _ = cfgs(arch)
    tree = jax.tree.map(np.asarray,
                        build(cfg).init_params(jax.random.PRNGKey(0)))
    if "cross" in tree and "gate_attn" in tree["cross"]:
        rng = np.random.default_rng(99)
        for name in ("gate_attn", "gate_mlp"):
            shape = tree["cross"][name].shape
            gate = rng.uniform(0.5, 1.5, shape) * rng.choice([-1, 1], shape)
            tree["cross"][name] = gate.astype(np.float32)
    if dtype != "bfloat16":
        tree = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a).astype(getattr(jnp, dtype))), tree)
    return tree


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference model of ``arch``, its compiled prefill and decode
    step (compiled once per shape, shared by the tests)."""
    from repro.models import build
    model = build(cfgs(arch)[0])
    return (model, jax.jit(model.prefill, static_argnums=2),
            jax.jit(model.decode_step))


def bf16_array(x):
    """numpy values rounded to bf16 once, as an ml_dtypes array both
    packages read bit for bit (torch through ``from_jax``)."""
    return np.asarray(jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16))


def batch(arch, seed, *, b=2, seq=32, labels=True, frames=32,
          dtype="bfloat16"):
    """A numpy batch: tokens (and labels) of ``seq`` (the decoder's
    length for encdec); the vlm's ``image_embed`` [b, n_image_tokens, D],
    the encdec's ``audio_embed`` [b, frames, D], standard-normal in bf16.
    Under f32 weights (``dtype``) the frames are upcast: the reference's
    encoder scan needs its carry to keep its dtype through a layer, and
    bf16 frames under f32 weights come out f32 (it raises).  The vlm's
    image stays bf16 there, and both packages promote its products."""
    cfg, _ = cfgs(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, seq + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1]}
    if labels:
        out["labels"] = toks[:, 1:]
    if cfg.family == "vlm":
        out["image_embed"] = bf16_array(rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)))
    else:
        out["audio_embed"] = bf16_array(rng.standard_normal(
            (b, frames, cfg.d_model)))
        if dtype == "float32":
            out["audio_embed"] = out["audio_embed"].astype(np.float32)
    return out


def to_torch(tree):
    return TP.from_jax(tree)


def np_(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def rel(got, want):
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def ulp_close(got, want, ulps):
    """Within ``ulps`` bf16 ulps of the largest reference value."""
    got, want = np_(got), np_(want)
    tol = ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    return tol


def logits_close(got, want, ulps=COMPILED_ULPS):
    """Logits within the ulp budget; argmax equal wherever the reference's
    top-2 gap exceeds twice it (the near-tie rule of
    ``tests/test_torch_decode.py``)."""
    tol = ulp_close(got, want, ulps)
    want = np_(want)
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert (np_(got).argmax(-1) == want.argmax(-1))[clear].all()


def f32_cotangents(monkeypatch):
    """The reference's residual boundary pins every cotangent to bf16,
    which JAX refuses for an f32 primal (caveat f): the pin becomes the
    identity inside the calling test only."""
    import repro.models.stack as r_stack
    monkeypatch.setattr(r_stack, "_bf16_tangent", lambda x: x)


def reference_positions(monkeypatch):
    """The port's encdec takes the reference's own bf16 position table,
    inside the calling test only.  The two tables differ in a few entries
    by one bf16 ulp (XLA's f32 ``exp`` is not PyTorch's;
    ``test_sinusoidal_positions_match_reference`` holds that), which moves
    f32 results by more than sum orders do: 2 of 136 x 128 entries move
    an f32 gradient by 3e-5.  With one table the f32 checks hold the rest
    of the model at sum-order tolerance."""
    from repro.models.layers import sinusoidal_positions as ref
    from repro_torch.models import decode as t_decode
    from repro_torch.models import stack as t_stack

    def positions(seq, d, offset=0, device=None):
        if isinstance(offset, torch.Tensor):
            device, offset = offset.device, jnp.asarray(offset.cpu().numpy())
        return to_torch({"p": np.asarray(ref(seq, d, offset))})["p"].to(
            device or "cpu")

    for module in (t_stack, t_decode):
        monkeypatch.setattr(module, "sinusoidal_positions", positions)


class FlashSpy:
    """Records the keyword arguments of each call to the flash entry
    point (its plain version here)."""

    def __enter__(self):
        self.calls, self.saved = [], kops.flash_attention
        kops.flash_attention = lambda *a, **kw: (self.calls.append(kw)
                                                 or self.saved(*a, **kw))
        return self

    def __exit__(self, *exc):
        kops.flash_attention = self.saved


def leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ------------------------------------------------------------------ checks


def check_param_specs(arch):
    """Keys, shapes, axes, dtypes and initializers of the full-width tree,
    and the total and active parameter counts."""
    from repro.configs import ALL_ARCHS
    from repro.models import stack

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, path + (key,)).items()}
        dtype = (str(tree.dtype).replace("torch.", "")
                 if isinstance(tree.dtype, torch.dtype)
                 else jnp.dtype(tree.dtype).name)
        return {path: (tuple(tree.shape), tuple(tree.axes), dtype, tree.init)}

    assert flat(TP.param_specs(T_ARCHS[arch])) == flat(
        stack.param_specs(ALL_ARCHS[arch]))
    assert T_ARCHS[arch].param_count() == stack.param_count(ALL_ARCHS[arch])
    assert T_ARCHS[arch].active_param_count() == stack.param_count(
        ALL_ARCHS[arch], active_only=True)


def check_weight_bridge(arch):
    raw = params(arch)
    tparams = to_torch(raw)
    flat = jax.tree_util.tree_flatten_with_path(raw)[0]
    assert len(flat) == len(TP.leaves(tparams))
    for path, want in flat:
        got = leaf(tparams, path)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, path
        view = (np.int16, torch.int16) if want.dtype.itemsize == 2 else (
            np.int32, torch.int32)
        np.testing.assert_array_equal(got.view(view[1]).numpy(),
                                      np.array(want).view(view[0]),
                                      err_msg=str(path))


def check_cache_specs(arch):
    cfg_r, cfg_t = cfgs(arch)
    from repro.models import build
    want = jax.tree.map(lambda s: (tuple(s.shape), jnp.dtype(s.dtype).name),
                        build(cfg_r).cache_specs(3, 40))
    got = TP.tree_map(lambda s: (tuple(s.shape),
                                 str(s.dtype).replace("torch.", "")),
                      t_build(cfg_t).cache_specs(3, 40))
    assert got == want


def check_input_specs(arch):
    """The train and prefill declarations equal the reference's, names in
    order; ``sample_batch`` draws them on the given device.  The decode
    kind (the reference's dry-run input) is not declared."""
    from repro.configs.base import ShapeConfig as RShape
    from repro.models import build
    from repro_torch.configs.base import ShapeConfig
    cfg_r, cfg_t = cfgs(arch)
    model = t_build(cfg_t)
    for kind in ("train", "prefill"):
        want = build(cfg_r).input_specs(RShape("s", kind, 48, 3))
        got = model.input_specs(ShapeConfig("s", kind, 48, 3))
        assert list(got) == list(want), kind
        for name, (dims, dtype) in got.items():
            assert dims == want[name].shape, (kind, name)
            assert str(dtype).replace("torch.", "") == jnp.dtype(
                want[name].dtype).name, (kind, name)
        sample = model.sample_batch(ShapeConfig("s", kind, 48, 3), 0, "cpu")
        for name, t in sample.items():
            assert tuple(t.shape) == got[name][0] and t.dtype == got[name][1]
        assert int(sample["tokens"].max()) < cfg_t.vocab_size
        embed = [t for n, t in sample.items() if n.endswith("_embed")][0]
        assert 0.9 < float(embed.float().std()) < 1.1
    with pytest.raises(ValueError, match="unknown batch kind"):
        model.input_specs(ShapeConfig("s", "decode", 48, 3))


def check_loss_and_grads(arch, remat, dtype, monkeypatch, grad_tol=1e-5,
                         **batch_kw):
    """``Model.loss`` and every gradient against ``jax.value_and_grad`` of
    the reference's loss: f32 gradients within ``grad_tol`` relative
    (norm; caveat f's pin lifted) and the loss 1e-5, bf16 loss 1e-3
    relative and each gradient within ``GRAD_ULPS`` of its largest entry
    (caveat d)."""
    from repro.models import build
    cfg_r, cfg_t = cfgs(arch)
    if dtype == "float32":
        f32_cotangents(monkeypatch)
        if cfg_t.family == "encdec":
            reference_positions(monkeypatch)
    weights = params(arch, dtype)
    data = batch(arch, 4, dtype=dtype, **batch_kw)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: build(cfg_r).loss(p, b, remat=remat, z_loss=1e-4),
        has_aux=True))(weights, data)
    live = TP.tree_map(lambda t: t.requires_grad_(), to_torch(weights))
    got, _ = t_build(cfg_t).loss(live, to_torch(data), remat=remat,
                                 z_loss=1e-4)
    got.backward()
    loss_tol = 1e-5 if dtype == "float32" else 1e-3
    assert abs(got.item() - float(want)) <= loss_tol * abs(float(want))
    got_g = TP.tree_map(lambda t: t.grad, live)
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(flat) == len(TP.leaves(got_g))
    for path, w in flat:
        g = leaf(got_g, path)
        assert str(g.dtype).replace("torch.", "") == w.dtype.name, path
        if dtype == "float32":
            assert rel(g, w) <= grad_tol, (path, rel(g, w))
        else:
            ulp_close(g, w, GRAD_ULPS)


def check_prefill_and_decode(arch, dtype, monkeypatch, **batch_kw):
    """``Model.prefill`` (logits and every cache leaf, decode headroom on
    the self cache only) against the reference's compiled prefill, then
    four ``decode_step`` calls continuing it against its compiled step
    (the cross cache read only).  f32: logits within ``LOGIT_TOL``, caches
    within ``CACHE_TOL`` of their largest entry (encdec's decoder rows past
    its first layer carry the encoder's f32 differences through the cross
    attention: 1.3e-5 of the scale measured); bf16: both within
    ``COMPILED_ULPS`` of their scale, argmax by the near-tie rule."""
    _, cfg_t = cfgs(arch)
    if dtype == "float32" and cfg_t.family == "encdec":
        reference_positions(monkeypatch)
    _, prefill, step = reference(arch)
    weights = params(arch, dtype)
    tparams = to_torch(weights)
    tmodel = t_build(cfg_t)
    data = batch(arch, 6, labels=False, dtype=dtype, **batch_kw)
    s = data["tokens"].shape[1]
    want, jcache = prefill(weights, data, s + 8)
    got, tcache = tmodel.prefill(tparams, to_torch(data), s + 8)

    def close(a, b, tol):
        if dtype == "float32":
            if tol == CACHE_TOL:
                tol *= float(np.abs(np_(b)).max())
            np.testing.assert_allclose(np_(a), np_(b), rtol=0, atol=tol)
        elif tol == LOGIT_TOL:
            logits_close(a, b)
        else:
            ulp_close(a, b, COMPILED_ULPS)

    close(got, want, LOGIT_TOL)
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(TP.leaves(tcache)) == 4
    for path, w in flat:
        t = leaf(tcache, path)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).replace("torch.", "") == w.dtype.name, path
        close(t, w, CACHE_TOL)
    cross = np_(tcache["cross"]["k"]).copy()
    rng = np.random.default_rng(7)
    for i in range(4):
        tok = rng.integers(0, cfg_t.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full((2,), s + i, np.int32)
        want, jcache = step(weights, jcache, jnp.asarray(tok),
                            jnp.asarray(pos))
        got = tmodel.decode_step(tparams, tcache, torch.tensor(tok),
                                 torch.tensor(pos))
        close(got, want, LOGIT_TOL)
    np.testing.assert_array_equal(np_(tcache["cross"]["k"]), cross)
    close(tcache["self"]["k"], jcache["self"]["k"], CACHE_TOL)


def prompts(vocab=512, n=3, length=12):
    rng = np.random.default_rng(8)
    return [rng.integers(0, vocab, size=length).tolist() for _ in range(n)]


def reference_streams(arch, slots, max_new=6):
    """The reference's contiguous engine on ``prompts()``, greedy, f32
    weights, each decode call's host inputs copied before the step sees
    them (caveat a; test-side only)."""
    from repro.serve.engine import Request as RRequest
    from repro.serve.engine import ServeEngine as RServe
    model, _, step = reference(arch)
    eng = RServe(model, params(arch, "float32"), slots=slots, **ENGINE_GEOM)

    def greedy(weights, cache, tok, pos):
        logits, cache = step(weights, cache, jnp.asarray(np.array(tok)),
                             jnp.asarray(np.array(pos)))
        return jnp.argmax(logits, axis=-1), cache

    eng._decode = greedy
    done = eng.run([RRequest(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts())])
    return {r.rid: r.out for r in done}


def check_engine_streams(arch, slots, max_new=6):
    """The port's contiguous ``ServeEngine`` (f32 weights, zero cross
    caches as in the reference) gives the reference engine's greedy
    streams token for token."""
    _, cfg_t = cfgs(arch)
    eng = ServeEngine(t_build(cfg_t), to_torch(params(arch, "float32")),
                      slots=slots, device="cpu", **ENGINE_GEOM)
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts())])
    got = {r.rid: r.out for r in done}
    assert eng.report()["served"] == 3
    assert all(len(out) == max_new for out in got.values())
    assert (eng.cache["cross"]["k"] == 0).all()
    assert got == reference_streams(arch, slots, max_new)


def check_serve_cli(arch, capsys):
    """Asked for the paged engine, the CLI serves through the contiguous
    one, as the reference's does; its report carries every key of the
    reference's and the audit's verdict equals the reference's."""
    from repro.launch.serve import serve as r_serve
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", arch, "--requests", "3",
          "--max-new", "4"])
    got = json.loads(capsys.readouterr().out)
    want = r_serve(arch, n_requests=3, max_new=4)
    assert set(want) <= set(got)
    assert got["engine"] == want["engine"] == "contiguous"
    assert got["served"] == want["served"] == 3
    assert got["audit"]["gate_ok"] == want["audit"]["gate_ok"]
    assert [f["kind"] for f in got["audit"]["findings"]] == [
        f["kind"] for f in want["audit"]["findings"]]


def check_train_cli_refuses(arch, embed, tmp_path):
    """The data pipeline yields tokens and labels only, so the launcher
    refuses the family, naming the embeddings it lacks (the reference's
    launcher fails on them later, in ``device_put``)."""
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match=embed):
        train(arch, steps=1, device="cpu", out_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())
