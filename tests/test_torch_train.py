"""The port's training path against the JAX reference, on the CPU, at
``reduced(deepseek-7b)`` scale cut to 2 layers (d_model 128, 4 q heads over
2 kv heads, head dim 32, vocab 512).

Both sides start from the same weights and optimizer state (the reference's
``init_train_state`` through ``train_state_from_jax``, bit for bit) and the
same batches (numpy).  Tolerances, each with its reason:

* the port's ``Model.loss`` against ``Model(use_pallas=True).loss`` (the
  Pallas flash kernel in interpret mode, fp32 P rounded once, as the port's
  plain version): f32 2e-6 relative, bf16 2e-3 relative (caveat d of the
  roadmap: the compiled reference keeps some residual adds in fp32 that
  the port rounds to bf16);
* loss and every gradient against ``jax.value_and_grad`` of
  ``Model(use_pallas=False).loss`` (the jnp attention the reference trains
  through): f32 1e-5 relative norm (sum orders only), bf16 2e-2 relative
  norm (that path rounds P to bf16 before P·V; the port's does not).  In
  f32 the reference's bf16 pin on its residual cotangents is lifted
  (``_f32_cotangents``): JAX refuses it for f32 parameters;
* ``adamw.apply`` on identical fp32 gradients: 1e-6;
* three ``make_train_step`` steps against the reference's jitted step in
  f32: losses 1e-5 relative, parameters 1e-4 relative norm (int8
  compression 1e-3: a gradient a rounding away from a quantisation edge
  moves by one quantum);
* the data pipeline, checkpoints and a resumed run: exact.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import (RunConfig, ShapeConfig, TrainConfig)
from repro_torch.data.pipeline import DataConfig, DataPipeline, batch_at
from repro_torch.launch.train import train
from repro_torch.models import build as t_build
from repro_torch.models import params as P
from repro_torch.models.attention import full_attention
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step, train_state_from_jax)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ARCH = "deepseek-7b"
SEQ, BATCH = 128, 2


def _cfgs():
    from repro.configs import ALL_ARCHS, reduced
    ref = dataclasses.replace(reduced(ALL_ARCHS[ARCH]), n_layers=2)
    port = dataclasses.replace(t_reduced(T_ARCHS[ARCH]), n_layers=2)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_state(dtype: str):
    """The reference's initial TrainState as numpy, params in ``dtype``."""
    from repro.models import build
    from repro.optim import adamw as r_adamw
    from repro.train.step import TrainState as RState
    cfg, _ = _cfgs()
    params = build(cfg).init_params(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), params)
    return jax.tree.map(np.asarray, RState(params, r_adamw.init(params)))


def _batch(seed=0, seq=SEQ, batch=BATCH, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _f32_cotangents(monkeypatch):
    """The reference's residual boundary (``stack._res``) pins every
    cotangent to bf16, which JAX refuses for an f32 primal: its gradient
    cannot be taken with f32 parameters as it stands.  For the f32 cases
    the pin becomes the identity (the forward is the identity either way),
    inside this test only."""
    import repro.models.stack as r_stack
    monkeypatch.setattr(r_stack, "_bf16_tangent", lambda x: x)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- configs


def test_train_configs_match_reference():
    """The copied ShapeConfig and TrainConfig equal the reference's, field
    for field with defaults; RunConfig's fields are the reference's less
    the mesh, the sharding rules and ``use_pallas``."""
    from repro.configs import base as r_base
    from repro_torch.configs import base as t_base
    for name in ("ShapeConfig", "TrainConfig"):
        r_fields = [(f.name, f.default) for f in
                    dataclasses.fields(getattr(r_base, name))]
        t_fields = [(f.name, f.default) for f in
                    dataclasses.fields(getattr(t_base, name))]
        assert r_fields == t_fields, name
    assert {f.name for f in dataclasses.fields(RunConfig)} == (
        {f.name for f in dataclasses.fields(r_base.RunConfig)}
        - {"mesh", "rules", "use_pallas"})


# ---------------------------------------------------------- attention, loss


@pytest.mark.parametrize("seq,chunk", [(128, 1024), (200, 1024), (200, 100)])
def test_full_attention_matches_reference(seq, chunk):
    """Both routes of ``full_attention`` in f32: S 128 takes the flash
    route (the reference's Pallas kernel in interpret mode), S 200 the
    jnp ``_attend``, whole or in chunks of 100 query rows."""
    from repro.models.attention import full_attention as r_full
    cfg_r, cfg_t = _cfgs()
    params = _ref_state("float32").params["layers"]["attn"]
    p_r = jax.tree.map(lambda a: jnp.asarray(a[0]), params)
    p_t = P.tree_map(lambda t: t[0], P.from_jax(params))
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg_t.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(r_full, cfg_r, chunk=chunk,
                                     use_pallas=seq % 128 == 0))(
        p_r, jnp.asarray(x))
    got = full_attention(cfg_t, p_t, torch.tensor(x), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 2e-3)])
def test_loss_matches_reference_flash_path(dtype, tol):
    from repro.models import build
    cfg_r, cfg_t = _cfgs()
    state = _ref_state(dtype)
    batch = _batch()
    want, want_m = jax.jit(lambda p, b: build(cfg_r, use_pallas=True).loss(
        p, b, z_loss=1e-4))(state.params, batch)
    got, got_m = t_build(cfg_t).loss(P.from_jax(state.params), _tb(batch),
                                     z_loss=1e-4)
    assert abs(float(got) - float(want)) <= tol * abs(float(want))
    assert abs(float(got_m["z_loss"]) - float(want_m["z_loss"])) <= (
        tol * abs(float(want_m["z_loss"])))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax_value_and_grad(dtype, tol, remat,
                                                     monkeypatch):
    from repro.models import build
    if dtype == "float32":
        _f32_cotangents(monkeypatch)
    cfg_r, cfg_t = _cfgs()
    state = _ref_state(dtype)
    batch = _batch(seed=1)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: build(cfg_r).loss(p, b, remat=remat, z_loss=1e-4),
        has_aux=True))(state.params, batch)
    params = P.tree_map(lambda t: t.requires_grad_(),
                        P.from_jax(state.params))
    got, _ = t_build(cfg_t).loss(params, _tb(batch), remat=remat,
                                 z_loss=1e-4)
    got.backward()
    assert abs(got.item() - float(want)) <= tol * abs(float(want))
    got_g = P.leaves(P.tree_map(lambda t: t.grad, params))
    want_leaves = jax.tree.leaves(want_g)
    assert len(got_g) == len(want_leaves)
    for g, w in zip(got_g, want_leaves):
        assert g.dtype == getattr(torch, dtype)
        assert _rel(_np(g), w) <= tol, (g.shape, _rel(_np(g), w))


# -------------------------------------------------------------- optimizer


def test_adamw_apply_matches_reference():
    """One update on identical fp32 gradients, twice in a row (bias
    corrections at steps 1 and 2), with clipping active."""
    from repro.configs.base import TrainConfig as RTrain
    from repro.optim import adamw as r_adamw
    state = _ref_state("bfloat16")
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, state.params) for _ in range(2)]
    tc = dict(warmup_steps=2, total_steps=10)
    r_params, r_opt = state.params, state.opt
    t_state = train_state_from_jax(state)
    t_params, t_opt = t_state.params, t_state.opt
    for g in grads:
        r_params, r_opt, r_m = jax.jit(
            lambda o, g, p: r_adamw.apply(RTrain(**tc), o, g, p))(
            r_opt, g, r_params)
        t_params, t_opt, t_m = adamw.apply(TrainConfig(**tc), t_opt,
                                           P.from_jax(g), t_params)
    assert int(t_opt.step) == int(r_opt.step) == 2
    for key in ("grad_norm", "lr"):
        assert abs(float(t_m[key]) - float(r_m[key])) <= 1e-6 * abs(
            float(r_m[key]))
    for tree_t, tree_r in ((t_opt.master, r_opt.master), (t_opt.m, r_opt.m),
                           (t_opt.v, r_opt.v), (t_params, r_params)):
        for a, b in zip(P.leaves(tree_t), jax.tree.leaves(tree_r)):
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-6)


def test_adamw_slices_give_the_same_bits(monkeypatch):
    """A leaf updated in slices along its first dimension (as large
    stacked leaves are) ends bit for bit where one pass over it ends:
    parameters, master, m and v, over two steps with clipping active."""
    state = _ref_state("bfloat16")
    rng = np.random.default_rng(4)
    grads = P.from_jax(jax.tree.map(lambda a: rng.standard_normal(
        a.shape).astype(np.float32) * 0.05, state.params))
    grads = P.tree_map(lambda t: t.to(torch.bfloat16), grads)
    runs = []
    for elements in (adamw.SLICE_ELEMENTS, 1000):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", elements)
        t_state = train_state_from_jax(state)
        params, opt = t_state.params, t_state.opt
        for _ in range(2):
            params, opt, _ = adamw.apply(TrainConfig(warmup_steps=2),
                                         opt, grads, params)
        runs.append([t for tree in (params, opt.master, opt.m, opt.v)
                     for t in P.leaves(tree)])
    assert len(adamw._slices(params["embed"]["tok"])) > 1   # sliced: 1000
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant,tol", [
    ({}, 1e-4), ({"microbatches": 2}, 1e-4),
    ({"grad_compress": "int8_ef"}, 1e-3)])
def test_train_steps_track_reference(variant, tol, monkeypatch):
    """Three steps through ``make_train_step`` against the reference's
    jitted step, f32 parameters, remat full."""
    _f32_cotangents(monkeypatch)
    from repro.configs.base import RunConfig as RRun
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import TrainConfig as RTrain
    from repro.models import build
    from repro.train.step import make_train_step as r_make
    cfg_r, cfg_t = _cfgs()
    tc = dict(warmup_steps=1, total_steps=3, **variant)
    r_step = jax.jit(r_make(build(cfg_r), RRun(
        cfg_r, RShape("t", "train", SEQ, BATCH), train=RTrain(**tc))))
    t_step = make_train_step(t_build(cfg_t), RunConfig(
        cfg_t, ShapeConfig("t", "train", SEQ, BATCH), TrainConfig(**tc)))
    r_state = _ref_state("float32")
    t_state = train_state_from_jax(r_state)
    for i in range(3):
        batch = _batch(seed=10 + i)
        r_state, r_m = r_step(r_state, batch)
        t_state, t_m = t_step(t_state, _tb(batch))
        assert abs(float(t_m["loss"]) - float(r_m["loss"])) <= 1e-5 * abs(
            float(r_m["loss"])), i
    for a, b in zip(P.leaves(t_state.params),
                    jax.tree.leaves(r_state.params)):
        assert _rel(_np(a), b) <= tol, (a.shape, _rel(_np(a), b))


def test_wide_bf16_steps_track_reference():
    """Four steps of the default schedule (lr 3e-6 to 1.2e-5, warmup 100)
    with bf16 parameters at d_model 1024, head dim 128, 2 layers, vocab
    4096, 4 x 128 tokens, against the reference's jitted step from the
    same state.  The loss is not monotone here (it rises at the second
    step on both sides): this holds that the port's optimizer follows the
    reference's step for step at a wide, bf16 setting, swings included.
    Losses and parameters 5e-4 relative (norm) each: bf16 gradients, both
    seen under 1e-4."""
    from repro.configs import ALL_ARCHS
    from repro.configs.base import RunConfig as RRun
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import TrainConfig as RTrain
    from repro.models import build
    from repro.optim import adamw as r_adamw
    from repro.train.step import TrainState as RState
    from repro.train.step import make_train_step as r_make
    wide = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=8,
                head_dim=128, d_ff=2752, vocab_size=4096)
    cfg_r = dataclasses.replace(ALL_ARCHS[ARCH], **wide)
    cfg_t = dataclasses.replace(T_ARCHS[ARCH], **wide)
    seq, batch = 128, 4
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          build(cfg_r).init_params(jax.random.PRNGKey(0)))
    r_state = jax.tree.map(np.asarray, RState(params, r_adamw.init(params)))
    t_state = train_state_from_jax(r_state)
    r_step = jax.jit(r_make(build(cfg_r), RRun(
        cfg_r, RShape("t", "train", seq, batch), train=RTrain())))
    t_step = make_train_step(t_build(cfg_t), RunConfig(
        cfg_t, ShapeConfig("t", "train", seq, batch), TrainConfig()))
    losses = []
    for i in range(4):
        b = _batch(seed=10 + i, seq=seq, batch=batch, vocab=4096)
        r_state, r_m = r_step(r_state, b)
        t_state, t_m = t_step(t_state, _tb(b))
        losses.append((float(r_m["loss"]), float(t_m["loss"])))
        assert abs(losses[-1][1] - losses[-1][0]) <= 5e-4 * losses[-1][0], (
            i, losses)
    print("reference, port losses:", losses)
    for a, b in zip(P.leaves(t_state.params),
                    jax.tree.leaves(r_state.params)):
        assert a.dtype == torch.bfloat16
        assert _rel(_np(a), b) <= 5e-4, (a.shape, _rel(_np(a), b))


# ------------------------------------------------------------------- data


def test_data_pipeline_equals_reference():
    from repro.data.pipeline import DataConfig as RData
    from repro.data.pipeline import DataPipeline as RPipe
    from repro.data.pipeline import batch_at as r_batch_at
    kw = dict(vocab_size=512, seq_len=64, global_batch=4, seed=3,
              n_hosts=2, host_id=1)
    t_pipe, r_pipe = DataPipeline(DataConfig(**kw), start_step=5), RPipe(
        RData(**kw), start_step=5)
    try:
        for _ in range(3):
            (ts, tb), (rs, rb) = next(t_pipe), next(r_pipe)
            assert ts == rs
            for k in rb:
                np.testing.assert_array_equal(tb[k], rb[k])
                np.testing.assert_array_equal(
                    batch_at(DataConfig(**kw), ts)[k],
                    r_batch_at(RData(**kw), rs)[k])
    finally:
        t_pipe.close()
        r_pipe.close()


# ------------------------------------------------------------ checkpoints


def _assert_state_equals_numpy(t_state, r_state):
    for (key, a), b in zip(_named(t_state), jax.tree.leaves(r_state)):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), b.view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=key)


def _named(state):
    from repro_torch.runtime.checkpoint import _flatten
    return list(_flatten(state).items())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's CheckpointManager writes a trained state (bf16
    params, fp32 optimizer state, step 1); the port's restores it bit for
    bit under the same key names, and the reverse holds too."""
    from repro.runtime.checkpoint import CheckpointManager as RManager
    r_state = _ref_state("bfloat16")
    r_state = r_state._replace(opt=r_state.opt._replace(
        step=np.asarray(1, np.int32),
        m=jax.tree.map(lambda a: a + 0.5, r_state.opt.m)))
    RManager(tmp_path / "ref").save(1, r_state)
    like = train_state_from_jax(_ref_state("bfloat16"))
    restored = CheckpointManager(tmp_path / "ref").restore(None, like=like)
    assert isinstance(restored, TrainState)
    _assert_state_equals_numpy(restored, r_state)

    CheckpointManager(tmp_path / "port").save(1, restored)
    back = RManager(tmp_path / "port").restore(1, like=r_state)
    _assert_state_equals_numpy(restored, back)


def test_checkpoint_verifies_hash_and_shapes(tmp_path):
    _, cfg = _cfgs()
    model = t_build(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json"
                           ).read_text())
    assert manifest["dtypes"]["params/embed/tok"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"

    other = t_build(dataclasses.replace(cfg, d_ff=cfg.d_ff * 2))
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore(3, like=init_train_state(
            other, torch.Generator().manual_seed(0), "cpu"))
    shard = tmp_path / "step_00000003" / "host_00000.npz"
    shard.write_bytes(shard.read_bytes()[:-8] + b"corrupt!")
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(3, like=state)


# ---------------------------------------------------------------- launcher


def test_resume_reproduces_the_uninterrupted_losses(tmp_path):
    kw = dict(steps=4, total_steps=4, ckpt_every=2, seq_len=32,
              global_batch=2, device="cpu")
    full = train(ARCH, out_dir=str(tmp_path / "full"), **kw)
    part = dict(kw, steps=2)
    first = train(ARCH, out_dir=str(tmp_path / "cut"), **part)
    resumed = train(ARCH, out_dir=str(tmp_path / "cut"), resume=True, **kw)
    assert first["losses"] == full["losses"][:2]
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["audit"]["trace"]["ckpt-restore"] == 1
    assert full["loss_decreased"]
    assert set(full) >= {"arch", "steps", "first_loss", "last_loss",
                         "loss_decreased", "wall_s", "fleet_efficiency",
                         "diagnostics", "audit", "image_hash", "wireup"}


def test_train_cli_runs_on_the_cpu_and_asks_for_a_gpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", ARCH, "--steps", "2", "--seq-len",
          "32", "--global-batch", "2", "--out", str(tmp_path)])
    res = json.loads(capsys.readouterr().out)
    assert res["device"] == "cpu" and np.isfinite(res["last_loss"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(ARCH, steps=1, out_dir=str(tmp_path / "gpu"))
