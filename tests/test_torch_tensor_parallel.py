"""The port's sharded training step on the CPU, held against the reference.

Tensor, sequence and expert parallelism with FSDP (the ``train`` rules) for
the dense and moe families: reduced deepseek-7b (and a 6-head variant
whose padded q group, ``g_pad`` 4 against a group of 3, is what a
``model`` axis of 4 takes) and reduced granite-moe, 2 layers, f32, seq 32,
batch 4, weights and batches drawn with numpy (``_torch_tp_ranks``).

Ranks are spawned processes over gloo (``tests/_torch_tp_ranks.py``), each
world size once for the module and all at once: worlds 2 ((1,2) and
(2,1)), 4 ((2,2) and (1,4)) and 8 ((2,2,2)).  The reference's GSPMD runs
at the same meshes come from one JAX subprocess with eight host devices
(``tests/_torch_tp_reference.py``), started beside them.  Tolerances, each
with its reason:

* the dense steps against the port's one-process step and against the
  reference's sharded step: loss, grad norm, every gradient and every
  parameter after one AdamW step, 2e-5 absolute (f32 sums in another
  order); two runs of one mesh bit for bit;
* moe against the reference's sharded step at the same mesh, 2e-5: its
  capacity and its aux are per shard, so a sharded moe step is not the
  one-process step; at capacity factor 8 (nothing drops) and the aux
  weighted 0 it is, 2e-5;
* the losses at (2,2,2) in bf16 against the reference's, 2e-2, the band of
  ``tests/test_integration.py``;
* the layer functions (SwiGLU through the sequence-parallel helpers,
  attention on each rank's heads, the expert-parallel MoE) against the
  reference's under the same mesh, 2e-5; ``pad_group_dim`` exactly;
* the attested steps' collectives and findings, the checkpoint restored
  across meshes (2e-5), and the refusals: vlm and encdec under any model
  axis, ssm and hybrid at a sequence outside the context-parallel
  block's condition (``tests/test_torch_context_parallel.py`` holds them
  where it holds).
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.models.layers import HeadGeom, embed_tokens, pad_group_dim
from repro_torch.parallel import RULESETS, ShardCtx, constrain
from repro_torch.parallel import ctx as T_CTX

jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
BF16_TOL = 2e-2     # tests/test_integration.py:56
DENSE = ["dense@1x2", "dense@2x1", "dense@2x2", "gpad@1x4"]
MOE = ["moe@1x2", "moe@2x1", "moe@2x2"]


def _world(key: str) -> int:
    return int(np.prod([int(n) for n in key.split("@")[1].split("x")]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks by world, the reference's npz, the port's one-process
    results by config)."""
    d = tmp_path_factory.mktemp("tp")
    R.draw_inputs(d / "inputs.npz")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_tp_reference.py"),
         str(d)], cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        handle = R.start((2, 4, 8), d)
        one = {name: R.run_case(name, *R.load(d / "inputs.npz", name)[:2])
               for name in ("dense", "gpad", "moe_cf8")}
        ranks = R.join(handle)
        _, err = ref.communicate(timeout=R.TIMEOUT_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return ranks, np.load(d / "reference.npz"), one


def _result(ranks, key: str, dtype: str = "float32") -> dict:
    return ranks[_world(key)][0][f"{key}/{dtype}"]


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(tree[k], key) if isinstance(tree[k], dict)
                   else {key: tree[k]})
    return out


def _close_trees(got: dict, want: dict, tol: float = TOL) -> None:
    got, want = _flat(got), {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k in got:
        err = float(np.abs(got[k].float().numpy() - want[k]).max())
        assert err <= tol, (k, err)


def _ref_tree(ref, key: str, part: str) -> dict:
    prefix = f"{key}/{part}/"
    return {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}


# ------------------------------------------------------------- helpers


def test_pad_group_dim_and_geometry_match_reference():
    from repro.models import layers as r_layers
    geom = HeadGeom(6, 2, 32, 4)
    r_geom = r_layers.HeadGeom(6, 2, 32, 4)
    assert (geom.group, geom.g_pad, geom.h_run) == (3, 4, 8)
    assert (geom.g_pad, geom.h_run, geom.kv_pad, geom.h_dec) == (
        r_geom.g_pad, r_geom.h_run, r_geom.kv_pad, r_geom.h_dec)
    rng = np.random.default_rng(0)
    for out, shape in ((True, (128, 192)), (False, (192, 128))):
        w = rng.standard_normal(shape).astype(np.float32)
        got = pad_group_dim(torch.from_numpy(w), geom, out).numpy()
        want = np.asarray(r_layers.pad_group_dim(jax.numpy.asarray(w),
                                                 r_geom, out))
        assert np.array_equal(got, want)


def test_constrain_checks_the_local_shape():
    x = torch.zeros(4, 16, 128)
    assert constrain(x, ("act_batch", "act_res", None), (4, 16, 128)) is x
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=(2, 2))
    saved = T_CTX._current()
    T_CTX._state.ctx = ShardCtx(stand_in, RULESETS["train"])
    try:
        local = torch.zeros(2, 16, 128)
        assert constrain(local, ("act_batch", "act_res", None),
                         (4, 32, 128)) is local
        with pytest.raises(ValueError, match="has shape"):
            constrain(x, ("act_batch", "act_res", None), (4, 32, 128))
    finally:
        T_CTX._state.ctx = saved


@pytest.mark.parametrize("key", ["dense@2x2/float32",
                                 "dense@2x2x2/bfloat16",
                                 "moe@2x2x2/bfloat16"])
def test_shardings_equal_the_reference(runs, key):
    """``launch.bind``'s param and batch shardings, as the ranks bound
    them, equal the reference's ``PartitionSpec``s on the same mesh."""
    from repro.configs import ALL_ARCHS, reduced
    from repro.launch.bind import _BATCH_AXES
    from repro.models import build
    from repro.models import params as r_params
    from repro.parallel import ctx as r_ctx
    ranks, _, _ = runs
    case = key.split("/")[0]
    name, dims = case.split("@")
    got = ranks[_world(case)][0][key]["shardings"]
    shape = tuple(int(n) for n in dims.split("x"))
    stand_in = types.SimpleNamespace(axis_names=R.AXES[len(shape)],
                                     devices=np.empty(shape))
    arch = {"dense": "deepseek-7b", "moe": "granite-moe-1b-a400m"}[name]
    r_cfg = dataclasses.replace(reduced(ALL_ARCHS[arch]),
                                n_layers=R.CONFIGS[name].n_layers)
    with r_ctx.bind(stand_in, RULESETS["train"]):
        want = r_params.partition(build(r_cfg).param_specs())
        want_batch = {k: tuple(r_ctx.resolve(_BATCH_AXES[k],
                                             (R.BATCH, R.SEQ)))
                      for k in ("tokens", "labels")}
    want = {k: tuple(v) for k, v in _flat(want).items()}
    assert _flat(got["params"]) == want
    assert got["batch"] == want_batch
    # the DTensor placements: Shard(dim) on each mesh axis a dim takes
    for key, spec in want.items():
        dim_of = {a: d for d, part in enumerate(spec) if part
                  for a in ((part,) if isinstance(part, str) else part)}
        assert _flat(got["placements"])[key] == [
            f"S({dim_of[a]})" if a in dim_of else "R"
            for a in R.AXES[len(shape)]], key


@pytest.mark.parametrize("fn", ["swiglu", "attention", "moe", "moe_aux",
                                "attention_gpad"])
def test_layer_functions_match_reference(runs, fn):
    ranks, ref, _ = runs
    if fn == "attention_gpad":
        got = _result(ranks, "gpad@1x4")["helpers"]["attention"]
        want = ref["gpad@1x4/attention"]
    else:
        got = _result(ranks, "dense@2x2")["helpers"][fn]
        want = ref[f"dense@2x2/{fn}"]
    assert got.shape == want.shape
    assert float(np.abs(got.float().numpy() - want).max()) <= TOL


# ---------------------------------------------------------- the steps


@pytest.mark.parametrize("key", DENSE)
def test_dense_step_equals_one_process(runs, key):
    ranks, _, one = runs
    got = _result(ranks, key)
    want = one[key.split("@")[0]]
    for rank in ranks[_world(key)]:
        res = rank[f"{key}/float32"]
        assert abs(res["loss"] - want["loss"]) <= TOL
        assert abs(res["grad_norm"] - want["grad_norm"]) <= TOL
    _close_trees(got["grads"], _flat(want["grads"]))
    _close_trees(got["params"], _flat(want["params"]))


@pytest.mark.parametrize("key", DENSE + MOE)
def test_step_equals_the_reference_sharded(runs, key):
    ranks, ref, _ = runs
    got = _result(ranks, key)
    assert abs(got["loss"] - float(ref[f"{key}/loss"])) <= TOL
    assert abs(got["grad_norm"] - float(ref[f"{key}/grad_norm"])) <= TOL
    _close_trees(got["grads"], _ref_tree(ref, key, "grads"))
    _close_trees(got["params"], _ref_tree(ref, key, "params"))


def test_same_mesh_twice_is_bit_equal(runs):
    ranks, _, _ = runs
    got = _result(ranks, "dense@1x2")
    again = got["again"]
    assert got["loss"] == again["loss"]
    for part in ("grads", "params"):
        a, b = _flat(got[part]), _flat(again[part])
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_backward_on_another_thread_is_the_same(runs):
    """A CUDA backward runs on autograd's own thread, where the thread-local
    binding is not set: the remat recompute carries the forward's
    (``parallel.ctx.carry``), and the gradients are the same bits."""
    ranks, _, _ = runs
    got = _result(ranks, "dense@1x2")
    a, b = _flat(got["grads"]), _flat(got["thread_grads"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("key", ["moe_cf8@1x2", "moe_cf8@2x2"])
def test_moe_without_drops_equals_one_process(runs, key):
    ranks, _, one = runs
    got, want = _result(ranks, key), one["moe_cf8"]
    assert abs(got["loss"] - want["loss"]) <= TOL
    assert abs(got["grad_norm"] - want["grad_norm"]) <= TOL
    _close_trees(got["grads"], _flat(want["grads"]))
    _close_trees(got["params"], _flat(want["params"]))


def test_moe_capacity_is_per_shard(runs):
    """At capacity factor 1.25 the meshes route differently, as the
    reference's do: per-shard routing is not one process's."""
    ranks, ref, _ = runs
    losses = {k: _result(ranks, k)["loss"] for k in MOE}
    assert len({round(v, 6) for v in losses.values()}) == 3
    for k, v in losses.items():
        assert abs(v - float(ref[f"{k}/loss"])) <= TOL


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_loss_parity_at_2x2x2(runs, name):
    ranks, ref, _ = runs
    for rank in ranks[8]:
        loss = rank[f"{name}@2x2x2/bfloat16"]["loss"]
        assert abs(loss - float(ref[f"{name}@2x2x2/bf16_loss"])) < BF16_TOL


# ------------------------------------------------- program, checkpoint


@pytest.mark.parametrize("key", DENSE + MOE + ["moe_cf8@1x2",
                                               "moe_cf8@2x2"])
def test_attested_step_takes_the_expected_collectives(runs, key):
    ranks, _, _ = runs
    program = _result(ranks, key)["program"]
    kinds = {kind for kind, _ in program["ops"]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    moe_ep = key.startswith("moe") and not key.endswith("x1")
    assert ("all-to-all" in kinds) == moe_ep
    assert program["backends"] == ["gloo"]
    assert program["findings"] == []      # no host-transfer on CPU gloo
    assert program["audit"] == []         # train-transport and, dense,
    # train-no-expert-dispatch pass


def test_moe_exchanges_twice_a_layer_forward(runs):
    """Two all-to-alls a layer in the forward, two again in the remat
    recompute and their two transposes in the backward, each of one
    layer's ``[E, cap, D]`` slots."""
    ranks, _, _ = runs
    program = _result(ranks, "moe@1x2")["program"]
    a2a = [b for kind, b in program["ops"] if kind == "all-to-all"]
    assert len(a2a) == 6 * R.CONFIGS["moe"].n_layers
    assert len(set(a2a)) == 1


def test_checkpoint_restores_across_meshes(runs):
    """Written at (2, 2) after one step, restored at (1, 2): the next
    step's loss equals the run that went on at (2, 2)."""
    ranks, _, _ = runs
    want = _result(ranks, "dense@2x2")["next_loss"]
    for rank in ranks[2]:
        assert abs(rank["restored_loss"] - want) <= TOL


def test_sharded_save_holds_one_leaf_at_a_time(runs):
    """Every rank gathers each leaf of the state once, and no gathered
    leaf (nor the writer's array of it) outlives the next gather."""
    ranks, _, _ = runs
    for rank in ranks[4]:
        save = rank["dense@2x2/float32"]["save"]
        assert save["gathers"] == save["leaves"]
        assert save["live_max"] == 0


def test_sharded_save_fails_on_every_rank_with_its_writer(runs):
    """Rank 0 failing to write ends the save on every rank with an error
    (none waits out the collective timeout), and commits nothing."""
    ranks, _, _ = runs
    for r, rank in enumerate(ranks[4]):
        failed = rank["dense@2x2/float32"]["failed_save"]
        assert failed["committed"] is None
        want = ("OSError: no space left" if r == 0
                else "RuntimeError: checkpoint 1: rank 0 did not write it")
        assert failed["raised"].startswith(want), failed["raised"]


@pytest.mark.parametrize("family", sorted(R.REFUSED))
def test_other_families_refuse_a_model_axis(runs, family):
    """vlm and encdec refuse any model axis; ssm and hybrid run under one
    through the context-parallel block, and refuse a sequence outside its
    condition (``R.REFUSED_SEQ``), naming the condition."""
    ranks, _, _ = runs
    message = ranks[2][0]["refusals"][family]
    assert message is not None and "(1, 2)" in message
    if family in ("ssm", "hybrid"):
        assert "mamba_block_cp" in message
        assert "24 tokens to be a multiple of its scan chunk" in message
    else:
        assert "vlm and encdec under a mesh" in message


@pytest.mark.cuda
def test_embedding_gradient_sums_a_tokens_rows_in_fp32():
    """On the card, a bf16 table's gradient under four tokens of 2,048
    rows each is their fp32 sum rounded once: indexing's backward adds the
    rows in bf16 there, and the table's gradient then differs between one
    process and the data ranks that each sum part of the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the drift is the card's kernel's")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 4, (4, 2048), generator=gen).to(dev)
    g = torch.randn(4, 2048, 256, generator=gen) + 1.0
    g = g.to(dev, torch.bfloat16)
    table = torch.randn(512, 256, generator=gen).to(dev, torch.bfloat16)
    table.requires_grad_(True)
    embed_tokens({"tok": table}, tokens).backward(g)
    want = torch.zeros(512, 256, device=dev).index_add_(
        0, tokens.flatten(), g.reshape(-1, 256).float())
    err = (table.grad.float() - want).norm() / want.norm()
    assert float(err) <= 4e-3     # one bf16 rounding of each sum
