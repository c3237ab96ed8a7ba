"""The port's context-parallel Mamba2 training on the CPU, held against the
reference.

``ssm.mamba_block_cp`` runs each rank's sequence shard of every Mamba2
layer with the weights whole (``params.whole``): the conv's halo comes from
the previous rank (``comm.shift``), the local scan starts from zero, and
the incoming state is the prefix of every earlier rank's final state and
decay (``comm.all_gather``, ``_cp_prefix``).  Reduced mamba2 (2 layers)
and zamba2 (two groups of a Mamba2 layer and the shared attention block),
f32, seq 32, batch 4, weights and batches drawn with numpy
(``_torch_cp_ranks``; ``a_log`` drawn so a rank's state reaches the next
rank's tokens).

Ranks are spawned processes over gloo (``tests/_torch_cp_ranks.py``), each
world size once for the module and all at once: worlds 2 ((1,2) and
(2,1)), 4 ((1,4) and (2,2)) and 8 ((2,2,2)).  The reference's runs at the
same meshes come from one JAX subprocess with eight host devices
(``tests/_torch_cp_reference.py``), started beside them.  Tolerances, each
with its reason:

* ``_cp_prefix`` against the reference's, 1e-6 relative (the same sums);
* ``comm.shift`` exactly (a copy);
* ``mamba_block_cp`` at (1,2) and (1,4) against the reference's under the
  same mesh: y, the conv tail, the final state and every gradient, 2e-5
  of the larger of 1 and the quantity's largest magnitude (f32 sums in
  another order: the final state reaches 60 and ``a_log``'s gradient 170,
  where one ulp is 4e-6 and 1.5e-5; the unsharded block against the
  reference's ``mamba_block`` differs by 2.7e-5 in that state already);
* the ssm and hybrid steps against the port's one-process step and the
  reference's GSPMD step: loss, grad norm, every gradient and every
  parameter after one AdamW step, 2e-5; two runs of one mesh bit for bit;
* the losses at (2,2,2) in bf16 against the reference's, 2e-2, the band of
  ``tests/test_integration.py``;
* the attested steps' collectives and findings, a hybrid checkpoint
  restored across meshes (2e-5), and the refusal of a sequence outside
  the block's condition.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cp_ranks as R
import _torch_tp_ranks as T
from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.models.ssm import _cp_prefix

jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
BF16_TOL = 2e-2     # tests/test_integration.py:56
STEPS = [f"{name}@{dims}" for name in ("ssm", "hybrid")
         for dims in ("1x2", "2x1", "1x4", "2x2")]
MODEL_AXIS = [k for k in STEPS if not k.endswith("x1")]


def _world(key: str) -> int:
    return int(np.prod([int(n) for n in key.split("@")[1].split("x")]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks by world, the reference's npz, the port's one-process
    results by config)."""
    d = tmp_path_factory.mktemp("cp")
    R.draw_inputs(d / "inputs.npz")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_cp_reference.py"),
         str(d)], cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        handle = R.start((2, 4, 8), d)
        one = {name: R.run_case(name, *R.load(d / "inputs.npz", name)[:2])
               for name in R.CONFIGS}
        ranks = T.join(handle)
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


def _close(got: torch.Tensor, want, tol: float = TOL, what: str = "",
           scaled: bool = False):
    """``|got - want| <= tol`` everywhere; ``scaled``: ``tol`` times the
    larger of 1 and ``want``'s largest magnitude."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.float().numpy() - want).max())
    if scaled:
        tol *= max(1.0, float(np.abs(want).max()))
    assert err <= tol, (what, err, tol)


def _close_trees(got: dict, want: dict, tol: float = TOL,
                 scaled: bool = False) -> None:
    got = _flat(got)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], tol, k, scaled)


def _ref_tree(ref, prefix: str) -> dict:
    prefix += "/"
    return {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("tp", [2, 4])
def test_cp_prefix_matches_reference(tp):
    """Each shard's incoming state and the global final state, and their
    gradients, equal the reference's ``_cp_prefix``."""
    from repro.models.ssm import _cp_prefix as r_cp_prefix
    rng = np.random.default_rng(tp)
    s_all = rng.standard_normal((tp, 2, 3, 4, 5)).astype(np.float32)
    d_all = rng.uniform(0.1, 0.9, (tp, 2, 3)).astype(np.float32)
    w_in = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w_fin = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    for i in range(tp):
        s_t = torch.from_numpy(s_all).requires_grad_(True)
        d_t = torch.from_numpy(d_all).requires_grad_(True)
        got, final = _cp_prefix(s_t, d_t, i)
        ((got * torch.from_numpy(w_in)).sum()
         + (final * torch.from_numpy(w_fin)).sum()).backward()

        def r_loss(s, d):
            g, f = r_cp_prefix(s, d, jax.numpy.asarray(i))
            return (g * w_in).sum() + (f * w_fin).sum(), (g, f)
        (_, (want, want_final)), (gs, gd) = jax.value_and_grad(
            r_loss, argnums=(0, 1), has_aux=True)(s_all, d_all)
        for a, b in ((got, want), (final, want_final), (s_t.grad, gs),
                     (d_t.grad, gd)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_shift_passes_to_the_next_rank(runs, world):
    """Rank i's output is rank i-1's tensor (rank 0's zeros), in its own
    dtype; its gradient is rank i+1's cotangent (the last rank's zeros)."""
    ranks, _, _ = runs
    key = f"ssm@1x{world}/float32"
    for r, rank in enumerate(ranks[world]):
        got = rank[key]["shift"]
        assert got["y"].dtype == got["grad"].dtype == torch.bfloat16
        assert torch.equal(got["y"], torch.full_like(got["y"], float(r)))
        want = 10.0 + r + 1 if r + 1 < world else 0.0
        assert torch.equal(got["grad"], torch.full_like(got["grad"], want))


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_block_matches_reference(runs, mesh):
    """``mamba_block_cp`` with ``return_state``: y, the last shard's conv
    tail, the global final state, and the gradients in x and every
    parameter, against the reference's ``shard_map`` body on the same
    mesh."""
    ranks, ref, _ = runs
    got = _result(ranks, f"ssm@{mesh}")["block"]
    prefix = f"ssm@{mesh}/block"
    for part in ("y", "tail", "state", "dx"):
        _close(got[part], ref[f"{prefix}/{part}"], what=part, scaled=True)
    _close_trees(got["grads"], _ref_tree(ref, f"{prefix}/grads"),
                 scaled=True)


# ---------------------------------------------------------- the steps


@pytest.mark.parametrize("key", STEPS)
def test_step_equals_one_process(runs, key):
    ranks, _, one = runs
    got = _result(ranks, key)
    want = one[key.split("@")[0]]
    for rank in ranks[_world(key)]:
        res = rank[f"{key}/float32"]
        assert abs(res["loss"] - want["loss"]) <= TOL
        assert abs(res["grad_norm"] - want["grad_norm"]) <= TOL
    _close_trees(got["grads"], _flat(want["grads"]))
    _close_trees(got["params"], _flat(want["params"]))


@pytest.mark.parametrize("key", STEPS)
def test_step_equals_the_reference_sharded(runs, key):
    ranks, ref, _ = runs
    got = _result(ranks, key)
    assert abs(got["loss"] - float(ref[f"{key}/loss"])) <= TOL
    assert abs(got["grad_norm"] - float(ref[f"{key}/grad_norm"])) <= TOL
    _close_trees(got["grads"], _ref_tree(ref, f"{key}/grads"))
    _close_trees(got["params"], _ref_tree(ref, f"{key}/params"))


def test_same_mesh_twice_is_bit_equal(runs):
    ranks, _, _ = runs
    got = _result(ranks, "ssm@1x2")
    again = got["again"]
    assert got["loss"] == again["loss"]
    for part in ("grads", "params"):
        a, b = _flat(got[part]), _flat(again[part])
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_backward_on_another_thread_is_the_same(runs):
    """The remat recompute on autograd's own thread issues the halo shift
    and the all-gathers again under the forward's binding
    (``parallel.ctx.carry``): the same gradients, bit for bit."""
    ranks, _, _ = runs
    got = _result(ranks, "ssm@1x2")
    a, b = _flat(got["grads"]), _flat(got["thread_grads"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_loss_parity_at_2x2x2(runs, name):
    ranks, ref, _ = runs
    for rank in ranks[8]:
        loss = rank[f"{name}@2x2x2/bfloat16"]["loss"]
        assert abs(loss - float(ref[f"{name}@2x2x2/bf16_loss"])) < BF16_TOL


# ------------------------------------------------- program, checkpoint


@pytest.mark.parametrize("key", STEPS)
def test_attested_step_takes_the_expected_collectives(runs, key):
    """Under a model axis the step shifts the halo (send and recv, a
    collective-permute) and all-gathers the states and the weights; on a
    data-only mesh it only gathers and reduces.  No all-to-all, no
    ``host-transfer`` on CPU gloo, and the audit passes."""
    ranks, _, _ = runs
    program = _result(ranks, key)["program"]
    kinds = {kind for kind, _ in program["ops"]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert ("collective-permute" in kinds) == (key in MODEL_AXIS)
    assert "all-to-all" not in kinds
    assert program["backends"] == ["gloo"]
    assert program["findings"] == []
    assert program["audit"] == []


def test_halo_shift_is_three_messages_a_layer_on_rank_0(runs):
    """The ``[B, W-1, CC]`` halo a layer: rank 0 of (1, 2) sends it in the
    forward, again in the remat recompute, and receives its cotangent in
    the backward (a middle rank would also receive, and send back)."""
    ranks, _, _ = runs
    cfg = R.CONFIGS["ssm"]
    program = _result(ranks, "ssm@1x2")["program"]
    permutes = [b for kind, b in program["ops"]
                if kind == "collective-permute"]
    halo = T.BATCH * (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state
                                             * cfg.ssm_groups) * 4
    assert permutes == [halo] * (3 * cfg.n_layers)


def test_checkpoint_restores_across_meshes(runs):
    """A hybrid state written at (2, 2) after one step, restored at (1, 2):
    the next step's loss equals the run that went on at (2, 2)."""
    ranks, _, _ = runs
    want = _result(ranks, "hybrid@2x2")["next_loss"]
    for rank in ranks[2]:
        assert abs(rank["restored_loss"] - want) <= TOL


@pytest.mark.parametrize("what", ["ssm", "hybrid", "block"])
def test_sequence_outside_the_condition_is_refused(runs, what):
    """At (1, 4), 72 tokens are 18 a rank, no multiple of the scan chunk
    min(16, 18): the loss and the block raise a ``ValueError`` naming the
    condition (the reference would replicate the scan there)."""
    ranks, _, _ = runs
    message = _result(ranks, "ssm@1x4")["refusals"][what]
    assert message is not None
    assert "mamba_block_cp needs each rank's 18 tokens to be a multiple " \
           "of its scan chunk min(ssd_chunk 16, 18) = 16" in message
    if what != "block":
        assert "(1, 4)" in message
