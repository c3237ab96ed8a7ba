"""The port's distributed layer on the CPU, held against the reference.

* The sharded ring (``neuro.sim.simulate`` over a 1-D ``cells`` mesh) at
  1, 2 and 4 ranks over gloo, on ``tests/test_neuro.py``'s distributed
  ring (32 cells, 4 compartments, 30 ms): spike counts and wavefront equal
  to the reference's single-device ``simulate`` and to the port's
  one-process run, exactly; the state within the HH tolerance, 3e-5.  A
  cell count that does not split over the ranks raises.
* One sharded epoch recorded (``core.attest``): one all-gather of
  ``steps * N`` int8 bytes over gloo, no other collective, no
  ``host-transfer`` finding on the CPU.
* ``parallel.ctx.ShardCtx.resolve`` against the reference's over every
  rule set, meshes and shapes that take both the uneven drop and the
  de-duplication of mesh axes; ``parallel.rules.rules_for`` over every
  arch, shape, mesh and rule name; a real (2, 2) ``DeviceMesh`` at world
  size 4 through ``bind``, ``resolve`` and ``sharding_for``.
* ``launch.mesh.make_mesh`` at world size 4, and its refusals;
  ``core.bootstrap.init_benchmark`` at world size 1 with the reference's
  keys; ``init_distributed`` refusing NCCL for more ranks than cards.

The ranks are spawned processes (``tests/_torch_ranks.py``): every world
size at once, a ``file://`` rendezvous under ``tmp_path``, one intra-op
thread and a timeout each.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from _torch_ranks import MESH_CASES, RING, run_ranks
from repro_torch import configs as T_CONFIGS
from repro_torch.configs.base import RunConfig
from repro_torch.core import bootstrap as T_BOOT
from repro_torch.neuro import cable, sim
from repro_torch.neuro.ring import RingConfig
from repro_torch.parallel import RULESETS, ShardCtx, mesh_of, rules_for

jax = pytest.importorskip("jax")
from repro import configs as R_CONFIGS  # noqa: E402
from repro.configs.base import RunConfig as RRunConfig  # noqa: E402
from repro.neuro import cable as R_CABLE  # noqa: E402
from repro.neuro import ring as R_RING  # noqa: E402
from repro.neuro import sim as R_SIM  # noqa: E402
from repro.parallel import ctx as R_CTX  # noqa: E402
from repro.parallel import rules as R_RULES  # noqa: E402

WORLDS = (1, 2, 4)
HH_TOL = 3e-5       # tests/test_kernels.py's HH tolerance


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(WORLDS, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def one_process():
    """The ring on one device: the reference's and the port's."""
    cfg = RING["cell"]
    want = R_SIM.simulate(R_RING.RingConfig(
        n_cells=RING["n_cells"], t_end_ms=RING["t_end_ms"],
        cell=R_CABLE.CellConfig(n_compartments=cfg.n_compartments)))
    port = sim.simulate(RingConfig(**RING), device="cpu")
    return want, port


# ------------------------------------------------------------ sharded ring


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ring_equals_one_device(ranks, one_process, world):
    want, port = one_process
    assert want.total_spikes > 0
    for rank, res in enumerate(ranks[world]):
        ring = res["ring"]
        for got in (np.asarray(want.spike_counts), port.spike_counts.numpy()):
            assert np.array_equal(ring["counts"].numpy(), got), rank
        for got in (np.asarray(want.wavefront), port.wavefront.numpy()):
            assert np.array_equal(ring["wavefront"].numpy(), got), rank
        assert ring["total"] == want.total_spikes == port.total_spikes
        assert ring["counts"].dtype == ring["wavefront"].dtype == torch.int32
        assert ring["wall_s"] > 0
        for name, a, b, c in zip(cable.CellState._fields, ring["state"],
                                 want.state, port.state):
            assert a.shape == c.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=HH_TOL, err_msg=name)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                       atol=HH_TOL, err_msg=name)


@pytest.mark.parametrize("world", (2, 4))
def test_uneven_cells_raise(ranks, world):
    for res in ranks[world]:
        assert res["uneven"] == f"33 cells do not split evenly over " \
                                f"{world} ranks"


@pytest.mark.parametrize("world", WORLDS)
def test_attested_epoch_is_one_all_gather(ranks, world):
    cfg = RingConfig(**RING)
    for res in ranks[world]:
        epoch = res["epoch"]
        assert epoch["ops"] == [("all-gather",
                                 cfg.delay_steps * cfg.n_cells)]
        assert epoch["findings"] == []
        gathers = [line for line in epoch["lines"] if "c10d::" in line]
        assert len(gathers) == 1 and gathers[0].endswith(" over gloo")
        assert sum(line.startswith("plain::cable_epoch_plain")
                   for line in epoch["lines"]) == 1


def test_simulate_refuses_a_mesh_of_two_axes(ranks):
    for res in ranks[4]:
        assert res["two_axes"].startswith(
            "simulate shards cells over a 1-D mesh named ('cells',)")


# --------------------------------------------------- rules and the context

MESHES = [T_CONFIGS.SINGLE_POD, T_CONFIGS.MULTI_POD, T_CONFIGS.TINY_MESH,
          T_CONFIGS.MeshConfig((2, 2), ("data", "model")),
          T_CONFIGS.MeshConfig((4, 2), ("data", "model"))]
LOGICAL = [("embed", "mlp"), ("mlp", "embed"), ("vocab", "embed"),
           ("layers", "embed", "heads_out"), ("experts", "embed", "mlp"),
           ("act_batch", "act_seq", "act_embed"),
           ("act_batch", "act_res", None), ("act_seq", "act_batch"),
           ("act_batch", "act_seq", "act_heads", None),
           ("cache_batch", "cache_seq", "cache_kv", None),
           ("cache_batch", "cache_seq_tp", "cache_kv"),
           ("act_experts", "act_embed"), ("ssm_inner", "ssm_heads"),
           (None, "act_vocab"), ("nonexistent", "embed")]


def _shapes(n: int) -> list:
    """Shapes of rank ``n``: all even, a batch of 1, odd sizes, none."""
    return [None, (256,) * n, (1,) + (32768,) * (n - 1), (30,) * n,
            (2,) + (48,) * (n - 1)]


def _stand_in(mesh_cfg):
    """What both contexts read of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(
        axis_names=mesh_cfg.axes, devices=np.empty(mesh_cfg.shape),
        mesh_dim_names=mesh_cfg.axes, shape=mesh_cfg.shape)


@pytest.mark.parametrize("rules", sorted(RULESETS))
def test_resolve_equals_the_reference(rules):
    assert RULESETS[rules] == R_RULES.RULESETS[rules]
    for mesh_cfg in MESHES:
        mesh = _stand_in(mesh_cfg)
        t = ShardCtx(mesh, RULESETS[rules])
        r = R_CTX.ShardCtx(mesh, R_RULES.RULESETS[rules])
        for logical in LOGICAL:
            for shape in _shapes(len(logical)):
                assert t.resolve(logical, shape) == tuple(
                    r.resolve(logical, shape)), (mesh_cfg, logical, shape)


def test_resolve_drops_uneven_and_repeated_axes():
    ctx = ShardCtx(_stand_in(T_CONFIGS.SINGLE_POD), RULESETS["train"])
    # first use of "data" wins: act_seq finds it taken
    assert ctx.resolve(("act_batch", "act_seq"), (16, 4096)) == (
        "data", None)
    # a batch of 1 does not split 16 ways: act_seq takes "data" instead
    assert ctx.resolve(("act_batch", "act_seq"), (1, 4096)) == (
        None, "data")
    multi = ShardCtx(_stand_in(T_CONFIGS.MULTI_POD), RULESETS["train"])
    assert multi.resolve(("embed", "mlp"), (4096, 11008)) == (
        ("pod", "data"), "model")
    assert multi.resolve(("embed", "mlp"), (4001, 11000)) == (None, None)


def test_rules_for_equals_the_reference():
    names = ["baseline", "auto", *sorted(RULESETS)]
    for arch in sorted(R_CONFIGS.ALL_ARCHS):
        for shape in sorted(R_CONFIGS.SHAPES):
            for t_mesh, r_mesh in ((T_CONFIGS.SINGLE_POD,
                                    R_CONFIGS.SINGLE_POD),
                                   (T_CONFIGS.MULTI_POD,
                                    R_CONFIGS.MULTI_POD)):
                for name in names:
                    got = rules_for(RunConfig(
                        T_CONFIGS.ALL_ARCHS[arch], T_CONFIGS.SHAPES[shape],
                        mesh=t_mesh, rules=name))
                    want = R_RULES.rules_for(RRunConfig(
                        R_CONFIGS.ALL_ARCHS[arch], R_CONFIGS.SHAPES[shape],
                        mesh=r_mesh, rules=name))
                    assert got == want, (arch, shape, name)


def test_run_config_equals_the_reference():
    run = RunConfig(T_CONFIGS.ALL_ARCHS["deepseek-7b"],
                    T_CONFIGS.SHAPES["train_4k"])
    ref = RRunConfig(R_CONFIGS.ALL_ARCHS["deepseek-7b"],
                     R_CONFIGS.SHAPES["train_4k"])
    assert run.rules == ref.rules == "baseline"
    assert dataclasses.asdict(run.mesh) == dataclasses.asdict(ref.mesh)
    # positional calls keep their meaning
    assert RunConfig(run.model, run.shape, run.train) == run


def test_a_real_mesh_binds_as_the_reference(ranks):
    want_ctx = R_CTX.ShardCtx(_stand_in(T_CONFIGS.MeshConfig(
        (2, 2), ("data", "model"))), R_RULES.RULESETS["train"])
    coords = set()
    for res in ranks[4]:
        mesh = res["mesh22"]
        assert mesh["shape"] == (2, 2)
        assert mesh["names"] == ("data", "model")
        coords.add(tuple(mesh["coordinate"]))
        for (logical, shape), (spec, placements) in zip(MESH_CASES,
                                                        mesh["cases"]):
            want = tuple(want_ctx.resolve(logical, shape))
            assert spec == want
            assert placements == [
                f"S({spec.index(axis)})" if axis in spec else "R"
                for axis in ("data", "model")]
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


# ------------------------------------------------------- mesh, bootstrap


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_refuses_another_world_size(ranks, world):
    for res in ranks[world]:
        assert res["mismatch"] == (
            f"a mesh of ({2 * world},) ('cells',) needs {2 * world} ranks; "
            f"the process group has {world}")


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="none stands"):
        mesh_of((1, 1), ("data", "model"), "cpu")


def test_init_benchmark_has_the_reference_keys(ranks):
    got = ranks[1][0]["init_benchmark"]
    assert list(got) == ["mesh_shape", "axes", "mesh_construct_s",
                         "first_collective_s", "steady_collective_s",
                         "steady_collective_max_s"]
    assert got["mesh_shape"] == (1, 1) and got["axes"] == ("data", "model")
    assert 0 < got["steady_collective_s"] <= got["steady_collective_max_s"]


def _record_init(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


@pytest.mark.parametrize("wireup,env", [
    (T_BOOT.WireUp("localhost:29500", 2, 1), {}),
    (T_BOOT.WireUp("nid001:29500", 8, 5), {"SLURM_NTASKS_PER_NODE": "4(x2)"}),
])
def test_nccl_with_more_ranks_than_cards_raises(monkeypatch, wireup, env):
    calls = _record_init(monkeypatch)
    monkeypatch.delenv("SLURM_NTASKS_PER_NODE", raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL takes one rank a device"):
        T_BOOT.init_distributed(wireup, "cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        T_BOOT.init_distributed(wireup, "cpu", backend="nccl")
    assert calls == []
    # ranks that share the card ask for gloo
    T_BOOT.init_distributed(wireup, "cuda", backend="gloo",
                            init_method="file:///store")
    assert calls == [{"backend": "gloo", "init_method": "file:///store",
                      "world_size": wireup.num_processes,
                      "rank": wireup.process_id}]


def test_a_named_backend_makes_a_group_of_one(monkeypatch):
    calls = _record_init(monkeypatch)
    monkeypatch.delenv("SLURM_NTASKS_PER_NODE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = T_BOOT.WireUp("localhost:29501", 1, 0)
    assert T_BOOT.init_distributed(one, "cuda") is one
    assert calls == []
    T_BOOT.init_distributed(one, "cuda", backend="nccl")
    assert calls == [{"backend": "nccl", "init_method": "tcp://localhost:29501",
                      "world_size": 1, "rank": 0}]
