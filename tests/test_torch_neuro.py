"""The port's ring simulation and HH soma kernel on the CPU, against the
reference.

* ``hh_step_plain`` against the reference's oracle (``ref.hh_step_ref``)
  and its Pallas kernel in interpret mode, over ``tests/test_kernels.py``'s
  sweep and at the two voltages where ``_vtrap`` takes its limit: 3e-5.
* ``init_state`` bit for bit; ``cable.step`` over 1 and 200 steps within
  3e-5, spikes equal; the ring wiring equal.
* ``simulate`` on ``tests/test_neuro.py``'s three rings: spike counts and
  wavefronts exact, the final state within 1e-3 mV.
* The physiology tests of ``tests/test_neuro.py`` on the port.
* ``kernels.ops.hh_step`` on the CPU takes the plain version and counts
  nothing; the CUDA wrapper refuses what its kernel does not take; with a
  card (``cuda`` marker) the kernel against the plain version.
* One exchange epoch: ``kernels.ops.cable_epoch`` on the CPU against the
  reference's ``lax.scan`` of its ``cable.step`` (spikes exact, state
  within 3e-5); its plain version equal, bit for bit, to stepping
  ``cable.step``; the epoch wrapper's refusals; with a card the epoch
  kernel against its plain version, and ``simulate`` through it.

Inputs are drawn from seeded numpy inside each test and handed to both
frameworks.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.hh_neuron import (cable_epoch_cuda,
                                           cable_epoch_plain, hh_step_cuda,
                                           hh_step_plain)
from repro_torch.neuro import cable, ring, sim

TOL = 3e-5          # tests/test_kernels.py's HH tolerance
STATE_TOL = 1e-3    # mV, final state of a whole ring run
SWEEP_N = [7, 128, 1000, 4096]
SWEEP_DT = [0.0125, 0.025]
# tests/test_neuro.py's rings: (n_cells, n_rings, t_end_ms)
RINGS = [(32, 1, 40.0), (32, 4, 25.0), (16, 1, 20.0)]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    from repro.kernels import ref
    from repro.kernels.hh_neuron import hh_step_pallas
    from repro.neuro import cable as rcable
    from repro.neuro import ring as rring
    from repro.neuro import sim as rsim
    return {"ref": ref, "pallas": hh_step_pallas, "cable": rcable,
            "ring": rring, "sim": rsim}


def _hh_inputs(n, seed, v=None):
    """The seven [n] inputs with tests/test_kernels.py's distributions."""
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(-90, 30, n), rng.uniform(0, 1, n),
              rng.uniform(0, 1, n), rng.uniform(0, 1, n),
              rng.uniform(0, 8, n), rng.uniform(-20, 20, n),
              rng.uniform(0, 10, n)]
    if v is not None:
        arrays[0] = np.resize(np.asarray(v, np.float64), n)
    return [a.astype(np.float32) for a in arrays]


def _assert_outputs(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# ------------------------------------------------------------ HH update


@pytest.mark.parametrize("dt", SWEEP_DT)
@pytest.mark.parametrize("n", SWEEP_N)
def test_hh_plain_matches_reference_oracle_and_pallas(jref, n, dt):
    """The plain version against ``ref.hh_step_ref`` and against the TPU
    kernel run in interpret mode, on the same inputs."""
    args = _hh_inputs(n, seed=n + int(dt * 1e4))
    got = hh_step_plain(*(torch.from_numpy(a) for a in args), dt=dt)
    _assert_outputs(got, jref["ref"].hh_step_ref(*args, dt=dt))
    _assert_outputs(got, jref["pallas"](*args, dt=dt, interpret=True))


@pytest.mark.parametrize("v", [-40.0, -55.0, [-40.0, -55.0, -65.0, 0.0]])
def test_hh_plain_at_the_vtrap_limits(jref, v):
    """At v = -40 (alpha_m) and v = -55 (alpha_n) ``_vtrap``'s quotient is
    0/0 and its limit is taken; the update stays finite and equal to the
    reference's."""
    args = _hh_inputs(64, seed=3, v=v)
    got = hh_step_plain(*(torch.from_numpy(a) for a in args), dt=0.025)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_outputs(got, jref["ref"].hh_step_ref(*args, dt=0.025))


# ------------------------------------------------------------ cable cell


@pytest.mark.parametrize("n_cells,compartments", [(1, 4), (5, 32)])
def test_init_state_is_bit_equal(jref, n_cells, compartments):
    got = cable.init_state(n_cells, cable.CellConfig(
        n_compartments=compartments))
    want = jref["cable"].init_state(n_cells, jref["cable"].CellConfig(
        n_compartments=compartments))
    for name, a, b in zip(cable.CellState._fields, got, want):
        assert a.dtype == torch.float32 and a.shape == np.asarray(b).shape
        assert np.array_equal(a.numpy(), np.asarray(b)), name


@pytest.mark.parametrize("steps", [1, 200])
def test_step_matches_reference(jref, steps):
    """``cable.step`` from a state away from rest, with stimulus and
    incoming spikes, against the reference's step: every field within
    3e-5 and the same cells spiking at every step.  The reference's state
    crosses over through ``state_from_arrays``."""
    import jax.numpy as jnp
    rc = jref["cable"]
    n, c = 12, 6
    rng = np.random.default_rng(steps)
    ref_state = rc.init_state(n, rc.CellConfig(n_compartments=c))
    ref_state = ref_state._replace(
        v=jnp.asarray(rng.uniform(-75, -50, (n, c)), jnp.float32),
        g_syn=jnp.asarray(rng.uniform(0, 2, n), jnp.float32))
    state = cable.state_from_arrays([np.asarray(x) for x in ref_state])
    cfg, rcfg = (cable.CellConfig(n_compartments=c),
                 rc.CellConfig(n_compartments=c))
    for i in range(steps):
        spikes = (rng.uniform(size=n) < 0.05).astype(np.float32)
        i_ext = (rng.uniform(0, 25, n) * (i < 80)).astype(np.float32)
        state, spiked = cable.step(state, cfg, torch.from_numpy(spikes),
                                   torch.from_numpy(i_ext))
        ref_state, ref_spiked = rc.step(ref_state, rcfg, jnp.asarray(spikes),
                                        jnp.asarray(i_ext))
        assert np.array_equal(spiked.numpy(), np.asarray(ref_spiked)), i
    for name, a, b in zip(cable.CellState._fields, state, ref_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_state_from_arrays_is_exact():
    arrays = [np.random.default_rng(0).standard_normal(s).astype(np.float32)
              for s in ((3, 4), (3,), (3,), (3,), (3,))]
    state = cable.state_from_arrays(arrays)
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(state, arrays))


# ------------------------------------------------------------------ ring


@pytest.mark.parametrize("n_cells,n_rings", [(12, 3), (32, 1), (64, 8)])
def test_ring_wiring_matches_reference(jref, n_cells, n_rings):
    cfg = ring.RingConfig(n_cells=n_cells, n_rings=n_rings)
    rcfg = jref["ring"].RingConfig(n_cells=n_cells, n_rings=n_rings)
    assert np.array_equal(ring.source_of(cfg).numpy(),
                          np.asarray(jref["ring"].source_of(rcfg)))
    assert np.array_equal(ring.is_ring_head(cfg).numpy(),
                          np.asarray(jref["ring"].is_ring_head(rcfg)))
    assert (cfg.delay_steps, cfg.n_epochs, cfg.cells_per_ring) == (
        rcfg.delay_steps, rcfg.n_epochs, rcfg.cells_per_ring)


def test_ring_wiring_values():
    """tests/test_neuro.py's wiring: within-ring predecessor, wrapping."""
    cfg = ring.RingConfig(n_cells=12, n_rings=3)
    src = ring.source_of(cfg).tolist()
    assert src[0] == 3 and src[1] == 0 and src[4] == 7 and src[8] == 11
    assert torch.nonzero(ring.is_ring_head(cfg)).flatten().tolist() == [0, 4, 8]


@pytest.mark.parametrize("n_cells,n_rings,t_end", RINGS)
def test_simulate_matches_reference(jref, n_cells, n_rings, t_end):
    """The whole ring run against the reference's ``simulate``: spike
    counts and wavefronts exact, the final state within 1e-3 mV."""
    cfg = ring.RingConfig(n_cells=n_cells, n_rings=n_rings, t_end_ms=t_end,
                          cell=cable.CellConfig(n_compartments=4))
    rcfg = jref["ring"].RingConfig(
        n_cells=n_cells, n_rings=n_rings, t_end_ms=t_end,
        cell=jref["cable"].CellConfig(n_compartments=4))
    got = sim.simulate(cfg, device="cpu")
    want = jref["sim"].simulate(rcfg)
    assert got.spike_counts.dtype == torch.int32
    assert got.wavefront.dtype == torch.int32
    assert np.array_equal(got.spike_counts.numpy(),
                          np.asarray(want.spike_counts))
    assert np.array_equal(got.wavefront.numpy(), np.asarray(want.wavefront))
    assert got.total_spikes == want.total_spikes > 0
    for name, a, b in zip(cable.CellState._fields, got.state, want.state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=STATE_TOL, err_msg=name)


def test_wave_propagates_one_cell_per_epoch():
    cfg = ring.RingConfig(n_cells=32, t_end_ms=40.0,
                          cell=cable.CellConfig(n_compartments=4))
    r = sim.simulate(cfg, device="cpu")
    front = r.wavefront.numpy()
    assert (np.diff(front) >= 0).all()
    assert r.total_spikes == int(front[-1]) + 1
    assert r.total_spikes >= cfg.n_epochs - 1
    assert r.wall_s > 0


def test_multi_ring_independence():
    cfg = ring.RingConfig(n_cells=32, n_rings=4, t_end_ms=25.0,
                          cell=cable.CellConfig(n_compartments=4))
    counts = sim.simulate(cfg, device="cpu").spike_counts.reshape(4, 8)
    for r in range(1, 4):
        assert torch.equal(counts[0], counts[r])


def test_simulate_refuses_a_mesh_and_defaults_to_the_gpu(tmp_path,
                                                         monkeypatch):
    """What stays refused: a mesh that is not a ``DeviceMesh``, and a mesh
    whose size does not divide ``n_cells`` (a real one-rank gloo group
    holds the 8 cells; a stand-in mesh of 3 ranks does not).  The sharded
    ring itself is ``tests/test_torch_distributed.py``'s."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import mesh_of
    cfg = ring.RingConfig(n_cells=8, t_end_ms=5.0,
                          cell=cable.CellConfig(n_compartments=2))
    with pytest.raises(TypeError, match="DeviceMesh"):
        sim.simulate(cfg, device="cpu", mesh=object())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_of((1,), ("cells",), "cpu")
        assert isinstance(mesh, DeviceMesh)
        assert sim.simulate(cfg, device="cpu", mesh=mesh).total_spikes == \
            sim.simulate(cfg, device="cpu").total_spikes
        monkeypatch.setattr(mesh, "size", lambda: 3)
        with pytest.raises(ValueError, match="8 cells do not split evenly "
                                             "over 3 ranks"):
            sim.simulate(cfg, device="cpu", mesh=mesh)
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.simulate(cfg)


# ------------------------------------------------------------ physiology


def test_resting_cell_stays_at_rest():
    cfg = cable.CellConfig(n_compartments=4)
    st = cable.init_state(8, cfg)
    for _ in range(200):
        st, spiked = cable.step(st, cfg, torch.zeros(8), torch.zeros(8))
        assert not bool(spiked.any())
    assert float((st.v + 65.0).abs().max()) < 2.0


def test_stimulated_cell_spikes_once_then_repolarizes():
    cfg = cable.CellConfig(n_compartments=4)
    st = cable.init_state(1, cfg)
    spikes = 0
    for i in range(1200):  # 30 ms
        i_ext = torch.full((1,), 20.0) if i < 200 else torch.zeros(1)
        st, spiked = cable.step(st, cfg, torch.zeros(1), i_ext)
        spikes += int(spiked[0])
    assert spikes == 1
    assert float(st.v[0, 0]) < 0.0


# ---------------------------------------------------- dispatch and wrapper


def test_ops_dispatch_cpu_takes_plain_and_counts_nothing():
    ops.reset_launches()
    args = [torch.from_numpy(a) for a in _hh_inputs(33, seed=5)]
    got = ops.hh_step(*args[:6], 0.025, args[6])
    want = hh_step_plain(*args, dt=0.025)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.LAUNCHES == {"paged_attention": 0, "flash_attention": 0,
                            "ssd_scan": 0, "hh_step": 0, "cable_epoch": 0}


_BAD = {
    # name: (argument index, replacement of that argument, message)
    "cpu": (None, None, "CUDA device"),
    "dtype": (0, lambda t: t.double(), "float32"),
    "length": (3, lambda t: t[:-1], r"\[N\]"),
    "rank": (6, lambda t: t[None], r"\[N\]"),
    "contiguous": (1, lambda t: torch.stack([t, t], 1)[:, 0],
                   "contiguous"),
    "empty": ("all", lambda t: t[:0], "cells"),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_cuda_wrapper_rejects_bad_arguments(bad):
    """The wrapper raises on what its kernel does not take, before any
    build or launch (here on CPU tensors, which it refuses last)."""
    idx, change, msg = _BAD[bad]
    args = [torch.from_numpy(a) for a in _hh_inputs(16, seed=9)]
    if idx == "all":
        args = [change(t) for t in args]
    elif idx is not None:
        args[idx] = change(args[idx])
    with pytest.raises(ValueError, match=msg):
        hh_step_cuda(*args, dt=0.025)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """The kernel against the plain version on the card over the sweep, the
    ring's 131,072 cells and the ``_vtrap`` limits, at 3e-5; the dispatch
    counts each launch."""
    ops.reset_launches()
    cases = [(n, dt, None) for n in SWEEP_N + [131072] for dt in SWEEP_DT]
    cases += [(256, 0.025, [-40.0, -55.0])]
    for i, (n, dt, v) in enumerate(cases):
        args = [torch.from_numpy(a).to(cuda)
                for a in _hh_inputs(n, seed=100 + i, v=v)]
        got = ops.hh_step(*args[:6], dt, args[6])
        want = hh_step_plain(*args, dt=dt)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    assert ops.LAUNCHES["hh_step"] == len(cases)


@pytest.mark.cuda
def test_cuda_simulate_matches_plain(cuda, monkeypatch):
    """A ring through the epoch kernel (one launch an epoch, no soma
    kernel launch) against the same ring with the plain version on the
    card: spike counts and wavefronts exact."""
    cfg = ring.RingConfig(n_cells=1024, n_rings=8, t_end_ms=30.0,
                          cell=cable.CellConfig(n_compartments=8))
    ops.reset_launches()
    got = sim.simulate(cfg, device=cuda)
    assert ops.LAUNCHES["cable_epoch"] == 2 * cfg.n_epochs
    assert ops.LAUNCHES["hh_step"] == 0
    monkeypatch.setattr(ops, "cable_epoch", cable_epoch_plain)
    want = sim.simulate(cfg, device=cuda)
    assert ops.LAUNCHES["cable_epoch"] == 2 * cfg.n_epochs
    assert torch.equal(got.spike_counts, want.spike_counts)
    assert torch.equal(got.wavefront, want.wavefront)
    assert got.total_spikes == want.total_spikes > 0


# ------------------------------------------------------------ epoch kernel


def _epoch_inputs(n, c, steps, seed):
    """A state away from rest, spikes arriving at 2% of (step, cell) from
    a third of the way into the epoch, and the stimulus into every fourth
    cell: numpy arrays, for both frameworks."""
    rng = np.random.default_rng(seed)
    state = [rng.uniform(-75, -50, (n, c)), rng.uniform(0.02, 0.1, n),
             rng.uniform(0.5, 0.7, n), rng.uniform(0.3, 0.4, n),
             rng.uniform(0, 2, n)]
    incoming = rng.uniform(size=(steps, n)) < 0.02
    incoming[:steps // 3] = False
    i_stim = rng.uniform(10, 25, n) * (np.arange(n) % 4 == 0)
    return ([a.astype(np.float32) for a in state],
            incoming.astype(np.float32), i_stim.astype(np.float32))


@pytest.mark.parametrize("stim_left", [0, 77, 200])
def test_cable_epoch_matches_reference_scan(jref, stim_left):
    """``kops.cable_epoch`` on the CPU over one 200-step epoch (C 4, 32
    cells) against the reference's ``lax.scan`` of its ``cable.step`` over
    the same inputs, the stimulus cut at ``stim_left`` as ``_epoch_fn``
    cuts it: the same cells spike at every step, the state within 3e-5."""
    import jax
    import jax.numpy as jnp
    rc = jref["cable"]
    n, c, steps = 32, 4, 200
    arrays, incoming, i_stim = _epoch_inputs(n, c, steps, seed=stim_left)
    cfg, rcfg = (cable.CellConfig(n_compartments=c),
                 rc.CellConfig(n_compartments=c))

    def substep(st, inp):
        s, spikes_in = inp
        i_ext = jnp.where(s < stim_left, jnp.asarray(i_stim), 0.0)
        return rc.step(st, rcfg, spikes_in, i_ext.astype(jnp.float32))

    ref_state0 = rc.CellState(*(jnp.asarray(a) for a in arrays))
    ref_state, ref_spiked = jax.lax.scan(
        substep, ref_state0, (jnp.arange(steps), jnp.asarray(incoming)))
    ops.reset_launches()
    state, spiked = ops.cable_epoch(
        cable.state_from_arrays(arrays), cfg, torch.from_numpy(incoming),
        torch.from_numpy(i_stim), stim_left)
    assert not any(ops.LAUNCHES.values())
    assert spiked.dtype == torch.bool and spiked.shape == (steps, n)
    assert np.array_equal(spiked.numpy(), np.asarray(ref_spiked))
    assert bool(spiked.any())
    for name, a, b in zip(cable.CellState._fields, state, ref_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("n,c,steps,stim_left",
                         [(1, 2, 1, 1), (9, 4, 37, 20), (16, 32, 200, 120),
                          (5, 8, 60, -3), (5, 8, 60, 500)])
def test_cable_epoch_plain_equals_stepping_cable_step(n, c, steps,
                                                      stim_left):
    """The epoch's plain version is the loop of ``cable.step`` that
    ``sim.run`` made before it, bit for bit: state and every step's
    spikes."""
    arrays, incoming, i_stim = _epoch_inputs(n, c, steps, seed=n + steps)
    cfg = cable.CellConfig(n_compartments=c)
    got, got_spiked = cable_epoch_plain(
        cable.state_from_arrays(arrays), cfg, torch.from_numpy(incoming),
        torch.from_numpy(i_stim), stim_left)
    state = cable.state_from_arrays(arrays)
    i_stim_t, i_rest = torch.from_numpy(i_stim), torch.zeros(n)
    for s in range(steps):
        state, spiked = cable.step(state, cfg, torch.from_numpy(incoming[s]),
                                   i_stim_t if s < stim_left else i_rest)
        assert torch.equal(got_spiked[s], spiked), s
    for name, a, b in zip(cable.CellState._fields, got, state):
        assert torch.equal(a, b), name


_BAD_EPOCH = {
    # name: (change of (state, incoming, i_stim), message)
    "cpu": (lambda st, inc, ist: (st, inc, ist), "CUDA device"),
    "compartments_3": (lambda st, inc, ist: (
        st._replace(v=st.v[:, :3].contiguous()), inc, ist), "compartments"),
    "compartments_128": (lambda st, inc, ist: (
        st._replace(v=st.v.repeat(1, 32)), inc, ist), "compartments"),
    "dtype": (lambda st, inc, ist: (st._replace(m=st.m.double()), inc, ist),
              "float32"),
    "incoming_dtype": (lambda st, inc, ist: (st, inc.bool(), ist),
                       "float32"),
    "v_rank": (lambda st, inc, ist: (st._replace(v=st.v[:, 0].contiguous()),
                                     inc, ist), r"\[N, C\]"),
    "length": (lambda st, inc, ist: (st._replace(h=st.h[:-1]), inc, ist),
               r"\[N\]"),
    "i_stim_length": (lambda st, inc, ist: (st, inc, ist[1:]), r"\[N\]"),
    "incoming_cells": (lambda st, inc, ist: (st, inc[:, 1:].contiguous(),
                                             ist), "incoming"),
    "incoming_rank": (lambda st, inc, ist: (st, inc[0], ist), "incoming"),
    "no_steps": (lambda st, inc, ist: (st, inc[:0], ist), "incoming"),
    "contiguous": (lambda st, inc, ist: (
        st._replace(v=st.v.t().contiguous().t()), inc, ist), "contiguous"),
    "empty": (lambda st, inc, ist: (
        cable.CellState(st.v[:0], *(t[:0] for t in st[1:])), inc[:, :0],
        ist[:0]), "cells"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_EPOCH))
def test_cable_epoch_wrapper_rejects_bad_arguments(bad):
    """The epoch wrapper raises on what its kernel does not take (a
    compartment count without an instantiation, a type, shape or layout,
    a CPU tensor), before any build or launch."""
    change, msg = _BAD_EPOCH[bad]
    arrays, incoming, i_stim = _epoch_inputs(6, 4, 5, seed=2)
    args = change(cable.state_from_arrays(arrays),
                  torch.from_numpy(incoming), torch.from_numpy(i_stim))
    with pytest.raises(ValueError, match=msg):
        cable_epoch_cuda(args[0], cable.CellConfig(n_compartments=4),
                         args[1], args[2], 3)


def test_ops_cable_epoch_on_the_cpu_takes_plain_and_counts_nothing():
    arrays, incoming, i_stim = _epoch_inputs(10, 8, 30, seed=4)
    cfg = cable.CellConfig(n_compartments=8)
    ops.reset_launches()
    got = ops.cable_epoch(cable.state_from_arrays(arrays), cfg,
                          torch.from_numpy(incoming),
                          torch.from_numpy(i_stim), 12)
    want = cable_epoch_plain(cable.state_from_arrays(arrays), cfg,
                             torch.from_numpy(incoming),
                             torch.from_numpy(i_stim), 12)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    assert not any(ops.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_cable_epoch_matches_plain(cuda):
    """The epoch kernel against its plain version on the card, each
    compartment count the repo's configs use, the ring's 131,072 cells:
    spikes exact, the state within the ring runs' 1e-3 mV; one launch
    counted per call and the inputs left as they were."""
    cases = [(7, 2, 200, 100), (1000, 4, 37, 37), (4096, 8, 200, 0),
             (131072, 32, 200, 120), (333, 16, 1, 1), (256, 64, 50, 25)]
    ops.reset_launches()
    for i, (n, c, steps, stim_left) in enumerate(cases):
        arrays, incoming, i_stim = _epoch_inputs(n, c, steps, seed=50 + i)
        state = cable.state_from_arrays(arrays, cuda)
        inc, ist = (torch.from_numpy(a).to(cuda) for a in (incoming, i_stim))
        cfg = cable.CellConfig(n_compartments=c)
        got, got_spiked = ops.cable_epoch(state, cfg, inc, ist, stim_left)
        want, want_spiked = cable_epoch_plain(state, cfg, inc, ist,
                                              stim_left)
        torch.cuda.synchronize()
        assert torch.equal(got_spiked, want_spiked), (n, c, steps)
        for name, a, b in zip(cable.CellState._fields, got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=STATE_TOL,
                                       msg=f"{name} {(n, c, steps)}")
        assert all(np.array_equal(t.cpu().numpy(), a)
                   for t, a in zip(state, arrays))
    assert ops.LAUNCHES["cable_epoch"] == len(cases)
