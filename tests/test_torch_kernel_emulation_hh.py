"""The HH kernels' source, run on the CPU against their plain versions
through the g++ stand-in (``tests/_torch_emulation.py``): the soma kernel's
grid-stride loop and ``_vtrap``'s limits, and the cable epoch kernel at
every compartment count the repo's configs use (spikes exact over 200
steps).
"""
import ctypes

import numpy as np
import pytest
import torch

from _torch_emulation import _build_emulated
from repro_torch.kernels.hh_neuron import cable_epoch_plain, hh_step_plain
from repro_torch.neuro.cable import C_M, CellConfig, CellState, syn_decay


@pytest.fixture(scope="module")
def emulated_hh_lib(tmp_path_factory):
    """The HH source (both kernels) built for the CPU stand-in."""
    return _build_emulated("hh_neuron", tmp_path_factory.mktemp(
        "emulated_hh"))


@pytest.fixture(scope="module")
def emulated_hh(emulated_hh_lib):
    fn = emulated_hh_lib.hh_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 11
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _hh_launch(fn, args, dt, max_blocks):
    outs = [torch.full_like(args[0], float("nan")) for _ in range(4)]
    rc = fn(*(t.data_ptr() for t in (*args, *outs)), args[0].numel(), dt,
            max_blocks, None)
    return rc, outs


# (cells, max_blocks): one cell, a tail below one 256-thread block, N not
# a multiple of the block over a full grid, and grids cut to 1 and 2
# blocks so the grid-stride loop walks 3 and 4 times
HH_CASES = [(1, 0), (37, 0), (700, 0), (700, 1), (1800, 2)]


@pytest.mark.parametrize("case", HH_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dt", [0.0125, 0.025])
def test_emulated_hh_kernel_matches_plain(emulated_hh, case, dt):
    """Every cell written, each within the reference's 3e-5 of the plain
    version, on tests/test_kernels.py's input distributions."""
    cells, max_blocks = case
    rng = np.random.default_rng(cells + max_blocks)
    args = [torch.tensor(rng.uniform(lo, hi, cells), dtype=torch.float32)
            for lo, hi in ((-90, 30), (0, 1), (0, 1), (0, 1), (0, 8),
                           (-20, 20), (0, 10))]
    rc, outs = _hh_launch(emulated_hh, args, dt, max_blocks)
    assert rc == 0
    for got, want in zip(outs, hh_step_plain(*args, dt=dt)):
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_emulated_hh_kernel_at_the_vtrap_limits(emulated_hh):
    """v exactly -40 and -55, where ``_vtrap``'s quotient is 0/0: the
    kernel takes the limit, finite and equal to the plain version."""
    rng = np.random.default_rng(4)
    v = torch.tensor([-40.0, -55.0] * 150, dtype=torch.float32)
    args = [v] + [torch.tensor(rng.uniform(lo, hi, 300), dtype=torch.float32)
                  for lo, hi in ((0, 1), (0, 1), (0, 1), (0, 8), (-20, 20),
                                 (0, 10))]
    rc, outs = _hh_launch(emulated_hh, args, 0.025, 0)
    assert rc == 0
    for got, want in zip(outs, hh_step_plain(*args, dt=0.025)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


def test_emulated_hh_kernel_refuses_no_cells(emulated_hh):
    z = torch.zeros(4)
    assert emulated_hh(*[z.data_ptr()] * 11, 0, 0.025, 0, None) != 0


# ------------------------------------------------------------- cable epoch


@pytest.fixture(scope="module")
def emulated_epoch(emulated_hh_lib):
    fn = emulated_hh_lib.cable_epoch_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _epoch_launch(fn, state, cfg, incoming, i_stim, stim_left, max_blocks,
                  compartments=None):
    """The C entry point called as ``cable_epoch_cuda`` calls it, on CPU
    tensors; outputs start as NaN (spiked as 2) so an unwritten one
    shows."""
    outs = [torch.full_like(t, float("nan")) for t in state]
    spiked = torch.full(incoming.shape, 2, dtype=torch.uint8)
    cells, comps = state.v.shape
    rc = fn(*(t.data_ptr() for t in (*state, incoming, i_stim, *outs,
                                     spiked)),
            cells, comps if compartments is None else compartments,
            incoming.shape[0], stim_left, cfg.dt, cfg.dt / C_M, cfg.g_axial,
            cfg.g_pas, cfg.e_pas, syn_decay(cfg), cfg.syn_weight, max_blocks,
            None)
    return rc, CellState(*outs), spiked


def _epoch_problem(cells, comps, steps, seed):
    """A state away from rest, incoming spikes at 2% of (step, cell), and
    the stimulus into every third cell, cut halfway through the epoch."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    state = CellState(f32(rng.uniform(-75, -50, (cells, comps))),
                      f32(rng.uniform(0.02, 0.1, cells)),
                      f32(rng.uniform(0.5, 0.7, cells)),
                      f32(rng.uniform(0.3, 0.4, cells)),
                      f32(rng.uniform(0, 2, cells)))
    incoming = f32(rng.uniform(size=(steps, cells)) < 0.02)
    i_stim = f32(rng.uniform(10, 25, cells) * (np.arange(cells) % 3 == 0))
    return state, incoming, i_stim, (steps + 1) // 2


# (cells, compartments, max_blocks) with 128-thread blocks: one cell, a
# tail below one block, a ragged tail over a full grid (300 = 2 x 128 +
# 44), and a grid cut to one block so the grid-stride loop walks 3 times
EPOCH_CASES = [(1, 2, 0), (37, 4, 0), (300, 8, 0), (300, 32, 1),
               (130, 32, 0)]
# The soma's exp comes from the C library here and from PyTorch's
# vectorised exp in the plain version (a few ulp apart), and the plain
# version may raise n to the 4th through pow: after one step the state
# agrees to the soma's 3e-5; over 200 steps an ulp is amplified through
# the spike's upstroke, so the state is held to the ring runs' 1e-3 mV.
EPOCH_TOL = {1: 3e-5, 200: 1e-3}


@pytest.mark.parametrize("steps", [1, 200])
@pytest.mark.parametrize("case", EPOCH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_emulated_cable_epoch_matches_plain(emulated_epoch, case, steps):
    """Every cell and step written; the same cells spike at every step as
    in the plain version, the final state within ``EPOCH_TOL``."""
    cells, comps, max_blocks = case
    cfg = CellConfig(n_compartments=comps)
    state, incoming, i_stim, stim_left = _epoch_problem(
        cells, comps, steps, seed=cells * comps + steps)
    rc, got, spiked = _epoch_launch(emulated_epoch, state, cfg, incoming,
                                    i_stim, stim_left, max_blocks)
    assert rc == 0
    want, want_spiked = cable_epoch_plain(state, cfg, incoming, i_stim,
                                          stim_left)
    assert int(spiked.max()) <= 1
    assert torch.equal(spiked.bool(), want_spiked)
    if steps == 200:
        assert bool(want_spiked.any())     # the case reaches a spike
    for name, a, b in zip(CellState._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=EPOCH_TOL[steps],
                                   msg=name)


def test_emulated_cable_epoch_refuses_what_it_does_not_take(emulated_epoch):
    """Compartment counts without an instantiation, no steps, no cells."""
    cfg = CellConfig(n_compartments=4)
    state, incoming, i_stim, _ = _epoch_problem(8, 4, 3, seed=1)
    for comps in (1, 3, 5, 128):
        rc, _, _ = _epoch_launch(emulated_epoch, state, cfg, incoming,
                                 i_stim, 0, 0, compartments=comps)
        assert rc != 0, comps
    rc, _, _ = _epoch_launch(emulated_epoch, state, cfg, incoming[:0],
                             i_stim, 0, 0)
    assert rc != 0
    empty = CellState(*(t[:0] for t in state))
    rc, _, _ = _epoch_launch(emulated_epoch, empty, cfg, incoming[:, :0],
                             i_stim[:0], 0, 0)
    assert rc != 0
