"""Hodgkin–Huxley cable cells — the paper's application workload.

Port of ``repro.neuro.cable``.  Arbor's ring benchmark uses
morphologically detailed cable cells: an HH soma plus passive dendrite
compartments.  Compartment 0 carries the full HH mechanism and the
synapse; compartments 1..C-1 are passive cable, coupled by axial
conductance (an explicit stencil whose end compartments couple one-sided,
as the reference's edge padding makes them).  Gates use exponential Euler
at dt = 0.025 ms (Arbor's default).  Units: mV, ms, mS/cm².

``step`` always calls ``kernels.ops.hh_step`` for the soma: the tensors'
device picks the CUDA kernel or its plain version, so the reference's
``use_pallas`` has no counterpart.  ``hh_soma_update`` is that plain
version, the single source of the HH arithmetic (the reference's
``ref.hh_step_ref`` delegates to it too).  ``advance`` is the step's
arithmetic with the soma as an argument: ``step`` passes the kernel's
entry, the epoch's plain version (``kernels.hh_neuron.cable_epoch_plain``,
what ``neuro.sim.run`` reaches on the CPU) passes ``hh_soma_update``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kops

# classic HH constants
C_M = 1.0
G_NA, E_NA = 120.0, 50.0
G_K, E_K = 36.0, -77.0
G_L, E_L = 0.3, -54.4
E_SYN = 0.0
V_REST = -65.0
V_THRESH = -20.0  # upward crossing = spike


@dataclass(frozen=True)
class CellConfig:
    n_compartments: int = 32
    g_axial: float = 0.5       # coupling conductance between compartments
    g_pas: float = 0.1         # passive leak in dendrite
    e_pas: float = -65.0
    tau_syn: float = 2.0       # ms, exponential synapse
    syn_weight: float = 2.0    # conductance increment per spike
    dt: float = 0.025          # ms (Arbor/NEURON benchmark step)


class CellState(NamedTuple):
    v: torch.Tensor       # [n, C] f32
    m: torch.Tensor       # [n]
    h: torch.Tensor       # [n]
    n: torch.Tensor       # [n]
    g_syn: torch.Tensor   # [n]


def _f32_exp(x: float) -> float:
    """``exp`` of a Python float evaluated as JAX evaluates ``jnp.exp`` of
    one: in float32 (weak type), then held exactly as a Python float."""
    return float(torch.exp(torch.tensor(x, dtype=torch.float32)))


def init_state(n_cells: int, cfg: CellConfig,
               device: str | torch.device = "cpu") -> CellState:
    """Every cell at rest, its gates at their steady state.  The rates are
    evaluated on float32 tensors, as the reference's ``jnp`` evaluates them
    on ``V_REST`` (float64 arithmetic rounded to float32 would give other
    bits)."""
    v = torch.tensor(V_REST, dtype=torch.float32)
    gates = []
    for alpha, beta in ((_alpha_m, _beta_m), (_alpha_h, _beta_h),
                        (_alpha_n, _beta_n)):
        a, b = alpha(v), beta(v)
        gates.append(torch.full((n_cells,), float(a / (a + b)),
                                dtype=torch.float32, device=device))
    return CellState(
        v=torch.full((n_cells, cfg.n_compartments), V_REST,
                     dtype=torch.float32, device=device),
        m=gates[0], h=gates[1], n=gates[2],
        g_syn=torch.zeros((n_cells,), dtype=torch.float32, device=device))


def state_from_arrays(arrays: Sequence[np.ndarray],
                      device: str | torch.device = "cpu") -> CellState:
    """A state given as arrays in ``CellState``'s order (a reference
    ``CellState`` converted with ``np.asarray``) as the port's state on
    ``device``, bit for bit."""
    return CellState(*(torch.tensor(np.asarray(a, dtype=np.float32),
                                    device=device) for a in arrays))


# --- rate functions (vtrap-safe forms) ---
def _vtrap(x: torch.Tensor, y: float) -> torch.Tensor:
    # both branches are computed and one is kept, as jnp.where does; the
    # kept one is finite everywhere
    return torch.where((x / y).abs() < 1e-6, y * (1 - x / y / 2),
                       x / (torch.exp(x / y) - 1.0))


def _alpha_m(v):
    return 0.1 * _vtrap(-(v + 40.0), 10.0)


def _beta_m(v):
    return 4.0 * torch.exp(-(v + 65.0) / 18.0)


def _alpha_h(v):
    return 0.07 * torch.exp(-(v + 65.0) / 20.0)


def _beta_h(v):
    return 1.0 / (torch.exp(-(v + 35.0) / 10.0) + 1.0)


def _alpha_n(v):
    return 0.01 * _vtrap(-(v + 55.0), 10.0)


def _beta_n(v):
    return 0.125 * torch.exp(-(v + 65.0) / 80.0)


def hh_soma_update(v0: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
                   n: torch.Tensor, g_syn: torch.Tensor,
                   i_axial: torch.Tensor, dt: float, i_ext: torch.Tensor
                   ) -> tuple[torch.Tensor, ...]:
    """Exponential-Euler update of the HH soma.  All inputs [n] f32.  The
    compute hotspot: ``kernels/csrc/hh_neuron.cu`` fuses it into one pass,
    and this body is its plain version."""
    a_m, b_m = _alpha_m(v0), _beta_m(v0)
    a_h, b_h = _alpha_h(v0), _beta_h(v0)
    a_n, b_n = _alpha_n(v0), _beta_n(v0)

    def gate(x, a, b):
        tau = 1.0 / (a + b)
        inf = a * tau
        return inf + (x - inf) * torch.exp(-dt / tau)

    m_n = gate(m, a_m, b_m)
    h_n = gate(h, a_h, b_h)
    n_n = gate(n, a_n, b_n)

    g_na = G_NA * (m_n ** 3) * h_n
    g_k = G_K * (n_n ** 4)
    g_tot = g_na + g_k + G_L + g_syn
    i_inf = (g_na * E_NA + g_k * E_K + G_L * E_L + g_syn * E_SYN + i_axial
             + i_ext)
    v_inf = i_inf / g_tot
    v_n = v_inf + (v0 - v_inf) * torch.exp(-dt * g_tot / C_M)
    return v_n, m_n, h_n, n_n


def syn_decay(cfg: CellConfig) -> float:
    """The synapse's decay over one dt step, ``exp(-dt / tau_syn)``, as the
    reference evaluates it (float32)."""
    return _f32_exp(-cfg.dt / cfg.tau_syn)


def advance(state: CellState, cfg: CellConfig, spike_in: torch.Tensor,
            i_ext: torch.Tensor, soma) -> tuple[CellState, torch.Tensor]:
    """One dt step with ``soma`` (``hh_soma_update``'s signature) as the
    soma update; ``step`` and the epoch's plain version
    (``kernels.hh_neuron.cable_epoch_plain``) share this arithmetic."""
    v, m, h, n, g = state
    dt = cfg.dt

    # synapse: exponential decay + event increments
    g = g * syn_decay(cfg) + cfg.syn_weight * spike_in

    # cable stencil (explicit): i_axial into each compartment; the ends
    # see their own voltage beyond the edge (the reference's edge padding)
    left = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    right = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    i_axial = cfg.g_axial * (left - 2.0 * v + right)

    # passive dendrite compartments (1..C-1)
    v_dend = v[:, 1:]
    dv = (i_axial[:, 1:] + cfg.g_pas * (cfg.e_pas - v_dend)) * (dt / C_M)
    v_dend_new = v_dend + dv

    # HH soma (compartment 0)
    v0 = v[:, 0].contiguous()
    v0n, mn, hn, nn = soma(v0, m, h, n, g, i_axial[:, 0].contiguous(), dt,
                           i_ext)

    spiked = (v0n >= V_THRESH) & (v0 < V_THRESH)
    v_new = torch.cat([v0n[:, None], v_dend_new], dim=1)
    return CellState(v_new, mn, hn, nn, g), spiked


def step(state: CellState, cfg: CellConfig, spike_in: torch.Tensor,
         i_ext: torch.Tensor) -> tuple[CellState, torch.Tensor]:
    """One dt step.  spike_in: [n] float (1.0 = a presynaptic spike arrives
    this step); i_ext: [n] external current into the soma.  Returns
    (new_state, spiked [n] bool).  The soma goes through
    ``kernels.ops.hh_step``: the kernel on a card, the plain version
    here."""
    return advance(state, cfg, spike_in, i_ext, kops.hh_step)
