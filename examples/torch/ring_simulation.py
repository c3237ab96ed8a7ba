"""The paper's application workload: a Hodgkin–Huxley ring network
(Arbor ring benchmark) — watch the action potential propagate one cell per
axonal-delay epoch, then hold the run through the cable-epoch kernel on
the card to the plain version on the CPU, spike for spike (the
dual-environment check on real physiology).

    PYTHONPATH=src python examples/torch/ring_simulation.py [--device cpu]

Mirrors ``examples/ring_simulation.py``, which holds jnp against Pallas.
With ``--device cpu`` both sides run the plain version on the CPU.
"""
import argparse
import json

import numpy as np

from repro_torch.kernels import ops
from repro_torch.neuro.cable import CellConfig
from repro_torch.neuro.ring import RingConfig
from repro_torch.neuro.sim import simulate

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

cfg = RingConfig(n_cells=48, t_end_ms=45.0,
                 cell=CellConfig(n_compartments=8))
r = simulate(cfg, device="cpu")
front = r.wavefront.cpu().numpy()
print(f"cells={cfg.n_cells}  epochs={cfg.n_epochs}  "
      f"delay={cfg.delay_ms}ms  dt={cfg.cell.dt}ms")
print(f"total spikes: {r.total_spikes}")
print("wavefront per epoch:", front.tolist())
reached = front[front >= 0]  # -1 = no spike that epoch (EPSP rise time can
# push the last hop past t_end — the wave continues, the clock stops)
assert (np.diff(reached) >= 0).all(), "wave must advance monotonically"
assert r.total_spikes == int(reached[-1]) + 1

ops.reset_launches()
rk = simulate(cfg, device=args.device)
assert np.array_equal(r.spike_counts.cpu().numpy(),
                      rk.spike_counts.cpu().numpy()), "kernel parity"
assert np.array_equal(front, rk.wavefront.cpu().numpy()), "wavefront parity"
print(f"{rk.state.v.device.type} cable-epoch path: spike-for-spike "
      f"identical to the CPU's plain version")
print(f"LAUNCHES {json.dumps(ops.LAUNCHES)}")
print("OK")
