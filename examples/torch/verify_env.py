"""The paper's core loop, end to end: capture a portable environment
manifest, bind it to this host, attest a train step's dispatched program,
inspect it for pathway misconfigurations (host transfers, collectives),
and run a dual-environment numeric check — the automated version of the
paper's Table 1 + §8.

    PYTHONPATH=src python examples/torch/verify_env.py [--device cpu]

Mirrors ``examples/verify_env.py``, which attests the compiled HLO and
holds eager JAX against jit.  Here the two environments are the port on
the card (flash kernel) and the port on the CPU (plain version); with
``--device cpu`` both sides run on the CPU.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, TINY_MESH, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
from repro_torch.core import attest
from repro_torch.core.diagnostics import Diagnostics
from repro_torch.core.manifest import Manifest, PortableEnv
from repro_torch.core.verify import DualEnvHarness
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models.params import tree_map
from repro_torch.serve import resolve_device
from repro_torch.train.step import init_train_state, make_train_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = reduced(ALL_ARCHS["deepseek-7b"])
shape = ShapeConfig("demo", "train", 64, 2)
tc = TrainConfig(remat="full")
run = RunConfig(model=cfg, shape=shape, train=tc)
model = build(cfg)

# 1. the portable part (the "image"): content-addressed
manifest = Manifest(PortableEnv.capture(cfg, shape, tc, "baseline"))
print(f"image hash            : {manifest.portable.image_hash}")

# 2. the host binding (the "--nv / --mpi=pmix" moment)
manifest.bind(dev, TINY_MESH)
b = manifest.binding
print(f"host binding          : {b.device_kind} x{b.n_devices}, mesh "
      f"{b.mesh_shape}, power limit {b.power_limit}, driver "
      f"{b.driver_version}")

# 3. run + attest: the first step's program, its transport report
step = make_train_step(model, run)
state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                         dev)
batch = model.sample_batch(shape, 1, dev)
with attest.record() as program:
    state, metrics = step(state, batch)
report = attest.parse_program(program.text, TINY_MESH.n_devices)
manifest.attest(program_text=program.text, collectives=report.summary())
kernel_calls = sorted({line.split("(")[0] for line in program.lines
                       if line.startswith(("kernel::", "plain::"))})
print(f"program fingerprint   : "
      f"{manifest.attestation['program_fingerprint']} "
      f"({len(program.lines)} ops; {', '.join(kernel_calls)})")
print(f"collectives           : {report.counts() or 'none (single device)'}")

# 4. diagnostics gate (the paper's §8 automated log review)
diag = Diagnostics()
diag.extend(report.findings, "train-step")
print(diag.render())

# 5. dual-environment numeric verification (card == CPU)
params = model.init_params(torch.Generator().manual_seed(0), "cpu")
on_dev = tree_map(lambda t: t.to(dev), params)
batch_cpu = {k: v.cpu() for k, v in batch.items()}
h = DualEnvHarness(repeats=2, warmup=1)
with torch.no_grad():
    rep = h.compare(
        dev.type, lambda: np.float32(model.loss(on_dev, batch)[0].float()
                                     .cpu()),
        "cpu", lambda: np.float32(model.loss(params, batch_cpu)[0].float()),
        rtol=1e-2)
print(f"dual-env verdicts     : "
      f"{[(v.kind, v.ok, v.detail) for v in rep.verdicts]}")
assert rep.ok and diag.gate()
print(f"LAUNCHES {json.dumps(ops.LAUNCHES)}")
print("OK — environment is performance-verified")
