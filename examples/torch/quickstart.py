"""Quickstart: build an assigned architecture at smoke scale, take one
training step (attention through the flash kernel on a card), then prefill
+ decode — the port's public API in ~50 lines.

    PYTHONPATH=src python examples/torch/quickstart.py [arch] [--device cpu]

Mirrors ``examples/quickstart.py``.  Runs on the GPU unless ``--device
cpu`` is given; a CPU tensor takes each kernel's plain version.
"""
import argparse
import json

import torch

from repro_torch.configs import ALL_ARCHS, reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, TrainConfig
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.serve import resolve_device
from repro_torch.train.step import init_train_state, make_train_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("arch", nargs="?", default="phi3-mini-3.8b")
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = reduced(ALL_ARCHS[args.arch])     # same family, laptop-sized
model = build(cfg)

# --- one training step (a length of 64 meets the flash condition) ---
shape = ShapeConfig("demo", "train", 64, 2)
run = RunConfig(model=cfg, shape=shape, train=TrainConfig(remat="full"))
state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                         dev)
step = make_train_step(model, run)
batch = model.sample_batch(shape, 0, dev)
state, metrics = step(state, batch)
print(f"[train]  arch={cfg.name}  loss={float(metrics['loss']):.4f}  "
      f"grad_norm={float(metrics['grad_norm']):.3f}")

# --- prefill + a few greedy decode steps ---
prompt = model.sample_batch(ShapeConfig("p", "prefill", 16, 2), 0, dev)
with torch.no_grad():
    logits, cache = model.prefill(state.params, prompt, cache_len=32)
    pos = torch.full((2,), 16, dtype=torch.int32, device=dev)
    toks = []
    tok = logits.argmax(-1)[:, None].int()
    for _ in range(8):
        logits = model.decode_step(state.params, cache, tok, pos)
        tok = logits.argmax(-1)[:, None].int()
        toks.append(int(tok[0, 0]))
        pos = pos + 1
print(f"[decode] greedy continuation: {toks}")
print(f"LAUNCHES {json.dumps(ops.LAUNCHES)}")
print("OK")
