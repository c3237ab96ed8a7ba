#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. build        — compile every CUDA kernel of the port from ``src/``
                  (nvcc, sm_90a, one process per source, all at once).
2. kernel       — the paged-attention kernel against its plain PyTorch
                  version on the card, over the CPU tests' geometries and
                  the full-width ones of the dense and GQA archs (f32
                  tolerance 2e-5, bf16 2e-2, and bf16 calls also within
                  REL_TOL of the plain version in relative norm over the
                  live rows).  Each full-width case's
                  design (``paged_design``: tensor cores for bf16 at head
                  dims 16-128 in steps of 16 with 4 or more rows a kv head,
                  CUDA cores otherwise) is printed, and both designs must
                  be covered.
3. flash_kernel — the flash-attention kernel against its plain version:
                  the ``tests/test_kernels.py`` sweep (S 128-512, f32 and
                  bf16, causal and not), head dims 32-128, a tail S of 100,
                  head dims 20 and 36; output (f32 2e-5, bf16 2e-2) and
                  log-sum-exp (2e-5 relative), and the gradients of its
                  autograd function against autograd through the plain
                  version (2e-5 / 2e-2 of each gradient's largest entry).
                  Each case's design (``flash_design``: tensor cores for
                  bf16 at D 32-128 in steps of 16, scalar otherwise) is
                  printed, and both designs must be covered.
4. reference    — the paged decode step through the kernel against the same
                  step on the CPU through the plain version, reduced
                  deepseek-7b in f32 (logits within 1e-3).
5. serve        — ``PagedServeEngine`` serving deepseek-7b at full width and
                  depth (6.9 B parameters, seeded random bf16 weights): 8
                  requests sharing a 256-token prefix, one of them sampled.
                  Launch counts are zeroed just before this run and read
                  just after: the paged-attention kernel must have run once
                  per layer per tick.  The same trace is then served again,
                  untimed, to record its widest tick with every slot busy.
6. parity       — the paged kernel against its plain version on the page
                  pool and page table that replay left behind (one layer).
7. timing       — paged kernel, plain version and
                  ``scaled_dot_product_attention`` (a yardstick the port
                  never calls) at the serving run's decode shape, L2
                  flushed before each launch, beside the least time the
                  card could take (its bound: the distinct pages the
                  lanes read, once each) and the launch floor (a
                  one-element ``add_`` under the same harness); the design
                  and the split count it took.
8. paged_timing — the launch floor; the paged kernel at the tick's geometry
                  with every lane decoding over 1-64 pages (a line through
                  the times gives its fixed cost and its cost a page); and
                  at 16 lanes x 2,048 keys, called as the engine calls it
                  (a 16-row chunk a lane): deepseek-7b and
                  deepseek-coder-33b decoding one fresh row a lane and the
                  latter's full 16-row chunk, each beside its plain
                  version, SDPA and the bound, with its design and splits.
9. profile      — where a serving tick's time goes: host wall time per tick
                  against device time per kernel (``torch.profiler``).
10. train_parity — full-width deepseek-7b cut to 2 layers, seq 256, batch 1:
                  the loss and every parameter's gradient through the flash
                  kernel against the same step with the plain version
                  called on the card (relative norm error within 2e-2).
11. train       — full-width deepseek-7b cut to 8 layers (2.46 B
                  parameters; AdamW state at 16 bytes per parameter does
                  not fit 30 layers in 80 GB), seq 2048, batch 4, remat
                  full: the first 4 steps of the default schedule (1000
                  steps, warmup 100) through ``make_train_step`` on the
                  port's ``DataPipeline``.  Finite losses, the last below
                  the first; the flash kernel launched twice per layer per
                  step (forward and remat recompute), counts zeroed just
                  before, through the tensor-core design.  One more step
                  under ``torch.profiler`` shows where a step's time goes.
                  Then the same 4 steps from the same seed with the plain
                  version on the card: each loss within 1e-3 relative of
                  the kernel run's.
12. train_cli   — ``launch/train.py::train`` on the card at ``reduced()``
                  scale: a run cut at a checkpoint and resumed reproduces
                  the uninterrupted run's losses; the flash kernel launched
                  twice a layer a step over the three runs.
13. flash_timing — flash kernel, plain version and
                  ``scaled_dot_product_attention(is_causal=True)`` (a
                  yardstick the port never calls) at the training shape,
                  q, k, v [128, 2048, 128] bf16 causal, L2 flushed before
                  each launch, beside the flops bound; the design it took,
                  and its registers and spills from the ptxas report (no
                  tensor-core instantiation may spill).
14. ssd_kernel  — the SSD scan kernel against its plain version, y and the
                  final state: the ``tests/test_kernels.py`` sweep (S
                  64-256, chunks 16-64, G 1 and 2), the full-width calls of
                  mamba2 and zamba2 (H 80, P 64, N 128 and 64, chunk 256,
                  S 2048), a G = 2 and an S = chunk case, f32 (2e-3) and
                  bf16 (one bf16 step); ``SsdScan``'s gradients against
                  autograd through the plain version.  Each case's design
                  (``ssd_design``: chunk-parallel on the tensor cores for
                  bf16 at P, N multiples of 16 and chunks of 64-256,
                  scalar otherwise) is printed, and both designs must be
                  covered.
15. ssm_serve, hybrid_serve — mamba2-2.7b and zamba2-2.7b at full width
                  and depth (seeded bf16 weights) through the contiguous
                  ``ServeEngine``: 4 requests of 32-64 prompt tokens, 16
                  new tokens each, one sampled.  Then the prefill check, at
                  full width cut to 16 layers (mamba2) and two groups
                  (zamba2): ``Model.prefill`` of a 512-token prompt (one SSD
                  launch a
                  Mamba2 layer, one flash launch a shared block; counts
                  zeroed just before) continued by ``decode_step``, against
                  the prompt stepped one token at a time, in f32.
16. ssm_train_parity — full width, seq 2048, batch 1, mamba2 cut to 2
                  layers and zamba2 to one group (6 layers): the loss and
                  every gradient through the kernels against the plain
                  versions on the card.
17. ssm_train   — mamba2-2.7b at full width and full depth (2.83 B
                  parameters), seq 2048, batch 4, remat full, the first 4
                  steps of the default schedule: the SSD kernel launched
                  twice per layer per step (counts zeroed just before),
                  through its tensor-core design, one more step under
                  ``torch.profiler`` (after a warm-up step in the same
                  profile) with the device ms of the SSD
                  forward's kernels and of the ``ssd_scan_backward`` and
                  ``adamw_update`` spans.  Then the same 4 steps from the
                  same seed with the plain versions on the card: each loss
                  within 1e-3 relative of the kernel run's.
18. ssd_timing  — SSD kernel and plain version at mamba2's training call
                  (x [4, 2048, 80, 64] bf16, chunk 256) and prefill call
                  (x [1, 512, 80, 64]), L2 flushed, beside the bytes bound;
                  the design each took, its workspace bytes and heads a
                  chunk-scan block, each pass's device ms from
                  ``torch.profiler`` kernel names, the share of y values
                  that differ from the plain version's, and each pass's
                  registers and spills from the ptxas report (no pass an
                  arch's call takes may spill).
19. hh_kernel   — the HH soma kernel against its plain version: the
                  ``tests/test_kernels.py`` sweep (n 7-4096, dt 0.0125 and
                  0.025, its input distributions) plus the ring's 131,072
                  cells and inputs at v = -40 and -55 mV (``_vtrap``'s
                  limits); v, m, h and n within 3e-5, and whether the bits
                  are equal.
20. cable_epoch_kernel — the epoch kernel (every cell through a whole
                  exchange epoch of cable steps in one launch) against its
                  plain version: C 2, 4, 8 and 32, 7, 1,000 and 131,072
                  cells, 1, 37 and 200 steps, a state away from rest,
                  seeded incoming spikes, the stimulus cut mid-epoch; every
                  step's spikes equal, the state within 1e-3, and whether
                  the bits are equal.
21. gather      — the paged engine's gather pathway: full-width
                  deepseek-7b cut to 4 layers, f32 weights and caches, on
                  the integration workload; ``compare_engines`` ok with
                  ``kernel="gather"`` and ``kernel="paged"``, greedy and
                  sampled, and the gather streams equal to the paged
                  kernel's.  Then the serve phase's bf16 trace (full depth)
                  once through ``kernel="gather"``: tokens/s and agreement
                  with the paged run, measured, not checked.
22. epoch_hold  — one epoch of the 131,072-cell ring (32 compartments,
                  the stimulus on for its first 120 steps, seeded incoming
                  spikes) stepped three ways: ``cable.step`` on the card
                  (the HH soma kernel once a dt step, counts zeroed just
                  before), the epoch kernel, and the plain version; all
                  three give the same spikes at every step and states
                  within 1e-3.
23. neuro       — the ring simulation at the repo's production scale
                  (``benchmarks/ring_podscale.py``: 131,072 cells of 32
                  compartments, 200 ms, 5 ms delay, 40 epochs of 200 dt
                  steps) on one card, as Arbor's single ring and as
                  NEURON's ringtest of 256 rings: through the epoch kernel
                  (counts zeroed just before, one launch an epoch and no
                  soma kernel launch, two runs: warm and timed) and through
                  the plain version; spike counts and wavefronts
                  identical, final state within 1e-3 mV; each ring's own
                  dynamics checked; one epoch (ten runs of it) under
                  ``torch.profiler``.  A small ring on the CPU (plain
                  version) and on the card must give the same spikes.
24. hh_timing   — the HH kernel and its plain version at the ring's
                  131,072 cells, L2 flushed, median of 50, beside the bytes
                  bound.
25. cable_epoch_timing — the epoch kernel and its plain version at one
                  epoch of the ring (131,072 cells x 32 compartments, 200
                  steps), L2 flushed, median of 25, beside the operations
                  bound; each instantiation's registers and spills (none
                  up to C = 32 may spill).
26. moe_kernel  — (run after kernel) the paged kernel's every-row mode
                  (``all_rows``, the moe family's) against its plain version
                  on every row of every lane, dead rows and idle lanes
                  included: qwen3-moe's (kv 4, group 8, hd 128) and
                  granite-moe's (kv 8, group 2, hd 64) full-width
                  geometries, chunks of 1 and 16, f32 and bf16, within the
                  kernel phase's tolerances; both designs and a lane split
                  across blocks must be covered.
27. moe_reference — (run after reference) reduced qwen3-moe's paged step
                  through the kernel against the same step on the CPU
                  through the plain version, f32, logits within 1e-3; the
                  steps hold a decoding lane whose dead rows cross a page
                  edge, a prefill tail and an idle lane.  The same steps
                  with the every-row argument dropped must miss that bound.
28. moe_serve   — (run after gather_serve, the dense model freed)
                  qwen3-moe-30b-a3b at full width and depth (30.5 B
                  parameters, seeded bf16 weights) on the serve phase's
                  trace and settings: one paged launch a layer a tick
                  (counts zeroed just before), 32 tokens in the vocab for
                  every request, an untimed replay with equal streams; the
                  kernel at its widest busy tick in both modes, every row
                  and live rows, beside each one's bound (``moe_timing``);
                  a profiled tick split into attention, routing and
                  dispatch, expert products, combine and the rest.
29. moe_train_parity — (run after train_parity) reduced granite-moe, seq
                  256: the loss and every gradient through the flash
                  kernel against the plain version on the card, held within
                  2e-2 in f32.  In bf16 each layer's route flips (tokens
                  whose top-k expert set differs between the two steps) are
                  counted, and the plain step is run again with the kernel
                  step's routes pinned (gate weights from its own
                  probabilities): its loss and every gradient are held
                  within 2e-2, and each layer's attention and moe outputs
                  are compared (the first layer past 2e-2 named).
30. moe_train   — (run after train) granite-moe-1b-a400m at full width and
                  depth, seq 2048, batch 4, remat full, 4 steps of the
                  default schedule: finite losses and router aux, the flash
                  kernel launched twice a layer a step (counts zeroed just
                  before); one more step under ``torch.profiler``.
31. cluster     — (run after gather_serve) ``ClusterEngine`` over 2 replicas
                  of the served deepseek-7b (one set of weights, each a
                  ``PagedServeEngine(kernel="paged")``, slots 4, block 16,
                  chunk 16, 512 pages): 16 chat requests of 4 tenants
                  (256-token prefixes, suffixes of 16-256, 32 new tokens,
                  bursts of 4 every 8 ticks, ``workloads.generate``) through
                  one engine and through the cluster under affinity,
                  round-robin and random routing.  Every cluster's streams
                  equal the single engine's; affinity beats random on
                  ``routed_affinity`` and ``shared_hit_rate``; the paged
                  kernel runs once a layer a tick in every replica (counts
                  zeroed just before each run); every replica's allocator
                  and host tier check; ``RunAudit`` gates the affinity run
                  clean and a routing rule flags random routing with
                  ``pathway-routing`` only; ``compare_engines(cluster=...)``
                  passes sampled.  ms a tick, tokens/s, routing counters and
                  occupancy for each run.
32. serve_cli   — ``python -m repro_torch.launch.serve --replicas 2
                  --metrics-port 0 --trace-out FILE`` in a process of its
                  own: exit code 0, the audit's gate passed, a Chrome trace
                  with one timeline per request.

33. vlm_reference, encdec_reference — (run after train_cli) reduced
                  llama-3.2-vision-11b (128 tokens against 16 image
                  tokens) and whisper-medium (128 frames, 16 decoder
                  tokens), f32, every gate drawn nonzero: the loss, every
                  gradient, ``prefill`` and four ``decode_step`` calls
                  through the flash kernel against the same run with the
                  plain version on the card (loss and gradients within
                  2e-2 relative norm, logits within 1e-3).  The flash
                  kernel's launches are counted by mode: causal for each
                  vlm and decoder self layer, bidirectional for each
                  encoder layer, once in the loss and once in the prefill.
34. vlm_serve, encdec_serve — llama-3.2-vision-11b (11.52 B) and
                  whisper-medium (0.811 B) at full width and depth, seeded
                  bf16 weights, every gate drawn nonzero: a prefill of 2
                  prompts (512 tokens against 1,600 image tokens; 64
                  tokens against 1,500 frames), warm then timed, its flash
                  launches counted (40 causal; 24 causal and none
                  bidirectional, 1,500 frames missing the flash
                  condition); 32 greedy ``decode_step`` calls, the first
                  one's logits within 3e-2 of the logit scale of a
                  teacher-forced forward of the prompt and its token,
                  argmax equal up to near-ties; then the contiguous
                  ``ServeEngine`` on 4 requests of 32-64 tokens, 16 new.
35. vlm_train, encdec_train — llama-3.2-vision-11b at full width cut to
                  one group (5 self layers, 1 cross block, 2.36 B), seq
                  2048, batch 4, 1,600 image tokens; whisper-medium whole,
                  1,500 frames, 448 decoder tokens, batch 8; remat full,
                  4 steps of the default schedule: finite losses, the
                  flash kernel's launches counted by mode (40 causal for
                  the vlm; none for whisper, whose lengths miss the flash
                  condition); one more step under ``torch.profiler``.

36. env_manifest — (run after train_cli, beside the examples) the
                  environment layer on deepseek-7b's train step at full
                  width cut to 2 layers (seq 128, batch 1): the manifest
                  captured and bound (the binding's card name and power
                  limit equal ``nvidia-smi``'s); the first step attested
                  twice from fresh states (one program, one fingerprint;
                  its kernel lines name the flash kernel, once a layer and
                  once a recompute, and no plain version; no host transfer
                  and no collective in its transport report); the same
                  first step unrecorded gives the same loss, bit for bit;
                  the same step attested on the CPU gives another program,
                  which ``diff`` tags ``EXPECTED (binding differs)`` with
                  no portable difference.
37. train_cli_env — ``python -m repro_torch.launch.train`` with the
                  train_cli phase's arguments in a process of its own: exit
                  code 0, ``manifest.json`` with the in-process run's image
                  hash, binding and program fingerprint, the audit's gate
                  passed, the in-process losses within 1e-5 relative.
38. examples    — the five examples of ``examples/torch/`` (quickstart,
                  ring_simulation, serve_lm, train_lm, verify_env) on the
                  card, each in a process of its own, all started together
                  before train_cli_env: each exits 0 with ``OK`` last, and
                  the launches it prints show its kernels (flash; the
                  cable epoch; paged; flash; flash).

39. ring_ranks  — (run after neuro) the arbor_ring of neuro (131,072
                  cells, 32 compartments, 200 ms, 40 epochs) sharded over
                  a 1-D ``cells`` mesh by ``neuro.sim.simulate``, one
                  process a rank on the card, wired up through ``WireUp``
                  from ``SLURM_NTASKS``/``SLURM_PROCID``/``REPRO_COORD_PORT``
                  on a free port: 1 rank over NCCL, 2 and 4 ranks sharing
                  the card over gloo (NCCL takes one rank a device).  Each
                  world's spike counts and wavefront equal the
                  single-process kernel run's, its final state bit for bit;
                  every rank launches ``cable_epoch`` twice an epoch (warm
                  and timed runs) and no other kernel.  One epoch is
                  attested on every rank: one all-gather of 200 x 131,072
                  int8 bytes and no other collective; no ``host-transfer``
                  finding under NCCL, one for the all-gather under gloo
                  (which stages device tensors through host memory).  The
                  backend, ``wall_s`` and cell-steps a second of each
                  world, and the NCCL version.  Every rank process has a
                  timeout and a collective timeout: a hang fails the phase.
40. init_benchmark — ``core.bootstrap.init_benchmark((1, 1), ("data",
                  "model"))``, the ``osu_init`` analogue, at world size 1
                  over NCCL: the first thing the one-rank process of
                  ring_ranks does, so its first collective sets up NCCL's
                  communicator.  The reference's keys.
41. tp_train    — (run after ring_ranks) deepseek-7b at full width cut to
                  2 layers (1.24 B), seq 2048, batch 4, remat full, bf16,
                  the ``train`` rules (FSDP over data, tensor and sequence
                  parallelism over model), 2 steps on each of the meshes
                  (1, 1) over one NCCL rank, (1, 2) and (2, 2) over gloo
                  ranks sharing the card (``python3 chip_smoke.py tp_rank
                  <backend> <dir> <arch> <mesh>``, wired up as ring_ranks'
                  ranks).  The one-rank process first takes the same steps
                  with no mesh bound: every rank's losses within 2e-2 of
                  that one-process step's, the flash kernel launched on
                  every rank's heads for every self-attention call (steps
                  x layers x 2), no other path.  The first sharded step is
                  attested: its collectives by kind with their payload
                  bytes (all-gather and reduce-scatter, no all-to-all),
                  their backend and ``host-transfer`` findings (every gloo
                  collective on the card's tensors).  Losses, grad norms,
                  ms a step and peak memory by rank.
42. moe_ep_train — the same for granite-moe-1b-a400m at full width cut to 4
                  layers over (1, 1) and (1, 2): 16 experts a rank, the
                  slots exchanged by all-to-all, two a layer forward (six
                  in the attested step with the remat recompute and the
                  backward).
43. cp_train    — the context-parallel Mamba2 block
                  (``ssm.mamba_block_cp``): mamba2-2.7b at full width cut
                  to 4 layers over (1, 1) (NCCL), (1, 2) and (1, 4) (gloo
                  ranks sharing the card), zamba2-2.7b cut to one group (6
                  layers: 5 Mamba2 and the shared block) over (1, 2), as
                  tp_train runs them (seq 2048, batch 4, remat full, bf16,
                  the ``train`` rules, 2 steps; the ranks of one world
                  train both archs in turn, each against its one-process
                  step).  Each rank scans its 2048 / tp tokens through the
                  SSD kernel (steps x Mamba2 layers x 2 launches) and runs
                  zamba2's shared attention on its heads through flash
                  (steps x groups x 2).  The attested first step under a
                  model axis shows the halo's collective-permute (send and
                  recv) and the all-gathers, no all-to-all.  The same
                  checks and figures as tp_train's.

Every engine the serve, gather_serve, cluster, vlm_serve and encdec_serve
phases build must leave ``torch.cuda.memory_allocated()`` where it found
it once deleted, with no help from the collector; each served model is
freed by dropping it.

Then the ``kernels`` summary line (the paged row with its design, launch
floor and ``paged_timing`` shapes; the paged and flash rows also carry the
moe runs' launches, the paged row the cluster runs' launches by policy and
the every-row timing, the flash row the vlm and encdec phases' launches
by mode; the flash row also the train_cli, env_manifest and examples'
launches, the paged row serve_lm's and the HH row ring_simulation's
epoch launches and ring_ranks' launches by world size and rank; the flash
row also tp_train's, moe_ep_train's and cp_train's (zamba2) by mesh and
rank, the SSD row cp_train's by arch, mesh and rank), the card's name
and power limit as ``nvidia-smi`` reports them, and last ``{"ok": true,
"device": ...}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ALL_ARCHS, reduced  # noqa: E402
from repro_torch.configs.base import (RunConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention_cuda, flash_attention_plain,
    flash_design, logsumexp_plain)
from repro_torch.kernels.hh_neuron import (  # noqa: E402
    EPOCH_COMPARTMENTS, cable_epoch_cuda, cable_epoch_plain, hh_step_cuda,
    hh_step_plain)
from repro_torch.launch.train import train as train_cli  # noqa: E402
from repro_torch.configs import TINY_MESH  # noqa: E402
from repro_torch.core import attest  # noqa: E402
from repro_torch.core.bootstrap import (WireUp, init_benchmark,  # noqa: E402
                                        init_distributed)
from repro_torch.core.manifest import (Manifest, PortableEnv,  # noqa: E402
                                       diff as manifest_diff)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_cuda, paged_attention_plain, paged_design, paged_splits)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SsdScan, ssd_design, ssd_scan_backward, ssd_scan_cuda, ssd_scan_plain,
    ssd_workspace_elements)
from repro_torch.models import build  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models import stack  # noqa: E402
from repro_torch.models.decode import decode_paged_chunk  # noqa: E402
from repro_torch.neuro import cable  # noqa: E402
from repro_torch.neuro import sim as neuro_sim  # noqa: E402
from repro_torch.neuro.cable import (CellConfig, CellState,  # noqa: E402
                                     init_state)
from repro_torch.neuro.ring import RingConfig, is_ring_head  # noqa: E402
from repro_torch.launch import bind as launch_bind  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import RULESETS, bind, mesh_of  # noqa: E402
from repro_torch.audit import (AuditContext, Evidence,  # noqa: E402
                               ExpectationRegistry, ExpectedSignature, Rule,
                               RunAudit, Tracer)
from repro_torch.serve import (ClusterEngine, PagedServeEngine,  # noqa: E402
                               Request, SamplingParams, ServeEngine,
                               WorkloadSpec, compare_engines, generate,
                               token_matrix)
from repro_torch.train.step import (TrainState,  # noqa: E402
                                    init_train_state, make_train_step)

ARCH = "deepseek-7b"
SLOTS, BLOCK, CHUNK, MAX_LEN = 4, 16, 16, 1024
N_REQUESTS, PREFIX, MAX_NEW = 8, 256, 32
SEED = 0
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 paged calls: ||kernel - plain|| / ||plain|| over the live rows.  Both
# round one fp32 result to bf16, so a sound kernel differs only where the
# two fp32 values straddle a rounding boundary; a mask one key off at 2,048
# keys, or a split's partial weighted a few percent off, reads above it.
REL_TOL = 1e-3
# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (name, kv heads, group, head_dim) at full width
FULL_WIDTH = [("deepseek-7b", 32, 1, 128), ("phi3-medium-14b", 10, 4, 128),
              ("deepseek-coder-33b", 8, 7, 128),
              ("granite-moe-1b-a400m", 8, 2, 64), ("zamba2-2.7b", 32, 1, 80),
              ("phi3-mini-3.8b", 32, 1, 96), ("qwen3-moe-30b-a3b", 4, 8, 128)]
# the moe family: qwen3 served and granite trained, both at full width and
# depth; their paged geometries take the every-row mode
MOE_SERVE_ARCH, MOE_TRAIN_ARCH = "qwen3-moe-30b-a3b", "granite-moe-1b-a400m"
MOE_GEOMS = [g for g in FULL_WIDTH if g[0] in (MOE_SERVE_ARCH, MOE_TRAIN_ARCH)]
MOE_SPANS = ("moe_route", "moe_experts", "moe_combine")
# three lanes of chunk 4 over pages of 8: two prefills, then a decoding
# lane whose dead rows 7-9 cross its page edge, a prefill tail of 2 and an
# idle lane in one step
MOE_REF_STEPS = [([0, 0, 0], [4, 4, 0]), ([4, 4, 0], [2, 4, 0]),
                 ([6, 8, 0], [1, 2, 0])]
KERNEL_REPLACES = {
    "paged_attention": "src/repro/kernels/paged_attention.py:102",
    "flash_attention": "src/repro/kernels/flash_attention.py:76",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:69",
    "hh_step": "src/repro/kernels/hh_neuron.py:73"}
KERNEL_SOURCES = {name: f"src/repro_torch/kernels/csrc/{src}.cu"
                  for name, src in (("paged_attention", "paged_attention"),
                                    ("flash_attention", "flash_attention"),
                                    ("ssd_scan", "ssd_scan"),
                                    ("hh_step", "hh_neuron"))}
# training: full width, depth cut to fit AdamW's 16 bytes per parameter
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 8, 2048, 4, 4
PARITY_LAYERS, PARITY_SEQ = 2, 256
GRAD_TOL = 2e-2   # relative norm error of loss and gradients, bf16
TRAJ_TOL = 1e-3   # relative error of each training loss, kernel vs plain


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ------------------------------------------------------------------ cases


def check_freed(before: int, what: str) -> None:
    """The card holds what it held before ``what`` was built, once it is
    deleted: no engine (page pool, caches, workspaces) outlives its last
    reference, with no help from the collector."""
    left = torch.cuda.memory_allocated() - before
    check(left == 0, f"{what}: {left} bytes still allocated after del")


def paged_case(b, c, kv, g, hd, bs, n_pages, pos, n_new, dtype, seed,
               device, extra_blocks=4):
    """A paged-attention problem on ``device``: random pool, a random
    permutation page table (physical order never equals logical order)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = b * n_pages + extra_blocks

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    perm = torch.randperm(nb, generator=gen, device=device)[:b * n_pages]
    return (randn(b, c, kv, g, hd), randn(nb, bs, kv, hd),
            randn(nb, bs, kv, hd),
            perm.reshape(b, n_pages).to(torch.int32).contiguous(),
            torch.tensor(pos, dtype=torch.int32, device=device),
            torch.tensor(n_new, dtype=torch.int32, device=device))


def compare(args, tol, all_rows=False) -> tuple[float, float]:
    """Kernel vs plain on every lane's valid rows (with ``all_rows``, on
    every row of every lane); every row finite; in bf16 also the relative
    norm error over the rows compared within ``REL_TOL``.  Returns the max
    abs error and the relative norm error."""
    out = paged_attention_cuda(*args, all_rows=all_rows)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
    err, diff_sq, ref_sq = 0.0, 0.0, 0.0
    what = f"q {tuple(args[0].shape)} {args[0].dtype} all_rows {all_rows}"
    for lane, n in enumerate(args[5].tolist()):
        n = out.shape[1] if all_rows else n
        got, want = out[lane, :n].float(), ref[lane, :n].float()
        if n:
            err = max(err, float((got - want).abs().max()))
            diff_sq += float(((got - want) ** 2).sum())
            ref_sq += float((want ** 2).sum())
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"kernel != plain: lane {lane} n_new {n} {what}")
    rel = (diff_sq / ref_sq) ** 0.5 if ref_sq else 0.0
    if args[0].dtype == torch.bfloat16:
        check(rel <= REL_TOL, f"kernel != plain: relative norm error {rel} "
              f"> {REL_TOL}, {what}")
    return err, rel


def lane_states(rng, b, c, bs, n_pages):
    """Ragged lanes at random positions: lane 0 a full chunk whose last row
    fills its page exactly, and with four lanes or more an idle lane and a
    decode lane; the rest random in [0, c]."""
    n_new = [int(n) for n in rng.integers(0, c + 1, size=b)]
    n_new[0] = c
    if b >= 4:
        n_new[1:3] = [0, 1]
    pos = []
    for i, n in enumerate(n_new):
        hi = n_pages * bs - max(n, 1)
        p = int(rng.integers(0, hi + 1))
        if i == 0:
            p = min(max(0, (p // bs) * bs + bs - n), hi)
        pos.append(p)
    return pos, n_new


# ----------------------------------------------------------------- phases


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = kbuild.build_all()
    ptxas = {}
    for name in kbuild.KERNELS:
        log = kbuild.library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 2),
          "per_kernel_s": {k: round(v, 2) for k, v in seconds.items()},
          "ptxas": ptxas})


def phase_kernel(dev) -> dict:
    rng = np.random.default_rng(SEED)
    n_cases, worst, worst_rel, designs = 0, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        errs = [(0.0, 0.0)]
        # the CPU tests' sweep (b=2, hd=32, 4 pages)
        for kv in (1, 2):
            for g in (1, 2, 4):
                for bs in (4, 8, 16):
                    for c in (1, 2, 3, 4):
                        pos, n_new = lane_states(rng, 2, c, bs, 4)
                        args = paged_case(2, c, kv, g, 32, bs, 4, pos, n_new,
                                          dtype, n_cases, dev)
                        errs.append(compare(args, TOL[dtype]))
                        n_cases += 1
        # edges: the largest head_dim and block the kernel takes, and a
        # block wider than a warp
        for kv, g, hd, bs, c in ((2, 3, 256, 64, 5), (4, 1, 96, 32, 3),
                                 (1, 8, 200, 48, 2)):
            pos, n_new = lane_states(rng, 4, c, bs, 6)
            args = paged_case(4, c, kv, g, hd, bs, 6, pos, n_new, dtype,
                              n_cases, dev)
            errs.append(compare(args, TOL[dtype]))
            n_cases += 1
        # full width, serving geometry: 4 slots, 64 pages of 16
        for name, kv, g, hd in FULL_WIDTH:
            for c in (1, CHUNK):
                pos, n_new = lane_states(rng, SLOTS, c, BLOCK, MAX_LEN // BLOCK)
                args = paged_case(SLOTS, c, kv, g, hd, BLOCK, MAX_LEN // BLOCK,
                                  pos, n_new, dtype, n_cases, dev)
                errs.append(compare(args, TOL[dtype]))
                n_cases += 1
                designs[f"{name}/c{c}/{str(dtype)[6:]}"] = paged_design(
                    dtype, c, g, hd)
        worst[str(dtype).replace("torch.", "")] = max(e for e, _ in errs)
        worst_rel[str(dtype).replace("torch.", "")] = max(r for _, r in errs)
    check(set(designs.values()) == {"mma", "scalar"},
          f"the full-width cases take one design only: {designs}")
    emit({"phase": "kernel", "cases": n_cases, "max_abs_err": worst,
          "max_rel_norm_err": worst_rel,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16]},
          "rel_norm_tolerance": {"bfloat16": REL_TOL},
          "full_width_designs": designs})
    return worst


def phase_moe_kernel(dev) -> None:
    """The every-row mode (``all_rows``, the moe family's) against the plain
    version on every row of every lane, idle lanes and dead rows included:
    qwen3-moe's and granite-moe's full-width geometries at the serving
    geometry, a decode chunk of 1 and the engine's 16."""
    rng = np.random.default_rng(SEED + 1)
    n_cases, worst, worst_rel, designs = 0, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        errs = []
        for name, kv, g, hd in MOE_GEOMS:
            for c in (1, CHUNK):
                n_pages = MAX_LEN // BLOCK
                pos, n_new = lane_states(rng, SLOTS, c, BLOCK, n_pages)
                args = paged_case(SLOTS, c, kv, g, hd, BLOCK, n_pages, pos,
                                  n_new, dtype, 1000 + n_cases, dev)
                errs.append(compare(args, TOL[dtype], all_rows=True))
                n_cases += 1
                designs[f"{name}/c{c}/{str(dtype)[6:]}"] = [
                    paged_design(dtype, c, g, hd),
                    paged_splits(SLOTS, c, kv, g, hd, BLOCK, n_pages, dtype)]
        worst[str(dtype)[6:]] = max(e for e, _ in errs)
        worst_rel[str(dtype)[6:]] = max(r for _, r in errs)
    check({d for d, _ in designs.values()} == {"mma", "scalar"},
          f"the every-row cases take one design only: {designs}")
    check(any(n > 1 for _, n in designs.values()),
          f"no every-row case splits a lane's pages: {designs}")
    emit({"phase": "moe_kernel", "cases": n_cases, "all_rows": True,
          "max_abs_err": worst, "max_rel_norm_err": worst_rel,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16]},
          "rel_norm_tolerance": {"bfloat16": REL_TOL},
          "designs_and_splits": designs})


def reference_err(cfg, steps, dev) -> float:
    """Max |logit| difference of the paged decode ``steps`` ((pos, n_new) of
    three lanes, chunk 4, pages of 8) through the kernel on the card and
    through the plain version on the CPU: reduced ``cfg``, seeded f32
    weights and pools."""
    model = build(cfg)
    params = P.tree_map(lambda t: t.float(), model.init_params(
        torch.Generator().manual_seed(SEED), "cpu"))
    spec = model.paged_cache_specs(16, 8)["paged"]["k"]
    pools = {"k": torch.zeros(spec.shape), "v": torch.zeros(spec.shape)}
    table = torch.tensor([[3, 7, 1, 0], [5, 2, 9, 0], [11, 4, 0, 0]],
                         dtype=torch.int32)
    rng = np.random.default_rng(SEED)
    on = {"cpu": (params, {"paged": pools}),
          "gpu": (P.tree_map(lambda t: t.to(dev), params),
                  {"paged": P.tree_map(lambda t: t.to(dev), pools)})}
    err = 0.0
    for pos, n_new in steps:
        toks = rng.integers(0, cfg.vocab_size, size=(3, 4))
        logits = {}
        for where, (prm, cache) in on.items():
            d = dev if where == "gpu" else torch.device("cpu")
            logits[where] = decode_paged_chunk(
                cfg, prm, cache, torch.tensor(toks, device=d),
                torch.tensor(pos, dtype=torch.int32, device=d),
                torch.tensor(n_new, dtype=torch.int32, device=d),
                table.to(d)).cpu()
        err = max(err, float((logits["gpu"] - logits["cpu"]).abs().max()))
    return err


def phase_reference(dev) -> None:
    """One model, two devices: the paged step through the CUDA kernel and
    through the plain version on the CPU, f32 weights and pools."""
    cfg = reduced(ALL_ARCHS[ARCH])
    steps = [([0, 0, 0], [4, 3, 0]), ([4, 3, 0], [1, 4, 2]),
             ([5, 7, 2], [1, 1, 4])]
    err = reference_err(cfg, steps, dev)
    check(err < 1e-3, f"GPU paged step vs CPU plain step: max |dlogit| {err}")
    emit({"phase": "reference", "arch": cfg.name, "dtype": "float32",
          "steps": len(steps), "max_abs_logit_err": err, "tolerance": 1e-3})


@contextlib.contextmanager
def live_rows_only():
    """The model's paged calls lose their every-row argument: the kernel
    computes each lane's live rows and writes zeros past them, as for the
    dense family.  The fault the moe_reference phase must see."""
    saved = ops.paged_attention
    ops.paged_attention = lambda *args, all_rows=False: saved(*args)
    try:
        yield
    finally:
        ops.paged_attention = saved


def phase_moe_reference(dev) -> None:
    """Reduced qwen3-moe's paged step through the kernel on the card against
    the plain version on the CPU, f32: a moe step routes every row of the
    batch together, so the dead rows must be computed as the plain version
    computes them.  Without the every-row argument the same steps must
    miss the bound."""
    cfg = reduced(ALL_ARCHS[MOE_SERVE_ARCH])
    err = reference_err(cfg, MOE_REF_STEPS, dev)
    with live_rows_only():
        err_live = reference_err(cfg, MOE_REF_STEPS, dev)
    check(err < 1e-3, f"moe: GPU paged step vs CPU plain step: max |dlogit| "
                      f"{err}")
    check(err_live > 1e-3, f"moe: the step without the every-row argument "
                           f"stays within the bound ({err_live}): the check "
                           f"cannot see the fault")
    emit({"phase": "moe_reference", "arch": cfg.name, "dtype": "float32",
          "steps": len(MOE_REF_STEPS), "max_abs_logit_err": err,
          "live_rows_only_max_abs_logit_err": err_live, "tolerance": 1e-3})


class RecordingModel:
    """Wraps the model's paged step to keep the arguments of the widest
    tick with every slot busy: the parity and timing phases replay that
    tick's real page table on the pool the run leaves behind.  Each call
    reads its arguments back from the device, so it wraps an untimed
    replay of the serving run, never the timed one."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.best = None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _record(self, pos, n_new, page_table):
        if int((n_new > 0).sum()) == SLOTS:
            keys = int(pos.sum())
            if self.best is None or keys >= self.best[0]:
                self.best = (keys, pos.clone(), n_new.clone(),
                             page_table.clone())

    def decode_paged_greedy_chunk(self, params, cache, tokens, pos, n_new,
                                  page_table):
        self._record(pos, n_new, page_table)
        return self.model.decode_paged_greedy_chunk(params, cache, tokens,
                                                    pos, n_new, page_table)

    def decode_paged_sample_chunk(self, params, cache, tokens, pos, n_new,
                                  page_table, lane):
        self._record(pos, n_new, page_table)
        return self.model.decode_paged_sample_chunk(
            params, cache, tokens, pos, n_new, page_table, lane)


def serve_requests(cfg) -> list:
    """The serving trace, made anew from the seed on every call."""
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX).tolist()
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=1)
    return [Request(rid=i, max_new=MAX_NEW,
                    prompt=prefix + rng.integers(
                        0, cfg.vocab_size,
                        size=int(rng.integers(16, 257))).tolist(),
                    sampling=sampled if i == 3 else None)
            for i in range(N_REQUESTS)]


def phase_serve(dev):
    cfg = ALL_ARCHS[ARCH]
    t0 = time.perf_counter()
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(params))

    # warm-up (cuBLAS handles, allocator) on a small engine of its own
    warm = PagedServeEngine(model, params, slots=2, max_len=64,
                            block_size=BLOCK, chunk=CHUNK, num_blocks=16,
                            device=dev)
    warm.run([Request(rid=0, prompt=list(range(20)), max_new=3)])
    del warm

    reqs = serve_requests(cfg)
    before = torch.cuda.memory_allocated()
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    rep = eng.report()
    check(rep["served"] == N_REQUESTS, f"served {rep['served']}")
    check(rep["prefix_hit_rate"] > 0, "no prefix-cache hits")
    check(launches["paged_attention"] == rep["decode_steps"] * cfg.n_layers,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"expected decode_steps x layers = "
          f"{rep['decode_steps']} x {cfg.n_layers}")
    eng.alloc.check()
    eng.host.check()
    for r in done:
        check(len(r.out) == MAX_NEW, f"request {r.rid}: {len(r.out)} tokens")
        check(all(0 <= t < cfg.padded_vocab for t in r.out),
              f"request {r.rid}: token outside the vocab")
    streams = {r.rid: r.out for r in done}
    del eng
    check_freed(before, "the serve engine")

    # the same trace again, untimed, through the recording wrapper: its
    # pool and widest busy tick feed the parity and timing phases
    recorder = RecordingModel(model)
    replay = PagedServeEngine(recorder, params, slots=SLOTS, max_len=MAX_LEN,
                              block_size=BLOCK, chunk=CHUNK, device=dev)
    replayed = {r.rid: r.out for r in replay.run(serve_requests(cfg))}
    replay.alloc.check()
    check(recorder.best is not None, "no tick with every slot busy")
    emit({"phase": "serve", "arch": cfg.name, "params": n_params,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "init_s": round(init_s, 2), "wall_s": round(wall, 3),
          "decode_steps": rep["decode_steps"],
          "ms_per_tick": round(1e3 * wall / rep["decode_steps"], 3),
          "tokens_out_per_s": round(rep["tokens_out"] / wall, 2),
          "tokens_processed_per_s": round(
              (rep["tokens_out"] + rep["prefill_tokens"]) / wall, 2),
          "launches": launches,
          "peak_mem_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 2),
          "report": rep,
          "replay_streams_equal": replayed == streams,
          "first_tokens": {rid: out[:4] for rid, out in streams.items()}})
    paged = {"streams": streams, "tokens_out_per_s": rep["tokens_out"] / wall,
             "wall_s": wall}
    return model, params, replay, recorder.best, launches, paged


# the paged-attention kernels' names in a profiler trace
PAGED_KERNEL_NAMES = ("paged_mma_kernel", "paged_scalar_kernel",
                      "paged_merge_kernel")


def phase_profile(model, params, dev) -> None:
    emit({"phase": "profile", **serve_profile(model, params, dev)})


def serve_profile(model, params, dev, warm=30, ticks=10, spans=()) -> dict:
    """Where a serving tick's time goes: the serve phase's traffic on a
    fresh engine, ``ticks`` ticks timed on the host clock, then the next
    ``ticks`` under ``torch.profiler`` for device time by kernel (and
    under each of ``spans``).  The device's busy share is the profiled
    device time per tick over the unprofiled wall time per tick (the
    profiler inflates wall time)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX).tolist()
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    for i in range(N_REQUESTS):
        eng.submit(Request(rid=i, max_new=MAX_NEW, prompt=prefix + rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(16, 257))).tolist()))
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(prof)
    device_ms = sum(by_kernel.values()) / ticks
    paged_by_name = {name: sum(v for k, v in by_kernel.items() if name in k)
                     / ticks for name in PAGED_KERNEL_NAMES}
    paged = sum(paged_by_name.values()) * ticks
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"ticks": ticks, "after_ticks": warm,
           "wall_ms_per_tick": wall_ms, "device_ms_per_tick": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "paged_attention_ms_per_tick": paged / ticks,
           "paged_attention_kernels_ms_per_tick": paged_by_name,
           "paged_attention_share_of_device": paged / ticks / device_ms,
           "weights_read_bound_ms_per_tick":
               2 * P.count(model.param_specs()) / HBM_BYTES_PER_S * 1e3,
           "top_kernels_ms_per_tick": {k[:60]: v / ticks for k, v in top}}
    if spans:
        out["span_ms_per_tick"] = {k: v / ticks for k, v in
                                   span_device_ms(prof, spans).items()}
    return out


def bound_ms(q, page_table, pos, n_new, k_pool, all_rows=False):
    """The least time for the call, from this run's data: the bytes the
    function must move (the K/V rows of the distinct physical pages the
    lanes visit, once each even where lanes share a page; the computed q
    rows once, every row with ``all_rows``; the whole output once; the
    table) over HBM rate, or its flops over the peak of its operand type,
    whichever is larger."""
    b, c, kv, g, hd = q.shape
    bs, item = k_pool.shape[1], q.element_size()
    n_pages = page_table.shape[1]
    bytes_, flops = 0, 0
    keys_read = {}          # physical page -> keys of it some lane reads
    for lane, (p, n) in enumerate(zip(pos.tolist(), n_new.tolist())):
        rows = c if all_rows else max(n, 1)
        keys = min(p + rows, n_pages * bs)
        for j, page in enumerate(page_table[lane, :-(-keys // bs)].tolist()):
            keys_read[page] = max(keys_read.get(page, 0),
                                  min(bs, keys - j * bs))
        bytes_ += rows * kv * g * hd * item
        flops += sum(4 * hd * kv * g * min(p + i + 1, n_pages * bs)
                     for i in range(rows))
    bytes_ += 2 * sum(keys_read.values()) * kv * hd * item
    bytes_ += q.numel() * item + page_table.numel() * 4 + 2 * b * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


def time_cold(fn, dev, n=50) -> float:
    """Median device ms of ``fn`` over ``n`` calls, each after the L2 cache
    (50 MB) was flushed, as the serving loop finds it after the other
    layers ran.  A spin kernel (about 2 ms) holds the stream while the host
    enqueues ``fn``, so the events bracket device work only, not the
    host's time to issue it."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_args(q, k_pool, v_pool, page_table, pos):
    """Dense K/V gathered through the page table and the same causal chunk
    mask, laid out for ``scaled_dot_product_attention`` with GQA."""
    b, c, kv, g, hd = q.shape
    n_pages, bs = page_table.shape[1], k_pool.shape[1]
    s = n_pages * bs
    k = k_pool[page_table.long()].reshape(b, s, kv, hd).transpose(1, 2)
    v = v_pool[page_table.long()].reshape(b, s, kv, hd).transpose(1, 2)
    qs = q.reshape(b, c, kv * g, hd).transpose(1, 2)
    rows = pos[:, None].long() + torch.arange(c, device=q.device)[None]
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= rows[:, :, None])[:, None]
    return qs.contiguous(), k.contiguous(), v.contiguous(), mask


def phase_parity_and_timing(eng, best, dev):
    _, pos, n_new, page_table = best
    cfg = eng.model.cfg
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    k_pool, v_pool = eng.view.k[0], eng.view.v[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((SLOTS, CHUNK, kv, g, hd), generator=gen,
                    device=dev).to(k_pool.dtype)
    args = (q, k_pool, v_pool, page_table, pos, n_new)
    bs = k_pool.shape[1]
    live = [set(page_table[i, :(p + max(n, 1) + bs - 1) // bs].tolist())
            for i, (p, n) in enumerate(zip(pos.tolist(), n_new.tolist()))]
    shared = len(set.intersection(*live))
    err, rel = compare(args, TOL[q.dtype])
    emit({"phase": "parity", "layer": 0, "pos": pos.tolist(),
          "n_new": n_new.tolist(), "pages_shared_by_all_slots": shared,
          "max_abs_err": err, "rel_norm_err": rel, "tolerance": TOL[q.dtype]})

    from torch.nn.functional import scaled_dot_product_attention as sdpa
    qs, ks, vs, mask = sdpa_args(*args[:5])
    lib_out = sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    ref = paged_attention_plain(*args)
    lib_err = max(
        float((lib_out[i].transpose(0, 1).reshape(CHUNK, kv, g, hd)[:n]
               .float() - ref[i, :n].float()).abs().max())
        for i, n in enumerate(n_new.tolist()) if n)
    bound, bound_by, bytes_, flops = bound_ms(q, page_table, pos, n_new,
                                              k_pool)
    t_kernel = time_cold(lambda: paged_attention_cuda(*args), dev)
    t_plain = time_cold(lambda: paged_attention_plain(*args), dev)
    t_lib = time_cold(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                   enable_gqa=True), dev)
    b, c, kv, g, hd = q.shape
    timing = {"phase": "timing", "shape": list(q.shape),
              "dtype": str(q.dtype).replace("torch.", ""),
              "pos": pos.tolist(), "n_new": n_new.tolist(),
              "design": paged_design(q.dtype, c, g, hd),
              "splits": paged_splits(b, c, kv, g, hd, bs,
                                     page_table.shape[1], q.dtype),
              "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
              "launch_floor_ms": launch_floor_ms(dev),
              "library": "scaled_dot_product_attention(enable_gqa) on K/V "
                         "pre-gathered through the page table",
              "library_max_abs_err": lib_err,
              "bound_ms": bound, "bound_by": bound_by, "bytes": bytes_,
              "flops": flops, "bound_share": bound / t_kernel,
              "gpu": nvidia_smi()}
    emit(timing)
    return err, timing


# the tick's geometry (4 lanes, 64 pages of 16, kv 32, g 1, hd 128, bf16)
# with every lane decoding one row over this many pages
SWEEP_PAGES = (1, 2, 4, 8, 16, 32, 64)
# long contexts: 16 lanes x 2,048 keys (128 pages of 16), bf16, q a chunk
# of CHUNK rows a lane as the engine passes it:
# (arch, kv heads, group, head_dim, fresh rows a lane)
LONG_LANES, LONG_KEYS = 16, 2048
LONG_SHAPES = [("deepseek-7b", 32, 1, 128, 1),
               ("deepseek-coder-33b", 8, 7, 128, 1),
               ("deepseek-coder-33b", 8, 7, 128, CHUNK)]


def launch_floor_ms(dev) -> float:
    """``time_cold`` of a one-element ``add_``: the least time any launch
    takes under that harness."""
    one = torch.zeros(1, device=dev)
    return time_cold(lambda: one.add_(1.0), dev)


def phase_paged_timing(dev) -> dict:
    """The paged kernel beside its launch floor: a sweep of pages a lane at
    the tick's geometry (fixed cost against cost a page, by a least-squares
    line), then the long-context shapes at the engine's chunk: kernel,
    plain version and SDPA (a yardstick the port never calls) beside the
    bytes or flops bound."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    floor = launch_floor_ms(dev)
    kv, g, hd = 32, 1, 128
    sweep = []
    for pages in SWEEP_PAGES:
        keys = pages * BLOCK
        args = paged_case(SLOTS, CHUNK, kv, g, hd, BLOCK, MAX_LEN // BLOCK,
                          [keys - 1] * SLOTS, [1] * SLOTS, torch.bfloat16,
                          pages, dev)
        compare(args, TOL[torch.bfloat16])
        sweep.append({"pages": pages,
                      "ms": time_cold(lambda: paged_attention_cuda(*args),
                                      dev),
                      "bound_ms": bound_ms(args[0], args[3], args[4],
                                           args[5], args[1])[0]})
    per_page, fixed = np.polyfit([s["pages"] for s in sweep],
                                 [s["ms"] for s in sweep], 1)
    shapes = []
    c = CHUNK
    for name, kv, g, hd, n in LONG_SHAPES:
        args = paged_case(LONG_LANES, c, kv, g, hd, BLOCK, LONG_KEYS // BLOCK,
                          [LONG_KEYS - n] * LONG_LANES, [n] * LONG_LANES,
                          torch.bfloat16, SEED, dev)
        err, rel = compare(args, TOL[torch.bfloat16])
        q, k_pool, v_pool, page_table, pos, n_new = args
        bound, bound_by, bytes_, flops = bound_ms(q, page_table, pos, n_new,
                                                  k_pool)
        qs, ks, vs, mask = sdpa_args(q, k_pool, v_pool, page_table, pos)
        t_kernel = time_cold(lambda: paged_attention_cuda(*args), dev)
        t_plain = time_cold(lambda: paged_attention_plain(*args), dev, n=10)
        t_lib = time_cold(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                       enable_gqa=True), dev)
        shapes.append({"arch": name, "shape": list(q.shape), "n_new": n,
                       "keys": LONG_KEYS,
                       "design": paged_design(q.dtype, c, g, hd),
                       "splits": paged_splits(LONG_LANES, c, kv, g, hd, BLOCK,
                                              LONG_KEYS // BLOCK, q.dtype),
                       "ms": t_kernel, "plain_ms": t_plain,
                       "library_ms": t_lib, "bound_ms": bound,
                       "bound_by": bound_by, "bytes": bytes_, "flops": flops,
                       "bound_share": bound / t_kernel,
                       "max_abs_err": err, "rel_norm_err": rel})
        del args, q, k_pool, v_pool, qs, ks, vs
        torch.cuda.empty_cache()
    timing = {"phase": "paged_timing", "launch_floor_ms": floor,
              "sweep": sweep, "sweep_fixed_ms": float(fixed),
              "sweep_ms_per_page": float(per_page), "shapes": shapes,
              "library": "scaled_dot_product_attention(enable_gqa) on K/V "
                         "pre-gathered through the page table",
              "gpu": nvidia_smi()}
    emit(timing)
    return timing


# ------------------------------------------------------------ flash kernel

# (bh, s, d): the tests/test_kernels.py:50-53 sweep (its S; the block
# shapes are the TPU kernel's own), the dense archs' head dims, a tail S
FLASH_SWEEP = [(3, s, 64) for s in (128, 256, 512)]
FLASH_HEAD_DIMS = [(2, 256, d) for d in (32, 64, 80, 96, 128)]
FLASH_TAIL = [(4, 100, 128), (2, 100, 64)]
# head dims that are not a multiple of 16: the scalar design in bf16 too
FLASH_SCALAR = [(2, 100, 36), (2, 256, 20)]
FLASH_GRAD_CASES = [(4, 256, 64), (2, 512, 128), (2, 100, 96)]


def flash_case(bh, s, d, dtype, seed, dev, grad=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((bh, s, d), generator=gen, device=dev)
                 .to(dtype).requires_grad_(grad) for _ in range(3))


def max_rel_to_max(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_flash_kernel(dev) -> dict:
    n_cases, worst, lse_worst, grad_worst = 0, {}, 0.0, {}
    designs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol, err = TOL[dtype], 0.0
        name = str(dtype).replace("torch.", "")
        for causal in (True, False):
            for bh, s, d in (FLASH_SWEEP + FLASH_HEAD_DIMS + FLASH_TAIL
                             + FLASH_SCALAR):
                designs[f"{bh}x{s}x{d} {name} causal={causal}"] = (
                    flash_design(dtype, d))
                q, k, v = flash_case(bh, s, d, dtype, n_cases, dev)
                out, lse = flash_attention_cuda(q, k, v, causal=causal)
                want = flash_attention_plain(q, k, v, causal=causal).float()
                want_lse = logsumexp_plain(q, k, causal=causal)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out.float()).all()),
                      f"non-finite flash output {(bh, s, d)} {dtype}")
                err = max(err, float((out.float() - want).abs().max()))
                lse_worst = max(lse_worst, float(
                    ((lse - want_lse).abs() / want_lse.abs().clamp_min(1))
                    .max()))
                check(torch.allclose(out.float(), want, rtol=tol, atol=tol),
                      f"flash kernel != plain: {(bh, s, d)} {dtype} "
                      f"causal={causal}")
                check(torch.allclose(lse, want_lse, rtol=2e-5, atol=2e-5),
                      f"flash log-sum-exp != plain: {(bh, s, d)} {dtype} "
                      f"causal={causal}")
                n_cases += 1
        g_err = 0.0
        for bh, s, d in FLASH_GRAD_CASES:
            d_out = flash_case(bh, s, d, dtype, 1000 + n_cases, dev)[0]
            grads = []
            for fn in (lambda q, k, v: FlashAttention.apply(q, k, v, True),
                       lambda q, k, v: flash_attention_plain(q, k, v)):
                q, k, v = flash_case(bh, s, d, dtype, n_cases, dev, grad=True)
                fn(q, k, v).backward(d_out)
                grads.append((q.grad, k.grad, v.grad))
            for got, want in zip(*grads):
                e = max_rel_to_max(got, want)
                g_err = max(g_err, e)
                check(e <= tol, f"flash gradients != plain autograd: "
                                f"{(bh, s, d)} {dtype}: {e}")
            n_cases += 1
        worst[name], grad_worst[name] = err, g_err
    check(set(designs.values()) == {"mma", "scalar"},
          f"the sweep does not cover both designs: {designs}")
    emit({"phase": "flash_kernel", "cases": n_cases, "max_abs_err": worst,
          "lse_max_rel_err": lse_worst,
          "grad_max_err_rel_to_max": grad_worst,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16], "lse": 2e-5},
          "head_dims": sorted({d for _, _, d in FLASH_SWEEP + FLASH_HEAD_DIMS
                               + FLASH_TAIL + FLASH_SCALAR}),
          "designs": designs})
    return worst


# ---------------------------------------------------------------- training


def loss_and_grads(model, params, batch):
    live = P.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch, remat="none", z_loss=1e-4)
    loss.backward()
    return loss.detach(), P.leaves(P.tree_map(lambda t: t.grad, live))


@contextlib.contextmanager
def plain_flash():
    """The model's flash calls go to the plain version, on the card: the
    reference side of the parity phase (the port itself has no switch)."""
    saved = ops.flash_attention
    ops.flash_attention = (lambda q, k, v, *, causal=True:
                           flash_attention_plain(q, k, v, causal=causal))
    try:
        yield
    finally:
        ops.flash_attention = saved


def rel_norm(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_train_parity(dev) -> None:
    cfg = dataclasses.replace(ALL_ARCHS[ARCH], n_layers=PARITY_LAYERS)
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    batch = model.sample_batch(ShapeConfig("parity", "train", PARITY_SEQ, 1),
                               SEED, dev)
    ops.reset_launches()
    loss_k, grads_k = loss_and_grads(model, params, batch)
    launches = ops.LAUNCHES["flash_attention"]
    with plain_flash():
        loss_p, grads_p = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    check(launches == PARITY_LAYERS,
          f"flash_attention launched {launches} times, expected one per "
          f"layer ({PARITY_LAYERS})")
    loss_err = rel_norm(loss_k, loss_p)
    errs = [rel_norm(a, b) for a, b in zip(grads_k, grads_p)]
    check(bool(torch.isfinite(loss_k)) and loss_err <= GRAD_TOL,
          f"loss through the kernel {float(loss_k)} vs plain "
          f"{float(loss_p)}")
    check(max(errs) <= GRAD_TOL,
          f"gradients through the kernel vs plain: max rel {max(errs)}")
    emit({"phase": "train_parity", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "seq": PARITY_SEQ, "batch": 1,
          "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
          "loss_rel_err": loss_err, "grad_leaves": len(errs),
          "grad_max_rel_norm_err": max(errs), "tolerance": GRAD_TOL,
          "flash_launches": launches})


def device_ms_by_kernel(prof) -> dict[str, float]:
    """Device milliseconds by kernel name from a ``torch.profiler`` run.
    Fails if the run holds no device time, saying what it did hold: its
    host events, the kernel launches among them, its device events and
    the card's free memory."""
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        # a record_function span shows on the device too: not a kernel
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
    if sum(by_kernel.values()) <= 0:
        events = prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        launches = sum("LaunchKernel" in ev.name for ev in events
                       if ev.device_type != cuda)
        check(False, f"the profiler saw no device time: {len(events)} "
              f"events, {launches} kernel launches on the host, "
              f"{sum(ev.device_type == cuda for ev in events)} on the "
              f"device; {torch.cuda.mem_get_info()[0] / 2**20:.0f} MiB "
              f"free on the card")
    return by_kernel


def span_device_ms(prof, names) -> dict[str, float]:
    """Device ms of the kernels launched inside each named
    ``record_function`` span, from its host-side ranges, summed."""
    out = {name: 0.0 for name in names}
    for ev in prof.events():
        if ev.name in out and ev.device_type == torch.autograd.DeviceType.CPU:
            out[ev.name] += ev.device_time_total / 1e3
    return out


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name, for the step's breakdown."""
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if "ssd_scan" in low:
        return "ssd_scan"
    if "hh_step" in low:
        return "hh_step"
    if "cable_epoch" in low:
        return "cable_epoch"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return ("matmul_f32" if "f32f32" in low or "sgemm" in low
                else "matmul_bf16")
    if "reduce" in low:
        return "reduction"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def train_setup(cfg, seq, batch, steps, dev):
    """What the training phases share: the model, its train step (remat
    full, the default schedule: 1000 steps, warmup 100), the first
    ``steps + 1`` host batches of the port's ``DataPipeline`` and a
    function that makes the seeded initial state."""
    model = build(cfg)
    step_fn = make_train_step(model, RunConfig(
        cfg, ShapeConfig("train", "train", seq, batch),
        TrainConfig(remat="full")))
    data = DataPipeline(DataConfig(cfg.vocab_size, seq, batch, seed=SEED))
    batches = [next(data)[1] for _ in range(steps + 1)]
    data.close()
    return model, step_fn, batches, lambda: init_train_state(
        model, torch.Generator(device=dev).manual_seed(SEED), dev)


def run_steps(step_fn, state, host_batches, dev, metrics_out=None):
    """Steps over ``host_batches``, each timed on the host clock from its
    batch's copy to the card to the host's read of its loss; each step's
    scalar metrics appended to ``metrics_out`` when it is given."""
    losses, step_s = [], []
    for host_batch in host_batches:
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(a, device=dev)
                 for k, a in host_batch.items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))   # the step's host sync
        step_s.append(time.perf_counter() - t0)
        if metrics_out is not None:
            metrics_out.append({k: float(v) for k, v in metrics.items()
                                if v.numel() == 1})
    return state, losses, step_s


def profiled_step(step_fn, state, host_batch, dev, spans=(), warmup=False):
    """One more step under ``torch.profiler``: (state, device ms, device
    ms by kernel kind, the top kernels, device ms under each of
    ``spans``).  ``warmup``: one step before it on the same batch under
    the profiler's warm-up (CUPTI's activity tracing on, its records
    dropped), so the recorded step's window is not the first one CUPTI
    opens for this profile."""
    from torch.profiler import ProfilerActivity, profile, schedule
    batch = {k: torch.as_tensor(a, device=dev)
             for k, a in host_batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=(schedule(wait=0, warmup=1, active=1)
                           if warmup else None)) as prof:
        if warmup:
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            prof.step()                 # warm-up ends, recording starts
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(prof)
    by_kind = {}
    for name, ms in by_kernel.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return (state, sum(by_kernel.values()), by_kind,
            {k[:70]: v for k, v in top}, span_device_ms(prof, spans))


def phase_train(dev) -> tuple[dict, float]:
    """Full-width deepseek-7b at 8 layers: 4 steps through the port's train
    step, launch counts zeroed just before and read just after; then one
    more step under ``torch.profiler``."""
    cfg = dataclasses.replace(ALL_ARCHS[ARCH], n_layers=TRAIN_LAYERS)
    # the first steps of the default schedule; at this width and 8,192
    # tokens a batch they already oscillate, the optimizer's doing, as the
    # plain-version run below shows (PERF.md)
    _, step_fn, batches, fresh = train_setup(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                             TRAIN_STEPS, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = fresh()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(state.params))
    ops.reset_launches()
    state, losses, step_s = run_steps(step_fn, state, batches[:TRAIN_STEPS],
                                      dev)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    expected = 2 * TRAIN_LAYERS * TRAIN_STEPS
    check(launches["flash_attention"] == expected,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected 2 x layers x steps = {expected} (forward and remat "
          f"recompute)")
    check(launches["paged_attention"] == 0, "paged attention ran in training")
    design = flash_design(getattr(torch, cfg.dtype), cfg.resolved_head_dim)
    check(design == "mma", f"the training call took the {design} design")

    steady_ms = statistics.median(step_s[1:]) * 1e3
    state, device_ms, by_kind, top, spans = profiled_step(
        step_fn, state, batches[TRAIN_STEPS], dev, ("adamw_update",))
    flash_ms = by_kind.get("flash_attention", 0.0)
    # the same steps from the same seed with the plain version on the
    # card: the kernel's training trajectory must track it
    del state
    torch.cuda.empty_cache()
    with plain_flash():
        _, plain_losses, _ = run_steps(step_fn, fresh(),
                                       batches[:TRAIN_STEPS], dev)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    check(traj_err <= TRAJ_TOL, f"losses through the kernel {losses} vs the "
                                f"plain version {plain_losses}")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params, "seq": TRAIN_SEQ,
          "batch": TRAIN_BATCH, "remat": "full", "init_s": round(init_s, 2),
          "losses": losses, "plain_losses": plain_losses,
          "loss_rel_err_vs_plain": traj_err, "tolerance": TRAJ_TOL,
          "step_ms": [1e3 * t for t in step_s],
          "steady_ms_per_step": steady_ms,
          "tokens_per_s": tokens / steady_ms * 1e3,
          "peak_mem_gb": peak_gb, "launches": launches,
          "flash_design": design,
          "profile": {"device_ms_per_step": device_ms,
                      "device_busy_share": device_ms / steady_ms,
                      "flash_kernel_ms_per_step": flash_ms,
                      "flash_share_of_device": flash_ms / device_ms,
                      "span_ms": spans,
                      "ms_by_kind": by_kind, "top_kernels_ms": top}})
    return launches, steady_ms


TRAIN_CLI_ARGS = dict(steps=4, total_steps=4, ckpt_every=2, seq_len=128,
                      global_batch=4)


def phase_train_cli() -> tuple[dict, dict, dict]:
    """The launcher on the card at reduced scale: cut at the step-2
    checkpoint and resumed, it gives the uninterrupted run's losses; the
    uninterrupted run's result and manifest, and the three runs' launches,
    are returned for ``train_cli_env``."""
    kw = dict(TRAIN_CLI_ARGS, device="cuda")
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        full = train_cli(ARCH, out_dir=f"{tmp}/full", **kw)
        first = train_cli(ARCH, out_dir=f"{tmp}/cut", **dict(kw, steps=2))
        resumed = train_cli(ARCH, out_dir=f"{tmp}/cut", resume=True, **kw)
        manifest = json.loads(Path(f"{tmp}/full/manifest.json").read_text())
    launches = dict(ops.LAUNCHES)
    cut = first["losses"] + resumed["losses"]
    diff = max(abs(a - b) / abs(b) for a, b in zip(cut, full["losses"]))
    check(len(cut) == 4 and diff <= 1e-5,
          f"resumed losses {cut} != uninterrupted {full['losses']}")
    check(full["loss_decreased"], f"launcher losses {full['losses']}")
    check(resumed["audit"]["trace"].get("ckpt-restore") == 1, "no restore")
    layers = reduced(ALL_ARCHS[ARCH]).n_layers
    check(launches["flash_attention"] == 2 * layers * (4 + 2 + 2),
          f"the launcher's runs launched flash {launches} times, expected "
          f"2 x layers x 8 steps")
    emit({"phase": "train_cli", "arch": full["arch"], "losses": full["losses"],
          "resumed_losses": cut, "max_rel_diff": diff,
          "bit_exact": cut == full["losses"],
          "trace": full["audit"]["trace"], "launches": launches})
    return full, manifest, launches


ENV_LAYERS, ENV_SEQ = 2, 128    # full width; a length the flash kernel takes


def attested_first_step(step_fn, state, host_batch, dev):
    """The first step of a run, recorded: (program, its transport report,
    the loss)."""
    batch = {k: torch.as_tensor(a, device=dev) for k, a in host_batch.items()}
    with attest.record() as program:
        state, metrics = step_fn(state, batch)
    return (program, attest.parse_program(program.text, TINY_MESH.n_devices),
            float(metrics["loss"]))


def phase_env_manifest(dev) -> dict:
    """The environment layer on the card: deepseek-7b's train step at full
    width (cut to 2 layers, seq 128, batch 1) captured, bound and attested.
    The binding names the card and its power limit as ``nvidia-smi`` does;
    two attestations of the first step (fresh states from one seed) give
    one fingerprint, name the flash kernel and no plain version, and show
    no host transfer; the same step without the recording gives the same
    loss, bit for bit; the same step attested on the CPU gives another
    program, which ``diff`` tags as expected (the binding differs)."""
    cfg = dataclasses.replace(ALL_ARCHS[ARCH], n_layers=ENV_LAYERS)
    tc = TrainConfig(remat="full")
    shape = ShapeConfig("train", "train", ENV_SEQ, 1)
    man = Manifest(PortableEnv.capture(cfg, shape, tc, "baseline"))
    man.bind(dev, TINY_MESH)
    smi = nvidia_smi()
    check(f"{man.binding.device_kind}, {man.binding.power_limit}" == smi,
          f"binding {man.binding} against nvidia-smi {smi!r}")
    _, step_fn, batches, fresh = train_setup(cfg, ENV_SEQ, 1, 1, dev)
    ops.reset_launches()
    runs = [attested_first_step(step_fn, fresh(), batches[0], dev)
            for _ in range(2)]
    launches = dict(ops.LAUNCHES)
    _, bare_losses, _ = run_steps(step_fn, fresh(), batches[:1], dev)
    (program, report, loss), (again, _, loss_again) = runs
    man.attest(program_text=program.text, collectives=report.summary())
    fingerprint = man.attestation["program_fingerprint"]
    check(again.text == program.text, "two attestations of the first step "
                                      "recorded different programs")
    kernel_calls = [line for line in program.lines
                    if line.startswith(("kernel::", "plain::"))]
    check(len(kernel_calls) == 2 * ENV_LAYERS and all(
        line.startswith("kernel::flash_attention(") for line in kernel_calls)
        and "plain::" not in program.text,
        f"the card's program calls {kernel_calls}")
    check(launches["flash_attention"] == 2 * len(kernel_calls),
          f"flash launched {launches} times over two attested steps")
    check(report.ops == [] and report.findings == [],
          f"the card's step: {report.summary()}")
    check(loss == loss_again == bare_losses[0],
          f"attested losses {loss}, {loss_again} against {bare_losses[0]} "
          f"without the recording")
    del fresh, step_fn
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, cpu_step, cpu_batches, cpu_fresh = train_setup(cfg, ENV_SEQ, 1, 1,
                                                      "cpu")
    cpu_program, cpu_report, cpu_loss = attested_first_step(
        cpu_step, cpu_fresh(), cpu_batches[0], "cpu")
    cpu_s = time.perf_counter() - t0
    del cpu_step, cpu_fresh
    cpu_man = Manifest(man.portable).bind("cpu", TINY_MESH)
    cpu_man.attest(program_text=cpu_program.text,
                   collectives=cpu_report.summary())
    lines = manifest_diff(man, cpu_man)
    check(bool(lines) and lines[-1].endswith("[EXPECTED (binding differs)]")
          and not any(line.startswith("portable.") for line in lines),
          f"diff card vs CPU: {lines}")
    check("plain::flash_attention_plain(" in cpu_program.text
          and "kernel::" not in cpu_program.text,
          "the CPU's program does not name the plain version alone")
    emit({"phase": "env_manifest", "arch": cfg.name, "layers": ENV_LAYERS,
          "d_model": cfg.d_model, "seq": ENV_SEQ, "batch": 1,
          "image_hash": man.portable.image_hash,
          "binding": dataclasses.asdict(man.binding),
          "nvidia_smi": smi, "cuda_version": man.portable.cuda_version,
          "program_fingerprint": fingerprint,
          "program_ops": len(program.lines),
          "program_bytes": man.attestation["program_bytes"],
          "kernel_calls": len(kernel_calls), "launches": launches,
          "losses": [loss, loss_again], "loss_without_recording":
          bare_losses[0], "cpu_loss": cpu_loss,
          "cpu_fingerprint": cpu_man.attestation["program_fingerprint"],
          "cpu_program_ops": len(cpu_program.lines), "cpu_s": cpu_s,
          "diff_card_vs_cpu": lines,
          "transport": report.summary()})
    return launches


def phase_train_cli_env(full: dict, manifest: dict) -> None:
    """``python -m repro_torch.launch.train`` on the card in a process of its
    own, with the train_cli phase's arguments: exit code 0, ``manifest.json``
    written with the in-process run's image hash, binding and program
    fingerprint, the audit's gate passed and the same losses."""
    root = Path(__file__).resolve().parent
    args = {"--steps": TRAIN_CLI_ARGS["steps"],
            "--ckpt-every": TRAIN_CLI_ARGS["ckpt_every"],
            "--seq-len": TRAIN_CLI_ARGS["seq_len"],
            "--global-batch": TRAIN_CLI_ARGS["global_batch"]}
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
             "--out", tmp, *[str(x) for kv in args.items() for x in kv]],
            capture_output=True, text=True, timeout=600, cwd=root,
            env={**os.environ, "PYTHONPATH": str(root / "src")})
        check(r.returncode == 0, f"train CLI exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        out = json.loads(r.stdout)
        written = json.loads((Path(tmp) / "manifest.json").read_text())
    check(out["audit"]["gate_ok"] and out["diagnostics"] == "ok",
          f"train CLI audit: {out['audit']}")
    check(out["image_hash"] == written["image_hash"] == full["image_hash"],
          f"image hashes: CLI {out['image_hash']}, its manifest "
          f"{written['image_hash']}, in-process {full['image_hash']}")
    check(written["binding"]["device_kind"] == torch.cuda.get_device_name(0)
          and written["binding"]["power_limit"]
          == manifest["binding"]["power_limit"],
          f"the CLI's binding {written['binding']}")
    check(written["attestation"]["program_fingerprint"]
          == manifest["attestation"]["program_fingerprint"],
          "the CLI's step program differs from the in-process run's")
    loss_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(out["losses"], full["losses"]))
    check(len(out["losses"]) == len(full["losses"]) and loss_diff <= 1e-5,
          f"CLI losses {out['losses']} vs in-process {full['losses']}")
    emit({"phase": "train_cli_env", "arch": out["arch"],
          "image_hash": out["image_hash"], "binding": written["binding"],
          "attestation": {k: written["attestation"][k] for k in (
              "program_fingerprint", "program_bytes")},
          "wireup": out["wireup"], "audit": out["audit"],
          "losses": out["losses"], "max_rel_diff_vs_in_process": loss_diff,
          "bit_exact": out["losses"] == full["losses"]})


# each example, the kernels its LAUNCHES line must show, and its arguments
EXAMPLES = {"quickstart": (("flash_attention",), []),
            "ring_simulation": (("cable_epoch",), []),
            "serve_lm": (("paged_attention",), []),
            "train_lm": (("flash_attention",), ["--out", "run"]),
            "verify_env": (("flash_attention",), [])}


@contextlib.contextmanager
def running_examples():
    """Start the five examples of ``examples/torch/`` on the card, each in a
    process of its own, all at once (each is small), their output going to
    files; yields ``{name: (start time, process, output file)}`` and stops
    every process still running on the way out."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name, (_, args) in EXAMPLES.items():
                cwd = Path(tmp) / name
                cwd.mkdir()
                log = cwd / "out.log"
                with open(log, "w") as sink:
                    procs[name] = (time.perf_counter(), subprocess.Popen(
                        [sys.executable, str(root / "examples" / "torch"
                                             / f"{name}.py"), *args],
                        cwd=cwd, env=env, stdout=sink,
                        stderr=subprocess.STDOUT), log)
            yield procs
        finally:
            for _, proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def phase_examples(procs: dict) -> dict:
    """Each example exits 0 with ``OK`` on its last line, and the launches
    it prints show its kernels."""
    out = {}
    for name, (t0, proc, log) in procs.items():
        rc = proc.wait(timeout=600)
        wall = time.perf_counter() - t0
        lines = log.read_text().strip().splitlines()
        check(rc == 0, f"example {name} exited {rc}: {lines[-20:]}")
        check(lines[-1].startswith("OK"), f"{name}: {lines[-3:]}")
        at = next(i for i, line in enumerate(lines)
                  if line.startswith("LAUNCHES "))
        launches = json.loads(lines[at][len("LAUNCHES "):])
        check(all(launches[k] > 0 for k in EXAMPLES[name][0]),
              f"{name} launched {launches}")
        out[name] = {"wall_s": wall, "launches": launches,
                     "said": lines[at - 1]}
    emit({"phase": "examples", **out})
    return out


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel entry in a library's
    build log (``-Xptxas=-v``), by mangled entry name."""
    log = kbuild.library_path(name).with_suffix(".log").read_text()
    entries, cur = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = entries.setdefault(m.group(1), {})
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m.group(1))
    return entries


def phase_flash_timing(dev) -> tuple[float, dict]:
    """The kernel at the training call's shape: B·H = 4 x 32, S 2048,
    head dim 128, bf16, causal."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    bh, s, d = TRAIN_BATCH * ALL_ARCHS[ARCH].n_heads, TRAIN_SEQ, 128
    design = flash_design(torch.bfloat16, d)
    check(design == "mma", f"the training shape takes the {design} design")
    mma = {e: r for e, r in ptxas_report("flash_attention").items()
           if "flash_attention_mma_kernel" in e}
    check(bool(mma) and all(r.get("spill_stores", 1) == 0
                            and r.get("spill_loads", 1) == 0
                            for r in mma.values()),
          f"a tensor-core flash instantiation spills: {mma}")
    ptxas = next(r for e, r in mma.items() if f"ILi{d}E" in e)
    q, k, v = flash_case(bh, s, d, torch.bfloat16, SEED, dev)
    out, _ = flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    lib = sdpa(q[None], k[None], v[None], is_causal=True)[0]
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    # both round one fp32 result to bf16, so they may differ by one bf16
    # step at most: 2^-7 of the value, plus 1e-4 for fp32 sum order
    check(torch.allclose(out.float(), want.float(), rtol=2 ** -7, atol=1e-4),
          f"flash kernel != plain at the training shape: {err}")
    lib_err = float((lib.float() - want.float()).abs().max())
    del out, want, lib
    # the causal rows' keys: S(S+1)/2 per row block, 4·D flops each (QK^T
    # and PV); each input read once, the output and the log-sum-exp
    # written once
    flops = 2 * bh * d * s * (s + 1)
    bytes_ = 4 * bh * s * d * q.element_size() + bh * s * 4
    t_ops = flops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_kernel = time_cold(lambda: flash_attention_cuda(q, k, v, causal=True),
                         dev, n=25)
    t_plain = time_cold(lambda: flash_attention_plain(q, k, v, causal=True),
                        dev, n=25)
    t_lib = time_cold(lambda: sdpa(q[None], k[None], v[None],
                                   is_causal=True), dev, n=25)
    bound = max(t_ops, t_bytes)
    timing = {"phase": "flash_timing", "shape": [bh, s, d],
              "dtype": "bfloat16", "causal": True, "ms": t_kernel,
              "plain_ms": t_plain, "library_ms": t_lib,
              "library": "scaled_dot_product_attention(is_causal=True)",
              "max_abs_err": err, "library_max_abs_err": lib_err,
              "bound_ms": bound,
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "flops": flops, "bytes": bytes_,
              "achieved_tflops": flops / t_kernel / 1e9,
              "bound_share": bound / t_kernel, "design": design,
              "registers": ptxas["registers"],
              "spill_stores": ptxas["spill_stores"],
              "spill_loads": ptxas["spill_loads"],
              "mma_registers_by_head_dim": {
                  int(re.search(r"ILi(\d+)E", e).group(1)): r["registers"]
                  for e, r in mma.items()},
              "gpu": nvidia_smi()}
    emit(timing)
    return err, timing

# ------------------------------------------------------------- SSD kernel

SSM_ARCH, HYBRID_ARCH = "mamba2-2.7b", "zamba2-2.7b"
# (b, s, h, p, g, n, chunk): the tests/test_kernels.py:85-100 sweep, the
# full-width calls of mamba2 (N 128) and zamba2 (N 64) at S 2048, a G = 2
# case at full width, S = chunk, and P, N that are not powers of two
SSD_SWEEP = [(2, s, 4, 32, g, 16, c) for s, c in ((64, 16), (128, 32),
                                                   (256, 64)) for g in (1, 2)]
SSD_FULL = [(1, 2048, 80, 64, 1, 128, 256), (1, 2048, 80, 64, 1, 64, 256),
            (1, 1024, 80, 64, 2, 128, 256), (2, 256, 80, 64, 1, 128, 256),
            (1, 384, 6, 40, 1, 24, 128)]
SSD_GRAD_CASES = [(2, 128, 4, 32, 2, 16, 32), (1, 256, 8, 64, 1, 128, 128)]
SSD_TOL = 2e-3          # the reference's SSD tolerance, f32
SSM_SLOTS, SSM_REQUESTS, SSM_MAX_NEW, SSM_MAX_LEN = 4, 4, 16, 256
PREFILL_LEN = 512       # two 256-token chunks
PREFILL_TOL = 1e-3      # prefill vs one-token recurrence, f32, relative
# the prefill check's depth (full width): stepping 512 tokens one at a time
# through all 64 (54) layers took 36 s an arch on an H100
PREFILL_LAYERS = {"mamba2-2.7b": 16, "zamba2-2.7b": 12}
SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, SSM_TRAIN_STEPS = 2048, 4, 4


def ssd_case(b, s, h, p, g, n, dtype, seed, dev, grad=False):
    """A scan problem with the reference sweep's distributions: x, B, C
    normal; dt in [0.001, 0.1]; a in [-1, -0.1]."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.099 + 0.001
    a = -(torch.rand((h,), generator=gen, device=dev) * 0.9 + 0.1)
    args = (randn(b, s, h, p), dt, a, randn(b, s, g, n), randn(b, s, g, n))
    return tuple(t.requires_grad_(grad) for t in args)


def ssd_close(y, y_p, fin, fin_p, dtype) -> tuple[bool, float]:
    """Kernel against plain: the final state (fp32) at 2e-3; y at 2e-3 in
    f32, and in bf16 at one bf16 step of each value (2^-7 relative) plus
    1e-3 for the fp32 sums' order, both sides rounding one fp32 result."""
    err = float((y.float() - y_p.float()).abs().max())
    ok = torch.allclose(fin, fin_p, rtol=SSD_TOL, atol=SSD_TOL) and (
        torch.allclose(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
        if dtype == torch.float32 else
        torch.allclose(y.float(), y_p.float(), rtol=2 ** -7, atol=1e-3))
    return ok and bool(torch.isfinite(y.float()).all()), err


def phase_ssd_kernel(dev) -> dict:
    n_cases, worst, grad_worst, designs = 0, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        err = 0.0
        name = str(dtype).replace("torch.", "")
        for b, s, h, p, g, n, chunk in SSD_SWEEP + SSD_FULL:
            designs[f"{b}x{s}x{h}x{p}x{g}x{n}x{chunk} {name}"] = ssd_design(
                dtype, p, n, chunk)
            args = ssd_case(b, s, h, p, g, n, dtype, n_cases, dev)
            y, fin = ssd_scan_cuda(*args, chunk)
            y_p, fin_p = ssd_scan_plain(*args, chunk)
            torch.cuda.synchronize()
            ok, e = ssd_close(y, y_p, fin, fin_p, dtype)
            err = max(err, e)
            check(ok, f"ssd kernel != plain: {(b, s, h, p, g, n, chunk)} "
                      f"{dtype}: max |dy| {e}")
            n_cases += 1
        g_err = 0.0
        for b, s, h, p, g, n, chunk in SSD_GRAD_CASES:
            designs[f"{b}x{s}x{h}x{p}x{g}x{n}x{chunk} {name} grad"] = (
                ssd_design(dtype, p, n, chunk))
            gen = torch.Generator(device=dev).manual_seed(1000 + n_cases)
            d_y = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
            d_fin = torch.randn((b, h, p, n), generator=gen, device=dev)
            grads = []
            for fn in (lambda *t: SsdScan.apply(*t, chunk),
                       lambda *t: ssd_scan_plain(*t, chunk)):
                args = ssd_case(b, s, h, p, g, n, dtype, n_cases, dev, True)
                torch.autograd.backward(fn(*args), (d_y, d_fin))
                grads.append([t.grad for t in args])
            tol = 1e-4 if dtype == torch.float32 else GRAD_TOL
            for got, want in zip(*grads):
                e = max_rel_to_max(got, want)
                g_err = max(g_err, e)
                check(e <= tol, f"SsdScan gradients != plain autograd: "
                                f"{(b, s, h, p, g, n, chunk)} {dtype}: {e}")
            n_cases += 1
        worst[name], grad_worst[name] = err, g_err
    check(set(designs.values()) == {"mma", "scalar"},
          f"the sweep does not cover both designs: {designs}")
    check(all(designs[f"{c} bfloat16"] == "mma" for c in (
        "x".join(map(str, case)) for case in SSD_FULL[:4])),
          f"a full-width bf16 call took the scalar design: {designs}")
    emit({"phase": "ssd_kernel", "cases": n_cases, "max_abs_err": worst,
          "grad_max_err_rel_to_max": grad_worst,
          "tolerance": {"float32": SSD_TOL, "bfloat16": "2^-7 rel + 1e-3",
                        "final_state": SSD_TOL,
                        "grad": {"float32": 1e-4, "bfloat16": GRAD_TOL}},
          "full_width": SSD_FULL,
          "cases_by_design": {d: sum(v == d for v in designs.values())
                              for d in ("mma", "scalar")},
          "designs": designs})
    return worst


class _PlainSsd(torch.autograd.Function):
    """The plain version's forward with the port's torch-op gradient.
    Autograd through the plain version itself gives NaN at full width: its
    dense exp(seg_q - seg_k) overflows above the diagonal once a chunk's
    summed dt * a passes about 88 (256 tokens at dt near softplus(0)), and
    the masked overflow carries 0 * inf back."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, chunk):
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_scan_plain(x, dt, a, b_in, c_in, chunk)

    @staticmethod
    def backward(ctx, d_y, d_fin):
        grads = ssd_scan_backward(*ctx.saved_tensors, ctx.chunk, d_y, d_fin)
        return (*grads, None)


@contextlib.contextmanager
def plain_kernels():
    """The model's flash, SSD and cable epoch calls go to their plain
    versions, on the card: the reference side of the parity phases (the
    port has no switch)."""
    saved = ops.ssd_scan, ops.cable_epoch

    def plain_ssd(x, dt, a, b_in, c_in, chunk):
        return _PlainSsd.apply(x, dt, a, b_in, c_in, min(chunk, x.shape[1]))

    ops.ssd_scan, ops.cable_epoch = plain_ssd, cable_epoch_plain
    try:
        with plain_flash():
            yield
    finally:
        ops.ssd_scan, ops.cable_epoch = saved


def phase_ssm_train_parity(dev) -> None:
    """Full width, seq 2048, batch 1: mamba2 cut to 2 layers and zamba2 to
    one group (5 Mamba2 layers and the shared block): the loss and every
    gradient through the kernels against the plain versions on the card."""
    for arch, layers in ((SSM_ARCH, 2), (HYBRID_ARCH, 6)):
        cfg = dataclasses.replace(ALL_ARCHS[arch], n_layers=layers)
        model = build(cfg)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED), dev)
        batch = model.sample_batch(
            ShapeConfig("parity", "train", SSM_TRAIN_SEQ, 1), SEED, dev)
        ops.reset_launches()
        loss_k, grads_k = loss_and_grads(model, params, batch)
        launches = dict(ops.LAUNCHES)
        with plain_kernels():
            loss_p, grads_p = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        n_ssd = layers if cfg.family == "ssm" else layers - 1
        n_flash = 0 if cfg.family == "ssm" else 1
        check(launches["ssd_scan"] == n_ssd
              and launches["flash_attention"] == n_flash,
              f"{arch}: launches {launches}, expected ssd_scan {n_ssd}, "
              f"flash_attention {n_flash}")
        loss_err = rel_norm(loss_k, loss_p)
        errs = [rel_norm(a, b) for a, b in zip(grads_k, grads_p)]
        check(bool(torch.isfinite(loss_k)) and loss_err <= TRAJ_TOL,
              f"{arch}: loss through the kernels {float(loss_k)} vs plain "
              f"{float(loss_p)}")
        check(all(np.isfinite(errs)) and max(errs) <= GRAD_TOL,
              f"{arch}: gradients through the kernels vs plain: max rel "
              f"{max(errs)}")
        emit({"phase": "ssm_train_parity", "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "seq": SSM_TRAIN_SEQ, "batch": 1,
              "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
              "loss_rel_err": loss_err, "loss_tolerance": TRAJ_TOL,
              "grad_leaves": len(errs), "grad_max_rel_norm_err": max(errs),
              "grad_tolerance": GRAD_TOL, "launches": launches})
        del params, grads_k, grads_p
        torch.cuda.empty_cache()


def near_tie_ok(got, want) -> tuple[bool, float]:
    """Logits [1, V] of two paths: within PREFILL_TOL of the largest
    |logit|, and the same argmax unless ``want``'s top two are within twice
    that (the near-tie rule of tests/test_torch_decode.py).  Returns
    (ok, max |dlogit|)."""
    err = float((got - want).abs().max())
    tol = PREFILL_TOL * float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values[0]
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    return err <= tol and (same or float(top2[0] - top2[1]) <= 2 * tol), err


def prefill_check(model, params, dev) -> dict:
    """``Model.prefill`` of a 512-token prompt (two 256-token chunks: one
    SSD launch a Mamba2 layer, one flash launch a shared block) continued by
    ``decode_step``, against the same prompt stepped one token at a time
    through ``decode_step``: first-token logits, the next step's logits,
    and every layer's final SSM state.  In f32 (the seeded bf16 weights
    upcast), so the two paths differ only by the order of fp32 sums; in
    bf16 they also round at different points, and the states part by a
    few percent a few layers down (0.8% after one layer, 3.8% after four,
    at reduced size on the CPU)."""
    cfg = model.cfg
    params = P.tree_map(lambda t: t.float(), params)
    prompt = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=PREFILL_LEN)
    cache_len = PREFILL_LEN + 8
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits_p, cache_p = model.prefill(
        params, {"tokens": torch.tensor(prompt[None], device=dev)}, cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cache_s = P.tree_map(lambda t: t.float(),
                         model.zero_cache(1, cache_len, dev))
    t0 = time.perf_counter()
    for i, tok in enumerate(prompt.tolist()):
        logits_s = model.decode_step(
            params, cache_s, torch.tensor([[tok]], device=dev),
            torch.tensor([i], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    stepped_s = time.perf_counter() - t0
    ok_first, first_err = near_tie_ok(logits_p, logits_s)
    state_err = max(rel_norm(a, b) for a, b in zip(cache_p["ssm"]["ssm"],
                                                   cache_s["ssm"]["ssm"]))
    first = [int(logits_p.argmax()), int(logits_s.argmax())]
    nxt = torch.tensor([[first[1]]], device=dev)
    pos = torch.tensor([PREFILL_LEN], dtype=torch.int32, device=dev)
    ok_next, next_err = near_tie_ok(model.decode_step(params, cache_p, nxt, pos),
                                    model.decode_step(params, cache_s, nxt, pos))
    n_ssm = cache_p["ssm"]["ssm"].shape[0]
    n_attn = cache_p["self"]["k"].shape[0] if "self" in cache_p else 0
    check(launches["ssd_scan"] == n_ssm
          and launches["flash_attention"] == n_attn,
          f"prefill launches {launches}: expected ssd_scan {n_ssm}, "
          f"flash_attention {n_attn}")
    check(ok_first and ok_next and state_err <= PREFILL_TOL,
          f"prefill vs one-token recurrence: first tokens {first}, max "
          f"|dlogit| {first_err} then {next_err}, state rel err {state_err}")
    return {"prompt": PREFILL_LEN, "dtype": "float32", "launches": launches,
            "first_tokens_prefill_stepped": first,
            "first_logits_max_abs_err": first_err,
            "next_logits_max_abs_err": next_err,
            "logit_scale": float(logits_s.abs().max()),
            "max_layer_ssm_state_rel_err": state_err,
            "tolerance": PREFILL_TOL,
            "prefill_s": prefill_s, "stepped_s": stepped_s}


def ssm_requests(cfg) -> list:
    """Four prompts of 32-64 tokens, 16 new tokens each, one sampled.  The
    contiguous engine feeds every prompt token through a step of its own
    (about 90 ms at full depth, host-bound), so the prompts are short."""
    rng = np.random.default_rng(SEED)
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=1)
    return [Request(rid=i, max_new=SSM_MAX_NEW,
                    prompt=rng.integers(0, cfg.vocab_size, size=int(
                        rng.integers(32, 65))).tolist(),
                    sampling=sampled if i == 1 else None)
            for i in range(SSM_REQUESTS)]


def phase_stateful_serve(arch, dev) -> dict:
    """Full width and depth, seeded bf16 weights, through the contiguous
    ``ServeEngine`` (the ssm and hybrid caches have no paged form), then
    the prefill check on the same width cut in depth (``PREFILL_LAYERS``),
    its weights seeded alike."""
    cfg = ALL_ARCHS[arch]
    model = build(cfg)
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - phase_t0
    warm = ServeEngine(model, params, slots=1, max_len=32, device=dev)
    warm.run([Request(rid=0, prompt=list(range(8)), max_new=2)])
    del warm
    eng = ServeEngine(model, params, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device=dev)
    reqs = ssm_requests(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rep = eng.report()
    check(rep["served"] == SSM_REQUESTS, f"{arch}: served {rep['served']}")
    for r in done:
        check(len(r.out) == SSM_MAX_NEW and all(
            0 <= t < cfg.padded_vocab for t in r.out),
            f"{arch}: request {r.rid} gave {r.out}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    # the contiguous engine feeds each prompt token through its own step
    steps = prompt_tokens + rep["decode_steps"]
    check(not any(launches.values()),
          f"{arch}: the contiguous engine launched {launches}")
    out = {"phase": ("ssm_serve" if cfg.family == "ssm"
                     else "hybrid_serve"), "arch": cfg.name,
           "params": sum(t.numel() for t in P.leaves(params)),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "init_s": round(init_s, 2), "engine": rep["engine"],
           "slots": SSM_SLOTS, "requests": SSM_REQUESTS,
           "prompt_tokens": prompt_tokens, "wall_s": wall,
           "decode_steps": rep["decode_steps"], "engine_steps": steps,
           "ms_per_step": 1e3 * wall / steps,
           "tokens_out_per_s": rep["tokens_out"] / wall,
           "tokens_processed_per_s": (rep["tokens_out"] + prompt_tokens) / wall,
           "launches": launches,
           "first_tokens": {r.rid: r.out[:4] for r in done}}
    del eng, params
    cut = build(dataclasses.replace(cfg, n_layers=PREFILL_LAYERS[arch]))
    out["prefill"] = prefill_check(cut, cut.init_params(
        torch.Generator(device=dev).manual_seed(SEED), dev), dev)
    out["prefill"]["layers"] = PREFILL_LAYERS[arch]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["phase_s"] = time.perf_counter() - phase_t0
    emit(out)
    return out


PRESSURE_BALLAST_GB = (0, 18)   # 18: the phase's 70.4 GB peak in the script


def profile_pressure() -> int:
    """``python3 chip_smoke.py profile_pressure``, not part of the run: the
    ssm_train step profiled alone, as the phase profiles it and after a
    warm-up step, three times and twice, beside 0 and 18 GB of ballast
    (the step's 52 GB peak raised to the phase's 70 GB, the card's free
    memory to a few hundred MiB); a JSON line a profile with the card's
    free memory before it and the device ms and kernels it saw."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    kbuild.build_all(("ssd_scan",))
    _, step_fn, batches, fresh = train_setup(
        ALL_ARCHS[SSM_ARCH], SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, 2, dev)
    state, _, _ = run_steps(step_fn, fresh(), batches[:2], dev)
    ballast = []
    for gb in PRESSURE_BALLAST_GB:
        while len(ballast) < gb // 2:
            ballast.append(torch.empty(500_000_000, device=dev))  # 2 GB
        for warmup in (False, False, False, True, True):
            state, _, _ = run_steps(step_fn, state, batches[2:], dev)
            free = torch.cuda.mem_get_info(dev)[0]
            try:
                state, device_ms, by_kind, _, _ = profiled_step(
                    step_fn, state, batches[2], dev, warmup=warmup)
                seen = {"device_ms": device_ms, "kinds": len(by_kind)}
            except RuntimeError as e:     # the failure is the finding
                seen = {"failed": str(e)}
            emit({"phase": "profile_pressure", "ballast_gb": gb,
                  "warmup": warmup, "free_mib": free / 2**20, **seen})
    print(nvidia_smi(), flush=True)
    return 0


def phase_ssm_train(dev) -> dict:
    """Full-width mamba2-2.7b at full depth (64 layers, 2.83 B parameters;
    AdamW state 45 GB): seq 2048, batch 4, remat full, the first 4 steps
    of the default schedule on the port's ``DataPipeline``; launch counts
    zeroed just before and read just after; one more step under
    ``torch.profiler``, after a warm-up step; then the same steps through
    the plain versions, each loss within ``TRAJ_TOL`` of the kernel
    run's."""
    cfg = ALL_ARCHS[SSM_ARCH]
    _, step_fn, batches, fresh = train_setup(
        cfg, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, SSM_TRAIN_STEPS, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = fresh()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launches()
    state, losses, step_s = run_steps(step_fn, state,
                                      batches[:SSM_TRAIN_STEPS], dev)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(np.isfinite(losses)), f"non-finite ssm training loss {losses}")
    expected = 2 * cfg.n_layers * SSM_TRAIN_STEPS
    check(launches["ssd_scan"] == expected,
          f"ssd_scan launched {launches['ssd_scan']} times, expected 2 x "
          f"layers x steps = {expected} (forward and remat recompute)")
    check(launches["flash_attention"] == 0 and launches["paged_attention"] == 0,
          f"attention kernels ran in mamba2 training: {launches}")
    design = ssd_design(getattr(torch, cfg.dtype), cfg.ssm_head_dim,
                        cfg.ssm_state, cfg.ssd_chunk)
    check(design == "mma", f"the training call took the {design} design")
    steady_ms = statistics.median(step_s[1:]) * 1e3
    state, device_ms, by_kind, top, spans = profiled_step(
        step_fn, state, batches[SSM_TRAIN_STEPS], dev,
        ("ssd_scan_backward", "adamw_update"), warmup=True)
    ssd_ms = by_kind.get("ssd_scan", 0.0)
    n_params = sum(t.numel() for t in P.leaves(state.params))
    # the same steps from the same seed with the plain versions on the
    # card: the kernel's training trajectory must track them
    del state
    torch.cuda.empty_cache()
    with plain_kernels():
        _, plain_losses, _ = run_steps(step_fn, fresh(),
                                       batches[:SSM_TRAIN_STEPS], dev)
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    tokens = SSM_TRAIN_SEQ * SSM_TRAIN_BATCH
    emit({"phase": "ssm_train", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params,
          "seq": SSM_TRAIN_SEQ, "batch": SSM_TRAIN_BATCH, "remat": "full",
          "init_s": round(init_s, 2), "losses": losses,
          "plain_losses": plain_losses, "loss_rel_err_vs_plain": traj_err,
          "tolerance": TRAJ_TOL,
          "loss_fell": losses[-1] < losses[0],
          "step_ms": [1e3 * t for t in step_s],
          "steady_ms_per_step": steady_ms,
          "tokens_per_s": tokens / steady_ms * 1e3,
          "peak_mem_gb": peak_gb, "launches": launches,
          "ssd_design": design,
          "profile": {"device_ms_per_step": device_ms,
                      "device_busy_share": device_ms / steady_ms,
                      "ssd_kernel_ms_per_step": ssd_ms,
                      "ssd_share_of_device": ssd_ms / device_ms,
                      "ssd_backward_ms_per_step": spans["ssd_scan_backward"],
                      "adamw_ms_per_step": spans["adamw_update"],
                      "ms_by_kind": by_kind, "top_kernels_ms": top}})
    check(traj_err <= TRAJ_TOL, f"ssm losses through the kernel {losses} vs "
                                f"the plain version {plain_losses}")
    return launches


def ssd_bound(b, s, h, p, g, n, chunk, dtype) -> tuple[float, str, int, int]:
    """The least time for one scan, from its shapes: each input read once
    and each output written once over HBM rate, or its useful flops (C·Bᵀ
    once per group on the causal half, the masked product with x, the
    inter-chunk term and the state update) over the peak of the inputs'
    type, whichever is larger."""
    item = torch.tensor([], dtype=dtype).element_size()
    bytes_ = (2 * b * s * h * p * item + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * item + b * h * p * n * 4)
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = (2 * b * nc * g * tri * n + 2 * b * nc * h * tri * p
             + 4 * b * s * h * p * n)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_, flops)


SSD_PASSES = ("chunk_state", "state_pass", "chunk_scan", "fixup")


def ssd_pass_ms(fn, dev, n=10) -> dict[str, float]:
    """Device ms a call of each pass of the kernel (the scalar design's
    one kernel as ``scalar``), by ``torch.profiler`` kernel names over
    ``n`` calls, each after the L2 cache was flushed."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    parts = {**{p: p for p in SSD_PASSES}, "ssd_scan_kernel": "scalar"}
    out = {}
    for name, ms in device_ms_by_kernel(prof).items():
        for key, part in parts.items():
            if key in name:
                out[part] = out.get(part, 0.0) + ms / n
    return out


def phase_ssd_timing(dev) -> tuple[float, dict]:
    """The kernel and its plain version at mamba2's training call
    (x [4, 2048, 80, 64] bf16, chunk 256, N 128) and its prefill call
    (x [1, 512, 80, 64]), L2 flushed before each launch, median of 25;
    each pass's device ms from the profiler.  No single PyTorch call
    computes the scan, so no library time."""
    cfg = ALL_ARCHS[SSM_ARCH]
    heads = kbuild.load("ssd_scan").ssd_scan_heads_per_block
    heads.argtypes = [ctypes.c_int] * 5
    heads.restype = ctypes.c_int
    # registers and spills of each tensor-core pass: none that an arch's
    # call takes may spill (the launcher's template: P and N up to 64 or
    # 128); mamba2's are reported, and every instantiation's spills
    mma = {e: r for e, r in ptxas_report("ssd_scan").items()
           if any(f"ssd_scan_{p}_kernel" in e for p in SSD_PASSES)}

    def tmpl(c):
        return (f"ILi{4 if c.ssm_head_dim <= 64 else 8}"
                f"ELi{4 if c.ssm_state <= 64 else 8}E")

    taken = {tmpl(c) for c in ALL_ARCHS.values()
             if c.family in ("ssm", "hybrid")}
    used = {e: r for e, r in mma.items()
            if "ILi" not in e or any(t in e for t in taken)}
    check(len(used) >= len(SSD_PASSES)
          and all(r.get("spill_stores", 1) == 0
                  and r.get("spill_loads", 1) == 0 for r in used.values()),
          f"an SSD pass that an arch's call takes spills: {used}")
    ptxas = {p: next(r for e, r in used.items() if f"ssd_scan_{p}_kernel" in e
                     and (tmpl(cfg) in e or "ILi" not in e))
             for p in SSD_PASSES}
    spills = {re.search(rf"ssd_scan_({'|'.join(SSD_PASSES)})_kernel"
                        r"(ILi\d+ELi\d+E)?", e).group(0):
              r.get("spill_stores", 0) + r.get("spill_loads", 0)
              for e, r in mma.items()}
    rows = {}
    for name, b, s in (("train", SSM_TRAIN_BATCH, SSM_TRAIN_SEQ),
                       ("prefill", 1, PREFILL_LEN)):
        h, p, g, n = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                      cfg.ssm_state)
        shape = (b, s, h, p, g, n, cfg.ssd_chunk)
        args = ssd_case(*shape[:6], torch.bfloat16, SEED, dev)
        y, fin = ssd_scan_cuda(*args, cfg.ssd_chunk)
        y_p, fin_p = ssd_scan_plain(*args, cfg.ssd_chunk)
        torch.cuda.synchronize()
        ok, err = ssd_close(y, y_p, fin, fin_p, torch.bfloat16)
        check(ok, f"ssd kernel != plain at the {name} call: {err}")
        y_share = float((y != y_p).float().mean())
        del y, fin, y_p, fin_p
        bound, bound_by, bytes_, flops = ssd_bound(*shape, torch.bfloat16)
        t_kernel = time_cold(lambda: ssd_scan_cuda(*args, cfg.ssd_chunk),
                             dev, n=25)
        t_plain = time_cold(lambda: ssd_scan_plain(*args, cfg.ssd_chunk),
                            dev, n=25)
        design = ssd_design(torch.bfloat16, p, n, cfg.ssd_chunk)
        check(design == "mma", f"the {name} call took the {design} design")
        passes = ssd_pass_ms(lambda: ssd_scan_cuda(*args, cfg.ssd_chunk), dev)
        check(set(passes) == set(SSD_PASSES),
              f"the profiler saw passes {passes} at the {name} call")
        rows[name] = {"x_shape": list(shape[:4]), "chunk": cfg.ssd_chunk,
                      "state": cfg.ssm_state, "dtype": "bfloat16",
                      "design": design,
                      "heads_per_block": heads(b, s, h, g, cfg.ssd_chunk),
                      "workspace_bytes": 4 * ssd_workspace_elements(
                          b, s, h, p, n, cfg.ssd_chunk, g),
                      "pass_ms": passes,
                      "pass_ms_sum": sum(passes.values()),
                      "ptxas": ptxas, "spill_bytes_by_instance": spills,
                      "y_share_differing_from_plain": y_share,
                      "ms": t_kernel, "plain_ms": t_plain,
                      "library_ms": None, "max_abs_err": err,
                      "bound_ms": bound, "bound_by": bound_by,
                      "bytes": bytes_, "useful_flops": flops,
                      "achieved_tflops": flops / t_kernel / 1e9,
                      "bound_share": bound / t_kernel}
    timing = {"phase": "ssd_timing", **rows, "gpu": nvidia_smi()}
    emit(timing)
    return rows["train"]["max_abs_err"], rows["train"]


# ------------------------------------------------------------- HH kernel

HH_SWEEP_N = (7, 128, 1000, 4096, 131072)   # tests/test_kernels.py + ring
HH_SWEEP_DT = (0.0125, 0.025)
HH_TOL = 3e-5           # the reference's HH tolerance (rtol and atol)
# fp32 operations of one cell's update, each exp and division counted once
HH_OPS_PER_CELL = 90
FP32_OPS_PER_S = PEAK_OPS_PER_S[torch.float32]


def hh_inputs(n, seed, dev, v=None) -> list:
    """The seven [n] fp32 inputs with tests/test_kernels.py's distributions
    (v in [-90, 30], gates in [0, 1], g_syn in [0, 8], i_axial in [-20,
    20], i_ext in [0, 10]); ``v`` overrides the voltages, repeated."""
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(-90, 30, n), rng.uniform(0, 1, n),
              rng.uniform(0, 1, n), rng.uniform(0, 1, n),
              rng.uniform(0, 8, n), rng.uniform(-20, 20, n),
              rng.uniform(0, 10, n)]
    if v is not None:
        arrays[0] = np.resize(np.asarray(v, np.float64), n)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def hh_compare(args, dt) -> tuple[float, bool]:
    """Kernel against plain on the card: every output finite and within
    HH_TOL.  Returns the max abs error and whether the bits are equal."""
    got = hh_step_cuda(*args, dt=dt)
    want = hh_step_plain(*args, dt=dt)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip("vmhn", got, want):
        check(bool(torch.isfinite(a).all()), f"non-finite hh kernel {name}")
        err = max(err, float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=HH_TOL, atol=HH_TOL),
              f"hh kernel != plain: {name}, n {a.numel()}, dt {dt}")
    return err, all(torch.equal(a, b) for a, b in zip(got, want))


def phase_hh_kernel(dev) -> float:
    cases = [(n, dt, None) for n in HH_SWEEP_N for dt in HH_SWEEP_DT]
    cases += [(4096, dt, [-40.0, -55.0]) for dt in HH_SWEEP_DT]
    results = [hh_compare(hh_inputs(n, SEED + i, dev, v), dt)
               for i, (n, dt, v) in enumerate(cases)]
    err = max(e for e, _ in results)
    emit({"phase": "hh_kernel", "cases": len(cases), "n": list(HH_SWEEP_N),
          "dt": list(HH_SWEEP_DT), "vtrap_limits_mV": [-40.0, -55.0],
          "max_abs_err": err, "tolerance": HH_TOL,
          "bits_equal_cases": sum(eq for _, eq in results)})
    return err


# --------------------------------------------------------- cable epoch

EPOCH_SWEEP_C = (2, 4, 8, 32)          # the repo's configs and tests
EPOCH_SWEEP_CELLS = (7, 1000, 131072)
EPOCH_SWEEP_STEPS = (1, 37, 200)


def epoch_inputs(n, c, steps, seed, dev):
    """tests/test_torch_neuro.py's epoch inputs: a state away from rest,
    spikes arriving at 2% of (step, cell) from a third of the way into
    the epoch, the stimulus into every fourth cell."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    state = CellState(f32(rng.uniform(-75, -50, (n, c))),
                      f32(rng.uniform(0.02, 0.1, n)),
                      f32(rng.uniform(0.5, 0.7, n)),
                      f32(rng.uniform(0.3, 0.4, n)),
                      f32(rng.uniform(0, 2, n)))
    incoming = rng.uniform(size=(steps, n)) < 0.02
    incoming[:steps // 3] = False
    i_stim = rng.uniform(10, 25, n) * (np.arange(n) % 4 == 0)
    return state, f32(incoming), f32(i_stim)


def epoch_compare(got, want, what) -> tuple[float, bool]:
    """Two epochs' ``(state, spiked)``: spikes equal at every step, the
    state finite and within RING_STATE_TOL.  Returns the largest state
    difference and whether the bits are equal."""
    (st, sp), (st_w, sp_w) = got, want
    check(torch.equal(sp, sp_w),
          f"{what}: spikes differ at {int((sp != sp_w).sum())} "
          f"(step, cell) of {int(sp_w.sum())} spikes")
    err = 0.0
    for name, a, b in zip(CellState._fields, st, st_w):
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        err = max(err, float((a - b).abs().max()))
    check(err <= RING_STATE_TOL, f"{what}: state differs by {err}")
    return err, all(torch.equal(a, b) for a, b in zip(st, st_w))


def phase_cable_epoch_kernel(dev) -> float:
    cases = [(n, c, steps) for c in EPOCH_SWEEP_C for n in EPOCH_SWEEP_CELLS
             for steps in EPOCH_SWEEP_STEPS]
    errs, equal, spikes = [], 0, 0
    for i, (n, c, steps) in enumerate(cases):
        state, incoming, i_stim = epoch_inputs(n, c, steps, SEED + i, dev)
        cfg = CellConfig(n_compartments=c)
        stim_left = (steps + 1) // 2        # cut mid-epoch
        want = cable_epoch_plain(state, cfg, incoming, i_stim, stim_left)
        got = cable_epoch_cuda(state, cfg, incoming, i_stim, stim_left)
        torch.cuda.synchronize()
        err, eq = epoch_compare(got, want, f"cable epoch {n}x{c}, {steps} "
                                           f"steps")
        errs.append(err)
        equal += eq
        spikes += int(want[1].sum())
    emit({"phase": "cable_epoch_kernel", "cases": len(cases),
          "compartments": list(EPOCH_SWEEP_C),
          "cells": list(EPOCH_SWEEP_CELLS), "steps": list(EPOCH_SWEEP_STEPS),
          "spikes": spikes, "spikes_equal": True,
          "max_state_abs_err": max(errs), "state_tolerance": RING_STATE_TOL,
          "bits_equal_cases": equal})
    return max(errs)


def phase_hh_timing(dev) -> tuple[float, dict]:
    """The kernel and its plain version at the ring's 131,072 cells, L2
    flushed before each launch, median of 50; no single PyTorch call
    computes the update, so no library time."""
    n, dt = RING_CELLS, 0.025
    args = hh_inputs(n, SEED, dev)
    err, _ = hh_compare(args, dt)
    bytes_ = 11 * n * 4                 # 7 inputs read, 4 outputs written
    flops = HH_OPS_PER_CELL * n
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    t_kernel = time_cold(lambda: hh_step_cuda(*args, dt=dt), dev, n=50)
    t_plain = time_cold(lambda: hh_step_plain(*args, dt=dt), dev, n=50)
    bound = max(t_bytes, t_ops)
    timing = {"phase": "hh_timing", "cells": n, "dt": dt, "ms": t_kernel,
              "plain_ms": t_plain, "library_ms": None, "max_abs_err": err,
              "bound_ms": bound,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bytes": bytes_, "flops": flops,
              "achieved_gb_per_s": bytes_ / t_kernel / 1e6,
              "bound_share": bound / t_kernel, "gpu": nvidia_smi()}
    emit(timing)
    return err, timing


def epoch_ops_per_cell_step(c) -> int:
    """fp32 operations of one cable step of one cell, by the code: the
    synapse 3, the stencil 4 a compartment, the dendrite 5 a compartment
    past the soma, the soma HH_OPS_PER_CELL, the spike test 2."""
    return 3 + 4 * c + 5 * (c - 1) + HH_OPS_PER_CELL + 2


def phase_cable_epoch_timing(dev) -> tuple[float, dict]:
    """One epoch of the ring through the epoch kernel and through its plain
    version, L2 flushed before each call, median of 25; no single PyTorch
    call computes an epoch, so no library time."""
    n, c, steps = RING_CELLS, RING_COMPARTMENTS, 200
    state, incoming, i_stim = epoch_inputs(n, c, steps, SEED, dev)
    cfg = CellConfig(n_compartments=c)
    err, equal = epoch_compare(
        cable_epoch_cuda(state, cfg, incoming, i_stim, 100),
        cable_epoch_plain(state, cfg, incoming, i_stim, 100), "epoch timing")
    # the state read and written once, incoming and i_stim read, spiked
    # written (one byte a step and cell)
    bytes_ = 2 * n * (c + 4) * 4 + steps * n * 4 + n * 4 + steps * n
    flops = n * steps * epoch_ops_per_cell_step(c)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    t_kernel = time_cold(
        lambda: cable_epoch_cuda(state, cfg, incoming, i_stim, 100), dev,
        n=25)
    t_plain = time_cold(
        lambda: cable_epoch_plain(state, cfg, incoming, i_stim, 100), dev,
        n=25)
    bound = max(t_bytes, t_ops)
    regs = {}
    for entry, r in ptxas_report("hh_neuron").items():
        if m := re.search(r"cable_epoch_kernelILi(\d+)E", entry):
            regs[int(m.group(1))] = r
    check(sorted(regs) == list(EPOCH_COMPARTMENTS),
          f"ptxas reports epoch instantiations {sorted(regs)}")
    spills = {k: r.get("spill_stores", 0) + r.get("spill_loads", 0)
              for k, r in regs.items()}
    check(not any(spills[k] for k in regs if k <= 32),
          f"an epoch instantiation up to C = 32 spills: {regs}")
    timing = {"phase": "cable_epoch_timing", "cells": n, "compartments": c,
              "steps": steps, "ms": t_kernel, "plain_ms": t_plain,
              "library_ms": None, "max_abs_err": err, "bits_equal": equal,
              "bound_ms": bound,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bytes": bytes_, "flops": flops,
              "ops_per_cell_step": epoch_ops_per_cell_step(c),
              "bound_share": bound / t_kernel,
              "cell_steps_per_s": n * steps / t_kernel * 1e3,
              "registers": {k: regs[k].get("registers") for k in sorted(regs)},
              "spill_bytes": {k: spills[k] for k in sorted(regs)},
              "gpu": nvidia_smi()}
    emit(timing)
    return err, timing


# ------------------------------------------------------------------ neuro

# benchmarks/ring_podscale.py's production ring, whole on one card
RING_CELLS, RING_COMPARTMENTS, RING_T_END, RING_DELAY = 131072, 32, 200.0, 5.0
RING_FORMS = (("arbor_ring", 1), ("ringtest", 256))   # ring_scaling.py's
RING_STATE_TOL = 1e-3   # mV (gates and conductance: the same, absolute)


def ring_config(n_cells, n_rings, t_end, compartments) -> RingConfig:
    return RingConfig(n_cells=n_cells, n_rings=n_rings, t_end_ms=t_end,
                      delay_ms=RING_DELAY,
                      cell=CellConfig(n_compartments=compartments))


EPOCH_PROFILE_RUNS = 10   # one epoch is ~1.5 ms: a window the profiler keeps


def epoch_profile(cfg, dev) -> dict:
    """One epoch of ``cfg`` (its first: the stimulus is on), run
    EPOCH_PROFILE_RUNS times on the host clock, then as many times again
    under ``torch.profiler``; every figure is per run.  The device's busy
    share is the profiled device time over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    one = dataclasses.replace(cfg, t_end_ms=cfg.delay_ms)
    state = init_state(cfg.n_cells, cfg.cell, dev)
    neuro_sim.run(one, state, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EPOCH_PROFILE_RUNS):
        neuro_sim.run(one, state, dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / EPOCH_PROFILE_RUNS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(EPOCH_PROFILE_RUNS):
            neuro_sim.run(one, state, dev)
        torch.cuda.synchronize()
    by_kernel = {k: v / EPOCH_PROFILE_RUNS
                 for k, v in device_ms_by_kernel(prof).items()}
    device_ms = sum(by_kernel.values())
    epoch_ms = sum(v for k, v in by_kernel.items() if "cable_epoch" in k)
    short = {}          # summed by the name's first 60 characters
    for k, v in by_kernel.items():
        short[k[:60]] = short.get(k[:60], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:8]
    return {"dt_steps": one.delay_steps, "runs": EPOCH_PROFILE_RUNS,
            "wall_ms": wall_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "epoch_kernel_ms": epoch_ms,
            "epoch_kernel_share_of_device": epoch_ms / device_ms,
            "top_kernels_ms": dict(top)}


def ring_dynamics_ok(cfg, res) -> bool:
    """The repo's own checks of a ring run (tests/test_neuro.py), as they
    hold at 32 compartments: every ring spikes alike; in each, the wave
    has fired cells 0..k-1 once each and no other; the front advances at
    most one cell an epoch and never recedes (an epoch may pass without a
    spike: a 32-compartment cell sometimes takes longer than the 5 ms
    delay to fire, so its spike falls into the next epoch); and the wave
    covers at least half the epochs."""
    front = res.wavefront.cpu()
    fired = front[front >= 0]
    counts = res.spike_counts.cpu().reshape(cfg.n_rings, cfg.cells_per_ring)
    k = int(counts[0].sum())
    wave = torch.zeros(cfg.cells_per_ring, dtype=counts.dtype)
    wave[:k] = 1
    steps = fired[1:] - fired[:-1]
    return (bool((counts == wave).all())
            and bool(((steps >= 0) & (steps <= 1)).all())
            and (cfg.n_rings > 1 or int(front.max()) == k - 1)
            and 2 * k >= cfg.n_epochs
            and res.total_spikes == cfg.n_rings * k)


def phase_epoch_hold(dev) -> int:
    """One epoch of the ring stepped three ways: ``cable.step`` on the card
    (the soma kernel once a dt step), the epoch kernel, the plain version.
    Returns the soma kernel's launches on its path."""
    cfg = ring_config(RING_CELLS, 1, RING_DELAY, RING_COMPARTMENTS)
    steps, n = cfg.delay_steps, cfg.n_cells
    stim_left = min(int(round(cfg.stim_ms / cfg.cell.dt)), steps)
    state0 = init_state(n, cfg.cell, dev)
    rng = np.random.default_rng(SEED)
    incoming = torch.tensor(rng.uniform(size=(steps, n)) < 0.002,
                            dtype=torch.float32, device=dev)
    i_stim = is_ring_head(cfg, dev).float() * cfg.stim_current
    i_rest = torch.zeros_like(i_stim)
    torch.cuda.synchronize()
    ops.reset_launches()
    state, spiked = state0, torch.empty_like(incoming, dtype=torch.bool)
    for s in range(steps):
        state, spiked[s] = cable.step(state, cfg.cell, incoming[s],
                                      i_stim if s < stim_left else i_rest)
    launches = dict(ops.LAUNCHES)
    check(launches["hh_step"] == steps
          and sum(launches.values()) == steps,
          f"cable.step over an epoch launched {launches}, expected hh_step "
          f"once a step")
    stepped = (state, spiked)
    epoch = ops.cable_epoch(state0, cfg.cell, incoming, i_stim, stim_left)
    plain = cable_epoch_plain(state0, cfg.cell, incoming, i_stim, stim_left)
    torch.cuda.synchronize()
    errs = {}
    for what, (a, b) in {"epoch_vs_plain": (epoch, plain),
                         "stepped_vs_plain": (stepped, plain),
                         "stepped_vs_epoch": (stepped, epoch)}.items():
        errs[what] = epoch_compare(a, b, f"epoch hold {what}")
    emit({"phase": "epoch_hold", "cells": n, "compartments": RING_COMPARTMENTS,
          "steps": steps, "stim_steps": stim_left,
          "spikes": int(plain[1].sum()), "spikes_equal": True,
          "hh_step_launches": launches["hh_step"],
          "max_state_abs_err": {k: e for k, (e, _) in errs.items()},
          "bits_equal": {k: eq for k, (_, eq) in errs.items()}})
    return launches["hh_step"]


def phase_neuro(dev) -> tuple[int, list]:
    # a small ring through the plain version on the CPU and through the
    # kernel on the card (tests/test_neuro.py's first ring)
    small = ring_config(32, 1, 40.0, 4)
    cpu, card = (neuro_sim.simulate(small, device=d) for d in ("cpu", dev))
    check(torch.equal(cpu.spike_counts, card.spike_counts.cpu())
          and torch.equal(cpu.wavefront, card.wavefront.cpu()),
          f"small ring: card spikes {card.spike_counts.tolist()} != CPU "
          f"{cpu.spike_counts.tolist()}")
    rows, main_launches = [], 0
    for name, n_rings in RING_FORMS:
        cfg = ring_config(RING_CELLS, n_rings, RING_T_END, RING_COMPARTMENTS)
        steps = cfg.n_epochs * cfg.delay_steps
        torch.cuda.synchronize()
        ops.reset_launches()
        got = neuro_sim.simulate(cfg, device=dev)
        launches = dict(ops.LAUNCHES)
        check(launches["cable_epoch"] == 2 * cfg.n_epochs
              and sum(launches.values()) == launches["cable_epoch"],
              f"{name}: launches {launches}, expected cable_epoch once an "
              f"epoch, two runs of {cfg.n_epochs} epochs (warm and timed), "
              f"and no other kernel")
        with plain_kernels():
            want = neuro_sim.simulate(cfg, device=dev)
        check(ops.LAUNCHES == launches, "the plain run launched a kernel")
        state_err = {f: float((a - b).abs().max())
                     for f, a, b in zip(CellState._fields, got.state,
                                        want.state)}
        same_counts = torch.equal(got.spike_counts, want.spike_counts)
        same_fronts = torch.equal(got.wavefront, want.wavefront)
        check(same_counts and same_fronts,
              f"{name}: kernel spikes {got.total_spikes} fronts "
              f"{got.wavefront.tolist()} != plain {want.total_spikes} "
              f"{want.wavefront.tolist()}")
        check(max(state_err.values()) <= RING_STATE_TOL,
              f"{name}: final state kernel vs plain {state_err}")
        check(ring_dynamics_ok(cfg, got), f"{name}: ring dynamics off: "
              f"{got.total_spikes} spikes, fronts {got.wavefront.tolist()}")
        row = {"form": name, "cells": cfg.n_cells, "rings": n_rings,
               "compartments": RING_COMPARTMENTS, "t_end_ms": RING_T_END,
               "epochs": cfg.n_epochs, "dt_steps": steps,
               "total_spikes": got.total_spikes,
               "wavefront_last": int(got.wavefront[-1]),
               "wall_s": got.wall_s, "plain_wall_s": want.wall_s,
               "dt_steps_per_s": steps / got.wall_s,
               "cell_steps_per_s": steps * cfg.n_cells / got.wall_s,
               "cable_epoch_launches": launches["cable_epoch"],
               "hh_step_launches": launches["hh_step"],
               "spikes_equal_plain": same_counts,
               "wavefront_equal_plain": same_fronts,
               "state_max_abs_err_vs_plain": state_err,
               "state_tolerance": RING_STATE_TOL,
               "epoch_profile": epoch_profile(cfg, dev)}
        emit({"phase": "neuro", **row})
        rows.append(row)
        if n_rings == 1:
            main_launches = launches["cable_epoch"]
        del got, want
    return main_launches, rows


# ------------------------------------------------------------- ring ranks

RANK_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
RANK_TIMEOUT_S = 300        # a world's processes, start to exit
COLLECTIVE_TIMEOUT_S = 120  # the rendezvous and every collective


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ring_rank(backend: str, out: str) -> int:
    """One rank of ring_ranks, in a process of its own: wire up from the
    Slurm variables, shard the ring over a ``cells`` mesh, save what it
    saw to ``out``/rank<r>.pt.  The one-rank world first times
    ``init_benchmark``."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wireup = WireUp.from_env()
    if not wireup.is_distributed:   # one task: WireUp's default port
        wireup = dataclasses.replace(
            wireup, coordinator=f"localhost:{os.environ['REPRO_COORD_PORT']}")
    init_distributed(wireup, dev, backend=backend,
                     timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    r, world = wireup.process_id, wireup.num_processes
    res = {"backend": torch.distributed.get_backend()}
    try:
        if world == 1:
            res["init_benchmark"] = init_benchmark(
                (1, 1), ("data", "model"), repeats=10, device="cuda")
        mesh = mesh_of((world,), ("cells",), "cuda")
        cfg = ring_config(RING_CELLS, 1, RING_T_END, RING_COMPARTMENTS)
        torch.cuda.synchronize()
        ops.reset_launches()
        got = neuro_sim.simulate(cfg, device=dev, mesh=mesh)
        res["launches"] = dict(ops.LAUNCHES)
        res.update(wall_s=got.wall_s, total_spikes=got.total_spikes,
                   counts=got.spike_counts.cpu(),
                   wavefront=got.wavefront.cpu(),
                   state=[t.cpu() for t in got.state])
        # one epoch (the first: the stimulus is on), attested
        shard = neuro_sim.Shard(cfg, dev, mesh)
        state = init_state(shard.n_loc, cfg.cell, dev)
        incoming = torch.zeros((cfg.delay_steps, shard.n_loc), device=dev)
        with attest.record() as program:
            shard.epoch(state, incoming, 0)
        torch.cuda.synchronize()
        report = attest.parse_program(program.text, world)
        res["epoch"] = {
            "collectives": [(op.kind, op.payload_bytes) for op in report.ops],
            "findings": report.findings,
            "lines": [line for line in program.lines
                      if line.startswith(("c10d::", "kernel::", "plain::"))]}
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, Path(out) / f"rank{r}.pt")
    return 0


def run_world(world: int, backend: str, tmp: Path, entry: str = "ring_rank",
              *args: str) -> list[dict]:
    """``world`` rank processes of ``entry`` (``ring_rank`` or
    ``tp_rank``, with ``args``) on the card, all at once; each rank's
    results.  A rank that fails or outlives RANK_TIMEOUT_S fails the
    phase; no process outlives this call."""
    out = tmp / str(world)
    out.mkdir()
    env = {**os.environ, "SLURM_NTASKS": str(world),
           "SLURM_STEP_NODELIST": "localhost",
           "REPRO_COORD_PORT": str(free_port())}
    procs = []
    try:
        for r in range(world):
            log = open(out / f"rank{r}.log", "w")
            procs.append((log, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), entry,
                 backend, str(out), *args],
                env={**env, "SLURM_PROCID": str(r)}, stdout=log,
                stderr=subprocess.STDOUT)))
        deadline = time.perf_counter() + RANK_TIMEOUT_S
        for r, (log, proc) in enumerate(procs):
            try:
                rc = proc.wait(max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            text = (out / f"rank{r}.log").read_text()
            check(rc == 0, f"{entry}: world {world} ({backend}) rank {r} "
                  f"ended {rc}:\n{text[-3000:]}")
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def phase_ring_ranks(dev) -> dict:
    """The sharded arbor_ring at 1 (NCCL), 2 and 4 (gloo) ranks against the
    single-process kernel run; the attested epoch of every rank; the
    one-rank world's init_benchmark.  Returns each world's launches by
    rank."""
    cfg = ring_config(RING_CELLS, 1, RING_T_END, RING_COMPARTMENTS)
    want = neuro_sim.simulate(cfg, device=dev)
    want_state = [t.cpu() for t in want.state]
    steps = cfg.n_epochs * cfg.delay_steps
    payload = cfg.delay_steps * cfg.n_cells
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend in RANK_WORLDS:
            ranks = run_world(world, backend, Path(tmp))
            got = ranks[0]
            check(all(res["backend"] == backend for res in ranks),
                  f"world {world}: backends {[r['backend'] for r in ranks]}")
            same_counts = torch.equal(got["counts"], want.spike_counts.cpu())
            same_fronts = torch.equal(got["wavefront"], want.wavefront.cpu())
            check(same_counts and same_fronts,
                  f"world {world}: {got['total_spikes']} spikes, fronts "
                  f"{got['wavefront'].tolist()} != one process's "
                  f"{want.total_spikes} {want.wavefront.tolist()}")
            state_err = {f: float((a - b).abs().max()) for f, a, b in
                         zip(CellState._fields, got["state"], want_state)}
            check(all(e == 0.0 for e in state_err.values()),
                  f"world {world}: final state differs from one process's "
                  f"{state_err}")
            launches[world] = [res["launches"]["cable_epoch"]
                               for res in ranks]
            for r, res in enumerate(ranks):
                check(res["launches"]["cable_epoch"] == 2 * cfg.n_epochs
                      and sum(res["launches"].values())
                      == res["launches"]["cable_epoch"],
                      f"world {world} rank {r}: launches {res['launches']}, "
                      f"expected cable_epoch once an epoch of two runs")
                epoch = res["epoch"]
                check(epoch["collectives"] == [("all-gather", payload)],
                      f"world {world} rank {r}: the epoch's collectives "
                      f"{epoch['collectives']}")
                staged = [f for f in epoch["findings"]
                          if f["kind"] == "host-transfer"
                          and f"over {backend}" in f["detail"]]
                check(epoch["findings"] == (staged if backend == "gloo"
                                            else [])
                      and len(staged) == (backend == "gloo"),
                      f"world {world} rank {r}: findings "
                      f"{epoch['findings']}")
                check(sum(line.startswith("kernel::cable_epoch")
                          for line in epoch["lines"]) == 1
                      and not any(line.startswith("plain::")
                                  for line in epoch["lines"]),
                      f"world {world} rank {r}: {epoch['lines']}")
            wall = max(res["wall_s"] for res in ranks)
            emit({"phase": "ring_ranks", "world": world, "backend": backend,
                  "cells": cfg.n_cells, "compartments": RING_COMPARTMENTS,
                  "t_end_ms": RING_T_END, "epochs": cfg.n_epochs,
                  "total_spikes": got["total_spikes"],
                  "spikes_equal_one_process": same_counts,
                  "wavefront_equal_one_process": same_fronts,
                  "state_bits_equal_one_process": True,
                  "wall_s_by_rank": [res["wall_s"] for res in ranks],
                  "wall_s": wall, "one_process_wall_s": want.wall_s,
                  "cell_steps_per_s": steps * cfg.n_cells / wall,
                  "cable_epoch_launches_by_rank": launches[world],
                  "epoch_collectives": got["epoch"]["collectives"],
                  "epoch_findings": [f["detail"][:160] for f in
                                     got["epoch"]["findings"]],
                  "epoch_lines": [line[:160] for line in
                                  got["epoch"]["lines"]],
                  "nccl_version": ".".join(
                      map(str, torch.cuda.nccl.version()))})
            if world == 1:
                bench = got["init_benchmark"]
                check(list(bench) == ["mesh_shape", "axes",
                                      "mesh_construct_s",
                                      "first_collective_s",
                                      "steady_collective_s",
                                      "steady_collective_max_s"],
                      f"init_benchmark keys {list(bench)}")
                emit({"phase": "init_benchmark", "backend": backend,
                      "world": world, **bench})
    return launches


# ------------------------------------------------- tensor-parallel training

# full width, depth cut so that four ranks' states and one process's fit
# the card together with the phases' rank processes
TP_LAYERS = {ARCH: 2, MOE_TRAIN_ARCH: 4, SSM_ARCH: 4, HYBRID_ARCH: 6}
TP_MESHES = {ARCH: ((1, 1), (1, 2), (2, 2)), MOE_TRAIN_ARCH: ((1, 1), (1, 2))}
TP_SEQ, TP_BATCH, TP_STEPS = 2048, 4, 2
TP_TOL = 2e-2       # |loss - one process's|, tests/test_integration.py:56
# step 1 against the one-process step, every leaf gathered: each gradient's
# relative error, the update's (master weights after minus before) over the
# whole tree, and the step's grad norm, relative.  bf16 noise reads at most
# 6e-3, 1.6e-2 and 1e-4 on the card; a gradient missing its sum over two
# ranks, or doubled, reads 0.7-1.0 on its leaf
TP_GRAD_TOL, TP_UPDATE_TOL, TP_NORM_TOL = 5e-2, 1e-1, 5e-3


def named_leaves(tree, prefix: str = "") -> dict:
    """A tree's leaves by slash-joined key, dict keys sorted."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(named_leaves(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def tp_batch(model, host_batch, dev, mesh=None) -> dict:
    batch = {k: torch.as_tensor(a, device=dev) for k, a in host_batch.items()}
    if mesh is None:
        return batch
    return launch_bind.shard_batch(
        model, ShapeConfig("train", "train", TP_SEQ, TP_BATCH), mesh, batch)


def tp_grads(model, params, host_batch, dev, mesh=None) -> tuple:
    """Step 1's gradients as the train step takes them (the loss with remat
    full and the default z-loss, then its backward), on the host: this
    rank's shards under ``mesh``; and their global norm as the step's
    clipping reduces it over the shards."""
    tc = TrainConfig(remat="full")
    live = P.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, tp_batch(model, host_batch, dev, mesh),
                         remat=tc.remat, z_loss=tc.z_loss)
    loss.backward()
    grads = P.tree_map(lambda t: t.grad, live)
    groups = (P.shard_groups(model.param_specs())
              if mesh is not None and mesh.size() > 1 else None)
    norm = float(adamw.clip_by_global_norm(grads, 1.0, groups)[1])
    del live, loss
    return P.tree_map(lambda t: t.cpu(), grads), norm


def tp_compare(ctx, model, got: dict, want: dict | None, dev) -> dict:
    """Each leaf of ``got`` (a tree of this rank's host shards under the
    bound mesh) gathered to its global tensor on the card, one leaf at a
    time, held on rank 0 against ``want``'s (the one-process tree, flat):
    each leaf's relative L2 error, and the whole tree's, and its norm."""
    specs = named_leaves(P.partition(model.param_specs()))
    rows, sq_want, sq_diff, sq_got = {}, 0.0, 0.0, 0.0
    for key, local in named_leaves(got).items():
        full = ctx.unshard(local.to(dev), specs[key]).float()
        if want is not None:
            ref = want[key].to(dev).float()
            d2 = float(torch.sum(torch.square(full - ref)))
            w2 = float(torch.sum(torch.square(ref)))
            g2 = float(torch.sum(torch.square(full)))
            rows[key] = (d2 / w2) ** 0.5 if w2 else d2 ** 0.5
            sq_want, sq_diff, sq_got = sq_want + w2, sq_diff + d2, sq_got + g2
            del ref
        del full
    return {"by_leaf": rows, "rel_err": (sq_diff / sq_want) ** 0.5
            if want is not None else None, "norm": sq_got ** 0.5}


def tp_steps(model, step_fn, state, host_batches, dev, mesh=None) -> dict:
    """``step_fn`` over ``host_batches`` (this rank's shards of them under
    ``mesh``), launch counts zeroed just before and read just after, each
    step timed from its batch's copy to its loss's read, the first one
    attested under a mesh of more than one rank.  Step 1's update (the
    master weights after it minus before) is kept on the host, outside
    the steps' clocks."""
    before = P.tree_map(lambda t: t.to("cpu", copy=True), state.opt.master)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "grad_norms": [], "ms": []}
    for i, host_batch in enumerate(host_batches):
        if mesh is not None:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        batch = tp_batch(model, host_batch, dev, mesh)
        attested = i == 0 and mesh is not None and mesh.size() > 1
        with (attest.record() if attested
              else contextlib.nullcontext()) as program:
            state, metrics = step_fn(state, batch)
        out["losses"].append(float(metrics["loss"]))   # the host sync
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["update"] = P.tree_map2(lambda a, b: a.cpu() - b,
                                        state.opt.master, before)
            del before
        if attested:
            report = attest.parse_program(program.text, mesh.size())
            kinds: dict = {}
            for op in report.ops:
                row = kinds.setdefault(op.kind, {"count": 0, "bytes": 0})
                row["count"] += 1
                row["bytes"] += op.payload_bytes
            out["collectives"] = kinds
            out["backends"] = sorted({line.rsplit(" over ", 1)[1]
                                      for line in program.lines
                                      if " over " in line})
            out["findings"] = [f["kind"] for f in report.findings]
            out["staged"] = sum(" over gloo" in f["detail"]
                                for f in report.findings)
            # gloo's send takes host memory: comm.shift copies each halo
            # (and its cotangent) to the host before sending it
            out["send_copies"] = sum("copy from the device to the host"
                                     in f["detail"] for f in report.findings)
            out["sends"] = sum(op.name.startswith("c10d::send")
                               for op in report.ops)
    out["launches"] = dict(ops.LAUNCHES)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def tp_rank(backend: str, out: str, archs: str, dims: str) -> int:
    """One rank of a sharded training phase (tp_train, moe_ep_train,
    cp_train), in a process of its own: wire up from the Slurm variables,
    then for each of the comma-separated ``archs`` (full width, TP_LAYERS
    deep) train TP_STEPS steps on its shards of a ``dims`` mesh under the
    ``train`` rules; the one-rank world first takes the same steps with no
    mesh bound (the one-process step).  Saves to ``out``/rank<r>.pt, a
    result by arch."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    wireup = WireUp.from_env()
    if not wireup.is_distributed:
        wireup = dataclasses.replace(
            wireup, coordinator=f"localhost:{os.environ['REPRO_COORD_PORT']}")
    init_distributed(wireup, dev, backend=backend,
                     timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    r = wireup.process_id
    shape = tuple(int(n) for n in dims.split("x"))
    res = {"backend": torch.distributed.get_backend(), "mesh": shape}
    try:
        for arch in archs.split(","):
            res[arch] = tp_rank_arch(arch, Path(out), shape, dev)
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, Path(out) / f"rank{r}.pt")
    return 0


def tp_rank_arch(arch: str, out: Path, shape: tuple, dev) -> dict:
    """``tp_rank``'s run of one arch on this rank."""
    r, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    cfg = dataclasses.replace(ALL_ARCHS[arch], n_layers=TP_LAYERS[arch])
    model, step_fn, batches, _ = train_setup(cfg, TP_SEQ, TP_BATCH,
                                             TP_STEPS - 1, dev)
    t0 = time.perf_counter()
    res = {}
    reference = out.parent / f"one_process_step1_{arch}.pt"
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(SEED), dev)
    if world == 1:
        one = P.tree_map(torch.clone, params)
        grads, _ = tp_grads(model, one, batches[0], dev)
        res["one_process"] = tp_steps(
            model, step_fn, TrainState(one, adamw.init(one)), batches, dev)
        update = named_leaves(res["one_process"].pop("update"))
        res["one_process"]["update_norm"] = sum(
            float(torch.sum(torch.square(t))) for t in update.values()
        ) ** 0.5
        torch.save({"grads": named_leaves(grads), "update": update},
                   reference)
        del one, grads, update
        torch.cuda.empty_cache()
    mesh = mesh_of(shape, ("data", "model"), "cuda")
    with bind(mesh, RULESETS["train"]) as ctx:
        local = launch_bind.shard(
            params, launch_bind.state_shardings(model, mesh).params)
        del params
        grads, clip_norm = tp_grads(model, local, batches[0], dev, mesh)
        torch.cuda.empty_cache()
        sharded = tp_steps(
            model, step_fn, TrainState(local, adamw.init(local)),
            batches, dev, mesh)
        want = torch.load(reference, mmap=True) if r == 0 else None
        update = sharded.pop("update")
        sharded["grads"] = tp_compare(ctx, model, grads,
                                      want and want["grads"], dev)
        sharded["grads"]["clip_norm"] = clip_norm
        sharded["update"] = tp_compare(ctx, model, update,
                                       want and want["update"], dev)
        res["sharded"] = sharded
        del grads, update, want
    res["sharded"]["seconds"] = time.perf_counter() - t0
    return res


def expected_launches(cfg) -> dict[str, int]:
    """Each kernel's launches in TP_STEPS steps of ``cfg`` under remat
    full: the forward and the recompute of every self-attention call
    (flash) and every Mamba2 layer (the SSD scan)."""
    mamba = {"ssm": cfg.n_layers,
             "hybrid": cfg.n_layers // cfg.attn_every * (cfg.attn_every - 1)
             }.get(cfg.family, 0)
    attention = {"dense": cfg.n_layers, "moe": cfg.n_layers,
                 "hybrid": cfg.n_layers // cfg.attn_every}.get(cfg.family, 0)
    return {"flash_attention": TP_STEPS * attention * 2,
            "ssd_scan": TP_STEPS * mamba * 2}


def phase_tp_train(arch: str, phase: str) -> dict:
    """``arch`` at full width, TP_LAYERS deep, over each of TP_MESHES (see
    ``sharded_train``).  Returns the flash launches by mesh and rank."""
    return {key: [n["flash_attention"] for n in by_rank]
            for key, by_rank in sharded_train(
                phase, [(dims, (arch,)) for dims in TP_MESHES[arch]]
            )[arch].items()}


def phase_cp_train() -> dict:
    """The context-parallel Mamba2 block: mamba2-2.7b 4 layers deep over
    (1, 1), (1, 2) and (1, 4), zamba2-2.7b one group (6 layers) over (1,
    2), each with its one-process step; the ranks of one world run both
    archs in turn.  Returns the launches by arch, mesh and rank."""
    return sharded_train("cp_train", [
        ((1, 1), (SSM_ARCH, HYBRID_ARCH)), ((1, 2), (SSM_ARCH, HYBRID_ARCH)),
        ((1, 4), (SSM_ARCH,))])


def sharded_train(phase: str, worlds: list) -> dict:
    """Each of ``worlds`` (a mesh and the archs its ranks train on it) at
    full width, TP_LAYERS deep, seq 2048, batch 4, remat full, bf16, the
    ``train`` rules: one NCCL rank at (1, 1), which also takes the
    one-process step, then gloo ranks sharing the card.  Every rank's
    losses within TP_TOL of the one-process step's, every self-attention
    call and every Mamba2 layer's scan through its kernel on every rank
    (``expected_launches``), the attested first step's collectives (dense:
    no all-to-all; moe: six a layer, two forward, two recomputed, two
    backward; ssm and hybrid under a model axis: the halo's
    collective-permute and the all-gathers, no all-to-all), and but for
    moe step 1's gradients, update and grad norm against the one-process
    step's.  Returns the launches by arch, mesh and rank."""
    launches: dict = {}
    one: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dims, archs in worlds:
            world = dims[0] * dims[1]
            backend = "nccl" if world == 1 else "gloo"
            key = "x".join(map(str, dims))
            ranks = run_world(world, backend, Path(tmp), "tp_rank",
                              ",".join(archs), key)
            for arch in archs:
                cfg = dataclasses.replace(ALL_ARCHS[arch],
                                          n_layers=TP_LAYERS[arch])
                if world == 1:
                    one[arch] = ranks[0][arch]["one_process"]
                got = [res[arch]["sharded"] for res in ranks]
                launches.setdefault(arch, {})[key] = [
                    {k: res["launches"][k] for k in ("flash_attention",
                                                     "ssd_scan")}
                    for res in got]
                sharded_check(phase, cfg, dims, backend, got, one[arch])
    return launches


def sharded_check(phase: str, cfg, dims: tuple, backend: str, got: list,
                  one: dict) -> None:
    """``sharded_train``'s checks and line for one arch on one mesh."""
    key = "x".join(map(str, dims))
    want = expected_launches(cfg)
    check(all(one["launches"][k] == n for k, n in want.items()),
          f"{phase} {cfg.name}: one process launched {one['launches']} "
          f"(want {want})")
    for rk, res in enumerate(got):
        err = max(abs(a - b) for a, b in zip(res["losses"], one["losses"]))
        check(err <= TP_TOL, f"{phase} {cfg.name} {key} rank {rk}: losses "
              f"{res['losses']} vs one process {one['losses']}")
        check(all(res["launches"][k] == n for k, n in want.items()),
              f"{phase} {cfg.name} {key} rank {rk}: launches "
              f"{res['launches']} (want {want})")
        check(res["losses"] == got[0]["losses"],
              f"{phase} {cfg.name} {key}: ranks' losses differ")
    a2a = 0
    cp = cfg.family in ("ssm", "hybrid") and dims[1] > 1
    if dims[0] * dims[1] > 1:
        kinds = got[0]["collectives"]
        a2a = kinds.get("all-to-all", {}).get("count", 0)
        check({"all-gather", "reduce-scatter"} <= set(kinds)
              and a2a == (6 * cfg.n_layers if cfg.family == "moe"
                          and dims[1] > 1 else 0)
              and ("collective-permute" in kinds) == cp
              and got[0]["backends"] == ["gloo"]
              and set(got[0]["findings"]) == {"host-transfer"}
              and got[0]["send_copies"] == got[0]["sends"]
              and got[0]["staged"] + got[0]["send_copies"]
              == len(got[0]["findings"]),
              f"{phase} {cfg.name} {key}: collectives {kinds}, backends "
              f"{got[0]['backends']}, findings {got[0]['findings']} "
              f"({got[0]['staged']} staged collectives, "
              f"{got[0]['send_copies']} copies for {got[0]['sends']} "
              f"sends)")
    emit({"phase": phase, "arch": cfg.name, "mesh": list(dims),
          "backend": backend, "layers": cfg.n_layers,
          "params": cfg.param_count(), "seq": TP_SEQ,
          "batch": TP_BATCH, "losses": got[0]["losses"],
          "grad_norms": got[0]["grad_norms"],
          "one_process_losses": one["losses"],
          "one_process_grad_norms": one["grad_norms"],
          "max_abs_dloss": max(abs(a - b) for a, b in zip(
              got[0]["losses"], one["losses"])),
          "ms_per_step_by_rank": [res["ms"] for res in got],
          "one_process_ms": one["ms"],
          "peak_gb_by_rank": [res["peak_gb"] for res in got],
          "seconds_by_rank": [res["seconds"] for res in got],
          "flash_launches_by_rank": [res["launches"]["flash_attention"]
                                     for res in got],
          "ssd_launches_by_rank": [res["launches"]["ssd_scan"]
                                   for res in got],
          "collectives": got[0].get("collectives", {}),
          "all_to_all_per_layer_forward": a2a // 3 // cfg.n_layers,
          "backends": got[0].get("backends", []),
          "host_transfer_findings": len(got[0].get("findings", [])),
          "host_transfer_send_copies": got[0].get("send_copies", 0),
          "step1_grad_rel_err_by_leaf": got[0]["grads"]["by_leaf"],
          "step1_grad_rel_err": got[0]["grads"]["rel_err"],
          "step1_grad_norm_gathered": got[0]["grads"]["norm"],
          "step1_grad_norm_clip": got[0]["grads"]["clip_norm"],
          "step1_update_rel_err_by_leaf": got[0]["update"]["by_leaf"],
          "step1_update_rel_err": got[0]["update"]["rel_err"],
          "step1_update_norm": got[0]["update"]["norm"],
          "one_process_step1_update_norm": one["update_norm"]})
    if cfg.family == "moe":
        # capacity is per shard, as in the reference: the shards drop
        # other tokens than one process does, so step 1's gradients differ
        # by what was dropped (printed, not held)
        return
    grads, update = got[0]["grads"], got[0]["update"]
    worst = max(grads["by_leaf"], key=grads["by_leaf"].get)
    check(grads["by_leaf"][worst] <= TP_GRAD_TOL,
          f"{phase} {cfg.name} {key}: step 1's {worst} gradient is "
          f"{grads['by_leaf'][worst]} off the one process's")
    check(update["rel_err"] <= TP_UPDATE_TOL,
          f"{phase} {cfg.name} {key}: step 1's update is "
          f"{update['rel_err']} off the one process's")
    for name, norm in (("step", got[0]["grad_norms"][0]),
                       ("clipping", grads["clip_norm"]),
                       ("gathered", grads["norm"])):
        check(abs(norm - one["grad_norms"][0])
              <= TP_NORM_TOL * one["grad_norms"][0],
              f"{phase} {cfg.name} {key}: step 1's grad norm by {name} "
              f"{norm} vs one process {one['grad_norms'][0]}")


# ----------------------------------------------------------------- gather

GATHER_LAYERS = 4       # full width, f32: 1.7 GB of embeddings, 0.8 a layer
GATHER_GEOM = dict(slots=2, max_len=64, block_size=8, chunk=4)


class F32Caches:
    """The model with its caches declared in f32, so an f32 engine keeps KV
    at the weights' precision (the model declares bf16 caches)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg

    def __getattr__(self, name):
        return getattr(self.model, name)

    @staticmethod
    def _f32(specs):
        return P.tree_map(lambda s: dataclasses.replace(
            s, dtype=torch.float32), specs)

    def cache_specs(self, batch, seq_len):
        return self._f32(self.model.cache_specs(batch, seq_len))

    def paged_cache_specs(self, num_blocks, block_size):
        return self._f32(self.model.paged_cache_specs(num_blocks, block_size))

    def zero_cache(self, batch, seq_len, device):
        return P.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                                device=device),
                          self.cache_specs(batch, seq_len))


def gather_requests(cfg) -> list:
    """tests/test_integration.py's oracle trace at the full vocab: a
    16-token shared prefix, four tails of 3-6 tokens, 6 new tokens each."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, size=16).tolist()
    tails = [rng.integers(0, cfg.vocab_size, size=3 + i).tolist()
             for i in range(4)]
    return [Request(rid=i, prompt=shared + tails[i], max_new=6)
            for i in range(4)]


def phase_gather(dev) -> None:
    """Both pathways of the paged engine against the contiguous oracle
    (``compare_engines``), greedy and sampled, f32; and the gather
    pathway's streams against the paged kernel's."""
    cfg = dataclasses.replace(ALL_ARCHS[ARCH], n_layers=GATHER_LAYERS)
    model = F32Caches(build(cfg))
    params = P.tree_map(lambda t: t.float(), model.init_params(
        torch.Generator(device=dev).manual_seed(SEED), dev))
    sampled = SamplingParams(temperature=0.8, top_k=16, top_p=0.9, seed=2)
    streams, verdicts, launches = {}, {}, {}
    for kernel in ("gather", "paged"):
        for name, sp in (("greedy", None), ("sampled", sampled)):
            ops.reset_launches()
            report = compare_engines(
                model, params, lambda: gather_requests(cfg), **GATHER_GEOM,
                sampling=sp, engine_kwargs={"paged": {"kernel": kernel}},
                device=dev)
            launches[f"{kernel}/{name}"] = ops.LAUNCHES["paged_attention"]
            check(report.ok, f"compare_engines kernel={kernel} {name}: "
                             f"{report.summary()['verdicts']}")
            streams[kernel, name] = report.b.value
            verdicts[f"{kernel}/{name}"] = report.summary()["verdicts"]
    for name in ("greedy", "sampled"):
        check(np.array_equal(streams["gather", name], streams["paged", name]),
              f"gather streams != paged kernel streams ({name}):\n"
              f"{streams['gather', name]}\n{streams['paged', name]}")
        check(launches[f"gather/{name}"] == 0
              and launches[f"paged/{name}"] > 0,
              f"paged_attention launches by pathway: {launches}")
    emit({"phase": "gather", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": "float32", **GATHER_GEOM,
          "requests": 4, "verdicts": verdicts,
          "paged_attention_launches": launches,
          "gather_equals_paged": True,
          "streams": streams["gather", "greedy"].tolist()})
    del params
    torch.cuda.empty_cache()


def phase_gather_serve(model, params, paged, dev) -> None:
    """The serve phase's bf16 trace once through ``kernel="gather"`` at full
    width and depth: throughput and agreement with the paged run are
    measurements (bf16 attention rounds at other points on the two
    pathways, so streams may part after a near tie)."""
    cfg = model.cfg
    warm = PagedServeEngine(model, params, slots=2, max_len=64,
                            block_size=BLOCK, chunk=CHUNK, num_blocks=16,
                            kernel="gather", device=dev)
    warm.run([Request(rid=0, prompt=list(range(20)), max_new=3)])
    del warm
    before = torch.cuda.memory_allocated()
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, kernel="gather",
                           device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(serve_requests(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = eng.report()
    del eng
    check_freed(before, "the gather engine")
    check(rep["served"] == N_REQUESTS and rep["kernel"] == "gather",
          f"gather serve: {rep['served']} served, kernel {rep['kernel']}")
    check(not any(ops.LAUNCHES.values()),
          f"the gather pathway launched {ops.LAUNCHES}")
    got = {r.rid: r.out for r in done}
    ref = paged["streams"]
    same = sum(a == b for rid in ref for a, b in zip(got[rid], ref[rid]))
    lead = [next((i for i, (a, b) in enumerate(zip(got[rid], ref[rid]))
                  if a != b), len(ref[rid])) for rid in sorted(ref)]
    emit({"phase": "gather_serve", "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": "bfloat16", "wall_s": wall,
          "decode_steps": rep["decode_steps"],
          "ms_per_tick": 1e3 * wall / rep["decode_steps"],
          "tokens_out_per_s": rep["tokens_out"] / wall,
          "paged_tokens_out_per_s": paged["tokens_out_per_s"],
          "prefix_hit_rate": rep["prefix_hit_rate"],
          "token_agreement_with_paged": same / sum(map(len, ref.values())),
          "requests_equal_to_paged": sum(got[r] == ref[r] for r in ref),
          "leading_tokens_equal": lead})


CLUSTER_REPLICAS = 2
CLUSTER_POLICIES = ("affinity", "round_robin", "random")


def cluster_trace(cfg):
    """The serve phase's shape spread over 4 tenants: 16 chat requests, a
    256-token system prompt a tenant, suffixes of 16-256 tokens, 32 new
    tokens, in bursts of 4 with 8 quiet ticks between."""
    return generate(WorkloadSpec(
        name="cluster-chat", family="chat", arrival="bursty",
        n_requests=16, vocab_size=cfg.vocab_size, seed=SEED,
        max_new=MAX_NEW, prefix_len=PREFIX, n_streams=4, suffix_lo=16,
        suffix_hi=256, burst_size=4, burst_gap=8.0))


def replica_stats(engines) -> tuple[int, list[float]]:
    """Each paged engine's allocator and host tier checked; their decode
    steps summed, and each one's mean batch occupancy."""
    for eng in engines:
        eng.alloc.check()
        eng.host.check()
    reps = [eng.report() for eng in engines]
    return (sum(rep["decode_steps"] for rep in reps),
            [rep["mean_batch_occupancy"] for rep in reps])


def phase_cluster(model, params, dev) -> dict:
    """``ClusterEngine`` over 2 replicas of the served deepseek-7b (one set
    of weights), each a ``PagedServeEngine(kernel="paged")``: the chat trace
    through one engine, then through the cluster under each routing policy,
    all with the trace's arrivals.  Every cluster's streams must equal the
    single engine's, affinity must beat random on ``routed_affinity`` and
    ``shared_hit_rate``, the paged kernel must run once a layer a tick in
    every replica (counts zeroed just before each run), every replica's
    allocator and host tier must check, ``RunAudit`` must gate the affinity
    run clean, a routing rule calibrated on it must flag random routing with
    ``pathway-routing`` only, each engine must leave the card as it found it
    when deleted, and ``compare_engines(cluster=...)`` must pass sampled."""
    cfg = model.cfg
    trace = cluster_trace(cfg)
    n = trace.n_requests
    check(trace.max_feed <= MAX_LEN, f"cluster trace feeds {trace.max_feed}")
    geom = dict(slots=SLOTS, max_len=MAX_LEN, block_size=BLOCK, chunk=CHUNK,
                device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def serve(make):
        before = torch.cuda.memory_allocated()
        eng = make()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.run(trace.requests(), arrivals=list(trace.arrivals))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["paged_attention"]
        steps, occupancy = replica_stats(
            eng.replicas if isinstance(eng, ClusterEngine) else [eng])
        check(launches == steps * cfg.n_layers,
              f"paged_attention launched {launches} times, expected the "
              f"replicas' decode steps x layers = {steps} x {cfg.n_layers}")
        rep = eng.report()
        ticks = int(eng.now)
        del eng
        check_freed(before, "an engine of the cluster phase")
        return token_matrix(done, n, MAX_NEW), rep, {
            "wall_s": wall, "ticks": ticks,
            "ms_per_tick": 1e3 * wall / ticks,
            "tokens_out_per_s": rep["tokens_out"] / wall,
            "decode_steps": steps, "paged_attention_launches": launches,
            "occupancy": occupancy}

    single, _, single_run = serve(lambda: PagedServeEngine(model, params,
                                                           **geom))
    ctx = AuditContext(workload="serve", family=cfg.family, arch=cfg.name,
                       shared_prefix=True)
    runs, reports, audit_findings = {}, {}, None
    for routing in CLUSTER_POLICIES:
        audit = RunAudit(ctx)
        got, rep, run = serve(lambda: ClusterEngine(
            model, params, replicas=CLUSTER_REPLICAS, routing=routing,
            routing_seed=SEED, tracer=audit.tracer, **geom))
        check((got >= 0).all() and (got == single).all(),
              f"cluster ({routing}) streams differ from one engine's")
        if routing == "affinity":
            diag = audit.finish(engine_report=rep, source="cluster")
            audit_findings = diag.findings
            check(diag.gate(), f"RunAudit of the affinity run: "
                               f"{diag.findings}")
        reports[routing] = rep
        runs[routing] = {**run, **{k: rep[k] for k in (
            "routed_affinity", "shared_hit_rate", "affine_opportunities",
            "routed_spills", "routed_cold", "summary_rebuilds",
            "prefill_tokens", "cached_tokens")}}
    healthy, misrouted = reports["affinity"], reports["random"]
    check(healthy["routed_affinity"] > misrouted["routed_affinity"]
          and healthy["shared_hit_rate"] > misrouted["shared_hit_rate"],
          f"affinity {runs['affinity']} does not beat random "
          f"{runs['random']}")
    rule = Rule(name="cluster-routing", workloads=("serve",),
                expect=ExpectedSignature(
                    min_routed_affinity=0.8 * healthy["routed_affinity"],
                    min_shared_hit_rate=0.85 * healthy["shared_hit_rate"]))
    registry = ExpectationRegistry([rule])
    kinds = {routing: sorted({f["kind"] for f in registry.evaluate(
        ctx, Evidence(engine_report=rep))})
        for routing, rep in reports.items()}
    check(kinds["random"] == ["pathway-routing"] and not kinds["affinity"],
          f"routing findings by policy: {kinds}")
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=1)
    verdict = compare_engines(model, params, trace.requests, slots=SLOTS,
                              max_len=MAX_LEN, block_size=BLOCK, chunk=CHUNK,
                              sampling=sampled,
                              cluster={"replicas": CLUSTER_REPLICAS},
                              device=dev)
    check(verdict.ok, f"compare_engines(cluster=...) sampled: "
                      f"{verdict.summary()['verdicts']}")
    emit({"phase": "cluster", "arch": cfg.name, "layers": cfg.n_layers,
          "replicas": CLUSTER_REPLICAS, "trace": trace.describe(),
          "single": single_run, "runs": runs, "audit": audit_findings,
          "routing_findings": kinds,
          "tick_ratio_affinity_to_single":
              runs["affinity"]["ms_per_tick"] / single_run["ms_per_tick"],
          "compare_engines_sampled": verdict.summary()["verdicts"],
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "streams_equal": True})
    return {routing: run["paged_attention_launches"]
            for routing, run in runs.items()}


def phase_serve_cli() -> None:
    """``python -m repro_torch.launch.serve --replicas 2 --metrics-port 0
    --trace-out FILE`` on the card, in a process of its own: exit code 0,
    the audit's gate passed, and a Chrome trace with one timeline per
    request."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--replicas",
             str(CLUSTER_REPLICAS), "--metrics-port", "0", "--trace-out",
             str(path)], capture_output=True, text=True, timeout=600,
            cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")})
        check(r.returncode == 0, f"serve CLI exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        out = json.loads(r.stdout)
        trace = json.loads(path.read_bytes())
    check(out["audit"]["gate_ok"], f"serve CLI audit: {out['audit']}")
    check(out["engine"] == "cluster" and out["device"].startswith("cuda"),
          f"serve CLI ran {out['engine']} on {out['device']}")
    check(trace["otherData"]["requests"] == out["served"]
          == out["trace_out"]["requests"],
          f"trace of {trace['otherData']['requests']} requests, served "
          f"{out['served']}")
    emit({"phase": "serve_cli", **{k: out[k] for k in (
        "arch", "device_name", "engine", "replicas", "routing", "served",
        "routed", "routed_affinity", "shared_hit_rate", "tokens_per_s",
        "trace_out", "attribution")},
        "metrics_port": out["metrics"]["port"], "audit": out["audit"]})


def phase_moe_serve(dev) -> tuple[dict, dict]:
    """qwen3-moe-30b-a3b at full width and depth (30.5 B parameters, seeded
    bf16 weights, whole on the card) through ``PagedServeEngine`` on the
    serve phase's trace and settings.  Launch counts are zeroed just before
    the timed run and read just after: one paged-attention launch a layer a
    tick.  An untimed replay must give the same streams; its widest busy
    tick feeds the every-row timing (``moe_row_timing``), and a fresh
    engine's ticks under ``torch.profiler`` split a tick's device time into
    attention, routing and dispatch, the expert products, the combine and
    the rest."""
    cfg = ALL_ARCHS[MOE_SERVE_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(params))

    warm = PagedServeEngine(model, params, slots=2, max_len=64,
                            block_size=BLOCK, chunk=CHUNK, num_blocks=16,
                            device=dev)
    warm.run([Request(rid=0, prompt=list(range(20)), max_new=3)])
    del warm
    eng = PagedServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(serve_requests(cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rep = eng.report()
    check(rep["served"] == N_REQUESTS, f"moe served {rep['served']}")
    check(launches["paged_attention"] == rep["decode_steps"] * cfg.n_layers,
          f"moe: paged_attention launched {launches['paged_attention']} "
          f"times, expected decode_steps x layers = "
          f"{rep['decode_steps']} x {cfg.n_layers}")
    eng.alloc.check()
    for r in done:
        check(len(r.out) == MAX_NEW, f"moe request {r.rid}: {len(r.out)} "
                                     f"tokens")
        check(all(0 <= t < cfg.padded_vocab for t in r.out),
              f"moe request {r.rid}: token outside the vocab")
    streams = {r.rid: r.out for r in done}
    del eng

    recorder = RecordingModel(model)
    replay = PagedServeEngine(recorder, params, slots=SLOTS, max_len=MAX_LEN,
                              block_size=BLOCK, chunk=CHUNK, device=dev)
    replayed = {r.rid: r.out for r in replay.run(serve_requests(cfg))}
    check(replayed == streams, "moe: the replay's streams differ from the "
                               "timed run's")
    check(recorder.best is not None, "moe: no tick with every slot busy")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    timing = moe_row_timing(replay, recorder.best, dev)
    del replay
    # fewer ticks than the dense profile: a moe tick launches about 3,000
    # kernels, and the profiler's host side slows with each
    prof = serve_profile(model, params, dev, warm=20, ticks=2,
                         spans=MOE_SPANS)
    spans = prof.pop("span_ms_per_tick")
    parts = {"attention": prof["paged_attention_ms_per_tick"],
             "router_and_dispatch": spans["moe_route"],
             "expert_products": spans["moe_experts"],
             "combine": spans["moe_combine"]}
    parts["rest"] = prof["device_ms_per_tick"] - sum(parts.values())
    emit({"phase": "moe_serve", "arch": cfg.name, "params": n_params,
          "active_params": cfg.active_param_count(), "layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts": cfg.n_experts,
          "top_k": cfg.top_k, "init_s": init_s, "wall_s": wall,
          "decode_steps": rep["decode_steps"],
          "ms_per_tick": 1e3 * wall / rep["decode_steps"],
          "tokens_out_per_s": rep["tokens_out"] / wall,
          "tokens_processed_per_s":
              (rep["tokens_out"] + rep["prefill_tokens"]) / wall,
          "launches": launches, "peak_mem_gb": peak_gb,
          "prefix_hit_rate": rep["prefix_hit_rate"],
          "replay_streams_equal": True,
          "first_tokens": {rid: out[:4] for rid, out in streams.items()},
          "profile": prof, "device_ms_per_tick_by_part": parts})
    return launches, timing


def moe_row_timing(eng, best, dev) -> dict:
    """The paged kernel at qwen3-moe's decode geometry (q [4, 16, 4, 8,
    128] bf16, the widest busy tick of the moe run on its layer-0 pool):
    every row (the moe path) against the live rows only (the dense path's
    economy), each beside its bound; the plain version and SDPA compute
    every row."""
    _, pos, n_new, page_table = best
    cfg = eng.model.cfg
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kv
    k_pool, v_pool = eng.view.k[0], eng.view.v[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((SLOTS, CHUNK, kv, g, hd), generator=gen,
                    device=dev).to(k_pool.dtype)
    args = (q, k_pool, v_pool, page_table, pos, n_new)
    err, rel = compare(args, TOL[q.dtype], all_rows=True)
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    qs, ks, vs, mask = sdpa_args(*args[:5])
    out = {"shape": list(q.shape), "dtype": str(q.dtype)[6:],
           "pos": pos.tolist(), "n_new": n_new.tolist(),
           "design": paged_design(q.dtype, CHUNK, g, hd),
           "splits": paged_splits(SLOTS, CHUNK, kv, g, hd, k_pool.shape[1],
                                  page_table.shape[1], q.dtype),
           "max_abs_err": err, "rel_norm_err": rel}
    for all_rows in (False, True):
        key = "all_rows" if all_rows else "live_rows"
        bound, by, _, _ = bound_ms(q, page_table, pos, n_new, k_pool,
                                   all_rows)
        out[key] = {"ms": time_cold(lambda: paged_attention_cuda(
            *args, all_rows=all_rows), dev), "bound_ms": bound,
            "bound_by": by}
    out["plain_ms"] = time_cold(lambda: paged_attention_plain(*args), dev)
    out["library_ms"] = time_cold(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True), dev)
    out["ms"], out["bound_ms"] = (out["all_rows"]["ms"],
                                  out["all_rows"]["bound_ms"])
    out["bound_by"] = out["all_rows"]["bound_by"]
    emit({"phase": "moe_timing", **out, "gpu": nvidia_smi()})
    return out


class _RoutedTorch:
    """``torch`` as ``models/moe.py`` sees it, with ``topk`` recorded or
    replayed: each router call's indices are appended to ``recorded`` in
    layer order; with ``pinned`` given, call i takes ``pinned[i]`` for its
    indices and gathers its gate weights from its own probabilities."""

    def __init__(self, pinned=None):
        self.pinned = pinned
        self.recorded: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, probs, k, dim=-1):
        if self.pinned is None:
            vals, idx = torch.topk(probs, k, dim=dim)
        else:
            idx = self.pinned[len(self.recorded)]
            vals = probs.gather(dim, idx)
        self.recorded.append(idx.detach())
        return vals, idx


@contextlib.contextmanager
def moe_routes(pinned=None):
    """The moe router's top-k through ``_RoutedTorch``, swapped in on the
    smoke side (the package has no switch); yields the recorded indices."""
    from repro_torch.models import moe
    routed = _RoutedTorch(pinned)
    saved, moe.torch = moe.torch, routed
    try:
        yield routed.recorded
    finally:
        moe.torch = saved


@contextlib.contextmanager
def moe_layer_outputs():
    """Each layer's attention output and moe output, in layer order, as
    the model's blocks compute them (recorded by wrappers swapped into the
    stack module on the smoke side)."""
    from repro_torch.models import stack
    outs = {"attention": [], "moe": []}
    saved = stack.full_attention, stack.moe_ffn

    def attention(*args, **kw):
        y = saved[0](*args, **kw)
        outs["attention"].append(y.detach())
        return y

    def moe_ffn(*args, **kw):
        y, aux = saved[1](*args, **kw)
        outs["moe"].append(y.detach())
        return y, aux

    stack.full_attention, stack.moe_ffn = attention, moe_ffn
    try:
        yield outs
    finally:
        stack.full_attention, stack.moe_ffn = saved


def route_flips(got, want) -> list[int]:
    """Per layer, the tokens whose top-k expert set differs."""
    return [int((a.sort(dim=-1).values != b.sort(dim=-1).values)
                .any(dim=-1).sum()) for a, b in zip(got, want)]


def phase_moe_train_parity(dev) -> None:
    """Reduced granite-moe, seq 256, batch 1: the loss and every gradient
    through the flash kernel against the same step with the plain version
    on the card.  Held within ``GRAD_TOL`` in f32.  In bf16 each layer's
    route flips are counted (tokens whose top-k set differs between the two
    steps), and the plain step is run again with the kernel step's routes
    pinned (its gate weights from its own probabilities): that pinned step's
    loss and every gradient are held within ``GRAD_TOL`` of the kernel
    step's, and each layer's attention and moe outputs are compared, the
    first layer past ``TOL`` (bf16) named."""
    cfg = reduced(ALL_ARCHS[MOE_TRAIN_ARCH])
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    batch = model.sample_batch(ShapeConfig("parity", "train", PARITY_SEQ, 1),
                               SEED, dev)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = P.tree_map(lambda t: t if t.dtype == torch.float32 else
                       t.to(dtype), params)
        ops.reset_launches()
        with moe_routes() as top_k, moe_layer_outputs() as outs_k:
            loss_k, grads_k = loss_and_grads(model, p, batch)
        launches = ops.LAUNCHES["flash_attention"]
        with plain_flash(), moe_routes() as top_p:
            loss_p, grads_p = loss_and_grads(model, p, batch)
        torch.cuda.synchronize()
        check(launches == cfg.n_layers,
              f"moe: flash_attention launched {launches} times, expected "
              f"one per layer ({cfg.n_layers})")
        check(len(top_k) == len(top_p) == cfg.n_layers,
              f"moe: {len(top_k)} and {len(top_p)} router calls, expected "
              f"one per layer ({cfg.n_layers})")
        errs = [rel_norm(a, b) for a, b in zip(grads_k, grads_p)]
        entry = {
            "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
            "loss_rel_err": rel_norm(loss_k, loss_p),
            "grad_max_rel_norm_err": max(errs), "flash_launches": launches,
            "flash_design": flash_design(dtype, cfg.resolved_head_dim),
            "tokens": int(top_k[0].shape[0]),
            "route_flips_per_layer": route_flips(top_k, top_p)}
        if dtype == torch.bfloat16:
            with plain_flash(), moe_routes(pinned=top_k) as top_pp, \
                    moe_layer_outputs() as outs_pp:
                loss_pp, grads_pp = loss_and_grads(model, p, batch)
            torch.cuda.synchronize()
            check(route_flips(top_k, top_pp) == [0] * cfg.n_layers,
                  "moe: the pinned step did not take the kernel's routes")
            layers = [{"layer": i,
                       "attention": rel_norm(outs_k["attention"][i],
                                             outs_pp["attention"][i]),
                       "moe": rel_norm(outs_k["moe"][i], outs_pp["moe"][i])}
                      for i in range(cfg.n_layers)]
            entry["pinned"] = {
                "loss_plain": float(loss_pp),
                "loss_rel_err": rel_norm(loss_k, loss_pp),
                "grad_max_rel_norm_err": max(
                    rel_norm(a, b) for a, b in zip(grads_k, grads_pp)),
                "layers": layers,
                "first_layer_past_band": next(
                    (row["layer"] for row in layers
                     if max(row["attention"], row["moe"]) > TOL[dtype]),
                    None)}
        res[str(dtype)[6:]] = entry
    f32, pinned = res["float32"], res["bfloat16"]["pinned"]
    check(f32["loss_rel_err"] <= GRAD_TOL
          and f32["grad_max_rel_norm_err"] <= GRAD_TOL,
          f"moe gradients through the kernel vs plain: {f32}")
    check(pinned["loss_rel_err"] <= GRAD_TOL
          and pinned["grad_max_rel_norm_err"] <= GRAD_TOL,
          f"moe bf16 gradients with the routes pinned: {pinned}")
    emit({"phase": "moe_train_parity", "arch": cfg.name,
          "layers": cfg.n_layers, "seq": PARITY_SEQ, "batch": 1,
          "grad_leaves": len(grads_k), "tolerance": GRAD_TOL,
          "held": ["float32", "bfloat16 with the routes pinned"], **res})


def phase_moe_train(dev) -> dict:
    """granite-moe-1b-a400m at full width and depth (1.33 B parameters),
    seq 2048, batch 4, remat full, the first 4 steps of the default
    schedule: finite losses and router aux, the flash kernel launched twice
    a layer a step (counts zeroed just before); one more step under
    ``torch.profiler`` with the device ms under the moe spans."""
    cfg = ALL_ARCHS[MOE_TRAIN_ARCH]
    _, step_fn, batches, fresh = train_setup(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                             TRAIN_STEPS, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = fresh()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(state.params))
    ops.reset_launches()
    metrics = []
    state, losses, step_s = run_steps(step_fn, state, batches[:TRAIN_STEPS],
                                      dev, metrics)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    aux = [m["moe_aux"] for m in metrics]
    check(all(np.isfinite(losses)), f"moe: non-finite loss {losses}")
    check(len(aux) == TRAIN_STEPS and all(np.isfinite(aux)),
          f"moe: router aux {aux}")
    expected = 2 * cfg.n_layers * TRAIN_STEPS
    check(launches["flash_attention"] == expected,
          f"moe: flash_attention launched {launches['flash_attention']} "
          f"times, expected 2 x layers x steps = {expected}")
    check(launches["paged_attention"] == 0, "paged attention ran in training")
    design = flash_design(getattr(torch, cfg.dtype), cfg.resolved_head_dim)
    check(design == "mma", f"the moe training call took the {design} design")
    steady_ms = statistics.median(step_s[1:]) * 1e3
    state, device_ms, by_kind, top, spans = profiled_step(
        step_fn, state, batches[TRAIN_STEPS], dev,
        MOE_SPANS + ("adamw_update",))
    del state
    tokens = TRAIN_SEQ * TRAIN_BATCH
    emit({"phase": "moe_train", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts": cfg.n_experts,
          "top_k": cfg.top_k, "params": n_params,
          "active_params": cfg.active_param_count(), "seq": TRAIN_SEQ,
          "batch": TRAIN_BATCH, "remat": "full", "init_s": init_s,
          "losses": losses, "moe_aux": aux,
          "loss_fell": losses[-1] < losses[0],
          "step_ms": [1e3 * t for t in step_s],
          "steady_ms_per_step": steady_ms,
          "tokens_per_s": tokens / steady_ms * 1e3, "peak_mem_gb": peak_gb,
          "launches": launches, "flash_design": design,
          "profile": {"device_ms_per_step": device_ms,
                      "device_busy_share": device_ms / steady_ms,
                      "span_ms": spans, "ms_by_kind": by_kind,
                      "top_kernels_ms": top}})
    return launches


# ------------------------------------------------------------ vlm, encdec

VLM_ARCH, ENCDEC_ARCH = "llama-3.2-vision-11b", "whisper-medium"
# the reference phases' lengths, multiples of 128 so every self-attention
# takes the flash kernel: vlm tokens, whisper frames (16 decoder tokens)
FAMILY_REF_LEN, FAMILY_REF_STEPS = 128, 4
# serving: prompts a prefill (against 1,600 image tokens or 1,500 frames)
FAMILY_PROMPT = {"vlm": 512, "encdec": 64}
FAMILY_PREFILL_BATCH, FAMILY_DECODE_STEPS = 2, 32
# decode vs teacher-forced forward, bf16: tests/test_archs.py::
# test_prefill_decode_consistency's 3e-2, of the largest |logit|
CONSISTENCY_TOL = 3e-2
# training: vlm cut to one group (5 self layers, 1 cross block), whisper
# whole; (sequence, batch): vlm tokens, whisper frames (448 decoder tokens)
FAMILY_TRAIN = {"vlm": (2048, 4), "encdec": (1500, 8)}
FAMILY_TRAIN_STEPS = 4


def draw_gates(params: dict, seed: int) -> None:
    """Each vlm gate drawn nonzero from the seed, in place: |gate| in [0.5,
    1.5), either sign.  At init the gates are zero, every cross block is
    then the identity and its path would carry no check."""
    if "gate_attn" not in params.get("cross", {}):
        return
    gen = torch.Generator().manual_seed(seed)
    for name in ("gate_attn", "gate_mlp"):
        t = params["cross"][name]
        mag = torch.rand(t.shape, generator=gen) + 0.5
        sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
        t.copy_(mag * sign)


@contextlib.contextmanager
def flash_launches_by_mode():
    """The flash kernel's launches, counted by mode, for the model's calls
    made inside: each call's mode is kept with the launches it added to
    ``ops.LAUNCHES``, so a call that runs the plain version counts none."""
    counts = {"causal": 0, "bidirectional": 0}
    saved = ops.flash_attention

    def counted(q, k, v, *, causal=True):
        before = ops.LAUNCHES["flash_attention"]
        out = saved(q, k, v, causal=causal)
        counts["causal" if causal else "bidirectional"] += (
            ops.LAUNCHES["flash_attention"] - before)
        return out

    ops.flash_attention = counted
    try:
        yield counts
    finally:
        ops.flash_attention = saved


def expected_flash(cfg, ctx_len: int, tok_len: int) -> dict[str, int]:
    """Flash launches of one forward: each self-attention whose length
    meets the flash condition (``S % min(128, S) == 0``), the decoder's
    (and the vlm's) causal, the encoder's over ``ctx_len`` frames not."""
    def flash(n):
        return n % min(128, n) == 0
    enc = cfg.n_encoder_layers if cfg.family == "encdec" else 0
    return {"causal": cfg.n_layers if flash(tok_len) else 0,
            "bidirectional": enc if flash(ctx_len) else 0}


def embed_name(cfg) -> str:
    return "image_embed" if cfg.family == "vlm" else "audio_embed"


def family_ref_run(model, params, batch, dev) -> tuple:
    """Loss and every gradient, then ``prefill`` and ``FAMILY_REF_STEPS``
    ``decode_step`` calls on seeded tokens: (loss, grads, logits of each
    call)."""
    loss, grads = loss_and_grads(model, params, batch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    s = prompt["tokens"].shape[1]
    logits, cache = model.prefill(params, prompt, s + FAMILY_REF_STEPS)
    out = [logits]
    toks = np.random.default_rng(SEED + 2).integers(
        0, model.cfg.vocab_size, size=(FAMILY_REF_STEPS, 2, 1))
    for i in range(FAMILY_REF_STEPS):
        out.append(model.decode_step(
            params, cache, torch.tensor(toks[i], device=dev),
            torch.full((2,), s + i, dtype=torch.int32, device=dev)))
    return loss, grads, out


def phase_family_reference(arch, dev) -> dict:
    """Reduced ``arch`` in f32, every gate drawn nonzero: the loss, every
    gradient, ``prefill`` and four ``decode_step`` calls through the flash
    kernel, against the same run with the plain version called on the card
    (``plain_flash``): loss and gradients within ``GRAD_TOL`` (relative
    norm, phase train_parity's), logits within 1e-3 (phase reference's).
    Lengths are ``FAMILY_REF_LEN``, so every self-attention launches the
    kernel: causal for the vlm's and the decoder's, bidirectional for the
    whisper encoder's."""
    cfg = reduced(ALL_ARCHS[arch])
    model = build(cfg)
    params = P.tree_map(lambda t: t.float(), model.init_params(
        torch.Generator(device=dev).manual_seed(SEED), dev))
    draw_gates(params, SEED)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in model.sample_batch(ShapeConfig(
                 "ref", "train", FAMILY_REF_LEN, 2), SEED, dev).items()}
    with flash_launches_by_mode() as launches:
        loss_k, grads_k, logits_k = family_ref_run(model, params, batch, dev)
    with plain_flash():
        loss_p, grads_p, logits_p = family_ref_run(model, params, batch, dev)
    torch.cuda.synchronize()
    tok_len = batch["tokens"].shape[1]
    one = expected_flash(cfg, FAMILY_REF_LEN, tok_len)
    want = {mode: 2 * n for mode, n in one.items()}   # the loss and prefill
    check(launches == want, f"{arch}: flash launches {launches}, expected "
                            f"{want} (one forward and one prefill)")
    loss_err = rel_norm(loss_k, loss_p)
    grad_errs = [rel_norm(a, b) for a, b in zip(grads_k, grads_p)]
    logit_err = max(float((a - b).abs().max())
                    for a, b in zip(logits_k, logits_p))
    check(bool(torch.isfinite(loss_k)) and loss_err <= GRAD_TOL,
          f"{arch}: loss through the kernel {float(loss_k)} vs plain "
          f"{float(loss_p)}")
    check(max(grad_errs) <= GRAD_TOL,
          f"{arch}: gradients through the kernel vs plain: max rel "
          f"{max(grad_errs)}")
    check(all(bool(torch.isfinite(t).all()) and t.shape == (
        2, cfg.padded_vocab) for t in logits_k),
          f"{arch}: prefill/decode logits not finite or misshapen")
    check(logit_err <= 1e-3, f"{arch}: prefill/decode logits through the "
                             f"kernel vs plain: max |dlogit| {logit_err}")
    out = {"phase": f"{cfg.family}_reference", "arch": cfg.name,
           "dtype": "float32", "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers, "tokens": tok_len,
           "context": (cfg.n_image_tokens if cfg.family == "vlm"
                       else FAMILY_REF_LEN),
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_err": loss_err, "grad_leaves": len(grad_errs),
           "grad_max_rel_norm_err": max(grad_errs), "grad_tolerance": GRAD_TOL,
           "decode_steps": FAMILY_REF_STEPS,
           "max_abs_logit_err": logit_err, "logit_tolerance": 1e-3,
           "flash_launches": launches}
    emit(out)
    return launches


def consistency(got, want) -> tuple[bool, float, float]:
    """``got`` within ``CONSISTENCY_TOL`` of ``want``'s largest |logit|,
    and each row's argmax equal unless ``want``'s top two lie within twice
    that.  tests/test_archs.py's band is per element (3e-2 + 3e-2|logit|),
    which bf16 misses on small logits: the hidden state's rounding moves
    every logit by an amount set by the largest (the reference misses it
    on its own tree, ROADMAP caveat b, and so does the port at reduced size
    in 1 of 1,024 logits at 16 tokens; both agree within 2e-6 in f32).
    Returns (ok, max |dlogit|, the share of logits inside the per-element
    band)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = CONSISTENCY_TOL * float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    near_tie = top2[:, 0] - top2[:, 1] <= 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    inside = float((err <= CONSISTENCY_TOL * (1 + want.abs())).float().mean())
    return (float(err.max()) <= tol and bool((same | near_tie).all()),
            float(err.max()), inside)


def family_prompt_batch(model, dev) -> dict:
    """``FAMILY_PREFILL_BATCH`` prompts of ``FAMILY_PROMPT`` tokens with
    their context: 1,600 image tokens or 1,500 audio frames, seeded."""
    cfg = model.cfg
    n = FAMILY_PROMPT[cfg.family]
    ctx = cfg.n_audio_frames if cfg.family == "encdec" else n
    batch = model.sample_batch(ShapeConfig("p", "prefill", ctx,
                                           FAMILY_PREFILL_BATCH), SEED, dev)
    batch["tokens"] = batch["tokens"][:, :n].contiguous()
    return batch


def phase_family_serve(arch, dev) -> dict:
    """``arch`` at full width and depth, seeded bf16 weights, every gate
    drawn nonzero: two prefills of the prompt batch (warm, then timed, its
    flash launches counted), ``FAMILY_DECODE_STEPS`` greedy ``decode_step``
    calls, the first one's logits held to a teacher-forced forward of the
    prompt and its token (``consistency``); then the contiguous
    ``ServeEngine`` on four requests of 32-64 tokens, 16 new each."""
    cfg = ALL_ARCHS[arch]
    model = build(cfg)
    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    draw_gates(params, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - phase_t0
    batch = family_prompt_batch(model, dev)
    n = batch["tokens"].shape[1]
    cache_len = n + FAMILY_DECODE_STEPS + 1
    model.prefill(params, batch, cache_len)               # warm-up
    torch.cuda.synchronize()
    with flash_launches_by_mode() as launches:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    want = expected_flash(cfg, batch[embed_name(cfg)].shape[1], n)
    check(launches == want, f"{arch}: prefill flash launches {launches}, "
                            f"expected {want}")
    tok = logits.argmax(-1)[:, None]
    first_tok = tok
    t0 = time.perf_counter()
    steps = []
    for i in range(FAMILY_DECODE_STEPS):
        step_logits = model.decode_step(
            params, cache, tok,
            torch.full((tok.shape[0],), n + i, dtype=torch.int32,
                       device=dev))
        if i == 0:
            first = step_logits
        tok = step_logits.argmax(-1)[:, None]
        steps.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out_toks = torch.cat(steps, 1)
    check(bool(torch.isfinite(first).all())
          and bool(((out_toks >= 0) & (out_toks < cfg.padded_vocab)).all()),
          f"{arch}: decode gave non-finite logits or tokens outside the "
          f"vocab")
    with torch.no_grad():
        forced = dict(batch, tokens=torch.cat([batch["tokens"], first_tok], 1))
        full, _ = stack.forward(cfg, params, forced)
    ok, err, inside = consistency(first, full[:, -1])
    scale = float(full[:, -1].abs().max())
    check(ok, f"{arch}: first decode step vs teacher-forced forward: max "
              f"|dlogit| {err} against {CONSISTENCY_TOL} of the logit scale "
              f"{scale}, or argmax apart")
    del full, cache, forced

    warm = ServeEngine(model, params, slots=1, max_len=32, device=dev)
    warm.run([Request(rid=0, prompt=list(range(8)), max_new=2)])
    del warm
    before = torch.cuda.memory_allocated()
    eng = ServeEngine(model, params, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                      device=dev)
    reqs = ssm_requests(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng_launches = dict(ops.LAUNCHES)
    rep = eng.report()
    check(rep["served"] == SSM_REQUESTS and rep["engine"] == "contiguous",
          f"{arch}: {rep}")
    for r in done:
        check(len(r.out) == SSM_MAX_NEW and all(
            0 <= t < cfg.padded_vocab for t in r.out),
            f"{arch}: request {r.rid} gave {r.out}")
    check(not any(eng_launches.values()),
          f"{arch}: the contiguous engine launched {eng_launches}")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    engine_steps = prompt_tokens + rep["decode_steps"]
    del eng
    check_freed(before, f"the {arch} engine")
    b = FAMILY_PREFILL_BATCH
    out = {"phase": f"{cfg.family}_serve", "arch": cfg.name,
           "params": sum(t.numel() for t in P.leaves(params)),
           "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
           "d_model": cfg.d_model, "init_s": init_s,
           "prompts": b, "prompt_tokens": n,
           "context": batch[embed_name(cfg)].shape[1],
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": b * n / prefill_s,
           "prefill_flash_launches": launches,
           "decode_steps": FAMILY_DECODE_STEPS,
           "decode_ms_per_step": 1e3 * decode_s / FAMILY_DECODE_STEPS,
           "decode_tokens_per_s": b * FAMILY_DECODE_STEPS / decode_s,
           "consistency_max_abs_err": err, "logit_scale": scale,
           "consistency_tol_of_scale": CONSISTENCY_TOL,
           "share_inside_per_element_band": inside,
           "engine": {"requests": SSM_REQUESTS, "slots": SSM_SLOTS,
                      "prompt_tokens": prompt_tokens, "wall_s": wall,
                      "engine_steps": engine_steps,
                      "ms_per_step": 1e3 * wall / engine_steps,
                      "tokens_out_per_s": rep["tokens_out"] / wall,
                      "launches": eng_launches,
                      "first_tokens": {r.rid: r.out[:4] for r in done}},
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "phase_s": time.perf_counter() - phase_t0}
    emit(out)
    return launches


def phase_family_train(arch, dev) -> dict:
    """``arch`` at full width (the vlm cut to one group: 5 self layers and
    one cross block), remat full, the first ``FAMILY_TRAIN_STEPS`` steps of
    the default schedule: tokens and labels from the port's
    ``DataPipeline`` (whisper's 448 decoder tokens), image or audio
    embeddings from ``Model.sample_batch``, every gate drawn nonzero.
    Finite losses; the flash kernel's launches counted (counts zeroed just
    before): twice a self layer a step where the length meets the flash
    condition, so none for whisper's 1,500 frames and 448 tokens; one more
    step under ``torch.profiler``."""
    cfg = ALL_ARCHS[arch]
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=cfg.cross_every)
    seq, b = FAMILY_TRAIN[cfg.family]
    tok_len = cfg.decoder_train_len if cfg.family == "encdec" else seq
    model = build(cfg)
    step_fn = make_train_step(model, RunConfig(
        cfg, ShapeConfig("train", "train", seq, b), TrainConfig(remat="full")))
    data = DataPipeline(DataConfig(cfg.vocab_size, tok_len, b, seed=SEED))
    batches = []
    for i in range(FAMILY_TRAIN_STEPS + 1):
        host = dict(next(data)[1])
        host[embed_name(cfg)] = model.sample_batch(
            ShapeConfig("train", "train", seq, b), SEED + i,
            "cpu")[embed_name(cfg)]
        batches.append(host)
    data.close()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    draw_gates(state.params, SEED)
    draw_gates(state.opt.master, SEED)    # AdamW's fp32 copy, the same draw
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in P.leaves(state.params))
    ops.reset_launches()
    with flash_launches_by_mode() as by_mode:
        state, losses, step_s = run_steps(
            step_fn, state, batches[:FAMILY_TRAIN_STEPS], dev)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(np.isfinite(losses)), f"{arch}: non-finite loss {losses}")
    one = expected_flash(cfg, seq, tok_len)
    want = {mode: 2 * n * FAMILY_TRAIN_STEPS for mode, n in one.items()}
    check(by_mode == want and launches["flash_attention"] == sum(
        want.values()), f"{arch}: flash launches {by_mode}, expected {want} "
                        f"(forward and remat recompute)")
    check(launches["paged_attention"] == 0, "paged attention ran in training")
    steady_ms = statistics.median(step_s[1:]) * 1e3
    state, device_ms, by_kind, top, spans = profiled_step(
        step_fn, state, batches[FAMILY_TRAIN_STEPS], dev, ("adamw_update",))
    del state
    emit({"phase": f"{cfg.family}_train", "arch": cfg.name,
          "layers": cfg.n_layers, "encoder_layers": cfg.n_encoder_layers,
          "d_model": cfg.d_model, "params": n_params,
          "seq": seq, "tokens": tok_len, "batch": b, "remat": "full",
          "init_s": init_s, "losses": losses,
          "loss_fell": losses[-1] < losses[0],
          "step_ms": [1e3 * t for t in step_s],
          "steady_ms_per_step": steady_ms,
          "tokens_per_s": tok_len * b / steady_ms * 1e3,
          "context_per_s": seq * b / steady_ms * 1e3,
          "peak_mem_gb": peak_gb, "flash_launches": by_mode,
          "launches": launches,
          "profile": {"device_ms_per_step": device_ms,
                      "device_busy_share": device_ms / steady_ms,
                      "flash_kernel_ms_per_step": by_kind.get(
                          "flash_attention", 0.0),
                      "span_ms": spans, "ms_by_kind": by_kind,
                      "top_kernels_ms": top}})
    return by_mode


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    phase_kernel(dev)
    phase_moe_kernel(dev)
    phase_flash_kernel(dev)
    phase_hh_kernel(dev)
    phase_cable_epoch_kernel(dev)
    phase_reference(dev)
    phase_moe_reference(dev)
    phase_gather(dev)
    model, params, replay, best, launches, paged = phase_serve(dev)
    err, timing = phase_parity_and_timing(replay, best, dev)
    del replay, best
    paged_timing = phase_paged_timing(dev)
    phase_profile(model, params, dev)
    phase_gather_serve(model, params, paged, dev)
    cluster_launches = phase_cluster(model, params, dev)
    phase_serve_cli()
    del model, params
    torch.cuda.empty_cache()
    moe_serve_launches, moe_timing = phase_moe_serve(dev)
    torch.cuda.empty_cache()
    phase_train_parity(dev)
    phase_moe_train_parity(dev)
    torch.cuda.empty_cache()
    train_launches, _ = phase_train(dev)
    torch.cuda.empty_cache()
    moe_train_launches = phase_moe_train(dev)
    torch.cuda.empty_cache()
    cli_full, cli_manifest, cli_launches = phase_train_cli()
    with running_examples() as procs:
        phase_train_cli_env(cli_full, cli_manifest)
        env_launches = phase_env_manifest(dev)
        examples = phase_examples(procs)
    torch.cuda.empty_cache()
    family = {}
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        family[arch] = {"reference": phase_family_reference(arch, dev)}
        torch.cuda.empty_cache()
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        family[arch]["serve_prefill"] = phase_family_serve(arch, dev)
        torch.cuda.empty_cache()
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        family[arch]["train"] = phase_family_train(arch, dev)
        torch.cuda.empty_cache()
    flash_err, flash = phase_flash_timing(dev)
    torch.cuda.empty_cache()
    phase_ssd_kernel(dev)
    for arch in (SSM_ARCH, HYBRID_ARCH):
        phase_stateful_serve(arch, dev)
        torch.cuda.empty_cache()
    phase_ssm_train_parity(dev)
    ssm_launches = phase_ssm_train(dev)
    torch.cuda.empty_cache()
    ssd_err, ssd = phase_ssd_timing(dev)
    torch.cuda.empty_cache()
    hh_launches = phase_epoch_hold(dev)
    epoch_launches, _ = phase_neuro(dev)
    rank_launches = phase_ring_ranks(dev)
    torch.cuda.empty_cache()
    tp_launches = phase_tp_train(ARCH, "tp_train")
    ep_launches = phase_tp_train(MOE_TRAIN_ARCH, "moe_ep_train")
    cp_launches = phase_cp_train()
    hh_err, hh = phase_hh_timing(dev)
    epoch_err, epoch = phase_cable_epoch_timing(dev)
    rows = {"paged_attention": (launches["paged_attention"], err, timing),
            "flash_attention": (train_launches["flash_attention"], flash_err,
                                flash),
            "ssd_scan": (ssm_launches["ssd_scan"], ssd_err, ssd),
            "hh_step": (hh_launches, hh_err, hh)}
    # the HH row's redesign: the epoch kernel, one launch an epoch on the
    # ring's path (hh_step's launches are the epoch hold's cable.step path)
    extra = {"paged_attention": {
        "cluster_launches": cluster_launches,
        "example_launches": {
            "serve_lm": examples["serve_lm"]["launches"]["paged_attention"]},
        "moe_launches": moe_serve_launches["paged_attention"],
        "moe_all_rows": {key: moe_timing[key] for key in (
            "shape", "design", "splits", "max_abs_err", "all_rows",
            "live_rows", "plain_ms", "library_ms")},
        "design": timing["design"], "launch_floor_ms": timing["launch_floor_ms"],
        "sweep_fixed_ms": paged_timing["sweep_fixed_ms"],
        "sweep_ms_per_page": paged_timing["sweep_ms_per_page"],
        "paged_timing": [{key: sh[key] for key in (
            "arch", "shape", "n_new", "design", "splits", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
            for sh in paged_timing["shapes"]]},
        "flash_attention": {
        "train_cli_launches": cli_launches["flash_attention"],
        "env_manifest_launches": env_launches["flash_attention"],
        "example_launches": {name: ex["launches"]["flash_attention"]
                             for name, ex in examples.items()
                             if "flash_attention" in EXAMPLES[name][0]},
        "moe_launches": moe_train_launches["flash_attention"],
        "vlm_launches": family[VLM_ARCH],
        "encdec_launches": family[ENCDEC_ARCH],
        "tp_train_launches": tp_launches,
        "moe_ep_train_launches": ep_launches,
        "cp_train_launches": {
            arch: {key: [n["flash_attention"] for n in by_rank]
                       for key, by_rank in by_mesh.items()}
            for arch, by_mesh in cp_launches.items()
            if arch == HYBRID_ARCH}},
        "ssd_scan": {"cp_train_launches": {
            arch: {key: [n["ssd_scan"] for n in by_rank]
                       for key, by_rank in by_mesh.items()}
            for arch, by_mesh in cp_launches.items()}},
        "hh_step": {
        "epoch_kernel": "cable_epoch", "epoch_launches": epoch_launches,
        "epoch_example_launches": {"ring_simulation": examples[
            "ring_simulation"]["launches"]["cable_epoch"]},
        "ring_ranks_launches": {f"world_{world}": by_rank for world, by_rank
                                in rank_launches.items()},
        "epoch_ms": epoch["ms"], "epoch_plain_ms": epoch["plain_ms"],
        "epoch_bound_ms": epoch["bound_ms"],
        "epoch_bound_by": epoch["bound_by"], "epoch_max_abs_err": epoch_err}}
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
        "replaces": KERNEL_REPLACES[name], "launches": n,
        "max_abs_err": e, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], **extra.get(name, {})}
        for name, (n, e, t) in rows.items()],
        "seconds": round(time.perf_counter() - t0, 1)})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["ring_rank"]:
        sys.exit(ring_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["tp_rank"]:
        sys.exit(tp_rank(*sys.argv[2:6]))
    if sys.argv[1:2] == ["profile_pressure"]:
        sys.exit(profile_pressure())
    sys.exit(main())
