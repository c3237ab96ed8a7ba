"""Deterministic synthetic token pipeline with host sharding + prefetch:
the port's own copy of ``repro.data.pipeline`` (pure numpy; copied, not
imported, so the port never loads the JAX package).  The same
``(seed, step, host)`` gives the same tokens in both packages.

Production shape: each host reads only its shard of the global batch
(host-data-parallel), batches are derived deterministically from
(seed, step) so a restarted job resumes byte-identically mid-epoch without
any shared iterator state — the data-side requirement for the
checkpoint/restart protocol.  A background thread keeps ``prefetch`` steps
ready so transient host stalls don't reach the collective (see
runtime/straggler.py).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _batch_for_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Deterministic (seed, step, host) -> token block.  Zipf-ish marginal
    over the vocab so losses behave like text rather than uniform noise."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    # smooth power-law ranks
    u = rng.random((b, s + 1))
    ranks = np.minimum((u ** -1.25 - 1).astype(np.int64), v - 1)
    tokens = ranks.astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class DataPipeline:
    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = _batch_for_step(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


def batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Random access (resume verification, tests)."""
    return _batch_for_step(cfg, step)
