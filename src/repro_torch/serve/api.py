"""Unified request-lifecycle serving API.

The port's own copy of ``repro.serve.api`` (pure Python).  ``LaneState.
as_args`` hands back numpy arrays; the engines turn them into fresh
tensors on their device every tick.

Every caller — launchers, examples, benchmarks, the audit pipeline —
speaks one contract to either serving backend, the way the paper's
container interface hides backend divergence behind a single stable
user-facing surface:

- ``SamplingParams``: per-request decoding policy (greedy, temperature,
  top-k, top-p).  Sampled decoding is *counter-based*: the PRNG key for a
  request's ``step``-th output token is derived purely from
  ``(seed, request_id, step)``, never from engine state — so a stream is
  deterministic and replayable across engines, slots, schedules, and
  preemption/recompute cycles (re-running a step re-derives the same key;
  there is no generator state to advance or restore).
- ``RequestHandle``: one submitted request's lifecycle — a streaming
  token iterator, ``result()`` to drain to completion, and ``cancel()``
  (mid-prefill or mid-decode; the engine releases the slot, pages, and
  prefix-cache references).
- ``Engine``: the structural protocol both ``ServeEngine`` and
  ``PagedServeEngine`` implement — ``submit / step / drain / cancel /
  has_work / report``.  The two incompatible seed ``run()`` shapes are
  retired behind the ``run_requests`` compatibility shim.
- ``LaneState``: the host-side mirror of per-slot sampling state handed
  to the jitted fused decode+sample step (``models.decode.
  sample_from_logits``) — fixed ``[slots]`` arrays, so sampling adds no
  shape polymorphism and no recompiles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Protocol, runtime_checkable

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy.

    ``temperature <= 0`` selects greedy argmax (the default, and the
    oracle-gated legacy behaviour).  ``top_k <= 0`` means no k-limit;
    ``top_p`` is the nucleus bound in ``(0, 1]``.  ``seed`` roots the
    counter-based key derivation — two requests with the same seed but
    different request ids draw decorrelated streams, the same
    (seed, rid) replays the identical stream anywhere.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 <= self.seed < 2**31:
            # the seed rides an int32 lane array into the jitted step;
            # fail at construction, not mid-serve (fold a wider hash
            # down before passing it in)
            raise ValueError(f"seed must be in [0, 2**31), got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def describe(self) -> str:
        """Compact trace-payload form (deterministic, replay-comparable)."""
        if self.greedy:
            return "greedy"
        return (f"t={self.temperature:g},k={self.top_k},"
                f"p={self.top_p:g},seed={self.seed}")


GREEDY = SamplingParams()


class LaneState:
    """Per-slot sampling state mirrored into the jitted step.

    Fixed-shape ``[slots]`` arrays (the jit signature never changes with
    the request mix).  ``step`` is the index of the output token about to
    be sampled — because keys are pure functions of (seed, rid, step),
    lanes whose sampled token is discarded (mid-prefill chunks, idle
    slots, recompute after preemption) consume nothing: the stream has no
    state to advance.
    """

    def __init__(self, slots: int):
        self.rid = np.zeros((slots,), np.int32)
        self.step = np.zeros((slots,), np.int32)
        self.seed = np.zeros((slots,), np.int32)
        self.temperature = np.zeros((slots,), np.float32)
        self.top_k = np.zeros((slots,), np.int32)
        self.top_p = np.ones((slots,), np.float32)

    def set(self, slot: int, req: Any) -> None:
        sp = req.sampling or GREEDY
        self.rid[slot] = req.rid
        self.step[slot] = len(req.out)
        self.seed[slot] = sp.seed
        self.temperature[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p

    def clear(self, slot: int) -> None:
        self.rid[slot] = 0
        self.step[slot] = 0
        self.seed[slot] = 0
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0

    def as_args(self) -> dict[str, np.ndarray]:
        return {"rid": self.rid, "step": self.step, "seed": self.seed,
                "temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p}


# ================================================================ protocol


@runtime_checkable
class Engine(Protocol):
    """The common serving contract.  ``submit`` registers a request (it
    starts no work) and returns its handle; ``step`` advances the engine
    by one scheduling tick + one batched model call and returns requests
    finishing this tick; ``drain`` steps until idle; ``cancel`` releases
    a request at any lifecycle stage; ``report`` is the engine's
    machine-readable counters (audit evidence)."""

    def submit(self, req: Any, *, arrival: float | None = None
               ) -> "RequestHandle": ...

    def step(self) -> list: ...

    def drain(self) -> list: ...

    def cancel(self, handle: "RequestHandle") -> bool: ...

    def has_work(self) -> bool: ...

    def report(self) -> dict: ...


class RequestHandle:
    """One submitted request's lifecycle, bound to its engine.

    Iterating the handle streams tokens as the engine produces them
    (pulling ``engine.step()`` under the hood, which also advances every
    other active request — streaming one handle starves nobody).
    """

    def __init__(self, engine: Engine, req: Any, entry: Any = None):
        self.engine = engine
        self.req = req
        self.entry = entry          # scheduler entry (paged engine only)
        self._cursor = 0

    # ------------------------------------------------------------- state
    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def cancelled(self) -> bool:
        return self.req.cancelled

    @property
    def finished(self) -> bool:
        return self.req.finished

    @property
    def done(self) -> bool:
        return self.req.finished or self.req.cancelled

    # --------------------------------------------------------- streaming
    def tokens(self) -> Iterator[int]:
        """Yield output tokens as they are decoded.  Safe to interleave
        with other handles' iteration or ``engine.step()`` calls: the
        cursor only moves forward over ``req.out``."""
        while True:
            out = self.req.out
            while self._cursor < len(out):
                tok = out[self._cursor]
                self._cursor += 1
                yield tok
            if self.done or not self.engine.has_work():
                return
            self.engine.step()

    __iter__ = tokens

    def result(self) -> Any:
        """Drive the engine until this request finishes (or is cancelled);
        returns the underlying request with its full output stream."""
        while not self.done and self.engine.has_work():
            self.engine.step()
        return self.req

    def cancel(self) -> bool:
        """Cancel at any stage (waiting, mid-prefill, mid-decode).  The
        engine releases the slot and every page/prefix-cache reference it
        held.  Returns False if the request already finished."""
        return self.engine.cancel(self)


# ============================================================ compat shim


def run_requests(engine: Engine, requests: list,
                 arrivals: list[float] | None = None) -> list:
    """The retired ``run(list)`` call shape as a thin shim over the
    lifecycle API — one signature for both engines.  Returns requests in
    completion order (cancelled requests never complete and are not
    returned)."""
    for i, req in enumerate(requests):
        engine.submit(req, arrival=arrivals[i] if arrivals else None)
    return engine.drain()
