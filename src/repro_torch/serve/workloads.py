"""Deterministic workload-trace generator for the serving benchmarks.

Real serving load is not a uniform stream of unrelated prompts: arrival
processes are bursty or diurnal with heavy-tailed think times, and the
prompts themselves carry shared-prefix structure the paged engine's
prefix cache exists to exploit.  This module generates such traces
*reproducibly* — every trace is a pure function of its ``WorkloadSpec``
(family, arrival process, sizes, seed), drawn from a single
``np.random.default_rng(seed)``, so the same spec yields byte-identical
prompts, priorities, and arrival ticks on every machine.  That makes the
traces usable as audit evidence: ``compare_engines`` gets its
token-identity verdict over them, and the SLO benchmark judges p99
latency counters against expectations that only hold if the trace is
the same one it was calibrated on.

Families (the shared-prefix shapes):

- ``chat``  — multi-tenant chat: each tenant has a fixed system prompt
  (the shared prefix); requests cycle over tenants with a fresh user
  suffix.  Prefix reuse is per-tenant — the cache must keep several
  warm chains alive at once.
- ``rag``   — retrieval-augmented generation: one giant common context
  shared by *every* request plus a short per-request query.  The
  best-case for prefix caching — one chain, hit on every admit.
- ``agent`` — tool-use loops: each agent re-submits its entire previous
  prompt plus a few new tokens every turn, so prompts grow and each
  turn's prefix is exactly the previous turn's prompt.  Requests are
  ordered round-robin over agents by turn so arrival order never asks
  for turn k before turn k-1.

Arrival processes (units: engine ticks, nondecreasing):

- ``uniform``    — fixed ``mean_gap`` spacing (the legacy shape).
- ``bursty``     — clusters of ``burst_size`` near-simultaneous arrivals
  separated by ``burst_gap`` quiet ticks: the overload shape that makes
  preemption matter.
- ``diurnal``    — exponential gaps whose rate is modulated by a
  sinusoid (period/amplitude): slow troughs, dense peaks.
- ``heavy-tail`` — Pareto(α) gaps: most requests arrive promptly, a few
  after very long gaps (keeps the engine draining between spurts).

``WorkloadTrace.requests()`` returns *fresh* ``Request`` objects each
call (engines mutate requests in place), shaped exactly as
``Engine.submit`` expects — so a trace drops into ``compare_engines``
and ``run_requests`` unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.serve.api import SamplingParams
from repro_torch.serve.engine import Request

FAMILIES = ("chat", "rag", "agent")
ARRIVALS = ("uniform", "bursty", "diurnal", "heavy-tail")


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a trace.  Frozen: a spec is a cache
    key — two equal specs generate identical traces."""

    name: str
    family: str = "chat"           # chat | rag | agent
    arrival: str = "uniform"       # uniform | bursty | diurnal | heavy-tail
    n_requests: int = 16
    vocab_size: int = 50
    seed: int = 0
    max_new: int = 8
    # ---- shared-prefix structure
    prefix_len: int = 16           # system prompt / RAG context / agent base
    n_streams: int = 4             # tenants (chat) or agents (agent)
    suffix_lo: int = 2             # per-request fresh suffix length bounds
    suffix_hi: int = 8
    turns: int = 4                 # agent: re-submissions per agent
    grow: int = 4                  # agent: tokens appended per turn
    # ---- arrival-process knobs (engine ticks)
    mean_gap: float = 4.0
    burst_size: int = 4
    burst_gap: float = 32.0
    period: float = 64.0
    amplitude: float = 0.8
    pareto_alpha: float = 1.5
    # ---- request attributes
    priorities: tuple = (0,)       # cycled over requests in arrival order
    temperature: float = 0.0       # > 0 => counter-based sampled decoding
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}, "
                             f"got {self.family!r}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        if not 1 <= self.suffix_lo <= self.suffix_hi:
            raise ValueError("need 1 <= suffix_lo <= suffix_hi")
        if self.prefix_len < 1 or self.n_streams < 1:
            raise ValueError("prefix_len and n_streams must be >= 1")
        if self.family == "agent" and (self.turns < 1 or self.grow < 1):
            raise ValueError("agent family needs turns >= 1 and grow >= 1")
        if not self.priorities:
            raise ValueError("priorities must be non-empty")

    # ------------------------------------------------------------- sizing
    @property
    def max_prompt_len(self) -> int:
        """Upper bound on any generated prompt length — the engine-sizing
        contract: ``max_len`` must cover ``max_prompt_len + max_new``."""
        if self.family == "agent":
            return self.prefix_len + self.turns * self.grow
        return self.prefix_len + self.suffix_hi

    @property
    def sampling(self) -> SamplingParams | None:
        if self.temperature <= 0:
            return None
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p,
                              seed=self.seed % (2 ** 31))


@dataclass
class WorkloadTrace:
    """One generated trace: prompts / arrivals / priorities, index-aligned
    (index == rid).  ``requests()`` mints fresh Request objects so the
    trace can be replayed through any number of engines."""

    spec: WorkloadSpec
    prompts: list = field(default_factory=list)       # list[list[int]]
    arrivals: list = field(default_factory=list)      # nondecreasing ticks
    priorities: list = field(default_factory=list)

    @property
    def n_requests(self) -> int:
        return len(self.prompts)

    @property
    def max_feed(self) -> int:
        """Longest prompt + generation budget: the ``max_len`` floor."""
        return max(len(p) for p in self.prompts) + self.spec.max_new

    def requests(self) -> list:
        """Fresh ``Request`` objects (rid == trace index).  Engines mutate
        requests in place, so every replay needs its own copies."""
        sp = self.spec.sampling
        return [Request(rid=i, prompt=list(p), max_new=self.spec.max_new,
                        priority=self.priorities[i], sampling=sp)
                for i, p in enumerate(self.prompts)]

    # -------------------------------------------------------- diagnostics
    def shared_prefix_stats(self) -> dict:
        """How much prefix structure the trace actually carries.
        ``reuse_frac`` is the fraction of prompt tokens covered by the
        longest earlier-prompt common prefix — an upper bound on what a
        perfect prefix cache could skip (ignoring eviction and paging
        granularity)."""
        total = reusable = 0
        for i, p in enumerate(self.prompts):
            total += len(p)
            best = 0
            for q in self.prompts[:i]:
                n = 0
                for a, b in zip(p, q):
                    if a != b:
                        break
                    n += 1
                best = max(best, n)
            reusable += best
        return {
            "prompt_tokens": total,
            "reusable_tokens": reusable,
            "reuse_frac": round(reusable / total, 3) if total else 0.0,
        }

    def describe(self) -> dict:
        """Deterministic trace fingerprint for bench reports."""
        s = self.spec
        return {
            "workload": s.name, "family": s.family, "arrival": s.arrival,
            "n_requests": self.n_requests, "seed": s.seed,
            "max_prompt_len": max(len(p) for p in self.prompts),
            "max_feed": self.max_feed,
            "span_ticks": round(self.arrivals[-1], 2) if self.arrivals else 0,
            **self.shared_prefix_stats(),
        }


# ============================================================== arrivals


def _gaps(spec: WorkloadSpec, n: int, rng: np.random.Generator) -> list:
    """Inter-arrival gaps (ticks) for ``n`` requests, first gap included
    (request 0 need not arrive at t=0 for non-uniform processes)."""
    if spec.arrival == "uniform":
        return [spec.mean_gap] * n
    if spec.arrival == "bursty":
        gaps = []
        for i in range(n):
            at_burst_head = i % spec.burst_size == 0
            # head of each burst waits out the quiet period; members
            # inside a burst land almost together (jitter < 1 tick keeps
            # intra-burst submission order meaningful but adversarial)
            gaps.append(spec.burst_gap if at_burst_head and i
                        else float(rng.uniform(0.0, 0.5)))
        return gaps
    if spec.arrival == "diurnal":
        gaps, t = [], 0.0
        for _ in range(n):
            rate = (1.0 + spec.amplitude
                    * math.sin(2.0 * math.pi * t / spec.period))
            g = float(rng.exponential(spec.mean_gap)) / max(rate, 0.1)
            gaps.append(g)
            t += g
        return gaps
    # heavy-tail: Pareto(α) scaled so the mean gap matches mean_gap when
    # α > 1 (the α <= 1 regime has no mean; fall back to raw scale)
    a = spec.pareto_alpha
    scale = spec.mean_gap * (a - 1.0) / a if a > 1.0 else spec.mean_gap
    return [scale * float(1.0 + rng.pareto(a)) for _ in range(n)]


def _arrival_ticks(spec: WorkloadSpec, n: int,
                   rng: np.random.Generator) -> list:
    ticks, t = [], 0.0
    for g in _gaps(spec, n, rng):
        t += g
        ticks.append(round(t, 4))
    return ticks


# =============================================================== prompts


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> list:
    # token 0 is reserved as padding in parts of the stack; draw from
    # [1, vocab) so prompts never alias the pad id
    return [int(x) for x in rng.integers(1, vocab, size=n)]


def _chat_prompts(spec: WorkloadSpec, rng: np.random.Generator) -> list:
    systems = [_tokens(rng, spec.prefix_len, spec.vocab_size)
               for _ in range(spec.n_streams)]
    prompts = []
    for i in range(spec.n_requests):
        suffix = _tokens(rng, int(rng.integers(spec.suffix_lo,
                                               spec.suffix_hi + 1)),
                         spec.vocab_size)
        prompts.append(systems[i % spec.n_streams] + suffix)
    return prompts


def _rag_prompts(spec: WorkloadSpec, rng: np.random.Generator) -> list:
    context = _tokens(rng, spec.prefix_len, spec.vocab_size)
    prompts = []
    for _ in range(spec.n_requests):
        query = _tokens(rng, int(rng.integers(spec.suffix_lo,
                                              spec.suffix_hi + 1)),
                        spec.vocab_size)
        prompts.append(context + query)
    return prompts


def _agent_prompts(spec: WorkloadSpec, rng: np.random.Generator) -> list:
    """Growing-prefix loops, round-robin over agents by turn: the output
    order is (agent0 turn0, agent1 turn0, ..., agent0 turn1, ...) so
    nondecreasing arrival ticks never schedule turn k before its own
    turn k-1 (whose prompt it extends)."""
    histories = [_tokens(rng, spec.prefix_len, spec.vocab_size)
                 for _ in range(spec.n_streams)]
    by_turn: list[list[list[int]]] = []
    for _ in range(spec.turns):
        this_turn = []
        for a in range(spec.n_streams):
            this_turn.append(list(histories[a]))
            histories[a] = histories[a] + _tokens(rng, spec.grow,
                                                  spec.vocab_size)
        by_turn.append(this_turn)
    flat = [p for turn in by_turn for p in turn]
    return flat[:spec.n_requests]


_FAMILY_BUILDERS = {
    "chat": _chat_prompts,
    "rag": _rag_prompts,
    "agent": _agent_prompts,
}


# ============================================================== generate


def generate(spec: WorkloadSpec) -> WorkloadTrace:
    """Build the trace for ``spec``.  Pure: one rng seeded from
    ``spec.seed`` drives prompts first, then arrivals — so adding new
    arrival processes never perturbs existing families' prompts."""
    rng = np.random.default_rng(spec.seed)
    prompts = _FAMILY_BUILDERS[spec.family](spec, rng)
    arrivals = _arrival_ticks(spec, len(prompts), rng)
    pr = spec.priorities
    priorities = [pr[i % len(pr)] for i in range(len(prompts))]
    return WorkloadTrace(spec=spec, prompts=prompts, arrivals=arrivals,
                         priorities=priorities)


# ===================================================== canonical suites


def smoke_specs(*, vocab_size: int = 50, seed: int = 0
                ) -> tuple[WorkloadSpec, ...]:
    """The benchmark suite's canonical small traces — one per family,
    each with a different arrival process so the matrix covers both
    axes.  Sized to fit the smoke engine (max_len 64: every spec's
    ``max_prompt_len + max_new`` stays under it)."""
    return (
        WorkloadSpec(name="chat-diurnal", family="chat", arrival="diurnal",
                     n_requests=12, vocab_size=vocab_size, seed=seed,
                     max_new=6, prefix_len=16, n_streams=3,
                     suffix_lo=2, suffix_hi=6, mean_gap=2.0,
                     priorities=(0, 1)),
        WorkloadSpec(name="rag-heavy-tail", family="rag",
                     arrival="heavy-tail", n_requests=10,
                     vocab_size=vocab_size, seed=seed + 1, max_new=6,
                     prefix_len=32, suffix_lo=2, suffix_hi=6,
                     mean_gap=3.0, pareto_alpha=1.6),
        WorkloadSpec(name="agent-bursty", family="agent", arrival="bursty",
                     n_requests=12, vocab_size=vocab_size, seed=seed + 2,
                     max_new=6, prefix_len=12, n_streams=3, turns=4,
                     grow=4, burst_size=3, burst_gap=24.0,
                     priorities=(0, 0, 1)),
    )
