"""Multi-replica cluster serving with prefix-affinity routing.

``ClusterEngine`` implements the ``serve.api.Engine`` protocol over N
``PagedServeEngine`` replicas — one more layer of the same contract, so
every consumer (launchers, benchmarks, the audit pipeline, the
``compare_engines`` oracle) drives a cluster exactly the way it drives a
single engine.

Routing is the new pathway, and it is built to be *verifiable*:

- **Prefix affinity.**  A request is scored against each replica by how
  deep its ``chain_hashes`` prefix chain matches a cheap per-replica
  summary of that replica's ``PrefixCache`` chains (exact hash set or a
  Bloom digest).  Deep match ⇒ the replica can serve the prompt's prefix
  from resident pages instead of recomputing it.  Summaries are refreshed
  from ``report()`` — the counters tell the router when a replica's
  resident set moved, so between refreshes the router may act on a stale
  view (bounded by ``refresh_every`` ticks).
- **Load-aware spill.**  When the affine replica is saturated (in-flight
  requests ≥ ``spill_factor ×`` its slots) the request spills to the
  least-loaded replica: prefix locality is a latency optimisation, not a
  correctness constraint, and queueing behind a hot replica to preserve
  it inverts the trade.
- **Pluggable policy.**  ``affinity`` (the production path),
  ``round_robin`` and ``random`` are interchangeable policy objects, so a
  routing misconfiguration is *injectable*: random routing keeps every
  token stream bit-identical (counter-based sampling is engine- and
  placement-independent) while cratering ``routed_affinity`` and the
  cluster-wide ``shared_hit_rate`` — only the audit layer's
  ``pathway-routing`` expectations separate it from the healthy run.

Every routing decision emits a ``route`` trace event (cluster tracer +
the chosen replica's own tracer), and ``report()`` aggregates replica
counters under the cluster's routing stats, so the pathway the router
took is evidence, not folklore.

Token-exactness by construction: requests are routed whole, each replica
is a full ``PagedServeEngine`` over the same weights, greedy decode is
batch-independent and sampled decode keys on ``(seed, rid, step)`` — so
a cluster of any size produces exactly the single engine's streams.
``compare_engines(..., cluster={...})`` gates this as the oracle verdict.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.audit.trace import NULL_TRACER, Tracer
from repro_torch.serve.api import GREEDY, RequestHandle, run_requests
from repro_torch.serve.engine import PagedServeEngine, Request, _validate
from repro_torch.serve.paging import chain_hashes, pages_for

ROUTING_POLICIES = ("affinity", "round_robin", "random")

#: Odd 64-bit mixing constants for the Bloom digest's k probe positions.
_BLOOM_MIX = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9)
_MASK64 = (1 << 64) - 1


class ExactSummary:
    """Per-replica prefix summary as the exact chain-hash set."""

    kind = "exact"

    def __init__(self):
        self._set: set[int] = set()

    def add(self, h: int) -> None:
        self._set.add(h)

    def __contains__(self, h: int) -> bool:
        return h in self._set

    def __len__(self) -> int:
        return len(self._set)


class BloomSummary:
    """Per-replica prefix summary as a Bloom digest: constant size
    regardless of resident-chain count, deterministic probe positions
    (multiplicative mixing of the 64-bit chain hash), and one-sided
    error — false positives cost a misrouted request a cache miss, never
    a wrong token."""

    kind = "bloom"

    def __init__(self, bits: int = 4096, k: int = 3):
        if bits <= 0 or not 1 <= k <= len(_BLOOM_MIX):
            raise ValueError(f"bloom needs bits > 0 and 1 <= k <= "
                             f"{len(_BLOOM_MIX)}, got ({bits}, {k})")
        self.bits = bits
        self.k = k
        self._field = 0
        self._n = 0

    def _positions(self, h: int):
        for mult in _BLOOM_MIX[:self.k]:
            yield ((h * mult) & _MASK64) % self.bits

    def add(self, h: int) -> None:
        for pos in self._positions(h):
            self._field |= 1 << pos
        self._n += 1

    def __contains__(self, h: int) -> bool:
        return all(self._field >> pos & 1 for pos in self._positions(h))

    def __len__(self) -> int:
        return self._n


def _make_summary(kind: str):
    if kind == "exact":
        return ExactSummary()
    if kind == "bloom":
        return BloomSummary()
    raise ValueError(f"summary must be 'exact' or 'bloom', got {kind!r}")


def match_depth(summary, hashes: Sequence[int]) -> int:
    """Leading chain hashes present in the summary — the number of full
    prompt blocks the replica could serve from resident pages."""
    depth = 0
    for h in hashes:
        if h not in summary:
            break
        depth += 1
    return depth


@dataclass
class _Replica:
    """Router-side view of one replica: the engine, its tracer, and the
    (possibly stale) prefix summary last refreshed from ``report()``."""

    idx: int
    engine: PagedServeEngine
    tracer: Tracer
    summary: Any = field(default_factory=ExactSummary)
    # (insertions, evictions) seen at the last refresh: the pair moves
    # monotonically whenever the resident chain set changes, so it is
    # the staleness key the report feed exposes
    feed_key: tuple[int, int] = (-1, -1)

    @property
    def load(self) -> int:
        """In-flight requests (waiting + running) — the spill signal."""
        return self.engine.sched.pending + self.engine.sched.active

    @property
    def slots(self) -> int:
        return self.engine.slots


# ================================================================ policies


class AffinityPolicy:
    """Deepest-prefix-match replica, least-loaded tiebreak, load-aware
    spill: a saturated affine replica (load ≥ ``spill_factor × slots``)
    loses the request to the least-loaded replica."""

    name = "affinity"

    def __init__(self, spill_factor: float = 2.0):
        if spill_factor <= 0:
            raise ValueError(f"spill_factor must be > 0, got {spill_factor}")
        self.spill_factor = spill_factor

    def choose(self, req: Request, depths: Sequence[int],
               replicas: Sequence[_Replica]) -> tuple[int, str]:
        loads = [r.load for r in replicas]
        least = min(range(len(replicas)), key=lambda i: (loads[i], i))
        best = max(depths)
        if best == 0:
            return least, "cold"           # no affinity anywhere: balance
        cands = [i for i, d in enumerate(depths) if d == best]
        idx = min(cands, key=lambda i: (loads[i], i))
        saturated = loads[idx] >= self.spill_factor * replicas[idx].slots
        if saturated and loads[least] < loads[idx]:
            return least, "spill"
        return idx, "affine"


class RoundRobinPolicy:
    """Placement-blind rotation — the locality-free baseline."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, req: Request, depths: Sequence[int],
               replicas: Sequence[_Replica]) -> tuple[int, str]:
        idx = self._next % len(replicas)
        self._next += 1
        return idx, "round_robin"


class RandomPolicy:
    """Seeded uniform routing — the injectable misconfiguration: token
    streams stay bit-identical while affinity and the cross-replica
    prefix hit rate crater."""

    name = "random"

    def __init__(self, seed: int = 0):
        import numpy as np
        self._rng = np.random.default_rng(seed)

    def choose(self, req: Request, depths: Sequence[int],
               replicas: Sequence[_Replica]) -> tuple[int, str]:
        return int(self._rng.integers(len(replicas))), "random"


def make_policy(routing, *, seed: int = 0):
    """Resolve a policy name (or pass a policy object through)."""
    if hasattr(routing, "choose") and hasattr(routing, "name"):
        return routing
    if routing == "affinity":
        return AffinityPolicy()
    if routing == "round_robin":
        return RoundRobinPolicy()
    if routing == "random":
        return RandomPolicy(seed)
    raise ValueError(f"routing must be one of {ROUTING_POLICIES} or a "
                     f"policy object, got {routing!r}")


# ================================================================= cluster


@dataclass
class ClusterStats:
    routed: int = 0
    affine_opportunities: int = 0   # routed requests with any summary match
    affine_routed: int = 0          # ... that landed on a deepest-match replica
    spills: int = 0
    cold: int = 0
    cancelled_unrouted: int = 0
    summary_rebuilds: int = 0

    @property
    def routed_affinity(self) -> float:
        """Fraction of affinity opportunities the router converted.  A
        healthy affinity policy sits near 1.0; uniform-random routing
        over n replicas sits near 1/n.  Vacuously 1.0 when the workload
        offered no opportunity (nothing to convert)."""
        if not self.affine_opportunities:
            return 1.0
        return self.affine_routed / self.affine_opportunities


class ClusterEngine:
    """N ``PagedServeEngine`` replicas behind one ``Engine`` contract.

    ``submit`` queues the request at the front door; routing happens when
    the request's arrival tick is due (inside ``step``), against the
    then-current per-replica prefix summaries — exactly when a real
    router would see it.  Each cluster tick routes due arrivals and then
    steps every replica once, so replica tick clocks stay in lockstep
    with the cluster clock and arrival semantics match the single-engine
    run tick for tick.

    Construction kwargs beyond the geometry (``num_blocks``, ``kernel``,
    ``use_prefix_cache``, ``preemption``, ``admit_every``, ...) are
    forwarded to every replica.
    """

    def __init__(self, model, params, *, replicas: int = 2, slots: int = 4,
                 max_len: int = 256, block_size: int = 16, chunk: int = 8,
                 routing="affinity", summary: str = "exact",
                 refresh_every: int = 1, routing_seed: int = 0,
                 tracer: Tracer | None = None,
                 replica_tracers: Sequence[Tracer] | None = None,
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if refresh_every < 1:
            raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
        _make_summary(summary)          # validate the kind eagerly
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.chunk = chunk
        self.summary_kind = summary
        self.refresh_every = refresh_every
        self.policy = make_policy(routing, seed=routing_seed)
        self.trace = tracer or NULL_TRACER
        if replica_tracers is None:
            replica_tracers = [Tracer() for _ in range(replicas)]
        if len(replica_tracers) != replicas:
            raise ValueError(f"need {replicas} replica tracers, "
                             f"got {len(replica_tracers)}")
        self._replicas = [
            _Replica(idx=i,
                     engine=PagedServeEngine(
                         model, params, slots=slots, max_len=max_len,
                         block_size=block_size, chunk=chunk,
                         tracer=replica_tracers[i], **engine_kwargs),
                     tracer=replica_tracers[i],
                     summary=_make_summary(summary))
            for i in range(replicas)
        ]
        self.now = 0.0
        self._ticks = 0
        self._pending: list[tuple[float, Request, RequestHandle]] = []
        self._placement: dict[int, tuple[int, RequestHandle]] = {}
        self.cstats = ClusterStats()
        ref = self._replicas[0].engine
        self.trace.emit(
            "engine-init", engine="cluster", replicas=replicas,
            family=model.cfg.family, arch=model.cfg.name,
            routing=self.policy.name, replica_engine="paged",
            slots=slots, max_len=max_len, block_size=block_size,
            chunk=chunk, pages=replicas * ref.alloc.num_blocks,
            prefix_cache=ref.prefix_enabled, kernel=ref.kernel,
            preemption=ref.sched.preemption, summary=summary,
            refresh_every=refresh_every)

    # -------------------------------------------------------------- views
    @property
    def replicas(self) -> list[PagedServeEngine]:
        return [r.engine for r in self._replicas]

    @property
    def replica_tracers(self) -> list[Tracer]:
        return [r.tracer for r in self._replicas]

    # ------------------------------------------------------------ intake
    def submit(self, req: Request, *, arrival: float | None = None
               ) -> RequestHandle:
        # the replica-side static checks, applied at the front door:
        # routing is deferred to the arrival tick, and a request that can
        # never place must fail here, not head-of-line-block a replica
        _validate(req)
        ref = self._replicas[0].engine
        feed = req.prompt[-(self.max_len - req.max_new):]
        worst = pages_for(len(feed) + req.max_new, self.block_size)
        if worst > ref.alloc.num_blocks:
            raise ValueError(
                f"request {req.rid} needs {worst} pages even fully "
                f"recomputed; each replica pool has {ref.alloc.num_blocks}")
        arrival = self.now if arrival is None else arrival
        req.t_submit = req.t_submit or time.perf_counter()
        handle = RequestHandle(self, req)
        self._pending.append((arrival, req, handle))
        self.trace.emit("submit", rid=req.rid, tick=self.now,
                        arrival=arrival, prompt_tokens=len(req.prompt),
                        max_new=req.max_new,
                        sampling=(req.sampling or GREEDY).describe())
        return handle

    def has_work(self) -> bool:
        return bool(self._pending) or any(r.engine.has_work()
                                          for r in self._replicas)

    # ----------------------------------------------------------- summaries
    def _refresh_summaries(self) -> None:
        """Rebuild stale per-replica summaries from the report feed.  The
        report's insertion/eviction counters are the staleness key: when
        they moved since the last refresh the resident chain set changed
        and the digest is rebuilt from ``PrefixCache.chains()``."""
        for r in self._replicas:
            rep = r.engine.report()
            key = (rep["prefix_insertions"], rep["prefix_evictions"])
            if key == r.feed_key:
                continue
            s = _make_summary(self.summary_kind)
            for h in r.engine.prefix.chains():
                s.add(h)
            r.summary = s
            r.feed_key = key
            self.cstats.summary_rebuilds += 1

    # -------------------------------------------------------------- route
    def _route(self, arrival: float, req: Request,
               handle: RequestHandle) -> None:
        feed = req.prompt[-(self.max_len - req.max_new):]
        hashes = chain_hashes(feed, self.block_size)
        depths = [match_depth(r.summary, hashes) for r in self._replicas]
        idx, decision = self.policy.choose(req, depths, self._replicas)
        # affinity accounting is policy-independent: every policy is
        # judged against the same "did it land on a deepest-match
        # replica" yardstick the audit layer gates on
        best = max(depths)
        self.cstats.routed += 1
        if best > 0:
            self.cstats.affine_opportunities += 1
            if depths[idx] == best:
                self.cstats.affine_routed += 1
        if decision == "spill":
            self.cstats.spills += 1
        elif decision == "cold":
            self.cstats.cold += 1
        replica = self._replicas[idx]
        rh = replica.engine.submit(req, arrival=arrival)
        handle.entry = rh.entry
        self._placement[id(req)] = (idx, rh)
        payload = dict(rid=req.rid, tick=self.now, arrival=arrival,
                       replica=idx, policy=self.policy.name,
                       decision=decision, depth=depths[idx],
                       best_depth=best, load=replica.load)
        self.trace.emit("route", **payload)
        if replica.tracer is not self.trace:
            replica.tracer.emit("route", **payload)

    # --------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """One cluster tick: refresh summaries (every ``refresh_every``-th
        tick), route due arrivals in submission order, then step every
        replica once (idle replicas tick too, keeping all clocks in
        lockstep with the cluster clock)."""
        self.now += 1.0
        self._ticks += 1
        if self._pending:
            if (self._ticks - 1) % self.refresh_every == 0:
                self._refresh_summaries()
            still = []
            for item in self._pending:
                if item[0] <= self.now:
                    self._route(*item)
                else:
                    still.append(item)
            self._pending = still
        done: list[Request] = []
        for r in self._replicas:
            done.extend(r.engine.step())
        return done

    def drain(self) -> list[Request]:
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    # ------------------------------------------------------------ cancel
    def cancel(self, handle: RequestHandle) -> bool:
        req = handle.req
        if req.finished or req.cancelled:
            return False
        placed = self._placement.get(id(req))
        if placed is not None:
            return placed[1].cancel()       # delegate to the replica
        for i, (_, r, _h) in enumerate(self._pending):
            if r is req:
                self._pending.pop(i)
                req.cancelled = True
                req.t_done = time.perf_counter()
                self.cstats.cancelled_unrouted += 1
                self.trace.emit("cancel", rid=req.rid, phase="waiting",
                                tick=self.now, released_pages=0)
                return True
        return False

    # ---------------------------------------------------------- run shim
    def run(self, requests: list[Request],
            arrivals: list[float] | None = None) -> list[Request]:
        return run_requests(self, requests, arrivals)

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        reps = [r.engine.report() for r in self._replicas]
        prefill = sum(rep["prefill_tokens"] for rep in reps)
        cached = sum(rep["cached_tokens"] for rep in reps)
        shared_hit = cached / (prefill + cached) if prefill + cached else 0.0
        kernels = {rep["kernel"] for rep in reps}
        occ = [rep["mean_batch_occupancy"] for rep in reps]
        return {
            "engine": "cluster",
            "replicas": len(self._replicas),
            "replica_engine": "paged",
            "routing": self.policy.name,
            "summary": self.summary_kind,
            "refresh_every": self.refresh_every,
            "served": sum(rep["served"] for rep in reps),
            "cancelled": (sum(rep["cancelled"] for rep in reps)
                          + self.cstats.cancelled_unrouted),
            "decode_steps": sum(rep["decode_steps"] for rep in reps),
            "tokens_out": sum(rep["tokens_out"] for rep in reps),
            "mean_batch_occupancy": round(sum(occ) / len(occ), 2),
            "prefill_tokens": prefill,
            "cached_tokens": cached,
            # cluster-wide (cross-replica) prefix reuse: the router's
            # quality shows up here — misrouting recomputes prefixes a
            # sibling replica already holds
            "prefix_hit_rate": round(shared_hit, 3),
            "shared_hit_rate": round(shared_hit, 3),
            "prefix_chains": sum(rep["prefix_chains"] for rep in reps),
            "pages": sum(rep["pages"] for rep in reps),
            "block_size": self.block_size,
            "chunk": self.chunk,
            "prefix_cache": all(rep["prefix_cache"] for rep in reps),
            "kernel": kernels.pop() if len(kernels) == 1 else "mixed",
            "preemptions": sum(rep["preemptions"] for rep in reps),
            "routed": self.cstats.routed,
            "routed_affinity": round(self.cstats.routed_affinity, 3),
            "affine_opportunities": self.cstats.affine_opportunities,
            "routed_spills": self.cstats.spills,
            "routed_cold": self.cstats.cold,
            "summary_rebuilds": self.cstats.summary_rebuilds,
            "compiles": max(rep["compiles"] for rep in reps),
            "per_replica": reps,
        }
