"""Declarative pathway-expectation registry.

The dual-environment verdict (``core.verify``) proves two pathways give
the same *answer*; it cannot see that one of them took a degraded route —
a dense arch silently falling back to the contiguous engine, a shrunken
page size, a disabled prefix cache, or a hot loop recompiling every tick
all produce token-identical output.  This registry encodes what the hot
path *should* look like for a given (arch family, mesh shape, workload)
and turns runtime evidence (trace events, engine reports,
``inspector.TransportReport``) into diagnostics findings in the existing
severity vocabulary, exactly the paper's "detect suboptimal transport
pathways from debug output" loop (§8) applied to our own runtime.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.audit.timeline import attribution, build_timelines
from repro_torch.audit.trace import Tracer
from repro_torch.core.inspector import COLLECTIVES, TransportReport


@dataclass(frozen=True)
class AuditContext:
    """What ran: the registry key. ``mesh`` is the device-mesh shape (a
    single-process serving run is ``(1,)``); ``shared_prefix`` declares
    that prompts overlap by at least one cache page, so a working prefix
    cache is an expectation rather than an optimisation — callers must
    leave it False when the common prefix is shorter than the engine's
    block size (sub-block prefixes cannot hit, only full blocks
    register)."""

    workload: str                      # "serve" | "train" | "bench:<name>"
    family: str                        # dense | moe | ssm | hybrid | vlm | encdec
    arch: str = "?"
    mesh: tuple[int, ...] = (1,)
    shared_prefix: bool = False

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.mesh))


@dataclass
class Evidence:
    """What we observed.  Any subset may be present; checks that lack
    their evidence are skipped (absence of evidence is not a finding)."""

    tracer: Tracer | None = None
    engine_report: dict | None = None      # ServeEngine/PagedServeEngine.report()
    transport: TransportReport | None = None
    # cluster runs: replica tracers carry the admit/prefill-done/finish
    # events the cluster tracer never sees; timeline reconstruction
    # merges them (duplicated submit/route events deduplicate)
    replica_tracers: Sequence[Tracer] = ()

    # ------------------------------------------------- derived accessors
    def engine_kind(self) -> str | None:
        if self.tracer is not None:
            ev = self.tracer.last("engine-init")
            if ev is not None:
                return ev.data.get("engine")
        if self.engine_report:
            return self.engine_report.get("engine")
        return None

    def engine_init(self) -> dict | None:
        if self.tracer is not None:
            ev = self.tracer.last("engine-init")
            if ev is not None:
                return ev.data
        return self.engine_report

    def request_latencies(self) -> dict[int, dict]:
        """Per-request lifecycle latencies on the engine tick clock,
        computed from the request-lifecycle trace events.  Returns
        rid -> {``ttft_ticks``, ``decode_gap_ticks`` (mean ticks per
        token after the first; requires a finish event), ``tokens``}.
        Cancelled requests are excluded — a cancelled stream has no
        defined completion latency.

        TTFT is read from the ``first-token`` event's own
        ``ttft_ticks`` payload (engines stamp it at emission), with
        ``tick - submit.arrival`` as a fallback — so the measurement
        survives the bounded ring evicting old ``submit`` events on
        long runs.  Requests whose *first-token* event itself was
        evicted are necessarily absent: the latencies are the retained
        window, not a lifetime census."""
        if self.tracer is None:
            return {}
        arrival: dict[int, float] = {}
        first: dict[int, dict] = {}
        fin: dict[int, dict] = {}
        cancelled: set[int] = set()
        for e in self.tracer.events("submit"):
            if "rid" in e.data:
                arrival[e.data["rid"]] = e.data.get(
                    "arrival", e.data.get("tick", 0.0))
        for e in self.tracer.events("first-token"):
            if "rid" in e.data:
                first.setdefault(e.data["rid"], e.data)
        for e in self.tracer.events("finish"):
            if "rid" in e.data and "tick" in e.data:
                fin[e.data["rid"]] = e.data
        for e in self.tracer.events("cancel"):
            cancelled.add(e.data.get("rid"))
        out: dict[int, dict] = {}
        for rid, ft in first.items():
            if rid in cancelled:
                continue
            if "ttft_ticks" in ft:
                rec = {"ttft_ticks": ft["ttft_ticks"]}
            elif "tick" in ft and rid in arrival:
                rec = {"ttft_ticks": ft["tick"] - arrival[rid]}
            else:
                continue
            f = fin.get(rid)
            if f is not None and "tick" in ft:
                n = f.get("tokens_out", 1)
                rec["decode_gap_ticks"] = ((f["tick"] - ft["tick"])
                                           / max(n - 1, 1))
                rec["tokens"] = n
            out[rid] = rec
        return out

    def request_timelines(self) -> dict:
        """Per-request phase decomposition (``audit.timeline``) rebuilt
        from the lifecycle trace: rid -> ``RequestTimeline`` whose
        ``queue_wait``/``prefill``/``decode``/``preempted``/``routing``
        spans sum exactly to the end-to-end tick latency.  Subject to
        the same retained-window caveat as ``request_latencies``."""
        if self.tracer is None:
            return {}
        return build_timelines(self.tracer, *self.replica_tracers)

    def compile_counts(self) -> dict[str, int]:
        """Per-jitted-function compile (cache-miss) counts.

        Trace events give the per-fn breakdown but live in a bounded
        ring; the engine report's ``compiles`` field is the watcher's
        exact lifetime counter, so it wins when larger (a long run whose
        early compile events were evicted still judges correctly)."""
        counts: dict[str, int] = {}
        if self.tracer is not None:
            for ev in self.tracer.events("compile"):
                fn = ev.data.get("fn", "?")
                counts[fn] = counts.get(fn, 0) + 1
        rep = self.engine_report or {}
        if isinstance(rep.get("compiles"), int):
            if rep.get("engine") in ("paged", "cluster"):
                # a cluster's replicas are paged engines sharing one jit
                # cache; its ``compiles`` is the per-replica max, judged
                # against the same chunk-fn budget
                fn = ("decode_paged_chunk" if rep.get("kernel") == "paged"
                      else "decode_chunk")
            else:
                fn = "decode_step"
            counts[fn] = max(counts.get(fn, 0), rep["compiles"])
        return counts


@dataclass
class ExpectedSignature:
    """The declarative half of a rule: what the evidence must show.
    ``None`` fields are unchecked."""

    engine: str | None = None               # "paged" | "contiguous"
    kernel: str | None = None               # paged engine KV pathway:
                                            # "paged" (through the page
                                            # table) | "gather" (dense
                                            # working-cache fallback)
    min_block_size: int | None = None       # page geometry floor
    min_prefix_hit_rate: float | None = None  # gated on ctx.shared_prefix
    max_compiles_per_fn: int | None = None  # steady state: 1 per program
    # per-request lifecycle latencies (engine tick clock, from the
    # submit/first-token/finish trace events).  Bounds are workload
    # properties — the defaults carry none; benchmarks and launchers
    # register calibrated rules for traces whose latencies they know.
    max_ttft_ticks: float | None = None
    max_decode_gap_ticks: float | None = None
    # population SLOs over the same tick-clock latencies: the worst-case
    # bounds above catch a single pathological request, the quantile
    # bounds catch systemic degradation under load (a misconfigured
    # scheduler inflates the p99 long before it touches the max on a
    # small trace).  Violations are ``pathway-slo`` findings.  Nearest-
    # rank quantiles over deterministic tick latencies: bit-reproducible.
    p99_ttft_ticks: float | None = None
    p99_decode_gap_ticks: float | None = None
    # cluster routing quality (serve.cluster reports): floors on the
    # fraction of affinity opportunities the router converted and on the
    # cluster-wide prefix hit rate.  Misrouting is the canonical
    # token-invisible degradation — every stream stays bit-identical
    # while prefixes a sibling replica already holds are recomputed.
    # Violations are ``pathway-routing`` findings.  Like the latency
    # bounds, the floors are workload properties: benchmarks register
    # rules calibrated from a healthy affinity run.
    min_routed_affinity: float | None = None
    min_shared_hit_rate: float | None = None
    # latency *attribution* bounds (audit.timeline): the SLO checks say
    # a quantile moved, these say *where the time went* — shares of the
    # p99-TTFT request's first-token latency spent queued / prefilling,
    # and the population share of end-to-end latency lost to preemption
    # gaps.  Exact rationals exported as floats; violations are
    # ``pathway-attribution`` findings naming the dominant phase.
    max_queue_share_p99: float | None = None
    max_prefill_share_p99: float | None = None
    max_preempted_share: float | None = None
    # KV memory tiering (paged engine reports): floor on the fraction of
    # previously-computed rows that readmissions restored from the host
    # swap tier instead of re-prefilling, and a ceiling on the re-
    # prefilled rows themselves.  A disabled/broken swap tier is another
    # token-invisible degradation — streams stay bit-identical while
    # every preemption's work is recomputed.  Violations are
    # ``pathway-tiering`` findings.  The floor is judged only when the
    # run actually readmitted previously-computed work (restored +
    # recompute > 0); an uncontended run is vacuously healthy.
    min_swap_restore_rate: float | None = None
    max_recompute_tokens: int | None = None
    allowed_collectives: frozenset[str] | None = None
    max_collective_group: int | None = None  # default: ctx.n_devices
    forbid_host_transfer: bool = False


@dataclass
class Rule:
    """Registry entry: match predicate (families × workloads × mesh) plus
    the expected signature.  ``families``/``workloads`` of ``None`` match
    anything; mesh bounds are on total device count."""

    name: str
    expect: ExpectedSignature
    families: tuple[str, ...] | None = None
    workloads: tuple[str, ...] | None = None
    min_devices: int = 1
    max_devices: int | None = None
    severity: str = "error"

    def applies(self, ctx: AuditContext) -> bool:
        if self.families is not None and ctx.family not in self.families:
            return False
        if self.workloads is not None:
            base = ctx.workload.split(":", 1)[0]
            if ctx.workload not in self.workloads and base not in self.workloads:
                return False
        n = ctx.n_devices
        if n < self.min_devices:
            return False
        if self.max_devices is not None and n > self.max_devices:
            return False
        return True


class ExpectationRegistry:
    def __init__(self, rules: Sequence[Rule] = ()):
        self.rules: list[Rule] = list(rules)

    def register(self, rule: Rule) -> Rule:
        self.rules.append(rule)
        return rule

    def match(self, ctx: AuditContext) -> list[Rule]:
        return [r for r in self.rules if r.applies(ctx)]

    # ----------------------------------------------------------- evaluate
    def evaluate(self, ctx: AuditContext, ev: Evidence) -> list[dict]:
        findings: list[dict] = []
        for rule in self.match(ctx):
            findings.extend(_check_rule(rule, ctx, ev))
        return findings


def nearest_rank(values: Sequence[float], q: float) -> float:
    """Deterministic nearest-rank quantile (the ceil(q*n)-th order
    statistic) — no interpolation, so SLO judgements over tick-clock
    latencies are bit-reproducible across platforms."""
    if not values:
        raise ValueError("quantile of an empty population")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile must be in (0, 1], got {q}")
    ordered = sorted(values)
    return ordered[min(math.ceil(q * len(ordered)), len(ordered)) - 1]


def _find(rule: Rule, kind: str, detail: str) -> dict:
    return {"severity": rule.severity, "kind": kind,
            "detail": f"[{rule.name}] {detail}"}


def _check_rule(rule: Rule, ctx: AuditContext, ev: Evidence) -> list[dict]:
    out: list[dict] = []
    sig = rule.expect

    if sig.engine is not None:
        got = ev.engine_kind()
        if got == "cluster" and sig.engine != "cluster":
            # a cluster is a router over per-replica engines: rules about
            # the serving pathway judge what each replica runs, read from
            # the cluster's declared replica engine
            init_ = ev.engine_init() or {}
            got = init_.get("replica_engine", got)
        if got is not None and got != sig.engine:
            out.append(_find(
                rule, "pathway-engine-selection",
                f"{ctx.family}/{ctx.workload} served by {got!r} engine; "
                f"expected {sig.engine!r} (token-identical output but a "
                f"degraded transport pathway)"))

    init = ev.engine_init()
    if sig.kernel is not None and init is not None:
        kern = init.get("kernel")
        # absent on contiguous evidence (the engine-selection check above
        # already covers that class); judged only where the field exists
        if kern is not None and kern != sig.kernel:
            out.append(_find(
                rule, "pathway-kernel",
                f"paged serving attends KV via the {kern!r} pathway; "
                f"expected {sig.kernel!r} — the dense per-slot gather "
                f"keeps token streams identical while reintroducing the "
                f"contiguous-shaped copy the page-table kernel removes"))

    if sig.min_block_size is not None and init is not None:
        bs = init.get("block_size")
        if bs is not None and bs < sig.min_block_size:
            out.append(_find(
                rule, "pathway-page-geometry",
                f"page size {bs} below floor {sig.min_block_size}: per-page "
                f"overhead dominates and prefix sharing granularity degrades"))

    if (sig.min_prefix_hit_rate is not None and ctx.shared_prefix
            and init is not None):
        if init.get("prefix_cache") is False:
            out.append(_find(
                rule, "pathway-prefix-cache",
                "prefix cache disabled on a shared-prefix workload: every "
                "admission recomputes the common prefix"))
        else:
            hr = (ev.engine_report or {}).get("prefix_hit_rate")
            if hr is not None and hr < sig.min_prefix_hit_rate:
                out.append(_find(
                    rule, "pathway-prefix-cache",
                    f"prefix hit rate {hr:.3f} below "
                    f"{sig.min_prefix_hit_rate:.3f} on a shared-prefix "
                    f"workload: cache ineffective (mis-sized pages or "
                    f"broken registration)"))

    if sig.max_ttft_ticks is not None or sig.max_decode_gap_ticks is not None:
        lat = ev.request_latencies()
        if lat:
            if sig.max_ttft_ticks is not None:
                rid, worst = max(((r, l["ttft_ticks"]) for r, l in lat.items()),
                                 key=lambda x: x[1])
                if worst > sig.max_ttft_ticks:
                    out.append(_find(
                        rule, "pathway-ttft",
                        f"request {rid} first token after {worst:.1f} ticks "
                        f"(> {sig.max_ttft_ticks:.1f}): admission latency "
                        f"degraded (output streams stay identical, the "
                        f"route to them slowed)"))
            if sig.max_decode_gap_ticks is not None:
                gaps = [(r, l["decode_gap_ticks"]) for r, l in lat.items()
                        if "decode_gap_ticks" in l]
                if gaps:
                    rid, worst = max(gaps, key=lambda x: x[1])
                    if worst > sig.max_decode_gap_ticks:
                        out.append(_find(
                            rule, "pathway-decode-latency",
                            f"request {rid} averaged {worst:.2f} ticks per "
                            f"decoded token (> {sig.max_decode_gap_ticks:.2f})"))

    if sig.p99_ttft_ticks is not None or sig.p99_decode_gap_ticks is not None:
        lat = ev.request_latencies()
        if lat:
            if sig.p99_ttft_ticks is not None:
                p99 = nearest_rank(
                    [l["ttft_ticks"] for l in lat.values()], 0.99)
                if p99 > sig.p99_ttft_ticks:
                    out.append(_find(
                        rule, "pathway-slo",
                        f"p99 TTFT {p99:.2f} ticks over {len(lat)} "
                        f"request(s) breaches the "
                        f"{sig.p99_ttft_ticks:.2f}-tick SLO: the serving "
                        f"pathway degrades under this load (streams stay "
                        f"identical; the tail latency does not)"))
            if sig.p99_decode_gap_ticks is not None:
                gaps = [l["decode_gap_ticks"] for l in lat.values()
                        if "decode_gap_ticks" in l]
                if gaps:
                    p99 = nearest_rank(gaps, 0.99)
                    if p99 > sig.p99_decode_gap_ticks:
                        out.append(_find(
                            rule, "pathway-slo",
                            f"p99 inter-token gap {p99:.2f} ticks breaches "
                            f"the {sig.p99_decode_gap_ticks:.2f}-tick SLO "
                            f"({len(gaps)} finished request(s))"))

    if (sig.max_queue_share_p99 is not None
            or sig.max_prefill_share_p99 is not None
            or sig.max_preempted_share is not None):
        att = attribution(ev.request_timelines())
        shares = att.get("p99_shares", {}) if att else {}
        if shares:
            dom = att["dominant_phase"]
            where = (f"dominant phase: {dom} "
                     f"({shares.get(dom, 0.0):.0%} of the "
                     f"{att['p99_ttft_ticks']:.1f}-tick p99 TTFT, "
                     f"request {att['p99_rid']})")
            if (sig.max_queue_share_p99 is not None
                    and shares.get("queue_wait", 0.0)
                    > sig.max_queue_share_p99):
                out.append(_find(
                    rule, "pathway-attribution",
                    f"queue_wait holds {shares['queue_wait']:.0%} of the "
                    f"p99-TTFT request's latency "
                    f"(> {sig.max_queue_share_p99:.0%}); {where} — "
                    f"admission, not compute, is the bottleneck (token "
                    f"streams stay identical)"))
            if (sig.max_prefill_share_p99 is not None
                    and shares.get("prefill", 0.0)
                    > sig.max_prefill_share_p99):
                out.append(_find(
                    rule, "pathway-attribution",
                    f"prefill holds {shares['prefill']:.0%} of the "
                    f"p99-TTFT request's latency "
                    f"(> {sig.max_prefill_share_p99:.0%}); {where} — "
                    f"prompt processing dominates the tail (chunking or "
                    f"prefix-cache pathway degraded)"))
        if (att and sig.max_preempted_share is not None
                and att["preempted_share"] > sig.max_preempted_share):
            out.append(_find(
                rule, "pathway-attribution",
                f"preemption gaps hold {att['preempted_share']:.0%} of "
                f"total end-to-end latency across {att['requests']} "
                f"request(s) (> {sig.max_preempted_share:.0%}): the "
                f"scheduler is thrashing admitted work"))

    rep = ev.engine_report or {}
    if sig.min_routed_affinity is not None:
        ra = rep.get("routed_affinity")
        # vacuously healthy when the workload offered no affinity
        # opportunity — nothing to convert, nothing to misroute
        if (ra is not None and rep.get("affine_opportunities", 0) > 0
                and ra < sig.min_routed_affinity):
            out.append(_find(
                rule, "pathway-routing",
                f"router converted {ra:.3f} of "
                f"{rep['affine_opportunities']} affinity opportunities "
                f"(< {sig.min_routed_affinity:.3f}): requests land off "
                f"their prefix-affine replica (token streams stay "
                f"identical; resident prefixes are recomputed)"))
    if sig.min_shared_hit_rate is not None and ctx.shared_prefix:
        shr = rep.get("shared_hit_rate")
        if shr is not None and shr < sig.min_shared_hit_rate:
            out.append(_find(
                rule, "pathway-routing",
                f"cluster-wide prefix hit rate {shr:.3f} below "
                f"{sig.min_shared_hit_rate:.3f} on a shared-prefix "
                f"workload: misrouting scatters prefix-sharing requests "
                f"across replicas, recomputing pages a sibling holds"))

    if sig.min_swap_restore_rate is not None:
        srr = rep.get("swap_restore_rate")
        readmitted = (rep.get("restored_tokens", 0)
                      + rep.get("recompute_tokens", 0))
        if srr is not None and readmitted > 0 and srr < sig.min_swap_restore_rate:
            out.append(_find(
                rule, "pathway-tiering",
                f"readmissions restored only {srr:.0%} of "
                f"{readmitted} previously-computed KV rows from the host "
                f"swap tier (< {sig.min_swap_restore_rate:.0%}): preempted "
                f"work is re-prefilled instead of swapped back in (token "
                f"streams stay identical; the memory pathway degraded)"))
    if sig.max_recompute_tokens is not None:
        rt = rep.get("recompute_tokens")
        if rt is not None and rt > sig.max_recompute_tokens:
            out.append(_find(
                rule, "pathway-tiering",
                f"{rt} previously-computed KV rows re-prefilled on "
                f"readmission (> {sig.max_recompute_tokens}): the host "
                f"swap tier is absorbing less preempted work than this "
                f"trace's healthy baseline"))

    if sig.max_compiles_per_fn is not None:
        for fn, n in ev.compile_counts().items():
            if n > sig.max_compiles_per_fn:
                out.append(_find(
                    rule, "pathway-recompilation",
                    f"{fn} compiled {n}× (> {sig.max_compiles_per_fn}): "
                    f"shape polymorphism leaked into the hot loop"))

    if ev.transport is not None:
        if sig.allowed_collectives is not None:
            bad = set(ev.transport.counts()) - set(sig.allowed_collectives)
            if bad:
                out.append(_find(
                    rule, "pathway-collective-kind",
                    f"unexpected collective kind(s) {sorted(bad)}; expected "
                    f"subset of {sorted(sig.allowed_collectives)}"))
        max_group = sig.max_collective_group
        if max_group is None and (sig.allowed_collectives is not None
                                  or sig.forbid_host_transfer):
            max_group = ctx.n_devices
        if max_group is not None:
            for op in ev.transport.ops:
                if op.group_size > max_group:
                    out.append(_find(
                        rule, "pathway-collective-group",
                        f"{op.name}: {op.kind} over group of "
                        f"{op.group_size} > mesh bound {max_group}"))
                    break
        if sig.forbid_host_transfer:
            for f in ev.transport.findings:
                if f.get("kind") == "host-transfer":
                    out.append(_find(
                        rule, "pathway-host-transfer",
                        "host transfer (infeed/outfeed/send/recv) on the "
                        "hot path: " + f.get("detail", "")))
                    break
    return out


# ===================================================== default expectations

#: Serving on attention-cache families must take the paged path — engine
#: AND kernel: KV attended through the device page table, not gathered
#: into a dense per-slot working cache — with sane page geometry, an
#: effective prefix cache on shared-prefix traces, and exactly one
#: compile per jitted program (fixed shapes).
_SERVE_PAGED = Rule(
    name="serve-dense-paged",
    families=("dense", "moe"),
    workloads=("serve", "bench"),
    expect=ExpectedSignature(
        engine="paged",
        kernel="paged",
        min_block_size=4,
        min_prefix_hit_rate=0.05,
        max_compiles_per_fn=1,
    ),
)

#: Stateful-cache families have no chunked path yet: contiguous is the
#: *correct* pathway for them (flagging paged here catches the inverse
#: misconfiguration once a paged path exists for ssm/hybrid).
_SERVE_STATEFUL = Rule(
    name="serve-stateful-contiguous",
    families=("ssm", "hybrid", "vlm", "encdec"),
    workloads=("serve", "bench"),
    expect=ExpectedSignature(engine="contiguous", max_compiles_per_fn=1),
)

#: Training hot paths: collective group sizes bounded by the mesh, no
#: host transfers inside the compiled step.
_TRAIN_TRANSPORT = Rule(
    name="train-transport",
    workloads=("train",),
    expect=ExpectedSignature(forbid_host_transfer=True),
)

#: all-to-all is expert dispatch: a non-moe train step emitting one took
#: a wrong partitioning pathway (e.g. a resharding the rule set should
#: have expressed as gather/scatter).
_TRAIN_NO_DISPATCH = Rule(
    name="train-no-expert-dispatch",
    families=tuple(f for f in ("dense", "ssm", "hybrid", "vlm", "encdec")),
    workloads=("train",),
    expect=ExpectedSignature(
        allowed_collectives=frozenset(
            k for k in COLLECTIVES
            if k not in ("all-to-all", "ragged-all-to-all")),
    ),
)

DEFAULT_REGISTRY = ExpectationRegistry(
    [_SERVE_PAGED, _SERVE_STATEFUL, _TRAIN_TRANSPORT, _TRAIN_NO_DISPATCH])
