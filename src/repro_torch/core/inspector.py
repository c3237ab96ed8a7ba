"""HLO transport-pathway inspector.

The TPU analogue of the paper's debug-log analysis (§3 "Automating Domain
Expertise"): instead of grepping UCX/NCCL traces for TCP fallbacks or
missing GPUDirect, we parse the compiled HLO — the authoritative record of
which collective "transports" XLA actually chose — and derive:

  * every collective op (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute), its payload bytes, group size, and
    how many times it executes (while-loop trip counts are recovered from
    the paired condition computations, so per-layer collectives inside
    scan-over-layers are counted per layer);
  * per-device communication bytes under a ring model
    (all-reduce 2(g-1)/g, gather/scatter (g-1)/g, permute 1.0);
  * misconfiguration findings (core/diagnostics.py policies): redundant
    re-gathers, all-reduce where reduce-scatter would do, replicated large
    buffers, host transfers — the "suboptimal transport pathway" class of
    bugs the paper detects by expert review, automated here.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

# bytes moved per device / payload bytes, ring algorithms
_RING_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "ragged-all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+"
    r"(" + "|".join(COLLECTIVES) + r")(?:-start|-done)?\(", re.M)
# the while operand may carry a nested tuple type, e.g.
# ``while((s32[], f32[64,64]{1,0}) %tuple)`` — match lazily up to the
# closing paren that precedes ``condition=``
_WHILE_RE = re.compile(
    r"while\(.*?\)\s*,\s*condition=%?([\w.\-]+)\s*,\s*body=%?([\w.\-]+)")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*?\)\s*->", re.M)
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([\d,]+)\}")
_GROUPS_V2_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_PAIRS_RE = re.compile(r"source_target_pairs=\{")


def _parse_shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO type string (handles tuple types)."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveOp:
    name: str
    kind: str
    payload_bytes: int      # result buffer bytes (per device, SPMD module)
    group_size: int
    computation: str
    trips: int = 1
    f32_activation: bool = False  # f32 payload, activation-shaped (rank>=3)

    @property
    def moved_bytes(self) -> float:
        """Per-device bytes on the wire across all executions."""
        return (_RING_FACTOR[self.kind](max(self.group_size, 2))
                * self.payload_bytes * self.trips)

    @property
    def tpu_adjusted_bytes(self) -> float:
        """XLA:CPU promotes bf16 dot operands to f32 and hoists the convert
        through collectives, doubling activation payloads on the wire.  TPU
        has native bf16 MXU dots, so the f32 width is a host artifact —
        the same image would move half these bytes there (the manifest/
        attestation layer records both).  Count such ops at bf16 width."""
        b = self.moved_bytes
        return b / 2 if self.f32_activation else b


@dataclass
class TransportReport:
    ops: list[CollectiveOp] = field(default_factory=list)
    findings: list[dict] = field(default_factory=list)

    @property
    def total_moved_bytes(self) -> float:
        return sum(op.moved_bytes for op in self.ops)

    @property
    def tpu_adjusted_moved_bytes(self) -> float:
        return sum(op.tpu_adjusted_bytes for op in self.ops)

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for op in self.ops:
            out[op.kind] += op.moved_bytes
        return dict(out)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for op in self.ops:
            out[op.kind] += op.trips
        return dict(out)

    def summary(self) -> dict:
        return {
            "total_moved_bytes": self.total_moved_bytes,
            "tpu_adjusted_moved_bytes": self.tpu_adjusted_moved_bytes,
            "by_kind": self.by_kind(),
            "counts": self.counts(),
            "n_findings": len(self.findings),
            "findings": self.findings,
        }


def _split_computations(hlo: str) -> dict[str, str]:
    """Map computation name -> its text block."""
    comps: dict[str, str] = {}
    current = None
    lines: list[str] = []
    for line in hlo.splitlines():
        m = _COMP_RE.match(line)
        if m and ("{" in line):
            if current is not None:
                comps[current] = "\n".join(lines)
            current = m.group(1)
            lines = [line]
        else:
            lines.append(line)
    if current is not None:
        comps[current] = "\n".join(lines)
    return comps


_TRIP_RE = re.compile(r'known_trip_count"?\s*:\s*\{"?n"?\s*:\s*"?(\d+)')


def _trip_count(cond_text: str) -> int | None:
    """Recover a static while trip count from its condition computation:
    the compare-against constant pattern XLA emits for counted loops."""
    consts = re.findall(r"=\s*s(?:32|64)\[\]\s+constant\((\d+)\)", cond_text)
    if not consts:
        return None
    # The loop bound is the largest integer constant compared against.
    if re.search(r"compare\(", cond_text):
        return max(int(c) for c in consts)
    return None


def _group_size(attr_line: str, n_partitions: int) -> int:
    m = _GROUPS_V2_RE.search(attr_line)
    if m:
        n_groups, g = int(m.group(1)), int(m.group(2))
        return g
    m = _GROUPS_RE.search(attr_line)
    if m:
        return len(m.group(1).split(","))
    if _PAIRS_RE.search(attr_line):
        return 2
    return n_partitions


def parse_hlo(hlo: str, n_partitions: int = 1) -> TransportReport:
    report = TransportReport()
    comps = _split_computations(hlo)

    # while-loop trip counts: map body computation -> trips.  Primary
    # source: the while instruction's backend_config known_trip_count;
    # fallback: the condition computation's compare constant.
    body_trips: dict[str, int] = {}
    for m in _WHILE_RE.finditer(hlo):
        cond, body = m.group(1), m.group(2)
        line_end = hlo.find("\n", m.end())
        line = hlo[m.start():line_end if line_end > 0 else len(hlo)]
        tm = _TRIP_RE.search(line)
        trips = int(tm.group(1)) if tm else _trip_count(comps.get(cond, ""))
        if trips:
            # nested whiles multiply: walk up later if needed (one level
            # of nesting is what scan-in-scan produces)
            body_trips[body] = body_trips.get(body, 1) * trips

    # propagate nesting: if a body contains a while whose body has trips,
    # multiply (two-level scan: hybrid/vlm groups)
    for name, text in comps.items():
        outer = body_trips.get(name)
        if not outer:
            continue
        for m in _WHILE_RE.finditer(text):
            inner_body = m.group(2)
            if inner_body in body_trips:
                body_trips[inner_body] *= outer

    for comp_name, text in comps.items():
        trips = body_trips.get(comp_name, 1)
        for m in _INSTR_RE.finditer(text):
            name, type_str, kind = m.group(1), m.group(2), m.group(3)
            if name.endswith(".done") or "-done" in name:
                continue  # count the -start only (async pairs)
            line = text[m.start():text.find("\n", m.start())]
            payload = _parse_shape_bytes(type_str)
            if kind == "all-to-all" and type_str.startswith("("):
                # tuple all-to-all: payload is the sum, already handled
                pass
            g = _group_size(line, n_partitions)
            f32_act = bool(re.match(r"\(?f32\[\d+,\d+,\d+", type_str))
            report.ops.append(CollectiveOp(
                name=name, kind=kind, payload_bytes=payload,
                group_size=g, computation=comp_name, trips=trips,
                f32_activation=f32_act))

    _attach_findings(report, hlo)
    return report


def _attach_findings(report: TransportReport, hlo: str) -> None:
    """Pathway-misconfiguration heuristics (paper §3/§8 automated)."""
    # 1. redundant gathers: same payload+kind+group repeated in one comp
    seen: dict[tuple, list[CollectiveOp]] = defaultdict(list)
    for op in report.ops:
        if op.kind == "all-gather":
            seen[(op.computation, op.payload_bytes, op.group_size)].append(op)
    for key, ops in seen.items():
        if len(ops) > 2:  # q,k,v gathers of same-shaped weights are fine; >2 identical is suspect
            report.findings.append({
                "severity": "info",
                "kind": "repeated-all-gather",
                "detail": f"{len(ops)} identical all-gathers of "
                          f"{ops[0].payload_bytes} B in {key[0]} — check for "
                          f"a missed CSE or a re-gather across uses",
            })
    # 2. large all-reduce where a reduce-scatter(+later gather) pattern is
    #    cheaper (gradient reduction): flag all-reduces > 256 MiB payload.
    for op in report.ops:
        if op.kind == "all-reduce" and op.payload_bytes > 256 * 2**20:
            report.findings.append({
                "severity": "warn",
                "kind": "monolithic-all-reduce",
                "detail": f"{op.name}: {op.payload_bytes/2**20:.0f} MiB "
                          f"all-reduce (g={op.group_size}); reduce-scatter + "
                          f"sharded update halves wire bytes",
            })
    # 3. dtype-promotion-inflated collectives (host-environment artifact:
    #    XLA:CPU promotes bf16 dot operands to f32 and hoists the convert
    #    through the collective; native-bf16 hosts move half the bytes).
    infl = sum(op.moved_bytes - op.tpu_adjusted_bytes for op in report.ops)
    if infl > 2**30:
        report.findings.append({
            "severity": "info",
            "kind": "promotion-inflated-collectives",
            "detail": f"{infl/2**30:.1f} GiB of f32 activation collectives "
                      f"are bf16 on a native-bf16 host (tpu_adjusted_moved_"
                      f"bytes reports the corrected term)",
        })
    # 4. host transfers in the hot path
    if re.search(r"\b(outfeed|infeed|send|recv)\(", hlo):
        report.findings.append({
            "severity": "warn",
            "kind": "host-transfer",
            "detail": "infeed/outfeed/send/recv found in compiled module",
        })


# ===================================================================
# Execution-weighted HLO cost model
#
# XLA's compiled.cost_analysis() counts each while body ONCE, so with
# scan-over-layers it under-reports flops/bytes by ~n_layers.  This model
# re-derives both with loop-trip multiplication:
#   * trips come from the while instruction's backend_config
#     known_trip_count (fallback: the condition's compare constant);
#   * dot flops = 2 · |result| · K (K = lhs contracting dims);
#   * elementwise/reduce ops count |result| arithmetic flops;
#   * HBM bytes = operand + result bytes of top-level and while-body
#     instructions; fusion bodies contribute flops but their internal
#     dataflow is VMEM-resident, so only the fusion's boundary operands
#     count toward bytes (this is the TPU memory model, where a fused
#     region streams HBM→VMEM once).
# ===================================================================

_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "power", "maximum", "minimum",
    "and", "or", "xor", "not", "negate", "abs", "sign", "compare", "select",
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "sqrt", "rsqrt", "cbrt", "sine", "cosine", "tan", "atan2", "logistic",
    "convert", "floor", "ceil", "round-nearest-afz", "round-nearest-even",
    "clamp", "is-finite", "erf", "remainder", "shift-left",
    "shift-right-arithmetic", "shift-right-logical", "stochastic-convert",
}
_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "opt-barrier", "while", "conditional", "call", "custom-call",
    "rng-bit-generator", "rng", "partition-id", "replica-id", "domain",
}

# Ops whose operands/results plausibly round-trip HBM on TPU.  Standalone
# elementwise ops are EXCLUDED from the bytes model: the TPU compiler fuses
# them into neighbouring dots/copies, so counting them (as the unfused CPU
# HLO would suggest) over-states HBM traffic by orders of magnitude.  Their
# flops still count.  This makes the bytes term a fusion-optimistic model —
# stated as such wherever reported.
_BYTES_OPS = {
    "dot", "convolution", "copy", "slice", "dynamic-slice",
    "dynamic-update-slice", "gather", "scatter", "concatenate", "pad",
    "transpose", "reverse", "sort", "reduce", "reduce-window", "iota",
    "copy-start", "copy-done",
}

# type string: either a tuple "(...)" (may contain /*index=N*/ comments,
# hence [^()] rather than [^=]) or a plain array type.
_INSTR_FULL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^()]*\)|[\w\[\],{}]+))\s+"
    r"([\w\-]+)\(", re.M)
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_TO_APPLY_RE = re.compile(r"to_apply=%?([\w.\-]+)")
_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def _dims_of(type_str: str) -> list[tuple[str, tuple[int, ...]]]:
    """All (dtype, dims) arrays in an HLO type string (tuples flattened)."""
    out = []
    for m in _SHAPE_RE.finditer(type_str):
        dt = m.group(1)
        if dt not in _DTYPE_BYTES:
            continue
        dims = tuple(int(d) for d in m.group(2).split(",") if d)
        out.append((dt, dims))
    # scalar arrays like f32[] :
    for m in re.finditer(r"(\w+)\[\]", type_str):
        if m.group(1) in _DTYPE_BYTES:
            out.append((m.group(1), ()))
    return out


def _bytes_of(type_str: str) -> int:
    total = 0
    for dt, dims in _dims_of(type_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _operand_names(line: str, op_start: int) -> list[str]:
    """Names inside the op's top-level parens."""
    i = line.find("(", op_start)
    depth = 0
    j = i
    for j in range(i, len(line)):
        if line[j] == "(":
            depth += 1
        elif line[j] == ")":
            depth -= 1
            if depth == 0:
                break
    seg = line[i:j + 1]
    return re.findall(r"%([\w.\-]+)", seg)


class _Comp:
    __slots__ = ("name", "dot_flops", "arith_flops", "bytes", "transcendentals",
                 "while_calls", "fusion_calls", "call_calls")

    def __init__(self, name: str):
        self.name = name
        self.dot_flops = 0.0
        self.arith_flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.while_calls: list[tuple[str, str, int]] = []  # (cond, body, trips)
        self.fusion_calls: list[str] = []
        self.call_calls: list[str] = []


def hlo_cost(hlo: str) -> dict:
    comps_text = _split_computations(hlo)
    comps: dict[str, _Comp] = {}

    for cname, text in comps_text.items():
        comp = _Comp(cname)
        shapes: dict[str, str] = {}
        # parameters appear in the signature: name: type
        header = text.split("{", 1)[0]
        for m in re.finditer(r"([\w.\-]+)\s*:\s*((?:\([^)]*\)|[\w\[\],]+))",
                             header):
            shapes[m.group(1)] = m.group(2)
        lines = text.splitlines()
        for line in lines:
            m = _INSTR_FULL_RE.match(line)
            if not m:
                continue
            name, type_str, op = m.group(1), m.group(2), m.group(3)
            shapes[name] = type_str
            if op == "while":
                wm = _WHILE_RE.search(line)
                trips = None
                tm = _TRIP_RE.search(line)
                if tm:
                    trips = int(tm.group(1))
                if wm:
                    comp.while_calls.append(
                        (wm.group(1), wm.group(2), trips or 0))
                continue
            if op == "fusion":
                # flops of the body count; boundary bytes do NOT — the CPU
                # backend wraps every elementwise op in a kLoop fusion, so
                # fusion traffic here is what the TPU compiler would fuse
                # away.  Dots/copies/DUS below carry the honest HBM model.
                cm = _CALLS_RE.search(line)
                if cm:
                    comp.fusion_calls.append(cm.group(1))
                continue
            if op == "call":
                cm = _TO_APPLY_RE.search(line) or _CALLS_RE.search(line)
                if cm:
                    comp.call_calls.append(cm.group(1))
                continue
            if op in _FREE_OPS:
                continue

            ops_names = _operand_names(line, m.end() - 1)
            if op in _BYTES_OPS:
                res_bytes = _bytes_of(type_str)
                opd_bytes = sum(_bytes_of(shapes.get(o, "")) for o in ops_names)
                comp.bytes += res_bytes + opd_bytes

            arrays = _dims_of(type_str)
            n_res = 0
            if arrays:
                n = 1
                for d in arrays[0][1]:
                    n *= d
                n_res = n
            if op == "dot":
                k = 1
                lhs = shapes.get(ops_names[0], "") if ops_names else ""
                lhs_arrays = _dims_of(lhs)
                cm = _LHS_CONTRACT_RE.search(line)
                if cm and lhs_arrays:
                    for idx in cm.group(1).split(","):
                        if idx:
                            k *= lhs_arrays[0][1][int(idx)]
                comp.dot_flops += 2.0 * n_res * k
            elif op in _ELEMENTWISE:
                comp.arith_flops += n_res
                if op in ("exponential", "log", "tanh", "logistic", "sine",
                          "cosine", "sqrt", "rsqrt", "power", "erf"):
                    comp.transcendentals += n_res
            elif op in ("reduce", "reduce-window"):
                opd = _dims_of(shapes.get(ops_names[0], "")) if ops_names else []
                n_opd = 0
                if opd:
                    n = 1
                    for d in opd[0][1]:
                        n *= d
                    n_opd = n
                comp.arith_flops += n_opd
            elif op.startswith("all-") or op in ("reduce-scatter",
                                                 "collective-permute"):
                pass  # collectives counted by parse_hlo
        comps[cname] = comp

    # --- propagate execution multipliers from ENTRY ---
    entry = None
    for line in hlo.splitlines():
        if line.startswith("ENTRY"):
            m = re.search(r"ENTRY\s+%?([\w.\-]+)", line)
            if m:
                entry = m.group(1)
            break
    if entry is None or entry not in comps:
        # fallback: computation not matched; pick the one with a while
        entry = next(iter(comps))

    totals = {"dot_flops": 0.0, "arith_flops": 0.0, "bytes": 0.0,
              "transcendentals": 0.0}
    visited_guard: set[tuple[str, int]] = set()

    def visit(cname: str, mult: float, bytes_on: bool, depth: int = 0):
        if depth > 50 or cname not in comps:
            return
        comp = comps[cname]
        totals["dot_flops"] += mult * comp.dot_flops
        totals["arith_flops"] += mult * comp.arith_flops
        totals["transcendentals"] += mult * comp.transcendentals
        if bytes_on:
            totals["bytes"] += mult * comp.bytes
        for cond, body, trips in comp.while_calls:
            t = max(trips, 1)
            visit(body, mult * t, bytes_on, depth + 1)
            visit(cond, mult * t, False, depth + 1)
        for callee in comp.fusion_calls:
            visit(callee, mult, False, depth + 1)  # fusion body: flops only
        for callee in comp.call_calls:
            visit(callee, mult, bytes_on, depth + 1)

    visit(entry, 1.0, True)
    totals["flops"] = totals["dot_flops"] + totals["arith_flops"]
    return totals
