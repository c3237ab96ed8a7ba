"""The step's program: what one training step dispatches, for attestation.

The reference attests the compiled HLO of its jitted step
(``compiled.as_text()`` → ``core.inspector.parse_hlo``).  The port compiles
nothing, so its program is what the step dispatches: every ATen op, in
order, each with its tensors' dtypes, shapes and device types, recorded
under a ``TorchDispatchMode``.  The hand-written kernels are launched
through ctypes and never reach the dispatcher, so each entry point of
``kernels.ops`` writes its own line (``note``): ``kernel::<name>`` where it
launches the kernel, ``plain::<name>_plain`` where a CPU tensor takes the
plain version.  The program's text therefore shows which side every kernel
call took.

A c10d collective's line ends in ``over <backend>``, the backend of its
process group.  ``parse_program`` reads that text as ``parse_hlo`` reads
HLO: the c10d collectives become the ``TransportReport``'s ops, and every
``aten::_local_scalar_dense`` (``.item()``, ``float(t)``), every copy from a
CUDA tensor to the CPU and every collective on CUDA tensors over gloo
(which has no device transport: it stages them through host memory inside
the op) becomes a ``host-transfer`` finding, which the audit's
``train-transport`` rule forbids in a training step.

Recording only watches: the ops run as they would without it, so the step's
results are the same bit for bit.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.inspector import CollectiveOp, TransportReport

# the lines of the recordings in progress, innermost last
_ACTIVE: list[list[str]] = []

_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_TENSOR_RE = re.compile(r"(\w+)\[([\d,]*)\]@(\w+)")
_OVER_RE = re.compile(r" over (\w+)$")
# backends that move device tensors through host memory
_HOST_STAGED = ("gloo",)


def _describe(tensors) -> str:
    return ", ".join(
        f"{str(t.dtype).removeprefix('torch.')}"
        f"[{','.join(map(str, t.shape))}]@{t.device.type}"
        for t in tensors if isinstance(t, torch.Tensor))


def _backends(leaves) -> str:
    """`` over <backend>`` for each process group among an op's
    arguments."""
    from torch._C._distributed_c10d import ProcessGroup
    return "".join(
        f" over {ProcessGroup.unbox(a)._get_backend_name()}" for a in leaves
        if isinstance(a, torch.ScriptObject)
        and a._type().name() == "ProcessGroup")


def note(line_kind: str, name: str, *tensors: torch.Tensor) -> None:
    """Write ``<line_kind>::<name>(<tensors>)`` into the active recording, for
    a call the dispatcher does not see; no-op when nothing records."""
    if _ACTIVE:
        _ACTIVE[-1].append(f"{line_kind}::{name}({_describe(tensors)})")


class _Recorder(TorchDispatchMode):
    def __init__(self, lines: list[str]):
        super().__init__()
        self.lines = lines

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = tree_leaves((args, kwargs))
        self.lines.append(f"{func.name()}({_describe(leaves)}) -> "
                          f"{_describe(tree_leaves(out))}{_backends(leaves)}")
        return out


@dataclass
class Program:
    """The recorded program: one line per dispatched op or kernel call."""

    lines: list[str] = field(default_factory=list)

    @property
    def text(self) -> str:
        return "\n".join(self.lines)


@contextlib.contextmanager
def record() -> Iterator[Program]:
    """Record what the body dispatches: ``with record() as program:``."""
    program = Program()
    _ACTIVE.append(program.lines)
    try:
        with _Recorder(program.lines):
            yield program
    finally:
        _ACTIVE.pop()


def _tensors(part: str) -> list[tuple[str, tuple[int, ...], str]]:
    return [(m.group(1), tuple(int(d) for d in m.group(2).split(",") if d),
             m.group(3)) for m in _TENSOR_RE.finditer(part)]


def _nbytes(tensors) -> int:
    total = 0
    for dtype, shape, _ in tensors:
        n = 1
        for d in shape:
            n *= d
        total += n * getattr(torch, dtype).itemsize
    return total


def parse_program(text: str, n_devices: int = 1) -> TransportReport:
    """The transport report of a recorded program (``parse_hlo``'s
    counterpart): its c10d collectives, and a ``host-transfer`` finding for
    each read of a scalar to the host, each device-to-host copy and each
    collective on device tensors over a backend that stages them through
    the host."""
    report = TransportReport()
    for i, line in enumerate(text.splitlines()):
        name, _, rest = line.partition("(")
        ins, _, outs = rest.rpartition(") -> ")
        namespace, _, op = name.partition("::")
        if namespace in ("c10d", "_c10d_functional"):
            kind = next((k for key, k in _COLLECTIVE_KINDS if key in op), None)
            if kind is not None:
                report.ops.append(CollectiveOp(
                    name=f"{name}#{i}", kind=kind,
                    payload_bytes=_nbytes(_tensors(outs) or _tensors(ins)),
                    group_size=n_devices, computation="step"))
                over = _OVER_RE.search(line)
                if (over and over.group(1) in _HOST_STAGED
                        and any(dev == "cuda"
                                for *_, dev in _tensors(rest))):
                    report.findings.append({
                        "severity": "warn", "kind": "host-transfer",
                        "detail": f"op {i}: a collective on device tensors "
                                  f"over {over.group(1)}, which stages them "
                                  f"through host memory ({line})"})
        if name == "aten::_local_scalar_dense":
            report.findings.append({
                "severity": "warn", "kind": "host-transfer",
                "detail": f"op {i}: a scalar read to the host inside the "
                          f"step ({line})"})
        elif (any(dev == "cuda" for *_, dev in _tensors(ins))
              and any(dev == "cpu" for *_, dev in _tensors(outs))):
            report.findings.append({
                "severity": "warn", "kind": "host-transfer",
                "detail": f"op {i}: a copy from the device to the host "
                          f"inside the step ({line})"})
    return report
