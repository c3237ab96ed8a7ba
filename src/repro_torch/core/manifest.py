"""Environment manifests: the container image of the port.

The port of ``repro.core.manifest``, in the same three parts:

  portable part   — PortableEnv: model/shape/train configs, the rule set,
                    the torch, CUDA and numpy versions, the ``nvcc`` flags
                    the kernels are built with, the dtype policy.
                    Hashable; two runs with equal hashes are the same
                    "image".
  host binding    — HostBinding: the device's name, count and platform, the
                    mesh, the host name, the driver version and power limit
                    (``nvidia-smi``), and the card's peaks from its data
                    sheet.  Attached late (``bind()``).
  attestation     — the first step's program (``core.attest``): its
                    fingerprint and size, and the collective summary.  The
                    same portable hash with another program fingerprint is
                    the "container behaves differently on this site"
                    signal; the reference fingerprints the compiled HLO.

Manifests serialize to JSON with the reference's top-level keys; ``diff``
explains any mismatch with the reference's tags.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.kernels.build import NVCC_FLAGS

# Dense peaks by device name, from the card's data sheet (NVIDIA H100 SXM:
# 989 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3), rated at its 700 W
# power limit; a card set below it runs slower.  A device not listed
# records null: no figure is assumed for it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 989e12, "hbm_bw": 3.35e12},
}


def _hash(obj: Any) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()[:16]


@dataclass(frozen=True)
class PortableEnv:
    """Everything that must be identical across sites."""

    model: dict
    shape: dict
    train: dict
    rules: str
    torch_version: str = ""
    cuda_version: str | None = None
    nvcc_flags: str = ""
    numpy_version: str = ""
    python_version: str = ""
    dtype_policy: str = "bf16-params/f32-master"

    @classmethod
    def capture(cls, model: ModelConfig, shape: ShapeConfig,
                train: TrainConfig | None = None,
                rules: str = "auto") -> "PortableEnv":
        return cls(
            model=dataclasses.asdict(model),
            shape=dataclasses.asdict(shape),
            train=dataclasses.asdict(train or TrainConfig()),
            rules=rules,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            nvcc_flags=" ".join(NVCC_FLAGS),
            numpy_version=np.__version__,
            python_version=sys.version.split()[0],
        )

    @property
    def image_hash(self) -> str:
        return _hash(dataclasses.asdict(self))


def nvidia_smi(index: int) -> tuple[str, str, str] | None:
    """``(name, power.limit, driver_version)`` of CUDA device ``index`` as
    ``nvidia-smi`` prints them, or None where it cannot be run.  The row is
    found by the device's UUID (``nvidia-smi`` numbers every card of the
    host, CUDA only the visible ones), else by the index."""
    try:
        out = subprocess.run(
            ["nvidia-smi",
             "--query-gpu=uuid,name,power.limit,driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    rows = [[f.strip() for f in line.split(",")]
            for line in out.strip().splitlines()]
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    for row in rows:
        if uuid is not None and row[0] == f"GPU-{uuid}":
            return tuple(row[1:])
    return tuple(rows[index][1:]) if index < len(rows) else None


@dataclass(frozen=True)
class HostBinding:
    """Site-specific, non-encapsulatable facts (late-bound)."""

    device_kind: str
    n_devices: int
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    platform_: str = ""
    hostname: str = ""
    driver_version: str | None = None
    power_limit: str | None = None
    peak_flops: float | None = None
    hbm_bw: float | None = None

    @classmethod
    def capture(cls, device: str | torch.device,
                mesh: MeshConfig) -> "HostBinding":
        dev = torch.device(device)
        if dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            kind = torch.cuda.get_device_name(index)
            smi = nvidia_smi(index)
            driver, power = (smi[2], smi[1]) if smi else (None, None)
            platform_ = "gpu"
        else:
            kind, driver, power, platform_ = "cpu", None, None, dev.type
        peaks = PEAKS.get(kind, {})
        return cls(
            device_kind=kind,
            n_devices=mesh.n_devices,
            mesh_shape=tuple(mesh.shape),
            mesh_axes=tuple(mesh.axes),
            platform_=platform_,
            hostname=platform.node(),
            driver_version=driver,
            power_limit=power,
            peak_flops=peaks.get("peak_flops"),
            hbm_bw=peaks.get("hbm_bw"),
        )


@dataclass
class Manifest:
    portable: PortableEnv
    binding: HostBinding | None = None
    attestation: dict = field(default_factory=dict)

    def bind(self, device: str | torch.device,
             mesh: MeshConfig) -> "Manifest":
        self.binding = HostBinding.capture(device, mesh)
        return self

    def attest(self, *, program_text: str | None = None,
               collectives: dict | None = None) -> "Manifest":
        if program_text is not None:
            self.attestation["program_fingerprint"] = hashlib.sha256(
                program_text.encode()).hexdigest()[:16]
            self.attestation["program_bytes"] = len(program_text)
        if collectives is not None:
            self.attestation["collectives"] = collectives
        return self

    # ---- serialization ----
    def to_json(self) -> str:
        return json.dumps({
            "image_hash": self.portable.image_hash,
            "portable": dataclasses.asdict(self.portable),
            "binding": dataclasses.asdict(self.binding) if self.binding else None,
            "attestation": self.attestation,
        }, indent=1, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        raw = json.loads(text)
        portable = PortableEnv(**raw["portable"])
        m = cls(portable=portable)
        if raw.get("binding"):
            b = raw["binding"]
            b["mesh_shape"] = tuple(b["mesh_shape"])
            b["mesh_axes"] = tuple(b["mesh_axes"])
            m.binding = HostBinding(**b)
        m.attestation = raw.get("attestation", {})
        return m


def diff(a: Manifest, b: Manifest) -> list[str]:
    """Explain differences between two manifests (paper Table 1, automated).

    Portable-part differences are *environment divergence* (a reproducibility
    bug); binding differences are expected host variation; attestation
    differences under equal portable hashes indicate the binding changed the
    dispatched program — the thing the paper's microbenchmarks exist to
    catch.
    """
    out: list[str] = []
    da, db = dataclasses.asdict(a.portable), dataclasses.asdict(b.portable)
    for k in sorted(set(da) | set(db)):
        if da.get(k) != db.get(k):
            out.append(f"portable.{k}: {da.get(k)!r} != {db.get(k)!r}")
    if a.binding and b.binding:
        ba, bb = dataclasses.asdict(a.binding), dataclasses.asdict(b.binding)
        for k in sorted(set(ba) | set(bb)):
            if ba.get(k) != bb.get(k):
                out.append(f"binding.{k}: {ba.get(k)!r} != {bb.get(k)!r} (host)")
    fa = a.attestation.get("program_fingerprint")
    fb = b.attestation.get("program_fingerprint")
    if fa and fb and fa != fb:
        tag = ("EXPECTED (binding differs)" if out else
               "UNEXPECTED — same env+binding, different program")
        out.append(f"attestation.program_fingerprint: {fa} != {fb} [{tag}]")
    return out
