"""Content-hashed, atomically committed checkpoints, on one host.

Port of ``repro.runtime.checkpoint`` with the same on-disk format, so a
checkpoint written by either package restores in the other:

  * ``step_N.tmp/`` is written first, then renamed to ``step_N/`` (a
    crashed writer never corrupts the latest checkpoint);
  * one ``host_00000.npz`` holds every tensor under the reference's key
    names (``params/embed/tok``, ``opt/step``, ``opt/master/...``: the
    state's NamedTuple fields in order, dict keys sorted); bf16 is stored
    as its ``uint16`` bits;
  * ``manifest.json`` records the keys, shapes, logical dtypes and the
    shard's sha256, which ``restore`` verifies.

Elastic resharding onto another device count waits for the multi-GPU
slice of the port.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

SHARD = "host_00000.npz"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves by slash-joined path: NamedTuple fields in order, dict keys
    sorted (the order and names of ``jax.tree_util``'s paths)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    flat: dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _rebuild(like: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, flat, key(k))
                            for k, v in zip(like._fields, like)))
    return flat[prefix]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """``(storable array, logical dtype name)``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str | None,
               like: torch.Tensor) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: dict | None = None) -> Path:
        t0 = time.time()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        converted = {k: _to_numpy(t) for k, t in _flatten(state).items()}
        shard_file = tmp / SHARD
        np.savez(shard_file, **{k: a for k, (a, _) in converted.items()})
        digest = hashlib.sha256(shard_file.read_bytes()).hexdigest()

        manifest = {
            "step": step,
            "format": 1,
            "n_hosts": 1,
            "keys": sorted(converted),
            "shapes": {k: list(a.shape) for k, (a, _) in converted.items()},
            "dtypes": {k: name for k, (_, name) in converted.items()},
            "sha256": {shard_file.name: digest},
            "wall_s": None,
            "extra": extra or {},
        }
        manifest["wall_s"] = round(time.time() - t0, 3)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))

        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit
        self._gc()
        return final

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, step: int | None, like: Any, verify: bool = True) -> Any:
        """The state saved at ``step`` (the latest when None), shaped like
        ``like``: each tensor on its ``like`` leaf's device and in its
        dtype.  Raises ``IOError`` on a hash mismatch and ``ValueError`` on
        a shape mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        shard_file = path / SHARD
        if not shard_file.exists():  # written by more hosts than this one
            shard_file = sorted(path.glob("host_*.npz"))[0]
        if verify and shard_file.name in manifest["sha256"]:
            digest = hashlib.sha256(shard_file.read_bytes()).hexdigest()
            if digest != manifest["sha256"][shard_file.name]:
                raise IOError(f"checksum mismatch in {shard_file}")
        data = np.load(shard_file)

        out = {}
        for key, leaf in _flatten(like).items():
            arr = data[key]
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} vs expected "
                                 f"{tuple(leaf.shape)}")
            out[key] = _to_tensor(arr, manifest["dtypes"].get(key), leaf)
        return _rebuild(like, out)

    def _gc(self) -> None:
        steps = sorted(
            (int(p.name.split("_")[1]), p) for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp"))
        for _, p in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(p)
