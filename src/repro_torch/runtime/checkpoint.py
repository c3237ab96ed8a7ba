"""Content-hashed, atomically committed checkpoints of global tensors.

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

A sharded state (each rank's slices under ``parallel.bind``) is saved
with its ``shardings`` (``launch.bind.state_shardings``): the ranks gather
one leaf at a time to its global tensor and rank 0 streams it into the
file, so the files are those of an unsharded run and a save holds one
global leaf at a time, not the whole state.  ``restore`` with the shardings of
the mesh that stands cuts each global tensor to this rank's slice, so a
state written on one mesh restores onto another (the reference's elastic
restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.ctx import _current

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


def _sha256(path: Path) -> str:
    """The file's sha256, read in 64 MiB blocks."""
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(1 << 26):
            digest.update(block)
    return digest.hexdigest()


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
    def save(self, step: int, state: Any, extra: dict | None = None,
             shardings: Any = None) -> Path:
        """Write ``state`` as checkpoint ``step``.  With ``shardings`` under
        a bound mesh, every rank calls it and gathers one leaf at a time;
        rank 0 streams each gathered leaf into the file and drops it before
        the next gather, so a save holds one global leaf beside the state.
        Every rank returns once the checkpoint is committed, and raises if
        rank 0 failed to write it."""
        t0 = time.time()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        ctx = _current()
        sharded = shardings is not None and ctx is not None
        specs = _flatten(shardings) if sharded else None
        writer = not sharded or dist.get_rank() == 0
        shapes: dict[str, list[int]] = {}
        dtypes: dict[str, str] = {}
        error: BaseException | None = None
        archive = None
        if writer:
            try:
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                archive = zipfile.ZipFile(tmp / SHARD, "w", allowZip64=True)
            except Exception as e:      # the ranks still gather, then raise
                error = e
        try:
            for key, t in _flatten(state).items():
                if sharded:
                    t = ctx.unshard(t, specs[key])
                if archive is not None and error is None:
                    try:
                        arr, dtypes[key] = _to_numpy(t)
                        shapes[key] = list(arr.shape)
                        with archive.open(key + ".npy", "w",
                                          force_zip64=True) as f:
                            np.lib.format.write_array(f, arr)
                        del arr
                    except Exception as e:
                        error = e
                del t
        finally:
            if archive is not None:
                archive.close()
        if writer and error is None:
            try:
                self._commit(step, tmp, final, shapes, dtypes, extra, t0)
            except Exception as e:
                error = e
        if sharded:
            failed = [None if error is None else repr(error)]
            dist.broadcast_object_list(failed, src=0)
            if failed[0] is not None and error is None:
                raise RuntimeError(f"checkpoint {step}: rank 0 did not "
                                   f"write it: {failed[0]}")
        if error is not None:
            raise error
        return final

    def _commit(self, step: int, tmp: Path, final: Path, shapes: dict,
                dtypes: dict, extra: dict | None, t0: float) -> None:
        """The manifest beside the written file, then the atomic rename."""
        manifest = {
            "step": step,
            "format": 1,
            "n_hosts": 1,
            "keys": sorted(shapes),
            "shapes": shapes,
            "dtypes": dtypes,
            "sha256": {SHARD: _sha256(tmp / SHARD)},
            "wall_s": None,
            "extra": extra or {},
        }
        manifest["wall_s"] = round(time.time() - t0, 3)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit
        self._gc()

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, step: int | None, like: Any, shardings: Any = None,
                verify: bool = True) -> Any:
        """The state saved at ``step`` (the latest when None), shaped like
        ``like``: each tensor on its ``like`` leaf's device and in its
        dtype; with ``shardings`` under a bound mesh, this rank's slice of
        each (the mesh may differ from the writer's).  Raises ``IOError``
        on a hash mismatch and ``ValueError`` on a shape mismatch."""
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
            if _sha256(shard_file) != manifest["sha256"][shard_file.name]:
                raise IOError(f"checksum mismatch in {shard_file}")
        data = np.load(shard_file)

        ctx = _current()
        specs = (_flatten(shardings)
                 if shardings is not None and ctx is not None else None)
        out = {}
        for key, leaf in _flatten(like).items():
            t = _to_tensor(data[key], manifest["dtypes"].get(key), leaf)
            if specs is not None:
                t = ctx.shard(t, specs[key])
            if list(t.shape) != list(leaf.shape):
                raise ValueError(f"{key}: checkpoint {tuple(t.shape)} vs "
                                 f"expected {tuple(leaf.shape)}")
            out[key] = t
        return _rebuild(like, out)

    def _gc(self) -> None:
        steps = sorted(
            (int(p.name.split("_")[1]), p) for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp"))
        for _, p in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(p)
