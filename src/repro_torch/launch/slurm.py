"""Slurm launch-script generation — the deployment half of the PMIx story.

The port of ``repro.launch.slurm``.  The paper's operational claim:
"containerized jobs are submitted to Slurm identically to native jobs, with
the sole modification of specifying the PMIx wire-up protocol"
(--mpi=pmix).  The analogue for a multi-host PyTorch job: identical sbatch
scripts whose only coupling to the host is the coordinator triple that
``core.bootstrap.WireUp`` reads from SLURM_* variables.  ``emit_sbatch``
writes that script for any (arch, shape) cell.  The scripts are the
reference's with four changes: the port's entry point, the CUDA devices'
export in place of the JAX platform's, the comment, and ``--gres=gpu:N``.
"""
from __future__ import annotations

from pathlib import Path

TEMPLATE = """#!/bin/bash
#SBATCH --job-name=repro-{arch}-{shape}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={walltime}
#SBATCH --output=%x-%j.out
{extra_directives}
# One process per host; each host drives its local GPUs.  The only
# host-coupled configuration is the wire-up triple, resolved from SLURM_*
# by repro_torch.core.bootstrap.WireUp (the --mpi=pmix analogue).
export REPRO_COORD_PORT={coord_port}
export CUDA_VISIBLE_DEVICES={visible_devices}

srun --kill-on-bad-exit=1 \\
  {container_prefix}python -m repro_torch.launch.{entry} \\
    --arch {arch} {entry_args}
"""


def emit_sbatch(arch: str, shape: str, *, nodes: int = 64,
                entry: str = "train", entry_args: str = "--full",
                gpus: int = 4, cpus: int = 32,
                walltime: str = "04:00:00", coord_port: int = 9876,
                container_image: str | None = None,
                out_dir: str | Path = "launch_scripts") -> Path:
    """Write an sbatch script for hosts of ``gpus`` GPUs each.  With
    ``container_image`` set, the srun line wraps the command in the
    container runtime exactly the way the paper launches Apptainer images
    (image immutable, wire-up from the host)."""
    prefix = ""
    if container_image:
        prefix = f"apptainer exec --nv {container_image} "
    text = TEMPLATE.format(
        arch=arch, shape=shape, nodes=nodes, cpus=cpus, walltime=walltime,
        coord_port=coord_port, entry=entry, entry_args=entry_args,
        container_prefix=prefix,
        visible_devices=",".join(str(i) for i in range(gpus)),
        extra_directives=f"#SBATCH --gres=gpu:{gpus}",
    )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch}__{shape}__{entry}.sbatch"
    path.write_text(text)
    return path


def emit_all(out_dir: str | Path = "launch_scripts") -> list[Path]:
    from repro_torch.core.registry import all_cells

    paths = []
    for arch, shape in all_cells():
        entry = "train" if shape == "train_4k" else "serve"
        paths.append(emit_sbatch(arch, shape, entry=entry,
                                 out_dir=out_dir))
    return paths


if __name__ == "__main__":
    for p in emit_all():
        print(p)
