"""Mesh construction (port of ``repro.launch.mesh``): ``DeviceMesh``es
over the process group that stands.  Functions only: importing this module
touches no process group and no device."""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import MeshConfig
from repro_torch.parallel.ctx import mesh_of


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    return make_mesh(mesh_config(multi_pod=multi_pod), device=device)


def make_mesh(cfg: MeshConfig, *, device: str = "cuda") -> DeviceMesh:
    return mesh_of(cfg.shape, cfg.axes, device)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    from repro_torch.configs.base import MULTI_POD, SINGLE_POD

    return MULTI_POD if multi_pod else SINGLE_POD
