"""Mesh construction on ``torch.distributed``. Counterpart of
``repro/launch/mesh.py``.

Functions, not module-level constants, so that importing never initialises
a process group. Each builds a ``DeviceMesh`` (``init_device_mesh`` with
named dims) over whatever process group is initialised: gloo ranks on the
CPU, NCCL on cards, or the fake process group of the dry-run
(``repro_torch.launch.dryrun``), which gives one process the view of rank
0 of 256 or 512.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.config import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig


def _init(shape: Sequence[int], axes: Sequence[str], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "torch.distributed.init_process_group first")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type 'cuda' requested but no CUDA "
                               "device is available; pass "
                               "device_type='cpu' for a gloo mesh")
        if dist.get_backend() not in ("nccl", "fake"):
            raise RuntimeError(f"a cuda mesh needs the NCCL backend, not "
                               f"{dist.get_backend()!r}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks with a leading 'pod'
    axis."""
    cfg = mesh_config(multi_pod)
    return _init(cfg.shape, cfg.axis_names, device_type)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    return _init(cfg.shape, cfg.axis_names, device_type)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the ranks of the process group."""
    return _init((data, model), ("data", "model"), device_type)


def mesh_config(multi_pod: bool) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH
