"""Device meshes (``repro.launch.mesh`` on PyTorch): functions, not
module constants — importing this module touches no process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, which the caller initialises (NCCL on the
card, gloo on the CPU; ``launch/train.py`` joins torchrun's).  The device
type follows the group: ``"cuda"`` unless its backend is gloo without a
card in use.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_mesh_for_devices",
           "mesh_device_count", "world_size", "join_torchrun_group"]


def join_torchrun_group(backend: str, device: torch.device) -> bool:
    """Join torchrun's process group when its environment is set (True),
    or report its absence (False: a process of its own).  ``backend``:
    ``auto`` is NCCL for ``device`` cuda and gloo for the CPU; gloo on the
    card lets several ranks share one card (it reduces CUDA tensors but
    gathers none)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend == "auto":
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise SystemExit("--backend nccl needs --device cuda")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _make(shape, names, device_type: Optional[str]):
    n = math.prod(shape)
    if n != world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {world_size()}")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl"
                       or torch.cuda.is_initialized() else "cpu")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16×16 = 256 ranks per pod; 2×16×16 = 512 multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device_type)


def make_mesh_for_devices(n: Optional[int] = None, model_parallel: int = 1,
                          device_type=None):
    """Small-scale mesh for local runs and tests: (n/model, model)."""
    n = n if n is not None else world_size()
    assert n % model_parallel == 0
    return _make((n // model_parallel, model_parallel), ("data", "model"),
                 device_type)


def mesh_device_count(mesh) -> int:
    return int(math.prod(tuple(mesh.shape)))
