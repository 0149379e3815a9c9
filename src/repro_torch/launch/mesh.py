"""Production mesh construction.

A FUNCTION (not a module-level constant) so importing this module never
touches ``torch.distributed``.  Single-pod: 16×16 = 256 ranks, axes
("data", "model").  Multi-pod: 2×16×16 = 512 ranks, axes
("pod", "data", "model") — the leading "pod" axis crosses hosts.

The caller initialises the default process group first
(``torch.distributed.init_process_group`` with its address, world size and
rank); a mesh takes the first ranks of it, as the reference takes the
first devices.  Meshes live on ``cuda`` unless the caller asks for
``device_type="cpu"`` (gloo, the CPU tests).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks, have {world} — "
            "initialise a process group of that size first")
    return DeviceMesh(device_type, torch.arange(need).view(*shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for tests and the card's checks."""
    return _mesh(shape, axes, device_type)
