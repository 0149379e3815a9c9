"""Global mesh context — lets model code apply sharding constraints without
threading the mesh through every call signature.

``use_mesh(mesh)`` installs a ``torch.distributed.device_mesh.DeviceMesh``
(with ``mesh_dim_names``) for the dynamic extent; ``constrain`` becomes the
identity when no mesh is installed (one card, one process).

The model code of this package is per rank: each process computes on its
own batch shard with plain tensors, as the body of a ``shard_map`` does.
So under a mesh ``constrain`` redistributes a ``DTensor`` to the spec's
placements and returns a plain tensor as it is; the calls stand at the
reference's layout points, where a whole-program accounting can find them.
The per-rank code lays the residual stream out itself: under
``use_seq_shard(True)`` (Megatron-SP, the reference's ``constrain_tokens(
seq_shard=True)``) each rank of "model" holds its S/n rows of it between
the tensor-parallel regions (``distributed.collectives.region_in`` /
``region_out``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

_MESH: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_SEQ: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_seq_shard", default=False)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None) -> Iterator[None]:
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def use_seq_shard(on: bool) -> Iterator[None]:
    """Within the block, the residual stream is this rank's rows of the
    sequence over "model" where ``on`` (the caller decides: a "model"
    axis of n > 1 ranks that divides the sequence)."""
    token = _SEQ.set(bool(on))
    try:
        yield
    finally:
        _SEQ.reset(token)


def seq_sharded() -> bool:
    return _SEQ.get()


def axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of mesh axis ``name``; 1 when the mesh has no such axis."""
    names = axis_names(mesh)
    return mesh.shape[names.index(name)] if name in names else 1


def batch_axes(mesh: DeviceMesh | None = None) -> tuple[str, ...]:
    """Mesh axes the batch dimension is sharded over (pod+data)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def fsdp_axis(mesh: DeviceMesh | None = None) -> str | None:
    mesh = mesh or current_mesh()
    if mesh is None or "data" not in axis_names(mesh):
        return None
    return "data"


def model_axis_size(mesh: DeviceMesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return 1
    return axis_size(mesh, "model")


def model_group(mesh: DeviceMesh | None = None):
    """The process group of the "model" axis; None without one."""
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return None
    return mesh.get_group("model")


def model_rank(mesh: DeviceMesh | None = None) -> int:
    """This rank's coordinate on the "model" axis; 0 without one."""
    mesh = mesh or current_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return 0
    return mesh.get_local_rank("model")


def data_shards(mesh: DeviceMesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return math.prod(axis_size(mesh, a) for a in batch_axes(mesh))


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """Redistribute a ``DTensor`` to ``spec`` iff a mesh is installed; a
    plain (per-rank) tensor is returned as it is."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    from .sharding import placements
    return x.redistribute(mesh, placements(mesh, spec))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading (batch) dim over pod+data, rest replicated."""
    mesh = current_mesh()
    if mesh is None:
        return x
    ba = batch_axes(mesh)
    return constrain(x, ba, *([None] * (x.ndim - 1)))


def constrain_tokens(x: torch.Tensor, *, seq_shard: bool = False
                     ) -> torch.Tensor:
    """Residual stream (B, S, d): batch over pod+data; optionally shard the
    sequence dim over "model" (Megatron-SP)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    ba = batch_axes(mesh)
    if (seq_shard and "model" in axis_names(mesh)
            and x.ndim >= 3 and x.shape[1] % axis_size(mesh, "model") == 0):
        return constrain(x, ba, "model", *([None] * (x.ndim - 2)))
    return constrain(x, ba, *([None] * (x.ndim - 1)))
