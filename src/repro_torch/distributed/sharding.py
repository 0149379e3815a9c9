"""Sharding rules: parameter/optimizer/activation/cache specs, and their
placement as ``DTensor``s on a ``DeviceMesh``.

Conventions (the reference's ``distributed/sharding.py``):
* batch dims shard over ("pod","data") — pure DP across pods;
* weights shard over "model" (TP/EP) plus "data" (FSDP / ZeRO-3) on a large
  non-TP dim, replicated across "pod";
* a dim is sharded over an axis only if divisible by the axis size — rules
  degrade to replication rather than producing invalid specs.

A spec is a tuple with one entry per tensor dim, in the form of
``jax.sharding.PartitionSpec``: ``None``, an axis name, or a tuple of axis
names.  The rules read a leaf's path as the reference names it: the port's
``layers.{i}.attn.wq`` is the reference's ``layers/attn/wq`` without its
leading (num_layers) axis, so a layer leaf's rule sees its shape with a
leading axis put back, and its spec drops that axis again.  The layer index
(and llama4's ``s{i}`` sub-layer, which no rule reads) is not part of the
path.

``shard_params(model, mesh)`` places every parameter as a ``DTensor`` by
its spec; a rank then holds what the rules give it.  The model code is per
rank and computes on plain tensors: ``gathered(module, keep=("model",))``
puts each ``DTensor`` parameter's value in its place for the extent of a
call and puts the ``DTensor`` back after it.  What is gathered:

* a leaf that its module lists in ``model_dims`` (attention's ``wq``,
  ``wk``, ``wv``, ``wo`` and biases, MLA's ``wq_b``, ``wk_b``, ``wv_b``,
  ``wo``, the dense MLP's and the shared expert's ``wi``, ``wg``, ``wo``,
  the SSM's ``w_out`` where its heads divide "model", the MoE's experts)
  and whose spec puts "model" on that dim (its heads, columns or experts)
  keeps its "model" shard: the layer computes its own heads, columns or
  experts and sums the row-parallel products over "model"
  (``models.layers``, ``models.ssm``, ``models.moe``).  Only its other
  axes ("data": FSDP) are gathered;
* every other leaf (norm scales, the router, MLA's down projections
  ``wq_a`` and ``wkv_a``, the SSM's ``w_in``, conv, ``A_log``, ``D`` and
  ``dt_bias``, the embedding and head, ``wk``/``wv`` whose rule shards
  the head dim because the KV heads do not divide "model", a leaf whose
  "model" entry ``_maybe`` dropped) is gathered to its full value.  A
  tensor-parallel layer narrows such a leaf to the share it computes (the
  SSM: the columns and channels of its heads, ``models.ssm``; attention:
  the KV heads its query heads read) and sums its gradient over "model".

The gather is a sum over the axis group of zero-padded shards, which every
backend (NCCL; gloo also for CUDA tensors) can all-reduce.  Its backward
sums the gradient over the batch axes, where each rank saw other tokens
(whether the leaf is sharded over them or replicated), then takes the
rank's slice.  A "model" shard is not summed over "model": each rank's
gradient of its own heads or columns is whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .context import axis_names, axis_size as _axsize

Spec = tuple
_BATCH_AXES = ("pod", "data")


def _fits(dim: int, mesh: DeviceMesh, axis: str | None) -> bool:
    if axis is None:
        return True
    return axis in axis_names(mesh) and dim % _axsize(mesh, axis) == 0


def _maybe(dim: int, mesh: DeviceMesh, axis: str | None):
    return (axis if axis is not None and _fits(dim, mesh, axis)
            and _axsize(mesh, axis) > 1 else None)


def batch_spec(mesh: DeviceMesh, shape: tuple[int, ...]) -> Spec:
    """Shard dim 0 over pod×data; drop axes that don't divide the batch."""
    ba: list[str] = []
    n = 1
    for a in _BATCH_AXES:
        if a in axis_names(mesh) and shape[0] % (n * _axsize(mesh, a)) == 0:
            ba.append(a)
            n *= _axsize(mesh, a)
    return (tuple(ba) if ba else None, *([None] * (len(shape) - 1)))


# ---------------------------------------------------------------------------
# Parameter specs by tree path
# ---------------------------------------------------------------------------


def _param_spec(path: tuple[str, ...], shape: tuple[int, ...],
                mesh: DeviceMesh) -> Spec:
    """Map one parameter (by its reference tree path + reference shape,
    layer leaves with their leading L axis) to a spec."""
    name = path[-1]
    inside_layers = "layers" in path
    fsdp = "data" if "data" in axis_names(mesh) else None

    def spec(*axes):
        # validate divisibility dim-by-dim; drop the axis if it doesn't fit
        return tuple(_maybe(d, mesh, a) for d, a in zip(shape, axes))

    # ---- top level ----
    if not inside_layers:
        if name == "embed":
            return spec("model", fsdp)
        if name == "lm_head":
            return spec(fsdp, "model")
        if name == "adapter":
            return spec(None, fsdp)
        return ()                                   # final_norm etc.

    # strip the leading L (scan) dim for layer params
    def lspec(*axes):
        return spec(None, *axes)

    parent = path[-2] if len(path) >= 2 else ""
    grand = path[-3] if len(path) >= 3 else ""

    if name == "scale":                              # any RMSNorm
        return ()
    # ---- attention ----
    if parent == "attn" or grand == "attn":
        if name == "wq":
            return lspec(fsdp, "model", None)
        if name in ("wk", "wv"):
            # kv heads rarely divide the model axis; shard head_dim instead
            if _fits(shape[2], mesh, "model") and shape[2] >= _axsize(mesh, "model"):
                return lspec(fsdp, "model", None)
            return lspec(fsdp, None, "model")
        if name == "wo":
            return lspec("model", None, fsdp)
        if name in ("bq",):
            return lspec("model", None)
        if name in ("bk", "bv"):
            return lspec(None, "model") if not _fits(shape[1], mesh, "model") \
                else lspec("model", None)
        # MLA
        if name == "wq_a":
            return lspec(fsdp, None)
        if name == "wq_b":
            return lspec(None, "model", None)
        if name == "wkv_a":
            return lspec(fsdp, None)
        if name in ("wk_b", "wv_b"):
            return lspec(None, "model", None)
    # ---- mlp (incl. moe shared expert) ----
    if parent in ("mlp", "shared"):
        if name in ("wi", "wg"):
            return lspec(fsdp, "model")
        if name == "wo":
            return lspec("model", fsdp)
    # ---- moe ----
    if parent == "moe":
        if name == "router":
            return ()
        if name in ("w_in", "w_gate"):
            return lspec("model", fsdp, None)
        if name == "w_out":
            return lspec("model", None, fsdp)
    # ---- ssm ----
    if parent == "ssm":
        if name == "w_in":
            return lspec(fsdp, "model")
        if name == "conv_w":
            return lspec(None, "model")
        if name == "conv_b":
            return lspec("model")
        if name == "w_out":
            return lspec("model", fsdp)
        if name in ("A_log", "D", "dt_bias"):
            return ()
    return ()


def _path_names(keys: tuple[str, ...]) -> tuple[str, ...]:
    """The reference's path of a leaf under nested-dict ``keys``: each key
    is split at its dots (a ``named_parameters()`` name) and the layer
    indices are dropped."""
    return tuple(part for key in keys for part in str(key).split(".")
                 if not part.isdigit())


def _flat(tree: Any, keys: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, keys + (k,))]
    return [(keys, tree)]


def _unflat(pairs: list[tuple[tuple, Any]]) -> Any:
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    out: dict = {}
    for keys, val in pairs:
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return out


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, full: torch.Tensor) -> DTensor:
        """``full`` (the same value on every rank) as a ``DTensor`` holding
        this rank's slice; no communication."""
        pl = self.placements
        local = local_slice(full, self.mesh, pl)
        if local is not full:
            local = local.clone()           # free the full value's storage
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=full.shape, stride=full.stride())


def param_shardings(params: Any, mesh: DeviceMesh) -> Any:
    """``NamedSharding`` tree matching a parameter tree: a ``Model`` (its
    ``named_parameters()``), a dict keyed by those names (``param_specs``),
    or an optimizer state tree over such dicts.

    Full-shape moments ("m"/"v" subtrees) reuse the parameter rules via
    their path tail; Adafactor's factored moments ("vr"/"vc", one dim
    removed) inherit the parent spec minus the removed dim.  A moment kept
    for a whole stack of layers (FactoredAdam's, under a layer path with
    no index) has its leading axis already and keeps it.
    """
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    out = []
    for keys, leaf in _flat(params):
        names = _path_names(keys)
        layer = any(part.isdigit() for key in keys
                    for part in str(key).split("."))
        shape = ((1,) if layer else ()) + _shape(leaf)
        if names[-1] == "vr":          # parent shape minus last dim
            parent = _param_spec(names[:-1], shape + (1,), mesh)
            spec = (tuple(parent) + (None,) * (len(shape) - len(parent)))[
                :len(shape)]
        elif names[-1] == "vc":        # parent shape minus dim -2
            parent = _param_spec(names[:-1],
                                 shape[:-1] + (1,) + shape[-1:], mesh)
            pl = tuple(parent) + (None,) * (len(shape) + 1 - len(parent))
            spec = pl[:len(shape) - 1] + (pl[len(shape)],)
        else:
            spec = _param_spec(names, shape, mesh)
        # drop axes that don't divide (factored shapes can break divisibility)
        fixed = []
        padded = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        for i, a in enumerate(padded[:len(shape)]):
            if a is None:
                fixed.append(None)
                continue
            axes = a if isinstance(a, tuple) else (a,)
            n = math.prod(_axsize(mesh, ax) for ax in axes)
            fixed.append(a if n > 0 and shape[i] % n == 0 else None)
        out.append((keys, NamedSharding(mesh, tuple(fixed[1:] if layer
                                                    else fixed))))
    return _unflat(out)


# ---------------------------------------------------------------------------
# Cache specs (decode)
# ---------------------------------------------------------------------------


def cache_shardings(cache: Any, mesh: DeviceMesh, *,
                    seq_shard: bool = False) -> Any:
    """Decode-cache specs (the cache keeps the reference's stacked layout).

    ``seq_shard=True`` shards the cache *sequence* dim over "model"
    (flash-decode style) instead of head-dim-sharded K/V.
    """
    def _ba(dim: int):
        out, n = [], 1
        for a in _BATCH_AXES:
            if a in axis_names(mesh) and dim % (n * _axsize(mesh, a)) == 0:
                out.append(a)
                n *= _axsize(mesh, a)
        return tuple(out) if out else None

    def one(name: str, shp: tuple[int, ...]) -> Spec:
        ba = _ba(shp[1]) if len(shp) > 1 else None
        if name == "pos":
            return ()
        if name in ("k", "v"):           # (L, B, S, KH, hd)
            if seq_shard and _fits(shp[2], mesh, "model"):
                return (None, ba, "model", None, None)
            kh_ok = _fits(shp[3], mesh, "model") and shp[3] >= _axsize(mesh, "model")
            return ((None, ba, None, "model", None) if kh_ok
                    else (None, ba, None, None, _maybe(shp[4], mesh, "model")))
        if name in ("ckv", "krope"):     # (L, B, S, r)
            if seq_shard and _fits(shp[2], mesh, "model"):
                return (None, ba, "model", None)
            return (None, ba, None, _maybe(shp[3], mesh, "model"))
        if name == "state":              # (L, B, nh, hp, ds)
            if _fits(shp[2], mesh, "model"):
                return (None, ba, "model", None, None)
            return (None, ba, None, _maybe(shp[3], mesh, "model"), None)
        if name == "conv":               # (L, B, K-1, conv_dim)
            return (None, ba, None, _maybe(shp[3], mesh, "model"))
        return ()

    return _unflat([(keys, NamedSharding(mesh, one(str(keys[-1]), _shape(l))))
                    for keys, l in _flat(cache)])


def batch_shardings(batch: Any, mesh: DeviceMesh) -> Any:
    return _unflat([(keys, NamedSharding(mesh, batch_spec(mesh, _shape(l))))
                    for keys, l in _flat(batch)])


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """A spec as one placement per mesh dim: a tensor dim sharded over
    ("pod", "data") takes ``Shard(dim)`` on both mesh dims, the first
    named the major one (mesh order, as the reference's device order)."""
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (() if entry is None
                else entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def local_slice(full: torch.Tensor, mesh: DeviceMesh,
                pl: tuple) -> torch.Tensor:
    """This rank's slice of ``full`` under placements ``pl`` (a view)."""
    t = full
    for i, p in enumerate(pl):
        n = mesh.shape[i]
        if isinstance(p, Shard) and n > 1:
            size, rem = divmod(t.shape[p.dim], n)
            if rem:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"divide over {n} shards")
            t = t.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    return t


class _Gather(torch.autograd.Function):
    """The full value of a local shard over the mesh dims it is sharded on
    (except ``keep``'s axes).  Backward: the gradient summed over the
    batch axes of more than one rank, then the rank's slice."""

    @staticmethod
    def forward(ctx, local, mesh, pl, keep):
        names = axis_names(mesh)
        dims = [i for i, p in enumerate(pl) if isinstance(p, Shard)
                and mesh.shape[i] > 1 and names[i] not in keep]
        ctx.mesh, ctx.pl, ctx.dims = mesh, pl, dims
        t = local
        for i in reversed(dims):                 # minor axis first
            d, n = pl[i].dim, mesh.shape[i]
            shape = list(t.shape)
            size = shape[d]
            shape[d] = size * n
            full = t.new_zeros(shape)
            full.narrow(d, mesh.get_local_rank(i) * size, size).copy_(t)
            dist.all_reduce(full, group=mesh.get_group(i))
            t = full
        return t if dims else t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        mesh, pl = ctx.mesh, ctx.pl
        batch = _batch_dims(mesh)
        g = grad
        for i in range(len(pl)):                 # major axis first
            if i in batch:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=mesh.get_group(i))
            if i in ctx.dims:
                size = g.shape[pl[i].dim] // mesh.shape[i]
                g = g.narrow(pl[i].dim, mesh.get_local_rank(i) * size, size)
        return g, None, None, None


def _batch_dims(mesh: DeviceMesh) -> list[int]:
    """The mesh dims of the batch axes with more than one rank."""
    names = axis_names(mesh)
    return [i for i, a in enumerate(names)
            if a in _BATCH_AXES and mesh.shape[i] > 1]


def gather(p: torch.Tensor, keep: tuple[str, ...] = ()) -> torch.Tensor:
    """A ``DTensor``'s full value as a plain tensor, its shards over
    ``keep``'s mesh axes left in place; a plain tensor as it is.  Where
    autograd records, the gradient is summed over the batch axes."""
    if not isinstance(p, DTensor):
        return p
    mesh, pl = p.device_mesh, tuple(p.placements)
    names = axis_names(mesh)
    sharded = any(isinstance(x, Shard) and mesh.shape[i] > 1
                  and names[i] not in keep for i, x in enumerate(pl))
    summed = p.requires_grad and torch.is_grad_enabled() and _batch_dims(mesh)
    if not (sharded or summed):
        return p.to_local()
    return _Gather.apply(p.to_local(), mesh, pl, tuple(keep))


def _model_dim(p: torch.Tensor) -> int | None:
    """The tensor dim a ``DTensor`` is sharded on over a "model" axis of
    more than one rank; None otherwise."""
    if not isinstance(p, DTensor):
        return None
    mesh = p.device_mesh
    names = axis_names(mesh)
    if "model" not in names or _axsize(mesh, "model") == 1:
        return None
    pl = p.placements[names.index("model")]
    return pl.dim if isinstance(pl, Shard) else None


@contextlib.contextmanager
def gathered(module: nn.Module, *, skip: str | None = None,
             keep: tuple[str, ...] = ()) -> Iterator[None]:
    """Within the block: each ``DTensor`` parameter of ``module`` (but
    those whose names start with ``skip``) replaced by its ``gather``.  A
    leaf listed in its module's ``model_dims`` (leaf -> dim) keeps its
    shards over ``keep``'s axes where it is sharded on that dim over
    "model".  The parameters are put back after it."""
    swapped = []
    try:
        for name, p in list(module.named_parameters()):
            if not isinstance(p, DTensor) or (skip and name.startswith(skip)):
                continue
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            dim = getattr(owner, "model_dims", {}).get(leaf)
            kept = keep if dim is not None and _model_dim(p) == dim else ()
            swapped.append((owner, leaf, p))
            owner._parameters[leaf] = gather(p, kept)
        yield
    finally:
        for owner, leaf, p in swapped:
            owner._parameters[leaf] = p


def assign(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Make ``value`` the parameter ``name`` of ``model``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    old = owner._parameters[leaf]
    owner._parameters[leaf] = nn.Parameter(
        value, requires_grad=old.requires_grad if old is not None else False)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place every parameter of ``model`` as a ``DTensor`` by its spec on
    ``mesh``, in place; returns ``model``.  Every rank must hold the same
    full values (weights from one seed, or one checkpoint): each keeps its
    own slice, with no communication."""
    shardings = param_shardings(model, mesh)
    for name, p in list(model.named_parameters()):
        assign(model, name, shardings[name].place(p.detach()))
    return model
