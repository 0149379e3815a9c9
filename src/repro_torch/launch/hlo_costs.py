"""Cost accounting of the operators a function dispatches — the port's
counterpart of ``src/repro/launch/hlo_costs.py``.

The reference parses XLA's compiled HLO text, whose ``cost_analysis`` visits
a ``while`` body once, and multiplies the bodies by their trip counts.  The
port has no HLO: it runs eagerly, so the program is the sequence of
operators the dispatcher sees while the function runs once.  Every layer,
every recomputation under ``remat="full"`` and every backward op is
dispatched, so nothing is multiplied by hand.  ``analyze(fn, *args)`` runs
``fn`` once under a dispatch mode of its own and accumulates, for this
process (one rank):

* ``flops``       — ``torch.utils.flop_counter``'s formulas, those
                    ``FlopCounterMode`` applies (products, and the five
                    kernels at their own: ``kernels._nvcc.kernel_op``).
                    ``FlopCounterMode`` itself is not entered: its module
                    tracker keeps tensors alive past their last use, and
                    it decomposes operators that have no formula, both of
                    which change the memory this same run follows (a tiny
                    hybrid step's peak: 104 MB under it, 60 MB without).
                    ``tests/test_torch_hlo_costs.py`` holds the two counts
                    equal on every configuration's steps;
* ``bytes_kernelized`` — Σ operand + output bytes over the operators
                    (views move none; an indexed read or write is billed
                    for the rows it touches, not the whole table, as the
                    reference bills ``gather`` / ``dynamic-update-slice``),
                    each kernel at its own inputs and outputs;
* ``flash_loop_bytes`` — what K2's plain version would move in scores and
                    probabilities, which the kernel keeps on chip;
* ``bytes``       — the two together, the traffic of the plain program;
* ``collective_bytes`` / ``collective_counts`` per kind, from the ``c10d``
                    and ``_c10d_functional`` operators (a ``DTensor``'s
                    redistributions included; the sums of the
                    tensor-parallel layers' ``psum`` and ``sum_grads`` and
                    of the sharded leaves' gathers): operand bytes per
                    rank;
* ``op_flops``    — the FLOPs by operator (``aten.mm``,
                    ``repro_torch.flash_attention``, ...), whose sum is
                    ``flops``: under a mesh with a "model" axis of n, the
                    attention and MLP products and K2 / K2-bwd are each
                    rank's 1/n (``tests/test_torch_dryrun.py``).

A ``DTensor`` operand is billed at its local shard.  With ``external``
tensors given (the step's arguments), ``CostMode`` also follows the bytes
of the storages alive on this rank, from those through every operator's
outputs until each storage is freed, and keeps their peak: what
``torch.cuda.max_memory_allocated`` reads on the card, before the
allocator's rounding.  (``torch.distributed._tools.mem_tracker`` does not
serve here: its module hooks hook the gradients of parameters, and
``distributed.sharding.gathered`` puts non-leaf tensors in their place
for a layer's call.)  Works on real, fake and ``meta`` tensors alike, so
the same accounting reads a dry run and a real step.
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import _nvcc

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective operator -> (kind, index of the operand argument)
_COLLECTIVE_OPS = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    # a DTensor's shard-to-shard reshard on a cuda mesh
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
}

# operators that move no device bytes of their own
_FREE = {"aten.empty", "aten.empty_strided", "aten.empty_like",
         "aten.new_empty", "aten.new_empty_strided", "aten.detach",
         "aten.lift_fresh", "aten._local_scalar_dense", "prim.device",
         "_c10d_functional.wait_tensor", "aten.is_same_size",
         "aten._unsafe_view"}
# indexed reads: billed for the rows they return (and the indices)
_GATHERS = {"aten.index", "aten.embedding", "aten.gather",
            "aten.index_select"}
# indexed writes: billed for the values written twice (and the indices)
_SCATTERS = {"aten.index_put", "aten.index_put_", "aten._index_put_impl_",
             "aten.scatter", "aten.scatter_", "aten.scatter_add",
             "aten.scatter_add_", "aten.index_add", "aten.index_add_",
             "aten.index_copy", "aten.index_copy_"}
_TRANSCENDENTAL = {"aten.exp", "aten.exp2", "aten.log", "aten.log1p",
                   "aten.tanh", "aten.rsqrt", "aten.sqrt", "aten.sigmoid",
                   "aten.silu", "aten.erf", "aten._softmax",
                   "aten._log_softmax", "aten.logsumexp", "aten.softplus"}


def _name(func) -> str:
    """``namespace.op`` of an operator (its overload dropped)."""
    return str(func._overloadpacket)


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


def _locals(tree):
    return tree_map(_local, tree)


def _nbytes(x) -> int:
    x = _local(x)
    if not isinstance(x, torch.Tensor):
        return 0
    return x.numel() * x.element_size()


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in tree_flatten(tree)[0])


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


class _Recorder:
    """The totals, and per operator for ``breakdown``."""

    def __init__(self):
        self.flops = 0
        self.op_flops: dict[str, int] = collections.Counter()
        self.bytes = 0
        self.loop_bytes = 0
        self.transcendentals = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.op_bytes: dict[str, int] = collections.Counter()

    def collective(self, name: str, args) -> bool:
        """Record ``name`` if it is a collective; whether it was."""
        if name not in _COLLECTIVE_OPS:
            return False
        kind, at = _COLLECTIVE_OPS[name]
        nbytes = _tree_bytes(args[at]) if len(args) > at else 0
        self.collective_bytes[kind] += nbytes
        self.collective_counts[kind] += 1
        return True

    def op(self, func, args, kwargs, out) -> None:
        name = _name(func)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*_locals(args), **_locals(kwargs),
                        out_val=_locals(out))
            self.flops += n
            self.op_flops[name] += n
        if name in _FREE or (_is_view(func) and name not in _SCATTERS):
            return
        kernel = _nvcc.KERNEL_OPS.get(func._overloadpacket)
        if kernel is not None and kernel.loop_bytes is not None:
            self.loop_bytes += kernel.loop_bytes(*args)
        out_b = _tree_bytes(out)
        tensors = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(_local(x), torch.Tensor)]
        in_bytes = [_nbytes(x) for x in tensors]
        if name in _GATHERS:
            # the table is the largest operand: bill the rows read
            nbytes = 2 * out_b + sum(in_bytes) - max(in_bytes, default=0)
        elif name in _SCATTERS:
            # the destination is the largest operand: bill what is written
            small = sum(in_bytes) - max(in_bytes, default=0)
            nbytes = 2 * small
        else:
            nbytes = sum(in_bytes) + out_b
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(
                _local(x).numel() for x in tree_flatten(out)[0]
                if isinstance(_local(x), torch.Tensor))
        self.bytes += nbytes
        self.op_bytes[name] += nbytes


class _Collectives(TorchDispatchMode):
    """Inside a ``DTensor`` operator: the collectives its redistributions
    issue, nothing else (the operator itself was billed at its shards)."""

    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self.rec.collective(_name(func), args)
        return func(*args, **(kwargs or {}))


class _Live:
    """Bytes of the storages alive on this rank, and their peak."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, nbytes: int) -> None:
        self.now -= nbytes

    def add(self, tree) -> None:
        for x in tree_flatten(tree)[0]:
            x = _local(x)
            if not isinstance(x, torch.Tensor):
                continue
            st = x.untyped_storage()
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[st] = nbytes
            weakref.finalize(st, self._free, nbytes)
            self.now += nbytes
        self.peak = max(self.peak, self.now)


class CostMode(TorchDispatchMode):
    """Bills every operator dispatched under it into a ``_Recorder``; with
    ``external`` tensors (those alive when it is entered), follows the
    live bytes from them on, and ``totals()`` carries their peak."""

    def __init__(self, external=None):
        super().__init__()
        self.rec = _Recorder()
        self.live = None
        if external is not None:
            self.live = _Live()
            self.live.add(list(external))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        dtensor = any(issubclass(t, DTensor) for t in types)
        if self.rec.collective(name, args):
            out = func(*args, **kwargs)
            self.rec.bytes += _tree_bytes(args) + _tree_bytes(out)
        elif dtensor:
            with _Collectives(self.rec):
                out = func(*args, **kwargs)
            self.rec.op(func, args, kwargs, out)
        else:
            out = func(*args, **kwargs)
            self.rec.op(func, args, kwargs, out)
        if self.live is not None:
            self.live.add(out)
        return out

    def totals(self) -> dict:
        """The reference's keys (``analyze``), ``op_flops``, and
        ``peak_bytes`` when the live bytes were followed."""
        rec = self.rec
        out = {
            "flops": float(rec.flops),
            "bytes": float(rec.bytes + rec.loop_bytes),
            "bytes_kernelized": float(rec.bytes),
            "flash_loop_bytes": float(rec.loop_bytes),
            "transcendentals": float(rec.transcendentals),
            "collective_bytes": {k: float(v)
                                 for k, v in rec.collective_bytes.items()},
            "collective_counts": dict(rec.collective_counts),
            "op_flops": dict(sorted(rec.op_flops.items())),
        }
        if self.live is not None:
            out["peak_bytes"] = self.live.peak
        return out


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return the reference's keys:
    ``flops``, ``bytes``, ``bytes_kernelized``, ``flash_loop_bytes``,
    ``transcendentals``, ``collective_bytes``, ``collective_counts``
    (per kind), and ``op_flops`` (per operator), for this rank."""
    with CostMode() as costs:
        fn(*args, **kwargs)
    return costs.totals()


def breakdown(fn: Callable, *args, top: int = 25, **kwargs) -> dict:
    """Run ``fn`` once; the ``top`` operators by FLOPs and by bytes (their
    totals over the run), as ``{"flops": [(op, flops)], "bytes": [(op,
    bytes)]}``."""
    with CostMode() as costs:
        fn(*args, **kwargs)
    return {"flops": costs.rec.op_flops.most_common(top),
            "bytes": costs.rec.op_bytes.most_common(top)}
