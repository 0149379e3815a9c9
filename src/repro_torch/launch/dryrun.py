"""Multi-pod dry-run: every (arch × shape × mesh) cell's step traced on fake
tensors, with nothing allocated and no card, and its roofline terms — the
port's counterpart of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each step with ``ShapeDtypeStruct``
inputs on forced host devices and reads XLA's compiled program.  The port
runs each step once, eagerly, as rank 0 of the mesh:

* a fake process group of the mesh's world size (torch's ``fake``
  backend on a ``HashStore``; collectives complete at once) and the mesh
  on it, of the tensors' device type (``DTensor.from_local`` moves a shard
  to its mesh's device);
* the model, optimizer state, batch and cache as ``FakeTensorMode``
  tensors on ``--device`` (``cuda`` by default, so every kernel takes its
  card route: the kernels are operators with fake implementations),
  placed by the sharding rules (``shard_params``, ``param_shardings``,
  ``batch_shardings``) and the decode cache made by ``Model.init_cache``
  under the mesh (this rank's KV heads, SSM heads and conv channels where
  attention and the SSM are tensor-parallel over "model") and cut to the
  rank's batch shard: a rank holds its shards
  and is given its batch shard, as on the card;
* ``launch.hlo_costs.analyze`` around the step for FLOPs, bytes and
  collectives per device (rank 0's, as the reference's are device 0's),
  and the peak of the bytes alive from the step's arguments on.

Each cell writes one record with the reference's keys; ``trace_s`` takes
the place of the XLA-only ones (``lower_s``, ``compile_s``, ``xla_*``,
``hlo_bytes``), and ``roofline_s_h100`` is max(FLOPs / 989e12, kernelized
bytes / 3.35e12): the H100 SXM data sheet's peaks, not a measurement.
Nothing is read from or written to the environment.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch <id> ...] [--shape <name> ...] [--multipod|--singlepod|--both]
        [--out experiments/dryrun_torch] [--skip-done] [--tiny]
        [--mesh-shape 2,2,2] [--seq N] [--batch N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from ..configs import ARCH_IDS, get_config, get_tiny_config
from ..distributed.context import use_mesh
from ..distributed.sharding import (NamedSharding, _flat, _unflat,
                                    batch_shardings, cache_shardings,
                                    local_slice, param_shardings,
                                    shard_params)
from ..models import Model
from ..models.config import ArchConfig
from ..training.step import (default_optimizer, init_state,
                             make_prefill_step, make_serve_step,
                             make_train_step)
from .hlo_costs import CostMode
from .mesh import make_debug_mesh, make_production_mesh
from .specs import SHAPES, ShapeSpec, input_specs, shape_applicable

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core rate, SXM data sheet
H100_HBM_BYTES_S = 3.35e12    # HBM3 rate, SXM data sheet
PEAKS = ("H100 SXM datasheet peaks (bf16 dense 989 TFLOP/s, HBM3 "
         "3.35 TB/s), not measured")


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token/seq."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n * tokens
    return 2.0 * n * shape.batch  # decode: one token per sequence


def roofline_s_h100(flops: float, bytes_kernelized: float) -> float:
    return max(flops / H100_BF16_FLOPS, bytes_kernelized / H100_HBM_BYTES_S)


@dataclasses.dataclass
class Cell:
    """One rank's step, ready to run: ``run()`` takes the step on
    ``args`` under the mesh; ``arguments`` are the tensors the step is
    given (parameters, optimizer state, batch, cache), each this rank's
    shard."""
    run: Callable[[], Any]
    arguments: list


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def tensor_bytes(tensors) -> int:
    """Bytes of this rank's shards of ``tensors``."""
    return sum(_local(t).numel() * _local(t).element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _place(tree, shardings):
    """Each leaf of ``tree`` (the full value, the same on every rank) as
    the ``DTensor`` of its sharding; a 0-d leaf stays as it is."""
    flat = dict(_flat(shardings))
    return _unflat([(keys, flat[keys].place(leaf) if leaf.dim() else leaf)
                    for keys, leaf in _flat(tree)])


def _shard(tree, shardings):
    """This rank's shard of each leaf of ``tree``, as a plain tensor."""
    flat = dict(_flat(shardings))
    out = []
    for keys, leaf in _flat(tree):
        sh: NamedSharding = flat[keys]
        if isinstance(leaf, torch.Tensor) and leaf.dim():
            leaf = local_slice(leaf, sh.mesh, sh.placements).clone()
        out.append((keys, leaf))
    return _unflat(out)


def _batch_only(shardings):
    """Each spec with its batch axes ("pod", "data") only: the decode cache
    ``Model.init_cache`` makes under the mesh already holds this rank's KV
    heads (the reference's "model" shard of ``cache_shardings`` where the
    KV heads divide the axis; where they do not, the heads its query heads
    read, whole, where the reference's spec shards the head dim), and its
    SSM heads and conv channels where the SSM is tensor-parallel; MLA's
    latent is whole on every rank."""
    def keep(entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        return entry if entry is not None and set(axes) <= {"pod", "data"} \
            else None
    return _unflat([(keys, NamedSharding(sh.mesh, tuple(keep(e)
                                                        for e in sh.spec)))
                    for keys, sh in _flat(shardings)])


def _inputs(cfg, shape: ShapeSpec, device, fake: bool,
            generator: torch.Generator | None) -> dict:
    """The step's batch at full (global) size on ``device``: fake tensors,
    or tokens drawn from ``generator`` (embeddings N(0, 1))."""
    specs = input_specs(cfg, shape)

    def make(t: torch.Tensor) -> torch.Tensor:
        if fake:
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=generator,
                               dtype=torch.float32).to(device, t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=generator,
                             dtype=t.dtype).to(device)

    return {k: make(v) for k, v in specs["batch"].items()}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh=None, *,
               device="cuda", fake: bool = True, seed: int = 0,
               opt=None) -> Cell:
    """This rank's step of ``shape``'s kind for ``cfg`` under ``mesh``
    (None: one device): the model (seeded weights, or fake tensors under
    the caller's ``FakeTensorMode``) placed by the sharding rules, the
    state of ``opt`` (default: ``default_optimizer(cfg)``) placed likewise
    for ``train``, and this rank's shard of the batch (and of the cache,
    for ``decode``)."""
    device = torch.device(device)
    if fake:
        model = Model(cfg, device="meta")
        for mod in model.modules():        # ``to_empty`` cannot swap in
            for name, p in mod._parameters.items():    # fake tensors
                mod._parameters[name] = nn.Parameter(
                    torch.empty_like(p, device=device),
                    requires_grad=p.requires_grad)
    else:
        model = Model(cfg, device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(seed))
    if mesh is not None:
        shard_params(model, mesh)
    gen = None if fake else torch.Generator().manual_seed(seed + 1)
    batch = _inputs(cfg, shape, device, fake, gen)
    if mesh is not None:
        batch = _shard(batch, batch_shardings(batch, mesh))
    if shape.kind == "train":
        if opt is None:
            opt = default_optimizer(cfg)
        state = init_state(model, opt)
        if mesh is not None:
            state["opt"] = _place(state["opt"],
                                  param_shardings(state["opt"], mesh))
        step, args = make_train_step(model, opt), (state, batch)
        arguments = ([p for _, p in _flat(state)]
                     + list(batch.values()))
    elif shape.kind == "prefill":
        step, args = make_prefill_step(model), (batch,)
        arguments = list(model.parameters()) + list(batch.values())
    else:
        with use_mesh(mesh):        # this rank's KV heads, the global batch
            cache = model.init_cache(shape.batch, shape.seq)
        cache["pos"] = shape.seq - 1            # a zero cache, last slot
        if mesh is not None:
            cache = _shard(cache, _batch_only(cache_shardings(
                cache, mesh, seq_shard=False)))
        step, args = make_serve_step(model), (cache, batch)
        arguments = (list(model.parameters()) + list(batch.values())
                     + [v for k, v in cache.items() if k != "pos"])

    def run():
        with use_mesh(mesh):
            return step(*args)

    return Cell(run, arguments)


def measure(cell: Cell) -> dict:
    """Run ``cell`` once under ``hlo_costs.CostMode``: the accounting,
    the output bytes and the peak of the bytes alive on this rank (the
    arguments included)."""
    with CostMode(external=cell.arguments) as costs:
        out = cell.run()
    acc = costs.totals()
    acc["output_bytes"] = tensor_bytes(tree_flatten(out)[0])
    return acc


def world_size(mesh) -> int:
    return 1 if mesh is None else math.prod(mesh.shape)


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool, *,
             tiny: bool = False, shape: ShapeSpec | None = None,
             opt: bool = False, device: str = "cuda",
             cfg: ArchConfig | None = None) -> dict:
    """One cell's record, traced on fake tensors on ``device`` as rank 0 of
    ``mesh`` (None: one device, no process group), whose device type must
    be ``device``'s.  A ``tiny`` cell trains with its full configuration's
    optimizer (FactoredAdam for dbrx-132b and llama4), so that it runs the
    full cell's step at a small size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if cfg is None:
        cfg = get_tiny_config(arch) if tiny else get_config(arch)
    if opt:
        # the reference's §Perf configuration: sequence-parallel residual
        # stream (Megatron-SP in ``Model.loss``: S/n rows a rank between
        # the tensor-parallel regions) and larger loss slabs
        cfg = dataclasses.replace(cfg, seq_shard_activations=True,
                                  loss_chunk=8192)
    shape = shape or SHAPES[shape_name]
    tag = "multi" if multi_pod else "single"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "status": "skip", "reason": why}
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        opt = default_optimizer(get_config(arch) if tiny else cfg)
        cell = build_cell(cfg, shape, mesh, device=device, fake=True,
                          opt=opt)
        off = {str(_local(t).device) for t in cell.arguments
               if _local(t).device.type != torch.device(device).type}
        if off:
            raise RuntimeError(f"arguments placed on {off}, not {device}: "
                               f"the mesh's device type is not the "
                               f"tensors'")
        argument_bytes = tensor_bytes(cell.arguments)
        acc = measure(cell)
    trace_s = time.perf_counter() - t0
    peak = acc["peak_bytes"]
    return {
        "arch": arch, "shape": shape.name, "mesh": tag,
        "chips": world_size(mesh),
        "status": "ok",
        "device": str(device),
        "optimizer": type(opt).__name__ if shape.kind == "train" else None,
        "trace_s": round(trace_s, 1),
        "flops_per_device": acc["flops"],
        "flops_per_operator": acc["op_flops"],
        "bytes_per_device": acc["bytes"],
        "bytes_per_device_kernelized": acc["bytes_kernelized"],
        "flash_loop_bytes_per_device": acc["flash_loop_bytes"],
        "collective_bytes_per_device": acc["collective_bytes"],
        "collective_counts": acc["collective_counts"],
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": acc["output_bytes"],
            "temp_bytes": peak - argument_bytes,
            "peak_bytes": peak,
        },
        "model_flops_global": model_flops(cfg, shape),
        "roofline_s_h100": roofline_s_h100(acc["flops"],
                                           acc["bytes_kernelized"]),
        "roofline_peaks": PEAKS,
    }


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    # torch registers its "fake" backend in this module, and nowhere else
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--singlepod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced configs (pipeline validation only)")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's §Perf configuration (SP "
                         "activations, bigger loss slabs)")
    ap.add_argument("--mesh-shape", default=None,
                    help="debug override, e.g. 2,2,2 (axes pod,data,model)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="device of the fake tensors and the mesh: cuda "
                         "(the default where torch is built with CUDA) or "
                         "cpu (the default elsewhere)")
    args = ap.parse_args(argv)
    # Indexing a fake CUDA tensor takes a CUDA device guard, which a
    # CPU-only build of torch lacks.  Each kernel is an operator that picks
    # its route inside, so the FLOPs and bytes do not depend on the device.
    # The collectives would where a DTensor reshards a shard of one
    # dimension into a shard of another on one mesh dimension: an
    # all-to-all on a cuda mesh, an all-gather on a cpu one (gloo has no
    # all-to-all).  The port's steps do no such reshard
    # (tests/test_torch_dryrun.py); DTensor also picks among placements by
    # a cost model that reads how many devices of the mesh's type the host
    # has, one on the card's host and on the CPU.
    device = args.device or ("cuda" if torch.backends.cuda.is_built()
                             else "cpu")

    modes = []
    if args.both or (not args.multipod and not args.singlepod):
        modes = [False, True]
    else:
        if args.singlepod:
            modes.append(False)
        if args.multipod:
            modes.append(True)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    try:
        for multi in modes:
            if args.mesh_shape:
                if multi:
                    continue  # custom mesh: run once
                dims = tuple(int(x) for x in args.mesh_shape.split(","))
                axes = (("pod", "data", "model") if len(dims) == 3
                        else ("data", "model"))
                _fake_group(math.prod(dims))
                mesh = make_debug_mesh(dims, axes, device_type=device)
            else:
                _fake_group(512 if multi else 256)
                mesh = make_production_mesh(multi_pod=multi,
                                            device_type=device)
            print(f"=== mesh {'multi(2,16,16)' if multi else 'single(16,16)'}"
                  f" axes={mesh.mesh_dim_names} devices={world_size(mesh)}",
                  flush=True)
            for arch in args.arch:
                for shape_name in args.shape:
                    tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                    path = outdir / f"{tag}.json"
                    if args.skip_done and path.exists():
                        rec = json.loads(path.read_text())
                        if rec.get("status") in ("ok", "skip"):
                            print(f"[cached] {tag}", flush=True)
                            continue
                    t0 = time.perf_counter()
                    shape = SHAPES[shape_name]
                    if args.seq or args.batch:
                        shape = dataclasses.replace(
                            shape, seq=args.seq or shape.seq,
                            batch=args.batch or shape.batch)
                    try:
                        rec = run_cell(arch, shape_name, mesh, multi,
                                       tiny=args.tiny, shape=shape,
                                       opt=args.opt, device=device)
                    except Exception as e:  # noqa: BLE001 - recorded per cell
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": "multi" if multi else "single",
                               "status": "error", "error": repr(e),
                               "traceback": traceback.format_exc()[-4000:]}
                        failures += 1
                    path.write_text(json.dumps(rec, indent=2, default=float))
                    status = rec["status"]
                    extra = (f"trace={rec.get('trace_s')}s "
                             f"flops/dev={rec.get('flops_per_device', 0):.3g}"
                             if status == "ok" else rec.get(
                                 "reason", rec.get("error", "")))
                    print(f"[{status}] {tag} ({time.perf_counter() - t0:.0f}s)"
                          f" {extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
