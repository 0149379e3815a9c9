"""Ranks of the port's mesh tests: spawned processes on gloo (CPU).

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes with the
``spawn`` method, each joining a gloo group through a file store under
``tmp_path`` (no fixed port, so xdist workers never collide), runs
``fn(rank, world, *args)`` in each and waits at most ``timeout`` seconds:
a rank that hangs is killed and the test fails instead of running the suite
into its time limit.  Each ``fn`` below writes what its rank computed to
``out/<name>-rank<r>.pt``; the tests read those files.  This module imports
torch and the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _mesh_cases import (DECODE_STEPS, LABEL_IDS, LABEL_SEED, MOE_ARCHS,
                         MOE_CAPACITY, MOE_DTYPES, TP_ARCHS, TP_DTYPES,
                         TP_MIXER_ARCHS, case_config)


def _entry(fn, rank: int, world: int, store: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path: Path, *args, timeout: float = 150.0
          ) -> None:
    ctx = mp.get_context("spawn")
    store = str(tmp_path / f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for i in hung:
        procs[i].kill()
        procs[i].join()
    if hung:
        raise TimeoutError(f"{fn.__name__}: ranks {hung} of {world} still "
                           f"ran after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"{fn.__name__}: rank exit codes {codes}")


def load(out: Path, name: str, world: int) -> list[dict]:
    return [torch.load(out / f"{name}-rank{r}.pt") for r in range(world)]


def _save(out: str, name: str, rank: int, result: dict) -> None:
    torch.save(result, Path(out) / f"{name}-rank{rank}.pt")


def nested(flat: dict, prefix: str) -> dict:
    """The ``prefix``-ed entries of an ``.npz`` as a nested dict."""
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(shape, axes, device_type="cpu")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_cfg(arch, dtype, capacity):
    from repro_torch.configs import get_tiny_config
    cfg = dataclasses.replace(get_tiny_config(arch), dtype=dtype)
    if capacity == "tight":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    return cfg


def moe_layer(ref: dict, case: str, cfg, grad: bool = False):
    """The port's ``MoE`` of ``cfg`` holding the reference's parameters."""
    from repro_torch.models import moe
    from repro_torch.models.layers import Init
    layer = moe.MoE(cfg, Init(torch.device("cpu"), torch.Generator()))
    prefix = f"params/{case}/"
    state = {k[len(prefix):].replace("/", "."): torch.from_numpy(v)
             for k, v in ref.items() if k.startswith(prefix)}
    layer.load_state_dict(state, strict=True)
    layer.requires_grad_(grad)
    return layer


@dataclasses.dataclass
class SlotRecorder:
    """Shadows ``models.moe.moe_local`` and keeps, per call, the kept
    (token, choice, local expert, slot) rows its dispatch gives."""
    rows: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        from repro_torch.models import moe
        self.inner = moe.moe_local

        def recording(p, x, cfg, *, e_off, num_local, capacity):
            _, top_i = moe.route(x, p["router"], cfg.experts_per_token)
            slot, keep = moe.dispatch(top_i, e_off=e_off,
                                      num_local=num_local, capacity=capacity)
            tok, choice = torch.nonzero(keep, as_tuple=True)
            s = slot[tok, choice]
            rows = torch.stack([tok, choice, s // capacity, s % capacity], 1)
            self.rows.append(sorted(map(tuple, rows.tolist())))
            return self.inner(p, x, cfg, e_off=e_off, num_local=num_local,
                              capacity=capacity)

        moe.moe_local = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_local = self.inner


def moe_ranks(rank: int, world: int, ref_path: str, out: str,
              meshes: list) -> None:
    """Every MoE case through ``moe_block`` on each mesh of ``world``
    ranks: this rank's output rows and kept slots."""
    from _mesh_cases import MOE_SHAPE
    from repro_torch.distributed.context import use_mesh
    from repro_torch.models import moe
    ref = dict(np.load(ref_path))
    result = {}
    for shape in meshes:
        mesh = _mesh(shape)
        i, j = mesh.get_coordinate()
        for arch in MOE_ARCHS:
            for dtype in MOE_DTYPES:
                for capacity in MOE_CAPACITY:
                    case = f"{arch}/{dtype}/{capacity}"
                    cfg = moe_cfg(arch, dtype, capacity)
                    layer = moe_layer(ref, case, cfg)
                    B, S = MOE_SHAPE
                    x = np.random.default_rng(1).standard_normal(
                        (B, S, cfg.d_model)).astype(np.float32)
                    bl = B // shape[0]
                    xs = torch.from_numpy(x[i * bl:(i + 1) * bl]).to(
                        getattr(torch, dtype))
                    with SlotRecorder() as rec, use_mesh(mesh), \
                            torch.no_grad():
                        y = moe.moe_block(layer, xs, cfg, mesh=mesh)
                    tag = f"{case}/{shape[0]}x{shape[1]}"
                    result[tag] = {"coord": (i, j), "out": y.float(),
                                   "slots": rec.rows}
    _save(out, f"moe{world}", rank, result)


def moe_grad_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """On (1, 2): loss and gradients through the expert-parallel
    ``moe_block`` and through the same layer unsharded, float32."""
    from _mesh_cases import MOE_SHAPE
    from repro_torch.models import moe
    ref = dict(np.load(ref_path))
    mesh = _mesh((1, 2))
    result = {}
    for arch in MOE_ARCHS:
        case = f"{arch}/float32/config"
        cfg = moe_cfg(arch, "float32", "config")
        B, S = MOE_SHAPE
        rng = np.random.default_rng(4)
        x0 = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        runs = {}
        for how in ("sharded", "unsharded"):
            layer = moe_layer(ref, case, cfg, grad=True)
            x = x0.clone().requires_grad_(True)
            y = (moe.moe_block(layer, x, cfg, mesh=mesh) if how == "sharded"
                 else layer(x))
            loss = (y * w).sum()
            loss.backward()
            runs[how] = {"loss": loss.detach(), "x": x.grad,
                         **{f"p/{n}": p.grad for n, p
                            in layer.named_parameters()}}
        result[arch] = {"rank": mesh.get_local_rank("model"), **runs}
    _save(out, "moe_grad", rank, result)


def model_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """Tiny dbrx through ``shard_params`` on (2, 2): prefill and decode
    steps of this rank's batch shard under ``use_mesh``."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.context import use_mesh
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.convert import params_from_reference
    ref = dict(np.load(ref_path))
    cfg = get_tiny_config("dbrx-132b")
    model = shard_params(params_from_reference(cfg, nested(ref, "params/"),
                                               device="cpu"), _mesh((2, 2)))
    mesh = model.embed.device_mesh
    i = mesh.get_local_rank("data")
    bl = ref["tokens"].shape[0] // 2
    rows = slice(i * bl, (i + 1) * bl)
    with use_mesh(mesh):
        logits, cache = model.prefill(
            {"tokens": torch.from_numpy(ref["tokens"][rows])})
        result = {"data": i, "prefill": logits}
        cache = model.extend_cache(cache, DECODE_STEPS)
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(
                cache, {"tokens": torch.from_numpy(ref["steps"][t][rows])})
            result[f"decode/{t}"] = logits
        sh = model.layers[0].attn.head_shard()
    result["k"], result["v"] = cache["k"], cache["v"]
    result["kv"] = (sh.kv0, sh.kv1)
    _save(out, "model", rank, result)


def ep_ranks(rank: int, world: int, moe_ref: str, model_ref: str,
             out: str) -> None:
    """The MoE file's ranks in one spawn: 2 ranks run the (1, 2) cases and
    the gradients, 4 ranks the (2, 2) and (1, 4) cases and the model."""
    if world == 2:
        moe_ranks(rank, world, moe_ref, out, [(1, 2)])
        moe_grad_ranks(rank, world, moe_ref, out)
    else:
        moe_ranks(rank, world, moe_ref, out, [(2, 2), (1, 4)])
        model_ranks(rank, world, model_ref, out)


# ---------------------------------------------------------------------------
# Tensor-parallel attention and MLP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LeafShapes:
    """Wraps ``Attention.qkv`` (prefill, training and decode call it) and
    ``MLP.forward`` and keeps, per call, each leaf their module lists in
    ``model_dims`` as (class, leaf, its size on that dim, the layer's full
    count there: H, KH or d_ff)."""
    rows: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        from repro_torch.models import layers
        self.saved = layers.Attention.qkv, layers.MLP.forward

        def full(mod, leaf):
            if isinstance(mod, layers.MLP):
                return mod.d_ff
            kv = leaf in ("wk", "wv", "bk", "bv")
            return mod.cfg.num_kv_heads if kv else mod.cfg.num_heads

        def wrap(fn):
            def inner(mod, *args, **kwargs):
                for leaf, dim in mod.model_dims.items():
                    w = mod._parameters.get(leaf)
                    if w is not None:
                        self.rows.append((type(mod).__name__, leaf,
                                          w.shape[dim], full(mod, leaf)))
                return fn(mod, *args, **kwargs)
            return inner

        layers.Attention.qkv = wrap(self.saved[0])
        layers.MLP.forward = wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.Attention.qkv, layers.MLP.forward = self.saved


def tp_model(ref: dict, arch: str, dtype: str = "float32", mesh=None,
             **fields):
    """Tiny ``arch`` (or a case of ``_mesh_cases.case_config``) in ``dtype``
    with ``fields`` changed, holding the reference's parameters
    (``_jax_mesh_ref.py``), placed on ``mesh`` where one is given."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.convert import params_from_reference
    base, changed = case_config(arch)
    cfg = dataclasses.replace(get_tiny_config(base), dtype=dtype,
                              **{**changed, **fields})
    model = params_from_reference(cfg, nested(ref, f"params/{arch}/"),
                                  device="cpu")
    return model if mesh is None else shard_params(model, mesh)


def tp_batch(ref: dict, arch: str, rows: slice) -> dict:
    """A training batch: the reference's prompt (ids or embeddings) and
    labels drawn from a seed, rows ``rows``."""
    model_in = ref[f"{arch}/prompt"]
    labels = np.random.default_rng(LABEL_SEED).integers(
        0, LABEL_IDS, model_in.shape[:2])
    key = "embeds" if model_in.ndim == 3 else "tokens"
    return {key: torch.from_numpy(model_in[rows]),
            "labels": torch.from_numpy(labels[rows])}


@dataclasses.dataclass
class MixerShapes:
    """Wraps ``SSM.forward``/``decode`` and ``MLA.forward``/``decode`` and
    keeps, per call, each leaf a tensor-parallel mixer computes its own
    heads with, as (class, leaf, its size on its heads' dim, the layer's
    full size there: d_inner or H); and the heads K3 and K2 saw at each
    launch, as ("K3", "heads", nh seen, None), ("K2", "heads", (query, KV)
    heads seen, None)."""
    rows: list = dataclasses.field(default_factory=list)
    LEAVES = {"SSM": {"w_out": 0},
              "MLA": {"wq_b": 1, "wk_b": 1, "wv_b": 1, "wo": 0}}

    def __enter__(self):
        from repro_torch.models import layers, ssm
        self.saved = (ssm.SSM.forward, ssm.SSM.decode, layers.MLA.forward,
                      layers.MLA.decode, ssm.ssd_chunk,
                      layers.flash_attention)

        def wrap(fn):
            def inner(mod, *args, **kwargs):
                name = type(mod).__name__
                full = (mod.cfg.d_inner if name == "SSM"
                        else mod.cfg.num_heads)
                for leaf, dim in self.LEAVES[name].items():
                    self.rows.append((name, leaf,
                                      mod._parameters[leaf].shape[dim],
                                      full))
                return fn(mod, *args, **kwargs)
            return inner

        def k3(xdt, *args, **kwargs):
            self.rows.append(("K3", "heads", xdt.shape[3], None))
            return self.saved[4](xdt, *args, **kwargs)

        def k2(q, k, *args, **kwargs):
            self.rows.append(("K2", "heads", (q.shape[2], k.shape[2]), None))
            return self.saved[5](q, k, *args, **kwargs)

        ssm.SSM.forward, ssm.SSM.decode = (wrap(self.saved[0]),
                                           wrap(self.saved[1]))
        layers.MLA.forward, layers.MLA.decode = (wrap(self.saved[2]),
                                                 wrap(self.saved[3]))
        ssm.ssd_chunk, layers.flash_attention = k3, k2
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers, ssm
        (ssm.SSM.forward, ssm.SSM.decode, layers.MLA.forward,
         layers.MLA.decode, ssm.ssd_chunk, layers.flash_attention) = \
            self.saved


@contextlib.contextmanager
def every_share():
    """``LeafShapes`` and ``MixerShapes`` at once; yields their rows."""
    with LeafShapes() as a, MixerShapes() as b:
        rows: list = []
        yield rows
    rows.extend(a.rows + b.rows)


def tp_train(ref: dict, arch: str, dtype: str, mesh,
             recorder=LeafShapes) -> dict:
    """One loss and backward of this rank's batch shard under ``mesh``,
    and of the unsharded model over every shard (the sum of the shards'
    losses, whose gradient the mesh's sums over "data" give): this rank's
    loss and gradient shards beside the unsharded ones' (the shard's loss,
    each gradient's slice under the parameter's placements)."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.distributed.sharding import local_slice
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    i = mesh.get_local_rank("data")
    bl = ref[f"{arch}/prompt"].shape[0] // n
    model = tp_model(ref, arch, dtype, mesh).requires_grad_(True)
    with recorder() as seen, use_mesh(mesh):
        loss = model.loss(tp_batch(ref, arch, slice(i * bl, (i + 1) * bl)))
        loss.backward()
    plain = tp_model(ref, arch, dtype).requires_grad_(True)
    losses = [plain.loss(tp_batch(ref, arch, slice(j * bl, (j + 1) * bl)))
              for j in range(n)]
    sum(losses).backward()
    params = dict(model.named_parameters())
    # a stub frontend's embedding takes no part: no gradient on either side
    return {"loss": loss.detach(), "want_loss": losses[i].detach(),
            "grads": {k: p.grad.to_local() for k, p in params.items()
                      if p.grad is not None},
            "want": {k: local_slice(p.grad, mesh, params[k].placements)
                     for k, p in plain.named_parameters()
                     if p.grad is not None},
            "shapes": seen if isinstance(seen, list) else seen.rows}


def tp_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """Each of ``TP_ARCHS`` through ``shard_params`` on the meshes of
    ``world`` ranks ((1, 2) on 2; (2, 2) and (1, 4) on 4): prefill and
    decode steps of this rank's batch shard under ``use_mesh``, its cache
    and the KV heads it holds, the leaf shapes the layers saw, and a
    training step in each of ``TP_DTYPES``."""
    from repro_torch.distributed.context import use_mesh
    ref = dict(np.load(ref_path))
    result = {}
    for shape in ([(1, 2)] if world == 2 else [(2, 2), (1, 4)]):
        mesh = _mesh(shape)
        i = mesh.get_local_rank("data")
        for arch in TP_ARCHS:
            prompt, steps = ref[f"{arch}/prompt"], ref[f"{arch}/steps"]
            key = "embeds" if prompt.ndim == 3 else "tokens"
            bl = prompt.shape[0] // shape[0]
            rows = slice(i * bl, (i + 1) * bl)
            model = tp_model(ref, arch, mesh=mesh)
            with LeafShapes() as seen, use_mesh(mesh):
                logits, cache = model.prefill(
                    {key: torch.from_numpy(prompt[rows])})
                res = {"data": i, "prefill": logits}
                cache = model.extend_cache(cache, DECODE_STEPS)
                for t in range(DECODE_STEPS):
                    logits, cache = model.decode_step(
                        cache, {key: torch.from_numpy(steps[t][rows])})
                    res[f"decode/{t}"] = logits
                sh = model.layers[0].attn.head_shard()
            res.update(k=cache["k"], v=cache["v"], kv=(sh.kv0, sh.kv1),
                       shapes=seen.rows)
            for dtype in TP_DTYPES:
                res[f"train/{dtype}"] = tp_train(ref, arch, dtype, mesh)
            result[f"{arch}/{shape[0]}x{shape[1]}"] = res
    _save(out, f"tp{world}", rank, result)


def tp_mixer_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """Each of ``TP_MIXER_ARCHS`` through ``shard_params`` on the meshes of
    ``world`` ranks ((1, 2) on 2; (2, 2) and (1, 4) on 4), as ``tp_ranks``:
    prefill and decode logits of this rank's batch shard, its cache, the
    shares its layers saw, a training step in each of ``TP_DTYPES``; then
    the edge case of its world against the unsharded port
    (``mixer_edge``)."""
    from repro_torch.distributed.context import use_mesh
    ref = dict(np.load(ref_path))
    result = {}
    for shape in ([(1, 2)] if world == 2 else [(2, 2), (1, 4)]):
        mesh = _mesh(shape)
        i = mesh.get_local_rank("data")
        for arch in TP_MIXER_ARCHS:
            prompt, steps = ref[f"{arch}/prompt"], ref[f"{arch}/steps"]
            bl = prompt.shape[0] // shape[0]
            rows = slice(i * bl, (i + 1) * bl)
            model = tp_model(ref, arch, mesh=mesh)
            with every_share() as seen, use_mesh(mesh):
                logits, cache = model.prefill(
                    {"tokens": torch.from_numpy(prompt[rows])})
                res = {"data": i, "model": mesh.get_local_rank("model"),
                       "prefill": logits}
                cache = model.extend_cache(cache, DECODE_STEPS)
                for t in range(DECODE_STEPS):
                    logits, cache = model.decode_step(
                        cache, {"tokens": torch.from_numpy(steps[t][rows])})
                    res[f"decode/{t}"] = logits
            res["cache"] = {k: v for k, v in cache.items() if k != "pos"}
            res["shapes"] = seen
            for dtype in TP_DTYPES:
                res[f"train/{dtype}"] = tp_train(ref, arch, dtype, mesh,
                                                 every_share)
            result[f"{arch}/{shape[0]}x{shape[1]}"] = res
    result["edge"] = {case: mixer_edge(*MIXER_EDGES[case])
                      for case in MIXER_EDGES
                      if np.prod(MIXER_EDGES[case][2]) == world}
    result["norm"] = norm_slice(rank, world)
    _save(out, f"mixers{world}", rank, result)


NORM_EPS = 1e-5


def norm_inputs() -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``norm_slice``'s input (3, 5, 64), scale (64,) and output
    cotangent, float32, from a seed."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, scale, g))


def norm_slice(rank: int, world: int) -> dict:
    """``layers.rmsnorm_split`` of this rank's slice of ``norm_inputs``'
    last dim over the world's group, per dtype of ``TP_DTYPES``: its output
    and the gradient of its input under the sum over every rank of the
    output times the cotangent."""
    from repro_torch.models.layers import rmsnorm_split
    x, scale, g = norm_inputs()
    w = x.shape[-1] // world
    cols = slice(rank * w, (rank + 1) * w)
    result = {}
    for dtype in TP_DTYPES:
        xs = x[..., cols].to(getattr(torch, dtype)).requires_grad_(True)
        y = rmsnorm_split(scale[cols].to(xs.dtype), xs, NORM_EPS,
                          x.shape[-1], dist.group.WORLD)
        (y.float() * g[..., cols]).sum().backward()
        result[dtype], result[f"grad/{dtype}"] = y.detach(), xs.grad
    return result


# the cases of ``mixer_edge`` by name: (tiny arch, its changed fields, mesh)
MIXER_EDGES = {
    # 2 SSM heads of 64 on 4 ranks: 4 divides d_inner (128), not the heads
    "ssm-heads-2-on-4": ("mamba2-2_7b", {"ssm_head_dim": 64}, (1, 4)),
    # 3 attention heads (gathered) beside 8 SSM heads (4 a rank) on 2 ranks
    "hybrid-attention-3-on-2": ("hymba-1_5b",
                                {"num_heads": 3, "num_kv_heads": 1}, (1, 2)),
    # the full configurations' remat: the layer recomputed in the backward
    # (its sums over "model" too), and "dots"' selective recompute
    "hybrid-remat-full": ("hymba-1_5b", {"remat": "full"}, (1, 2)),
    "ssm-remat-full": ("mamba2-2_7b", {"remat": "full"}, (1, 2)),
    "mla-remat-dots": ("minicpm3-4b", {"remat": "dots"}, (1, 2)),
}


def mixer_edge(arch: str, fields: dict, shape: tuple, recorder=None,
               seq: int = 8) -> dict:
    """Tiny ``arch`` with ``fields`` changed and seeded weights, on
    ``shape``'s mesh and unsharded: prefill, decode steps, the cache and a
    float32 training step of this rank's batch shard (the unsharded run
    over every shard, as ``tp_train``) of ``seq`` tokens a row, and the
    shares the layers saw (``recorder``'s rows; ``every_share``)."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.context import use_mesh
    from repro_torch.distributed.sharding import local_slice, shard_params
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_tiny_config(arch), **fields)
    mesh = _mesh(shape)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, 97, (4, seq + 1)))
    steps = torch.from_numpy(rng.integers(0, 97, (DECODE_STEPS, 4, 1)))
    n = shape[0]
    i = mesh.get_local_rank("data")
    bl = tokens.shape[0] // n
    mine = slice(i * bl, (i + 1) * bl)
    result = {"data": i, "model": mesh.get_local_rank("model")}
    for how in ("sharded", "plain"):
        model = Model(cfg, device="cpu")
        on = how == "sharded"
        if on:
            shard_params(model, mesh)
        part = (lambda t: t[mine]) if on else (lambda t: t)
        with (recorder or every_share)() as seen, \
                use_mesh(mesh if on else None):
            logits, cache = model.prefill({"tokens": part(tokens)[:, :-1]})
            run = {"prefill": logits}
            cache = model.extend_cache(cache, DECODE_STEPS)
            for t in range(DECODE_STEPS):
                logits, cache = model.decode_step(
                    cache, {"tokens": part(steps[t])})
                run[f"decode/{t}"] = logits
            model.requires_grad_(True)
            batches = [mine] if on else [slice(j * bl, (j + 1) * bl)
                                         for j in range(n)]
            losses = [model.loss({"tokens": tokens[b, :-1],
                                  "labels": tokens[b, 1:]})
                      for b in batches]
            sum(losses).backward()
        run["loss"] = losses[0 if on else i].detach()
        run["cache"] = {k: v for k, v in cache.items() if k != "pos"}
        run["grads"] = {k: p.grad for k, p in model.named_parameters()}
        run["shapes"] = seen
        result[how] = (run, model)
    (sharded, model), (plain, _) = result["sharded"], result["plain"]
    places = {k: p.placements for k, p in model.named_parameters()}
    plain["grads"] = {k: local_slice(g, mesh, places[k])
                      for k, g in plain["grads"].items()}
    sharded["grads"] = {k: g.to_local() for k, g in sharded["grads"].items()}
    result.update(sharded=sharded, plain=plain, arch=arch, fields=fields,
                  shape=shape)
    return result


# ---------------------------------------------------------------------------
# Sharding: placed shards, remesh
# ---------------------------------------------------------------------------


def shard_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """Tiny dbrx placed with ``shard_params`` on (2, 2): this rank's local
    shard of every parameter, by name, and its mesh coordinate."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.models.convert import params_from_reference
    ref = dict(np.load(ref_path))
    cfg = get_tiny_config("dbrx-132b")
    mesh = _mesh((2, 2))
    model = shard_params(params_from_reference(cfg, nested(ref, "params/"),
                                               device="cpu"), mesh)
    _save(out, "shards", rank, {
        "coord": tuple(mesh.get_coordinate()),
        "local": {n: p.to_local().clone() for n, p in
                  model.named_parameters()}})


REMESH_STEPS = 3


def _remesh_batches(cfg) -> list[dict]:
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (REMESH_STEPS, 4, 9))
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def _remesh_step(model):
    """A step of the remesh runs: the loss of this rank's batch shard
    under the parameters' mesh, averaged over "data", then every local
    shard scaled by 0.99 (an update that no mesh changes)."""
    from repro_torch.distributed.collectives import compressed_psum_mean
    from repro_torch.distributed.context import use_mesh
    from repro_torch.distributed.sharding import assign

    @torch.no_grad()
    def step_fn(state, batch):
        for name, p in state["params"].items():
            assign(model, name, p)
        mesh = model.embed.device_mesh
        n = mesh.size(mesh.mesh_dim_names.index("data"))
        i = mesh.get_local_rank("data")
        bl = batch["tokens"].shape[0] // n
        local = {k: torch.from_numpy(v[i * bl:(i + 1) * bl])
                 for k, v in batch.items()}
        with use_mesh(mesh):
            loss = compressed_psum_mean(model.loss(local), "data",
                                        mode="none")
        for p in state["params"].values():
            p.to_local().mul_(0.99)
        return state, {"loss": loss}
    return step_fn


def remesh_ranks(rank: int, world: int, out: str) -> None:
    """Run A: tiny stablelm on (2, 2) for 2 steps through
    ``FaultTolerantRunner``, ``remesh`` onto (1, 4)'s shardings, one more
    step.  Run B: the same weights on (1, 4) throughout.  Saves the full
    values before and after the re-mesh and both runs' losses."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.distributed.elastic import (FaultTolerantRunner,
                                                 RunnerConfig)
    from repro_torch.distributed.sharding import (gather, param_shardings,
                                                  shard_params)
    from repro_torch.models import Model
    cfg = get_tiny_config("stablelm-12b")
    batches = _remesh_batches(cfg)
    mesh_a, mesh_b = _mesh((2, 2)), _mesh((1, 4))
    result = {}
    for run, first in (("a", mesh_a), ("b", mesh_b)):
        model = shard_params(Model(cfg, device="cpu"), first)
        state = {"params": dict(model.named_parameters())}
        losses = {}
        runner = FaultTolerantRunner(
            RunnerConfig(checkpoint_dir=str(Path(out) / f"ckpt-{run}"),
                         checkpoint_every=1),
            step_fn=_remesh_step(model), state=state)
        on = lambda step, m: losses.__setitem__(step, m["loss"].clone())  # noqa: E731
        if run == "a":
            runner.run(iter(batches), REMESH_STEPS - 1, on_metrics=on)
            result["before"] = {n: gather(p).clone() for n, p in
                                runner.state["params"].items()}
            runner.remesh(param_shardings(runner.state, mesh_b))
            result["after"] = {n: gather(p).clone() for n, p in
                               runner.state["params"].items()}
            result["placements"] = {
                n: (tuple(p.device_mesh.shape), tuple(p.placements))
                for n, p in runner.state["params"].items()}
            result["step"] = runner.step
        runner.run(iter(batches[runner.step:]), REMESH_STEPS, on_metrics=on)
        result[f"losses/{run}"] = losses
    _save(out, "remesh", rank, result)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def psum_ranks(rank: int, world: int, ref_path: str, out: str) -> None:
    """``compressed_psum_mean`` of this rank's row over a ("pod",) mesh of
    4, in the three modes, with the reference's uniforms; and int8 from a
    generator."""
    from repro_torch.distributed.collectives import (compressed_psum_mean,
                                                     tree_compressed_psum_mean)
    from repro_torch.distributed.context import use_mesh
    ref = dict(np.load(ref_path))
    mesh = _mesh((world,), ("pod",))
    r = mesh.get_local_rank("pod")
    result = {"coord": r}
    with use_mesh(mesh):
        for label in ("seeded", "example"):
            x = torch.from_numpy(ref[f"x/{label}"][r])
            u = torch.from_numpy(ref[f"u/{label}"])
            for mode in ("none", "bf16", "int8"):
                result[f"{label}/{mode}"] = compressed_psum_mean(
                    x, "pod", mode=mode, u=u)
        x = torch.from_numpy(ref["x/seeded"][r])
        gen = torch.Generator().manual_seed(100 + r)
        result["generator/int8"] = compressed_psum_mean(x, "pod", gen)
        result["tree"] = tree_compressed_psum_mean(
            {"b": x, "a": {"c": 2 * x}}, mesh.get_group("pod"), mode="none")
    _save(out, "psum", rank, result)


# ---------------------------------------------------------------------------
# Dry run: the same steps for real
# ---------------------------------------------------------------------------


def dryrun_ranks(rank: int, world: int, out: str, cells: list) -> None:
    """Each (arch, shape, seq, batch[, remat]) of ``cells`` at its tiny
    config (``remat`` in place of its own where given, keyed
    "arch/shape/remat"), for real on the (2, 2, 2) ("pod", "data",
    "model") mesh: the step the dry run traces
    (``launch.dryrun.build_cell`` with seeded weights and tokens, the full
    configuration's optimizer), under ``launch.hlo_costs.CostMode``.
    Saves this rank's FLOPs, collectives and argument bytes per cell."""
    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.launch import dryrun
    from repro_torch.training.step import default_optimizer
    from repro_torch.launch.specs import SHAPES
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    result = {}
    for arch, shape_name, seq, batch, *remat in cells:
        shape = dataclasses.replace(SHAPES[shape_name], seq=seq, batch=batch)
        cfg = get_tiny_config(arch)
        key = f"{arch}/{shape_name}"
        if remat:
            cfg = dataclasses.replace(cfg, remat=remat[0])
            key += f"/{remat[0]}"
        cell = dryrun.build_cell(cfg, shape, mesh, device="cpu", fake=False,
                                 opt=default_optimizer(get_config(arch)))
        acc = dryrun.measure(cell)
        result[key] = {
            "flops": acc["flops"],
            "op_flops": acc["op_flops"],
            "collective_counts": acc["collective_counts"],
            "collective_bytes": acc["collective_bytes"],
            "argument_bytes": dryrun.tensor_bytes(cell.arguments)}
    _save(out, "dryrun", rank, result)


# ---------------------------------------------------------------------------
# The vocab-parallel embedding, head and loss; Megatron-SP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VocabRows:
    """Wraps ``Model.embed_inputs``, ``Model._head`` and ``transformer.
    chunked_xent`` and keeps, per call, the vocab rows or columns it
    computed on: ("embed", the embedding's rows; token ids only), ("head",
    the serving head's columns), ("loss", the loss head's columns)."""
    rows: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        from repro_torch.models import transformer
        model = transformer.Model
        self.saved = (model.embed_inputs, model._head,
                      transformer.chunked_xent)

        def embed(mod, batch):
            if mod.cfg.frontend == "none":
                self.rows.append(("embed", mod.embed.shape[0]))
            return self.saved[0](mod, batch)

        def head(mod, x):
            self.rows.append(("head", mod.unembed().shape[1]))
            return self.saved[1](mod, x)

        def xent(h, labels, w, *args, **kwargs):
            self.rows.append(("loss", w.shape[1]))
            return self.saved[2](h, labels, w, *args, **kwargs)

        model.embed_inputs, model._head = embed, head
        transformer.chunked_xent = xent
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        (transformer.Model.embed_inputs, transformer.Model._head,
         transformer.chunked_xent) = self.saved


@dataclasses.dataclass
class SeqRows:
    """Wraps ``transformer._block_out`` (each layer of the training path,
    and remat's recompute of it) and keeps, per call, ("layer", the rows
    of the residual stream it takes, its Megatron-SP flag) and, where the
    call returns (remat's recompute stops early), ("layer-out", the rows it
    gives): what remat "full" holds of a layer is its input."""
    rows: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        from repro_torch.models import transformer
        self.saved = transformer._block_out

        def block_out(blk, x, window, mesh=None, seq_shard=False):
            self.rows.append(("layer", x.shape[1], seq_shard))
            y = self.saved(blk, x, window, mesh, seq_shard)
            self.rows.append(("layer-out", y.shape[1]))
            return y

        transformer._block_out = block_out
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._block_out = self.saved


@contextlib.contextmanager
def model_rows():
    """``VocabRows`` and ``SeqRows`` at once; yields their rows."""
    with VocabRows() as a, SeqRows() as b:
        rows: list = []
        yield rows
    rows.extend(a.rows + b.rows)


def _meshes(world: int) -> list:
    return [(1, 2)] if world == 2 else [(2, 2), (1, 4)]


def case_ranks(rank: int, world: int, ref_path: str, out: str, name: str,
               cases, serve: bool, edges: dict) -> None:
    """Each of ``cases`` (``_mesh_cases``) through ``shard_params`` on the
    meshes of ``world`` ranks ((1, 2) on 2; (2, 2) and (1, 4) on 4):
    where ``serve``, prefill and decode logits of this rank's batch shard
    under ``use_mesh``; a training step in each of ``TP_DTYPES``
    (``tp_train``); the vocab rows and the residual stream's rows the
    calls saw (``model_rows``); then the cases of ``edges`` of its world
    against the unsharded port (``mixer_edge``)."""
    from repro_torch.distributed.context import use_mesh
    ref = dict(np.load(ref_path))
    result = {}
    for shape in _meshes(world):
        mesh = _mesh(shape)
        i = mesh.get_local_rank("data")
        for case in cases:
            res = {"data": i, "model": mesh.get_local_rank("model")}
            if serve:
                prompt, steps = ref[f"{case}/prompt"], ref[f"{case}/steps"]
                key = "embeds" if prompt.ndim == 3 else "tokens"
                bl = prompt.shape[0] // shape[0]
                rows = slice(i * bl, (i + 1) * bl)
                model = tp_model(ref, case, mesh=mesh)
                with model_rows() as seen, use_mesh(mesh):
                    res["prefill"], cache = model.prefill(
                        {key: torch.from_numpy(prompt[rows])})
                    cache = model.extend_cache(cache, DECODE_STEPS)
                    for t in range(DECODE_STEPS):
                        res[f"decode/{t}"], cache = model.decode_step(
                            cache, {key: torch.from_numpy(steps[t][rows])})
                res["shapes"] = seen
            for dtype in TP_DTYPES:
                res[f"train/{dtype}"] = tp_train(ref, case, dtype, mesh,
                                                 model_rows)
            if case_config(case)[0] in MOE_ARCHS:
                res["slots"] = seq_slots(ref, case, mesh)
            result[f"{case}/{shape[0]}x{shape[1]}"] = res
    result["edge"] = {case: mixer_edge(*edge[:3], recorder=model_rows,
                                       **edge[3] if len(edge) > 3 else {})
                      for case, edge in edges.items()
                      if np.prod(edge[2]) == world}
    _save(out, f"{name}{world}", rank, result)


def seq_slots(ref: dict, case: str, mesh) -> dict:
    """The kept (token, choice, expert, slot) rows of every ``moe_local``
    call of a float32 loss of this rank's batch shard, with the case's
    Megatron-SP and without it."""
    from repro_torch.distributed.context import use_mesh
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    i = mesh.get_local_rank("data")
    bl = ref[f"{case}/prompt"].shape[0] // n
    batch = tp_batch(ref, case, slice(i * bl, (i + 1) * bl))
    slots = {}
    for how, on in (("sp", True), ("plain", False)):
        model = tp_model(ref, case, mesh=mesh, seq_shard_activations=on)
        with SlotRecorder() as rec, use_mesh(mesh), torch.no_grad():
            model.loss(batch)
        slots[how] = rec.rows
    return slots
