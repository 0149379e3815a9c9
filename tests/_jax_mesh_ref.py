"""The reference's side of the mesh tests, run as its own process:

    python tests/_jax_mesh_ref.py TASK OUT.npz

JAX needs its host device count before it starts, so the tests of the
port's sharded layer run this script in a subprocess (as
``tests/test_distributed.py`` runs its mesh code) and read the ``.npz`` it
writes.  Meshes are ``jax.sharding.Mesh`` over 4 forced host devices,
device ``i * ncols + j`` at coordinate ``(i, j)``, with the default (auto)
axis types.  Inputs are drawn with numpy from the seeds the tests use;
parameters come from the reference's inits at ``PRNGKey(0)`` and are
written beside the results, as float32 (bf16 values widen exactly).

TASK is one of ``moe``, ``model``, ``shards``, ``psum``, ``tp``,
``tp_mixers``, ``tp_vocab``, ``tp_seq``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_tiny_config  # noqa: E402
from repro.models import Model, moe as ref_moe  # noqa: E402

from _mesh_cases import (DECODE_STEPS, LABEL_IDS, LABEL_SEED,  # noqa: E402
                         MODEL_SHAPE, MOE_ARCHS, MOE_CAPACITY, MOE_DTYPES,
                         MOE_MESHES, MOE_SHAPE, PSUM_SHAPE, SEQ_CASES,
                         TP_ARCHS, TP_MESHES, TP_MIXER_ARCHS, VOCAB_CASES,
                         case_config)


def mesh_of(shape, axes=("data", "model")) -> Mesh:
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def moe_cfg(arch, dtype, capacity):
    cfg = dataclasses.replace(get_tiny_config(arch), dtype=dtype)
    if capacity == "tight":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=0.5)
    return cfg


def moe_tokens(cfg) -> np.ndarray:
    B, S = MOE_SHAPE
    return np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def kept_slots(p, x, cfg, *, e_off, num_local, capacity) -> np.ndarray:
    """The reference's dispatch (``moe_local``'s routing, sort and slot
    steps) as rows of kept (token, choice, expert, slot), sorted."""
    k = cfg.experts_per_token
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    eid = top_i.reshape(-1)
    local = (eid >= e_off) & (eid < e_off + num_local)
    eid_l = jnp.where(local, eid - e_off, num_local)
    order = jnp.argsort(eid_l, stable=True)
    eid_s = eid_l[order]
    counts = jnp.bincount(eid_s, length=num_local + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(eid_s.size) - starts[eid_s]
    keep = np.asarray((pos < capacity) & (eid_s < num_local))
    order, eid_s, pos = (np.asarray(a) for a in (order, eid_s, pos))
    rows = [(int(o) // k, int(o) % k, int(e), int(c))
            for o, e, c, kept in zip(order, eid_s, pos, keep) if kept]
    return np.array(sorted(rows), np.int64).reshape(-1, 4)


def task_moe(out: dict) -> None:
    for arch in MOE_ARCHS:
        for dtype in MOE_DTYPES:
            for capacity in MOE_CAPACITY:
                cfg = moe_cfg(arch, dtype, capacity)
                case = f"{arch}/{dtype}/{capacity}"
                p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg)
                for name, v in flat(p).items():
                    out[f"params/{case}/{name}"] = v
                x = jnp.asarray(moe_tokens(cfg), dtype=getattr(jnp, dtype))
                B, S, d = x.shape
                E = cfg.num_experts
                for shape in MOE_MESHES:
                    mesh = mesh_of(shape)
                    y = jax.jit(lambda pp, xx: ref_moe.moe_block(
                        pp, xx, cfg, mesh=mesh, batch_axes=("data",)))(p, x)
                    tag = f"{case}/{shape[0]}x{shape[1]}"
                    out[f"out/{tag}"] = np.asarray(y, np.float32)
                    n_data, n_model = shape
                    num_local = max(E // n_model, 1)
                    bl = B // n_data
                    cap = ref_moe.capacity_for(bl * S, cfg)
                    for i in range(n_data):
                        xs = x[i * bl:(i + 1) * bl].reshape(bl * S, d)
                        for j in range(n_model):
                            out[f"slots/{tag}/{i}{j}"] = kept_slots(
                                p, xs, cfg, e_off=j * num_local,
                                num_local=num_local, capacity=cap)


def task_model(out: dict) -> None:
    from repro.distributed.context import use_mesh
    cfg = get_tiny_config("dbrx-132b")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    out.update({f"params/{k}": v for k, v in flat(params).items()})
    rng = np.random.default_rng(2)
    B, S = MODEL_SHAPE
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    steps = rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1))
    out["tokens"], out["steps"] = tokens, steps
    with use_mesh(mesh_of((2, 2))):
        logits, cache = jax.jit(model.prefill)(params,
                                               {"tokens": jnp.asarray(tokens)})
        out["prefill"] = np.asarray(logits)
        cache = model.extend_cache(cache, DECODE_STEPS)
        decode = jax.jit(model.decode_step)
        for t in range(DECODE_STEPS):
            logits, cache = decode(params, cache,
                                   {"tokens": jnp.asarray(steps[t])})
            out[f"decode/{t}"] = np.asarray(logits)
        out["cache/k"] = np.asarray(cache["k"], np.float32)
        out["cache/v"] = np.asarray(cache["v"], np.float32)


def model_inputs(cfg) -> tuple[np.ndarray, np.ndarray]:
    """A prompt (B, S) of token ids, or (B, S, d) embeddings for a stub
    frontend, and ``DECODE_STEPS`` steps of one token (embedding) each."""
    rng = np.random.default_rng(6)
    B, S = MODEL_SHAPE
    if cfg.frontend != "none":
        return (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                rng.standard_normal((DECODE_STEPS, B, 1, cfg.d_model))
                .astype(np.float32))
    return (rng.integers(0, cfg.vocab_size, (B, S)),
            rng.integers(0, cfg.vocab_size, (DECODE_STEPS, B, 1)))


def task_tp(out: dict, cases=TP_ARCHS, serve: bool = True,
            loss: bool = False) -> None:
    """Each of ``cases`` (a tiny configuration, or one with its fields
    changed: ``_mesh_cases.case_config``), its parameters placed by the
    reference's ``param_shardings`` on each of ``TP_MESHES`` (so XLA
    computes attention, the MLP, the SSM, MLA and the vocab-parallel head
    tensor-parallel over "model"): where ``serve``, prefill logits, decode
    logits and the final cache (each entry but ``pos``); where ``loss``,
    the loss of the prompt against labels drawn from ``LABEL_SEED`` (the
    port's tests draw the same), the mean over the whole batch."""
    from repro.distributed.context import use_mesh
    from repro.distributed.sharding import param_shardings
    from repro.launch.specs import param_specs
    for case in cases:
        arch, fields = case_config(case)
        cfg = dataclasses.replace(get_tiny_config(arch), **fields)
        model = Model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        out.update({f"params/{case}/{k}": v for k, v in flat(params).items()})
        prompt, steps = model_inputs(cfg)
        labels = np.random.default_rng(LABEL_SEED).integers(
            0, LABEL_IDS, prompt.shape[:2])
        out[f"{case}/prompt"], out[f"{case}/steps"] = prompt, steps
        key = "embeds" if cfg.frontend != "none" else "tokens"
        for shape in TP_MESHES:
            mesh = mesh_of(shape)
            tag = f"{case}/{shape[0]}x{shape[1]}"
            placed = jax.device_put(params, param_shardings(
                param_specs(cfg), mesh))
            with use_mesh(mesh):
                if loss:
                    out[f"{tag}/loss"] = np.asarray(jax.jit(model.loss)(
                        placed, {key: jnp.asarray(prompt),
                                 "labels": jnp.asarray(labels)}))
                if not serve:
                    continue
                logits, cache = jax.jit(model.prefill)(
                    placed, {key: jnp.asarray(prompt)})
                out[f"{tag}/prefill"] = np.asarray(logits)
                cache = model.extend_cache(cache, DECODE_STEPS)
                decode = jax.jit(model.decode_step)
                for t in range(DECODE_STEPS):
                    logits, cache = decode(placed, cache,
                                           {key: jnp.asarray(steps[t])})
                    out[f"{tag}/decode/{t}"] = np.asarray(logits)
                for name, val in cache.items():
                    if name != "pos":
                        out[f"{tag}/cache/{name}"] = np.asarray(val,
                                                                np.float32)


def task_tp_mixers(out: dict) -> None:
    task_tp(out, TP_MIXER_ARCHS)


def task_shards(out: dict) -> None:
    """Where each leaf of tiny dbrx's tree lives on a (2, 2) mesh: for
    every device coordinate, each dim's (start, stop) from
    ``NamedSharding.devices_indices_map``."""
    from repro.distributed.sharding import param_shardings
    from repro.launch.specs import param_specs
    cfg = get_tiny_config("dbrx-132b")
    params = Model(cfg).init(jax.random.PRNGKey(0))
    out.update({f"params/{k}": v for k, v in flat(params).items()})
    mesh = mesh_of((2, 2))
    sh_tree = param_shardings(param_specs(cfg), mesh)

    def walk(tree, spec_tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, spec_tree[k], f"{prefix}{k}/")
                continue
            imap = spec_tree[k].devices_indices_map(tuple(v.shape))
            box = np.zeros((2, 2, v.ndim, 2), np.int64)
            for i in range(2):
                for j in range(2):
                    for dim, sl in enumerate(imap[mesh.devices[i, j]]):
                        start, stop, _ = sl.indices(v.shape[dim])
                        box[i, j, dim] = (start, stop)
            out[f"box/{prefix}{k}"] = box
            out[f"spec/{prefix}{k}"] = np.array(repr(spec_tree[k].spec))
    walk(params, sh_tree)


def task_psum(out: dict) -> None:
    from repro.distributed.collectives import compressed_psum_mean
    mesh = Mesh(np.array(jax.devices()), ("pod",))
    key = jax.random.PRNGKey(0)
    x = (np.random.default_rng(3).standard_normal(PSUM_SHAPE)
         * 0.01).astype(np.float32)
    example = np.arange(16, dtype=np.float32).reshape(4, 4) / 100.0
    for label, xs in (("seeded", x), ("example", example)):
        out[f"x/{label}"] = xs
        out[f"u/{label}"] = np.asarray(jax.random.uniform(key, xs.shape[1:]))
        for mode in ("none", "bf16", "int8"):
            def body(xl, k, mode=mode):
                return compressed_psum_mean(xl[0], "pod", k, mode=mode)[None]
            y = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P("pod", None), P()),
                out_specs=P("pod", None), check_vma=False))(
                    jnp.asarray(xs), key)
            out[f"out/{label}/{mode}"] = np.asarray(y)


if __name__ == "__main__":
    task, path = sys.argv[1], sys.argv[2]
    result: dict = {}
    {"moe": task_moe, "model": task_model, "shards": task_shards,
     "psum": task_psum, "tp": task_tp, "tp_mixers": task_tp_mixers,
     "tp_vocab": lambda out: task_tp(out, VOCAB_CASES, loss=True),
     "tp_seq": lambda out: task_tp(out, SEQ_CASES, serve=False, loss=True)
     }[task](result)
    np.savez(path, **result)
    print("OK", len(result))
