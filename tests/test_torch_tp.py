"""Tensor-parallel attention and MLP over "model" (``repro_torch.models.
layers`` under a mesh) against the reference's model under the same mesh
and against the unsharded port, on the CPU.

The reference runs in a subprocess on 4 forced host devices
(``_jax_mesh_ref.py tp``), its parameters placed by its own
``param_shardings``, so that XLA's partitioner computes each device's heads
and MLP columns and sums the output products over "model".  The port runs
one process per rank on gloo (``_torch_dist.py``), each on its batch shard,
its parameters placed by ``shard_params``.  Meshes (1, 2), (2, 2) and (1,
4) over ("data", "model"); tiny qwen2-72b (GQA 4:2 with QKV bias),
musicgen-medium (embeddings in), llama4-maverick (a dense layer, then a MoE
layer with a shared expert) and dbrx-132b (attention beside the
expert-parallel MoE).  Their two KV heads divide "model" on (1, 2) and (2,
2); on (1, 4) each rank gathers ``wk``/``wv`` and keeps the one KV head its
query head reads.

* Each rank's prefill and decode logits and its cache heads against the
  reference's rows and heads at 1e-4 (``test_model_under_mesh_matches_
  reference``'s float32 gate): the partial products' sum over "model" is
  taken in another order on each side.
* A training step: each rank's loss and its gradient shard of every
  parameter against the unsharded port's (the sum of the data shards'
  losses, whose gradient the mesh's sums over "data" give; each gradient's
  slice under the parameter's placements), in float32 at rtol 1e-5 / atol
  1e-6.  In bfloat16 the loss is held at ``test_torch_moe_ep.py``'s band
  (rtol 1e-2, atol 1e-2 of the largest magnitude).  A bf16 gradient is
  held leaf by leaf against the float32 one, not against the unsharded
  bf16 run: that run is itself up to 2.39e-2 (relative L2) from float32
  (tiny qwen2-72b's ``bk`` on (1, 4)), and on tiny llama4 (top-1 routing)
  it routes a token to another expert than float32 does where the
  tensor-parallel run does not, which moves its leaves by up to 52 %.  So
  each leaf whose float32 gradient norm is at least ``GRAD_FLOOR`` of the
  largest leaf's is held at a relative L2 distance of at most
  ``BF16_GRAD`` from it (the readings on the CPU reach 1.49e-2, qwen2's
  ``bq`` on (1, 4)).  Below that floor the float32 gradient is rounding
  noise of the terms it sums, and the leaves there are named in
  ``NEAR_ZERO``: llama4's router (5.7e-10 to 1.0e-9 of the largest: top-1
  routing renormalises its one weight to 1) and qwen2's ``bk`` on (1, 4)
  (3.3e-6 to 7.6e-6: a key bias moves a query's scores alike but for
  RoPE's rotation), 0.24 to 1.17 of their own norm apart; their distance
  is held below the floor too.  The tensor-parallel path rounds each
  rank's partial products to bf16 before their sum over "model", which is
  taken in bf16, as the reference's products give them.
* At every call the layers saw each tensor-parallel leaf at its share:
  ``wq``, ``wo``, ``bq`` at H/n heads, the MLP's ``wi``, ``wg``, ``wo`` at
  d_ff/n columns, ``wk``, ``wv``, ``bk``, ``bv`` at KH/n where n divides KH
  (else whole, sliced by the layer).
* A configuration whose query heads split its KV heads unevenly (6:3 heads
  over 2 ranks) repeats K/V per local query head for K2 and decode; its
  logits and gradients against the unsharded port.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist
from _mesh_cases import DECODE_STEPS, TP_ARCHS, TP_DTYPES, TP_MESHES
from repro_torch.configs import get_tiny_config
from repro_torch.models.layers import head_shard

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-2)}
MODEL_TOL = 1e-4
# a bf16 gradient shard's relative L2 distance from the float32 one, for
# each leaf whose float32 norm is at least GRAD_FLOOR of the largest leaf's
BF16_GRAD, GRAD_FLOOR = 2e-2, 1e-4
# the leaves that may fall below the floor, by configuration
NEAR_ZERO = {"qwen2-72b": {"layers.0.attn.bk", "layers.1.attn.bk"},
             "llama4-maverick-400b-a17b": {"layers.1.moe.router"}}
MESH_IDS = [f"{a}x{b}" for a, b in TP_MESHES]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The reference's results and the port's ranks' results, once."""
    tmp = tmp_path_factory.mktemp("tp")
    ref = tmp / "tp.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_jax_mesh_ref.py"), "tp",
                        str(ref)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for world in (2, 4):
        _torch_dist.spawn(_torch_dist.tp_ranks, world, tmp, str(ref),
                          str(tmp), timeout=300.0)
    ranks = {w: _torch_dist.load(tmp, f"tp{w}", w) for w in (2, 4)}
    return {"ref": dict(np.load(ref)), "ranks": ranks}


def _ranks(out, shape, arch):
    return [res[f"{arch}/{shape[0]}x{shape[1]}"]
            for res in out["ranks"][shape[0] * shape[1]]]


def _np(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    want = _np(want)
    if dtype == "bfloat16":
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("what", ["prefill"] + [f"decode/{t}" for t in
                                                range(DECODE_STEPS)])
@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_logits_match_the_sharded_reference(out, shape, arch, what):
    want = out["ref"][f"{arch}/{shape[0]}x{shape[1]}/{what}"]
    bl = want.shape[0] // shape[0]
    for res in _ranks(out, shape, arch):
        i = res["data"]
        np.testing.assert_allclose(res[what].float().numpy(),
                                   want[i * bl:(i + 1) * bl], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"{arch} {what}")


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_cache_holds_the_ranks_heads(out, shape, arch):
    """Each rank's cache holds the KV heads of its query heads (the
    reference's cache shard where KH divides "model"), equal to the
    reference's at those heads."""
    cfg = get_tiny_config(arch)
    n = shape[1]
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    bl = out["ref"][f"{tag}/cache/k"].shape[1] // shape[0]
    seen = set()
    for r, res in enumerate(_ranks(out, shape, arch)):
        i = res["data"]
        j = r % n                      # rank (i, j) is i * n + j
        sh = head_shard(cfg, n, j)
        assert res["kv"] == (sh.kv0, sh.kv1)
        if cfg.num_kv_heads % n == 0:
            per = cfg.num_kv_heads // n
            assert res["kv"] == (j * per, (j + 1) * per)
        seen.add(res["kv"])
        for key in ("k", "v"):
            want = out["ref"][f"{tag}/cache/{key}"][
                :, i * bl:(i + 1) * bl, :, sh.kv0:sh.kv1]
            np.testing.assert_allclose(res[key].numpy(), want,
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=f"{tag} {key} rank {r}")
    heads = sorted(h for kv in seen for h in range(*kv))
    assert sorted(set(heads)) == list(range(cfg.num_kv_heads))


def _hold_bf16(arch: str, rank: int, grads: dict, g32: dict,
               near_zero: dict = NEAR_ZERO) -> None:
    """Each bf16 gradient shard against the float32 one: ``BF16_GRAD``
    relative above ``GRAD_FLOOR`` of the largest leaf's norm; below it, a
    leaf of ``near_zero`` whose distance is below the floor too."""
    floor = GRAD_FLOOR * max(float(np.linalg.norm(_np(g)))
                             for g in g32.values())
    for name, g in grads.items():
        norm = float(np.linalg.norm(_np(g32[name])))
        dist = float(np.linalg.norm(_np(g) - _np(g32[name])))
        what = (arch, rank, name, dist, norm)
        if norm >= floor:
            assert dist <= BF16_GRAD * norm, what
        else:
            assert name in near_zero.get(arch, ()), what
            assert dist <= floor, what


@pytest.mark.parametrize("dtype", TP_DTYPES)
@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_training_step_matches_unsharded(out, shape, arch, dtype):
    for r, res in enumerate(_ranks(out, shape, arch)):
        got = res[f"train/{dtype}"]
        _close(got["loss"], got["want_loss"], dtype, f"loss rank {r}")
        assert set(got["grads"]) == set(got["want"])
        for name, g in got["grads"].items():
            want = got["want"][name]
            assert g.shape == want.shape, name
            if dtype == "float32":
                _close(g, want, dtype, f"{arch} rank {r}: {name}")
        if dtype == "bfloat16":
            _hold_bf16(arch, r, got["grads"], res["train/float32"]["want"])


@pytest.mark.parametrize("arch", TP_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_layers_see_only_their_share(out, shape, arch):
    """The hook of ``LeafShapes``: in prefill, decode and both training
    steps, every attention and MLP call saw its tensor-parallel leaves at
    their share, never whole."""
    n = shape[1]
    cfg = get_tiny_config(arch)
    mlp = cfg.shared_expert_ff or not cfg.uses_moe or cfg.moe_every > 1
    for res in _ranks(out, shape, arch):
        rows = res["shapes"] + [row for dtype in TP_DTYPES
                                for row in res[f"train/{dtype}"]["shapes"]]
        kinds = {(cls, leaf) for cls, leaf, _, _ in rows}
        assert ("Attention", "wq") in kinds
        assert (("MLP", "wi") in kinds) == bool(mlp)
        for cls, leaf, size, full in rows:
            kv = leaf in ("wk", "wv", "bk", "bv")
            want = full if kv and full % n else full // n
            assert size == want, (cls, leaf, size, full, n)


def _uneven_ranks(rank: int, world: int, out: str) -> None:
    """6 query heads over 3 KV heads on (1, 2): rank 0 reads KV heads 0,
    0, 1, rank 1 1, 2, 2.  Prefill, four decode steps and a float32
    training step, sharded and unsharded."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.distributed.sharding import local_slice, shard_params
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_tiny_config("qwen2-72b"), num_heads=6,
                              num_kv_heads=3)
    mesh = _torch_dist._mesh((1, 2))
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, 97, (2, 9)))
    steps = torch.from_numpy(rng.integers(0, 97, (DECODE_STEPS, 2, 1)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    result = {}
    for how in ("sharded", "plain"):
        model = Model(cfg, device="cpu")
        with torch.no_grad():          # biases away from 0
            for blk in model.layers:
                for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv):
                    b.copy_(torch.randn(b.shape, generator=torch.Generator()
                                        .manual_seed(b.numel())) * 0.1)
        if how == "sharded":
            shard_params(model, mesh)
        with use_mesh(mesh if how == "sharded" else None):
            logits, cache = model.prefill({"tokens": tokens})
            run = {"prefill": logits}
            cache = model.extend_cache(cache, DECODE_STEPS)
            for t in range(DECODE_STEPS):
                logits, cache = model.decode_step(cache, {"tokens": steps[t]})
                run[f"decode/{t}"] = logits
            run["shard"] = model.layers[0].attn.head_shard()
            model.requires_grad_(True)
            loss = model.loss(batch)
            loss.backward()
        run["loss"] = loss.detach()
        run["k"] = cache["k"]
        run["grads"] = {k: p.grad for k, p in model.named_parameters()}
        result[how] = run
    sharded, plain = result["sharded"], result["plain"]
    plain["grads"] = {k: local_slice(g, mesh, sharded["grads"][k].placements)
                      for k, g in plain["grads"].items()}
    sharded["grads"] = {k: g.to_local() for k, g in sharded["grads"].items()}
    sh = sharded["shard"]
    sharded["shard"] = (sh.h0, sh.hl, sh.kv0, sh.kv1, sh.expand)
    _torch_dist._save(out, "uneven", rank, result)


def test_uneven_kv_heads_expand_per_query_head(tmp_path):
    _torch_dist.spawn(_uneven_ranks, 2, tmp_path, str(tmp_path),
                      timeout=150.0)
    for r, res in enumerate(_torch_dist.load(tmp_path, "uneven", 2)):
        sh, plain = res["sharded"], res["plain"]
        h0, hl, kv0, kv1, expand = sh["shard"]
        assert (h0, hl, kv0, kv1) == ((0, 3, 0, 2) if r == 0
                                      else (3, 3, 1, 3))
        assert expand == ((0, 0, 1) if r == 0 else (0, 1, 1))
        assert plain["shard"] is None
        for what in ["prefill"] + [f"decode/{t}" for t in
                                   range(DECODE_STEPS)]:
            np.testing.assert_allclose(sh[what].numpy(), plain[what].numpy(),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=what)
        np.testing.assert_allclose(sh["k"].numpy(),
                                   plain["k"][:, :, :, kv0:kv1].numpy(),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        _close(sh["loss"], plain["loss"], "float32", "loss")
        for name, g in sh["grads"].items():
            _close(g, plain["grads"][name], "float32", name)
