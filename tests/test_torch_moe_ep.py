"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_block``
under a mesh) against the reference's sharded ``moe_block`` (its
``shard_map`` path), on the CPU.

The reference runs in a subprocess on 4 forced host devices
(``_jax_mesh_ref.py``); the port runs one process per rank on gloo
(``_torch_dist.py``), each on its batch shard, and is compared by mesh
coordinate: rank (i, j) holds rows ``[i·B/n_data, (i+1)·B/n_data)`` of
the reference's output.  Meshes (1, 2), (2, 2) and (1, 4) over ("data",
"model"), tiny dbrx (4 experts, top-2) and tiny llama4 (4 experts, top-1,
a shared expert), in float32 and bfloat16, at the configs' capacity
factor and at 0.5, where capacity binds.

Tolerances (``test_torch_moe.py``'s gates): float32 at rtol 1e-5 /
atol 1e-6 — the shards' partial outputs and a token's k contributions add
in other orders; bfloat16 at rtol 1e-2 and atol 1e-2 of the reference's
largest magnitude — both sides round each shard's output to bf16 before
the sum, which each also takes in bf16, in its own order.  Each rank's
kept (token, choice) -> (expert, slot) set must equal the reference's
dispatch of the same shard: capacity comes from the shard's tokens.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist
from _mesh_cases import (DECODE_STEPS, MOE_ARCHS, MOE_CAPACITY, MOE_DTYPES,
                         MOE_MESHES, MOE_SHAPE)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-2)}


def reference(tasks: dict) -> None:
    """Run the reference's side of each task at once, each into its
    path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                   "_jax_mesh_ref.py"),
                               task, str(path)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for task, path in tasks.items()]
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0 and "OK" in stdout, stderr[-3000:]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The reference's results and the port's ranks' results, once."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    moe_ref, model_ref = tmp / "moe.npz", tmp / "model.npz"
    reference({"moe": moe_ref, "model": model_ref})
    for world in (2, 4):
        _torch_dist.spawn(_torch_dist.ep_ranks, world, tmp, str(moe_ref),
                          str(model_ref), str(tmp))
    return {"moe_ref": dict(np.load(moe_ref)),
            "model_ref": dict(np.load(model_ref)),
            "moe": {w: _torch_dist.load(tmp, f"moe{w}", w) for w in (2, 4)},
            "grad": _torch_dist.load(tmp, "moe_grad", 2),
            "model": _torch_dist.load(tmp, "model", 4)}


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("capacity", MOE_CAPACITY)
@pytest.mark.parametrize("dtype", MOE_DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_block_matches_sharded_reference(out, shape, arch, dtype,
                                             capacity):
    tag = f"{arch}/{dtype}/{capacity}/{shape[0]}x{shape[1]}"
    want = out["moe_ref"][f"out/{tag}"]
    ranks = out["moe"][shape[0] * shape[1]]
    bl = MOE_SHAPE[0] // shape[0]
    seen = set()
    for r, res in enumerate(ranks):
        got = res[tag]
        i, j = got["coord"]
        seen.add((i, j))
        _close(got["out"].numpy(), want[i * bl:(i + 1) * bl], dtype,
               f"{tag} rank {r} at {(i, j)}")
        ref_slots = [tuple(row) for row in
                     out["moe_ref"][f"slots/{tag}/{i}{j}"].tolist()]
        assert len(got["slots"]) == 1
        assert got["slots"][0] == ref_slots, f"{tag} rank {r}: kept slots"
    assert seen == {(i, j) for i in range(shape[0]) for j in range(shape[1])}


def test_tight_capacity_binds(out):
    """The "tight" cases drop pairs, so the kept-slot checks above see
    capacity bind on every mesh."""
    ref = out["moe_ref"]
    B, S = MOE_SHAPE
    for shape in MOE_MESHES:
        tag = f"dbrx-132b/float32/tight/{shape[0]}x{shape[1]}"
        kept = sum(len(ref[f"slots/{tag}/{i}{j}"])
                   for i in range(shape[0]) for j in range(shape[1]))
        assert kept < B * S * 2, (shape, kept)


def test_each_rank_keeps_only_its_experts(out):
    for world, ranks in out["moe"].items():
        for res in ranks:
            for tag, got in res.items():
                n_model = int(tag.split("/")[-1].split("x")[1])
                num_local = max(4 // n_model, 1)
                assert all(0 <= e < num_local for _, _, e, _ in
                           got["slots"][0]), tag


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_gradients_match_unsharded(out, arch):
    """(1, 2): capacity equals the unsharded one, so loss, the input's and
    the router's gradients equal the unsharded layer's, and each rank's
    experts' gradients are the unsharded ones on its rows (zero
    elsewhere), at float32's 1e-5."""
    for res in out["grad"]:
        got = res[arch]
        sh, un = got["sharded"], got["unsharded"]
        r = got["rank"]
        torch.testing.assert_close(sh["loss"], un["loss"], rtol=1e-5,
                                   atol=1e-5)
        for name in sh:
            if name == "loss":
                continue
            a, b = sh[name], un[name]
            if name.split("/")[-1] in ("w_in", "w_gate", "w_out"):
                mine = slice(2 * r, 2 * r + 2)
                torch.testing.assert_close(a[mine], b[mine], rtol=1e-5,
                                           atol=1e-6, msg=name)
                rest = torch.ones(a.shape[0], dtype=torch.bool)
                rest[mine] = False
                assert not a[rest].any(), name
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                           msg=name)


@pytest.mark.parametrize("what", ["prefill"] + [f"decode/{t}" for t in
                                                range(DECODE_STEPS)])
def test_model_under_mesh_matches_reference(out, what):
    """Tiny dbrx, its parameters placed with ``shard_params`` on (2, 2):
    each rank's prefill and decode logits against the reference's model
    under the same mesh, at 1e-4 (the MoE test's float32 model gate)."""
    want = out["model_ref"][what]
    bl = want.shape[0] // 2
    for res in out["model"]:
        i = res["data"]
        np.testing.assert_allclose(res[what].numpy(),
                                   want[i * bl:(i + 1) * bl], rtol=1e-4,
                                   atol=1e-4, err_msg=what)


def test_model_cache_under_mesh_matches_reference(out):
    """Each rank's cache holds its batch rows of the KV heads its query
    heads read (attention is tensor-parallel over "model": tiny dbrx's 2 KV
    heads, one a rank), equal to the reference's there."""
    ref = out["model_ref"]
    bl = ref["cache/k"].shape[1] // 2
    heads = set()
    for res in out["model"]:
        i = res["data"]
        kv0, kv1 = res["kv"]
        assert kv1 - kv0 == 1
        heads.add((i, kv0))
        for key in ("k", "v"):
            np.testing.assert_allclose(
                res[key].numpy(),
                ref[f"cache/{key}"][:, i * bl:(i + 1) * bl, :, kv0:kv1],
                rtol=1e-4, atol=1e-4, err_msg=key)
    assert heads == {(i, h) for i in range(2) for h in range(2)}
