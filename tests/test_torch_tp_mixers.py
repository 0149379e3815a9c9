"""The SSM mixer and MLA tensor-parallel over "model" (``repro_torch.models.
ssm``, ``repro_torch.models.layers.MLA`` under a mesh) against the
reference's model under the same mesh and against the unsharded port, on
the CPU.

The reference runs in a subprocess on 4 forced host devices
(``_jax_mesh_ref.py tp_mixers``), its parameters placed by its own
``param_shardings``; the port runs one process per rank on gloo
(``_torch_dist.tp_mixer_ranks``), each on its batch shard.  Meshes (1, 2),
(2, 2) and (1, 4) over ("data", "model"); tiny mamba2-2.7B (8 SSM heads of
16, one B/C group), hymba-1.5B (4/2 attention heads beside 8 SSM heads)
and minicpm3-4B (MLA, 4 heads).  Every one of their head counts divides
"model" on each mesh but hymba's 2 KV heads on (1, 4), which the rank
gathers (``tests/test_torch_tp.py``).

* Each rank's prefill and decode logits against the reference's rows at
  1e-4 (``test_torch_tp.py``'s gate).
* The caches: ``state`` holds the rank's heads, ``conv`` its channels (its
  heads' x channels, then B and C), mapped back to the reference's
  ``conv_dim`` columns; MLA's latent (``ckv``, ``krope``) whole on every
  rank; hymba's K/V heads as ``test_torch_tp.py`` holds them.
* A training step's loss and gradient shards against the unsharded port,
  float32 at rtol 1e-5 / atol 1e-6, bf16 by ``test_torch_tp.py``'s
  per-leaf rule against the float32 gradient (readings on the CPU: at most
  1.94e-2 relative above the floor, hymba's ``wq`` on (1, 4); the leaves
  below it in ``NEAR_ZERO``).
* The layers saw only their share: ``w_out`` at d_inner/n rows, MLA's
  ``wq_b``, ``wk_b``, ``wv_b``, ``wo`` at H/n heads, K3 and K2 launched on
  the local heads.
* Two edge cases against the unsharded port: tiny mamba2 with 2 SSM heads
  of 64 on (1, 4), where 4 divides d_inner but not the heads, so the mixer
  runs whole on every rank; a tiny hybrid whose 3 attention heads do not
  divide "model" (gathered) while its 8 SSM heads do (4 a rank).  And the
  full configurations' remat on (1, 2), the same way: hymba and mamba2
  under "full", minicpm3 under "dots".
* ``rmsnorm_split`` over a last dim split over 2 and 4 ranks equals
  ``rmsnorm`` of the whole, and so do its input gradients.
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
from _mesh_cases import DECODE_STEPS, TP_DTYPES, TP_MESHES, TP_MIXER_ARCHS
from repro_torch.configs import get_tiny_config
from test_torch_tp import MODEL_TOL, _close, _hold_bf16, _np

MESH_IDS = [f"{a}x{b}" for a, b in TP_MESHES]
# The leaves whose float32 gradient norm falls below ``test_torch_tp``'s
# floor (1e-4 of the largest leaf's, the head's) in the bf16 step, by
# configuration: 9.6e-7 to 9.8e-5 of the largest on the CPU, each within
# 0.01-0.03 of its own norm from float32 and below the floor, as the rule
# holds them.  Small leaves, not rounding noise: SSM decays and step
# biases, a hybrid's second norm, MLA's query-latent norm.
NEAR_ZERO = {
    "mamba2-2_7b": {f"layers.{i}.ssm.{leaf}" for i in (0, 1)
                    for leaf in ("A_log", "dt_bias")},
    "hymba-1_5b": {f"layers.{i}.{leaf}" for i in (0, 1)
                   for leaf in ("ssm.A_log", "ssm.dt_bias", "ln2.scale")},
    "minicpm3-4b": {f"layers.{i}.attn.q_norm.scale" for i in (0, 1)},
}
WHAT = ["prefill"] + [f"decode/{t}" for t in range(DECODE_STEPS)]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The reference's results and the port's ranks' results, once."""
    tmp = tmp_path_factory.mktemp("mixers")
    ref = tmp / "mixers.npz"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parents[1] / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable,
                        str(Path(__file__).with_name("_jax_mesh_ref.py")),
                        "tp_mixers", str(ref)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for world in (2, 4):
        _torch_dist.spawn(_torch_dist.tp_mixer_ranks, world, tmp, str(ref),
                          str(tmp), timeout=300.0)
    ranks = {w: _torch_dist.load(tmp, f"mixers{w}", w) for w in (2, 4)}
    return {"ref": dict(np.load(ref)), "ranks": ranks}


def _ranks(out, shape, arch):
    return [res[f"{arch}/{shape[0]}x{shape[1]}"]
            for res in out["ranks"][shape[0] * shape[1]]]


def _ssm_share(cfg, n: int, j: int) -> tuple[slice, list[int]]:
    """Rank j's SSM heads, and its ``conv`` channels as the reference's
    ``conv_dim`` columns: its heads' x channels, its groups' B and C (one
    group in every configuration here: all of B and C)."""
    hl = cfg.ssm_heads // n
    di, gd = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    hp = cfg.ssm_head_dim
    cols = list(range(j * hl * hp, (j + 1) * hl * hp)) + \
        list(range(di, di + 2 * gd))
    return slice(j * hl, (j + 1) * hl), cols


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("arch", TP_MIXER_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_logits_match_the_sharded_reference(out, shape, arch, what):
    want = out["ref"][f"{arch}/{shape[0]}x{shape[1]}/{what}"]
    bl = want.shape[0] // shape[0]
    for res in _ranks(out, shape, arch):
        i = res["data"]
        np.testing.assert_allclose(res[what].float().numpy(),
                                   want[i * bl:(i + 1) * bl], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"{arch} {what}")


@pytest.mark.parametrize("arch", TP_MIXER_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_cache_holds_the_ranks_share(out, shape, arch):
    """``state``: the rank's heads; ``conv``: its channels; MLA's latent
    whole; K/V: the KV heads its query heads read.  Each equal to the
    reference's final cache there."""
    cfg = get_tiny_config(arch)
    n = shape[1]
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    ref = {k.rsplit("/", 1)[1]: v for k, v in out["ref"].items()
           if k.startswith(f"{tag}/cache/")}
    for res in _ranks(out, shape, arch):
        i, j = res["data"], res["model"]
        got = res["cache"]
        assert set(got) == set(ref), (set(got), set(ref))
        bl = next(iter(ref.values())).shape[1] // shape[0]
        want = {k: v[:, i * bl:(i + 1) * bl] for k, v in ref.items()}
        if cfg.uses_ssm:
            heads, cols = _ssm_share(cfg, n, j)
            want["state"] = want["state"][:, :, heads]
            want["conv"] = want["conv"][..., cols]
        if "k" in want:
            from repro_torch.models.layers import head_shard
            sh = head_shard(cfg, n, j)
            for key in ("k", "v"):
                want[key] = want[key][:, :, :, sh.kv0:sh.kv1]
        for key, w in want.items():
            np.testing.assert_allclose(got[key].float().numpy(), w,
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=f"{tag} {key} rank {i},{j}")


@pytest.mark.parametrize("dtype", TP_DTYPES)
@pytest.mark.parametrize("arch", TP_MIXER_ARCHS)
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
            _hold_bf16(arch, r, got["grads"], res["train/float32"]["want"],
                       NEAR_ZERO)


def _share_rows(cfg, n: int, rows: list) -> None:
    """Every row of ``_torch_dist.every_share`` at the share the layers
    compute on over ``n`` ranks: a mixer's heads split where n divides
    them, whole where it does not."""
    def split(full: int, heads: int) -> int:
        return full // n if heads % n == 0 else full

    for cls, leaf, size, full in rows:
        what = (cls, leaf, size, full, n)
        if cls == "SSM":
            assert size == split(full, cfg.ssm_heads), what
        elif cls == "MLA":
            assert size == split(full, full), what
        elif cls == "K3":
            assert size == split(cfg.ssm_heads, cfg.ssm_heads), what
        elif cls == "K2":
            if cfg.attention == "mla":
                H = split(cfg.num_heads, cfg.num_heads)
                assert size == (H, H), what
            else:
                assert size[0] == split(cfg.num_heads, cfg.num_heads), what
        else:                          # test_torch_tp.py's rule
            kv = leaf in ("wk", "wv", "bk", "bv")
            want = full if kv and full % n else split(full, full)
            assert size == want, what


@pytest.mark.parametrize("arch", TP_MIXER_ARCHS)
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_layers_see_only_their_share(out, shape, arch):
    """In prefill, decode and both training steps, every SSM and MLA call
    saw its tensor-parallel leaves at their share, and K3 / K2 ran on the
    rank's heads, never whole."""
    cfg = get_tiny_config(arch)
    for res in _ranks(out, shape, arch):
        rows = res["shapes"] + [row for dtype in TP_DTYPES
                                for row in res[f"train/{dtype}"]["shapes"]]
        kinds = {cls for cls, *_ in rows}
        assert ("SSM" in kinds) == cfg.uses_ssm
        assert ("K3" in kinds) == cfg.uses_ssm
        assert ("MLA" in kinds) == (cfg.attention == "mla")
        _share_rows(cfg, shape[1], rows)


@pytest.mark.parametrize("case", list(_torch_dist.MIXER_EDGES))
def test_edge_cases_match_unsharded(out, case):
    """``_torch_dist.MIXER_EDGES``: logits, cache, loss and gradient shards
    against the unsharded port; the shares the layers saw (mamba2 with 2
    heads on 4 ranks: ``w_out`` and K3 whole; the hybrid: attention whole,
    the SSM 4 of 8 heads a rank; under remat, as without it)."""
    world = int(np.prod(_torch_dist.MIXER_EDGES[case][2]))
    for res in out["ranks"][world]:
        edge = res["edge"][case]
        cfg = dataclasses.replace(get_tiny_config(edge["arch"]), **edge["fields"])
        n = edge["shape"][1]
        sh, plain = edge["sharded"], edge["plain"]
        bl = plain["prefill"].shape[0] // edge["shape"][0]
        rows = slice(edge["data"] * bl, (edge["data"] + 1) * bl)
        for what in WHAT:
            np.testing.assert_allclose(sh[what].numpy(),
                                       plain[what][rows].numpy(),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=what)
        want = {k: v[:, rows] for k, v in plain["cache"].items()}
        if cfg.uses_ssm and cfg.ssm_heads % n == 0:
            heads, cols = _ssm_share(cfg, n, edge["model"])
            want["state"] = want["state"][:, :, heads]
            want["conv"] = want["conv"][..., cols]
        if cfg.attention in ("gqa", "swa") and cfg.num_heads % n == 0:
            from repro_torch.models.layers import head_shard
            sh_kv = head_shard(cfg, n, edge["model"])
            for key in ("k", "v"):
                want[key] = want[key][:, :, :, sh_kv.kv0:sh_kv.kv1]
        assert set(want) == set(sh["cache"])
        for key, w in want.items():
            np.testing.assert_allclose(sh["cache"][key].numpy(), w.numpy(),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=key)
        _close(sh["loss"], plain["loss"], "float32", "loss")
        assert set(sh["grads"]) == set(plain["grads"])
        for name, g in sh["grads"].items():
            _close(g, plain["grads"][name], "float32", name)
        _share_rows(cfg, n, sh["shapes"])
        kinds = {(cls, leaf) for cls, leaf, *_ in sh["shapes"]}
        mixer = "MLA" if cfg.attention == "mla" else "SSM"
        assert (mixer, "wq_b" if mixer == "MLA" else "w_out") in kinds
        if cfg.family == "hybrid":
            assert ("Attention", "wq") in kinds


@pytest.mark.parametrize("world", [2, 4])
def test_rmsnorm_split_equals_rmsnorm(out, world):
    """``rmsnorm_split`` on ``world`` ranks, each holding its slice of the
    last dim (``_torch_dist.norm_slice``), in float32 and bf16: the slices
    of ``rmsnorm`` of the whole, and each slice's input gradient the
    whole's slice."""
    from repro_torch.models.layers import rmsnorm
    x, scale, g = _torch_dist.norm_inputs()
    ranks = [res["norm"] for res in out["ranks"][world]]
    for dtype in TP_DTYPES:
        xx = x.to(getattr(torch, dtype)).detach().requires_grad_(True)
        want = rmsnorm(scale.to(xx.dtype), xx, _torch_dist.NORM_EPS)
        (want.float() * g).sum().backward()
        got = torch.cat([r[dtype] for r in ranks], -1)
        grad = torch.cat([r[f"grad/{dtype}"] for r in ranks], -1)
        _close(got, want.detach(), dtype, f"{dtype} rmsnorm")
        _close(grad, xx.grad, dtype, f"{dtype} gradient")
