"""Megatron-SP (``seq_shard_activations``: the residual stream's sequence
over "model" between the tensor-parallel regions, ``repro_torch.
distributed.collectives.region_in`` / ``region_out``) against the
reference's model under the same mesh and flag and against the unsharded
port, on the CPU.

The reference runs in a subprocess on 4 forced host devices
(``_jax_mesh_ref.py tp_seq``: the loss under each mesh with
``seq_shard_activations``); the port runs one process per rank on gloo
(``_torch_dist.case_ranks``), each on its batch shard.  Meshes (1, 2), (2,
2) and (1, 4) over ("data", "model"); the cases of ``_mesh_cases.
SEQ_CASES``: tiny qwen2-72b (attention and MLP), hymba-1.5B (attention
beside the SSM, both mix norms), mamba2-2.7B (the SSM), minicpm3-4B (MLA),
dbrx-132B (attention beside the expert-parallel MoE) and musicgen-medium
(embeddings in: the adapter's output split), each with the flag set.
Their 8 tokens a row divide every "model" axis.

* The float32 loss: the mean of the data ranks' losses against the
  reference's under the mesh and the flag, rtol 1e-5.
* A training step's loss and every gradient shard (the norm scales, which
  SP applies to a rank's rows, included) against the unsharded port,
  float32 at rtol 1e-5 / atol 1e-6, bf16 by ``test_torch_tp.py``'s
  per-leaf rule.
* Every layer took and gave S/n rows of the residual stream, and the
  vocab-parallel heads V/n columns.
* dbrx: the kept slots of every ``moe_local`` call equal those of the same
  loss without SP (the capacity reads the gathered tokens).
* Edge cases against the unsharded port (``_torch_dist.mixer_edge``):
  remat "full" (what it holds of a layer, its input, is S/n rows) and
  "dots", which also equals "full"; S % n != 0, which falls back to the
  whole stream; mixers that run whole on every rank (mamba2 with 2 SSM
  heads on 4, a hybrid with 3 attention heads on 2, MLA with 3 heads on 2,
  an MLP of 130 columns on 4) and a vocab of 254 on 4 (the head whole).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dist
from _mesh_cases import SEQ_CASES, TP_DTYPES, TP_MESHES, case_config
from test_torch_tp import MODEL_TOL, NEAR_ZERO, _close, _hold_bf16
from test_torch_tp_mixers import NEAR_ZERO as MIXER_NEAR_ZERO
from test_torch_tp_vocab import WHAT, _cfg

ROOT = Path(__file__).resolve().parents[1]
MESH_IDS = [f"{a}x{b}" for a, b in TP_MESHES]
# the bf16 leaves that may fall below test_torch_tp's floor, by case
CASE_NEAR_ZERO = {case: {**NEAR_ZERO, **MIXER_NEAR_ZERO}.get(arch, set())
                  for case, (arch, _) in SEQ_CASES.items()}
SP = {"seq_shard_activations": True}
# (tiny configuration, changed fields, mesh[, mixer_edge's arguments])
SEQ_EDGES = {
    "remat-full": ("qwen2-72b", {**SP, "remat": "full"}, (1, 2)),
    "remat-dots": ("qwen2-72b", {**SP, "remat": "dots"}, (1, 2)),
    "hybrid-remat-full-on-4": ("hymba-1_5b", {**SP, "remat": "full"},
                               (1, 4)),
    # 7 and 6 tokens a row: "model" does not divide them
    "fallback-7-on-2": ("qwen2-72b", SP, (1, 2), {"seq": 7}),
    "fallback-6-on-4": ("hymba-1_5b", SP, (1, 4), {"seq": 6}),
    # modules that run whole on every rank
    "ssm-heads-2-on-4": ("mamba2-2_7b", {**SP, "ssm_head_dim": 64}, (1, 4)),
    "hybrid-attention-3-on-2": ("hymba-1_5b", {**SP, "num_heads": 3,
                                               "num_kv_heads": 1}, (1, 2)),
    "mla-heads-3-on-2": ("minicpm3-4b", {**SP, "num_heads": 3}, (1, 2)),
    "mlp-cols-130-on-4": ("qwen2-72b", {**SP, "d_ff": 130}, (1, 4)),
    "vocab-254-on-4": ("qwen2-72b", {**SP, "vocab_size": 254}, (1, 4)),
}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The reference's losses and the port's ranks' results, once."""
    tmp = tmp_path_factory.mktemp("seq")
    ref = tmp / "seq.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_jax_mesh_ref.py"), "tp_seq",
                        str(ref)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for world in (2, 4):
        _torch_dist.spawn(_torch_dist.case_ranks, world, tmp, str(ref),
                          str(tmp), "seq", list(SEQ_CASES), False,
                          SEQ_EDGES, timeout=300.0)
    ranks = {w: _torch_dist.load(tmp, f"seq{w}", w) for w in (2, 4)}
    return {"ref": dict(np.load(ref)), "ranks": ranks}


def _ranks(out, shape, case):
    return [res[f"{case}/{shape[0]}x{shape[1]}"]
            for res in out["ranks"][shape[0] * shape[1]]]


def _edge(out, case):
    world = int(np.prod(SEQ_EDGES[case][2]))
    return [res["edge"][case] for res in out["ranks"][world]]


@pytest.mark.parametrize("case", list(SEQ_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_loss_matches_the_sharded_reference(out, shape, case):
    want = float(out["ref"][f"{case}/{shape[0]}x{shape[1]}/loss"])
    losses = {res["data"]: float(res["train/float32"]["loss"])
              for res in _ranks(out, shape, case)}
    assert sorted(losses) == list(range(shape[0]))
    np.testing.assert_allclose(np.mean(list(losses.values())), want,
                               rtol=1e-5, err_msg=case)


@pytest.mark.parametrize("dtype", TP_DTYPES)
@pytest.mark.parametrize("case", list(SEQ_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_training_step_matches_unsharded(out, shape, case, dtype):
    for r, res in enumerate(_ranks(out, shape, case)):
        got = res[f"train/{dtype}"]
        _close(got["loss"], got["want_loss"], dtype, f"loss rank {r}")
        assert set(got["grads"]) == set(got["want"])
        for name, g in got["grads"].items():
            want = got["want"][name]
            assert g.shape == want.shape, name
            if dtype == "float32":
                _close(g, want, dtype, f"{case} rank {r}: {name}")
        if dtype == "bfloat16":
            _hold_bf16(case, r, got["grads"], res["train/float32"]["want"],
                       CASE_NEAR_ZERO)


def _layers(rows) -> set:
    """{(rows a layer took, its SP flag, rows it gave)} of ``SeqRows``."""
    ins = {row[1:] for row in rows if row[0] == "layer"}
    outs = {row[1] for row in rows if row[0] == "layer-out"}
    return {(*i, o) for i in ins for o in outs}


@pytest.mark.parametrize("case", list(SEQ_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_residual_stream_holds_its_rows(out, shape, case):
    """Every layer of both training steps (forward, and remat's recompute
    where there is one) took and gave S/n rows under SP; the heads saw
    V/n columns."""
    cfg = _cfg(case)
    n = shape[1]
    for res in _ranks(out, shape, case):
        for dtype in TP_DTYPES:
            rows = res[f"train/{dtype}"]["shapes"]
            assert _layers(rows) == {(8 // n, True, 8 // n)}, rows
            assert len([r for r in rows if r[0] == "layer"]) == \
                cfg.num_layers
            assert {size for what, size, *_ in rows
                    if not what.startswith("layer")} == {cfg.vocab_size // n}


@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_moe_keeps_the_same_slots(out, shape):
    for res in _ranks(out, shape, "dbrx-132b-sp"):
        slots = res["slots"]
        assert slots["sp"] and slots["sp"] == slots["plain"]


@pytest.mark.parametrize("case", list(SEQ_EDGES))
def test_edge_cases_match_unsharded(out, case):
    """Logits, cache, loss and gradient shards against the unsharded port;
    the rows every layer took (S/n, or S where "model" does not divide
    it, remat's recompute included)."""
    arch, fields, shape, *more = SEQ_EDGES[case]
    seq = (more[0] if more else {}).get("seq", 8)
    n = shape[1]
    cfg = dataclasses.replace(_cfg(arch), **fields)
    for edge in _edge(out, case):
        sh, plain = edge["sharded"], edge["plain"]
        bl = plain["prefill"].shape[0] // shape[0]
        rows = slice(edge["data"] * bl, (edge["data"] + 1) * bl)
        for what in WHAT:
            np.testing.assert_allclose(sh[what].numpy(),
                                       plain[what][rows].numpy(),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=what)
        _close(sh["loss"], plain["loss"], "float32", "loss")
        assert set(sh["grads"]) == set(plain["grads"])
        for name, g in sh["grads"].items():
            _close(g, plain["grads"][name], "float32", f"{case}: {name}")
        on = seq % n == 0
        layer = (seq // n, True, seq // n) if on else (seq, False, seq)
        assert _layers(sh["shapes"]) == {layer}, sh["shapes"]
        calls = [r for r in sh["shapes"] if r[0] == "layer"]
        assert len(calls) == cfg.num_layers * (2 if cfg.remat != "none"
                                               else 1)


def test_dots_matches_full(out):
    """remat "dots" under SP: the same loss and gradients as "full"."""
    for full, dots in zip(_edge(out, "remat-full"), _edge(out, "remat-dots")):
        a, b = full["sharded"], dots["sharded"]
        _close(b["loss"], a["loss"], "float32", "loss")
        for name, g in b["grads"].items():
            _close(g, a["grads"][name], "float32", name)
