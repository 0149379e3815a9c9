"""The vocab-parallel embedding, head and loss (``repro_torch.models.
transformer.Model`` under a mesh whose "model" axis divides the vocab)
against the reference's model under the same mesh and against the
unsharded port, on the CPU.

The reference runs in a subprocess on 4 forced host devices
(``_jax_mesh_ref.py tp_vocab``), its parameters placed by its own
``param_shardings`` (``embed`` ("model", fsdp), ``lm_head`` (fsdp,
"model")); the port runs one process per rank on gloo
(``_torch_dist.case_ranks``), each on its batch shard.  Meshes (1, 2), (2,
2) and (1, 4) over ("data", "model"); the cases of ``_mesh_cases.
VOCAB_CASES``: tiny qwen2-72b (an untied head), musicgen-medium (a stub
frontend: embeddings in, the head split) and qwen2-72b with
``tie_embeddings`` (the head is the embedding's local rows, transposed).
Their vocab of 256 divides "model" on every mesh.

* Each rank's prefill and decode logits (whole: the ranks' columns
  gathered) against the reference's rows at ``test_torch_tp.py``'s 1e-4.
* The float32 loss: the mean of the data ranks' losses against the
  reference's loss of the whole batch under the mesh, rtol 1e-5.
* A training step's loss and gradient shards against the unsharded port,
  float32 at rtol 1e-5 / atol 1e-6, bf16 by ``test_torch_tp.py``'s
  per-leaf rule against the float32 gradient.
* The embedding, the serving head and the loss head computed on V/n rows
  or columns at every call, never V.
* A vocab that does not divide "model" (255 on 2 ranks, 254 on 4: a field
  changed, as ``test_torch_tp_mixers.py``'s edge cases) stays whole, as the
  reference's ``_maybe`` leaves it: logits, cache, loss and gradient
  shards against the unsharded port.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dist
from _mesh_cases import (DECODE_STEPS, TP_DTYPES, TP_MESHES, VOCAB_CASES,
                         case_config)
from repro_torch.configs import get_tiny_config
from test_torch_tp import MODEL_TOL, NEAR_ZERO, _close, _hold_bf16

ROOT = Path(__file__).resolve().parents[1]
MESH_IDS = [f"{a}x{b}" for a, b in TP_MESHES]
WHAT = ["prefill"] + [f"decode/{t}" for t in range(DECODE_STEPS)]
# the bf16 leaves that may fall below test_torch_tp's floor, by case
CASE_NEAR_ZERO = {case: NEAR_ZERO.get(arch, set())
                  for case, (arch, _) in VOCAB_CASES.items()}
# (tiny configuration, changed fields, mesh): a vocab "model" does not divide
VOCAB_EDGES = {
    "vocab-255-on-2": ("qwen2-72b", {"vocab_size": 255}, (1, 2)),
    "vocab-254-on-4": ("qwen2-72b", {"vocab_size": 254}, (1, 4)),
}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The reference's results and the port's ranks' results, once."""
    tmp = tmp_path_factory.mktemp("vocab")
    ref = tmp / "vocab.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_jax_mesh_ref.py"), "tp_vocab",
                        str(ref)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    for world in (2, 4):
        _torch_dist.spawn(_torch_dist.case_ranks, world, tmp, str(ref),
                          str(tmp), "vocab", list(VOCAB_CASES), True,
                          VOCAB_EDGES, timeout=300.0)
    ranks = {w: _torch_dist.load(tmp, f"vocab{w}", w) for w in (2, 4)}
    return {"ref": dict(np.load(ref)), "ranks": ranks}


def _ranks(out, shape, case):
    return [res[f"{case}/{shape[0]}x{shape[1]}"]
            for res in out["ranks"][shape[0] * shape[1]]]


def _cfg(case):
    arch, fields = case_config(case)
    return dataclasses.replace(get_tiny_config(arch), **fields)


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("case", list(VOCAB_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_logits_match_the_sharded_reference(out, shape, case, what):
    want = out["ref"][f"{case}/{shape[0]}x{shape[1]}/{what}"]
    bl = want.shape[0] // shape[0]
    for res in _ranks(out, shape, case):
        i = res["data"]
        assert res[what].shape[-1] == _cfg(case).vocab_size
        np.testing.assert_allclose(res[what].float().numpy(),
                                   want[i * bl:(i + 1) * bl], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"{case} {what}")


@pytest.mark.parametrize("case", list(VOCAB_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_loss_matches_the_sharded_reference(out, shape, case):
    """The data ranks' float32 losses (each the mean over its rows, every
    label kept) averaged: the reference's mean over the whole batch."""
    want = float(out["ref"][f"{case}/{shape[0]}x{shape[1]}/loss"])
    ranks = _ranks(out, shape, case)
    losses = {res["data"]: float(res["train/float32"]["loss"])
              for res in ranks}
    assert sorted(losses) == list(range(shape[0]))
    np.testing.assert_allclose(np.mean(list(losses.values())), want,
                               rtol=1e-5, err_msg=case)


@pytest.mark.parametrize("dtype", TP_DTYPES)
@pytest.mark.parametrize("case", list(VOCAB_CASES))
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


@pytest.mark.parametrize("case", list(VOCAB_CASES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=MESH_IDS)
def test_vocab_is_split(out, shape, case):
    """At every call of prefill, decode and both training steps the
    embedding (token ids only), the serving head and the loss head saw
    V/n rows or columns; the gradient shards of ``embed`` and ``lm_head``
    hold V/n of them too."""
    cfg = _cfg(case)
    V, n = cfg.vocab_size, shape[1]
    for res in _ranks(out, shape, case):
        rows = [row for row in res["shapes"] + [
            r for dtype in TP_DTYPES for r in res[f"train/{dtype}"]["shapes"]]
            if not row[0].startswith("layer")]
        kinds = {what for what, _ in rows}
        assert kinds == ({"head", "loss"} if cfg.frontend != "none"
                         else {"embed", "head", "loss"}), kinds
        assert {size for _, size in rows} == {V // n}, rows
        grads = res["train/float32"]["grads"]
        # a stub frontend's embedding takes no part: no gradient
        assert ("embed" in grads) == (cfg.frontend == "none"
                                      or cfg.tie_embeddings)
        if "embed" in grads:
            assert grads["embed"].shape[0] == V // n
        if not cfg.tie_embeddings:
            assert grads["lm_head"].shape[1] == V // n
        else:
            assert "lm_head" not in grads


@pytest.mark.parametrize("case", list(VOCAB_EDGES))
def test_vocab_that_does_not_divide_stays_whole(out, case):
    arch, fields, shape = VOCAB_EDGES[case]
    world = int(np.prod(shape))
    V = fields["vocab_size"]
    for res in out["ranks"][world]:
        edge = res["edge"][case]
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
            _close(g, plain["grads"][name], "float32", name)
        vocab = [size for what, size, *_ in sh["shapes"]
                 if not what.startswith("layer")]
        assert vocab and set(vocab) == {V}, vocab
