"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

* The ``--tiny --singlepod --mesh-shape 2,2,2 --seq 64 --batch 8`` cells
  of ``tests/test_dryrun_pipeline.py`` (qwen2-72b train_4k and decode_32k,
  dbrx-132b train_4k, hymba-1_5b long_500k) and llama4-maverick train_4k
  (a tiny train cell keeps its full configuration's optimizer: dbrx and
  llama4 train under FactoredAdam, llama4 with two layer stacks) run
  through the CLI in a subprocess, traced
  on fake tensors as rank 0 of a fake process group.  Their FLOPs,
  collective counts, collective bytes and argument bytes per device must
  equal rank 0's from a real run of the same steps (seeded weights and
  tokens) on 8 gloo ranks (``_torch_dist.py``).  The reference cannot run
  the dbrx and hymba cells under jax 0.9 (ROADMAP C0a), so this is how
  those two are held.
* No step of those cells reshards a shard of one dimension into a shard
  of another on one mesh dimension: DTensor does that by an all-to-all on
  a cuda mesh and by an all-gather on a cpu one, so a step without it
  reports the same collectives on both (``launch.dryrun``).
* With attention and the MLP tensor-parallel over "model", a rank's
  K2 / K2-bwd FLOPs and its products' (less the loss head and the MoE
  router, which every rank of "model" repeats) are the unsharded cell's
  at the rank's batch over the "model" size, exactly, per operator.
* ``model_flops`` equals the reference's for all ten archs × four shapes;
  the reference's side runs in a subprocess (``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` at import, so it is never imported here).
* One reference cell that runs: qwen2-72b decode_32k at its tiny config
  on a one-device mesh.  Its ``jax.make_mesh`` mesh has explicit axes,
  which every reference cell refuses under jax 0.9, so the reference's
  ``run_cell`` is given a ``jax.sharding.Mesh`` (auto axes) in a
  subprocess.  The port's FLOPs there are its matmuls' (``FlopCounterMode``
  counts products only); the reference's ``flops_per_device`` also counts
  each reduction's elements (softmax and norm sums).  A decode step's
  reductions are O(d + S·H) per token against the products' O(d²) and
  O(S·H·hd), so the port must be below the reference by at most 1 %
  (measured: 0.32 %).  The argument bytes differ by the reference's int32
  cache position (4 bytes); the port's is a Python int.
* Two train_4k cells at their tiny configs on the same one-device mesh,
  qwen2-72b (attention) and mamba2-2_7b (SSM), whose FLOPs include the
  backward and the kernels (``test_train_cell_against_the_reference``).
  The reference's subprocess splits its FLOPs, trip counts multiplied as
  its ``hlo_costs`` does, into dots inside its attention loop
  (``flash_attention`` in the op's name), other dots, and reductions
  (each reduction's input elements, which the port does not count).
  qwen2: the port's products outside K2 / K2-bwd equal the reference's
  dots outside the loop exactly (the same matmuls, the remat and the
  loss head's recomputation included).  The reference's loop runs every
  query against whole KV chunks of ``attn_kv_chunk`` keys (the keys
  padded to it, no causal skip), two products forward and four backward
  (dq, dk, dp, dv); K2 counts its kept (query, key) pairs, two products
  forward and seven backward (S and dP recomputed, ``band_pairs``).  So
  ``K2 · Sq · Skv_padded · 3(Dk + Dv) == loop · pairs · (5Dk + 4Dv)``,
  exactly.  mamba2: XLA folds some of the SSD scan's small products into
  fusions counted as reductions, so its dots cannot be split by kernel;
  the port's FLOPs must lie between the reference's dots less what the
  masked half of each chunk adds (the reference multiplies all Q² (q, t)
  pairs of a chunk, K3 and K3-bwd the Q(Q+1)/2 kept ones, at most
  Q²/(Q(Q+1)/2) - 1 of K3's count more) and its dots (measured: 0.72 %
  below them, the bound 5.2 %).
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist
import torch.distributed.tensor.placement_types as placement_types
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

import _torch_dist
from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.kernels.flash_attention import band_pairs
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_costs import CostMode
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import SHAPES

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 64, 8
CELLS = [("qwen2-72b", ["train_4k", "decode_32k"]),
         ("dbrx-132b", ["train_4k"]),
         ("hymba-1_5b", ["long_500k"]),
         ("llama4-maverick-400b-a17b", ["train_4k"])]
KEYS = [(arch, shape) for arch, shapes in CELLS for shape in shapes]
FACTORED = {"dbrx-132b", "llama4-maverick-400b-a17b"}
DOTS_ARCH = "dbrx-132b"     # the tiny train cell also taken under "dots"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's records of every cell, by (arch, shape)."""
    out = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for arch, shapes in CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--tiny",
               "--singlepod", "--mesh-shape", "2,2,2", "--arch", arch,
               "--shape", *shapes, "--seq", str(SEQ), "--batch", str(BATCH),
               "--device", "cpu", "--out", str(out)]
        r = subprocess.run(cmd, capture_output=True, text=True, env=ENV,
                           cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        for shape in shapes:
            recs[arch, shape] = json.loads(
                (out / f"{arch}__{shape}__single.json").read_text())
    return recs


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """Rank 0's counts of the same steps, for real on 8 gloo ranks."""
    out = tmp_path_factory.mktemp("dryrun-real")
    cells = [(arch, shape, SEQ, BATCH) for arch, shape in KEYS]
    cells.append((DOTS_ARCH, "train_4k", SEQ, BATCH, "dots"))
    _torch_dist.spawn(_torch_dist.dryrun_ranks, 8, out, str(out), cells,
                      timeout=400.0)
    return _torch_dist.load(out, "dryrun", 8)[0]


@pytest.mark.parametrize("arch,shape", KEYS)
def test_tiny_cell_equals_a_real_run(records, real, arch, shape):
    rec = records[arch, shape]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 8
    if shape == "train_4k":
        assert rec["optimizer"] == ("FactoredAdam" if arch in FACTORED
                                    else "AdamW")
    want = real[f"{arch}/{shape}"]
    assert rec["flops_per_device"] == want["flops"] > 0
    # per operator: the kernels' equal; the products only in their sum
    # (einsum takes bmm on fake tensors where it takes mm on real ones for
    # the decode scores against one KV head)
    ops = rec["flops_per_operator"]
    assert {k: v for k, v in ops.items() if k.startswith("repro_torch.")} \
        == {k: v for k, v in want["op_flops"].items()
            if k.startswith("repro_torch.")}
    assert sum(ops.values()) == rec["flops_per_device"]
    assert rec["collective_counts"] == want["collective_counts"]
    assert rec["collective_bytes_per_device"] == want["collective_bytes"]
    assert rec["memory"]["argument_bytes"] == want["argument_bytes"] > 0
    assert sum(rec["collective_counts"].values()) > 0
    assert rec["bytes_per_device"] == (rec["bytes_per_device_kernelized"]
                                       + rec["flash_loop_bytes_per_device"])
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["roofline_s_h100"] > 0 and "not measured" in rec[
        "roofline_peaks"]
    # K2 runs in every attention arch's train step, in no decode step
    attention = not get_tiny_config(arch).is_attention_free
    assert (rec["flash_loop_bytes_per_device"] > 0) == (
        attention and shape == "train_4k")


def test_dots_cell_equals_a_real_run(records, real):
    """The tiny dbrx-132b train_4k cell under remat "dots", traced as rank
    0 of a fake group of 8 on the (2, 2, 2) mesh (the selective
    checkpoint's cache mode over ``CostMode``; the experts' "model" shards
    and every other leaf gathered inside the checkpointed layers), equals
    rank 0 of a real 8-rank gloo run of it; K2 runs twice a layer, so it
    costs more FLOPs than the cell without remat."""
    cfg = dataclasses.replace(get_tiny_config(DOTS_ARCH), remat="dots")
    spec = dataclasses.replace(SHAPES["train_4k"], seq=SEQ, batch=BATCH)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        rec = dryrun.run_cell(DOTS_ARCH, "train_4k", mesh, False, tiny=True,
                              shape=spec, device="cpu", cfg=cfg)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok", rec
    assert rec["optimizer"] == "FactoredAdam"
    want = real[f"{DOTS_ARCH}/train_4k/dots"]
    assert rec["flops_per_device"] == want["flops"]
    assert rec["collective_counts"] == want["collective_counts"]
    assert rec["collective_bytes_per_device"] == want["collective_bytes"]
    assert rec["memory"]["argument_bytes"] == want["argument_bytes"] > 0
    none = records[DOTS_ARCH, "train_4k"]
    assert none["memory"]["argument_bytes"] == want["argument_bytes"]
    assert rec["flops_per_device"] > none["flops_per_device"]


def _op_flops(arch: str, mesh) -> dict:
    """FLOPs by operator of the tiny train_4k cell of rank 0 of ``mesh``
    (None: one device, the rank's batch of BATCH / 4 rows), fake tensors."""
    cfg = get_tiny_config(arch)
    batch = BATCH if mesh is not None else BATCH // 4
    shape = dataclasses.replace(SHAPES["train_4k"], seq=SEQ, batch=batch)
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = dryrun.build_cell(cfg, shape, mesh, device="cpu")
        with CostMode() as costs:
            cell.run()
    return costs.totals()["op_flops"]


@pytest.mark.parametrize("arch", ["qwen2-72b", "llama4-maverick-400b-a17b"])
def test_tensor_parallel_products_per_rank(arch):
    """The tiny train_4k cell on (2, 2, 2) against the same cell unsharded
    at the rank's batch (BATCH / 4 rows): per operator, K2's and K2-bwd's
    FLOPs are the unsharded ones / 2 ("model" = 2: each rank's heads), and
    so are the products' (attention's projections, the dense MLP's, the
    shared expert's, the expert-parallel experts' and the vocab-parallel
    loss head's) once the products every rank repeats are taken out of
    both: the MoE router (6·T·d·E a MoE layer: forward, dx, dW), exactly."""
    cfg = get_tiny_config(arch)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        tp = _op_flops(arch, mesh)
    finally:
        dist.destroy_process_group()
    whole = _op_flops(arch, None)
    assert set(tp) == set(whole)
    T, d = BATCH // 4 * SEQ, cfg.d_model
    moe_layers = (cfg.num_layers // cfg.moe_every if cfg.uses_moe else 0)
    replicated = 6 * T * d * cfg.num_experts * moe_layers
    kernels = [op for op in whole if op.startswith("repro_torch.")]
    assert kernels
    for op in kernels:
        assert 2 * tp[op] == whole[op] > 0, op
    products = [op for op in whole if not op.startswith("repro_torch.")]
    assert 2 * (sum(tp[op] for op in products) - replicated) == \
        sum(whole[op] for op in products) - replicated > 0
    assert sum(tp.values()) < sum(whole.values())


_REF_MODEL_FLOPS = """
import json, sys
from repro.configs import ARCH_IDS, get_config
from repro.launch.dryrun import SHAPES, model_flops
print(json.dumps({f"{a}/{s}": model_flops(get_config(a), SHAPES[s])
                  for a in ARCH_IDS for s in SHAPES}))
"""


def test_model_flops_match_the_reference():
    r = subprocess.run([sys.executable, "-c", _REF_MODEL_FLOPS],
                       capture_output=True, text=True, cwd=ROOT,
                       env={**ENV, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(want) == len(ARCH_IDS) * len(SHAPES)
    for a in ARCH_IDS:
        for s in SHAPES:
            assert dryrun.model_flops(get_config(a), SHAPES[s]) == want[
                f"{a}/{s}"], (a, s)


_REF_CELL = """
import dataclasses, json, os
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
from repro.launch import dryrun as rd
import jax, numpy as np
from jax.sharding import Mesh
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
            ("pod", "data", "model"))
shape = dataclasses.replace(rd.SHAPES["decode_32k"], seq=%d, batch=%d)
rec = rd.run_cell("qwen2-72b", "decode_32k", mesh, False, tiny=True,
                  shape=shape)
print(json.dumps(rec))
""" % (SEQ, BATCH)


def test_decode_cell_against_the_reference():
    r = subprocess.run([sys.executable, "-c", _REF_CELL],
                       capture_output=True, text=True, cwd=ROOT,
                       env={**ENV, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    assert ref["status"] == "ok"
    shape = dataclasses.replace(SHAPES["decode_32k"], seq=SEQ, batch=BATCH)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"),
                               device_type="cpu")
        rec = dryrun.run_cell("qwen2-72b", "decode_32k", mesh, False,
                              tiny=True, shape=shape, device="cpu")
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok"
    port, want = rec["flops_per_device"], ref["flops_per_device"]
    assert 0.99 * want <= port <= want, (port, want)
    assert rec["memory"]["argument_bytes"] == ref["memory"][
        "argument_bytes"] - 4
    assert rec["model_flops_global"] == ref["model_flops_global"]



@pytest.mark.parametrize("arch,shape", KEYS)
def test_no_shard_to_shard_reshard(monkeypatch, arch, shape):
    """The tiny cell's step, traced on the (2, 2, 2) cpu mesh, calls
    DTensor's shard-to-shard exchange (all-gather + slice on a cpu mesh,
    all-to-all on a cuda one) for no tensor."""
    calls = collections.Counter()
    exchange = placement_types.shard_dim_alltoall

    def spy(x, gather_dim, shard_dim, mesh, mesh_dim):
        calls[tuple(x.shape), gather_dim, shard_dim, mesh_dim] += 1
        return exchange(x, gather_dim, shard_dim, mesh, mesh_dim)

    monkeypatch.setattr(placement_types, "shard_dim_alltoall", spy)
    spec = dataclasses.replace(SHAPES[shape], seq=SEQ, batch=BATCH)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        rec = dryrun.run_cell(arch, shape, mesh, False, tiny=True,
                              shape=spec, device="cpu")
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok", rec
    assert not calls, dict(calls)


_REF_TRAIN = """
import dataclasses, json, os, re, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
import jax, numpy as np
from jax.sharding import Mesh
import repro.configs
from repro.distributed.context import use_mesh
from repro.launch import dryrun as rd, hlo_costs as hc
from repro.launch.specs import input_specs, param_specs
from repro.models import Model
from repro.training.step import default_optimizer, make_train_step
arch, seq, batch, remat = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
_tiny = repro.configs.get_tiny_config
# the cell's configuration at this remat, for run_cell's lookup too
repro.configs.get_tiny_config = lambda a: dataclasses.replace(_tiny(a),
                                                              remat=remat)
get_tiny_config = repro.configs.get_tiny_config
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
            ("pod", "data", "model"))
cfg = get_tiny_config(arch)
shape = dataclasses.replace(rd.SHAPES["train_4k"], seq=seq, batch=batch)
rec = rd.run_cell(arch, "train_4k", mesh, False, tiny=True, shape=shape)
with use_mesh(mesh):
    opt = default_optimizer(cfg)
    pspecs = param_specs(cfg)
    state = {"params": pspecs,
             "opt": jax.eval_shape(lambda p: opt.init(p), pspecs)}
    hlo = jax.jit(make_train_step(Model(cfg), opt)).lower(
        state, input_specs(cfg, shape)["batch"]).compile().as_text()
# each computation's trip multiplier, as hlo_costs.breakdown walks them
model = hc.HloCostModel(hlo)
called = {c.group(1) for lines in model.computations.values()
          for ln in lines for c in hc._CALL_RE.finditer(ln)}
called |= {c.group(1) for lines in model.computations.values()
           for ln in lines for c in [hc._COND_RE.search(ln)] if c}
mult = {}

def walk(comp, m):
    mult[comp] = mult.get(comp, 0) + m
    for ln in model.computations.get(comp, []):
        d = hc._DEF_RE.match(ln)
        if not d:
            continue
        rhs, trips = d.group(2), 1
        if " while(" in rhs:
            t = hc._TRIP_RE.search(rhs)
            trips = int(t.group(1)) if t else 1
        for c in hc._CALL_RE.finditer(rhs):
            walk(c.group(1), m * trips)
        c = hc._COND_RE.search(rhs)
        if c:
            walk(c.group(1), m * trips)

for root in model.computations:
    if root not in called:
        walk(root, 1)
split = {"loop_dots": 0.0, "other_dots": 0.0, "reductions": 0.0}
for comp, lines in model.computations.items():
    m, defs = mult.get(comp, 0), model._defs(lines)
    for ln in lines:
        d = hc._DEF_RE.match(ln)
        op = d and re.match(r"((?:\\([^)]*\\)|[a-z0-9\\[\\],{}\\s]*?))\\s*"
                            r"([a-z][a-z0-9\\-]*)\\(", d.group(2))
        if not op:
            continue
        rhs, kind = d.group(2), op.group(2)
        if kind == "dot":
            key = ("loop_dots" if "flash_attention" in rhs
                   else "other_dots")
            split[key] += m * model._dot_flops(rhs, defs, op.group(1))
        elif kind in ("reduce", "reduce-window"):
            names = model._operands(rhs, kind)
            split["reductions"] += m * sum(
                hc._numel_from_type(defs[o].split("(")[0])
                for o in names if o in defs) / max(len(names), 1)
print(json.dumps({"flops": rec["flops_per_device"], "chunk":
                  cfg.attn_kv_chunk, "ssm_chunk": cfg.ssm_chunk, **split}))
"""


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "mamba2-2_7b"])
def test_train_cell_against_the_reference(arch, remat):
    r = subprocess.run([sys.executable, "-c", _REF_TRAIN, arch, str(SEQ),
                        str(BATCH), remat], capture_output=True, text=True,
                       cwd=ROOT, env={**ENV, "JAX_PLATFORMS": "cpu"},
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    # the split covers the reference's whole count
    assert ref["loop_dots"] + ref["other_dots"] + ref["reductions"] == \
        pytest.approx(ref["flops"], rel=1e-12)
    cfg = dataclasses.replace(get_tiny_config(arch), remat=remat)
    shape = dataclasses.replace(SHAPES["train_4k"], seq=SEQ, batch=BATCH)
    fwd = 1 if remat == "none" else 2     # forward, then the recompute
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = dryrun.build_cell(cfg, shape, None, device="cpu")
        with CostMode() as costs:
            cell.run()
    kernels = sum(n for op, n in costs.rec.op_flops.items()
                  if op.startswith("repro_torch."))
    other = costs.rec.flops - kernels
    assert kernels > 0 and ref["reductions"] > 0
    if not cfg.is_attention_free:    # qwen2-72b: attention alone
        H, Dk = cfg.num_heads, cfg.head_dim
        per_pair = fwd * 2 * Dk + 4 * Dk + 3 * Dk
        assert kernels == BATCH * H * 2 * per_pair * sum(
            band_pairs(SEQ, SEQ, True, 0) for _ in range(cfg.num_layers))
        assert other == ref["other_dots"]
        padded = -(-SEQ // ref["chunk"]) * ref["chunk"]
        pairs = band_pairs(SEQ, SEQ, True, 0)
        assert (kernels * SEQ * padded * (fwd + 2) * (Dk + Dk)
                == ref["loop_dots"] * pairs * per_pair)
    else:
        assert ref["loop_dots"] == 0
        Q = ref["ssm_chunk"]
        extra = Q * Q / (Q * (Q + 1) // 2) - 1
        dots = ref["other_dots"]
        assert dots - extra * kernels <= costs.rec.flops <= dots, (
            costs.rec.flops, dots, kernels)
