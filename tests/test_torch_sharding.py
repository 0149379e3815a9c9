"""The port's sharded layer (``repro_torch.distributed.sharding``,
``launch.mesh``, ``launch.specs``, ``FaultTolerantRunner.remesh``) against
the reference, on the CPU.

The rules need no devices: the reference's run on a
``jax.sharding.AbstractMesh`` in this process, the port's on a
``DeviceMesh`` of a fake process group (``torch.testing``'s ``FakeStore``),
for all ten configurations at full size (meta tensors, nothing allocated)
on the (2, 2, 2) ("pod", "data", "model") debug mesh and the 16×16 and
2×16×16 production meshes.  A spec is compared entry by entry, each entry
as the tuple of axis names it shards over, and a layer leaf's reference
spec without its leading (num_layers) entry.

Placement and re-meshing run on 4 gloo ranks (``_torch_dist.py``); the
reference's device index map comes from a subprocess on 4 forced host
devices (``_jax_mesh_ref.py``).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

import _torch_dist
from repro.configs import ARCH_IDS, get_config as ref_config
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.training import optim as ref_optim
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.distributed import sharding
from repro_torch.distributed.context import (batch_axes, data_shards,
                                             fsdp_axis, model_axis_size,
                                             use_mesh)
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.convert import layer_groups, reference_leaf
from repro_torch.models.transformer import _sub_cfgs
from repro_torch.training import optim

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(ARCH_IDS)
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec, ndim: int) -> tuple:
    """A spec as one tuple of axis names per dim."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(() if e is None else tuple(e) if isinstance(e, tuple)
                 else (e,) for e in entries)


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(the port's DeviceMesh on a fake group, the reference's
    AbstractMesh) of one shape."""
    shape, axes = MESHES[request.param]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield (make_debug_mesh(shape, axes, device_type="cpu"),
               AbstractMesh(shape, axes))
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_specs.param_specs(ref_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return specs.param_specs(get_config(arch))


def _ref_path(cfg, keys) -> tuple:
    """The reference's tree path of a port leaf under nested ``keys``
    (``models/convert.py``'s ``reference_leaf``: layer j of groups of g is
    row j // g of sub-layer s{j % g}); a FactoredAdam moment kept for a
    whole stack is keyed by that stacked name already."""
    g = len(_sub_cfgs(cfg))
    return tuple(part for key in keys
                 for part in reference_leaf(str(key), g)[0].split("."))


def _per_layer(keys) -> bool:
    return any(part.isdigit() for key in keys for part in str(key).split("."))


def _ref_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _compare(cfg, port_tree, ref_tree, port_mesh, ref_mesh):
    """Every port leaf's spec against the reference's (a layer leaf's
    without its leading entry); returns the number of leaves compared."""
    got = sharding._flat(sharding.param_shardings(port_tree, port_mesh))
    want = ref_sharding.param_shardings(ref_tree, ref_mesh)
    n = 0
    for keys, sh in got:
        path = _ref_path(cfg, keys)
        ref_sh = _ref_leaf(want, path)
        ref_shape = _ref_leaf(ref_tree, path).shape
        w = _norm(ref_sh.spec, len(ref_shape))
        leaf = _ref_leaf(port_tree, keys)
        if _per_layer(keys):
            w = w[1:]
        else:   # a FactoredAdam moment of a whole stack: the same shape
            assert tuple(leaf.shape) == tuple(ref_shape), path
        assert _norm(sh.spec, leaf.dim()) == w, (path, sh.spec, ref_sh.spec)
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(meshes, arch):
    port_mesh, ref_mesh = meshes
    cfg = get_config(arch)
    port, ref = _port_params(arch), _ref_params(arch)
    assert _compare(cfg, port, ref, port_mesh, ref_mesh) == len(port)


@pytest.mark.parametrize("opt", ["AdamW", "FactoredAdam"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_specs_match_reference(meshes, arch, opt):
    port_mesh, ref_mesh = meshes
    cfg = get_config(arch)
    kw = {"layer_groups": layer_groups(cfg)} if opt == "FactoredAdam" else {}
    port_state = getattr(optim, opt)(**kw).init(_port_params(arch))
    ref_state = jax.eval_shape(getattr(ref_optim, opt)().init,
                               _ref_params(arch))
    assert all(t.is_meta for _, t in sharding._flat(port_state))
    assert _compare(cfg, port_state, ref_state, port_mesh, ref_mesh) > 0
    # every moment of the reference has its counterpart, and only those
    ref_paths = {tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(ref_state)[0]}
    assert {_ref_path(cfg, keys) for keys, _ in
            sharding._flat(port_state)} == ref_paths


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(meshes, arch, seq_shard):
    port_mesh, ref_mesh = meshes
    shape = specs.SHAPES["decode_32k"]
    port = specs.input_specs(get_config(arch), shape)
    ref = ref_specs.input_specs(ref_config(arch), ref_specs.SHAPES[
        "decode_32k"])
    got = sharding.cache_shardings(port["cache"], port_mesh,
                                   seq_shard=seq_shard)
    want = ref_sharding.cache_shardings(ref["cache"], ref_mesh,
                                        seq_shard=seq_shard)
    assert sorted(got) == sorted(want)
    for key, sh in got.items():
        ndim = len(getattr(ref["cache"][key], "shape", ()))
        assert _norm(sh.spec, ndim) == _norm(want[key].spec, ndim), key
    got = sharding.batch_shardings(port["batch"], port_mesh)
    want = ref_sharding.batch_shardings(ref["batch"], ref_mesh)
    assert sorted(got) == sorted(want)
    for key, leaf in port["batch"].items():
        assert _norm(got[key].spec, leaf.dim()) == _norm(want[key].spec,
                                                         leaf.dim()), key
    assert sharding.replicated(port_mesh).spec == ()
    assert tuple(ref_sharding.replicated(ref_mesh).spec) == ()
    for b in (1, 2, 3, 4, 6, 32, 48, 128, 256):
        assert _norm(sharding.batch_spec(port_mesh, (b, 7)), 2) == _norm(
            ref_sharding.batch_spec(ref_mesh, (b, 7)), 2), b


def test_context_queries(meshes):
    port_mesh, ref_mesh = meshes
    with use_mesh(port_mesh):
        assert batch_axes() == tuple(a for a in ("pod", "data")
                                     if a in ref_mesh.axis_names)
        assert fsdp_axis() == "data"
        assert model_axis_size() == ref_mesh.shape["model"]
        assert data_shards() == int(np.prod(
            [ref_mesh.shape[a] for a in batch_axes()]))
    assert batch_axes() == () and model_axis_size() == 1


def test_reference_sharding_asserts_mirrored():
    """``tests/test_distributed.py::test_sharding_rules_subprocess``'s
    asserts, on the port's rules."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                               device_type="cpu")
        sh = sharding.param_shardings(
            specs.param_specs(get_tiny_config("stablelm-12b")), mesh)
        assert sh["embed"].spec == ("model", "data")
        assert sh["layers.0.attn.wq"].spec == ("data", "model", None)
        # tiny cfg: kv=2 divides the size-2 model axis, so KH itself shards
        assert sh["layers.0.attn.wk"].spec == ("data", "model", None)
        assert sh["layers.0.mlp.wi"].spec == ("data", "model")
        assert all(a is None for a in sh["layers.0.ln1.scale"].spec)
        sh2 = sharding.param_shardings(
            specs.param_specs(get_tiny_config("dbrx-132b")), mesh)
        assert sh2["layers.1.moe.w_in"].spec == ("model", "data", None)
        assert sharding.placements(mesh, (("pod", "data"), "model")) == (
            sharding.Shard(0), sharding.Shard(0), sharding.Shard(1))
        with pytest.raises(ValueError):
            sharding.placements(mesh, (("data", "pod"), None))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(RuntimeError, match="needs"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_model_builds_every_full_config(arch):
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    params = list(model.parameters())
    assert params and all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            _ref_params(arch)))


# ---------------------------------------------------------------------------
# On 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    ref = tmp / "shards.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable,
                             str(ROOT / "tests" / "_jax_mesh_ref.py"),
                             "shards", str(ref)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _torch_dist.spawn(_torch_dist.remesh_ranks, 4, tmp, str(tmp))
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    _torch_dist.spawn(_torch_dist.shard_ranks, 4, tmp, str(ref), str(tmp))
    return {"ref": dict(np.load(ref)),
            "shards": _torch_dist.load(tmp, "shards", 4),
            "remesh": _torch_dist.load(tmp, "remesh", 4)}


def test_local_shards_match_reference_index_map(ranks):
    """Each rank's local shard of every tiny-dbrx leaf is the slice that
    the reference's ``devices_indices_map`` gives the device at the same
    mesh coordinate (port layer i is row i of the stacked leaf)."""
    ref = ranks["ref"]
    cfg = get_tiny_config("dbrx-132b")
    seen = set()
    for res in ranks["shards"]:
        i, j = res["coord"]
        seen.add((i, j))
        for name, local in res["local"].items():
            path = "/".join(_ref_path(cfg, (name,)))
            full = ref[f"params/{path}"]
            box = ref[f"box/{path}"][i, j]
            if name.startswith("layers."):
                assert tuple(box[0]) == (0, full.shape[0])
                full = full[int(name.split(".")[1])]
                box = box[1:]
            want = full[tuple(slice(a, b) for a, b in box)]
            np.testing.assert_array_equal(local.float().numpy(), want,
                                          err_msg=f"{name} at {(i, j)}")
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_remesh_onto_new_shardings(ranks):
    """A run saved on (2, 2) and re-meshed onto (1, 4)'s shardings: every
    leaf's full value bit-equal, each placed by the (1, 4) rules, and the
    next loss equal to that of a run on (1, 4) from the start."""
    for res in ranks["remesh"]:
        assert res["step"] == 2
        assert res["before"].keys() == res["after"].keys()
        for name in res["before"]:
            assert torch.equal(res["before"][name], res["after"][name]), name
        for name, (shape, _) in res["placements"].items():
            assert shape == (1, 4), name
        a, b = res["losses/a"], res["losses/b"]
        assert sorted(a) == sorted(b) == [1, 2, 3]
        assert torch.equal(a[3], b[3]), (a[3], b[3])
        for step in (1, 2):    # same weights, other meshes: rounding only
            torch.testing.assert_close(a[step], b[step], rtol=1e-5,
                                       atol=1e-6)
    placements = ranks["remesh"][0]["placements"]
    assert placements["embed"][1] == (sharding.Replicate(),
                                      sharding.Shard(0))


def test_remat_recompute_keeps_the_mesh():
    """``remat="full"`` recomputes each layer in the backward, which the
    autograd engine runs on a thread of its own for CUDA tensors, where
    the mesh installed by ``use_mesh`` (a context variable) is not set.
    The recompute must still see the mesh: tiny dbrx with ``remat="full"``
    on a (1, 2) mesh (the MoE expert-parallel, 8 of 16 experts a rank),
    fake tensors, its loss's backward taken on another thread."""
    import dataclasses
    import threading
    from torch._subclasses.fake_tensor import FakeTensorMode
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_debug_mesh((1, 2), ("data", "model"), device_type="cpu")
        cfg = dataclasses.replace(get_tiny_config("dbrx-132b"), remat="full")
        errors = []
        mode = FakeTensorMode()
        with mode:
            net = Model(cfg, device="meta")
            for mod in net.modules():
                for name, p in mod._parameters.items():
                    mod._parameters[name] = torch.nn.Parameter(
                        torch.empty_like(p, device="cpu"))
            sharding.shard_params(net, mesh)
            tokens = torch.zeros((2, 16), dtype=torch.long)
            with use_mesh(mesh):
                loss = net.loss({"tokens": tokens, "labels": tokens})

            def backward():       # dispatch modes go with the engine's
                try:              # threads; context variables do not
                    with mode:
                        loss.backward()
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)

            t = threading.Thread(target=backward)
            t.start()
            t.join(120)
        assert not t.is_alive()
        assert errors == []
    finally:
        dist.destroy_process_group()
