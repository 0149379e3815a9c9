"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package ``repro``, not even its modules that do not import JAX."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


@pytest.mark.parametrize("module", [
    "repro_torch", "repro_torch.core", "repro_torch.kernels",
    "repro_torch.models", "repro_torch.configs", "repro_torch.serving",
    "repro_torch.serving.engine", "repro_torch.launch.serve",
    "repro_torch.training", "repro_torch.data", "repro_torch.checkpoint",
    "repro_torch.distributed", "repro_torch.launch.train",
    "repro_torch.core.graph", "repro_torch.distributed.hetero",
    "repro_torch.models.moe", "repro_torch.distributed.context",
    "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
    "repro_torch.launch.mesh", "repro_torch.launch.specs",
    "repro_torch.launch.dryrun", "repro_torch.launch.hlo_costs",
    "repro_torch.tracing"])
def test_import_pulls_in_no_jax_and_no_reference(module):
    code = (f"import json, sys; import {module}; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert module in loaded
    bad = [m for m in loaded if m == "jax" or m.startswith("jax.")
           or m.startswith("jaxlib") or m == "repro" or m.startswith("repro.")]
    assert bad == []


def test_no_source_file_names_jax_or_the_reference():
    pattern = re.compile(r"import jax|from repro\.|from repro ")
    files = sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu"))
    assert files
    offenders = [f"{p.relative_to(SRC)}:{i}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert offenders == []


@pytest.mark.parametrize("module,names", [
    ("context", ["current_mesh", "use_mesh", "batch_axes", "fsdp_axis",
                 "model_axis_size", "data_shards", "constrain",
                 "constrain_batch", "constrain_tokens"]),
    ("sharding", ["batch_spec", "_param_spec", "param_shardings",
                  "cache_shardings", "batch_shardings", "replicated"]),
    ("collectives", ["quantize_int8", "dequantize_int8",
                     "compressed_psum_mean", "tree_compressed_psum_mean"])])
def test_distributed_modules_export_the_reference_names(module, names):
    import importlib
    mod = importlib.import_module(f"repro_torch.distributed.{module}")
    assert [n for n in names if not hasattr(mod, n)] == []
    if module == "context":
        import repro_torch.distributed as pkg
        assert [n for n in names if n not in pkg.__all__] == []


def test_launch_modules_export_the_reference_names():
    from repro_torch.launch import dryrun, hlo_costs, mesh, specs
    for name in ("make_production_mesh", "make_debug_mesh"):
        assert hasattr(mesh, name)
    for name in ("ShapeSpec", "SHAPES", "shape_applicable", "input_specs",
                 "param_specs"):
        assert hasattr(specs, name)
    for name in ("model_flops", "run_cell", "main"):
        assert hasattr(dryrun, name)
    for name in ("analyze", "breakdown", "COLLECTIVES"):
        assert hasattr(hlo_costs, name)
