"""Tests of the benchmark itself, on the CPU at tiny sizes:

    python -m pytest perfbench/tests

Tests marked ``card`` need a CUDA device and skip without one; whether
there is one is decided inside the ``card`` fixture, never at import.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

# tiny sizes of the configurations' widths, for runs on the CPU
TINY = {
    "minicpm3-4b": dict(num_layers=2, d_model=64, num_heads=4,
                        num_kv_heads=4, d_ff=128, vocab_size=256,
                        head_dim=24, q_lora_rank=32, kv_lora_rank=16,
                        qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, loss_chunk=64),
    "mamba2-2_7b": dict(num_layers=2, d_model=64, vocab_size=256,
                        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                        loss_chunk=64),
}
# limits of the tiny cells, well above the tiny sound runs' readings (a
# logit gap of ~3e-5; gaps of loss ~1e-5, gradient ~4e-3, change ~7e-3)
TINY_LIMITS = {"logit_gap": 0.05, "loss_gap": 1e-3, "grad_gap": 0.05,
               "change_gap": 0.05, "m_gap": 0.05, "v_gap": 0.05}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "False")


def make_tiny(dst: Path, dtype: str = "bfloat16") -> Path:
    """A copy of the benchmark under ``dst`` whose configurations keep
    their kinds of blocks at tiny widths, whose mixes are short, and whose
    cells' limits are ``TINY_LIMITS``; ``dst/src`` links to the port."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    (dst / "src").symlink_to(ROOT / "src")
    for name, sizes in TINY.items():
        p = dst / "perfbench" / "configs" / f"{name}.json"
        doc = json.loads(p.read_text())
        doc["model"].update(sizes, dtype=dtype)
        p.write_text(json.dumps(doc))
    traffic = dst / "perfbench" / "traffic"
    for p in traffic.glob("*.json"):
        mix = json.loads(p.read_text())
        if mix["kind"] == "closed_loop":
            mix.update(prompt_len=[20, 40], new_tokens=4)
        else:
            mix.update(seq_len=32, batch=2)
        p.write_text(json.dumps(mix))
    for p in (dst / "perfbench" / "limits").glob("*.json"):
        lim = json.loads(p.read_text())
        if "requests" in lim["check"]:
            lim["check"]["requests"] = 3
        for k in lim["numbers"]:
            lim["numbers"][k]["limit"] = TINY_LIMITS[k]
        p.write_text(json.dumps(lim))
    return dst


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_tiny(tmp_path / "bench")


def run_cell(root: Path, workload: str, seed: int = 2**31 + 11,
             seconds: float = 0.5, trace: int = 0, capsys=None) -> dict:
    """One run of ``workload`` from the benchmark at ``root`` on the CPU
    (the look for a card skipped); returns the parsed last line."""
    import time
    from perfbench.harness import cli

    args = cli.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    assert cli.run(args, root, time.perf_counter(), device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
