"""The port's training path (``Model.loss`` / ``hidden_states``,
``training.step``, ``launch.train``) against the reference on the CPU, for
every architecture at its tiny config (float32), the MoE ones included.

Weights are the reference's ``Model.init(PRNGKey(0))`` loaded into the port
through ``params_from_reference``; batches come from ``SyntheticLM`` (the
same numpy arrays for both).  S = 40 crosses the tiny sliding window (32)
and five SSD chunks (8).  The loss is held at rtol 1e-5 and every
parameter's gradient at ||g_port - g_ref|| <= 1e-4 ||g_ref|| (float32; the
two stacks sum in different orders, as in ``tests/test_torch_models.py``,
whose logits are held at 1e-4).  On the CPU K2 and K3 run their plain
versions forward and backward.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as ref_tiny_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import Model as RefModel
from repro.training.optim import AdamW as RefAdamW
from repro.training.optim import cosine_schedule as ref_cosine
from repro.training.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import chunked_xent
from repro_torch.training.optim import AdamW, cosine_schedule
from repro_torch.training.step import (default_optimizer, init_state,
                                       make_eval_step, make_train_step)

B, S = 2, 40
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SRC = Path(__file__).resolve().parents[1] / "src"


def _pair(arch, **overrides):
    cfg = dataclasses.replace(ref_tiny_config(arch), **overrides)
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = params_from_reference(
        dataclasses.replace(get_tiny_config(arch), **overrides), tree,
        device="cpu")
    return cfg, ref, params, port


def _batch(cfg, step=0, seed=1):
    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed,
        embed_dim=cfg.d_model if cfg.frontend != "none" else 0)).batch(step)


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat_grads(tree, prefix="", groups=1):
    """The reference's grad tree as {port parameter name: array}; with
    ``groups`` g > 1 (llama4), row j of ``layers.s{i}.*`` is the port's
    layer j * g + i."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_grads(v, f"{prefix}{k}.", groups))
        elif prefix.startswith("layers."):
            rest, sub = prefix[len("layers."):], 0
            if groups > 1:
                head, _, rest = rest.partition(".")
                sub = int(head[1:])
            for j in range(v.shape[0]):
                out[f"layers.{j * groups + sub}.{rest}{k}"] = v[j]
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_grads(port, batch):
    port.requires_grad_(True)
    loss = port.loss(_port_batch(batch))
    loss.backward()
    return loss, {n: p.grad for n, p in port.named_parameters()}


def _grad_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    errs = {}
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = (np.zeros_like(w) if got[name] is None
             else got[name].double().numpy())
        errs[name] = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    return errs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    cfg, ref, params, port = _pair(arch)
    batch = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, got = _port_grads(port, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    want = _flat_grads(jax.tree_util.tree_map(np.asarray, want),
                       groups=cfg.moe_every if cfg.uses_moe else 1)
    if cfg.experts_per_token == 1:
        # top-1 routing renormalises the one weight to p / p = 1, so the
        # router's exact gradient is zero and both sides hold rounding
        # noise: each must be below 1e-6 of the whole gradient's norm
        total = np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))
        for name in [n for n in want if n.endswith(".moe.router")]:
            assert np.linalg.norm(want.pop(name)) <= 1e-6 * total, name
            assert float(got.pop(name).norm()) <= 1e-6 * total, name
    errs = _grad_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


def test_ignored_labels_and_a_ragged_last_chunk():
    """Labels < 0 drop out of the mean, and a loss chunk that does not
    divide B*S leaves a short last chunk: both as the reference's padding
    does it."""
    cfg, ref, params, port = _pair("stablelm-12b", loss_chunk=24)
    batch = _batch(cfg)
    batch["labels"][0, :7] = -1
    batch["labels"][1, 30:] = -1
    want = ref.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port.loss(_port_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [7, 64])
def test_chunked_xent_equals_one_cross_entropy(chunk, dtype):
    """The chunked head equals one ``F.cross_entropy`` over all (T, V) f32
    logits, labels -1 ignored, in value and in the gradients of the hidden
    states and the head (the head widened to f32 once, its gradient summed
    over the chunks in f32 and rounded once).  float32: rtol 1e-5; bf16:
    one bf16 ulp (2**-7 relative) plus 1e-5 of the largest magnitude."""
    T, d, V = 50, 24, 40
    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((T, d)), dtype=dtype)
    w = torch.tensor(rng.standard_normal((d, V)) * 0.3, dtype=dtype)
    labels = torch.tensor(rng.integers(0, V, T))
    labels[[0, 9, 33]] = -1
    hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
    got = chunked_xent(hg, labels, wg, chunk)
    got.backward()
    hf, wf = h.float().requires_grad_(), w.float().requires_grad_()
    want = torch.nn.functional.cross_entropy(hf @ wf, labels,
                                             ignore_index=-1)
    want.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for g, x in ((hg.grad, hf.grad), (wg.grad, wf.grad)):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), x.numpy(), rtol=rtol,
                                   atol=1e-5 * float(x.abs().max()))


@pytest.mark.parametrize("arch", ["hymba-1_5b", "minicpm3-4b"])
def test_full_remat_gives_the_same_gradients(arch):
    """``remat="full"`` recomputes each layer (and each loss chunk) in the
    backward; on the CPU the recomputation is the same arithmetic, so the
    gradients are equal bit for bit."""
    _, _, _, port_none = _pair(arch)
    _, _, _, port_full = _pair(arch, remat="full")
    batch = _batch(port_none.cfg)
    loss_a, a = _port_grads(port_none, batch)
    loss_b, b = _port_grads(port_full, batch)
    assert torch.equal(loss_a, loss_b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("arch", ["hymba-1_5b", "internvl2-26b"])
def test_three_train_steps_track_the_reference(arch):
    """Three AdamW steps from the same weights on the same batches: the
    losses, grad norms and lrs of ``make_train_step`` follow the
    reference's.  Step 0 (same weights) is held at rtol 1e-5; steps 1 and 2
    at rtol 1e-3, because Adam's first update divides each gradient entry
    by its own magnitude, so an entry near zero whose float32 rounding
    differs moves by a different fraction of the lr.  At lr 1e-3 both stay
    finite; at lr 1e-2 the reference's tiny hymba turns NaN at step 1
    (ROADMAP C3) while the port's does not."""
    cfg, ref, params, port = _pair(arch)
    ref_opt = RefAdamW(learning_rate=ref_cosine(1e-3, 1, 3))
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 1, 3))
    ref_step = jax.jit(ref_make_train_step(ref, ref_opt))
    rstate = {"params": params, "opt": ref_opt.init(params)}
    state = init_state(port, opt)
    step = make_train_step(port, opt)
    data = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=4,
                embed_dim=cfg.d_model if cfg.frontend != "none" else 0)
    ref_data, data = (RefSyntheticLM(RefDataConfig(**data)),
                      SyntheticLM(DataConfig(**data)))
    for i in range(3):
        rstate, rm = ref_step(rstate, {k: jnp.asarray(v) for k, v in
                                       ref_data.batch(i).items()})
        state, m = step(state, _port_batch(data.batch(i)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=1e-5 if i == 0 else 1e-3,
                                       err_msg=f"step {i} {key}")
    assert all(p.grad is None for p in port.parameters())
    assert state["params"]["embed"] is port.embed
    evaluated = make_eval_step(port)(_port_batch(data.batch(5)))
    assert evaluated.grad_fn is None


def test_default_optimizer_follows_the_reference():
    assert isinstance(default_optimizer(get_config("hymba-1_5b")), AdamW)
    assert default_optimizer(get_config("hymba-1_5b")).state_dtype == \
        torch.bfloat16
    assert type(default_optimizer(get_config(
        "llama4-maverick-400b-a17b"))).__name__ == "FactoredAdam"


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_cli_runs_on_the_cpu(tmp_path):
    out = _cli("--tiny", "--device", "cpu", "--steps", "3", "--arch",
               "hymba-1_5b", "--log-every", "1", "--batch", "2", "--seq",
               "24")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=hymba-1_5b-tiny params=")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)


def test_train_cli_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _cli("--tiny", "--device", "cpu", "--steps", "2", "--arch",
                 "stablelm-12b", "--batch", "2", "--seq", "16",
                 "--ckpt-dir", ckpt, "--ckpt-every", "1")
    assert first.returncode == 0, first.stderr
    again = _cli("--tiny", "--device", "cpu", "--steps", "3", "--arch",
                 "stablelm-12b", "--batch", "2", "--seq", "16",
                 "--ckpt-dir", ckpt, "--resume", "--log-every", "1")
    assert again.returncode == 0, again.stderr
    assert "resumed from step 2" in again.stdout
    assert [ln.split()[1] for ln in again.stdout.splitlines()
            if ln.startswith("step ")] == ["3"]


def test_train_cli_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _cli("--tiny", "--steps", "1")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
