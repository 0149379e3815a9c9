"""The port's training substrate (``repro_torch.training.optim``,
``checkpoint.store``, ``data.pipeline``, ``distributed.elastic``) on the
CPU: every case of ``tests/test_training_substrate.py`` run against the
port, plus the port held against the reference.

Held against the reference: ``SyntheticLM`` batches are equal, array for
array, for several (seed, step, host); ``AdamW`` and ``FactoredAdam`` given
the same numpy params and grads give the same params, moments and metrics
within 1e-6 (both compute in float32 in the same order; only the last bits
of a sum may differ).  Plus a bfloat16 checkpoint round trip (stored as the
16-bit pattern), in-place restore into a model, and ``remesh``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.training.optim import AdamW as RefAdamW
from repro.training.optim import FactoredAdam as RefFactoredAdam
from repro.training.optim import cosine_schedule as ref_cosine
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.elastic import (FaultTolerantRunner,
                                             RunnerConfig, StepFailure)
from repro_torch.training.optim import (AdamW, FactoredAdam, cosine_schedule,
                                        global_norm)

TOL = 1e-6


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


# ----------------------------------------------------------------- optim --

def _quadratic_params():
    return {"w": _t([3.0, -2.0, 1.0]), "b": _t(0.5)}


def test_adamw_minimizes_quadratic():
    params = _quadratic_params()
    opt = AdamW(learning_rate=0.05, weight_decay=0.0, clip_norm=1e9)
    state = opt.init(params)

    def loss_fn(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(200):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves),
                                                     list(leaves.values()))))
        params, state, metrics = opt.update(grads, state, params)
    assert float(loss_fn(params)) < 1e-3
    assert int(state["step"]) == 200


def test_factored_adam_minimizes_matrix_quadratic():
    params = {"w": torch.ones((8, 16)) * 2.0}
    opt = FactoredAdam(learning_rate=0.1, layer_groups=1)
    state = opt.init(params)
    # factored state is O(n+m), not O(nm)
    assert state["v"]["w"]["vr"].shape == (8,)
    assert state["v"]["w"]["vc"].shape == (16,)

    for _ in range(300):
        grads = {"w": 2 * params["w"] / params["w"].numel()}   # d mean(w^2)
        params, state, _ = opt.update(grads, state, params)
    assert float(torch.mean(params["w"] ** 2)) < 1e-3


def test_grad_clipping():
    params = {"w": torch.zeros(4)}
    opt = AdamW(learning_rate=1.0, clip_norm=1.0, weight_decay=0.0)
    state = opt.init(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = opt.update(grads, state, params)
    assert metrics["grad_norm"] > 1e5  # reported pre-clip


def test_cosine_schedule():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-2)


@pytest.mark.parametrize("step", [0, 5, 10, 37, 100, 150])
def test_cosine_schedule_matches_reference(step):
    got = float(cosine_schedule(1e-3, 10, 100)(torch.tensor(step)))
    want = float(ref_cosine(1e-3, 10, 100)(jnp.asarray(step)))
    assert got == pytest.approx(want, rel=TOL, abs=1e-12)


def test_global_norm():
    t = {"a": torch.ones(4), "b": torch.ones((2, 2)) * 2}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(4 + 16))


def test_missing_grad_is_a_zero_grad():
    """A leaf that did not reach the loss (grad None) is updated as with a
    zero gradient, as ``jax.grad`` returns zeros for it."""
    params = {"w": torch.ones((2, 3)), "b": torch.ones(3)}
    opt = AdamW(learning_rate=0.1)
    state = opt.init(params)
    params, state, _ = opt.update({"w": torch.ones((2, 3)), "b": None},
                                  state, params)
    assert torch.equal(params["b"], torch.ones(3))       # no decay on 1-D
    assert torch.equal(state["m"]["b"], torch.zeros(3))


# ------------------------------------------- optimizers vs the reference --

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "emb": (3, 4, 2)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", ["adamw", "adamw-bf16-states",
                                  "factored"])
def test_optimizer_updates_match_reference(name):
    """Three steps from the same numpy params with the same numpy grads:
    params, moments, grad_norm and lr within 1e-6 of the reference's."""
    lr = (cosine_schedule(1e-2, 2, 10), ref_cosine(1e-2, 2, 10))
    if name == "factored":
        port = FactoredAdam(learning_rate=lr[0], weight_decay=0.01,
                            layer_groups=1)
        ref = RefFactoredAdam(learning_rate=lr[1], weight_decay=0.01)
    else:
        bf16 = name.endswith("bf16-states")
        port = AdamW(learning_rate=lr[0], clip_norm=2.0,
                     state_dtype=torch.bfloat16 if bf16 else torch.float32)
        ref = RefAdamW(learning_rate=lr[1], clip_norm=2.0,
                       state_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    p_np = _opt_tree(0)
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    rparams = {k: jnp.asarray(v) for k, v in p_np.items()}
    state, rstate = port.init(params), ref.init(rparams)
    for step in range(3):
        g_np = {k: v * (1.5 + step) for k, v in _opt_tree(step + 1).items()}
        params, state, m = port.update(
            {k: torch.from_numpy(v) for k, v in g_np.items()}, state, params)
        rparams, rstate, rm = ref.update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, rstate, rparams)
        for k in p_np:
            _close(params[k], rparams[k], f"{name} step {step} param {k}")
            _close(state["m"][k], np.asarray(rstate["m"][k], np.float32),
                   f"{name} m {k}")
            rv = rstate["v"][k]
            for sub, val in (rv.items() if isinstance(rv, dict)
                             else [(None, rv)]):
                got = state["v"][k] if sub is None else state["v"][k][sub]
                _close(got, np.asarray(val, np.float32), f"{name} v {k}")
        _close(m["grad_norm"], rm["grad_norm"], "grad_norm")
        _close(m["lr"], rm["lr"], "lr")
        assert int(state["step"]) == int(rstate["step"]) == step + 1


# ------------------------------------------------------------ checkpoint --

def _tree(x=1.0):
    return {"params": {"w": torch.full((4, 3), x), "b": torch.zeros(3)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree(2.5)
    store.save(tmp_path, 42, t)
    restored, step = store.restore(tmp_path, _zeros_like(t))
    assert step == 42
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert store.latest_step(tmp_path) == 42


def test_checkpoint_keep_k(tmp_path):
    for s in (1, 2, 3, 4, 5):
        store.save(tmp_path, s, _tree(float(s)), keep=2)
    steps = sorted(p.name for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_checkpoint_atomic_crash_safety(tmp_path):
    store.save(tmp_path, 1, _tree(1.0))
    # simulate a crash mid-save: stale tmp dir must not break restore
    (tmp_path / "step_00000002.tmp").mkdir()
    restored, step = store.restore(tmp_path, _tree(0.0))
    assert step == 1
    assert float(restored["params"]["w"][0, 0]) == 1.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    store.save(tmp_path, 1, _tree())
    bad = {"params": {"w": torch.zeros((5, 3)), "b": torch.zeros(3)},
           "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        store.restore(tmp_path, bad)
    assert torch.equal(bad["params"]["b"], torch.zeros(3))   # nothing written


def test_checkpoint_bf16_roundtrip_is_bit_exact(tmp_path):
    """bf16 is stored as its 16-bit pattern with its dtype in the manifest
    and restored bit for bit into the target tensor's dtype and device;
    the layout is the reference's (manifest + arrays/<i>.npy)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    tree = {"params": {"w": w.bfloat16(), "s": torch.tensor(3.5)},
            "opt": {"m": {"w": (w * 1e-3).bfloat16()},
                    "step": torch.tensor(11, dtype=torch.int32)}}
    path = store.save(tmp_path, 3, tree)
    assert (path / "manifest.json").exists()
    assert sorted(p.name for p in (path / "arrays").iterdir()) == [
        "0.npy", "1.npy", "2.npy", "3.npy"]
    assert np.load(path / "arrays" / "0.npy").dtype == np.uint16
    fresh = {"params": {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                        "s": torch.tensor(0.0)},
             "opt": {"m": {"w": torch.zeros(5, 7, dtype=torch.bfloat16)},
                     "step": torch.tensor(0, dtype=torch.int32)}}
    targets = [leaf for _, leaf in store.flatten(fresh)]
    restored, step = store.restore(tmp_path, fresh)
    assert step == 3
    for (ka, a), (kb, b) in zip(store.flatten(restored),
                                store.flatten(tree)):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), ka
    # in place: the very tensors of the tree it was given
    assert all(a is b for a, b in zip(
        [leaf for _, leaf in store.flatten(restored)], targets))


def test_checkpoint_restores_into_a_model_in_place(tmp_path):
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import Model
    cfg = get_tiny_config("stablelm-12b")
    src = Model(cfg, device="cpu",
                generator=torch.Generator().manual_seed(1))
    store.save(tmp_path, 5, {"params": dict(src.named_parameters())})
    dst = Model(cfg, device="cpu",
                generator=torch.Generator().manual_seed(2))
    store.restore(tmp_path, {"params": dict(dst.named_parameters())})
    for (n, a), (_, b) in zip(src.named_parameters(),
                              dst.named_parameters()):
        assert torch.equal(a, b), n


# ------------------------------------------------------------------ data --

def test_data_deterministic_and_host_sharded():
    cfg = dict(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    a = SyntheticLM(DataConfig(**cfg, num_hosts=2, host_index=0)).batch(5)
    a2 = SyntheticLM(DataConfig(**cfg, num_hosts=2, host_index=0)).batch(5)
    b = SyntheticLM(DataConfig(**cfg, num_hosts=2, host_index=1)).batch(5)
    np.testing.assert_array_equal(a["tokens"], a2["tokens"])  # replayable
    assert not np.array_equal(a["tokens"], b["tokens"])       # disjoint hosts
    assert a["tokens"].shape == (4, 16)
    # labels are next-token shifted
    assert a["labels"].shape == (4, 16)


def test_data_has_learnable_structure():
    cfg = DataConfig(vocab_size=50, seq_len=128, global_batch=16, seed=0)
    data = SyntheticLM(cfg)
    batch = data.batch(0)
    toks, labels = batch["tokens"], batch["labels"]
    # bigram successor fires ~50% of the time
    hits = (labels == data._succ[toks]).mean()
    assert 0.3 < hits < 0.7


def test_prefetcher():
    cfg = DataConfig(vocab_size=10, seq_len=4, global_batch=2)
    pf = Prefetcher(SyntheticLM(cfg).stream(), depth=2)
    b0 = next(pf)
    b1 = next(pf)
    assert b0["tokens"].shape == (2, 4)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    pf.close()


@pytest.mark.parametrize("seed,step,hosts,host,embed", [
    (0, 0, 1, 0, 0), (3, 5, 2, 1, 0), (7, 123, 4, 2, 0), (1, 2, 1, 0, 8)])
def test_batches_equal_the_reference(seed, step, hosts, host, embed):
    kw = dict(vocab_size=97, seq_len=33, global_batch=8, seed=seed,
              num_hosts=hosts, host_index=host, embed_dim=embed)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    want = RefSyntheticLM(RefDataConfig(**kw)).batch(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------------- fault tolerance --

def test_runner_recovers_from_failures(tmp_path):
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] in (3, 7):   # two injected failures
            raise StepFailure("injected")
        return {"x": state["x"] + batch["inc"]}, {"x": state["x"]}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    runner = FaultTolerantRunner(cfg, step_fn=flaky_step,
                                 state={"x": torch.tensor(0.0)})
    batches = ({"inc": torch.tensor(1.0)} for _ in range(100))
    final = runner.run(batches, num_steps=10)
    assert runner.step == 10
    assert runner.restarts == 2
    # state reflects 10 successful increments from the restored points
    assert float(final["x"]) >= 8.0
    assert store.latest_step(tmp_path) == 10


def test_runner_resumes_from_checkpoint(tmp_path):
    def step(state, batch):
        return {"x": state["x"] + 1.0}, {}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=5)
    r1 = FaultTolerantRunner(cfg, step_fn=step,
                             state={"x": torch.tensor(0.0)})
    r1.run(({} for _ in range(100)), num_steps=7)
    # new runner (fresh process) resumes from step 7 checkpoint
    r2 = FaultTolerantRunner(cfg, step_fn=step,
                             state={"x": torch.tensor(0.0)})
    assert r2.restore_latest()
    assert r2.step == 7
    assert float(r2.state["x"]) == 7.0


def test_runner_stops_on_an_exhausted_stream(tmp_path):
    def step(state, batch):
        return {"x": state["x"] + 1.0}, {}

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=100)
    runner = FaultTolerantRunner(cfg, step_fn=step,
                                 state={"x": torch.tensor(0.0)})
    runner.run(iter([{}, {}, {}]), num_steps=10)
    assert runner.step == 3
    assert store.latest_step(tmp_path) == 3      # final checkpoint written


def test_runner_gives_up_after_max_retries(tmp_path):
    def broken(state, batch):
        raise StepFailure("always")

    cfg = RunnerConfig(checkpoint_dir=str(tmp_path), max_retries_per_step=2)
    runner = FaultTolerantRunner(cfg, step_fn=broken,
                                 state={"x": torch.tensor(0.0)})
    with pytest.raises(StepFailure):
        runner.run(iter([{}] * 5), num_steps=5)
    assert runner.restarts == 3


def test_remesh_restores_onto_a_device_keeping_the_tensors(tmp_path):
    """``remesh(device)`` checkpoints, re-homes every state tensor on the
    device (the same objects, so a model's parameters follow) and restores
    the checkpoint into them."""
    p = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    state = {"params": {"p": p}, "opt": {"step": torch.tensor(4)}}
    runner = FaultTolerantRunner(RunnerConfig(checkpoint_dir=str(tmp_path)),
                                 step_fn=None, state=state)
    runner.step = 4
    runner.remesh("cpu")
    assert runner.step == 4 and store.latest_step(tmp_path) == 4
    assert runner.state["params"]["p"] is p
    assert torch.equal(p, torch.arange(6.0).reshape(2, 3))
