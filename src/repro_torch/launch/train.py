"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1_5b \
        --steps 100 --batch 4 --seq 2048 [--ckpt-dir DIR] [--resume] \
        [--device cuda|cpu] [--tiny]

Composes the stack: config → Model (weights from ``--seed``) → AdamW →
synthetic data pipeline → fault-tolerant runner (checkpoint/restart) when
``--ckpt-dir`` is given.  The default device is the card; without one it
raises unless ``--device cpu`` is given, which runs the kernels' plain
versions (use it with ``--tiny``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_tiny_config
from ..data.pipeline import DataConfig, Prefetcher, SyntheticLM
from ..distributed.elastic import FaultTolerantRunner, RunnerConfig
from ..models import Model
from ..models.config import ArchConfig
from ..training.optim import AdamW, cosine_schedule
from ..training.step import init_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b", choices=ARCH_IDS)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


@dataclasses.dataclass
class Job:
    """What ``main`` trains: the objects it builds from its arguments."""
    cfg: ArchConfig
    model: Model
    opt: AdamW
    state: dict
    data: SyntheticLM
    step_fn: Callable[[dict, dict], tuple[dict, dict]]   # numpy batches


def build(args: argparse.Namespace, cfg: ArchConfig | None = None) -> Job:
    """The objects ``main`` trains with, for ``args``; ``cfg`` (a cut of a
    configuration, another remat) in place of the one ``--arch`` and
    ``--tiny`` name."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run on the host")
    if cfg is None:
        cfg = (get_tiny_config(args.arch) if args.tiny
               else get_config(args.arch))
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    model = Model(cfg, device=args.device, generator=gen)
    opt = AdamW(learning_rate=cosine_schedule(args.lr, warmup=20,
                                              total=args.steps),
                state_dtype=torch.float32 if args.tiny else torch.bfloat16)
    state = init_state(model, opt)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.frontend != "none" else 0))
    train_step = make_train_step(model, opt)

    def step_fn(state, batch):
        batch = {k: torch.as_tensor(v).to(model.device)
                 for k, v in batch.items()}
        return train_step(state, batch)

    return Job(cfg, model, opt, state, data, step_fn)


def main(argv=None) -> int:
    args = parse_args(argv)
    job = build(args)
    n_params = sum(p.numel() for p in job.model.parameters())
    print(f"arch={job.cfg.name} params={n_params/1e6:.2f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    losses = []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    state = job.state
    if args.ckpt_dir:
        runner = FaultTolerantRunner(
            RunnerConfig(checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=args.ckpt_every),
            step_fn=job.step_fn, state=state)
        if args.resume and runner.restore_latest():
            print(f"resumed from step {runner.step}")
        t0 = time.time()
        pf = Prefetcher(job.data.stream(runner.step))
        try:
            runner.run(pf, args.steps, on_metrics=on_metrics)
        finally:
            pf.close()
        dt = time.time() - t0
    else:
        t0 = time.time()
        pf = Prefetcher(job.data.stream(0))
        try:
            for step in range(1, args.steps + 1):
                state, metrics = job.step_fn(state, next(pf))
                on_metrics(step, metrics)
        finally:
            pf.close()
        dt = time.time() - t0

    if len(losses) >= 20:
        first = np.mean(losses[:5])
        last = np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'}) "
              f"in {dt:.0f}s ({dt/max(len(losses),1)*1e3:.0f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
