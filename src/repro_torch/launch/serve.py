"""Serving entry point: batched generation with POAS dispatch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1_5b \
        --requests 8 --max-new 16 [--groups 2] [--device cuda|cpu] [--tiny]

Weights are drawn from ``--seed``; nothing is downloaded.  The default
device is the card; ``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_tiny_config
from ..core.device_model import DeviceProfile, LinearTimeModel, NO_COPY
from ..models import Model
from ..serving.engine import PoasDispatcher, Request, ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b", choices=ARCH_IDS)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--groups", type=int, default=2,
                    help="simulated replica groups for POAS dispatch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if cfg.frontend != "none":
        print(f"{cfg.name}: stub-frontend arch — serving demo uses token "
              "inputs; pick a text arch")
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run on the host")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    model = Model(cfg, device=args.device, generator=gen)
    engine = ServingEngine(model)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    tokens=rng.integers(1, cfg.vocab_size,
                                        int(rng.integers(4, 32))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    groups = [DeviceProfile(f"group{i}", "gpu-group",
                            LinearTimeModel(a=(1 + i) * 1e-6, b=1e-3),
                            NO_COPY)
              for i in range(args.groups)]
    disp = PoasDispatcher(groups)
    buckets = disp.split(reqs)
    shares = (disp.last_plan.optimize.shares() if disp.last_plan
              else [0.0] * len(groups))
    print(f"dispatch[{disp.domain.name}]:", [len(b) for b in buckets],
          f"shares {[f'{s:.2f}' for s in shares]} "
          f"predicted makespan {disp.predicted_makespan(buckets)*1e3:.2f}ms")
    disp.split(reqs)   # identical batch geometry -> PlanCache hit
    print(f"plan cache: {disp.poas.cache.stats()}")

    t0 = time.perf_counter()
    done = []
    for bucket in buckets:
        done += engine.generate(bucket)
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in done)
    print(f"{len(done)} completions, {total} tokens in {dt:.2f}s "
          f"({total/max(dt, 1e-9):.0f} tok/s) on {model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
