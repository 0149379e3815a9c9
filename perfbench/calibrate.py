"""The readings the limits of ``correct`` are set from (not part of a
benchmark run):

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 0]

For each seed, one process builds the cell, runs a short window (one
batch of a serving mix; none beyond set-up's steps for training) and the
check, and prints one JSON line: the program's numbers and, on the
control seeds, the control's (the reference lowered to fp8, ``.fp8``)
and for a training cell the half-batch fault's (``.half_batch``), each
against the float32 reference.  ``PERF.md`` gives the readings and the
limits set from them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    from perfbench.harness.cli import CELLS
    from perfbench.harness.registry import Registry

    reg = Registry(ROOT)
    cell = reg.workload(args.workload)
    cfg, mix = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = CELLS[mix["kind"]](cfg, mix, seed, args.device,
                                  reg.limits(args.workload)["check"])
        t0 = time.perf_counter()
        run.setup()
        t1 = time.perf_counter()
        run.window(args.seconds)
        t2 = time.perf_counter()
        extra = {}
        if seed in control:
            extra["precisions"] = ("float32", "fp8")
            if run.kind == "train":
                extra["faults"] = ("half_batch",)
        numbers = run.check(**extra)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": numbers, "setup_s": t1 - t0,
                          "window_s": t2 - t1,
                          "check_s": time.perf_counter() - t2,
                          **getattr(run, "detail", {})}),
              flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
