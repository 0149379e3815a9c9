"""The benchmark of the PyTorch and CUDA port (``repro_torch``), one run of
one cell of ``BENCHMARK.json``:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the result (JSON); the last
lines of standard error are the numbers ``correct`` compared, each beside
its limit.  Every cache the run builds lies inside the checkout.
"""
import os
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    cache = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from perfbench.harness import cli
    return cli.run(cli.parse(argv), ROOT, STARTED)


if __name__ == "__main__":
    sys.exit(main())
