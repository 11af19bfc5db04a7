"""Run one cell of the port's benchmark once and print its result's line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are those of ``BENCHMARK.json`` at the root of the checkout.  The
last line of standard output is the run's JSON result; the numbers compared
with the reference, each beside its limit, are the last lines of standard
error.  Without as many CUDA devices as the cell asks for it prints no
result and exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
