"""The comparison's readings over many seeds in one process: the program's
(the lower readings of each limit) or, with ``--control DTYPE``, those of
the reference computed in ``DTYPE`` and put in the program's place (the
control: ``bfloat16``, the precision below the configurations' float32; the
upper readings).  The benchmark's own runs never run the control.

    python portbench/control.py --workload dambreak3d.run --seeds 1,2,3 --seconds 10 \\
        [--control bfloat16]

Each seed's window is ``--seconds`` long (long enough to reach the later
compared output); one JSON line per seed: its checks, ``correct`` and the
seconds the run took.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import run_cell

    t_start = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        out = io.StringIO()
        t0 = time.perf_counter()
        rc = run_cell(args.workload, seed, args.seconds, False, t_start,
                      control=args.control, out=out)
        line = out.getvalue().strip().splitlines()
        res = json.loads(line[-1]) if line else {}
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "rc": rc, "correct": res.get("correct"),
                          "checks": {k: v["value"] for k, v in res.get("checks", {}).items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
