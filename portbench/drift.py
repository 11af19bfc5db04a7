"""How far the program's trajectory drifts from the reference's over many
intervals, both from the deck's initial arrays: the program's state at
output k of a window's first pass against the reference stepped from t = 0
to the same time in float64, and the same reference in float32 (the
witness: what float32 rounding alone gives) against it too.

The benchmark's runs do not run it: from t = 0 to output 40 the reference
takes minutes, longer than a run's window, so a run's ``later`` comparison
starts the reference from the program's state one output before.

    python portbench/drift.py --workload dambreak3d.run --seeds 1,2 --output 40

One JSON line per seed: the four numbers of ``check.gaps`` for the program
and for the witness, the steps and the seconds each side took.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def drift(c: dict, seed: int, output: int, device) -> dict:
    import torch

    from portbench import check, harness
    from portbench.reference import sph

    c["config"]["check"]["later"] = [output, output]
    device = torch.device(device)
    run = harness.Run(c, seed, device)
    t0 = time.perf_counter()
    run.setup(False)
    run.next_counter = 1
    run.drive("window", 0.0, output)             # stops after ``output`` intervals
    _, b, t_out = run.snap["later"]
    got = check.port_numpy(b)
    steps = got["iteration"] - int(run.state0.iteration)
    program_s = time.perf_counter() - t0
    arrays, config = run.arrays, run.config
    del run, b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    P = sph.physics(config)
    res = {"seed": seed, "output": output, "t_out": t_out, "steps": steps,
           "program_s": program_s}
    ref = None
    for name, dtype in (("reference", torch.float64), ("witness", torch.float32)):
        t0 = time.perf_counter()
        out, n = check.reference_interval(config, arrays, None, t_out, 4 * steps + 10,
                                          dtype=dtype, device=device)
        res[f"{name}_s"] = time.perf_counter() - t0
        res[f"{name}_steps"] = n
        if ref is None:
            ref, ref_steps = out, n
            res["program"] = check.gaps(got, ref, steps, ref_steps, P)
        else:
            res["witness"] = check.gaps(out, ref, n, ref_steps, P)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--output", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: drift needs a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        res = drift(harness.cell(args.workload), seed, args.output, "cuda:0")
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
