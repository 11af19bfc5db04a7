#!/usr/bin/env python3
"""The procedural mDBC and moving-body decks (``procedural_decks.py``) through
the JAX package's deck CLIs and the port's, on the CPU, with
``tools/analyze_case.py``'s readings at every output side by side.

    python3 compare_case.py [--cases still_tank,moving_square]
                            [--packages jax,torch] [--tank-t-end T]
                            [--square-dp DP] [--resume CHECKPOINT.npz]
                            [--out FILE.json] [--load FILE.json ...]
                            [--jax-readings FILE.json]

Cases, each at a coarse size the CPU carries, in f32 (the decks' default):

- ``still_tank``: ``duckling_mdbc`` (mDBC, dx 0.01, k 1.5, ARTIFICIAL,
  LINEAR, an output every 0.02 s) on the coarse still tank: the deck's dx
  and water depth on a 0.05 x 0.05 m floor (4,953 rows); band 950-1100.
- ``moving_square``: ``moving_square_2d --dp 0.1`` (motion at 2.8 m/s,
  PLANAR shifting, LAMINAR_SPS, an output every 0.01 s to 2.5 s) on the
  10 x 5 m box (5,936 rows); band 900-1150 with 2 outliers allowed, the body
  (marker 3) tracked along x.

Each deck runs as its script does (the JAX deck from ``examples/`` with
``--cpu``, the port's as ``python -m sphexample_tpu_torch.examples.<deck>
--cpu``), writing its VTKHDF; every snapshot it saves is read on the way: the
port's by ``sphexample_tpu_torch.utils.validation.case_readings``, the JAX
package's by :func:`readings` here, the same definitions on the host.  The
table gives t, the fluid density range, |v|max (the largest velocity
component), the rows outside the band and (square) the body's error against
its track.  ``--out`` keeps every run as JSON; ``--load`` reads such files
(and ``compare_dam_break.py --out`` files) instead of running, so that each
package can run in a process of its own; ``--jax-readings FILE`` writes the
JAX runs with the port's CPU run's differences from them, what the card's
``chip_smoke.py`` holds its runs of the same cases against (the card has no
JAX).  ``--square-dp 0.02 --resume CHECKPOINT`` continues the full square
from a checkpoint (e.g. one the card wrote) through the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import procedural_decks as pd

ROOT = Path(__file__).resolve().parent

CASES = {
    "still_tank": {
        "deck": "duckling_mdbc",
        "write": lambda root, size: pd.write_still_tank(root, size or "coarse"),
        "gate": {"band": (950.0, 1100.0)},
    },
    "moving_square": {
        "deck": "moving_square_2d",
        "write": lambda root, size: pd.write_moving_square(root, size or pd.SQUARE_DP["coarse"]),
        "gate": {"band": (900.0, 1150.0), "allow_outliers": 2, "track_marker": 3,
                 "speed": pd.SQUARE_SPEED},
    },
}


def readings(t, ptype, active, position, velocity, density, group_marker, origin=None,
             band=(950.0, 1150.0), allow_outliers=0, track_marker=None, speed=0.0,
             direction=0, duration=1e30, track_tol=1e-3):
    """``tools/analyze_case.py`` on one snapshot's host arrays: the keys of
    ``case_readings`` (the port's) but ``nonfinite``."""
    live = active.astype(bool)
    fluid = live & (ptype == pd.FLUID)
    rho, pos = density[fluid].astype(np.float64), position[live].astype(np.float64)
    lo, hi = band
    out_band = int(((rho < lo) | (rho > hi)).sum())
    out = {"t": float(t), "rho_min": float(rho.min()), "rho_max": float(rho.max()),
           "vmax": float(np.abs(velocity[live]).max()),
           "nan": int(np.isnan(pos).sum() + np.isnan(rho).sum()), "out_band": out_band}
    flags = ["nan"] if out["nan"] else []
    if out_band > allow_outliers:
        flags.append("out_of_band")
    elif out_band and (rho.min() < 1.5 * lo - 0.5 * hi or rho.max() > 1.5 * hi - 0.5 * lo):
        flags.append("hard_band")
    if track_marker is not None:
        x = float(pos[group_marker[live] == track_marker, direction].mean())
        err = 0.0
        if origin is not None:
            x0, t0 = origin
            err = abs(x - (x0 + speed * (min(out["t"], duration) - min(t0, duration))))
            if err > track_tol:
                flags.append("off_trajectory")
        out.update(x_body=x, body_err=err)
    out.update(bad=len(flags), flags=flags, ok=not flags)
    return out


def _jax_deck(deck, argv):
    """The JAX deck's ``main`` as its script runs (``examples/`` on
    ``sys.path``, ``sys.argv`` set); nothing under ``examples/`` is edited."""
    sys.path.insert(0, str(ROOT / "examples"))
    old = sys.argv
    sys.argv = [f"{deck}.py", *argv]
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{deck}",
                                                      ROOT / "examples" / f"{deck}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
    finally:
        sys.argv = old
        sys.path.remove(str(ROOT / "examples"))


def run(package, case, t_end=None, dtype="float32", workdir=None, size=None, resume=None):
    """``case`` through ``package``'s deck CLI on the CPU; its readings at
    every output, the steps, the particles and the seconds.  ``size``: the
    still tank's lattice counts (procedural_decks.still_tank's arguments)
    instead of the coarse tank's, or the square's spacing instead of 0.1;
    ``resume``: a checkpoint of the same case (either package's, e.g. one
    the card wrote) that the CLI resumes from with ``--resume``."""
    spec = CASES[case]
    work = Path(workdir or tempfile.mkdtemp(prefix=f"compare_case_{case}_"))
    spec["write"](str(work / "input"), size)
    deck_argv = ["--dp", str(size or pd.SQUARE_DP["coarse"])] if case == "moving_square" else []
    argv = ["--cpu", "--dtype", dtype, "--input", str(work / "input"),
            "--save", str(work / package), *deck_argv]
    if t_end is not None:
        argv += ["--t-end", repr(t_end)]
    if resume is not None:
        argv += ["--resume", str(resume)]
    rows, origin, sims = [], [None], []

    def hook(real, read):
        def run_simulation(sim, save_callback=None, **kw):
            def save(counter, state):
                r = read(state, origin[0])
                if origin[0] is None and "x_body" in r:
                    origin[0] = (r["x_body"], r["t"])
                rows.append({"counter": counter, **r})
                if save_callback is not None:
                    save_callback(counter, state)

            out = real(sim, save_callback=save, **kw)
            sims.append(out)
            return out

        return run_simulation

    t0 = time.perf_counter()
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import sphexample_tpu as M

        def read(state, origin):
            p = state.particles
            return readings(np.asarray(state.total_time), np.asarray(p.ptype),
                            np.asarray(p.active), np.asarray(p.position),
                            np.asarray(p.velocity), np.asarray(p.density),
                            np.asarray(p.group_marker), origin, **spec["gate"])

        real = M.run_simulation
        M.run_simulation = hook(real, read)
        try:
            _jax_deck(spec["deck"], argv)
        finally:
            M.run_simulation = real
    else:
        from sphexample_tpu_torch.core import driver
        from sphexample_tpu_torch.utils.validation import case_readings

        def read(state, origin):
            r = case_readings(state, origin=origin, **spec["gate"])
            del r["nonfinite"]
            return r

        real = driver.run_simulation
        driver.run_simulation = hook(real, read)
        try:
            importlib.import_module(f"sphexample_tpu_torch.examples.{spec['deck']}").main(argv)
        finally:
            driver.run_simulation = real
    seconds = time.perf_counter() - t0
    sim = sims[-1]
    return {"package": package, "case": case, "deck": spec["deck"], "argv": deck_argv,
            "dtype": dtype, "gate": spec["gate"], "n": sim.n_live,
            "steps": int(sim.state.iteration), "t_end_arg": t_end, "t_end": rows[-1]["t"],
            "seconds": seconds, "readings": rows}


READING_KEYS = ("t", "x_front", "rho_min", "rho_max", "vmax", "x_body", "body_err")


def differences(a, b):
    """The largest differences of two runs' readings over their common
    outputs (compare_dam_break.py's runs too): each reading's absolute
    difference, the rows outside the band, the outputs whose verdicts differ,
    and the two step counts."""
    pairs = list(zip(a["readings"], b["readings"]))
    first = a["readings"][0]
    out = {k: max(abs(x[k] - y[k]) for x, y in pairs) for k in READING_KEYS if k in first}
    for k in ("out_band", "outside_band"):
        if k in first:
            out[k] = max(abs(x[k] - y[k]) for x, y in pairs)
    if "ok" in first:
        out["verdicts_differ"] = sum(x["ok"] != y["ok"] for x, y in pairs)
    out.update(outputs=len(pairs), steps=[a["steps"], b["steps"]])
    return out


def table(runs):
    lines = []
    for r in runs:
        lines.append(f"{r['package']} {r['case']}: n {r['n']}, {r['steps']} steps to "
                     f"t = {r['t_end']:.4f} s, {r['seconds']:.1f} s (CPU)")
    track = "x_body" in runs[0]["readings"][0]
    lines.append("      t " + "".join(
        f"| {r['package']:>5} rho_min  rho_max   |v|max out" + ("   body_err" if track else "")
        + " ok " for r in runs))
    for rows in zip(*(r["readings"] for r in runs)):
        lines.append(f"{rows[0]['t']:7.4f} " + "".join(
            f"| {x['rho_min']:13.4f} {x['rho_max']:8.4f} {x['vmax']:8.5f} {x['out_band']:3d}"
            + (f" {x['body_err']:10.3e}" if track else "") + f" {'OK' if x['ok'] else 'FAIL'} "
            for x in rows))
    for r in runs:
        rd = r["readings"]
        lines.append(f"{r['package']} {r['case']}: density [{min(x['rho_min'] for x in rd):.4f}, "
                     f"{max(x['rho_max'] for x in rd):.4f}], |v|max <= "
                     f"{max(x['vmax'] for x in rd):.5f}, most rows outside the band "
                     f"{max(x['out_band'] for x in rd)}"
                     + (f", body error <= {max(x['body_err'] for x in rd):.3e} m"
                        if track else "")
                     + f", bad snapshots {sum(x['bad'] for x in rd)}")
    if len(runs) == 2:
        lines.append(f"{runs[1]['package']} vs {runs[0]['package']}: "
                     + json.dumps(differences(runs[1], runs[0])))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="still_tank,moving_square")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--tank-t-end", type=float, default=None,
                    help="end the still tank here (default: the deck's 1.0 s)")
    ap.add_argument("--square-t-end", type=float, default=None,
                    help="end the moving square here (default: the deck's 2.5 s)")
    ap.add_argument("--square-dp", type=float, default=None,
                    help="the square's spacing (default 0.1; the full case is 0.02)")
    ap.add_argument("--resume", default=None, metavar="CHECKPOINT.npz",
                    help="resume every run of the (one) case from this checkpoint")
    ap.add_argument("--out", default=None)
    ap.add_argument("--load", nargs="+", default=None, metavar="FILE",
                    help="instead of running, read the runs of earlier --out files "
                         "(and of compare_dam_break.py --out files)")
    ap.add_argument("--jax-readings", default=None, metavar="FILE",
                    help="write the JAX runs into FILE, keyed by case, each with "
                         "the port's CPU run's differences from it")
    args = ap.parse_args(argv)
    ends = {"still_tank": args.tank_t_end, "moving_square": args.square_t_end}
    done = {}
    if args.load:
        for f in args.load:
            data = json.loads(Path(f).read_text())
            if isinstance(data, list):          # compare_dam_break.py's runs
                for r in data:
                    done.setdefault(f"dam_break_dx{r['dx']}", []).append(r)
            else:
                for case, runs in data.items():
                    done.setdefault(case, []).extend(runs)
    else:
        for case in args.cases.split(","):
            size = args.square_dp if case == "moving_square" else None
            done[case] = [run(p, case, ends[case], size=size, resume=args.resume)
                          for p in args.packages.split(",")]
    for case, runs in done.items():
        if case.startswith("dam_break"):
            by = {r["package"]: r for r in runs}
            print(f"{case}: jax vs torch: {json.dumps(differences(by['jax'], by['torch']))}")
        else:
            print("\n".join(table(runs)), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(done, fh)
    if args.jax_readings:
        kept = {}
        for case, runs in done.items():
            by = {r["package"]: r for r in runs}
            kept[case] = {**by["jax"], "cpu_port_vs_jax": (
                differences(by["torch"], by["jax"]) if "torch" in by else None)}
        Path(args.jax_readings).write_text(json.dumps(kept, indent=0) + "\n")


if __name__ == "__main__":
    main()
