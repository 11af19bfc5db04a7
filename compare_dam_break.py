#!/usr/bin/env python3
"""The 3D dam break through the JAX package and the port on the CPU, with
``tools/analyze_dambreak.py``'s readings at every output side by side.

    python3 compare_dam_break.py --dx 0.04 [--t-end 1.6] [--packages jax,torch]
                                 [--out FILE.json]

The deck is ``examples/dam_break_3d.py``'s (io/casegen.py, c0 33.14,
alpha 0.1, CFL 0.2, h = sqrt 3 dx, Wendland C2, ARTIFICIAL, LINEAR, an output
every 0.01 s, f32) at a spacing the CPU can carry: dx 0.04 runs to 1.6 s in
~8 min a package, dx 0.0085 (the deck's own) takes minutes a step. Each
output prints t, the front, the fluid density range, |v|max and the fluid
rows outside [990, 1010] (the density band of the JAX package's record,
PERFORMANCE.md:36-68); ``--out`` keeps them as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

BAND = (990.0, 1010.0)


def readings(t, ptype, active, position, density, velocity):
    fluid = (ptype == 1) & active
    rho, pos, vel = density[fluid], position[fluid], velocity[fluid]
    return {"t": float(t), "x_front": float(pos[:, 0].max()),
            "rho_min": float(rho.min()), "rho_max": float(rho.max()),
            "vmax": float(np.sqrt((vel * vel).sum(-1)).max()),
            "outside_band": int(((rho < BAND[0]) | (rho > BAND[1])).sum()),
            "fluid_rows": int(fluid.sum())}


def run(package, dx, t_end, dtype="float32"):
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import sphexample_tpu as M
        from sphexample_tpu.io.casegen import dam_break_3d

        kw = {}
        host = np.asarray
    else:
        import sphexample_tpu_torch as M
        from sphexample_tpu_torch.io.casegen import dam_break_3d

        kw = {"device": "cpu"}
        host = lambda a: a.cpu().numpy()  # noqa: E731
    const = M.SimulationConstants(dx=dx, c0=33.14, alpha=0.1, m0=1000 * dx**3, cfl=0.2)
    kern = M.make_kernel(M.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * dx**2)))
    meta = M.SimulationMetaData(simulation_name="DamBreak3D", save_location="out/compare",
                                dims=3, simulation_time=t_end, output_times=0.01,
                                dtype=dtype)
    sim = M.assemble_simulation(*dam_break_3d(dx), meta, const, kern,
                                M.ViscosityModel.ARTIFICIAL, M.DensityDiffusionModel.LINEAR,
                                **kw)
    rows = []

    def save(counter, state):
        p = state.particles
        rows.append(readings(host(state.total_time), host(p.ptype), host(p.active),
                             host(p.position), host(p.density), host(p.velocity)))

    t0 = time.perf_counter()
    sim = M.run_simulation(sim, save_callback=save)
    return {"package": package, "dx": dx, "n": sim.n_live, "steps": int(sim.state.iteration),
            "seconds": time.perf_counter() - t0, "readings": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dx", type=float, required=True)
    ap.add_argument("--t-end", type=float, default=1.6)
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = [run(p, args.dx, args.t_end) for p in args.packages.split(",")]
    for r in runs:
        print(f"{r['package']}: n {r['n']}, {r['steps']} steps, {r['seconds']:.1f} s (CPU)")
    print("      t " + "".join(f"| {r['package']:>5} x_front  rho_min  rho_max  |v|max out "
                              for r in runs))
    for rows in zip(*(r["readings"] for r in runs)):
        print(f"{rows[0]['t']:7.4f} " + "".join(
            f"| {x['x_front']:13.4f} {x['rho_min']:8.2f} {x['rho_max']:8.2f} "
            f"{x['vmax']:7.3f} {x['outside_band']:3d} " for x in rows))
    for r in runs:
        rd = r["readings"]
        print(f"{r['package']}: density [{min(x['rho_min'] for x in rd):.4f}, "
              f"{max(x['rho_max'] for x in rd):.4f}], outputs outside {BAND}: "
              f"{sum(x['outside_band'] > 0 for x in rd)}, most rows outside: "
              f"{max(x['outside_band'] for x in rd)} of {rd[0]['fluid_rows']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(runs, fh)


if __name__ == "__main__":
    main()
