"""3D dam break - the reference's headline "1+ day on CPU" case (port of
``examples/dam_break_3d.py``).

Python analog of ``example/Dambreak3d.jl``: dx=0.0085, c0=33.14, alpha=0.1,
m0=1000 dx^3, CFL=0.2, h=sqrt(3 dx^2), no mDBC.  The Dp0.0085 fluid CSV is
not shipped, so by default the same tank/column layout is generated
procedurally (io/casegen.py: 159,712 particles at the default dx); pass
``--from-csv`` to load the Dp0.02 CSV pair instead.

    python -m sphexample_tpu_torch.examples.dam_break_3d [--cpu] [--shard N] ...
"""

import numpy as np

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    ap = standard_argparser("out/dam_break_3d")
    ap.add_argument("--dx", type=float, default=0.0085)
    ap.add_argument("--from-csv", action="store_true",
                    help="load the Dp0.02 reference CSVs instead of casegen")
    args = ap.parse_args(argv)
    apply_backend_args(args)

    from .. import (
        DensityDiffusionModel,
        Geometry,
        KernelFamily,
        KernelOutputMode,
        ParticleType,
        SimulationConstants,
        SimulationMetaData,
        ViscosityModel,
        make_kernel,
    )

    dx = 0.02 if args.from_csv else args.dx
    # reference example/Dambreak3d.jl:8-15
    const = SimulationConstants(dx=dx, c0=33.14, alpha=0.1, m0=1000 * dx**3, cfl=0.2)
    kern = make_kernel(KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * dx**2)))
    meta = SimulationMetaData(
        simulation_name="DamBreak3D",
        save_location=args.save,
        dims=3,
        simulation_time=args.t_end if args.t_end is not None else 1.6,
        output_times=0.01,
        export_grid_cells=True,
        dtype=args.dtype,
        kernel_output=(KernelOutputMode.STORE if args.kernel_output
                       else KernelOutputMode.NONE),
    )

    if args.from_csv:
        geoms = [
            Geometry(
                csv_file=f"{args.input}/dam_break_3d/DamBreak3d_Dp{dx}_Bound.csv",
                group_marker=1, type=ParticleType.FIXED,
            ),
            Geometry(
                csv_file=f"{args.input}/dam_break_3d/DamBreak3d_Dp{dx}_Fluid.csv",
                group_marker=2, type=ParticleType.FLUID,
            ),
        ]
        return run_case(args, geoms, meta, const, kern,
                        ViscosityModel.ARTIFICIAL, DensityDiffusionModel.LINEAR)
    from ..io.casegen import dam_break_3d

    return run_case(args, [], meta, const, kern,
                    ViscosityModel.ARTIFICIAL, DensityDiffusionModel.LINEAR,
                    arrays=dam_break_3d(dx))


if __name__ == "__main__":
    main()
