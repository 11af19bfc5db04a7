"""2D moving square: prescribed rigid body + PlanarShifting + LaminarSPS
(port of ``examples/moving_square_2d.py``).

Python analog of ``example/MovingSquare2d.jl``: g=0, c0=28, Cb=112000,
alpha=1e-6, CFL=0.2, kernel k=sqrt(2); the square (marker 3) translates at
2.8 m/s in +x from t=0 for 3 s.

The reference script points at the Dp0.02 fluid CSV, which is not shipped;
the complete Dp0.04 set is used by default (pass --dp 0.02 if you have the
full inputs).

    python -m sphexample_tpu_torch.examples.moving_square_2d [--cpu] ...
"""

import math

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    ap = standard_argparser("out/moving_square")
    ap.add_argument("--dp", type=float, default=0.04)
    args = ap.parse_args(argv)
    apply_backend_args(args)

    from .. import (
        DensityDiffusionModel,
        Geometry,
        KernelFamily,
        KernelOutputMode,
        MotionDetails,
        ParticleType,
        ShiftingMode,
        SimulationConstants,
        SimulationMetaData,
        ViscosityModel,
        make_kernel,
    )

    dp = args.dp
    # reference example/MovingSquare2d.jl:9-16
    const = SimulationConstants(
        dx=dp, c0=28.0, delta_sph=0.1, g=0.0, Cb=112000.0, alpha=1e-6, cfl=0.2
    )
    geoms = [
        Geometry(
            csv_file=f"{args.input}/moving_square_2d/MovingSquare_Dp{dp}_Fixed.csv",
            group_marker=1, type=ParticleType.FIXED,
        ),
        Geometry(
            csv_file=f"{args.input}/moving_square_2d/MovingSquare_Dp{dp}_Fluid.csv",
            group_marker=2, type=ParticleType.FLUID,
        ),
        Geometry(
            csv_file=f"{args.input}/moving_square_2d/MovingSquare_Dp{dp}_Square.csv",
            group_marker=3, type=ParticleType.MOVING,
            motion=MotionDetails(
                velocity=2.8, start_time=0.0, duration=3.0, direction=(1.0, 0.0)
            ),
        ),
    ]
    meta = SimulationMetaData(
        simulation_name="MovingSquare2D",
        save_location=args.save,
        dims=2,
        simulation_time=args.t_end if args.t_end is not None else 2.5,
        output_times=0.01,
        shifting=ShiftingMode.PLANAR,
        dtype=args.dtype,
        kernel_output=(KernelOutputMode.STORE if args.kernel_output
                       else KernelOutputMode.NONE),
    )
    kern = make_kernel(KernelFamily.WENDLAND_C2, 2, dx=const.dx, k=math.sqrt(2))
    return run_case(args, geoms, meta, const, kern,
                    ViscosityModel.LAMINAR_SPS, DensityDiffusionModel.LINEAR)


if __name__ == "__main__":
    main()
