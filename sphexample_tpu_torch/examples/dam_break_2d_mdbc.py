"""2D dam break with density diffusion + mDBC walls (port of
``examples/dam_break_2d_mdbc.py``).

Python analog of ``example/Dambreak2dMDBC.jl``: dx=0.01 constants with
c0=88.14487860902641, CFL=0.5, the three-layer Dp0.02 mDBC geometry, and an
explicit vector of output times (reference Dambreak2dMDBC.jl:34).

    python -m sphexample_tpu_torch.examples.dam_break_2d_mdbc --input DIR [--cpu] ...
"""

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    args = standard_argparser("out/dam_break_2d").parse_args(argv)
    apply_backend_args(args)

    from .. import (
        DensityDiffusionModel,
        Geometry,
        KernelFamily,
        KernelOutputMode,
        MDBCMode,
        ParticleType,
        SimulationConstants,
        SimulationMetaData,
        ViscosityModel,
        make_kernel,
    )

    # reference example/Dambreak2dMDBC.jl:7
    const = SimulationConstants(
        dx=0.01, c0=88.14487860902641, delta_sph=0.1, cfl=0.5, alpha=0.01
    )
    geoms = [
        Geometry(
            csv_file=f"{args.input}/dam_break_2d/DamBreak2d_Dp0.02_MDBC_Bound_ThreeLayers.csv",
            group_marker=1, type=ParticleType.FIXED,
        ),
        Geometry(
            csv_file=f"{args.input}/dam_break_2d/DamBreak2d_Dp0.02_MDBC_Fluid_ThreeLayers.csv",
            group_marker=2, type=ParticleType.FLUID,
        ),
    ]
    t_end = args.t_end if args.t_end is not None else 2.0
    # explicit output-time vector (reference :34: collect(0.01:0.01:2))
    n_out = int(round(t_end / 0.01))
    output_times = tuple(0.01 * (i + 1) for i in range(n_out))
    meta = SimulationMetaData(
        simulation_name="DamBreak2D",
        save_location=args.save,
        dims=2,
        simulation_time=t_end,
        output_times=output_times,
        mdbc=MDBCMode.SIMPLE,
        export_grid_cells=True,
        dtype=args.dtype,
        kernel_output=(KernelOutputMode.STORE if args.kernel_output
                       else KernelOutputMode.NONE),
    )
    kern = make_kernel(KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    return run_case(
        args, geoms, meta, const, kern,
        ViscosityModel.ARTIFICIAL, DensityDiffusionModel.LINEAR,
        particle_normals_path=(
            f"{args.input}/dam_break_2d/DamBreak2d_Dp0.02_MDBC_GhostNodes_ThreeLayers.csv"
        ),
    )


if __name__ == "__main__":
    main()
