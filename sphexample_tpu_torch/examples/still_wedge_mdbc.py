"""2D hydrostatic still-wedge with mDBC boundaries (port of
``examples/still_wedge_mdbc.py``).

Python analog of the reference driver script ``example/StillWedgeMDBC.jl``:
same constants (dx=0.02, c0=42.48576250492629, delta=0.1, CFL=0.5), same
input CSVs, ArtificialViscosity + LinearDensityDiffusion + SimpleMDBC.

    python -m sphexample_tpu_torch.examples.still_wedge_mdbc --input DIR [--cpu] ...
"""

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    args = standard_argparser("out/still_wedge").parse_args(argv)
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

    # reference example/StillWedgeMDBC.jl:7
    const = SimulationConstants(dx=0.02, c0=42.48576250492629, delta_sph=0.1, cfl=0.5)
    geoms = [
        Geometry(
            csv_file=f"{args.input}/still_wedge/StillWedge_Dp{const.dx}_Bound.csv",
            group_marker=1, type=ParticleType.FIXED,
        ),
        Geometry(
            csv_file=f"{args.input}/still_wedge/StillWedge_Dp{const.dx}_Fluid.csv",
            group_marker=2, type=ParticleType.FLUID,
        ),
    ]
    meta = SimulationMetaData(
        simulation_name="StillWedge",
        save_location=args.save,
        dims=2,
        simulation_time=args.t_end if args.t_end is not None else 4.0,
        output_times=0.01,
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
            f"{args.input}/still_wedge_mdbc/StillWedge_Dp{const.dx}_GhostNodes_Correct.csv"
        ),
    )


if __name__ == "__main__":
    main()
