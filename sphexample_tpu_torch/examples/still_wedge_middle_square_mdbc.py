"""2D still wedge with a submerged square: multi-object mDBC boundaries
(port of ``examples/still_wedge_middle_square_mdbc.py``).

Python analog of ``example/StillWedgeMiddleSquareMDBC.jl`` (same constants
as the plain wedge, middle-square geometry set).

    python -m sphexample_tpu_torch.examples.still_wedge_middle_square_mdbc --input DIR ...
"""

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    args = standard_argparser("out/still_wedge_middle_square").parse_args(argv)
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

    const = SimulationConstants(dx=0.02, c0=42.48576250492629, delta_sph=0.1, cfl=0.5)
    base = f"{args.input}/still_wedge_middle_square_mdbc/StillWedge_MiddleSquare_Dp{const.dx}"
    geoms = [
        Geometry(csv_file=f"{base}_Bound.csv", group_marker=1, type=ParticleType.FIXED),
        Geometry(csv_file=f"{base}_Fluid.csv", group_marker=2, type=ParticleType.FLUID),
    ]
    meta = SimulationMetaData(
        simulation_name="StillWedgeMiddleSquare",
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
    return run_case(args, geoms, meta, const, kern,
                    ViscosityModel.ARTIFICIAL, DensityDiffusionModel.LINEAR,
                    particle_normals_path=f"{base}_GhostNodes.csv")


if __name__ == "__main__":
    main()
