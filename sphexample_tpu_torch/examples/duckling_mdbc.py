"""3D "duckling" tank with mDBC boundaries (port of
``examples/duckling_mdbc.py``).

Python analog of ``example/DucklingMDBC.jl``: dx=0.01, c0=23.43842998154953,
CFL=0.2, alpha=0.02, m0=0.001, kernel k=1.5, SimpleMDBC.

    python -m sphexample_tpu_torch.examples.duckling_mdbc --input DIR [--cpu] ...
"""

from ._runner import apply_backend_args, run_case, standard_argparser


def main(argv=None):
    args = standard_argparser("out/duckling").parse_args(argv)
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

    const = SimulationConstants(
        dx=0.01, c0=23.43842998154953, delta_sph=0.1, cfl=0.2, alpha=0.02, m0=0.001
    )
    base = f"{args.input}/case_duckling_mdbc/CaseDuckling_Dp{const.dx}"
    geoms = [
        Geometry(csv_file=f"{base}_Bound_MDBC.csv", group_marker=1, type=ParticleType.FIXED),
        Geometry(csv_file=f"{base}_Fluid_MDBC.csv", group_marker=2, type=ParticleType.FLUID),
    ]
    meta = SimulationMetaData(
        simulation_name="CaseDuckling",
        save_location=args.save,
        dims=3,
        simulation_time=args.t_end if args.t_end is not None else 1.0,
        output_times=0.02,
        mdbc=MDBCMode.SIMPLE,
        export_grid_cells=True,
        dtype=args.dtype,
        kernel_output=(KernelOutputMode.STORE if args.kernel_output
                       else KernelOutputMode.NONE),
    )
    kern = make_kernel(KernelFamily.WENDLAND_C2, 3, dx=const.dx, k=1.5)
    return run_case(args, geoms, meta, const, kern,
                    ViscosityModel.ARTIFICIAL, DensityDiffusionModel.LINEAR,
                    particle_normals_path=f"{base}_GhostNodes.csv")


if __name__ == "__main__":
    main()
