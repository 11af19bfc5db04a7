"""sphexample_tpu_torch: the weakly-compressible SPH solver in PyTorch, with
its neighbor sweep and its mDBC ghost-node moment sums as hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``sphexample_tpu`` (JAX), which stays in the repository as the
reference.  This package imports no JAX and nothing of the JAX package.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .config import (  # noqa: F401
    DensityDiffusionModel,
    Geometry,
    KernelFamily,
    KernelOutputMode,
    LogMode,
    MDBCMode,
    MotionDetails,
    ParticleType,
    ShiftingMode,
    SimulationConstants,
    SimulationMetaData,
    SPHKernelInstance,
    ViscosityModel,
    make_kernel,
    replace,
)
from .state import (  # noqa: F401
    Particles,
    SimulationState,
    allocate_particles,
    state_from_numpy,
    state_to_numpy,
)
from .core.driver import (  # noqa: F401
    Simulation,
    assemble_simulation,
    build_simulation,
    run_simulation,
)
from .core.step import StepConfig, make_interval_fn, sph_step  # noqa: F401

__version__ = "0.1.0"
