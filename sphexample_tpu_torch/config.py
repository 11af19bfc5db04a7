"""Static configuration for the PyTorch/CUDA port of the WCSPH solver.

A copy of ``sphexample_tpu/config.py`` (the port imports nothing of the JAX
package): plain Python dataclasses of floats / ints / enums.  In the port
they select code paths and template instantiations in eager Python instead
of being baked into a trace, so a mode that is off still costs nothing.
Reference: ``src/SimulationMetaDataConfiguration.jl:12-75`` and
``src/SimulationConstantsConfiguration.jl:36-52``.

Knobs of the JAX package that only sized TPU structures (Pallas windows,
chunk tables) are not copied: nothing in the port reads them.
``block_sweep`` is kept: it chooses between the port's two sweep kernels as
it does between the JAX package's.  The host loop's knobs (steps per chunk,
asynchronous output, the device-call watchdog) are kept with the JAX
defaults.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Particle types (reference src/SimulationGeometry.jl:10-14)
# ---------------------------------------------------------------------------
class ParticleType(enum.IntEnum):
    FLUID = 1
    FIXED = 2
    MOVING = 3


# ---------------------------------------------------------------------------
# Mode axes (reference src/SimulationMetaDataConfiguration.jl:12-26)
# ---------------------------------------------------------------------------
class ShiftingMode(enum.Enum):
    NONE = "none"
    PLANAR = "planar"


class KernelOutputMode(enum.Enum):
    NONE = "none"
    STORE = "store"


class MDBCMode(enum.Enum):
    NONE = "none"
    SIMPLE = "simple"


class LogMode(enum.Enum):
    NONE = "none"
    STORE = "store"


class KernelFamily(enum.Enum):
    WENDLAND_C2 = "wendland_c2"
    CUBIC_SPLINE = "cubic_spline"


class ViscosityModel(enum.Enum):
    """Reference src/SPHViscosityModels.jl:13-39."""

    ZERO = "zero"
    ARTIFICIAL = "artificial"
    LAMINAR = "laminar"
    LAMINAR_SPS = "laminar_sps"


class DensityDiffusionModel(enum.Enum):
    """Reference src/SPHDensityDiffusionModels.jl:20-148 (the reference's
    exported-but-undefined ``ZeroGravityComplexDensityDiffusion`` is not
    replicated)."""

    ZERO = "zero"
    ZERO_GRAVITY_LINEAR = "zero_gravity_linear"
    LINEAR = "linear"
    COMPLEX = "complex"


# ---------------------------------------------------------------------------
# Simulation constants (reference src/SimulationConstantsConfiguration.jl:36-52)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SimulationConstants:
    """Physical / numerical constants with the reference's derived defaults.

    All fields are Python floats: torch multiplies a tensor by a Python
    scalar in the tensor's dtype, so arithmetic stays in the state dtype.
    """

    rho0: float = 1000.0
    dx: float = 0.02
    m0: Optional[float] = None  # default rho0 * dx^2 (2D convention)
    alpha: float = 0.01
    g: float = 9.81
    c0: Optional[float] = None  # default sqrt(2 g) * 20
    gamma: float = 7.0
    delta_sph: float = 0.1  # density-diffusion coefficient delta_phi
    cfl: float = 0.2
    Cb: Optional[float] = None  # default c0^2 rho0 / gamma
    nu0: float = 1e-6
    blin_constant: float = 0.0066
    smagorinsky_constant: float = 0.12

    def __post_init__(self):
        if self.m0 is None:
            object.__setattr__(self, "m0", self.rho0 * self.dx**2)
        if self.c0 is None:
            object.__setattr__(self, "c0", math.sqrt(self.g * 2) * 20)
        if self.Cb is None:
            object.__setattr__(self, "Cb", (self.c0**2 * self.rho0) / self.gamma)
        if not (self.rho0 > 0 and self.dx > 0 and self.m0 > 0):
            raise ValueError("rho0, dx and m0 must be positive")
        if not (self.g >= 0 and self.c0 > 0 and self.gamma > 0):
            raise ValueError("g must be >= 0, c0 and gamma positive")
        if not (self.delta_sph > 0 and self.cfl > 0 and self.Cb >= 0):
            raise ValueError("delta_sph and cfl must be positive, Cb >= 0")

    @property
    def gamma_inv(self) -> float:
        return 1.0 / self.gamma

    @property
    def Cb_inv(self) -> float:
        return 1.0 / self.Cb


# ---------------------------------------------------------------------------
# Kernel instance (reference src/SPHKernels.jl:30-72)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SPHKernelInstance:
    """Precomputed smoothing-kernel scalars: h, 1/h, support radius H = k*h,
    1/H, H^2, normalization alpha_d and eta^2 = (0.01 h)^2."""

    family: KernelFamily
    dims: int
    k: float
    h: float
    h_inv: float
    H: float
    H_inv: float
    H2: float
    alpha_d: float
    eta2: float
    cubic_eps: float = 1.0  # CubicSpline tensile-correction epsilon


def _alpha_d(family: KernelFamily, dims: int, h: float) -> float:
    """Normalization constants (reference src/SPHKernels.jl:22-27); no 1D
    Wendland constant, as in the reference."""
    if family is KernelFamily.WENDLAND_C2:
        if dims == 2:
            return 7 / (4 * math.pi * h**2)
        if dims == 3:
            return 21 / (16 * math.pi * h**3)
        raise ValueError("WendlandC2 supports only 2D/3D (reference SPHKernels.jl:21)")
    if family is KernelFamily.CUBIC_SPLINE:
        if dims == 1:
            return 2 / (3 * h)
        if dims == 2:
            return 10 / (7 * math.pi * h**2)
        if dims == 3:
            return 1 / (math.pi * h**3)
        raise ValueError("CubicSpline supports only 1D/2D/3D")
    raise ValueError(f"unknown kernel family {family}")


def make_kernel(
    family: KernelFamily,
    dims: int,
    *,
    dx: Optional[float] = None,
    h: Optional[float] = None,
    k: float = 2.0,
    cubic_eps: float = 1.0,
) -> SPHKernelInstance:
    """Construct a kernel instance from exactly one of ``dx`` or ``h``
    (reference src/SPHKernels.jl:42-72): given ``dx``, h = k*dx; the support
    radius is always H = k*h."""
    if (dx is None) == (h is None):
        raise ValueError("Must provide exactly one of `dx` or `h`")
    h0 = k * dx if dx is not None else h
    H = k * h0
    return SPHKernelInstance(
        family=family,
        dims=dims,
        k=k,
        h=h0,
        h_inv=1.0 / h0,
        H=H,
        H_inv=1.0 / H,
        H2=H * H,
        alpha_d=_alpha_d(family, dims, h0),
        eta2=(0.01 * h0) ** 2,
        cubic_eps=cubic_eps,
    )


# ---------------------------------------------------------------------------
# Geometry spec (reference src/SimulationGeometry.jl:10-31)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MotionDetails:
    """Prescribed rigid-body motion (reference src/SimulationGeometry.jl:16-22)."""

    velocity: float
    start_time: float
    duration: float
    direction: Tuple[float, ...]


@dataclass(frozen=True)
class Geometry:
    """One input body: CSV path + group marker + particle type + optional motion
    (reference src/SimulationGeometry.jl:24-31)."""

    csv_file: str
    group_marker: int
    type: ParticleType
    motion: Optional[MotionDetails] = None


# ---------------------------------------------------------------------------
# Simulation metadata (reference src/SimulationMetaDataConfiguration.jl:28-67)
# ---------------------------------------------------------------------------
DEFAULT_OUTPUT_VARIABLES: Tuple[str, ...] = (
    "ChunkID",
    "Kernel",
    "KernelGradient",
    "Density",
    "Pressure",
    "Velocity",
    "Acceleration",
    "BoundaryBool",
    "ID",
    "Type",
    "GroupMarker",
    "GhostPoints",
    "GhostNormals",
)


@dataclass(frozen=True)
class SimulationMetaData:
    """Run metadata + the four static mode axes.  Mutable counters of the
    reference struct (Iteration, TotalTime, ...) live in the
    :class:`~sphexample_tpu_torch.state.SimulationState` instead."""

    simulation_name: str
    save_location: str
    dims: int = 2
    simulation_time: float = 1.0
    # Scalar output interval or explicit tuple of output times
    # (reference SimulationMetaDataConfiguration.jl:39, SPHCellList.jl:687-698).
    output_times: Union[float, Tuple[float, ...]] = 0.02
    shifting: ShiftingMode = ShiftingMode.NONE
    kernel_output: KernelOutputMode = KernelOutputMode.NONE
    mdbc: MDBCMode = MDBCMode.NONE
    log: LogMode = LogMode.STORE
    visualize_in_paraview: bool = True
    export_single_vtkhdf: bool = True
    export_grid_cells: bool = False
    output_variables: Tuple[str, ...] = DEFAULT_OUTPUT_VARIABLES
    open_log_file: bool = True
    # --- port knobs (no reference equivalent) ---
    dtype: str = "float32"  # state dtype; "float64" for parity runs
    grid_margin_cells: int = 6  # static-grid padding around initial extent
    block_size: int = 1024  # particle chunking of the plain pair sweep
    # the block sweep where the rows allow, False the cell sweep; both
    # compute every model and mode.  The one rule that chooses between them,
    # on one device and sharded: core/driver.py:choose_sweep_kernel
    block_sweep: bool = True
    # Steps per chunk of an output interval: the host checks progress, beats
    # the watchdog and fires the progress callback between chunks
    # (core/step.py:make_interval_fn); None = one chunk per interval.
    max_steps_per_call: Optional[int] = 64
    # Run the save callback on a worker thread, so that snapshot transfers
    # and file writes overlap the next interval (core/driver.py:_AsyncSaver).
    async_output: bool = True
    # Device-call watchdog (utils/watchdog.py): seconds a chunk or a snapshot
    # save may block before the run warns loudly - or, with watchdog_hard,
    # exits with code 86 so that a supervisor can resume from the last
    # checkpoint.
    device_call_timeout: Optional[float] = None
    watchdog_hard: bool = False

    def output_time_for(self, counter: int) -> float:
        """next_output_time (reference src/SPHCellList.jl:687-698)."""
        if isinstance(self.output_times, (int, float)):
            return float(self.output_times) * counter
        times = self.output_times
        # Reference indexes 1-based with guard `idx < length(times)`
        # (SPHCellList.jl:691-698): the *last* list entry is never used and the
        # final interval runs to SimulationTime - replicated faithfully.
        if counter < len(times):
            return float(times[counter - 1])
        return float(self.simulation_time)


def replace(obj, **kwargs):
    """Convenience re-export of dataclasses.replace for config tweaking."""
    return dataclasses.replace(obj, **kwargs)
