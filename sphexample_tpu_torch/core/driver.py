"""Host driver: build the simulation, run output intervals (port of
``sphexample_tpu/core/driver.py``).

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises when no GPU is present.  Only an explicit ``device="cpu"`` runs on
the CPU (the plain versions of the kernels).  ``assemble_simulation`` builds
the motion table from ``geometries`` and chooses the sweep kernel
(:func:`choose_sweep_kernel`).  A simulation sharded by
``parallel.mesh.shard_simulation`` carries the tuple of its slab states;
``run_simulation`` steps it through the same loop, reads the replicated
scalars from rank 0's state and raises when a stencil window or a row
migration reached past the halo (``max_halo > cfg.halo``);
:func:`gather_state` gives the one global state.  Still missing: re-grid and
replay of an interval on grid escapes (and, sharded, re-sharding with a
larger halo), output and the asynchronous saver, checkpoints; the port's
kernels have no capacity windows, so grid escapes and the halo are the only
overflows left to guard.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import (
    DensityDiffusionModel,
    Geometry,
    MDBCMode,
    SimulationConstants,
    SimulationMetaData,
    SPHKernelInstance,
    ViscosityModel,
)
from ..io.csv_io import load_boundary_normals, load_geometries
from ..models import equations as eq
from ..ops import cell_list as cl
from ..ops.block_sweep import BLOCK_CAP_LIMIT
from ..ops.interactions import PhysicsSpec
from ..state import SimulationState, allocate_particles, gather_state  # noqa: F401
from .motion import build_motion_table
from .step import StepConfig, make_interval_fn


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  Raises when CUDA is asked for and absent:
    the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def choose_sweep_kernel(block_sweep: bool, capacity: int) -> str:
    """The sweep kernel of a deck, by the JAX package's own rule
    (``sphexample_tpu/core/driver.py:149-169``): ``"block"`` when
    ``meta.block_sweep`` is set and the particle capacity is within
    ``BLOCK_CAP_LIMIT``, else ``"cell"``.  The model set plays no part: both
    kernels compute every model and mode."""
    return "block" if block_sweep and capacity <= BLOCK_CAP_LIMIT else "cell"


@dataclass
class Simulation:
    """A ready-to-run simulation: static config + device state (sharded:
    the tuple of slab states, and the mesh they live on)."""

    cfg: StepConfig
    state: SimulationState
    meta: SimulationMetaData
    n_live: int
    interval_fn: Callable = None
    mesh: object = None

    def __post_init__(self):
        if self.interval_fn is None:
            self.interval_fn = make_interval_fn(self.cfg)


def assemble_simulation(
    position: np.ndarray,
    density: np.ndarray,
    ptype: np.ndarray,
    group_marker: np.ndarray,
    idp: np.ndarray,
    meta: SimulationMetaData,
    constants: SimulationConstants,
    kernel: SPHKernelInstance,
    viscosity: ViscosityModel,
    diffusion: DensityDiffusionModel,
    *,
    ghost_points: Optional[np.ndarray] = None,
    ghost_normals: Optional[np.ndarray] = None,
    geometries: Sequence[Geometry] = (),
    capacity: Optional[int] = None,
    device=None,
) -> Simulation:
    """Allocate the state on ``device`` from host arrays and assemble the
    step config (static grid bounds from the initial positions, the motion
    table, the mDBC ghost count, the sweep kernel)."""
    dev = resolve_device(device)
    n = len(density)

    grid = cl.grid_from_positions(position, kernel.H_inv, meta.grid_margin_cells)
    particles = allocate_particles(position, density, ptype, group_marker, idp,
                                   device=dev, dtype=meta.dtype, capacity=capacity)
    dtype = particles.position.dtype

    n_ghost = 0
    if ghost_points is not None:
        # Reference LoadMDBCNormals! (SPHCellList.jl:507-524): ghost rows map
        # 1:1 onto the first particles in ID order (the boundary body loads
        # first and IDs are contiguous from 1).
        n_ghost = len(ghost_points)
        if n_ghost > n:
            raise ValueError(f"{n_ghost} ghost rows for {n} particles")
        gp = np.zeros((particles.capacity, meta.dims))
        gn = np.zeros((particles.capacity, meta.dims))
        gp[:n_ghost] = ghost_points
        gn[:n_ghost] = ghost_normals
        particles = particles.replace(
            ghost_points=torch.as_tensor(gp).to(device=dev, dtype=dtype),
            ghost_normals=torch.as_tensor(gn).to(device=dev, dtype=dtype),
        )

    # initial pressure (reference RunSimulation, SPHCellList.jl:835)
    particles = particles.replace(pressure=eq.pressure(particles.density, constants))

    spec = PhysicsSpec(
        constants=constants,
        kernel=kernel,
        viscosity=viscosity,
        diffusion=diffusion,
        shifting=meta.shifting,
        kernel_output=meta.kernel_output,
    )
    cfg = StepConfig(spec=spec, meta=meta, grid=grid, block_size=meta.block_size,
                     motion=build_motion_table(geometries, meta.dims),
                     boundary_capacity=max(1, n_ghost),
                     sweep_kernel=choose_sweep_kernel(meta.block_sweep,
                                                      particles.capacity))

    def scalar(dt):
        return torch.zeros((), dtype=dt, device=dev)

    state = SimulationState(
        particles=particles,
        cell_start=torch.zeros((grid.ncells + 2,), dtype=torch.int32, device=dev),
        total_time=scalar(dtype),
        current_dt=scalar(dtype),
        iteration=scalar(torch.int32),
        max_occupancy=scalar(torch.int32),
        max_segment=scalar(torch.int32),
        occupied_cells=scalar(torch.int32),
        position_half=torch.zeros_like(particles.position),
        grid_escapes=scalar(torch.int32),
        max_halo=scalar(torch.int32),
    )
    return Simulation(cfg=cfg, state=state, meta=meta, n_live=n)


def build_simulation(
    geometries: Sequence[Geometry],
    meta: SimulationMetaData,
    constants: SimulationConstants,
    kernel: SPHKernelInstance,
    viscosity: ViscosityModel,
    diffusion: DensityDiffusionModel,
    particle_normals_path: Optional[str] = None,
    capacity: Optional[int] = None,
    device=None,
) -> Simulation:
    """Load CSV geometry and assemble a ready-to-run simulation."""
    position, density, ptype, group_marker, idp = load_geometries(geometries, meta.dims)

    ghost_points = ghost_normals = None
    if meta.mdbc is MDBCMode.SIMPLE and particle_normals_path is not None:
        _, ghost_points, ghost_normals = load_boundary_normals(
            particle_normals_path, meta.dims
        )

    return assemble_simulation(
        position, density, ptype, group_marker, idp,
        meta, constants, kernel, viscosity, diffusion,
        ghost_points=ghost_points, ghost_normals=ghost_normals,
        geometries=geometries, capacity=capacity, device=device,
    )


def run_simulation(
    sim: Simulation,
    log_callback: Optional[Callable[[dict], None]] = None,
    max_intervals: Optional[int] = None,
) -> Simulation:
    """Outer host loop over output intervals (reference SPHCellList.jl:881-929).

    Raises when particles escaped the static grid during an interval (they
    were clamped into edge cells: wrong physics), or, in a sharded run, when
    a stencil window or a row migration reached past the halo (the clamped
    window dropped pairs); re-gridding or re-sharding and replaying the
    interval is a later slice of the port."""
    meta = sim.meta
    state = sim.state
    sharded = isinstance(state, tuple)
    counter = 1
    intervals = 0
    t_wall0 = time.perf_counter()
    while True:
        t_out = meta.output_time_for(counter)
        prev_iter = int(_replicated(state).iteration)
        states = sim.interval_fn(state, t_out)
        state = _replicated(states)
        check_halo(sim.cfg, state)
        esc = int(state.grid_escapes)
        if esc > 0:
            raise RuntimeError(
                f"{esc} particle(s) escaped the static cell grid and were "
                f"clamped into edge cells (wrong physics); raise "
                f"grid_margin_cells"
            )
        counter += 1
        intervals += 1
        tt = float(state.total_time)
        if log_callback is not None:
            log_callback(dict(
                counter=counter,
                total_time=tt,
                iteration=int(state.iteration),
                steps_in_interval=int(state.iteration) - prev_iter,
                dt=float(state.current_dt),
                wall_time=time.perf_counter() - t_wall0,
            ))
        if tt > meta.simulation_time:
            break
        if max_intervals is not None and intervals >= max_intervals:
            break
        state = states
    sim.state = states
    return sim


def _replicated(state) -> SimulationState:
    """The state whose scalars speak for the run: rank 0's slab state of a
    sharded run (the scalars are replicated), else the state itself."""
    return state[0] if isinstance(state, tuple) else state


def check_halo(cfg: StepConfig, state) -> None:
    """The halo guard of a sharded run: a window that the clamp cut dropped
    pairs without a sign, so an interval whose ``max_halo`` passed the halo
    is not to be believed."""
    state = _replicated(state)
    if cfg.halo and int(state.max_halo) > cfg.halo:
        raise RuntimeError(
            f"stencil windows reached {int(state.max_halo)} sorted rows past "
            f"a slab boundary, exceeding the halo capacity {cfg.halo}; "
            f"re-shard with a larger halo")
