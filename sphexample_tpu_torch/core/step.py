"""The 12-stage symplectic predictor-corrector step (port of
``sphexample_tpu/core/step.py``), on one device or on one slab of a sharded
run.

Stage numbering mirrors the reference's timer taxonomy (SURVEY.md 3.2):

  00  dx accumulation (update_delta_x!, SPHCellList.jl:744,706-724)
  01  adaptive dt                         (:748)
  02  lazy neighbor rebuild when dx >= h  (:758-762)
  03  pressure from density               (:771)
  04  mDBC ghost-node density correction  (:772)
  05  first neighbor sweep                (:774)
  06  half step predictor                 (:778)
  07  clamp rho_half at boundary          (:781)
  03b pressure from rho_half              (:789)
  08  second neighbor sweep               (:790)
  09  clamp density at boundary           (:794)
  10  symplectic density corrector        (:796)
  11  full step corrector                 (:798)
  12  time/iteration bookkeeping          (:800)

Prescribed motion (``core/motion.py``) is applied once per half step, before
stage 03 and after stage 07; PLANAR shifting is part of stage 11.

The sharded step (``cfg.ctx`` sharded, ``parallel/``): every rank runs this
same function on its slab of the global cell-sorted order.  The reductions of
stages 00 and 01 go over all slabs, the rebuild is distributed
(``cell_list.rebuild_sharded``: local sort + 1-hop row migration; with
``cfg.halo == 0`` the replicated argsort of ``cell_list.rebuild``), the two
sweeps and the mDBC moments read a halo-extended window (``ops/halo.py``),
and the rebuild records in ``max_halo`` how far any window or migration
reached past a slab: the driver raises when that passes ``cfg.halo``.

The two sweeps go through ``cfg.sweep_kernel``: ``"block"``
(``ops/block_sweep.py``, one thread per self) or ``"cell"``
(``ops/cell_sweep.py``, one block per cell); both compute every model and
mode.  ``assemble_simulation`` chooses by the JAX package's rule.

The lazy rebuild is a host ``if`` on the displacement accumulator: one
device-to-host sync per step (the JAX package decides it on the device with
``lax.cond``).  The rule itself is unchanged - rebuilding every step would
change the sort order, the stale-cell stencil and so the physics.  In a
sharded run every rank takes the same branch: the accumulator is built from
the ``pmax`` of stage 00 alone, so all ranks hold the same value.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import MDBCMode, ShiftingMode, SimulationMetaData
from ..models import equations as eq
from ..ops import cell_list as cl
from ..ops.block_sweep import block_sweep, block_sweep_sharded
from ..ops.cell_sweep import cell_sweep, cell_sweep_sharded
from ..ops.interactions import PhysicsSpec
from ..ops.mdbc import mdbc_density_correction, mdbc_density_correction_sharded
from ..ops.timestep import adaptive_dt
from ..parallel.context import SINGLE, CommContext
from ..state import SimulationState
from ..utils.watchdog import DeviceWatchdog
from .motion import MotionTable, progress_motion


@dataclass(frozen=True)
class StepConfig:
    """Static bundle for the step function."""

    spec: PhysicsSpec
    meta: SimulationMetaData
    grid: cl.Grid
    block_size: int         # particle chunking of the plain sweep
    motion: MotionTable
    boundary_capacity: int  # number of mDBC ghost-carrying particles (static)
    sweep_kernel: str       # "block" or "cell" (core/driver.py chooses)
    ctx: CommContext = SINGLE  # sharded communication context (one rank's)
    # sharded: rows exchanged with each slab neighbour per sweep; 0 = the
    # window is the whole gathered array (parallel/mesh.py sizes it)
    halo: int = 0


_SWEEPS = {"block": block_sweep, "cell": cell_sweep}
_SWEEPS_SHARDED = {"block": block_sweep_sharded, "cell": cell_sweep_sharded}


def _sweep(cfg: StepConfig, p, cell_start, position, density, pressure, velocity):
    """One neighbor sweep through the chosen wrapper: its CUDA kernel on the
    card, its plain version for CPU tensors.  Sharded: the same kernel on
    the slab's halo-extended window."""
    sweeps = _SWEEPS_SHARDED if cfg.ctx.is_sharded else _SWEEPS
    sweep = sweeps.get(cfg.sweep_kernel)
    if sweep is None:
        raise ValueError(f"unknown sweep kernel {cfg.sweep_kernel!r}")
    if cfg.ctx.is_sharded:
        return sweep(cfg.spec, cfg.grid, cfg.halo, p, cell_start, position,
                     density, pressure, velocity, cfg.ctx, cfg.block_size)
    return sweep(cfg.spec, cfg.grid, p, cell_start, position, density,
                 pressure, velocity, cfg.block_size)


def _halo_need(cfg: StepConfig, p, cell_start, base: int, migration):
    """Halo telemetry of a rebuild: the furthest sorted-row reach of any live
    local stencil window past the slab's boundaries (empty segments have
    start == end == 0 and do not count), of the ghost windows under mDBC (a
    ghost sits up to about a cell from its particle), and the rebuild's
    migration count; the maximum over all slabs."""
    cap = p.capacity
    zero = torch.zeros((), dtype=torch.int32, device=p.device)

    def reach(coords, live):
        starts, ends = cl.row_segments(coords, cfg.grid, cell_start)
        live_seg = live[:, None] & (ends > starts)
        left = torch.max(torch.where(live_seg, base - starts, zero))
        right = torch.max(torch.where(live_seg, ends - (base + cap), zero))
        return torch.maximum(left, right)

    need = torch.maximum(reach(p.cell, p.active), zero)
    if cfg.meta.mdbc is MDBCMode.SIMPLE:
        has_g = torch.any(p.ghost_points != 0, dim=-1) & p.active
        g_coords = cl.clamp_coords(
            cl.cell_coords(p.ghost_points, cfg.spec.kernel.H_inv), cfg.grid)
        need = torch.maximum(need, reach(g_coords, has_g))
    return cfg.ctx.pmax(torch.maximum(need, migration)).to(torch.int32)


def _gravity_acc(cfg: StepConfig, particles, acc):
    """acc += gravity on the last axis scaled by GravityFactor
    (reference HalfTimeStep/FullTimeStep, SPHCellList.jl:630,647)."""
    g_last = cfg.spec.constants.g * particles.gravity_factor
    out = acc.clone()
    out[..., -1] += g_last
    return out


def sph_step(cfg: StepConfig, state: SimulationState, dx_acc):
    """One symplectic step.  Returns (new_state, new_dx_acc)."""
    spec = cfg.spec
    c = spec.constants
    kern = spec.kernel
    ctx = cfg.ctx
    p = state.particles

    # 00 - displacement accumulator: dx += 4 * max |pos_half - pos|
    disp2 = torch.sum((state.position_half - p.position) ** 2, dim=-1)
    dx_acc = dx_acc + 4.0 * torch.sqrt(ctx.pmax(torch.max(disp2)))

    # 01 - adaptive dt
    dt = adaptive_dt(p.position, p.velocity, p.acceleration, c, kern, ctx)
    dt2 = dt * 0.5

    # 02 - lazy rebuild when dx >= h (host decision: one sync per step)
    cell_start = state.cell_start
    occ, seg, ncc = state.max_occupancy, state.max_segment, state.occupied_cells
    escapes = state.grid_escapes
    halo_need = state.max_halo
    rebuilds = state.rebuilds
    if float(dx_acc) >= kern.h:
        # grid-escape telemetry: active particles whose UNCLAMPED cell coords
        # fall outside the static grid would be clamped into edge cells
        raw = cl.cell_coords(p.position, kern.H_inv)
        esc = ctx.psum(torch.sum(
            torch.any(raw != cl.clamp_coords(raw, cfg.grid), dim=-1) & p.active
        ).to(torch.int32))
        if ctx.is_sharded and cfg.halo > 0:
            p, cell_start, occ_new, migration = cl.rebuild_sharded(
                p, kern.H_inv, cfg.grid, ctx, cfg.halo)
        else:
            p, cell_start, occ_new = cl.rebuild(p, kern.H_inv, cfg.grid, ctx)
        cap = p.capacity
        base = ctx.rank() * cap
        p = p.replace(chunk_id=(base + torch.arange(cap, dtype=torch.int32,
                                                    device=p.device)) // cfg.block_size)
        if ctx.is_sharded and cfg.halo > 0:
            halo_need = torch.maximum(
                _halo_need(cfg, p, cell_start, base, migration), halo_need)
        counts = cell_start[1 : cfg.grid.ncells + 1] - cell_start[: cfg.grid.ncells]
        occ = torch.maximum(occ_new, occ)
        seg = torch.maximum(cl.max_row_segment(cell_start, cfg.grid), seg)
        ncc = torch.maximum(torch.sum(counts > 0).to(torch.int32), ncc)
        escapes = torch.maximum(esc, escapes)
        dx_acc = torch.zeros_like(dx_acc)
        rebuilds += 1

    # -- motion (first half, reference :765)
    pos, vel = progress_motion(cfg.motion, p, state.total_time, dt2)
    p = p.replace(position=pos, velocity=vel)

    # 03 - pressure from current density (quirk: computed BEFORE the mDBC
    # correction mutates density; the first sweep therefore pairs corrected
    # densities with pre-correction pressures, as the reference does)
    p = p.replace(pressure=eq.pressure(p.density, c))

    # 04 - mDBC: one call of the fused moment-and-correction kernel on the
    # card, the plain version for CPU tensors (``ops.mdbc.correct_density``);
    # no host sync
    if cfg.meta.mdbc is MDBCMode.SIMPLE and ctx.is_sharded:
        p = p.replace(density=mdbc_density_correction_sharded(
            spec, cfg.grid, p, cell_start, cfg.boundary_capacity, ctx, cfg.halo))
    elif cfg.meta.mdbc is MDBCMode.SIMPLE:
        p = p.replace(density=mdbc_density_correction(
            spec, cfg.grid, p, cell_start, cfg.boundary_capacity))

    # 05 - first neighbor sweep (predictor forces)
    out1 = _sweep(cfg, p, cell_start, p.position, p.density, p.pressure,
                  p.velocity)

    # 06 - half step predictor (reference HalfTimeStep, :624-638)
    acc = _gravity_acc(cfg, p, out1.acceleration)
    ml = p.motion_limiter[:, None]
    pos_half = p.position + p.velocity * dt2 * ml
    vel_half = p.velocity + acc * dt2 * ml
    rho_half = p.density + out1.drhodt * dt2
    p = p.replace(acceleration=acc)

    # 07 - clamp rho_half at boundaries
    rho_half = eq.limit_density_at_boundary(rho_half, c.rho0, p.motion_limiter)

    # -- motion (second half, reference :787); the second sweep still reads
    # the pos_half of stage 06, taken before this advance
    pos, vel = progress_motion(cfg.motion, p, state.total_time, dt2)
    p = p.replace(position=pos, velocity=vel)

    # 03b - pressure from rho_half
    p = p.replace(pressure=eq.pressure(rho_half, c))

    # 08 - second neighbor sweep (corrector forces, on half-step fields)
    out2 = _sweep(cfg, p, cell_start, pos_half, rho_half, p.pressure, vel_half)

    # 09 - clamp density at boundaries (before the corrector, reference :794)
    density = eq.limit_density_at_boundary(p.density, c.rho0, p.motion_limiter)

    # 10 - symplectic density corrector
    density = eq.density_epsi(density, out2.drhodt, rho_half, dt)

    # 11 - full step corrector (reference FullTimeStep, :640-677)
    acc2 = _gravity_acc(cfg, p, out2.acceleration)
    vel_new = p.velocity + acc2 * dt * ml
    mid_vel = 0.5 * (vel_new + (vel_new - acc2 * dt * ml))
    dpos = mid_vel * dt
    if cfg.meta.shifting is ShiftingMode.PLANAR:
        # Fickian shifting with free-surface scaling (reference :654-677):
        # A=2, A_FST=0, A_FSM=D; shift disabled where the scaling is negative.
        A_coef, A_fst = 2.0, 0.0
        A_fsm = float(p.dims)
        a_fsc = (out2.div_r - A_fst) / (A_fsm - A_fst)
        vmag = torch.sqrt(torch.sum(vel_new * vel_new, dim=-1))
        delta_x = (-a_fsc * A_coef * kern.h * vmag * dt)[:, None] * out2.grad_c
        delta_x = torch.where(a_fsc[:, None] < 0, torch.zeros_like(delta_x), delta_x)
        dpos = dpos + delta_x
    pos_new = p.position + dpos * ml

    updates = dict(position=pos_new, velocity=vel_new, acceleration=acc2,
                   density=density)
    if out2.kernel_w is not None:
        updates["kernel_w"] = out2.kernel_w
        updates["kernel_grad"] = out2.kernel_grad
    p = p.replace(**updates)

    # 12 - bookkeeping
    new_state = state.replace(
        particles=p,
        cell_start=cell_start,
        total_time=state.total_time + dt,
        current_dt=dt,
        iteration=state.iteration + 1,
        max_occupancy=occ,
        max_segment=seg,
        occupied_cells=ncc,
        position_half=pos_half,
        grid_escapes=escapes,
        max_halo=halo_need,
        rebuilds=rebuilds,
    )
    return new_state, dx_acc


def _initial_dx_acc(cfg: StepConfig, state: SimulationState):
    # 1 + h: the first step of every run/interval rebuilds (reference :739)
    return torch.full((), 1.0 + cfg.spec.kernel.h, dtype=state.total_time.dtype,
                      device=state.total_time.device)


def _check_interval_progress(state: SimulationState, t_out, it_before: int) -> None:
    """Fail loudly instead of spinning when the state diverges: a NaN
    ``total_time`` ends the step loop (``t <= t_out`` is false) without
    crossing the output time."""
    t = float(state.total_time)
    if not math.isfinite(t):
        raise FloatingPointError(
            f"simulation diverged: total_time is {t} at iteration "
            f"{int(state.iteration)}"
        )
    if t <= float(t_out) and int(state.iteration) == it_before:
        raise FloatingPointError(
            f"simulation stalled: no steps taken at t={t} < t_out="
            f"{float(t_out)} (non-finite dt or state)"
        )


def make_interval_fn(cfg: StepConfig):
    """The per-output-interval function: steps while ``total_time <= t_out``
    (reference SPHCellList.jl:742), with the displacement accumulator freshly
    set to 1 + h so the first step of every interval rebuilds (:739).  Reads
    ``total_time`` on the host once per step.

    The steps go in chunks of at most ``meta.max_steps_per_call`` (the JAX
    package's device programs, ``sphexample_tpu/core/step.py:464-513``); the
    accumulator carries across chunks, so the trajectory is that of one
    unchunked loop.  Between chunks the host checks progress
    (:func:`_check_interval_progress`) and fires ``progress(state)`` after
    every chunk but the last - the analog of the reference's in-interval
    ProgressMeter spinner (SPHCellList.jl:870-907).  With
    ``meta.device_call_timeout`` set, a watchdog is armed around every chunk
    after this function's first (which may build and load the kernels) and
    warns - or, with ``meta.watchdog_hard``, exits with code 86 so that a
    supervisor can resume from the last checkpoint - when one blocks longer
    (utils/watchdog.py).  In a sharded run every rank runs this loop on its
    slab; rank 0's speaks for the run (progress and watchdog)."""
    cap = cfg.meta.max_steps_per_call
    wd_timeout = cfg.meta.device_call_timeout
    lead = cfg.ctx.rank() == 0
    warm = [False]

    def interval(state: SimulationState, t_out: float, progress=None) -> SimulationState:
        wd = None
        if wd_timeout and lead:
            wd = DeviceWatchdog(wd_timeout, hard=cfg.meta.watchdog_hard,
                                context="device chunk")
        try:
            dx = _initial_dx_acc(cfg, state)
            while True:
                it_before = int(state.iteration)
                if wd is not None and warm[0]:
                    wd.arm(f"from iteration {it_before}")
                k = 0
                while float(state.total_time) <= t_out and (cap is None or k < cap):
                    state, dx = sph_step(cfg, state, dx)
                    k += 1
                done = float(state.total_time) > t_out
                if wd is not None:
                    wd.disarm()
                warm[0] = True
                _check_interval_progress(state, t_out, it_before)
                if done:
                    return state
                if progress is not None and lead:
                    progress(state)
        finally:
            if wd is not None:
                wd.stop()

    return interval


def make_fixed_steps_fn(cfg: StepConfig, n_steps: int):
    """Run exactly ``n_steps`` steps (benchmark and test helper)."""

    def run(state: SimulationState) -> SimulationState:
        dx = _initial_dx_acc(cfg, state)
        for _ in range(n_steps):
            state, dx = sph_step(cfg, state, dx)
        return state

    return run
