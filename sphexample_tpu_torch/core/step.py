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

Stage 02, the lazy rebuild (:func:`_lazy_rebuild`), is the JAX package's
``lax.cond`` on the displacement accumulator.  The rule itself is unchanged -
rebuilding every step would change the sort order, the stale-cell stencil
and so the physics.  A plain call of :func:`sph_step` decides it on the host
(one device-to-host read).  A chunk of steps (:func:`make_chunk_body`, the
JAX ``lax.while_loop``) decides it on the device: on the card the chunk is
one CUDA graph (``csrc/chunk_graph.cu``) in which every step is the body of
an IF node on ``total_time <= t_out`` and the rebuild the body of an IF node
on ``dx_acc >= h``, both compared in f64 as the host compares them, and
:func:`make_chunk_loop` reads the host once per chunk.  The JAX package
compares in the state's dtype; a value between f32(h) and h is where the two
could part (ROADMAP §C).  In a sharded run every rank takes the same branch:
the accumulator is built from the ``pmax`` of stage 00 alone, so all ranks
hold the same value; the sharded ranks stay on the host loop
(:func:`make_chunk_body` chooses by ``cfg.ctx``), since a graph cannot
capture the host barrier at which they meet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..config import MDBCMode, ShiftingMode, SimulationMetaData
from ..models import equations as eq
from ..ops import cell_list as cl
from ..ops import launch_count
from ..ops.block_sweep import block_sweep, block_sweep_sharded
from ..ops.cell_sweep import cell_sweep, cell_sweep_sharded
from ..ops.interactions import PhysicsSpec
from ..ops.mdbc import mdbc_density_correction, mdbc_density_correction_sharded
from ..ops.timestep import adaptive_dt
from ..parallel.context import SINGLE, CommContext
from ..state import (Particles, SimulationState, clone_state, copy_state_,
                     state_leaves)
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
    # stage 02's branch(flag, body) inside a chunk (make_chunk_body gives it
    # its steps); None: a host ``if`` (_lazy_rebuild)
    branch: Optional[Callable] = None


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


class Stage02(NamedTuple):
    """What stage 02 hands on to the rest of the step: the particles (sorted
    anew after a rebuild), the cell list, the telemetry maxima, the
    displacement accumulator and the rebuild count."""

    particles: Particles
    cell_start: torch.Tensor
    max_occupancy: torch.Tensor
    max_segment: torch.Tensor
    occupied_cells: torch.Tensor
    grid_escapes: torch.Tensor
    max_halo: torch.Tensor
    dx_acc: torch.Tensor
    rebuilds: torch.Tensor


def _rebuild(cfg: StepConfig, keep: Stage02) -> Stage02:
    """The rebuild branch of stage 02 (JAX ``do_rebuild``): re-sort the
    particles by cell, rebuild the cell list, take the telemetry maxima with
    ``keep``'s values, reset the accumulator and count the rebuild.  Every
    result is a new tensor."""
    kern, ctx = cfg.spec.kernel, cfg.ctx
    p = keep.particles
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
    halo_need = keep.max_halo
    if ctx.is_sharded and cfg.halo > 0:
        halo_need = torch.maximum(_halo_need(cfg, p, cell_start, base, migration),
                                  halo_need)
    counts = cell_start[1 : cfg.grid.ncells + 1] - cell_start[: cfg.grid.ncells]
    return Stage02(
        particles=p, cell_start=cell_start,
        max_occupancy=torch.maximum(occ_new, keep.max_occupancy),
        max_segment=torch.maximum(cl.max_row_segment(cell_start, cfg.grid),
                                  keep.max_segment),
        occupied_cells=torch.maximum(torch.sum(counts > 0).to(torch.int32),
                                     keep.occupied_cells),
        grid_escapes=torch.maximum(esc, keep.grid_escapes),
        max_halo=halo_need, dx_acc=torch.zeros_like(keep.dx_acc),
        rebuilds=keep.rebuilds + 1)


def _write_stage02(dst: Stage02, src: Stage02) -> None:
    """``src`` written into ``dst``'s tensors, in place."""
    pairs = list(zip(dst.particles.tensors(), src.particles.tensors()))
    pairs += list(zip(dst[1:], src[1:]))
    for d, s in pairs:
        d.copy_(s)


def _lazy_rebuild(cfg: StepConfig, state: SimulationState, p, dx_acc,
                  branch=None) -> Stage02:
    """Stage 02: rebuild the cell list when ``dx_acc >= h`` (the JAX
    package's ``lax.cond(dx_acc >= kern.h, do_rebuild, no_rebuild, p)``).

    With no ``branch`` (a plain call, the sharded ranks) it is a host ``if``
    on ``float(dx_acc)``: one device-to-host read, and a rebuild hands on
    new tensors.  A chunk (:func:`make_chunk_body`) gives its steps a
    ``branch(flag, body)`` (``StepConfig.branch``): the decision is then
    ``dx_acc.double() >= h`` on the device, the same f64 comparison, and
    ``body`` writes the rebuild in place into the tensors that are handed on
    either way (the chunk's buffers); on the card ``branch`` captures
    ``body`` as a CUDA graph IF node on the flag, on the CPU it is a host
    ``if`` on it."""
    keep = Stage02(p, state.cell_start, state.max_occupancy, state.max_segment,
                   state.occupied_cells, state.grid_escapes, state.max_halo, dx_acc,
                   state.rebuilds)
    h = cfg.spec.kernel.h
    if branch is not None:
        branch(dx_acc.double() >= h, lambda: _write_stage02(keep, _rebuild(cfg, keep)))
        return keep
    if float(dx_acc) >= h:
        return _rebuild(cfg, keep)
    return keep


def sph_step(cfg: StepConfig, state: SimulationState, dx_acc):
    """One symplectic step.  Returns (new_state, new_dx_acc).  Inside a
    chunk ``cfg.branch`` takes stage 02's decision (:func:`_lazy_rebuild`)."""
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

    # 02 - lazy rebuild when dx >= h
    st = _lazy_rebuild(cfg, state, p, dx_acc, cfg.branch)
    p, cell_start, dx_acc = st.particles, st.cell_start, st.dx_acc

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
        max_occupancy=st.max_occupancy,
        max_segment=st.max_segment,
        occupied_cells=st.occupied_cells,
        position_half=pos_half,
        grid_escapes=st.grid_escapes,
        max_halo=st.max_halo,
        rebuilds=st.rebuilds,
    )
    return new_state, dx_acc


def _initial_dx_acc(cfg: StepConfig, state: SimulationState):
    # 1 + h: the first step of every run/interval rebuilds (reference :739)
    return torch.full((), 1.0 + cfg.spec.kernel.h, dtype=state.total_time.dtype,
                      device=state.total_time.device)


def _check_interval_progress(t: float, it: int, t_out, it_before: int) -> None:
    """Fail loudly instead of spinning when the state diverges: a NaN
    ``total_time`` ends the step loop (``t <= t_out`` is false) without
    crossing the output time.  ``t`` and ``it`` are the state's total time
    and iteration as the host read them after a chunk."""
    if not math.isfinite(t):
        raise FloatingPointError(
            f"simulation diverged: total_time is {t} at iteration {it}")
    if t <= float(t_out) and it == it_before:
        raise FloatingPointError(
            f"simulation stalled: no steps taken at t={t} < t_out="
            f"{float(t_out)} (non-finite dt or state)"
        )


def _host_read(state: SimulationState, prev_iteration) -> tuple:
    """The one host read of a chunk: (total_time, iteration, the iteration
    ``prev_iteration`` held), in one device-to-host copy.  The same copy
    brings the launch counters of the state's device, where a chunk graph
    armed them, and folds them into the kernel wrappers' counts
    (``ops/launch_count.py``)."""
    dev = state.total_time.device
    counters = launch_count.counters(dev)
    vals = torch.stack([state.total_time.double(), state.iteration.double(),
                        prev_iteration.double()])
    if counters is not None:
        vals = torch.cat([vals, counters.double()])
    read = vals.tolist()
    if counters is not None:
        launch_count.fold(dev, read[3:])
    return read[0], int(read[1]), int(read[2])


# steps per replay of a chunk graph when ``meta.max_steps_per_call`` is None
# (the JAX loop is then unbounded): the graph is replayed until the interval
# ends, with no progress call in between
UNBOUNDED_GRAPH_STEPS = 64
_NO_STOP = 2 ** 31 - 1    # the iteration bound of an interval's chunks


def _host_branch(flag, body) -> None:
    """A chunk's stage 02 branch on CPU tensors: a host ``if`` on the flag."""
    if bool(flag):
        body()


def _signature(state: SimulationState) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) for a in state_leaves(state))


class _Buffers:
    """What a chunk owns: the state its steps read and write in place, the
    displacement accumulator, the output time (f64), the iteration bound and
    the two decision flags.  Filled from the caller's tensors before a chunk
    runs and copied out after it, so that no state handed in or out shares
    storage with them."""

    def __init__(self, state: SimulationState):
        dev = state.total_time.device
        self.signature = _signature(state)
        self.state = clone_state(state)
        self.dx = torch.zeros((), dtype=state.total_time.dtype, device=dev)
        self.t_out = torch.zeros((), dtype=torch.float64, device=dev)
        self.stop = torch.zeros((), dtype=state.iteration.dtype, device=dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.rebuild = torch.zeros((), dtype=torch.bool, device=dev)

    def load(self, state, t_out: float, dx_acc, stop: Optional[int]) -> None:
        copy_state_(self.state, state)
        self.dx.copy_(dx_acc)
        self.t_out.fill_(float(t_out))
        self.stop.fill_(_NO_STOP if stop is None else int(stop))

    def set_live(self) -> None:
        """The guard of the next step: ``total_time <= t_out`` (in f64, as
        the eager loop compares on the host) and ``iteration < stop``."""
        s = self.state
        self.live.copy_((s.total_time.double() <= self.t_out) & (s.iteration < self.stop))

    def step(self, cfg: StepConfig) -> None:
        """One step on the buffers, then the next step's guard.  ``cfg``
        carries the chunk's stage 02 branch (``cfg.branch``)."""
        new, dx = sph_step(cfg, self.state, self.dx)
        copy_state_(self.state, new)
        self.dx.copy_(dx)
        self.set_live()

    def out(self):
        return clone_state(self.state), self.dx.clone()


class _Pieces:
    """PyTorch captures into one memory pool, each kept as its
    ``cudaGraph_t`` (``keep_graph``): the pieces of a chunk graph, captured
    in the order they run, so that the pool's memory is reused only as a
    replay would reuse it."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.open = None

    def begin(self) -> None:
        self.open = torch.cuda.CUDAGraph(keep_graph=True)
        self.open.capture_begin(pool=self.pool)

    def end(self) -> int:
        g, self.open = self.open, None
        g.capture_end()
        self.graphs.append(g)
        return g.raw_cuda_graph()

    def abort(self) -> None:
        if self.open is not None:
            g, self.open = self.open, None
            try:
                g.capture_end()
            except RuntimeError:
                pass


class _StepCapture:
    """Stage 02's branch while a step is captured: the flag goes into the
    chunk's ``rebuild`` buffer, the step's head piece ends, the rebuild is
    captured as its own piece (the IF node's body) and the tail piece
    begins."""

    def __init__(self, pieces: _Pieces, flag_buf):
        self.pieces, self.flag_buf = pieces, flag_buf
        self.head = self.body = None

    def __call__(self, flag, body) -> None:
        if self.head is not None:
            raise RuntimeError("a captured step takes stage 02's branch once")
        self.flag_buf.copy_(flag)
        self.head = self.pieces.end()
        self.pieces.begin()
        body()
        self.body = self.pieces.end()
        self.pieces.begin()


class ChunkGraph:
    """The chunk of ``steps`` guarded steps as one CUDA graph on the card
    (``csrc/chunk_graph.cu``): one step is captured once, in three pieces
    (its head up to stage 02's decision, the rebuild, its tail), and the
    graph holds it ``steps`` times, each under an IF node on the guard and
    with the rebuild under an IF node on ``dx_acc >= h``.  Nothing in a step
    depends on its place in the chunk: the buffers are fixed and every
    temporary dies inside the step.  Built once for a state's shapes,
    replayed per chunk.  Holds what the chip check reads: ``capture_s``,
    ``instantiate_s``, ``nodes_per_step`` (the step's three pieces, two set
    kernels and two IF nodes) and ``memory_bytes`` (the device memory
    reserved while it was built, its pool included)."""

    def __init__(self, cfg: StepConfig, steps: int, buf: _Buffers):
        """``buf``: the chunk's buffers, loaded, their next step live.  That
        step runs first, eagerly, on a side stream (the warm-up: what the
        step caches on the device is made before the capture, a rebuild
        included when the chunk starts an interval); then the next step is
        captured on the same stream, which runs nothing."""
        from ..ops._build import load_all, load_library

        dev = buf.state.total_time.device
        self.steps, self.device, self.buf = steps, dev, buf
        load_all()
        self._lib = lib = load_library("chunk_graph")
        launch_count.arm(dev)
        mem0 = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        pieces = _Pieces()
        # a graph freed by the garbage collector during the capture would
        # destroy CUDA objects while the stream captures: collect first, and
        # not while capturing
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side):
                buf.step(dataclasses.replace(cfg, branch=_host_branch))
                side.synchronize()
                try:
                    head, step_head, body, tail = self._capture(cfg, pieces)
                except BaseException:
                    pieces.abort()          # on the capture's own stream
                    raise
        except Exception as e:
            raise RuntimeError(f"chunk graph capture failed: {e}") from e
        finally:
            gc.enable()
            torch.cuda.current_stream(dev).wait_stream(side)
        self._pieces = pieces.graphs      # their pool backs the graph's memory
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        t0 = time.perf_counter()
        err = lib.sph_chunk_graph_build(steps, head, step_head, body, tail,
                                        buf.live.data_ptr(), buf.rebuild.data_ptr(),
                                        ctypes.byref(graph), ctypes.byref(exe))
        if err != 0:
            raise RuntimeError("chunk graph instantiation failed: "
                               f"{lib.sph_chunk_graph_error_string(err).decode()}")
        self._graph, self._exec = graph.value, exe.value
        err = lib.sph_chunk_graph_upload(self._exec, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("chunk graph upload failed: "
                               f"{lib.sph_chunk_graph_error_string(err).decode()}")
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0
        self.nodes_per_step = 4 + sum(self._nodes(g) for g in (step_head, body, tail))
        self.memory_bytes = torch.cuda.memory_reserved(dev) - mem0

    def _capture(self, cfg, pieces):
        """Capture, on the current (side) stream, the chunk's first guard
        and one step in its three pieces.  Returns their graphs (guard, step
        head, rebuild, step tail)."""
        buf = self.buf
        t0 = time.perf_counter()
        pieces.begin()
        buf.set_live()
        head = pieces.end()
        split = _StepCapture(pieces, buf.rebuild)
        pieces.begin()
        buf.step(dataclasses.replace(cfg, branch=split))
        tail = pieces.end()
        if split.body is None:
            raise RuntimeError("stage 02 was not captured as a branch")
        self.capture_s = time.perf_counter() - t0
        return head, split.head, split.body, tail

    def _nodes(self, graph) -> int:
        n = ctypes.c_int()
        self._lib.sph_chunk_graph_nodes(graph, ctypes.byref(n))
        return n.value

    def replay(self):
        """One replay on the current stream of the loaded buffers, then the
        buffers out into new tensors.  No host read."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.sph_chunk_graph_launch(self._exec, stream)
        if err != 0:
            raise RuntimeError("chunk graph launch failed: "
                               f"{self._lib.sph_chunk_graph_error_string(err).decode()}")
        return self.buf.out()

    def __del__(self):
        # an executable still running is freed when it completes (CUDA's
        # rule); no synchronisation here, which a capture would not allow
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_exec", None):
            lib.sph_chunk_graph_destroy(self._graph, self._exec)


def make_chunk_body(cfg: StepConfig):
    """One chunk: at most ``meta.max_steps_per_call`` steps
    (:data:`UNBOUNDED_GRAPH_STEPS` when None) while ``total_time <= t_out``
    (JAX ``make_chunk_body``, ``sphexample_tpu/core/step.py:437-461``).
    Returns ``chunk(state, t_out, dx_acc, stop=None) -> (state, dx_acc)``;
    ``stop`` also ends it at that iteration (:func:`make_fixed_steps_fn`).
    The chunk copies the state it is given into buffers of its own
    (:class:`_Buffers`), steps them in place and hands out new tensors
    copied from them.

    On the card every chunk is one replay of a :class:`ChunkGraph`: every
    step is the body of an IF node on ``total_time <= t_out``, evaluated on
    the device in f64, and stage 02's rebuild the body of an IF node on
    ``dx_acc >= h``; a skipped step leaves every buffer as it was.  No host
    read happens in a chunk: the caller reads the state once after it.  The
    first chunk that takes a step (and the first for a state of other
    shapes) builds the graph: it reads the guard on the host, runs its first
    step eagerly (the warm-up) and the rest of its steps in the graph.  A
    capture or instantiation that fails raises; the eager loop is never run
    in its place.  CPU tensors: the same guarded steps run eagerly on the
    same buffers, each decision a host ``if``.  ``chunk.graph`` is the
    graph (None before the card's first chunk), ``chunk.buffers`` the
    buffers.

    A sharded config (``cfg.ctx``) gets :func:`_eager_chunk` instead: its
    ranks are threads that meet at a host barrier inside the step, which a
    graph cannot hold."""
    if cfg.ctx.is_sharded:
        return _eager_chunk(cfg)
    steps = cfg.meta.max_steps_per_call or UNBOUNDED_GRAPH_STEPS
    host_cfg = dataclasses.replace(cfg, branch=_host_branch)

    def chunk(state, t_out, dx_acc, stop=None):
        dev = state.total_time.device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        if chunk.buffers is None or chunk.buffers.signature != _signature(state):
            chunk.graph = None
            chunk.buffers = _Buffers(state)
        buf = chunk.buffers
        buf.load(state, t_out, dx_acc, stop)
        if chunk.graph is not None:
            return chunk.graph.replay()
        buf.set_live()
        if dev.type == "cuda":
            if not bool(buf.live):
                return buf.out()
            it0 = int(buf.state.iteration)
            chunk.graph = ChunkGraph(cfg, steps, buf)     # runs the first step
            # the rest of this chunk: ``steps`` in all from ``it0``
            buf.stop.fill_(min(_NO_STOP if stop is None else int(stop), it0 + steps))
            buf.set_live()
            return chunk.graph.replay()
        for _ in range(steps):
            if not bool(buf.live):
                break
            buf.step(host_cfg)
        return buf.out()

    chunk.graph = chunk.buffers = None
    return chunk


def _eager_chunk(cfg: StepConfig):
    """A chunk as a host loop of ``sph_step`` calls, each step's guard and
    its stage 02 decision a host read: what :func:`make_chunk_body` gives a
    sharded config.  The signature of its chunk."""
    cap = cfg.meta.max_steps_per_call

    def chunk(state, t_out, dx_acc, stop=None):
        k = 0
        while (float(state.total_time) <= t_out and (cap is None or k < cap)
               and (stop is None or int(state.iteration) < stop)):
            state, dx_acc = sph_step(cfg, state, dx_acc)
            k += 1
        return state, dx_acc

    chunk.graph = chunk.buffers = None
    return chunk


def make_chunk_loop(cfg: StepConfig, chunk):
    """The per-output-interval host loop over ``chunk(state, t_out, dx_acc)``
    calls (JAX ``make_chunk_loop``, ``sphexample_tpu/core/step.py:464-513``):
    the displacement accumulator is set to 1 + h at the interval's start, so
    that its first step rebuilds (reference :739), and carries across chunks,
    so the trajectory is that of one unchunked loop.  After every chunk the
    host reads the state once (:func:`_host_read`: total time, iteration and
    the launch counters), checks progress (:func:`_check_interval_progress`)
    and, when ``meta.max_steps_per_call`` bounds the chunks, fires
    ``progress(state)`` after every chunk but the last - the analog of the
    reference's in-interval ProgressMeter spinner (SPHCellList.jl:870-907).
    With ``meta.device_call_timeout`` set, a watchdog is armed around every
    chunk after this function's first (which may build the kernels and
    capture the graph) and warns - or, with ``meta.watchdog_hard``, exits
    with code 86 so that a supervisor can resume from the last checkpoint -
    when one blocks longer (utils/watchdog.py).  In a sharded run every rank
    runs this loop on its slab; rank 0's speaks for the run (progress and
    watchdog).  The returned function's ``chunk`` is ``chunk``."""
    wd_timeout = cfg.meta.device_call_timeout
    lead = cfg.ctx.rank() == 0
    bounded = cfg.meta.max_steps_per_call is not None
    warm = [False]

    def interval(state: SimulationState, t_out: float, progress=None) -> SimulationState:
        wd = None
        if wd_timeout and lead:
            wd = DeviceWatchdog(wd_timeout, hard=cfg.meta.watchdog_hard,
                                context="device chunk")
        try:
            dx = _initial_dx_acc(cfg, state)
            while True:
                prev = state.iteration
                if wd is not None and warm[0]:
                    wd.arm("from the last chunk's end")
                state, dx = chunk(state, t_out, dx)
                t, it, it_before = _host_read(state, prev)
                if wd is not None:
                    wd.disarm()
                warm[0] = True
                _check_interval_progress(t, it, t_out, it_before)
                if t > t_out:
                    return state
                if progress is not None and lead and bounded:
                    progress(state)
        finally:
            if wd is not None:
                wd.stop()

    interval.chunk = chunk
    return interval


def make_interval_fn(cfg: StepConfig):
    """The per-output-interval function: steps while ``total_time <= t_out``
    (reference SPHCellList.jl:742) in chunks of at most
    ``meta.max_steps_per_call`` - ``make_chunk_loop(cfg,
    make_chunk_body(cfg))``, as in the JAX package; on the card every chunk
    of a single-device run is one graph replay and one host read."""
    return make_chunk_loop(cfg, make_chunk_body(cfg))


def make_fixed_steps_fn(cfg: StepConfig, n_steps: int):
    """Run exactly ``n_steps`` steps (benchmark and test helper; JAX: one
    ``fori_loop`` under one ``jit``): chunks of :func:`make_chunk_body` with
    no output time, bounded at the iteration ``n_steps`` past the start
    (read once, before the first chunk), until it is reached; one host read
    per chunk.  A chunk that takes no step (a non-finite ``total_time`` or
    ``dt``) raises.  The returned function's ``chunk`` is its chunk (on the
    card its graph is captured at the first call)."""
    chunk = make_chunk_body(cfg)

    def run(state: SimulationState) -> SimulationState:
        dx = _initial_dx_acc(cfg, state)
        it = int(state.iteration)
        stop = it + n_steps
        while it < stop:
            prev = state.iteration
            state, dx = chunk(state, math.inf, dx, stop)
            t, it, it_before = _host_read(state, prev)
            if it == it_before:
                raise FloatingPointError(
                    f"simulation stalled: no steps taken at iteration {it} "
                    f"(total_time {t}; non-finite dt or state)")
        return state

    run.chunk = chunk
    return run
