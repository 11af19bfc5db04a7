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
on ``dx_acc >= h``, and :func:`make_chunk_loop` reads the host once per
chunk.  Both decisions are made in the state's dtype, as the JAX package
makes them (``dx_acc >= kern.h`` with a weakly typed ``h``, and ``t_out`` in
the state's dtype): the device flags, the host ``if`` and the loop's end
test alike.

In a sharded run every rank takes the same branch: the accumulator is built
from the ``pmax`` of stage 00 alone and the time from the replicated ``dt``,
so all ranks hold the same values.  :func:`make_chunk_body` routes a sharded
config by where its slabs lie: all on one card, the chunk of every slab is
one CUDA graph (rank 0's flags drive the IF nodes; the collectives are
captured, ``parallel/context.py:GroupCapture``); on several cards, the
ranks run the eager chunk (:func:`_eager_chunk`), since the body of a
conditional node stays on one device.
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
from ..ops.block_sweep import block_sweep, block_sweep_sharded
from ..ops.cell_sweep import cell_sweep, cell_sweep_sharded
from ..ops.interactions import PhysicsSpec
from ..ops.mdbc import mdbc_density_correction, mdbc_density_correction_sharded
from ..ops.timestep import adaptive_dt
from ..parallel.context import SINGLE, CommContext, GroupCapture, run_ranks
from ..state import (Particles, SimulationState, clone_state, copy_state_,
                     state_leaves)
from ..utils.timers import RECORDER, host_read
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
    package's ``lax.cond(dx_acc >= kern.h, do_rebuild, no_rebuild, p)``),
    compared in ``dx_acc``'s dtype as JAX compares it: ``h`` is a Python
    float, which a tensor comparison takes in the tensor's dtype.

    With no ``branch`` (a plain call, the eager chunk) it is a host ``if``
    on the flag: one device-to-host read, and a rebuild hands on new
    tensors.  A chunk (:func:`make_chunk_body`) gives its steps a
    ``branch(flag, body)`` (``StepConfig.branch``): the flag stays on the
    device, and ``body`` writes the rebuild in place into the tensors that
    are handed on either way (the chunk's buffers); on the card ``branch``
    captures ``body`` as a CUDA graph IF node on the flag, on the CPU it is
    a host ``if`` on it."""
    keep = Stage02(p, state.cell_start, state.max_occupancy, state.max_segment,
                   state.occupied_cells, state.grid_escapes, state.max_halo, dx_acc,
                   state.rebuilds)
    flag = dx_acc >= cfg.spec.kernel.h
    if branch is not None:
        branch(flag, lambda: _write_stage02(keep, _rebuild(cfg, keep)))
        return keep
    if bool(flag):
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


def _initial_dx_acc(cfg: StepConfig, state):
    """1 + h in the state's dtype on its device: the first step of every
    run/interval rebuilds (reference :739).  A sharded state (the tuple of
    its slab states): one accumulator per slab, on the slab's device."""
    if isinstance(state, tuple):
        return tuple(_initial_dx_acc(cfg, s) for s in state)
    return torch.full((), 1.0 + cfg.spec.kernel.h, dtype=state.total_time.dtype,
                      device=state.total_time.device)


def _lead(state) -> SimulationState:
    """The state whose scalars speak for a run: rank 0's slab state of a
    sharded run (the scalars are replicated), else the state itself."""
    return state[0] if isinstance(state, tuple) else state


def _in_dtype(t_out, dtype) -> float:
    """The output time as the state's dtype holds it (the JAX driver hands
    its chunks ``t_out`` in the state's dtype), as a Python float."""
    return torch.tensor(float(t_out), dtype=dtype).item()


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


def _host_read(state, prev_iteration, prev_rebuilds=None) -> tuple:
    """The one host read of a chunk: (total_time, iteration, the iteration
    ``prev_iteration`` held), in one device-to-host copy.  A sharded state
    is read at rank 0's slab, once for all slabs.  With ``prev_rebuilds``
    (while tracing) it also brings the state's rebuild count and the one
    ``prev_rebuilds`` held, and closes the chunk's record in
    ``utils/timers.py:RECORDER``."""
    state = _lead(state)
    vals = [state.total_time.double(), state.iteration.double(), prev_iteration.double()]
    if prev_rebuilds is not None:
        vals += [state.rebuilds.double(), prev_rebuilds.double()]
    read = host_read(torch.stack(vals), torch.Tensor.tolist)
    if prev_rebuilds is not None:
        RECORDER.chunk_done(int(read[1]) - int(read[2]), int(read[3]) - int(read[4]))
    return read[0], int(read[1]), int(read[2])


def _before(state) -> tuple:
    """What :func:`_host_read` compares the state after a chunk with: the
    iteration before the chunk and, while tracing, the rebuild count."""
    lead = _lead(state)
    return (lead.iteration, lead.rebuilds) if RECORDER.on else (lead.iteration,)


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
    """What a chunk owns for one slab (the whole state on a single device):
    the state its steps read and write in place, the displacement
    accumulator, the output time and the iteration bound, and the two
    decision flags.  Filled from the caller's tensors before a chunk runs
    and copied out after it, so that no state handed in or out shares
    storage with them."""

    def __init__(self, state: SimulationState):
        dev = state.total_time.device
        self.signature = _signature(state)
        self.state = clone_state(state)
        self.dx = torch.zeros((), dtype=state.total_time.dtype, device=dev)
        self.t_out = torch.zeros((), dtype=state.total_time.dtype, device=dev)
        self.stop = torch.zeros((), dtype=state.iteration.dtype, device=dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.rebuild = torch.zeros((), dtype=torch.bool, device=dev)

    def load(self, state, t_out: float, dx_acc, stop: Optional[int]) -> None:
        copy_state_(self.state, state)
        self.dx.copy_(dx_acc)
        self.t_out.fill_(float(t_out))      # rounded to the state's dtype
        self.stop.fill_(_NO_STOP if stop is None else int(stop))

    def set_live(self) -> None:
        """The guard of the next step: ``total_time <= t_out`` (in the
        state's dtype, as the JAX loop compares) and ``iteration < stop``."""
        s = self.state
        self.live.copy_((s.total_time <= self.t_out) & (s.iteration < self.stop))

    def step(self, cfg: StepConfig) -> None:
        """One step on the buffers, then the next step's guard.  ``cfg``
        carries the chunk's stage 02 branch (``cfg.branch``)."""
        new, dx = sph_step(cfg, self.state, self.dx)
        copy_state_(self.state, new)
        self.dx.copy_(dx)
        self.set_live()

    def out(self):
        return clone_state(self.state), self.dx.clone()


class _StepCapture:
    """Stage 02's branch of one rank while a step is captured: the flag goes
    into the rank's ``rebuild`` buffer, the step's head piece ends, the
    rebuild is captured as its own piece (the IF node's body) and the tail
    piece begins.  At rank 0 ``head`` and ``body`` hold the pieces."""

    def __init__(self, capture: GroupCapture, rank: int, flag_buf):
        self.capture, self.rank, self.flag_buf = capture, rank, flag_buf
        self.head = self.body = None
        self.taken = False

    def __call__(self, flag, body) -> None:
        if self.taken:
            raise RuntimeError("a captured step takes stage 02's branch once")
        self.taken = True
        self.flag_buf.copy_(flag)
        self.head = self.capture.end(self.rank)
        self.capture.begin(self.rank)
        body()
        self.body = self.capture.end(self.rank)
        self.capture.begin(self.rank)


class ChunkGraph:
    """The chunk of ``steps`` guarded steps as one CUDA graph on the card
    (``csrc/chunk_graph.cu``): one step is captured once, in three pieces
    (its head up to stage 02's decision, the rebuild, its tail), and the
    graph holds it ``steps`` times, each under an IF node on the guard and
    with the rebuild under an IF node on ``dx_acc >= h``.  Nothing in a step
    depends on its place in the chunk: the buffers are fixed and every
    temporary dies inside the step.  Built once for a state's shapes,
    replayed per chunk.

    A sharded chunk (``group``: the ranks of one card) is the same graph
    with every slab's step in each piece: each piece is captured across the
    ranks' streams (``parallel/context.py:GroupCapture``), the collectives'
    events become edges between the ranks' branches, and rank 0's flags
    drive the IF nodes (every rank holds the same values).  The ranks'
    threads run only for the warm-up and the capture; a replay is one
    launch from the calling thread.

    Holds what the chip check reads: ``capture_s``, ``instantiate_s``,
    ``nodes_per_step`` (the step's three pieces, two set kernels and two IF
    nodes) and ``memory_bytes`` (the device memory reserved while it was
    built, its pool included)."""

    def __init__(self, cfgs, steps: int, bufs, group=None):
        """``cfgs`` and ``bufs``: each rank's config and buffers (one of each
        on a single device), loaded, their next step live.  That step runs
        first, eagerly, on the ranks' streams (the warm-up: what the step
        caches on the device is made before the capture, a rebuild included
        when the chunk starts an interval); then the next step is captured
        on the same streams, which run nothing."""
        from ..ops._build import load_all, load_library

        dev = bufs[0].state.total_time.device
        self.steps, self.device, self.bufs, self.group = steps, dev, bufs, group
        load_all()
        self._lib = lib = load_library("chunk_graph")
        mem0 = torch.cuda.memory_reserved(dev)
        if group is None:
            streams = [torch.cuda.Stream(dev)]
            capture = GroupCapture(None, streams, "global")
        else:
            streams = [group.stream(r) for r in range(group.size)]
            capture = GroupCapture(group, streams, "relaxed")
        self._streams = streams
        host = [dataclasses.replace(c, branch=_host_branch) for c in cfgs]
        # a graph freed by the garbage collector during the capture would
        # destroy CUDA objects while the streams capture: collect first, and
        # not while capturing
        gc.collect()
        gc.disable()
        try:
            self._on_ranks(lambda r: bufs[r].step(host[r]), sync=True)
            t0 = time.perf_counter()
            try:
                pieces = self._on_ranks(lambda r: self._capture(cfgs[r], r, capture),
                                        sync=False)[0]
            except BaseException:
                capture.abort()
                raise
            self.capture_s = time.perf_counter() - t0
        except Exception as e:
            raise RuntimeError(f"chunk graph capture failed: {e}") from e
        finally:
            gc.enable()
        self._pieces = capture.graphs      # their pool backs the graph's memory
        head, step_head, body, tail = pieces
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        t0 = time.perf_counter()
        err = lib.sph_chunk_graph_build(steps, head, step_head, body, tail,
                                        bufs[0].live.data_ptr(), bufs[0].rebuild.data_ptr(),
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

    def _on_ranks(self, fn, sync: bool) -> list:
        """``fn(rank)`` on every rank's stream: the ranks' threads of a
        group (``run_ranks``), or on a single device this thread on a side
        stream.  The streams wait on the calling thread's stream first;
        ``sync`` as in ``run_ranks``."""
        if self.group is not None:
            return run_ranks(self.group, fn, sync=sync)
        caller, side = torch.cuda.current_stream(self.device), self._streams[0]
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            side.wait_stream(caller)
            out = [fn(0)]
            if sync:
                side.synchronize()
        if not sync:
            caller.wait_stream(side)
        return out

    def _capture(self, cfg, rank: int, capture: GroupCapture):
        """Rank ``rank``'s part of the capture, on its stream: the chunk's
        first guard and one step in its three pieces.  Returns, at rank 0,
        their graphs (guard, step head, rebuild, step tail)."""
        buf = self.bufs[rank]
        capture.begin(rank)
        buf.set_live()
        head = capture.end(rank)
        split = _StepCapture(capture, rank, buf.rebuild)
        capture.begin(rank)
        buf.step(dataclasses.replace(cfg, branch=split))
        tail = capture.end(rank)
        if not split.taken:
            raise RuntimeError("stage 02 was not captured as a branch")
        return head, split.head, split.body, tail

    def _nodes(self, graph) -> int:
        n = ctypes.c_int()
        self._lib.sph_chunk_graph_nodes(graph, ctypes.byref(n))
        return n.value

    def launch(self) -> None:
        """One launch of the graph on the current stream, on the loaded
        buffers."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.sph_chunk_graph_launch(self._exec, stream)
        if err != 0:
            raise RuntimeError("chunk graph launch failed: "
                               f"{self._lib.sph_chunk_graph_error_string(err).decode()}")

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
    step is the body of an IF node on ``total_time <= t_out`` and stage
    02's rebuild the body of an IF node on ``dx_acc >= h``, both evaluated
    on the device in the state's dtype; a skipped step leaves every buffer
    as it was.  No host read happens in a chunk: the caller reads the state
    once after it.  The first chunk that takes a step (and the first for a
    state of other shapes) builds the graph: it reads the guard on the
    host, runs its first step eagerly (the warm-up) and the rest of its
    steps in the graph.  A capture or instantiation that fails raises; the
    eager loop is never run in its place.  CPU tensors: the same guarded
    steps run eagerly on the same buffers, each decision a host ``if``.

    A sharded config (``cfg.ctx``, rank 0's context of the group) gets the
    chunk of all its slabs at once (the counterpart of the JAX package's
    ``shard_map`` of this function): ``state`` and ``dx_acc`` are tuples,
    one entry per slab.  Its route is chosen by where the slabs lie:

    * all on one card, or all on the CPU: the buffers above, one set per
      rank on its device, and on the card one graph that holds every slab's
      step (``route`` "graph");
    * on several cards: :func:`_eager_chunk` (``route`` "eager") - the
      ranks' threads step their slabs with a host read per step, since the
      body of a conditional node stays on one device.

    While tracing is on (``utils/timers.py``) the chunk records the spans
    ``chunk.load`` (the buffers filled), ``chunk.launch``, ``chunk.out``
    (the state copied out) and ``graph.build``, and around a replay on the
    card four CUDA events on the calling stream: before and after the
    load, after the launch, after the copies out.

    ``chunk.graph`` is the graph (None before the card's first chunk),
    ``chunk.buffers`` the buffers (sharded: a list, one per slab),
    ``chunk.route`` the route."""
    group = cfg.ctx.group
    if group is not None and len(set(group.devices)) > 1:
        return _eager_chunk(cfg)
    n = group.size if group is not None else 1
    cfgs = [dataclasses.replace(cfg, ctx=cfg.ctx.for_rank(r)) for r in range(n)]
    host = [dataclasses.replace(c, branch=_host_branch) for c in cfgs]
    steps = cfg.meta.max_steps_per_call or UNBOUNDED_GRAPH_STEPS

    def chunk(state, t_out, dx_acc, stop=None):
        states, dxs = (state, dx_acc) if group is not None else ((state,), (dx_acc,))
        if len(states) != n:
            raise ValueError(f"{len(states)} slab states for {n} ranks")
        dev = states[0].total_time.device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        if chunk.slabs is None or [b.signature for b in chunk.slabs] != [
                _signature(s) for s in states]:
            chunk.graph = None
            chunk.slabs = [_Buffers(s) for s in states]
            chunk.buffers = chunk.slabs if group is not None else chunk.slabs[0]
        bufs = chunk.slabs
        timed = RECORDER.on and chunk.graph is not None    # a replay's events
        if timed:
            RECORDER.chunk_mark(0, dev)
        with RECORDER.span("chunk.load"):
            for b, s, d in zip(bufs, states, dxs):
                b.load(s, t_out, d, stop)
        if chunk.graph is None:
            for b in bufs:
                b.set_live()
            if dev.type == "cpu":
                return host_chunk(bufs)
            if not host_read(bufs[0].live, bool):
                return _handed_out([b.out() for b in bufs], group)
            it0 = host_read(bufs[0].state.iteration, int)
            with RECORDER.span("graph.build"):
                # runs the first step
                chunk.graph = ChunkGraph(cfgs, steps, bufs, group)
            # the rest of this chunk: ``steps`` in all from ``it0``
            for b in bufs:
                b.stop.fill_(min(_NO_STOP if stop is None else int(stop), it0 + steps))
                b.set_live()
        if timed:
            RECORDER.chunk_mark(1, dev)
        with RECORDER.span("chunk.launch"):
            chunk.graph.launch()
        if timed:
            RECORDER.chunk_mark(2, dev)
        with RECORDER.span("chunk.out"):
            outs = [b.out() for b in bufs]
        if timed:
            RECORDER.chunk_mark(3, dev)
        return _handed_out(outs, group)

    def host_chunk(bufs):
        """The chunk's guarded steps on CPU tensors, each decision a host
        ``if``."""
        def run(r):
            for _ in range(steps):
                if not bool(bufs[r].live):
                    break
                bufs[r].step(host[r])

        if group is None:
            run(0)
        else:
            run_ranks(group, run)
        with RECORDER.span("chunk.out"):
            return _handed_out([b.out() for b in bufs], group)

    chunk.graph = chunk.buffers = chunk.slabs = None
    chunk.route = "graph"
    return chunk


def _handed_out(outs, group):
    """A chunk's [(state, dx_acc), ...] per slab as it hands them out: the
    pair itself on a single device, a pair of tuples when sharded."""
    if group is None:
        return outs[0]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def _eager_chunk(cfg: StepConfig):
    """A chunk as a host loop of ``sph_step`` calls, each step's guard and
    its stage 02 decision a host read, in the state's dtype: the route of
    :func:`make_chunk_body` for a sharded config whose slabs lie on several
    cards, and the reference that the chunk graph is held against.  A
    sharded config (rank 0's context): the chunk of all slabs, each rank's
    loop on its thread (``run_ranks``).  The signature of
    :func:`make_chunk_body`'s chunk."""
    cap = cfg.meta.max_steps_per_call

    def steps(cfg_r, state, t_out, dx_acc, stop):
        t_end, k = _in_dtype(t_out, state.total_time.dtype), 0
        while (float(state.total_time) <= t_end and (cap is None or k < cap)
               and (stop is None or int(state.iteration) < stop)):
            state, dx_acc = sph_step(cfg_r, state, dx_acc)
            k += 1
        return state, dx_acc

    if not cfg.ctx.is_sharded:
        def chunk(state, t_out, dx_acc, stop=None):
            return steps(cfg, state, t_out, dx_acc, stop)
    else:
        group = cfg.ctx.group
        cfgs = [dataclasses.replace(cfg, ctx=cfg.ctx.for_rank(r)) for r in range(group.size)]

        def chunk(states, t_out, dx_acc, stop=None):
            if len(states) != group.size:
                raise ValueError(f"{len(states)} slab states for {group.size} ranks")
            if any(d.type == "cuda" for d in group.devices):
                from ..ops._build import load_all

                load_all()
            outs = run_ranks(group, lambda r: steps(cfgs[r], states[r], t_out,
                                                    dx_acc[r], stop))
            return _handed_out(outs, group)

    chunk.graph = chunk.buffers = None
    chunk.route = "eager"
    return chunk


def make_chunk_loop(cfg: StepConfig, chunk):
    """The per-output-interval host loop over ``chunk(state, t_out, dx_acc)``
    calls (JAX ``make_chunk_loop``, ``sphexample_tpu/core/step.py:464-513``):
    the displacement accumulator is set to 1 + h at the interval's start, so
    that its first step rebuilds (reference :739), and carries across chunks,
    so the trajectory is that of one unchunked loop.  After every chunk the
    host reads the state once (:func:`_host_read`: total time and iteration;
    a sharded state at rank 0's slab, once for all), checks progress
    (:func:`_check_interval_progress`), ends the interval once the time
    passed ``t_out`` in the state's dtype and, when
    ``meta.max_steps_per_call`` bounds the chunks, fires ``progress(state)``
    (rank 0's slab state when sharded) after every chunk but the last - the
    analog of the reference's in-interval ProgressMeter spinner
    (SPHCellList.jl:870-907).  With ``meta.device_call_timeout`` set, a
    watchdog is armed around every chunk after this function's first (which
    may build the kernels and capture the graph) and warns - or, with
    ``meta.watchdog_hard``, exits with code 86 so that a supervisor can
    resume from the last checkpoint - when one blocks longer
    (utils/watchdog.py).  While tracing is on (``utils/timers.py``) every
    chunk is a span ``chunk`` with the children ``chunk.host_read`` (where
    the host waits for the card) and ``chunk.progress`` beside the chunk
    body's own, and the host read also brings the chunk's rebuilds, for the
    chunk's record.  The returned function's ``chunk`` is ``chunk``."""
    wd_timeout = cfg.meta.device_call_timeout
    bounded = cfg.meta.max_steps_per_call is not None
    warm = [False]

    def interval(state, t_out: float, progress=None):
        wd = None
        if wd_timeout:
            wd = DeviceWatchdog(wd_timeout, hard=cfg.meta.watchdog_hard,
                                context="device chunk")
        try:
            dx = _initial_dx_acc(cfg, state)
            t_end = _in_dtype(t_out, _lead(state).total_time.dtype)
            while True:
                prev = _before(state)
                if wd is not None and warm[0]:
                    wd.arm("from the last chunk's end")
                with RECORDER.span("chunk"):
                    state, dx = chunk(state, t_out, dx)
                    with RECORDER.span("chunk.host_read"):
                        t, it, it_before = _host_read(state, *prev)
                    if wd is not None:
                        wd.disarm()
                    warm[0] = True
                    _check_interval_progress(t, it, t_end, it_before)
                    if t > t_end:
                        return state
                    if progress is not None and bounded:
                        with RECORDER.span("chunk.progress"):
                            progress(_lead(state))
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
    of a run whose slabs lie on one card is one graph replay and one host
    read.  A sharded config: the function of the tuple of slab states."""
    return make_chunk_loop(cfg, make_chunk_body(cfg))


def make_fixed_steps_fn(cfg: StepConfig, n_steps: int):
    """Run exactly ``n_steps`` steps (benchmark and test helper; JAX: one
    ``fori_loop`` under one ``jit``): chunks of :func:`make_chunk_body` with
    no output time, bounded at the iteration ``n_steps`` past the start
    (read once, before the first chunk), until it is reached; one host read
    per chunk.  A chunk that takes no step (a non-finite ``total_time`` or
    ``dt``) raises.  The returned function's ``chunk`` is its chunk (on the
    card its graph is captured at the first call).  A sharded config: the
    function of the tuple of slab states."""
    chunk = make_chunk_body(cfg)

    def run(state):
        dx = _initial_dx_acc(cfg, state)
        it = host_read(_lead(state).iteration, int)
        stop = it + n_steps
        while it < stop:
            prev = _before(state)
            state, dx = chunk(state, math.inf, dx, stop)
            t, it, it_before = _host_read(state, *prev)
            if it == it_before:
                raise FloatingPointError(
                    f"simulation stalled: no steps taken at iteration {it} "
                    f"(total_time {t}; non-finite dt or state)")
        return state

    run.chunk = chunk
    return run
