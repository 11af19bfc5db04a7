"""Host driver: build the simulation, run output intervals (port of
``sphexample_tpu/core/driver.py``).

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises when no GPU is present.  Only an explicit ``device="cpu"`` runs on
the CPU (the plain versions of the kernels).  ``assemble_simulation`` builds
the motion table from ``geometries`` and chooses the sweep kernel
(:func:`choose_sweep_kernel`).  ``run_simulation`` is the JAX package's host
loop: output intervals in chunks, the save callback (on a worker thread by
default, :class:`_AsyncSaver`), the log and progress callbacks, the
``HourGlass`` sections, and the re-grid and replay of an interval in which
particles escaped the static grid (:func:`_regrow_grid`, :func:`_retune`).
The port's kernels have no capacity windows, so grid escapes and, sharded,
the halo are the only overflows to guard, and capacity never grows on a
replay.  A simulation sharded by ``parallel.mesh.shard_simulation`` carries
the tuple of its slab states; ``run_simulation`` steps it through the same
loop and reads the replicated scalars from rank 0's state.  On a grid escape
or a halo overrun it gathers the pre-interval slabs, re-grids, re-shards
with a grown halo over the same mesh and replays (:func:`_reshard`);
:func:`gather_state` gives the one global state.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
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
from ..ops.interactions import PhysicsSpec
from ..state import SimulationState, allocate_particles, gather_state
from ..utils.timers import RECORDER, SWEEP_COUNTER, HourGlass, host_read
from ..utils.watchdog import DeviceWatchdog
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


# The most rows the block sweep reads; above it a deck takes the cell sweep
# (ops/cell_sweep.py), as it does in the JAX package, whose block kernel
# encodes row offsets in 21 bits.  The CUDA kernel itself has no such limit
# (int32 indices).
BLOCK_CAP_LIMIT = 1 << 21
# The most global rows the block sweep serves: the JAX package's f32 sorted
# index is exact below 2^24, so its sharded rule stops there too.
BLOCK_GLOBAL_LIMIT = 1 << 24


def choose_sweep_kernel(block_sweep: bool, capacity: int, rows: Optional[int] = None) -> str:
    """The sweep kernel of a deck, on one device or sharded, by the JAX
    package's own rules (``sphexample_tpu/core/driver.py:149-169``,
    ``sphexample_tpu/parallel/mesh.py:267-275``): ``"block"`` when
    ``meta.block_sweep`` is set, the ``rows`` the kernel reads are within
    ``BLOCK_CAP_LIMIT`` and the global ``capacity`` within
    ``BLOCK_GLOBAL_LIMIT``, else ``"cell"``.  ``rows`` is the capacity on one
    device (None); a slab's window ``C + 2 * halo`` sharded, the whole
    capacity when the halo is 0.  The model set plays no part: both kernels
    compute every model and mode."""
    rows = capacity if rows is None else rows
    fits = rows <= BLOCK_CAP_LIMIT and capacity <= BLOCK_GLOBAL_LIMIT
    return "block" if block_sweep and fits else "cell"


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
    hourglass: object = None  # filled by run_simulation

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


def _overflow_reason(cfg: StepConfig, state) -> Optional[str]:
    """Non-None when the interval's results are not to be believed: particles
    escaped the static grid (they were clamped into edge cells), or, sharded,
    a stencil window or a row migration reached past the halo (the clamped
    window dropped pairs).  The lines of JAX ``_overflow_reason`` that the
    port can trip; it has no candidate windows or chunk tables."""
    state = _replicated(state)
    esc = host_read(state.grid_escapes, int)
    if esc > 0:
        return (
            f"{esc} particle(s) escaped the static cell grid and were "
            f"clamped into edge cells (wrong physics); re-grid with a "
            f"larger bounding box or raise grid_margin_cells"
        )
    if cfg.halo and host_read(state.max_halo, int) > cfg.halo:
        return (
            f"stencil windows reached {host_read(state.max_halo, int)} sorted rows past "
            f"a slab boundary, exceeding the halo capacity {cfg.halo}; "
            f"re-shard with a larger halo"
        )
    return None


def _regrow_grid(cfg: StepConfig, failed_state, margin_cells: int) -> cl.Grid:
    """Union of the current grid and the escaped configuration's bounding box
    (plus margin): covers wherever the failed interval's particles actually
    went.  The reference's Dict grid is unbounded (SPHCellList.jl:144-162);
    this is the static-grid analog - grow, replay, carry on."""
    p = failed_state.particles
    act = p.active.cpu().numpy()
    pos = p.position.detach().cpu().numpy()[act]
    if not np.all(np.isfinite(pos)):
        raise FloatingPointError(
            "simulation diverged: non-finite particle positions at the "
            "grid-escape re-grid"
        )
    esc_grid = cl.grid_from_positions(pos, cfg.spec.kernel.H_inv, margin_cells)
    cmin = tuple(min(a, b) for a, b in zip(cfg.grid.cmin, esc_grid.cmin))
    cmax = tuple(
        max(a + s - 1, b + t - 1)
        for a, s, b, t in zip(cfg.grid.cmin, cfg.grid.shape,
                              esc_grid.cmin, esc_grid.shape)
    )
    new_grid = cl.Grid(
        cmin=cmin, shape=tuple(hi - lo + 1 for lo, hi in zip(cmin, cmax))
    )
    if new_grid.ncells > max(8 * cfg.grid.ncells, 2 ** 24):
        raise RuntimeError(
            f"grid-escape re-grid would need {new_grid.ncells} cells "
            f"({new_grid.shape}, was {cfg.grid.shape}): particles are far "
            f"outside the simulation domain - this is almost certainly a "
            f"diverged simulation, not a domain-sizing problem"
        )
    return new_grid


def _retune(sim: Simulation, prev_state, failed_state):
    """Grow the static grid to cover the failed interval's escapees (and,
    sharded, the halo) and return (sim, pre-interval state) for the replay
    (JAX ``_retune`` without its candidate windows).  Capacity and, on one
    device, the sweep kernel stay as assembled: the port's kernels have no
    candidate windows to grow."""
    cfg = sim.cfg
    esc = int(_replicated(failed_state).grid_escapes)
    new_grid = cfg.grid
    if esc > 0:
        new_grid = _regrow_grid(cfg, gather_state(failed_state),
                                sim.meta.grid_margin_cells)
    if cfg.ctx.is_sharded:
        return _reshard(sim, prev_state, failed_state, new_grid)
    if new_grid == cfg.grid:
        raise RuntimeError(
            "grid retune made no progress; raise grid_margin_cells manually")
    # the replay starts from the pre-interval state on the grown grid: the
    # old cell_start has the old grid's shape, and the escape count was
    # measured against the old grid (the replay's first step rebuilds)
    dev = prev_state.cell_start.device
    prev_state = prev_state.replace(
        cell_start=torch.zeros((new_grid.ncells + 2,), dtype=torch.int32, device=dev),
        grid_escapes=torch.zeros((), dtype=torch.int32, device=dev),
    )
    print(
        f"[sphexample_tpu_torch] grid escapes {esc}; re-gridding "
        f"{cfg.grid.shape}->{new_grid.shape} and replaying the interval",
        file=sys.stderr,
    )
    new_sim = Simulation(cfg=dataclasses.replace(cfg, grid=new_grid),
                         state=prev_state, meta=sim.meta, n_live=sim.n_live)
    return new_sim, prev_state


def _reshard(sim: Simulation, prev_state, failed_state, new_grid):
    """The sharded retune (JAX ``_retune``'s sharded branch,
    ``sphexample_tpu/core/driver.py:355-405``, without its candidate
    windows): gather the pre-interval slabs into one state, put it on
    ``new_grid``, and cut it again over the same mesh with the halo floored
    at ``halo_floor(max_halo, halo)`` rows.  A floor above a slab gives the
    whole-array window (``size_halo``), which cannot overflow, so the
    replays end.  Returns (sharded sim, its slab states)."""
    from ..parallel.context import SINGLE
    from ..parallel.mesh import halo_floor, shard_simulation

    cfg = sim.cfg
    failed = _replicated(failed_state)
    esc, halo_need = int(failed.grid_escapes), int(failed.max_halo)
    min_halo = halo_floor(halo_need, cfg.halo)
    state = gather_state(prev_state)
    if new_grid != cfg.grid:
        dev = state.cell_start.device
        state = state.replace(
            cell_start=torch.zeros((new_grid.ncells + 2,), dtype=torch.int32, device=dev),
            grid_escapes=torch.zeros((), dtype=torch.int32, device=dev))
    base = Simulation(cfg=dataclasses.replace(cfg, ctx=SINGLE, halo=0, grid=new_grid),
                      state=state, meta=sim.meta, n_live=sim.n_live)
    print(
        f"[sphexample_tpu_torch] sharded neighbor windows outgrown (halo "
        f"{halo_need}/{cfg.halo}, grid escapes {esc}); retuning halo >= "
        f"{min_halo}, grid {cfg.grid.shape}->{new_grid.shape}, re-sharding "
        f"over {sim.mesh.size} devices and replaying the interval",
        file=sys.stderr,
    )
    new_sim = shard_simulation(base, sim.mesh, min_halo=min_halo)
    if new_grid == cfg.grid and new_sim.cfg.halo == cfg.halo:
        raise RuntimeError(
            "sharded retune made no progress (neither the grid nor the halo "
            "changed); raise grid_margin_cells or shard over fewer devices")
    return new_sim, new_sim.state


def _default_progress(meta: SimulationMetaData, t_wall0: float):
    """In-interval progress line (the reference's ProgressMeter spinner,
    SPHCellList.jl:870-907): fires once per chunk, rate-limited, and only
    when stderr is a terminal."""
    if not sys.stderr.isatty():
        return None
    last = [0.0]

    def progress(state):
        now = time.perf_counter()
        if now - last[0] < 2.0:
            return
        last[0] = now
        tt = float(state.total_time)
        frac = min(tt / meta.simulation_time, 1.0) if meta.simulation_time else 0.0
        wall = now - t_wall0
        eta = wall * (1.0 - frac) / frac if frac > 1e-9 else float("nan")
        sys.stderr.write(
            f"\r  iter {int(state.iteration):>8}  t={tt:.4f}/"
            f"{meta.simulation_time:g}s  dt={float(state.current_dt):.2e}  "
            f"wall {wall:6.0f}s  eta {eta:6.0f}s "
        )
        sys.stderr.flush()

    return progress


class _AsyncSaver:
    """Run the save callback on a worker thread so that snapshot transfers
    and file writes overlap the next interval's compute.

    One worker keeps the snapshots in order (same output files); the queue
    is bounded, so at most ``maxsize`` states wait.  This is safe because
    nothing writes in place into a state the loop has handed on.  An eager
    step returns new tensors.  A chunk (``core/step.py:make_chunk_body``; on
    the card a CUDA graph that writes its static buffers in place) copies
    the state it is given into its buffers before it runs and hands out new
    tensors copied from them after it: no state handed in or out shares
    storage with what the next replay writes, the saver's snapshots and the
    pre-interval state ``run_simulation`` keeps for a replay included.  On
    the card the worker's ``.cpu()`` copies run on its thread's current
    stream (the default one), behind the kernels already queued there.
    Exceptions re-raise on the next enqueue or on close()."""

    def __init__(self, save_callback, maxsize: int = 2, watchdog=None):
        self._cb = save_callback
        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._wd = watchdog  # covers the snapshot transfers too
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._wd is not None:
                    self._wd.arm(f"snapshot {item[0]}")
                self._cb(*item)
            except BaseException as e:  # noqa: BLE001 - surfaced on main thread
                self._err = e
                return
            finally:
                # disarm on every exit: a save exception leaving the watchdog
                # armed would fire a bogus "device call hung" (or an
                # os._exit(86) in hard mode) over the error close() raises
                if self._wd is not None:
                    self._wd.disarm()
                self._q.task_done()

    def __call__(self, counter, state):
        # bounded-timeout puts: if the worker died (or is stuck in a stalled
        # transfer), the main thread must not block forever on a full queue
        while True:
            if self._err is not None:
                raise RuntimeError("async save failed") from self._err
            if not self._t.is_alive():
                raise RuntimeError("async saver thread died")
            try:
                self._q.put((counter, state), timeout=30.0)
                return
            except queue.Full:
                continue

    def drain(self):
        """Wait until every queued snapshot is written (a worker's error
        raises here): a save callback that reads the simulation's config
        then sees the config its snapshots were stepped under."""
        q = self._q
        while True:
            if self._err is not None:
                raise RuntimeError("async save failed") from self._err
            with q.all_tasks_done:
                if not q.unfinished_tasks:
                    return
                q.all_tasks_done.wait(timeout=1.0)
            if not self._t.is_alive() and q.unfinished_tasks:
                raise RuntimeError("async saver thread died")

    def close(self):
        # after a worker exception the thread has exited without draining: a
        # blocking put on the bounded queue would turn the failure into a
        # hang.  A healthy but slow worker must instead be waited for:
        # returning with snapshots still queued would drop the last outputs.
        deadline = time.monotonic() + 1800.0
        while (self._err is None and self._t.is_alive()
               and time.monotonic() < deadline):
            try:
                self._q.put(None, timeout=60.0)
                break
            except queue.Full:
                continue  # worker alive and draining: keep waiting
        while self._t.is_alive() and time.monotonic() < deadline:
            self._t.join(timeout=60.0)
        if self._err is not None:
            raise RuntimeError("async save failed") from self._err
        if self._t.is_alive() or not self._q.empty():
            raise RuntimeError(
                "async saver did not drain within 30 min: "
                "snapshots would be lost (stalled transfer?)"
            )


def run_simulation(
    sim: Simulation,
    save_callback: Optional[Callable[[int, SimulationState], None]] = None,
    log_callback: Optional[Callable[[dict], None]] = None,
    max_intervals: Optional[int] = None,
    auto_retune: bool = True,
    start_counter: int = 1,
    progress_callback: Optional[Callable] = None,
) -> Simulation:
    """Outer host loop over output intervals (reference SPHCellList.jl:881-929).

    ``save_callback(counter, state)`` fires once for the initial state (at
    ``start_counter == 1`` only: a resumed run's snapshot for its counter
    exists already) and once per output time; with ``meta.async_output`` it
    runs on a worker thread.  When particles escaped the static grid during
    an interval, or (sharded) a stencil window reached past the halo, its
    results are invalid: with ``auto_retune`` the driver grows the grid (and
    re-shards with a grown halo) and **replays the interval from the
    pre-interval state**, otherwise it raises.  ``sim.cfg``, ``sim.state``,
    ``sim.interval_fn`` and ``sim.mesh`` are updated in place;
    ``sim.hourglass`` holds the wall time of the loop's sections.

    While tracing is on (``utils/timers.py:start_trace``) each interval is a
    span ``driver.interval``, its output counter the spans' interval id,
    with the children ``driver.pre_read``, ``chunk_loop.interval`` (the
    chunk loop's spans below it), ``driver.overflow_check``,
    ``driver.retune``, ``driver.save``, ``driver.log`` and
    ``driver.end_check``; each interval, a replay included, counts the
    sweep kernel it runs under ``driver.sweep.<block|cell>``
    (``StepConfig.sweep_kernel``); every read of the device here goes through
    ``host_read``, which counts it (seven an interval with a log callback,
    three without, one more sharded, besides the chunk loop's one a chunk)."""
    meta = sim.meta
    state = sim.state
    dtype = _replicated(state).total_time.dtype
    counter = start_counter
    saver = save_callback
    save_wd = None
    if save_callback is not None and meta.async_output:
        if meta.device_call_timeout:
            save_wd = DeviceWatchdog(meta.device_call_timeout,
                                     hard=meta.watchdog_hard,
                                     context="snapshot save")
        saver = _AsyncSaver(save_callback, watchdog=save_wd)
    if saver is not None and counter == 1:
        # initial-state snapshot; on resume (start_counter > 1) the snapshot
        # for this counter already exists in the reopened output files
        saver(counter, state)

    # stage-level wall accounting (reference's TimerOutputs taxonomy,
    # SPHCellList.jl:883-918); retrieve via sim.hourglass.report()
    hourglass = HourGlass()
    sim.hourglass = hourglass
    t_wall0 = time.perf_counter()
    if progress_callback is None:
        progress_callback = _default_progress(meta, t_wall0)
    intervals = 0
    try:
        while True:
            if RECORDER.on:
                RECORDER.interval = counter + 1
                RECORDER.count(SWEEP_COUNTER + sim.cfg.sweep_kernel)
            with RECORDER.span("driver.interval"):
                # the output time in the state's dtype, as the JAX loop compares
                t_out = torch.tensor(meta.output_time_for(counter), dtype=dtype).item()
                with RECORDER.span("driver.pre_read"):
                    prev_iter = host_read(_replicated(state).iteration, int)
                prev_state = state
                with hourglass.section("00 SimulationLoop", "chunk_loop.interval"):
                    state = sim.interval_fn(state, t_out, progress_callback)

                with RECORDER.span("driver.overflow_check"):
                    overflow = _overflow_reason(sim.cfg, state)
                if overflow:
                    if not auto_retune:
                        raise RuntimeError(overflow)
                    with hourglass.section("02b Retune neighbor windows", "driver.retune"):
                        if isinstance(saver, _AsyncSaver):
                            saver.drain()  # snapshots queued on the old grid and mesh
                        new_sim, state = _retune(sim, prev_state, state)
                        sim.cfg = new_sim.cfg
                        sim.state = new_sim.state
                        sim.interval_fn = new_sim.interval_fn
                        sim.mesh = new_sim.mesh
                    continue  # replay the same interval on the grown grid / halo

                counter += 1
                intervals += 1
                lead = _replicated(state)
                if saver is not None:
                    with hourglass.section("13 Save Particle Data", "driver.save"):
                        saver(counter, state)
                if log_callback is not None:
                    with RECORDER.span("driver.log"):
                        log_callback(dict(
                            counter=counter,
                            total_time=host_read(lead.total_time),
                            iteration=host_read(lead.iteration, int),
                            steps_in_interval=host_read(lead.iteration, int) - prev_iter,
                            dt=host_read(lead.current_dt),
                            wall_time=time.perf_counter() - t_wall0,
                        ))
                with RECORDER.span("driver.end_check"):
                    ended = host_read(lead.total_time) > meta.simulation_time
                if ended:
                    break
                if max_intervals is not None and intervals >= max_intervals:
                    break
    finally:
        try:
            if isinstance(saver, _AsyncSaver):
                with hourglass.section("13 Save Particle Data", "driver.save"):
                    saver.close()
        finally:
            # stop the watchdog even when close() raises - a still-armed
            # hard watchdog would os._exit(86) over the real error
            if save_wd is not None:
                save_wd.stop()
            if RECORDER.on:
                RECORDER.interval = None

    sim.state = state
    return sim


def _replicated(state) -> SimulationState:
    """The state whose scalars speak for the run: rank 0's slab state of a
    sharded run (the scalars are replicated), else the state itself."""
    return state[0] if isinstance(state, tuple) else state
