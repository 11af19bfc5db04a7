"""Multi-slab execution: shard an assembled simulation over P ranks (port of
``sphexample_tpu/parallel/mesh.py``).

The particle axis is cut in global cell-sorted order (``parallel.context``);
the step function is unchanged - every rank runs ``sph_step`` on its slab
with a sharded :class:`CommContext`.  Ranks are threads of this process: rank
r owns slab r on device ``cuda:(r mod torch.cuda.device_count())``, so P slabs
run on however many cards are visible, one included (they then share the
card, each on its own stream), or on the CPU when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import MDBCMode
from ..core.driver import Simulation, choose_sweep_kernel, resolve_device
from ..core.step import StepConfig, make_fixed_steps_fn, make_interval_fn
from ..ops import cell_list as cl
from ..state import pad_capacity, split_state
from .context import DEFAULT_TIMEOUT, CommContext, LocalGroup, run_ranks


@dataclass(frozen=True)
class Mesh:
    """The rank-to-device map of a sharded run: slab r lives on ``devices[r]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_slabs: Optional[int] = None, device=None) -> Mesh:
    """``n_slabs`` ranks (default: one per visible card).  ``device=None``
    means the cards: rank r goes to ``cuda:(r mod count)``, and no card
    raises.  ``device="cpu"`` puts every rank on the CPU (the tests); a
    single CUDA device pins every rank to it."""
    dev = resolve_device(device)
    if n_slabs is None:
        n_slabs = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = int(n_slabs)
    if n < 1:
        raise ValueError(f"make_mesh({n_slabs}): a mesh needs at least one slab")
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", r % count) for r in range(n)))
    return Mesh((dev,) * n)


def measure_halo(position, active, inv_cutoff, grid, ndev: int, capacity: int,
                 ghost_points=None) -> int:
    """Host-side (numpy): the largest sorted-row reach of any stencil window
    past its own slab's boundaries in the given configuration.  Every
    neighbor cell of cell k has a linear key within ``W = sum(strides)`` of k,
    so a window's rows are bounded by the ``[k - W, k + W]`` key band - the
    conservative band that the step's ``max_halo`` telemetry guards as the
    fluid drifts.  ``ghost_points`` (mDBC): a ghost's band is taken at the
    ghost's key but anchored to its particle's slab, as the telemetry does."""
    pos = np.asarray(position)
    act = np.asarray(active)
    ncells = grid.ncells
    key = np.where(act, cl.host_cell_keys(pos, inv_cutoff, grid), ncells)
    order = np.argsort(key, kind="stable")
    cell_start = np.searchsorted(key[order], np.arange(ncells + 2))
    rank = np.empty(capacity, np.int64)
    rank[order] = np.arange(capacity)
    C = capacity // ndev
    dev = rank // C
    W = int(sum(grid.strides))

    def band_need(k_arr, mask):
        s = cell_start[np.clip(k_arr - W, 0, ncells)]
        e = cell_start[np.clip(k_arr + W + 1, 0, ncells + 1)]
        left = np.where(mask, dev * C - s, 0)
        right = np.where(mask, e - (dev + 1) * C, 0)
        return max(int(left.max(initial=0)), int(right.max(initial=0)))

    need = band_need(key, act & (key < ncells))
    if ghost_points is not None:
        gp = np.asarray(ghost_points)
        has_g = act & np.any(gp != 0, axis=-1)
        need = max(need, band_need(cl.host_cell_keys(gp, inv_cutoff, grid), has_g))
    return max(int(need), 0)


def _r128(v) -> int:
    return -(-int(v) // 128) * 128


def halo_floor(need: int, halo: int) -> int:
    """The floor a sharded retune puts under the next halo when windows
    reached ``need`` rows past a slab with a halo of ``halo`` rows (the JAX
    driver's ``min_halo``, ``sphexample_tpu/core/driver.py:373``): twice the
    need, at least the old halo, rounded up to 128 rows, plus 128."""
    return _r128(max(need * 2, halo)) + 128


def size_halo(need: int, C: int, min_halo: int = 0) -> int:
    """The halo of a slab of ``C`` rows whose windows reach ``need`` rows
    (the rule of ``sphexample_tpu/parallel/mesh.py:220-245``): twice the
    need plus 128, rounded up to 128 rows, when that fits a slab; the whole
    slab when only the bare need fits (the telemetry guards it); else 0 - one
    hop cannot cover the reach, and the window is the whole gathered array.
    ``min_halo`` is a floor a caller observed; a floor above a slab gives 0."""
    want = max(_r128(need * 2 + 128), _r128(min_halo))
    if want <= C:
        return want
    if _r128(min_halo) > C:
        return 0
    if _r128(need + 64) <= C:
        return C
    return 0


def sharded_config(cfg: StepConfig, mesh: Mesh, timeout: float = DEFAULT_TIMEOUT) -> StepConfig:
    """``cfg`` with rank 0's context of a new group of the mesh's ranks: the
    config that the sharded chunk (``core/step.py:make_chunk_body``) and
    :func:`make_sharded_fn` take."""
    return dataclasses.replace(cfg, ctx=CommContext(LocalGroup(mesh.devices, timeout), 0))


def make_sharded_fn(cfg: StepConfig, mesh: Mesh, make_fn: Callable,
                    timeout: float = DEFAULT_TIMEOUT):
    """Run a per-rank function on every slab at once, each rank on its
    thread (``run_ranks``): ``make_fn(cfg_r)`` builds rank r's function
    ``(state, *args) -> result`` from the config that carries rank r's
    context (a step, a sweep, a collective - not the chunk, which takes all
    slabs at once); the result takes the tuple of slab states and returns
    the tuple of results.  On the card every library is built and loaded
    before the ranks start.  Returns (function, cfg with rank 0's
    context)."""
    cfg = sharded_config(cfg, mesh, timeout)
    group = cfg.ctx.group
    fns = [make_fn(dataclasses.replace(cfg, ctx=cfg.ctx.for_rank(r)))
           for r in range(mesh.size)]

    def run(states, *args):
        if len(states) != mesh.size:
            raise ValueError(f"{len(states)} slab states for {mesh.size} ranks")
        if any(d.type == "cuda" for d in mesh.devices):
            from ..ops._build import load_all

            load_all()
        return tuple(run_ranks(group, lambda r: fns[r](states[r], *args)))

    return run, cfg


def make_sharded_interval_fn(cfg: StepConfig, mesh: Mesh,
                             timeout: float = DEFAULT_TIMEOUT):
    """The per-output-interval function of a sharded run (JAX
    ``jit(shard_map(make_chunk_body))`` under ``make_chunk_loop``,
    ``sphexample_tpu/parallel/mesh.py:105-125``): one chunk loop
    (``core/step.py:make_chunk_loop``) over the chunk of all slabs at once,
    one host read per chunk for all of them, progress and the watchdog in
    that one loop.  On the card, with every slab on one card, each chunk is
    one replay of one CUDA graph that holds every slab's steps, stage 02
    and the loop's guard; with slabs on several cards, the ranks' eager
    chunk (``chunk.route``; ``core/step.py:make_chunk_body``).  Returns
    (function of the tuple of slab states, cfg with rank 0's context)."""
    cfg = sharded_config(cfg, mesh, timeout)
    return make_interval_fn(cfg), cfg


def make_sharded_fixed_steps_fn(cfg: StepConfig, mesh: Mesh, n_steps: int,
                                timeout: float = DEFAULT_TIMEOUT):
    """Exactly ``n_steps`` steps on every slab (benchmark and test helper;
    ``core/step.py:make_fixed_steps_fn`` over the chunk of all slabs);
    ``cfg`` is a sharded simulation's."""
    return make_fixed_steps_fn(sharded_config(cfg, mesh, timeout), n_steps)


def shard_simulation(sim: Simulation, mesh: Optional[Mesh] = None,
                     min_halo: int = 0,
                     timeout: float = DEFAULT_TIMEOUT) -> Simulation:
    """A copy of ``sim`` cut into ``mesh.size`` slabs: ``state`` is the tuple
    of slab states on the mesh's devices, ``interval_fn`` steps them SPMD
    (``mesh=None``: one slab per visible card).

    As in the JAX package: the capacity is padded to a multiple of
    ``ndev * 512`` (kept so that the port's slabs are the JAX package's
    slabs; the port's kernels need no alignment); the state is pre-sorted
    with the in-step ordering rule, because the distributed rebuild migrates
    rows one hop at most; the halo is sized from the initial geometry with a
    2x margin (:func:`size_halo`) and guarded by the ``max_halo`` telemetry;
    the sweep kernel is ``core/driver.py:choose_sweep_kernel``'s for the
    slabs' window ``C + 2 * halo`` and the global capacity; stale
    ``max_halo`` and ``grid_escapes`` are reset.  With ``halo == 0`` the
    same kernels run on the whole gathered array.

    Not carried over, because the port's kernels have no such windows: the
    ``min_ct_cap`` floor with the chunk and program tables, and the rule that
    grows the halo to ``cseg + 128`` rows for the mDBC kernel."""
    mesh = mesh or make_mesh()
    ndev = mesh.size
    cfg0 = sim.cfg
    if isinstance(sim.state, tuple):
        raise ValueError("the simulation is already sharded")
    cap = sim.state.particles.capacity
    new_cap = int(-(-cap // (ndev * 512)) * (ndev * 512))
    state = pad_capacity(sim.state, new_cap)

    # pre-sort into global cell-sorted order, by THE rule of the in-step
    # rebuild (position_half, a scratch array, is permuted along here)
    p0 = state.particles
    H_inv = cfg0.spec.kernel.H_inv
    keys0, coords = cl.sort_keys(p0, H_inv, cfg0.grid)
    perm0 = torch.argsort(keys0, stable=True)
    p0 = p0.permute(perm0).replace(cell=coords.index_select(0, perm0))
    zero = torch.zeros((), dtype=torch.int32, device=p0.device)
    state = state.replace(
        particles=p0, cell_start=cl.segment_starts(keys0, cfg0.grid.ncells),
        position_half=state.position_half.index_select(0, perm0),
        max_halo=zero, grid_escapes=zero.clone())

    C = new_cap // ndev
    mdbc = sim.meta.mdbc is MDBCMode.SIMPLE
    need = measure_halo(p0.position.cpu().numpy(), p0.active.cpu().numpy(), H_inv,
                        cfg0.grid, ndev, new_cap,
                        ghost_points=p0.ghost_points.cpu().numpy() if mdbc else None)
    halo = size_halo(need, C, min_halo)

    n_ext = C + 2 * halo if halo > 0 else new_cap
    cfg = dataclasses.replace(cfg0, halo=halo, sweep_kernel=choose_sweep_kernel(
        sim.meta.block_sweep, new_cap, n_ext))
    interval_fn, cfg = make_sharded_interval_fn(cfg, mesh, timeout)
    return Simulation(cfg=cfg, state=split_state(state, mesh.devices),
                      meta=sim.meta, n_live=sim.n_live, interval_fn=interval_fn,
                      mesh=mesh)
