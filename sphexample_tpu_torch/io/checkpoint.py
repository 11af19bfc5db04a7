"""Checkpoint / resume (port of ``sphexample_tpu/io/checkpoint.py``; the
reference has none).

Whole-``SimulationState`` snapshots as compressed ``.npz``: every particle
field, the neighbor structure and the loop counters, so a resumed run
continues bit for bit from the saved output time (the interval-local
displacement accumulator resets at every interval start by design - the same
reset the reference performs every ``SimulationLoop`` call).

The file format is the JAX package's, so that a file written by either
package loads into the other: every leaf is stored under ``f::`` followed by
JAX's ``keystr`` of its pytree path (``f::.particles.position``,
``f::.cell_start``, ``f::.total_time``, ...), beside ``counter`` and
``capacity``.  The port adds keys the JAX loader ignores: its rebuild
count (``rebuilds``, an int; the state holds it as a device counter) and
the grid the state was stepped on (``grid_cmin``, ``grid_shape``: a run
that re-gridded resumes on its grown grid).  The JAX
package's Pallas tables and their telemetry (``pallas_tables``,
``block_tables``, ``max_chunks``) have no counterpart in the port: they are
skipped on load.  Particle-axis arrays are padded with inactive rows (``id =
-1``) when the simulation's capacity is larger than the file's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from ..state import (SimulationState, gather_state, pad_capacity, split_state,
                     state_from_numpy, state_tensors, state_to_numpy)

# telemetry that older checkpoints of the JAX package lack; zero re-accumulates
_OPTIONAL = ("grid_escapes",)


def save_checkpoint(path: str, state, counter: int, grid=None):
    """Write ``state`` (a tuple of slab states is gathered first) as the
    snapshot for output ``counter``; ``grid`` (a ``cell_list.Grid``) records
    the grid it was stepped on, which :func:`resume_simulation` adopts."""
    state = gather_state(state)
    arrays = {f"f::.{k}": v for k, v in state_to_numpy(state).items()}
    extras = dict(
        counter=np.asarray(counter),
        capacity=np.asarray(state.particles.capacity),
        rebuilds=np.asarray(int(state.rebuilds)),
    )
    if grid is not None:
        extras.update(grid_cmin=np.asarray(grid.cmin), grid_shape=np.asarray(grid.shape))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **extras, **arrays)


def load_checkpoint(path: str, template: SimulationState) -> Tuple[SimulationState, int]:
    """Restore into the structure, dtypes and device of ``template`` (a
    single-device state).  Particle-axis arrays whose capacity differs are
    padded with inactive slots (the template's capacity must be >= the
    saved one - :func:`resume_simulation` grows a simulation first).
    Returns ``(state, counter)``."""
    with np.load(path) as data:
        return _load_into(data, template)


def _load_into(data, template: SimulationState) -> Tuple[SimulationState, int]:
    if "capacity" not in data:
        raise ValueError(
            "checkpoint has no 'capacity': a legacy positional checkpoint of "
            "the JAX package; re-save it there to migrate")
    cap_saved = int(data["capacity"])
    cap_t = int(template.particles.capacity)
    if cap_t < cap_saved:
        raise ValueError(
            f"checkpoint capacity {cap_saved} exceeds the simulation's "
            f"{cap_t}; grow it first (resume_simulation does this)"
        )
    leaves = {}
    for name, leaf in state_tensors(template).items():
        kp = f".{name}"
        dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        if f"f::{kp}" not in data:
            if name in _OPTIONAL:
                leaves[name] = np.zeros(tuple(leaf.shape), dtype)
                continue
            raise ValueError(f"checkpoint is missing state leaf {kp!r}")
        arr = data[f"f::{kp}"]
        if arr.shape != tuple(leaf.shape):
            ok_pad = (
                arr.ndim >= 1 and leaf.ndim == arr.ndim
                and arr.shape[0] == cap_saved and leaf.shape[0] == cap_t
                and arr.shape[1:] == tuple(leaf.shape[1:])
            )
            if not ok_pad:
                raise ValueError(
                    f"checkpoint leaf {kp!r} shape {arr.shape} != template "
                    f"{tuple(leaf.shape)} and is not a particle-axis array"
                )
            padded = np.zeros(leaf.shape, dtype=arr.dtype)
            padded[:cap_saved] = arr
            if kp.endswith(".id"):
                padded[cap_saved:] = -1  # pad_capacity's convention
            arr = padded
        leaves[name] = arr.astype(dtype, copy=False)
    state = state_from_numpy(leaves, template.particles.device)
    # an int either way: the files store one, and the state holds it on its
    # device (SimulationState.__post_init__)
    rebuilds = int(data["rebuilds"]) if "rebuilds" in data else int(template.rebuilds)
    return state.replace(rebuilds=rebuilds), int(data["counter"])


def resume_simulation(sim, path: str):
    """Resume ``sim`` from ``path``: grows its capacity to the checkpoint's
    when that is larger, adopts the checkpoint's grid when it records one (a
    run that re-gridded), then loads.  Returns ``(sim, start_counter)``; pass
    the counter to ``run_simulation(sim, start_counter=...)``.

    A sharded ``sim`` (a tuple of slab states) takes the checkpoint's global
    arrays cut into its slabs, with its mesh and halo, as the JAX function
    does (its sharded interval function takes the loaded global state); the
    checkpoint's capacity must not exceed the sharded capacity."""
    from ..core.driver import Simulation
    from ..ops.cell_list import Grid

    with np.load(path) as npz:
        cap = int(npz["capacity"]) if "capacity" in npz else 0
        grid = None
        if "grid_shape" in npz:
            grid = Grid(cmin=tuple(int(v) for v in npz["grid_cmin"]),
                        shape=tuple(int(v) for v in npz["grid_shape"]))
    sharded = isinstance(sim.state, tuple)
    state = gather_state(sim.state)
    if cap > state.particles.capacity:
        if sharded:
            raise ValueError(
                f"checkpoint capacity {cap} exceeds the sharded simulation's "
                f"{state.particles.capacity}: resume the single-device "
                "simulation, then shard it")
        state = pad_capacity(state, cap)
    cfg = sim.cfg
    if grid is not None and grid != cfg.grid:
        cfg = dataclasses.replace(cfg, grid=grid)
        state = state.replace(cell_start=torch.zeros(
            (grid.ncells + 2,), dtype=torch.int32, device=state.cell_start.device))
    state, start_counter = load_checkpoint(path, state)
    if sharded:
        from ..parallel.mesh import make_sharded_interval_fn

        interval_fn = sim.interval_fn
        if cfg is not sim.cfg:
            interval_fn, cfg = make_sharded_interval_fn(cfg, sim.mesh)
        sim = Simulation(cfg=cfg, state=split_state(state, sim.mesh.devices),
                         meta=sim.meta, n_live=sim.n_live, interval_fn=interval_fn,
                         mesh=sim.mesh)
        return sim, start_counter
    if cfg is not sim.cfg:
        sim = Simulation(cfg=cfg, state=state, meta=sim.meta, n_live=sim.n_live)
    sim.state = state
    return sim, start_counter
