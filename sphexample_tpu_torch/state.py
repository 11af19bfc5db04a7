"""Particle state: flat structure-of-arrays dataclasses of torch tensors.

The port of ``sphexample_tpu/state.py``: the reference's 17-field
``StructArray`` SoA (reference ``src/PreProcess.jl:114``) as tensors on one
chosen device, padded to a static capacity (``active`` marks live slots) and
kept *cell-sorted* between lazy rebuilds so that all neighbor candidates are
contiguous row segments of the arrays.

The JAX package's Pallas table fields (``PallasTables``, ``BlockTables`` and
their telemetry) have no counterpart: the port's CUDA sweep reads only
``cell_start``, the stale cell coordinates and the sorted order.

A sharded simulation's state is a tuple of P slab states, one per rank
(:func:`split_state`, :func:`gather_state`): the per-particle arrays are cut
into P contiguous slabs of the global sorted order, each on its rank's
device; ``cell_start`` and the scalars are replicated.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .config import ParticleType


@dataclass
class Particles:
    """Cell-sorted particle SoA.  Field names mirror the reference
    StructArray (PreProcess.jl:114); ``active`` is the padding mask and
    ``cell`` the per-dimension cell coordinates of the last rebuild."""

    cell: torch.Tensor            # [N, D] int32 cell coords from last rebuild
    chunk_id: torch.Tensor        # [N] int32 - owning compute block (ParaView parity)
    kernel_w: torch.Tensor        # [N] kernel sums (only filled in STORE mode)
    kernel_grad: torch.Tensor     # [N, D]
    position: torch.Tensor        # [N, D]
    acceleration: torch.Tensor    # [N, D]
    velocity: torch.Tensor        # [N, D]
    density: torch.Tensor         # [N]
    pressure: torch.Tensor        # [N]
    gravity_factor: torch.Tensor  # [N] float: Fluid -1, Moving +1, Fixed 0
    motion_limiter: torch.Tensor  # [N] float: Fluid 1 else 0
    boundary_bool: torch.Tensor   # [N] uint8 = !motion_limiter
    id: torch.Tensor              # [N] int32 1-based particle id (-1 for padding)
    ptype: torch.Tensor           # [N] int32 ParticleType enum value
    group_marker: torch.Tensor    # [N] int32
    ghost_points: torch.Tensor    # [N, D] zero when no associated ghost node
    ghost_normals: torch.Tensor   # [N, D]
    active: torch.Tensor          # [N] bool padding mask

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def dims(self) -> int:
        return self.position.shape[1]

    @property
    def device(self) -> torch.device:
        return self.position.device

    def replace(self, **kwargs) -> "Particles":
        return dataclasses.replace(self, **kwargs)

    def tensors(self) -> tuple:
        """Every field, in declaration order."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    @classmethod
    def from_tensors(cls, tensors) -> "Particles":
        """The inverse of :meth:`tensors`."""
        return cls(*tensors)

    def map(self, fn) -> "Particles":
        """``fn`` applied to every per-particle field."""
        return Particles.from_tensors(fn(a) for a in self.tensors())

    def permute(self, perm: torch.Tensor) -> "Particles":
        """Reorder every per-particle field by ``perm`` (the reference's full
        17-field StructArray sort, SPHCellList.jl:142)."""
        return self.map(lambda a: a.index_select(0, perm))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[str(dtype)]


def allocate_particles(
    position: np.ndarray,
    density: np.ndarray,
    ptype: np.ndarray,
    group_marker: np.ndarray,
    idp: np.ndarray,
    *,
    device,
    dtype=torch.float32,
    capacity: Optional[int] = None,
) -> Particles:
    """Build Particles on ``device`` from host arrays (one row per particle).

    Mirrors ``AllocateDataStructures`` (reference PreProcess.jl:45-119):
    GravityFactor (Fluid -1, Moving +1, Fixed 0; :79-87), MotionLimiter
    (Fluid 1 else 0; :89-98), BoundaryBool (:100), zero-initialised dynamic
    fields (:102-112), rows sorted by particle ID (:116).  Slots beyond the
    live count are inactive padding.
    """
    dtype = _torch_dtype(dtype)
    n, dims = position.shape
    capacity = int(capacity or n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < particle count {n}")

    order = np.argsort(idp, kind="stable")
    position = np.asarray(position, dtype=np.float64)[order]
    density = np.asarray(density, dtype=np.float64)[order]
    ptype = np.asarray(ptype, dtype=np.int32)[order]
    group_marker = np.asarray(group_marker, dtype=np.int32)[order]
    idp = np.asarray(idp, dtype=np.int64)[order]

    gravity_factor = np.zeros(n)
    gravity_factor[ptype == ParticleType.FLUID] = -1.0
    gravity_factor[ptype == ParticleType.MOVING] = 1.0
    motion_limiter = (ptype == ParticleType.FLUID).astype(np.float64)
    boundary_bool = (motion_limiter == 0).astype(np.uint8)

    def pad(a, fill=0):
        a = np.asarray(a)
        out = np.full((capacity,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out

    def t(a, dt, fill=0):
        return torch.as_tensor(pad(a, fill)).to(device=device, dtype=dt)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Particles(
        cell=zeros(capacity, dims, dt=torch.int32),
        chunk_id=zeros(capacity, dt=torch.int32),
        kernel_w=zeros(capacity),
        kernel_grad=zeros(capacity, dims),
        position=t(position, dtype),
        acceleration=zeros(capacity, dims),
        velocity=zeros(capacity, dims),
        density=t(density, dtype),
        pressure=zeros(capacity),
        gravity_factor=t(gravity_factor, dtype),
        motion_limiter=t(motion_limiter, dtype),
        boundary_bool=t(boundary_bool, torch.uint8),
        id=t(idp, torch.int32, fill=-1),
        ptype=t(ptype, torch.int32),
        group_marker=t(group_marker, torch.int32),
        ghost_points=zeros(capacity, dims),
        ghost_normals=zeros(capacity, dims),
        active=torch.as_tensor(np.arange(capacity) < n).to(device),
    )


@dataclass
class SimulationState:
    """Full simulation state: particles + neighbor structure + the mutable
    counters the reference keeps in ``SimulationMetaData``.  Scalars are
    0-dim tensors on the particles' device."""

    particles: Particles
    cell_start: torch.Tensor      # [ncells + 2] int32 segment starts (incl. parking)
    total_time: torch.Tensor      # scalar
    current_dt: torch.Tensor      # scalar
    iteration: torch.Tensor       # scalar int32
    max_occupancy: torch.Tensor   # scalar int32 - max cell occupancy seen
    max_segment: torch.Tensor     # scalar int32 - max 3-cell row segment length
    occupied_cells: torch.Tensor  # scalar int32 - occupied-cell count at rebuild
    # Scratch half-step position kept across steps ONLY for the lazy-rebuild
    # displacement rule (update_delta_x!, reference SPHCellList.jl:706-724).
    # Like the reference, it is NOT permuted on resort (scratch arrays are not
    # part of the StructArray sort) - a faithful cadence quirk.
    position_half: torch.Tensor   # [N, D]
    # Active particles whose unclamped cell coords fell outside the static
    # grid at any rebuild (they are clamped into edge cells: wrong physics);
    # run_simulation re-grids and replays the interval when it is nonzero.
    grid_escapes: torch.Tensor    # scalar int32
    # Sharded runs: the furthest sorted-row reach of any stencil window (and
    # of the rebuild's row migration) past its slab's boundaries, the maximum
    # over every rebuild.  It must stay <= the halo (``StepConfig.halo``);
    # ``run_simulation`` raises when it does not.  0 on a single device.
    max_halo: torch.Tensor        # scalar int32
    # Lazy rebuilds taken: a scalar int32 counter on the state's device
    # (a chunk's graph adds to it; an int given here is put there).  Not
    # part of the JAX state.
    rebuilds: Optional[torch.Tensor] = None

    def __post_init__(self):
        if not isinstance(self.rebuilds, torch.Tensor):
            self.rebuilds = torch.full((), int(self.rebuilds or 0), dtype=torch.int32,
                                       device=self.total_time.device)

    def replace(self, **kwargs) -> "SimulationState":
        return dataclasses.replace(self, **kwargs)


_PARTICLE_FIELDS = tuple(f.name for f in dataclasses.fields(Particles))
_STATE_TENSORS = ("cell_start", "total_time", "current_dt", "iteration",
                  "max_occupancy", "max_segment", "occupied_cells",
                  "position_half", "grid_escapes", "max_halo")
# what is cut into slabs (beside the particle fields) / replicated
_SLAB_TENSORS = ("position_half",)


def pad_capacity(state: SimulationState, new_capacity: int) -> SimulationState:
    """Grow the particle capacity with inactive padding rows (id -1)."""
    old = state.particles.capacity
    if new_capacity == old:
        return state
    if new_capacity < old:
        raise ValueError("cannot shrink capacity")
    extra = new_capacity - old

    def pad(a):
        return torch.cat([a, torch.zeros((extra,) + tuple(a.shape[1:]), dtype=a.dtype,
                                         device=a.device)], dim=0)

    parts = state.particles.map(pad)
    parts.id[old:] = -1
    return state.replace(particles=parts, position_half=pad(state.position_half))


def split_state(state: SimulationState, devices) -> tuple:
    """Cut one (globally cell-sorted) state into ``len(devices)`` slab states:
    equal contiguous slabs of the per-particle arrays, everything else
    replicated, slab r on ``devices[r]``."""
    n = len(devices)
    cap = state.particles.capacity
    if cap % n:
        raise ValueError(f"capacity {cap} is not a multiple of {n} slabs")
    C = cap // n
    slabs = []
    for r, dev in enumerate(devices):
        cut = lambda a: a[r * C:(r + 1) * C].to(dev, copy=True)  # noqa: E731
        slabs.append(dataclasses.replace(
            state, particles=state.particles.map(cut),
            rebuilds=state.rebuilds.to(dev, copy=True),
            **{k: cut(getattr(state, k)) for k in _SLAB_TENSORS},
            **{k: getattr(state, k).to(dev, copy=True) for k in _STATE_TENSORS
               if k not in _SLAB_TENSORS}))
    return tuple(slabs)


def gather_state(states, device=None) -> SimulationState:
    """The inverse of :func:`split_state`: one global state on ``device``
    (default: rank 0's), the replicated leaves taken from rank 0."""
    if isinstance(states, SimulationState):
        return states
    dev = states[0].particles.device if device is None else torch.device(device)
    cat = lambda get: torch.cat([get(s).to(dev) for s in states], dim=0)  # noqa: E731
    fields = dataclasses.fields(Particles)
    particles = Particles(**{f.name: cat(lambda s, k=f.name: getattr(s.particles, k))
                             for f in fields})
    first = states[0]
    return dataclasses.replace(
        first, particles=particles, rebuilds=first.rebuilds.to(dev),
        **{k: cat(lambda s, k=k: getattr(s, k)) for k in _SLAB_TENSORS},
        **{k: getattr(first, k).to(dev) for k in _STATE_TENSORS
           if k not in _SLAB_TENSORS})


def state_from_numpy(leaves: Dict[str, np.ndarray], device, devices=None):
    """Build the port's state from a flat dict of numpy leaves, named like
    the JAX ``SimulationState``'s fields (``"particles.position"``,
    ``"cell_start"``, ``"total_time"``, ...).  Keys the port has no field
    for (the JAX package's Pallas tables and telemetry) are ignored; a
    missing key raises ``KeyError``.  Dtypes are kept as given.

    With ``devices`` (one per slab, e.g. a mesh's) the leaves are a sharded
    JAX state's global arrays and the result is the tuple of slab states."""
    def t(key):
        return torch.tensor(np.asarray(leaves[key]), device=device)

    particles = Particles(**{f: t(f"particles.{f}") for f in _PARTICLE_FIELDS})
    state = SimulationState(particles=particles,
                            **{k: t(k) for k in _STATE_TENSORS})
    return state if devices is None else split_state(state, devices)


def state_tensors(state: SimulationState) -> Dict[str, torch.Tensor]:
    """Every tensor of a single-device state by the flat names of
    :func:`state_from_numpy` (``"particles.position"``, ``"cell_start"``,
    ...), without a copy."""
    out = {f"particles.{f}": getattr(state.particles, f) for f in _PARTICLE_FIELDS}
    out.update({k: getattr(state, k) for k in _STATE_TENSORS})
    return out


def state_leaves(state: SimulationState) -> tuple:
    """Every tensor of a single-device state, ``rebuilds`` included, in a
    fixed order (:func:`clone_state`, :func:`copy_state_`)."""
    return (state.particles.tensors() + tuple(getattr(state, k) for k in _STATE_TENSORS)
            + (state.rebuilds,))


def clone_state(state: SimulationState) -> SimulationState:
    """A copy of ``state`` that shares no storage with it."""
    leaves = [a.clone() for a in state_leaves(state)]
    n = len(_PARTICLE_FIELDS)
    return SimulationState(particles=Particles.from_tensors(leaves[:n]),
                           **dict(zip(_STATE_TENSORS, leaves[n:-1])),
                           rebuilds=leaves[-1])


def copy_state_(dst: SimulationState, src: SimulationState) -> None:
    """Write every tensor of ``src`` into the same tensor of ``dst``, in
    place (shapes and dtypes must agree); a tensor that is already ``dst``'s
    is skipped."""
    for d, s in zip(state_leaves(dst), state_leaves(src)):
        if d is not s:
            d.copy_(s)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy`: a flat dict of numpy leaves
    (of the gathered global state when given a tuple of slab states)."""
    return {k: v.cpu().numpy() for k, v in state_tensors(gather_state(state)).items()}
