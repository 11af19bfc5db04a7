"""Prescribed rigid-body motion for Moving particles (port of
``sphexample_tpu/core/motion.py``).

Reference: ``ProgressMotion`` (``src/SPHCellList.jl:575-596``) - applied twice
per step, once per half step (call sites SPHCellList.jl:765,787).  The
reference's per-GroupMarker ``MotionDefinition`` table (SPHCellList.jl:855-864)
becomes a small dense table indexed by group marker; its tensors are made
once per (table, device, dtype), so no step copies them from the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..config import Geometry, ParticleType


@dataclass(frozen=True)
class MotionTable:
    """Static per-group-marker motion parameters (row 0 unused; markers are
    1-based like the reference)."""

    velocity: Tuple[float, ...]
    start_time: Tuple[float, ...]
    duration: Tuple[float, ...]
    direction: Tuple[Tuple[float, ...], ...]
    defined: Tuple[bool, ...]

    @property
    def any_motion(self) -> bool:
        return any(self.defined)


def build_motion_table(geometries: Sequence[Geometry], dims: int) -> MotionTable:
    gmax = max((g.group_marker for g in geometries), default=0)
    vel = [0.0] * (gmax + 1)
    start = [0.0] * (gmax + 1)
    dur = [0.0] * (gmax + 1)
    direction = [tuple([0.0] * dims) for _ in range(gmax + 1)]
    defined = [False] * (gmax + 1)
    for g in geometries:
        if g.motion is not None:
            m = g.motion
            vel[g.group_marker] = float(m.velocity)
            start[g.group_marker] = float(m.start_time)
            dur[g.group_marker] = float(m.duration)
            direction[g.group_marker] = tuple(float(v) for v in m.direction)
            defined[g.group_marker] = True
    return MotionTable(
        velocity=tuple(vel),
        start_time=tuple(start),
        duration=tuple(dur),
        direction=tuple(direction),
        defined=tuple(defined),
    )


@functools.lru_cache(maxsize=None)
def _table_tensors(motion: MotionTable, device, dtype):
    """(velocity, start, end, direction, defined) of ``motion`` on ``device``.
    Made once: a per-call copy from the host would block it every step."""
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    start, dur = t(motion.start_time), t(motion.duration)
    return (t(motion.velocity), start, start + dur, t(motion.direction),
            torch.tensor(motion.defined, dtype=torch.bool, device=device))


def progress_motion(motion: MotionTable, particles, total_time, dt2):
    """Set velocity / advance position of Moving particles inside their motion
    window (reference SPHCellList.jl:575-596).  Velocity is *assigned* (zeroed
    outside the inclusive window ``start <= t <= start + duration``),
    position integrated by dt/2.  Only ``ptype == MOVING`` rows whose group
    marker has a motion are touched.  Returns (position, velocity); the
    inputs themselves when no motion is defined.
    """
    if not motion.any_motion:
        return particles.position, particles.velocity

    dtype = particles.position.dtype
    vel_t, start_t, end_t, dir_t, def_t = _table_tensors(
        motion, particles.position.device, dtype)

    marker = torch.clamp(particles.group_marker, 0, len(motion.velocity) - 1).long()
    is_moving = ((particles.ptype == int(ParticleType.MOVING)) & def_t[marker])[:, None]

    should = (start_t[marker] <= total_time) & (total_time <= end_t[marker])
    v = (vel_t[marker] * should.to(dtype))[:, None] * dir_t[marker]

    velocity = torch.where(is_moving, v, particles.velocity)
    position = torch.where(is_moving, particles.position + v * dt2, particles.position)
    return position, velocity
