"""Procedural case generators (a copy of ``sphexample_tpu/io/casegen.py``).

The 3D dam break is a 1.6 x 0.67 x 0.45 m tank (five single-layer walls,
open top) with a 0.4 x 0.65 x 0.3 m water column at one end - extents taken
from the reference's ``input/dam_break_3d/DamBreak3d_Dp0.02_*.csv``.
"""

from __future__ import annotations

import numpy as np

from ..config import ParticleType


def _lattice(n, dx):
    return (np.arange(n) + 0.5) * dx


def dam_break_3d(dx: float = 0.0085):
    """Returns (position, density, ptype, group_marker, idp) host arrays."""
    Lx, Ly, Lz = 1.60, 0.67, 0.45
    # the column spans the FULL tank width minus one lattice gap per side
    Fx, Fz = 0.40, 0.30

    nx, ny, nz = int(round(Lx / dx)), int(round(Ly / dx)), int(round(Lz / dx))
    gx, gy, gz = _lattice(nx, dx), _lattice(ny, dx), _lattice(nz, dx)

    # five single-layer walls (open top), like the reference bound CSV
    X, Y, Z = np.meshgrid(gx, gy, gz, indexing="ij")
    shell = (
        (X == gx[0]) | (X == gx[-1])
        | (Y == gy[0]) | (Y == gy[-1])
        | (Z == gz[0])
    )
    walls = np.stack([X[shell], Y[shell], Z[shell]], axis=-1)

    # fluid column, one lattice gap from the walls
    fx = gx[(gx > gx[0]) & (gx <= gx[0] + Fx)][1:]
    fy = gy[(gy > gy[0]) & (gy < gy[-1])][1:-1]
    fz = gz[(gz > gz[0]) & (gz <= gz[0] + Fz)][1:]
    FX, FY, FZ = np.meshgrid(fx, fy, fz, indexing="ij")
    fluid = np.stack([FX.ravel(), FY.ravel(), FZ.ravel()], axis=-1)

    pos = np.concatenate([walls, fluid])
    nb, nf = len(walls), len(fluid)
    ptype = np.concatenate(
        [np.full(nb, int(ParticleType.FIXED)), np.full(nf, int(ParticleType.FLUID))]
    ).astype(np.int32)
    dens = np.full(len(pos), 1000.0)
    grp = np.concatenate([np.full(nb, 1), np.full(nf, 2)]).astype(np.int32)
    idp = np.arange(1, len(pos) + 1)
    return pos, dens, ptype, grp, idp


def dam_break_2d(dx: float = 0.01):
    """2D (x-z plane) dam break: 1.6 x 0.45 tank, 0.4 x 0.3 column."""
    Lx, Lz = 1.60, 0.45
    Fx, Fz = 0.40, 0.30
    nx, nz = int(round(Lx / dx)), int(round(Lz / dx))
    gx, gz = _lattice(nx, dx), _lattice(nz, dx)
    X, Z = np.meshgrid(gx, gz, indexing="ij")
    shell = (X == gx[0]) | (X == gx[-1]) | (Z == gz[0])
    walls = np.stack([X[shell], Z[shell]], axis=-1)
    fx = gx[(gx > gx[0]) & (gx <= gx[0] + Fx)][1:]
    fz = gz[(gz > gz[0]) & (gz <= gz[0] + Fz)][1:]
    FX, FZ = np.meshgrid(fx, fz, indexing="ij")
    fluid = np.stack([FX.ravel(), FZ.ravel()], axis=-1)
    pos = np.concatenate([walls, fluid])
    nb, nf = len(walls), len(fluid)
    ptype = np.concatenate(
        [np.full(nb, int(ParticleType.FIXED)), np.full(nf, int(ParticleType.FLUID))]
    ).astype(np.int32)
    dens = np.full(len(pos), 1000.0)
    grp = np.concatenate([np.full(nb, 1), np.full(nf, 2)]).astype(np.int32)
    idp = np.arange(1, len(pos) + 1)
    return pos, dens, ptype, grp, idp
