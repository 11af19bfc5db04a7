"""The 3D dam break's particles: a 1.6 x 0.67 x 0.45 m tank (five
single-layer walls, open top) with a 0.4 x 0.65 x 0.3 m water column at one
end, every site of a lattice of pitch ``dx`` at ``(i + 0.5) dx``.

A numpy copy of the port's ``io/casegen.py:dam_break_3d`` (the extents of
SPHExample's ``input/dam_break_3d/DamBreak3d_Dp0.02_*.csv``): at dx 0.0085,
159,712 particles.  ``geometry`` is the configuration's ``geometry`` group.
"""

import numpy as np

FLUID, FIXED = 1, 2


def _lattice(n, dx):
    return (np.arange(n) + 0.5) * dx


def build(geometry):
    """(position [n, 3], density, ptype, group_marker, idp) host arrays,
    walls first (marker 1), then the fluid (marker 2); ids from 1."""
    dx = geometry["dx"]
    Lx, Ly, Lz = geometry["tank"]
    Fx, Fz = geometry["column"]
    nx, ny, nz = (int(round(L / dx)) for L in (Lx, Ly, Lz))
    gx, gy, gz = _lattice(nx, dx), _lattice(ny, dx), _lattice(nz, dx)

    X, Y, Z = np.meshgrid(gx, gy, gz, indexing="ij")
    shell = (X == gx[0]) | (X == gx[-1]) | (Y == gy[0]) | (Y == gy[-1]) | (Z == gz[0])
    walls = np.stack([X[shell], Y[shell], Z[shell]], axis=-1)

    fx = gx[(gx > gx[0]) & (gx <= gx[0] + Fx)][1:]
    fy = gy[(gy > gy[0]) & (gy < gy[-1])][1:-1]
    fz = gz[(gz > gz[0]) & (gz <= gz[0] + Fz)][1:]
    FX, FY, FZ = np.meshgrid(fx, fy, fz, indexing="ij")
    fluid = np.stack([FX.ravel(), FY.ravel(), FZ.ravel()], axis=-1)

    pos = np.concatenate([walls, fluid])
    nb, nf = len(walls), len(fluid)
    ptype = np.repeat(np.array([FIXED, FLUID], np.int32), [nb, nf])
    marker = np.repeat(np.array([1, 2], np.int32), [nb, nf])
    return pos, np.full(len(pos), 1000.0), ptype, marker, np.arange(1, len(pos) + 1)
