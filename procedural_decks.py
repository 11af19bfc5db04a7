"""Procedural inputs for the mDBC and moving-body decks, in each deck's own
CSV layout (the reference decks' input CSVs are not in the repository).

numpy only: it imports neither ``torch`` nor either package, so that the
card's ``chip_smoke.py``, ``compare_case.py`` (both packages on the CPU) and
the tests build the same bytes.

- :func:`write_still_tank` - a still-water tank for the ``duckling_mdbc``
  deck (``examples/duckling_mdbc.py`` and its port): the deck's dx 0.01 and
  constants, three FIXED lattice layers on the floor and all four sides (open
  top), every wall row's ghost point its reflection about each interface plane
  it lies beyond, the initial densities from the inverse equation of state of
  the hydrostatic column.  Files
  ``case_duckling_mdbc/CaseDuckling_Dp0.01_{Bound_MDBC,Fluid_MDBC,GhostNodes}.csv``.
- :func:`write_moving_square` - a closed box for the ``moving_square_2d``
  deck: 10.0 x 5.0 m inside, three FIXED wall layers, fluid around a 1.0 m
  square of MOVING rows (marker 3) centred at (1.5, 2.5) m, in the manner of
  SPHERIC benchmark test 6 (a square towed through a closed tank); long
  enough for the deck's 2.8 m/s for 2.5 s (7.0 m).  Files
  ``moving_square_2d/MovingSquare_Dp{dp}_{Fixed,Fluid,Square}.csv``.

Every lattice site sits at ``(i + 0.5) dx + OFF``: the global shift of
``tests/test_trajectory.py:35-42`` keeps coordinates off the half-integer
cell boundary, where numpy's and the devices' roundings may pick different
cells.  ``Idp`` runs from 0 over the files in the deck's order (the loaders
add 1).  Run as a script to write a case:

    python3 procedural_decks.py still_tank DIR [--size full|coarse]
    python3 procedural_decks.py moving_square DIR [--dp 0.02]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

OFF = 0.0037
RHO0, GAMMA, G = 1000.0, 7.0, 9.81
LAYERS = 3
FLUID, FIXED, MOVING = 1, 2, 3      # config.ParticleType of both packages

# the duckling_mdbc deck's spacing and sound speed (examples/duckling_mdbc.py)
TANK_DX = 0.01
TANK_C0 = 23.43842998154953
# lattice sites inside the tank: floor nx x ny, water depth, wall height
TANK_SIZES = {
    "full": dict(nx=100, ny=50, depth=30, height=40),     # 1.00 x 0.50 m, 0.30 m deep
    "coarse": dict(nx=5, ny=5, depth=30, height=40),      # 0.05 x 0.05 m, the same depth
}
TANK_FILES = "case_duckling_mdbc/CaseDuckling_Dp0.01"

# the moving square (examples/moving_square_2d.py: 2.8 m/s in +x for 3 s)
SQUARE_BOX = (10.0, 5.0)
SQUARE_SIDE = 1.0
SQUARE_CENTRE = (1.5, 2.5)
SQUARE_SPEED = 2.8
SQUARE_DP = {"full": 0.02, "coarse": 0.1}

PARTICLE_HEADER = "Points:0,Points:1,Points:2,Idp,Rhop"
NORMAL_HEADER = "Normal:0,Normal:1,Normal:2,Points:0,Points:1,Points:2"


def _lattice(lo, hi):
    """Integer sites of the box [lo, hi) per axis, [n, dims], x slowest."""
    axes = [np.arange(a, b) for a, b in zip(lo, hi)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, len(axes))


def hydrostatic_density(z, top, c0):
    """The inverse equation of state at rho0 g (top - z) (B = c0^2 rho0 / gamma),
    as ``tests/test_torch_physics_validation.py:_write_tank`` sets it."""
    B = c0**2 * RHO0 / GAMMA
    return RHO0 * (1 + RHO0 * G * (top - z) / B) ** (1 / GAMMA)


def still_tank(nx, ny, depth, height, dx=TANK_DX, c0=TANK_C0, layers=LAYERS):
    """The still tank's rows: ``boundary`` [nb, 3] (walls first in the deck's
    order), ``fluid`` [nf, 3], ``ghosts`` [nb, 3] (each wall row's reflection
    about the interface planes x = 0, x = nx dx, y = 0, y = ny dx, z = 0 it
    lies beyond), ``rho_b``, ``rho_f``.  Shifted by ``OFF``."""
    idx = _lattice((-layers, -layers, -layers), (nx + layers, ny + layers, height))
    wall = (np.any(idx < 0, axis=-1) | (idx[:, 0] >= nx) | (idx[:, 1] >= ny))
    fluid = ~wall & (idx[:, 2] < depth)
    pts = (idx + 0.5) * dx
    rho = hydrostatic_density(pts[:, 2], (depth - 0.5) * dx, c0)
    hi = np.array([nx * dx, ny * dx, np.inf])
    walls = pts[wall]
    ghosts = np.where(walls < 0, -walls, walls)
    ghosts = np.where(walls > hi, 2 * hi - walls, ghosts)
    return {"boundary": walls + OFF, "fluid": pts[fluid] + OFF, "ghosts": ghosts + OFF,
            "rho_b": rho[wall], "rho_f": rho[fluid]}


def moving_square(dp, box=SQUARE_BOX, side=SQUARE_SIDE, centre=SQUARE_CENTRE,
                  layers=LAYERS):
    """The moving square's rows in x-z: ``fixed``, ``fluid``, ``square``
    ([n, 2] each) at spacing ``dp``; all at rho0 (g = 0).  Shifted by ``OFF``."""
    nx, nz = (int(round(L / dp)) for L in box)
    idx = _lattice((-layers, -layers), (nx + layers, nz + layers))
    wall = np.any((idx < 0) | (idx >= [nx, nz]), axis=-1)
    lo = [int(round((c - side / 2) / dp)) for c in centre]
    hi = [int(round((c + side / 2) / dp)) for c in centre]
    body = ~wall & np.all((idx >= lo) & (idx < hi), axis=-1)
    pts = (idx + 0.5) * dp + OFF
    return {"fixed": pts[wall], "fluid": pts[~wall & ~body], "square": pts[body]}


def _xz(a):
    return a if a.shape[1] == 3 else np.stack([a[:, 0], np.zeros(len(a)), a[:, 1]], axis=-1)


def _write(path, header, table):
    """One CSV, every value as Python's ``repr`` (the loaders read it back
    to the same bits)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(header + "\n")
        fh.writelines(",".join(map(repr, row)) + "\n" for row in table.tolist())


def _write_bodies(paths, bodies, densities):
    """Particle CSVs with ``Idp`` consecutive over the files, from 0."""
    start = 0
    for path, pts, rho in zip(paths, bodies, densities):
        n = len(pts)
        idp = np.arange(start, start + n, dtype=np.float64)
        _write(path, PARTICLE_HEADER,
               np.concatenate([_xz(pts), idp[:, None], rho[:, None]], axis=1))
        start += n


def write_still_tank(root, size="full"):
    """The still tank of ``TANK_SIZES[size]`` (or of the lattice counts
    ``size``, a dict of :func:`still_tank`'s) under ``root`` (the deck's
    ``--input``); returns the case of :func:`still_tank` with ``paths``."""
    case = still_tank(**(TANK_SIZES[size] if isinstance(size, str) else size))
    base = os.path.join(root, TANK_FILES)
    paths = {k: f"{base}_{k}.csv" for k in ("Bound_MDBC", "Fluid_MDBC", "GhostNodes")}
    _write_bodies((paths["Bound_MDBC"], paths["Fluid_MDBC"]),
                  (case["boundary"], case["fluid"]), (case["rho_b"], case["rho_f"]))
    _write(paths["GhostNodes"], NORMAL_HEADER,
           np.concatenate([case["ghosts"] - case["boundary"], case["boundary"]], axis=1))
    return {**case, "paths": paths}


def write_moving_square(root, dp=SQUARE_DP["full"]):
    """The moving square at ``dp`` under ``root`` (the deck's ``--input``,
    run with ``--dp dp``); returns the case of :func:`moving_square` with
    ``paths``."""
    case = moving_square(dp)
    base = os.path.join(root, "moving_square_2d", f"MovingSquare_Dp{dp}")
    paths = {k: f"{base}_{k}.csv" for k in ("Fixed", "Fluid", "Square")}
    bodies = (case["fixed"], case["fluid"], case["square"])
    _write_bodies(tuple(paths.values()), bodies, [np.full(len(b), RHO0) for b in bodies])
    return {**case, "paths": paths}


def still_tank_arrays(case):
    """``(position, density, ptype, group_marker, idp), ghost_points,
    ghost_normals`` as the deck assembles them from the files (FIXED rows
    with marker 1 first, then FLUID with marker 2; ids from 1; the ghost
    point is the file's point plus its normal, as the loader forms it)."""
    nb, nf = len(case["boundary"]), len(case["fluid"])
    arrays = (np.concatenate([case["boundary"], case["fluid"]]),
              np.concatenate([case["rho_b"], case["rho_f"]]),
              np.repeat(np.array([FIXED, FLUID], np.int32), [nb, nf]),
              np.repeat(np.array([1, 2], np.int32), [nb, nf]),
              np.arange(1, nb + nf + 1))
    normals = case["ghosts"] - case["boundary"]
    return arrays, case["boundary"] + normals, normals


def moving_square_arrays(case):
    """``(position, density, ptype, group_marker, idp)`` as the deck assembles
    them (FIXED marker 1, FLUID marker 2, MOVING marker 3; ids from 1)."""
    bodies = (case["fixed"], case["fluid"], case["square"])
    counts = [len(b) for b in bodies]
    n = sum(counts)
    return (np.concatenate(bodies), np.full(n, RHO0),
            np.repeat(np.array([FIXED, FLUID, MOVING], np.int32), counts),
            np.repeat(np.array([1, 2, 3], np.int32), counts), np.arange(1, n + 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("still_tank", "moving_square"))
    ap.add_argument("root")
    ap.add_argument("--size", default="full", choices=tuple(TANK_SIZES))
    ap.add_argument("--dp", type=float, default=SQUARE_DP["full"])
    args = ap.parse_args(argv)
    if args.case == "still_tank":
        case = write_still_tank(args.root, args.size)
        print(f"still tank: {len(case['boundary'])} wall rows, {len(case['fluid'])} fluid")
    else:
        case = write_moving_square(args.root, args.dp)
        print(f"moving square: {len(case['fixed'])} wall rows, {len(case['fluid'])} fluid, "
              f"{len(case['square'])} square")
    for path in case["paths"].values():
        print(path)


if __name__ == "__main__":
    main()
