"""The 3D dam break with mDBC walls: the fluid block of ``dam_break_3d.py``
in the same 1.6 x 0.67 x 0.45 m tank, its single wall layer replaced by
``wall_layers`` lattice layers (the original one and the further ones
outside it: floor and sides, open top), the boundary density set by SIMPLE
mDBC from each wall row's ghost point.

A numpy copy of the port's ``chip_smoke.py:mdbc_dam_break`` on the 3D case:
the interface planes lie dx / 2 inside the innermost wall layer, and a wall
row's ghost point is its reflection about every interface plane it lies
beyond (edge and corner rows reflect in 2 or 3 axes); its normal is ghost
minus position.  At dx 0.0085, 249,036 particles (131,736 wall rows).
``geometry`` is the configuration's ``geometry`` group.
"""

import importlib.util
from pathlib import Path

import numpy as np

FLUID, FIXED = 1, 2


def _fluid_block(geometry):
    """The fluid rows of ``dam_break_3d.py``, loaded by path as the harness
    loads a deck."""
    path = Path(__file__).with_name("dam_break_3d.py")
    spec = importlib.util.spec_from_file_location("portbench_decks_dam_break_3d", path)
    deck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(deck)
    pos, _, ptype, _, _ = deck.build(geometry)
    return pos[ptype == FLUID]


def build(geometry):
    """(position [n, 3], density, ptype, group_marker, idp, ghost_points
    [nb, 3], ghost_normals [nb, 3]) host arrays: walls first (marker 1, ids
    1..nb, the rows the ghosts belong to), then the fluid (marker 2)."""
    dx = geometry["dx"]
    extra = geometry["wall_layers"] - 1
    counts = [int(round(L / dx)) for L in geometry["tank"]]
    # lattice indices: the extra layers on every side but the open top
    axes = ([np.arange(-extra, n + extra) for n in counts[:-1]]
            + [np.arange(-extra, counts[-1])])
    idx = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    hi = np.array([n - 2 for n in counts[:-1]] + [np.iinfo(np.int64).max])
    wall = np.any((idx < 1) | (idx > hi), axis=-1)
    walls = (idx[wall] + 0.5) * dx
    # reflect about the interface planes x = dx and x = (n - 1) dx
    top = np.array([(n - 1) * dx for n in counts[:-1]] + [np.inf])
    ghost = np.where(walls < dx, 2 * dx - walls, walls)
    ghost = np.where(walls > top, 2 * top - walls, ghost)
    fluid = _fluid_block(geometry)
    nb, nf = len(walls), len(fluid)
    return (np.concatenate([walls, fluid]), np.full(nb + nf, 1000.0),
            np.repeat(np.array([FIXED, FLUID], np.int32), [nb, nf]),
            np.repeat(np.array([1, 2], np.int32), [nb, nf]), np.arange(1, nb + nf + 1),
            ghost, ghost - walls)
