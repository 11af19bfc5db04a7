"""SPHERIC benchmark test 6's closed tank in x-z: a 10 x 5 m box inside
three FIXED wall layers, full of fluid around a 1 m square of MOVING rows
centred at (1.5, 2.5) m, every site at ``(i + 0.5) dp + OFF``.

A numpy copy of ``procedural_decks.py:moving_square`` (the deck's own CSVs
are not public at dp 0.02): at dp 0.02, 129,536 particles, 2,500 of them
the square.  ``geometry`` is the configuration's ``geometry`` group.
"""

import numpy as np

FLUID, FIXED, MOVING = 1, 2, 3


def _lattice(lo, hi):
    axes = [np.arange(a, b) for a, b in zip(lo, hi)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, len(axes))


def build(geometry):
    """(position [n, 2], density, ptype, group_marker, idp) host arrays:
    walls (marker 1), fluid (marker 2), the square (marker 3); ids from 1."""
    dp, side, layers = geometry["dp"], geometry["side"], geometry["wall_layers"]
    nx, nz = (int(round(L / dp)) for L in geometry["box"])
    idx = _lattice((-layers, -layers), (nx + layers, nz + layers))
    wall = np.any((idx < 0) | (idx >= [nx, nz]), axis=-1)
    lo = [int(round((c - side / 2) / dp)) for c in geometry["centre"]]
    hi = [int(round((c + side / 2) / dp)) for c in geometry["centre"]]
    body = ~wall & np.all((idx >= lo) & (idx < hi), axis=-1)
    pts = (idx + 0.5) * dp + geometry["offset"]
    bodies = (pts[wall], pts[~wall & ~body], pts[body])
    counts = [len(b) for b in bodies]
    n = sum(counts)
    return (np.concatenate(bodies), np.full(n, 1000.0),
            np.repeat(np.array([FIXED, FLUID, MOVING], np.int32), counts),
            np.repeat(np.array([1, 2, 3], np.int32), counts), np.arange(1, n + 1))
