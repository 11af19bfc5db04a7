"""The work of one neighbour sweep, counted from what the physics needs: the
yardstick of the sweep kernels' roofline shares.

Operations are ordered pairs i != j inside the support and, for the
ARTIFICIAL viscosity, approaching pairs (v_ij . x_ij < 0), times per-pair
constants of the model set.  Candidates that a kernel examines and rejects
are not counted, so the bound stays what it is whatever kernel computes the
sweep.  Bytes are every input of the sweep read once (position, velocity,
density, pressure, motion limiter: f32) and every output written once (the
K f32 sums per row).  The pairs are found afresh from the positions alone,
so neither the row order nor the program's cell list moves the count; the
support is decided in the state's precision, as the sweep decides it.
"""

from __future__ import annotations

import torch

from .peaks import PEAK_BYTES, PEAK_F32
from .reference.pairs import stencil_segments
from .reference.sph import Grid, map_floor

# f32 operations per pair of each model set: (pair, approaching pair).
# 3D Wendland C2, ARTIFICIAL, LINEAR, no extras: the distance, q and the
# kernel gradient (9), v_ij and v.gradW (8), continuity (3), LINEAR diffusion
# with its hydrostatic term, volume and limiter gate (14), the pressure term
# and the 4 accumulations (11): 45; an approaching pair adds the viscosity
# term (v.x, mu, Pi, Pi gradW and its sum: 9).
# 2D Wendland C2, LAMINAR_SPS, LINEAR, PLANAR: distance, q, gradient factor,
# v_ij, v.x, x.gradW and the limiter product (16), continuity (4), LINEAR
# diffusion (13), pressure term and accumulation (9), laminar term (9),
# sub-particle stress (13 for dv, gradW and their products, 2 x 28 for the
# two tau . gradW, 6 to scale and add: 75), PLANAR's two sums (10): 136.
OPS_PER_PAIR = {
    (3, "artificial", "linear", "none"): (45, 9),
    (2, "laminar_sps", "linear", "planar"): (136, 0),
}


def model_key(config: dict) -> tuple:
    m = config["models"]
    return (config["kernel"]["dims"], m["viscosity"], m["diffusion"], m["shifting"])


def sums_per_row(config: dict) -> int:
    d = config["kernel"]["dims"]
    return (1 + d) * (1 + (config["models"]["shifting"] == "planar"))


def count_pairs(P, grid: Grid, position, velocity, rows_per_chunk: int = 16384):
    """(pairs, approaching pairs) of these positions: ordered, i != j,
    distance within the support in the state's own precision (as the sweep
    decides it), counted on fresh cells of pitch H."""
    dev = position.device
    pos, vel = position, velocity
    lo_c = torch.tensor(grid.cmin, device=dev)
    hi_c = lo_c + torch.tensor(grid.shape, device=dev) - 1
    cell = torch.minimum(torch.maximum(map_floor(pos, 1.0 / P.H), lo_c), hi_c) - lo_c
    key = (cell * torch.tensor(grid.strides, device=dev)).sum(-1)
    order = torch.argsort(key, stable=True)
    pos, vel, cell, key = pos[order], vel[order], cell[order], key[order]
    start = torch.zeros(grid.ncells + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(torch.bincount(key, minlength=grid.ncells), 0)
    lo, hi = stencil_segments(cell, grid.shape, grid.strides, start)
    S = lo.shape[1]
    pairs = approaching = 0
    for r0 in range(0, pos.shape[0], rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, pos.shape[0])
        lens = (hi[r0:r1] - lo[r0:r1]).reshape(-1)
        seg = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
        first = torch.cumsum(lens, 0) - lens
        j = lo[r0:r1].reshape(-1)[seg] + (torch.arange(seg.numel(), device=dev) - first[seg])
        i = r0 + torch.div(seg, S, rounding_mode="floor")
        xij = pos[i] - pos[j]
        keep = ((xij * xij).sum(-1) <= P.H2) & (i != j)
        pairs += int(keep.sum())
        vdotx = ((vel[i] - vel[j]) * xij).sum(-1)
        approaching += int((keep & (vdotx < 0)).sum())
    return pairs, approaching


def sweep_work(config: dict, P, grid: Grid, position, velocity) -> dict:
    """The operations, bytes and least time of one sweep of this state."""
    n, d = position.shape
    pairs, approaching = count_pairs(P, grid, position, velocity)
    per_pair, per_approach = OPS_PER_PAIR[model_key(config)]
    ops = per_pair * pairs + per_approach * approaching
    nbytes = n * (2 * d + 3) * 4 + n * sums_per_row(config) * 4
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return {"pairs": pairs, "approaching_pairs": approaching, "ops": ops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
