"""The work of one neighbour sweep, and of one mDBC correction (stage 04),
counted from what the physics needs: the yardstick of the sweep kernels' and
the mDBC kernel's roofline shares.

Operations are ordered pairs i != j inside the support and, for the
ARTIFICIAL viscosity, approaching pairs (v_ij . x_ij < 0), times per-pair
constants of the model set.  Candidates that a kernel examines and rejects
are not counted, so the bound stays what it is whatever kernel computes the
sweep.  Bytes are every input of the sweep read once (position, velocity,
density, pressure, motion limiter: f32) and every output written once (the
K f32 sums per row).  The pairs are found afresh from the positions alone,
so neither the row order nor the program's cell list moves the count; the
support is decided in the state's precision, as the sweep decides it.

SIMPLE mDBC leaves a sweep's work per pair as it is: it rewrites the wall
rows' densities before the first sweep, and the sweep's pair terms (the
diffusion's fluid-fluid gate among them) are the same with it or without
it, so ``model_key`` has no mDBC key.
"""

from __future__ import annotations

import torch

from .peaks import PEAK_BYTES, PEAK_F32
from .reference.pairs import candidates, row_slices, stencil_segments
from .reference.sph import Grid

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
    cell, key = grid.cells(position, P)
    order = torch.argsort(key, stable=True)
    pos, vel = position[order], velocity[order]
    lo, hi = stencil_segments(cell[order], grid.shape, grid.strides, grid.starts(key))
    pairs = approaching = 0
    for r0 in range(0, pos.shape[0], rows_per_chunk):
        i, j = candidates(lo, hi, r0, min(r0 + rows_per_chunk, pos.shape[0]))
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


# f32 operations of stage 04 per ghost-fluid pair inside the support, by
# dimension D (3D first): x_gj = g - x_j (3), its square (5), q = sqrt / h
# (2), W = alpha_d t^4 (2q + 1) with t = 1 - q / 2 (8), grad W = alpha_d 5
# (q - 2)^3 / (8 h^2) x_gj (7), V_j = m0 / rho_j (1), the D + 1 sums of b
# (4; m0 taken out of the sum), A's (D + 1)^2 sums of V_j [W, grad W] (x)
# [1, x_jg] (4 + 12 products, the first column needs none, and 16 sums:
# 32): 62.  2D: 2, 3, 2, 8, 6, 1, 3 and 3 + 6 + 9: 43.
MDBC_OPS_PER_PAIR = {3: 62, 2: 43}
# per ghost with a fluid neighbour, n = D + 1: m0 times b (n), the LU
# factors of A without pivoting (3D 34, 2D 13), det A as their diagonal's
# product (n - 1), the forward and back substitutions (n (n - 1) and
# n (n - 1) + n), rho_g + grad rho . (r_b - g) (3D): 4 + 34 + 3 + 12 + 16 +
# 9 = 78; 2D 3 + 13 + 2 + 6 + 9 + 6 = 39.  The Shepard fallback replaces the
# solve and costs less.
MDBC_OPS_PER_GHOST = {3: 78, 2: 39}


def roofline_pct(bound_s, seconds):
    """A kernel's share of its roofline, in %: the least time of its work
    over the time it took; None where either is missing."""
    if not bound_s or not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def count_ghost_pairs(P, position, ghost, fluid, per_slice: int = 1 << 24):
    """(pairs, wet, reached): the ghost-fluid pairs inside the support (the
    ghost points the rows of ``ghost`` carry where nonzero, against the rows
    where ``fluid``), decided in the state's precision; the ghosts with at
    least one such pair; the fluid rows in at least one ghost's support.
    Counted on fresh cells of pitch H around the points themselves."""
    dev = position.device
    g = ghost[torch.any(ghost != 0, dim=-1)]
    x = position[fluid]
    if g.shape[0] == 0 or x.shape[0] == 0:
        return 0, 0, 0
    grid = Grid.around(torch.cat([x, g]).cpu().numpy(), P)
    _, key = grid.cells(x, P)
    x = x[torch.argsort(key, stable=True)]
    lo_s, hi_s = stencil_segments(grid.cells(g, P)[0], grid.shape, grid.strides,
                                  grid.starts(key))
    pairs = 0
    wet = torch.zeros(g.shape[0], dtype=torch.bool, device=dev)
    reached = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    for r0, r1 in row_slices(lo_s, hi_s, per_slice):
        i, j = candidates(lo_s, hi_s, r0, r1)
        xgj = g[i] - x[j]
        keep = (xgj * xgj).sum(-1) <= P.H2
        pairs += int(keep.sum())
        wet[i[keep]] = True
        reached[j[keep]] = True
    return pairs, int(wet.sum()), int(reached.sum())


def mdbc_work(config: dict, P, position, ghost_points, ptype) -> dict:
    """The operations, bytes and least time of one SIMPLE mDBC correction of
    this state: ``ghost_points`` [n, D] per row (zero where a row has none).
    Bytes: each ghost with a fluid neighbour reads its ghost point, its
    position and its density and writes its density (f32); each fluid row
    in some ghost's support is read once (position, density, motion
    limiter).  A ghost with no fluid neighbour keeps its density: no work."""
    d = position.shape[1]
    pairs, wet, reached = count_ghost_pairs(P, position, ghost_points, ptype == 1)
    ops = MDBC_OPS_PER_PAIR[d] * pairs + MDBC_OPS_PER_GHOST[d] * wet
    nbytes = wet * (2 * d + 2) * 4 + reached * (d + 2) * 4
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return {"pairs": pairs, "wet_ghosts": wet, "fluid_rows": reached, "ops": ops,
            "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
