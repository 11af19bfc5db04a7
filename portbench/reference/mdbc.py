"""SIMPLE mDBC in the plain reference: the boundary density extrapolated
from each wall row's ghost point (English et al., Comp. Part. Mech. 2022),
written from SPHExample ``src/SPHCellList.jl:219-266`` (the ghost's
neighbour loop), ``:319-365`` (the pair moments) and ``:598-622`` (the
correction).

For every row with a nonzero ghost point g, over the fluid rows j inside the
support of g (x_jg = x_j - g):

    b = sum m0 [W, grad W]
    A = sum V_j [W, W x_jg ; grad W, grad W (x) x_jg]        ((D+1) x (D+1))

with grad W the gradient at g and V_j = m0 / rho_j; then

    |det A| >= 1e-3:  [rho_g, grad rho] = A^-1 b,  rho = rho_g + grad rho . (r_b - g)
    else A_11 > 0:    rho = b_1 / A_11            (Shepard)
    else:             the old density
    NaN:              rho0

It is applied once a step, after the Tait pressure and before the first
sweep (stage 04), so the first sweep pairs corrected densities with
uncorrected pressures.  Departures from SPHExample:

* it computes in the dtype it is given (float64 the reference, bfloat16 the
  control); in bfloat16 or float16 the determinant and the solve alone run in
  float32 (``torch.linalg`` has no lower precision), their inputs and result
  rounded to the state's dtype;
* the solve is ``torch.linalg.solve`` (LU with pivoting), SPHExample's ``\\``;
* a ghost's candidates are the rows of the 3^D stencil of its cell at the
  last rebuild (the stale cells every sweep of the reference uses), not a
  fresh neighbour search, and they are taken in slices of
  ``CANDIDATES_PER_SLICE`` so that the peak stays under the sweep's pairs.
"""

from __future__ import annotations

import torch

from .pairs import candidates, row_slices, stencil_segments

DET_THRESHOLD = 1e-3
CANDIDATES_PER_SLICE = 1 << 24


def moments(P, grid, cell_start, ghost, pos, rho, fluid):
    """(b [B, D+1], A [B, D+1, D+1]) of the ghost points ``ghost`` [B, D]
    over the fluid rows of ``pos`` (rows sorted by the cells of
    ``cell_start``) inside their support."""
    dev, dtype = pos.device, pos.dtype
    B, d = ghost.shape
    cell, _ = grid.cells(ghost, P)
    lo, hi = stencil_segments(cell, grid.shape, grid.strides, cell_start)
    b = torch.zeros(B, d + 1, dtype=dtype, device=dev)
    A = torch.zeros(B, d + 1, d + 1, dtype=dtype, device=dev)
    h = P.h
    for r0, r1 in row_slices(lo, hi, CANDIDATES_PER_SLICE):
        i, j = candidates(lo, hi, r0, r1)
        xgj = ghost[i] - pos[j]
        d2 = (xgj * xgj).sum(-1)
        keep = fluid[j] & (d2 <= P.H2)
        i, j, xgj, d2 = i[keep], j[keep], xgj[keep], d2[keep]
        q = torch.clamp(torch.sqrt(d2) / h, 0.0, 2.0)
        t = 1.0 - 0.5 * q
        w = P.alpha_d * (t * t) * (t * t) * (2.0 * q + 1.0)
        s = q - 2.0
        gw = (P.alpha_d * 5.0 * (s * s * s) / (8.0 * h * h))[:, None] * xgj
        wg = torch.cat([w[:, None], gw], -1)                       # [W, grad W]
        b.index_add_(0, i, P.m0 * wg)
        e = torch.cat([torch.ones_like(w)[:, None], -xgj], -1)     # [1, x_jg]
        A.index_add_(0, i, (P.m0 / rho[j])[:, None, None] * wg[:, :, None] * e[:, None, :])
    return b, A


def correct(P, grid, cell_start, ghost, pos, rho, fluid):
    """The densities after stage 04: ``rho`` with every ghost row's density
    extrapolated (a new tensor).  ``ghost`` [n, D] is zero on rows without
    a ghost point."""
    rows = torch.nonzero((ghost != 0).any(-1)).squeeze(1)
    if rows.numel() == 0:
        return rho
    g = ghost[rows]
    b, A = moments(P, grid, cell_start, g, pos, rho, fluid)
    low = A.dtype in (torch.bfloat16, torch.float16)
    A_s, b_s = (A.float(), b.float()) if low else (A, b)
    det = torch.linalg.det(A_s)
    solve = torch.abs(det) >= DET_THRESHOLD
    sol = torch.zeros_like(b_s)
    if bool(solve.any()):
        sol[solve] = torch.linalg.solve(A_s[solve], b_s[solve])
    sol = sol.to(A.dtype)
    rho_solve = sol[:, 0] + (sol[:, 1:] * (pos[rows] - g)).sum(-1)
    old = rho[rows]
    shepard = A[:, 0, 0] > 0
    a00 = torch.where(shepard, A[:, 0, 0], torch.ones_like(old))
    new = torch.where(solve, rho_solve, torch.where(shepard, b[:, 0] / a00, old))
    new = torch.where(torch.isnan(new), torch.full_like(new, P.rho0), new)
    out = rho.clone()
    out[rows] = new
    return out
