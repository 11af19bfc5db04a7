"""The reference's neighbour pairs: every ordered pair (i, j), i != j, whose
cells at the last rebuild lie within one cell of each other on every axis
(the 3^D stencil of the stale cells; the x range clamped to the grid, rows
outside it empty) and whose distance is within the support.

Candidates of a rebuild are kept as a Verlet list: those within the support
plus twice a skin at the positions the list was made from.  While no row
has moved more than the skin from there, the list holds every pair inside
the support; past that it is made again from the same cells.
"""

from __future__ import annotations

import torch

CANDIDATES_PER_CHUNK = 1 << 25


def stencil_segments(cell, shape, strides, start):
    """[N, S] sorted-row ranges [lo, hi) of the 3^(D-1) stencil rows of
    each row's cell (relative coordinates ``cell``); each range covers
    the x-adjacent cells of one row of the stencil."""
    dev = cell.device
    d = cell.shape[1]
    offsets = torch.tensor([[a] for a in (-1, 0, 1)] if d == 2 else
                           [[a, b] for b in (-1, 0, 1) for a in (-1, 0, 1)], device=dev)
    shp = torch.tensor(shape, device=dev)
    std = torch.tensor(strides, device=dev)
    rows = cell[:, None, 1:] + offsets                            # [N, S, D-1]
    valid = ((rows >= 0) & (rows < shp[1:])).all(-1)
    x_lo = torch.clamp(cell[:, 0] - 1, 0, shape[0] - 1)
    x_hi = torch.clamp(cell[:, 0] + 1, 0, shape[0] - 1)
    base = (torch.where(valid[..., None], rows, 0) * std[1:]).sum(-1)
    lo = torch.where(valid, start[base + x_lo[:, None]], 0)
    hi = torch.where(valid, start[base + x_hi[:, None] + 1], 0)
    return lo, hi


def row_slices(lo, hi, per_slice: int):
    """Consecutive row ranges [r0, r1) of ``lo`` / ``hi`` whose candidates
    number about ``per_slice`` each (a row is never split)."""
    ends = torch.cumsum((hi - lo).sum(1), 0)
    bounds = [0]
    total = int(ends[-1]) if ends.numel() else 0
    for cut in range(per_slice, total, per_slice):
        bounds.append(int(torch.searchsorted(ends, cut)))
    bounds.append(lo.shape[0])
    return [(r0, r1) for r0, r1 in zip(bounds[:-1], bounds[1:]) if r1 > r0]


def candidates(lo, hi, r0, r1):
    """(i, j): every row i of [r0, r1) with every sorted row j of its
    stencil's ranges."""
    dev = lo.device
    S = lo.shape[1]
    lens = (hi[r0:r1] - lo[r0:r1]).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    j = lo[r0:r1].reshape(-1)[seg] + (torch.arange(seg.numel(), device=dev) - first[seg])
    i = r0 + torch.div(seg, S, rounding_mode="floor")
    return i, j


class PairList:
    def __init__(self, P, skin_share: float = 0.125):
        self.skin = skin_share * P.H
        self.R2 = (P.H + 2.0 * self.skin) ** 2

    def rebuild(self, cell, key, grid, pos):
        """New cells (``cell`` relative to the grid, rows sorted by ``key``);
        ``start`` keeps each cell's first sorted row for mDBC's ghosts."""
        self.start = grid.starts(key)
        self.lo, self.hi = stencil_segments(cell, grid.shape, grid.strides, self.start)
        self._refresh(pos)

    def _refresh(self, pos):
        I, J = [], []
        for r0, r1 in row_slices(self.lo, self.hi, CANDIDATES_PER_CHUNK):
            i, j = candidates(self.lo, self.hi, r0, r1)
            xij = pos[i] - pos[j]
            keep = ((xij * xij).sum(-1) <= self.R2) & (i != j)
            I.append(i[keep])
            J.append(j[keep])
        self.I, self.J = torch.cat(I), torch.cat(J)
        self.base = pos.clone()

    def within(self, pos, H2):
        """The pairs inside the support at ``pos`` (rows in the order the
        cells were made in)."""
        moved = torch.sqrt(((pos - self.base) ** 2).sum(-1).max())
        if not float(moved) <= self.skin:
            self._refresh(pos)
        xij = pos[self.I] - pos[self.J]
        keep = (xij * xij).sum(-1) <= H2
        return self.I[keep], self.J[keep]
