"""Sorted cell list on the device (port of ``sphexample_tpu/ops/cell_list.py``).

Replaces the reference's ``UpdateNeighbors!`` machinery (sort StructArray by
cell + run-length-encode + Dict lookup, reference ``src/SPHCellList.jl:118-163``)
with:

  * the same round-half-away-from-zero cell assignment (``map_floor``,
    SPHCellList.jl:56-61),
  * a *static dense grid*: cell coords are clamped into a host-chosen bounding
    box and linearized with the x-axis fastest, so the three x-adjacent cells
    of any stencil row occupy one contiguous key range,
  * a stable ``argsort`` over linear keys + a gather-permute of all fields,
  * segment starts from a ``bincount`` histogram + ``cumsum``.

Between lazy rebuilds the stored cell coords are stale by design (the
reference's displacement-accumulator rule, SPHCellList.jl:706-724).  Inactive
padding slots are parked at key ``ncells``, so they sort to the tail and no
stencil row ever visits them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..state import Particles


@dataclass(frozen=True)
class Grid:
    """Static cell-grid bounds: per-dimension integer cell coordinates
    (``map_floor`` convention) chosen on the host."""

    cmin: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def dims(self) -> int:
        return len(self.shape)

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def parking_key(self) -> int:
        return self.ncells

    @property
    def strides(self) -> Tuple[int, ...]:
        """x fastest: key = rel[0] + nx*(rel[1] + ny*rel[2])."""
        s = [1]
        for n in self.shape[:-1]:
            s.append(s[-1] * n)
        return tuple(s)


def _i32(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


def map_floor(x, inv_cutoff):
    """Round-half-away-from-zero onto the integer grid of pitch H
    (reference SPHCellList.jl:56-61): sign(x) * trunc(|x| * H^-1 + 0.5)."""
    return (torch.sign(x) * torch.trunc(torch.abs(x) * inv_cutoff + 0.5)).to(torch.int32)


def cell_coords(position, inv_cutoff):
    """Per-particle cell coordinates (reference ExtractCells!, SPHCellList.jl:118-123)."""
    return map_floor(position, inv_cutoff)


def clamp_coords(coords, grid: Grid):
    lo = _i32(grid.cmin, coords.device)
    hi = lo + _i32(grid.shape, coords.device) - 1
    return torch.minimum(torch.maximum(coords, lo), hi)


def linearize(coords, grid: Grid):
    """Linear key of (clamped) cell coords; x (dim 0) fastest."""
    rel = clamp_coords(coords, grid) - _i32(grid.cmin, coords.device)
    return torch.sum(rel * _i32(grid.strides, coords.device), dim=-1, dtype=torch.int32)


def grid_from_positions(
    positions: np.ndarray, inv_cutoff: float, margin_cells: int = 6
) -> Grid:
    """Host-side: static grid bounds from initial positions plus a safety
    margin (particles leaving the box are clamped to edge cells)."""
    c = np.sign(positions) * np.trunc(np.abs(positions) * inv_cutoff + 0.5)
    c = c.astype(np.int64)
    cmin = c.min(axis=0) - margin_cells
    cmax = c.max(axis=0) + margin_cells
    return Grid(cmin=tuple(int(v) for v in cmin),
                shape=tuple(int(v) for v in (cmax - cmin + 1)))


def segment_starts(keys, ncells: int):
    """``cell_start[k] = number of keys < k`` as ``[ncells + 2]`` int32, from
    a histogram + cumsum (integer-exact, independent of input order)."""
    cnt = torch.bincount(keys.long() + 1, minlength=ncells + 2)
    return torch.cumsum(cnt, 0).to(torch.int32)


def max_row_segment(cell_start, grid: Grid):
    """Max 3-cell x-window sum over all rows (0-dim int32 tensor)."""
    counts = cell_start[1 : grid.ncells + 1] - cell_start[: grid.ncells]
    rows = counts.reshape(-1, grid.shape[0])
    if grid.shape[0] < 3:
        return torch.max(torch.sum(rows, dim=1)).to(torch.int32)
    seg = rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]
    return torch.max(seg).to(torch.int32)


def sort_keys(particles: Particles, inv_cutoff, grid: Grid):
    """Clamped cell coords + linear sort keys with inactive rows parked at
    ``grid.parking_key`` - THE ordering rule of :func:`rebuild`."""
    coords = clamp_coords(cell_coords(particles.position, inv_cutoff), grid)
    parking = torch.full_like(coords[:, 0], grid.parking_key)
    keys = torch.where(particles.active, linearize(coords, grid), parking)
    return keys, coords


def rebuild(particles: Particles, inv_cutoff, grid: Grid):
    """Assign cells, stable-sort all particle fields by linear key, build
    segment starts.  Returns (sorted particles, cell_start, max_occupancy).

    ``cell_start`` has length ncells+2: cell k occupies sorted rows
    [cell_start[k], cell_start[k+1]), the parking cell for inactive padding
    is key ``ncells``.  Ties keep their order (stable sort), so rows of one
    cell stay in their previous relative order - the sorted index, and with
    it the density-diffusion role, depends on it.
    """
    keys, coords = sort_keys(particles, inv_cutoff, grid)
    perm = torch.argsort(keys, stable=True)
    sorted_keys = keys.index_select(0, perm)
    sorted_parts = particles.permute(perm).replace(cell=coords.index_select(0, perm))
    cell_start = segment_starts(sorted_keys, grid.ncells)
    occ = cell_start[1 : grid.ncells + 1] - cell_start[: grid.ncells]
    return sorted_parts, cell_start, torch.max(occ).to(torch.int32)


def stencil_rows(dims: int) -> np.ndarray:
    """Static row offsets over dims 1..D-1 (all of {-1,0,1}^(D-1)): each row,
    combined with the contiguous x-span [-1, +1], covers 3 cells of the full
    3^D neighborhood.  3 rows in 2D, 9 rows in 3D (d2 outer, d1 inner)."""
    if dims == 2:
        deltas = [(d1,) for d1 in (-1, 0, 1)]
    elif dims == 3:
        deltas = [(d1, d2) for d2 in (-1, 0, 1) for d1 in (-1, 0, 1)]
    else:
        raise ValueError("only 2D/3D supported")
    return np.asarray(deltas, dtype=np.int32)


def row_segments(coords, grid: Grid, cell_start):
    """Candidate segment (start, end) sorted-row ranges for each stencil row
    of every particle with cell ``coords`` [..., D]; output shapes [..., S]
    with S = 3^(D-1).  Rows outside the grid give empty segments
    (start == end == 0); within a row the x-range [cx-1, cx+1] is clamped to
    the grid edge (the reference's Dict miss -> empty range,
    SPHCellList.jl:199-203)."""
    dev = coords.device
    rows = torch.as_tensor(stencil_rows(grid.dims), device=dev)  # [S, D-1]
    shape = _i32(grid.shape, dev)
    strides = _i32(grid.strides, dev)

    rel = coords - _i32(grid.cmin, dev)
    row_rel = rel[..., None, 1:] + rows                             # [..., S, D-1]
    row_valid = torch.all((row_rel >= 0) & (row_rel < shape[1:]), dim=-1)

    x_lo = torch.clamp(rel[..., 0] - 1, 0, grid.shape[0] - 1)
    x_hi = torch.clamp(rel[..., 0] + 1, 0, grid.shape[0] - 1)
    row_base = torch.sum(row_rel * strides[1:], dim=-1, dtype=torch.int32)
    key_lo = torch.where(row_valid, row_base + x_lo[..., None], 0)
    key_hi = torch.where(row_valid, row_base + x_hi[..., None], -1)

    zero = torch.zeros((), dtype=cell_start.dtype, device=dev)
    start = torch.where(row_valid, cell_start[key_lo.long()], zero)
    end = torch.where(row_valid, cell_start[(key_hi + 1).long()], zero)
    return start, end
