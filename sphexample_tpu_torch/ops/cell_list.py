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
  * segment starts from a ``bincount`` histogram + ``cumsum``,
  * for P slabs of the global sorted order: :func:`rebuild` over gathered
    keys (replicated argsort), or :func:`rebuild_sharded` - a local sort and
    a 1-hop row migration.

Between lazy rebuilds the stored cell coords are stale by design (the
reference's displacement-accumulator rule, SPHCellList.jl:706-724).  Inactive
padding slots are parked at key ``ncells``, so they sort to the tail and no
stencil row ever visits them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..parallel.context import SINGLE
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


@functools.lru_cache(maxsize=None)
def _i32(values, device):
    """``values`` (a tuple) as an int32 tensor on ``device``, made once: a
    copy from the host per call would block it, and a captured graph cannot
    hold one.  Never written in place."""
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


def host_cell_keys(positions: np.ndarray, inv_cutoff: float, grid: Grid) -> np.ndarray:
    """Host-side (numpy) clamped linear cell keys: the mirror of
    ``linearize(clamp_coords(cell_coords(...)))`` for the host sizers."""
    c = (np.sign(positions) * np.trunc(np.abs(positions) * inv_cutoff + 0.5)).astype(np.int64)
    lo = np.asarray(grid.cmin)
    c = np.clip(c, lo, lo + np.asarray(grid.shape) - 1)
    return ((c - lo) * np.asarray(grid.strides)).sum(axis=1)


def segment_starts(keys, ncells: int):
    """``cell_start[k] = number of keys < k`` as ``[ncells + 2]`` int32, from
    a histogram + cumsum (integer-exact, independent of input order).  The
    histogram is a scatter-add: ``torch.bincount`` reads the largest key on
    the host first."""
    idx = keys.long() + 1
    cnt = torch.zeros(ncells + 2, dtype=torch.int64, device=keys.device)
    cnt.scatter_add_(0, idx, torch.ones_like(idx))
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


def rebuild(particles: Particles, inv_cutoff, grid: Grid, ctx=None):
    """Assign cells, stable-sort all particle fields by linear key, build
    segment starts.  Returns (sorted particles, cell_start, max_occupancy).

    ``cell_start`` has length ncells+2: cell k occupies sorted rows
    [cell_start[k], cell_start[k+1]), the parking cell for inactive padding
    is key ``ncells``.  Ties keep their order (stable sort), so rows of one
    cell stay in their previous relative order - the sorted index, and with
    it the density-diffusion role, depends on it.

    Under a sharded ``ctx`` the keys are gathered, every rank computes the
    identical *global* permutation (replicated argsort) and takes its
    contiguous slab of the globally sorted order from the gathered fields;
    ``cell_start`` indexes global sorted positions.
    """
    ctx = ctx or SINGLE
    keys, coords = sort_keys(particles, inv_cutoff, grid)
    keys_g = ctx.gather(keys)
    perm = torch.argsort(keys_g, stable=True)
    sorted_keys = keys_g.index_select(0, perm)
    if ctx.is_sharded:
        cap = particles.capacity
        slab = perm[ctx.rank() * cap:(ctx.rank() + 1) * cap]
        sorted_parts = particles.map(lambda a: ctx.gather(a).index_select(0, slab))
        sorted_parts = sorted_parts.replace(cell=ctx.gather(coords).index_select(0, slab))
    else:
        sorted_parts = particles.permute(perm).replace(cell=coords.index_select(0, perm))
    cell_start = segment_starts(sorted_keys, grid.ncells)
    occ = cell_start[1 : grid.ncells + 1] - cell_start[: grid.ncells]
    return sorted_parts, cell_start, torch.max(occ).to(torch.int32)


def rebuild_sharded(particles: Particles, inv_cutoff, grid: Grid, ctx, halo: int):
    """Distributed rebuild of one slab: local stable sort + 1-hop row
    migration, with no global gather of the fields and no replicated argsort
    (port of ``sphexample_tpu/ops/cell_list.py:rebuild_sharded``).

    Between lazy rebuilds a particle moves less than ``h``, so its key
    changes to at most a neighboring cell and its global sorted position by
    less than the sorted-row reach that bounds the sweep's halo.  The new
    global position of every locally held row needs no gather of rows:

        g = cell_start[key] + prefix[key] + local_rank

    because the previous slabs are disjoint ordered ranges, so the stable
    tie-break orders rows of equal key by rank first; ``prefix`` is the
    exclusive over-ranks prefix of the per-key counts (one gather of the
    count vector).  ``g`` increases along the local sorted order, so the rows
    that migrate are a head slice (to rank - 1) and a tail slice (to
    rank + 1): one exchange of ``halo``-row packs, ``g`` encoded ``+ 1`` so
    that the zero fill at the end ranks decodes as invalid.

    Returns (slab particles in global cell-sorted order, global
    ``cell_start``, max occupancy, migration_need): the largest head or tail
    slice any rank needed, which must stay <= ``halo``.
    """
    C = particles.capacity
    ncells = grid.ncells
    rank, ndev = ctx.rank(), ctx.num_devices
    base = rank * C
    dev = particles.device
    i32 = torch.int32

    keys, coords = sort_keys(particles, inv_cutoff, grid)
    order = torch.argsort(keys, stable=True)
    skeys = keys.index_select(0, order).long()

    local_start = segment_starts(skeys, ncells)
    counts_loc = local_start[1:] - local_start[:-1]                 # [ncells+1]
    counts_all = ctx.gather(counts_loc[None])                       # [ndev, ncells+1]
    prefix = torch.sum(counts_all[:rank], dim=0, dtype=i32)
    counts_glob = torch.sum(counts_all, dim=0, dtype=i32)
    cell_start = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                            torch.cumsum(counts_glob, 0).to(i32)])  # [ncells+2]

    # global sorted position of every locally sorted row (increasing)
    lrank = torch.arange(C, dtype=i32, device=dev) - local_start[skeys]
    g = cell_start[skeys] + prefix[skeys] + lrank

    sorted_parts = particles.permute(order).replace(cell=coords.index_select(0, order))

    n_left = torch.sum(g < base).to(i32)
    n_right = torch.sum(g >= base + C).to(i32)
    migration_need = ctx.pmax(torch.maximum(n_left, n_right))

    H = halo
    idx = torch.arange(H, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    head_g = torch.where(idx < n_left, g[:H] + 1, zero)
    tail_g = torch.where(idx >= H - n_right, g[C - H:] + 1, zero)
    fields = sorted_parts.tensors()
    from_l, from_r = ctx.exchange(tuple(a[:H] for a in fields) + (head_g,),
                                  tuple(a[C - H:] for a in fields) + (tail_g,))

    big = torch.full((), 2 ** 30, dtype=i32, device=dev)
    g_mine = torch.where((g >= base) & (g < base + C), g, big)
    g_from_l = torch.where(from_l[-1] > 0, from_l[-1] - 1, big)
    g_from_r = torch.where(from_r[-1] > 0, from_r[-1] - 1, big)
    g_cat = torch.cat([g_mine, g_from_l, g_from_r])                 # [C + 2H]
    # exactly C rows carry g in [base, base + C): the global positions
    # partition; everything else sorts past them
    take = torch.argsort(g_cat, stable=True)[:C]
    merged = Particles.from_tensors(
        torch.cat([a, bl, br], dim=0).index_select(0, take)
        for a, bl, br in zip(fields, from_l[:-1], from_r[:-1]))

    occ = cell_start[1 : ncells + 1] - cell_start[:ncells]
    return merged, cell_start, torch.max(occ).to(i32), migration_need


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
    rows = _i32(tuple(map(tuple, stencil_rows(grid.dims).tolist())), dev)  # [S, D-1]
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
