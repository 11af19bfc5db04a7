"""Pruned neighbor lists: fixed [N, K] candidate indices with a skin (port of
``sphexample_tpu/ops/neighbor_list.py``, in plain PyTorch: the JAX module is
XLA code outside any Pallas kernel, so it has no hand kernel).

An opt-in alternative to the per-sweep stencil windows: at a lazy rebuild the
stencil candidates within radius H + skin of the *rebuild* positions are
compacted into a static [N, K] index list; force sweeps then gather exactly
those candidates.

Semantics: with skin = h, the reference's displacement-accumulator rule
(rebuild when Dx >= h, Dx accumulating ~2x the per-step displacement max,
reference SPHCellList.jl:706-724) bounds the relative approach of any pair
between rebuilds by ~h, so the list is a superset of every stencil pair that
can come within the H cutoff before the next rebuild.  The per-pair H cutoff
is still applied each sweep, so results match the stencil path up to
floating-point summation order.

Both functions take the particle axis ``block_size`` rows at a time: the
list build holds a [block_size, 3^(D-1) * cseg] candidate block, the sweep a
[block_size, K] one.
"""

from __future__ import annotations

import torch

from .cell_list import Grid, linearize, row_segments
from .interactions import _dot, _sweep_out, _zero_outs, add_pairs


def build_neighbor_list(
    kern,
    grid: Grid,
    cseg: int,
    K: int,
    block_size: int,
    particles,            # sorted Particles (cell/active/position)
    cell_start,
):
    """Returns (nbr [N, K] int32 with sentinel N for padding, max_count).

    ``cseg`` rows are read from each stencil row's segment (the JAX
    package's candidate window: a longer segment is cut).  ``max_count`` is
    the largest true neighbor-candidate count - if it exceeds K the list
    silently truncated and the caller must retune.
    """
    n = particles.capacity
    dev = particles.position.device
    r2 = (kern.H + kern.h) ** 2          # the skin is h
    position = particles.position
    starts, ends = row_segments(particles.cell, grid, cell_start)   # [N, S]
    offs = torch.arange(cseg, device=dev)
    nbr = torch.full((n, K), n, dtype=torch.int32, device=dev)
    max_count = torch.zeros((), dtype=torch.int64, device=dev)
    for b0 in range(0, n, block_size):
        b1 = min(b0 + block_size, n)
        st, en = starts[b0:b1].long(), ends[b0:b1].long()
        j = st[:, :, None] + offs                                   # [B, S, cseg]
        valid = (j < en[:, :, None]).reshape(b1 - b0, -1)
        j = j.reshape(b1 - b0, -1)                                  # [B, S*cseg]
        j = j.clamp(0, n - 1)
        xij = position[b0:b1, None, :] - position[j]
        d2 = _dot(xij, xij)
        idx = torch.arange(b0, b1, device=dev)[:, None]
        sel = valid & (d2 <= r2) & (j != idx) & particles.active[b0:b1, None]
        max_count = torch.maximum(max_count, sel.sum(dim=1).max())
        # compact the selected indices to the front (ascending j)
        keys = torch.sort(torch.where(sel, j, n), dim=1).values[:, :K]
        nbr[b0:b1, :keys.shape[1]] = keys.to(torch.int32)
    return nbr, max_count.to(torch.int32)


def pair_sweep_list(
    spec,
    grid: Grid,
    nbr,                   # [N, K] int32 (sentinel n)
    block_size: int,
    particles,
    position,
    density,
    pressure,
    velocity,
):
    """Neighbor sweep over the pruned list (single-device path).

    The physics of ``ops/interactions.pair_sweep`` (one pair body,
    ``add_pairs``); the candidate source is the [N, K] list instead of the
    stencil row segments, so the density-diffusion role compares the two
    particles' cell keys.
    """
    n, dims = position.shape
    keys = linearize(particles.cell, grid)
    outs = _zero_outs(spec, n, dims, position)
    for b0 in range(0, n, block_size):
        b1 = min(b0 + block_size, n)
        rows = nbr[b0:b1].long()
        valid = rows < n
        r = torch.arange(b0, b1, device=position.device)[:, None].expand_as(rows)[valid]
        j = rows[valid]
        xij = position[r] - position[j]
        d2 = _dot(xij, xij)
        keep = (d2 <= spec.kernel.H2) & particles.active[r]
        r, j, xij, d2 = r[keep], j[keep], xij[keep], d2[keep]
        add_pairs(spec, outs, r, r, j, xij, d2, density, pressure, velocity,
                  particles.motion_limiter, keys[j] == keys[r])
    return _sweep_out(outs)
