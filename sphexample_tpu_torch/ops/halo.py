"""The halo-extended window of one slab: what the sharded sweeps and the
sharded mDBC read their candidates from.

A slab holds C contiguous rows of the global cell-sorted order, from row
``base = rank * C``.  With ``halo = H > 0`` its window is ``[left halo | own
| right halo]``: the last H rows of rank - 1, its own C rows, the first H rows
of rank + 1 (one 1-hop exchange; the end ranks get zero rows, which no
stencil reaches because ``cell_start`` never points past the global ends).
With ``halo = 0`` (slabs thinner than the stencil reach) the window is the
whole gathered array.  Either way the selves are the window's rows
``[self_off, self_off + C)`` and ``cell_start`` is rebased by the window's
first global row ``ext_off`` and clamped into the window.
"""

from __future__ import annotations

import torch


def extend(ctx, rows, halo: int):
    """``rows`` (a [C, ...] tensor, or a tuple of them) -> (the window's rows,
    self_off, ext_off)."""
    single = isinstance(rows, torch.Tensor)
    parts = (rows,) if single else tuple(rows)
    C = parts[0].shape[0]
    base = ctx.rank() * C
    if halo > 0:
        if halo > C:
            raise ValueError(f"halo {halo} exceeds the slab's {C} rows: one hop "
                             "cannot cover it")
        left, right = ctx.exchange(tuple(a[:halo] for a in parts),
                                   tuple(a[C - halo:] for a in parts))
        ext = tuple(torch.cat([lt, a, rt], dim=0)
                    for lt, a, rt in zip(left, parts, right))
        self_off, ext_off = halo, base - halo
    else:
        ext = tuple(ctx.gather(a) for a in parts)
        self_off, ext_off = base, 0
    return (ext[0] if single else ext), self_off, ext_off


def rebase(cell_start, ext_off: int, n_ext: int):
    """Global sorted rows -> rows of a window that starts at global row
    ``ext_off`` and holds ``n_ext`` rows; what lies outside clamps to an
    empty range at the window's edge."""
    return torch.clamp(cell_start - ext_off, 0, n_ext).to(torch.int32)
