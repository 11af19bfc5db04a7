"""An independent count of the sweep walk's staged tiles for the tests of
its compute rule (tests/test_torch_sweep_schedule.py, tests/test_torch_cuda.py):
the accepted pairs of every lane in every tile, from the accepted candidates
of ``ops/block_sweep.py:walk_candidates`` rather than from ``pass_bodies``'
own enumeration of the tiles."""

import torch

from sphexample_tpu_torch.ops import block_sweep as bs


def tile_pairs(sched, grid, cell_start, position, H2: float, self_off: int = 0) -> list:
    """A list with one list of the lanes' accepted pairs (lanes with none
    left out) per staged tile that has any.  A pair (r, j) lies in the tile
    of r's pass whose stencil row's union run holds j (the runs of a pass
    are disjoint)."""
    ub, ue, _, _ = bs._pass_rows(sched, grid, cell_start)
    r, j = bs.walk_candidates(sched, grid, cell_start, position, H2, self_off)
    if r.numel() == 0:
        return []
    q = sched.pass_of[r]
    row = ((j[:, None] >= ub[q]) & (j[:, None] < ue[q])).long().argmax(1)
    key = ((q * ub.shape[1] + row) << 20) + (j - ub[q, row]) // bs.WALK_TILE
    _, tile = torch.unique(key, return_inverse=True)
    n = int(r.max()) + 1
    lane, pairs = torch.unique(tile * n + r, return_counts=True)
    per = torch.bincount(torch.div(lane, n, rounding_mode="floor"))
    return [c.tolist() for c in torch.split(pairs.cpu(), per.cpu().tolist())]
