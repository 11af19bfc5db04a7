"""An independent count of the sweep walk's staged tiles for the tests of
its stage and compute steps (tests/test_torch_sweep_schedule.py,
tests/test_torch_cuda.py, host_walk_check.py): the accepted pairs of every
lane in every tile, from the accepted candidates of
``ops/block_sweep.py:walk_candidates`` rather than from ``pass_bodies``' own
enumeration of the tiles; the tiles of a pass and a lane's masks of a tile as
the kernel's ``walk_stage`` forms them; and states whose tiles span stencil
rows."""

import numpy as np
import torch

from sphexample_tpu_torch.ops import block_sweep as bs


def tile_pairs(sched, grid, cell_start, position, H2: float, self_off: int = 0) -> list:
    """A list with one list of the lanes' accepted pairs (lanes with none
    left out) per staged tile that has any.  A pass's stencil rows' union
    runs are one stream in the walk's order (the runs of a pass are
    disjoint), cut every WALK_TILE rows: a pair (r, j) lies in the tile of
    r's pass that holds j's place in that stream."""
    ub, ue, _, _ = bs._pass_rows(sched, grid, cell_start)
    r, j = bs.walk_candidates(sched, grid, cell_start, position, H2, self_off)
    if r.numel() == 0:
        return []
    q = sched.pass_of[r]
    row = ((j[:, None] >= ub[q]) & (j[:, None] < ue[q])).long().argmax(1)
    start = torch.cumsum(ue - ub, 1) - (ue - ub)        # each run's place in the stream
    place = start[q, row] + j - ub[q, row]
    key = (q << 20) + place // bs.WALK_TILE
    _, tile = torch.unique(key, return_inverse=True)
    n = int(r.max()) + 1
    lane, pairs = torch.unique(tile * n + r, return_counts=True)
    per = torch.bincount(torch.div(lane, n, rounding_mode="floor"))
    return [c.tolist() for c in torch.split(pairs.cpu(), per.cpu().tolist())]


def pass_tiles(ub, ue) -> list:
    """The tiles the walk stages for one pass whose stencil rows have the
    union runs [ub[s], ue[s]): the runs read as one stream in the walk's
    order and cut every WALK_TILE rows, so that a tile may span the end of
    one stencil row and the start of the next ones and only the pass's last
    tile is part-full.  A list of tiles, each a list of its pieces (stencil
    row, first pack row, rows)."""
    tiles, cur, fill = [], [], 0
    for s, (a, b) in enumerate(zip(ub.tolist(), ue.tolist())):
        while a < b:
            n = min(bs.WALK_TILE - fill, b - a)
            cur.append((s, a, n))
            fill, a = fill + n, a + n
            if fill == bs.WALK_TILE:
                tiles.append(cur)
                cur, fill = [], 0
    if cur:
        tiles.append(cur)
    return tiles


def _low(n: int) -> int:
    return (1 << n) - 1


def tile_masks(pieces, jb, je, i: int, s_i: int, e_i: int):
    """A lane's (own, role) words of one staged tile as walk_stage forms
    them: ``own`` the tile offsets of its own ranges [jb[s], je[s]) less its
    self i; ``role`` from the rows below i, s_i and e_i counted piece by
    piece (the stream's pack rows ascend): low(below(i)) ^ (low(below(e_i))
    & ~low(below(s_i)))."""
    own = nt = 0
    below = [0, 0, 0]
    for s, a, n in pieces:
        lo = min(max(jb[s] - a, 0), n)
        hi = min(max(je[s] - a, 0), n)
        m = _low(nt + hi) & ~_low(nt + lo)
        if 0 <= i - a < n:
            m &= ~(1 << (nt + i - a))
        own |= m
        for k, v in enumerate((i, s_i, e_i)):
            below[k] += min(max(v - a, 0), n)
        nt += n
    return own, _low(below[0]) ^ (_low(below[2]) & ~_low(below[1]))


def stream_positions(dims: int, case: str, H: float, seed: int = 11):
    """Positions whose passes stage tiles across stencil rows, for a kernel
    of support H (the cell edge): ``spans`` - a jittered lattice of spacing
    H / 3 (about 27 rows a cell in 3D, 9 in 2D), whose stencil rows hold
    10-100 union rows, so that tiles span two and three of them and passes
    of several tiles end in a part-full one; ``surface`` - that lattice
    under a cover two rows deep of spacing H (a free surface): stencil rows
    of 1-3 candidates and tiles that touch every stencil row of their pass."""
    rng = np.random.default_rng(seed)
    a = H / 3
    side = 8 if dims == 3 else 14
    lat = (np.stack(np.meshgrid(*([np.arange(side)] * dims), indexing="ij"),
                    axis=-1).reshape(-1, dims) + 0.5) * a
    lat = lat + rng.uniform(-0.2, 0.2, size=lat.shape) * a
    if case == "spans":
        return lat
    w = int(np.ceil(side * a / H)) + 2
    cover = (np.stack(np.meshgrid(*([np.arange(w)] * (dims - 1) + [np.arange(2)]),
                                  indexing="ij"), axis=-1).reshape(-1, dims) + 0.5) * H
    cover += np.r_[[-H] * (dims - 1), side * a]
    cover = cover + rng.uniform(-0.2, 0.2, size=cover.shape) * H
    return np.concatenate([lat, cover])
