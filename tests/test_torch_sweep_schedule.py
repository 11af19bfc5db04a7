"""The schedule of the two sweep kernels' shared walk
(``csrc/sph_sweep_walk.cuh``) in its plain PyTorch mirrors: the block
kernel's split of 32 consecutive rows into passes by cell row
(``ops/block_sweep.py:block_schedule``) and the cell kernel's list of
occupied pairs of x-adjacent cells (``ops/cell_sweep.py:cell_schedule``).
Through union -> own range -> filter (``walk_candidates``) every self must
accept exactly the candidates that ``ops/cell_list.py:row_segments`` gives
it, in the same order - the order that keeps the kernels' sums bit for bit
what they were.  Crowded, sheet and edge cells (the cases of the card's cell
tests), cells of more than 32 selves, warps across cell rows, inactive rows
inside a warp and self windows with ``self_off > 0``."""

import re

from pathlib import Path

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import halo as halo_mod
from sphexample_tpu_torch.ops.interactions import candidates
from sphexample_tpu_torch.state import allocate_particles
from walk_tiles import pass_tiles, stream_positions, tile_masks, tile_pairs

torch.set_num_threads(1)
DX = 0.05


def _positions(dims, case, kern, rng):
    """The cases of tests/test_torch_cuda.py:test_cell_kernel_odd_cells, the
    stream states of walk_tiles.py, and a jittered lattice; returns
    (positions, grid or None)."""
    if case in ("spans", "surface"):
        return stream_positions(dims, case, kern.H), None
    if case == "crowded":
        # 150 rows inside one cell, 250 around it
        inner = (rng.uniform(-0.45, 0.45, size=(150, dims)) + 2.0) * kern.H
        outer = (rng.uniform(-1.4, 1.4, size=(250, dims)) + 2.0) * kern.H
        return np.concatenate([inner, outer]), None
    if case == "sheet":
        pos = rng.uniform(0, 1.5, size=(300, dims))
        pos[:, -1] = 0.3 + rng.uniform(-0.01, 0.01, size=300) * DX
        return pos, None
    if case == "edge":
        pos = rng.uniform(-0.3, 0.3, size=(400, dims))
        grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=0)
        pos[:40] *= 1.5        # 40 rows outside the grid: clamped into edge cells
        return pos, grid
    n = 500 if dims == 3 else 300
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * DX] * dims), indexing="ij"),
                      axis=-1).reshape(-1, dims)[:n]
    return coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * DX, None


def _state(dims, case, pad=23, seed=11):
    """Sorted f32 rows of ``case`` with inactive padding, cell list rebuilt."""
    rng = np.random.default_rng(seed)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    pos, grid = _positions(dims, case, kern, rng)
    n = len(pos)
    grid = grid or cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    p = allocate_particles(pos, np.full(n, 1000.0), np.ones(n, np.int32),
                           np.ones(n, np.int32), np.arange(1, n + 1), device="cpu",
                           dtype=torch.float32, capacity=n + pad)
    sp, cs, occ = cl.rebuild(p, kern.H_inv, grid)
    return kern, grid, sp, cs, int(occ)


def _d2(position, i, j):
    """d2 summed unfused, dimension by dimension, as pair_distance2 does."""
    xij = position[i] - position[j]
    d2 = torch.zeros_like(xij[:, 0])
    for d in range(xij.shape[1]):
        d2 = d2 + xij[:, d] * xij[:, d]
    return d2


def _reference(grid, cell, rows, cs, position, H2, self_off=0):
    """The pairs (r, j) of the self rows ``rows`` (bool [n]) through
    ``row_segments`` (each self's own ranges, stencil rows in order, j
    ascending), filtered by j != i and d2 <= H2."""
    starts, ends = cl.row_segments(cell, grid, cs)
    r, j = candidates(starts.long(), ends.long(), 0, cell.shape[0])
    keep = rows[r] & (j != self_off + r) & ~(_d2(position, self_off + r, j) > H2)
    return r[keep], j[keep]


def _hold(sched, grid, cell, rows, cs, position, H2, self_off=0):
    got = bs.walk_candidates(sched, grid, cs, position, H2, self_off)
    ref = _reference(grid, cell, rows, cs, position, H2, self_off)
    assert ref[0].numel() > 0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return got


def _window(p, cs, r, halo, n_slabs=3):
    """Slab r's window of the sorted state, built by slicing (as the card's
    window tests do): slab particles, rebased cell_start, extended positions,
    self_off."""
    N = p.capacity
    C = N // n_slabs
    base = r * C
    lo, hi, self_off = (0, N, base) if halo == 0 else (base - halo, base + C + halo, halo)
    zl = p.position.new_zeros((max(0, -lo), p.dims))
    zr = p.position.new_zeros((max(0, hi - N), p.dims))
    pos = torch.cat([zl, p.position[max(lo, 0):min(hi, N)], zr])
    return p.map(lambda a: a[base:base + C]), halo_mod.rebase(cs, lo, hi - lo), pos, self_off


CASES = ["lattice", "crowded", "sheet", "edge"]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_block_walk_accepts_the_row_segment_candidates(dims, case):
    kern, grid, p, cs, occ = _state(dims, case)
    sched = bs.block_schedule(grid, p, cs)
    got = _hold(sched, grid, p.cell, p.active, cs, p.position, kern.H2)
    # every live row in one pass, every pass inside one warp and one cell row
    live = sched.pass_of >= 0
    assert torch.equal(live, p.active)
    warp = torch.arange(p.capacity) // bs.WARP
    for q in range(sched.pass_row.shape[0]):
        rows = torch.nonzero(sched.pass_of == q).flatten()
        assert rows.numel() and warp[rows].unique().numel() == 1
        rel = p.cell[rows, 1:].long() - torch.tensor(grid.cmin[1:])
        assert torch.equal(rel, sched.pass_row[q].expand_as(rel))
    if case == "crowded":
        assert occ > 2 * bs.WARP       # a cell of more selves than two warps
    # the selves' accepted lists are ascending within each stencil row: the
    # order in which the kernel sums them
    assert got[0].numel() > 0


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_cell_walk_accepts_the_row_segment_candidates(dims, case):
    kern, grid, p, cs, occ = _state(dims, case)
    sched = cw.cell_schedule(grid, cs, p.capacity)
    in_cells = torch.arange(p.capacity) < int(cs[grid.ncells])
    assert torch.equal(sched.pass_of >= 0, in_cells)
    _hold(sched, grid, p.cell, in_cells, cs, p.position, kern.H2)
    # a pass holds at most one warp of rows, all of one group
    counts = torch.bincount(sched.pass_of[in_cells])
    assert int(counts.max()) <= bs.WARP
    if case == "crowded":
        assert int((counts == bs.WARP).sum()) >= 4
    # each self's own cell range is the one rebuild gave it
    key = cl.linearize(p.cell, grid).long()
    assert torch.equal(sched.own[in_cells, 0], cs[key].long()[in_cells])


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_occupied_list_is_the_nonempty_cells(dims, case):
    """The cell kernel lists a group for every pair of x-adjacent cells with
    a row in it, nothing else, in ascending order."""
    _, grid, p, cs, _ = _state(dims, case)
    sched = cw.cell_schedule(grid, cs, p.capacity)
    counts = cs[1:grid.ncells + 1] - cs[:grid.ncells]
    occupied = torch.nonzero(counts > 0).flatten()
    nx = grid.shape[0]
    assert torch.equal(sched.cells, torch.unique(occupied - (occupied % nx) % 2))
    assert sched.groups == sched.cells.numel() and bool((sched.cells % nx % 2 == 0).all())


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["lattice", "crowded"])
def test_warps_across_cell_rows_and_inactive_rows(dims, case):
    """A warp whose rows cross into the next cell row takes one pass per
    row; inactive rows inside a warp are in no pass and accept nothing,
    and the other rows of their warp keep their candidates."""
    kern, grid, p, cs, _ = _state(dims, case)
    sched = bs.block_schedule(grid, p, cs)
    warp = torch.arange(p.capacity) // bs.WARP
    live = sched.pass_of >= 0
    passes = torch.zeros(int(warp.max()) + 1, dtype=torch.int64)
    passes.scatter_reduce_(0, warp[live], torch.ones_like(warp[live]), "sum")
    assert int(passes.max()) >= 2          # some warp spans two cell rows
    holes = p.active.clone()
    holes[5::7] = False                    # inactive rows between live ones
    p2 = p.replace(active=holes)
    sched2 = bs.block_schedule(grid, p2, cs)
    got = _hold(sched2, grid, p.cell, holes, cs, p.position, kern.H2)
    assert not bool((~holes[got[0]]).any())
    assert torch.equal(sched2.pass_of >= 0, holes)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["lattice", "crowded", "edge"])
@pytest.mark.parametrize("halo", ["thick", "whole"])
def test_self_windows(dims, case, halo):
    """A slab's self rows [self_off, self_off + C) of a longer window: both
    schedules accept the single-device walk's candidates of those rows,
    shifted into window rows; a cell that straddles the slab edge is the
    cell kernel's on both slabs."""
    kern, grid, p, cs, _ = _state(dims, case, pad=30)
    C = p.capacity // 3
    h = 2 * C if halo == "thick" else 0     # either way no stencil is cut
    whole = bs.walk_candidates(bs.block_schedule(grid, p, cs), grid, cs, p.position, kern.H2)
    for r in range(3):
        pl, cs_ext, pos, off = _window(p, cs, r, h)
        assert off > 0 or r == 0
        sched = bs.block_schedule(grid, pl, cs_ext)
        rr, jj = _hold(sched, grid, pl.cell, pl.active, cs_ext, pos, kern.H2, off)
        mine = (whole[0] >= r * C) & (whole[0] < (r + 1) * C)
        shift = off - r * C                       # window row = global row + shift
        assert torch.equal(rr + r * C, whole[0][mine])
        assert torch.equal(jj - shift, whole[1][mine])
        csched = cw.cell_schedule(grid, cs_ext, C, off)
        in_cells = (torch.arange(C) + r * C) < int(cs[grid.ncells])
        assert torch.equal(csched.pass_of >= 0, in_cells)
        _hold(csched, grid, pl.cell, in_cells, cs_ext, pos, kern.H2, off)


@pytest.mark.parametrize("dims", [2, 3])
def test_schedule_stats(dims):
    """The stats chip_smoke.py prints: passes and lanes add up, the block
    schedule fills its warps at least as well as the cell schedule, the
    filter tests at least the self's own candidates, and the tiles and their
    fill are those of the pass's stream cut into full tiles."""
    kern, grid, p, cs, _ = _state(dims, "lattice")
    n_live = int(p.active.sum())
    for sched in (bs.block_schedule(grid, p, cs), cw.cell_schedule(grid, cs, p.capacity)):
        st = bs.schedule_stats(sched, grid, cs)
        assert st["warp_passes"] >= st["groups"] > 0
        assert st["mean_active_lanes"] * st["warp_passes"] == pytest.approx(n_live)
        assert 0 < st["mean_active_lanes"] <= bs.WARP
        assert st["union_over_self_candidates"] >= 1.0
        assert st["tiles"] >= st["union_rows"] / bs.WALK_TILE
        # a pass's tiles are its union rows cut every WALK_TILE rows
        ub, ue, _, _ = bs._pass_rows(sched, grid, cs)
        assert st["tiles"] == sum(len(pass_tiles(a, b)) for a, b in zip(ub, ue))
        assert 0 < st["tile_fill"] <= 1.0
        assert st["tile_fill"] * st["tiles"] * bs.WALK_TILE == pytest.approx(st["union_rows"])
    blk = bs.schedule_stats(bs.block_schedule(grid, p, cs), grid, cs)
    cel = bs.schedule_stats(cw.cell_schedule(grid, cs, p.capacity), grid, cs)
    assert blk["mean_active_lanes"] >= cel["mean_active_lanes"]
    assert blk["self_candidates"] == cel["self_candidates"]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["lattice", "crowded", "sheet"])
def test_pass_bodies(dims, case):
    """The pair bodies a warp runs by compute batching: a lane's accepts add
    up to the walk's accepted pairs; batching over a span that holds others
    never costs more bodies (tile >= pass and stencil row >= pass, a pass's
    tiles and its stencil rows each cutting it, >= the mean lane; a tile
    may span stencil rows, so neither holds the other), and no batching
    costs more than stepping through the union together.  The
    walk's per-tile choice of path (``balanced``) never costs more than the
    per-lane path on every tile and never less than ceil(pairs / 32) a tile;
    it and the cooperative share are those of the rule applied to the
    tiles' pairs counted from the accepted candidates."""
    kern, grid, p, cs, _ = _state(dims, case)
    for sched in (bs.block_schedule(grid, p, cs), cw.cell_schedule(grid, cs, p.capacity)):
        n_pass = int(sched.pass_row.shape[0])
        queue = bs.walk_queue(1 + dims)
        b = bs.pass_bodies(sched, grid, cs, p.position, kern.H2, torch.arange(n_pass),
                           queue=queue)
        got = bs.walk_candidates(sched, grid, cs, p.position, kern.H2)
        assert b["passes"] == n_pass
        accepted = torch.bincount(sched.pass_of[got[0]], minlength=n_pass)
        members = torch.bincount(sched.pass_of[sched.pass_of >= 0], minlength=n_pass)
        assert b["mean_lane"] == pytest.approx(float((accepted / members).sum()))
        assert b["any_lane"] >= b["per_tile"] >= b["per_pass"]
        assert b["any_lane"] >= b["per_row"] >= b["per_pass"]
        assert b["per_pass"] >= b["mean_lane"] > 0
        tiles = tile_pairs(sched, grid, cs, p.position, kern.H2)
        assert sum(map(sum, tiles)) == got[0].numel()
        assert b["per_tile"] == sum(map(max, tiles))
        least = sum(-(-sum(t) // bs.WARP) for t in tiles)
        assert b["per_tile"] >= b["balanced"] >= least
        rule = [bs.tile_rounds(t, queue) for t in tiles]
        assert b["balanced"] == sum(r for r, _ in rule)
        n_tiles = bs.schedule_stats(sched, grid, cs)["tiles"]
        assert b["cooperative_tiles"] * n_tiles == pytest.approx(sum(c for _, c in rule))
        for t, (r, c) in zip(tiles, rule):
            assert -(-sum(t) // bs.WARP) <= r <= max(t)
            assert c == (r < max(t))
            assert sum(max(x - r, 0) for x in t) <= queue   # the pairs past the rounds fit


def _tile_walk(sched, grid, cs, position, H2):
    """The pairs (r, j) of the kernel's stage -> filter -> compute order:
    each pass's tiles (walk_tiles.pass_tiles), each member's masks of a tile
    as walk_stage forms them (walk_tiles.tile_masks), the d2 test of every
    staged row, its accepted offsets ascending; r ascending, each self's
    pairs in the order the walk folds them.  Checks each accepted pair's
    role bit against same_cell ? i < j : i > j on the way.  Also returns
    each pass's tiles."""
    ub, ue, base, valid = bs._pass_rows(sched, grid, cs)
    csl = cs.long()
    pairs, passes = {}, []
    for q in range(ub.shape[0]):
        tiles = pass_tiles(ub[q], ue[q])
        passes.append(tiles)
        for r in torch.nonzero(sched.pass_of == q).flatten().tolist():
            xl, xh = sched.x_range[r].tolist()
            jb = [int(csl[base[q, s] + xl]) if valid[q, s] else 0 for s in range(ub.shape[1])]
            je = [int(csl[base[q, s] + xh + 1]) if valid[q, s] else 0
                  for s in range(ub.shape[1])]
            s_i, e_i = sched.own[r].tolist()
            mine = pairs.setdefault(r, [])
            for pieces in tiles:
                own, role = tile_masks(pieces, jb, je, r, s_i, e_i)
                rows = torch.cat([torch.arange(a, a + n) for _, a, n in pieces])
                keep = ~(_d2(position, torch.full_like(rows, r), rows) > H2)
                for k in torch.nonzero(keep).flatten().tolist():
                    if own >> k & 1:
                        j = int(rows[k])
                        assert bool(role >> k & 1) == ((r < j) if s_i <= j < e_i else (r > j))
                        mine.append(j)
    r = torch.tensor([r for r in sorted(pairs) for _ in pairs[r]], dtype=torch.int64)
    j = torch.tensor([j for k in sorted(pairs) for j in pairs[k]], dtype=torch.int64)
    return (r, j), passes


def _has(shape, passes, S):
    """Whether the tiles of ``passes`` (per pass, pass_tiles' lists) show
    ``shape``."""
    tiles = [t for p in passes for t in p]
    if shape == "two_and_three_rows":
        return {2, 3} <= {len({s for s, _, _ in t}) for t in tiles}
    if shape == "part_full_last":
        return any(len(p) >= 2 and sum(n for _, _, n in p[-1]) < bs.WALK_TILE for p in passes)
    if shape == "short_rows":           # a stencil row of 1-3 union rows
        for p in passes:
            runs = {}
            for s, _, n in (piece for t in p for piece in t):
                runs[s] = runs.get(s, 0) + n
            if any(n <= 3 for n in runs.values()):
                return True
        return False
    return any(len({s for s, _, _ in t}) == S for t in tiles)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case,shape", [("spans", "two_and_three_rows"),
                                        ("spans", "part_full_last"),
                                        ("surface", "short_rows"),
                                        ("surface", "every_row")])
def test_stream_tiles(dims, case, shape):
    """The walk stages a pass's candidates as one stream of full tiles: a
    tile spans two and three stencil rows, stencil rows of 1-3 candidates
    (a free surface) share a tile, a tile touches every stencil row of its
    pass (the walk ends no tile early for the number of its stencil rows),
    a pass of several tiles ends in a part-full one.  In each, every tile
    but a pass's last is full, and the pairs taken tile by tile through the
    kernel's masks are the row_segments candidates in their order, each
    with its density-diffusion role."""
    kern, grid, p, cs, _ = _state(dims, case)
    in_cells = torch.arange(p.capacity) < int(cs[grid.ncells])
    shown = False
    for sched, rows in ((bs.block_schedule(grid, p, cs), p.active),
                        (cw.cell_schedule(grid, cs, p.capacity), in_cells)):
        got, passes = _tile_walk(sched, grid, cs, p.position, kern.H2)
        ref = _reference(grid, p.cell, rows, cs, p.position, kern.H2)
        assert ref[0].numel() > 0
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for tiles in passes:
            assert all(sum(n for _, _, n in t) == bs.WALK_TILE for t in tiles[:-1])
        shown |= _has(shape, passes, 3 ** (dims - 1))
    assert shown


@pytest.mark.parametrize("pairs,queue,rounds,cooperative", [
    ([2] * 32, 8, 2, False),                  # balanced: nothing to hand over
    ([9] + [1] * 31, None, 2, True),          # one busy lane: ceil(40 / 32) rounds
    ([40, 40] + [0] * 30, 64, 8, True),       # the queue fits 64 of the 78 past 1 round
    ([5, 3] + [0] * 30, 8, 1, True),          # idle lanes take the 6 queued pairs
    ([5, 3] + [0] * 30, 4, 2, True),          # ... 4 of them, in 2 rounds
    ([1] + [0] * 31, 8, 1, False),
])
def test_tile_rounds(pairs, queue, rounds, cooperative):
    """The walk's rule for a tile: the fewest rounds >= ceil(pairs / 32)
    whose pairs past them fit the queue, cooperative when that is fewer than
    the busiest lane's pairs."""
    assert bs.tile_rounds(pairs, queue) == (rounds, cooperative)


def _lattice(dims, rows_per_cell, side):
    """The decks' initial lattice: sites at (i + 0.5) DX, a quarter of a cell
    off the cell boundaries, under a kernel whose support (the cell edge)
    holds about ``rows_per_cell`` rows a cell: the 3D dam break's h = sqrt(3)
    dx (about 41.6), the moving square's h = k = sqrt(2) dx (4)."""
    h = DX * (np.sqrt(3.0) if rows_per_cell > 8 else np.sqrt(2.0))
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, h=h,
                         k=2.0 if rows_per_cell > 8 else np.sqrt(2.0))
    assert (kern.H / DX) ** dims == pytest.approx(rows_per_cell, rel=0.05)
    pos = (np.stack(np.meshgrid(*([np.arange(side)] * dims), indexing="ij"),
                    axis=-1).reshape(-1, dims) + 0.5) * DX
    n = len(pos)
    grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    p = allocate_particles(pos, np.full(n, 1000.0), np.ones(n, np.int32),
                           np.ones(n, np.int32), np.arange(1, n + 1), device="cpu",
                           dtype=torch.float32, capacity=n)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    return kern, grid, sp, cs


@pytest.mark.parametrize("dims,rows_per_cell,side,least,most", [
    (3, 41.6, 20, 0.0, 0.6),      # the dam break's crowding: the tiles run ~40 % of it
    (2, 4.0, 64, 0.45, 0.7),      # the square's: ~55 %, a tile a pass of its 3 stencil rows
])
def test_cooperative_share_follows_the_crowding(dims, rows_per_cell, side, least, most):
    """Most tiles of both decks' lattices can save a round by handing pairs
    over, and take the cooperative path; what that saves follows the
    crowding: on a 3D lattice of about 40 rows a cell (a lane's pairs gather
    in the stencil rows near its position in the cell) the walk runs under
    0.6 of the per-lane path's bodies, on a 2D lattice of about 4 rows a cell
    0.45-0.7 of them (its pass's few union rows are about one tile, whose
    busiest lane the per-lane path pays)."""
    kern, grid, p, cs = _lattice(dims, rows_per_cell, side)
    sched = bs.block_schedule(grid, p, cs)
    n_pass = int(sched.pass_row.shape[0])
    pick = torch.randperm(n_pass, generator=torch.Generator().manual_seed(0))[:120]
    b = bs.pass_bodies(sched, grid, cs, p.position, kern.H2, pick,
                       queue=bs.walk_queue(1 + dims))
    assert 0.6 <= b["cooperative_tiles"] <= 1.0
    assert least * b["per_tile"] < b["balanced"] < most * b["per_tile"]


@pytest.mark.parametrize("name", ["WALK_TILE", "WALK_TERM_BYTES"])
def test_walk_constants_are_the_kernels(name):
    """The mirrors' constants are the values in csrc/sph_sweep_walk.cuh."""
    src = (Path(bs.__file__).resolve().parent.parent / "csrc" / "sph_sweep_walk.cuh").read_text()
    found = re.findall(rf"constexpr int {name} = (-?\d+);", src)
    assert found == [str(getattr(bs, name))]
