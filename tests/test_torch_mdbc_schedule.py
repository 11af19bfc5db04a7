"""The fused mDBC kernel's schedule and epilogue, held on the CPU.

``csrc/mdbc_moments.cu`` cannot run here, so what decides its results is
mirrored in plain code and pinned:

* the grouping (``ops/mdbc_moments.py:ghost_groups``, the mirror of the
  kernel's steps 1-3): each slot's key - the clamped cell of its ghost point
  in f32 - against a numpy brute force and against the JAX package's
  ``clamp_coords(cell_coords(...))``; the parking of invalid and fill slots;
  the counting sort into occupied cells and work entries; each group's
  stencil rows equal to every member ghost's own candidate ranges;
* the epilogue's expression tree (written out below entry by entry, as the
  kernel's ``det3`` / ``det4`` / ``correct`` compute it) against
  ``ops/mdbc.py:_mdbc_apply`` bit for bit, f32 and f64, on seeded systems with
  singular ones, A00 = 0, NaN entries and determinants on the 1e-3 threshold;
  and against the JAX package's ``_det_solve`` within the f64 bands of
  tests/test_sweep.py:103-107 (rtol 1e-10, atol 1e-8) and the f32 kernel
  bands of tests/test_pallas_block.py:68-93 (2e-5);
* the schedule constants and ``struct MdbcParams`` against their Python
  mirrors, parsed from the source.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.ops import mdbc as jmdbc
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops import mdbc as tmdbc
from sphexample_tpu_torch.ops import mdbc_moments as tmom
from sphexample_tpu_torch.ops.interactions import PhysicsSpec

torch.set_num_threads(1)
SRC = (Path(tmom.__file__).resolve().parent.parent / "csrc" / "mdbc_moments.cu").read_text()
DX = 0.05
CASES = ["slab", "crowded", "edge", "outside", "halves", "many"]


def _spec(dims, family="WENDLAND_C2"):
    const = T.SimulationConstants(dx=DX)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    return PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                       diffusion=T.DensityDiffusionModel.ZERO)


def _ghosts(dims, case, seed=3):
    """(spec, grid, ghost points [B, D] f64, validity [B]) of a case:
    ``slab`` scattered ghosts, ``crowded`` 90 in one cell, ``edge`` at the
    grid's corner with a third outside it, ``outside`` all outside the grid on
    every side, ``halves`` on the half-integer cell boundaries (where
    map_floor rounds away from zero), ``many`` 700 in a few cells."""
    rng = np.random.default_rng(seed)
    spec = _spec(dims)
    pitch = spec.kernel.H
    grid = tcl.Grid(cmin=(-4,) * dims, shape=(12,) * dims)
    if case == "slab":
        g = rng.uniform(-3.5, 6.5, size=(150, dims)) * pitch
    elif case == "crowded":
        g = (3.0 + rng.uniform(-0.45, 0.45, size=(90, dims))) * pitch
    elif case == "edge":
        g = (-4.0 + rng.uniform(-0.45, 0.45, size=(90, dims))) * pitch
        g[:30, 0] -= 0.6 * pitch
    elif case == "outside":
        g = rng.uniform(-9.0, 12.0, size=(200, dims)) * pitch
    elif case == "halves":
        g = (rng.integers(-6, 9, size=(120, dims)) + 0.5) * pitch
    else:
        g = (rng.integers(0, 3, size=(700, 1)) + rng.uniform(-0.4, 0.4, size=(700, dims))) \
            * pitch
    valid = rng.uniform(size=len(g)) > 0.1
    return spec, grid, torch.as_tensor(g), torch.as_tensor(valid)


def _numpy_keys(g, H_inv, grid):
    """map_floor in f32, two roundings, clamped and linearized, in numpy."""
    x = g.numpy().astype(np.float32)
    t = np.trunc(np.abs(x) * np.float32(H_inv) + np.float32(0.5))
    c = np.where(x < 0, -t, t).astype(np.int64)
    lo = np.asarray(grid.cmin)
    rel = np.clip(c - lo, 0, np.asarray(grid.shape) - 1)
    return (rel * np.asarray(grid.strides)).sum(-1)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_keys_match_numpy_and_jax(dims, case):
    spec, grid, g, valid = _ghosts(dims, case)
    groups = tmom.ghost_groups(spec, grid, g, valid)
    keys = groups["keys"].numpy()
    want = _numpy_keys(g, spec.kernel.H_inv, grid)
    np.testing.assert_array_equal(keys[valid.numpy()], want[valid.numpy()])
    assert (keys[~valid.numpy()] == -1).all()
    jgrid = jcl.Grid(cmin=grid.cmin, shape=grid.shape)
    jc = jcl.clamp_coords(jcl.cell_coords(jnp.asarray(g.numpy().astype(np.float32)),
                                          spec.kernel.H_inv), jgrid)
    np.testing.assert_array_equal(keys[valid.numpy()],
                                  np.asarray(jcl.linearize(jc, jgrid))[valid.numpy()])
    if case == "outside":
        raw = tcl.cell_coords(g.float(), spec.kernel.H_inv)
        assert bool((raw != tcl.clamp_coords(raw, grid)).all(-1).any())


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_counting_sort_into_cells_and_entries(dims, case):
    """Occupied cells ascending with their ghost counts, every unparked slot
    once in ``order`` under its cell, entries = each cell's ghosts in chunks
    of CHUNK; the same groups whatever the slot order."""
    spec, grid, g, valid = _ghosts(dims, case)
    groups = tmom.ghost_groups(spec, grid, g, valid)
    keys = groups["keys"]
    live = keys[keys >= 0].numpy()
    cells, counts = np.unique(live, return_counts=True)
    np.testing.assert_array_equal(groups["cells"].numpy(), cells)
    np.testing.assert_array_equal(groups["counts"].numpy(), counts)
    order = groups["order"].numpy()
    assert sorted(order.tolist()) == np.nonzero(valid.numpy())[0].tolist()
    assert (np.diff(keys.numpy()[order]) >= 0).all()
    want = [min(tmom.CHUNK, n - k) for n in counts for k in range(0, n, tmom.CHUNK)]
    np.testing.assert_array_equal(groups["entries"].numpy(), want)
    assert int(groups["entries"].sum()) == int(valid.sum())
    np.testing.assert_array_equal(groups["cells"][groups["entry_cell"]].numpy(),
                                  np.repeat(cells, [len(range(0, n, tmom.CHUNK))
                                                    for n in counts]))
    perm = torch.as_tensor(np.random.default_rng(1).permutation(len(g)))
    shuffled = tmom.ghost_groups(spec, grid, g[perm], valid[perm])
    assert torch.equal(shuffled["cells"], groups["cells"])
    assert torch.equal(shuffled["counts"], groups["counts"])
    assert torch.equal(shuffled["keys"], groups["keys"][perm])


@pytest.mark.parametrize("row0_has_ghost", [True, False])
@pytest.mark.parametrize("capacity", [3, 8, 16])
def test_parking_of_invalid_and_fill_slots(row0_has_ghost, capacity):
    """With the compacted list, fill slots (b > 0 at row 0) are parked
    whatever their validity, and so are invalid slots; slot 0 computes when
    row 0 carries the first ghost.  Without the list (moments mode) only
    invalid slots are parked."""
    spec = _spec(2)
    n = 12
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 0.3, size=(n, 2))
    rows = ([0] if row0_has_ghost else []) + [4, 7, 9]
    ghost = np.zeros((n, 2))
    ghost[rows] = pos[rows] + 0.02
    ptype = np.full(n, 1, np.int32)
    ptype[rows] = 2
    parts = T.allocate_particles(pos, rng.uniform(995, 1040, size=n), ptype,
                                 np.ones(n, np.int32), np.arange(1, n + 1), device="cpu",
                                 dtype=torch.float64, capacity=n)
    parts = parts.replace(ghost_points=torch.as_tensor(ghost))
    grid = tcl.grid_from_positions(pos, spec.kernel.H_inv, margin_cells=3)
    bidx, bvalid = tmdbc.compact_ghosts(parts, capacity)
    gp = parts.ghost_points[bidx]
    fused = tmom.ghost_groups(spec, grid, gp, bvalid, bidx=bidx)
    fill = (torch.arange(capacity) > 0) & (bidx == 0)
    assert torch.equal(fused["parked"], ~bvalid | fill)
    assert int((~fused["parked"]).sum()) == min(capacity, len(rows))
    assert bool(fill.any()) == (capacity > len(rows))
    moments = tmom.ghost_groups(spec, grid, gp, bvalid)
    assert torch.equal(moments["parked"], ~bvalid)
    if row0_has_ghost and capacity > len(rows):
        # the fill slots are valid copies of row 0: computed in moments mode
        assert int((~moments["parked"]).sum()) == capacity


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["sparse", "crowded", "edge", "wide"])
def test_group_stencil_is_each_ghosts_candidates(dims, case):
    """The rows a work entry stages are, per stencil row, the range
    ``row_segments`` gives each of its ghosts (the kernel's sums rest on
    it); ``staged`` caps them at STAGE_ROWS and skips entries of one ghost."""
    rng = np.random.default_rng(9)
    spec = _spec(dims)
    pitch = spec.kernel.H
    n_f = 3000 if case == "wide" else 400
    if case == "sparse":
        gp = rng.uniform(0.0, 0.4, size=(80, dims))
        pos = rng.uniform(-0.1, 0.5, size=(n_f, dims))
    else:
        center = np.zeros(dims) if case == "edge" else np.full(dims, 3.0 * pitch)
        gp = center + rng.uniform(-0.45, 0.45, size=(90, dims)) * pitch
        pos = center + rng.uniform(-0.49, 0.49, size=(n_f, dims)) * pitch
        pos[:, 0] = center[0] + rng.uniform(-1.45, 1.45, size=n_f) * pitch
    parts = T.allocate_particles(pos, np.full(n_f, 1000.0), np.ones(n_f, np.int32),
                                 np.ones(n_f, np.int32), np.arange(1, n_f + 1), device="cpu",
                                 dtype=torch.float64, capacity=n_f)
    grid = (tcl.Grid(cmin=(0,) * dims, shape=(10,) * dims) if case == "edge"
            else tcl.grid_from_positions(np.concatenate([pos, gp]), spec.kernel.H_inv,
                                         margin_cells=2))
    _, cs, _ = tcl.rebuild(parts, spec.kernel.H_inv, grid)
    g = torch.as_tensor(gp)
    groups = tmom.ghost_groups(spec, grid, g, torch.ones(len(g), dtype=torch.bool),
                               cell_start=cs)
    coords = tcl.clamp_coords(tcl.cell_coords(g.float(), spec.kernel.H_inv), grid)
    starts, ends = tcl.row_segments(coords, grid, cs)
    own = (ends - starts).sum(-1)
    slot_cell = torch.searchsorted(groups["cells"], groups["keys"])
    assert torch.equal(groups["rows"][slot_cell], own.long())
    rows = groups["rows"][groups["entry_cell"]]
    want = torch.where(groups["entries"] >= tmom.MIN_STAGE, rows.clamp(max=tmom.STAGE_ROWS), 0)
    assert torch.equal(groups["staged"], want)
    if case == "wide":
        assert int(groups["rows"].max()) > tmom.STAGE_ROWS
    stats = tmom.schedule_stats(groups)
    assert stats["candidate_rows"] == int(own.sum())
    assert stats["ghosts"] == len(g) and stats["parked_slots"] == 0
    assert stats["staged_rows"] == int(groups["staged"].sum())
    assert stats["candidate_rows_read_unstaged"] == int(
        (groups["entries"] * (rows - groups["staged"])).sum())


@pytest.mark.parametrize("dims", [2, 3])
def test_dry_slots_have_no_fluid_candidate(dims):
    """A slot is dry exactly when no candidate row of its stencil is a fluid
    row (brute force over its candidate list); dry slots are not grouped."""
    rng = np.random.default_rng(4)
    spec = _spec(dims)
    n_b, n_f = 150, 120
    pos = np.concatenate([rng.uniform(0.0, 0.8, size=(n_b, dims)),
                          rng.uniform(0.6, 0.9, size=(n_f, dims))])
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    n = n_b + n_f
    parts = T.allocate_particles(pos, np.full(n, 1000.0), ptype, np.ones(n, np.int32),
                                 np.arange(1, n + 1), device="cpu", dtype=torch.float64,
                                 capacity=n + 4)
    grid = tcl.grid_from_positions(pos, spec.kernel.H_inv, margin_cells=2)
    sp, cs, _ = tcl.rebuild(parts, spec.kernel.H_inv, grid)
    g = torch.as_tensor(rng.uniform(0.0, 0.8, size=(200, dims)))
    valid = torch.as_tensor(rng.uniform(size=200) > 0.05)
    groups = tmom.ghost_groups(spec, grid, g, valid, cell_start=cs,
                               motion_limiter=sp.motion_limiter)
    starts, ends = tcl.row_segments(tcl.clamp_coords(tcl.cell_coords(
        g.float(), spec.kernel.H_inv), grid), grid, cs)
    i, j = tmom.candidates(starts, ends, 0, len(g))
    wet = torch.zeros(len(g), dtype=torch.bool)
    wet[i[sp.motion_limiter[j] > 0.5]] = True
    assert torch.equal(groups["dry"], valid & ~wet)
    assert 0 < int(groups["dry"].sum()) < int(valid.sum())
    assert torch.equal(groups["keys"] >= 0, valid & wet)
    assert int(groups["counts"].sum()) == int((valid & wet).sum())


def test_schedule_constants_match_the_source():
    got = {k: int(v) for k, v in re.findall(r"constexpr int (MDBC_\w+) = (\d+);", SRC)}
    assert got["MDBC_CHUNK"] == tmom.CHUNK
    assert got["MDBC_STAGE_ROWS"] == tmom.STAGE_ROWS
    assert got["MDBC_MIN_STAGE"] == tmom.MIN_STAGE
    launches = re.findall(r"(mdbc_\w+_group_kernel)(?:<[^<>]*>)?<<<", SRC)
    assert launches == ["mdbc_wet_group_kernel", "mdbc_keys_group_kernel",
                        "mdbc_cells_group_kernel", "mdbc_order_group_kernel"]
    # every launch, grouping and moments, is checked for an error where it was made
    body = SRC[SRC.index("cudaError_t launch("):SRC.index("}  // namespace")]
    assert len(re.findall(r">>>\(", body)) == 5
    assert len(re.findall(r">>>\([^;]*\);\s*(?:if \(\(err = |return )cudaGetLastError\(\)",
                          body)) == 5


def test_params_struct_matches_the_source():
    body = re.search(r"struct MdbcParams \{(.*?)\};", SRC, re.S).group(1)
    ctypes_of = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double}
    fields = []
    for ctype, name, arr in re.findall(r"^\s*(int|float|double) (\w+)(\[\d+\])?;", body, re.M):
        t = ctypes_of[ctype]
        fields.append((name, t * int(arr[1:-1]) if arr else t))
    mirror = tmom.MdbcParams._fields_
    assert [f[0] for f in mirror] == [f[0] for f in fields]
    for (_, a), (_, b) in zip(mirror, fields):
        assert ctypes.sizeof(a) == ctypes.sizeof(b) and a._type_ == b._type_ \
            if hasattr(a, "_length_") else a == b


# --- the epilogue's expression tree -------------------------------------------


def _det3(m):
    """csrc/mdbc_moments.cu::det3, entry by entry; ``m(r, c)`` an entry."""
    a = m(0, 0) * (m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1))
    b = m(0, 1) * (m(1, 0) * m(2, 2) - m(1, 2) * m(2, 0))
    c = m(0, 2) * (m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0))
    return (a - b) + c


def _det(m, n):
    if n == 3:
        return _det3(m)
    t = [m(0, k) * _det3(lambda r, c, k=k: m(1 + r, c if c < k else c + 1)) for k in range(4)]
    return ((t[0] - t[1]) + t[2]) - t[3]


def epilogue_tree(bvec, Amat, diff, rho_old, rho0):
    """The kernel's ``correct``: determinant k on lane k (A, then A with
    column k - 1 replaced by b), the quotients, the gradient term left to
    right, the Shepard quotient, the decision tree and the NaN scrub."""
    n = Amat.shape[-1]
    dets = [_det(lambda r, c, k=k: bvec[:, r] if c == k - 1 else Amat[:, r, c], n)
            for k in range(n + 1)]
    sol = [dk / dets[0] for dk in dets[1:]]
    grad = sol[1] * diff[:, 0]
    for d in range(1, n - 1):
        grad = grad + sol[1 + d] * diff[:, d]
    rho_solve = sol[0] + grad
    rho_shepard = bvec[:, 0] / Amat[:, 0, 0]
    use_solve = torch.abs(dets[0]) >= tmom.DET_THRESHOLD
    use_shepard = ~use_solve & (Amat[:, 0, 0] > 0)
    rho = torch.where(use_solve, rho_solve, torch.where(use_shepard, rho_shepard, rho_old))
    rho = torch.where(torch.isnan(rho), torch.full_like(rho, rho0), rho)
    return rho, use_solve.to(torch.int8) * 2 + use_shepard.to(torch.int8), dets[0], sol


def _systems(n, dtype, seed):
    """Seeded moment systems: well-posed ones, two proportional columns, all
    zero, A00 = 0 with a singular rest, NaN in A and in b, b = 0, and
    determinants placed on, just above and just below the 1e-3 threshold."""
    rng = np.random.default_rng(seed)
    B = 96
    A = rng.normal(size=(B, n, n)) + 3 * np.eye(n)
    b = rng.normal(size=(B, n)) * 1000.0
    A[1, :, 1] = 2.0 * A[1, :, 0]
    A[2] = 0.0
    b[2] = 0.0
    A[3, 0, :] = 0.0
    A[3, :, 0] = 0.0
    A[4, 1, 2] = np.nan
    b[5, 0] = np.nan
    b[6] = 0.0
    A[7, 0, 0] = -1.0
    A[7, 1:, :] = 0.0
    # det A = A00 exactly: the threshold in the state's dtype, the next
    # numbers above and below it, and its negative
    np_t = np.float32 if dtype == torch.float32 else np.float64
    thr = np_t(tmom.DET_THRESHOLD)
    for i, v in ((8, thr), (9, np.nextafter(thr, np_t(1))), (10, np.nextafter(thr, np_t(0))),
                 (11, -thr)):
        A[i] = np.eye(n)
        A[i, 0, 0] = float(v)
    A, b = torch.as_tensor(A, dtype=dtype), torch.as_tensor(b, dtype=dtype)
    diff = torch.as_tensor(rng.normal(size=(B, n - 1)) * 0.01, dtype=dtype)
    rho_old = torch.as_tensor(rng.uniform(995, 1040, size=B), dtype=dtype)
    rho_old[12] = float("nan")
    A[12] = 0.0
    return A, b, diff, rho_old


def _apply(A, b, diff, rho_old, rho0):
    """``_mdbc_apply`` on slots whose particle row r holds rho_old[r] at
    position gpoint[r] + diff[r]."""
    B, n = b.shape
    dims = n - 1
    spec = PhysicsSpec(constants=T.SimulationConstants(dx=DX, rho0=rho0),
                       kernel=T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX),
                       viscosity=T.ViscosityModel.ZERO, diffusion=T.DensityDiffusionModel.ZERO)
    gpoint = torch.linspace(0.1, 0.5, B * dims, dtype=b.dtype).reshape(B, dims)
    parts = T.allocate_particles(np.zeros((B, dims)), np.full(B, 1000.0), np.full(B, 2, np.int32),
                                 np.ones(B, np.int32), np.arange(1, B + 1), device="cpu",
                                 dtype=b.dtype, capacity=B)
    parts = parts.replace(position=gpoint + diff, density=rho_old)
    bidx = torch.arange(B)
    return tmdbc._mdbc_apply(spec, parts, bidx, torch.ones(B, dtype=torch.bool),
                             gpoint, b, A), (gpoint + diff) - gpoint


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_epilogue_tree_is_mdbc_apply_bit_for_bit(dtype, n, seed):
    A, b, diff, rho_old = _systems(n, dtype, seed)
    (rho, dec), d = _apply(A, b, diff, rho_old, 1000.0)
    got, got_dec, det, _ = epilogue_tree(b, A, d, rho_old, 1000.0)
    assert torch.equal(got, rho) and torch.equal(got_dec, dec)
    # the cases the systems were built for
    assert int(dec[8]) == 2 and int(dec[11]) == 2              # |det| on the threshold
    assert (int(dec[9]), int(dec[10])) == (2, 1)                # just above / below
    assert int(dec[7]) == 0 and int(dec[2]) == 0 and int(dec[3]) == 0
    assert float(rho[12]) == 1000.0                             # NaN scrubbed to rho0
    assert torch.isfinite(rho).all()


@pytest.mark.parametrize("n", [3, 4])
def test_epilogue_tree_matches_jax_det_solve(n):
    """f64 within the bands of tests/test_sweep.py:103-107; f32 within the
    f32 kernel bands of tests/test_pallas_block.py:68-93 (XLA may contract
    a product into a multiply-add where torch rounds twice)."""
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-8), (torch.float32, 2e-5, 2e-5)):
        A, b, _, _ = _systems(n, dtype, 7)
        ok = torch.ones(len(b), dtype=torch.bool)
        ok[1:13] = False                                        # the crafted rows
        jd, jx = jmdbc._det_solve(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
        _, _, det, sol = epilogue_tree(b, A, torch.zeros(len(b), n - 1, dtype=dtype),
                                       torch.zeros(len(b), dtype=dtype), 1000.0)
        np.testing.assert_allclose(det.numpy()[ok], np.asarray(jd)[ok], rtol=rtol,
                                   atol=atol * float(np.abs(np.asarray(jd)).max()))
        x = torch.stack(sol, -1).numpy()[ok]
        np.testing.assert_allclose(x, np.asarray(jx)[ok], rtol=rtol,
                                   atol=atol * float(np.abs(np.asarray(jx)[ok]).max()))
        # the column-replaced determinants are torch's _det_solve, bit for bit
        td, tx = tmdbc._det_solve(A, b)
        torch.testing.assert_close(td, det, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(tx, torch.stack(sol, -1), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rho_solve_adds_the_gradient_left_to_right(dtype):
    """``_mdbc_apply``'s rho_solve is sol0 + ((s1 d0 + s2 d1) + s3 d2): the
    order the kernel keeps (and torch.sum's on the card for this
    column-major product), not (s1 d0 + s3 d2) + s2 d1."""
    A, b, diff, rho_old = _systems(4, dtype, 2)
    (rho, dec), d = _apply(A, b, diff * 300.0, rho_old, 1000.0)
    _, sol = tmdbc._det_solve(A, b)
    want = sol[:, 0] + ((sol[:, 1] * d[:, 0] + sol[:, 2] * d[:, 1]) + sol[:, 3] * d[:, 2])
    solve = (dec == 2) & torch.isfinite(want)
    assert int(solve.sum()) > 80
    assert torch.equal(rho[solve], want[solve])
