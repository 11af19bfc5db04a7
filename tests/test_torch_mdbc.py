"""The port's mDBC (``ops/mdbc.py``, ``ops/mdbc_moments.py``) on the CPU in
f64 against the JAX package's (gather path, and its Pallas moment kernel in
interpret mode) and the numpy brute force, on the inputs of test_mdbc.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from reference_impl import brute_force_mdbc
from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.ops import mdbc as jmdbc
from sphexample_tpu.ops.interactions import PhysicsSpec as JSpec
from sphexample_tpu.state import allocate_particles as j_allocate
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops import mdbc as tmdbc
from sphexample_tpu_torch.ops import mdbc_moments as tmom
from sphexample_tpu_torch.ops.interactions import PhysicsSpec as TSpec

torch.set_num_threads(1)


def _slab_inputs(dims, seed=7):
    """test_mdbc.py:26-46: a boundary slab at x<0 whose ghosts point into
    the fluid at x>0."""
    rng = np.random.default_rng(seed)
    n_b, n_f = 40, 160
    pos_b = rng.uniform(-0.15, 0.0, size=(n_b, dims))
    pos_f = rng.uniform(0.0, 0.4, size=(n_f, dims))
    pos = np.concatenate([pos_b, pos_f])
    ghost = np.zeros_like(pos)
    ghost[:n_b] = pos_b + np.array([0.1] + [0.0] * (dims - 1))
    dens = rng.uniform(995, 1040, size=n_b + n_f)
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    return pos, ghost, dens, ptype, n_b


def _crowded_inputs(edge):
    """test_mdbc.py:181-251: 90 ghosts inside one cell, 240 fluid particles
    in its 3-cell x-row; with ``edge`` the cell is the grid's corner (stencil
    rows clip, fluid left of the grid is clamped into it); with ``edge ==
    "ghosts_outside"`` a third of the ghost points also lie one cell left of
    the grid and are clamped into the corner cell."""
    rng = np.random.default_rng(11)
    kern = J.make_kernel(J.KernelFamily.WENDLAND_C2, 2, dx=0.05)
    pitch = kern.H
    center = (np.array([0, 0]) if edge else np.array([3, 3])) * pitch
    n_b, n_f = 90, 240
    gpts = center + rng.uniform(-0.45, 0.45, size=(n_b, 2)) * pitch
    if edge == "ghosts_outside":
        gpts[:30, 0] -= 0.6 * pitch
    pos_b = rng.uniform(0, 0.4, size=(n_b, 2)) + np.array([12 * pitch, 0.0])
    fx = rng.uniform(-1.45, 1.45, size=n_f) * pitch + center[0]
    fz = rng.uniform(-0.49, 0.49, size=n_f) * pitch + center[1]
    pos = np.concatenate([pos_b, np.stack([fx, fz], axis=-1)])
    dens = rng.uniform(995, 1040, size=n_b + n_f)
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    ghost = np.zeros_like(pos)
    ghost[:n_b] = gpts
    return pos, ghost, dens, ptype, n_b


def _setup(M, dims, pos, ghost, dens, ptype, grid_args=None, capacity=None,
           family="WENDLAND_C2"):
    """Sorted particles, cell_start, grid and spec of package ``M`` (the JAX
    package or the port) from the same host arrays."""
    n = len(pos)
    const = M.SimulationConstants(dx=0.05)
    kern = M.make_kernel(M.KernelFamily[family], dims, dx=const.dx)
    ids = np.arange(1, n + 1)
    grp = np.ones(n, np.int32)
    cap = capacity or n
    gfull = np.zeros((cap, dims))
    gfull[:n] = ghost
    if M is J:
        cl, Spec = jcl, JSpec
        parts = j_allocate(pos, dens, ptype, grp, ids, dtype=jnp.float64, capacity=cap)
        parts = parts.replace(ghost_points=jnp.asarray(gfull))
    else:
        cl, Spec = tcl, TSpec
        parts = T.allocate_particles(pos, dens, ptype, grp, ids, device="cpu",
                                     dtype=torch.float64, capacity=cap)
        parts = parts.replace(ghost_points=torch.as_tensor(gfull))
    grid = (cl.Grid(**grid_args) if grid_args
            else cl.grid_from_positions(pos, kern.H_inv, margin_cells=3))
    sorted_p, cell_start, _ = cl.rebuild(parts, kern.H_inv, grid)
    spec = Spec(constants=const, kernel=kern, viscosity=M.ViscosityModel.ZERO,
                diffusion=M.DensityDiffusionModel.ZERO)
    return spec, grid, sorted_p, cell_start


def _brute(spec, p):
    kern = spec.kernel
    family = "wendland" if kern.family.name == "WENDLAND_C2" else "cubic"
    return brute_force_mdbc(kern, spec.constants, p.cell.numpy(), p.position.numpy(),
                            p.density.numpy(), p.ptype.numpy(),
                            p.ghost_points.numpy(), kern.H_inv, kernel_family=family)


@pytest.mark.parametrize("dims", [2, 3])
def test_correction_matches_jax_gather_and_brute_force(dims):
    pos, ghost, dens, ptype, n_b = _slab_inputs(dims)
    js, jg, jp, jcs = _setup(J, dims, pos, ghost, dens, ptype)
    ts, tg, tp, tcs = _setup(T, dims, pos, ghost, dens, ptype)
    np.testing.assert_array_equal(np.asarray(jp.id), tp.id.numpy())
    ref = np.asarray(jmdbc.mdbc_density_correction(
        js, jg, 3 * 64, jp, jcs, boundary_capacity=n_b))
    out = tmdbc.mdbc_density_correction(ts, tg, tp, tcs, n_b).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(out, _brute(ts, tp), rtol=1e-8, atol=1e-8)
    # the correction fired, and the fluid densities are untouched bit for bit
    is_fluid = tp.ptype.numpy() == 1
    assert (np.abs(out - tp.density.numpy())[~is_fluid] > 1e-6).any()
    np.testing.assert_array_equal(out[is_fluid], tp.density.numpy()[is_fluid])


def test_correction_matches_jax_pallas_interpret():
    """The JAX package's Pallas moment kernel (interpret mode, 2D, capacity
    512) sums in f32: 3e-5 on the corrected densities (test_mdbc.py:68-70)."""
    pos, ghost, dens, ptype, n_b = _slab_inputs(2)
    js, jg, jp, jcs = _setup(J, 2, pos, ghost, dens, ptype, capacity=512)
    ts, tg, tp, tcs = _setup(T, 2, pos, ghost, dens, ptype, capacity=512)
    ref = np.asarray(jmdbc.mdbc_density_correction(
        js, jg, 256, jp, jcs, boundary_capacity=n_b,
        use_pallas=True, mpc=64, pallas_interpret=True))
    out = tmdbc.mdbc_density_correction(ts, tg, tp, tcs, n_b).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-5, atol=1e-8)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
def test_moments_match_jax_ghost_sums(monkeypatch, dims, family):
    """(bvec, Amat) of the plain version against the sums the JAX gather
    path hands to its ``_mdbc_apply``."""
    pos, ghost, dens, ptype, n_b = _slab_inputs(dims)
    js, jg, jp, jcs = _setup(J, dims, pos, ghost, dens, ptype, family=family)
    ts, tg, tp, tcs = _setup(T, dims, pos, ghost, dens, ptype, family=family)
    seen = {}

    def capture(spec, particles, bidx, bvalid, gpoint, bvec, Amat):
        seen.update(bidx=np.asarray(bidx), bvalid=np.asarray(bvalid),
                    bvec=np.asarray(bvec), Amat=np.asarray(Amat))
        return particles.density

    monkeypatch.setattr(jmdbc, "_mdbc_apply", capture)
    jmdbc.mdbc_density_correction(js, jg, 3 * 64, jp, jcs, boundary_capacity=n_b)

    bidx, bvalid = tmdbc.compact_ghosts(tp, n_b)
    np.testing.assert_array_equal(bidx.numpy(), seen["bidx"])
    np.testing.assert_array_equal(bvalid.numpy(), seen["bvalid"])
    bvec, Amat = tmom.mdbc_moments(ts, tg, tp.ghost_points[bidx], bvalid, tp.position,
                                   tp.density, tp.motion_limiter, tcs)
    assert bvec.shape == (n_b, dims + 1) and Amat.shape == (n_b, dims + 1, dims + 1)
    assert np.abs(seen["Amat"]).max() > 0
    for a, b in ((bvec.numpy(), seen["bvec"]), (Amat.numpy(), seen["Amat"])):
        # atol: entries that cancel to ~0 against the largest of the system
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-13 * np.abs(b).max())


@pytest.mark.parametrize("n", [3, 4])
def test_det_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(64, n, n))
    b = rng.normal(size=(64, n))
    A[5, :, 1] = 2.0 * A[5, :, 0]     # singular: two proportional columns
    A[6] = 0.0                        # singular: all zero
    jd, jx = jmdbc._det_solve(jnp.asarray(A), jnp.asarray(b))
    td, tx = tmdbc._det_solve(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-12, atol=1e-15)
    ok = np.ones(64, bool)
    ok[[5, 6]] = False
    np.testing.assert_allclose(tx.numpy()[ok], np.asarray(jx)[ok], rtol=1e-12, atol=1e-15)
    # and it solves the regular systems
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A[ok], tx.numpy()[ok]), b[ok],
                               rtol=1e-8, atol=1e-8)
    # the singular rows divide by a (near-)zero det: the same non-finite
    # pattern as JAX, no exception
    assert abs(float(td[5])) < 1e-12 and float(td[6]) == 0.0
    np.testing.assert_array_equal(np.isnan(tx.numpy()[6]), np.isnan(np.asarray(jx)[6]))
    assert np.isnan(tx.numpy()[6]).all()
    with pytest.raises(ValueError):
        tmdbc._det_solve(torch.zeros(2, 5, 5), torch.zeros(2, 5))


def test_no_neighbors_keeps_density():
    """A ghost far from every particle: zero moments, zero det and A00 - the
    branch not taken divides by zero and is selected away."""
    const = T.SimulationConstants(dx=0.05)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    parts = T.allocate_particles(
        np.array([[0.0, 0.0]]), np.array([990.0]), np.array([2], np.int32),
        np.array([1], np.int32), np.array([1]), device="cpu", dtype=torch.float64)
    parts = parts.replace(ghost_points=torch.tensor([[5.0, 5.0]], dtype=torch.float64))
    grid = tcl.Grid(cmin=(-2, -2), shape=(40, 40))
    sp, cs, _ = tcl.rebuild(parts, kern.H_inv, grid)
    spec = TSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                 diffusion=T.DensityDiffusionModel.ZERO)
    with torch.autograd.set_detect_anomaly(True):
        out = tmdbc.mdbc_density_correction(spec, grid, sp, cs, 1)
    assert float(out[0]) == 990.0


@pytest.mark.parametrize("edge", [False, True, "ghosts_outside"])
def test_crowded_and_edge_clamped_cells(edge):
    pos, ghost, dens, ptype, n_b = _crowded_inputs(edge)
    grid_args = dict(cmin=(0, 0), shape=(16, 16)) if edge else None
    ts, tg, tp, tcs = _setup(T, 2, pos, ghost, dens, ptype, grid_args=grid_args,
                             capacity=1024)
    out = tmdbc.mdbc_density_correction(ts, tg, tp, tcs, n_b).numpy()
    live = tp.active.numpy()
    ref = _brute(ts, tp)
    np.testing.assert_allclose(out[live], ref[live], rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(out[~live], tp.density.numpy()[~live])
    is_b = tp.ptype.numpy()[live] == 2
    changed = np.abs(out - tp.density.numpy())[live] > 1e-12
    if edge:
        # fluid (and ghost points) left of the corner cell are clamped into it
        for pts, outside in ((tp.position, True),
                             (tp.ghost_points, edge == "ghosts_outside")):
            raw = tcl.cell_coords(pts[tp.active], ts.kernel.H_inv)
            assert bool((raw != tcl.clamp_coords(raw, tg)).any()) == outside
        assert changed[is_b].any()
    else:
        assert changed[is_b].mean() > 0.9
    # the JAX gather path sees the same clamped cells
    js, jg, jp, jcs = _setup(J, 2, pos, ghost, dens, ptype, grid_args=grid_args,
                             capacity=1024)
    jref = np.asarray(jmdbc.mdbc_density_correction(js, jg, 384, jp, jcs,
                                                    boundary_capacity=n_b))
    np.testing.assert_allclose(out, jref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("capacity,n_ghost_rows", [(8, 3), (2, 3), (4, 0)])
def test_compaction_fill_and_size_rules(capacity, n_ghost_rows):
    """The list is what ``jnp.nonzero(has_ghost, size=B, fill_value=0)``
    gives: ascending rows, fill slots at row 0 with row 0's validity, rows
    past the capacity dropped; and no ghost at all leaves the density as is."""
    n = 12
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 0.3, size=(n, 2))
    ghost = np.zeros((n, 2))
    rows = [2, 5, 9][:n_ghost_rows]
    ghost[rows] = pos[rows] + 0.02
    ptype = np.full(n, 1, np.int32)
    ptype[rows] = 2
    dens = rng.uniform(995, 1040, size=n)
    ts, tg, tp, tcs = _setup(T, 2, pos, ghost, dens, ptype, capacity=16)
    has = (tp.ghost_points != 0).any(-1) & tp.active
    (jb,) = jnp.nonzero(jnp.asarray(has.numpy()), size=capacity, fill_value=0)
    bidx, bvalid = tmdbc.compact_ghosts(tp, capacity)
    np.testing.assert_array_equal(bidx.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(bvalid.numpy(), has.numpy()[np.asarray(jb)])
    out = tmdbc.mdbc_density_correction(ts, tg, tp, tcs, capacity)
    changed = (out != tp.density).numpy()
    assert changed.sum() == min(capacity, n_ghost_rows)
    assert not changed[~has.numpy()].any()


def test_rebuild_carries_ghost_fields():
    """``Particles.permute`` moves ghost points and normals with their rows."""
    pos, ghost, dens, ptype, n_b = _slab_inputs(2)
    n = len(pos)
    const = T.SimulationConstants(dx=0.05)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    parts = T.allocate_particles(pos, dens, ptype, np.ones(n, np.int32),
                                 np.arange(1, n + 1), device="cpu", dtype=torch.float64)
    normals = ghost - np.where(ghost.any(-1, keepdims=True), pos, 0.0)
    parts = parts.replace(ghost_points=torch.as_tensor(ghost),
                          ghost_normals=torch.as_tensor(normals))
    grid = tcl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, _, _ = tcl.rebuild(parts, kern.H_inv, grid)
    rows = sp.id.numpy() - 1
    assert (rows != np.arange(n)).any()
    np.testing.assert_array_equal(sp.ghost_points.numpy(), ghost[rows])
    np.testing.assert_array_equal(sp.ghost_normals.numpy(), normals[rows])
    np.testing.assert_array_equal(sp.position.numpy(), pos[rows])


def test_cuda_only_checks_run_before_any_build():
    """What the wrapper refuses for a CUDA tensor it refuses by name, before
    it builds or launches anything (no card needed to see it)."""
    const = T.SimulationConstants(dx=0.05)
    spec = TSpec(constants=const,
                 kernel=T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=0.05),
                 viscosity=T.ViscosityModel.ZERO, diffusion=T.DensityDiffusionModel.ZERO)
    assert tmom.kernel_variant(spec, 2) == 0 and tmom.kernel_variant(spec, 3) == 2
    with pytest.raises(NotImplementedError, match="dims"):
        tmom.kernel_variant(spec, 1)
    assert tmom.n_moments(2) == 12 and tmom.n_moments(3) == 20
