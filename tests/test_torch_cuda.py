"""The CUDA kernels on the card.  The block sweep: every template instance
of ``csrc/block_sweep.cu`` and every model and mode against the plain sweep
in f64 and against the cell sweep, the wrapper's input checks, a short run
of the main path and of a moving square.  The cell sweep: every
viscosity x diffusion x kernel family of ``csrc/cell_sweep.cu`` with shifting
and kernel output, every template instance, crowded, sparse and edge cells,
its input checks, and a short moving-square run.  The mDBC moment kernel:
every template instance of ``csrc/mdbc_moments.cu`` against its plain version
in f64, crowded and edge-clamped cells included, its input checks, and a
short mDBC run; its fused mode (stage 04 in one call) bit for bit the unfused
path on the card and within 1e-4 of the plain version in every instance, on
an f64 state, cells of 700 ghosts, stencils wider than the stage, dry and
empty stencils, no slots, and on the halo with the other slabs' slots
parked.  The sharded path: the three kernels on the halo-extended windows of
3 slabs (cells straddling the slab edges, the whole-array window) against
their plain versions and against the single-device kernels, the window
entries' input checks, and 4-slab runs as thread ranks on the cards visible.
The host loop: a grid escape re-gridded and replayed on the card, a card
state's checkpoint round trip, and ``check_determinism`` for the block sweep,
the cell sweep and the mDBC kernel.  The chunk graph
(``core/step.py:make_chunk_body``): bit for bit the eager loop on a 3D
deck, an mDBC deck and a moving deck, a replay under sync-debug mode, a
failed capture raising, the launch counts after replays, a handed-out state
unchanged by the next replay.  Tracing (``utils/timers.py``): each replay
timed by its CUDA events within its span, the account of replays, copies
and gaps closing on the device clock, the host reads counted, and every
``cudaGraphLaunch`` of a profiler trace inside a ``chunk.launch`` span.
A CUDA kernel has no CPU mode, so
these tests are marked ``gpu`` and skip without a card.  They import no JAX,
so they also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.io.casegen import dam_break_3d
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import halo as halo_mod
from sphexample_tpu_torch.ops import mdbc
from sphexample_tpu_torch.ops import mdbc_moments as mm
from sphexample_tpu_torch.ops.interactions import PhysicsSpec
from sphexample_tpu_torch.parallel.context import SINGLE
from sphexample_tpu_torch.parallel.mesh import (make_mesh, make_sharded_fixed_steps_fn,
                                                shard_simulation)
from sphexample_tpu_torch.state import Particles, allocate_particles, gather_state
from walk_tiles import tile_pairs

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)
DX = 0.05
# kernel (f32 inputs, its own summation order) vs plain sweep in f64: the
# difference relative to the field's max, the bar chip_smoke.py holds too
REL_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on(p: Particles, device, dtype) -> Particles:
    return Particles(**{
        f.name: (v.to(device, dtype) if v.is_floating_point() else v.to(device))
        for f in dataclasses.fields(p) for v in (getattr(p, f.name),)})


def _sorted_state(dims, family, n, cap, seed=0):
    """A jittered lattice with random velocities and densities, fluid and
    boundary rows, inactive padding, rebuilt in f64 on the CPU."""
    rng = np.random.default_rng(seed)
    const = T.SimulationConstants(dx=DX, cfl=0.5)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * DX] * dims), indexing="ij"),
                      axis=-1).reshape(-1, dims)[:n]
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * DX
    pos -= pos.mean(axis=0)
    dens = rng.uniform(990, 1040, size=n)
    ptype = rng.choice([1, 2], size=n, p=[0.8, 0.2]).astype(np.int32)
    p = allocate_particles(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                           device="cpu", dtype=torch.float64, capacity=cap)
    vel = np.zeros((cap, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    p = p.replace(velocity=torch.as_tensor(vel),
                  pressure=eq.pressure(p.density, const))
    grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs


def _args(spec, grid, p, cs):
    return (spec, grid, p, cs, p.position, p.density, p.pressure, p.velocity)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", ["ZERO", "ARTIFICIAL"])
@pytest.mark.parametrize("diff", ["ZERO", "LINEAR"])
def test_kernel_matches_plain_sweep(cuda, dims, family, visc, diff):
    n, cap = (300, 320) if dims == 2 else (500, 530)
    const, kern, grid, p64, cs = _sorted_state(dims, family, n, cap)
    spec = PhysicsSpec(constants=const, kernel=kern,
                       viscosity=T.ViscosityModel[visc],
                       diffusion=T.DensityDiffusionModel[diff])
    ref = bs.block_sweep_plain(*_args(spec, grid, p64, cs))
    p32 = _on(p64, cuda, torch.float32)
    before = bs.launches
    out = bs.block_sweep(*_args(spec, grid, p32, cs.to(cuda)))
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    assert out.drhodt.dtype == torch.float32 and out.drhodt.device.type == cuda.type
    for a, b in ((out.drhodt, ref.drhodt), (out.acceleration, ref.acceleration)):
        a = a.double().cpu()
        assert torch.isfinite(a).all()
        assert not a[n:].any()  # padding rows stay zero
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= REL_TOL * scale


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    const, kern, grid, p64, cs = _sorted_state(3, "WENDLAND_C2", 200, 200)
    p = _on(p64, cuda, torch.float32)
    cs = cs.to(cuda)
    spec = PhysicsSpec(constants=const, kernel=kern,
                       viscosity=T.ViscosityModel.ARTIFICIAL,
                       diffusion=T.DensityDiffusionModel.LINEAR)
    before = bs.launches
    # every model set has an instance; a dimension outside (2, 3) has none
    with pytest.raises(NotImplementedError, match="dims=4"):
        bs.block_sweep(spec, grid, p, cs, torch.zeros((200, 4), device=cuda), p.density,
                       p.pressure, p.velocity)
    with pytest.raises(ValueError, match="cell_start"):
        bs.block_sweep(*_args(spec, grid, p, cs.cpu()))
    with pytest.raises(TypeError, match="int32"):
        bs.block_sweep(*_args(spec, grid, p, cs.long()))
    with pytest.raises(ValueError, match="shape"):
        bs.block_sweep(spec, grid, p, cs, p.position, p.density[:-1], p.pressure,
                       p.velocity)
    assert bs.launches == before


def test_main_path_steps_through_the_kernel(cuda):
    """20 steps of a coarse 3D dam break on the card (f32, the kernel) and on
    the CPU (f32, the plain sweep): two launches per step, and the same
    trajectory to f32 summation-order noise."""
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    const = T.SimulationConstants(dx=DX, c0=33.14, alpha=0.1, m0=1000 * DX**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * DX**2)))
    meta = T.SimulationMetaData(simulation_name="gpu_steps", save_location=".", dims=3)
    sims = [T.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const, kern,
                                  T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device=d)
            for d in (cuda, "cpu")]
    before = bs.launches
    gpu, cpu = (make_fixed_steps_fn(s.cfg, 20)(s.state) for s in sims)
    torch.cuda.synchronize()
    assert bs.launches == before + 40
    assert gpu.rebuilds == cpu.rebuilds
    assert float(gpu.total_time) == pytest.approx(float(cpu.total_time), rel=1e-5)

    def by_id(state, field):
        p = state.particles
        return getattr(p, field).cpu()[torch.argsort(p.id.cpu())][p.id.cpu().sort()[0] > 0]

    # bands an order of magnitude above what f32 rounding does to 20 steps
    # of this case (positions ~1 m, velocities ~0.1 m/s, densities ~1000)
    torch.testing.assert_close(by_id(gpu, "position"), by_id(cpu, "position"),
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(by_id(gpu, "velocity"), by_id(cpu, "velocity"),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(by_id(gpu, "density"), by_id(cpu, "density"),
                               rtol=5e-6, atol=0)
    assert torch.isfinite(by_id(gpu, "velocity")).all()


# --- the mDBC moment kernel ------------------------------------------------

def _ghost_state(dims, family, crowded=None, seed=7, n_b=90, n_f=240):
    """Boundary rows with ghost points and fluid rows, inactive padding,
    rebuilt in f64 on the CPU.  ``crowded``: ``n_b`` ghosts in one cell and
    ``n_f`` fluid rows in its x-row; "edge" pins that cell at the grid's
    corner and puts a third of the ghost points outside the grid (clamped);
    "blob" puts the ghosts within 0.1 H of each other."""
    rng = np.random.default_rng(seed)
    const = T.SimulationConstants(dx=DX)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    grid = None
    if crowded is None:
        n_b, n_f = 60, 400
        pos_b = rng.uniform(-0.15, 0.0, size=(n_b, dims))
        pos_f = rng.uniform(0.0, 0.4, size=(n_f, dims))
        gpts = pos_b + np.array([0.1] + [0.0] * (dims - 1))
    else:
        pitch = kern.H
        center = (np.zeros(dims) if crowded == "edge" else np.full(dims, 3.0)) * pitch
        spread = 0.1 if crowded == "blob" else 0.45
        gpts = center + rng.uniform(-spread, spread, size=(n_b, dims)) * pitch
        if crowded == "edge":
            gpts[:30, 0] -= 0.6 * pitch
            grid = cl.Grid(cmin=(0,) * dims, shape=(16,) * dims)
        pos_b = rng.uniform(0, 0.4, size=(n_b, dims)) + np.array(
            [12 * pitch] + [0.0] * (dims - 1))
        pos_f = center + rng.uniform(-0.49, 0.49, size=(n_f, dims)) * pitch
        pos_f[:, 0] = center[0] + rng.uniform(-1.45, 1.45, size=n_f) * pitch
    pos = np.concatenate([pos_b, pos_f])
    n = n_b + n_f
    cap = n + 37
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(995, 1040, size=n), ptype,
                           np.ones(n, np.int32), np.arange(1, n + 1),
                           device="cpu", dtype=torch.float64, capacity=cap)
    ghost = np.zeros((cap, dims))
    ghost[:n_b] = gpts
    p = p.replace(ghost_points=torch.as_tensor(ghost))
    grid = grid or cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                       diffusion=T.DensityDiffusionModel.ZERO)
    return spec, grid, sp, cs, n_b


def _moment_args(spec, grid, p, cs, cap, n_valid):
    """The wrapper's arguments for ``cap`` ghost slots, those from
    ``n_valid`` on marked invalid (they still carry a ghost point)."""
    bidx, bvalid = mdbc.compact_ghosts(p, cap)
    bvalid = bvalid.clone()
    bvalid[n_valid:] = False
    return (spec, grid, p.ghost_points[bidx], bvalid, p.position, p.density,
            p.motion_limiter, cs)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("crowded", [None, "interior", "edge"])
def test_mdbc_kernel_matches_plain_moments(cuda, dims, family, crowded):
    spec, grid, p64, cs, n_b = _ghost_state(dims, family, crowded)
    cap = n_b + 5                       # 5 invalid slots: zeros out
    bref, Aref = mm.mdbc_moments_plain(*_moment_args(spec, grid, p64, cs, cap, n_b))
    p32 = _on(p64, cuda, torch.float32)
    before = mm.launches
    bk, Ak = mm.mdbc_moments(*_moment_args(spec, grid, p32, cs.to(cuda), cap, n_b))
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    assert bk.dtype == torch.float32 and bk.device.type == cuda.type
    assert bk.shape == (cap, dims + 1) and Ak.shape == (cap, dims + 1, dims + 1)
    assert not bk[n_b:].any() and not Ak[n_b:].any()   # invalid slots: zeros
    for a, b in ((bk, bref), (Ak, Aref)):
        a = a.double().cpu().reshape(cap, -1)
        b = b.reshape(cap, -1)
        assert torch.isfinite(a).all()
        scale = b.abs().amax(dim=0)     # per moment column
        assert (scale > 0).all()
        assert ((a - b).abs().amax(dim=0) <= REL_TOL * scale).all()
    # and the corrected densities: f32 sums through the solve
    # (tests/test_mdbc.py:68-70 allows the f32 moment kernel 3e-5)
    ref = mdbc.mdbc_density_correction(spec, grid, p64, cs, cap)
    out = mdbc.mdbc_density_correction(spec, grid, p32, cs.to(cuda), cap)
    assert mm.launches == before + 2
    det, _ = mdbc._det_solve(Aref, bref)
    far = (det.abs() - mdbc.DET_THRESHOLD).abs() > 0.05 * mdbc.DET_THRESHOLD
    rows = mdbc.compact_ghosts(p64, cap)[0][:n_b][far[:n_b]]
    torch.testing.assert_close(out.double().cpu()[rows], ref[rows], rtol=1e-4, atol=0)
    fluid = p64.ptype == 1
    assert torch.equal(out.cpu()[fluid], p32.density.cpu()[fluid])


def test_mdbc_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spec, grid, p64, cs, n_b = _ghost_state(3, "WENDLAND_C2")
    p = _on(p64, cuda, torch.float32)
    args = _moment_args(spec, grid, p, cs.to(cuda), n_b, n_b)
    before = mm.launches
    # a kernel family the CUDA source has no instance of (the enum has none
    # today, so a stand-in member): it raises, it does not fall back
    gaussian = enum.Enum("OtherFamily", {"GAUSSIAN": "gaussian"}).GAUSSIAN
    other = dataclasses.replace(
        spec, kernel=dataclasses.replace(spec.kernel, family=gaussian))
    with pytest.raises(NotImplementedError, match="GAUSSIAN"):
        mm.mdbc_moments(other, *args[1:])
    with pytest.raises(ValueError, match="cell_start"):
        mm.mdbc_moments(*args[:-1], cs)             # on the CPU
    with pytest.raises(TypeError, match="int32"):
        mm.mdbc_moments(*args[:-1], cs.to(cuda).long())
    with pytest.raises(ValueError, match="shape"):
        mm.mdbc_moments(*args[:5], p.density[:-1], *args[6:])
    assert mm.launches == before
    # no ghost slot at all: nothing to launch, empty moments
    b0, A0 = mm.mdbc_moments(spec, grid, args[2][:0], args[3][:0], *args[4:])
    assert b0.shape == (0, 4) and A0.shape == (0, 4, 4) and mm.launches == before


def test_mdbc_steps_through_both_kernels(cuda):
    """10 steps of a small mDBC floor-and-block case on the card (f32, the
    kernels) and on the CPU (f32, the plain versions): one mDBC launch and two
    sweep launches per step, and the same trajectory to f32 noise."""
    const = T.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3, m0=1000 * 0.02**3)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, dx=const.dx)
    dx = const.dx
    xs, ys, zs = np.meshgrid(np.arange(8), np.arange(8), np.arange(8), indexing="ij")
    fluid = np.stack([xs.ravel(), ys.ravel(), zs.ravel() + 1.0], axis=-1) * dx
    fx, fy = np.meshgrid(np.arange(-3, 11), np.arange(-3, 11), indexing="ij")
    floor = np.stack([fx.ravel() * dx, fy.ravel() * dx, np.zeros(fx.size)], axis=-1)
    pos = np.concatenate([floor, fluid]) + 0.0037
    nb, n = len(floor), len(floor) + len(fluid)
    ptype = np.concatenate([np.full(nb, 2), np.full(n - nb, 1)]).astype(np.int32)
    ghost = floor + 0.0037 + np.array([0.0, 0.0, dx])
    meta = T.SimulationMetaData(simulation_name="gpu_mdbc", save_location=".", dims=3,
                                mdbc=T.MDBCMode.SIMPLE, grid_margin_cells=4)
    sims = [T.assemble_simulation(pos, np.full(n, 1000.0), ptype, np.ones(n, np.int32),
                                  np.arange(1, n + 1), meta, const, kern,
                                  T.ViscosityModel.ARTIFICIAL,
                                  T.DensityDiffusionModel.LINEAR, device=d,
                                  ghost_points=ghost, ghost_normals=ghost - pos[:nb])
            for d in (cuda, "cpu")]
    b0, m0 = bs.launches, mm.launches
    gpu, cpu = (make_fixed_steps_fn(s.cfg, 10)(s.state) for s in sims)
    torch.cuda.synchronize()
    assert bs.launches == b0 + 20 and mm.launches == m0 + 10
    ids_g, ids_c = gpu.particles.id.cpu(), cpu.particles.id
    assert torch.equal(ids_g, ids_c)
    dg, dc = gpu.particles.density.cpu(), cpu.particles.density
    assert float((dc[ids_c <= nb] - 1000.0).abs().max()) > 1e-3   # mDBC fired
    torch.testing.assert_close(dg, dc, rtol=2e-5, atol=0)
    torch.testing.assert_close(gpu.particles.position.cpu(), cpu.particles.position,
                               rtol=0, atol=2e-6)


# --- the fused stage 04: grouping, moments, solve and decision tree in one call -----

RHO_TOL = 1e-4       # corrected densities, f32 kernel vs f64 plain (chip_smoke.py)
NEAR_DET = 0.05      # |det| within this share of the threshold: may flip


def _fused_vs(cuda, spec, grid, p64, cs, cap, dtype=torch.float32):
    """The fused kernel on the ``dtype`` copy of the state against (a) the
    unfused path on the card - the same kernel's moments mode, then
    ``_mdbc_apply`` - bit for bit, and (b) the plain f64 path within RHO_TOL
    away from the |det| threshold.  Returns (fused density, decision, the
    compacted list)."""
    p = _on(p64, cuda, dtype)
    csg = cs.to(cuda)
    bidx, bvalid = mdbc.compact_ghosts(p, cap)
    before, groups0 = mm.launches, mm.group_launches
    rho, dec, mom = mm.mdbc_correct(spec, grid, p, bidx, bvalid, p.position, p.density,
                                    p.motion_limiter, csg, moments=True)
    torch.cuda.synchronize()
    assert mm.launches == before + 1 and mm.group_launches == groups0 + 4
    assert rho.dtype == dtype and rho.data_ptr() != p.density.data_ptr()
    gp = p.ghost_points[bidx]
    bk, Ak = mm.mdbc_moments(spec, grid, gp, bvalid, p.position, p.density, p.motion_limiter,
                             csg)
    rho_u, dec_u = mdbc._mdbc_apply(spec, p, bidx, bvalid, gp, bk, Ak)
    fill = (torch.arange(cap, device=cuda) > 0) & (bidx == 0)
    live = bvalid & ~fill
    mu = torch.cat([bk, Ak.reshape(cap, -1)], 1).float()
    assert torch.equal(mom[live], mu[live]) and not mom[~live].any()
    assert torch.equal(rho, rho_u), float((rho - rho_u).abs().max())
    assert torch.equal(dec[live], dec_u[live]) and not dec[~live].any()
    # against the plain version in f64
    bidx64, bvalid64 = mdbc.compact_ghosts(p64, cap)
    ref, dec_p = mdbc.correct_density(spec, grid, p64, bidx64, bvalid64, p64.position,
                                      p64.density, p64.motion_limiter, cs)
    bref, Aref = mm.mdbc_moments_plain(spec, grid, p64.ghost_points[bidx64], bvalid64,
                                       p64.position, p64.density, p64.motion_limiter, cs)
    det, _ = mdbc._det_solve(Aref, bref)
    far = ((det.abs() - mdbc.DET_THRESHOLD).abs() > NEAR_DET * mdbc.DET_THRESHOLD) & live.cpu()
    rows = bidx64[far]
    torch.testing.assert_close(rho.double().cpu()[rows], ref[rows], rtol=RHO_TOL, atol=0)
    assert torch.equal(dec.cpu()[far], dec_p[far])
    fluid = p64.ptype == 1
    assert torch.equal(rho.cpu()[fluid], p.density.cpu()[fluid])
    return rho, dec, bidx


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("crowded", [None, "interior", "edge", "blob"])
def test_fused_kernel_matches_plain_and_unfused(cuda, dims, family, crowded):
    """All four instances on the sparse, crowded, edge-clamped and blob
    states, with fill slots past the ghosts."""
    spec, grid, p64, cs, n_b = _ghost_state(dims, family, crowded)
    _fused_vs(cuda, spec, grid, p64, cs, n_b + 11)


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_on_an_f64_state(cuda, dims):
    """The epilogue in f64 from the f32 moments: bit for bit the unfused
    path on the card."""
    spec, grid, p64, cs, n_b = _ghost_state(dims, "WENDLAND_C2", "interior")
    _fused_vs(cuda, spec, grid, p64, cs, n_b + 3, dtype=torch.float64)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_written_out_gradient_term_is_torch_sum_on_the_card(cuda, dims, dtype):
    """``_mdbc_apply`` (and the fused kernel) add sol[1:] . diff left to
    right, written out; on the card that is bit for bit
    ``torch.sum(sol[..., 1:] * diff, -1)`` with ``sol`` as ``_det_solve``
    lays it out: on random systems, and through ``_mdbc_apply`` on the
    solved rows of a crowded state."""
    g = torch.Generator().manual_seed(11)
    n, B = dims + 1, 100_000
    A = torch.randn(B, n, n, generator=g, dtype=torch.float64).to(cuda, dtype)
    b = torch.randn(B, n, generator=g, dtype=torch.float64).to(cuda, dtype)
    rows = torch.randn(2 * B, dims, generator=g, dtype=torch.float64).to(cuda, dtype)
    idx = torch.randint(0, 2 * B, (B,), generator=g).to(cuda)
    gpoint = torch.randn(B, dims, generator=g, dtype=torch.float64).to(cuda, dtype)
    _, sol = mdbc._det_solve(A, b)
    diff = rows[idx] - gpoint
    written = sol[..., 1] * diff[..., 0]
    for d in range(1, dims):
        written = written + sol[..., 1 + d] * diff[..., d]
    assert torch.equal(written, torch.sum(sol[..., 1:] * diff, dim=-1))

    spec, grid, p64, cs, n_b = _ghost_state(dims, "WENDLAND_C2", "interior")
    p = _on(p64, cuda, dtype)
    bidx, bvalid = mdbc.compact_ghosts(p, n_b)
    gp = p.ghost_points[bidx]
    bk, Ak = mm.mdbc_moments(spec, grid, gp, bvalid, p.position, p.density, p.motion_limiter,
                             cs.to(cuda))
    bk, Ak = bk.to(dtype), Ak.to(dtype)
    rho, dec = mdbc._mdbc_apply(spec, p, bidx, bvalid, gp, bk, Ak)
    _, sol = mdbc._det_solve(Ak, bk)
    summed = sol[..., 0] + torch.sum(sol[..., 1:] * (p.position[bidx] - gp), dim=-1)
    solved = (dec == 2) & bvalid
    assert int(solved.sum()) > n_b // 2
    assert torch.equal(rho[bidx][solved], summed[solved])


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_cells_of_more_ghosts_than_a_block_takes(cuda, dims):
    """700 ghosts in one cell: 22 work entries of at most 32 ghosts, each
    staging the same stencil; the device's counters equal the mirror's."""
    spec, grid, p64, cs, n_b = _ghost_state(dims, "WENDLAND_C2", "interior", n_b=700)
    cap = n_b + 5
    _fused_vs(cuda, spec, grid, p64, cs, cap)
    p = _on(p64, cuda, torch.float32)
    bidx, bvalid = mdbc.compact_ghosts(p, cap)
    groups = mm.ghost_groups(spec, grid, p.ghost_points[bidx], bvalid, bidx=bidx,
                             cell_start=cs.to(cuda), motion_limiter=p.motion_limiter)
    assert int(groups["counts"].max()) > 10 * mm.CHUNK
    dec = torch.empty(cap, dtype=torch.int8, device=cuda)
    scratch = mm._launch(spec, grid, cap, p.ghost_points.contiguous(), bidx, bvalid,
                         p.position, p.density, p.motion_limiter, cs.to(cuda),
                         own=(p.position, p.density, p.density.clone()), decision=dec)
    entries, _, slots, parked, cells, dry = scratch[:6].tolist()
    assert entries == groups["entries"].numel() and cells == groups["cells"].numel()
    assert parked == int(groups["parked"].sum()) and slots == int(groups["counts"].sum())
    assert dry == int(groups["dry"].sum())


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_stencil_wider_than_the_stage(cuda, dims):
    """A ghost cell whose stencil holds more rows than the kernel stages:
    the rest are read from device memory, in the same order."""
    spec, grid, p64, cs, n_b = _ghost_state(dims, "WENDLAND_C2", "interior", n_b=40,
                                            n_f=mm.STAGE_ROWS + 600)
    first = mdbc.compact_ghosts(p64, 1)[0]
    starts, ends = cl.row_segments(cl.clamp_coords(cl.cell_coords(
        p64.ghost_points[first], spec.kernel.H_inv), grid), grid, cs)
    assert int((ends - starts).sum()) > mm.STAGE_ROWS
    _fused_vs(cuda, spec, grid, p64, cs, n_b + 2)


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_empty_stencil_and_lone_ghosts(cuda, dims):
    """One ghost per cell (entries that read device memory directly) and a
    ghost whose stencil is empty: zero moments, the density kept."""
    rng = np.random.default_rng(5)
    const = T.SimulationConstants(dx=DX)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    n_b, n_f = 12, 300
    pos_b = rng.uniform(-0.15, 0.0, size=(n_b, dims))
    gpts = (np.arange(n_b)[:, None] * np.eye(dims)[0] * 1.5 + 0.5) * kern.H
    gpts[-1] = 40 * kern.H
    pos = np.concatenate([pos_b, rng.uniform(0.0, 0.4 * n_b * kern.H, size=(n_f, dims))])
    n = n_b + n_f
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(995, 1040, size=n), ptype, np.ones(n, np.int32),
                           np.arange(1, n + 1), device="cpu", dtype=torch.float64,
                           capacity=n + 3)
    ghost = np.zeros((n + 3, dims))
    ghost[:n_b] = gpts
    p = p.replace(ghost_points=torch.as_tensor(ghost))
    grid = cl.grid_from_positions(np.concatenate([pos, gpts]), kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                       diffusion=T.DensityDiffusionModel.ZERO)
    rho, dec, bidx = _fused_vs(cuda, spec, grid, sp, cs, n_b + 2)
    far = int(torch.nonzero(sp.id == n_b)[0])              # the last ghost's row
    slot = int(torch.nonzero(bidx.cpu() == far)[0])
    assert int(dec[slot]) == 0 and float(rho[far]) == float(sp.density[far].float())
    groups = mm.ghost_groups(spec, grid, sp.ghost_points[bidx.cpu()],
                             mdbc.compact_ghosts(sp, n_b + 2)[1], bidx=bidx.cpu(),
                             cell_start=cs)
    assert int(groups["counts"].max()) == 1 and int(groups["rows"].min()) == 0


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_dry_stencils(cuda, dims):
    """Ghosts among wall rows only - entries whose staged stencil holds no
    fluid row skip the walk - and one of NaN density: zero moments, the
    density kept, the NaN scrubbed to rho0, the unfused path's bits."""
    rng = np.random.default_rng(3)
    const = T.SimulationConstants(dx=DX)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    n_b, n_f = 200, 100
    pos_b = rng.uniform(0.0, 0.5, size=(n_b, dims))
    pos = np.concatenate([pos_b, rng.uniform(2.0, 2.4, size=(n_f, dims))])
    n = n_b + n_f
    dens = rng.uniform(995, 1040, size=n)
    dens[3] = np.nan
    ptype = np.concatenate([np.full(n_b, 2), np.full(n_f, 1)]).astype(np.int32)
    p = allocate_particles(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                           device="cpu", dtype=torch.float64, capacity=n + 5)
    ghost = np.zeros((n + 5, dims))
    ghost[:n_b] = pos_b[:, ::-1] * 0.8 + 0.05
    p = p.replace(ghost_points=torch.as_tensor(ghost))
    grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                       diffusion=T.DensityDiffusionModel.ZERO)
    rho, dec, bidx = _fused_vs(cuda, spec, grid, sp, cs, n_b + 3)
    assert not dec.any() and not torch.isnan(rho).any()
    nan_row = torch.isnan(sp.density)
    assert float(rho.cpu()[nan_row]) == const.rho0
    assert torch.equal(rho.cpu()[~nan_row], sp.density[~nan_row].float())


def test_fused_kernel_without_slots(cuda):
    """B = 0: nothing to launch; a fresh copy of the density comes back."""
    spec, grid, p64, cs, n_b = _ghost_state(3, "WENDLAND_C2")
    p = _on(p64, cuda, torch.float32)
    bidx, bvalid = mdbc.compact_ghosts(p, 0)
    before = mm.launches
    rho, dec, mom = mm.mdbc_correct(spec, grid, p, bidx, bvalid, p.position, p.density,
                                    p.motion_limiter, cs.to(cuda), moments=True)
    assert mm.launches == before and dec.shape == (0,) and mom.shape == (0, 20)
    assert torch.equal(rho, p.density) and rho.data_ptr() != p.density.data_ptr()
    assert torch.equal(mdbc.mdbc_density_correction(spec, grid, p, cs.to(cuda), 0), p.density)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    spec, grid, p64, cs, n_b = _ghost_state(3, "WENDLAND_C2")
    p = _on(p64, cuda, torch.float32)
    csg = cs.to(cuda)
    bidx, bvalid = mdbc.compact_ghosts(p, n_b)
    args = (p.position, p.density, p.motion_limiter, csg)
    before = mm.launches
    with pytest.raises(TypeError, match="bidx"):
        mm.mdbc_correct(spec, grid, p, bidx.int(), bvalid, *args)
    with pytest.raises(TypeError, match="float32 / float64"):
        mm.mdbc_correct(spec, grid, p.replace(density=p.density.half()), bidx, bvalid, *args)
    with pytest.raises(ValueError, match="cell_start"):
        mm.mdbc_correct(spec, grid, p, bidx, bvalid, *args[:3], cs)
    with pytest.raises(ValueError, match="gvalid"):
        mm.mdbc_correct(spec, grid, p, bidx, bvalid[:-1], *args)
    with pytest.raises(ValueError, match="unsupported device"):
        mm.mdbc_correct(spec, grid, p64, bidx.cpu(), bvalid.cpu(), p64.position, p64.density,
                        p64.motion_limiter, cs)
    assert mm.launches == before


@pytest.mark.parametrize("dims", [2, 3])
def test_fused_kernel_on_the_halo_parks_other_slabs_slots(cuda, dims):
    """Each slab compacts to the global capacity and parks the slots past its
    own ghosts; its corrected rows are the single launch's bit for bit."""
    spec, grid, p64, cs, n_b = _ghost_state(dims, "WENDLAND_C2")
    cap = p64.capacity - p64.capacity % N_SLABS
    p64 = p64.map(lambda a: a[:cap])
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    whole = mdbc.mdbc_density_correction(spec, grid, p32, cs_g, n_b)
    C = cap // N_SLABS
    dens, parked = [], 0
    for r in range(N_SLABS):
        pl, cs_e, f, _ = _window(p32, cs_g, r, (dims - 1) * C)
        bidx, bvalid = mdbc.compact_ghosts(pl, n_b)
        rho, dec, _ = mm.mdbc_correct(spec, grid, pl, bidx, bvalid, f["position"],
                                      f["density"], f["motion_limiter"], cs_e)
        groups = mm.ghost_groups(spec, grid, pl.ghost_points[bidx], bvalid, bidx=bidx)
        own = int((torch.any(pl.ghost_points != 0, dim=-1) & pl.active).sum())
        assert int(groups["parked"].sum()) == n_b - own
        assert not dec[groups["parked"]].any()
        parked += n_b - own
        dens.append(rho)
    assert parked == (N_SLABS - 1) * n_b
    assert torch.equal(torch.cat(dens), whole)


# --- the cell sweep -----------------------------------------------------------

VISC = ["ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS"]
DIFF = ["ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX"]
FIELDS = ("drhodt", "acceleration", "kernel_w", "kernel_grad", "grad_c", "div_r")


def _full_spec(const, kern, visc, diff, store=True, shift=True):
    return PhysicsSpec(
        constants=const, kernel=kern, viscosity=T.ViscosityModel[visc],
        diffusion=T.DensityDiffusionModel[diff],
        shifting=T.ShiftingMode.PLANAR if shift else T.ShiftingMode.NONE,
        kernel_output=T.KernelOutputMode.STORE if store else T.KernelOutputMode.NONE)


def _state_at(pos, family, cap, grid=None, seed=0):
    """Rows at ``pos`` with random velocities, densities and types (fluid,
    fixed, moving), inactive padding, rebuilt in f64 on the CPU."""
    rng = np.random.default_rng(seed)
    n, dims = pos.shape
    const = T.SimulationConstants(dx=DX, cfl=0.5)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    ptype = rng.choice([1, 2, 3], size=n, p=[0.7, 0.2, 0.1]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(990, 1040, size=n), ptype,
                           np.ones(n, np.int32), np.arange(1, n + 1),
                           device="cpu", dtype=torch.float64, capacity=cap)
    vel = np.zeros((cap, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    p = p.replace(velocity=torch.as_tensor(vel), pressure=eq.pressure(p.density, const))
    grid = grid or cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, occ = cl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs, int(occ)


def _hold_cell_sweep(cuda, spec, grid, p64, cs, n):
    """The kernel on the f32 copy of ``p64`` against the plain f64 sweep:
    one launch, every field of the mode set, padding rows zero."""
    ref = cw.cell_sweep_plain(*_args(spec, grid, p64, cs))
    p32 = _on(p64, cuda, torch.float32)
    before = cw.launches
    out = cw.cell_sweep(*_args(spec, grid, p32, cs.to(cuda)))
    torch.cuda.synchronize()
    assert cw.launches == before + 1
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert a.dtype == torch.float32 and a.device.type == cuda.type
        a = a.double().cpu()
        assert torch.isfinite(a).all(), f
        assert not a[n:].any(), f  # padding rows stay zero
        scale = float(b.abs().max())
        assert scale > 0, f
        assert float((a - b).abs().max()) <= REL_TOL * scale, f


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
def test_cell_kernel_matches_plain_sweep(cuda, dims, family, visc, diff):
    n, cap = (300, 320) if dims == 2 else (500, 530)
    const, kern, grid, p64, cs = _sorted_state(dims, family, n, cap)
    _hold_cell_sweep(cuda, _full_spec(const, kern, visc, diff), grid, p64, cs, n)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc", ["ARTIFICIAL", "LAMINAR_SPS"])
@pytest.mark.parametrize("store,shift", [(False, False), (True, False), (False, True)])
def test_cell_kernel_instances_without_extras(cuda, dims, visc, store, shift):
    n, cap = (300, 320) if dims == 2 else (500, 530)
    const, kern, grid, p64, cs = _sorted_state(dims, "WENDLAND_C2", n, cap)
    spec = _full_spec(const, kern, visc, "LINEAR", store, shift)
    _hold_cell_sweep(cuda, spec, grid, p64, cs, n)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
@pytest.mark.parametrize("store,shift", [(True, True), (False, False)])
def test_block_kernel_every_mode_matches_plain_and_cell_kernel(cuda, dims, family, visc,
                                                               diff, store, shift):
    """The block kernel in every model and mode against the plain f64 sweep
    (every field, padding rows zero), and against the cell kernel on the
    same f32 inputs: the two hand kernels share their pair physics and differ
    in summation order only."""
    n, cap = (300, 320) if dims == 2 else (500, 530)
    const, kern, grid, p64, cs = _sorted_state(dims, family, n, cap)
    spec = _full_spec(const, kern, visc, diff, store, shift)
    ref = bs.block_sweep_plain(*_args(spec, grid, p64, cs))
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    before = bs.launches
    out = bs.block_sweep(*_args(spec, grid, p32, cs_g))
    cell = cw.cell_sweep(*_args(spec, grid, p32, cs_g))
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    for f in FIELDS:
        a, b, c = getattr(out, f), getattr(ref, f), getattr(cell, f)
        assert (a is None) == (b is None) == (c is None), f
        if a is None:
            continue
        assert a.dtype == torch.float32 and a.device.type == cuda.type
        a, c = a.double().cpu(), c.double().cpu()
        assert torch.isfinite(a).all(), f
        assert not a[n:].any(), f  # padding rows stay zero
        scale = float(b.abs().max())
        assert scale > 0, f
        assert float((a - b).abs().max()) <= REL_TOL * scale, f
        assert float((a - c).abs().max()) <= REL_TOL * scale, f


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["crowded", "sheet", "edge"])
def test_cell_kernel_odd_cells(cuda, dims, case):
    """A cell with more selves than a block has threads (and a row longer
    than one shared-memory tile), a sheet one particle thick, and cells on
    the edge of a grid without margin (clamped stencils, rows outside the
    grid)."""
    rng = np.random.default_rng(11)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    grid = None
    if case == "crowded":
        # 150 rows inside one cell, 250 around it
        inner = (rng.uniform(-0.45, 0.45, size=(150, dims)) + 2.0) * kern.H
        outer = (rng.uniform(-1.4, 1.4, size=(250, dims)) + 2.0) * kern.H
        pos = np.concatenate([inner, outer])
    elif case == "sheet":
        pos = rng.uniform(0, 1.5, size=(300, dims))
        pos[:, -1] = 0.3 + rng.uniform(-0.01, 0.01, size=300) * DX
    else:
        pos = rng.uniform(-0.3, 0.3, size=(400, dims))
        grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=0)
        pos[:40] *= 1.5        # 40 rows outside the grid: clamped into edge cells
    n = len(pos)
    const, kern, grid, p64, cs, occ = _state_at(pos, "WENDLAND_C2", n + 23, grid)
    if case == "crowded":
        assert occ >= 150
    spec = _full_spec(const, kern, "LAMINAR_SPS", "COMPLEX")
    _hold_cell_sweep(cuda, spec, grid, p64, cs, n)


def test_cell_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    const, kern, grid, p64, cs = _sorted_state(3, "WENDLAND_C2", 200, 200)
    p = _on(p64, cuda, torch.float32)
    cs = cs.to(cuda)
    spec = _full_spec(const, kern, "LAMINAR_SPS", "COMPLEX")
    before = cw.launches
    with pytest.raises(ValueError, match="cell_start"):
        cw.cell_sweep(*_args(spec, grid, p, cs.cpu()))
    with pytest.raises(TypeError, match="int32"):
        cw.cell_sweep(*_args(spec, grid, p, cs.long()))
    with pytest.raises(ValueError, match="shape"):
        cw.cell_sweep(spec, grid, p, cs, p.position, p.density[:-1], p.pressure,
                      p.velocity)
    with pytest.raises(ValueError, match="grid"):
        cw.cell_sweep(*_args(spec, cl.Grid(cmin=(0, 0), shape=(4, 4)), p, cs))
    assert cw.launches == before
    # an unbuilt cell_start (all zeros) gives every row zero, as the plain version
    out = cw.cell_sweep(*_args(spec, grid, p, torch.zeros_like(cs)))
    assert not out.drhodt.any() and not out.kernel_w.any()


def _moving_square(device, dtype="float32", block_sweep=False):
    """A closed box of fixed walls filled with fluid around a solid square
    translating at 0.5 m/s, the MovingSquare mode set, g = 0."""
    dp = 0.02
    const = T.SimulationConstants(dx=dp, c0=28.0, delta_sph=0.1, g=0.0, Cb=112000.0,
                                  alpha=1e-6, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dp, k=float(np.sqrt(2)))
    ix, iz = np.meshgrid(np.arange(-2, 42), np.arange(-2, 32), indexing="ij")
    ix, iz = ix.ravel(), iz.ravel()
    wall = (ix < 0) | (ix >= 40) | (iz < 0) | (iz >= 30)
    square = (ix >= 8) & (ix < 14) & (iz >= 12) & (iz < 18)
    ptype = np.where(wall, 2, np.where(square, 3, 1)).astype(np.int32)
    order = np.argsort(-ptype, kind="stable")       # square, walls, fluid
    pos = (np.stack([ix, iz], axis=-1)[order] + 0.5) * dp + 0.0037
    ptype = ptype[order]
    n = len(pos)
    meta = T.SimulationMetaData("gpu_square", ".", dims=2, dtype=dtype,
                                shifting=T.ShiftingMode.PLANAR,
                                kernel_output=T.KernelOutputMode.STORE,
                                block_sweep=block_sweep, grid_margin_cells=4)
    geoms = (T.Geometry("", 3, T.ParticleType.MOVING,
                        T.MotionDetails(0.5, 0.0, 10.0, (1.0, 0.0))),)
    sim = T.assemble_simulation(pos, np.full(n, 1000.0), ptype, ptype.copy(),
                                np.arange(1, n + 1), meta, const, kern,
                                T.ViscosityModel.LAMINAR_SPS,
                                T.DensityDiffusionModel.LINEAR, geometries=geoms,
                                device=device)
    return sim, pos, ptype


def test_moving_square_steps_through_the_cell_kernel(cuda):
    """10 steps of a small moving-square box on the card (f32, the kernel) and
    on the CPU (f32, the plain sweep): two cell-sweep launches per step, no
    block-sweep launch, the square on its track, the same trajectory to f32
    noise."""
    (sim_g, pos0, ptype), (sim_c, _, _) = _moving_square(cuda), _moving_square("cpu")
    assert sim_g.cfg.sweep_kernel == "cell"
    b0, c0 = bs.launches, cw.launches
    gpu, cpu = (make_fixed_steps_fn(s.cfg, 10)(s.state) for s in (sim_g, sim_c))
    torch.cuda.synchronize()
    assert cw.launches == c0 + 20 and bs.launches == b0
    assert torch.equal(gpu.particles.id.cpu(), cpu.particles.id)
    order = torch.argsort(gpu.particles.id.cpu())
    pg = gpu.particles.position.cpu()[order]
    sq = ptype == 3
    x_track = pos0[sq, 0] + 0.5 * float(gpu.total_time)
    assert np.abs(pg.numpy()[sq, 0] - x_track).max() < 1e-6
    assert torch.equal(pg[torch.as_tensor(ptype == 2)], torch.as_tensor(pos0[ptype == 2],
                                                       dtype=torch.float32))
    torch.testing.assert_close(gpu.particles.position.cpu(), cpu.particles.position,
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(gpu.particles.density.cpu(), cpu.particles.density,
                               rtol=5e-6, atol=0)
    # with k = sqrt 2 the kernel is cut at q = sqrt 2, where W is not yet
    # zero, and lattice neighbours at 2 dp sit exactly on that rim: f32 noise
    # in the positions flips a few of them in or out.  Such a row is off by
    # one or two rim values; every other row agrees to f32 rounding.
    kern = sim_g.cfg.spec.kernel
    w_rim = kern.alpha_d * (1 - 0.5 * np.sqrt(2)) ** 4 * (2 * np.sqrt(2) + 1)
    dw = (gpu.particles.kernel_w.cpu() - cpu.particles.kernel_w).abs()
    off = dw > 1e-5 * cpu.particles.kernel_w.abs()
    assert int(off.sum()) <= 0.02 * off.numel()
    assert float(dw.max()) <= 2.02 * w_rim
    assert float(gpu.particles.kernel_w[gpu.particles.ptype == 1].min()) > 0


def test_moving_square_steps_through_the_block_kernel(cuda):
    """The same box with the deck's default ``block_sweep=True``: 10 steps
    through the block kernel's 2D all-extras instance, two block-sweep
    launches per step and none of the cell sweep, the square on its track,
    and the trajectory of the cell-kernel run to f32 noise."""
    (sim_b, pos0, ptype), (sim_c, _, _) = (_moving_square(cuda, block_sweep=True),
                                           _moving_square(cuda))
    assert (sim_b.cfg.sweep_kernel, sim_c.cfg.sweep_kernel) == ("block", "cell")
    assert bs.kernel_variant(sim_b.cfg.spec, 2) == 23
    b0, c0 = bs.launches, cw.launches
    blk = make_fixed_steps_fn(sim_b.cfg, 10)(sim_b.state)
    torch.cuda.synchronize()
    assert (bs.launches - b0, cw.launches - c0) == (20, 0)
    cel = make_fixed_steps_fn(sim_c.cfg, 10)(sim_c.state)
    assert torch.equal(blk.particles.id, cel.particles.id)
    order = torch.argsort(blk.particles.id.cpu())
    sq = ptype == 3
    x_track = pos0[sq, 0] + 0.5 * float(blk.total_time)
    assert np.abs(blk.particles.position.cpu()[order].numpy()[sq, 0] - x_track).max() < 1e-6
    torch.testing.assert_close(blk.particles.position, cel.particles.position,
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(blk.particles.density, cel.particles.density,
                               rtol=5e-6, atol=0)
    assert float(blk.particles.kernel_w[blk.particles.ptype == 1].min()) > 0


def test_block_rule_takes_the_cell_kernel_when_asked(cuda):
    """``block_sweep=False`` on the main path's model set: the same 5 steps
    through either kernel, to f32 summation-order noise."""
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    const = T.SimulationConstants(dx=DX, c0=33.14, alpha=0.1, m0=1000 * DX**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * DX**2)))
    ends = {}
    for flag in (True, False):
        meta = T.SimulationMetaData("gpu_rule", ".", dims=3, block_sweep=flag)
        sim = T.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const,
                                    kern, T.ViscosityModel.ARTIFICIAL,
                                    T.DensityDiffusionModel.LINEAR, device=cuda)
        assert sim.cfg.sweep_kernel == ("block" if flag else "cell")
        b0, c0 = bs.launches, cw.launches
        ends[flag] = make_fixed_steps_fn(sim.cfg, 5)(sim.state)
        assert (bs.launches - b0, cw.launches - c0) == ((10, 0) if flag else (0, 10))
    a, b = ends[True].particles, ends[False].particles
    assert torch.equal(a.id, b.id)
    torch.testing.assert_close(a.position, b.position, rtol=0, atol=2e-6)
    torch.testing.assert_close(a.density, b.density, rtol=5e-6, atol=0)
    # any model set takes the block sweep by the rule: LAMINAR runs through it
    meta = T.SimulationMetaData("gpu_rule", ".", dims=3)
    sim = T.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const, kern,
                                T.ViscosityModel.LAMINAR,
                                T.DensityDiffusionModel.LINEAR, device=cuda)
    assert sim.cfg.sweep_kernel == "block"
    b0, c0 = bs.launches, cw.launches
    end = make_fixed_steps_fn(sim.cfg, 1)(sim.state)
    assert (bs.launches - b0, cw.launches - c0) == (2, 0)
    assert torch.isfinite(end.particles.acceleration).all()


# --- the sharded path: the kernels on halo-extended windows ----------------------

N_SLABS = 3


def _window(p, cs, r, halo, n_slabs=N_SLABS):
    """Slab r's window of the sorted state (p, cs), built by slicing: (slab
    particles, rebased cell_start, extended fields, self_off).  ``halo = 0``:
    the whole array.  Rows past the global ends are zeros."""
    N = p.capacity
    C = N // n_slabs
    base = r * C
    lo, hi, self_off = (0, N, base) if halo == 0 else (base - halo, base + C + halo, halo)

    def ext(a):
        zl = a.new_zeros((max(0, -lo),) + tuple(a.shape[1:]))
        zr = a.new_zeros((max(0, hi - N),) + tuple(a.shape[1:]))
        return torch.cat([zl, a[max(lo, 0):min(hi, N)], zr])

    f = {k: ext(getattr(p, k)) for k in
         ("position", "density", "pressure", "velocity", "motion_limiter")}
    return p.map(lambda a: a[base:base + C]), halo_mod.rebase(cs, lo, hi - lo), f, self_off


def _straddles(cs, base):
    """Whether a cell's rows lie on both sides of sorted row ``base``."""
    inner = cs[(cs > 0) & (cs < cs[-1])]
    return bool(base > 0 and not (inner == base).any())


def _hold_window(cuda, mod, spec, grid, p64, cs, n, halos):
    """The windowed kernel of ``mod`` on the f32 copy of every slab's window
    against the plain f64 sweep on the same window; the slabs' outputs
    concatenated against the single-device kernel, bit for bit."""
    window, plain, single = ((bs.block_sweep_window, bs.block_sweep_plain, bs.block_sweep)
                             if mod is bs else
                             (cw.cell_sweep_window, cw.cell_sweep_plain, cw.cell_sweep))
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    whole = single(*_args(spec, grid, p32, cs_g))
    C = p64.capacity // N_SLABS
    assert any(_straddles(cs, r * C) for r in range(1, N_SLABS))
    for halo in halos:
        outs = []
        for r in range(N_SLABS):
            pl64, cs_ext, f64, off = _window(p64, cs, r, halo)
            ref = plain(spec, grid, pl64, cs_ext, f64["position"], f64["density"],
                        f64["pressure"], f64["velocity"],
                        motion_limiter=f64["motion_limiter"], self_off=off)
            pl, cs_e, f, _ = _window(p32, cs_g, r, halo)
            before = mod.window_launches, mod.launches
            out = window(spec, grid, pl, cs_e, f["position"], f["density"], f["pressure"],
                         f["velocity"], f["motion_limiter"], off)
            torch.cuda.synchronize()
            assert (mod.window_launches, mod.launches) == (before[0] + 1, before[1])
            for name in FIELDS:
                a, b = getattr(out, name), getattr(ref, name)
                assert (a is None) == (b is None), name
                if a is None:
                    continue
                a = a.double().cpu()
                assert a.shape[0] == C and torch.isfinite(a).all(), name
                scale = float(getattr(plain(*_args(spec, grid, p64, cs)), name).abs().max())
                assert float((a - b).abs().max()) <= REL_TOL * scale, (name, r, halo)
            outs.append(out)
        for name in FIELDS:
            if getattr(whole, name) is not None:
                got = torch.cat([getattr(o, name) for o in outs])
                assert torch.equal(got, getattr(whole, name)), (name, halo)
    assert not outs[-1].drhodt[C - (p64.capacity - n):].any()   # padding rows: zero


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", ["ZERO", "ARTIFICIAL"])
@pytest.mark.parametrize("diff", ["ZERO", "LINEAR"])
def test_block_window_kernel_matches_plain_and_single(cuda, dims, family, visc, diff):
    n, cap = (300, 321) if dims == 2 else (500, 531)
    const, kern, grid, p64, cs = _sorted_state(dims, family, n, cap)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel[visc],
                       diffusion=T.DensityDiffusionModel[diff])
    # 3D: a slab of this small cube is thinner than the stencil reach, so the
    # window takes two slabs' rows each way (zeros past the ends)
    _hold_window(cuda, bs, spec, grid, p64, cs, n,
                 halos=((dims - 1) * (cap // N_SLABS), 0))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc,diff", [("LAMINAR_SPS", "LINEAR"), ("LAMINAR", "COMPLEX"),
                                       ("ARTIFICIAL", "ZERO_GRAVITY_LINEAR")])
def test_block_window_kernel_all_extras_matches_plain_and_single(cuda, dims, visc, diff):
    """The block kernel on the halo with PLANAR and STORE on (the sharded
    moving square's instance in 2D): every slab against its plain version,
    the slabs concatenated against the single-device launch bit for bit."""
    n, cap = (300, 321) if dims == 2 else (500, 531)
    const, kern, grid, p64, cs = _sorted_state(dims, "WENDLAND_C2", n, cap)
    spec = _full_spec(const, kern, visc, diff)
    _hold_window(cuda, bs, spec, grid, p64, cs, n,
                 halos=((dims - 1) * (cap // N_SLABS), 0))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc", ["ARTIFICIAL", "LAMINAR_SPS"])
@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_cell_window_kernel_matches_plain_and_single(cuda, dims, visc, store, shift):
    n, cap = (300, 321) if dims == 2 else (500, 531)
    const, kern, grid, p64, cs = _sorted_state(dims, "WENDLAND_C2", n, cap)
    spec = _full_spec(const, kern, visc, "COMPLEX" if store else "LINEAR", store, shift)
    _hold_window(cuda, cw, spec, grid, p64, cs, n,
                 halos=((dims - 1) * (cap // N_SLABS), 0))


def test_window_cut_by_the_clamp_drops_pairs(cuda):
    """A halo thinner than the stencil reach: the rebased cell_start clamps,
    the kernel and the plain version drop the same pairs (they still agree),
    and the slabs no longer add up to the single-device sweep - what the
    ``max_halo`` guard of the driver exists for."""
    const, kern, grid, p64, cs = _sorted_state(3, "WENDLAND_C2", 500, 531)
    spec = _full_spec(const, kern, "ARTIFICIAL", "LINEAR", False, False)
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    whole = cw.cell_sweep(*_args(spec, grid, p32, cs_g))
    C = 531 // N_SLABS
    pl64, cs_ext, f64, off = _window(p64, cs, 1, 8)
    ref = cw.cell_sweep_plain(spec, grid, pl64, cs_ext, f64["position"], f64["density"],
                              f64["pressure"], f64["velocity"],
                              motion_limiter=f64["motion_limiter"], self_off=off)
    pl, cs_e, f, _ = _window(p32, cs_g, 1, 8)
    for mod, window in ((cw, cw.cell_sweep_window), (bs, bs.block_sweep_window)):
        out = window(spec, grid, pl, cs_e, f["position"], f["density"], f["pressure"],
                     f["velocity"], f["motion_limiter"], off)
        scale = float(ref.drhodt.abs().max())
        assert float((out.drhodt.double().cpu() - ref.drhodt).abs().max()) <= REL_TOL * scale
        assert not torch.equal(out.drhodt, whole.drhodt[C:2 * C])


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
def test_mdbc_kernel_on_the_halo_matches_plain_and_single(cuda, dims, family):
    spec, grid, p64, cs, n_b = _ghost_state(dims, family)
    cap = p64.capacity - p64.capacity % N_SLABS           # a multiple of the slabs
    p64 = p64.map(lambda a: a[:cap])                      # (drops padding rows only)
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    whole = mdbc.mdbc_density_correction(spec, grid, p32, cs_g, n_b)
    bw, Aw = mm.mdbc_moments_plain(*_moment_args(spec, grid, p64, cs, n_b, n_b))
    C = cap // N_SLABS
    dens, seen = [], 0
    for r in range(N_SLABS):
        pl64, cs_ext, f64, _ = _window(p64, cs, r, (dims - 1) * C)
        bidx, bvalid = mdbc.compact_ghosts(pl64, n_b)
        ref = mm.mdbc_moments_plain(spec, grid, pl64.ghost_points[bidx], bvalid,
                                    f64["position"], f64["density"],
                                    f64["motion_limiter"], cs_ext)
        pl, cs_e, f, _ = _window(p32, cs_g, r, (dims - 1) * C)
        bidx, bvalid = mdbc.compact_ghosts(pl, n_b)
        before = mm.launches
        bk, Ak = mm.mdbc_moments(spec, grid, pl.ghost_points[bidx], bvalid, f["position"],
                                 f["density"], f["motion_limiter"], cs_e)
        torch.cuda.synchronize()
        assert mm.launches == before + 1
        for a, b, full in ((bk, ref[0], bw), (Ak, ref[1], Aw)):
            a, b = a.double().cpu().reshape(n_b, -1), b.reshape(n_b, -1)
            scale = full.reshape(n_b, -1).abs().amax(dim=0)   # per column, all ghosts
            assert ((a - b).abs().amax(dim=0) <= REL_TOL * scale).all()
        seen += int((torch.any(pl.ghost_points != 0, dim=-1) & pl.active).sum())
        dens.append(mdbc._mdbc_apply(spec, pl, bidx, bvalid, pl.ghost_points[bidx],
                                     bk, Ak)[0])
    assert seen == n_b
    assert torch.equal(torch.cat(dens), whole)


def test_window_wrappers_reject_what_the_kernels_do_not_take(cuda):
    const, kern, grid, p64, cs = _sorted_state(3, "WENDLAND_C2", 200, 201)
    spec = _full_spec(const, kern, "ARTIFICIAL", "LINEAR", False, False)
    p, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    pl, cs_e, f, off = _window(p, cs_g, 1, 20)
    args = (spec, grid, pl, cs_e, f["position"], f["density"], f["pressure"], f["velocity"])
    for mod, window in ((bs, bs.block_sweep_window), (cw, cw.cell_sweep_window)):
        before = mod.window_launches
        with pytest.raises(ValueError, match="cell_start"):
            window(spec, grid, pl, cs_e.cpu(), *args[4:], f["motion_limiter"], off)
        with pytest.raises(ValueError, match="motion_limiter"):
            window(*args, pl.motion_limiter, off)         # the slab's, not the window's
        with pytest.raises(ValueError, match="motion_limiter"):
            window(*args, f["motion_limiter"].cpu(), off)
        with pytest.raises(ValueError, match="outside"):
            window(*args, f["motion_limiter"], f["position"].shape[0] - 3)
        with pytest.raises(ValueError, match="outside"):
            window(*args, f["motion_limiter"], -1)
        with pytest.raises(TypeError, match="int32"):
            window(spec, grid, pl, cs_e.long(), *args[4:], f["motion_limiter"], off)
        assert mod.window_launches == before
        # the single-device entry takes no window
        with pytest.raises(ValueError, match="shape"):
            (bs.block_sweep if mod is bs else cw.cell_sweep)(*args)
    with pytest.raises(ValueError, match="exceeds"):
        halo_mod.extend(SINGLE, pl.position, pl.capacity + 1)


def _tall_column(device, mdbc_on, block=True, margin=4):
    """A tall 2D water column between walls (f32): thin in x, long in z, so
    that 4 slabs of the sorted order are thicker than one stencil reach;
    ``margin`` cells of grid around it."""
    const = T.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    dx, nx, nz = const.dx, 6, 220
    xs, zs = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    fluid = np.stack([xs.ravel() * dx, zs.ravel() * dx + dx], axis=-1)
    fx = np.arange(-3, nx + 3) * dx
    floor = np.stack([fx, np.zeros_like(fx)], axis=-1)
    wz = np.arange(0, nz + 6) * dx
    lw = np.stack([np.full_like(wz, -dx), wz], axis=-1)
    rw = np.stack([np.full_like(wz, nx * dx), wz], axis=-1)
    bound = np.concatenate([floor, lw, rw])
    pos = np.concatenate([bound, fluid]) + 0.0037
    nb, n = len(bound), len(bound) + len(fluid)
    ptype = np.concatenate([np.full(nb, 2), np.full(n - nb, 1)]).astype(np.int32)
    gn = np.concatenate([np.tile([[0.0, dx]], (len(floor), 1)),
                         np.tile([[dx, 0.0]], (len(lw), 1)),
                         np.tile([[-dx, 0.0]], (len(rw), 1))])
    meta = T.SimulationMetaData("gpu_column", ".", dims=2, block_size=32,
                                grid_margin_cells=margin, block_sweep=block,
                                mdbc=T.MDBCMode.SIMPLE if mdbc_on else T.MDBCMode.NONE)
    return T.assemble_simulation(
        pos, np.full(n, 1000.0), ptype, np.ones(n, np.int32), np.arange(1, n + 1), meta,
        const, kern, T.ViscosityModel.ARTIFICIAL, T.DensityDiffusionModel.LINEAR,
        ghost_points=(bound + 0.0037 + gn) if mdbc_on else None,
        ghost_normals=gn if mdbc_on else None, device=device)


@pytest.mark.parametrize("mdbc_on,block", [(False, True), (True, True), (False, False)])
def test_four_slab_run_on_the_card(cuda, mdbc_on, block):
    """12 steps of the tall column on 4 slabs (thread ranks on the cards
    visible) and on one device: two windowed sweep launches per step per
    slab, one mDBC launch, no single-device entry, ``0 < max_halo <= halo``,
    and - each slab's rows being the single-device kernel's bit for bit - the
    same end state bit for bit."""
    steps = 12
    single = _tall_column(cuda, mdbc_on, block)
    sharded = shard_simulation(_tall_column(cuda, mdbc_on, block), make_mesh(4))
    cfg = sharded.cfg
    assert cfg.halo > 0 and cfg.sweep_kernel == ("block" if block else "cell")
    assert [d.index for d in sharded.mesh.devices] == [
        r % torch.cuda.device_count() for r in range(4)]
    one = make_fixed_steps_fn(single.cfg, steps)(single.state)
    mod, other = (bs, cw) if block else (cw, bs)
    w0, s0, o0, m0 = mod.window_launches, mod.launches, other.window_launches, mm.launches
    states = make_sharded_fixed_steps_fn(cfg, sharded.mesh, steps)(sharded.state)
    torch.cuda.synchronize()
    assert mod.window_launches == w0 + 2 * steps * 4
    assert mod.launches == s0 and other.window_launches == o0
    assert mm.launches == m0 + (steps * 4 if mdbc_on else 0)
    assert len({int(s.rebuilds) for s in states}) == 1 and states[0].rebuilds == one.rebuilds
    four = gather_state(states, cuda)
    assert 0 < int(four.max_halo) <= cfg.halo
    assert float(four.total_time) == float(one.total_time)

    def by_id(state, field):
        p = state.particles
        order = torch.argsort(p.id)
        return getattr(p, field)[order][p.id[order] > 0]

    for field in ("position", "velocity", "density", "pressure", "acceleration"):
        assert torch.equal(by_id(four, field), by_id(one, field)), field
    if mdbc_on:
        walls = by_id(four, "ptype") == 2
        assert float((by_id(four, "density")[walls] - 1000.0).abs().max()) > 1e-3


# --- the shared walk of both sweeps (csrc/sph_sweep_walk.cuh) ----------------------

WALK_CASES = ["crowded", "blob", "sheet", "edge", "holes"]
WALK_MODES = {"main": ("ARTIFICIAL", "LINEAR", False, False),
              "extras": ("LAMINAR_SPS", "COMPLEX", True, True)}


def _walk_state(dims, case, family="WENDLAND_C2", seed=11):
    """Cells the walk must get right: ``crowded`` (150 selves in one cell:
    more than a warp and more than a tile, a stencil row of more than two
    tiles), ``blob`` (200 rows within 0.2 H of each other: every lane accepts
    every row of a tile), ``sheet`` and ``edge`` (clamped stencils, rows
    outside the grid), ``holes`` (a lattice with every 7th row inactive in
    place, inside the warps)."""
    rng = np.random.default_rng(seed)
    kern = T.make_kernel(T.KernelFamily[family], dims, dx=DX)
    grid = None
    if case == "crowded":
        inner = (rng.uniform(-0.45, 0.45, size=(150, dims)) + 2.0) * kern.H
        outer = (rng.uniform(-1.4, 1.4, size=(250, dims)) + 2.0) * kern.H
        pos = np.concatenate([inner, outer])
    elif case == "blob":
        pos = rng.uniform(-0.2, 0.2, size=(200, dims)) * kern.H + 3.0 * kern.H
    elif case == "sheet":
        pos = rng.uniform(0, 1.5, size=(300, dims))
        pos[:, -1] = 0.3 + rng.uniform(-0.01, 0.01, size=300) * DX
    elif case == "edge":
        pos = rng.uniform(-0.3, 0.3, size=(400, dims))
        grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=0)
        pos[:40] *= 1.5
    else:
        n = 500 if dims == 3 else 300
        side = int(np.ceil(n ** (1 / dims)))
        pos = np.stack(np.meshgrid(*([np.arange(side) * DX] * dims), indexing="ij"),
                       axis=-1).reshape(-1, dims)[:n]
        pos = pos + rng.uniform(-0.4, 0.4, size=pos.shape) * DX
    n = len(pos)
    const, kern, grid, p64, cs, occ = _state_at(pos, family, n + 23, grid)
    if case == "holes":
        act = p64.active.clone()
        act[5::7] = False
        p64 = p64.replace(active=act)
    return const, kern, grid, p64, cs, occ


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("mode", list(WALK_MODES))
def test_walk_both_kernels_match_plain_and_each_other(cuda, dims, case, mode):
    """Both kernels on the walk's hard cases against the plain f64 sweep
    (below 1e-4 of each field's max) and against each other bit for bit
    (they visit every self's candidates in the same order)."""
    const, kern, grid, p64, cs, occ = _walk_state(dims, case)
    if case == "crowded":
        assert occ > bs.WALK_TILE
        sched = bs.block_schedule(grid, p64, cs)
        ub, ue, _, _ = bs._pass_rows(sched, grid, cs)
        assert int((ue - ub).max()) > 2 * bs.WALK_TILE
    spec = _full_spec(const, kern, *WALK_MODES[mode])
    ref = bs.block_sweep_plain(*_args(spec, grid, p64, cs))
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    b0, c0 = bs.launches, cw.launches
    blk = bs.block_sweep(*_args(spec, grid, p32, cs_g))
    cel = cw.cell_sweep(*_args(spec, grid, p32, cs_g))
    torch.cuda.synchronize()
    assert (bs.launches, cw.launches) == (b0 + 1, c0 + 1)
    for f in FIELDS:
        a, b, c = getattr(blk, f), getattr(ref, f), getattr(cel, f)
        assert (a is None) == (b is None) == (c is None), f
        if a is None:
            continue
        assert torch.equal(a, c), f
        a = a.double().cpu()
        assert torch.isfinite(a).all(), f
        assert not a[~p64.active].any(), f      # inactive rows: zero
        scale = float(b.abs().max())
        assert scale > 0, f
        assert float((a - b).abs().max()) <= REL_TOL * scale, f


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
def test_block_and_cell_kernels_bitwise_in_every_mode(cuda, dims, family, visc, diff):
    """All 32 mode sets (PLANAR and STORE on) on a crowded state: the block
    kernel equals the cell kernel bit for bit in every field."""
    const, kern, grid, p64, cs, _ = _walk_state(dims, "crowded", family)
    spec = _full_spec(const, kern, visc, diff)
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    blk = bs.block_sweep(*_args(spec, grid, p32, cs_g))
    cel = cw.cell_sweep(*_args(spec, grid, p32, cs_g))
    torch.cuda.synchronize()
    for f in FIELDS:
        a, c = getattr(blk, f), getattr(cel, f)
        assert (a is None) == (c is None), f
        if a is not None:
            assert torch.isfinite(a).all() and torch.equal(a, c), f


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("case", ["crowded", "holes"])
def test_walk_windows_of_both_kernels(cuda, dims, case):
    """B2 and B3s on the self windows of 3 slabs (self_off > 0, cells
    straddling the slab edges): each slab bitwise the single-device launch
    of either kernel, and the two kernels bitwise each other."""
    const, kern, grid, p64, cs, _ = _walk_state(dims, case)
    spec = _full_spec(const, kern, "LAMINAR_SPS", "LINEAR")
    p32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    whole = bs.block_sweep(*_args(spec, grid, p32, cs_g))
    C = p64.capacity // N_SLABS
    for r in range(N_SLABS):
        pl, cs_e, f, off = _window(p32, cs_g, r, 2 * C)
        assert off > 0
        args = (spec, grid, pl, cs_e, f["position"], f["density"], f["pressure"],
                f["velocity"], f["motion_limiter"], off)
        outs = (bs.block_sweep_window(*args), cw.cell_sweep_window(*args))
        torch.cuda.synchronize()
        for name in FIELDS:
            mine = getattr(whole, name)
            if mine is None:
                continue
            for o in outs:
                assert torch.equal(getattr(o, name), mine[r * C:(r + 1) * C]), (name, r)


def _both_paths_state(dims, seed=5):
    """A dense jittered lattice (about 40 rows a cell in 3D, 36 in 2D) beside
    a sparse scatter: tiles that take the walk's cooperative path and tiles
    that keep the per-lane one; a capacity of N_SLABS slabs of an odd length,
    so that slabs start off a multiple of 32 rows."""
    rng = np.random.default_rng(seed)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    a = kern.H / (3.42 if dims == 3 else 6.0)
    side = 10 if dims == 3 else 30
    lat = np.stack(np.meshgrid(*([np.arange(side) * a] * dims), indexing="ij"),
                   axis=-1).reshape(-1, dims)
    lat = lat + rng.uniform(-0.2, 0.2, size=lat.shape) * a
    span = side * a
    sparse = (rng.uniform(0, 1, size=(200, dims)) * span * 2.5
              + np.r_[span * 1.2, [0.0] * (dims - 1)])
    pos = np.concatenate([lat, sparse])
    n = len(pos)
    slab = (n + 23) // N_SLABS | 1          # odd: slab r starts at r * slab
    return _state_at(pos, "WENDLAND_C2", N_SLABS * slab) + (n,)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("mode", list(WALK_MODES))
def test_walk_paths_both_kernels_and_slabs(cuda, dims, mode):
    """Tiles on both compute paths of the walk (checked on the plain mirror:
    cooperative and per-lane tiles in both kernels' schedules, and a
    cooperative tile whose rounds the queue's size raised): B1 equals B3 bit
    for bit and both lie within REL_TOL of the plain f64 sweep; on N_SLABS
    slabs whose self rows start off a multiple of 32 (so their warps group
    the rows otherwise than the single launch does) every slab of either
    kernel is its single launch bit for bit and within REL_TOL of the plain
    sweep on its window."""
    const, kern, grid, p64, cs, _, n = _both_paths_state(dims)
    spec = _full_spec(const, kern, *WALK_MODES[mode])
    C = p64.capacity // N_SLABS
    assert C % 32 and (2 * C) % 32
    queue = bs.walk_queue(bs.n_sums(spec, dims))
    p32 = _on(p64, "cpu", torch.float32)
    for sched in (bs.block_schedule(grid, p64, cs), cw.cell_schedule(grid, cs, p64.capacity)):
        tiles = tile_pairs(sched, grid, cs, p32.position, kern.H2)
        rule = [bs.tile_rounds(t, queue) for t in tiles]
        assert any(c for _, c in rule) and not all(c for _, c in rule)
        # a cooperative tile whose rounds the queue's size raised
        assert any(c and r > -(-sum(t) // 32) for t, (r, c) in zip(tiles, rule))
    ref = bs.block_sweep_plain(*_args(spec, grid, p64, cs))
    g32, cs_g = _on(p64, cuda, torch.float32), cs.to(cuda)
    blk = bs.block_sweep(*_args(spec, grid, g32, cs_g))
    cel = cw.cell_sweep(*_args(spec, grid, g32, cs_g))
    torch.cuda.synchronize()
    for f in FIELDS:
        a, b, c = getattr(blk, f), getattr(ref, f), getattr(cel, f)
        assert (a is None) == (b is None) == (c is None), f
        if a is None:
            continue
        assert torch.equal(a, c), f
        a = a.double().cpu()
        assert torch.isfinite(a).all() and not a[~p64.active].any(), f
        assert float((a - b).abs().max()) <= REL_TOL * float(b.abs().max()), f
    for mod in (bs, cw):
        _hold_window(cuda, mod, spec, grid, p64, cs, n, halos=(2 * C, 0))


# --- the host loop on the card: re-grid and replay, checkpoints, determinism ------

def _escape_on(device):
    """tests/test_aux.py:477-541 on ``device`` in f32: a random 2D blob, one
    particle launched at 30 m/s through the grid's 2-cell margin."""
    rng = np.random.default_rng(7)
    const = T.SimulationConstants(dx=0.02, c0=40.0, cfl=0.3)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    pos = rng.uniform(0, 0.3, size=(200, 2))
    meta = T.SimulationMetaData(simulation_name="esc", save_location=".", dims=2,
                                simulation_time=0.02, output_times=0.01, block_size=64,
                                grid_margin_cells=2)
    sim = T.assemble_simulation(pos, np.full(200, const.rho0), np.ones(200, np.int32),
                                np.ones(200, np.int32), np.arange(1, 201), meta, const,
                                kern, T.ViscosityModel.ARTIFICIAL,
                                T.DensityDiffusionModel.ZERO, device=device)
    p = sim.state.particles
    vel = torch.zeros_like(p.velocity)
    vel[0, 0] = 30.0
    pos2 = p.position.clone()
    pos2[0] = torch.tensor([0.45, 0.15], dtype=pos2.dtype)
    sim.state = sim.state.replace(particles=p.replace(velocity=vel, position=pos2))
    return sim


def test_regrid_replay_on_the_card(cuda, monkeypatch):
    """An escape re-grids and replays on the card: the grid grows, the replay
    runs clean, 2 block-sweep launches per step taken (the failed attempt
    included), and the kernel agrees with its plain version on the end state
    over the grown grid."""
    from sphexample_tpu_torch.core import step

    sim = _escape_on(cuda)
    grid0 = sim.cfg.grid
    calls = []
    real = step._check_interval_progress

    def counted(t, it, t_out, it_before):
        # the steps of every chunk, the failed interval's included: under the
        # chunk graph ``sph_step`` runs only while the graph is captured
        calls.extend([1] * (it - it_before))
        return real(t, it, t_out, it_before)

    monkeypatch.setattr(step, "_check_interval_progress", counted)
    before = bs.launches
    T.run_simulation(sim, max_intervals=1)
    torch.cuda.synchronize()
    assert sim.cfg.grid.ncells > grid0.ncells and int(sim.state.grid_escapes) == 0
    assert sim.hourglass.counts["02b Retune neighbor windows"] >= 1
    assert sim.state.particles.position.device.type == "cuda"
    assert len(calls) > int(sim.state.iteration) > 0
    assert bs.launches - before == 2 * len(calls)
    p, cs = sim.state.particles, sim.state.cell_start
    spec = sim.cfg.spec
    out = bs.block_sweep(*_args(spec, sim.cfg.grid, p, cs))
    p64 = _on(p, "cpu", torch.float64)
    ref = bs.block_sweep_plain(*_args(spec, sim.cfg.grid, p64, cs.cpu()))
    for a, b in ((out.drhodt, ref.drhodt), (out.acceleration, ref.acceleration)):
        a = a.double().cpu()
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= REL_TOL * float(b.abs().max())


def test_checkpoint_round_trip_of_a_card_state(cuda, tmp_path):
    from sphexample_tpu_torch.io.checkpoint import (load_checkpoint, resume_simulation,
                                                    save_checkpoint)

    sim = _tall_column(cuda, mdbc_on=True)
    state = make_fixed_steps_fn(sim.cfg, 6)(sim.state)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, 2, grid=sim.cfg.grid)
    back, counter = load_checkpoint(path, _tall_column(cuda, mdbc_on=True).state)
    assert counter == 2 and back.rebuilds == state.rebuilds
    for f in dataclasses.fields(state.particles):
        a, b = getattr(back.particles, f.name), getattr(state.particles, f.name)
        assert a.device.type == "cuda" and torch.equal(a, b), f.name
    for name in ("cell_start", "total_time", "current_dt", "iteration", "position_half"):
        assert getattr(back, name).device.type == "cuda"
        assert torch.equal(getattr(back, name), getattr(state, name)), name
    resumed, counter = resume_simulation(_tall_column(cuda, mdbc_on=True), path)
    assert resumed.state.particles.position.device.type == "cuda"
    on_cpu, _ = load_checkpoint(path, _tall_column("cpu", mdbc_on=True).state)
    assert torch.equal(on_cpu.particles.density, state.particles.density.cpu())


@pytest.mark.parametrize("mdbc_on,block", [(False, True), (False, False), (True, True)])
def test_determinism_of_the_kernels(cuda, mdbc_on, block):
    """``check_determinism`` holds on the card for the block sweep, the cell
    sweep and the mDBC kernel: each output is written once, in one order."""
    from sphexample_tpu_torch.utils.validation import check_determinism

    sim = _tall_column(cuda, mdbc_on, block)
    mod, other = (bs, cw) if block else (cw, bs)
    s0, o0, m0 = mod.launches, other.launches, mm.launches
    assert check_determinism(sim, n_steps=5)
    assert mod.launches - s0 == 2 * 5 * 2 and other.launches == o0
    assert mm.launches - m0 == (10 if mdbc_on else 0)


# --- the chunk graph: a chunk of steps as one CUDA graph (core/step.py) ------------


def _dam_break(device, cap=8):
    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    const = T.SimulationConstants(dx=DX, c0=33.14, alpha=0.1, m0=1000 * DX**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * DX**2)))
    meta = T.SimulationMetaData(simulation_name="gpu_chunk", save_location=".", dims=3,
                                max_steps_per_call=cap)
    return T.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device=device)


def _fluid_vz(state, vz):
    """``state`` with the fluid's last velocity component at ``vz``."""
    p = state.particles
    v = p.velocity.clone()
    v[:, -1] = torch.where(p.ptype == int(T.ParticleType.FLUID), vz, 0.0)
    return state.replace(particles=p.replace(velocity=v))


def _falling(sim, speed=5.0):
    """The start state with the fluid falling at ``speed``: a rebuild every
    few steps."""
    return _fluid_vz(sim.state, -speed)


def _eager(cfg, state, t_outs):
    """The reference: each interval a plain loop of ``sph_step`` calls."""
    from sphexample_tpu_torch.core.step import sph_step

    for t_out in t_outs:
        dx = torch.full((), 1.0 + cfg.spec.kernel.h, dtype=state.total_time.dtype,
                        device=state.total_time.device)
        # the output time in the state's dtype, as the JAX loop compares
        t_end = torch.tensor(t_out, dtype=state.total_time.dtype).item()
        while float(state.total_time) <= t_end:
            state, dx = sph_step(cfg, state, dx)
    return state


def _leaves_equal(a, b):
    from sphexample_tpu_torch.state import state_leaves

    return all(torch.equal(x, y) for x, y in zip(state_leaves(a), state_leaves(b)))


def _t_outs(sim, state, n=3, steps=20):
    dt = float(sim.cfg.spec.constants.cfl) * sim.cfg.spec.kernel.h / sim.cfg.spec.constants.c0
    t0 = float(state.total_time)
    return [t0 + k * steps * dt for k in range(1, n + 1)]


@pytest.mark.parametrize("deck", ["dam_break", "mdbc", "moving_square"])
def test_chunk_graph_is_the_eager_loop_bit_for_bit(cuda, deck):
    """Three intervals of 20 or more steps in chunks of 8 through
    ``make_interval_fn`` (the chunk graph, rebuilds inside chunks,
    intervals that end inside one) and through a plain loop of ``sph_step``
    calls: every tensor bit for bit."""
    from sphexample_tpu_torch.core.step import make_interval_fn

    if deck == "dam_break":
        sim = _dam_break(cuda)
        start = _falling(sim)
    elif deck == "mdbc":
        sim = _tall_column(cuda, mdbc_on=True)
        start = _falling(sim)
    else:
        sim, _, _ = _moving_square(cuda, block_sweep=True)
        start = _falling(sim)
    cfg = dataclasses.replace(sim.cfg, meta=T.replace(sim.meta, max_steps_per_call=8))
    interval = make_interval_fn(cfg)
    t_outs = _t_outs(sim, start)
    state = start
    for t_out in t_outs:
        state = interval(state, t_out)
    ref = _eager(cfg, start, t_outs)
    assert int(state.iteration) == int(ref.iteration) >= 60
    # at least 2 rebuilds more than the intervals' first steps: inside chunks
    assert int(state.rebuilds) == int(ref.rebuilds) > len(t_outs) + 1
    assert _leaves_equal(state, ref)
    assert interval.chunk.graph is not None and interval.chunk.graph.steps == 8


def test_chunk_replay_reads_the_host_once(cuda, monkeypatch):
    """After its capture, an interval in chunks runs under
    ``set_sync_debug_mode("error")`` with the one host read per chunk
    (``_host_read``) let through and counted: no other read is on the path."""
    from sphexample_tpu_torch.core import step

    sim = _dam_break(cuda)
    start = _falling(sim)
    interval = step.make_interval_fn(sim.cfg)
    t_outs = _t_outs(sim, start, n=2)
    first = interval(start, t_outs[0])
    reads, real = [0], step._host_read

    def counted(s, prev):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(s, prev)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(step, "_host_read", counted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        end = interval(first, t_outs[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps = int(end.iteration) - int(first.iteration)
    assert steps > 8 and reads[0] == -(-steps // 8)


def test_failed_capture_raises_and_runs_nothing(cuda, monkeypatch):
    """A capture that fails raises, naming the cause; the eager loop does not
    run in its place: only the chunk's first step ran (eagerly, on the
    chunk's buffers, before the capture: 2 sweep launches), the state handed
    in is unchanged, and a later capture works."""
    from sphexample_tpu_torch.core import step

    sim = _dam_break(cuda)
    before = [a.clone() for a in (sim.state.particles.position, sim.state.total_time)]
    real = step._write_stage02

    def broken(dst, src):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("injected fault in the rebuild")
        real(dst, src)

    monkeypatch.setattr(step, "_write_stage02", broken)
    b0 = bs.launches
    with pytest.raises(RuntimeError, match="chunk graph capture failed: injected"):
        step.make_interval_fn(sim.cfg)(sim.state, 0.001)
    assert bs.launches == b0 + 2
    assert torch.equal(sim.state.particles.position, before[0])
    assert torch.equal(sim.state.total_time, before[1])
    monkeypatch.setattr(step, "_write_stage02", real)
    out = step.make_interval_fn(sim.cfg)(sim.state, 0.001)
    assert float(out.total_time) > 0.001
    assert bs.launches - b0 == 2 + 2 * int(out.iteration)


def test_launch_counts_follow_the_replays(cuda, monkeypatch):
    """The wrappers count where they launch, and a captured launch counts at
    every replay that runs it (``ops/launch_count.py``): N steps through the
    graph count N times 2 sweeps, 1 mDBC call and its 4 grouping kernels,
    and a count made inside the rebuild's IF body counts the rebuilds that
    ran, not the steps."""
    from sphexample_tpu_torch.core import step
    from sphexample_tpu_torch.ops import launch_count

    sim = _tall_column(cuda, mdbc_on=True)
    cfg = dataclasses.replace(sim.cfg, meta=T.replace(sim.meta, max_steps_per_call=8))
    real = step._rebuild
    monkeypatch.setattr(bs, "window_launches", 0)

    def rebuild(cfg, keep):
        # a launch of the rebuild's own, counted as a wrapper counts one
        launch_count.add(bs, "window_launches", 1, keep.dx_acc.device)
        return real(cfg, keep)

    monkeypatch.setattr(step, "_rebuild", rebuild)
    start = _falling(sim)
    b0, m0, g0 = bs.launches, mm.launches, mm.group_launches
    n = 3 * 8 + 5        # three whole replays and part of a fourth
    fixed = make_fixed_steps_fn(cfg, n)
    state = fixed(start)
    assert fixed.chunk.graph is not None
    assert int(state.iteration) == int(start.iteration) + n
    assert bs.launches - b0 == 2 * n
    assert mm.launches - m0 == n and mm.group_launches - g0 == 4 * n
    rebuilds = int(state.rebuilds) - int(start.rebuilds)
    assert 1 < rebuilds < n and bs.window_launches == rebuilds


def test_saver_snapshot_unchanged_by_the_next_replay(cuda):
    """A state the chunk loop hands out (what the asynchronous saver holds,
    and what ``run_simulation`` keeps for a replay) shares no storage with
    the graph's buffers, and the next interval's replays leave it as it
    was."""
    from sphexample_tpu_torch.core.step import make_interval_fn
    from sphexample_tpu_torch.state import state_leaves

    sim = _dam_break(cuda)
    start = _falling(sim)
    interval = make_interval_fn(sim.cfg)
    t_outs = _t_outs(sim, start, n=2)
    snap = interval(start, t_outs[0])
    kept = [a.clone() for a in state_leaves(snap)]
    buf = interval.chunk.buffers
    owned = {a.untyped_storage().data_ptr() for a in state_leaves(buf.state)}
    assert not owned & {a.untyped_storage().data_ptr() for a in state_leaves(snap)}
    nxt = interval(snap, t_outs[1])
    torch.cuda.synchronize()
    assert int(nxt.iteration) > int(snap.iteration)
    assert all(torch.equal(a, b) for a, b in zip(kept, state_leaves(snap)))


# --- tracing: spans, host reads and CUDA events around the replays (utils/timers.py) --


def _traced(cuda, run, intervals=3):
    """The falling dam break in chunks of 8, its chunk graph captured by a
    first interval; then ``intervals`` intervals of ``run_simulation`` with
    a log callback, tracing on, run by ``run(go)``.  Returns the log
    records and the recorder."""
    from sphexample_tpu_torch.utils import timers

    sim = _dam_break(cuda)
    sim.state = _falling(sim)
    T.run_simulation(sim, max_intervals=1)
    logs = []

    def go():
        T.run_simulation(sim, log_callback=logs.append, max_intervals=intervals,
                         start_counter=2)
        torch.cuda.synchronize()

    timers.start_trace()
    try:
        run(go)
    finally:
        timers.stop_trace()
    return logs, timers.RECORDER


def test_traced_chunks_time_each_replay(cuda):
    """Every chunk of the traced intervals is a replay timed by its four
    events: its launch's device time is > 0 and within its ``chunk`` span,
    the gaps between chunks are > 0, replays, copies and gaps add up to the
    device clock's span, and the reads are 7 an interval and 1 a chunk."""
    from sphexample_tpu_torch.utils.timers import HOST_READS

    logs, rec = _traced(cuda, lambda go: go())
    spans = [s for s in rec.spans if s[0] == "chunk"]
    assert len(logs) == 3 and len(spans) == len(rec.chunks) >= 2 * len(logs)
    for (_, a, b, _, interval), (c_int, steps, rebuilds, replay, copy, gap) in zip(
            spans, rec.chunks):
        assert c_int == interval and 0 < steps <= 8 and rebuilds >= 0
        assert 0 < replay <= (b - a) / 1e6 and copy > 0
    gaps = [c[5] for c in rec.chunks]
    assert gaps[0] is None and all(g > 0 for g in gaps[1:])
    total = sum(c[3] + c[4] for c in rec.chunks) + sum(gaps[1:])
    assert total == pytest.approx(rec.device_span_ms(), rel=1e-2)
    assert sum(c[1] for c in rec.chunks) == sum(r["steps_in_interval"] for r in logs)
    assert rec.counters[HOST_READS] == 7 * len(logs) + len(rec.chunks)


def test_graph_launches_lie_in_chunk_launch_spans(cuda):
    """Under ``torch.profiler`` every ``cudaGraphLaunch`` runtime record,
    placed by ``trace_start_ns()``, lies inside a ``chunk.launch`` span
    within 20 us: the spans are on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    held = {}

    def profiled(go):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            go()
        held["prof"] = prof

    _, rec = _traced(cuda, profiled, intervals=2)
    prof = held["prof"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    launches = [(a, b) for name, a, b, _, _ in rec.spans if name == "chunk.launch"]
    records = [e for e in prof.events() if "cudaGraphLaunch" in e.name]
    assert len(records) == len(launches) > 0
    slack = 20_000
    for e in records:
        a = t0 + 1000 * e.time_range.start
        b = t0 + 1000 * e.time_range.end
        assert any(s - slack <= a and b <= t + slack for s, t in launches), (a, b)


# --- the sharded chunk: every slab's steps in one graph (slabs on one card) ---------

def _capture_under_sync_debug(monkeypatch):
    """Run every chunk graph's capture (``ChunkGraph._on_ranks`` without
    ``sync``: the ranks' threads capturing) under
    ``set_sync_debug_mode("error")``: a host read in it raises."""
    from sphexample_tpu_torch.core import step

    real, captures = step.ChunkGraph._on_ranks, [0]

    def on_ranks(self, fn, sync):
        if sync:
            return real(self, fn, sync)
        captures[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, fn, sync)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(step.ChunkGraph, "_on_ranks", on_ranks)
    return captures


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mdbc_on,block", [(False, True), (True, True), (False, False)])
def test_sharded_chunk_graph_is_the_eager_chunk_bit_for_bit(cuda, monkeypatch, n, mdbc_on,
                                                            block):
    """The tall column on ``n`` slabs of one card, its fluid thrown up at 24
    m/s (rebuilds inside chunks), three intervals in chunks of 8: through
    the sharded interval function (one graph of every slab's steps, its
    capture under sync-debug mode) and through the ranks' eager chunk (a
    host read a step): every tensor of every slab bit for bit, 2 windowed
    sweep launches (+ 1 mDBC call) a step a slab counted at the replays,
    and, once built, one host read per chunk under sync-debug mode."""
    from sphexample_tpu_torch.core import step
    from sphexample_tpu_torch.state import state_leaves

    captures = _capture_under_sync_debug(monkeypatch)
    # room above the column for its rise (~0.5 m): no grid escape
    sim = _tall_column(cuda, mdbc_on, block, margin=24)
    sim.meta = T.replace(sim.meta, max_steps_per_call=8)
    sim.cfg = dataclasses.replace(sim.cfg, meta=sim.meta)
    sharded = shard_simulation(sim, make_mesh(n, torch.device("cuda", 0)))
    interval = sharded.interval_fn
    assert interval.chunk.route == "graph"
    start = tuple(_fluid_vz(s, 24.0) for s in sharded.state)
    t_outs = _t_outs(sim, start[0])
    mod = bs if block else cw
    w0, m0 = mod.window_launches, mm.launches
    graph = start
    for t_out in t_outs[:2]:
        graph = interval(graph, t_out)
    assert captures[0] == 1 and interval.chunk.graph is not None
    reads, real = [0], step._host_read

    def counted(s, prev):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(s, prev)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(step, "_host_read", counted)
    it1 = int(graph[0].iteration)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph = interval(graph, t_outs[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.setattr(step, "_host_read", real)
    assert reads[0] == -(-(int(graph[0].iteration) - it1) // 8)
    steps = int(graph[0].iteration) - int(start[0].iteration)
    assert mod.window_launches - w0 == 2 * steps * n
    assert mm.launches - m0 == (steps * n if mdbc_on else 0)
    eager_interval = step.make_chunk_loop(sharded.cfg, step._eager_chunk(sharded.cfg))
    eager = start
    for t_out in t_outs:
        eager = eager_interval(eager, t_out)
    assert int(graph[0].iteration) == int(eager[0].iteration) >= 60
    rebuilds = int(graph[0].rebuilds) - int(start[0].rebuilds)
    assert rebuilds > len(t_outs) + 1 and len({int(s.rebuilds) for s in graph}) == 1
    for a, b in zip(graph, eager):
        assert all(torch.equal(x, y) for x, y in zip(state_leaves(a), state_leaves(b)))


def test_sharded_failed_capture_raises(cuda, monkeypatch):
    """A sharded capture that fails in one rank raises, naming the cause,
    with no eager chunk run in its place; the capture left open is ended,
    the state handed in is unchanged, and a later capture works."""
    from sphexample_tpu_torch.core import step
    from sphexample_tpu_torch.parallel.context import thread_rank

    sharded = shard_simulation(_tall_column(cuda, False),
                               make_mesh(2, torch.device("cuda", 0)))
    before = [a.clone() for a in (sharded.state[1].particles.position,
                                  sharded.state[1].total_time)]
    real = step._write_stage02

    def broken(dst, src):
        if torch.cuda.is_current_stream_capturing() and thread_rank() == 1:
            raise RuntimeError("injected fault in rank 1's rebuild")
        real(dst, src)

    monkeypatch.setattr(step, "_write_stage02", broken)
    monkeypatch.setattr(step, "_eager_chunk", None)
    with pytest.raises(RuntimeError, match="chunk graph capture failed: injected"):
        sharded.interval_fn(sharded.state, 0.001)
    assert torch.equal(sharded.state[1].particles.position, before[0])
    assert torch.equal(sharded.state[1].total_time, before[1])
    monkeypatch.setattr(step, "_write_stage02", real)
    out = step.make_interval_fn(sharded.cfg)(sharded.state, 0.001)
    assert float(out[1].total_time) > 0.001 and out[0].iteration == out[1].iteration
