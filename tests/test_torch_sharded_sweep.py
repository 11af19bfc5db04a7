"""The plain versions of the windowed kernels, on the CPU in f64: the sweep
over a self range of a halo-extended array (``interactions.pair_sweep`` with
``self_off``; the CPU path of ``block_sweep_sharded`` / ``cell_sweep_sharded``)
and the mDBC moments on extended arrays (``mdbc_density_correction_sharded``),
4 slabs as thread ranks with the real halo exchange, concatenated and held
against the single-device plain versions at ``rtol=1e-9, atol=1e-12``: every
viscosity x density diffusion with PLANAR shifting and kernel output STORE, in
2D and 3D, with cells straddling the slab edges, for the 1-hop window and for
the whole-array window (``halo = 0``).  And the host halo sizer
``measure_halo`` against the JAX package's on the same arrays."""

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu.ops.cell_list import Grid as JGrid
from sphexample_tpu.parallel.mesh import measure_halo as j_measure_halo
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import halo as halo_mod
from sphexample_tpu_torch.ops import mdbc
from sphexample_tpu_torch.ops.interactions import PhysicsSpec, pair_sweep
from sphexample_tpu_torch.parallel.context import CommContext, LocalGroup, run_ranks
from sphexample_tpu_torch.parallel.mesh import measure_halo, size_halo
from sphexample_tpu_torch.state import allocate_particles

torch.set_num_threads(1)
N = 4
DX = 0.05
RTOL, ATOL = 1e-9, 1e-12   # f64, the same pair terms in the same order
FIELDS = ("drhodt", "acceleration", "kernel_w", "kernel_grad", "grad_c", "div_r")
VISC = ["ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS"]
DIFF = ["ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX"]


def _column(dims, seed=0, ghosts=False):
    """A jittered lattice column, long in the last axis (the slowest of the
    cell key), with fluid, fixed and moving rows and inactive padding, in f64,
    rebuilt; the capacity is a multiple of 4 and the slab edges cut cells."""
    rng = np.random.default_rng(seed)
    const = T.SimulationConstants(dx=DX, cfl=0.5)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    shape = (5, 260) if dims == 2 else (3, 3, 150)
    coords = np.stack(np.meshgrid(*[np.arange(s) * DX for s in shape], indexing="ij"),
                      axis=-1).reshape(-1, dims)
    n = len(coords)
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * DX
    cap = -(-(n + 9) // N) * N
    ptype = rng.choice([1, 2, 3], size=n, p=[0.7, 0.2, 0.1]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(990, 1040, size=n), ptype,
                           np.ones(n, np.int32), np.arange(1, n + 1), device="cpu",
                           dtype=torch.float64, capacity=cap)
    vel = np.zeros((cap, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    p = p.replace(velocity=torch.as_tensor(vel), pressure=eq.pressure(p.density, const))
    if ghosts:
        gp = np.zeros((cap, dims))
        fixed = np.flatnonzero(ptype == 2)
        gp[fixed] = pos[fixed] + rng.uniform(-1.0, 1.0, size=(len(fixed), dims)) * DX
        p = p.replace(ghost_points=torch.as_tensor(gp))
    grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs


def _halo_of(kern, grid, p, ghosts=False):
    need = measure_halo(p.position.numpy(), p.active.numpy(), kern.H_inv, grid, N,
                        p.capacity, p.ghost_points.numpy() if ghosts else None)
    halo = size_halo(need, p.capacity // N)
    assert 0 < need <= halo <= p.capacity // N
    return halo


def _slabs(p):
    C = p.capacity // N
    return [p.map(lambda a, r=r: a[r * C:(r + 1) * C].clone()) for r in range(N)]


def _on_ranks(fn):
    group = LocalGroup(["cpu"] * N, timeout=60.0)
    return run_ranks(group, lambda r: fn(CommContext(group, r), r))


def _straddled_edges(cs, C):
    inner = set(cs[(cs > 0) & (cs < cs[-1])].tolist())
    return [r * C for r in range(1, N) if r * C not in inner]


def _assert_sweeps_close(outs, ref):
    for name in FIELDS:
        want = getattr(ref, name)
        if want is None:
            assert all(getattr(o, name) is None for o in outs), name
            continue
        got = torch.cat([getattr(o, name) for o in outs])
        assert float(want.abs().max()) > 0, name
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=name)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
def test_windowed_sweep_matches_single_device(dims, visc, diff):
    const, kern, grid, p, cs = _column(dims)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel[visc],
                       diffusion=T.DensityDiffusionModel[diff],
                       shifting=T.ShiftingMode.PLANAR,
                       kernel_output=T.KernelOutputMode.STORE)
    ref = pair_sweep(spec, grid, 64, p, cs, p.position, p.density, p.pressure, p.velocity)
    assert _straddled_edges(cs, p.capacity // N)      # slab edges cut cells
    slabs = _slabs(p)
    for halo in (_halo_of(kern, grid, p), 0):         # the 1-hop window, the whole array
        outs = _on_ranks(lambda c, r: cw.cell_sweep_sharded(
            spec, grid, halo, slabs[r], cs, slabs[r].position, slabs[r].density,
            slabs[r].pressure, slabs[r].velocity, c, 64))
        assert all(o.drhodt.shape[0] == p.capacity // N for o in outs)
        _assert_sweeps_close(outs, ref)


@pytest.mark.parametrize("dims", [2, 3])
def test_block_and_cell_entries_share_the_plain_window(dims):
    """On the CPU both sharded entries and both window entries are the plain
    windowed sweep: bit for bit the same, and a window built by slicing gives
    what the exchange gives."""
    const, kern, grid, p, cs = _column(dims, seed=1)
    spec = PhysicsSpec(constants=const, kernel=kern,
                       viscosity=T.ViscosityModel.ARTIFICIAL,
                       diffusion=T.DensityDiffusionModel.LINEAR)
    halo = _halo_of(kern, grid, p)
    slabs = _slabs(p)
    C = p.capacity // N

    def both(c, r):
        args = (spec, grid, halo, slabs[r], cs, slabs[r].position, slabs[r].density,
                slabs[r].pressure, slabs[r].velocity, c, 64)
        return bs.block_sweep_sharded(*args), cw.cell_sweep_sharded(*args)

    for r, (b, c) in enumerate(_on_ranks(both)):
        assert torch.equal(b.drhodt, c.drhodt) and torch.equal(b.acceleration, c.acceleration)
        lo, hi = r * C - halo, (r + 1) * C + halo

        def ext(a):
            zl = a.new_zeros((max(0, -lo),) + tuple(a.shape[1:]))
            zr = a.new_zeros((max(0, hi - p.capacity),) + tuple(a.shape[1:]))
            return torch.cat([zl, a[max(lo, 0):min(hi, p.capacity)], zr])

        cs_ext = halo_mod.rebase(cs, lo, hi - lo)
        assert cs_ext.dtype == torch.int32 and int(cs_ext.min()) >= 0
        assert int(cs_ext.max()) <= hi - lo
        for window in (bs.block_sweep_window, cw.cell_sweep_window):
            w = window(spec, grid, slabs[r], cs_ext, ext(p.position), ext(p.density),
                       ext(p.pressure), ext(p.velocity), ext(p.motion_limiter), halo, 64)
            assert torch.equal(w.drhodt, b.drhodt)
            assert torch.equal(w.acceleration, b.acceleration)


def test_window_thinner_than_the_reach_drops_pairs():
    """What ``max_halo`` guards: a halo below the need clamps the rebased
    ``cell_start`` and the slabs no longer add up to the single-device sweep."""
    const, kern, grid, p, cs = _column(2)
    spec = PhysicsSpec(constants=const, kernel=kern,
                       viscosity=T.ViscosityModel.ARTIFICIAL,
                       diffusion=T.DensityDiffusionModel.LINEAR)
    ref = pair_sweep(spec, grid, 64, p, cs, p.position, p.density, p.pressure, p.velocity)
    slabs = _slabs(p)
    outs = _on_ranks(lambda c, r: cw.cell_sweep_sharded(
        spec, grid, 2, slabs[r], cs, slabs[r].position, slabs[r].density,
        slabs[r].pressure, slabs[r].velocity, c, 64))
    got = torch.cat([o.drhodt for o in outs])
    assert torch.isfinite(got).all() and not torch.allclose(got, ref.drhodt, rtol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        _on_ranks(lambda c, r: halo_mod.extend(c, slabs[r].position, p.capacity))


@pytest.mark.parametrize("dims", [2, 3])
def test_windowed_mdbc_matches_single_device(dims):
    const, kern, grid, p, cs = _column(dims, seed=2, ghosts=True)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ZERO,
                       diffusion=T.DensityDiffusionModel.ZERO)
    B = int((torch.any(p.ghost_points != 0, dim=-1) & p.active).sum())
    assert B > 20
    ref = mdbc.mdbc_density_correction(spec, grid, p, cs, B)
    assert float((ref - p.density).abs().max()) > 1e-3      # the correction fired
    slabs = _slabs(p)
    for halo in (_halo_of(kern, grid, p, ghosts=True), 0):
        outs = _on_ranks(lambda c, r: mdbc.mdbc_density_correction_sharded(
            spec, grid, slabs[r], cs, B, c, halo))
        torch.testing.assert_close(torch.cat(outs), ref, rtol=RTOL, atol=ATOL)


def _host_arrays(dims, ghosts, seed):
    _, kern, grid, p, _ = _column(dims, seed=seed, ghosts=ghosts)
    # an unsorted order as well: the sizer sorts for itself
    perm = np.random.default_rng(seed).permutation(p.capacity)
    return kern, grid, (p.position.numpy()[perm], p.active.numpy()[perm],
                        p.ghost_points.numpy()[perm])


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("ghosts", [False, True])
@pytest.mark.parametrize("ndev", [2, 4])
def test_measure_halo_equals_the_jax_function(dims, ghosts, ndev):
    kern, grid, (pos, act, gp) = _host_arrays(dims, ghosts, seed=5)
    jgrid = JGrid(cmin=grid.cmin, shape=grid.shape)
    cap = len(pos)
    want = j_measure_halo(pos, act, kern.H_inv, jgrid, ndev, cap,
                          ghost_points=gp if ghosts else None)
    got = measure_halo(pos, act, kern.H_inv, grid, ndev, cap,
                       ghost_points=gp if ghosts else None)
    assert isinstance(got, int) and got == want > 0
    if ghosts:
        assert got >= measure_halo(pos, act, kern.H_inv, grid, ndev, cap)
    np.testing.assert_array_equal(
        cl.host_cell_keys(pos, kern.H_inv, grid),
        cl.linearize(cl.cell_coords(torch.as_tensor(pos), kern.H_inv), grid).numpy())


def test_halo_of_the_main_deck_by_both_functions():
    """The 159,712-particle 3D dam break (``dam_break_3d(0.0085)``, f32
    positions, capacity padded to 4 x 512 rows) on 4 slabs: the JAX package's
    sizer and the port's give the same need, and the rule the same halo."""
    from sphexample_tpu_torch.io.casegen import dam_break_3d

    dx = 0.0085
    pos = dam_break_3d(dx)[0]
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * dx**2)))
    grid = cl.grid_from_positions(pos, kern.H_inv, 6)
    assert grid.shape == (67, 36, 28) and sum(grid.strides) == 2480
    cap = -(-len(pos) // (N * 512)) * (N * 512)
    p = np.zeros((cap, 3), np.float32)
    p[:len(pos)] = pos
    act = np.arange(cap) < len(pos)
    want = j_measure_halo(p, act, kern.H_inv, JGrid(cmin=grid.cmin, shape=grid.shape),
                          N, cap)
    assert (len(pos), cap) == (159712, 159744)
    assert measure_halo(p, act, kern.H_inv, grid, N, cap) == want == 15596
    assert size_halo(want, cap // N) == 31360 <= cap // N == 39936


def test_size_halo_rule():
    """The sizing rule of ``sphexample_tpu/parallel/mesh.py:220-245``."""
    assert size_halo(100, 1024) == 384                     # r128(2 * 100 + 128)
    assert size_halo(15596, 39936) == 31360                # the 159,712-particle dam break
    assert size_halo(500, 1024) == 1024                    # tight fit: the whole slab
    assert size_halo(1000, 1024) == 0                      # one hop cannot cover it
    assert size_halo(100, 1024, min_halo=600) == 640       # an observed floor
    assert size_halo(100, 1024, min_halo=5000) == 0        # a floor above a slab
    assert size_halo(0, 512) == 128
