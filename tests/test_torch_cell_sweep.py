"""The port's cell-sweep module on the CPU: its plain version against the JAX
package's TPU cell-pair sweep (``pallas_pair_sweep`` in interpret mode) in f32
with the tolerances of test_pallas_sweep.py:100-119, against JAX ``pair_sweep``
in f64 over the whole viscosity x diffusion x kernel-family matrix with
shifting and kernel output on (tolerances of test_sweep.py:103-107), and the
wrapper: CPU tensors take the plain version, the params struct, the variant
chooser, the collector and the input checks."""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu.config as jc
import sphexample_tpu_torch.config as tc
from sphexample_tpu.models import equations as jeq
from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.ops.interactions import PhysicsSpec as JSpec
from sphexample_tpu.ops.interactions import pair_sweep as j_pair_sweep
from sphexample_tpu.ops.pallas_sweep import pallas_pair_sweep
from sphexample_tpu.state import allocate_particles as j_alloc
from sphexample_tpu_torch.models import equations as teq
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops.interactions import PhysicsSpec as TSpec
from sphexample_tpu_torch.state import allocate_particles as t_alloc
from kernel_launches import forbid_kernels

torch.set_num_threads(1)
VISC = ["ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS"]
DIFF = ["ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX"]
FIELDS = ("drhodt", "acceleration", "kernel_w", "kernel_grad", "grad_c", "div_r")


def _inputs(dims, n, seed):
    """The jittered lattice of test_pallas_sweep.py:27-51, as numpy arrays."""
    rng = np.random.default_rng(seed)
    dx = 0.05
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * dx] * dims), indexing="ij"),
                      axis=-1).reshape(-1, dims)[:n]
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * dx
    pos -= pos.mean(axis=0)
    dens = rng.uniform(990, 1040, size=n)
    vel = rng.normal(0, 0.5, size=(n, dims))
    ptype = rng.choice([1, 2], size=n).astype(np.int32)
    return pos, dens, vel, ptype


def _both(dims, family, visc, diff, n, cap, f64, seed=3):
    """The same rows allocated and rebuilt by both packages (PLANAR + STORE)."""
    pos, dens, vel, ptype = _inputs(dims, n, seed)
    ids, ones = np.arange(1, n + 1), np.ones(n, np.int32)
    velp = np.zeros((cap, dims))
    velp[:n] = vel
    tdt, jdt = (torch.float64, jnp.float64) if f64 else (torch.float32, jnp.float32)

    tconst = tc.SimulationConstants(dx=0.05, cfl=0.5)
    tkern = tc.make_kernel(tc.KernelFamily[family], dims, dx=0.05)
    p = t_alloc(pos, dens, ptype, ones, ids, device="cpu", dtype=tdt, capacity=cap)
    p = p.replace(velocity=torch.as_tensor(velp, dtype=tdt))
    p = p.replace(pressure=teq.pressure(p.density, tconst))
    grid = tcl.grid_from_positions(pos, tkern.H_inv, margin_cells=3)
    sp, cs, _ = tcl.rebuild(p, tkern.H_inv, grid)
    tspec = TSpec(constants=tconst, kernel=tkern, viscosity=tc.ViscosityModel[visc],
                  diffusion=tc.DensityDiffusionModel[diff],
                  shifting=tc.ShiftingMode.PLANAR,
                  kernel_output=tc.KernelOutputMode.STORE)

    jconst = jc.SimulationConstants(dx=0.05, cfl=0.5)
    jkern = jc.make_kernel(jc.KernelFamily[family], dims, dx=0.05)
    jp = j_alloc(pos, dens, ptype, ones, ids, dtype=jdt, capacity=cap)
    jp = jp.replace(velocity=jnp.asarray(velp, dtype=jdt))
    jp = jp.replace(pressure=jeq.pressure(jp.density, jconst))
    jgrid = jcl.Grid(cmin=grid.cmin, shape=grid.shape)
    jsp, jcs, _ = jcl.rebuild(jp, jkern.H_inv, jgrid)
    np.testing.assert_array_equal(np.asarray(jsp.id), sp.id.numpy())
    jspec = JSpec(constants=jconst, kernel=jkern, viscosity=jc.ViscosityModel[visc],
                  diffusion=jc.DensityDiffusionModel[diff],
                  shifting=jc.ShiftingMode.PLANAR,
                  kernel_output=jc.KernelOutputMode.STORE)
    return (tspec, grid, sp, cs), (jspec, jgrid, jsp, jcs)


def _sweep_args(spec, grid, p, cs):
    return (spec, grid, p, cs, p.position, p.density, p.pressure, p.velocity)


@pytest.mark.parametrize("visc,diff", [("ARTIFICIAL", "LINEAR"),
                                       ("LAMINAR_SPS", "ZERO_GRAVITY_LINEAR")])
def test_plain_cell_sweep_matches_pallas_interpret(visc, diff, monkeypatch):
    """n = 220, capacity 1024, mpc, cseg = 64, 256, f32, 2D: all six fields."""
    (tspec, grid, p, cs), (jspec, jgrid, jp, jcs) = _both(
        2, "WENDLAND_C2", visc, diff, n=220, cap=1024, f64=False)
    forbid_kernels(monkeypatch)           # CPU tensors never launch the kernel
    out = cw.cell_sweep(*_sweep_args(tspec, grid, p, cs))
    assert out.drhodt.dtype == torch.float32
    ref = pallas_pair_sweep(jspec, jgrid, 64, 256, min(jgrid.ncells, jp.capacity),
                            jp, jcs, jp.position, jp.density, jp.pressure, jp.velocity,
                            interpret=True)
    for f in FIELDS:
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        # test_pallas_sweep.py:100-119: 2e-5 of the field max; 1e-4 absolute
        # for kernel_w and div_r
        atol = 1e-4 if f in ("kernel_w", "div_r") else 2e-5 * (float(np.abs(b).max()) + 1e-6)
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=atol, err_msg=f)
        assert np.abs(b).max() > 0, f


@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
def test_plain_cell_sweep_matches_jax_pair_sweep_f64(family, visc, diff):
    dims = 3 if (visc, diff) == ("LAMINAR_SPS", "COMPLEX") else 2
    (tspec, grid, p, cs), (jspec, jgrid, jp, jcs) = _both(
        dims, family, visc, diff, n=120, cap=136, f64=True, seed=0)
    out = cw.cell_sweep_plain(*_sweep_args(tspec, grid, p, cs), block_size=50)
    ref = j_pair_sweep(jspec, jgrid, 3 * 64, 64, jp, jcs, jp.position, jp.density,
                       jp.pressure, jp.velocity)
    # test_sweep.py:103-107 (the COMPLEX 7th root goes through two pow's)
    rtol, atol = (1e-5, 2e-6 * float(np.abs(np.asarray(ref.drhodt)).max())) \
        if diff == "COMPLEX" else (1e-10, 1e-8)
    np.testing.assert_allclose(out.drhodt.numpy(), np.asarray(ref.drhodt),
                               rtol=rtol, atol=atol)
    for f in FIELDS[1:]:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-10, atol=1e-8, err_msg=f)
    assert not out.drhodt[120:].any() and not out.kernel_w[120:].any()


def _spec(dims=3, visc="ARTIFICIAL", diff="LINEAR", store=False, shift=False,
          family="WENDLAND_C2"):
    const = tc.SimulationConstants(dx=0.0034, c0=33.14, alpha=0.1, nu0=1e-6)
    kern = tc.make_kernel(tc.KernelFamily[family], dims, h=float(np.sqrt(3) * 0.0034))
    return TSpec(constants=const, kernel=kern, viscosity=tc.ViscosityModel[visc],
                 diffusion=tc.DensityDiffusionModel[diff],
                 shifting=tc.ShiftingMode.PLANAR if shift else tc.ShiftingMode.NONE,
                 kernel_output=(tc.KernelOutputMode.STORE if store
                                else tc.KernelOutputMode.NONE))


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_every_mode_has_a_kernel_variant(dims, visc, store, shift):
    seen = set()
    for diff in DIFF:
        for family in ("WENDLAND_C2", "CUBIC_SPLINE"):
            spec = _spec(dims, visc, diff, store, shift, family)
            seen.add(cw.kernel_variant(spec, dims))
            assert cw.n_sums(spec, dims) == (1 + dims) * (1 + store + shift)
    # one template instance per (dims, SPS, STORE, PLANAR); the family, the
    # other viscosities and the diffusion are run-time parameters
    assert seen == {(dims == 3) << 3 | (visc == "LAMINAR_SPS") << 2 | store << 1 | shift}
    prm = cw.sweep_params(_spec(dims, visc, "COMPLEX", store, shift, "CUBIC_SPLINE"),
                          tcl.Grid(cmin=(0,) * dims, shape=(5,) * dims), 10)
    assert (prm.family, prm.viscosity, prm.diffusion) == (1, VISC.index(visc), 3)


def test_kernel_variant_rejects_only_bad_dims():
    with pytest.raises(NotImplementedError, match="dims=1"):
        cw.kernel_variant(_spec(), 1)
    with pytest.raises(NotImplementedError, match="dims=4"):
        cw.kernel_variant(_spec(), 4)


def test_params_struct_layout():
    spec = _spec(3, "LAMINAR_SPS", "COMPLEX")
    grid = tcl.Grid(cmin=(-6, -6, -6), shape=(148, 69, 51))
    prm = cw.sweep_params(spec, grid, 2215035)
    # 12 ints, then 18 floats, in the order of struct CellSweepParams
    assert ctypes.sizeof(prm) == 12 * 4 + 18 * 4
    assert [f[0] for f in prm._fields_[:8]] == ["n", "self_off", "ncells", "shape",
                                                "strides", "family", "viscosity",
                                                "diffusion"]
    assert prm.self_off == 0 and cw.sweep_params(spec, grid, 512, 128).self_off == 128
    assert prm.n == 2215035 and prm.ncells == 148 * 69 * 51
    assert list(prm.shape) == [148, 69, 51] and list(prm.strides) == [1, 148, 148 * 69]
    c, k = spec.constants, spec.kernel
    assert prm.lam_fac == pytest.approx(4 * c.m0 * c.nu0, rel=1e-6)
    assert prm.rho0_g == pytest.approx(c.rho0 * c.g, rel=1e-6)
    assert prm.Cb_inv == pytest.approx(1 / c.Cb, rel=1e-6)
    assert prm.cs2_dx2 == pytest.approx((c.smagorinsky_constant * c.dx) ** 2, rel=1e-6)
    assert prm.blin_dx2 == pytest.approx(c.blin_constant * c.dx ** 2, rel=1e-6)
    assert prm.alpha_c0 == pytest.approx(0.1 * 33.14, rel=1e-6)
    assert prm.H2 == pytest.approx(k.H2, rel=1e-6)
    # a 2D grid pads its third extent with 1: the kernel divides by shape[1] only in 3D
    prm2 = cw.sweep_params(_spec(2), tcl.Grid(cmin=(0, 0), shape=(7, 9)), 5)
    assert list(prm2.shape) == [7, 9, 1] and list(prm2.strides)[:2] == [1, 7]


@pytest.mark.parametrize("dims,store,shift", [(2, True, True), (3, True, True),
                                              (3, False, True), (2, True, False),
                                              (3, False, False)])
def test_collect(dims, store, shift):
    spec = _spec(dims, store=store, shift=shift)
    n, k = 12, cw.n_sums(spec, dims)
    out = torch.randn(n, k)
    out[-3:] = float("nan")          # rows no block owns may hold anything
    active = torch.arange(n) < n - 3
    col = cw.collect(out, active, torch.float64, dims, spec)
    names = iter(range(k))
    expect = {"drhodt": 1, "acceleration": dims}
    if store:
        expect.update(kernel_w=1, kernel_grad=dims)
    if shift:
        expect.update(grad_c=dims, div_r=1)
    for f in FIELDS:
        v = getattr(col, f)
        if f not in expect:
            assert v is None
            continue
        cols = [next(names) for _ in range(expect[f])]
        assert v.dtype == torch.float64 and not v[~active].any()     # select, not product
        torch.testing.assert_close(v[active].reshape(9, -1), out[active][:, cols].double())


def test_cpu_wrapper_is_the_plain_version(monkeypatch):
    (tspec, grid, p, cs), _ = _both(3, "CUBIC_SPLINE", "LAMINAR_SPS", "COMPLEX",
                                    n=150, cap=160, f64=True, seed=4)
    forbid_kernels(monkeypatch)
    a = cw.cell_sweep(*_sweep_args(tspec, grid, p, cs))
    b = cw.cell_sweep_plain(*_sweep_args(tspec, grid, p, cs), block_size=7)
    for f in FIELDS:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=1e-12, atol=1e-9)
    assert not a.drhodt[150:].any()


def test_input_checks_raise_on_the_cuda_path(monkeypatch):
    """A stand-in for a CUDA position tensor: the dispatch reaches the kernel
    path and refuses what the kernel does not take, before building anything."""
    (tspec, grid, p, cs), _ = _both(2, "WENDLAND_C2", "ARTIFICIAL", "LINEAR",
                                    n=60, cap=64, f64=False)
    fake = types.SimpleNamespace(device=torch.device("cuda"), shape=(64, 2),
                                 dtype=torch.float32)
    forbid_kernels(monkeypatch)
    with pytest.raises(ValueError, match="velocity is on cpu"):
        cw.cell_sweep(tspec, grid, p, cs, fake, p.density, p.pressure, p.velocity)
    with pytest.raises(ValueError, match="grid"):
        cw.cell_sweep(tspec, tcl.Grid(cmin=(0, 0, 0), shape=(3, 3, 3)), p, cs, fake,
                      p.density, p.pressure, p.velocity)
    with pytest.raises(NotImplementedError, match="dims=4"):
        cw.cell_sweep(tspec, grid, p, cs,
                      types.SimpleNamespace(device=torch.device("cuda"), shape=(64, 4)),
                      None, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        cw.cell_sweep(tspec, grid, p, cs,
                      types.SimpleNamespace(device=torch.device("meta"), shape=(64, 2)),
                      None, None, None)
