"""The port's plain ``pair_sweep`` against the numpy brute-force oracle
(``reference_impl.brute_force_sweep``) over every viscosity x diffusion
model in 2D and 3D, both kernel families, and against JAX ``pair_sweep`` on
the main-path models - f64, with the tolerances of test_sweep.py."""

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
from sphexample_tpu.state import allocate_particles as j_alloc
from sphexample_tpu_torch.models import equations as teq
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops.interactions import PhysicsSpec as TSpec
from sphexample_tpu_torch.ops.interactions import pair_sweep
from sphexample_tpu_torch.state import allocate_particles as t_alloc

from reference_impl import brute_force_sweep

torch.set_num_threads(1)


def _setup(dims, n, family="WENDLAND_C2", seed=0, capacity=None):
    """The same jittered lattice as test_sweep.py, rebuilt by the port."""
    rng = np.random.default_rng(seed)
    const = tc.SimulationConstants(dx=0.05, cfl=0.5)
    kern = tc.make_kernel(tc.KernelFamily[family], dims, dx=const.dx)
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * const.dx] * dims),
                                  indexing="ij"), axis=-1).reshape(-1, dims)[:n]
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * const.dx
    pos -= pos.mean(axis=0)
    dens = rng.uniform(990, 1040, size=n)
    vel = rng.normal(0, 0.5, size=(n, dims))
    ptype = rng.choice([1, 2], size=n, p=[0.8, 0.2]).astype(np.int32)
    cap = capacity or n
    inputs = (pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1))
    velp = np.zeros((cap, dims))
    velp[:n] = vel
    p = t_alloc(*inputs, device="cpu", dtype=torch.float64, capacity=cap)
    p = p.replace(velocity=torch.as_tensor(velp))
    p = p.replace(pressure=teq.pressure(p.density, const))
    grid = tcl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = tcl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs, (inputs, velp, cap)


def _spec(const, kern, visc, diff, full=True):
    return TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel[visc],
                 diffusion=tc.DensityDiffusionModel[diff],
                 shifting=tc.ShiftingMode.PLANAR if full else tc.ShiftingMode.NONE,
                 kernel_output=(tc.KernelOutputMode.STORE if full
                                else tc.KernelOutputMode.NONE))


def _oracle(family, kern, const, visc, diff, p, full=True):
    return brute_force_sweep(
        kernel_family="wendland" if family == "WENDLAND_C2" else "cubic",
        kern=kern, const=const,
        viscosity=tc.ViscosityModel[visc].value,
        diffusion=tc.DensityDiffusionModel[diff].value,
        shifting=full, kernel_output=full,
        cells=p.cell.numpy(), pos=p.position.numpy(), dens=p.density.numpy(),
        pres=p.pressure.numpy(), vel=p.velocity.numpy(),
        ml=p.motion_limiter.numpy(), active=p.active.numpy(),
    )


def _sweep(spec, grid, p, cs, block_size=64):
    return pair_sweep(spec, grid, block_size, p, cs, p.position, p.density,
                      p.pressure, p.velocity)


VISC = ["ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS"]
DIFF = ["ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX"]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("visc", VISC)
@pytest.mark.parametrize("diff", DIFF)
def test_sweep_matches_brute_force(dims, visc, diff):
    const, kern, grid, p, cs, _ = _setup(dims, n=120 if dims == 2 else 140)
    out = _sweep(_spec(const, kern, visc, diff), grid, p, cs)
    ref = _oracle("WENDLAND_C2", kern, const, visc, diff, p)
    # test_sweep.py's bands: XLA/torch pow vs numpy in the COMPLEX 7th root
    if diff == "COMPLEX":
        rtol, atol = 1e-5, 2e-6 * float(np.abs(ref["drhodt"]).max())
    else:
        rtol, atol = 1e-10, 1e-8
    np.testing.assert_allclose(out.drhodt.numpy(), ref["drhodt"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(out.acceleration.numpy(), ref["acc"], rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(out.kernel_w.numpy(), ref["kernel_w"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out.kernel_grad.numpy(), ref["kernel_grad"],
                               rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(out.grad_c.numpy(), ref["grad_c"], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out.div_r.numpy(), ref["div_r"], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dims", [2, 3])
def test_sweep_cubic_spline(dims):
    const, kern, grid, p, cs, _ = _setup(dims, n=120, family="CUBIC_SPLINE")
    out = _sweep(_spec(const, kern, "ARTIFICIAL", "LINEAR", full=False), grid, p, cs)
    ref = _oracle("CUBIC_SPLINE", kern, const, "ARTIFICIAL", "LINEAR", p, full=False)
    np.testing.assert_allclose(out.drhodt.numpy(), ref["drhodt"], rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(out.acceleration.numpy(), ref["acc"], rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("dims,visc,diff,family", [
    (2, "ARTIFICIAL", "LINEAR", "WENDLAND_C2"),
    (3, "ARTIFICIAL", "LINEAR", "WENDLAND_C2"),
    (2, "ARTIFICIAL", "LINEAR", "CUBIC_SPLINE"),
    (3, "LAMINAR_SPS", "COMPLEX", "WENDLAND_C2"),
])
def test_sweep_matches_jax_pair_sweep(dims, visc, diff, family):
    """Same inputs through JAX ``pair_sweep`` (with inactive padding rows);
    the chunk size differs from the JAX block size on purpose."""
    const, kern, grid, p, cs, (inputs, velp, cap) = _setup(
        dims, n=120, family=family, capacity=136)
    full = visc != "ARTIFICIAL"
    out = pair_sweep(_spec(const, kern, visc, diff, full), grid, 50, p, cs,
                     p.position, p.density, p.pressure, p.velocity)

    jconst = jc.SimulationConstants(dx=0.05, cfl=0.5)
    jkern = jc.make_kernel(jc.KernelFamily[family], dims, dx=0.05)
    jp = j_alloc(*inputs, dtype=jnp.float64, capacity=cap)
    jp = jp.replace(velocity=jnp.asarray(velp))
    jp = jp.replace(pressure=jeq.pressure(jp.density, jconst))
    jgrid = jcl.Grid(cmin=grid.cmin, shape=grid.shape)
    jsp, jcs, _ = jcl.rebuild(jp, jkern.H_inv, jgrid)
    jspec = JSpec(constants=jconst, kernel=jkern,
                  viscosity=jc.ViscosityModel[visc],
                  diffusion=jc.DensityDiffusionModel[diff],
                  shifting=jc.ShiftingMode.PLANAR if full else jc.ShiftingMode.NONE,
                  kernel_output=(jc.KernelOutputMode.STORE if full
                                 else jc.KernelOutputMode.NONE))
    ref = j_pair_sweep(jspec, jgrid, 3 * 64, 64, jsp, jcs, jsp.position,
                       jsp.density, jsp.pressure, jsp.velocity)
    rtol, atol = (1e-5, 2e-6 * float(np.abs(np.asarray(ref.drhodt)).max())) \
        if diff == "COMPLEX" else (1e-10, 1e-8)
    np.testing.assert_allclose(out.drhodt.numpy(), np.asarray(ref.drhodt),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(out.acceleration.numpy(), np.asarray(ref.acceleration),
                               rtol=1e-10, atol=1e-8)
    for f in ("kernel_w", "kernel_grad", "grad_c", "div_r"):
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-8)
    assert not out.drhodt[120:].any() and not out.acceleration[120:].any()


def test_momentum_conservation():
    """Pair forces are equal and opposite: total momentum change vanishes."""
    const, kern, grid, p, cs, _ = _setup(2, n=200)
    out = _sweep(_spec(const, kern, "ARTIFICIAL", "ZERO", full=False), grid, p, cs)
    assert np.allclose(out.acceleration.numpy().sum(axis=0), 0.0, atol=1e-8)
