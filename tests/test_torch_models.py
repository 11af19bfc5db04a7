"""f64 parity of the port's model functions with the JAX package's on random
pair batches (rtol 1e-12; the COMPLEX diffusion band of test_sweep.py for
the 7th-root inverse EOS, whose pow differs between libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu.config as jc
import sphexample_tpu_torch.config as tc
from sphexample_tpu.models import density_diffusion as jdd
from sphexample_tpu.models import equations as jeq
from sphexample_tpu.models import kernels as jk
from sphexample_tpu.models import viscosity as jv
from sphexample_tpu_torch.models import density_diffusion as tdd
from sphexample_tpu_torch.models import equations as teq
from sphexample_tpu_torch.models import kernels as tk
from sphexample_tpu_torch.models import viscosity as tv

torch.set_num_threads(1)
RTOL = 1e-12


def _kernels(family, dims, dx=0.05):
    return (jc.make_kernel(jc.KernelFamily[family], dims, dx=dx),
            tc.make_kernel(tc.KernelFamily[family], dims, dx=dx))


def _consts(**kw):
    kw = dict(dx=0.05, cfl=0.5, **kw)
    return jc.SimulationConstants(**kw), tc.SimulationConstants(**kw)


def _pairs(dims, n=400, seed=0):
    """Random pair batch inside the support of a dx=0.05 kernel."""
    rng = np.random.default_rng(seed)
    xij = rng.uniform(-0.19, 0.19, size=(n, dims))
    vij = rng.normal(0, 0.5, size=(n, dims))
    rho_i = rng.uniform(990, 1040, n)
    rho_j = rng.uniform(990, 1040, n)
    ml_i = rng.choice([0.0, 1.0], n)
    ml_j = rng.choice([0.0, 1.0], n)
    role = rng.random(n) < 0.5
    return xij, vij, rho_i, rho_j, ml_i, ml_j, role


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("dims", [2, 3])
def test_kernel_w_gradw_tensile(family, dims):
    jkern, tkern = _kernels(family, dims)
    xij = _pairs(dims)[0]
    d = np.sqrt((xij**2).sum(-1))
    q = np.clip(d * jkern.h_inv, 0.0, 2.0)
    _close(jk.W(jkern, jnp.asarray(q)), tk.W(tkern, torch.as_tensor(q)))
    _close(jk.grad_W(jkern, jnp.asarray(q), jnp.asarray(xij)),
           tk.grad_W(tkern, torch.as_tensor(q), torch.as_tensor(xij)), atol=1e-300)
    rng = np.random.default_rng(1)
    P_i, P_j = rng.normal(0, 2e3, (2, len(q)))
    rho_i, rho_j = rng.uniform(990, 1040, (2, len(q)))
    args = [P_i, rho_i, P_j, rho_j, q]
    _close(jk.tensile_correction(jkern, *map(jnp.asarray, args), 0.05),
           tk.tensile_correction(tkern, *map(torch.as_tensor, args), 0.05))


def test_equations():
    jcst, tcst = _consts(c0=33.14)
    rng = np.random.default_rng(2)
    rho = rng.uniform(950, 1050, 500)
    rho[:5] = 0.0  # padding rows
    drho = rng.normal(0, 50, 500)
    rho_half = rho + rng.normal(0, 1, 500)
    rho_half[:3] = 0.0
    ml = rng.choice([0.0, 1.0], 500)
    J, T = jnp.asarray, torch.as_tensor
    _close(jeq.pressure(J(rho), jcst), teq.pressure(T(rho), tcst))
    _close(jeq.equation_of_state(J(rho), 33.14, 7.0, 1000.0),
           teq.equation_of_state(T(rho), 33.14, 7.0, 1000.0))
    _close(jeq.density_epsi(J(rho), J(drho), J(rho_half), 1e-4),
           teq.density_epsi(T(rho), T(drho), T(rho_half), 1e-4))
    _close(jeq.limit_density_at_boundary(J(rho), 1000.0, J(ml)),
           teq.limit_density_at_boundary(T(rho), 1000.0, T(ml)))
    tmpl = rng.normal(size=(500, 3))
    _close(jeq.gravity_vector_last_axis(J(tmpl), J(drho)),
           teq.gravity_vector_last_axis(T(tmpl), T(drho)))
    P = rng.normal(0, 2e5, 500)
    P[0] = -1.5 * jcst.Cb  # negative EOS argument: odd root
    # the 7th root's pow differs between XLA and torch: the COMPLEX band
    a = jeq.inverse_hydrostatic_eos(1000.0, J(P), jcst.Cb_inv)
    _close(a, teq.inverse_hydrostatic_eos(1000.0, T(P), tcst.Cb_inv),
           rtol=1e-5, atol=2e-6 * float(np.abs(np.asarray(a)).max()))


@pytest.mark.parametrize("model", ["ZERO", "ARTIFICIAL", "LAMINAR", "LAMINAR_SPS"])
@pytest.mark.parametrize("dims", [2, 3])
def test_viscosity(model, dims):
    jkern, tkern = _kernels("WENDLAND_C2", dims)
    jcst, tcst = _consts(alpha=0.1, c0=30.0)
    xij, vij, rho_i, rho_j, *_ = _pairs(dims, seed=3)
    d2 = (xij**2).sum(-1)
    q = np.clip(np.sqrt(d2) * jkern.h_inv, 0.0, 2.0)
    gw = np.array(jk.grad_W(jkern, jnp.asarray(q), jnp.asarray(xij)))
    args = [xij, vij, gw, d2, rho_i, rho_j]
    a = jv.compute_viscosity(jc.ViscosityModel[model], jkern, jcst,
                             *map(jnp.asarray, args))
    b = tv.compute_viscosity(tc.ViscosityModel[model], tkern, tcst,
                             *map(torch.as_tensor, args))
    _close(a, b, atol=1e-14 * float(np.abs(np.asarray(a)).max() + 1e-300))


@pytest.mark.parametrize("model", ["ZERO", "ZERO_GRAVITY_LINEAR", "LINEAR", "COMPLEX"])
@pytest.mark.parametrize("dims", [2, 3])
def test_density_diffusion(model, dims):
    jkern, tkern = _kernels("WENDLAND_C2", dims)
    jcst, tcst = _consts(c0=30.0)
    xij, _, rho_i, rho_j, ml_i, ml_j, role = _pairs(dims, seed=4)
    d2 = (xij**2).sum(-1)
    q = np.clip(np.sqrt(d2) * jkern.h_inv, 0.0, 2.0)
    gw = np.array(jk.grad_W(jkern, jnp.asarray(q), jnp.asarray(xij)))
    args = [xij, gw, d2, rho_i, rho_j, ml_i, ml_j, role]
    a = np.asarray(jdd.compute_density_diffusion(
        jc.DensityDiffusionModel[model], jkern, jcst, *map(jnp.asarray, args)))
    b = tdd.compute_density_diffusion(
        tc.DensityDiffusionModel[model], tkern, tcst, *map(torch.as_tensor, args))
    if model == "COMPLEX":
        _close(a, b, rtol=1e-5, atol=2e-6 * float(np.abs(a).max()))
    else:
        _close(a, b, atol=1e-14 * float(np.abs(a).max() + 1e-300))
    assert tdd.linear_hydrostatic_constant(tcst) == jdd.linear_hydrostatic_constant(jcst)
