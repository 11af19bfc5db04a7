"""The port's block-sweep module on the CPU: its plain version against the
JAX package's TPU block sweep (``pallas_block_sweep`` in interpret mode) in
f32 with the 2e-5 tolerances of test_pallas_block.py, and the wrapper's
dispatch (CPU tensors -> plain version; every model set has an instance,
and what has none raises on the CUDA path, never falls back)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphexample_tpu.config as jc
import sphexample_tpu_torch.config as tc
from sphexample_tpu.models import equations as jeq
from sphexample_tpu.ops import cell_list as jcl
from sphexample_tpu.ops import pallas_block_sweep as pbs
from sphexample_tpu.ops.interactions import PhysicsSpec as JSpec
from sphexample_tpu.state import allocate_particles as j_alloc
from sphexample_tpu_torch.models import equations as teq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops.interactions import PhysicsSpec as TSpec
from sphexample_tpu_torch.state import allocate_particles as t_alloc

torch.set_num_threads(1)


def _inputs(dims=2, n=220, seed=3):
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


def _port(pos, dens, vel, ptype, cap, family="WENDLAND_C2", dtype=torch.float32):
    n, dims = pos.shape
    const = tc.SimulationConstants(dx=0.05, cfl=0.5)
    kern = tc.make_kernel(tc.KernelFamily[family], dims, dx=0.05)
    p = t_alloc(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                device="cpu", dtype=dtype, capacity=cap)
    velp = np.zeros((cap, dims))
    velp[:n] = vel
    p = p.replace(velocity=torch.as_tensor(velp, dtype=dtype))
    p = p.replace(pressure=teq.pressure(p.density, const))
    grid = tcl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = tcl.rebuild(p, kern.H_inv, grid)
    return const, kern, grid, sp, cs


def _args(spec, grid, p, cs):
    return (spec, grid, p, cs, p.position, p.density, p.pressure, p.velocity)


def test_plain_block_sweep_matches_pallas_interpret():
    pos, dens, vel, ptype = _inputs()
    cap = 1024
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, cap)
    spec = TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel.ARTIFICIAL,
                 diffusion=tc.DensityDiffusionModel.LINEAR)
    before = bs.launches
    out = bs.block_sweep(*_args(spec, grid, p, cs))
    assert bs.launches == before  # CPU tensors never launch the kernel
    assert out.drhodt.dtype == torch.float32

    n = len(dens)
    jconst = jc.SimulationConstants(dx=0.05, cfl=0.5)
    jkern = jc.make_kernel(jc.KernelFamily.WENDLAND_C2, 2, dx=0.05)
    jp = j_alloc(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                 dtype=jnp.float32, capacity=cap)
    velp = np.zeros((cap, 2))
    velp[:n] = vel
    jp = jp.replace(velocity=jnp.asarray(velp, dtype=jnp.float32))
    jp = jp.replace(pressure=jeq.pressure(jp.density, jconst))
    jgrid = jcl.Grid(cmin=grid.cmin, shape=grid.shape)
    jsp, jcs, _ = jcl.rebuild(jp, jkern.H_inv, jgrid)
    np.testing.assert_array_equal(np.asarray(jsp.id), p.id.numpy())
    jspec = JSpec(constants=jconst, kernel=jkern,
                  viscosity=jc.ViscosityModel.ARTIFICIAL,
                  diffusion=jc.DensityDiffusionModel.LINEAR)
    ref = pbs.pallas_block_sweep(jspec, jgrid, 2048, jsp, jcs, jsp.position,
                                 jsp.density, jsp.pressure, jsp.velocity,
                                 interpret=True)
    scale_d = float(np.abs(np.asarray(ref.drhodt)).max()) + 1e-6
    scale_a = float(np.abs(np.asarray(ref.acceleration)).max()) + 1e-6
    np.testing.assert_allclose(out.drhodt.numpy(), np.asarray(ref.drhodt),
                               rtol=2e-5, atol=2e-5 * scale_d)
    np.testing.assert_allclose(out.acceleration.numpy(), np.asarray(ref.acceleration),
                               rtol=2e-5, atol=2e-5 * scale_a)


def test_cpu_wrapper_is_the_plain_version():
    pos, dens, vel, ptype = _inputs(dims=3, n=150, seed=4)
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, 160, dtype=torch.float64)
    spec = TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel.ARTIFICIAL,
                 diffusion=tc.DensityDiffusionModel.LINEAR)
    before = bs.launches
    a = bs.block_sweep(*_args(spec, grid, p, cs))
    b = bs.block_sweep_plain(*_args(spec, grid, p, cs), block_size=7)
    assert bs.launches == before
    torch.testing.assert_close(a.drhodt, b.drhodt, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(a.acceleration, b.acceleration, rtol=1e-12, atol=1e-9)
    assert not a.drhodt[150:].any()


def test_pack_and_collect():
    pos, dens, vel, ptype = _inputs(dims=3, n=40, seed=5)
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, 48)
    pack = bs.pack_fields(p.position, p.velocity, p.density, p.pressure,
                          p.motion_limiter)
    assert pack.shape == (48, 12) and pack.dtype == torch.float32
    assert (pack[:, 3] > 0).all()  # guarded density, padding rows carry 1
    torch.testing.assert_close(pack[:, 7], 1.0 / pack[:, 3])
    out = torch.randn(48, 4)
    col = bs.collect(out, p.active, torch.float64, 3)
    assert col.drhodt.dtype == torch.float64 and col.acceleration.shape == (48, 3)
    assert not col.acceleration[~p.active].any()
    torch.testing.assert_close(col.drhodt[p.active], out[p.active, 0].double())


@pytest.mark.parametrize("visc,diff,family,dims,ok", [
    ("ARTIFICIAL", "LINEAR", "WENDLAND_C2", 3, 11),
    ("ARTIFICIAL", "LINEAR", "WENDLAND_C2", 2, 3),
    ("ZERO", "ZERO", "CUBIC_SPLINE", 3, 12),
    ("ARTIFICIAL", "ZERO", "CUBIC_SPLINE", 2, 6),
    ("LAMINAR", "LINEAR", "WENDLAND_C2", 3, 24),
    ("ARTIFICIAL", "COMPLEX", "WENDLAND_C2", 3, 24),
    ("LAMINAR_SPS", "ZERO_GRAVITY_LINEAR", "WENDLAND_C2", 2, 20),
])
def test_kernel_variants_and_unsupported_models(visc, diff, family, dims, ok):
    """Every model set has an instance (16-31: the run-time models, SPS
    pinned); only a dimension outside (2, 3) is refused, on the CUDA path
    before touching data or building anything."""
    const = tc.SimulationConstants(dx=0.05)
    kern = tc.make_kernel(tc.KernelFamily[family], dims, dx=0.05)
    spec = TSpec(constants=const, kernel=kern, viscosity=tc.ViscosityModel[visc],
                 diffusion=tc.DensityDiffusionModel[diff])
    assert bs.kernel_variant(spec, dims) == ok
    # a stand-in for a CUDA tensor of another dimension
    fake = types.SimpleNamespace(device=torch.device("cuda"), shape=(64, 4))
    with pytest.raises(NotImplementedError, match="dims=4"):
        bs.block_sweep(spec, None, None, None, fake, None, None, None)


def test_modes_without_kernel_raise_on_cuda_path():
    """PLANAR and STORE map to instances of their own (K = 8 and 12 sums in
    3D); a dimension outside (2, 3) is what has no kernel, and raises."""
    const = tc.SimulationConstants(dx=0.05)
    kern = tc.make_kernel(tc.KernelFamily.WENDLAND_C2, 3, dx=0.05)
    for extra, variant, k in ((dict(shifting=tc.ShiftingMode.PLANAR), 25, 8),
                              (dict(kernel_output=tc.KernelOutputMode.STORE), 26, 8),
                              (dict(shifting=tc.ShiftingMode.PLANAR,
                                    kernel_output=tc.KernelOutputMode.STORE), 27, 12)):
        spec = TSpec(constants=const, kernel=kern,
                     viscosity=tc.ViscosityModel.ARTIFICIAL,
                     diffusion=tc.DensityDiffusionModel.LINEAR, **extra)
        assert bs.kernel_variant(spec, 3) == variant
        assert bs.n_sums(spec, 3) == k
        with pytest.raises(NotImplementedError, match="dims=1"):
            bs.kernel_variant(spec, 1)


def test_sweep_params_layout():
    const = tc.SimulationConstants(dx=0.0085, c0=33.14, alpha=0.1)
    kern = tc.make_kernel(tc.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3) * 0.0085))
    spec = TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel.ARTIFICIAL,
                 diffusion=tc.DensityDiffusionModel.LINEAR)
    grid = tcl.Grid(cmin=(-6, -6, -6), shape=(67, 36, 28))
    prm = bs.sweep_params(spec, grid, 159712)
    import ctypes

    # 14 ints (n, self_off, cmin, shape, strides, family, viscosity,
    # diffusion), then 18 floats
    assert ctypes.sizeof(prm) == 14 * 4 + 18 * 4
    assert (prm.family, prm.viscosity, prm.diffusion) == (0, 1, 2)
    assert prm.self_off == 0 and bs.sweep_params(spec, grid, 39936, 33664).self_off == 33664
    assert list(prm.strides) == [1, 67, 67 * 36] and prm.n == 159712
    assert prm.alpha_c0 == pytest.approx(0.1 * 33.14)
