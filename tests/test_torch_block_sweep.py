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
from kernel_launches import forbid_kernels

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


def test_plain_block_sweep_matches_pallas_interpret(monkeypatch):
    pos, dens, vel, ptype = _inputs()
    cap = 1024
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, cap)
    spec = TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel.ARTIFICIAL,
                 diffusion=tc.DensityDiffusionModel.LINEAR)
    forbid_kernels(monkeypatch)  # CPU tensors never launch the kernel
    out = bs.block_sweep(*_args(spec, grid, p, cs))
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


def test_cpu_wrapper_is_the_plain_version(monkeypatch):
    pos, dens, vel, ptype = _inputs(dims=3, n=150, seed=4)
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, 160, dtype=torch.float64)
    spec = TSpec(constants=const, kernel=kern,
                 viscosity=tc.ViscosityModel.ARTIFICIAL,
                 diffusion=tc.DensityDiffusionModel.LINEAR)
    forbid_kernels(monkeypatch)
    a = bs.block_sweep(*_args(spec, grid, p, cs))
    b = bs.block_sweep_plain(*_args(spec, grid, p, cs), block_size=7)
    torch.testing.assert_close(a.drhodt, b.drhodt, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(a.acceleration, b.acceleration, rtol=1e-12, atol=1e-9)
    assert not a.drhodt[150:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [2, 3])
def test_pack_and_collect(dims, dtype, monkeypatch):
    """Every column of the pack against its source field, in both layouts:
    3D (x,y,z,rho)(vx,vy,vz,1/rho)(p,ml,+0,+0), 2D (x,y,vx,vy)(rho,1/rho,p,ml),
    the density guarded (padding rows, 0, -0, negative and NaN carry 1), each
    value rounded to f32 from the fields' dtype; then the collect."""
    pos, dens, vel, ptype = _inputs(dims=dims, n=40, seed=5)
    const, kern, grid, p, cs = _port(pos, dens, vel, ptype, 48, dtype=dtype)
    rho = p.density.clone()
    rho[[0, 1, 2, 3]] = torch.tensor([0.0, -0.0, -3.0, float("nan")], dtype=dtype)
    forbid_kernels(monkeypatch)  # CPU tensors never launch the kernel
    pack = bs.pack_fields(p.position, p.velocity, rho, p.pressure, p.motion_limiter)
    assert pack.shape == (48, 4 * dims) and pack.dtype == torch.float32
    assert pack.is_contiguous()
    guarded = torch.where(rho > 0, rho, torch.ones_like(rho))
    # the four rows set above and the padding rows (density 0) carry 1
    assert (guarded[:4] == 1).all() and (guarded[40:] == 1).all()
    f32 = lambda a: a.to(torch.float32)  # noqa: E731
    if dims == 3:
        cols = {(0, 3): p.position, (3, 4): guarded[:, None], (4, 7): p.velocity,
                (7, 8): 1.0 / guarded[:, None], (8, 9): p.pressure[:, None],
                (9, 10): p.motion_limiter[:, None], (10, 12): torch.zeros(48, 2)}
    else:
        cols = {(0, 2): p.position, (2, 4): p.velocity, (4, 5): guarded[:, None],
                (5, 6): 1.0 / guarded[:, None], (6, 7): p.pressure[:, None],
                (7, 8): p.motion_limiter[:, None]}
    assert sum(b - a for a, b in cols) == 4 * dims
    for (a, b), field in cols.items():
        assert torch.equal(pack[:, a:b], f32(field)), (a, b)
    if dims == 3:
        assert not torch.signbit(pack[:, 10:]).any()   # +0, never -0
    out = torch.randn(48, 1 + dims)
    col = bs.collect(out, p.active, torch.float64, dims)
    assert col.drhodt.dtype == torch.float64 and col.acceleration.shape == (48, dims)
    assert not col.acceleration[~p.active].any()
    torch.testing.assert_close(col.drhodt[p.active], out[p.active, 0].double())


def test_the_cpu_pack_is_the_plain_one(monkeypatch):
    """On CPU tensors the pack is the plain version and loads no kernel."""
    forbid_kernels(monkeypatch)
    pos, dens, vel, ptype = _inputs(dims=3, n=30, seed=2)
    _, _, _, p, _ = _port(pos, dens, vel, ptype, 32)
    args = (p.position, p.velocity, p.density, p.pressure, p.motion_limiter)
    calls = []
    real = bs.pack_fields_plain
    monkeypatch.setattr(bs, "pack_fields_plain", lambda *a: calls.append(1) or real(*a))
    assert torch.equal(bs.pack_fields(*args), real(*args))
    assert calls == [1]


@pytest.mark.parametrize("case,error,match", [
    ("half", TypeError, "positions must be float32 or float64, not torch.float16"),
    ("int", TypeError, "positions must be float32 or float64, not torch.int32"),
    ("velocity_dtype", TypeError, "velocity is torch.float64, positions torch.float32"),
    ("pressure_dtype", TypeError, "pressure is torch.float64, positions torch.float32"),
    ("ml_dtype", TypeError, "motion_limiter is torch.float16, positions torch.float32"),
    ("density_shape", ValueError, "density has shape"),
    ("ml_device", ValueError, "motion_limiter is on meta"),
])
def test_sweep_checks_refuse_what_the_kernels_and_the_pack_do_not_take(case, error, match):
    """``check_inputs``, which every CUDA sweep entry runs before its pack and
    its launch, refuses positions that are not float32 or float64, a field of
    another dtype than the positions (the pack kernel reads all five in one
    dtype), and a field of another shape or device; f32 and f64 pass."""
    pos, dens, vel, ptype = _inputs(dims=3, n=30, seed=2)
    for dtype in (torch.float32, torch.float64):
        _, _, grid, p, cs = _port(pos, dens, vel, ptype, 32, dtype=dtype)
        bs.check_inputs(grid, p, cs, p.position, p.density, p.pressure, p.velocity,
                        reads_cell=True)
    _, _, grid, p, cs = _port(pos, dens, vel, ptype, 32)
    f = dict(position=p.position, density=p.density, pressure=p.pressure,
             velocity=p.velocity, motion_limiter=p.motion_limiter)
    if case in ("half", "int"):
        f = {k: v.to(torch.float16 if case == "half" else torch.int32) for k, v in f.items()}
    elif case == "velocity_dtype":
        f["velocity"] = f["velocity"].double()
    elif case == "pressure_dtype":
        f["pressure"] = f["pressure"].double()
    elif case == "ml_dtype":
        f["motion_limiter"] = f["motion_limiter"].half()
    elif case == "density_shape":
        f["density"] = torch.ones(33)
    else:
        f["motion_limiter"] = torch.ones(32, device="meta")
    with pytest.raises(error, match=match):
        bs.check_inputs(grid, p, cs, reads_cell=True, **f)


def test_pack_of_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: a dtype the kernel has no
    instance for raises before any build or launch, and the plain version
    (the torch.cat) is never called; any other device raises."""
    forbid_kernels(monkeypatch)
    monkeypatch.setattr(bs, "pack_fields_plain",
                        lambda *a: pytest.fail("a non-CPU tensor reached the plain pack"))
    fake = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float16,
                                 shape=(64, 3))
    with pytest.raises(TypeError, match="float32 or float64 fields, not torch.float16"):
        bs.pack_fields(fake, None, None, None, None)
    meta = [torch.zeros(8, 3, device="meta")] * 2 + [torch.zeros(8, device="meta")] * 3
    with pytest.raises(ValueError, match="unsupported device meta"):
        bs.pack_fields(*meta)


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
