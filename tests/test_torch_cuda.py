"""The CUDA block sweep on the card: every template instance of
``csrc/block_sweep.cu`` against the plain sweep in f64, the wrapper's input
checks, and a short run of the main path.  A CUDA kernel has no CPU mode, so
these tests are marked ``gpu`` and skip without a card.  They import no JAX,
so they also run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.io.casegen import dam_break_3d
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops.interactions import PhysicsSpec
from sphexample_tpu_torch.state import Particles, allocate_particles

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
    laminar = dataclasses.replace(spec, viscosity=T.ViscosityModel.LAMINAR)
    with pytest.raises(NotImplementedError, match="LAMINAR"):
        bs.block_sweep(*_args(laminar, grid, p, cs))
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
