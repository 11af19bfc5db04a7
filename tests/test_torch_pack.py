"""The input pack of both sweeps on the card (``ops/block_sweep.py:pack_fields``,
the kernel ``csrc/pack_fields.cu``): bit for bit the plain torch expression
(``pack_fields_plain``) on the same CUDA tensors and on the CPU, compared as
int32 words, in 2D and 3D, from f32 and f64 fields, for 1, 31, 4097 and
2^20 + 3 rows, with densities of 0, -0, below 0, NaN, +inf and denormal
among them; every sharded slab's sweep on the kernel's pack bit for bit the
sweep on the plain pack; the wrapper and the sweep entries' checks on CUDA
tensors; and the pack kernel's launches (``tests/kernel_launches.py``), one
a pack, as many as the sweep launches of eager steps.
A CUDA kernel has no CPU mode, so these tests are marked ``gpu`` and skip
without a card.  They import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_pack.py -q
"""

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.io.casegen import dam_break_3d
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops.interactions import PhysicsSpec
from sphexample_tpu_torch.parallel.context import CommContext, LocalGroup, run_ranks
from sphexample_tpu_torch.parallel.mesh import measure_halo, size_halo
from sphexample_tpu_torch.state import allocate_particles
from kernel_launches import Launches

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)
DX = 0.05
N_SLABS = 4
# densities the guard maps to 1 (0, -0, below 0, NaN), and kept ones whose
# reciprocal is 0 (+inf) or overflows (denormal in f32 or in f64)
SPECIAL = [0.0, -0.0, -3.0, float("nan"), float("inf"), 1e-40, 1e-310, 1e-45]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fields(n, dims, dtype, seed=0):
    """Random fields on the CPU: positions and velocities of both signs (a
    -0 among them), densities near 1000 with SPECIAL spread over the rows,
    pressures, a 0/1 motion limiter."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64, generator=g)
    pos = torch.randn(n, dims, **f64)
    vel = 0.5 * torch.randn(n, dims, **f64)
    dens = 990.0 + 50.0 * torch.rand(n, **f64)
    pres = 1e4 * torch.randn(n, **f64)
    ml = (torch.rand(n, **f64) > 0.3).double()
    k = min(n, len(SPECIAL))
    dens[torch.linspace(0, n - 1, k).long()] = torch.tensor(SPECIAL[:k], dtype=torch.float64)
    pos[0, 0] = vel[-1, -1] = pres[n // 2] = -0.0
    return [t.to(dtype) for t in (pos, vel, dens, pres, ml)]


def _words(pack):
    return pack.view(torch.int32)


@pytest.mark.parametrize("n", [1, 31, 4097, 2**20 + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [2, 3])
def test_pack_kernel_is_the_plain_expression_bit_for_bit(cuda, dims, dtype, n):
    cpu = _fields(n, dims, dtype, seed=n)
    dev = [t.to(cuda) for t in cpu]
    with Launches() as n_got:
        got = bs.pack_fields(*dev)
    assert n_got["pack"] == 1
    assert got.shape == (n, 4 * dims) and got.dtype == torch.float32 and got.is_contiguous()
    with Launches() as n_plain:
        plain = bs.pack_fields_plain(*dev)
    assert n_plain["pack"] == 0                # the plain version launches no pack kernel
    assert torch.equal(_words(got), _words(plain))
    assert torch.equal(_words(got.cpu()), _words(bs.pack_fields_plain(*cpu)))
    rho, rcp = (got[:, 3], got[:, 7]) if dims == 3 else (got[:, 4], got[:, 5])
    dens = cpu[2].to(cuda)
    assert (rho[~(dens > 0)] == 1).all() and (rcp[~(dens > 0)] == 1).all()
    if n >= len(SPECIAL):
        assert torch.isinf(rcp).any()          # a denormal's reciprocal overflows


def test_pack_wrapper_on_the_card(cuda):
    """On CUDA tensors the wrapper refuses a dtype the kernel has no instance
    for, copies a strided field to contiguous rows, and packs zero rows into
    an empty [0, 12] without a launch; the sweep entries' checks
    (``check_inputs``) refuse a field of another dtype before any pack."""
    pos, vel, dens, pres, ml = [t.to(cuda) for t in _fields(64, 3, torch.float32)]
    with Launches() as n_refused:
        with pytest.raises(TypeError, match="float32 or float64"):
            bs.pack_fields(*(t.half() for t in (pos, vel, dens, pres, ml)))
        assert bs.pack_fields(pos[:0], vel[:0], dens[:0], pres[:0], ml[:0]).shape == (0, 12)
    assert n_refused["pack"] == 0
    strided = torch.cat([pos, vel], dim=1)
    with Launches() as n_strided:
        got = bs.pack_fields(strided[:, :3], strided[:, 3:], dens, pres, ml)
    assert n_strided["pack"] == 1
    assert torch.equal(_words(got), _words(bs.pack_fields_plain(pos, vel, dens, pres, ml)))
    const, kern, grid, p64, cs, _ = _column(3)
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ARTIFICIAL,
                       diffusion=T.DensityDiffusionModel.LINEAR)
    p = p64.map(lambda a: (a.to(cuda, torch.float32) if a.is_floating_point()
                           else a.to(cuda)))
    with Launches() as n_checked:
        for sweep in (bs.block_sweep, cw.cell_sweep):
            with pytest.raises(TypeError, match="pressure is torch.float64"):
                sweep(spec, grid, p, cs.to(cuda), p.position, p.density,
                      p.pressure.double(), p.velocity)
    assert n_checked["pack"] == 0


def _column(dims, seed=0):
    """A jittered lattice column long in its last axis, fluid, fixed and
    moving rows and inactive padding, sorted in f64 on the CPU; its capacity
    a multiple of N_SLABS, the slab edges cutting cells."""
    rng = np.random.default_rng(seed)
    const = T.SimulationConstants(dx=DX, cfl=0.5)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, dims, dx=DX)
    shape = (5, 260) if dims == 2 else (3, 3, 150)
    coords = np.stack(np.meshgrid(*[np.arange(s) * DX for s in shape], indexing="ij"),
                      axis=-1).reshape(-1, dims)
    n = len(coords)
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * DX
    cap = -(-(n + 9) // N_SLABS) * N_SLABS
    ptype = rng.choice([1, 2, 3], size=n, p=[0.7, 0.2, 0.1]).astype(np.int32)
    p = allocate_particles(pos, rng.uniform(990, 1040, size=n), ptype,
                           np.ones(n, np.int32), np.arange(1, n + 1), device="cpu",
                           dtype=torch.float64, capacity=cap)
    vel = np.zeros((cap, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    p = p.replace(velocity=torch.as_tensor(vel), pressure=eq.pressure(p.density, const))
    grid = cl.grid_from_positions(pos, kern.H_inv, margin_cells=3)
    sp, cs, _ = cl.rebuild(p, kern.H_inv, grid)
    need = measure_halo(sp.position.numpy(), sp.active.numpy(), kern.H_inv, grid, N_SLABS,
                        cap)
    return const, kern, grid, sp, cs, size_halo(need, cap // N_SLABS)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kernel", ["block", "cell"])
def test_sharded_windows_sweep_the_kernels_pack(cuda, monkeypatch, dims, kernel):
    """``sweep_sharded`` on 4 slabs of the card (thread ranks), each slab's
    f32 pack made by the kernel and extended by the halo: one pack launch a
    slab, as many as the windowed sweep launches, and every slab's sweep bit
    for bit the sweep on the plain version's pack; for the 1-hop window and
    the whole gathered array (``halo = 0``)."""
    const, kern, grid, p64, cs, halo = _column(dims)
    assert halo > 0
    spec = PhysicsSpec(constants=const, kernel=kern, viscosity=T.ViscosityModel.ARTIFICIAL,
                       diffusion=T.DensityDiffusionModel.LINEAR)
    p = p64.map(lambda a: (a.to(cuda, torch.float32) if a.is_floating_point()
                           else a.to(cuda)))
    cs_g = cs.to(cuda)
    C = p.capacity // N_SLABS
    slabs = [p.map(lambda a, r=r: a[r * C:(r + 1) * C].clone()) for r in range(N_SLABS)]
    sharded = bs.block_sweep_sharded if kernel == "block" else cw.cell_sweep_sharded
    group = LocalGroup([cuda] * N_SLABS, timeout=120.0)

    def sweep(h):
        return run_ranks(group, lambda r: sharded(
            spec, grid, h, slabs[r], cs_g, slabs[r].position, slabs[r].density,
            slabs[r].pressure, slabs[r].velocity, CommContext(group, r), 64))

    for h in (halo, 0):
        with Launches() as n_got:
            got = sweep(h)
        assert n_got["pack"] == N_SLABS == n_got[f"{kernel}_window"] and n_got[kernel] == 0
        with Launches() as n_plain, monkeypatch.context() as m:
            m.setattr(bs, "pack_fields", bs.pack_fields_plain)
            want = sweep(h)
        assert n_plain["pack"] == 0 and n_plain[f"{kernel}_window"] == N_SLABS
        for r, (a, b) in enumerate(zip(got, want)):
            assert float(a.acceleration.abs().max()) > 0, r
            assert torch.equal(a.drhodt, b.drhodt) and torch.equal(
                a.acceleration, b.acceleration), (r, h)


def test_eager_steps_pack_before_every_sweep(cuda):
    """Eager steps of the main path: 2 pack launches a step, one before
    each sweep launch."""
    from sphexample_tpu_torch.core.step import sph_step

    pos, dens, ptype, grp, idp = dam_break_3d(DX)
    const = T.SimulationConstants(dx=DX, c0=33.14, alpha=0.1, m0=1000 * DX**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * DX**2)))
    meta = T.SimulationMetaData(simulation_name="gpu_pack", save_location=".", dims=3)
    sim = T.assemble_simulation(pos + 0.0037, dens, ptype, grp, idp, meta, const, kern,
                                T.ViscosityModel.ARTIFICIAL,
                                T.DensityDiffusionModel.LINEAR, device=cuda)
    state = sim.state
    dx = torch.full((), 1.0 + kern.h, dtype=state.total_time.dtype, device=cuda)
    with Launches() as n:
        for _ in range(3):
            state, dx = sph_step(sim.cfg, state, dx)
    assert n["block"] == 6 == n["pack"]
    assert torch.isfinite(state.particles.velocity).all()
