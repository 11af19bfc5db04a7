"""The block sweep in every model and mode, on the CPU: the port's
``block_sweep`` (CPU tensors: its plain version) against the JAX package's
TPU block sweep (``pallas_block_sweep`` in interpret mode) with PLANAR
shifting and kernel output STORE on, in f32 with the tolerances of
test_pallas_block.py, and at the MovingSquare deck's k = sqrt 2 against the
JAX package's XLA sweep; ``kernel_variant`` against the instances that
``csrc/block_sweep.cu`` lists; and the ctypes mirrors of both sweeps' params
against the structs of their CUDA sources."""

import itertools
import re
from pathlib import Path

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
from sphexample_tpu.ops.interactions import pair_sweep as j_pair_sweep
from sphexample_tpu.ops.pallas_sweep import pallas_pair_sweep
from sphexample_tpu.state import allocate_particles as j_alloc
from sphexample_tpu_torch.models import equations as teq
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as tcl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops.interactions import PhysicsSpec as TSpec
from sphexample_tpu_torch.state import allocate_particles as t_alloc
from kernel_launches import forbid_kernels

torch.set_num_threads(1)
CSRC = Path(bs.__file__).resolve().parent.parent / "csrc"
DX = 0.05


def _states(dims, family, k=None, n=220, seed=3, cap=1024):
    """test_pallas_block.py's jittered lattice (random densities, velocities
    and types), as the port's and the JAX package's sorted f32 states on one
    grid."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / dims)))
    coords = np.stack(np.meshgrid(*([np.arange(side) * DX] * dims), indexing="ij"),
                      axis=-1).reshape(-1, dims)[:n]
    pos = coords + rng.uniform(-0.4, 0.4, size=(n, dims)) * DX
    pos -= pos.mean(axis=0)
    dens = rng.uniform(990, 1040, size=n)
    vel = np.zeros((cap, dims))
    vel[:n] = rng.normal(0, 0.5, size=(n, dims))
    ptype = rng.choice([1, 2], size=n).astype(np.int32)
    kw = {} if k is None else dict(k=k)

    tconst = tc.SimulationConstants(dx=DX, cfl=0.5)
    tkern = tc.make_kernel(tc.KernelFamily[family], dims, dx=DX, **kw)
    p = t_alloc(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                device="cpu", dtype=torch.float32, capacity=cap)
    p = p.replace(velocity=torch.as_tensor(vel, dtype=torch.float32))
    p = p.replace(pressure=teq.pressure(p.density, tconst))
    grid = tcl.grid_from_positions(pos, tkern.H_inv, margin_cells=3)
    tp, tcs, _ = tcl.rebuild(p, tkern.H_inv, grid)

    jconst = jc.SimulationConstants(dx=DX, cfl=0.5)
    jkern = jc.make_kernel(jc.KernelFamily[family], dims, dx=DX, **kw)
    jp = j_alloc(pos, dens, ptype, np.ones(n, np.int32), np.arange(1, n + 1),
                 dtype=jnp.float32, capacity=cap)
    jp = jp.replace(velocity=jnp.asarray(vel, dtype=jnp.float32))
    jp = jp.replace(pressure=jeq.pressure(jp.density, jconst))
    jgrid = jcl.Grid(cmin=grid.cmin, shape=grid.shape)
    jsp, jcs, _ = jcl.rebuild(jp, jkern.H_inv, jgrid)
    np.testing.assert_array_equal(np.asarray(jsp.id), tp.id.numpy())
    return (tconst, tkern, grid, tp, tcs), (jconst, jkern, jgrid, jsp, jcs)


def _specs(dims, visc, diff, family, k):
    """Both packages' specs with PLANAR shifting and kernel output STORE on,
    and their states."""
    (tconst, tkern, grid, p, cs), (jconst, jkern, jgrid, jp, jcs) = _states(dims, family, k)
    tspec = TSpec(constants=tconst, kernel=tkern, viscosity=tc.ViscosityModel[visc],
                  diffusion=tc.DensityDiffusionModel[diff],
                  shifting=tc.ShiftingMode.PLANAR,
                  kernel_output=tc.KernelOutputMode.STORE)
    jspec = JSpec(constants=jconst, kernel=jkern, viscosity=jc.ViscosityModel[visc],
                  diffusion=jc.DensityDiffusionModel[diff],
                  shifting=jc.ShiftingMode.PLANAR,
                  kernel_output=jc.KernelOutputMode.STORE)
    return tspec, jspec, (grid, p, cs), (jgrid, jp, jcs)


def _assert_close(out, ref):
    """test_pallas_block.py:65-94, field by field."""
    def close(a, b, atol, rtol=2e-5):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)

    def scale(b):
        return float(np.abs(np.asarray(b)).max())

    close(out.drhodt, ref.drhodt, 2e-5 * (scale(ref.drhodt) + 1e-6))
    close(out.acceleration, ref.acceleration, 2e-5 * (scale(ref.acceleration) + 1e-6))
    close(out.kernel_w, ref.kernel_w, 1e-4)
    close(out.kernel_grad, ref.kernel_grad, 2e-5 * (scale(ref.kernel_grad) + 1e-6))
    close(out.grad_c, ref.grad_c, 2e-5 * (scale(ref.grad_c) + 1e-6))
    close(out.div_r, ref.div_r, 1e-4)


@pytest.mark.parametrize("dims,visc,diff,family,k", [
    # the five model sets of test_pallas_block.py:103-116
    (2, "ARTIFICIAL", "LINEAR", "WENDLAND_C2", None),
    (2, "LAMINAR_SPS", "ZERO_GRAVITY_LINEAR", "WENDLAND_C2", None),
    (2, "ZERO", "ZERO", "WENDLAND_C2", None),
    (2, "ARTIFICIAL", "COMPLEX", "WENDLAND_C2", None),
    (2, "ARTIFICIAL", "LINEAR", "CUBIC_SPLINE", None),
    # the MovingSquare deck's models (examples/moving_square_2d.py:65-73);
    # its k = sqrt 2 in the next test
    (2, "LAMINAR_SPS", "LINEAR", "WENDLAND_C2", None),
    (3, "LAMINAR", "COMPLEX", "WENDLAND_C2", None),
])
def test_block_sweep_every_mode_matches_pallas_interpret(dims, visc, diff, family, k,
                                                        monkeypatch):
    tspec, jspec, (grid, p, cs), (jgrid, jp, jcs) = _specs(dims, visc, diff, family, k)
    forbid_kernels(monkeypatch)  # CPU tensors never launch the kernel
    out = bs.block_sweep(tspec, grid, p, cs, p.position, p.density, p.pressure,
                         p.velocity)
    assert bs.kernel_variant(tspec, dims) >= 16
    ref = pbs.pallas_block_sweep(jspec, jgrid, 2048, jp, jcs, jp.position, jp.density,
                                 jp.pressure, jp.velocity, interpret=True)
    _assert_close(out, ref)
    assert float(np.abs(np.asarray(ref.kernel_w)).max()) > 0
    assert not out.drhodt[220:].any()


def test_moving_square_models_at_k_sqrt2_match_the_jax_sweep():
    """The MovingSquare deck's model set with its kernel, Wendland C2 at
    k = sqrt 2, against the JAX package's XLA ``pair_sweep`` (its reference
    path, held against the Julia reference by test_trajectory.py).  The JAX
    TPU kernels are not the yardstick here: their gradient factor takes the
    support to end at q = 2 (``_grad_w_factor`` clamps min(q - 2, 0), the d2
    cutoff only when k = 2), so they add the pairs at sqrt 2 < q < 2 to every
    gradient sum.  Pinned for the block and the cell-pair kernel, so that the
    difference stays on record: their W sums agree, their accelerations do
    not."""
    tspec, jspec, (grid, p, cs), (jgrid, jp, jcs) = _specs(
        2, "LAMINAR_SPS", "LINEAR", "WENDLAND_C2", float(np.sqrt(2)))
    out = bs.block_sweep(tspec, grid, p, cs, p.position, p.density, p.pressure,
                         p.velocity)
    ref = j_pair_sweep(jspec, jgrid, 256, 64, jp, jcs, jp.position, jp.density,
                       jp.pressure, jp.velocity)
    _assert_close(out, ref)
    block = pbs.pallas_block_sweep(jspec, jgrid, 2048, jp, jcs, jp.position, jp.density,
                                   jp.pressure, jp.velocity, interpret=True)
    cell = pallas_pair_sweep(jspec, jgrid, 64, 256, min(jgrid.ncells, jp.capacity), jp,
                             jcs, jp.position, jp.density, jp.pressure, jp.velocity,
                             interpret=True)
    acc_ref = np.asarray(ref.acceleration)
    for tpu in (block, cell):
        np.testing.assert_allclose(np.asarray(tpu.kernel_w), np.asarray(ref.kernel_w),
                                   rtol=2e-5, atol=1e-4)
        acc = np.asarray(tpu.acceleration)
        assert np.abs(acc - acc_ref).max() > 1e-2 * np.abs(acc_ref).max()


def _sph_cases(source):
    return {int(v) for v in re.findall(r"^\s*SPH_CASE\((\d+),", source, flags=re.M)}


@pytest.mark.parametrize("dims", [2, 3])
def test_every_model_set_maps_to_a_listed_instance(dims):
    """Every viscosity x diffusion x family x shifting x kernel output has an
    instance; the instances reached are exactly the ``SPH_CASE`` numbers of
    csrc/block_sweep.cu for this dimension, each model set pinned at compile
    time (0-15) reaching its own."""
    listed = _sph_cases((CSRC / "block_sweep.cu").read_text())
    assert listed == set(range(32))
    const = tc.SimulationConstants(dx=DX)
    seen = {}
    for family, visc, diff, shift, out in itertools.product(
            tc.KernelFamily, tc.ViscosityModel, tc.DensityDiffusionModel,
            tc.ShiftingMode, tc.KernelOutputMode):
        spec = TSpec(constants=const, kernel=tc.make_kernel(family, dims, dx=DX),
                     viscosity=visc, diffusion=diff, shifting=shift, kernel_output=out)
        v = bs.kernel_variant(spec, dims)
        seen.setdefault(v, []).append((family, visc, diff, shift, out))
    assert set(seen) == {v for v in listed if ((v >> 3) & 1) == (dims == 3)}
    assert len(seen) == 16
    pinned = [v for v in seen if v < 16]
    assert len(pinned) == 8 and all(len(seen[v]) == 1 for v in pinned)


def _struct_fields(source, name):
    """(field, count) of ``struct <name>`` in a CUDA source, in order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, source, flags=re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(int|float)\s+(\w+)(?:\[(\d+)\])?;", line)
        if m:
            fields.append((m.group(1), m.group(2), int(m.group(3) or 1)))
    return fields


def _mirror_fields(cls):
    import ctypes

    out = []
    for fname, ctype in cls._fields_:
        count = getattr(ctype, "_length_", 1)
        base = ctype._type_ if count > 1 else ctype
        out.append(({ctypes.c_int: "int", ctypes.c_float: "float"}[base], fname, count))
    return out


@pytest.mark.parametrize("source,struct,mirror", [
    ("block_sweep.cu", "SweepParams", bs.SweepParams),
    ("cell_sweep.cu", "CellSweepParams", cw.CellSweepParams),
])
def test_params_mirror_the_cuda_struct(source, struct, mirror):
    """A mismatch between a struct and its ctypes mirror gives wrong numbers
    with no error: names, types, array lengths and order must agree."""
    fields = _struct_fields((CSRC / source).read_text(), struct)
    assert len(fields) >= 20
    assert fields == _mirror_fields(mirror)
