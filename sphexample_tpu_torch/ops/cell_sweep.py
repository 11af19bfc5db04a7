"""The cell-centric neighbor sweep, every model and mode: the CUDA kernel's
wrapper and its plain version (the counterpart of
``sphexample_tpu/ops/pallas_sweep.py``).

:func:`cell_sweep` has the signature of ``ops.block_sweep.block_sweep`` and
returns the same ``SweepOut``.  It takes the kernel ``csrc/cell_sweep.cu``
for CUDA tensors - one thread block per grid cell, the candidates of a cell
staged in shared memory for all its selves - and the plain PyTorch sweep
(``interactions.pair_sweep``, the same math on the same inputs) only for CPU
tensors.  A CUDA tensor launches the kernel or raises: there is no fallback.
``launches`` counts the kernel launches of this process.

``assemble_simulation`` takes this sweep when ``meta.block_sweep`` is False or the particle
capacity exceeds ``block_sweep.BLOCK_CAP_LIMIT`` (``core/driver.py``); it is
the only one of the two that computes LAMINAR, LAMINAR_SPS,
ZERO_GRAVITY_LINEAR, COMPLEX, PLANAR shifting and STORE on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import (DensityDiffusionModel, KernelFamily, KernelOutputMode,
                      ShiftingMode, ViscosityModel)
from ..models.density_diffusion import linear_hydrostatic_constant
from ..models.kernels import W
from ..state import Particles
from .block_sweep import check_inputs, collect, pack_fields
from .cell_list import Grid
from .interactions import PhysicsSpec, SweepOut, pair_sweep

# kernel launches in this process (chip_smoke.py resets and reads it)
launches = 0

# the enum values of csrc/cell_sweep.cu and csrc/sph_kernel_functions.cuh
_FAMILY = {KernelFamily.WENDLAND_C2: 0, KernelFamily.CUBIC_SPLINE: 1}
_VISCOSITY = {ViscosityModel.ZERO: 0, ViscosityModel.ARTIFICIAL: 1,
              ViscosityModel.LAMINAR: 2, ViscosityModel.LAMINAR_SPS: 3}
_DIFFUSION = {DensityDiffusionModel.ZERO: 0,
              DensityDiffusionModel.ZERO_GRAVITY_LINEAR: 1,
              DensityDiffusionModel.LINEAR: 2, DensityDiffusionModel.COMPLEX: 3}


class CellSweepParams(ctypes.Structure):
    """Mirror of ``struct CellSweepParams`` in csrc/cell_sweep.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("ncells", ctypes.c_int),
        ("shape", ctypes.c_int * 3),
        ("strides", ctypes.c_int * 3),
        ("family", ctypes.c_int),
        ("viscosity", ctypes.c_int),
        ("diffusion", ctypes.c_int),
        ("H2", ctypes.c_float),
        ("h", ctypes.c_float),
        ("h_inv", ctypes.c_float),
        ("eta2", ctypes.c_float),
        ("alpha_d", ctypes.c_float),
        ("wendland_fac", ctypes.c_float),
        ("m0", ctypes.c_float),
        ("alpha_c0", ctypes.c_float),
        ("diff_fac", ctypes.c_float),
        ("C_lin", ctypes.c_float),
        ("rho0", ctypes.c_float),
        ("rho0_g", ctypes.c_float),
        ("Cb_inv", ctypes.c_float),
        ("lam_fac", ctypes.c_float),
        ("cs2_dx2", ctypes.c_float),
        ("blin_dx2", ctypes.c_float),
        ("cubic_eps", ctypes.c_float),
        ("w_dx_inv", ctypes.c_float),
    ]


def n_sums(spec: PhysicsSpec, dims: int) -> int:
    """K = (1+D)(1 + STORE + PLANAR) f32 sums per self: drho, dv/dt, then
    W, grad W, then grad C, div r."""
    return (1 + dims) * (1 + (spec.kernel_output is KernelOutputMode.STORE)
                         + (spec.shifting is ShiftingMode.PLANAR))


def kernel_variant(spec: PhysicsSpec, dims: int) -> int:
    """The kernel's template instance: every model and mode has one, only
    ``dims`` outside (2, 3) raises ``NotImplementedError``."""
    if dims not in (2, 3):
        raise NotImplementedError(f"the CUDA cell sweep does not compute dims={dims}")
    return ((dims == 3) << 3
            | (spec.viscosity is ViscosityModel.LAMINAR_SPS) << 2
            | (spec.kernel_output is KernelOutputMode.STORE) << 1
            | (spec.shifting is ShiftingMode.PLANAR))


def sweep_params(spec: PhysicsSpec, grid: Grid, n: int) -> CellSweepParams:
    kern, c = spec.kernel, spec.constants
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [1] * (3 - len(v))))  # noqa: E731
    w_dx = float(W(kern, torch.tensor(c.dx, dtype=torch.float64)))
    return CellSweepParams(
        n=n, ncells=grid.ncells, shape=pad(grid.shape), strides=pad(grid.strides),
        family=_FAMILY[kern.family], viscosity=_VISCOSITY[spec.viscosity],
        diffusion=_DIFFUSION[spec.diffusion],
        H2=kern.H2, h=kern.h, h_inv=kern.h_inv, eta2=kern.eta2,
        alpha_d=kern.alpha_d,
        wendland_fac=kern.alpha_d * 5.0 / (8.0 * kern.h * kern.h),
        m0=c.m0, alpha_c0=c.alpha * c.c0,
        diff_fac=c.delta_sph * kern.h * c.c0,
        C_lin=linear_hydrostatic_constant(c),
        rho0=c.rho0, rho0_g=c.rho0 * c.g, Cb_inv=c.Cb_inv,
        lam_fac=4.0 * c.m0 * c.nu0,
        cs2_dx2=(c.smagorinsky_constant * c.dx) ** 2,
        blin_dx2=c.blin_constant * c.dx * c.dx,
        cubic_eps=kern.cubic_eps,
        w_dx_inv=(1.0 / w_dx) if w_dx != 0.0 else 0.0,
    )


def cell_sweep_plain(spec: PhysicsSpec, grid: Grid, particles: Particles,
                     cell_start, position, density, pressure, velocity,
                     block_size: int = 1024) -> SweepOut:
    """The plain version: ``pair_sweep`` on the same inputs, every mode (its
    inactive rows are zero and it computes in the state dtype, like the
    kernel's collected output)."""
    return pair_sweep(spec, grid, block_size, particles, cell_start,
                      position, density, pressure, velocity)


def cell_sweep(spec: PhysicsSpec, grid: Grid, particles: Particles,
               cell_start, position, density, pressure, velocity,
               block_size: int = 1024) -> SweepOut:
    """One full neighbor sweep.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an exception."""
    if position.device.type == "cpu":
        return cell_sweep_plain(spec, grid, particles, cell_start, position,
                                density, pressure, velocity, block_size)
    if position.device.type != "cuda":
        raise ValueError(f"unsupported device {position.device}")
    return _launch(spec, grid, particles, cell_start, position, density,
                   pressure, velocity)


def _launch(spec, grid, particles, cell_start, position, density, pressure,
            velocity) -> SweepOut:
    global launches
    n, dims = position.shape
    variant = kernel_variant(spec, dims)
    check_inputs(grid, particles, cell_start, position, density, pressure,
                 velocity, reads_cell=False)
    dev = position.device

    from ._build import load_library

    lib = load_library("cell_sweep")
    pack = pack_fields(position, velocity, density, pressure,
                       particles.motion_limiter)
    cs = cell_start.contiguous()
    # zero-filled: a row outside every cell range (inactive padding, or any
    # row while cell_start is still unbuilt) gets no block and stays zero
    out = torch.zeros((n, n_sums(spec, dims)), dtype=torch.float32, device=dev)
    params = sweep_params(spec, grid, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sph_cell_sweep(ctypes.addressof(params), variant, pack.data_ptr(),
                                 cs.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cell_sweep launch failed: "
                           f"{lib.sph_cell_sweep_error_string(err).decode()}")
    launches += 1
    return collect(out, particles.active, position.dtype, dims, spec)
