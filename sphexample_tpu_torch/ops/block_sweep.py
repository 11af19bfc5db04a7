"""The neighbor sweep of every step: the CUDA kernel's wrapper and its plain
version (the counterpart of ``sphexample_tpu/ops/pallas_block_sweep.py``).

:func:`block_sweep` takes the kernel ``csrc/block_sweep.cu`` for CUDA
tensors and the plain PyTorch sweep (``interactions.pair_sweep``, the same
math on the same inputs) only for CPU tensors.  A CUDA tensor launches the
kernel or raises: there is no fallback.  ``launches`` counts the kernel
launches of this process.

Outputs are in cell-sorted order, masked by ``active`` and cast to the state
dtype (the counterpart of the JAX package's ``_collect``).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import (DensityDiffusionModel, KernelFamily, KernelOutputMode,
                      ShiftingMode, ViscosityModel)
from ..models.density_diffusion import linear_hydrostatic_constant
from ..models.kernels import W
from ..state import Particles
from .cell_list import Grid
from .interactions import PhysicsSpec, SweepOut, pair_sweep

# kernel launches in this process (chip_smoke.py resets and reads it)
launches = 0
# The largest particle capacity ``assemble_simulation`` gives to this sweep; above it a
# deck takes the cell sweep (ops/cell_sweep.py), as it does in the JAX
# package, whose block kernel encodes row offsets in 21 bits.  The CUDA
# kernel itself has no such limit (int32 indices).
BLOCK_CAP_LIMIT = 1 << 21


class SweepParams(ctypes.Structure):
    """Mirror of ``struct SweepParams`` in csrc/block_sweep.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("cmin", ctypes.c_int * 3),
        ("shape", ctypes.c_int * 3),
        ("strides", ctypes.c_int * 3),
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
        ("cubic_eps", ctypes.c_float),
        ("w_dx_inv", ctypes.c_float),
    ]


def kernel_variant(spec: PhysicsSpec, dims: int) -> int:
    """The kernel's template instance for this model set, or
    ``NotImplementedError`` naming what the kernel does not compute."""
    unsupported = []
    if dims not in (2, 3):
        unsupported.append(f"dims={dims}")
    if spec.viscosity not in (ViscosityModel.ZERO, ViscosityModel.ARTIFICIAL):
        unsupported.append(f"viscosity {spec.viscosity.name}")
    if spec.diffusion not in (DensityDiffusionModel.ZERO,
                              DensityDiffusionModel.LINEAR):
        unsupported.append(f"density diffusion {spec.diffusion.name}")
    if spec.shifting is not ShiftingMode.NONE:
        unsupported.append(f"shifting {spec.shifting.name}")
    if spec.kernel_output is not KernelOutputMode.NONE:
        unsupported.append(f"kernel output {spec.kernel_output.name}")
    if unsupported:
        raise NotImplementedError(
            "the CUDA block sweep does not compute " + ", ".join(unsupported)
            + "; SimulationMetaData(block_sweep=False) takes the cell sweep, "
            "which computes every model and mode")
    return ((dims == 3) << 3
            | (spec.kernel.family is KernelFamily.CUBIC_SPLINE) << 2
            | (spec.viscosity is ViscosityModel.ARTIFICIAL) << 1
            | (spec.diffusion is DensityDiffusionModel.LINEAR))


def sweep_params(spec: PhysicsSpec, grid: Grid, n: int) -> SweepParams:
    kern, c = spec.kernel, spec.constants
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [0] * (3 - len(v))))  # noqa: E731
    w_dx = float(W(kern, torch.tensor(c.dx, dtype=torch.float64)))
    return SweepParams(
        n=n, cmin=pad(grid.cmin), shape=pad(grid.shape),
        strides=pad(grid.strides),
        H2=kern.H2, h=kern.h, h_inv=kern.h_inv, eta2=kern.eta2,
        alpha_d=kern.alpha_d,
        wendland_fac=kern.alpha_d * 5.0 / (8.0 * kern.h * kern.h),
        m0=c.m0, alpha_c0=c.alpha * c.c0,
        diff_fac=c.delta_sph * kern.h * c.c0,
        C_lin=linear_hydrostatic_constant(c),
        cubic_eps=kern.cubic_eps,
        w_dx_inv=(1.0 / w_dx) if w_dx != 0.0 else 0.0,
    )


def pack_fields(position, velocity, density, pressure, ml):
    """Row-major f32 pack read by the kernel, float4-aligned rows:
    3D (x,y,z,rho)(vx,vy,vz,1/rho)(p,ml,0,0); 2D (x,y,vx,vy)(rho,1/rho,p,ml).
    Density is guarded (padding rows carry 1, never 0)."""
    dims = position.shape[1]
    rho = torch.where(density > 0, density, torch.ones_like(density))
    rcp = 1.0 / rho
    col = lambda a: a[:, None]  # noqa: E731
    if dims == 3:
        z = torch.zeros_like(rho)
        cols = [position, col(rho), velocity, col(rcp), col(pressure), col(ml),
                col(z), col(z)]
    else:
        cols = [position, velocity, col(rho), col(rcp), col(pressure), col(ml)]
    return torch.cat([a.to(torch.float32) for a in cols], dim=1).contiguous()


def collect(out, active, dtype, dims, spec: PhysicsSpec = None) -> SweepOut:
    """[N, K] kernel rows -> SweepOut, masked by ``active``, in ``dtype``.
    Columns: drho, dv/dt, then (STORE) W, grad W, then (PLANAR) grad C, div r;
    without ``spec`` only the first 1+D.  The mask is a select, never a
    product: rows that no thread wrote may hold anything."""
    vals = torch.where(active[:, None], out, torch.zeros_like(out)).to(dtype)
    k = 1 + dims
    fields = dict(drhodt=vals[:, 0], acceleration=vals[:, 1:k], kernel_w=None,
                  kernel_grad=None, grad_c=None, div_r=None)
    if spec is not None and spec.kernel_output is KernelOutputMode.STORE:
        fields.update(kernel_w=vals[:, k], kernel_grad=vals[:, k + 1:2 * k])
        k *= 2
    if spec is not None and spec.shifting is ShiftingMode.PLANAR:
        fields.update(grad_c=vals[:, k:k + dims], div_r=vals[:, k + dims])
    return SweepOut(**fields)


def check_inputs(grid: Grid, particles: Particles, cell_start, position, density,
                 pressure, velocity, reads_cell: bool) -> None:
    """Raise on what a sweep kernel does not take: a field on another device,
    of another shape or of another type than the kernel reads."""
    n, dims = position.shape
    if dims != grid.dims:
        raise ValueError(f"positions are {dims}D, the grid {grid.dims}D")
    dev = position.device
    fields = [("velocity", velocity, (n, dims)), ("density", density, (n,)),
              ("pressure", pressure, (n,)), ("active", particles.active, (n,)),
              ("motion_limiter", particles.motion_limiter, (n,)),
              ("cell_start", cell_start, (grid.ncells + 2,))]
    if reads_cell:
        fields.append(("cell", particles.cell, (n, dims)))
    for name, t, shape in fields:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, positions on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if cell_start.dtype != torch.int32 or (reads_cell
                                           and particles.cell.dtype != torch.int32):
        raise TypeError("cell and cell_start must be int32")
    if particles.active.dtype != torch.bool:
        raise TypeError("active must be bool")
    if not position.dtype.is_floating_point:
        raise TypeError(f"position must be floating point, not {position.dtype}")


def block_sweep_plain(spec: PhysicsSpec, grid: Grid, particles: Particles,
                      cell_start, position, density, pressure, velocity,
                      block_size: int = 1024) -> SweepOut:
    """The plain version: ``pair_sweep`` on the same inputs (its inactive
    rows are zero and it computes in the state dtype, like the kernel's
    collected output)."""
    return pair_sweep(spec, grid, block_size, particles, cell_start,
                      position, density, pressure, velocity)


def block_sweep(spec: PhysicsSpec, grid: Grid, particles: Particles,
                cell_start, position, density, pressure, velocity,
                block_size: int = 1024) -> SweepOut:
    """One full neighbor sweep.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an exception."""
    if position.device.type == "cpu":
        return block_sweep_plain(spec, grid, particles, cell_start, position,
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
                 velocity, reads_cell=True)
    dev = position.device

    from ._build import load_library

    lib = load_library("block_sweep")
    pack = pack_fields(position, velocity, density, pressure,
                       particles.motion_limiter)
    cell = particles.cell.contiguous()
    cs = cell_start.contiguous()
    act = particles.active.contiguous()
    out = torch.empty((n, dims + 1), dtype=torch.float32, device=dev)
    params = sweep_params(spec, grid, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sph_block_sweep(
            ctypes.addressof(params), variant, pack.data_ptr(), cell.data_ptr(),
            cs.data_ptr(), act.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"block_sweep launch failed: {lib.sph_error_string(err).decode()}")
    launches += 1
    return collect(out, particles.active, position.dtype, dims)
