"""The ghost-node moment sums of mDBC: the CUDA kernel's wrapper and its plain
version (the counterpart of ``sphexample_tpu/ops/pallas_mdbc.py``).

For every ghost point g the sums over the fluid particles j within the
support radius of g (reference ``SPHCellList.jl:319-365``)::

    b = sum_j m0 [W, grad W]                       [D+1]
    A = sum_j [V_j W, V_j grad W] (x) [1, -x_gj]   [D+1, D+1],  V_j = m0 / rho_j

with x_gj = g - x_j.  Candidates are the 3^(D-1) stencil rows x 3 x-adjacent
cells around the ghost's cell, read from the stale ``cell_start`` of the last
rebuild; the ghost's cell is computed fresh from the ghost point and clamped
into the grid.  The closed-form solve and the decision tree stay outside
(``ops/mdbc.py``).  The candidate arrays may be a slab's halo-extended window
(``ops/halo.py``) with ``cell_start`` rebased to it: the ghost's cell comes
from the ghost point and the global grid, so only the row ranges shift, and
neither version needs to know.

:func:`mdbc_moments` takes the kernel ``csrc/mdbc_moments.cu`` for CUDA
tensors and the plain PyTorch version only for CPU tensors.  A CUDA tensor
launches the kernel or raises: there is no fallback.  ``launches`` counts the
kernel launches of this process.  The kernel reads the f32 position, density
and motion limiter directly (the fluid test, the density guard and V_j are
computed in its body; any other dtype is cast first) and sums in f32; its
moments are cast to the state dtype before the solve.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..config import KernelFamily
from ..models import kernels as K
from .cell_list import Grid, cell_coords, clamp_coords, row_segments
from .interactions import PhysicsSpec, candidates

# kernel launches in this process (chip_smoke.py resets and reads it); under
# a lock, since the slabs of a sharded run are threads
launches = 0
_count_lock = threading.Lock()
# ghosts per gather of the plain version: bounds its transient footprint
GHOST_CHUNK = 4096


class MdbcParams(ctypes.Structure):
    """Mirror of ``struct MdbcParams`` in csrc/mdbc_moments.cu."""

    _fields_ = [
        ("nb", ctypes.c_int),
        ("cmin", ctypes.c_int * 3),
        ("shape", ctypes.c_int * 3),
        ("strides", ctypes.c_int * 3),
        ("H2", ctypes.c_float),
        ("H_inv", ctypes.c_float),
        ("h_inv", ctypes.c_float),
        ("eta2", ctypes.c_float),
        ("alpha_d", ctypes.c_float),
        ("wendland_fac", ctypes.c_float),
        ("m0", ctypes.c_float),
    ]


def n_moments(dims: int) -> int:
    """K = (D+1) + (D+1)^2 scalars per ghost: 12 in 2D, 20 in 3D."""
    return (dims + 1) * (dims + 2)


def mdbc_moments_plain(spec: PhysicsSpec, grid: Grid, gpoint, gvalid, position,
                       density, motion_limiter, cell_start):
    """The plain version: gather every ghost's candidates, keep the fluid
    ones inside the support, sum.  Returns (bvec [B, D+1], Amat [B, D+1,
    D+1]) in the caller's ghost order and the dtype of ``position``; invalid
    slots give zeros.  Ghosts are processed ``GHOST_CHUNK`` at a time to bound
    the gather footprint; a chunk's candidate list is exact (no fixed window)."""
    kern, c = spec.kernel, spec.constants
    B, dims = gpoint.shape
    dp = dims + 1
    dev, dtype = position.device, position.dtype
    bvec = torch.zeros((B, dp), dtype=dtype, device=dev)
    Amat = torch.zeros((B, dp * dp), dtype=dtype, device=dev)
    gcoords = clamp_coords(cell_coords(gpoint, kern.H_inv), grid)
    starts, ends = row_segments(gcoords, grid, cell_start)            # [B, S]
    for b0 in range(0, B, GHOST_CHUNK):
        i, j = candidates(starts, ends, b0, min(b0 + GHOST_CHUNK, B))
        xij = gpoint[i] - position[j]                  # ghost -> particle
        d2 = torch.sum(xij * xij, dim=-1)
        # fluid-only (ml == 1 <=> FLUID, the allocation rule of state.py),
        # inclusive support cutoff, valid ghost slots only
        within = (motion_limiter[j] > 0.5) & (d2 <= kern.H2) & gvalid[i]
        i, j, xij, d2 = i[within], j[within], xij[within], d2[within]
        q = torch.clamp(torch.sqrt(d2) * kern.h_inv, 0.0, 2.0)
        w = K.W(kern, q)
        grad_w = K.grad_W(kern, q, xij)
        rho_j = density[j]
        rho_j = torch.where(rho_j > 0, rho_j, torch.ones_like(rho_j))
        vj = c.m0 / rho_j
        # b = sum m0 [W, gradW]  (reference SPHCellList.jl:351)
        bvec.index_add_(0, i, c.m0 * torch.cat([w[:, None], grad_w], dim=-1))
        # A = sum outer([Vj W, Vj gradW], [1, -x_gj])  (reference :353-359)
        fc = vj[:, None] * torch.cat([w[:, None], grad_w], dim=-1)
        e = torch.cat([torch.ones_like(w)[:, None], -xij], dim=-1)
        Amat.index_add_(0, i, (fc[:, :, None] * e[:, None, :]).reshape(-1, dp * dp))
    return bvec, Amat.reshape(B, dp, dp)


def mdbc_moments(spec: PhysicsSpec, grid: Grid, gpoint, gvalid, position,
                 density, motion_limiter, cell_start):
    """(bvec, Amat) of every ghost slot.  CPU tensors: the plain version.
    CUDA tensors: the kernel, or an exception."""
    if position.device.type == "cpu":
        return mdbc_moments_plain(spec, grid, gpoint, gvalid, position, density,
                                  motion_limiter, cell_start)
    if position.device.type != "cuda":
        raise ValueError(f"unsupported device {position.device}")
    return _launch(spec, grid, gpoint, gvalid, position, density,
                   motion_limiter, cell_start)


def kernel_variant(spec: PhysicsSpec, dims: int) -> int:
    """The kernel's template instance, or ``NotImplementedError`` naming
    what the kernel does not compute."""
    if dims not in (2, 3):
        raise NotImplementedError(f"the CUDA mDBC kernel does not compute dims={dims}")
    family = spec.kernel.family
    if family not in (KernelFamily.WENDLAND_C2, KernelFamily.CUBIC_SPLINE):
        raise NotImplementedError(
            f"the CUDA mDBC kernel does not compute kernel family {family.name}")
    return (dims == 3) << 1 | (family is KernelFamily.CUBIC_SPLINE)


def moment_params(spec: PhysicsSpec, grid: Grid, nb: int) -> MdbcParams:
    kern = spec.kernel
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [0] * (3 - len(v))))  # noqa: E731
    return MdbcParams(
        nb=nb, cmin=pad(grid.cmin), shape=pad(grid.shape), strides=pad(grid.strides),
        H2=kern.H2, H_inv=kern.H_inv, h_inv=kern.h_inv, eta2=kern.eta2,
        alpha_d=kern.alpha_d,
        wendland_fac=kern.alpha_d * 5.0 / (8.0 * kern.h * kern.h),
        m0=spec.constants.m0,
    )


def _launch(spec, grid, gpoint, gvalid, position, density, motion_limiter,
            cell_start):
    global launches
    n, dims = position.shape
    B = gpoint.shape[0]
    variant = kernel_variant(spec, dims)
    if dims != grid.dims:
        raise ValueError(f"positions are {dims}D, the grid {grid.dims}D")
    dev = position.device
    for name, t, shape in (("gpoint", gpoint, (B, dims)), ("gvalid", gvalid, (B,)),
                           ("density", density, (n,)),
                           ("motion_limiter", motion_limiter, (n,)),
                           ("cell_start", cell_start, (grid.ncells + 2,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, positions on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if cell_start.dtype != torch.int32:
        raise TypeError("cell_start must be int32")
    if gvalid.dtype != torch.bool:
        raise TypeError("gvalid must be bool")
    if not (position.dtype.is_floating_point and gpoint.dtype.is_floating_point):
        raise TypeError("position and gpoint must be floating point")

    from ._build import load_library

    lib = load_library("mdbc_moments")
    kdim = n_moments(dims)
    out = torch.empty((B, kdim), dtype=torch.float32, device=dev)
    if B > 0:
        # the kernel reads the state arrays as they are: an f32 state is
        # passed through without a copy
        f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
        ghost, pos = f32(gpoint), f32(position)
        rho, ml = f32(density), f32(motion_limiter)
        valid = gvalid.contiguous()
        cs = cell_start.contiguous()
        params = moment_params(spec, grid, B)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sph_mdbc_moments(
                ctypes.addressof(params), variant, ghost.data_ptr(),
                valid.data_ptr(), pos.data_ptr(), rho.data_ptr(), ml.data_ptr(),
                cs.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("mdbc_moments launch failed: "
                               f"{lib.sph_mdbc_error_string(err).decode()}")
        with _count_lock:
            launches += 1
    vals = out.to(position.dtype)
    dp = dims + 1
    return vals[:, :dp], vals[:, dp:].reshape(B, dp, dp)
