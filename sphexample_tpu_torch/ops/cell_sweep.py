"""The cell-centric neighbor sweep, every model and mode: the CUDA kernel's
wrapper and its plain version (the counterpart of
``sphexample_tpu/ops/pallas_sweep.py``).

:func:`cell_sweep` has the signature of ``ops.block_sweep.block_sweep`` and
returns the same ``SweepOut``.  It takes the kernel ``csrc/cell_sweep.cu``
for CUDA tensors - a list of the occupied pairs of x-adjacent cells built on
the device, then one warp per listed pair at a time, its candidates staged in
shared memory for all its selves (:func:`cell_schedule` is that schedule in
plain PyTorch) - and the plain PyTorch sweep
(``interactions.pair_sweep``, the same math on the same inputs) only for CPU
tensors.  A CUDA tensor launches the kernel or raises: there is no fallback.
:func:`cell_sweep_window` is the kernel on a self window of a longer candidate
array, :func:`cell_sweep_sharded` on one slab of a sharded run (the
counterpart of ``pallas_pair_sweep_sharded``).

Which of the two sweeps a run takes, on one device or sharded, is decided in
one place: ``core/driver.py:choose_sweep_kernel``.  Both
sweeps compute every model and mode, with the pair physics of
``csrc/sph_pair_math.cuh``; the params' model members and the column order
of the output are shared (``block_sweep.MODEL_FIELDS``, ``collect``).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import KernelOutputMode, ShiftingMode, ViscosityModel
from ..state import Particles
from .block_sweep import (MODEL_FIELDS, WARP, Schedule, _pass_union, collect,
                          model_params, n_sums, sweep_fields, sweep_sharded)
from .cell_list import Grid
from .interactions import PhysicsSpec, SweepOut, pair_sweep


class CellSweepParams(ctypes.Structure):
    """Mirror of ``struct CellSweepParams`` in csrc/cell_sweep.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("self_off", ctypes.c_int),
        ("ncells", ctypes.c_int),
        ("shape", ctypes.c_int * 3),
        ("strides", ctypes.c_int * 3),
    ] + MODEL_FIELDS


def kernel_variant(spec: PhysicsSpec, dims: int) -> int:
    """The kernel's template instance: every model and mode has one, only
    ``dims`` outside (2, 3) raises ``NotImplementedError``."""
    if dims not in (2, 3):
        raise NotImplementedError(f"the CUDA cell sweep does not compute dims={dims}")
    return ((dims == 3) << 3
            | (spec.viscosity is ViscosityModel.LAMINAR_SPS) << 2
            | (spec.kernel_output is KernelOutputMode.STORE) << 1
            | (spec.shifting is ShiftingMode.PLANAR))


def sweep_params(spec: PhysicsSpec, grid: Grid, n: int, self_off: int = 0) -> CellSweepParams:
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [1] * (3 - len(v))))  # noqa: E731
    return CellSweepParams(
        n=n, self_off=self_off, ncells=grid.ncells, shape=pad(grid.shape),
        strides=pad(grid.strides), **model_params(spec))


def cell_schedule(grid: Grid, cell_start, n: int, self_off: int = 0) -> Schedule:
    """The cell kernel's passes: the groups are the cells (2q, 2q + 1) of each
    x row (the last alone in a row of odd length) with self rows in
    ``[self_off, self_off + n)``, listed in ascending order (the kernel's
    list holds the same groups; its warps take them in any order); a group's
    selves are swept 32 at a time.  A self's own cell is the one of the pair
    whose rows hold it."""
    dev = cell_start.device
    cs = cell_start.long()
    nx = grid.shape[0]
    half = (nx + 1) // 2
    q = torch.arange((grid.ncells // nx) * half, device=dev)
    c = torch.div(q, half, rounding_mode="floor") * nx + 2 * (q % half)
    width = torch.clamp(nx - c % nx, max=2)
    lo = torch.clamp(cs[c], min=self_off)
    hi = torch.clamp(cs[c + width], max=self_off + n)
    listed = lo < hi
    first, glo, ghi = c[listed], lo[listed], hi[listed]
    npass = torch.div(ghi - glo + WARP - 1, WARP, rounding_mode="floor")
    poff = torch.cumsum(npass, 0) - npass
    # each self row's group (the last group starting at or before it), if it
    # lies inside that group's rows
    i = self_off + torch.arange(n, device=dev)
    g = torch.clamp(torch.searchsorted(glo, i, right=True) - 1, min=0)
    if first.numel() == 0:          # nothing listed: one stand-in group, no row in it
        first, glo, ghi, poff = (t.new_zeros(1) for t in (first, glo, ghi, poff))
    inside = (i >= glo[g]) & (i < ghi[g])
    pass_of = torch.where(inside, poff[g] + torch.div(i - glo[g], WARP, rounding_mode="floor"),
                          -1)
    key = first[g] + (i >= cs[first[g] + 1]).long()
    own = torch.stack([cs[key], cs[key + 1]], dim=-1)
    x = key % nx
    x_range = torch.stack([torch.clamp(x - 1, min=0), torch.clamp(x + 1, max=nx - 1)], dim=-1)
    t = torch.div(torch.repeat_interleave(first[:npass.numel()], npass), nx,
                  rounding_mode="floor")
    if grid.dims == 3:
        pass_row = torch.stack([t % grid.shape[1],
                                torch.div(t, grid.shape[1], rounding_mode="floor")], dim=-1)
    else:
        pass_row = t[:, None]
    return Schedule(groups=int(listed.sum()), pass_of=pass_of, pass_row=pass_row,
                    pass_x=_pass_union(pass_of, x_range, int(npass.sum())),
                    x_range=x_range, own=own, cells=c[listed])


def cell_sweep_plain(spec: PhysicsSpec, grid: Grid, particles: Particles,
                     cell_start, position, density, pressure, velocity,
                     block_size: int = 1024, motion_limiter=None,
                     self_off: int = 0) -> SweepOut:
    """The plain version: ``pair_sweep`` on the same inputs, every mode (its
    inactive rows are zero and it computes in the state dtype, like the
    kernel's collected output); with ``motion_limiter`` / ``self_off`` on a
    window."""
    return pair_sweep(spec, grid, block_size, particles, cell_start,
                      position, density, pressure, velocity,
                      motion_limiter=motion_limiter, self_off=self_off)


def cell_sweep(spec: PhysicsSpec, grid: Grid, particles: Particles,
               cell_start, position, density, pressure, velocity,
               block_size: int = 1024) -> SweepOut:
    """One full neighbor sweep.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an exception."""
    return sweep_fields(kernel_variant, launch_pack, False, False, spec, grid,
                        particles, cell_start, position, density, pressure,
                        velocity, None, 0, block_size)


def cell_sweep_window(spec: PhysicsSpec, grid: Grid, particles: Particles,
                      cell_start, position, density, pressure, velocity,
                      motion_limiter, self_off: int,
                      block_size: int = 1024) -> SweepOut:
    """The sweep of the self rows ``[self_off, self_off + N)`` of extended
    fields (``Ne`` rows; ``particles`` holds the N self rows, ``cell_start``
    is rebased to the fields' rows).  CPU tensors: the plain version.  CUDA
    tensors: the kernel on the window, or an exception."""
    return sweep_fields(kernel_variant, launch_pack, False, True, spec, grid,
                        particles, cell_start, position, density, pressure,
                        velocity, motion_limiter, self_off, block_size)


def cell_sweep_sharded(spec: PhysicsSpec, grid: Grid, halo: int,
                       particles: Particles, cell_start, position, density,
                       pressure, velocity, ctx, block_size: int = 1024) -> SweepOut:
    """One slab's sweep through the cell kernel
    (``ops.block_sweep.sweep_sharded``)."""
    return sweep_sharded(kernel_variant, launch_pack, False, spec, grid, halo,
                         particles, cell_start, position, density, pressure,
                         velocity, ctx, block_size)


def launch_pack(spec, grid, particles, cell_start, pack, self_off: int, dtype) -> SweepOut:
    """Launch the kernel on a ready pack: selves are its rows ``[self_off,
    self_off + N)``, N the rows of ``particles`` (active)."""
    n, dims = particles.capacity, grid.dims
    variant = kernel_variant(spec, dims)
    if self_off < 0 or self_off + n > pack.shape[0]:
        raise ValueError(f"self rows [{self_off}, {self_off + n}) outside the "
                         f"pack's {pack.shape[0]} rows")
    dev = pack.device

    from ._build import load_library

    lib = load_library("cell_sweep")
    cs = cell_start.contiguous()
    # zero-filled: a row outside every cell range (inactive padding, or any
    # row while cell_start is still unbuilt) is in no group and stays zero
    out = torch.zeros((n, n_sums(spec, dims)), dtype=torch.float32, device=dev)
    params = sweep_params(spec, grid, n, self_off)
    # the kernel's list of occupied groups, filled on the device
    groups = torch.empty(lib.sph_cell_sweep_list_size(ctypes.addressof(params)),
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sph_cell_sweep(ctypes.addressof(params), variant, pack.data_ptr(),
                                 cs.data_ptr(), groups.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cell_sweep launch failed: "
                           f"{lib.sph_cell_sweep_error_string(err).decode()}")
    return collect(out, particles.active, dtype, dims, spec)
