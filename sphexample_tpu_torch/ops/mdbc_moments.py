"""The ghost-node moment sums of mDBC and the correction behind them: the
CUDA kernel's wrappers and the plain versions (the counterpart of
``sphexample_tpu/ops/pallas_mdbc.py``).

For every ghost point g the sums over the fluid particles j within the
support radius of g (reference ``SPHCellList.jl:319-365``)::

    b = sum_j m0 [W, grad W]                       [D+1]
    A = sum_j [V_j W, V_j grad W] (x) [1, -x_gj]   [D+1, D+1],  V_j = m0 / rho_j

with x_gj = g - x_j.  Candidates are the 3^(D-1) stencil rows x 3 x-adjacent
cells around the ghost's cell, read from the stale ``cell_start`` of the last
rebuild; the ghost's cell is computed fresh from the ghost point and clamped
into the grid.  The candidate arrays may be a slab's halo-extended window
(``ops/halo.py``) with ``cell_start`` rebased to it: the ghost's cell comes
from the ghost point and the global grid, so only the row ranges shift, and
neither version needs to know.

The kernel ``csrc/mdbc_moments.cu`` groups the ghosts by cell on the device
and stages each cell's candidates once for all of its ghosts.  It runs in two
modes, one C call each:

* :func:`mdbc_moments` - the moments of every slot (invalid slots give
  zeros); the plain version :func:`mdbc_moments_plain` for CPU tensors;
* :func:`mdbc_correct` - stage 04 fused: the moments of the slots of the
  compacted list, then the Cramer solve and the decision tree of
  ``ops/mdbc.py:_mdbc_apply`` in the state's dtype, written into a copy of
  the density.  Fill slots and invalid slots are parked (no work), and so
  are dry slots, whose stencil holds no fluid row (their sums would be +0:
  the grouping writes what the solve would); CUDA tensors only
  (``ops/mdbc.py:correct_density`` takes the plain path for CPU tensors).

A CUDA tensor launches the kernel or raises: there is no fallback.  A call
launches four grouping kernels and then the moment kernel.  The
kernel reads the f32 position, density and motion limiter (any other dtype is
cast first) and sums in f32.  :func:`ghost_groups` is the plain mirror of the
grouping, for the tests and for ``chip_smoke.py``'s counts.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import KernelFamily
from ..models import kernels as K
from .cell_list import Grid, cell_coords, clamp_coords, linearize, row_segments
from .interactions import PhysicsSpec, candidates

# ghosts per gather of the plain version: bounds its transient footprint
GHOST_CHUNK = 4096
DET_THRESHOLD = 1e-3     # |det A| below it: Shepard or keep (reference :606)
# the kernel's schedule (constants of csrc/mdbc_moments.cu): ghosts per work
# entry, stencil rows staged per entry, ghosts an entry needs to stage
CHUNK, STAGE_ROWS, MIN_STAGE = 32, 2048, 2


class MdbcParams(ctypes.Structure):
    """Mirror of ``struct MdbcParams`` in csrc/mdbc_moments.cu."""

    _fields_ = [
        ("nb", ctypes.c_int),
        ("ncells", ctypes.c_int),
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
        ("rho0", ctypes.c_double),
        ("det_threshold", ctypes.c_double),
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
    CUDA tensors: the kernel in moments mode, or an exception."""
    if position.device.type == "cpu":
        return mdbc_moments_plain(spec, grid, gpoint, gvalid, position, density,
                                  motion_limiter, cell_start)
    B, dims = gpoint.shape
    _check(spec, grid, gpoint, gvalid, position, density, motion_limiter, cell_start,
           (B, dims))
    out = torch.empty((B, n_moments(dims)), dtype=torch.float32, device=position.device)
    if B > 0:
        f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
        _launch(spec, grid, B, f32(gpoint), None, gvalid, position, density,
                motion_limiter, cell_start, moments=out)
    vals = out.to(position.dtype)
    dp = dims + 1
    return vals[:, :dp], vals[:, dp:].reshape(B, dp, dp)


def mdbc_correct(spec: PhysicsSpec, grid: Grid, particles, bidx, bvalid, position,
                 density, motion_limiter, cell_start, moments: bool = False):
    """Stage 04 in one C call: the corrected density of the rows ``bidx``
    (the compacted list of ``particles``, ``ops/mdbc.py:compact_ghosts``)
    against the candidate arrays ``position``, ``density``,
    ``motion_limiter`` - the particles' own, or a slab's halo-extended
    window with ``cell_start`` rebased to it.  Returns (density: a new
    array, the particles' density with the corrected rows written;
    decision [B] int8: 0 keep, 1 Shepard, 2 solve, and 0 for a parked slot;
    the [B, K] f32 moments when ``moments``, zeros on parked slots, else
    None).  Fill slots (b > 0 indexing row 0) and invalid slots are parked:
    no work, nothing written.  Each row's density is the one the unfused
    path (:func:`mdbc_moments`, then ``_mdbc_apply``) gives, bit for bit.
    The epilogue runs in the particles' dtype (f32 or f64).  CUDA tensors
    only."""
    ghost, own_pos, own_rho = particles.ghost_points, particles.position, particles.density
    B, dims = bidx.shape[0], own_pos.shape[1]
    _check(spec, grid, bidx, bvalid, position, density, motion_limiter, cell_start, (B,))
    for name, t in (("ghost_points", ghost), ("particles.position", own_pos),
                    ("particles.density", own_rho)):
        if t.device != position.device:
            raise ValueError(f"{name} is on {t.device}, positions on {position.device}")
        if t.dtype != own_pos.dtype or t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} is {t.dtype}: the particles' fields must be one of "
                            "float32 / float64 together")
    if bidx.dtype != torch.int64:
        raise TypeError("bidx must be int64")
    if ghost.shape != own_pos.shape or own_rho.shape != own_pos.shape[:1]:
        raise ValueError("ghost_points, position and density of the particles disagree "
                         f"in shape: {tuple(ghost.shape)}, {tuple(own_pos.shape)}, "
                         f"{tuple(own_rho.shape)}")
    out = own_rho.clone()
    decision = torch.empty(B, dtype=torch.int8, device=out.device)
    mom = (torch.empty((B, n_moments(dims)), dtype=torch.float32, device=out.device)
           if moments else None)
    if B > 0:
        _launch(spec, grid, B, ghost.contiguous(), bidx.contiguous(), bvalid, position,
                density, motion_limiter, cell_start,
                own=(own_pos.contiguous(), own_rho.contiguous(), out),
                decision=decision, moments=mom)
    return out, decision, mom


def kernel_variant(spec: PhysicsSpec, dims: int, dtype=torch.float32) -> int:
    """The kernel's template instance (f64 << 2 | dims3 << 1 | cubic), or
    ``NotImplementedError`` naming what the kernel does not compute."""
    if dims not in (2, 3):
        raise NotImplementedError(f"the CUDA mDBC kernel does not compute dims={dims}")
    family = spec.kernel.family
    if family not in (KernelFamily.WENDLAND_C2, KernelFamily.CUBIC_SPLINE):
        raise NotImplementedError(
            f"the CUDA mDBC kernel does not compute kernel family {family.name}")
    return ((dtype == torch.float64) << 2 | (dims == 3) << 1
            | (family is KernelFamily.CUBIC_SPLINE))


def moment_params(spec: PhysicsSpec, grid: Grid, nb: int) -> MdbcParams:
    kern = spec.kernel
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [0] * (3 - len(v))))  # noqa: E731
    return MdbcParams(
        nb=nb, ncells=grid.ncells, cmin=pad(grid.cmin), shape=pad(grid.shape),
        strides=pad(grid.strides),
        H2=kern.H2, H_inv=kern.H_inv, h_inv=kern.h_inv, eta2=kern.eta2,
        alpha_d=kern.alpha_d,
        wendland_fac=kern.alpha_d * 5.0 / (8.0 * kern.h * kern.h),
        m0=spec.constants.m0, rho0=spec.constants.rho0, det_threshold=DET_THRESHOLD,
    )


def ghost_groups(spec: PhysicsSpec, grid: Grid, gpoint, gvalid, bidx=None,
                 cell_start=None, motion_limiter=None):
    """The plain mirror of the kernel's grouping (``csrc/mdbc_moments.cu``,
    step 1) for ghost slots ``gpoint`` [B, D]: a slot is parked when it is
    invalid or, with the compacted list ``bidx``, a fill slot (b > 0 indexing
    row 0); with ``cell_start`` and the candidates' ``motion_limiter`` it is
    dry when no candidate row of its stencil is a fluid row.  Every other
    slot's key is the clamped cell of its ghost point, computed in f32.
    Returns a dict: ``keys`` [B] (-1 when parked or dry), ``parked`` [B],
    ``dry`` [B], ``cells`` (the occupied ghost cells, ascending), ``counts``
    (their ghosts), ``order`` (the grouped slots by cell, each cell's in
    ascending slot order; the kernel's order inside a cell is arbitrary),
    ``entries`` (ghosts of each work entry: a cell's ghosts in chunks of
    ``CHUNK``, cell by cell), ``entry_cell``.  With ``cell_start``: ``rows``
    (each cell's stencil rows, what each of its ghosts has as candidates)
    and ``staged`` (the rows each entry stages in shared memory)."""
    B = gpoint.shape[0]
    dev = gpoint.device
    parked = ~gvalid.bool()
    if bidx is not None:
        parked = parked | ((torch.arange(B, device=dev) > 0) & (bidx == 0))
    coords = clamp_coords(cell_coords(gpoint.to(torch.float32), spec.kernel.H_inv), grid)
    dry = torch.zeros_like(parked)
    if motion_limiter is not None:
        fluid = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum((motion_limiter > 0.5).long(), 0)])
        starts, ends = row_segments(coords, grid, cell_start)
        dry = ~parked & ((fluid[ends.long()] - fluid[starts.long()]).sum(-1) == 0)
    keys = torch.where(parked | dry, torch.full_like(coords[:, 0], -1), linearize(coords, grid))
    order = torch.argsort(keys, stable=True)[int((parked | dry).sum()):]
    cells, counts = torch.unique(keys[order], return_counts=True)
    n_ent = (counts + CHUNK - 1) // CHUNK
    entry_cell = torch.repeat_interleave(torch.arange(len(cells), device=dev), n_ent)
    k = torch.arange(len(entry_cell), device=dev) - torch.repeat_interleave(
        torch.cumsum(n_ent, 0) - n_ent, n_ent)
    entries = torch.clamp(counts[entry_cell] - k * CHUNK, max=CHUNK)
    out = {"keys": keys, "parked": parked, "dry": dry, "cells": cells, "counts": counts,
           "order": order, "entries": entries, "entry_cell": entry_cell}
    if cell_start is not None:
        rel = torch.stack([(cells // s) % n for s, n in zip(grid.strides, grid.shape)], -1)
        rel = rel + torch.tensor(grid.cmin, dtype=rel.dtype, device=dev)
        starts, ends = row_segments(rel.to(torch.int32), grid, cell_start)
        rows = (ends - starts).sum(-1).to(torch.int64)
        out["rows"] = rows
        out["staged"] = torch.where(entries >= MIN_STAGE,
                                    rows[entry_cell].clamp(max=STAGE_ROWS),
                                    torch.zeros_like(entries))
    return out


def schedule_stats(groups) -> dict:
    """What chip_smoke.py prints of a grouping (:func:`ghost_groups` with
    ``cell_start``): ghost groups (cells), work entries, ghosts per group,
    parked and dry slots, and the rows staged against the candidate rows the
    grouped ghosts have (their ratio is the share of the first version's
    reads left for them)."""
    counts, rows = groups["counts"], groups["rows"]
    ghosts = int(counts.sum())
    candidates_rows = int((counts * rows).sum())
    staged = int(groups["staged"].sum())
    return {"ghost_groups": int(counts.numel()), "entries": int(groups["entries"].numel()),
            "ghosts": ghosts, "parked_slots": int(groups["parked"].sum()),
            "dry_slots": int(groups["dry"].sum()),
            "ghosts_per_group": ghosts / max(1, counts.numel()),
            "max_ghosts_per_group": int(counts.max()) if counts.numel() else 0,
            "staged_rows": staged, "candidate_rows": candidates_rows,
            "staged_rows_per_candidate_row": staged / max(1, candidates_rows),
            "candidate_rows_read_unstaged": int((groups["entries"] * (
                rows[groups["entry_cell"]] - groups["staged"])).sum())}


def _check(spec, grid, slots, gvalid, position, density, motion_limiter, cell_start,
           slot_shape):
    """The kernel's input checks (both modes): ``slots`` is the ghost points
    [B, D] or the compacted list [B]."""
    n, dims = position.shape
    kernel_variant(spec, dims)
    if dims != grid.dims:
        raise ValueError(f"positions are {dims}D, the grid {grid.dims}D")
    dev = position.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the kernel takes CUDA tensors")
    B = slot_shape[0]
    for name, t, shape in (("slots", slots, slot_shape), ("gvalid", gvalid, (B,)),
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
    if not position.dtype.is_floating_point:
        raise TypeError("position must be floating point")


def _launch(spec, grid, B, ghost, bidx, gvalid, position, density, motion_limiter,
            cell_start, own=None, decision=None, moments=None):
    """One C call: moments mode (``bidx`` None: ``ghost`` is the f32 [B, D]
    slots) or fused mode (``ghost`` the particles' ghost points, ``own`` =
    (their position, their density, the output density))."""
    from ._build import load_library

    lib = load_library("mdbc_moments")
    dims = position.shape[1]
    variant = kernel_variant(spec, dims, ghost.dtype)
    # the kernel reads the candidate arrays as they are: an f32 state is
    # passed through without a copy
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    pos, rho, ml = f32(position), f32(density), f32(motion_limiter)
    valid, cs = gvalid.contiguous(), cell_start.contiguous()
    params = moment_params(spec, grid, B)
    scratch = torch.empty(lib.sph_mdbc_scratch_ints(ctypes.addressof(params)),
                          dtype=torch.int32, device=pos.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    own_pos, own_rho, out_rho = own if own is not None else (None, None, None)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = lib.sph_mdbc_moments(
            ctypes.addressof(params), variant, ghost.data_ptr(), ptr(bidx), valid.data_ptr(),
            pos.data_ptr(), rho.data_ptr(), ml.data_ptr(), cs.data_ptr(), ptr(own_pos),
            ptr(own_rho), ptr(out_rho), ptr(decision), ptr(moments), scratch.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("mdbc_moments launch failed: "
                           f"{lib.sph_mdbc_error_string(err).decode()}")
    return scratch
