"""The neighbor sweep of every step, every model and mode: the CUDA kernel's
wrapper and its plain version (the counterpart of
``sphexample_tpu/ops/pallas_block_sweep.py``).

:func:`block_sweep` takes the kernel ``csrc/block_sweep.cu`` for CUDA
tensors and the plain PyTorch sweep (``interactions.pair_sweep``, the same
math on the same inputs) only for CPU tensors.  A CUDA tensor launches the
kernel or raises: there is no fallback.

:func:`block_sweep_window` is the same kernel on a self window of a longer
candidate array, and :func:`block_sweep_sharded` the sweep of one slab of a
sharded run (the counterpart of ``pallas_block_sweep_sharded``): it packs
the slab's rows, extends the pack by the two halos (``ops/halo.py``: one
1-hop exchange of ``halo`` packed rows each way, or the all-gather when
``halo`` is 0) and launches the kernel on the window.

Both sweep kernels read the fields as one f32 pack of float4-aligned rows,
:func:`pack_fields` (the counterpart of the JAX package's
``pack_block_fields``): for CUDA tensors the kernel ``csrc/pack_fields.cu``,
one launch before every sweep launch; for CPU tensors :func:`pack_fields_plain`, the same bits.

Outputs are in cell-sorted order, masked by ``active`` and cast to the state
dtype (the counterpart of the JAX package's ``_collect``).

The kernel's schedule (``csrc/sph_sweep_walk.cuh``): a warp sweeps 32
consecutive self rows, in one pass per cell row they sit in; each pass stages
the union of its selves' candidate ranges, filters it per self and computes
the accepted pairs.  :func:`block_schedule` is that split in plain PyTorch,
:func:`walk_candidates` the candidates each self accepts through union, own
range and filter, in the kernel's order, and :func:`schedule_stats` what the
schedule costs (``chip_smoke.py`` prints it; ``ops/cell_sweep.py`` has the
cell kernel's schedule).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import (DensityDiffusionModel, KernelFamily, KernelOutputMode,
                      ShiftingMode, ViscosityModel)
from ..models.density_diffusion import linear_hydrostatic_constant
from ..models.kernels import W
from ..state import Particles
from .cell_list import Grid, stencil_rows
from .halo import extend, rebase
from .interactions import PhysicsSpec, SweepOut, pair_sweep

# the enum values of csrc/sph_pair_math.cuh and csrc/sph_kernel_functions.cuh
_FAMILY = {KernelFamily.WENDLAND_C2: 0, KernelFamily.CUBIC_SPLINE: 1}
_VISCOSITY = {ViscosityModel.ZERO: 0, ViscosityModel.ARTIFICIAL: 1,
              ViscosityModel.LAMINAR: 2, ViscosityModel.LAMINAR_SPS: 3}
_DIFFUSION = {DensityDiffusionModel.ZERO: 0,
              DensityDiffusionModel.ZERO_GRAVITY_LINEAR: 1,
              DensityDiffusionModel.LINEAR: 2, DensityDiffusionModel.COMPLEX: 3}
# the model members both sweeps' params end with, in the order of their structs
MODEL_FIELDS = [
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


class SweepParams(ctypes.Structure):
    """Mirror of ``struct SweepParams`` in csrc/block_sweep.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("self_off", ctypes.c_int),
        ("cmin", ctypes.c_int * 3),
        ("shape", ctypes.c_int * 3),
        ("strides", ctypes.c_int * 3),
    ] + MODEL_FIELDS


def model_params(spec: PhysicsSpec) -> dict:
    """The values of ``MODEL_FIELDS`` for this model set."""
    kern, c = spec.kernel, spec.constants
    w_dx = float(W(kern, torch.tensor(c.dx, dtype=torch.float64)))
    return dict(
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


def n_sums(spec: PhysicsSpec, dims: int) -> int:
    """K = (1+D)(1 + STORE + PLANAR) f32 sums per self: drho, dv/dt, then
    W, grad W, then grad C, div r."""
    return (1 + dims) * (1 + (spec.kernel_output is KernelOutputMode.STORE)
                         + (spec.shifting is ShiftingMode.PLANAR))


def kernel_variant(spec: PhysicsSpec, dims: int) -> int:
    """The kernel's template instance for this model set: every model and
    mode has one, only ``dims`` outside (2, 3) raises
    ``NotImplementedError``.  0-15: the main path's models pinned at compile
    time (ZERO / ARTIFICIAL viscosity, ZERO / LINEAR diffusion, no kernel
    output, no shifting); 16-31: the rest, templated on LAMINAR_SPS, STORE
    and PLANAR, the other choices made at run time."""
    if dims not in (2, 3):
        raise NotImplementedError(f"the CUDA block sweep does not compute dims={dims}")
    store = spec.kernel_output is KernelOutputMode.STORE
    shift = spec.shifting is ShiftingMode.PLANAR
    if (spec.viscosity in (ViscosityModel.ZERO, ViscosityModel.ARTIFICIAL)
            and spec.diffusion in (DensityDiffusionModel.ZERO, DensityDiffusionModel.LINEAR)
            and not store and not shift):
        return ((dims == 3) << 3
                | (spec.kernel.family is KernelFamily.CUBIC_SPLINE) << 2
                | (spec.viscosity is ViscosityModel.ARTIFICIAL) << 1
                | (spec.diffusion is DensityDiffusionModel.LINEAR))
    return (16 | (dims == 3) << 3
            | (spec.viscosity is ViscosityModel.LAMINAR_SPS) << 2
            | store << 1 | shift)


def sweep_params(spec: PhysicsSpec, grid: Grid, n: int, self_off: int = 0) -> SweepParams:
    pad = lambda v: (ctypes.c_int * 3)(*(list(v) + [0] * (3 - len(v))))  # noqa: E731
    return SweepParams(
        n=n, self_off=self_off, cmin=pad(grid.cmin), shape=pad(grid.shape),
        strides=pad(grid.strides), **model_params(spec))


def pack_fields_plain(position, velocity, density, pressure, ml):
    """The pack in plain PyTorch: the guard and the reciprocal in the fields'
    dtype, then every column rounded to f32 (see :func:`pack_fields`)."""
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


def pack_fields(position, velocity, density, pressure, ml):
    """Row-major f32 pack read by both sweep kernels, float4-aligned rows:
    3D (x,y,z,rho)(vx,vy,vz,1/rho)(p,ml,0,0); 2D (x,y,vx,vy)(rho,1/rho,p,ml).
    Density is guarded (padding rows carry 1, never 0).  CPU tensors: the
    plain version.  CUDA tensors, as :func:`check_inputs` passes them: the
    kernel ``csrc/pack_fields.cu``, bit for bit the plain version (zero rows
    launch nothing), or an exception."""
    dev = position.device
    if dev.type == "cpu":
        return pack_fields_plain(position, velocity, density, pressure, ml)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if position.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the pack kernel takes float32 or float64 fields, not {position.dtype}")
    n, dims = position.shape
    out = torch.empty((n, 4 * dims), dtype=torch.float32, device=dev)   # 12 / 8 floats
    if n == 0:
        return out

    from ._build import load_library

    lib = load_library("pack_fields")
    fields = [t.contiguous() for t in (position, velocity, density, pressure, ml)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sph_pack_fields(dims, int(position.dtype == torch.float64), n,
                                  *(t.data_ptr() for t in fields), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pack_fields launch failed: {lib.sph_pack_error_string(err).decode()}")
    return out


def collect(out, active, dtype, dims, spec: PhysicsSpec = None) -> SweepOut:
    """[N, K] kernel rows -> SweepOut, masked by ``active``, in ``dtype``.
    Columns: drho, dv/dt, then (STORE) W, grad W, then (PLANAR) grad C, div r;
    without ``spec`` only the first 1+D are read.  The mask is a select, never a
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
                 pressure, velocity, reads_cell: bool, motion_limiter=None,
                 self_off: int = 0, window: bool = False) -> None:
    """Raise on what a sweep kernel and its input pack do not take: a field
    on another device, of another shape or of another type than they read
    (the five fields all float32 or all float64).  The fields have ``Ne``
    rows, ``particles`` the ``N`` self rows ``[self_off, self_off + N)`` of
    them; without ``window`` the two are the same rows."""
    ne, dims = position.shape
    n = particles.capacity
    if dims != grid.dims:
        raise ValueError(f"positions are {dims}D, the grid {grid.dims}D")
    if not window and (n != ne or self_off != 0):
        raise ValueError(f"particles have shape ({n},), the fields ({ne},)")
    if self_off < 0 or self_off + n > ne:
        raise ValueError(f"self rows [{self_off}, {self_off + n}) outside the "
                         f"fields' {ne} rows")
    dev = position.device
    ml = particles.motion_limiter if motion_limiter is None else motion_limiter
    fields = [("velocity", velocity, (ne, dims)), ("density", density, (ne,)),
              ("pressure", pressure, (ne,)), ("active", particles.active, (n,)),
              ("motion_limiter", ml, (ne,)),
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
    if position.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"positions must be float32 or float64, not {position.dtype}")
    for name, t in (("velocity", velocity), ("density", density), ("pressure", pressure),
                    ("motion_limiter", ml)):
        if t.dtype != position.dtype:
            raise TypeError(f"{name} is {t.dtype}, positions {position.dtype}")


# the walk's shape (csrc/sph_sweep_walk.cuh): the selves of one warp pass, the
# packed rows of one staged tile (one bit of a lane's accept mask each), and
# the bytes of queued pair terms a warp holds for the cooperative path
WARP = 32
WALK_TILE = 64
WALK_TERM_BYTES = 3072


def walk_queue(k: int) -> int:
    """Pairs a tile may queue for other lanes, for K sums a self
    (sph_sweep_walk.cuh::walk_queue)."""
    return max(WALK_TERM_BYTES // (4 * k), 8)


def tile_rounds(pairs, queue: Optional[int] = None):
    """(rounds, cooperative) of a tile whose lanes accept ``pairs`` (a list
    of ints), by the kernel's rule: the fewest rounds >= ceil(sum / 32) whose
    pairs past them fit ``queue`` (no limit when None); cooperative when
    they are fewer than the busiest lane's pairs, else per lane."""
    r = -(-sum(pairs) // WARP)
    while queue is not None and sum(max(p - r, 0) for p in pairs) > queue:
        r += 1
    return r, r < max(pairs, default=0)


@dataclass(frozen=True)
class Schedule:
    """The passes of a sweep kernel's warps: each self row is in at most one
    pass, and the selves of a pass share one cell row (y, or y and z), so
    one set of stencil rows.  ``pass_x`` is the union of the members' x
    ranges, ``cells`` the cell kernel's list of groups (their first cells)."""

    groups: int                     # warps with a live row / listed groups
    pass_of: torch.Tensor           # [n] int64: each self row's pass, -1 for none
    pass_row: torch.Tensor          # [P, D-1] each pass's cell row (unclamped)
    pass_x: torch.Tensor            # [P, 2] its union x range [min x_lo, max x_hi]
    x_range: torch.Tensor           # [n, 2] each self's clamped x range
    own: torch.Tensor               # [n, 2] each self's own cell rows [s_i, e_i)
    cells: Optional[torch.Tensor] = None


def _pass_union(pass_of, x_range, n_pass):
    """[P, 2] union x range of each pass: min x_lo, max x_hi of its members."""
    live = pass_of >= 0
    idx = pass_of[live]
    lo = torch.full((n_pass,), 1 << 30, dtype=torch.int64, device=idx.device)
    hi = torch.full((n_pass,), -1, dtype=torch.int64, device=idx.device)
    lo = lo.scatter_reduce(0, idx, x_range[live, 0], "amin")
    hi = hi.scatter_reduce(0, idx, x_range[live, 1], "amax")
    return torch.stack([lo, hi], dim=-1)


def block_schedule(grid: Grid, particles: Particles, cell_start) -> Schedule:
    """The block kernel's passes: warp w takes self rows [32w, 32w + 32) and
    splits its live rows by the unclamped cell row of their stale cells
    (rel[1 .. D-1]), one pass per row (the kernel ballots on the lowest
    pending lane's row; a warp's passes do not depend on each other)."""
    cell, active = particles.cell.long(), particles.active
    n, dims = cell.shape
    dev = cell.device
    cs = cell_start.long()
    cmin = torch.tensor(grid.cmin, device=dev)
    shape = torch.tensor(grid.shape, device=dev)
    strides = torch.tensor(grid.strides, device=dev)
    rel = cell - cmin
    key = (torch.minimum(torch.clamp(rel, min=0), shape - 1) * strides).sum(-1)
    own = torch.stack([cs[key], cs[key + 1]], dim=-1)
    x_range = torch.stack([torch.clamp(rel[:, 0] - 1, 0, grid.shape[0] - 1),
                           torch.clamp(rel[:, 0] + 1, 0, grid.shape[0] - 1)], dim=-1)
    warp = torch.arange(n, device=dev) // WARP
    ids = torch.cat([warp[:, None], rel[:, 1:]], dim=1)[active]
    if ids.shape[0] == 0:
        uniq = ids.new_zeros((0, dims))
        inv = ids.new_zeros((0,))
    else:
        uniq, inv = torch.unique(ids, dim=0, return_inverse=True)
    pass_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pass_of[active] = inv
    return Schedule(groups=int(torch.unique(warp[active]).numel()), pass_of=pass_of,
                    pass_row=uniq[:, 1:], pass_x=_pass_union(pass_of, x_range, uniq.shape[0]),
                    x_range=x_range, own=own)


def _pass_rows(sched: Schedule, grid: Grid, cell_start):
    """[P, S] union candidate ranges (ub, ue) of every pass and stencil row
    (z outer, y inner, as the kernels walk them), empty outside the grid;
    and the [P, S] row bases (cell key of x = 0)."""
    dev = cell_start.device
    cs = cell_start.long()
    rows = torch.as_tensor(stencil_rows(grid.dims), device=dev).long()   # [S, D-1]
    shape = torch.tensor(grid.shape[1:], device=dev)
    strides = torch.tensor(grid.strides[1:], device=dev)
    row_rel = sched.pass_row[:, None, :] + rows                          # [P, S, D-1]
    valid = torch.all((row_rel >= 0) & (row_rel < shape), dim=-1)
    base = torch.where(valid, (row_rel * strides).sum(-1), 0)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ub = torch.where(valid, cs[base + sched.pass_x[:, None, 0]], zero)
    ue = torch.where(valid, cs[base + sched.pass_x[:, None, 1] + 1], zero)
    return ub, ue, base, valid


def walk_candidates(sched: Schedule, grid: Grid, cell_start, position, H2: float,
                    self_off: int = 0):
    """The pairs (r, j) the kernel's walk accepts, in its order: for each self
    row r of a pass, every stencil row's union run [ub, ue), ascending, kept
    where j lies in the self's own x range, j != i (i = self_off + r, its
    position row) and d2 <= H2, d2 summed unfused in ``position``'s dtype as
    the kernel's pair_distance2 does.  int64 tensors, r ascending."""
    dev = cell_start.device
    cs = cell_start.long()
    ub, ue, base, valid = _pass_rows(sched, grid, cell_start)
    r = torch.nonzero(sched.pass_of >= 0).flatten()
    p = sched.pass_of[r]
    S = ub.shape[1]
    lens = (ue[p] - ub[p]).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    j = ub[p].reshape(-1)[seg] + torch.arange(seg.numel(), device=dev) - first[seg]
    self_k, srow = torch.div(seg, S, rounding_mode="floor"), seg % S
    rr, pp = r[self_k], p[self_k]
    b = base[pp, srow]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    jb = torch.where(valid[pp, srow], cs[b + sched.x_range[rr, 0]], zero)
    je = torch.where(valid[pp, srow], cs[b + sched.x_range[rr, 1] + 1], zero)
    i = self_off + rr
    xij = position[i] - position[j]
    d2 = torch.zeros_like(xij[:, 0])
    for d in range(xij.shape[1]):
        d2 = d2 + xij[:, d] * xij[:, d]
    keep = (j >= jb) & (j < je) & (j != i) & ~(d2 > H2)
    return rr[keep], j[keep]


def pass_bodies(sched: Schedule, grid: Grid, cell_start, position, H2: float,
                passes, self_off: int = 0, queue: Optional[int] = None) -> dict:
    """Pair bodies a warp runs over the passes ``passes`` (pass ids), by how
    its compute is batched, and the accepted pairs of its busiest and mean
    lane, summed over the passes: ``any_lane`` - the union rows some lane
    accepts (a walk whose lanes step through the union together pays the
    body on each); ``per_tile`` - the busiest lane's accepts in each staged
    tile (the per-lane path on every tile; a pass's stencil rows' union runs
    read as one stream, cut every WALK_TILE rows, as the kernel's walk_stage
    stages them); ``balanced`` - in each tile the rounds of the path the walk
    takes there
    (:func:`tile_rounds`, ``queue`` the kernel's walk_queue for the mode's
    sums); ``per_row`` - the busiest lane's in each stencil row;
    ``per_pass`` - over the whole pass; ``mean_lane`` - a lane's average;
    ``cooperative_tiles`` - the share of the staged tiles that take the
    cooperative path (a share, not a sum).
    Self row r is ``position`` row self_off + r, as in walk_candidates."""
    ub, ue, base, valid = _pass_rows(sched, grid, cell_start)
    cs = cell_start.long()
    out = {"passes": 0, "any_lane": 0, "per_tile": 0, "balanced": 0, "per_row": 0,
           "per_pass": 0, "mean_lane": 0.0}
    tiles = coop = 0
    for q in passes.tolist():
        rows = torch.nonzero(sched.pass_of == q).flatten()
        stream = []
        for s in range(ub.shape[1]):
            a, b = int(ub[q, s]), int(ue[q, s])
            if a >= b:
                continue
            j = torch.arange(a, b, device=rows.device)
            jb = cs[base[q, s] + sched.x_range[rows, 0]]
            je = cs[base[q, s] + sched.x_range[rows, 1] + 1]
            xij = position[self_off + rows][:, None, :] - position[j][None, :, :]
            d2 = torch.zeros_like(xij[..., 0])
            for d in range(xij.shape[-1]):
                d2 = d2 + xij[..., d] * xij[..., d]
            acc = ((j >= jb[:, None]) & (j < je[:, None]) & (j != self_off + rows[:, None])
                   & ~(d2 > H2))
            out["any_lane"] += int(acc.any(0).sum())
            out["per_row"] += int(acc.sum(1).max())
            stream.append(acc)
        stream = torch.cat(stream, dim=1)
        for t in range(0, stream.shape[1], WALK_TILE):
            lanes = stream[:, t:t + WALK_TILE].sum(1).tolist()
            rounds, take = tile_rounds(lanes, queue)
            out["per_tile"] += max(lanes)
            out["balanced"] += rounds
            tiles += 1
            coop += int(take)
        total = stream.sum(1)
        out["passes"] += 1
        out["per_pass"] += int(total.max())
        out["mean_lane"] += float(total.double().mean())
    out["cooperative_tiles"] = coop / tiles if tiles else 0.0
    return out


def schedule_stats(sched: Schedule, grid: Grid, cell_start) -> dict:
    """What a schedule costs: groups, warp passes, mean member lanes per
    pass, tiles staged (a pass's union rows over WALK_TILE, rounded up) and
    ``tile_fill`` (union rows over tiles x WALK_TILE), the union rows staged
    and the selves' own candidates, and the rows a member lane tests over
    the candidates of its own ranges (the filter's extra work: 1 when every
    pass's selves share one x range)."""
    ub, ue, base, valid = _pass_rows(sched, grid, cell_start)
    cs = cell_start.long()
    live = sched.pass_of >= 0
    n_pass = int(ub.shape[0])
    members = int(live.sum())
    p = sched.pass_of[live]
    own = torch.where(valid[p], cs[base[p] + sched.x_range[live, 1, None] + 1]
                      - cs[base[p] + sched.x_range[live, 0, None]], 0)
    per_pass = (ue - ub).sum(-1)
    union = int(per_pass.sum())
    tested = int((per_pass * torch.bincount(p, minlength=n_pass)).sum())
    self_cand = int(own.sum())
    tiles = int(((per_pass + WALK_TILE - 1) // WALK_TILE).sum())
    return {"groups": sched.groups, "warp_passes": n_pass,
            "mean_active_lanes": members / n_pass if n_pass else 0.0,
            "tiles": tiles, "tile_fill": union / (tiles * WALK_TILE) if tiles else 0.0,
            "union_rows": union, "self_candidates": self_cand,
            "union_over_self_candidates": tested / self_cand if self_cand else 0.0}


def block_sweep_plain(spec: PhysicsSpec, grid: Grid, particles: Particles,
                      cell_start, position, density, pressure, velocity,
                      block_size: int = 1024, motion_limiter=None,
                      self_off: int = 0) -> SweepOut:
    """The plain version: ``pair_sweep`` on the same inputs (its inactive
    rows are zero and it computes in the state dtype, like the kernel's
    collected output); with ``motion_limiter`` / ``self_off`` on a window."""
    return pair_sweep(spec, grid, block_size, particles, cell_start,
                      position, density, pressure, velocity,
                      motion_limiter=motion_limiter, self_off=self_off)


def sweep_fields(variant_of, launch, reads_cell: bool, window: bool,
                 spec: PhysicsSpec, grid: Grid, particles: Particles, cell_start,
                 position, density, pressure, velocity, motion_limiter,
                 self_off: int, block_size: int) -> SweepOut:
    """The entry of either sweep kernel (``variant_of`` / ``launch``: its
    instance check and its pack launcher) on unpacked fields: the selves are
    the rows ``[self_off, self_off + N)`` of the fields, N the rows of
    ``particles``.  CPU tensors: the plain version.  CUDA tensors: pack and
    launch the kernel, or raise."""
    if position.device.type == "cpu":
        return pair_sweep(spec, grid, block_size, particles, cell_start, position,
                          density, pressure, velocity, motion_limiter=motion_limiter,
                          self_off=self_off)
    if position.device.type != "cuda":
        raise ValueError(f"unsupported device {position.device}")
    variant_of(spec, position.shape[1])
    check_inputs(grid, particles, cell_start, position, density, pressure,
                 velocity, reads_cell=reads_cell, motion_limiter=motion_limiter,
                 self_off=self_off, window=window)
    ml = particles.motion_limiter if motion_limiter is None else motion_limiter
    pack = pack_fields(position, velocity, density, pressure, ml)
    return launch(spec, grid, particles, cell_start, pack, self_off, position.dtype)


def block_sweep(spec: PhysicsSpec, grid: Grid, particles: Particles,
                cell_start, position, density, pressure, velocity,
                block_size: int = 1024) -> SweepOut:
    """One full neighbor sweep.  CPU tensors: the plain version.  CUDA
    tensors: the kernel, or an exception."""
    return sweep_fields(kernel_variant, launch_pack, True, False, spec, grid,
                        particles, cell_start, position, density, pressure,
                        velocity, None, 0, block_size)


def block_sweep_window(spec: PhysicsSpec, grid: Grid, particles: Particles,
                       cell_start, position, density, pressure, velocity,
                       motion_limiter, self_off: int,
                       block_size: int = 1024) -> SweepOut:
    """The sweep of the self rows ``[self_off, self_off + N)`` of extended
    fields (``Ne`` rows; ``particles`` holds the N self rows, ``cell_start``
    is rebased to the fields' rows).  CPU tensors: the plain version.  CUDA
    tensors: the kernel on the window, or an exception."""
    return sweep_fields(kernel_variant, launch_pack, True, True, spec, grid,
                        particles, cell_start, position, density, pressure,
                        velocity, motion_limiter, self_off, block_size)


def sweep_sharded(variant_of, launch, reads_cell: bool, spec: PhysicsSpec,
                  grid: Grid, halo: int, particles: Particles, cell_start,
                  position, density, pressure, velocity, ctx,
                  block_size: int = 1024) -> SweepOut:
    """One slab's sweep in a sharded run, for either sweep kernel
    (``variant_of`` / ``launch``: its instance check and its pack launcher).
    ``particles`` and the fields are the slab's C rows, ``cell_start`` indexes
    global sorted rows.  The window comes from ``ops/halo.py``.  CUDA
    tensors: the f32 pack of the slab's rows is what travels (``halo`` packed
    rows each way), and the kernel runs on the extended pack.  CPU tensors:
    the fields travel in the state dtype and the plain version runs."""
    C, dims = position.shape
    ml = particles.motion_limiter
    if position.device.type == "cpu":
        cols = torch.cat([position, velocity, density[:, None], pressure[:, None],
                          ml[:, None]], dim=1)
        ext, self_off, ext_off = extend(ctx, cols, halo)
        cs_ext = rebase(cell_start, ext_off, ext.shape[0])
        return pair_sweep(spec, grid, block_size, particles, cs_ext,
                          ext[:, :dims], ext[:, 2 * dims], ext[:, 2 * dims + 1],
                          ext[:, dims:2 * dims], motion_limiter=ext[:, 2 * dims + 2],
                          self_off=self_off)
    if position.device.type != "cuda":
        raise ValueError(f"unsupported device {position.device}")
    variant_of(spec, dims)
    check_inputs(grid, particles, cell_start, position, density, pressure,
                 velocity, reads_cell=reads_cell)
    pack = pack_fields(position, velocity, density, pressure, ml)
    pack_ext, self_off, ext_off = extend(ctx, pack, halo)
    cs_ext = rebase(cell_start, ext_off, pack_ext.shape[0])
    return launch(spec, grid, particles, cs_ext, pack_ext, self_off, position.dtype)


def block_sweep_sharded(spec: PhysicsSpec, grid: Grid, halo: int,
                        particles: Particles, cell_start, position, density,
                        pressure, velocity, ctx, block_size: int = 1024) -> SweepOut:
    """One slab's sweep through the block kernel (:func:`sweep_sharded`)."""
    return sweep_sharded(kernel_variant, launch_pack, True, spec, grid, halo,
                         particles, cell_start, position, density, pressure,
                         velocity, ctx, block_size)


def launch_pack(spec, grid, particles, cell_start, pack, self_off: int, dtype) -> SweepOut:
    """Launch the kernel on a ready pack: selves are its rows ``[self_off,
    self_off + N)``, N the rows of ``particles`` (cell, active)."""
    n, dims = particles.capacity, grid.dims
    variant = kernel_variant(spec, dims)
    if self_off < 0 or self_off + n > pack.shape[0]:
        raise ValueError(f"self rows [{self_off}, {self_off + n}) outside the "
                         f"pack's {pack.shape[0]} rows")
    dev = pack.device

    from ._build import load_library

    lib = load_library("block_sweep")
    cell = particles.cell.contiguous()
    cs = cell_start.contiguous()
    act = particles.active.contiguous()
    out = torch.empty((n, n_sums(spec, dims)), dtype=torch.float32, device=dev)
    params = sweep_params(spec, grid, n, self_off)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sph_block_sweep(
            ctypes.addressof(params), variant, pack.data_ptr(), cell.data_ptr(),
            cs.data_ptr(), act.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"block_sweep launch failed: {lib.sph_error_string(err).decode()}")
    return collect(out, particles.active, dtype, dims, spec)
