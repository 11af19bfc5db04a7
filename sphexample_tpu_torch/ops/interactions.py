"""The plain pair-interaction sweep: gather + reduce in PyTorch (port of
``sphexample_tpu/ops/interactions.py``).

Every particle gathers its candidates - the S = 3^(D-1) contiguous row
segments of the cell-sorted arrays (3 x-adjacent cells per segment) - keeps
those inside the H^2 cutoff other than itself, and sums the pair terms into
its own row; each pair is computed from both endpoints.  The particle axis
is processed in chunks of ``block_size`` rows to bound the gather footprint,
and a chunk's candidate list is exact (no fixed-capacity window, so no
candidate is ever cut off and none is padding).

This is the sweep for CPU tensors and the oracle the CUDA kernels
(``ops/block_sweep.py``, ``ops/cell_sweep.py``) are held against.  With
``self_off`` / ``motion_limiter`` it sweeps a self range of a longer
("extended") candidate array - a slab of the global sorted order between its
two halos, or inside the whole gathered array - which is the plain version of
the windowed kernels and the CPU path of the sharded step (the JAX package's
``global_*`` / ``local_*`` / ``idx_base`` form).
Physics per pair matches ``ComputeInteractions!`` (reference
SPHCellList.jl:268-317) including the density-diffusion role-order quirk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..config import (
    DensityDiffusionModel,
    KernelOutputMode,
    ShiftingMode,
    SimulationConstants,
    SPHKernelInstance,
    ViscosityModel,
)
from ..models import density_diffusion as dd
from ..models import kernels as K
from ..models import viscosity as visc
from ..state import Particles
from .cell_list import Grid, linearize, row_segments


@dataclass(frozen=True)
class PhysicsSpec:
    """Static bundle of everything the pair physics needs."""

    constants: SimulationConstants
    kernel: SPHKernelInstance
    viscosity: ViscosityModel
    diffusion: DensityDiffusionModel
    shifting: ShiftingMode = ShiftingMode.NONE
    kernel_output: KernelOutputMode = KernelOutputMode.NONE


class SweepOut(NamedTuple):
    """Per-particle accumulators of one neighbor sweep, in sorted order.
    Optional outputs are ``None`` when their mode is off."""

    drhodt: torch.Tensor
    acceleration: torch.Tensor
    kernel_w: Optional[torch.Tensor]
    kernel_grad: Optional[torch.Tensor]
    grad_c: Optional[torch.Tensor]    # shifting concentration gradient
    div_r: Optional[torch.Tensor]     # shifting divergence (free-surface detector)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def candidates(starts, ends, b0: int, b1: int):
    """Candidate pairs (i, j) of self rows [b0, b1): every (self, stencil
    row, j) of the row segments ``starts``/``ends`` [N, S], in row-major
    order, with no padding to a fixed window.  int64 index tensors."""
    dev = starts.device
    S = starts.shape[1]
    lens = (ends[b0:b1] - starts[b0:b1]).reshape(-1).long()
    seg = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    first = torch.cumsum(lens, 0) - lens
    j = starts[b0:b1].reshape(-1).long()[seg] + (
        torch.arange(seg.numel(), device=dev) - first[seg])
    i = b0 + torch.div(seg, S, rounding_mode="floor")
    return i, j


def pair_sweep(
    spec: PhysicsSpec,
    grid: Grid,
    block_size: int,
    particles: Particles,   # sorted self rows (cell / motion_limiter / active)
    cell_start,             # [ncells+2] int32, indexing rows of ``position``
    position,               # [Ne, D] sweep field set (state or half-step)
    density,                # [Ne]
    pressure,               # [Ne]
    velocity,               # [Ne, D]
    motion_limiter=None,    # [Ne]; default: ``particles.motion_limiter``
    self_off: int = 0,      # row of ``position`` that self row 0 is
) -> SweepOut:
    """One full neighbor sweep over the self rows (sorted order).

    Single device: the fields have the selves' N rows and ``self_off`` is 0.
    A window: the fields are an extended array of Ne >= N rows, the selves
    its rows [self_off, self_off + N), ``cell_start`` is rebased to it and
    clamped to [0, Ne]; a rigid shift keeps the order of two sorted indices,
    so the density-diffusion role compares extended indices.
    """
    kern = spec.kernel
    n, dims = particles.capacity, position.shape[1]
    ml = particles.motion_limiter if motion_limiter is None else motion_limiter

    starts, ends = row_segments(particles.cell, grid, cell_start)     # [N, S]
    keys = linearize(particles.cell, grid).long()
    s_cell = cell_start[keys]
    e_cell = cell_start[keys + 1]

    outs = _zero_outs(spec, n, dims, position)
    for b0 in range(0, n, block_size):
        b1 = min(b0 + block_size, n)
        r, j = candidates(starts, ends, b0, b1)      # self row, candidate
        i = r + self_off                             # the self in the fields
        xij = position[i] - position[j]
        d2 = _dot(xij, xij)
        # support cutoff, self-exclusion, active selves only (candidates in
        # stencil rows are always active: padding is parked past every row)
        keep = (d2 <= kern.H2) & (j != i) & particles.active[r]
        r, i, j, xij, d2 = r[keep], i[keep], j[keep], xij[keep], d2[keep]
        # density-diffusion role order: intra-cell pairs give the i role to
        # the lower sorted index, cross-cell pairs to the particle in the
        # later cell (= higher index)
        same_cell = (j >= s_cell[r]) & (j < e_cell[r])
        add_pairs(spec, outs, r, i, j, xij, d2, density, pressure, velocity, ml,
                  same_cell)
    return _sweep_out(outs)


def _zero_outs(spec: PhysicsSpec, n: int, dims: int, like) -> dict:
    """The zeroed accumulators of a sweep over ``n`` selves."""
    zeros = lambda *shape: torch.zeros(shape, dtype=like.dtype, device=like.device)  # noqa: E731
    outs = {"drhodt": zeros(n), "acc": zeros(n, dims)}
    if spec.kernel_output is KernelOutputMode.STORE:
        outs.update(kernel_w=zeros(n), kernel_grad=zeros(n, dims))
    if spec.shifting is ShiftingMode.PLANAR:
        outs.update(grad_c=zeros(n, dims), div_r=zeros(n))
    return outs


def _sweep_out(outs: dict) -> SweepOut:
    return SweepOut(
        drhodt=outs["drhodt"],
        acceleration=outs["acc"],
        kernel_w=outs.get("kernel_w"),
        kernel_grad=outs.get("kernel_grad"),
        grad_c=outs.get("grad_c"),
        div_r=outs.get("div_r"),
    )


def add_pairs(spec: PhysicsSpec, outs: dict, r, i, j, xij, d2, density, pressure,
              velocity, ml, same_cell):
    """Sum the terms of the pairs (i, j) - fields indexed by ``i`` and ``j``,
    ``xij = x_i - x_j`` and ``d2 = |xij|^2`` within the support - into the
    self rows ``r`` of the accumulators ``outs``.  ``same_cell``: whether j
    lies in i's cell (the density-diffusion role order)."""
    kern = spec.kernel
    c = spec.constants
    rho_i, rho_j = density[i], density[j]
    p_i, p_j = pressure[i], pressure[j]
    ml_i, ml_j = ml[i], ml[j]

    d = torch.sqrt(d2)
    q = torch.clamp(d * kern.h_inv, 0.0, 2.0)
    grad_w = K.grad_W(kern, q, xij)                             # [P, D]
    vij = velocity[i] - velocity[j]

    # continuity (reference SPHCellList.jl:289-291)
    sym = _dot(-vij, grad_w)
    drho = -rho_i * (c.m0 / rho_j) * sym

    # density diffusion (reference :293-296), cell-centric role order
    i_is_role_i = torch.where(same_cell, i < j, i > j)
    drho = drho + dd.compute_density_diffusion(
        spec.diffusion, kern, c, xij, grad_w, d2,
        rho_i, rho_j, ml_i, ml_j, i_is_role_i,
    )

    # momentum (reference :299-303) + tensile correction + viscosity
    pfac = (p_i + p_j) / (rho_i * rho_j)
    f_ab = K.tensile_correction(kern, p_i, rho_i, p_j, rho_j, q, c.dx)
    dvdt = (-c.m0 * (pfac + f_ab))[..., None] * grad_w
    dvdt = dvdt + visc.compute_viscosity(
        spec.viscosity, kern, c, xij, vij, grad_w, d2, rho_i, rho_j
    )

    outs["drhodt"].index_add_(0, r, drho)
    outs["acc"].index_add_(0, r, dvdt)
    if "kernel_w" in outs:
        # KernelOutput! (reference SPHCellList.jl:106-116)
        outs["kernel_w"].index_add_(0, r, K.W(kern, q))
        outs["kernel_grad"].index_add_(0, r, grad_w)
    if "grad_c" in outs:
        # add_shifting_terms! (reference SPHCellList.jl:73-88): grad_C
        # uses the self density, div_r the neighbor's
        outs["grad_c"].index_add_(0, r, (c.m0 / rho_i)[:, None] * grad_w)
        outs["div_r"].index_add_(
            0, r, (c.m0 / rho_j) * _dot(-xij, grad_w) * (ml_i * ml_j))

