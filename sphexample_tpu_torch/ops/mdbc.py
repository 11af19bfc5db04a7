"""mDBC: modified dynamic boundary condition, the ghost-node density
extrapolation (port of ``sphexample_tpu/ops/mdbc.py``, single-device part).

Reference path: ``src/SPHCellList.jl:219-266`` ghost neighbor loop,
``:319-365`` pair moments, ``:598-622`` correction.  Per step:

  * compact the boundary particles that carry a ghost node into a fixed-size
    index list (on the device, without a host sync),
  * sum the first-order moment system b (D+1) / A (D+1)^2 of every ghost
    point over its fluid neighbors,
  * solve all (D+1)x(D+1) systems in closed form (Cramer's rule) and apply
    the reference's decision tree.

:func:`correct_density` takes the last two steps.  CUDA tensors: one call of
the fused kernel (``ops/mdbc_moments.py:mdbc_correct``: moments, solve and
decision tree in ``csrc/mdbc_moments.cu``).  CPU tensors: the plain version
(``mdbc_moments_plain``, then :func:`_mdbc_apply`, plain elementwise tensor
code whose expression tree the kernel's epilogue repeats).

:func:`mdbc_density_correction_sharded` is the same for one slab of a sharded
run: the slab's own ghosts against its halo-extended window.
"""

from __future__ import annotations

import functools

import torch

from .cell_list import Grid
from .halo import extend, rebase
from .interactions import PhysicsSpec
from .mdbc_moments import DET_THRESHOLD, mdbc_correct, mdbc_moments_plain  # noqa: F401


def _det3(m):
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


@functools.lru_cache(maxsize=None)
def _minor_columns(device):
    """Row k: the columns that minor k keeps.  Made once per device, so that
    no step copies it from the host (such a copy blocks the host)."""
    return torch.tensor([[c for c in range(4) if c != k] for k in range(4)],
                        device=device)


def _det4(M):
    """Laplace expansion along the first row; the four 3x3 minors go through
    one batched :func:`_det3`."""
    rest = _minor_columns(M.device)
    minors = M[..., 1:, :][..., :, rest].movedim(-3, -2)      # [..., 4, 3, 3]
    t = M[..., 0, :] * _det3(minors)
    return t[..., 0] - t[..., 1] + t[..., 2] - t[..., 3]


def _det_solve(A, b):
    """Batched determinant + Cramer solve for (D+1) in {3, 4}.

    Returns (det, x) with x_k = det(A with column k replaced by b) / det(A).
    A singular system divides by zero here (inf or NaN in ``x``); the caller
    selects on ``|det|`` and never reads those rows.  A and its n
    column-replaced copies are stacked, so the determinant formula runs once.
    """
    n = A.shape[-1]
    if n not in (3, 4):
        raise ValueError(f"unsupported system size {n}")
    mats = A.unsqueeze(0).repeat(n + 1, *([1] * A.dim()))     # [n+1, ..., n, n]
    for kcol in range(n):
        mats[kcol + 1][..., :, kcol] = b
    dets = (_det3 if n == 3 else _det4)(mats)                 # [n+1, ...]
    det = dets[0]
    return det, dets[1:].movedim(0, -1) / det[..., None]


def compact_ghosts(particles, boundary_capacity: int):
    """The static-size list of the rows that carry a ghost node, ascending:
    (bidx [B] int64, bvalid [B] bool).  Slots past the count index row 0 and
    take ``has_ghost[0]`` as their validity, rows past ``boundary_capacity``
    are dropped (the fill and size rules of the JAX package's
    ``jnp.nonzero(has_ghost, size=B, fill_value=0)``).  A cumulative sum and
    a scatter on the device: no host sync."""
    B = boundary_capacity
    has_ghost = torch.any(particles.ghost_points != 0, dim=-1) & particles.active
    n = has_ghost.shape[0]
    slot = torch.cumsum(has_ghost, 0) - 1
    # rows without a ghost, and ghosts past the capacity, land in slot B,
    # which is cut off
    slot = torch.where(has_ghost, slot, B).clamp(max=B)
    bidx = torch.zeros(B + 1, dtype=torch.int64, device=has_ghost.device)
    bidx.scatter_(0, slot, torch.arange(n, device=has_ghost.device))
    bidx = bidx[:B]
    return bidx, has_ghost[bidx]


def _mdbc_apply(spec: PhysicsSpec, particles, bidx, bvalid, gpoint, bvec, Amat):
    """Solve + Shepard/keep decision tree + NaN scrub (reference
    SPHCellList.jl:606-621).  Returns the corrected density array (a new
    tensor) and the decision of every slot (0 keep, 1 Shepard, 2 solve)."""
    c = spec.constants
    det, sol = _det_solve(Amat, bvec)
    diff = particles.position[bidx] - gpoint
    # sol[1:] . diff added left to right: the order torch.sum takes on the card
    # for this column-major product, written out so that the fused kernel and
    # every device repeat it
    grad = sol[..., 1] * diff[..., 0]
    for d in range(1, diff.shape[-1]):
        grad = grad + sol[..., 1 + d] * diff[..., d]
    rho_solve = sol[..., 0] + grad
    rho_shepard = bvec[..., 0] / Amat[..., 0, 0]

    rho_old = particles.density[bidx]
    use_solve = torch.abs(det) >= DET_THRESHOLD
    use_shepard = (~use_solve) & (Amat[..., 0, 0] > 0.0)

    # the branch not taken may hold inf/NaN (zero det or A00): where selects
    # it away before the scrub
    new_rho = torch.where(use_solve, rho_solve,
                          torch.where(use_shepard, rho_shepard, rho_old))
    # NaN scrub (reference :615, :618)
    new_rho = torch.where(torch.isnan(new_rho),
                          torch.full_like(new_rho, c.rho0), new_rho)
    new_rho = torch.where(bvalid, new_rho, rho_old)

    # fill slots all index row 0; every one of them writes the same value
    # (row 0's own corrected density when row 0 carries a ghost, else its
    # old density), so the scatter is deterministic
    density = particles.density.clone()
    density[bidx] = new_rho
    decision = use_solve.to(torch.int8) * 2 + use_shepard.to(torch.int8)
    return density, decision


def correct_density(spec: PhysicsSpec, grid: Grid, particles, bidx, bvalid, position,
                    density, motion_limiter, cell_start):
    """(corrected density array - a new tensor -, decision of every slot) of
    the compacted rows ``bidx`` of ``particles`` against the candidate arrays
    ``position``, ``density``, ``motion_limiter`` (the particles' own, or a
    slab's window with ``cell_start`` rebased to it).  CPU tensors: the
    plain moments and :func:`_mdbc_apply`.  CUDA tensors: the fused kernel,
    which parks the fill slots (their decision reads 0; the density is the
    same) - or an exception."""
    if position.device.type != "cpu":
        density, decision, _ = mdbc_correct(spec, grid, particles, bidx, bvalid, position,
                                            density, motion_limiter, cell_start)
        return density, decision
    gpoint = particles.ghost_points[bidx]                  # [B, D]
    bvec, Amat = mdbc_moments_plain(spec, grid, gpoint, bvalid, position, density,
                                    motion_limiter, cell_start)
    return _mdbc_apply(spec, particles, bidx, bvalid, gpoint, bvec, Amat)


def mdbc_density_correction(spec: PhysicsSpec, grid: Grid, particles, cell_start,
                            boundary_capacity: int):
    """Return the corrected density array.

    For every boundary particle with a nonzero ghost point: sum the moments
    b / A over the fluid neighbors of the ghost point, then (reference
    SPHCellList.jl:606-621):

      |det A| >= 1e-3 : rho = sol[0] + grad(rho) . (r_b - r_ghost)
      elif A[0,0] > 0 : Shepard fallback rho = b[0] / A[0,0]
      else            : the old density
      NaN             : rho0
    """
    bidx, bvalid = compact_ghosts(particles, boundary_capacity)
    return correct_density(spec, grid, particles, bidx, bvalid, particles.position,
                           particles.density, particles.motion_limiter, cell_start)[0]


def mdbc_density_correction_sharded(spec: PhysicsSpec, grid: Grid, particles,
                                    cell_start, boundary_capacity: int, ctx,
                                    halo: int):
    """The corrected density of one slab in a sharded run (port of
    ``sphexample_tpu/ops/mdbc.py:mdbc_density_correction_sharded``).

    Ghost-carrying boundary particles are slab-resident and their ghost
    points sit within about a cell of them, so every candidate range of a
    ghost's stencil lies in the window the sweeps already use (the rebuild
    telemetry of ``core/step.py`` counts the ghost windows' reach).  The three
    fields the moments read - position, density, motion limiter - are
    extended by the two halos (one 1-hop exchange; with ``halo = 0`` the
    all-gather), ``cell_start`` (global sorted rows) is rebased to the window,
    and :func:`correct_density` runs on the slab's own ghosts.  The list is
    compacted to the global ``boundary_capacity`` slots (the JAX package's
    static B), most of them fill slots on a slab: the fused kernel parks
    them, so a slab computes its own ghosts only."""
    bidx, bvalid = compact_ghosts(particles, boundary_capacity)
    (pos, rho, ml), _, ext_off = extend(
        ctx, (particles.position, particles.density, particles.motion_limiter), halo)
    cs_ext = rebase(cell_start, ext_off, pos.shape[0])
    return correct_density(spec, grid, particles, bidx, bvalid, pos, rho, ml, cs_ext)[0]
