"""Density diffusion models, Fourtakas et al. 2019 family (port of
``sphexample_tpu/models/density_diffusion.py``).

Gather formulation: returns the diffusion contribution D to particle *i*'s
drho/dt for the pair (i, j).  The reference visits each unordered pair once
and sets D_j = -D_i, with a *cell-centric* role order (NeighborLoop!,
SPHCellList.jl:186-210): intra-cell pairs give the i role to the lower sorted
index, cross-cell pairs to the particle in the *later* cell.  ``i_is_role_i``
carries that flag; it selects the asymmetric m0/rho volume factor and, for
COMPLEX, the orientation of the (non-odd) inverse hydrostatic EOS.

Reference: ``src/SPHDensityDiffusionModels.jl:32-188``.
"""

from __future__ import annotations

import torch

from ..config import DensityDiffusionModel, SimulationConstants, SPHKernelInstance
from .equations import inverse_hydrostatic_eos


def linear_hydrostatic_constant(c) -> float:
    """C_lin with rho_h = C_lin * (z_i - z_j) for the LINEAR model: the
    linearized inverse EOS applied to P^H = rho0 (-g)(-x_ij[end])
    (reference SPHDensityDiffusionModels.jl:116-122).  The CUDA sweep reads
    this same constant."""
    return c.rho0 * (-c.g) * (-1.0) * ((1.0 / (c.Cb * c.gamma)) * c.rho0)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def compute_density_diffusion(
    model: DensityDiffusionModel,
    kernel: SPHKernelInstance,
    constants: SimulationConstants,
    xij,
    grad_w,
    d2,
    rho_i,
    rho_j,
    ml_i,
    ml_j,
    i_is_role_i,
):
    """Diffusion contribution to particle i's drho/dt (gather form)."""
    if model is DensityDiffusionModel.ZERO:
        return torch.zeros_like(rho_i)

    c = constants
    inv_d2 = 1.0 / (d2 + kernel.eta2)
    rho_ji = rho_j - rho_i

    if model is DensityDiffusionModel.ZERO_GRAVITY_LINEAR:
        # psi = 2 (rho_j - rho_i)(-x_ij) / (d^2 + eta^2); no hydrostatic term,
        # no MotionLimiter gate (reference SPHDensityDiffusionModels.jl:56-87)
        psi = (2.0 * rho_ji * inv_d2)[..., None] * (-xij)
        ml_gate = torch.ones_like(rho_i)
    else:
        # P_ij^H = rho0 (-g)(-x_ij[end]) (reference :121, :172)
        P_h = c.rho0 * (-c.g) * (-xij[..., -1])
        if model is DensityDiffusionModel.LINEAR:
            # linearized inverse EOS (reference :116-122)
            rho_h = P_h * ((1.0 / (c.Cb * c.gamma)) * c.rho0)
        elif model is DensityDiffusionModel.COMPLEX:
            # full inverse EOS (reference :172-173); not odd in P, so the
            # j-role endpoint evaluates the i-role orientation and flips sign
            rho_h = torch.where(
                i_is_role_i,
                inverse_hydrostatic_eos(c.rho0, P_h, c.Cb_inv),
                -inverse_hydrostatic_eos(c.rho0, -P_h, c.Cb_inv),
            )
        else:
            raise ValueError(f"unknown density diffusion model {model}")
        psi = (2.0 * (rho_ji - rho_h) * inv_d2)[..., None] * (-xij)
        # fluid-fluid pairs only (reference :130-132)
        ml_gate = ml_i * ml_j

    # asymmetric volume factor: m0 / rho_(j-role)
    vol = torch.where(i_is_role_i, c.m0 / rho_j, c.m0 / rho_i)
    return c.delta_sph * kernel.h * c.c0 * vol * _dot(psi, grad_w) * ml_gate
