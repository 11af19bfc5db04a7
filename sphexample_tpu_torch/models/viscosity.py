"""Pairwise viscosity models: Zero, Artificial (Monaghan), Laminar,
Laminar+SPS (port of ``sphexample_tpu/models/viscosity.py``).

Gather formulation: each function returns the viscous acceleration
contribution to particle *i* only; the contribution to *j* comes when the
pair is revisited from *j*'s side (every term is role-swap invariant).
Reference: ``src/SPHViscosityModels.jl:51-126``.
"""

from __future__ import annotations

import torch

from ..config import SimulationConstants, SPHKernelInstance, ViscosityModel


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _artificial(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j):
    """Monaghan artificial viscosity (reference SPHViscosityModels.jl:56-74),
    active only for approaching pairs (v.x < 0):
    mu_ij = h (v.x) / (d^2 + eta^2);  Pi_i = -m0 (-alpha c0 mu_ij)/rho_bar * gradW."""
    v_dot_x = _dot(vij, xij)
    rho_bar = 0.5 * (rho_i + rho_j)
    mu = kernel.h * v_dot_x / (d2 + kernel.eta2)
    pi_fac = -constants.m0 * (-constants.alpha * constants.c0 * mu) / rho_bar
    pi_fac = torch.where(v_dot_x < 0, pi_fac, torch.zeros_like(pi_fac))
    return pi_fac[..., None] * grad_w


def _laminar(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j):
    """Laminar viscosity (reference SPHViscosityModels.jl:77-87):
    term = 4 m0 nu0 (x . gradW) / ((rho_i + rho_j) + (d^2 + eta^2)), with the
    reference's DualSPHysics-form ``+`` between the two denominators."""
    term = (4.0 * constants.m0 * constants.nu0 * _dot(xij, grad_w)) / (
        (rho_i + rho_j) + (d2 + kernel.eta2)
    )
    return term[..., None] * vij


def _laminar_sps(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j):
    """Laminar + Smagorinsky sub-particle-scale stress
    (reference SPHViscosityModels.jl:90-126), in the role-swap invariant
    forms S_i = (m0/rho_j) (v_j - v_i) gradW^T with tau built from rho_i,
    S_j = (m0/rho_i) (v_j - v_i) gradW^T with tau built from rho_j, and
    dtau/dt_i = (m0/(rho_i rho_j)) (tau_i + tau_j) . gradW."""
    t1 = _laminar(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j)

    m0 = constants.m0
    dx = constants.dx
    cs2_dx2 = (constants.smagorinsky_constant * dx) ** 2
    blin_dx2 = constants.blin_constant * dx * dx

    dv = -vij  # v_j - v_i
    eye = torch.eye(xij.shape[-1], dtype=xij.dtype, device=xij.device)

    def tau(rho_scale, rho_self):
        S = (m0 / rho_scale)[..., None, None] * (dv[..., :, None] * grad_w[..., None, :])
        norm_S = torch.sqrt(2.0 * torch.sum(S * S, dim=(-2, -1)))
        nu_t = cs2_dx2 * norm_S
        trace_S = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
        dev = S - (trace_S / 3.0)[..., None, None] * eye
        return (
            2.0 * (nu_t * rho_self)[..., None, None] * dev
            - (2.0 / 3.0) * (rho_self * blin_dx2 * norm_S * norm_S)[..., None, None] * eye
        )

    tau_i = tau(rho_j, rho_i)
    tau_j = tau(rho_i, rho_j)
    dtau_i = (m0 / (rho_i * rho_j))[..., None] * torch.einsum(
        "...ab,...b->...a", tau_i + tau_j, grad_w
    )
    return t1 + dtau_i


def compute_viscosity(
    model: ViscosityModel,
    kernel: SPHKernelInstance,
    constants: SimulationConstants,
    xij,
    vij,
    grad_w,
    d2,
    rho_i,
    rho_j,
):
    """Viscous acceleration contribution to particle i (gather form)."""
    if model is ViscosityModel.ZERO:
        return torch.zeros_like(xij)
    if model is ViscosityModel.ARTIFICIAL:
        return _artificial(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j)
    if model is ViscosityModel.LAMINAR:
        return _laminar(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j)
    if model is ViscosityModel.LAMINAR_SPS:
        return _laminar_sps(kernel, constants, xij, vij, grad_w, d2, rho_i, rho_j)
    raise ValueError(f"unknown viscosity model {model}")
