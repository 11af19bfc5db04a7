"""Core WCSPH equations: Tait EOS, symplectic density corrector, boundary
clamp (port of ``sphexample_tpu/models/equations.py``).

Reference: ``src/SimulationEquations.jl``.
"""

from __future__ import annotations

import torch

from ..config import SimulationConstants


def equation_of_state_gamma7(rho, c0, rho0):
    """Tait EOS with the gamma=7 fast path (reference SimulationEquations.jl:9-11):
    P = (c0^2 rho0 / 7) ((rho/rho0)^7 - 1).  Like the reference, ``Pressure!``
    always calls this form; the gamma constant is dead at runtime."""
    r = rho / rho0
    r2 = r * r
    r4 = r2 * r2
    return ((c0 * c0 * rho0) / 7.0) * (r4 * r2 * r - 1.0)


def equation_of_state(rho, c0, gamma, rho0):
    """Generic-gamma Tait EOS (reference SimulationEquations.jl:14-16)."""
    return ((c0 * c0 * rho0) / gamma) * ((rho / rho0) ** gamma - 1.0)


def pressure(rho, constants: SimulationConstants):
    """Pressure from density (reference SimulationEquations.jl:18-24)."""
    return equation_of_state_gamma7(rho, constants.c0, constants.rho0)


def density_epsi(density, drhodt, rho_half, dt):
    """Symplectic density corrector (reference SimulationEquations.jl:28-33):
    epsilon = -(drhodt / rho_half) dt;  rho *= (2 - eps) / (2 + eps).
    The division is guarded so inactive padding (rho == 0) stays finite."""
    nz = rho_half != 0
    ratio = torch.where(nz, drhodt / torch.where(nz, rho_half, torch.ones_like(rho_half)),
                        torch.zeros_like(rho_half))
    eps = -ratio * dt
    return density * (2.0 - eps) / (2.0 + eps)


def limit_density_at_boundary(density, rho0, motion_limiter):
    """Clamp boundary-particle density to >= rho0 where the motion limiter is
    zero (reference SimulationEquations.jl:36-42)."""
    is_boundary = motion_limiter == 0
    return torch.where(is_boundary & (density < rho0),
                       torch.full_like(density, rho0), density)


def gravity_vector_last_axis(template, value):
    """A vector like ``template`` with ``value`` in the last component
    (gravity acts on the last axis, reference SimulationEquations.jl:44-46)."""
    out = torch.zeros_like(template)
    out[..., -1] = value
    return out


def inverse_hydrostatic_eos(rho0, P, Cb_inv):
    """rho = rho0 (((1 + P/Cb))^(1/7) - 1) (reference SimulationEquations.jl:63),
    as a plain power (the reference's bit-trick 7th root is a CPU speed hack);
    odd root via copysign like the reference's Estimate7thRoot."""
    x = 1.0 + P * Cb_inv
    root = torch.sign(x) * torch.abs(x) ** (1.0 / 7.0)
    return rho0 * (root - 1.0)
