"""SPH smoothing kernels: Wendland C2 and cubic spline (port of
``sphexample_tpu/models/kernels.py``).

Shape-polymorphic tensor functions; all scalars come precomputed from the
static :class:`~sphexample_tpu_torch.config.SPHKernelInstance`.
Reference: ``src/SPHKernels.jl:75-126``.
"""

from __future__ import annotations

import torch

from ..config import KernelFamily, SPHKernelInstance


def W(kernel: SPHKernelInstance, q):
    """Kernel value W(q) with q = d/h in [0, 2].

    Wendland C2: alpha_d (1 - q/2)^4 (2q + 1)   (reference SPHKernels.jl:75-78)
    Cubic spline: piecewise cubic               (reference SPHKernels.jl:89-92)
    """
    aD = kernel.alpha_d
    if kernel.family is KernelFamily.WENDLAND_C2:
        t = 1.0 - 0.5 * q
        t2 = t * t
        return aD * (t2 * t2) * (2.0 * q + 1.0)
    # branchless: indicator masks mirror the reference's boolean products
    inner = (1.0 - 1.5 * q * q + 0.75 * q * q * q) * ((q >= 0) & (q <= 1))
    t = 2.0 - q
    outer = 0.25 * (t * t * t) * ((q > 1) & (q <= 2))
    return aD * (inner + outer)


def grad_W(kernel: SPHKernelInstance, q, xij):
    """Kernel gradient with respect to particle i: a vector along x_ij.

    Wendland C2: alpha_d * 5 (q-2)^3 / (8 h^2) * x_ij
    (reference SPHKernels.jl:80-87).
    Cubic spline: dW/dq * (1/h) * x_ij / (|x_ij| + eta^2)
    (reference SPHKernels.jl:94-110).

    ``q`` broadcasts against the leading axes of ``xij`` (last axis = dims).
    """
    aD = kernel.alpha_d
    if kernel.family is KernelFamily.WENDLAND_C2:
        t = q - 2.0
        factor = aD * 5.0 * (t * t * t) / (8.0 * kernel.h * kernel.h)
        return factor[..., None] * xij
    dwdq_inner = aD * (-3.0 * q + 2.25 * q * q)
    t = 2.0 - q
    dwdq_outer = aD * (-0.75) * (t * t)
    dwdq = torch.where(
        (q >= 0) & (q <= 1),
        dwdq_inner,
        torch.where((q > 1) & (q <= 2), dwdq_outer, torch.zeros_like(q)),
    )
    r = torch.sqrt(torch.sum(xij * xij, dim=-1))
    factor = dwdq * kernel.h_inv / (r + kernel.eta2)
    return factor[..., None] * xij


def tensile_correction(kernel: SPHKernelInstance, P_i, rho_i, P_j, rho_j, q, dx, n: int = 4):
    """Tensile-instability correction term f_ab: zero for Wendland C2
    (reference SPHKernels.jl:115-117); for the cubic spline
    eps * ((P_i/rho_i^2) + (P_j/rho_j^2)) * (W(q)/W(dx))^n
    (reference SPHKernels.jl:119-126, which evaluates W at the *raw
    distance* dx rather than dx/h - replicated as-is)."""
    if kernel.family is KernelFamily.WENDLAND_C2:
        return torch.zeros_like(q)
    w_q = W(kernel, q)
    w_dx = W(kernel, torch.as_tensor(dx, dtype=q.dtype, device=q.device))
    ratio = w_q / w_dx
    return kernel.cubic_eps * ((P_i / (rho_i * rho_i)) + (P_j / (rho_j * rho_j))) * ratio**n
