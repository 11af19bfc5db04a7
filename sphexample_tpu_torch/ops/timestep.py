"""CFL-adaptive time stepping as device reductions (port of
``sphexample_tpu/ops/timestep.py``).

Reference: ``src/TimeStepping.jl:24-46``.
"""

from __future__ import annotations

import torch

from ..config import SimulationConstants, SPHKernelInstance
from ..parallel.context import SINGLE


def adaptive_dt(
    position,
    velocity,
    acceleration,
    constants: SimulationConstants,
    kernel: SPHKernelInstance,
    ctx=None,
):
    """dt = CFL * min(dt_force, dt_acoustic), as a 0-dim tensor.  Under a
    sharded ``ctx`` the two reductions go over every slab (``pmax`` /
    ``pmin``), so that all ranks step with the same dt.

    * viscous term: max over particles of |h (v . r) / (r . r + eta^2)| - the
      reference uses the *absolute position* r here, not pair distances
      (TimeStepping.jl:30-32); replicated faithfully.
    * force: dt1 = min sqrt(h / |a|), inf for zero acceleration (the
      reference's init=Inf; inactive padding has a = 0 and v = 0).
    * acoustic: dt2 = h / (c0 + visc).
    """
    ctx = ctx or SINGLE
    h = kernel.h
    v_dot_r = torch.sum(velocity * position, dim=-1)
    r_dot_r = torch.sum(position * position, dim=-1)
    visc = ctx.pmax(torch.max(torch.abs(h * v_dot_r / (r_dot_r + kernel.eta2))))

    acc_norm = torch.sqrt(torch.sum(acceleration * acceleration, dim=-1))
    inf = torch.full_like(acc_norm, float("inf"))
    dt1 = ctx.pmin(torch.min(torch.where(acc_norm > 0, torch.sqrt(h / acc_norm), inf)))

    dt2 = h / (constants.c0 + visc)
    return constants.cfl * torch.minimum(dt1, dt2)
