"""Determinism and precision validation (port of
``sphexample_tpu/utils/validation.py``).

The reference avoids data races by construction (per-thread accumulators,
SURVEY.md section 5.2); the port's kernels compute each pair from both
endpoints and write each output once, with no atomics in any sum, so the
check here is explicit: the same state in gives the same bits out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import ParticleType
from ..state import gather_state, state_tensors


def check_determinism(sim, n_steps: int = 5) -> bool:
    """Run ``n_steps`` twice from the same state through
    ``make_fixed_steps_fn``; True when every tensor of the two end states is
    equal bit for bit (and the host's rebuild count agrees).

    On the card this holds for the kernels (block sweep, cell sweep, mDBC
    moments): each output is written once, in a fixed order.  It need not
    hold for the plain versions, whose pair sums go through ``index_add_``:
    PyTorch documents that op as nondeterministic on CUDA tensors and makes
    no promise of order on the CPU either (single-threaded CPU runs have
    been bit for bit so far, but nothing pins that)."""
    from ..core.step import make_fixed_steps_fn

    if isinstance(sim.state, tuple):
        raise ValueError("check_determinism takes a single-device simulation")
    run = make_fixed_steps_fn(sim.cfg, n_steps)
    a = run(sim.state)
    b = run(sim.state)
    if a.rebuilds != b.rebuilds:
        return False
    ta, tb = state_tensors(a), state_tensors(b)
    return all(torch.equal(ta[k], tb[k]) for k in ta)


def compare_states(state_a, state_b, n_live: int) -> Dict[str, float]:
    """Max relative field differences between two runs, matched by particle
    ID (orders may differ; a tuple of slab states is gathered first).  Use
    to quantify fp32-vs-fp64 drift."""
    out = {}

    def host(state, field):
        p = gather_state(state).particles
        return getattr(p, field).detach().cpu().numpy()

    def order(state):
        ids = host(state, "id")
        o = np.argsort(ids)
        return o[ids[o] > 0]

    oa, ob = order(state_a), order(state_b)
    for field in ("position", "velocity", "density", "pressure"):
        a = host(state_a, field).astype(np.float64)[oa]
        b = host(state_b, field).astype(np.float64)[ob]
        scale = np.abs(b).max() + 1e-30
        out[field] = float(np.abs(a - b).max() / scale)
    return out


_FINITE_FIELDS = ("position", "velocity", "acceleration", "density", "pressure")


def dam_break_readings(state, L: float = 0.4, g: float = 9.81) -> Dict[str, float]:
    """The dam-break readings of ``tools/analyze_dambreak.py`` on one state,
    reduced on the state's device and read back in one copy: time ``t`` and
    ``T`` = t sqrt(2 g / L), the front ``x_front`` (the fluid's largest x)
    and ``X`` = x_front / L (``L`` the column's initial width), the fluid's
    density range, its largest speed ``vmax``, ``nan`` (NaNs in the fluid's
    density and positions, the tool's count) and ``nonfinite`` (values not
    finite in position, velocity, acceleration, density or pressure on a
    live row)."""
    state = gather_state(state)
    p = state.particles
    fluid = p.active & (p.ptype == int(ParticleType.FLUID))
    rho, pos, vel = p.density[fluid], p.position[fluid], p.velocity[fluid]
    nonfinite = sum((~torch.isfinite(getattr(p, f)[p.active])).sum() for f in _FINITE_FIELDS)
    vals = torch.stack([
        pos[:, 0].max().double(), rho.min().double(), rho.max().double(),
        torch.sqrt((vel * vel).sum(-1)).max().double(),
        (torch.isnan(rho).sum() + torch.isnan(pos).sum()).double(),
        nonfinite.double(), state.total_time.double()]).cpu().tolist()
    xf, rmin, rmax, vmax, nan, bad, t = vals
    return {"t": t, "T": t * float(np.sqrt(2 * g / L)), "x_front": xf, "X": xf / L,
            "rho_min": rmin, "rho_max": rmax, "vmax": vmax, "nan": int(nan),
            "nonfinite": int(bad)}

