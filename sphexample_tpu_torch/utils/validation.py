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


def case_readings(state, band=(950.0, 1150.0), allow_outliers: int = 0, hard_band=None,
                  track_marker=None, direction: int = 0, speed: float = 0.0,
                  duration: float = 1e30, track_tol: float = 1e-3,
                  origin=None) -> Dict[str, object]:
    """The readings and the verdict of ``tools/analyze_case.py`` on one state,
    reduced on the state's device and read back in one copy.

    Per snapshot: time ``t``, the fluid density range ``rho_min`` /
    ``rho_max``, ``vmax`` (the largest absolute velocity *component* over all
    live rows, the tool's |v|max), ``nan`` (NaNs in the live positions and
    the fluid density), ``out_band`` (fluid rows outside ``band``) and
    ``nonfinite`` (values not finite in position, velocity, acceleration,
    density or pressure on a live row).  ``bad`` counts the tool's failures
    of this snapshot and ``flags`` names them: ``"nan"``; ``"out_of_band"``
    (more than ``allow_outliers`` rows outside ``band``); ``"hard_band"``
    (at most that many, but one beyond ``hard_band``, by default ``band``
    widened by its half-width on each side); ``"off_trajectory"``.

    With ``track_marker``: ``x_body``, the mean position of the rows of that
    group marker along the state's axis ``direction`` (the tool's files hold
    a 2D state's z as their third axis), and ``body_err``, its distance from
    x0 + speed (min(t, duration) - min(t0, duration)).  ``origin`` is
    (x0, t0), the first snapshot's ``x_body`` and ``t``; without one this
    snapshot is the first (``body_err`` 0, as in the tool).
    :class:`CaseReader` keeps the origin across snapshots."""
    state = gather_state(state)
    p = state.particles
    fluid = p.active & (p.ptype == int(ParticleType.FLUID))
    rho, pos = p.density[fluid], p.position[p.active]
    lo, hi = band
    hlo, hhi = hard_band if hard_band is not None else (1.5 * lo - 0.5 * hi,
                                                        1.5 * hi - 0.5 * lo)
    nonfinite = sum((~torch.isfinite(getattr(p, f)[p.active])).sum() for f in _FINITE_FIELDS)
    vals = [rho.min().double(), rho.max().double(),
            p.velocity[p.active].abs().max().double(),
            (torch.isnan(pos).sum() + torch.isnan(rho).sum()).double(),
            ((rho < lo) | (rho > hi)).sum().double(), nonfinite.double(),
            state.total_time.double()]
    if track_marker is not None:
        body = p.active & (p.group_marker == int(track_marker))
        vals.append(p.position[body][:, direction].double().mean())
    vals = torch.stack(vals).cpu().tolist()
    rmin, rmax, vmax, nan, out_band, bad_values, t = vals[:7]
    out = {"t": t, "rho_min": rmin, "rho_max": rmax, "vmax": vmax, "nan": int(nan),
           "out_band": int(out_band), "nonfinite": int(bad_values)}
    flags = []
    if out["nan"]:
        flags.append("nan")
    if out["out_band"] > allow_outliers:
        flags.append("out_of_band")
    elif out["out_band"] and (rmin < hlo or rmax > hhi):
        flags.append("hard_band")
    if track_marker is not None:
        x = vals[7]
        if origin is None:
            err = 0.0
        else:
            x0, t0 = origin
            err = abs(x - (x0 + speed * (min(t, duration) - min(t0, duration))))
            if err > track_tol:
                flags.append("off_trajectory")
        out.update(x_body=x, body_err=err)
    out.update(bad=len(flags), flags=flags, ok=not flags)
    return out


class CaseReader:
    """:func:`case_readings` over the snapshots of one run: keeps the body's
    origin (x0, t0) from the first snapshot it reads, as the tool does, and
    every reading in ``readings``.  Call it as ``reader(state)``."""

    def __init__(self, **options):
        self.options = options
        self.origin = None
        self.readings = []

    def __call__(self, state) -> Dict[str, object]:
        r = case_readings(state, origin=self.origin, **self.options)
        if self.origin is None and "x_body" in r:
            self.origin = (r["x_body"], r["t"])
        self.readings.append(r)
        return r

    @property
    def bad(self) -> int:
        """The tool's count of bad snapshots (its ``FAIL (n bad snapshots)``)."""
        return sum(r["bad"] for r in self.readings)
