"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/``) run from the same inputs.

Two intervals of a window's first pass are compared, each as a state at its
output time matched row by row through the particle ids:

* ``first``: the first output interval, the reference stepping from the
  deck's initial arrays (the start of every run);
* ``later``: an output interval of the first pass drawn from the seed, the
  reference stepping from the program's own state at the output before it
  (a reference from t = 0 would take thousands of steps).

Per interval: the steps taken (exact), the largest position gap in particle
spacings, the largest velocity gap over the largest reference speed, the
largest density gap over the largest departure of the reference's density
from rho0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import sph

FIELDS = ("steps", "pos_gap", "vel_gap", "rho_gap")


def port_numpy(state) -> dict:
    """A state of the program, by id order, as float64 numpy."""
    p = state.particles
    order = torch.argsort(p.id)
    g = lambda a: a[order].double().cpu().numpy()  # noqa: E731
    return dict(id=p.id[order].cpu().numpy().astype(np.int64), position=g(p.position),
                velocity=g(p.velocity), acceleration=g(p.acceleration),
                density=g(p.density), total_time=float(state.total_time),
                iteration=int(state.iteration))


def gaps(got: dict, ref: dict, steps_got: int, steps_ref: int, P) -> dict:
    """The four numbers of one interval; NaN where either side gave none (a
    reference or a control that stalled)."""
    if got is None or ref is None or not np.array_equal(got["id"], ref["id"]):
        return {f: math.nan for f in FIELDS}
    v_scale = np.abs(ref["velocity"]).max()
    r_scale = np.abs(ref["density"] - P.rho0).max()
    with np.errstate(invalid="ignore", divide="ignore"):
        return {
            "steps": float(abs(steps_got - steps_ref)),
            "pos_gap": float(np.abs(got["position"] - ref["position"]).max() / P.dx),
            "vel_gap": float(np.abs(got["velocity"] - ref["velocity"]).max() / v_scale),
            "rho_gap": float(np.abs(got["density"] - ref["density"]).max() / r_scale),
        }


def deck_ghosts(arrays) -> np.ndarray:
    """Each deck row's ghost point, by id order: the deck's ghost points on
    its first rows (ids 1..nb), zero on the others."""
    ghost = np.zeros_like(arrays[0])
    ghost[:len(arrays[5])] = arrays[5]
    return ghost


def reference_interval(config, arrays, start: dict, t_out: float, max_steps: int,
                       dtype=torch.float64, device="cuda"):
    """The reference's state at ``t_out`` and its steps, stepping from
    ``start`` (None: the deck's initial arrays at t = 0); (None, 0) where it
    stalls.  ``arrays``: the deck's (``harness.deck_arrays``), with mDBC its
    ghost points too, never the program's."""
    P = sph.physics(config)
    position, density, ptype, marker, ids = arrays[:5]
    grid = sph.Grid.around(position, P)
    ghost = deck_ghosts(arrays) if P.mdbc else None
    if start is None:
        zeros = np.zeros_like(position)
        s = sph.State(P, ids, ptype, marker, position, zeros, zeros, density, 0.0, 0,
                      dtype, device, ghost)
    else:
        rows = start["id"] - 1                  # ids run from 1 in the deck's order
        s = sph.State(P, start["id"], ptype[rows], marker[rows], start["position"],
                      start["velocity"], start["acceleration"], start["density"],
                      start["total_time"], start["iteration"], dtype, device,
                      None if ghost is None else ghost[rows])
        if "order" in start:                    # the program's row order
            s.permute(torch.as_tensor(start["order"], device=device))
    try:
        steps = sph.run_interval(P, grid, s, t_out, max_steps)
    except sph.Stalled:
        return None, 0
    return s.numpy(), steps


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at most its limit (a
    NaN fails)."""
    rows = [(name, readings.get(name, math.nan), limit) for name, limit in limits.items()]
    ok = all(v <= lim for _, v, lim in rows)    # NaN <= x is False
    return ok, rows
