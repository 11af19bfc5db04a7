"""The plain reference of the benchmark: the weakly-compressible SPH step of
a configuration in plain PyTorch, written from the configuration file alone.

It is a frozen copy of the port's model equations and of the step's order
(reference SPHExample, ``src/SPHCellList.jl``): the lazy cell-list rebuild
(a stable sort by cell when the displacement accumulator reaches h, and the
stale cells' 3^D stencil between rebuilds), the CFL time step, the Tait
pressure, SIMPLE mDBC's boundary densities (``mdbc.py``), two neighbour
sweeps (continuity, LINEAR density diffusion with its cell-ordered roles,
pressure force, ARTIFICIAL or LAMINAR_SPS viscosity, PLANAR shifting's
sums), the symplectic predictor-corrector, the boundary clamps, prescribed
motion and PLANAR shifting.  It imports no part of the program and none of
its kernels: pairs come from a Verlet list of the stencil's candidates
(``pairs.py``), the sums from ``index_add_``.

It computes in the dtype it is given: float64 is the reference, the next
precision below the configuration's float32 (bfloat16) is the control.  The
simulation clock (the time and its comparison with the output time) is kept
in float32 at least: a bfloat16 clock cannot pass 0.5 s in steps of 1e-4 s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .pairs import PairList

FLUID, FIXED, MOVING = 1, 2, 3
GRID_MARGIN_CELLS = 6


@dataclass(frozen=True)
class Physics:
    """Every constant of a configuration, derived as SPHExample derives its
    defaults (``SimulationConstantsConfiguration.jl``, ``SPHKernels.jl``)."""

    dims: int
    dx: float
    rho0: float
    m0: float
    g: float
    c0: float
    gamma: float
    delta: float
    cfl: float
    Cb: float
    alpha: float
    nu0: float
    blin: float
    smag: float
    h: float
    H: float
    alpha_d: float
    eta2: float
    viscosity: str
    diffusion: str
    shifting: bool
    motion: tuple      # (marker, speed, start, end, direction) per moving body
    mdbc: bool = False

    @property
    def H2(self) -> float:
        return self.H * self.H


def physics(config: dict) -> Physics:
    c, k, m = config["constants"], config["kernel"], config["models"]
    if k["family"] != "wendland_c2":
        raise NotImplementedError(f"kernel family {k['family']}")
    if m["diffusion"] != "linear" or m["viscosity"] not in ("artificial", "laminar_sps"):
        raise NotImplementedError(f"model set {m}")
    if m["mdbc"] not in ("none", "simple") or m["kernel_output"] != "none":
        raise NotImplementedError(f"mode set {m}")
    dims = k["dims"]
    dx, rho0, g = c["dx"], c.get("rho0", 1000.0), c.get("g", 9.81)
    gamma = c.get("gamma", 7.0)
    c0 = c.get("c0", math.sqrt(2 * g) * 20)
    kk = k.get("k", 2.0)
    h = kk * k["dx"] if "dx" in k else k["h"]
    alpha_d = 7 / (4 * math.pi * h**2) if dims == 2 else 21 / (16 * math.pi * h**3)
    motion = tuple((mo["marker"], mo["velocity"], mo["start_time"],
                    mo["start_time"] + mo["duration"], tuple(mo["direction"]))
                   for mo in config.get("motion", ()))
    return Physics(
        dims=dims, dx=dx, rho0=rho0, m0=c.get("m0", rho0 * dx**2), g=g, c0=c0,
        gamma=gamma, delta=c.get("delta_sph", 0.1), cfl=c.get("cfl", 0.2),
        Cb=c.get("Cb", c0**2 * rho0 / gamma), alpha=c.get("alpha", 0.01),
        nu0=c.get("nu0", 1e-6), blin=c.get("blin_constant", 0.0066),
        smag=c.get("smagorinsky_constant", 0.12), h=h, H=kk * h, alpha_d=alpha_d,
        eta2=(0.01 * h) ** 2, viscosity=m["viscosity"], diffusion=m["diffusion"],
        shifting=m["shifting"] == "planar", motion=motion, mdbc=m["mdbc"] == "simple")


def map_floor(x, inv):
    """Round half away from zero onto the cell grid of pitch 1 / ``inv``."""
    if isinstance(x, np.ndarray):
        return (np.sign(x) * np.trunc(np.abs(x) * inv + 0.5)).astype(np.int64)
    return (torch.sign(x) * torch.trunc(torch.abs(x) * inv + 0.5)).to(torch.int64)


@dataclass(frozen=True)
class Grid:
    cmin: tuple
    shape: tuple

    @classmethod
    def around(cls, position: np.ndarray, P: Physics) -> "Grid":
        """The static grid of the initial positions, six cells of margin."""
        c = map_floor(position, 1.0 / P.H)
        lo = c.min(axis=0) - GRID_MARGIN_CELLS
        hi = c.max(axis=0) + GRID_MARGIN_CELLS
        return cls(tuple(int(v) for v in lo), tuple(int(v) for v in hi - lo + 1))

    @property
    def ncells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def strides(self) -> tuple:
        s = [1]
        for n in self.shape[:-1]:
            s.append(s[-1] * n)
        return tuple(s)

    def cells(self, points, P: Physics):
        """(cell, key): each point's cell of pitch H, clamped into the grid and
        relative to it, and the cell's linear key (x fastest)."""
        dev = points.device
        lo = torch.tensor(self.cmin, device=dev)
        hi = lo + torch.tensor(self.shape, device=dev) - 1
        cell = torch.minimum(torch.maximum(map_floor(points, 1.0 / P.H), lo), hi) - lo
        return cell, (cell * torch.tensor(self.strides, device=dev)).sum(-1)

    def starts(self, key):
        """[ncells + 1]: each cell's first row among rows sorted by ``key``."""
        start = torch.zeros(self.ncells + 1, dtype=torch.int64, device=key.device)
        start[1:] = torch.cumsum(torch.bincount(key, minlength=self.ncells), 0)
        return start


class State:
    """Rows in the current sorted order; ``ids`` names them.  ``ghost``
    [n, D]: each row's ghost point (zero where it has none), with mDBC."""

    def __init__(self, P: Physics, ids, ptype, marker, pos, vel, acc, rho, t,
                 iteration: int, dtype, device, ghost=None):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(device, dtype)  # noqa: E731
        self.ids = torch.as_tensor(np.asarray(ids, np.int64), device=device)
        self.ptype = torch.as_tensor(np.asarray(ptype, np.int64), device=device)
        marker = torch.as_tensor(np.asarray(marker, np.int64), device=device)
        self.pos, self.vel, self.acc, self.rho = f(pos), f(vel), f(acc), f(rho)
        self.ghost = None if ghost is None else f(ghost)
        self.fields = ("ids", "ptype", "pos", "vel", "acc", "rho", "ml", "gf", "moving",
                       "speed", "t0", "t1", "dir") + (() if ghost is None else ("ghost",))
        self.pos_half = self.pos.clone()
        self.ml = (self.ptype == FLUID).to(dtype)
        self.gf = torch.where(self.ptype == FLUID, -1.0,
                              torch.where(self.ptype == MOVING, 1.0, 0.0)).to(dtype)
        n, d = self.pos.shape
        self.moving = torch.zeros(n, dtype=torch.bool, device=device)
        self.speed = torch.zeros(n, dtype=dtype, device=device)
        self.t0 = torch.zeros(n, dtype=dtype, device=device)
        self.t1 = torch.zeros(n, dtype=dtype, device=device)
        self.dir = torch.zeros(n, d, dtype=dtype, device=device)
        for mk, speed, t0, t1, direction in P.motion:
            rows = (marker == mk) & (self.ptype == MOVING)
            self.moving |= rows
            self.speed[rows], self.t0[rows], self.t1[rows] = speed, t0, t1
            self.dir[rows] = torch.tensor(direction, dtype=dtype, device=device)
        self.cell = torch.zeros(n, d, dtype=torch.int64, device=device)
        self.key = torch.zeros(n, dtype=torch.int64, device=device)
        clock = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
        self.t = torch.tensor(float(t), dtype=clock, device=device)
        self.iteration = int(iteration)
        self.rebuilds = 0

    def permute(self, perm):
        for name in self.fields:
            setattr(self, name, getattr(self, name)[perm])

    def numpy(self) -> dict:
        """The state by id order, as float64 numpy."""
        order = torch.argsort(self.ids)
        g = lambda a: a[order].double().cpu().numpy()  # noqa: E731
        return dict(id=self.ids[order].cpu().numpy(), position=g(self.pos),
                    velocity=g(self.vel), density=g(self.rho),
                    total_time=float(self.t), iteration=self.iteration,
                    rebuilds=self.rebuilds)


def eos(rho, P: Physics):
    r = rho / P.rho0
    r2 = r * r
    return ((P.c0 * P.c0 * P.rho0) / 7.0) * (r2 * r2 * r2 * r - 1.0)


def clamp_boundary(rho, ml, P: Physics):
    return torch.where((ml == 0) & (rho < P.rho0), torch.full_like(rho, P.rho0), rho)


def motion(s: State, pos, vel, dt2):
    """Assign the prescribed velocity (zero outside its inclusive window) to
    the moving rows and advance them by dt / 2."""
    if not bool(s.moving.any()):
        return pos, vel
    on = ((s.t0 <= s.t) & (s.t <= s.t1)).to(pos.dtype)
    v = (s.speed * on)[:, None] * s.dir
    m = s.moving[:, None]
    return torch.where(m, pos + v * dt2, pos), torch.where(m, v, vel)


def time_step(s: State, P: Physics):
    v_dot_r = (s.vel * s.pos).sum(-1)
    r_dot_r = (s.pos * s.pos).sum(-1)
    visc = torch.max(torch.abs(P.h * v_dot_r / (r_dot_r + P.eta2)))
    a = torch.sqrt((s.acc * s.acc).sum(-1))
    dt1 = torch.min(torch.where(a > 0, torch.sqrt(P.h / a), torch.full_like(a, math.inf)))
    return P.cfl * torch.minimum(dt1, P.h / (P.c0 + visc))


def sweep(P: Physics, s: State, pairs: PairList, pos, rho, prs, vel, chunk: int = 1 << 23):
    """One neighbour sweep: (drho/dt, dv/dt, grad C, div r) per row, summed
    over the pairs of the stale stencil inside the support."""
    n, d = pos.shape
    drho = torch.zeros(n, dtype=pos.dtype, device=pos.device)
    acc = torch.zeros(n, d, dtype=pos.dtype, device=pos.device)
    grad_c = torch.zeros_like(acc) if P.shifting else None
    div_r = torch.zeros_like(drho) if P.shifting else None
    I_all, J_all = pairs.within(pos, P.H2)
    m0, h = P.m0, P.h
    for c0 in range(0, I_all.numel(), chunk):
        i, j = I_all[c0:c0 + chunk], J_all[c0:c0 + chunk]
        xij = pos[i] - pos[j]
        d2 = (xij * xij).sum(-1)
        q = torch.clamp(torch.sqrt(d2) / h, 0.0, 2.0)
        t = q - 2.0
        gw = (P.alpha_d * 5.0 * (t * t * t) / (8.0 * h * h))[:, None] * xij
        vij = vel[i] - vel[j]
        rho_i, rho_j = rho[i], rho[j]
        ml_i, ml_j = s.ml[i], s.ml[j]
        # continuity
        dr = -rho_i * (m0 / rho_j) * (-(vij * gw).sum(-1))
        # LINEAR density diffusion; roles by cell, then by sorted row
        rho_h = (P.rho0 * (-P.g) * (-xij[:, -1])) * ((1.0 / (P.Cb * P.gamma)) * P.rho0)
        psi = (2.0 * ((rho_j - rho_i) - rho_h) / (d2 + P.eta2))[:, None] * (-xij)
        same = s.key[i] == s.key[j]
        role_i = torch.where(same, i < j, i > j)
        vol = torch.where(role_i, m0 / rho_j, m0 / rho_i)
        dr = dr + P.delta * h * P.c0 * vol * (psi * gw).sum(-1) * (ml_i * ml_j)
        # pressure force (Wendland C2: no tensile term)
        dv = (-m0 * ((prs[i] + prs[j]) / (rho_i * rho_j)))[:, None] * gw
        if P.viscosity == "artificial":
            v_dot_x = (vij * xij).sum(-1)
            mu = h * v_dot_x / (d2 + P.eta2)
            pi = -m0 * (-P.alpha * P.c0 * mu) / (0.5 * (rho_i + rho_j))
            dv = dv + torch.where(v_dot_x < 0, pi, torch.zeros_like(pi))[:, None] * gw
        else:
            dv = dv + _laminar_sps(P, xij, vij, gw, d2, rho_i, rho_j)
        drho.index_add_(0, i, dr)
        acc.index_add_(0, i, dv)
        if P.shifting:
            grad_c.index_add_(0, i, (m0 / rho_i)[:, None] * gw)
            div_r.index_add_(0, i, (m0 / rho_j) * (-(xij * gw).sum(-1)) * (ml_i * ml_j))
    return drho, acc, grad_c, div_r


def _laminar_sps(P: Physics, xij, vij, gw, d2, rho_i, rho_j):
    """Laminar viscosity plus the Smagorinsky sub-particle stress, in the
    role-swap invariant form of SPHExample's ``SPHViscosityModels.jl``."""
    m0 = P.m0
    lam = (4.0 * m0 * P.nu0 * (xij * gw).sum(-1)) / ((rho_i + rho_j) + (d2 + P.eta2))
    out = lam[:, None] * vij
    cs2 = (P.smag * P.dx) ** 2
    blin = P.blin * P.dx * P.dx
    dvel = -vij
    eye = torch.eye(xij.shape[1], dtype=xij.dtype, device=xij.device)

    def tau(rho_scale, rho_self):
        S = (m0 / rho_scale)[:, None, None] * (dvel[:, :, None] * gw[:, None, :])
        norm = torch.sqrt(2.0 * (S * S).sum((-2, -1)))
        trace = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
        dev = S - (trace / 3.0)[:, None, None] * eye
        return (2.0 * (cs2 * norm * rho_self)[:, None, None] * dev
                - (2.0 / 3.0) * (rho_self * blin * norm * norm)[:, None, None] * eye)

    taus = tau(rho_j, rho_i) + tau(rho_i, rho_j)
    return out + (m0 / (rho_i * rho_j))[:, None] * torch.einsum("pab,pb->pa", taus, gw)


def rebuild(s: State, grid: Grid, P: Physics, pairs: PairList):
    """Stage 02's rebuild: cells of the current positions clamped into the
    grid, a stable sort by linear key (x fastest), the stencil's pairs."""
    cell, key = grid.cells(s.pos, P)
    perm = torch.argsort(key, stable=True)
    s.permute(perm)
    s.cell, s.key = cell[perm], key[perm]
    s.rebuilds += 1
    pairs.rebuild(s.cell, s.key, grid, s.pos)


def step(P: Physics, grid: Grid, s: State, pairs: PairList, dx_acc):
    disp2 = ((s.pos_half - s.pos) ** 2).sum(-1)
    dx_acc = dx_acc + 4.0 * torch.sqrt(torch.max(disp2))
    dt = time_step(s, P)
    dt2 = dt * 0.5
    if bool(dx_acc >= P.h):
        rebuild(s, grid, P, pairs)
        dx_acc = torch.zeros_like(dx_acc)

    pos, vel = motion(s, s.pos, s.vel, dt2)
    prs = eos(s.rho, P)
    if P.mdbc:
        from . import mdbc

        s.rho = mdbc.correct(P, grid, pairs.start, s.ghost, pos, s.rho, s.ptype == FLUID)
    drho, acc, _, _ = sweep(P, s, pairs, pos, s.rho, prs, vel)
    acc[:, -1] += P.g * s.gf
    ml = s.ml[:, None]
    pos_half = pos + vel * dt2 * ml
    vel_half = vel + acc * dt2 * ml
    rho_half = clamp_boundary(s.rho + drho * dt2, s.ml, P)
    pos, vel = motion(s, pos, vel, dt2)
    drho2, acc2, grad_c, div_r = sweep(P, s, pairs, pos_half, rho_half, eos(rho_half, P),
                                       vel_half)

    rho = clamp_boundary(s.rho, s.ml, P)
    nz = rho_half != 0
    eps = -torch.where(nz, drho2 / torch.where(nz, rho_half, torch.ones_like(rho_half)),
                       torch.zeros_like(rho_half)) * dt
    rho = rho * (2.0 - eps) / (2.0 + eps)
    acc2[:, -1] += P.g * s.gf
    vel_new = vel + acc2 * dt * ml
    dpos = 0.5 * (vel_new + (vel_new - acc2 * dt * ml)) * dt
    if P.shifting:
        a_fsc = div_r / float(P.dims)
        vmag = torch.sqrt((vel_new * vel_new).sum(-1))
        shift = (-a_fsc * 2.0 * P.h * vmag * dt)[:, None] * grad_c
        dpos = dpos + torch.where(a_fsc[:, None] < 0, torch.zeros_like(shift), shift)
    s.pos, s.vel, s.acc, s.rho = pos + dpos * ml, vel_new, acc2, rho
    s.pos_half = pos_half
    s.t = s.t + dt.to(s.t.dtype)
    s.iteration += 1
    return dx_acc


class Stalled(RuntimeError):
    """The interval took no step, or far more than it should have."""


def run_interval(P: Physics, grid: Grid, s: State, t_out: float, max_steps: int) -> int:
    """Steps while the time, in the state's dtype, is at most ``t_out`` in
    that dtype; the first step rebuilds.  Returns the steps taken."""
    dtype = s.pos.dtype
    t_end = float(torch.tensor(t_out, dtype=s.t.dtype))
    dx_acc = torch.tensor(1.0 + P.h, dtype=dtype, device=s.pos.device)
    pairs = PairList(P)
    steps = 0
    while float(s.t) <= t_end:
        t_before = float(s.t)
        dx_acc = step(P, grid, s, pairs, dx_acc)
        steps += 1
        if not float(s.t) > t_before or steps > max_steps:
            raise Stalled(f"{steps} steps to t = {float(s.t)} of {t_end}")
    return steps
