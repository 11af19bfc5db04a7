#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   - the card's name and power limit (no GPU: exit 1, no result);
2. build    - nvcc builds every ``sphexample_tpu_torch/csrc/*.cu``, one
              process per source, all started together;
3. parity   - the block-sweep kernel against its plain PyTorch version on one
              sweep of the 3D dam break (dx 0.0085, fluid velocity (0,0,-1))
              and the 2D dam break (dx 0.01); relative-to-field-max
              differences must stay below 1e-4;
4. run      - the 3D dam break at dx 0.0085 (159,712 particles): 10 warm-up
              steps, then 200 timed steps through ``make_fixed_steps_fn``,
              with the physics checks (finite fields, fluid density within
              2% of rho0, the column falling, fixed walls unmoved) and the
              launch count (exactly 2 per step);
5. breakdown - where a step's time goes: the sweep kernel, the rebuild and
              the rest, timed with CUDA events, and the device busy share
              over a profiled window;
6. parity_after_run - phase 3's comparison on the state the run ends in;
7. parity_mdbc_3d, parity_mdbc_2d - the mDBC moment kernel against its plain
              PyTorch version on the three-layer mDBC dam break (3D at dx
              0.0085: 131,736 ghost-carrying boundary particles + 117,300
              fluid; 2D at dx 0.01), fluid densities perturbed from a seeded
              generator; every moment column must agree below 1e-4 of the
              column's max, and the solve / Shepard / keep decisions and the
              corrected densities are compared with the rows within a hair
              of the |det| threshold counted and printed;
              parity_sweep_mdbc_3d - the block-sweep kernel against its plain
              version on that 3D state as the first sweep of a step sees it
              (pressure from the uncorrected density, then the mDBC correction,
              fluid velocity (0,0,-1));
8. run_mdbc - the 3D mDBC dam break (249,036 particles): 10 warm-up steps,
              then 200 timed steps, with the physics checks of phase 4,
              some boundary density moved off rho0 (the correction fired),
              no grid escapes, and the launch counts (exactly 1 mDBC launch
              and 2 block-sweep launches per step);
9. breakdown_mdbc - phase 5 for the mDBC run, with stage 04 timed;
10. parity_mdbc_after_run, parity_sweep_mdbc_after_run - phase 7's comparisons
              on the state the run ends in;
11. parity_cell_3d, parity_cell_2d (with phase 3) - the cell-sweep kernel
              against its plain version on the states of phase 3 and on stirred
              copies of them (seeded density and velocity noise);
              parity_cell_modes_3d, parity_cell_modes_2d - every viscosity x
              density diffusion x kernel family with PLANAR shifting and
              kernel output STORE on the stirred states, all six fields below
              1e-4 of the field's max;
12. run_large - the 3D dam break at dx 0.0034 (2,215,035 particles) through
              ``assemble_simulation`` with its defaults: the capacity rule must
              pick the cell sweep on its own.  10 warm-up + 200 timed steps,
              the physics checks of phase 4, exactly 2 cell-sweep and 0
              block-sweep launches per step, the kernel against its plain
              version before and after the run (parity_cell_large,
              parity_cell_large_after_run);
13. breakdown_large - phase 5 for the large run and, for the record only, the
              block-sweep kernel launched directly on the same end state: its
              time and its parity with the plain version;
14. run_moving_square - a procedural 2D moving-square case (262,276
              particles: a closed box of three fixed wall layers, 2.56 m x
              1.60 m inside at dp 0.004, filled with fluid around a solid
              0.2 m square of MOVING particles translating at 2.8 m/s in +x;
              the constants, kernel and models of examples/moving_square_2d.py:
              Wendland C2 with k = sqrt 2, LAMINAR_SPS, LINEAR, PLANAR, STORE,
              g = 0, f32, ``block_sweep=False``): 10 + 200 steps; the square on
              its prescribed track, walls still, finite fields, the fluid
              density within 1.5 v / c0 = 15 % of rho0 (an impulsively started
              body compresses the fluid ahead of it by about v / c0), a shift
              applied near the body, kernel sums
              positive on the fluid, 2 cell-sweep launches per step, no grid
              escapes, the kernel against its plain version on the end state
              (parity_cell_moving_square_after_run, all six fields);
15. kernels - one line, one entry per kernel: launches on the main path that
              runs it, time per call of the wrapper (CUDA events; pack +
              kernel + collect) and of the kernel alone (profiler), the plain
              version's time, the bound.  The block sweep runs on two paths:
              its entry holds the dam-break path's numbers and, under keys
              ending in ``_mdbc_path``, the mDBC path's own.  The cell sweep's
              entry holds the large path's numbers, the block sweep's time on
              that same state, and the moving-square path's under keys ending
              in ``_moving_square_path``.

Then the card's name and power limit from nvidia-smi on a line of their own,
and last ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.core.step import _sweep, make_fixed_steps_fn, sph_step
from sphexample_tpu_torch.io.casegen import dam_break_2d, dam_break_3d
from sphexample_tpu_torch.models import equations as eq
from sphexample_tpu_torch.ops import _build
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops import cell_sweep as cw
from sphexample_tpu_torch.ops import mdbc
from sphexample_tpu_torch.ops import mdbc_moments as mm
from sphexample_tpu_torch.ops.interactions import candidates

REL_TOL = 1e-4           # kernel vs plain, relative to the field's max
WARM_STEPS, STEPS = 10, 200
# the large-capacity path: io/casegen.py:dam_break_3d at this spacing has this
# many particles, past the block sweep's capacity limit of 2^21 rows
LARGE_DX, LARGE_N = 0.0034, 2215035
# f32 operations per candidate and per pair of the 3D Wendland / ARTIFICIAL
# / LINEAR instance of csrc/block_sweep.cu, counted from its source: a
# candidate costs the difference, squared distance and cutoff compare; an
# accepted pair the kernel gradient, continuity, LINEAR diffusion, pressure
# term and accumulation; an approaching pair (v.x < 0) the viscosity term.
OPS_CANDIDATE, OPS_PAIR, OPS_APPROACH = 9, 45, 9
# the same for the 3D Wendland instance of csrc/mdbc_moments.cu: a candidate
# costs the difference, squared distance and the cutoff and fluid compares; an
# accepted pair the density guard and the volume (2), the distance, q, kernel
# value (8) and gradient (4 + 3) and the 4 x (1 + 1 + 1 + 3 x 2) sums of b and A
MDBC_OPS_CANDIDATE, MDBC_OPS_PAIR = 10, 56
# rows whose |det| lies within this share of the 1e-3 threshold may take the
# other branch in the kernel's summation order: counted, not compared
NEAR_DET = 0.05
RHO_TOL = 1e-4           # corrected densities, kernel vs plain moments (f32)
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def case_3d(dx=0.0085):
    """The main path: bench.py's 3D dam break (reference Dambreak3d.jl)."""
    const = T.SimulationConstants(dx=dx, c0=33.14, alpha=0.1, m0=1000 * dx**3, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 3, h=float(np.sqrt(3 * dx**2)))
    meta = T.SimulationMetaData(simulation_name="chip_smoke_3d",
                                save_location="out", dims=3)
    return dam_break_3d(dx), meta, const, kern


def case_2d(dx=0.01):
    """bench.py's 2D dam break (reference Dambreak2dMDBC.jl constants)."""
    const = T.SimulationConstants(dx=dx, c0=88.14487860902641, cfl=0.5, alpha=0.01)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dx)
    meta = T.SimulationMetaData(simulation_name="chip_smoke_2d",
                                save_location="out", dims=2)
    return dam_break_2d(dx), meta, const, kern


def mdbc_dam_break(case):
    """The three-layer mDBC dam break of ``case`` (3D or 2D): the fluid block
    and tank extents of the dam break, its single wall layer replaced by
    three lattice layers (the original one and two further out: floor and
    sides, open top).  The boundary interface planes lie dx/2 inside the
    innermost layer; a boundary particle's ghost point is its reflection
    about every interface plane it lies beyond (edge and corner particles
    reflect in 2 or 3 axes) and its normal is ghost - position.  Boundary
    particles come first, with IDs from 1.  Returns (arrays, ghost_points,
    ghost_normals, meta, const, kern)."""
    (pos, _, ptype, _, _), meta, const, kern = case
    dims, dx = meta.dims, const.dx
    extents = (1.60, 0.67, 0.45) if dims == 3 else (1.60, 0.45)
    counts = [int(round(L / dx)) for L in extents]
    # lattice indices: two extra layers on every side but the open top
    axes = [np.arange(-2, n + 2) for n in counts[:-1]] + [np.arange(-2, counts[-1])]
    idx = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dims)
    hi = np.array([n - 2 for n in counts[:-1]] + [np.iinfo(np.int64).max])
    wall = np.any((idx < 1) | (idx > hi), axis=-1)
    walls = (idx[wall] + 0.5) * dx
    # reflect about the interface planes x = dx and x = (n - 1) dx
    top = np.array([(n - 1) * dx for n in counts[:-1]] + [np.inf])
    ghost = np.where(walls < dx, 2 * dx - walls, walls)
    ghost = np.where(walls > top, 2 * top - walls, ghost)
    fluid = pos[ptype == int(T.ParticleType.FLUID)]
    nb, nf = len(walls), len(fluid)
    arrays = (
        np.concatenate([walls, fluid]),
        np.full(nb + nf, 1000.0),
        np.concatenate([np.full(nb, int(T.ParticleType.FIXED)),
                        np.full(nf, int(T.ParticleType.FLUID))]).astype(np.int32),
        np.concatenate([np.full(nb, 1), np.full(nf, 2)]).astype(np.int32),
        np.arange(1, nb + nf + 1),
    )
    meta = T.replace(meta, simulation_name=meta.simulation_name + "_mdbc",
                     mdbc=T.MDBCMode.SIMPLE)
    return arrays, ghost, ghost - walls, meta, const, kern


SQUARE_SPEED = 2.8       # m/s in +x (examples/moving_square_2d.py:54-56)


def moving_square_case(dp=0.004, nx=640, nz=400, wall_layers=3,
                       square=(100, 150, 175, 225)):
    """A procedural MovingSquare case (the deck's input CSVs are not in the
    repository): a closed box of ``wall_layers`` fixed lattice layers around
    ``nx`` x ``nz`` interior lattice sites at spacing ``dp``, filled with
    fluid except for a solid square of MOVING particles (interior site
    indices ``square`` = x0, x1, z0, z1) that translates at 2.8 m/s in +x.
    Constants, kernel and modes of examples/moving_square_2d.py:39-41, 59-73.
    Group markers as in the deck (1 fixed, 2 fluid, 3 square); IDs from 1,
    square first.  Lattice sites sit at (i + 0.5) dp, a quarter of a cell
    off the nearest cell boundary (the cell pitch is 2 dp).  Returns (arrays, geometries, meta,
    const, kern, viscosity, diffusion)."""
    const = T.SimulationConstants(dx=dp, c0=28.0, delta_sph=0.1, g=0.0, Cb=112000.0,
                                  alpha=1e-6, cfl=0.2)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=dp, k=float(np.sqrt(2)))
    w = wall_layers
    ix, iz = np.meshgrid(np.arange(-w, nx + w), np.arange(-w, nz + w), indexing="ij")
    ix, iz = ix.ravel(), iz.ravel()
    wall = (ix < 0) | (ix >= nx) | (iz < 0) | (iz >= nz)
    x0, x1, z0, z1 = square
    body = (ix >= x0) & (ix < x1) & (iz >= z0) & (iz < z1)
    ptype = np.where(wall, int(T.ParticleType.FIXED),
                     np.where(body, int(T.ParticleType.MOVING),
                              int(T.ParticleType.FLUID))).astype(np.int32)
    order = np.argsort(-ptype, kind="stable")       # square, walls, fluid
    ptype = ptype[order]
    pos = (np.stack([ix, iz], axis=-1)[order] + 0.5) * dp
    marker = np.select([ptype == int(T.ParticleType.FIXED),
                        ptype == int(T.ParticleType.FLUID)], [1, 2], 3).astype(np.int32)
    n = len(pos)
    arrays = (pos, np.full(n, const.rho0), ptype, marker, np.arange(1, n + 1))
    geometries = (
        T.Geometry("", 1, T.ParticleType.FIXED),
        T.Geometry("", 2, T.ParticleType.FLUID),
        T.Geometry("", 3, T.ParticleType.MOVING,
                   T.MotionDetails(velocity=SQUARE_SPEED, start_time=0.0, duration=3.0,
                                   direction=(1.0, 0.0))),
    )
    meta = T.SimulationMetaData(
        simulation_name="chip_smoke_moving_square", save_location="out", dims=2,
        shifting=T.ShiftingMode.PLANAR, kernel_output=T.KernelOutputMode.STORE,
        block_sweep=False)
    return (arrays, geometries, meta, const, kern, T.ViscosityModel.LAMINAR_SPS,
            T.DensityDiffusionModel.LINEAR)


def assemble_moving_square(case, device="cuda"):
    (pos, dens, ptype, grp, idp), geometries, meta, const, kern, visc, diff = case
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 visc, diff, geometries=geometries, device=device)


def moving_square_checks(sim, case, state, sweep_out, label, total_steps):
    """The moving-square gates beyond ``run_phase``'s: the square on its
    prescribed track, a shift applied near the body, kernel sums positive on
    the fluid."""
    pos0, ptype0 = case[0][0], case[0][2]
    p = state.particles
    order = torch.argsort(p.id)               # IDs are 1..n in input order
    x_now = p.position[order][:, 0].double().cpu().numpy()
    body = ptype0 == int(T.ParticleType.MOVING)
    t = float(state.total_time)
    track_err = float(np.abs(x_now[body] - (pos0[body, 0] + SQUARE_SPEED * t)).max())
    # each of the 2 advances of a step rounds the f32 position by at most
    # half a unit in the last place; twice that as the band
    track_tol = 2 * total_steps * float(np.spacing(np.float32(x_now[body].max())))
    # the stage-11 shift of this state's own sweep (core/step.py): A = 2,
    # A_FSM = D, zero where the free-surface scaling is negative
    h = sim.cfg.spec.kernel.h
    a_fsc = sweep_out.div_r / float(p.dims)
    vmag = p.velocity.norm(dim=-1)
    shift = (a_fsc.clamp(min=0) * 2.0 * h * vmag * state.current_dt
             * sweep_out.grad_c.norm(dim=-1) * p.motion_limiter)
    fluid = p.ptype == int(T.ParticleType.FLUID)
    near = fluid & (sweep_out.grad_c.norm(dim=-1) > 0)
    res = {
        "phase": label + "_checks", "square_rows": int(body.sum()),
        "square_displacement_m": SQUARE_SPEED * t, "track_max_err_m": track_err,
        "track_tol_m": track_tol, "fluid_rows_with_grad_c": int(near.sum()),
        "grad_c_max": float(sweep_out.grad_c.norm(dim=-1)[fluid].max()),
        "shift_max_m": float(shift.max()), "rows_shifted": int((shift > 0).sum()),
        "fluid_kernel_w_min": float(p.kernel_w[fluid].min()),
        "fluid_kernel_w_max": float(p.kernel_w[fluid].max()),
    }
    res["ok"] = (track_err <= track_tol and res["shift_max_m"] > 0
                 and res["fluid_kernel_w_min"] > 0)
    emit(res)
    if not res["ok"]:
        fail(f"{label}: square off its track, no shift applied, or kernel sums not positive")
    return res


def kernel_only_ms(fn, name, reps=5):
    """Device time per launch of the kernel ``name`` alone (profiler, device
    events only) over ``reps`` calls of ``fn``; "not measured" without
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and f"{name}_kernel" in e.key]
    count = sum(e.count for e in mine)
    if not count:
        return "not measured"
    return sum(e.self_device_time_total for e in mine) / 1e3 / count


def assemble(case):
    (pos, dens, ptype, grp, idp), meta, const, kern = case
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cuda")


def assemble_mdbc(case):
    (pos, dens, ptype, grp, idp), ghost, normals, meta, const, kern = mdbc_dam_break(case)
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cuda",
                                 ghost_points=ghost, ghost_normals=normals)


def falling_state(sim):
    """Rebuilt cell list, fluid velocity pointing down (bench.py:96-100),
    so that the viscous terms are live."""
    p, cs, _ = cl.rebuild(sim.state.particles, sim.cfg.spec.kernel.H_inv, sim.cfg.grid)
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    return p.replace(velocity=down * p.motion_limiter[:, None]), cs


def perturbed_state(sim, seed=0):
    """Rebuilt cell list, fluid densities within +-1% of rho0 from a seeded
    generator, so that the moment systems are not degenerate."""
    p, cs, _ = cl.rebuild(sim.state.particles, sim.cfg.spec.kernel.H_inv, sim.cfg.grid)
    noise = np.random.default_rng(seed).uniform(-0.01, 0.01, size=p.capacity)
    noise = torch.as_tensor(noise, dtype=p.density.dtype).to(p.device)
    return p.replace(density=p.density * (1 + noise * p.motion_limiter)), cs


def first_sweep_state(sim, p, cs):
    """``p`` as the first sweep of an mDBC step sees it: pressure from the
    uncorrected density, then the stage-04 density correction; fluid velocity
    pointing down so that the viscous terms are live."""
    p = p.replace(pressure=eq.pressure(p.density, sim.cfg.spec.constants))
    p = p.replace(density=mdbc.mdbc_density_correction(
        sim.cfg.spec, sim.cfg.grid, p, cs, sim.cfg.boundary_capacity))
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    return p.replace(velocity=down * p.motion_limiter[:, None])


SWEEP_FIELDS = (("drhodt", "drhodt"), ("acc", "acceleration"), ("kernel_w", "kernel_w"),
                ("kernel_grad", "kernel_grad"), ("grad_c", "grad_c"), ("div_r", "div_r"))


def sweep_diff(k, ref, label):
    """Largest difference of every field the mode set has, absolute and
    relative to the field's max; fails on a non-finite value."""
    res = {}
    for name, field in SWEEP_FIELDS:
        a, b = getattr(k, field), getattr(ref, field)
        if (a is None) != (b is None):
            fail(f"{label}: {field} present in one version only")
        if a is None:
            continue
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label}: non-finite {name}")
        d = float((a - b).abs().max())
        res[f"{name}_max_abs"] = d
        res[f"{name}_rel"] = d / max(float(b.abs().max()), 1e-30)
    return res


def compare(sim, p, cs, label, mod=bs, spec=None, quiet=False):
    """A sweep kernel (``mod``: the block or the cell sweep) against its plain
    version on the same inputs.  Returns the record and the kernel's output."""
    args = (spec or sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density,
            p.pressure, p.velocity)
    sweep, plain = ((bs.block_sweep, bs.block_sweep_plain) if mod is bs
                    else (cw.cell_sweep, cw.cell_sweep_plain))
    k = sweep(*args)
    ref = plain(*args, block_size=4096)
    torch.cuda.synchronize()
    res = {"phase": label, "n": int(p.active.sum()), **sweep_diff(k, ref, label)}
    res["max_rel"] = max(v for key, v in res.items() if key.endswith("_rel"))
    res["max_abs"] = max(v for key, v in res.items() if key.endswith("_max_abs"))
    res["ok"] = res["max_rel"] < REL_TOL
    if not quiet:
        emit(res)
    if not res["ok"]:
        if quiet:
            emit(res)
        fail(f"{label}: kernel and plain version disagree")
    return res, k


def stirred_state(sim, seed=1):
    """Rebuilt cell list, fluid densities within +-1% of rho0 and fluid
    velocities of ~0.5 m/s in every direction from a seeded generator, the
    pressure from that density: every term of every model is live."""
    p, cs = perturbed_state(sim, seed)
    rng = np.random.default_rng(seed + 1000)
    vel = torch.as_tensor(rng.normal(0, 0.5, size=tuple(p.velocity.shape)),
                          dtype=p.velocity.dtype).to(p.device)
    return p.replace(velocity=vel * p.motion_limiter[:, None],
                     pressure=eq.pressure(p.density, sim.cfg.spec.constants)), cs


def compare_cell_modes(sim, p, cs, label):
    """The cell sweep against its plain version for every viscosity x density
    diffusion x kernel family, PLANAR shifting and kernel output STORE on:
    all six fields of all 32 mode sets."""
    spec0 = sim.cfg.spec
    kern = spec0.kernel
    worst, worst_mode, per_mode = 0.0, None, {}
    for family in T.KernelFamily:
        fam_kern = T.make_kernel(family, kern.dims, h=kern.h, k=kern.k)
        for visc in T.ViscosityModel:
            for diff in T.DensityDiffusionModel:
                spec = dataclasses.replace(
                    spec0, kernel=fam_kern, viscosity=visc, diffusion=diff,
                    shifting=T.ShiftingMode.PLANAR,
                    kernel_output=T.KernelOutputMode.STORE)
                mode = f"{family.name}/{visc.name}/{diff.name}"
                res, _ = compare(sim, p, cs, f"{label}:{mode}", mod=cw, spec=spec,
                                 quiet=True)
                if sum(k.endswith("_rel") for k in res) != len(SWEEP_FIELDS) + 1:
                    fail(f"{label}:{mode}: not all six fields compared")
                per_mode[mode] = res["max_rel"]
                if res["max_rel"] >= worst:
                    worst, worst_mode = res["max_rel"], mode
    out = {"phase": label, "n": int(p.active.sum()), "modes": len(per_mode),
           "fields": len(SWEEP_FIELDS), "max_rel": worst, "worst_mode": worst_mode,
           "max_rel_per_mode": per_mode, "ok": worst < REL_TOL}
    emit(out)
    return out


def moment_args(sim, p, cs):
    """The moment wrapper's arguments on this state, as stage 04 makes them."""
    bidx, bvalid = mdbc.compact_ghosts(p, sim.cfg.boundary_capacity)
    return bidx, (sim.cfg.spec, sim.cfg.grid, p.ghost_points[bidx], bvalid,
                  p.position, p.density, p.motion_limiter, cs)


def compare_mdbc(sim, p, cs, label):
    """The moment kernel against its plain version on the same inputs: every
    moment column relative to its max; then both sets of moments through the
    solve and the decision tree."""
    bidx, args = moment_args(sim, p, cs)
    gpoint, bvalid = args[2], args[3]
    B = gpoint.shape[0]
    bk, Ak = mm.mdbc_moments(*args)
    bp, Ap = mm.mdbc_moments_plain(*args)
    torch.cuda.synchronize()
    k = torch.cat([bk, Ak.reshape(B, -1)], dim=1)
    ref = torch.cat([bp, Ap.reshape(B, -1)], dim=1)
    if not (torch.isfinite(k).all() and torch.isfinite(ref).all()):
        fail(f"{label}: non-finite moments")
    col_max = ref.abs().amax(dim=0)
    col_err = (k - ref).abs().amax(dim=0)
    col_rel = col_err / col_max.clamp(min=1e-30)
    rho_k, dec_k = mdbc._mdbc_apply(sim.cfg.spec, p, bidx, bvalid, gpoint, bk, Ak)
    rho_p, dec_p = mdbc._mdbc_apply(sim.cfg.spec, p, bidx, bvalid, gpoint, bp, Ap)
    det = mdbc._det_solve(Ap, bp)[0].abs()
    # near a threshold: |det| within NEAR_DET of 1e-3, or (below it) an A00
    # that is zero in one version and a vanishing W > 0 in the other - a
    # single neighbour on the rim of the support, where the two versions'
    # roundings of d2 may decide the cutoff differently
    a00p, a00k = Ap[:, 0, 0], Ak[:, 0, 0]
    rim = 1e-6 * a00p.max()
    near = ((det - mdbc.DET_THRESHOLD).abs() <= NEAR_DET * mdbc.DET_THRESHOLD) | (
        (det < mdbc.DET_THRESHOLD) & ((a00p > 0) != (a00k > 0))
        & (a00p <= rim) & (a00k <= rim))
    flipped = (dec_k != dec_p) & bvalid
    excluded = (near | flipped) & bvalid
    held = bvalid & ~excluded
    a, b = rho_k[bidx][held], rho_p[bidx][held]
    rho_rel = float(((a - b).abs() / b.abs()).max()) if a.numel() else 0.0
    res = {
        "phase": label, "ghost_slots": B, "valid_ghosts": int(bvalid.sum()),
        "ghosts_with_fluid_neighbour": int(((bp[:, 0] > 0) & bvalid).sum()),
        "decisions_plain": {name: int(((dec_p == v) & bvalid).sum())
                            for name, v in (("solve", 2), ("shepard", 1), ("keep", 0))},
        "decisions_kernel": {name: int(((dec_k == v) & bvalid).sum())
                             for name, v in (("solve", 2), ("shepard", 1), ("keep", 0))},
        "moment_max_abs": float(col_err.max()), "moment_max_rel": float(col_rel.max()),
        "moment_col_rel": [float(v) for v in col_rel],
        "rho_max_rel": rho_rel, "rows_near_threshold_excluded": int(excluded.sum()),
        "decision_flips": int(flipped.sum()),
        "decision_flips_far_from_threshold": int((flipped & ~near).sum()),
    }
    res["ok"] = (res["moment_max_rel"] < REL_TOL and rho_rel < RHO_TOL
                 and res["decision_flips_far_from_threshold"] == 0
                 and res["ghosts_with_fluid_neighbour"] > 0
                 and bool(torch.isfinite(rho_k).all()))
    emit(res)
    if not res["ok"]:
        fail(f"{label}: moment kernel and plain version disagree")
    return res


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep_work(sim, p, cs, reads_cell=True):
    """Candidates, pairs in support and approaching pairs of this state's
    sweep (what the kernel really evaluates), and the bytes it must move."""
    kern = sim.cfg.spec.kernel
    starts, ends = cl.row_segments(p.cell, sim.cfg.grid, cs)
    act = p.active
    n_cand = n_pair = n_appr = 0
    for b0 in range(0, p.capacity, 8192):
        i, j = candidates(starts, ends, b0, min(b0 + 8192, p.capacity))
        live = act[i]
        i, j = i[live], j[live]
        xij = p.position[i] - p.position[j]
        d2 = (xij * xij).sum(-1)
        keep = (d2 <= kern.H2) & (i != j)
        vdotx = ((p.velocity[i] - p.velocity[j]) * xij).sum(-1)
        n_cand += int(i.numel())
        n_pair += int(keep.sum())
        n_appr += int((keep & (vdotx < 0)).sum())
    n, d = p.position.shape
    # inputs read once (position, velocity, density, pressure, motion
    # limiter, active, cell_start; the block sweep reads the cell coordinates
    # too) + the [N, 1+D] f32 output
    nbytes = (n * (2 * d + 3) * p.position.element_size() + n
              + (n * d * 4 if reads_cell else 0) + cs.numel() * 4 + n * (1 + d) * 4)
    ops = OPS_CANDIDATE * n_cand + OPS_PAIR * n_pair + OPS_APPROACH * n_appr
    return n_cand, n_pair, n_appr, nbytes, ops


def sweep_numbers(sim, p, cs, mod=bs, plain_reps=2):
    """A sweep kernel (the block or the cell sweep) on this state: the
    wrapper's and the plain version's time per call (CUDA events), this
    state's work and the bound it gives.  The work count is that of the
    ARTIFICIAL + LINEAR model set without extras, which every path that calls
    this runs."""
    n_cand, n_pair, n_appr, nbytes, ops = sweep_work(sim, p, cs, reads_cell=mod is bs)
    args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density,
            p.pressure, p.velocity)
    sweep, plain = ((bs.block_sweep, bs.block_sweep_plain) if mod is bs
                    else (cw.cell_sweep, cw.cell_sweep_plain))
    ms = time_cuda(lambda: sweep(*args), 20)
    plain_ms = time_cuda(lambda: plain(*args, block_size=4096), plain_reps)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "candidates": n_cand, "pairs": n_pair, "approaching_pairs": n_appr,
            "bytes": nbytes, "ops": ops}


def mdbc_work(sim, args):
    """Candidates and in-support fluid pairs of these ghosts (what the moment
    kernel really evaluates), and the bytes it must move."""
    spec, grid, gpoint, bvalid, position, density, ml, cs = args
    kern = spec.kernel
    gcoords = cl.clamp_coords(cl.cell_coords(gpoint, kern.H_inv), grid)
    starts, ends = cl.row_segments(gcoords, grid, cs)
    B, d = gpoint.shape
    n_cand = n_pair = 0
    for b0 in range(0, B, 8192):
        i, j = candidates(starts, ends, b0, min(b0 + 8192, B))
        live = bvalid[i]
        i, j = i[live], j[live]
        xij = gpoint[i] - position[j]
        n_cand += int(i.numel())
        n_pair += int((((xij * xij).sum(-1) <= kern.H2) & (ml[j] > 0.5)).sum())
    n = position.shape[0]
    # inputs read once (ghost points, validity, position, density, motion
    # limiter, cell_start) + the [B, K] f32 output
    nbytes = (B * d * gpoint.element_size() + B + n * (d + 2) * position.element_size()
              + cs.numel() * 4 + B * mm.n_moments(d) * 4)
    ops = MDBC_OPS_CANDIDATE * n_cand + MDBC_OPS_PAIR * n_pair
    return n_cand, n_pair, nbytes, ops


def run_phase(sim, label, mdbc_on, sweep="block", falling=True, rho_band=0.02):
    """10 warm-up + 200 timed steps through ``make_fixed_steps_fn`` with the
    launch counts set to 0 just before the timed steps and read just after,
    and the physics checks.  ``sweep`` names the kernel the path must take:
    2 launches of it per step, none of the other.  Returns (end state, the
    emitted record)."""
    if sim.cfg.sweep_kernel != sweep:
        fail(f"{label}: assemble_simulation chose the {sim.cfg.sweep_kernel} sweep, not {sweep}")
    ids0 = sim.state.particles.id.clone()
    pos0 = sim.state.particles.position.clone()
    fixed0 = sim.state.particles.ptype == int(T.ParticleType.FIXED)
    state = make_fixed_steps_fn(sim.cfg, WARM_STEPS)(sim.state)
    torch.cuda.synchronize()
    rebuilds0 = state.rebuilds
    torch.cuda.reset_peak_memory_stats()
    bs.launches = 0
    mm.launches = 0
    cw.launches = 0
    t0 = time.perf_counter()
    state = make_fixed_steps_fn(sim.cfg, STEPS)(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"block": bs.launches, "cell": cw.launches}
    sweep_launches, mdbc_launches = counts[sweep], mm.launches
    other_launches = sum(v for k, v in counts.items() if k != sweep)
    p = state.particles
    n = sim.n_live
    finite = all(bool(torch.isfinite(getattr(p, f)).all()) for f in
                 ("position", "velocity", "acceleration", "density", "pressure"))
    fluid = p.ptype == int(T.ParticleType.FLUID)
    rho0 = sim.cfg.spec.constants.rho0
    rho_f = p.density[fluid]
    order_now = torch.argsort(p.id)
    order0 = torch.argsort(ids0)
    walls_still = bool(torch.equal(p.position[order_now][fixed0[order0]],
                                   pos0[order0][fixed0[order0]]))
    rho_b = p.density[(p.ptype == int(T.ParticleType.FIXED)) & p.active]
    run = {
        "phase": label, "n": n, "steps": STEPS, "wall_s": wall,
        "particle_steps_per_s": n * STEPS / wall, "ms_per_step": 1e3 * wall / STEPS,
        "device": torch.cuda.get_device_name(0), "rebuilds": state.rebuilds - rebuilds0,
        "sim_time_s": float(state.total_time), "dt": float(state.current_dt),
        "fluid_rho_min": float(rho_f.min()), "fluid_rho_max": float(rho_f.max()),
        "fluid_vz_min": float(p.velocity[fluid][:, -1].min()),
        "boundary_rho_min": float(rho_b.min()), "boundary_rho_max": float(rho_b.max()),
        "boundary_rows_off_rho0": int((rho_b != rho0).sum()),
        "sweep_kernel": sweep, "launches": sweep_launches,
        "block_sweep_launches": counts["block"], "cell_sweep_launches": counts["cell"],
        "mdbc_launches": mdbc_launches,
        "ghosts": sim.cfg.boundary_capacity if mdbc_on else 0,
        "finite": finite, "walls_still": walls_still,
        "max_occupancy": int(state.max_occupancy), "max_segment": int(state.max_segment),
        "grid_escapes": int(state.grid_escapes),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(run)
    if not finite:
        fail(f"{label}: non-finite fields after the run")
    if not (abs(run["fluid_rho_min"] / rho0 - 1) <= rho_band
            and abs(run["fluid_rho_max"] / rho0 - 1) <= rho_band):
        fail(f"{label}: fluid density left rho0 +- {100 * rho_band:g}%")
    if falling and not run["fluid_vz_min"] < 0:
        fail(f"{label}: the fluid column is not falling")
    if not walls_still:
        fail(f"{label}: fixed boundary particles moved")
    if sweep_launches != 2 * STEPS or other_launches != 0:
        fail(f"{label}: {sweep}-sweep launches {sweep_launches} != 2 x {STEPS} steps, "
             f"or the other sweep was launched ({other_launches})")
    if mdbc_launches != (STEPS if mdbc_on else 0):
        fail(f"{label}: mDBC launches {mdbc_launches} in {STEPS} steps")
    if run["grid_escapes"] != 0:
        fail(f"{label}: particles escaped the static grid")
    if mdbc_on and run["boundary_rows_off_rho0"] == 0:
        fail(f"{label}: no boundary density moved off rho0 - mDBC did not fire")
    return state, run


def breakdown_phase(sim, state, run, label):
    """Where a step's time goes (CUDA events; profiler for busy share)."""
    pf, csf = state.particles, state.cell_start
    sweep_ms = time_cuda(lambda: _sweep(sim.cfg, pf, csf, pf.position, pf.density,
                                        pf.pressure, pf.velocity), 20)
    rebuild_ms = time_cuda(lambda: cl.rebuild(pf, sim.cfg.spec.kernel.H_inv,
                                              sim.cfg.grid), 10)
    dx_far = torch.full((), 1e9, dtype=state.total_time.dtype, device="cuda")
    dx_none = torch.zeros((), dtype=state.total_time.dtype, device="cuda")
    step_rebuild_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_far), 10)
    step_plain_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_none), 10)
    step_ms = run["ms_per_step"]
    brk = {
        "phase": label, "step_ms": step_ms,
        "sweep_ms": sweep_ms, "two_sweeps_share": 2 * sweep_ms / step_ms,
        "rebuild_ms": rebuild_ms, "rebuilds_per_step": run["rebuilds"] / STEPS,
        "step_ms_with_rebuild": step_rebuild_ms, "step_ms_without_rebuild": step_plain_ms,
    }
    if sim.cfg.meta.mdbc is T.MDBCMode.SIMPLE:
        # stage 04 as the step runs it: compaction, kernel, solve, scatter
        stage_ms = time_cuda(lambda: mdbc.mdbc_density_correction(
            sim.cfg.spec, sim.cfg.grid, pf, csf, sim.cfg.boundary_capacity), 20)
        _, args = moment_args(sim, pf, csf)
        bvec, Amat = mm.mdbc_moments(*args)
        brk.update(
            mdbc_stage_ms=stage_ms, mdbc_stage_share=stage_ms / step_ms,
            mdbc_compact_ms=time_cuda(lambda: mdbc.compact_ghosts(
                pf, sim.cfg.boundary_capacity), 20),
            mdbc_moments_ms=time_cuda(lambda: mm.mdbc_moments(*args), 20),
            mdbc_solve_ms=time_cuda(lambda: mdbc._det_solve(Amat, bvec), 20))
    brk.update(prof_window(sim, state))
    emit(brk)
    return brk


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device - this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": secs,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln][:8]
                    for k, v in _build.build_logs.items()}})

    # 3 - block-sweep parity on the initial lattices; 11 - the cell sweep on
    # the same states, on stirred copies, and in every mode
    sim3 = assemble(case_3d())
    p3, cs3 = falling_state(sim3)
    par3, _ = compare(sim3, p3, cs3, "parity_3d")
    parc3, _ = compare(sim3, p3, cs3, "parity_cell_3d", mod=cw)
    p3, cs3 = stirred_state(sim3)
    parc3s, _ = compare(sim3, p3, cs3, "parity_cell_3d_stirred", mod=cw)
    modes3 = compare_cell_modes(sim3, p3, cs3, "parity_cell_modes_3d")
    del p3, cs3
    sim2 = assemble(case_2d())
    p2, cs2 = falling_state(sim2)
    compare(sim2, p2, cs2, "parity_2d")
    compare(sim2, p2, cs2, "parity_cell_2d", mod=cw)
    p2, cs2 = stirred_state(sim2)
    compare(sim2, p2, cs2, "parity_cell_2d_stirred", mod=cw)
    modes2 = compare_cell_modes(sim2, p2, cs2, "parity_cell_modes_2d")
    del sim2, p2, cs2
    if not (modes3["ok"] and modes2["ok"]):
        fail("parity_cell_modes: kernel and plain version disagree")

    # 4-6 - the dam-break path: run, breakdown, parity on the end state
    state, run = run_phase(sim3, "run", mdbc_on=False)
    brk = breakdown_phase(sim3, state, run, "breakdown")
    pf, csf = state.particles, state.cell_start
    par_after, _ = compare(sim3, pf, csf, "parity_after_run")

    # the block sweep's entry of the kernel line (the dam-break end state)
    nums = sweep_numbers(sim3, pf, csf)
    sweep_entry = {
        "name": "block_sweep", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/block_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_block_sweep.py:573 (_make_block_kernel)",
        "launches": run["launches"],
        "max_abs_err": max(par_after["drhodt_max_abs"], par_after["acc_max_abs"]),
        "max_rel_err": max(par3["drhodt_rel"], par3["acc_rel"],
                           par_after["drhodt_rel"], par_after["acc_rel"]),
        "ms": nums["ms"], "ms_per_launch": nums["ms"],
        "kernel_only_ms": brk.get("block_sweep_kernel_only_ms", "not measured"),
        "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
        "library_ms": None,
        **{k: nums[k] for k in ("candidates", "pairs", "approaching_pairs",
                                "bytes", "ops")},
    }
    del sim3, state, pf, csf
    torch.cuda.empty_cache()

    # 7 - moment-kernel parity on the initial mDBC lattices
    simm = assemble_mdbc(case_3d())
    n_ghost = simm.cfg.boundary_capacity
    if (n_ghost, simm.n_live) != (131736, 249036):
        fail(f"the mDBC case has {n_ghost} ghosts / {simm.n_live} particles")
    pm, csm = perturbed_state(simm)
    parm3 = compare_mdbc(simm, pm, csm, "parity_mdbc_3d")
    par_sweep_m3, _ = compare(simm, first_sweep_state(simm, pm, csm), csm,
                              "parity_sweep_mdbc_3d")
    del pm, csm
    simm2 = assemble_mdbc(case_2d())
    pm2, csm2 = perturbed_state(simm2)
    compare_mdbc(simm2, pm2, csm2, "parity_mdbc_2d")
    del simm2, pm2, csm2

    # 8-10 - the mDBC path: run, breakdown, parity on the end state
    state, runm = run_phase(simm, "run_mdbc", mdbc_on=True)
    brkm = breakdown_phase(simm, state, runm, "breakdown_mdbc")
    pf, csf = state.particles, state.cell_start
    parm_after = compare_mdbc(simm, pf, csf, "parity_mdbc_after_run")
    par_sweep_m, _ = compare(simm, pf, csf, "parity_sweep_mdbc_after_run")

    _, margs = moment_args(simm, pf, csf)
    m_cand, m_pair, m_bytes, m_ops = mdbc_work(simm, margs)
    m_ms = time_cuda(lambda: mm.mdbc_moments(*margs), 20)
    m_plain_ms = time_cuda(lambda: mm.mdbc_moments_plain(*margs), 2)
    t_bytes, t_ops = m_bytes / PEAK_BYTES, m_ops / PEAK_F32
    mdbc_entry = {
        "name": "mdbc_moments", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/mdbc_moments.cu",
        "replaces": "sphexample_tpu/ops/pallas_mdbc.py:41 (_make_mdbc_kernel)",
        "launches": runm["mdbc_launches"],
        "max_abs_err": parm_after["moment_max_abs"],
        "max_rel_err": max(parm3["moment_max_rel"], parm_after["moment_max_rel"]),
        "ms": m_ms, "ms_per_launch": m_ms,
        "kernel_only_ms": brkm.get("mdbc_moments_kernel_only_ms", "not measured"),
        "plain_ms": m_plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
        "ghosts": n_ghost, "candidates": m_cand, "pairs": m_pair,
        "bytes": m_bytes, "ops": m_ops,
    }
    # the block sweep on the mDBC path, at that path's own shapes
    nums = sweep_numbers(simm, pf, csf)
    sweep_entry.update(
        launches_mdbc_path=runm["launches"],
        max_abs_err_mdbc_path=max(par_sweep_m["drhodt_max_abs"],
                                  par_sweep_m["acc_max_abs"]),
        max_rel_err_mdbc_path=max(par_sweep_m3["drhodt_rel"], par_sweep_m3["acc_rel"],
                                  par_sweep_m["drhodt_rel"], par_sweep_m["acc_rel"]),
        kernel_only_ms_mdbc_path=brkm.get("block_sweep_kernel_only_ms",
                                          "not measured"),
        **{f"{k}_mdbc_path": v for k, v in nums.items()})
    del simm, state, pf, csf, margs
    torch.cuda.empty_cache()

    # 12-13 - the large-capacity path: the capacity rule picks the cell sweep
    siml = assemble(case_3d(dx=LARGE_DX))
    if siml.n_live != LARGE_N or siml.state.particles.capacity <= bs.BLOCK_CAP_LIMIT:
        fail(f"the large case has {siml.n_live} particles, capacity "
             f"{siml.state.particles.capacity}")
    pl, csl = falling_state(siml)
    parl, _ = compare(siml, pl, csl, "parity_cell_large", mod=cw)
    del pl, csl
    state, runl = run_phase(siml, "run_large", mdbc_on=False, sweep="cell")
    brkl = breakdown_phase(siml, state, runl, "breakdown_large")
    pf, csf = state.particles, state.cell_start
    parl_after, _ = compare(siml, pf, csf, "parity_cell_large_after_run", mod=cw)
    numl = sweep_numbers(siml, pf, csf, mod=cw, plain_reps=1)
    # for the record only: the block sweep launched directly on the same state
    # (one thread per self against one block per cell, the same work)
    argl = (siml.cfg.spec, siml.cfg.grid, pf, csf, pf.position, pf.density,
            pf.pressure, pf.velocity)
    parl_block, _ = compare(siml, pf, csf, "parity_block_large_after_run")
    block_same = {
        "phase": "block_sweep_on_large_state", "n": siml.n_live,
        "block_sweep_ms": time_cuda(lambda: bs.block_sweep(*argl), 20),
        "block_sweep_kernel_only_ms": kernel_only_ms(lambda: bs.block_sweep(*argl),
                                                     "block_sweep"),
        "cell_sweep_ms": numl["ms"],
        "cell_sweep_kernel_only_ms": brkl.get("cell_sweep_kernel_only_ms",
                                              "not measured"),
        "block_sweep_max_rel_err": parl_block["max_rel"],
        "bound_ms": numl["bound_ms"], "grid_cells": siml.cfg.grid.ncells,
        "occupied_cells": int(state.occupied_cells),
    }
    emit(block_same)
    cell_entry = {
        "name": "cell_sweep", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/cell_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_sweep.py:598 (_make_kernel)",
        "launches": runl["launches"],
        "max_abs_err": parl_after["max_abs"],
        "max_rel_err": max(parc3["max_rel"], parc3s["max_rel"], modes3["max_rel"],
                           modes2["max_rel"], parl["max_rel"], parl_after["max_rel"]),
        "ms": numl["ms"], "ms_per_launch": numl["ms"],
        "kernel_only_ms": block_same["cell_sweep_kernel_only_ms"],
        "plain_ms": numl["plain_ms"],
        "bound_ms": numl["bound_ms"], "bound_by": numl["bound_by"],
        "library_ms": None,
        "block_sweep_ms_same_state": block_same["block_sweep_ms"],
        "block_sweep_kernel_only_ms_same_state": block_same["block_sweep_kernel_only_ms"],
        **{k: numl[k] for k in ("candidates", "pairs", "approaching_pairs",
                                "bytes", "ops")},
    }
    del siml, state, pf, csf, argl
    torch.cuda.empty_cache()

    # 14 - the moving-square path: motion, shifting, SPS, STORE, the cell sweep
    case_sq = moving_square_case()
    simq = assemble_moving_square(case_sq)
    if simq.n_live < 250000:
        fail(f"the moving-square case has only {simq.n_live} particles")
    # an impulsively started body compresses the fluid ahead of it by about
    # v / c0 = 10 % (the acoustic estimate; the deck's own speed and sound
    # speed), with some overshoot at its corners: the band is 1.5 v / c0, not
    # the dam break's 2 %
    state, runq = run_phase(simq, "run_moving_square", mdbc_on=False, sweep="cell",
                            falling=False, rho_band=1.5 * SQUARE_SPEED / case_sq[3].c0)
    brkq = breakdown_phase(simq, state, runq, "breakdown_moving_square")
    pf, csf = state.particles, state.cell_start
    parq, outq = compare(simq, pf, csf, "parity_cell_moving_square_after_run", mod=cw)
    if sum(k.endswith("_rel") for k in parq) != len(SWEEP_FIELDS) + 1:
        fail("run_moving_square: not all six fields compared")
    moving_square_checks(simq, case_sq, state, outq, "run_moving_square",
                         WARM_STEPS + STEPS)
    argq = (simq.cfg.spec, simq.cfg.grid, pf, csf, pf.position, pf.density,
            pf.pressure, pf.velocity)
    cell_entry.update(
        launches_moving_square_path=runq["launches"],
        max_abs_err_moving_square_path=parq["max_abs"],
        max_rel_err_moving_square_path=parq["max_rel"],
        ms_moving_square_path=time_cuda(lambda: cw.cell_sweep(*argq), 20),
        kernel_only_ms_moving_square_path=brkq.get("cell_sweep_kernel_only_ms",
                                                   "not measured"),
        plain_ms_moving_square_path=time_cuda(
            lambda: cw.cell_sweep_plain(*argq, block_size=4096), 2))

    # 15 - the kernel line
    emit({"kernels": [sweep_entry, mdbc_entry, cell_entry]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def prof_window(sim, state, steps=20):
    """Device busy share of ``steps`` steps under torch.profiler (kernel
    time summed over the window's wall time), and each hand-written kernel's
    time alone, without its wrapper's pack and collect."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = make_fixed_steps_fn(sim.cfg, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched, so summing every row would count them twice
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    if dev_us <= 0:
        return {"profiled_steps": steps, "busy_share": "not measured"}
    out = {
        "profiled_steps": steps, "profiled_wall_ms": 1e3 * wall,
        "device_busy_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "device_launches_per_step": sum(e.count for e in ev) / steps,
        "top_device_ops_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }
    for name in ("block_sweep", "cell_sweep", "mdbc_moments"):
        mine = [e for e in ev if f"{name}_kernel" in e.key]
        count = sum(e.count for e in mine)
        if count:
            out[f"{name}_kernel_only_ms"] = (
                sum(e.self_device_time_total for e in mine) / 1e3 / count)
    return out


if __name__ == "__main__":
    sys.exit(main())
