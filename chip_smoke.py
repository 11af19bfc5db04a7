#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   - the card's name and power limit (no GPU: exit 1, no result);
2. build    - nvcc builds every ``sphexample_tpu_torch/csrc/*.cu``;
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
7. kernels  - one line per kernel: launches on the main path, time per
              call of the wrapper (CUDA events; pack + kernel + collect)
              and of the kernel alone (profiler), the plain version's
              time, the bound.

Then the card's name and power limit from nvidia-smi on a line of their own,
and last ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.core.step import _sweep, make_fixed_steps_fn, sph_step
from sphexample_tpu_torch.io.casegen import dam_break_2d, dam_break_3d
from sphexample_tpu_torch.ops import _build
from sphexample_tpu_torch.ops import block_sweep as bs
from sphexample_tpu_torch.ops import cell_list as cl
from sphexample_tpu_torch.ops.interactions import candidates

REL_TOL = 1e-4           # kernel vs plain, relative to the field's max
WARM_STEPS, STEPS = 10, 200
# f32 operations per candidate and per pair of the 3D Wendland / ARTIFICIAL
# / LINEAR instance of csrc/block_sweep.cu, counted from its source: a
# candidate costs the difference, squared distance and cutoff compare; an
# accepted pair the kernel gradient, continuity, LINEAR diffusion, pressure
# term and accumulation; an approaching pair (v.x < 0) the viscosity term.
OPS_CANDIDATE, OPS_PAIR, OPS_APPROACH = 9, 45, 9
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


def assemble(case):
    (pos, dens, ptype, grp, idp), meta, const, kern = case
    return T.assemble_simulation(pos, dens, ptype, grp, idp, meta, const, kern,
                                 T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, device="cuda")


def falling_state(sim):
    """Rebuilt cell list, fluid velocity pointing down (bench.py:96-100),
    so that the viscous terms are live."""
    p, cs, _ = cl.rebuild(sim.state.particles, sim.cfg.spec.kernel.H_inv, sim.cfg.grid)
    down = torch.zeros(p.dims, dtype=p.position.dtype, device=p.device)
    down[-1] = -1.0
    return p.replace(velocity=down * p.motion_limiter[:, None]), cs


def compare(sim, p, cs, label):
    args = (sim.cfg.spec, sim.cfg.grid, p, cs, p.position, p.density,
            p.pressure, p.velocity)
    k = bs.block_sweep(*args)
    ref = bs.block_sweep_plain(*args, block_size=4096)
    torch.cuda.synchronize()
    res = {"phase": label, "n": int(p.active.sum())}
    for name, a, b in (("drhodt", k.drhodt, ref.drhodt),
                       ("acc", k.acceleration, ref.acceleration)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label}: non-finite {name}")
        d = float((a - b).abs().max())
        m = float(b.abs().max())
        res[f"{name}_max_abs"] = d
        res[f"{name}_rel"] = d / max(m, 1e-30)
    res["ok"] = res["drhodt_rel"] < REL_TOL and res["acc_rel"] < REL_TOL
    emit(res)
    if not res["ok"]:
        fail(f"{label}: kernel and plain version disagree")
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


def sweep_work(sim, p, cs):
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
    # limiter, cell, active, cell_start) + the [N, 1+D] f32 output
    nbytes = (n * (2 * d + 3) * p.position.element_size() + n * d * 4 + n
              + cs.numel() * 4 + n * (1 + d) * 4)
    ops = OPS_CANDIDATE * n_cand + OPS_PAIR * n_pair + OPS_APPROACH * n_appr
    return n_cand, n_pair, n_appr, nbytes, ops


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

    # 3 - parity on the initial lattices
    sim3 = assemble(case_3d())
    p3, cs3 = falling_state(sim3)
    par3 = compare(sim3, p3, cs3, "parity_3d")
    sim2 = assemble(case_2d())
    p2, cs2 = falling_state(sim2)
    compare(sim2, p2, cs2, "parity_2d")
    del sim2, p2, cs2

    # 4 - the main path: 10 warm-up + 200 timed steps
    sim = sim3
    ids0 = sim.state.particles.id.clone()
    pos0 = sim.state.particles.position.clone()
    fixed0 = sim.state.particles.ptype == int(T.ParticleType.FIXED)
    state = make_fixed_steps_fn(sim.cfg, WARM_STEPS)(sim.state)
    torch.cuda.synchronize()
    rebuilds0 = state.rebuilds
    bs.launches = 0
    t0 = time.perf_counter()
    state = make_fixed_steps_fn(sim.cfg, STEPS)(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bs.launches
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
    run = {
        "phase": "run", "n": n, "steps": STEPS, "wall_s": wall,
        "particle_steps_per_s": n * STEPS / wall, "ms_per_step": 1e3 * wall / STEPS,
        "device": kind, "nvidia_smi": smi, "rebuilds": state.rebuilds - rebuilds0,
        "sim_time_s": float(state.total_time), "dt": float(state.current_dt),
        "fluid_rho_min": float(rho_f.min()), "fluid_rho_max": float(rho_f.max()),
        "fluid_vz_min": float(p.velocity[fluid][:, -1].min()),
        "launches": launches, "finite": finite, "walls_still": walls_still,
        "max_occupancy": int(state.max_occupancy), "max_segment": int(state.max_segment),
        "grid_escapes": int(state.grid_escapes),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(run)
    if not finite:
        fail("non-finite fields after the run")
    if not (abs(run["fluid_rho_min"] / rho0 - 1) <= 0.02
            and abs(run["fluid_rho_max"] / rho0 - 1) <= 0.02):
        fail("fluid density left rho0 +- 2%")
    if not run["fluid_vz_min"] < 0:
        fail("the fluid column is not falling")
    if not walls_still:
        fail("fixed boundary particles moved")
    if launches != 2 * STEPS:
        fail(f"block-sweep launches {launches} != 2 x {STEPS} steps")

    # 5 - where a step's time goes (CUDA events; profiler for busy share)
    pf, csf = state.particles, state.cell_start
    sweep_ms = time_cuda(lambda: _sweep(sim.cfg, pf, csf, pf.position, pf.density,
                                        pf.pressure, pf.velocity), 20)
    rebuild_ms = time_cuda(lambda: cl.rebuild(pf, sim.cfg.spec.kernel.H_inv,
                                              sim.cfg.grid), 10)
    dx_far = torch.full((), 1e9, dtype=state.total_time.dtype, device="cuda")
    dx_none = torch.zeros((), dtype=state.total_time.dtype, device="cuda")
    step_rebuild_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_far), 10)
    step_plain_ms = time_cuda(lambda: sph_step(sim.cfg, state, dx_none), 10)
    busy = prof_window(sim, state)
    step_ms = 1e3 * wall / STEPS
    brk = {
        "phase": "breakdown", "step_ms": step_ms,
        "sweep_ms": sweep_ms, "two_sweeps_share": 2 * sweep_ms / step_ms,
        "rebuild_ms": rebuild_ms, "rebuilds_per_step": run["rebuilds"] / STEPS,
        "step_ms_with_rebuild": step_rebuild_ms, "step_ms_without_rebuild": step_plain_ms,
        **busy,
    }
    emit(brk)

    # 6 - parity on the state the run ends in (cells no longer on the lattice)
    par_after = compare(sim, pf, csf, "parity_after_run")

    # 7 - the kernel line
    n_cand, n_pair, n_appr, nbytes, ops = sweep_work(sim, pf, csf)
    args = (sim.cfg.spec, sim.cfg.grid, pf, csf, pf.position, pf.density,
            pf.pressure, pf.velocity)
    kernel_ms = time_cuda(lambda: bs.block_sweep(*args), 20)
    plain_ms = time_cuda(lambda: bs.block_sweep_plain(*args, block_size=4096), 2)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    bound_ms = 1e3 * max(t_bytes, t_ops)
    emit({"kernels": [{
        "name": "block_sweep", "route": "cuda",
        "source": "sphexample_tpu_torch/csrc/block_sweep.cu",
        "replaces": "sphexample_tpu/ops/pallas_block_sweep.py:573 (_make_block_kernel)",
        "launches": launches,
        "max_abs_err": max(par_after["drhodt_max_abs"], par_after["acc_max_abs"]),
        "max_rel_err": max(par3["drhodt_rel"], par3["acc_rel"],
                           par_after["drhodt_rel"], par_after["acc_rel"]),
        "ms": kernel_ms, "ms_per_launch": kernel_ms,
        "kernel_only_ms": brk.get("kernel_only_ms", "not measured"), "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms,
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
        "candidates": n_cand, "pairs": n_pair, "approaching_pairs": n_appr,
        "bytes": nbytes, "ops": ops,
    }]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def prof_window(sim, state, steps=20):
    """Device busy share of ``steps`` steps under torch.profiler (kernel
    time summed over the window's wall time)."""
    from torch.profiler import ProfilerActivity, profile

    run = make_fixed_steps_fn(sim.cfg, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in ev)
    top = sorted(ev, key=lambda e: getattr(e, "self_device_time_total", 0.0),
                 reverse=True)[:8]
    if dev_us <= 0:
        return {"profiled_steps": steps, "busy_share": "not measured"}
    # the kernel alone, without the wrapper's pack and collect
    sweep = [e for e in ev if "block_sweep_kernel" in e.key]
    sweep_us = sum(e.self_device_time_total for e in sweep)
    sweep_n = sum(e.count for e in sweep)
    return {
        "profiled_steps": steps, "profiled_wall_ms": 1e3 * wall,
        "device_busy_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
        "kernel_only_ms": sweep_us / 1e3 / sweep_n if sweep_n else "not measured",
        "top_device_ops_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


if __name__ == "__main__":
    sys.exit(main())
