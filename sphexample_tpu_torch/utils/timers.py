"""Timing: hierarchical host timers + per-stage device timing (port of
``sphexample_tpu/utils/timers.py``).

The analog of the reference's TimerOutputs instrumentation (reference
``src/SPHCellList.jl:748-800`` wraps every stage in ``@timeit
SimMetaData.HourGlass "NN label"``; tables printed at exit,
SimulationLoggerConfiguration.jl:204-217):

* :class:`HourGlass` - a hierarchical wall-clock accumulator for the host
  loop (interval compute, retune, snapshot saves), printed as a table.
* :func:`profile_stages` - times each numbered stage of the step on its own,
  with the reference's stage names (01 dt, 02 rebuild, 03 EOS, 04 mDBC,
  05/08 sweep).  A diagnostic: the run never pays for it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


class HourGlass:
    """Named wall-clock accumulator (reference TimerOutputs analog)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, sort_by: str = "time") -> str:
        total = time.perf_counter() - self._t0
        items = sorted(
            self.totals.items(),
            key=(lambda kv: -kv[1]) if sort_by == "time" else (lambda kv: kv[0]),
        )
        lines = [
            f"{'section':<40} {'calls':>8} {'total [s]':>12} {'% wall':>8}",
            "-" * 72,
        ]
        for name, t in items:
            lines.append(
                f"{name:<40} {self.counts[name]:>8d} {t:>12.3f} {100 * t / total:>7.1f}%"
            )
        lines.append("-" * 72)
        lines.append(f"{'wall clock':<40} {'':>8} {total:>12.3f}")
        return "\n".join(lines)


def profile_stages(cfg, state, iters: int = 10) -> Dict[str, float]:
    """Time each step stage on its own (ms per call): on the card between two
    ``torch.cuda.synchronize()`` calls, after one untimed call; on the CPU,
    plain wall time.  The sweep stage goes through ``core/step.py:_sweep``,
    so on the card it times the sweep kernel the config chose.

    Stage names mirror the reference timer taxonomy (SPHCellList.jl:748-800).
    """
    from ..config import MDBCMode
    from ..core.step import _sweep
    from ..models import equations as eq
    from ..ops import cell_list as cl
    from ..ops.mdbc import mdbc_density_correction
    from ..ops.timestep import adaptive_dt

    spec, kern, c = cfg.spec, cfg.spec.kernel, cfg.spec.constants
    if cfg.ctx.is_sharded:
        # the stage probes call one rank's functions alone: a sharded ctx's
        # collectives would wait for the other ranks
        raise ValueError(
            "profile_stages supports single-device configs only; profile the "
            "sharded run with torch.profiler instead"
        )
    p0 = state.particles

    def sync():
        if p0.device.type == "cuda":
            torch.cuda.synchronize(p0.device)

    def timed(fn, *args):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        return (time.perf_counter() - t0) / iters * 1e3

    results = {}
    results["01 Update TimeStep"] = timed(
        lambda pp: adaptive_dt(pp.position, pp.velocity, pp.acceleration, c, kern), p0
    )
    results["02 Update Neighbors (sort)"] = timed(
        lambda pp: cl.rebuild(pp, kern.H_inv, cfg.grid), p0
    )
    p, cell_start, _ = cl.rebuild(p0, kern.H_inv, cfg.grid)
    results["03 Pressure (EOS)"] = timed(lambda rho: eq.pressure(rho, c), p.density)
    if cfg.meta.mdbc is MDBCMode.SIMPLE:
        results["04 mDBC correction"] = timed(
            lambda pp, cs: mdbc_density_correction(spec, cfg.grid, pp, cs,
                                                   cfg.boundary_capacity),
            p, cell_start,
        )
    results["05/08 Neighbor sweep"] = timed(
        lambda pp, cs: _sweep(cfg, pp, cs, pp.position, pp.density, pp.pressure,
                              pp.velocity).drhodt,
        p, cell_start,
    )
    return results
