"""Simulation logger: file + optional console tee, per-output step metrics
(port of ``sphexample_tpu/utils/logger.py``: torch's version and devices
where the JAX version prints ``jax.devices()``).

Reference: ``src/SimulationLoggerConfiguration.jl`` - InitializeLogger dumps
environment + configs + particle counts (:144-162, :87-133); LogStep writes
part number, physical time, step counts, wall time, wall-seconds per physical
second and an ETA (:171-195); LogFinal closes with totals (:204-217).
"""

from __future__ import annotations

import logging
import os
import platform
import sys
import time
from dataclasses import dataclass
from datetime import datetime, timedelta

import torch


def torch_devices() -> list:
    """The CUDA cards torch sees, by name, or ``["cpu"]`` without one."""
    if not torch.cuda.is_available():
        return ["cpu"]
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


@dataclass
class SimulationLogger:
    save_location: str
    to_console: bool = True
    name: str = "sphexample_tpu_torch"
    append: bool = False  # resume: keep the previous run's log lines

    def __post_init__(self):
        os.makedirs(self.save_location, exist_ok=True)
        self.path = os.path.join(self.save_location, "SimulationLog.log")
        self.logger = logging.getLogger(f"{self.name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.handlers.clear()
        fh = logging.FileHandler(self.path, mode="a" if self.append else "w")
        fh.setFormatter(logging.Formatter("%(message)s"))
        self.logger.addHandler(fh)
        if self.to_console:
            ch = logging.StreamHandler(sys.stdout)
            ch.setFormatter(logging.Formatter("%(message)s"))
            self.logger.addHandler(ch)
        self._t0 = time.perf_counter()

    def initialize(self, meta, constants, kernel, viscosity, diffusion, geometries, n_particles):
        log = self.logger.info
        log("=" * 78)
        log(f"SPHExample-TPU (PyTorch port) simulation log - {datetime.now().isoformat()}")
        log(f"python {sys.version.split()[0]} on {platform.platform()}")
        log(f"torch {torch.__version__}; devices: {torch_devices()}")
        log("-" * 78)
        log(f"SimulationMetaData : {meta}")
        log(f"SimulationConstants: {constants}")
        log(f"KernelInstance     : {kernel}")
        log(f"Viscosity          : {viscosity}")
        log(f"DensityDiffusion   : {diffusion}")
        log("-" * 78)
        for g in geometries:
            log(f"geometry: marker={g.group_marker} type={g.type.name} csv={g.csv_file}")
        log(f"total particles: {n_particles}")
        log("=" * 78)
        self._t0 = time.perf_counter()

    def log_step(self, info: dict, simulation_time: float):
        """``info`` comes from the driver's log callback."""
        wall = info.get("wall_time", time.perf_counter() - self._t0)
        tt = info["total_time"]
        per_physical = wall / tt if tt > 0 else float("inf")
        remaining = max(simulation_time - tt, 0.0) * per_physical
        eta = datetime.now() + timedelta(seconds=remaining)
        self.logger.info(
            f"Part {info['counter']:5d} | t = {tt:10.5f} s | "
            f"steps: {info['iteration']:8d} (+{info['steps_in_interval']}) | "
            f"dt = {info['dt']:.3e} | wall {wall:9.2f} s | "
            f"{per_physical:8.2f} wall-s per physical-s | ETA {eta:%Y-%m-%d %H:%M:%S}"
        )

    def log_final(self, state, timesteps=None):
        wall = time.perf_counter() - self._t0
        if isinstance(state, tuple):  # sharded: the scalars are replicated
            state = state[0]
        self.logger.info("-" * 78)
        self.logger.info(
            f"finished: t = {float(state.total_time):.5f} s in "
            f"{int(state.iteration)} steps, wall {wall:.2f} s"
        )
        if timesteps:
            import numpy as np

            ts = np.asarray(timesteps)
            self.logger.info(
                f"dt stats: min {ts.min():.3e}  mean {ts.mean():.3e}  max {ts.max():.3e}"
            )
            self.logger.info(self._ascii_plot(ts))
        self.logger.info("=" * 78)

    @staticmethod
    def _ascii_plot(ts, height: int = 10, width: int = 64) -> str:
        """dt-vs-output line plot (the reference renders a UnicodePlots graph
        at exit, SPHCellList.jl:923)."""
        import numpy as np

        if len(ts) < 2:
            return ""
        x = np.linspace(0, len(ts) - 1, min(width, len(ts)))
        y = np.interp(x, np.arange(len(ts)), ts)
        lo, hi = float(y.min()), float(y.max())
        span = (hi - lo) or 1.0
        rows = np.round((y - lo) / span * (height - 1)).astype(int)
        canvas = [[" "] * len(y) for _ in range(height)]
        for col, r in enumerate(rows):
            canvas[height - 1 - r][col] = "*"
        lines = [f"dt per output [{lo:.3e} .. {hi:.3e}]"]
        lines += ["|" + "".join(row) for row in canvas]
        lines.append("+" + "-" * len(y))
        return "\n".join(lines)

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
