"""One run of one cell of the port's benchmark (``python portbench/run.py``).

A cell names a configuration (``configs/<name>.json``: the deck, its
constants and models, the limits of its comparison), a traffic mix
(``traffic/<name>.json``) and its metrics, each read by
``metrics/<name>.py``.  Nothing here knows a cell by name.

The run:

1. Set-up: the deck's arrays from the seed (the fluid rows jittered well
   under a particle spacing), the port's kernels loaded (built on a
   checkout's first run), the simulation assembled with
   ``assemble_simulation``, its one chunk graph captured by a short warm
   interval, the initial state kept.
2. The window: ``run_simulation`` on the initial state, passes of the deck
   from t = 0 to its end time, each pass from the initial state again, until
   the first output after ``seconds``.
3. With ``trace``: a sub-window of a few more intervals under
   ``torch.profiler`` (device activity only), framed by a marker kernel at
   each end.
4. The peak memory is read, the program's state freed, and the reference
   (``reference/``) recomputes two intervals of the first pass
   (``check.py``); every number compared is printed beside its limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sphexample_tpu")
# the warm interval that captures the chunk graph: a step or two
WARM_T_OUT = 1e-4
# the traced sub-window: at least this long and this many intervals
TRACE_SECONDS = 0.3
TRACE_MIN_INTERVALS = 2
# stage 04 on the card: the fused mdbc_moments_kernel and its four
# mdbc_*_group_kernel launches
MDBC_OPS = "mdbc_"


class StopWindow(Exception):
    """Raised from the log callback once the window has what it needs."""


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find(kind: str, name: str, suffix: str) -> Path:
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path.relative_to(ROOT)})")
    return path


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(workload: str, bench: dict = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json``: its entry, configuration,
    traffic and the metrics it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(workload=entry,
                config=load_json(find("configs", entry["config"], ".json")),
                traffic=load_json(find("traffic", entry["traffic"], ".json")),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def f32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to float32 values, held in float64."""
    return a.astype(np.float32).astype(np.float64)


def deck_arrays(config: dict, seed: int) -> tuple:
    """(position, density, ptype, group_marker, idp) of the configuration's
    deck, the fluid rows jittered by up to ``jitter_dx`` spacings per axis,
    every position a float32 value (both sides start from the same bits).
    A deck with ghost nodes adds (ghost_points, ghost_normals) of its first
    rows (ids 1..nb), unjittered, rounded to float32 as well."""
    pos, rho, ptype, marker, ids, *ghosts = load_module(
        find("decks", config["deck"], ".py")).build(config["geometry"])
    fluid = ptype == 1
    jitter = config["jitter_dx"] * config["constants"]["dx"]
    pos = pos.copy()
    pos[fluid] += rng(seed, 0).uniform(-jitter, jitter, pos[fluid].shape)
    return (f32(pos), rho, ptype, marker, ids, *(f32(g) for g in ghosts))


def later_output(config: dict, seed: int) -> int:
    lo, hi = config["check"]["later"]
    return int(rng(seed, 1).integers(lo, hi + 1))


def build_port(config: dict, arrays: tuple, device):
    """The simulation as the deck's CLI assembles it (``examples/_runner.py``),
    with no output: nothing is written to ``save_location``.  With SIMPLE
    mDBC the deck's ghost points and normals go with the arrays."""
    import sphexample_tpu_torch as T

    c, k, m, r = config["constants"], config["kernel"], config["models"], config["run"]
    size = {"h": k["h"]} if "h" in k else {"dx": k["dx"]}
    kern = T.make_kernel(T.KernelFamily(k["family"]), k["dims"], k=k.get("k", 2.0), **size)
    meta = T.SimulationMetaData(
        simulation_name=config["name"], save_location="", dims=r["dims"],
        simulation_time=r["t_end"], output_times=r["output_times"], dtype=r["dtype"],
        shifting=T.ShiftingMode(m["shifting"]), kernel_output=T.KernelOutputMode(m["kernel_output"]),
        mdbc=T.MDBCMode(m["mdbc"]))
    geometries = [T.Geometry(csv_file="", group_marker=mo["marker"], type=T.ParticleType.MOVING,
                             motion=T.MotionDetails(velocity=mo["velocity"],
                                                    start_time=mo["start_time"],
                                                    duration=mo["duration"],
                                                    direction=tuple(mo["direction"])))
                  for mo in config.get("motion", ())]
    ghosts = {}
    if m["mdbc"] == "simple":
        ghosts = dict(ghost_points=arrays[5], ghost_normals=arrays[6])
    return T.assemble_simulation(*arrays[:5], meta, T.SimulationConstants(**c), kern,
                                 T.ViscosityModel(m["viscosity"]),
                                 T.DensityDiffusionModel(m["diffusion"]),
                                 geometries=geometries, device=device, **ghosts)


def plant(fault: str, fn, dx: float):
    """The timed path broken underneath, for the harness's own tests."""
    import torch

    def unchanged(state, t_out, progress=None):
        out = fn(state, t_out, progress)
        return state.replace(total_time=out.total_time, iteration=out.iteration,
                             current_dt=out.current_dt, rebuilds=out.rebuilds)

    def half(state, t_out, progress=None):
        out = fn(state, t_out, progress)
        p_in, p = state.particles, out.particles
        where = torch.empty_like(p_in.id, dtype=torch.long)
        where[p_in.id.long() - 1] = torch.arange(p_in.capacity, device=p.device)
        src = where[p.id.long() - 1]
        left = (p.id % 2 == 0)
        pick = lambda a, b: torch.where(left.reshape((-1,) + (1,) * (a.dim() - 1)), b[src], a)  # noqa: E731
        return out.replace(particles=p.replace(
            position=pick(p.position, p_in.position), velocity=pick(p.velocity, p_in.velocity),
            density=pick(p.density, p_in.density)))

    def altered(state, t_out, progress=None):
        out = fn(state, t_out, progress)
        p = out.particles
        pos = p.position.clone()
        pos[torch.argmax(p.id * (p.ptype == 1)), 0] += dx
        return out.replace(particles=p.replace(position=pos))

    return {"unchanged": unchanged, "half": half, "altered": altered}[fault]


def gate(state, rho0: float):
    """1 where an interval's end state breaks a run gate (a non-finite
    field, an escape from the grid, a fluid density outside [rho0 / 2,
    2 rho0]), else 0: a device tensor, read once after the window."""
    import torch

    p = state.particles
    fluid = p.ptype == 1
    ok = (torch.isfinite(p.position).all() & torch.isfinite(p.velocity).all()
          & (state.grid_escapes == 0)
          & ~(fluid & ((p.density < 0.5 * rho0) | (p.density > 2.0 * rho0))).any())
    return (~ok).to(torch.int32)


class Run:
    """The window, the traced sub-window and what they recorded."""

    def __init__(self, c: dict, seed: int, device, fault: str = None):
        self.c, self.seed, self.device, self.fault = c, seed, device, fault
        self.config = c["config"]
        self.records = []            # one per completed output interval
        self.rebuild_counts = []     # device counters at the end of each pass
        self.replays = self.raised = 0
        self.snap = {}               # "first" / "later": (state in, state out, t_out)
        self.last_state = None
        self.later_k = later_output(self.config, seed)
        self.setup_parts = {}

    # -- set-up -------------------------------------------------------------
    def setup(self, trace: bool):
        import torch

        parts, t = self.setup_parts, time.perf_counter()

        def mark(name):
            nonlocal t
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        self.arrays = deck_arrays(self.config, self.seed)
        mark("arrays")
        if self.device.type == "cuda":
            from sphexample_tpu_torch.ops._build import load_all

            load_all()
        mark("kernels")
        self.sim = sim = build_port(self.config, self.arrays, self.device)
        self.n_live = sim.n_live
        inner = sim.interval_fn
        self.chunk = getattr(inner, "chunk", None)
        if self.fault:
            inner = plant(self.fault, inner, self.config["constants"]["dx"])
        self.inner = inner
        sim.interval_fn = self.interval
        self.state0 = sim.state
        self.bad = torch.zeros((), dtype=torch.int32, device=self.device)
        self.phase, self.pass_index = "warm", -1
        self.sync()
        mark("assemble")
        inner(self.state0, WARM_T_OUT)               # captures the chunk graph
        self.sync()
        mark("warm_interval")
        if trace and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                torch.ones(1, device=self.device).add_(1)
                torch.cuda.synchronize(self.device)
            mark("profiler")

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the loop calls ------------------------------------------------
    def interval(self, state, t_out, progress=None):
        out = self.inner(state, t_out, progress)
        self.bad = self.bad + gate(out, 1000.0)
        self.last_state = out
        if self.phase == "window" and self.pass_index == 0:
            self.in_pass += 1
            if self.in_pass == 1:
                self.snap["first"] = (state, out, t_out)
            if self.in_pass <= self.later_k and self.in_pass >= 2:
                self.snap["later"] = (state, out, t_out)
        return out

    def log(self, info):
        now = time.perf_counter()
        self.records.append(dict(phase=self.phase, pass_index=self.pass_index,
                                 counter=info["counter"], steps=info["steps_in_interval"],
                                 wall_s=now - self.mark))
        self.mark = now
        self.done += 1
        # the next interval: the following output, or a new pass once this
        # one has passed the deck's end time
        ended = info["total_time"] > self.config["run"]["t_end"]
        self.next_counter = 1 if ended else info["counter"]
        if now >= self.deadline and self.done >= self.min_intervals:
            raise StopWindow

    # -- the window -----------------------------------------------------------
    def drive(self, phase: str, seconds: float, min_intervals: int = 1):
        """Passes of ``run_simulation`` until ``seconds`` have passed and
        ``min_intervals`` intervals completed; a pass that reaches the
        deck's end time is followed by one from the initial state."""
        from sphexample_tpu_torch.core.driver import run_simulation

        sim = self.sim
        self.phase, self.min_intervals, self.done = phase, min_intervals, 0
        self.deadline = time.perf_counter() + seconds
        while True:
            counter = self.next_counter
            if counter == 1:
                self.pass_index += 1
                self.in_pass = 0
                sim.state = self.state0
            else:
                sim.state = self.last_state
            grid = sim.cfg.grid
            self.mark = time.perf_counter()
            stop = False
            try:
                run_simulation(sim, log_callback=self.log, start_counter=counter)
                self.next_counter = 1
            except StopWindow:
                stop = True
            except Exception:                                   # noqa: BLE001
                traceback.print_exc(file=sys.stderr)
                self.raised += 1
                stop = True
            if self.last_state is not None:
                self.rebuild_counts.append((phase, self.last_state.rebuilds))
            if sim.cfg.grid != grid or sim.interval_fn != self.interval:
                self.replays += 1                               # a re-grid and replay
                sim.interval_fn = self.interval
            if stop or self.raised:
                return

    def window(self, seconds: float):
        self.next_counter = 1
        self.sync()
        t0 = time.perf_counter()
        self.drive("window", seconds)
        self.sync()
        self.window_s = time.perf_counter() - t0

    def traced(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from . import trace

        if self.raised:
            return None

        flag = torch.zeros(1, device=self.device)

        def marker():                   # one kernel: an end of the sub-window
            flag.add_(1)
            torch.cuda.synchronize(self.device)

        # device activity only: the host's own records would slow the loop
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker()
            self.drive("trace", TRACE_SECONDS, TRACE_MIN_INTERVALS)
            torch.cuda.synchronize(self.device)
            marker()
        mdbc = self.config["models"]["mdbc"] == "simple"
        red = trace.reduce(prof.events(), groups={"mdbc": MDBC_OPS} if mdbc else None)
        if red is None:
            return None
        red["steps"] = steps = sum(r["steps"] for r in self.records if r["phase"] == "trace")
        if mdbc and steps:
            red["mdbc_s_per_step"] = red.pop("mdbc_s") / steps
            red["mdbc_launches_per_step"] = red.pop("mdbc_launches") / steps
        if self.sim.cfg.sweep_kernel == "block":
            if red["kernel_launches"] == 2 * red["steps"] and red["steps"]:
                red["b1_s_per_launch"] = red["kernel_s"] / red["kernel_launches"]
                red["b1_source"] = "profiler, graph replays"
            else:
                red["b1_s_per_launch"] = self.eager_b1()
                red["b1_source"] = "profiler, eager launches on the traced state"
        return red

    def eager_b1(self):
        """B1's device time per launch over eager launches on the last
        traced state (the profiler names a graph's kernels unreliably)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from sphexample_tpu_torch.ops.block_sweep import block_sweep

        st, cfg = self.last_state, self.sim.cfg
        p = st.particles

        def call():
            block_sweep(cfg.spec, cfg.grid, p, st.cell_start, p.position, p.density,
                        p.pressure, p.velocity)

        call()
        torch.cuda.synchronize(self.device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize(self.device)
        mine = [e for e in prof.events() if "block_sweep_kernel" in e.name]
        if not mine:
            return None
        return sum(e.time_range.elapsed_us() for e in mine) / 1e6 / len(mine)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, fault: str = None, control: str = None, c: dict = None,
             out=sys.stdout) -> int:
    """One run; prints the result's line on ``out``.  Returns the exit code.
    ``device``, ``fault``, ``control`` and ``c`` (a cell dict) are for the
    benchmark's own tests and the control's script: ``control`` names the
    dtype in which the reference takes the program's place."""
    import torch

    from . import check, work
    from .reference import sph

    c = c or cell(workload)
    chips = c["workload"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
    device = torch.device(device)
    cuda = device.type == "cuda"
    run = Run(c, seed, device, fault)
    run.setup_parts["imports"] = time.perf_counter() - t_start
    if cuda:
        t = time.perf_counter()
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        run.setup_parts["cuda_init"] = time.perf_counter() - t
    run.setup(trace)
    setup_s = time.perf_counter() - t_start
    run.window(seconds)
    window_records = [r for r in run.records if r["phase"] == "window"]
    traced = run.traced() if trace and cuda else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bad = int(run.bad)
    rebuilds = sum(int(t) for ph, t in run.rebuild_counts if ph == "window")
    nodes = getattr(getattr(run.chunk, "graph", None), "nodes_per_step", None)
    final = run.last_state
    work_done = None
    if traced is not None and traced.get("b1_s_per_launch") and final is not None:
        P = sph.physics(run.config)
        work_done = work.sweep_work(run.config, P, sph.Grid.around(run.arrays[0], P),
                                    final.particles.position, final.particles.velocity)
    if traced is not None and "mdbc_s_per_step" in traced and final is not None:
        work_done = dict(work_done or {}, mdbc=state_mdbc_work(run, final))
    # host copies of what the comparison needs, then the program is freed
    snaps = {name: (check.port_numpy(a), check.port_numpy(b), t_out)
             for name, (a, b, t_out) in run.snap.items()}
    orders = {name: a.particles.id.long().cpu().numpy() - 1
              for name, (a, b, t_out) in run.snap.items()}
    del run.sim, run.snap, run.last_state, run.state0, run.inner, run.chunk, final
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the metrics ------------------------------------------------------------
    obs = dict(config=run.config, n_live=run.n_live, setup_s=setup_s, window_s=run.window_s,
               intervals=window_records, steps=sum(r["steps"] for r in window_records),
               rebuilds=rebuilds, graph_nodes_per_step=nodes, memory_peak_bytes=peak,
               trace=traced, work=work_done)
    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = load_module(find("metrics", m["name"], ".py")).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the comparison -------------------------------------------------------------
    t_check = time.perf_counter()
    readings = {}
    for name, (a, b, t_out) in snaps.items():
        steps = b["iteration"] - a["iteration"]
        start = None
        if name != "first":
            start = dict(a, order=orders[name])
        ref, ref_steps = check.reference_interval(run.config, run.arrays, start, t_out,
                                                  4 * steps + 10, device=device)
        got, got_steps = b, steps
        if control:
            got, got_steps = check.reference_interval(run.config, run.arrays, start, t_out,
                                                      4 * steps + 10, dtype=getattr(torch, control),
                                                      device=device)
        for field, v in check.gaps(got, ref, got_steps, ref_steps, sph.physics(run.config)).items():
            readings[f"{name}.{field}"] = v
    limits = dict(run.config["check"]["limits"])
    if "later" not in snaps:
        limits = {k: v for k, v in limits.items() if not k.startswith("later.")}
    ok, rows = check.judge(readings, limits)
    run.setup_parts["check_s"] = time.perf_counter() - t_check

    failed = run.raised + run.replays + bad
    attempted = len(window_records) + run.raised + run.replays
    result = {"correct": bool(ok and failed == 0 and window_records), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": chips, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    report(run, obs, traced, work_done, cuda)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def state_mdbc_work(run: Run, state) -> dict:
    """``work.mdbc_work`` of ``state``'s positions with the deck's ghost
    points and particle types (not the program's copies), row by row as the
    state holds them."""
    import torch

    from . import check, work
    from .reference import sph

    p = state.particles
    ids = p.id.long().cpu().numpy() - 1
    ghost = check.deck_ghosts(run.arrays)[ids]
    ghost = torch.as_tensor(ghost).to(p.position.device, p.position.dtype)
    ptype = torch.as_tensor(run.arrays[2][ids], device=p.position.device)
    return work.mdbc_work(run.config, sph.physics(run.config), p.position, ghost, ptype)


def report(run: Run, obs: dict, traced, work_done, cuda: bool):
    """What a reader of the run's standard error wants besides the checks."""
    info = dict(setup_s=obs["setup_s"], parts=run.setup_parts, window_s=obs["window_s"],
                intervals=len(obs["intervals"]), steps=obs["steps"],
                passes=run.pass_index + 1, rebuilds=obs["rebuilds"], later_output=run.later_k,
                graph_nodes_per_step=obs["graph_nodes_per_step"])
    if traced is not None:
        info["trace"] = {k: v for k, v in traced.items() if k not in ("device_ops", "idle_gaps")}
    if work_done is not None:
        info["work"] = work_done
    if traced is not None and "mdbc_s_per_step" in traced:
        from . import work

        t = traced["mdbc_s_per_step"]
        info["mdbc"] = {"ms_per_step": 1e3 * t,
                        "launches_per_step": traced["mdbc_launches_per_step"],
                        "roofline_pct": work.roofline_pct(
                            (work_done or {}).get("mdbc", {}).get("bound_s"), t)}
    if cuda:
        try:
            info["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            info["card"] = f"nvidia-smi: {e}"
    print("portbench: " + json.dumps(info), file=sys.stderr)
