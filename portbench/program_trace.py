"""A cell's window read from the port's own records (``utils/timers.py``):
spans, host-read counts and CUDA events per chunk graph replay, with tracing
off and on in turns in one process, then a sub-window under
``torch.profiler`` with the program's spans placed on its axis.

    python portbench/program_trace.py --workload movingsquare.run --seed <n> \\
        --seconds 20 [--turns off,on,on,off] [--out FILE]

Prints one JSON line: per turn the cell's end-to-end rates (its own
readers) and, tracing on, the window's readings:

* ``step.graph_ms_per_step``: the replays' device ms (the events after the
  buffers' load and after the launch) over the steps they took;
* ``driver.host_gap_share``: the device-clock gaps between chunks (the last
  event of one chunk to the first of the next: the card waiting on the
  host) over the device-clock span from the first chunk's first event to
  the last chunk's last, in %;
* ``driver.host_reads_per_interval``: ``driver.host_reads`` over the
  completed intervals;
* the account: replays + copies + gaps against that span, and the span
  against the window's host wall; the spans' count, total and self time.

The profiled sub-window adds the union of device activity per step
(``trace.reduce``), its longest idle gaps named ``"<innermost program span>
| <runtime record>"``, the idle time by innermost span, and how many
``cudaGraphLaunch`` records lie in a ``chunk.launch`` span.  Needs a CUDA
device; reads nothing of a program without the recorder.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# a gap shorter than this (us) is left out of the idle time by span
MIN_GAP_US = 10.0


def window_readings(rec, intervals: int, window_s: float) -> dict:
    """The window's readings from the recorder ``rec`` (tracing was on over
    exactly the window, which completed ``intervals`` intervals)."""
    from sphexample_tpu_torch.utils.timers import HOST_READS

    timed = [c for c in rec.chunks if c[3] is not None]
    steps = sum(c[1] for c in timed)
    replay = sum(c[3] for c in timed)
    copy = sum(c[4] for c in timed)
    # a gap where the chunk before ended another interval: through the driver
    inner, outer = [], []
    for prev, c in zip(rec.chunks, rec.chunks[1:]):
        if c[5] is not None:
            (inner if c[0] == prev[0] else outer).append(c[5])
    gap = sum(inner) + sum(outer)
    span = rec.device_span_ms()
    out = {"chunks": len(rec.chunks), "timed_chunks": len(timed), "steps": steps,
           "rebuilds": sum(c[2] for c in rec.chunks), "replay_ms": replay, "copy_ms": copy,
           "gap_ms": gap, "gaps_in_interval": [len(inner), sum(inner)],
           "gaps_between_intervals": [len(outer), sum(outer)], "device_span_ms": span,
           "host_reads": rec.counters[HOST_READS],
           "driver.host_reads_per_interval": rec.counters[HOST_READS] / intervals}
    if steps:
        out["step.graph_ms_per_step"] = replay / steps
    if span:
        out["driver.host_gap_share"] = 100.0 * gap / span
        out["account"] = (replay + copy + gap) / span
        out["span_over_window"] = span / 1e3 / window_s
    return out


def span_table(spans) -> dict:
    """Per span name: [count, total s, self s] (self: the span's duration
    less its children's)."""
    child = defaultdict(int)
    for name, a, b, parent, _ in spans:
        if parent is not None and b is not None:
            child[parent] += b - a
    table = defaultdict(lambda: [0, 0.0, 0.0])
    for row, (name, a, b, parent, _) in enumerate(spans):
        if b is None:
            continue
        t = table[name]
        t[0] += 1
        t[1] += (b - a) / 1e9
        t[2] += (b - a - child[row]) / 1e9
    return dict(sorted(table.items(), key=lambda kv: -kv[1][2]))


def named_gaps(events, spans, top: int = 10) -> dict:
    """The device's idle gaps in a trace framed by a marker kernel at each
    end (``trace.reduce``'s frame): the ``top`` longest, each named by the
    runtime record under it and, where the program's ``spans`` (``(start
    us, end us, name)`` on the trace's axis) cover it, by the innermost
    span first; and the idle seconds by innermost span over every gap of at
    least ``MIN_GAP_US``."""
    from portbench import stats, trace

    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if trace._device_type(e) == "CUDA":
            if not getattr(e, "is_user_annotation", False):
                device.append((a, b))
        else:
            name = f"profiler: {e.name}" if e.name in trace.PROFILER_RECORDS else e.name
            host.append((a, b, name))
    device.sort()
    lo, hi = device[0][1], device[-1][0]
    inner = [(max(a, lo), min(b, hi)) for a, b in device[1:-1] if b > lo and a < hi]
    idle = stats.gaps(inner, lo, hi)
    spans = sorted(spans)

    def span_at(a, b):
        near = [s for s in spans if s[0] < b and s[1] > a]
        name = trace._host_at(near, a, b) if near else None
        return None if name == "host, no record" else name

    longest = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        record, span = trace._host_at(host, a, b), span_at(a, b)
        longest.append([f"{span} | {record}" if span else record, (b - a) / 1e6])
    by_span = defaultdict(float)
    for a, b in idle:
        if b - a >= MIN_GAP_US:
            by_span[span_at(a, b) or "no span"] += (b - a) / 1e6
    return {"idle_gaps": longest,
            "idle_s_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def profiled(run, rec) -> dict:
    """A sub-window as the harness traces one (device activity only,
    framed by a marker kernel at each end), tracing on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, trace
    from sphexample_tpu_torch.utils import timers

    flag = torch.zeros(1, device=run.device)

    def marker():
        flag.add_(1)
        torch.cuda.synchronize(run.device)

    start = len(run.records)
    timers.start_trace()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker()
            run.drive("trace", harness.TRACE_SECONDS, harness.TRACE_MIN_INTERVALS)
            torch.cuda.synchronize(run.device)
            marker()
    finally:
        timers.stop_trace()
    events = prof.events()
    red = trace.reduce(events)
    recs = run.records[start:]
    steps = sum(r["steps"] for r in recs)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    spans = [((a - t0) / 1e3, (b - t0) / 1e3, name) for name, a, b, _, _ in rec.spans
             if b is not None]
    launches = [(a, b) for a, b, name in spans if name == "chunk.launch"]
    records = [(e.time_range.start, e.time_range.end) for e in events
               if "cudaGraphLaunch" in e.name]
    inside = sum(any(s - 20 <= a and b <= t + 20 for s, t in launches) for a, b in records)
    out = {"window_s": red["window_s"], "busy_s": red["busy_s"], "steps": steps,
           "intervals": len(recs), "device_ms_per_step": 1e3 * red["busy_s"] / steps,
           "idle_share": 1.0 - red["busy_s"] / red["window_s"],
           "graph_launches": len(records), "graph_launches_in_chunk_launch": inside,
           "readings": window_readings(rec, len(recs), red["window_s"]),
           "spans": span_table(rec.spans)}
    out.update(named_gaps(events, spans))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="each turn's window")
    ap.add_argument("--turns", default="off,on,on,off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import CACHES

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    import torch

    from portbench import harness
    from sphexample_tpu_torch.utils import timers

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 3
    c = harness.cell(args.workload)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    run = harness.Run(c, args.seed, device)
    run.setup(trace=True)
    turns = []
    for mode in args.turns.split(","):
        if mode not in ("on", "off"):
            raise SystemExit(f"a turn is 'on' or 'off', not {mode!r}")
        start = len(run.records)
        if mode == "on":
            timers.start_trace()
        try:
            run.window(args.seconds)
        finally:
            rec = timers.stop_trace()
        recs = run.records[start:]
        obs = dict(n_live=run.n_live, window_s=run.window_s, intervals=recs,
                   steps=sum(r["steps"] for r in recs))
        turn = {"mode": mode, "window_s": run.window_s, "intervals": len(recs),
                "steps": obs["steps"]}
        for m in c["end_to_end"]:
            if m["name"] != "setup_s":
                turn[m["name"]] = harness.load_module(
                    harness.find("metrics", m["name"], ".py")).read(obs)
        if mode == "on":
            turn.update(window_readings(rec, len(recs), run.window_s))
            turn["spans"] = span_table(rec.spans)
        turns.append(turn)
        print(f"program_trace: {json.dumps({k: v for k, v in turn.items() if k != 'spans'})}",
              file=sys.stderr, flush=True)
    result = {"workload": args.workload, "seed": args.seed, "turns": turns,
              "profiled": profiled(run, timers.RECORDER),
              "card": torch.cuda.get_device_name(device)}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
