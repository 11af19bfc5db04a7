"""Reduction of a ``torch.profiler`` trace of a traced sub-window: the union
of device activity, the device operations that took most time, the longest
idle gaps named by the host's CUDA runtime call under them, a kernel's
time per launch, and the total time and launches of named groups of device
operations.

Times are the profiler's (microseconds from its start).  The harness frames
the sub-window with one marker kernel at each end, so it runs from the end
of the first device operation to the start of the last.
"""

from __future__ import annotations

from collections import defaultdict

from .stats import gaps, union_length

# the profiler's own records on the host (its buffer management, not the
# program): the gaps they cover are named as the profiler's
PROFILER_RECORDS = ("Activity Buffer Request", "Buffer Flush")


def _device_type(e):
    return str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]


def reduce(events, kernel_names=("block_sweep_kernel",), top: int = 10,
           groups: dict = None) -> dict:
    """``events``: the profiler's ``events()`` (FunctionEvent records); None
    where the markers and something between them are not all there.
    ``groups`` (name: a part of a device operation's name) adds, for each
    group, ``<name>_s`` and ``<name>_launches``: the seconds and the count of
    the device operations whose names hold that part."""
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _device_type(e) == "CUDA":
            if not getattr(e, "is_user_annotation", False):
                device.append((a, b, e.name))
        else:
            name = f"profiler: {e.name}" if e.name in PROFILER_RECORDS else e.name
            host.append((a, b, name))
    device.sort()
    if len(device) < 3:
        return None
    lo, hi = device[0][1], device[-1][0]
    device = [(max(a, lo), min(b, hi), name) for a, b, name in device[1:-1]
              if b > lo and a < hi]
    busy = union_length([(a, b) for a, b, _ in device], lo, hi)
    by_name = defaultdict(float)
    for a, b, name in device:
        by_name[name] += b - a
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    idle = sorted(gaps([(a, b) for a, b, _ in device], lo, hi), key=lambda g: g[0] - g[1])[:top]
    idle_named = [[_host_at(host, a, b), (b - a) / 1e6] for a, b in idle]

    kernel = [(a, b) for a, b, name in device if any(k in name for k in kernel_names)]
    totals = {}
    for group, part in (groups or {}).items():
        mine = [b - a for a, b, name in device if part in name]
        totals[f"{group}_s"] = sum(mine) / 1e6
        totals[f"{group}_launches"] = len(mine)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "device_events": len(device),
        "device_ops": [[name[:120], us / 1e6] for name, us in device_ops],
        "idle_gaps": idle_named,
        "kernel_launches": len(kernel),
        "kernel_s": sum(b - a for a, b in kernel) / 1e6,
        **totals,
    }


def _host_at(host, a, b) -> str:
    """The host record that covers at least half of the gap [a, b] and is
    the shortest such (the most specific), else the one that covers most of
    it; "host, no record" where none overlaps."""
    best, covering = None, None
    for s, e, name in host:
        over = min(e, b) - max(s, a)
        if over <= 0:
            continue
        if over >= 0.5 * (b - a) and (covering is None or e - s < covering[0]):
            covering = (e - s, name)
        if best is None or over > best[0]:
            best = (over, name)
    if covering is not None:
        return covering[1][:120]
    return best[1][:120] if best else "host, no record"
