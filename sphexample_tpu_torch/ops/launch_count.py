"""Kernel launch counts that stay true when a CUDA graph replays the launches.

Each kernel wrapper (``ops/block_sweep.py``, ``ops/cell_sweep.py``,
``ops/mdbc_moments.py``) keeps its counts as module integers (``launches``,
``window_launches``, ``group_launches``) and adds to them with :func:`add`
where it launches its kernel, and nowhere else.  An eager launch adds to the
integer at once.  A launch made while its stream captures a graph
(``core/step.py:ChunkGraph``) runs only when the graph replays it: there
:func:`add` puts an ``add_`` on the device counter of that count into the
same graph, beside the launch, so that every replay of the node adds to the
device counter too, and a node that a replay skips (an IF node's body not
taken) adds nothing.  The chunk loop folds the device counters into the
module integers at its one host read after each chunk (:func:`fold`), so the
integers count every launch that ran, eager or replayed.

The device counters are kept per device and per *lane*: the rank of the
thread that launches (``parallel/context.py:thread_rank``; 0 outside a
sharded run).  The slabs of a sharded run on one card are branches of one
graph that run at the same time, so each rank adds to a counter of its own,
and no two ``add_`` nodes write the same element.  A lane's counters exist
once :func:`arm` made them (before a capture); a launch captured in a lane
without them raises.  The module integers change under one lock.
"""

from __future__ import annotations

import threading

import torch

from ..parallel.context import thread_rank

_lock = threading.Lock()
_slots: list = []        # (module, count name), the device counters' order
_counters: dict = {}     # (device, lane) -> int64 [len(_slots)]
_folded: dict = {}       # (device, lane) -> the counter values already in the integers


def register(module, *names: str) -> None:
    """Give the counts ``names`` of ``module`` (its integers) a device
    counter slot each; done once, when the module is imported."""
    for name in names:
        if (module, name) not in _slots:
            _slots.append((module, name))


def arm(device, lanes: int = 1) -> None:
    """Make the device counters of lanes ``0 .. lanes - 1`` on ``device``
    (zeros), those not yet made: before a capture, since a counter made
    during one would live in the graph's memory."""
    device = torch.device(device)
    with _lock:
        for lane in range(lanes):
            if (device, lane) not in _counters:
                _counters[device, lane] = torch.zeros(len(_slots), dtype=torch.int64,
                                                      device=device)
                _folded[device, lane] = [0] * len(_slots)


def _capturing(device: torch.device) -> bool:
    """Whether ``device``'s current stream captures a graph."""
    if device.type != "cuda":
        return False
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


def add(module, name: str, n: int, device) -> None:
    """Count ``n`` launches of ``module``'s count ``name``, made now on
    ``device``'s current stream: into the module's integer, or, while that
    stream captures a graph, onto the calling rank's device counter, inside
    the graph."""
    if n == 0:
        return
    device = torch.device(device)
    if _capturing(device):
        lane = thread_rank()
        counters = _counters.get((device, lane))
        if counters is None:
            raise RuntimeError(f"a launch captured on {device} (rank {lane}) with no "
                               "device counter to count it (launch_count.arm was not "
                               "called)")
        counters[_slots.index((module, name))].add_(n)
        return
    with _lock:
        setattr(module, name, getattr(module, name) + n)


def counters(device) -> list:
    """The device counters of ``device``, one tensor per lane in lane order
    (empty where none were armed)."""
    device = torch.device(device)
    lanes = sorted(lane for d, lane in _counters if d == device)
    return [_counters[device, lane] for lane in lanes]


def fold(device, values) -> None:
    """Add what the device counters of ``device`` gained since the last fold
    to the module integers; ``values`` are the counters as the host read
    them, :func:`counters`' tensors one after the other.  The counters only
    grow, so a read older than the last fold adds nothing."""
    device = torch.device(device)
    lanes = sorted(lane for d, lane in _counters if d == device)
    k = len(_slots)
    with _lock:
        for j, lane in enumerate(lanes):
            seen = _folded[device, lane]
            for i, ((module, name), v) in enumerate(zip(_slots, values[j * k:(j + 1) * k])):
                v = int(v)
                if v > seen[i]:
                    setattr(module, name, getattr(module, name) + v - seen[i])
                    seen[i] = v
