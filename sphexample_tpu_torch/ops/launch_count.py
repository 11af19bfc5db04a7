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

A device counter exists on a device once :func:`arm` made it (before a
capture); a launch captured on a device without one raises.  The slabs of a
sharded run are threads: the integers change under one lock.
"""

from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_slots: list = []        # (module, count name), the device counters' order
_counters: dict = {}     # device -> int64 [len(_slots)]
_folded: dict = {}       # device -> the counter values already in the integers


def register(module, *names: str) -> None:
    """Give the counts ``names`` of ``module`` (its integers) a device
    counter slot each; done once, when the module is imported."""
    for name in names:
        if (module, name) not in _slots:
            _slots.append((module, name))


def arm(device) -> None:
    """Make the device counters of ``device`` (zeros), if not yet made:
    before a capture, since a counter made during one would live in the
    graph's memory."""
    device = torch.device(device)
    with _lock:
        if device not in _counters:
            _counters[device] = torch.zeros(len(_slots), dtype=torch.int64, device=device)
            _folded[device] = [0] * len(_slots)


def add(module, name: str, n: int, device) -> None:
    """Count ``n`` launches of ``module``'s count ``name``, made now on
    ``device``'s current stream: into the module's integer, or, while that
    stream captures a graph, onto the device counter, inside the graph."""
    if n == 0:
        return
    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            capturing = torch.cuda.is_current_stream_capturing()
    else:
        capturing = False
    if capturing:
        counters = _counters.get(device)
        if counters is None:
            raise RuntimeError(f"a launch captured on {device} with no device counter "
                               "to count it (launch_count.arm was not called)")
        counters[_slots.index((module, name))].add_(n)
        return
    with _lock:
        setattr(module, name, getattr(module, name) + n)


def counters(device):
    """The device counters of ``device``, or None where none were armed."""
    return _counters.get(torch.device(device))


def fold(device, values) -> None:
    """Add what the device counters of ``device`` gained since the last fold
    to the module integers; ``values`` are the counters as the host read them
    (in slot order).  The counters only grow, so a read older than the last
    fold adds nothing."""
    device = torch.device(device)
    with _lock:
        seen = _folded[device]
        for i, ((module, name), v) in enumerate(zip(_slots, values)):
            v = int(v)
            if v > seen[i]:
                setattr(module, name, getattr(module, name) + v - seen[i])
                seen[i] = v
