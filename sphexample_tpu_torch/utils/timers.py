"""Timing of the host loop: the ``HourGlass`` section totals (port of
``sphexample_tpu/utils/timers.py``) and, while tracing is on, one recorder
of spans, counters and per-chunk device times.

The analog of the reference's TimerOutputs instrumentation (reference
``src/SPHCellList.jl:748-800`` wraps every stage in ``@timeit
SimMetaData.HourGlass "NN label"``; tables printed at exit,
SimulationLoggerConfiguration.jl:204-217):

* :class:`HourGlass` - a hierarchical wall-clock accumulator for the host
  loop (interval compute, retune, snapshot saves), printed as a table.
* :data:`RECORDER` - the spans of ``core/driver.py:run_simulation`` and of
  the chunk loop (``core/step.py``), the count of their device-to-host
  reads (``driver.host_reads``, through :func:`host_read`), the intervals
  run through each sweep kernel (``driver.sweep.block`` / ``.cell``) and, per chunk
  graph replay, device times from CUDA events.  Off by default;
  :func:`start_trace` clears it and turns it on, :func:`stop_trace` turns
  it off.  Off, every site costs one flag test: no span, no CUDA event, no
  device operation and no host read is added to the loop.

Spans are taken on ``time.time_ns()`` (CLOCK_REALTIME), the clock of
``torch.profiler``'s ``trace_start_ns()``: ``start_ns - trace_start_ns``
places a span on the axis of a profiler trace taken at the same time.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch

HOST_READS = "driver.host_reads"
# with the sweep kernel's name: the intervals run_simulation ran through it
SWEEP_COUNTER = "driver.sweep."
_OFF = nullcontext()


class _Span:
    """One span while it is open: its row in ``Recorder.spans``."""

    __slots__ = ("rec", "name", "row")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        with rec._lock:
            self.row = len(rec.spans)
            rec.spans.append([self.name, time.time_ns(), None,
                              stack[-1] if stack else None, rec.interval])
        stack.append(self.row)
        return self

    def __exit__(self, *exc):
        self.rec.spans[self.row][2] = time.time_ns()
        self.rec._stack().pop()
        return False


class Recorder:
    """What the host loop records while tracing is on, kept in memory:

    * ``spans``: ``[name, start_ns, end_ns, parent, interval]`` - ``parent``
      the row of the span open around it on the same thread (None at the
      top), ``interval`` the output counter of the interval it belongs to
      (:attr:`interval`, set by ``run_simulation``: the counter its save and
      log callbacks get), shared by that interval's spans;
    * ``counters``: named integer counts;
    * ``chunks``: per chunk ``(interval, steps, rebuilds, replay_ms,
      copy_ms, gap_ms)`` - the steps and rebuilds from the chunk's one host
      read; on the card, around a chunk graph's replay, the device time of
      the launch, of the buffers' copies in and out, and the device-clock
      gap from the previous chunk's last event to this chunk's first (the
      time the card waited on the host between them).  The device times are
      None for a chunk that replayed no graph; the gap is None for the first
      chunk timed and after one that was not.

    Four timing events a chunk come from a pool of eight, used in turns, so
    memory stays bounded; a chunk's events are read after its host read,
    which has already waited past them."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool: Dict[torch.device, list] = {}
        self.clear()

    def clear(self) -> None:
        self.spans: list = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.chunks: list = []
        self.interval: Optional[int] = None
        self._slot = 0
        self._pending = self._first = self._last = self._device = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A context manager that records span ``name`` while tracing is on
        (a shared no-op when off)."""
        return _Span(self, name) if self.on else _OFF

    def count(self, name: str) -> None:
        with self._lock:
            self.counters[name] += 1

    def chunk_mark(self, i: int, device) -> None:
        """Record the current chunk's timing event ``i`` on ``device``'s
        current stream: 0 before its buffers are loaded, 1 after, 2 after
        the graph's launch, 3 after the state is copied out."""
        stream = torch.cuda.current_stream(device)
        if i == 0:
            if self._pending is not None:
                self._last = None         # a chunk left unclosed: no gap across it
            pool = self._pool.get(device)
            if pool is None:
                pool = self._pool[device] = [torch.cuda.Event(enable_timing=True)
                                             for _ in range(8)]
            if device != self._device:
                self._device, self._first, self._last = device, None, None
            self._slot ^= 1
            self._pending = pool[4 * self._slot:4 * self._slot + 4]
        self._pending[i].record(stream)
        if i == 0 and self._first is None:
            # the first chunk's start, kept apart from the pool for the span
            self._first = torch.cuda.Event(enable_timing=True)
            self._first.record(stream)

    def chunk_done(self, steps: int, rebuilds: int) -> None:
        """Close the chunk whose host read gave ``steps`` and ``rebuilds``."""
        events, self._pending = self._pending, None
        replay = copy = gap = None
        if events is None:
            self._last = None
        else:
            e0, e1, e2, e3 = events
            replay = e1.elapsed_time(e2)
            copy = e0.elapsed_time(e1) + e2.elapsed_time(e3)
            if self._last is not None:
                gap = self._last.elapsed_time(e0)
            self._last = e3
        self.chunks.append((self.interval, steps, rebuilds, replay, copy, gap))

    def device_span_ms(self) -> Optional[float]:
        """Device ms from the first timed chunk's first event to the last
        chunk's last (None unless the last chunk was timed); read it after
        the device has passed that event."""
        if self._first is None or self._last is None:
            return None
        return self._first.elapsed_time(self._last)


RECORDER = Recorder()


def start_trace() -> Recorder:
    """Clear :data:`RECORDER` and turn tracing on."""
    RECORDER.clear()
    RECORDER.on = True
    return RECORDER


def stop_trace() -> Recorder:
    """Turn tracing off; what was recorded stays until the next start."""
    RECORDER.on = False
    return RECORDER


def host_read(tensor: torch.Tensor, convert=float):
    """``convert(tensor)``: a read that waits for the device and copies to
    the host, counted under ``driver.host_reads`` while tracing is on."""
    if RECORDER.on:
        RECORDER.count(HOST_READS)
    return convert(tensor)


class HourGlass:
    """Named wall-clock accumulator (reference TimerOutputs analog).  While
    tracing is on a section is also a span of :data:`RECORDER`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str, span: Optional[str] = None):
        """Time the block under ``name``; its span is named ``span`` (the
        section's name when None)."""
        t = time.perf_counter()
        try:
            with RECORDER.span(span or name):
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
