"""The tracing recorder of ``sphexample_tpu_torch/utils/timers.py`` on the
CPU: off it records nothing and creates no CUDA event; on, over a tiny deck's
intervals, the span tree of ``run_simulation`` and the chunk loop (parents,
interval ids, nesting in time), the count of device-to-host reads (seven an
interval with a log callback, plus one a chunk; one more sharded, for the
halo), the chunks' steps and rebuilds, the count of intervals per sweep
kernel (block, and cell with the capacity rule's cap lowered), and a
trajectory bit for bit the one run with tracing off.  The card's part (CUDA events around a replay, the
profiler's clock) is in ``tests/test_torch_cuda.py``."""

import hashlib
import re
import time

import pytest
import torch
from torch.overrides import TorchFunctionMode

import sphexample_tpu_torch as T
from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation
from sphexample_tpu_torch.state import gather_state, state_tensors
from sphexample_tpu_torch.utils import timers
from sphexample_tpu_torch.utils.timers import HOST_READS, RECORDER, HourGlass
from test_torch_driver import tiny

torch.set_num_threads(1)
INTERVALS = 2
DRIVER_CHILDREN = {"driver.pre_read", "chunk_loop.interval", "driver.overflow_check",
                   "driver.log", "driver.end_check"}


@pytest.fixture(autouse=True)
def tracing_off():
    timers.stop_trace()
    RECORDER.clear()
    yield
    timers.stop_trace()
    RECORDER.clear()


class _CountReads(TorchFunctionMode):
    """Counts every read of a tensor's value into a Python number or list."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
             torch.Tensor.__int__, torch.Tensor.__float__}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _sim(sharded=False):
    sim = tiny(T, max_steps_per_call=3, block_size=32)
    return shard_simulation(sim, make_mesh(2, "cpu")) if sharded else sim


def _digest(state) -> str:
    h = hashlib.sha256()
    for k, v in state_tensors(gather_state(state)).items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _run(sim, trace: bool):
    """``INTERVALS`` intervals with a log callback and a progress callback
    that reads nothing, tracing on or off; the log records, the torch-level
    reads counted and the end state."""
    logs, mode = [], _CountReads()
    if trace:
        timers.start_trace()
    try:
        with mode:
            T.run_simulation(sim, log_callback=logs.append, max_intervals=INTERVALS,
                             progress_callback=lambda state: None)
    finally:
        timers.stop_trace()
    return logs, mode.n, sim.state


def _no_cuda_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was created")

    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_tracing_off_records_nothing_and_leaves_the_hourglass(monkeypatch):
    _no_cuda_event(monkeypatch)
    sims = [_sim(), _sim()]
    _run(sims[0], trace=False)
    assert RECORDER.spans == [] and dict(RECORDER.counters) == {} and RECORDER.chunks == []
    assert RECORDER.interval is None
    _run(sims[1], trace=True)
    assert RECORDER.spans and RECORDER.counters[HOST_READS] > 0
    off, on = sims[0].hourglass, sims[1].hourglass
    assert dict(off.counts) == dict(on.counts) == {"00 SimulationLoop": INTERVALS}
    names = [re.split(r"\s{2,}", line)[0] for line in off.report().splitlines()]
    assert names == [re.split(r"\s{2,}", line)[0] for line in on.report().splitlines()]


def test_hourglass_section_is_a_span_only_while_tracing():
    hg = HourGlass()
    with hg.section("13 Save Particle Data", "driver.save"):
        time.sleep(0.002)
    assert RECORDER.spans == []
    timers.start_trace()
    with hg.section("13 Save Particle Data", "driver.save"):
        with hg.section("02b Retune neighbor windows"):
            pass
    timers.stop_trace()
    assert hg.counts == {"13 Save Particle Data": 2, "02b Retune neighbor windows": 1}
    assert hg.totals["13 Save Particle Data"] >= 0.002
    (save, t0, t1, parent, _), (retune, s0, s1, rparent, _) = RECORDER.spans
    assert (save, parent, retune, rparent) == ("driver.save", None,
                                               "02b Retune neighbor windows", 0)
    assert t0 <= s0 <= s1 <= t1


def test_span_tree_of_the_driver_and_the_chunk_loop():
    sim = _sim()
    logs, _, _ = _run(sim, trace=True)
    spans = RECORDER.spans
    by_row = dict(enumerate(spans))

    def parent_name(row):
        p = by_row[row][3]
        return None if p is None else by_row[p][0]

    tops = [r for r, s in by_row.items() if s[3] is None]
    assert [spans[r][0] for r in tops] == ["driver.interval"] * INTERVALS
    assert [spans[r][4] for r in tops] == [rec["counter"] for rec in logs] == [2, 3]
    for top in tops:
        kids = {s[0] for s in spans if s[3] == top}
        assert kids == DRIVER_CHILDREN
    want = {"chunk_loop.interval": "driver.interval", "chunk": "chunk_loop.interval",
            "chunk.load": "chunk", "chunk.out": "chunk", "chunk.host_read": "chunk",
            "chunk.progress": "chunk"}
    seen = set()
    for row, (name, start, end, parent, interval) in by_row.items():
        assert start <= end
        if parent is not None:
            p = by_row[parent]
            assert p[1] <= start and end <= p[2]
            assert interval == p[4]          # one interval's spans share its id
        if name in want:
            assert parent_name(row) == want[name], name
            seen.add(name)
    assert seen == set(want)
    # chunks of 3 steps: every chunk has its host read, all but an
    # interval's last its progress call
    n_chunks = sum(s[0] == "chunk" for s in spans)
    assert sum(s[0] == "chunk.host_read" for s in spans) == n_chunks
    assert sum(s[0] == "chunk.progress" for s in spans) == n_chunks - INTERVALS
    assert n_chunks == sum(-(-rec["steps_in_interval"] // 3) for rec in logs)


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_host_reads_are_counted_and_tracing_adds_none(sharded):
    logs_off, reads_off, _ = _run(_sim(sharded), trace=False)
    sim = _sim(sharded)
    logs_on, reads_on, state = _run(sim, trace=True)
    # the reads the loop makes, as torch sees them, are the same in number
    assert reads_on == reads_off
    chunks = RECORDER.chunks
    halo = 1 if sim.cfg.halo else 0
    assert RECORDER.counters[HOST_READS] == (7 + halo) * INTERVALS + len(chunks)
    assert sharded == bool(halo)
    # the chunks' steps and rebuilds, from each chunk's one read
    assert [c[0] for c in chunks] == sorted(c[0] for c in chunks)
    assert {c[0] for c in chunks} == {rec["counter"] for rec in logs_on}
    for rec in logs_on:
        mine = [c for c in chunks if c[0] == rec["counter"]]
        assert sum(c[1] for c in mine) == rec["steps_in_interval"]
        assert all(0 < c[1] <= 3 for c in mine)
    lead = state[0] if sharded else state
    # every interval's first step rebuilds
    assert sum(c[2] for c in chunks) == int(lead.rebuilds) >= INTERVALS
    firsts = [c for k, c in enumerate(chunks) if k == 0 or chunks[k - 1][0] != c[0]]
    assert len(firsts) == INTERVALS and all(c[2] >= 1 for c in firsts)
    # no device times off the card
    assert all(c[3:] == (None, None, None) for c in chunks)
    assert RECORDER.device_span_ms() is None


@pytest.mark.parametrize("route", ["block", "cell"])
def test_each_interval_counts_the_sweep_it_ran(monkeypatch, route):
    """``driver.sweep.<kernel>`` once an interval, for the kernel the
    capacity rule chose (the cell route forced by a cap below the deck's
    rows); nothing while tracing is off."""
    from sphexample_tpu_torch.core import driver

    if route == "cell":
        monkeypatch.setattr(driver, "BLOCK_CAP_LIMIT", 8)
    sim = _sim()
    assert sim.cfg.sweep_kernel == route
    _run(sim, trace=False)
    assert dict(RECORDER.counters) == {}
    _run(_sim(), trace=True)
    sweeps = {k: v for k, v in RECORDER.counters.items() if k.startswith(timers.SWEEP_COUNTER)}
    assert sweeps == {timers.SWEEP_COUNTER + route: INTERVALS}


def test_trajectory_is_the_same_with_tracing_on_and_off():
    logs_off, _, off = _run(_sim(), trace=False)
    logs_on, _, on = _run(_sim(), trace=True)
    assert _digest(off) == _digest(on)
    strip = [{k: v for k, v in r.items() if k != "wall_time"} for r in logs_off]
    assert strip == [{k: v for k, v in r.items() if k != "wall_time"} for r in logs_on]


def test_start_clears_and_host_read_counts_only_while_on():
    x = torch.tensor(2.5)
    assert timers.host_read(x) == 2.5 and timers.host_read(x, int) == 2
    assert dict(RECORDER.counters) == {}
    rec = timers.start_trace()
    assert rec is RECORDER and rec.on
    timers.host_read(x)
    with rec.span("a"):
        timers.host_read(x, torch.Tensor.tolist)
    assert rec.counters[HOST_READS] == 2 and [s[0] for s in rec.spans] == ["a"]
    timers.stop_trace()
    timers.host_read(x)
    assert rec.counters[HOST_READS] == 2
    timers.start_trace()
    assert rec.spans == [] and dict(rec.counters) == {} and rec.chunks == []


class _FakeEvent:
    """A CUDA event stand-in on a clock the test sets (``NOW``, ms)."""

    NOW = [0.0]
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = self.NOW[0]

    def elapsed_time(self, other):
        return other.t - self.t


def test_chunk_events_give_replay_copy_gap_and_span(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    rec = timers.start_trace()

    def chunk(at, steps=4, rebuilds=1, marks=(0.0, 1.0, 5.0, 6.5)):
        for i, dt in enumerate(marks):
            _FakeEvent.NOW[0] = at + dt
            rec.chunk_mark(i, "cuda:0")
        rec.chunk_done(steps, rebuilds)

    rec.interval = 2
    chunk(0.0)
    chunk(10.0)
    rec.chunk_done(3, 0)                 # a chunk that replayed no graph
    rec.interval = 3
    for k in range(6):                   # the pool's events are used in turns
        chunk(30.0 + 10 * k, steps=2, rebuilds=0)
    for i in range(4):                   # a chunk marked and never closed
        rec.chunk_mark(i, "cuda:0")
    chunk(100.0)
    replay, copy = 4.0, 2.5
    assert rec.chunks[0] == (2, 4, 1, replay, copy, None)
    assert rec.chunks[1] == (2, 4, 1, replay, copy, 10.0 - 6.5)
    assert rec.chunks[2] == (2, 3, 0, None, None, None)
    assert rec.chunks[3] == (3, 2, 0, replay, copy, None)
    assert all(c == (3, 2, 0, replay, copy, 10.0 - 6.5) for c in rec.chunks[4:9])
    assert rec.chunks[9] == (3, 4, 1, replay, copy, None)
    # from the first chunk's first event to the last chunk's last
    assert rec.device_span_ms() == 100.0 + 6.5
    assert _FakeEvent.made == 8 + 1          # the pool and the first chunk's start
    timers.start_trace()
    assert rec.device_span_ms() is None and rec.chunks == []
