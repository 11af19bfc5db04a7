"""``program_trace.py``'s reductions of the port's records on made-up
records: self time, the window's readings and the account, and the gaps
named by the innermost program span."""

from types import SimpleNamespace

import pytest

from portbench.program_trace import named_gaps, span_table, window_readings
from sphexample_tpu_torch.utils.timers import HOST_READS, Recorder


class _Event:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_span_table_self_time():
    s = 10**9
    spans = [["driver.interval", 0, 10 * s, None, 2],
             ["chunk", 1 * s, 7 * s, 0, 2],
             ["chunk.host_read", 5 * s, 6 * s, 1, 2],
             ["driver.log", 8 * s, 9 * s, 0, 2],
             ["chunk", 12 * s, 13 * s, None, None],
             ["open", 14 * s, None, None, None]]
    table = span_table(spans)
    assert table["driver.interval"] == [1, 10.0, 3.0]
    assert table["chunk"] == [2, 7.0, 6.0]
    assert table["chunk.host_read"] == [1, 1.0, 1.0] and "open" not in table


def test_window_readings_and_account():
    rec = Recorder()
    # (interval, steps, rebuilds, replay, copy, gap): two intervals of two
    # chunks, the first chunk timed without a gap before it
    rec.chunks = [(2, 64, 1, 80.0, 0.5, None), (2, 49, 0, 61.0, 0.5, 0.1),
                  (3, 64, 2, 79.0, 0.5, 1.2), (3, 50, 0, 62.0, 0.5, 0.1)]
    rec.counters[HOST_READS] = 2 * 7 + 4
    rec._first, rec._last = _Event(0.0), _Event(285.4)
    r = window_readings(rec, intervals=2, window_s=0.29)
    assert r["step.graph_ms_per_step"] == pytest.approx(282.0 / 227)
    assert r["driver.host_gap_share"] == pytest.approx(100 * 1.4 / 285.4)
    assert r["driver.host_reads_per_interval"] == 9.0
    assert r["gaps_in_interval"] == [2, pytest.approx(0.2)]
    assert r["gaps_between_intervals"] == [1, 1.2]
    assert r["account"] == pytest.approx((282.0 + 2.0 + 1.4) / 285.4)
    assert r["span_over_window"] == pytest.approx(0.2854 / 0.29)
    assert r["rebuilds"] == 3 and r["copy_ms"] == 2.0


def _ev(name, a, b, device):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def test_gaps_named_by_the_innermost_span():
    events = [_ev("marker", 0, 1, True), _ev("k1", 1, 100, True), _ev("k2", 150, 300, True),
              _ev("k3", 302, 400, True), _ev("marker", 1000, 1001, True),
              _ev("cudaMemcpyAsync", 95, 140, False), _ev("cudaGraphLaunch", 420, 990, False)]
    spans = [(90.0, 160.0, "driver.interval"), (92.0, 145.0, "driver.log"),
             (410.0, 995.0, "chunk.launch")]
    out = named_gaps(events, spans, top=2)
    assert out["idle_gaps"] == [["chunk.launch | cudaGraphLaunch", 600 / 1e6],
                                ["driver.log | cudaMemcpyAsync", 50 / 1e6]]
    # the 2-us gap is left out of the idle time by span
    assert out["idle_s_by_span"] == {"chunk.launch": 600 / 1e6, "driver.log": 50 / 1e6}
