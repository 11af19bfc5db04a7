"""The percentile, spread and share arithmetic, and the trace's reduction,
on synthetic numbers and spans."""

import statistics
from types import SimpleNamespace

import pytest

from portbench import stats, trace


def test_percentile_is_a_sample():
    v = [float(i) for i in range(1, 201)]
    assert stats.percentile(v, 95) == 190.0
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5.0, 1.0, 3.0], 50) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_matches_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 7), (9, 12)]
    assert stats.union_length(spans, 0, 10) == pytest.approx(3 + 2 + 1)
    assert stats.gaps(spans, 0, 10) == [(3, 5), (7, 9)]
    assert stats.gaps(spans, -1, 13) == [(-1, 0), (3, 5), (7, 9), (12, 13)]
    assert stats.union_length([], 0, 10) == 0.0
    assert stats.gaps([], 0, 10) == [(0, 10)]


def _event(name, a, b, device="CPU", annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=f"DeviceType.{device}", is_user_annotation=annotation)


def test_trace_reduce():
    events = [
        _event("marker", 90.0, 100.0, "CUDA"),
        _event("cudaStreamSynchronize", 300.0, 700.0),
        _event("cudaGraphLaunch", 140.0, 150.0),
        _event("block_sweep_kernel<3>", 100.0, 300.0, "CUDA"),
        _event("block_sweep_kernel<3>", 700.0, 900.0, "CUDA"),
        _event("copy", 250.0, 350.0, "CUDA"),
        _event("annotation", 100.0, 1100.0, "CUDA", annotation=True),
        _event("marker", 1100.0, 1105.0, "CUDA"),
    ]
    red = trace.reduce(events)
    # the sub-window runs from the first marker's end to the last one's start
    assert red["window_s"] == pytest.approx(1000e-6)
    assert red["busy_s"] == pytest.approx(450e-6)
    assert red["device_events"] == 3
    assert red["kernel_launches"] == 2 and red["kernel_s"] == pytest.approx(400e-6)
    assert red["device_ops"][0] == ["block_sweep_kernel<3>", pytest.approx(400e-6)]
    # the longest gap (350-700) lies in the host's sync; the next (900-1100) under no record
    assert red["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(350e-6)]
    assert red["idle_gaps"][1] == ["host, no record", pytest.approx(200e-6)]
    # no markers, no sub-window
    assert trace.reduce(events[1:3]) is None
