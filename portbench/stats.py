"""Percentiles, spreads and unions of spans: the arithmetic of the benchmark's numbers."""

from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """The nearest-rank ``p``-th percentile: a value that was observed."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle gaps ``(start, end)`` between the union of ``intervals``
    inside [lo, hi], in time order."""
    out, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach and a < hi:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return out
