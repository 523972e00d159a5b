"""Arithmetic of the end-to-end and device metrics: percentiles, rates,
intervals, the union of device spans and the idle share."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def intervals(boundaries) -> np.ndarray:
    """Each frame's time, from its start to the next frame's start."""
    b = np.asarray(boundaries, np.float64)
    return b[1:] - b[:-1]


def rate(count: int, seconds: float) -> float:
    return count / seconds


def union(spans, lo: float, hi: float) -> float:
    """Length of the union of (start, end) spans clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] that no span covers."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_share(spans, lo: float, hi: float) -> float:
    """Percent of [lo, hi] in which no span runs."""
    return 100.0 * (1.0 - union(spans, lo, hi) / (hi - lo))


def spread(values) -> float:
    """Interquartile distance as a share of the median
    (``statistics.quantiles(values, n=4)``)."""
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
