"""The window arithmetic of the end-to-end metrics, on the host's clock.

A rate is the work of every operation completed in the window over the
whole window, from its start to the end of its last operation: the time
between operations counts, and a failed operation adds time and no work.
A tail is a percentile of the latency of every operation of the window,
a failed one counted as missing every limit (an infinite latency).
"""

from __future__ import annotations

import math


def rate(ops, window) -> float | None:
    span = window[1] - window[0]
    if not ops or span <= 0:
        return None
    return sum(o.work for o in ops if o.ok) / span


def percentile_ms(ops, q: float) -> float | None:
    """The nearest-rank ``q`` percentile of the operations' latencies, in
    ms; None when it falls on a failed operation."""
    if not ops:
        return None
    lat = sorted((o.t1 - o.t0) * 1e3 if o.ok else math.inf for o in ops)
    v = lat[max(0, math.ceil(q / 100.0 * len(lat)) - 1)]
    return None if math.isinf(v) else v
