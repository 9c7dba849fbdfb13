"""Order statistics of the benchmark's samples.

``percentile`` is a copy of ``repro_torch.serve.stats.percentile`` (the
nearest-rank percentile), kept here so that a change to the program cannot
change how the benchmark reads its samples.  ``spread`` is the measure the
bounds are set from: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.
"""
from __future__ import annotations

import math
import statistics


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of an iterable of floats."""
    xs = sorted(samples)
    if not xs:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def spread(values) -> float:
    """(Q3 - Q1) / median of ``values``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
