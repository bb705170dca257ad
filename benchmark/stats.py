"""The window's arithmetic: the rate over all solves and all the time, the
95th percentile of all walls with failed solves beyond every limit, and the
spread of a metric over runs."""

from __future__ import annotations

import math
import statistics
from typing import List, Sequence


def rate(work_per_solve: float, completed: int, window_s: float) -> float:
    """Work completed per second over the whole window."""
    return work_per_solve * completed / window_s


def percentile(walls: Sequence[float], failed: Sequence[bool], q: float) -> float:
    """The ``q``-th percentile (nearest rank) of all walls, a failed solve
    counting as infinitely long."""
    vals = sorted(math.inf if bad else w for w, bad in zip(walls, failed))
    if not vals:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def spread(values: List[float]) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles``, n=4), as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
