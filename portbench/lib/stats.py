"""Order statistics of a run's samples."""
from __future__ import annotations

import statistics


def percentile(values, p: int) -> float:
    """The ``p``-th percentile (1-99) of ``values``, as Python's
    ``statistics.quantiles(values, n=100, method='inclusive')`` cuts them;
    the one value of a single-value list."""
    vals = list(values)
    if not vals:
        raise ValueError('percentile of no values')
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method='inclusive')[p - 1])

