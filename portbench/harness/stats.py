"""The arithmetic of the end-to-end metrics, over all the work and all
the time of the window."""

from __future__ import annotations

import numpy as np


def rate(work: list[float], window_s: float) -> float:
    """All the work completed in the window over the window's seconds."""
    return float(sum(work)) / window_s


def p95(values: list[float]) -> float:
    """The 95th percentile of every value (numpy's linear rule), not a
    statistic of chunks."""
    return float(np.percentile(np.asarray(values, np.float64), 95))

