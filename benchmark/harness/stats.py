"""Statistics of a window: one definition each, over every sample."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear between ranks); NaN for
    none."""
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, q)) if v.size else float("nan")


def rate(units: float, start: float, end: float) -> float:
    """Units completed over the time from the window's start to the end of
    the last unit completed in it."""
    return units / (end - start) if end > start else float("nan")


def idle_share(busy_s: float, window_s: float) -> float:
    """The share of the window, in %, with no device operation running."""
    return 100.0 * (1.0 - busy_s / window_s) if window_s > 0 else float("nan")
