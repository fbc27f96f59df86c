"""The arithmetic of the end-to-end metrics, on plain numbers: a rate is all
the work over all the wall time of the window; a latency tail is over
every item opened in the window, an item not delivered by the window's end
counting with the time it has waited so far."""

from __future__ import annotations

import numpy as np

__all__ = ["rate", "waits", "percentile"]


def rate(work: float, seconds: float) -> float:
    """Work per second over the window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def waits(opened: dict, delivered: dict, t0: float, t_end: float) -> list:
    """The wait of every item opened in [t0, t_end): delivery time minus
    open time, or t_end minus open time for an item not delivered by
    t_end.  ``opened`` and ``delivered`` map an item to a time."""
    out = []
    for item, t_open in opened.items():
        if not t0 <= t_open < t_end:
            continue
        t_done = delivered.get(item)
        out.append((t_done if t_done is not None and t_done <= t_end
                     else t_end) - t_open)
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    if not len(values):
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))
