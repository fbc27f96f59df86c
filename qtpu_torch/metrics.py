"""Structured metrics, logging, and profiling hooks.

Counterpart of ``qtpu/metrics.py``: structured JSONL metrics (sifted bits,
QBER, rate chosen, BP iterations, FER, leaked bits, final bits/s), a
running bits/s meter, and a ``torch.profiler`` trace around a region for
kernel-level inspection (host ops and, on a card, its kernels).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricsLogger", "RateMeter", "profile_trace"]


class MetricsLogger:
    """JSONL metrics sink; one record per event, flushed immediately."""

    def __init__(self, stream: Optional[IO[str]] = None, path: Optional[str] = None):
        if path is not None:
            self._fh = open(path, "a", buffering=1)
            self._own = True
        else:
            self._fh = stream or sys.stderr
            self._own = False
        self._t0 = time.time()

    def log(self, kind: str, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 6), "kind": kind, **fields}
        self._fh.write(json.dumps(rec) + "\n")

    def window(self, metrics) -> None:
        """Log a qtpu_torch.pipeline.WindowMetrics record."""
        self.log("window", **metrics.as_dict())

    def close(self) -> None:
        if self._own:
            self._fh.close()


class RateMeter:
    """Running bits/s meter (the reference `getrate` role)."""

    def __init__(self, horizon_s: float = 10.0):
        self._events: list[tuple[float, int]] = []
        self._horizon = horizon_s
        self.total_bits = 0

    def add(self, bits: int) -> None:
        now = time.time()
        self.total_bits += bits
        self._events.append((now, bits))
        cutoff = now - self._horizon
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def rate_bps(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        if span <= 0:
            return 0.0
        return sum(b for _, b in self._events) / span


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace around a region, written to ``log_dir`` as a
    Chrome trace (``trace.json``); no-op when log_dir is None.  CUDA
    activity is recorded when a card is present."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
