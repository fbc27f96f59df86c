"""Spans around the benchmark's calls into each layer, and the device trace
of a traced run.

``Tracer.span(name)`` marks a host range (a ``record_function`` named
``qkdbench:<name>``) while the profiler runs, and is free otherwise.
``start`` / ``stop`` bracket the traced part of a window with
``torch.profiler`` (CPU and CUDA activity), synchronizing the card at both
ends so that every kernel launched inside it is in the trace and none
launched before it.  ``record()`` exports the trace as Chrome trace JSON
under ``TMPDIR``, reads it and deletes the file: kernels, copies and
memsets on the card's timeline, and the benchmark's host spans.  The
arithmetic (busy time as the union of device intervals, the top device
operations, idle time by the host span it fell in) follows
``qtpu_torch/profiling.py``'s ``_Trace``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

__all__ = ["Tracer", "TraceRecord", "PREFIX"]

PREFIX = "qkdbench:"
WINDOW = PREFIX + "traced_window"
TOP = 10
_UNTRACED = contextlib.nullcontext()


class TraceRecord:
    """What the card ran in the traced window, times in µs on the trace's
    clock: ``kernels`` [(name, start, end, launch time or None)],
    ``copies`` [(name, start, end)] (memcpy and memset), ``spans`` [(name,
    start, end)] of the benchmark's host spans, and the traced window
    (``t0``, ``t1``)."""

    def __init__(self, kernels, copies, spans, t0, t1):
        self.kernels = kernels
        self.copies = copies
        self.spans = spans
        self.t0, self.t1 = t0, t1

    @classmethod
    def from_chrome(cls, events: list) -> "TraceRecord":
        launches, kernels, copies, spans = {}, [], [], []
        t0 = t1 = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            start = float(e["ts"])
            end = start + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = start
            elif cat == "kernel":
                kernels.append((name, start, end, corr))
            elif cat in ("gpu_memcpy", "gpu_memset"):
                copies.append((name, start, end))
            elif cat == "user_annotation" and name.startswith(PREFIX):
                if name == WINDOW:
                    t0, t1 = start, end
                else:
                    spans.append((name[len(PREFIX):], start, end))
        if t0 is None:
            raise RuntimeError("the trace holds no traced window")
        kernels = [(n, s, e, launches.get(c)) for n, s, e, c in kernels]
        return cls(kernels, copies, sorted(spans, key=lambda s: s[1]),
                   t0, t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _intervals(self) -> list:
        """Device intervals (kernels and copies) clipped to the window."""
        out = []
        for _, s, e, *_ in self.kernels + self.copies:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                out.append((s, e))
        return sorted(out)

    def _busy(self) -> list:
        """The union of the device intervals, as disjoint intervals."""
        merged = []
        for s, e in self._intervals():
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e6

    def launches(self) -> int:
        """Kernels, copies and memsets that started in the window."""
        return sum(1 for _, s, *_ in self.kernels + self.copies
                   if self.t0 <= s <= self.t1)

    def kernel_s(self, pred) -> float:
        """Summed device seconds of the kernels whose name ``pred``
        accepts."""
        return sum(e - s for n, s, e, _ in self.kernels if pred(n)) / 1e6

    def kernel_count(self, pred) -> int:
        return sum(1 for n, *_ in self.kernels if pred(n))

    def host_segments(self) -> list:
        """The window cut into (start, end, span) pieces, each piece named
        by the innermost benchmark span the host was in (the latest
        started of those open), or None outside every span."""
        bounds = sorted({self.t0, self.t1} | {t for _, s, e in self.spans
                                              for t in (s, e)
                                              if self.t0 < t < self.t1})
        out, i, open_ = [], 0, []
        for lo, hi in zip(bounds, bounds[1:]):
            while i < len(self.spans) and self.spans[i][1] <= lo:
                open_.append(self.spans[i])
                i += 1
            open_ = [sp for sp in open_ if sp[2] > lo]
            out.append((lo, hi, open_[-1][0] if open_ else None))
        return out

    def launched_in(self, span: str) -> list:
        """The kernels whose launch lies inside a span named ``span``."""
        ranges = [(s, e) for n, s, e in self.spans if n == span]
        starts = [r[0] for r in ranges]
        out = []
        for k in self.kernels:
            t = k[3]
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
                out.append(k)
        return out

    def breakdown(self) -> dict:
        """The device operations with the most summed seconds, and the
        device's idle seconds summed by the host span the host was in
        meanwhile."""
        ops = collections.Counter()
        for n, s, e, *_ in self.kernels + self.copies:
            ops[n[:200]] += (e - s) / 1e6
        gaps, last = [], self.t0
        for s, e in self._busy() + [[self.t1, self.t1]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        idle = collections.Counter()
        segs, j = self.host_segments(), 0
        for g0, g1 in gaps:
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < g1:
                lo, hi, name = segs[k]
                idle[name or "outside_spans"] += (min(hi, g1)
                                                  - max(lo, g0)) / 1e6
                k += 1
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(TOP)]}


class Tracer:
    """Spans and the traced window of one run (``active`` in a ``--trace
    1`` run)."""

    def __init__(self, active: bool, device=None):
        self.active = active
        self.device = device
        self.on = False
        self._prof = None
        self._window = None
        self._record = None

    def span(self, name: str):
        if not self.on:
            return _UNTRACED
        from torch.profiler import record_function
        return record_function(PREFIX + name)

    def _sync(self) -> None:
        import torch
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop a profiler once (in set-up), so that the traced
        window does not pay the profiler's first start."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            self._sync()

    def elapsed(self) -> float:
        """Seconds since the traced window started."""
        return time.perf_counter() - self.started

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.on = True
        self.started = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self._window.__exit__(None, None, None)
        self.on = False
        self._prof.__exit__(None, None, None)

    def record(self) -> TraceRecord:
        """The traced window read back (once, after ``stop``)."""
        if self._record is None:
            fd, path = tempfile.mkstemp(prefix="qkdbench-trace-",
                                        suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh)["traceEvents"]
            finally:
                os.unlink(path)
            self._prof = None
            self._record = TraceRecord.from_chrome(events)
        return self._record
