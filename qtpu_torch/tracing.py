"""Spans inside the program, on the profiler's clock.

One recorder a process.  ``span(name, window=None)`` is a context manager
around a piece of the program's host work.  It records only while a
``torch.profiler`` session is active or inside ``recording()``; otherwise
it returns one shared no-op object, so the cost of an unrecorded span is
one flag read.

A recorded span holds its name, its window id (a span given none takes
its parent's, so the spans of one window share it; a drain covering many
windows holds their tuple), the id of the span that encloses it on its
thread (its parent), the thread, and its start and end in Unix
nanoseconds (``time.time_ns``), the host clock of the profiler's own
events.  While the profiler runs, each top-level span (one with no
parent on its thread) also opens a ``record_function`` range named
``qtpu_torch:<name>``, so an exported Chrome trace shows the program's
spans on one timeline with the kernels (an event's ``ts`` is in
microseconds after the trace's ``baseTimeNanoseconds``).  A range costs
the profiler tens of microseconds, so the spans nested inside one open
none: their time is the recorder's own stamps.  The span is stamped
outside its range, its start before the range opens and its end after it
closes, so it holds the range and lies inside any range a caller opened
around it.

``recorded()`` returns the spans that have ended and the number of spans
dropped because the buffer held ``CAPACITY`` already; ``clear()`` empties
both.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

__all__ = ["PREFIX", "CAPACITY", "Span", "Recorded", "span", "recorded",
           "clear", "recording", "table"]

PREFIX = "qtpu_torch:"
# Spans the buffer holds before it drops (and counts) the rest.
CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span; ``parent`` is the ``id`` of the span that
    enclosed it on its thread, None at the top."""
    id: int
    name: str
    window: object
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


class Recorded(NamedTuple):
    spans: list
    dropped: int


class _Recorder:
    """The process's buffer of ended spans."""

    def __init__(self):
        self.manual = 0          # open recording() blocks
        self.spans: list = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def add(self, sp: Span) -> None:
        with self.lock:
            if len(self.spans) < CAPACITY:
                self.spans.append(sp)
            else:
                self.dropped += 1


_REC = _Recorder()


class _Off:
    """The shared span of a program that is not recording.  Its
    ``__enter__`` and ``__exit__`` are a builtin that takes any arguments
    and returns "" (false, so an exception goes on): a call to C, which
    costs ~40% less than two Python methods."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "window", "id", "parent", "start", "fn")

    def __init__(self, name: str, window):
        self.name, self.window = name, window

    def __enter__(self):
        stack = _REC.stack()
        up = stack[-1] if stack else None
        if up is not None:
            self.parent = up.id
            if self.window is None:
                self.window = up.window
        else:
            self.parent = None
        self.id = next(_REC.ids)
        stack.append(self)
        self.fn = None
        self.start = time.time_ns()
        if up is None and _profiler._is_profiler_enabled:
            self.fn = _profiler.record_function(PREFIX + self.name)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        end = time.time_ns()
        _REC.stack().pop()
        _REC.add(Span(self.id, self.name, self.window, self.parent,
                      threading.get_ident(), self.start, end))
        return False


def span(name: str, window=None):
    """A context manager that records the block as span ``name`` of
    ``window`` while recording, and the shared no-op otherwise."""
    if not (_REC.manual or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, window)


@contextlib.contextmanager
def recording():
    """Record inside the block whether or not a profiler runs."""
    with _REC.lock:
        _REC.manual += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.manual -= 1


def recorded() -> Recorded:
    """The ended spans (in the order they ended) and the spans dropped,
    since the last ``clear()``."""
    with _REC.lock:
        return Recorded(list(_REC.spans), _REC.dropped)


def clear() -> None:
    with _REC.lock:
        _REC.spans = []
        _REC.dropped = 0


def table(spans) -> dict:
    """{name: {total_ms, calls, ms_per_call}} of ``spans``, each span's
    whole duration under its name, most time first."""
    ns, calls = collections.Counter(), collections.Counter()
    for sp in spans:
        ns[sp.name] += sp.end_ns - sp.start_ns
        calls[sp.name] += 1
    return {name: {"total_ms": round(t / 1e6, 1), "calls": calls[name],
                   "ms_per_call": round(t / 1e6 / calls[name], 3)}
            for name, t in ns.most_common()}
