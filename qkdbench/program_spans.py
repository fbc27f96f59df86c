"""The program's own spans, read for the per-layer metrics on the device
trace's clock.

The measured package records spans inside itself (``qtpu_torch.tracing``:
each span's name, window, parent span, thread, and start and end in Unix
ns) while ``torch.profiler`` runs, which in a ``--trace 1`` run is the
traced part of the window.  ``read(record)`` takes what the recorder
holds and maps it onto the clock of ``record["trace"]``, whose ``ts`` are
µs after the exported trace's ``baseTimeNanoseconds``: the wall clock
floored to 7,889,238-s intervals (libkineto's ChromeTraceBaseTime, which
torch's exporter copies).  The trace record does not keep that base, so
the candidates are the floor at the first recorded span and the interval
before it (a profiler started before the wall clock crossed a multiple);
the one under which the program's spans nest in the benchmark's own is
taken:

- every program ``bob.on_message`` inside a benchmark ``bob.on_message``,
- every program ``drain`` inside a benchmark ``key_pull``,
- every program ``decode`` inside a benchmark ``decode``,

each to within ``SLACK_US``, where the trace holds benchmark spans of that
name, and at least one span so checked.  A run where no candidate passes
raises (a moved metric source fails loudly, as elsewhere in this
benchmark).  ``read`` returns None where the program has no recorder, the
run was not traced, or the recorder holds no span.

Per window means per program ``bob.finalize`` span in the traced window.
"""

from __future__ import annotations

import bisect
import collections
import importlib
from typing import NamedTuple, Optional

__all__ = ["Span", "Spans", "read", "map_spans", "busy_intervals",
           "SLACK_US", "BASE_INTERVAL_NS", "NESTS"]

SLACK_US = 20.0
BASE_INTERVAL_NS = 7_889_238 * 1_000_000_000
# (program span, the benchmark span it runs inside)
NESTS = (("bob.on_message", "bob.on_message"), ("drain", "key_pull"),
         ("decode", "decode"))
HANDLER_EXCLUDED = ("program.", "pa.host_total", "drain")


class Span(NamedTuple):
    """A program span on the trace's clock (µs)."""
    id: int
    name: str
    window: object
    parent: Optional[int]
    thread: int
    start: float
    end: float


def _recorded():
    """What the program's recorder holds, or None where the program has
    none."""
    try:
        tracing = importlib.import_module("qtpu_torch.tracing")
    except ModuleNotFoundError as exc:
        if exc.name in ("qtpu_torch", "qtpu_torch.tracing"):
            return None
        raise
    return tracing.recorded()


def busy_intervals(trace) -> list:
    """The union of the trace's kernel and copy intervals inside its
    window, as sorted disjoint [start, end] pairs."""
    out = []
    for _, s, e, *_ in sorted(list(trace.kernels) + list(trace.copies),
                              key=lambda k: k[1]):
        s, e = max(s, trace.t0), min(e, trace.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Spans:
    """The program's spans that overlap the traced window [t0, t1], on the
    trace's clock, with the arithmetic the readers share."""

    def __init__(self, spans: list, t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.spans = [sp for sp in spans if sp.end > t0 and sp.start < t1]
        self.children = collections.defaultdict(list)
        for sp in self.spans:
            if sp.parent is not None:
                self.children[sp.parent].append(sp)
        threads = collections.Counter(sp.thread for sp in self.spans)
        # The loop's thread: the one that ran the most spans.
        self.main = threads.most_common(1)[0][0] if threads else None

    def clipped(self, sp: Span) -> float:
        """µs of ``sp`` inside the window."""
        return max(0.0, min(sp.end, self.t1) - max(sp.start, self.t0))

    def named(self, name: str, thread="any") -> list:
        """Spans called ``name``: on any thread, on the loop's thread
        (``"main"``), or on any other (``"other"``)."""
        out = [sp for sp in self.spans if sp.name == name]
        if thread == "main":
            out = [sp for sp in out if sp.thread == self.main]
        elif thread == "other":
            out = [sp for sp in out if sp.thread != self.main]
        return out

    def windows(self) -> int:
        """Windows Bob finalized in the window (``bob.finalize`` spans)."""
        return len(self.named("bob.finalize"))

    def outermost(self, sp: Span, pred) -> list:
        """The descendants of ``sp`` that ``pred`` accepts and no accepted
        ancestor below ``sp`` holds."""
        out, todo = [], list(self.children[sp.id])
        while todo:
            c = todo.pop()
            if pred(c):
                out.append(c)
            else:
                todo += self.children[c.id]
        return out

    def self_us(self, sp: Span, pred=None) -> float:
        """µs of ``sp`` in the window outside its descendants that ``pred``
        accepts (outside its children where ``pred`` is None)."""
        kids = (self.children[sp.id] if pred is None
                else self.outermost(sp, pred))
        return self.clipped(sp) - sum(self.clipped(c) for c in kids)

    def idle_us(self, spans: list, busy: list) -> float:
        """µs of the window inside ``spans`` (disjoint) in which no
        interval of ``busy`` ran."""
        total = 0.0
        for sp in spans:
            lo, hi = max(sp.start, self.t0), min(sp.end, self.t1)
            if hi <= lo:
                continue
            covered = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy)
            total += (hi - lo) - covered
        return total


def _nest_check(spans: list, bench: list, t0: float, t1: float):
    """(spans checked, spans outside every benchmark span they belong in)
    of the program spans overlapping [t0, t1]."""
    checked, bad = 0, []
    for mine, theirs in NESTS:
        # The benchmark's spans of one name follow each other on its
        # thread: the one that can hold a span is the last to start by it.
        ranges = sorted((s, e) for n, s, e in bench if n == theirs)
        starts = [s for s, _ in ranges]
        if not ranges:
            continue
        for sp in spans:
            if sp.name != mine or sp.end <= t0 or sp.start >= t1:
                continue
            checked += 1
            i = bisect.bisect_right(starts, sp.start + SLACK_US) - 1
            if i < 0 or sp.end > ranges[i][1] + SLACK_US:
                bad.append(sp)
    return checked, bad


def map_spans(raw: list, trace) -> Spans:
    """``raw`` (the recorder's spans, Unix ns) on ``trace``'s clock, under
    the base the nesting check confirms; raises where none does."""
    first = min(sp.start_ns for sp in raw)
    floor = first // BASE_INTERVAL_NS * BASE_INTERVAL_NS
    tried = []
    for base in (floor, floor - BASE_INTERVAL_NS):
        spans = [Span(sp.id, sp.name, sp.window, sp.parent, sp.thread,
                      (sp.start_ns - base) / 1e3, (sp.end_ns - base) / 1e3)
                 for sp in raw]
        checked, bad = _nest_check(spans, trace.spans, trace.t0, trace.t1)
        if checked and not bad:
            return Spans(spans, trace.t0, trace.t1)
        tried.append((base, checked, bad[:3]))
    raise RuntimeError(
        "qkdbench: the program's spans do not nest in the benchmark's on "
        "any base of the trace's clock (base ns, spans checked, first "
        f"outside): {tried}: the program's spans or the trace's clock "
        "moved")


def read(record) -> Optional[Spans]:
    """The program's spans of the traced window of ``record``, or None
    where there are none to read."""
    trace = record.get("trace")
    if trace is None:
        return None
    rec = _recorded()
    if rec is None or not rec.spans:
        return None
    return map_spans(rec.spans, trace)


def per_window_ms(spans: Optional[Spans], us: float) -> Optional[float]:
    """``us`` in ms per window finalized, or None without windows."""
    if spans is None or not spans.windows():
        return None
    return us / 1e3 / spans.windows()
