"""``program_spans``' arithmetic on hand-made records: the program's spans
(Unix ns) mapped onto a trace's clock (µs after the floored base), the
nesting check that confirms the mapping and raises on a shifted span,
self time under nested children, the loop's thread against the others,
the card's idle time under the drain, and each reader built on them."""

from __future__ import annotations

import pytest

from qkdbench import program_spans as ps
from qkdbench import registry
from qkdbench.trace import TraceRecord
from qtpu_torch.tracing import Recorded, Span

BASE = 227 * ps.BASE_INTERVAL_NS          # a floored wall clock, in ns
MAIN, WORKER = 11, 22


def _ns(us: float) -> int:
    """A trace time (µs) as the Unix ns the program stamps."""
    return BASE + round(us * 1e3)


def _span(i, name, start, end, parent=None, thread=MAIN, window=None):
    return Span(i, name, window, parent, thread, _ns(start), _ns(end))


def _record(spans, bench, kernels=(), t0=0.0, t1=1000.0):
    return {"trace": TraceRecord(list(kernels), [], sorted(
        bench, key=lambda s: s[1]), t0, t1), "_spans": spans}


@pytest.fixture
def recorder(monkeypatch):
    """Hand the readers ``record["_spans"]`` as the recorder's spans."""
    held = {}
    monkeypatch.setattr(ps, "_recorded", lambda: held.get("rec"))

    def give(record):
        held["rec"] = Recorded(record["_spans"], 0)
        return record
    return give


# A window of the session: Bob's message (a program call and the decoder
# under it), his flush (the window's finalize, its PA under that), a pull
# (the drain on the loop's thread) and the drain worker on its own.
SESSION = [
    _span(3, "program.bob", 120, 170, parent=2, window=5),
    _span(4, "decode", 130, 160, parent=3, window=5),
    _span(2, "bob.on_syndromes", 110, 180, parent=1, window=5),
    _span(1, "bob.on_message", 100, 200, window=5),
    _span(7, "program.pa", 320, 340, parent=6, window=5),
    _span(6, "pa.host_total", 310, 350, parent=8, window=5),
    _span(8, "bob.finalize", 305, 355, parent=5, window=5),
    _span(5, "bob.flush", 300, 400),
    _span(10, "drain.join", 510, 580, parent=9),
    _span(11, "drain.sort", 580, 590, parent=9),
    _span(9, "drain", 500, 600),
    _span(12, "drain.materialize", 450, 560, thread=WORKER,
          window=(4, 5)),
]
BENCH = [("bob.on_message", 95.0, 205.0), ("bob.flush", 298.0, 402.0),
         ("key_pull", 490.0, 620.0)]
# The card runs 520-540 (inside the drain) and 130-160.
KERNELS = [("k", 520.0, 540.0, None), ("k", 130.0, 160.0, None)]


def test_mapping_puts_spans_on_the_traces_clock(recorder):
    spans = ps.read(recorder(_record(SESSION, BENCH)))
    got = {sp.name: (sp.start, sp.end) for sp in spans.spans}
    assert got["bob.on_message"] == pytest.approx((100.0, 200.0))
    assert got["drain"] == pytest.approx((500.0, 600.0))
    assert spans.main == MAIN


def test_a_trace_begun_before_the_floor_maps_at_the_interval_before():
    """A profiler started just before the wall clock crossed a multiple
    of the interval: its trace counts from the floor before the spans'."""
    interval_us = ps.BASE_INTERVAL_NS / 1e3
    start = BASE + ps.BASE_INTERVAL_NS + 10_000_000
    raw = [Span(1, "decode", None, None, MAIN, start, start + 40_000)]
    at = interval_us + 10_000.0
    trace = TraceRecord([], [], [("decode", at - 10.0, at + 50.0)],
                        interval_us - 1000.0, interval_us + 20_000.0)
    spans = ps.map_spans(raw, trace)
    assert (spans.spans[0].start, spans.spans[0].end) == (at, at + 40.0)


def test_a_shifted_span_raises(recorder):
    shifted = list(SESSION)
    shifted[3] = _span(1, "bob.on_message", 100, 230, window=5)
    with pytest.raises(RuntimeError, match="do not nest"):
        ps.read(recorder(_record(shifted, BENCH)))
    # Within the slack it passes.
    shifted[3] = _span(1, "bob.on_message", 100, 205 + ps.SLACK_US - 1,
                       window=5)
    assert ps.read(recorder(_record(shifted, BENCH))) is not None


def test_a_drain_outside_every_pull_raises(recorder):
    moved = [("bob.on_message", 95.0, 205.0), ("key_pull", 700.0, 800.0)]
    with pytest.raises(RuntimeError, match="do not nest"):
        ps.read(recorder(_record(SESSION, moved)))


def test_nothing_checked_raises(recorder):
    with pytest.raises(RuntimeError, match="do not nest"):
        ps.read(recorder(_record(SESSION, [("feed", 0.0, 10.0)])))


def test_self_time_with_nested_children(recorder):
    spans = ps.read(recorder(_record(SESSION, BENCH)))
    by = {sp.name: sp for sp in spans.spans}
    assert spans.self_us(by["bob.on_message"]) == pytest.approx(30.0)
    assert spans.self_us(by["bob.on_syndromes"]) == pytest.approx(20.0)
    # Below the handler, only the outermost excluded spans count: the
    # decoder inside program.bob is not taken twice.
    def excluded(sp):
        return sp.name.startswith(ps.HANDLER_EXCLUDED)
    assert spans.self_us(by["bob.on_message"], excluded) == \
        pytest.approx(50.0)
    assert spans.self_us(by["bob.flush"], excluded) == pytest.approx(60.0)


def test_per_thread_selection(recorder):
    spans = ps.read(recorder(_record(SESSION, BENCH)))
    assert [sp.id for sp in spans.named("drain", "main")] == [9]
    assert spans.named("drain.materialize", "main") == []
    assert [sp.id for sp in spans.named("drain.materialize", "other")] \
        == [12]
    assert len(spans.named("drain.materialize")) == 1


def test_spans_are_clipped_to_the_window(recorder):
    spans = ps.read(recorder(_record(SESSION, BENCH, t0=150.0, t1=550.0)))
    by = {sp.name: sp for sp in spans.spans}
    assert spans.clipped(by["bob.on_message"]) == pytest.approx(50.0)
    assert spans.clipped(by["drain"]) == pytest.approx(50.0)
    assert "bob.on_syndromes" in by and spans.windows() == 1


def test_idle_under_the_drain(recorder):
    record = recorder(_record(SESSION, BENCH, KERNELS))
    spans = ps.read(record)
    busy = ps.busy_intervals(record["trace"])
    assert busy == [[130.0, 160.0], [520.0, 540.0]]
    assert spans.idle_us(spans.named("drain", "main"), busy) == \
        pytest.approx(80.0)


def _reader(metric):
    return registry.load_module(
        registry.HERE / "layer_metrics" / f"{metric}.py",
        "qkdbench_metric_" + metric.replace(".", "_")).read


@pytest.mark.parametrize("metric, want", [
    ("drain_wait_ms_per_window", 0.1),
    ("drain_worker_ms_per_window", 0.11),
    # on_message 100 - program.bob 50; flush 100 - pa.host_total 40.
    ("handler_self_ms_per_window", 0.11),
    ("program_dispatch_ms_per_window", 0.07),
    ("drain_idle_share.session", 8.0),
    ("decoder_host_us_per_call.decode", 30.0),
])
def test_each_reader(recorder, metric, want):
    read = _reader(metric)
    assert read(recorder(_record(SESSION, BENCH, KERNELS))) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "drain_wait_ms_per_window", "drain_worker_ms_per_window",
    "handler_self_ms_per_window", "program_dispatch_ms_per_window",
    "drain_idle_share.session", "decoder_host_us_per_call.decode"])
def test_readers_read_nothing_without_spans(monkeypatch, metric):
    read = _reader(metric)
    record = _record(SESSION, BENCH)
    # A program without a recorder, an empty recorder, an untraced run.
    monkeypatch.setattr(ps, "_recorded", lambda: None)
    assert read(record) is None
    monkeypatch.setattr(ps, "_recorded", lambda: Recorded([], 0))
    assert read(record) is None
    monkeypatch.setattr(ps, "_recorded", lambda: Recorded(SESSION, 0))
    assert read({"trace": None}) is None


def test_a_program_without_a_recorder_reads_none(monkeypatch, tmp_path):
    """An older program: its package has no ``tracing`` module."""
    import sys
    pkg = tmp_path / "qtpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name in [m for m in sys.modules
                 if m == "qtpu_torch" or m.startswith("qtpu_torch.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path))
    assert ps._recorded() is None
