"""qtpu_torch.tracing on the CPU: the recorder is off (and its spans one
shared no-op) without a profiler; under a CPU ``torch.profiler`` a
two-party session records every span of the session, the drain and the
decoder with window ids and parents, the drain worker's spans on a thread
of its own, and as many spans as the session reports windows, retries and
decodes; each top-level span holds its ``qtpu_torch:`` twin in the
exported Chrome trace, and agrees with it where no other thread runs,
while nested spans open no range; a full buffer counts what it drops.
The decoder's ``decode.plan`` and the kernels' ``build`` run only on a
card."""

import collections
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qtpu_torch import pipeline, tracing

B = 16
# Nine windows at n = 1024: the fifth window's bits carry a burst of
# errors, so its decode fails in more than 8 blocks and the sixth in
# fewer, each retried by one ``program.retry``; a drain every 4 windows
# leaves one window's keys for the inline drain.
CFG = pipeline.PipelineConfig(n=1024, blocks_per_window=B,
                              qber_test_bits=512, drain_windows=4)
WINDOWS, BURST = 8, 4

SESSION_SPANS = {
    "alice.start_window", "alice.on_message", "alice.on_rate_select",
    "alice.on_verify_ack", "bob.on_message", "bob.service_opens",
    "bob.on_syndromes", "bob.on_retry", "bob.flush", "bob.resolve_decode",
    "bob.finalize", "push_sifted", "pa.host_total", "host.affine_for",
    "host.prng_derive", "program.alice", "program.bob", "program.retry",
    "program.retry_gather", "program.pa",
    "program.pack", "drain", "drain.join", "drain.unpack", "drain.sort",
    "drain.materialize", "decode", "setup.ladder", "setup.programs"}
PROGRAMS = {"program.alice": "alice.on_rate_select",
            "program.bob": "bob.on_syndromes",
            "program.retry": "bob.on_retry",
            "program.retry_gather": "alice.on_verify_ack",
            "program.pa": "pa.host_total", "program.pack": "pa.host_total"}


def _bits():
    rng = np.random.default_rng(1)
    n = CFG.n * B * WINDOWS
    a = rng.integers(0, 2, n).astype(np.uint8)
    q = np.full(n, 0.03)
    q[BURST * CFG.n * B:(BURST + 1) * CFG.n * B] = 0.09
    return a, a ^ (rng.random(n) < q).astype(np.uint8)


def _session():
    """The session, with the keys left for the inline drain drained."""
    pipeline._PROGRAM_CACHE.clear()
    alice, bob = pipeline.run_loopback(CFG, *_bits(), device="cpu")
    pending = [len(p._final_chunks) for p in (alice, bob)]
    for p in (alice, bob):
        p.drain_final()
    return alice, bob, pending


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The session under a CPU profiler: (alice, bob, keys left for the
    inline drain, what the recorder holds, the trace's ``qtpu_torch:``
    ranges, the calling thread)."""
    tracing.clear()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # The first profiler range of a process takes a millisecond to set
        # up its operator, around its own start; any real run has opened
        # one before the program's first span.
        with record_function("warm-up"):
            pass
        alice, bob, pending = _session()
    rec = tracing.recorded()
    tracing.clear()
    return (alice, bob, pending, rec, _twins(prof, path),
            threading.get_ident())


def test_off_records_nothing_and_spans_are_one_noop():
    tracing.clear()
    assert tracing.span("a", 1) is tracing.span("b")
    with tracing.span("a"):
        pass
    alice, bob, _ = _session()
    assert len(bob.metrics) >= WINDOWS - 1
    rec = tracing.recorded()
    assert rec.spans == [] and rec.dropped == 0


def test_profiled_session_records_every_span(traced):
    _, _, _, rec, _, _ = traced
    names = {sp.name for sp in rec.spans}
    assert SESSION_SPANS <= names, SESSION_SPANS - names
    # Only a card plans and launches the kernels and builds them.
    assert not names & {"decode.plan", "build"}
    assert rec.dropped == 0


def test_spans_carry_windows_and_parents(traced):
    _, bob, _, rec, _, caller = traced
    by_id = {sp.id: sp for sp in rec.spans}
    for sp in rec.spans:
        assert sp.end_ns >= sp.start_ns
        if sp.parent is not None:
            up = by_id[sp.parent]
            assert up.thread == sp.thread
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
    finalized = [sp.window for sp in rec.spans if sp.name == "bob.finalize"]
    assert sorted(finalized) == sorted(m.window_id for m in bob.metrics)
    for sp in rec.spans:
        if sp.name in PROGRAMS:
            up = by_id[sp.parent]
            assert up.name == PROGRAMS[sp.name], (sp, up)
            assert isinstance(sp.window, int) and sp.window == up.window
        elif sp.name == "decode":
            # The decoder's spans take the window of the program that
            # called it.
            up = by_id[sp.parent]
            assert up.name in ("program.bob", "program.retry")
            assert sp.window == up.window
        elif sp.name in ("alice.on_rate_select", "bob.on_syndromes"):
            assert by_id[sp.parent].name.endswith(".on_message")
        elif sp.name in ("drain.join", "drain.unpack", "drain.sort"):
            assert by_id[sp.parent].name == "drain"
        elif sp.name in ("bob.on_message", "alice.on_message", "drain"):
            assert sp.parent is None and sp.thread == caller


def test_drain_worker_spans_are_on_their_own_thread(traced):
    alice, bob, pending, rec, _, caller = traced
    worker = [sp for sp in rec.spans if sp.name == "drain.materialize"]
    assert worker and all(sp.thread != caller and sp.parent is None
                          for sp in worker)
    # Each party's worker covers each of its windows once.
    covered = collections.defaultdict(list)
    for sp in worker:
        covered[sp.thread] += sp.window
    assert len(covered) == 2
    assert all(len(ws) == len(set(ws)) for ws in covered.values())
    assert pending == [1, 1]
    assert sum(sp.name == "drain.unpack" for sp in rec.spans) == 2


def test_span_counts_equal_what_the_session_reports(traced):
    alice, bob, _, rec, _, _ = traced
    n = collections.Counter(sp.name for sp in rec.spans)
    assert n["bob.finalize"] == len(bob._completed) == len(bob.metrics)
    assert len(alice._aborted) + len(bob._aborted) == 0
    retried = sum(m.blocks_retried > 0 for m in bob.metrics)
    assert n["program.retry"] == retried >= 2
    assert "program.retry_small" not in n
    assert max(m.blocks_retried for m in bob.metrics) > 8
    assert n["decode"] == len(bob.metrics) + retried
    # The worker's drains and the one inline drain a party cover every
    # window its keys come from.
    covered = collections.defaultdict(list)
    for sp in rec.spans:
        if sp.name == "drain.materialize":
            covered[sp.thread] += sp.window
    assert sorted(len(ws) + 1 for ws in covered.values()) == sorted(
        len({w for w, _ in p.final_key_index}) for p in (alice, bob))


def _twins(prof, path) -> dict:
    """{name: [(start, end)]} of the ``qtpu_torch:`` ranges in the Chrome
    trace ``prof`` exports to ``path``, in Unix ns: ``ts`` µs after the
    trace's ``baseTimeNanoseconds``."""
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    base = int(chrome["baseTimeNanoseconds"])
    out = collections.defaultdict(list)
    for e in chrome["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(tracing.PREFIX):
            s = base + round(float(e["ts"]) * 1e3)
            out[name[len(tracing.PREFIX):]].append(
                (s, s + round(float(e["dur"]) * 1e3)))
    return out


def test_spans_contain_their_chrome_twins(traced):
    """Each top-level span of the calling thread holds its ``qtpu_torch:``
    range of the exported trace (the span is stamped outside the range),
    to within 20 µs, on the trace's clock mapped to Unix ns; a span that
    only ever runs nested opens no range."""
    _, _, _, rec, twins, caller = traced
    mine = [sp for sp in rec.spans
            if sp.thread == caller and sp.parent is None]
    assert len(mine) > 50
    assert not set(twins) & {"program.bob", "drain.join", "decode"}
    for sp in mine:
        inside = [(s, e) for s, e in twins[sp.name]
                  if s >= sp.start_ns - 20_000 and e <= sp.end_ns + 20_000]
        assert inside, sp


def test_spans_agree_with_their_chrome_twins(tmp_path):
    """With no other thread running, each span's start and end are within
    50 µs of its twin's."""
    tracing.clear()
    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        for i in range(20):
            with tracing.span("outer", i):
                x = x + 1
                with tracing.span("inner"):
                    x = x * 2
    rec = tracing.recorded()
    tracing.clear()
    twins = _twins(prof, tmp_path / "trace.json")
    assert len(rec.spans) == 40 and set(twins) == {"outer"}
    for sp in rec.spans[1::2]:
        assert sp.name == "outer"
        s, e = min(twins[sp.name], key=lambda t: abs(t[0] - sp.start_ns))
        assert abs(s - sp.start_ns) <= 50_000, sp
        assert abs(e - sp.end_ns) <= 50_000, sp


def test_recording_nests_and_inherits_windows():
    tracing.clear()
    with tracing.recording():
        assert tracing.span("a") is not tracing.span("b")
        with tracing.span("outer", 7):
            with tracing.span("inner"):
                pass
        with tracing.span("alone"):
            pass
    assert tracing.span("a") is tracing.span("b")
    rec = tracing.recorded()
    tracing.clear()
    inner, outer, alone = rec.spans
    assert (inner.name, inner.window, inner.parent) == ("inner", 7, outer.id)
    assert (outer.window, outer.parent) == (7, None)
    assert (alone.window, alone.parent) == (None, None)
    assert tracing.table(rec.spans)["inner"]["calls"] == 1


def test_full_buffer_counts_its_drops(monkeypatch):
    tracing.clear()
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span("s", i):
                pass
    rec = tracing.recorded()
    assert [sp.window for sp in rec.spans] == [0, 1, 2]
    assert rec.dropped == 2
    tracing.clear()
    assert tracing.recorded() == tracing.Recorded([], 0)


def test_threads_keep_their_own_parents():
    tracing.clear()
    seen = []

    def worker():
        with tracing.span("worker"):
            seen.append(threading.get_ident())

    with tracing.recording():
        with tracing.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    rec = tracing.recorded()
    tracing.clear()
    spans = {sp.name: sp for sp in rec.spans}
    assert spans["worker"].parent is None
    assert spans["worker"].thread == seen[0] != spans["main"].thread


def test_threads_lose_no_span():
    """More recording threads than cores, switching often: every span is
    kept."""
    import os
    import sys
    tracing.clear()
    threads, each = 2 * (os.cpu_count() or 4), 300

    def worker():
        for i in range(each):
            with tracing.span("s", i):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            pool = [threading.Thread(target=worker) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    rec = tracing.recorded()
    tracing.clear()
    assert len(rec.spans) == threads * each and rec.dropped == 0
    assert len({sp.id for sp in rec.spans}) == threads * each
    assert all(sp.parent is None for sp in rec.spans)
