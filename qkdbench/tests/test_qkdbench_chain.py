"""The events cell: its files are found by name, a sound run on the CPU at
a small size is ``correct`` and reports its per-layer metrics when traced,
either control of ``control_chain`` in the program's place is refused by
``sift_chunks_differ``, a program that answers a held chunk empty is
refused at the warm-up, the plain matcher keeps to its rules on events
made for them, and the readers return None where there is nothing to
read.  The card test runs the cell at its own size for a short window."""

from __future__ import annotations

import json
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from qkdbench import chain_spans, control_chain, program_spans, registry, run
from qkdbench.reference import sift as ref_sift
from qkdbench.tests.tiny import REPO
from qkdbench.tests.tiny_chain import CHAIN, tiny_chain_copy

SEED = (1 << 31) + 977
NEW_METRICS = ("sift_ms_per_window", "sift_idle_share.chain",
               "sift_roofline.chain")
# The production session's metrics, whose readers take this cell's record.
SESSION_METRICS = (
    "key_pull_ms_per_window", "retry_share", "launches_per_window",
    "bp_layered_roofline.session", "pa_roofline.session",
    "device_idle_share.session", "drain_wait_ms_per_window",
    "drain_worker_ms_per_window", "handler_self_ms_per_window",
    "program_dispatch_ms_per_window", "drain_idle_share.session")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_chain_copy(tmp_path_factory.mktemp("tiny_chain"))


def _result(tiny, capsys, trace=0, seconds=2.0):
    bench, root = tiny
    rc = run.main(["--workload", CHAIN, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", str(trace)], bench_path=bench,
                  root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


def test_chain_cell_finds_its_files():
    c = registry.cell(REPO / "BENCHMARK.json", CHAIN)
    assert c.config["name"] == c.entry["config"] == "chain65k"
    assert callable(c.driver().run)
    assert {m["name"] for m in c.end_to_end} == {
        "secret_bits_per_s", "key_latency_p95_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {*SESSION_METRICS,
                                                *NEW_METRICS}
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]))


def test_chain_config_is_config4():
    """The configuration is ``benchmarks/config4_sifted_chain.py``'s:
    ``production_config`` with its four overrides, its ChainConfig and its
    source."""
    from qtpu_torch.pipeline import production_config
    c = registry.cell(REPO / "BENCHMARK.json", CHAIN)
    drv = c.driver()
    cfg = drv.chain_config(c.config)
    assert cfg.pipeline == production_config(
        blocks_per_window=32, qber_test_bits=2048,
        stream_capacity_bits=1 << 25, drain_windows=4)
    assert (cfg.window_s, cfg.sift_batch_frames, cfg.coincidence_window,
            cfg.pfind_bins, cfg.servo_gain) == (0.05, 8, 40, 1 << 18, 0.5)
    src = c.config["source_events"]
    assert (src["pair_rate_hz"], src["offset_ns"], src["error_rate"],
            src["dark_rate_hz"]) == (1e7, 4321.0, 0.025, 2e4)


def test_chain_sound_run_is_correct(tiny, capsys):
    res = _result(tiny, capsys)
    assert res["correct"], res["checks"]
    assert res["checks"]["sift_chunks_differ"]["value"] == 0
    assert res["checks"]["sift_chunks_checked"]["value"] >= 4
    assert res["checks"]["sift_chunks_dropped"]["value"] == 0
    assert list(res)[-1] == "checks"


def test_chain_traced_run_reports_its_metrics(tiny, capsys):
    """On the CPU no kernel runs, so the rooflines have nothing to read."""
    res = _result(tiny, capsys, trace=1)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    rooflines = {"sift_roofline.chain", "bp_layered_roofline.session",
                 "pa_roofline.session"}
    assert {*SESSION_METRICS, *NEW_METRICS} - rooflines <= got
    assert not rooflines & got
    assert res["metrics"]["sift_ms_per_window"]["value"] > 0


@pytest.mark.parametrize("part", sorted(control_chain.PARTS))
def test_chain_control_is_refused(tiny, capsys, part):
    with mock.patch(*control_chain.PARTS[part]):
        res = _result(tiny, capsys)
    assert res["correct"] is False
    assert res["checks"]["sift_chunks_differ"]["value"] > 0


def test_chain_run_refuses_a_program_that_drops_chunks(tiny, capsys):
    """A Bob that answers a chunk of Alice's empty though he holds its
    events (as one that lets go of frames she is still to announce does)
    is refused at the warm-up: the run raises before its window."""
    from qtpu_torch.chain import BobChain
    from qtpu_torch.messages import SiftIndex
    on_timing = BobChain._on_timing
    seen = []

    def dropping(self, msg):
        seen.append(msg.window_id)
        q = self._events.get(msg.window_id)
        if len(seen) != 3 or not q:
            return on_timing(self, msg)
        q.popleft()
        if not q:
            del self._events[msg.window_id]
        self.link.send(SiftIndex(window_id=msg.window_id,
                                 indices=np.zeros(0, np.int32)))

    bench, root = tiny
    with mock.patch.object(BobChain, "_on_timing", dropping), \
            pytest.raises(RuntimeError, match="answered 1 of Alice's chunks"):
        run.main(["--workload", CHAIN, "--seed", str(SEED), "--seconds",
                  "2", "--trace", "0"], bench_path=bench, root=root,
                 require_card=False)
    assert len(seen) > 3


def _chunk(times, dets, frame=0):
    return ref_sift.Chunk(frame, np.asarray(times, np.int32),
                          np.asarray(dets, np.uint8))


def test_plain_matcher_rules():
    """Ties go left; the padding never matches; one Bob event keeps its
    nearest claimant (the lower index at equal distance); only agreeing
    bases sift; the residual is the float32 mean and the servo truncates."""
    # Bob: 100 (basis 0, value 1), 200 (basis 1, value 0), 300 (basis 0, 0)
    bob = _chunk([100, 200, 300], [1, 2, 0])
    # Alice: 104 is nearer 100; 150 lies halfway, outside the window; 196
    # and 204 both claim 200 at distance 4 (the lower index keeps it); 500
    # is past the window.
    alice = _chunk([104, 150, 196, 204, 500], [0, 0, 2, 2, 0])
    got = ref_sift.match_chunk(alice, bob, 0, 40, 0.5)
    assert got.matched == 2
    assert got.index.tolist() == [0, 2]
    assert got.bob_bits.tolist() == [1, 0]
    assert got.residual == np.float32(0.0)
    moved = ref_sift.match_chunk(alice, bob, -3, 40, 0.5)
    # Offset -3: 101 -> 100 (d -1), 193 -> 200 (d 7), 201 -> 200 (d -1).
    assert moved.index.tolist() == [0, 3]
    assert moved.residual == np.float32(-1.0)
    assert int(moved.next_offset) == -3
    assert ref_sift.match_chunk(alice, _chunk([], []), 5, 40, 0.5) \
        .next_offset == 5
    tie = ref_sift.match_chunk(_chunk([150], [0]), bob, 0, 50, 0.5)
    assert tie.index.tolist() == [0] and tie.bob_bits.tolist() == [1]
    assert tie.residual == np.float32(-50.0) and tie.next_offset == -25
    frames = ref_sift.frame_chunks(
        np.array([(1 << 29) + 7, 3, -2, 5, (1 << 29) + 1]),
        np.array([1, 2, 3, 0, 2]))
    assert [(c.frame, c.times.tolist(), c.detectors.tolist())
            for c in frames] == [(0, [3, 5], [2, 0]), (1, [1, 7], [2, 1])]
    assert ref_sift.splice(alice, got.index).tolist() == [0, 0]


def test_readers_return_none_without_spans(monkeypatch):
    """Where the program records no chain span (a parent without them),
    the sift readers return None and the roofline None without calls."""
    reg = registry.cell(REPO / "BENCHMARK.json", CHAIN)
    spans = program_spans.Spans(
        [program_spans.Span(1, "bob.finalize", 3, None, 7, 0.0, 1.0),
         program_spans.Span(2, "bob.on_message", 3, None, 7, 1.0, 2.0)],
        0.0, 10.0)
    monkeypatch.setattr(program_spans, "read", lambda record: spans)
    record = {"trace": object(), "sift_batches": []}
    assert chain_spans.outermost(record) is None
    for name in NEW_METRICS:
        assert reg.metric_reader(name)(record) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_chain_cell_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "qkdbench.run", "--workload", CHAIN, "--seed",
         str((1 << 31) + 4242), "--seconds", "4", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert {*SESSION_METRICS, *NEW_METRICS} <= set(res["metrics"])
        assert 0 < res["metrics"]["sift_roofline.chain"]["value"] <= 100
