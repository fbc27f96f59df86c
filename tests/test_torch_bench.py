"""The port's bench (qtpu_torch.bench) against the reference bench.

On the CPU at small sizes: the BSC stream equals the reference's
``device_bsc_stream`` (benchmarks/config4_full_chain.py) bit for bit;
``measure_full_chain`` equals the reference's on every field that does not
depend on time (windows, secret fraction, authentication bits, mean
iterations, FER); the per-chip replay passes its check at
max_inflight_windows=3 and a second run times nothing that was built or
made; the replay check raises on an altered, a missing and an extra
message; the median is taken over clean runs only, and fewer than two
fail; the events -> key chain's rates leave out the warm-up; and the CLI's
``bench`` prints one JSON line with bench.py's keys.  Tolerance:
exact, apart from rates (wall-clock).

The reference module is loaded by path.  It turns on JAX's persistent
compile cache when imported; the fixture restores the cache settings at
once, so nothing else in the process writes to ``.jax_cache/``.
"""

import functools
import importlib.util
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest

import qtpu.pipeline as jpipe
import qtpu_torch.pipeline as tpipe
from qtpu_torch import bench
from qtpu_torch.ldpc.decode import make_layered_decoder
from qtpu_torch.link import make_direct_pair
from qtpu_torch.messages import Abort, RateSelect, VerifyAck

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n=1024, blocks_per_window=4, qber_test_bits=512)
# Both benches feed the session this many bits a chunk here: the default
# 2^23 would leave ~2,000 windows of stream for the untimed drain at n=1024.
CHUNK = 1 << 14


@pytest.fixture(scope="module")
def reference():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "config4_full_chain", ROOT / "benchmarks" / "config4_full_chain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in saved.items():
        jax.config.update(k, v)
    return mod


def test_bsc_stream_matches_reference(reference):
    """Three chunks of 2048 bits for 5000 (the last one partly used)."""
    a, b = bench.device_bsc_stream(5000, 0.03, 7, chunk_bits=2048,
                                   device="cpu")
    ja, jb = reference.device_bsc_stream(5000, 0.03, 7, chunk_bits=2048)
    assert len(a) == len(b) == len(ja) == len(jb) == 3
    for got, want in zip(a + b, ja + jb):
        assert got.shape == (2048,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flips = sum(int((x ^ y).sum()) for x, y in zip(a, b))
    assert 0 < flips < 0.06 * 3 * 2048


def test_full_chain_matches_reference(reference, monkeypatch):
    monkeypatch.setattr(reference, "device_bsc_stream", functools.partial(
        reference.device_bsc_stream, chunk_bits=CHUNK))
    want = reference.measure_full_chain(
        windows=4, warmup_windows=2,
        config=jpipe.PipelineConfig(**SMALL, max_inflight_windows=1))
    got = bench.measure_full_chain(
        windows=4, warmup_windows=2,
        config=tpipe.PipelineConfig(**SMALL, max_inflight_windows=1),
        device="cpu", chunk_bits=CHUNK)
    assert got["windows"] == 4 and got["auth_bits_total"] > 0
    for k in ("windows", "secret_fraction", "auth_bits_total", "iters_mean",
              "fer"):
        assert got[k] == want[k], k
    assert got["trace_growth"] == 0


@pytest.mark.parametrize("side", ["bob", "alice"])
def test_measure_party_replay_and_clean_rerun(side):
    """At max_inflight_windows=3 Bob's rate choices follow his prior as the
    decodes land; the replay answers each window as recorded.  The second
    run in the process builds and makes nothing inside its timed region."""
    cfg = tpipe.PipelineConfig(**SMALL, max_inflight_windows=3)
    runs = [bench.measure_party(side, windows=4, warmup_windows=2,
                                config=cfg, device="cpu", chunk_bits=CHUNK)
            for _ in range(2)]
    assert all(r["windows"] >= 4 and r["sifted_bits_per_s"] > 0
               for r in runs)
    assert runs[1]["trace_growth"] == 0


def test_replay_forces_recorded_choices_when_decodes_land_late(monkeypatch):
    """Bob's rate choice follows his QBER prior, which a decode updates when
    its stats land.  A recording whose stats land only at blocking flushes
    (as behind a busy card) chooses other rungs at QBER 5% than one whose
    stats land at once; the replay, whose stats land at once, still sends
    exactly the recorded messages: it answers each window as recorded."""
    cfg = tpipe.PipelineConfig(**SMALL, max_inflight_windows=3,
                               qber_initial=0.04, qber_test_floor=32)
    chosen = []
    plain_choose = tpipe.BobSession._choose

    def logged(self):
        c = plain_choose(self)
        chosen[-1].append((self._open_q[0], c))
        return c

    class LateFirst(tpipe.BobSession):
        """The first session made (the recording's Bob) resolves a decode
        only when the caller blocks for it."""
        made = 0

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            LateFirst.made += 1
            self._late = LateFirst.made == 1

        def flush(self, block=True, limit=0):
            if self._late and not block:
                return False
            return super().flush(block, limit)

    monkeypatch.setattr(tpipe.BobSession, "_choose", logged)
    for late in (False, True):
        chosen.append([])
        if late:
            monkeypatch.setattr(tpipe, "BobSession", LateFirst)
        r = bench.measure_party("bob", windows=6, warmup_windows=2,
                                qber=0.05, config=cfg, device="cpu",
                                chunk_bits=CHUNK)
        assert r["windows"] >= 6
    assert LateFirst.made == 2
    assert chosen[0] != chosen[1]


def test_program_insertions_are_counted():
    cfg = tpipe.PipelineConfig(**SMALL, code_seed=0x7E57)
    bob = tpipe.BobSession(cfg, 1, make_direct_pair()[1], device="cpu")
    before = bench._made()
    bob.programs(0)
    assert bench._made() == before + 1
    tpipe.BobSession(cfg, 1, make_direct_pair()[1], device="cpu").programs(0)
    assert bench._made() == before + 1          # served from the cache


def _bob_messages():
    ok = np.array([1, 0, 1, 1], np.uint8)
    return [RateSelect(window_id=0, qber_milli=30, rate_index=2),
            VerifyAck(window_id=0, num_blocks=4, ok_mask=ok),
            VerifyAck(window_id=0, num_blocks=4, ok_mask=np.ones(4, np.uint8),
                      round=1),
            RateSelect(window_id=1, qber_milli=31, rate_index=2),
            Abort(window_id=1, reason="sync", consumed=4096)]


@pytest.mark.parametrize("change", ["none", "altered", "missing", "extra"])
def test_check_replay_compares_whole_multisets(change):
    recorded = _bob_messages()
    sent = list(reversed(_bob_messages()))   # another order is no fault
    if change == "altered":                  # window 0's round-0 ack
        sent[3] = VerifyAck(window_id=0, num_blocks=4,
                            ok_mask=np.array([1, 1, 0, 1], np.uint8))
    elif change == "missing":
        del sent[0]                          # the abort of window 1
    elif change == "extra":
        sent.append(_bob_messages()[1])      # a second round-0 ack
    if change == "none":
        bench.check_replay(sent, recorded, {0, 1}, 2)
        return
    with pytest.raises(RuntimeError, match="diverged"):
        bench.check_replay(sent, recorded, {0, 1}, 2)


def test_check_replay_coverage():
    recorded = _bob_messages()
    with pytest.raises(RuntimeError, match="never sent RateSelect"):
        bench.check_replay(recorded[:3], recorded, {0}, 2)


def test_sifted_chain_rates_exclude_warmup():
    cfg = tpipe.PipelineConfig(n=1024, blocks_per_window=2,
                               qber_test_bits=256, alg="minsum")
    r = bench.measure_sifted_chain(sim_windows=9, pair_rate=150_000,
                                   device="cpu", pipeline=cfg)
    assert r["sim_windows"] == 6 and r["blocks_per_window"] == 2
    assert 0 < r["sifted_bits_warmup"] < r["sifted_bits_total"]
    assert 0 < r["final_key_bits_warmup"] < r["final_key_bits"]
    dt = r["elapsed_s"]
    sifted = r["sifted_bits_total"] - r["sifted_bits_warmup"]
    final = r["final_key_bits"] - r["final_key_bits_warmup"]
    assert r["sifted_bits_per_s_wall"] == pytest.approx(sifted / dt, rel=2e-2)
    assert r["chain_from_events_final_bits_per_s"] == pytest.approx(
        final / dt, rel=2e-2)
    assert r["sifted_bits_per_s_wall"] < 0.95 * r["sifted_bits_total"] / dt


@pytest.mark.parametrize("growth", [(0, 0, 0), (0, 2, 0), (1, 0, 1)])
def test_median_run_takes_only_clean_runs(growth):
    runs = [{"sifted_bits_per_s": v, "trace_growth": g}
            for v, g in zip((3.0, 1.0, 2.0), growth)]
    if sum(g == 0 for g in growth) < 2:
        with pytest.raises(RuntimeError, match="two clean runs"):
            bench._median_run(runs)
        return
    med, clean = bench._median_run(runs)
    assert all(r["trace_growth"] == 0 for r in clean)
    assert [r["sifted_bits_per_s"] for r in clean] == sorted(
        r["sifted_bits_per_s"] for r in runs if r["trace_growth"] == 0)
    assert med is clean[len(clean) // 2]


def _reference_extra_keys():
    """The decode extras bench.py always sets (its ``extra = {...}``)."""
    text = (ROOT / "bench.py").read_text()
    block = text[text.index("extra = {"):]
    return set(re.findall(r'"(\w+)":', block[:block.index("}")]))


def test_cli_bench_cpu_prints_one_reference_line(monkeypatch, capsys,
                                                 tmp_path):
    """With the three QTPU_BENCH_SKIP_* set: the decoder alone.  The launch
    counts are set to 0 before each measurement (a stale count is gone)."""
    from qtpu_torch import cli
    from qtpu_torch.ldpc import cuda_bp
    for k in ("FULL", "SIFTED_CHAIN", "SIFT"):
        monkeypatch.setenv(f"QTPU_BENCH_SKIP_{k}", "1")
    monkeypatch.setattr(bench, "ARTIFACT", tmp_path / "bench_last_run.json")
    monkeypatch.setitem(cuda_bp.launches, "bp_layered", 5)
    assert cli.main(["--device", "cpu", "bench"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    objects = [ln for ln in lines if ln.startswith("{")]
    assert objects == [lines[-1]]
    out = json.loads(lines[-1])
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert out["metric"] == "decode_kernel_bits_per_s_qber3_FALLBACK"
    assert out["unit"] == "Gbit/s" and out["value"] > 0
    extra = out["extra"]
    assert _reference_extra_keys() <= set(extra) and extra["device"] == "cpu"
    assert extra["decode_blocks_converged"] == extra["decode_blocks"] == 64
    code, llr, syn = bench.decode_inputs("cpu", 64)
    plain = make_layered_decoder(code, bench.DECODE_ITERS)(llr, syn)
    assert extra["decode_iterations_sum"] == int(plain.iterations.sum())
    host = extra["host"]
    assert host["cores_usable"] >= 1 and host["cpu"]
    for now in (host["start"], host["end"]):
        assert len(now["loadavg"]) == 3
        assert now["torch_cpu_op_us"] > 0 and now["python_loop_ms"] > 0
    assert json.loads((tmp_path / "bench_last_run.json").read_text()) == out
    launches = json.loads(lines[-2].split("bench launches: ", 1)[1])
    assert launches == {"decode": {"bp_layered": 0, "bp_flooding": 0,
                                   "threefry_draws": 0,
                                   "threefry_hash": 0, "qc_encode": 0,
                                   "pin_llr": 0, "llr": 0,
                                   "verify_hash": 0, "verify_tail": 0}}


def test_bench_needs_cuda_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench.main([])
