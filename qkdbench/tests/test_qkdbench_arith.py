"""The frozen roofline arithmetic against hand-computed shapes, the rate
and latency arithmetic on synthetic stamps, and the trace reduction on a
synthetic trace."""

from __future__ import annotations

import math

import pytest

from qkdbench import roofline, stats
from qkdbench.trace import PREFIX, WINDOW, TraceRecord


def test_decode_bound_bytes_and_operations():
    # n = 4096 (3,6)-regular: z = 256, mb = 8, 48 edges, B = 1024.
    nbytes = 1024 * (4 * 4096 + 2048 + 4096 + 1 + 4) + 4 * (8 + 1 + 96)
    assert roofline.decode_bound_s(4096, 2048, 8, 48, 256, 1024, 0) == \
        pytest.approx(nbytes / 3.35e12)
    ops = 5 * 1024 * 48 * 256 * 10
    assert roofline.decode_bound_s(4096, 2048, 8, 48, 256, 1024, 5 * 1024) \
        == pytest.approx(ops / 67e12)


def test_toeplitz_bound_production_shape():
    # r4 of the production ladder: P = 63,488, l_max = 46,973, B = 128.
    B, n, m = 128, 63488, 46973
    L = 1 << 17
    flops = B * (3 * 2.5 * L * 17 + 6 * (L // 2 + 1))
    assert roofline.toeplitz_bound_s(B, n, m) == pytest.approx(flops / 67e12)
    assert flops == pytest.approx(2.189e9, rel=1e-3)   # chip_smoke's 2.189
    # A short hash is bound by its bytes.
    assert roofline.toeplitz_bound_s(1, 4, 3) == pytest.approx(
        max((6 + 4 + 3) / 3.35e12, (3 * 2.5 * 8 * 3 + 6 * 5) / 67e12))


def test_waits_count_an_undelivered_window_to_the_end():
    opened = {0: 9.0, 1: 10.0, 2: 10.5, 3: 11.5}
    delivered = {1: 10.2, 2: 12.5}
    got = stats.waits(opened, delivered, 10.0, 12.0)
    assert got == pytest.approx([0.2, 1.5, 0.5])


def test_rate_and_percentile():
    assert stats.rate(300, 1.5) == 200
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95)
    assert stats.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_record_reduction():
    events = [
        _ev("user_annotation", WINDOW, 0, 100),
        _ev("user_annotation", PREFIX + "pa", 10, 10),
        _ev("user_annotation", PREFIX + "feed", 50, 40),
        _ev("user_annotation", PREFIX + "flush", 52, 6),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _ev("kernel", "fft", 20, 10, corr=1),
        _ev("kernel", "bp_layered_kernel<8>", 25, 15, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 5),
    ]
    tr = TraceRecord.from_chrome(events)
    assert tr.window_s == pytest.approx(1e-4)
    assert tr.busy_s() == pytest.approx(25e-6)      # [20, 40) and [60, 65)
    assert tr.launches() == 3
    assert tr.kernel_count(lambda n: "bp_layered" in n) == 1
    assert [k[0] for k in tr.launched_in("pa")] == ["fft"]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["bp_layered_kernel<8>", pytest.approx(15e-6)]
    idle = dict(bd["idle_gaps"])
    # Idle [0, 10) and [40, 50): outside; [10, 20): "pa"; [50, 52) and
    # [58, 60): "feed", [52, 58): the "flush" inside it; [65, 90): "feed";
    # [90, 100): outside.
    assert idle["outside_spans"] == pytest.approx(30e-6)
    assert idle["pa"] == pytest.approx(10e-6)
    assert idle["flush"] == pytest.approx(6e-6)
    assert idle["feed"] == pytest.approx(29e-6)
    assert math.isclose(sum(idle.values()) + tr.busy_s(), tr.window_s)


def test_trace_without_window_is_refused():
    with pytest.raises(RuntimeError):
        TraceRecord.from_chrome([_ev("kernel", "k", 0, 1)])


class _FakeTrace:
    def __init__(self, n, each_s):
        self.n, self.each_s = n, each_s

    def kernel_count(self, pred):
        return self.n

    def kernel_s(self, pred):
        return self.n * self.each_s


def test_layered_roofline_tolerates_a_missed_kernel():
    from qkdbench.readers import bp_layered_roofline
    call = (4096, 2048, 8, 48, 256, 1024, 5 * 1024)
    bound = roofline.decode_bound_s(*call)
    rec = {"decodes": [call] * 200, "trace": _FakeTrace(200, 10 * bound)}
    assert bp_layered_roofline(rec) == pytest.approx(10.0)
    rec["trace"] = _FakeTrace(198, 10 * bound)       # two missed
    assert bp_layered_roofline(rec) == pytest.approx(10.0)
    rec["trace"] = _FakeTrace(190, 10 * bound)       # too many
    assert bp_layered_roofline(rec) is None
    assert bp_layered_roofline({"decodes": [call], "trace": None}) is None
