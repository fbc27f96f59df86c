"""qtpu_torch.profiling (``programs``, ``full_chain``) on the CPU at a small
config: each returns every key of its reference's output
(``benchmarks/profile_programs.py``, ``benchmarks/profile_full_chain.py``),
``programs`` profiles the rung the reference's own Bob selects from the 3%
prior, the chain settles the windows asked for, and the methods the chain
wraps with timers are the originals again afterwards, also when the run
fails.  Nothing is traced on the CPU: the device numbers are None.
Times are not compared.
"""

import collections

import pytest
import torch

import qtpu.pipeline as jpipe
from qtpu.link import DirectLink as JLink
import qtpu_torch.pipeline as tpipe
from qtpu_torch import prng, profiling

SMALL = dict(n=1024, blocks_per_window=8, qber_test_bits=512)
# The reference prints these (profile_full_chain.py's JSON).
CHAIN_KEYS = {"mode", "windows", "window_ms", "sifted_bits_per_s"}
TIMER_NAMES = {"alice.start_window", "alice.on_rate_select",
               "alice.on_verify_ack", "bob.service_opens", "bob.on_syndromes",
               "bob.resolve_decode", "pa.host_total", "host.affine_for",
               "host.prng_derive"}


def _originals() -> dict:
    out = {(owner, attr): getattr(owner, attr)
           for owner, attr, _ in profiling._host_timers(tpipe, prng)}
    out[(tpipe._Party, "programs")] = tpipe._Party.programs
    return out


def test_programs_small_config():
    cfg = tpipe.PipelineConfig(**SMALL)
    out = profiling.programs("cpu", reps=1, cfg=cfg)
    for name in profiling.PROGRAMS:
        assert out[name] > 0, name
        assert out["device_ms"][name] is None
        assert out["launches"][name] is None
        assert out["bp_launches"][name] == {"bp_layered": 0,
                                            "bp_flooding": 0}
    # The rung, shortening, test bits and payload of the reference's Bob.
    qa, qb = collections.deque(), collections.deque()
    jbob = jpipe.BobSession(jpipe.PipelineConfig(**SMALL), 0x5E55,
                            JLink(qb, qa))
    jbob.qest.update_prior(0.03 * 1e6, 1e6)
    _, r, s, k_pb = jbob._choose()
    assert (out["rung"], out["short_bits"], out["k_pb"], out["B"]) == (
        r, s, k_pb, 8)
    assert out["P"] == jbob.payload_per_block(r)
    assert {"cpu", "start", "end"} <= out["host"].keys()


@pytest.mark.parametrize("serial", [False, True])
def test_full_chain_small_config(serial):
    before = _originals()
    out = profiling.full_chain("cpu", windows=2, warmup=2, serial=serial,
                               cfg=tpipe.PipelineConfig(**SMALL),
                               chunk_bits=1 << 14)
    assert CHAIN_KEYS <= out.keys()
    assert out["mode"] == ("serial" if serial else "pipelined")
    assert out["windows"] == 2
    assert sum(out["mix"]["rungs"].values()) == 2
    assert out["mix"]["iters_mean"] > 0
    assert out["window_ms"] > 0 and out["sifted_bits_per_s"] > 0
    assert TIMER_NAMES <= out["phases"].keys()
    dev_timers = {n for n in out["phases"] if n.startswith("dev.")}
    if serial:
        assert {"dev.alice_program[a]", "dev.bob_program[b]",
                "dev.pa[a]", "dev.pa[b]"} <= dev_timers
    else:
        assert not dev_timers
    assert out["trace"] is None
    assert {"cpu", "cores_usable", "start", "end"} <= out["host"].keys()
    assert _originals() == before


def test_full_chain_restores_methods_when_it_fails(monkeypatch):
    before = _originals()

    def fail(self):
        raise RuntimeError("injected")

    monkeypatch.setattr(tpipe.BobSession, "_choose", fail)
    with pytest.raises(RuntimeError, match="injected"):
        profiling.full_chain("cpu", windows=1, warmup=1, serial=True,
                             cfg=tpipe.PipelineConfig(**SMALL),
                             chunk_bits=1 << 14)
    assert _originals() == before


def test_trace_busy_is_the_union_of_kernel_intervals():
    tr = profiling._Trace(True)
    tr.kernels = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("a", 20.0, 21.0),
                  ("c", 11.0, 11.5)]
    tr.copies = [(12.0, 13.0), (30.0, 32.0)]
    assert tr.busy_ms() == pytest.approx(13e-3)
    assert tr.kernel_ms() == pytest.approx(18.5e-3)
    assert tr.copy_ms() == pytest.approx(3e-3)
    assert [(k["name"], k["launches"]) for k in tr.top(2)] == [("a", 2),
                                                               ("b", 1)]
    # A region counts what started inside it.
    tr.regions["calls"] = (4.0, 20.5)
    part = tr.part("calls")
    assert part.kernels == [("b", 5.0, 12.0), ("a", 20.0, 21.0),
                            ("c", 11.0, 11.5)]
    assert part.copies == [(12.0, 13.0)]


def test_device_trace_on_the_cpu_traces_nothing():
    with profiling.device_trace(torch.device("cpu")) as tr:
        with tr.region("calls"):
            torch.ones(4).sum()
    assert tr.kernels is None and not tr.tracing and not tr.regions


@pytest.mark.parametrize("argv", [["programs"], ["chain", "2"]])
def test_cli_needs_cuda_unless_told_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        profiling.main(argv)
