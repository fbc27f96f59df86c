"""The check refuses what it must: each cell run on the CPU at a small
size, with the card's look skipped and the timed path broken underneath,
prints a result whose ``correct`` is false; the same run unbroken prints
``correct`` true.  The controls are the plain reference put in the
program's place in the nearest precision below the configuration's
(bfloat16 for float32): the layered min-sum with bfloat16 messages in the
decode cell, the PA hash with bfloat16 spectra in the session cell."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from qkdbench import control, run
from qkdbench.reference import keys as ref_keys
from qkdbench.tests.tiny import DECODE, SESSION, tiny_copy

SEED = (1 << 31) + 977


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def _result(tiny, cell, capsys, seconds=2.0):
    bench, root = tiny
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", "0"], bench_path=bench,
                  root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [SESSION, DECODE])
def test_sound_run_is_correct(tiny, cell, capsys):
    res = _result(tiny, cell, capsys)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _hard_decision(code, *a, **k):
    """A decoder that returns its input unchanged: the channel's hard
    decision, unconverged."""
    from qtpu_torch.ldpc.decode import BatchDecodeResult

    def decode(llr, syndrome):
        B = llr.shape[0]
        return BatchDecodeResult(
            (llr < 0).to(torch.uint8),
            torch.zeros(B, dtype=torch.bool, device=llr.device),
            torch.zeros(B, dtype=torch.int32, device=llr.device))
    return decode


def _wrap_decoder(make, alter):
    def make_batch_decoder(code, *a, **k):
        dec = make(code, *a, **k)

        def decode(llr, syndrome):
            return alter(dec(llr, syndrome))
        return decode
    return make_batch_decoder


def _half_batch(res):
    """Half of the batch left out: the second half's outputs are zeros."""
    from qtpu_torch.ldpc.decode import BatchDecodeResult
    h = res.bits.shape[0] // 2
    bits, conv, it = res.bits.clone(), res.converged.clone(), \
        res.iterations.clone()
    bits[h:] = 0
    conv[h:] = conv[:h].all()
    it[h:] = it[:h].float().mean().round().to(torch.int32)
    return BatchDecodeResult(bits, conv, it)


def _one_bit(res):
    """An answer altered where it is produced: one decoded bit flipped."""
    from qtpu_torch.ldpc.decode import BatchDecodeResult
    bits = res.bits.clone()
    bits[0, 0] ^= 1
    return BatchDecodeResult(bits, res.converged, res.iterations)


def _decode_fault(name):
    import qtpu_torch.ldpc.decode as d
    return {"state_unchanged": _hard_decision,
            "half_batch": _wrap_decoder(d.make_batch_decoder, _half_batch),
            "answer_altered": _wrap_decoder(d.make_batch_decoder, _one_bit),
            "control_bfloat16": control.decoder_bf16}[name]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "control_bfloat16"])
def test_decode_cell_refuses(tiny, fault, capsys, monkeypatch):
    import qtpu_torch.ldpc.decode as d
    monkeypatch.setattr(d, "make_batch_decoder", _decode_fault(fault))
    res = _result(tiny, DECODE, capsys)
    assert res["correct"] is False
    assert res["checks"]["blocks_differ"]["value"] > 0


def _key_bit_flipped(hash_fn):
    def toeplitz_hash(t, x, m, *a, **k):
        out = hash_fn(t, x, m, *a, **k).clone()
        out[:, 0] ^= 1
        return out
    return toeplitz_hash


def _iterations_altered(res):
    """A decode's answer altered where it is produced: one block's
    iteration count off by one (its bits, and so its key, unchanged)."""
    from qtpu_torch.ldpc.decode import BatchDecodeResult
    it = res.iterations.clone()
    it[0] += 1
    return BatchDecodeResult(res.bits, res.converged, it)


@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged",
                                   "control_bfloat16", "decode_altered"])
def test_session_cell_refuses(tiny, fault, capsys, monkeypatch):
    import qtpu_torch.window_programs as wp
    if fault == "answer_altered":
        monkeypatch.setattr(wp, "_toeplitz_hash",
                            _key_bit_flipped(wp._toeplitz_hash))
    elif fault == "control_bfloat16":
        monkeypatch.setattr(wp, "_toeplitz_hash", control.toeplitz_bf16)
        monkeypatch.setattr(wp, "make_batch_decoder", control.decoder_bf16)
    elif fault == "decode_altered":
        monkeypatch.setattr(wp, "make_batch_decoder", _wrap_decoder(
            wp.make_batch_decoder, _iterations_altered))
    else:
        monkeypatch.setattr(wp, "make_batch_decoder", _hard_decision)
    res = _result(tiny, SESSION, capsys)
    assert res["correct"] is False
    failing = [k for k, v in res["checks"].items()
               if not (v["value"] <= v["limit"] if v["op"] == "<="
                       else v["value"] >= v["limit"])]
    assert failing
    if fault == "decode_altered":
        assert failing == ["decode_blocks_differ"]


def _session_raises(tiny, match, trace=0):
    bench, root = tiny
    with pytest.raises(RuntimeError, match=match):
        run.main(["--workload", SESSION, "--seed", str(SEED), "--seconds",
                  "1", "--trace", str(trace)], bench_path=bench, root=root,
                 require_card=False)


def test_session_refuses_a_renamed_key_list(tiny, monkeypatch):
    """Where the program's key list has another name, emptying it would
    empty nothing: the run raises before it starts."""
    import qtpu_torch.pipeline as pl
    init = pl.BobSession.__init__

    def renamed(self, *a, **k):
        init(self, *a, **k)
        self._final_keys = self.__dict__.pop("_final_host")
    monkeypatch.setattr(pl.BobSession, "__init__", renamed)
    _session_raises(tiny, "no longer has _final_host")


def test_session_refuses_a_pull_that_returns_old_keys(tiny, monkeypatch):
    """Where emptying the key lists no longer empties them, a later pull
    returns keys an earlier one had: the run raises."""
    import qtpu_torch.keystore as ks
    given = {}
    pull = ks.records_from_session

    def cumulative(session):
        given.setdefault(id(session), []).extend(pull(session))
        return list(given[id(session)])
    monkeypatch.setattr(ks, "records_from_session", cumulative)
    _session_raises(tiny, "came back in a later pull")


def test_traced_session_refuses_a_hook_that_sees_no_call(tiny, monkeypatch):
    """Where the programs' PA no longer goes through the wrapped ``pa``,
    the traced run raises instead of leaving its roofline out."""
    import qtpu_torch.pipeline as pl
    make = pl.make_window_programs

    def unwrappable(*a, **k):
        progs = make(*a, **k)
        pinned = type("Pinned", (type(progs),),
                      {"_replace": lambda self, **kw: self})
        return pinned(*progs)
    monkeypatch.setattr(pl, "make_window_programs", unwrappable)
    _session_raises(tiny, "saw no call to the programs' pa", trace=1)


def test_control_pa_is_the_references_bfloat16_product():
    """The PA control is the float64 reference's product with its spectra
    rounded to bfloat16: exact where bfloat16 holds the sums (one-hot
    inputs, whose convolution is one shifted 1), and wrong in a large
    share of each row's bits at a production block's size (a payload of
    61,440 bits hashed to 40,000), where the sums run to the tens of
    thousands, past bfloat16's 8 significant bits."""
    n, m = 700, 500
    t = np.zeros((3, n + m - 1), np.uint8)
    x = np.zeros((3, n), np.uint8)
    for i, (a, b) in enumerate([(0, 0), (600, 17), (1198, 699)]):
        t[i, a], x[i, b] = 1, 1
    got = control.toeplitz_bf16(torch.from_numpy(t), torch.from_numpy(x), m)
    for i in range(3):
        assert np.array_equal(got[i].numpy(), ref_keys.toeplitz(t[i], x[i], m))
    n, m = 61440, 40000
    rng = np.random.default_rng(8)
    t = rng.integers(0, 2, (2, n + m - 1)).astype(np.uint8)
    x = rng.integers(0, 2, (2, n)).astype(np.uint8)
    got = control.toeplitz_bf16(torch.from_numpy(t), torch.from_numpy(x), m)
    for i in range(2):
        wrong = np.mean(got[i].numpy() != ref_keys.toeplitz(t[i], x[i], m))
        assert wrong > 0.25
