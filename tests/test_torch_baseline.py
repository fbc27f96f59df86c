"""qtpu_torch.baseline's BASELINE configs 1-3 and the reference's decoder
API names (``make_batch_decoder``, ``encode_syndrome_batch``) against the
reference, on the CPU.

Each port function takes the same numpy inputs as the reference script
(``benchmarks/config1_smoke.py``, ``config2_batch.py``,
``config3_rate_adaptive.py``) at a small size; the efficiency sweep and
config 5 are in tests/test_torch_baseline_sessions.py.  Tolerance: exact, with
two exceptions the reference's CPU decoders force (ROADMAP.md §3): the
min-sum decoders are held to the reference on blocks it converges and to
``qtpu_torch.ldpc.golden`` on the rest (XLA's float arithmetic departs
from golden on blocks that never converge), and on punctured rungs XLA's flooding decoder reports up
to one iteration fewer than the port on some blocks, so config 3's mean
iterations there agree within 1.  Times are not compared.
"""

import functools
import json
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.ldpc import calibrate as jcal
from qtpu.ldpc import codes as jcodes
from qtpu.ldpc import decode as jdecode
from qtpu.ldpc import encode as jencode
from qtpu_torch import baseline
from qtpu_torch.ldpc import golden
from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
from qtpu_torch.ldpc.decode import make_batch_decoder
from qtpu_torch.ldpc.encode import encode_syndrome_batch

ROOT = Path(__file__).resolve().parent.parent


@functools.cache
def _jdecoder(alg: str, max_iters: int):
    """The reference's decoder (one compile per schedule and limit)."""
    return jdecode.make_batch_decoder(jcodes.make_regular_code(1024),
                                      max_iters=max_iters, alg=alg)


def _held_to_reference(code, llr, syn, got, ref, alg="layered"):
    """Port decode ``got`` against the reference's ``ref`` (numpy triples
    bits, converged, iterations) of a min-sum schedule: equal on the
    blocks the reference converges, equal to the port's golden model on
    the rest.  Returns the reference's (converged, iterations) with golden
    in place of the blocks it did not converge."""
    bits, conv, iters = got
    ok = ref[1]
    np.testing.assert_array_equal(bits[ok], ref[0][ok])
    np.testing.assert_array_equal(conv[ok], ref[1][ok])
    np.testing.assert_array_equal(iters[ok], ref[2][ok])
    want_conv, want_iters = ref[1].copy(), ref[2].copy()
    for b in np.flatnonzero(~ok):
        g = golden.decode(code, llr[b], syn[b], max_iters=60, alg=alg)
        np.testing.assert_array_equal(g.bits.reshape(-1), bits[b])
        assert (g.iterations, g.converged) == (iters[b], conv[b])
        want_conv[b], want_iters[b] = g.converged, g.iterations
    return want_conv, want_iters


def test_config1_matches_reference(capsys):
    runpy.run_path(str(ROOT / "benchmarks" / "config1_smoke.py"))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = baseline.config1()
    assert got.keys() == want.keys()
    for k in want.keys() - {"decode_s"}:
        assert got[k] == want[k], k
    assert got["converged"] and got["key_exact"]


def test_config2_matches_reference():
    """config2(n = 1024, B = 16, one timed call) against the reference's
    computation on the same default_rng(0) draws: the reference's encoder,
    channel LLRs and layered decoder (60 iterations)."""
    B = 16
    got = baseline.config2(device="cpu", n=1024, batch=B, reps=1)
    assert got["config"] == 2 and got["batch"] == B
    code, jcode = make_regular_code(1024), jcodes.make_regular_code(1024)
    enc, jdec = jencode.make_batch_encoder(jcode), _jdecoder("layered", 60)
    port_dec = make_batch_decoder(code, max_iters=60, alg="layered")
    inputs = baseline.config2_inputs(code, B, "cpu")
    rng = np.random.default_rng(0)
    assert [row["qber"] for row in got["sweep"]] == list(
        baseline.CONFIG2_QBERS)
    for row, (q, llr, syn) in zip(got["sweep"], inputs):
        keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
        bob = keys ^ (rng.random((B, code.n)) < q).astype(np.uint8)
        jsyn = np.asarray(enc(jnp.asarray(keys)))
        jllr = np.asarray(jdecode.channel_llr(jnp.asarray(bob), q))
        np.testing.assert_array_equal(syn.numpy(), jsyn)
        np.testing.assert_array_equal(llr.numpy(), jllr)
        ref = tuple(np.asarray(x) for x in jdec(jnp.asarray(jllr),
                                                jnp.asarray(jsyn)))
        res = port_dec(llr, syn)
        conv, iters = _held_to_reference(
            code, jllr, jsyn, (res.bits.numpy(), res.converged.numpy(),
                               res.iterations.numpy()), ref)
        assert row["fer"] == 1.0 - float(conv.mean())
        assert row["iters_mean"] == round(float(iters.mean()), 2)
        assert row["iters_p99"] == int(np.percentile(iters, 99))
        assert row["iters_sum"] == int(iters.sum())
        assert row["launches"] == {"bp_layered": 0, "bp_flooding": 0}
        assert row["ms"] > 0 and row["gbit_s"] >= 0


def test_config3_matches_reference():
    """Every rung of the n = 1024 mixed ladder at its ceiling, 32 blocks:
    the reference's ``measure_fer`` on the same seeds."""
    got = baseline.config3(device="cpu", n=1024, blocks=32)
    ladder, jladder = make_rate_ladder(1024), jcodes.make_rate_ladder(1024)
    assert len(got["rungs"]) == len(ladder.steps) == 5
    punctured = 0
    for idx, (row, jstep) in enumerate(zip(got["rungs"], jladder.steps)):
        q = jladder.max_qber[idx]
        fer, iters = jcal.measure_fer(jstep, q, blocks=32, seed=idx)
        assert row == {**row, "rung": jstep.name, "qber": q,
                       "rate_eff": round(jstep.effective_rate(), 4),
                       "fer": round(fer, 4),
                       "leak_per_payload": round(jstep.leaked_bits()
                                                 / jstep.payload_bits(), 4)}
        if jstep.punct_cols:
            punctured += 1
            assert abs(row["iters_mean"] - round(iters, 1)) <= 1.0
        else:
            assert row["iters_mean"] == round(iters, 1)
    assert punctured > 0


@pytest.mark.parametrize("alg", ["layered", "minsum", "sumprod"])
def test_make_batch_decoder_matches_reference(alg):
    """The reference's name and signature: both min-sum schedules on the
    blocks the reference converges (golden on the rest: after 60 rounds
    XLA's flooding decoder too departs from golden on a block that never
    converges), converged blocks' bits and flags for sum-product
    (tanh/atanh differ in the last bit between the libraries)."""
    code = make_regular_code(1024)
    rng = np.random.default_rng(5)
    qbers = np.repeat([0.01, 0.03, 0.05, 0.09], 4)
    keys = rng.integers(0, 2, (16, code.n)).astype(np.uint8)
    noise = (rng.random((16, code.n)) < qbers[:, None]).astype(np.uint8)
    syn = encode_syndrome_batch(code, keys)
    np.testing.assert_array_equal(
        syn, jencode.encode_syndrome_batch(jcodes.make_regular_code(1024),
                                           keys))
    llr = np.array(jdecode.channel_llr(jnp.asarray(keys ^ noise), 0.03))
    res = make_batch_decoder(code, max_iters=60, alg=alg)(
        torch.from_numpy(llr), torch.from_numpy(syn))
    got = (res.bits.numpy(), res.converged.numpy(), res.iterations.numpy())
    ref = tuple(np.asarray(x) for x in _jdecoder(alg, 60)(jnp.asarray(llr),
                                                          jnp.asarray(syn)))
    assert got[1].any() and not got[1].all()
    if alg != "sumprod":
        _held_to_reference(code, llr, syn, got, ref, alg)
    else:
        ok = ref[1]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[0][ok], ref[0][ok])


def test_cli_prints_config1(capsys):
    assert baseline.main(["config1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["config"] == 1
    assert out["launches"] == {"bp_layered": 0, "bp_flooding": 0}


@pytest.mark.parametrize("argv", [["config2"], ["config3"], ["config5"],
                                  ["efficiency", "production"]])
def test_cli_needs_cuda_unless_told_cpu(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        baseline.main(argv)


def test_fer_inputs_are_measure_fers_batch():
    """``fer_inputs`` (the batch phase 18 holds the kernels to) on a
    punctured rung with pinned payload bits: punctured columns at LLR 0,
    ``extra_short_bits`` pins a block at +-BIG with the codeword's sign,
    the codeword's syndromes, and ``measure_fer`` == the reference's on
    the same seed."""
    from qtpu_torch.ldpc.calibrate import fer_inputs, measure_fer
    from qtpu_torch.ldpc.decode import BIG_LLR
    ladder, jladder = make_rate_ladder(1024), jcodes.make_rate_ladder(1024)
    idx = next(i for i, s in enumerate(ladder.steps) if s.punct_cols)
    step, q, pins = ladder.steps[idx], ladder.max_qber[idx], 64
    x, llr, syn, pay = fer_inputs(step, q, 8, seed=3, extra_short_bits=pins,
                                  device="cpu")
    z = step.code.z
    for c in step.punct_cols:
        assert not llr[:, c * z:(c + 1) * z].any()
    big = llr.abs() == BIG_LLR
    assert (big.sum(dim=1) == pins).all()
    assert torch.equal(llr[big] < 0, x[big].bool())
    assert pay.size == step.payload_bits() - pins
    np.testing.assert_array_equal(
        syn.numpy(), encode_syndrome_batch(step.code, x.numpy()))
    got = measure_fer(step, q, blocks=8, seed=3, extra_short_bits=pins,
                      device="cpu")
    want = jcal.measure_fer(jladder.steps[idx], q, blocks=8, seed=3,
                            extra_short_bits=pins)
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 1.0


def test_entry_device_for_the_commands():
    from qtpu_torch.devices import device_name, entry_device
    assert entry_device("qtpu_torch.baseline", "cpu") == torch.device("cpu")
    assert device_name(torch.device("cpu")) == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="qtpu_torch.baseline: --device "
                       "cuda: CUDA is not available"):
        entry_device("qtpu_torch.baseline", "cuda")
