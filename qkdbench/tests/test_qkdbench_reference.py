"""The plain reference against the program's CPU path at a small size, and
the benchmark's inputs: the same seed gives the same inputs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from qkdbench import generators
from qkdbench.reference import codes, keys, minsum, session_check
from qkdbench.tests.tiny import REPO


def test_regular_code_equals_the_programs():
    from qtpu_torch.ldpc.codes import make_regular_code
    for n in (1024, 4096):
        ours, theirs = codes.make_regular_code(n), make_regular_code(n)
        for f in ("edge_row", "edge_col", "edge_shift", "row_edges"):
            assert np.array_equal(getattr(ours, f), getattr(theirs, f))


def test_syndromes_are_the_parity_checks():
    from qtpu_torch.ldpc.codes import make_regular_code
    c = codes.make_regular_code(1024)
    H = make_regular_code(1024).to_dense().astype(np.int64)
    w = torch.randint(0, 2, (5, 1024), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    want = (w.numpy().astype(np.int64) @ H.T) % 2
    assert np.array_equal(codes.syndromes(c, w).numpy(), want)


@pytest.mark.parametrize("qber", [0.02, 0.06])
def test_minsum_equals_the_programs_plain_decoder(qber):
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.ldpc.decode import make_batch_decoder
    c = codes.make_regular_code(1024)
    g = generators.generator(11, "cpu")
    words, rx = generators.bsc_words(g, qber, 16, 1024, "cpu")
    llr, syn = generators.llr(rx, qber), codes.syndromes(c, words)
    res = make_batch_decoder(make_regular_code(1024), 30, alg="layered")(
        llr, syn)
    bits, conv, iters = minsum.layered_decode(c, llr, syn, 30)
    assert torch.equal(bits, res.bits)
    assert torch.equal(conv, res.converged)
    assert torch.equal(iters, res.iterations)


def test_block_key_equals_the_programs_pa():
    from qtpu_torch import prng
    from qtpu_torch import random as tr
    from qtpu_torch.pa import _toeplitz_hash
    seed, w, n, l_max = (1 << 31) + 5, 17, 900, 640
    kd = prng.key_data(prng.derive(prng.root_key(seed), "pa", w, 0))
    assert np.array_equal(kd, keys.pa_key(seed, w))
    t = tr.seed_rows_at_plain(kd, (), range(4), n + l_max - 1, "cpu")
    x = torch.randint(0, 2, (4, n), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(2))
    want = _toeplitz_hash(t, x, l_max).numpy()
    for b in range(4):
        got = keys.block_key(seed, w, b, x[b].numpy(), l_max, 500)
        assert np.array_equal(got, want[b, :500])


def test_toeplitz_equals_the_direct_product():
    from qtpu_torch.pa import toeplitz_hash_golden
    rng = np.random.default_rng(4)
    t = rng.integers(0, 2, 60 + 40 - 1).astype(np.uint8)
    x = rng.integers(0, 2, 60).astype(np.uint8)
    assert np.array_equal(keys.toeplitz(t, x, 40),
                          toeplitz_hash_golden(t, x, 40))


def test_rungs_equal_the_programs_ladder():
    from qtpu_torch.pipeline import AliceSession
    from qtpu_torch.link import make_direct_pair
    from qkdbench.traffic.session import _pipeline_config
    cfg = json.loads((REPO / "qkdbench/configs/prod65k.json").read_text())
    cfg["pipeline"]["n"] = 2048
    alice = AliceSession(_pipeline_config(cfg["pipeline"]), 1,
                         make_direct_pair()[0], device="cpu")
    for r, rung in enumerate(session_check.rungs(cfg)):
        step = alice.ladder.steps[r]
        assert rung.payload == alice.payload_per_block(r)
        assert rung.leaked == step.leaked_bits()
        assert rung.l_max == alice.programs(r).l_max


def test_inputs_follow_the_seed():
    a1, b1 = generators.bsc_pool(123456789012, 0.03, 1 << 16, "cpu")
    a2, b2 = generators.bsc_pool(123456789012, 0.03, 1 << 16, "cpu")
    a3, _ = generators.bsc_pool(123456789013, 0.03, 1 << 16, "cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)
    flips = float((a1 ^ b1).float().mean())
    assert 0.02 < flips < 0.04
    g1, g2 = (generators.generator(2 ** 40 + 3, "cpu") for _ in range(2))
    w1, r1 = generators.bsc_words(g1, 0.05, 4, 256, "cpu")
    w2, r2 = generators.bsc_words(g2, 0.05, 4, 256, "cpu")
    assert torch.equal(w1, w2) and torch.equal(r1, r2)
    llr = generators.llr(r1, 0.05)
    mag = np.float32(np.log(0.95 / 0.05))
    assert torch.equal(llr.abs(), torch.full_like(llr, float(mag)))
    assert torch.equal(llr < 0, r1.bool())
