"""Toeplitz privacy amplification: qtpu_torch.pa vs qtpu.pa and golden.

The cases of tests/test_pa.py and the single-device cases of
tests/test_stream_pa.py, run on the port (CPU tensors) with the same numpy
inputs; each result must equal the reference's and the direct GF(2)
mat-vec.  Then a layered stream-PA session (pa_mode="stream") on both
packages: final keys, key index, ledgers and per-window metrics must be
identical.  Tolerance: exact everywhere (the float margins are checked
< 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qtpu.pipeline as jpipe
import qtpu_torch.pipeline as tpipe
from qtpu import pa as jpa
from qtpu_torch import pa


@pytest.fixture(scope="module", autouse=True)
def settled_reference_flush():
    orig = jpipe.BobSession.flush

    def flush(self, block=True, limit=0):
        for w in self._pending:
            st = self._inflight.get(w)
            if st is not None and "stats_dev" in st:
                jax.block_until_ready(st["stats_dev"])
        return orig(self, block, limit)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.BobSession, "flush", flush)
        yield


def _bits(rng, *shape):
    return rng.integers(0, 2, shape).astype(np.uint8)


@pytest.mark.parametrize("n,m", [(64, 32), (1000, 300), (4096, 2048), (8192, 1500)])
def test_fft_matches_direct(n, m):
    rng = np.random.default_rng(n + m)
    t, x = _bits(rng, m + n - 1), _bits(rng, n)
    want = pa.toeplitz_hash_golden(t, x, m)
    np.testing.assert_array_equal(want, jpa.toeplitz_hash_golden(t, x, m))
    got = pa.toeplitz_hash_fft(torch.from_numpy(t),
                               torch.from_numpy(x[None]), m).numpy()[0]
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jpa.toeplitz_hash_fft(jnp.asarray(t), jnp.asarray(x[None]),
                                           m))[0]
    np.testing.assert_array_equal(got, ref)


def test_batched_per_block_seeds():
    rng = np.random.default_rng(5)
    n, m, B = 2048, 900, 4
    t, x = _bits(rng, B, m + n - 1), _bits(rng, B, n)
    got = pa.make_toeplitz_hasher(n, m)(torch.from_numpy(t),
                                        torch.from_numpy(x)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b], pa.toeplitz_hash_golden(t[b], x[b], m))
    # One seed broadcast over the batch.
    one = pa.toeplitz_hash_fft(torch.from_numpy(t[0]), torch.from_numpy(x),
                               m).numpy()
    np.testing.assert_array_equal(
        one, np.asarray(jpa.toeplitz_hash_fft(jnp.asarray(t[0]),
                                              jnp.asarray(x), m)))


def test_linearity():
    """Toeplitz hashing is GF(2)-linear: T(x^y) = T(x)^T(y)."""
    rng = np.random.default_rng(9)
    n, m = 1024, 512
    t, x, y = _bits(rng, m + n - 1), _bits(rng, n), _bits(rng, n)

    def h(v):
        return pa.toeplitz_hash_fft(torch.from_numpy(t), torch.from_numpy(v),
                                    m).numpy()[0]
    np.testing.assert_array_equal(h(x) ^ h(y), h(x ^ y))


def test_window_program_hash_exact_at_production_shape():
    """tests/test_pa.py's production-shape pin on the port's in-program
    hash: P=63488, l_max=47104 (conv length 2^17) — exact integer spot
    checks, full equality with a float64 FFT, float32 margin < 0.25."""
    from qtpu_torch.pa import _toeplitz_hash, toeplitz_margin
    P, m, rows = 63488, 47104, 2
    rng = np.random.default_rng(42)
    t, x = _bits(rng, rows, m + P - 1), _bits(rng, rows, P)
    got = _toeplitz_hash(torch.from_numpy(t), torch.from_numpy(x), m).numpy()
    assert got.shape == (rows, m)
    t64, x64 = t.astype(np.int64), x.astype(np.int64)
    for j in rng.integers(0, m, 64):
        j = int(j)
        for b in range(rows):
            want = int(np.dot(t64[b, j: j + P][::-1], x64[b])) & 1
            assert got[b, j] == want, (b, j)
    exact = _toeplitz_hash(torch.from_numpy(t), torch.from_numpy(x), m,
                           torch.float64).numpy()
    np.testing.assert_array_equal(got, exact)
    assert toeplitz_margin(t, x, m) < 0.25


def test_final_key_length():
    assert pa.final_key_length(4096, 1280, 256, 50, 64) == 4096 - 1280 - 256 - 50 - 64
    assert pa.final_key_length(100, 90, 20, 50, 64) == 0


@pytest.mark.parametrize("N,m,seg", [(2048, 300, 512), (1024, 77, 1024),
                                     (4096, 513, 256)])
def test_stream_toeplitz_matches_golden_and_reference(N, m, seg):
    """Segment-boundary-crossing offsets (several segments), one segment,
    odd m; float32 and float64 give the golden product."""
    rng = np.random.default_rng(N + m)
    x, t = _bits(rng, N), _bits(rng, m + N - 1)
    want = pa.toeplitz_hash_golden(t, x, m)
    ref = np.asarray(jpa.stream_toeplitz(jnp.asarray(t), jnp.asarray(x), m,
                                         segment=seg))
    np.testing.assert_array_equal(ref, want)
    tt, xx = torch.from_numpy(t), torch.from_numpy(x)
    for precision in (torch.float32, torch.float64):
        got = pa.stream_toeplitz(tt, xx, m, segment=seg,
                                 precision=precision).numpy()
        np.testing.assert_array_equal(got, want)
        assert pa.stream_margin(tt, xx, m, segment=seg,
                                precision=precision) < 0.25


def _cpu(mod):
    """``device="cpu"`` for the port's entry points (the reference's take
    no device)."""
    return {"device": "cpu"} if mod.__name__.startswith("qtpu_torch") else {}


def _run_stream(mod, seed=3, **kw):
    rng = np.random.default_rng(seed)
    total = 60_000
    a_bits = rng.integers(0, 2, total).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(total) < 0.02).astype(np.uint8)
    cfg = mod.PipelineConfig(n=1024, blocks_per_window=8, qber_test_bits=512,
                             pa_mode="stream", pa_stream_windows=2,
                             max_inflight_windows=1, **kw)
    return mod.run_loopback(cfg, a_bits, b_bits, session_seed=11, wire=True,
                            **_cpu(mod))


def test_session_stream_pa_matches_reference():
    ja, jb = _run_stream(jpipe)
    ta, tb = _run_stream(tpipe)
    key = ta.final_key_bits()
    assert key.size > 0, "stream flushes must emit key"
    assert ta._stream_flushes >= 2
    for other in (tb, ja, jb):
        np.testing.assert_array_equal(other.final_key_bits(), key)
    assert (ta.final_key_index == tb.final_key_index == ja.final_key_index
            == jb.final_key_index)
    assert all(b < 0 for _, b in ta.final_key_index)
    assert (ta.ledger.as_dict() == tb.ledger.as_dict() == ja.ledger.as_dict()
            == jb.ledger.as_dict())
    assert ta.ledger.final_bits == key.size
    assert [m.as_dict() for m in tb.metrics] == [m.as_dict() for m in jb.metrics]
