"""qtpu_torch.sift vs qtpu.sift on the same detector events.

Events come from ``qtpu.channel.EntangledPairSource`` with a numpy seed and
go through both packages on the CPU.  Tolerance: exact for the pfind
offset, the matched / bob_index / basis_ok / bob_bits outputs, the frame
matcher's outputs including its final offset, the sift_outputs rows and
counts, and splice; 1e-5 relative for the servo residuals (float32 means
whose sums the port takes exactly in integers).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qtpu import sift as jsift
from qtpu.channel import EntangledPairSource
from qtpu.framing import TIME_UNITS_PER_NS
from qtpu_torch import sift as tsift

SPAN = int(0.05 * 1e9 * TIME_UNITS_PER_NS)


def _frame(ev):
    """(times_a, basis_a, times_b, basis_b, bits_b) numpy arrays of one
    simulation window, rebased to int32 device times."""
    wa, wb = ev.alice, ev.bob
    det_a = wa.detectors.astype(np.int32)
    det_b = wb.detectors.astype(np.int32)
    return (jsift.rebase_times(wa.times, 0), (det_a >> 1).astype(np.uint8),
            jsift.rebase_times(wb.times, 0), (det_b >> 1).astype(np.uint8),
            (det_b & 1).astype(np.uint8))


@pytest.fixture(scope="module")
def events():
    """tests/test_sift.py's source."""
    src = EntangledPairSource(pair_rate_hz=40_000, window_s=0.05,
                              offset_ns=9_876.25, dark_rate_hz=1_000)
    return src.generate(np.random.default_rng(123))


@pytest.fixture(scope="module")
def frames():
    """Three windows of a faster source, padded to one capacity (the
    chain's batched layout)."""
    src = EntangledPairSource(pair_rate_hz=300_000, window_s=0.05,
                              offset_ns=4_321.0, error_rate=0.025,
                              dark_rate_hz=20_000)
    rng = np.random.default_rng(5)
    raw = [_frame(src.generate(rng, start_epoch=w)) for w in range(3)]
    na = 1 << int(np.ceil(np.log2(max(len(f[0]) for f in raw))))
    nb = 1 << int(np.ceil(np.log2(max(len(f[2]) for f in raw))))
    out = [np.full((3, na), jsift.DEVICE_PAD, np.int32),
           np.zeros((3, na), np.uint8),
           np.full((3, nb), jsift.DEVICE_PAD, np.int32),
           np.zeros((3, nb), np.uint8), np.zeros((3, nb), np.uint8)]
    for i, f in enumerate(raw):
        for arr, v in zip(out, f):
            arr[i, :len(v)] = v
    return out, int(round(4_321.0 * TIME_UNITS_PER_NS))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bins", [1 << 18, 1 << 20])
def test_pfind_matches_reference(events, bins):
    ta, _, tb, _, _ = _frame(events)
    ref = int(jsift.pfind(jnp.asarray(ta), jnp.asarray(tb), SPAN,
                          num_bins=bins))
    got = tsift.pfind(torch.from_numpy(ta), torch.from_numpy(tb), SPAN,
                      num_bins=bins)
    assert got.dtype == torch.int32 and int(got) == ref
    assert abs(ref - events.true_offset_units) < 50
    coarse = int(jsift.pfind(jnp.asarray(ta), jnp.asarray(tb), SPAN,
                             num_bins=bins, refine=False))
    assert int(tsift.pfind(torch.from_numpy(ta), torch.from_numpy(tb), SPAN,
                           num_bins=bins, refine=False)) == coarse


def test_pfind_matches_reference_high_rate(frames):
    (ta, _, tb, _, _), true = frames
    ref = int(jsift.pfind(jnp.asarray(ta[0]), jnp.asarray(tb[0]), SPAN,
                          num_bins=1 << 18))
    got = int(tsift.pfind(torch.from_numpy(ta[0]), torch.from_numpy(tb[0]),
                          SPAN, num_bins=1 << 18))
    assert got == ref and abs(got - true) < 50


def _assert_match_same(ref, got):
    _eq(ref.matched, got.matched)
    _eq(ref.bob_index, got.bob_index)
    _eq(ref.basis_ok, got.basis_ok)
    _eq(ref.bob_bits, got.bob_bits)
    np.testing.assert_allclose(float(got.residual), float(ref.residual),
                               rtol=1e-5)


@pytest.mark.parametrize("delta,window", [(0, 40), (-200, 400)])
def test_coincidence_match_matches_reference(events, delta, window):
    arrs = _frame(events)
    off = events.true_offset_units + delta
    ref = jsift.coincidence_match(*map(jnp.asarray, arrs), jnp.int32(off),
                                  window=window)
    got = tsift.coincidence_match(*map(torch.from_numpy, arrs),
                                  torch.tensor(off, dtype=torch.int32),
                                  window=window)
    _assert_match_same(ref, got)
    assert got.matched.sum() > 1000


def test_frame_matcher_and_outputs_match_reference(frames):
    arrs, true = frames
    ref = jsift.make_frame_matcher(3, 40)(*map(jnp.asarray, arrs),
                                          jnp.int32(true - 30))
    got = tsift.make_frame_matcher(3, 40)(*map(torch.from_numpy, arrs),
                                          true - 30)
    _eq(ref.sift_mask, got.sift_mask)
    _eq(ref.bob_bits, got.bob_bits)
    _eq(ref.matched_counts, got.matched_counts)
    _eq(ref.sifted_counts, got.sifted_counts)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-5)
    assert int(got.final_offset) == int(ref.final_offset)
    assert got.final_offset.dtype == torch.int32
    r_idx, r_cnt, r_bits = jsift.sift_outputs(ref.sift_mask, ref.bob_bits)
    g_idx, g_cnt, g_bits = tsift.sift_outputs(got.sift_mask, got.bob_bits)
    _eq(r_idx, g_idx)
    _eq(r_cnt, g_cnt)
    total = int(np.asarray(r_cnt).sum())
    assert total > 10_000
    np.testing.assert_array_equal(np.asarray(r_bits)[:total],
                                  g_bits[:total].numpy())
    r_flat, r_total = jsift.compact_frames(ref.sift_mask, ref.bob_bits)
    g_flat, g_total = tsift.compact_frames(got.sift_mask, got.bob_bits)
    _eq(r_flat, g_flat)
    assert int(g_total) == int(r_total) == total


def test_splice_matches_reference(frames):
    arrs, true = frames
    r = tsift.make_frame_matcher(3, 40)(*map(torch.from_numpy, arrs), true)
    idx, counts, _ = tsift.sift_outputs(r.sift_mask, r.bob_bits)
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 2, arrs[0].shape[1], dtype=np.uint8)
    k = int(counts[0])
    ref = jsift.splice(jnp.asarray(raw), jnp.asarray(idx[0, :k].numpy()))
    _eq(ref, tsift.splice(torch.from_numpy(raw), idx[0, :k]))


def test_compact_by_mask_matches_reference():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 100, 64).astype(np.int32)
    mask = rng.random(64) < 0.4
    r_out, r_cnt = jsift.compact_by_mask(jnp.asarray(vals), jnp.asarray(mask))
    g_out, g_cnt = tsift.compact_by_mask(torch.from_numpy(vals),
                                         torch.from_numpy(mask))
    _eq(r_out, g_out)
    assert int(g_cnt) == int(r_cnt)


def test_coincidence_scan_matches_reference(events):
    """tests/test_sift.py's servo scenario: 200 units off, window 400,
    eight chunks."""
    arrs = _frame(events)
    off = events.true_offset_units - 200
    r_off, r_res = jsift.coincidence_scan(*map(jnp.asarray, arrs),
                                          jnp.int32(off), window=400,
                                          num_chunks=8)
    g_off, g_res = tsift.coincidence_scan(*map(torch.from_numpy, arrs), off,
                                          window=400, num_chunks=8)
    assert int(g_off) == int(r_off)
    assert abs(int(g_off) - events.true_offset_units) < 50
    for f in ("matched", "bob_index", "basis_ok", "bob_bits"):
        _eq(getattr(r_res, f), getattr(g_res, f))
    np.testing.assert_allclose(g_res.residual.numpy(),
                               np.asarray(r_res.residual), rtol=1e-5)


def test_one_to_one_exact_at_wide_window_large_frame():
    """tests/test_sift.py's scenario: window * Na = 2^32, heavy multi-claim
    contention; the port's int64 scatter-min picks the reference's
    winners."""
    rng = np.random.default_rng(7)
    na = 1 << 19
    span = jsift.MAX_SPAN - 1
    ta = np.sort(rng.integers(0, span, na)).astype(np.int32)
    tb = np.sort(rng.integers(0, span, na)).astype(np.int32)
    dummy = np.zeros(na, np.uint8)
    arrs = (ta, dummy, tb, dummy, dummy)
    ref = jsift.coincidence_match(*map(jnp.asarray, arrs), jnp.int32(0),
                                  window=8192)
    got = tsift.coincidence_match(*map(torch.from_numpy, arrs), 0,
                                  window=8192)
    _assert_match_same(ref, got)
    assert got.matched.sum() > 0.5 * na
