"""Sifting chain: time-offset acquisition, coincidence matching, splicing.

Counterpart of ``qtpu/sift.py`` in torch ops on the tensors' device:

- ``pfind`` — FFT cross-correlation of both parties' binned arrival times
  for the coarse time offset, refined by a delta histogram and a mean lock;
- ``coincidence_match`` — nearest-neighbour matching of Alice's events
  against Bob's (sorted-merge via ``torch.searchsorted``), one-to-one by the
  lexicographic (distance, index) rule, basis compare, servo residual;
- ``make_frame_matcher`` / ``coincidence_scan`` — batches of frames or
  chunks with the drift servo carried on the device between them;
- ``sift_outputs`` / ``compact_frames`` / ``compact_by_mask`` — stable
  compaction of the sifted events; ``splice`` — Alice's gather.

Device times stay int32 in 125 ps units rebased to the window start
(``rebase_times``); padding carries ``DEVICE_PAD`` (2^30), which sorts last
and cannot overflow a distance against any in-window time.  On identical
events every output equals the reference's (the tests hold offsets, masks,
indices and counts exactly, residuals to 1e-5 relative).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["pfind", "coincidence_match", "splice", "compact_by_mask",
           "SiftResult", "DEVICE_PAD", "MAX_SPAN", "rebase_times",
           "FrameSiftResult", "make_frame_matcher", "compact_frames",
           "sift_outputs", "coincidence_scan"]

DEVICE_PAD = np.int32(2 ** 30)   # padding time: sorts last, overflow-safe
MAX_SPAN = 2 ** 29               # max window span in 125 ps units (~67 ms)
_PAD = int(DEVICE_PAD)


def rebase_times(times_i64: np.ndarray, window_start: int) -> np.ndarray:
    """Host-side: rebase int64 event times to int32 device times; padding
    (any time outside [start, start + MAX_SPAN)) becomes DEVICE_PAD."""
    t = np.asarray(times_i64, np.int64) - np.int64(window_start)
    out = np.where((t >= 0) & (t < MAX_SPAN), t, np.int64(DEVICE_PAD))
    return out.astype(np.int32)


def _int_mean(values: torch.Tensor, mask: torch.Tensor,
              count: torch.Tensor) -> torch.Tensor:
    """float32 mean of the masked integers: summed exactly in int64, then
    divided once in float32.  The reference sums their float32 casts, in
    an order that differs between XLA and torch; both equal this wherever
    the reference's float32 sum is exact (|partial sums| < 2^24)."""
    total = torch.where(mask, values, 0).sum(dtype=torch.int64)
    return total.to(torch.float32) / count.to(torch.float32)


# ---------------------------------------------------------------------------
# pfind — FFT cross-correlation time-offset acquisition
# ---------------------------------------------------------------------------

def pfind(times_a: torch.Tensor, times_b: torch.Tensor, span: int,
          num_bins: int = 1 << 20, refine: bool = True) -> torch.Tensor:
    """Estimate Bob's clock offset relative to Alice (0-d int32 tensor on
    the inputs' device; positive: Bob's events lag Alice's).

    times_*: int32 device times (see rebase_times), padding at DEVICE_PAD,
    Bob's sorted.  span: window length in units (< MAX_SPAN).  Coarse bins
    over the full span pick the peak; with ``refine`` a delta histogram
    over +-2 coarse bins and a mean lock at jitter scale refine it."""
    dev = times_a.device

    def xcorr_peak(ta, tb, lo, hi, bins):
        scale = (hi - lo) / bins
        ia = ((ta - lo) / scale).to(torch.int32).clamp(0, bins - 1)
        ib = ((tb - lo) / scale).to(torch.int32).clamp(0, bins - 1)
        va = ((ta >= lo) & (ta < hi)).to(torch.float32)
        vb = ((tb >= lo) & (tb < hi)).to(torch.float32)
        ha = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(
            0, ia, va)
        hb = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(
            0, ib, vb)
        fa = torch.fft.rfft(ha)
        fb = torch.fft.rfft(hb)
        corr = torch.fft.irfft(torch.conj(fa) * fb, bins)
        peak = torch.argmax(corr).to(torch.int32)
        # Lags > bins/2 are negative offsets (circular correlation).
        lag = torch.where(peak > bins // 2, peak - bins, peak)
        return (lag * scale).to(torch.int32)

    coarse = xcorr_peak(times_a, times_b, 0, span, num_bins)
    if not refine:
        return coarse
    nb = times_b.shape[0]

    def nearest_delta(est, w):
        """Signed delta to each Alice event's nearest Bob event, validity
        mask for |delta| <= w (pads excluded)."""
        t = times_a + est
        pos = torch.searchsorted(times_b, t, side="left")
        right = pos.clamp(0, nb - 1)
        left = (pos - 1).clamp(0, nb - 1)
        dr = times_b[right] - t
        dl = times_b[left] - t
        take_l = dl.abs() <= dr.abs()
        d = torch.where(take_l, dl, dr)
        best = torch.where(take_l, left, right)
        valid = ((times_a < _PAD) & (times_b[best] < _PAD)
                 & (d.abs() <= w))
        return d, valid

    # Stage 2 — histogram-peak refinement over +-2 coarse bins (robust to
    # the uniform accidental background at high rates).
    scale = max(1, span // num_bins)
    est = coarse
    w = 2 * scale
    bin_w = 16
    nbins = (2 * w) // bin_w
    d, valid = nearest_delta(est, w)
    idx = torch.div(d + w, bin_w, rounding_mode="floor").clamp(0, nbins - 1)
    hist = torch.zeros(nbins, dtype=torch.float32, device=dev).index_add_(
        0, idx, valid.to(torch.float32))
    est = est + (torch.argmax(hist).to(torch.int32) * bin_w
                 + bin_w // 2 - w)
    # Stage 3 — mean lock at jitter scale.
    for wf in (64, 48):
        d, valid = nearest_delta(est, wf)
        cnt = valid.sum().clamp(min=1)
        est = est + _int_mean(d, valid, cnt).to(torch.int32)
    return est


# ---------------------------------------------------------------------------
# costream — coincidence matching + basis compare
# ---------------------------------------------------------------------------

class SiftResult(NamedTuple):
    matched: torch.Tensor      # (Na,) bool — Alice event matched a Bob event
    bob_index: torch.Tensor    # (Na,) int32 — nearest Bob event
    basis_ok: torch.Tensor     # (Na,) bool — bases agree
    bob_bits: torch.Tensor     # (Na,) uint8 — Bob's bit at the match
    residual: torch.Tensor     # 0-d f32 — mean time residual of matches
    offset_used: torch.Tensor  # offset applied


def coincidence_match(times_a: torch.Tensor, basis_a: torch.Tensor,
                      times_b: torch.Tensor, basis_b: torch.Tensor,
                      bits_b: torch.Tensor, offset, window: int
                      ) -> SiftResult:
    """Match each Alice event to the nearest Bob event within +-window.

    Fixed-capacity arrays; Bob's times sorted ascending with padding at
    DEVICE_PAD.  One sorted merge (searchsorted), no data-dependent
    shapes."""
    ta = times_a + offset  # move Alice onto Bob's clock
    pos = torch.searchsorted(times_b, ta, side="left")
    nb = times_b.shape[0]
    right = pos.clamp(0, nb - 1)
    left = (pos - 1).clamp(0, nb - 1)
    d_right = (times_b[right] - ta).abs()
    d_left = (times_b[left] - ta).abs()
    take_left = d_left <= d_right
    best = torch.where(take_left, left, right)
    dist = torch.where(take_left, d_left, d_right)
    # Padding guard: a padded Alice entry must never match.
    valid_a = times_a < _PAD
    valid_b = times_b[best] < _PAD
    matched = (dist <= window) & valid_a & valid_b
    # One-to-one: when several Alice events claim one Bob event only the
    # lexicographically smallest (dist, index) wins.  The reference takes a
    # segmented min over runs of equal `best` with two associative scans
    # because JAX runs without int64; both streams are sorted, so all
    # claimants of one Bob event form one run, and a scatter-min of the
    # int64 key dist*Na + i over `best` gives the same winners.
    na = times_a.shape[0]
    idx = torch.arange(na, dtype=torch.int64, device=times_a.device)
    big = torch.iinfo(torch.int64).max
    key = torch.where(matched, dist.to(torch.int64) * na + idx, big)
    win = torch.full((nb,), big, dtype=torch.int64,
                     device=times_a.device).scatter_reduce(
        0, best, key, reduce="amin", include_self=True)
    matched = matched & (key == win[best])
    basis_ok = basis_a == basis_b[best]
    denom = matched.sum().clamp(min=1)
    residual = _int_mean(times_b[best] - ta, matched, denom)
    return SiftResult(matched=matched, bob_index=best.to(torch.int32),
                      basis_ok=basis_ok,
                      bob_bits=bits_b[best].to(torch.uint8),
                      residual=residual, offset_used=offset)


class FrameSiftResult(NamedTuple):
    sift_mask: torch.Tensor       # (F, Na) bool — matched AND basis-agreeing
    bob_bits: torch.Tensor        # (F, Na) uint8 — Bob's bit at the match
    matched_counts: torch.Tensor  # (F,) int32 — coincidences per frame
    sifted_counts: torch.Tensor   # (F,) int32 — sifted bits per frame
    residuals: torch.Tensor       # (F,) f32 — per-frame servo residuals
    final_offset: torch.Tensor    # 0-d int32 — offset after the last frame


def _servo(offset: torch.Tensor, residual: torch.Tensor,
           servo_gain: float) -> torch.Tensor:
    """offset + int32(gain * residual), in float32 as the reference."""
    return offset + (servo_gain * residual).to(torch.int32)


def make_frame_matcher(num_frames: int, window: int,
                       servo_gain: float = 0.5):
    """Batched multi-frame coincidence matcher: ``(times_a (F,Na), basis_a,
    times_b (F,Nb), basis_b, bits_b, offset0) -> FrameSiftResult``, the
    frames matched in order with the drift servo's offset kept on the
    device between frames (no host sync per frame).  Frames are padded to
    static capacity with DEVICE_PAD times."""

    def match_frames(times_a, basis_a, times_b, basis_b, bits_b, offset0):
        offset = torch.as_tensor(offset0, dtype=torch.int32,
                                 device=times_a.device)
        sm, bits, mc, sc, res = [], [], [], [], []
        for f in range(times_a.shape[0]):
            r = coincidence_match(times_a[f], basis_a[f], times_b[f],
                                  basis_b[f], bits_b[f], offset, window)
            offset = _servo(offset, r.residual, servo_gain)
            m = r.matched & r.basis_ok
            sm.append(m)
            bits.append(r.bob_bits)
            mc.append(r.matched.sum())
            sc.append(m.sum())
            res.append(r.residual)
        return FrameSiftResult(
            sift_mask=torch.stack(sm), bob_bits=torch.stack(bits),
            matched_counts=torch.stack(mc).to(torch.int32),
            sifted_counts=torch.stack(sc).to(torch.int32),
            residuals=torch.stack(res), final_offset=offset)

    return match_frames


def _stable_front(mask: torch.Tensor) -> torch.Tensor:
    """Stable argsort of ~mask along the last axis: selected entries first,
    each group in index order."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


def sift_outputs(sift_mask: torch.Tensor, bob_bits: torch.Tensor):
    """Device-side sift epilogue: (idx (F, Na) int32, counts (F,) int32,
    bits_flat (F*Na,) uint8) — per-frame Alice-event indices compacted
    sifted-first (the type-4 SiftIndex rows, valid prefix = counts[f]), and
    the frame-major compacted Bob bits (valid prefix = sum(counts)).  Only
    the counts need to reach the host."""
    order = _stable_front(sift_mask).to(torch.int32)
    counts = sift_mask.sum(dim=-1).to(torch.int32)
    bits_flat, _ = compact_frames(sift_mask, bob_bits)
    return order, counts, bits_flat


def compact_frames(sift_mask: torch.Tensor, bob_bits: torch.Tensor):
    """Flatten a frame batch's sifted bits to a contiguous prefix (frame-
    major, stable within frame).  Returns (bits (F*Na,) with sifted bits
    first, total int32)."""
    flat_mask = sift_mask.reshape(-1)
    order = _stable_front(flat_mask)
    return (bob_bits.reshape(-1)[order],
            flat_mask.sum().to(torch.int32))


def coincidence_scan(times_a, basis_a, times_b, basis_b, bits_b,
                     offset0, window: int, num_chunks: int,
                     servo_gain: float = 0.5):
    """Chunked coincidence matching with a clock-drift servo: Alice's
    (sorted) events split into ``num_chunks`` equal chunks, each matched
    against all of Bob's, the offset updated by ``servo_gain * residual``
    after each.  Returns (final offset, per-chunk SiftResults stacked
    along a leading axis)."""
    chunk = times_a.shape[0] // num_chunks
    ta = times_a[:chunk * num_chunks].reshape(num_chunks, chunk)
    ba = basis_a[:chunk * num_chunks].reshape(num_chunks, chunk)
    offset = torch.as_tensor(offset0, dtype=torch.int32,
                             device=times_a.device)
    results = []
    for c in range(num_chunks):
        r = coincidence_match(ta[c], ba[c], times_b, basis_b, bits_b, offset,
                              window)
        results.append(r)
        offset = _servo(offset, r.residual, servo_gain)
    return offset, SiftResult(*(torch.stack(field)
                                for field in zip(*results)))


# ---------------------------------------------------------------------------
# splicer — Alice-side gather by the peer's index
# ---------------------------------------------------------------------------

def splice(alice_bits: torch.Tensor, sift_index: torch.Tensor) -> torch.Tensor:
    """Alice's sifted key: her raw bits at the type-4 index positions (all
    in range; a padded index row is clamped by the caller)."""
    return alice_bits[..., sift_index.to(torch.int64)].to(torch.uint8)


def compact_by_mask(values: torch.Tensor, mask: torch.Tensor):
    """Stable compaction: selected entries moved to the front, order kept;
    returns (compacted, count).  Entries past count are the rest."""
    return values[..., _stable_front(mask)], mask.sum()
