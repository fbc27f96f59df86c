"""The events cell's reference: one chunk of detector events framed,
coincidence-matched and sifted again, in plain NumPy.

The semantics of the entanglement-based (BBM92) sifting chain of
``kurtsiefer/qcrypto`` (chopper/chopper2 framing, costream matching and
sifting, splicer), as the program states them, independent of its code:

- **Framing.**  A party's stream of absolute int64 times in 125 ps units
  is sorted stably; times below 0 are dropped; frame f holds the times t
  with t // 2^29 == f, rebased to t - f 2^29 (int32).  Frames come out in
  ascending order, each once a call: a chunk is one frame of one call, so
  consecutive calls can give chunks of one frame id.
- **Matching.**  Alice's times move onto Bob's clock by the offset; each
  Alice event takes the Bob event nearest to it in the chunk (ties to the
  one on the left), and is matched when that distance is at most the
  coincidence window.
- **One to one.**  Where several Alice events hold one Bob event, the one
  with the smallest (distance, Alice index) keeps it.
- **Sifting.**  A matched pair whose bases agree is sifted.  The index row
  is the sifted Alice indices in order; Bob's bits are his bits at their
  partners, in the same order; Alice's splice is her bits at the row.
- **Servo.**  The residual is the float32 division of the exact (int64)
  sum of Bob's time minus Alice's moved time over the matched pairs by
  the float32 count of them (1 where there are none); the next offset is
  offset + int32(float32(gain) x residual), truncated toward zero.

Departures from ``costream``: events are matched within a chunk only (a
pair split by a frame boundary, or by the boundary of two calls, is
lost, where costream carries the tail of a frame into the next); the
window is a fixed +-``coincidence_window`` and not costream's adaptive
one; one-to-one matching keeps the nearest claimant, where costream takes
the first in time; the servo updates once a chunk from the mean residual,
where costream tracks the drift continuously; no basis-dependent
detector delays are corrected.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["FRAME_UNITS", "Chunk", "Sifted", "frame_chunks", "match_chunk",
           "splice"]

FRAME_UNITS = 1 << 29


class Chunk(NamedTuple):
    """One frame of one call: ``frame``, rebased int32 ``times``, and the
    uint8 ``detectors`` (basis = bit 1, value = bit 0)."""
    frame: int
    times: np.ndarray
    detectors: np.ndarray


class Sifted(NamedTuple):
    """A chunk's sifting: the index row (int32, the sifted Alice indices
    in order), Bob's bits at them (uint8), the matched pairs, the float32
    residual and the int32 offset after the servo."""
    index: np.ndarray
    bob_bits: np.ndarray
    matched: int
    residual: np.float32
    next_offset: np.int32


def frame_chunks(times_abs, detectors) -> list:
    """The chunks of one call's stream, in ascending frame order."""
    t = np.asarray(times_abs, np.int64)
    d = np.asarray(detectors, np.uint8)
    keep = t >= 0
    t, d = t[keep], d[keep]
    order = np.argsort(t, kind="stable")
    t, d = t[order], d[order]
    frames = t // FRAME_UNITS
    cuts = np.flatnonzero(np.diff(frames)) + 1
    out = []
    for lo, hi in zip(np.concatenate([[0], cuts]),
                      np.concatenate([cuts, [len(t)]])):
        if hi > lo:
            f = int(frames[lo])
            out.append(Chunk(f, (t[lo:hi] - f * FRAME_UNITS).astype(np.int32),
                             d[lo:hi]))
    return out


def match_chunk(alice: Chunk, bob: Chunk, offset: int, window: int,
                gain: float) -> Sifted:
    """Sift one chunk from ``offset`` (Bob's clock minus Alice's)."""
    ta = alice.times.astype(np.int64) + int(offset)
    tb = bob.times.astype(np.int64)
    na, nb = len(ta), len(tb)
    basis_a = (alice.detectors >> 1) & 1
    basis_b, bits_b = (bob.detectors >> 1) & 1, bob.detectors & 1
    if nb == 0 or na == 0:
        residual = np.float32(0.0)
        return Sifted(np.zeros(0, np.int32), np.zeros(0, np.uint8), 0,
                      residual, _servo(offset, residual, gain))
    pos = np.searchsorted(tb, ta, side="left")
    left = np.clip(pos - 1, 0, nb - 1)
    right = np.clip(pos, 0, nb - 1)
    d_left = np.abs(tb[left] - ta)
    d_right = np.abs(tb[right] - ta)
    take_left = d_left <= d_right
    best = np.where(take_left, left, right)
    dist = np.where(take_left, d_left, d_right)
    claim = np.flatnonzero(dist <= window)
    # One to one: of the claimants of each Bob event, the smallest
    # (distance, index).
    order = np.lexsort((claim, dist[claim], best[claim]))
    ranked = claim[order]
    first = np.ones(len(ranked), bool)
    first[1:] = best[ranked[1:]] != best[ranked[:-1]]
    matched = np.sort(ranked[first])
    diffs = tb[best[matched]] - ta[matched]
    residual = (np.float32(int(diffs.sum()))
                / np.float32(max(1, len(matched))))
    sifted = matched[basis_a[matched] == basis_b[best[matched]]]
    return Sifted(sifted.astype(np.int32),
                  bits_b[best[sifted]].astype(np.uint8), len(matched),
                  np.float32(residual), _servo(offset, residual, gain))


def _servo(offset: int, residual, gain: float) -> np.int32:
    step = (np.float32(gain) * np.float32(residual)).astype(np.int32)
    return np.int32(np.int64(offset) + np.int64(step))


def splice(alice: Chunk, index: np.ndarray) -> np.ndarray:
    """Alice's sifted bits: her values at the index row."""
    return (alice.detectors[np.asarray(index, np.int64)] & 1).astype(np.uint8)
