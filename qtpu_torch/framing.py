"""Epoch framing, timestamped-event formats, and bit packing.

Reference capability: the epoch/file framing convention that every qcrypto
daemon sits on (SURVEY.md §2 "Core runtime", Appendix A): time is sliced into
epochs of 2^29 ns (~0.537 s); every stream artifact is addressed by a 32-bit
epoch number; events are 64-bit records (49-bit timestamp @ 125 ps + 4-bit
detector id).

TPU-first design: epochs become *array windows*, not files — a window of
events is a struct-of-arrays (times, detectors) with static capacity and a
validity count, so the whole sifting chain stays jit-compatible.  Keys are
bit-packed into uint32 words for host transport and hashing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "EPOCH_NS", "TIME_UNITS_PER_NS", "EPOCH_UNITS", "FRAME_UNITS",
    "epoch_of_time", "frame_of_time", "split_epochs",
    "pack_bits", "unpack_bits", "pack_deltas", "unpack_deltas",
    "EventWindow", "KeyBlock",
]

# Reference framing constants (SURVEY.md Appendix A):
EPOCH_NS = 2 ** 29                 # one epoch = 2^29 ns ≈ 0.537 s
TIME_UNITS_PER_NS = 8              # timestamps in 125 ps units
EPOCH_UNITS = EPOCH_NS * TIME_UNITS_PER_NS  # epoch length in 125 ps units
DETECTOR_BITS = 4
TIME_BITS = 49


# Device frame: the sifting kernels keep event times in int32 125 ps units
# (no fast int64 on the VPU), so one matching window spans at most 2^29
# units ≈ 67 ms.  A reference epoch (2^29 ns = 2^32 units) therefore maps to
# exactly 8 device FRAMES; stream artifacts are addressed by frame id, and
# epoch id = frame id >> 3.
FRAME_UNITS = 2 ** 29
FRAMES_PER_EPOCH = EPOCH_UNITS // FRAME_UNITS


def epoch_of_time(t_units: np.ndarray) -> np.ndarray:
    """Epoch number for timestamps in 125 ps units."""
    return (np.asarray(t_units) // EPOCH_UNITS).astype(np.uint32)


def frame_of_time(t_units: np.ndarray) -> np.ndarray:
    """Device-frame number (epoch/8) for timestamps in 125 ps units."""
    return (np.asarray(t_units) // FRAME_UNITS).astype(np.uint32)


def split_epochs(times_abs: np.ndarray, detectors: np.ndarray
                 ) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """The chopper/chopper2 role (SURVEY.md §3 #3-4): split a continuous
    absolute-time event stream into device frames.

    Returns [(frame_id, times_rebased_i32, detectors)] in frame order; times
    are rebased to the frame start so they satisfy the int32 device-time
    contract (qtpu.sift).  Empty frames are omitted (the reference emits
    empty epoch files; an in-process pipeline has no queue to keep warm).
    """
    times_abs = np.asarray(times_abs, np.int64)
    detectors = np.asarray(detectors, np.uint8)
    keep = times_abs >= 0   # jitter at the stream head can dip below t=0
    times_abs, detectors = times_abs[keep], detectors[keep]
    order = np.argsort(times_abs, kind="stable")
    times_abs, detectors = times_abs[order], detectors[order]
    fids = times_abs // FRAME_UNITS
    out = []
    for f in np.unique(fids):
        m = fids == f
        t = (times_abs[m] - f * FRAME_UNITS).astype(np.int32)
        out.append((int(f), t, detectors[m]))
    return out


def pack_deltas(times: np.ndarray) -> bytes:
    """Width-adaptive delta encoding of sorted event times (the type-2
    compression role, SURVEY.md Appendix A): first time as i32, then gaps at
    the smallest byte width {1,2,3,4} that fits this batch's maximum gap.
    ~25-60%% of the raw int32 cost at realistic count rates."""
    import struct
    times = np.asarray(times, np.int64)
    n = len(times)
    if n == 0:
        return struct.pack("<Bi", 1, 0) + b""
    deltas = np.diff(times)
    assert (deltas >= 0).all(), "times must be sorted"
    max_d = int(deltas.max()) if n > 1 else 0
    width = 1 if max_d < (1 << 8) else 2 if max_d < (1 << 16) \
        else 3 if max_d < (1 << 24) else 4
    head = struct.pack("<Bi", width, int(times[0]))
    le = deltas.astype(np.uint32)[:, None] >> (8 * np.arange(4, dtype=np.uint32))
    body = (le & 0xFF).astype(np.uint8)[:, :width].tobytes()
    return head + body


def unpack_deltas(data: bytes, n: int) -> np.ndarray:
    """Inverse of pack_deltas for n events; returns int64 times."""
    import struct
    width, t0 = struct.unpack_from("<Bi", data)
    if n == 0:
        return np.zeros(0, np.int64)
    raw = np.frombuffer(data[5:5 + width * (n - 1)], np.uint8)
    b = raw.reshape(n - 1, width).astype(np.uint32)
    deltas = np.zeros(n - 1, np.uint32)
    for k in range(width):
        deltas |= b[:, k] << np.uint32(8 * k)
    out = np.empty(n, np.int64)
    out[0] = t0
    out[1:] = t0 + np.cumsum(deltas.astype(np.int64))
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a (..., n) 0/1 array into (..., ceil(n/32)) uint32 words (LSB-first)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    pad = (-n) % 32
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), np.uint8)], axis=-1)
    words = bits.reshape(bits.shape[:-1] + (-1, 32))
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (words.astype(np.uint32) * weights).sum(axis=-1).astype(np.uint32)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bits, truncated to n bits."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((words[..., :, None] >> shifts) & 1).astype(np.uint8)
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n]


@dataclasses.dataclass
class EventWindow:
    """A fixed-capacity window of detector events (one or more epochs).

    Struct-of-arrays with a validity count so shapes stay static under jit:
    entries at index >= count are padding (time = 2^63-1 sorts them last).
    """

    times: np.ndarray       # (capacity,) int64, 125 ps units, sorted ascending
    detectors: np.ndarray   # (capacity,) uint8 in [0, 16)
    count: int              # number of valid events
    start_epoch: int        # first epoch covered
    num_epochs: int         # epochs covered

    PAD_TIME = np.int64(2 ** 63 - 1)

    @classmethod
    def from_events(cls, times: np.ndarray, detectors: np.ndarray,
                    start_epoch: int, num_epochs: int,
                    capacity: int | None = None) -> "EventWindow":
        order = np.argsort(times, kind="stable")
        times = np.asarray(times, np.int64)[order]
        detectors = np.asarray(detectors, np.uint8)[order]
        n = len(times)
        cap = capacity or _next_pow2(max(n, 1))
        assert cap >= n, "capacity too small"
        t = np.full(cap, cls.PAD_TIME, np.int64)
        d = np.zeros(cap, np.uint8)
        t[:n] = times
        d[:n] = detectors
        return cls(times=t, detectors=d, count=n,
                   start_epoch=start_epoch, num_epochs=num_epochs)


@dataclasses.dataclass
class KeyBlock:
    """A contiguous run of key bits addressed by epoch range.

    This is the unit the EC pipeline works on (reference "processblock",
    SURVEY.md §1) and the shape of the final-key artifact (type-7 analog).
    """

    start_epoch: int
    num_epochs: int
    bits: np.ndarray          # (n,) uint8
    leaked_bits: int = 0      # running leakage attributed to this block

    @property
    def n(self) -> int:
        return int(self.bits.shape[0])

    def packed(self) -> np.ndarray:
        return pack_bits(self.bits)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


# ---------------------------------------------------------------------------
# Port-only additions (everything above this line is a verbatim copy of
# qtpu/framing.py; tests/test_torch_imports.py holds it to that).
# ---------------------------------------------------------------------------

# The same bits as the copy of unpack_bits above, which this replaces: one
# np.unpackbits over bytes instead of a uint32 shift and mask a bit.
def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bits, truncated to n bits: the little-endian bytes
    of only the words that hold the first n bits, unpacked LSB-first."""
    words = np.asarray(words, dtype=np.uint32)
    if n >= 0:
        words = words[..., :(n + 31) // 32]
    words = np.ascontiguousarray(words, dtype="<u4")
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n]
