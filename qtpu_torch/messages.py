"""Typed inter-party EC message schema with a packed wire format.

Reference capability: the EC packet layer — ``subcomponents/comms.c`` +
``definitions/ec_packet_def.h`` (SURVEY.md §3 #15, Appendix A): every message
carries {tag, length, subtype, epoch-range} so a streaming pipeline can route
it to in-flight blocks; payloads are subtype-specific.

Fresh design (not a field-for-field copy): dataclasses with explicit pack/
unpack to little-endian bytes.  The epoch-range addressing idea is kept as
``window_id`` — the streaming pipeline's unit of work (a fixed batch of key
blocks), which plays the reference's {start epoch, number of epochs} role.

Subtype families map to the LDPC protocol of SURVEY.md §4.4 (one round trip)
plus the QBER handshake of §4.3.
"""

from __future__ import annotations

import dataclasses
import struct
from enum import IntEnum
from typing import ClassVar, Type

import numpy as np

from qtpu_torch.framing import pack_bits, unpack_bits

__all__ = [
    "MsgType", "Message", "WindowOpen", "RateSelect", "Syndromes",
    "VerifyAck", "Abort", "TimingBasis", "SiftIndex", "RetryDisclose",
    "pack_message", "unpack_message",
]

MAGIC = 0x51C0FFEE  # wire tag (reference: packet tag field)
_HEADER = struct.Struct("<IIII")  # magic, total_len, subtype, window_id


def _as_np(a, dtype=np.uint8) -> np.ndarray:
    """Materialize a possibly-device array for the wire (protocol v2 keeps
    arrays on device through in-process DirectLinks; serializing links pay
    the device→host fetch here, at the NIC boundary where a deployment
    would pay it anyway)."""
    a = a.cpu() if hasattr(a, "cpu") else a
    return np.asarray(a).astype(dtype, copy=False)


class MsgType(IntEnum):
    WINDOW_OPEN = 1     # Alice → Bob: window w is ready to start
    RATE_SELECT = 2     # Bob → Alice: prior-driven rate rung + shortening
                        # + inline QBER test size
    SYNDROMES = 3       # Alice → Bob: per-block syndromes + verify hashes
                        # + inline QBER test-bit disclosure
    VERIFY_ACK = 4      # Bob → Alice: per-block pass/fail mask
    ABORT = 5           # either → either: tear down a window; carries the
                        # sender's consumed stream length for cursor resync
    TIMING_BASIS = 6    # Alice → Bob: event times + basis (type-2 role)
    SIFT_INDEX = 7      # Bob → Alice: matched-event index (type-4 role)
    RETRY_DISCLOSE = 8  # Alice → Bob: extra bits for failed blocks (blind-
                        # reconciliation retry)


@dataclasses.dataclass
class Message:
    window_id: int
    TYPE: ClassVar[MsgType]

    def payload_bytes(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "Message":
        raise NotImplementedError


@dataclasses.dataclass
class WindowOpen(Message):
    """Alice has a window's worth of stream buffered (no payload — stream
    consumption waits for the rung choice, so the reserve can cover the
    worst-case rung)."""
    TYPE: ClassVar[MsgType] = MsgType.WINDOW_OPEN

    def payload_bytes(self) -> bytes:
        return b""

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "WindowOpen":
        return cls(window_id=window_id)


@dataclasses.dataclass
class RateSelect(Message):
    """Bob's prior-driven protocol choice for the window: the ladder rung,
    the fine-shortening amount, and the inline QBER test-bit size.

    ``short_bits``: extra payload positions per block to shorten (pin to
    shared-PRNG values) — the fine rate-adaptation knob interpolating the
    effective rate between ladder rungs.
    ``test_bits_pb``: QBER test positions per block Alice must disclose
    inside her Syndromes message (protocol-PRNG positions, pinned in the
    decode)."""
    qber_milli: int     # QBER prior estimate in 1/1000 units (diagnostic)
    rate_index: int
    short_bits: int = 0
    test_bits_pb: int = 0
    TYPE: ClassVar[MsgType] = MsgType.RATE_SELECT

    def payload_bytes(self) -> bytes:
        return struct.pack("<IIII", self.qber_milli, self.rate_index,
                           self.short_bits, self.test_bits_pb)

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "RateSelect":
        q, r, s, k = struct.unpack_from("<IIII", data)
        return cls(window_id=window_id, qber_milli=q, rate_index=r,
                   short_bits=s, test_bits_pb=k)


@dataclasses.dataclass
class Syndromes(Message):
    """The one-way reconciliation message: per-block syndromes + 64-bit
    verification hashes + the inline QBER test-bit disclosure (SURVEY.md
    §4.4 — ONE message replaces Cascade's dozens of round trips; §3 #11 —
    the disclosure rides the same message instead of its own round trip)."""
    rate_index: int
    num_blocks: int
    syndrome_bits: int            # m per block
    syndromes: np.ndarray         # (B, m) uint8 — may be a device array
    verify_hashes: np.ndarray     # (B, Vh) uint8 — may be a device array
    short_bits: int = 0           # disclosed-shortening positions per block
    test_bits_pb: int = 0         # echo of RateSelect.test_bits_pb
    test_bits: np.ndarray = None  # (B, k_pb) uint8 — may be a device array
    short_values: np.ndarray = None  # (B, s) uint8 — may be a device array
    TYPE: ClassVar[MsgType] = MsgType.SYNDROMES

    def payload_bytes(self) -> bytes:
        syn = _as_np(self.syndromes)
        hashes = _as_np(self.verify_hashes)
        vh = hashes.shape[-1]
        k = self.test_bits_pb
        s = self.short_bits
        # The in-process form may carry the program's full static K_max /
        # S_max columns; only the DISCLOSED columns ever hit the wire.
        test = (_as_np(self.test_bits)[:, :k] if k
                else np.zeros((self.num_blocks, 0), np.uint8))
        shortv = (_as_np(self.short_values)[:, :s] if s
                  else np.zeros((self.num_blocks, 0), np.uint8))
        head = struct.pack("<IIIIII", self.rate_index, self.num_blocks,
                           self.syndrome_bits, s, vh, k)
        parts = [head, pack_bits(syn).tobytes(), pack_bits(hashes).tobytes()]
        if k:
            parts.append(pack_bits(test).tobytes())
        if s:
            parts.append(pack_bits(shortv).tobytes())
        return b"".join(parts)

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "Syndromes":
        r, b, m, s, vh, k = struct.unpack_from("<IIIIII", data)
        off = 24

        def take(width):
            nonlocal off
            if not width:
                return np.zeros((b, 0), np.uint8)
            w = (width + 31) // 32
            words = np.frombuffer(data[off:off + b * w * 4],
                                  np.uint32).reshape(b, w)
            off += b * w * 4
            return unpack_bits(words, width)

        syn = take(m)
        hashes = take(vh)
        test = take(k)
        shortv = take(s)
        return cls(window_id=window_id, rate_index=r, num_blocks=b,
                   syndrome_bits=m, syndromes=syn,
                   verify_hashes=hashes, short_bits=s,
                   test_bits_pb=k, test_bits=test, short_values=shortv)


@dataclasses.dataclass
class VerifyAck(Message):
    """Bob's per-block verification results (True = hashes matched).

    ``round`` distinguishes the initial ack (0) from post-retry acks."""
    num_blocks: int
    ok_mask: np.ndarray  # (B,) uint8
    round: int = 0
    TYPE: ClassVar[MsgType] = MsgType.VERIFY_ACK

    def payload_bytes(self) -> bytes:
        return (struct.pack("<II", self.num_blocks, self.round)
                + pack_bits(self.ok_mask).tobytes())

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "VerifyAck":
        b, rnd = struct.unpack_from("<II", data)
        words = np.frombuffer(data[8:], np.uint32)
        return cls(window_id=window_id, num_blocks=b,
                   ok_mask=unpack_bits(words, b), round=rnd)


@dataclasses.dataclass
class RetryDisclose(Message):
    """Blind-reconciliation retry: Alice's payload bits at protocol-PRNG
    positions for every still-failed block (row per failed block, in
    block-index order).  Bob pins these (LLR ±inf) and re-decodes."""
    round: int
    num_bits: int              # disclosed bits per failed block
    failed_mask: np.ndarray    # (B,) uint8
    bits: np.ndarray           # (num_failed, num_bits) uint8 on the wire;
                               # in-process links may carry (B, num_bits)
                               # device arrays (only failed rows meaningful)
    TYPE: ClassVar[MsgType] = MsgType.RETRY_DISCLOSE

    def payload_bytes(self) -> bytes:
        mask = _as_np(self.failed_mask)
        bits = _as_np(self.bits)
        if bits.shape[0] == len(mask):
            # Device form carries all rows; the WIRE discloses failed rows
            # only (leakage = num_bits x num_failed, as the ledger charges).
            bits = bits[mask.astype(bool)]
        head = struct.pack("<III", self.round, self.num_bits, len(mask))
        return (head + pack_bits(mask).tobytes()
                + pack_bits(bits).tobytes())

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "RetryDisclose":
        rnd, k, b = struct.unpack_from("<III", data)
        off = 12
        mask_words = (b + 31) // 32
        mask = unpack_bits(np.frombuffer(data[off:off + 4 * mask_words],
                                         np.uint32), b)
        nf = int(mask.sum())
        row_words = (k + 31) // 32
        bits = unpack_bits(
            np.frombuffer(data[off + 4 * mask_words:], np.uint32
                          ).reshape(nf, row_words), k)
        return cls(window_id=window_id, round=rnd, num_bits=k,
                   failed_mask=mask, bits=bits)


@dataclasses.dataclass
class Abort(Message):
    """Tear down a window.  ``consumed`` is the sender's consumed stream
    length for the window — the receiver consumes-and-discards to match so
    an asymmetric abort can never desynchronize the two parties' stream
    cursors (a receiver that consumed MORE echoes the abort back with its
    own count).  ``disclosed_*`` carry the sender's leakage charges for the
    window (QBER test bits / syndromes / hashes already on the channel when
    the abort struck) so both ledgers stay equal even when only one party
    reached the disclosure stage."""
    reason: str = ""
    consumed: int = 0
    disclosed_qber: int = 0
    disclosed_syndrome: int = 0
    disclosed_hash: int = 0
    TYPE: ClassVar[MsgType] = MsgType.ABORT

    def payload_bytes(self) -> bytes:
        return (struct.pack("<QQQQ", self.consumed, self.disclosed_qber,
                            self.disclosed_syndrome, self.disclosed_hash)
                + self.reason.encode("utf-8"))

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "Abort":
        c, dq, ds, dh = struct.unpack_from("<QQQQ", data)
        return cls(window_id=window_id, reason=data[32:].decode("utf-8"),
                   consumed=c, disclosed_qber=dq, disclosed_syndrome=ds,
                   disclosed_hash=dh)


@dataclasses.dataclass
class TimingBasis(Message):
    """Alice's compressed timing + basis info for one sift window — the
    reference type-2 stream (SURVEY.md Appendix A), sent source → receiver
    so costream can coincidence-match.  Timing is delta-encoded at the
    smallest byte width fitting the window's gaps (framing.pack_deltas);
    the basis bits are packed.  window_id carries the device-frame id
    (epoch id = frame id >> 3) when the chain runs epoch-true streaming."""
    times: np.ndarray    # (Na,) int32 device times (rebased to window start)
    basis: np.ndarray    # (Na,) uint8 0/1
    TYPE: ClassVar[MsgType] = MsgType.TIMING_BASIS

    def payload_bytes(self) -> bytes:
        from qtpu_torch.framing import pack_deltas
        n = len(self.times)
        tb = pack_deltas(np.asarray(self.times, np.int64))
        return (struct.pack("<II", n, len(tb)) + tb
                + pack_bits(np.asarray(self.basis, np.uint8)).tobytes())

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "TimingBasis":
        from qtpu_torch.framing import unpack_deltas
        n, tlen = struct.unpack_from("<II", data)
        times = unpack_deltas(data[8:8 + tlen], n).astype(np.int32)
        words = np.frombuffer(data[8 + tlen:], np.uint32)
        return cls(window_id=window_id, times=times,
                   basis=unpack_bits(words, n))


@dataclasses.dataclass
class SiftIndex(Message):
    """Bob's sifting decision for one window — the reference type-4 stream:
    indices of Alice's events that were coincidence-matched with agreeing
    basis, in order.  Alice splices her raw key at these positions.

    Device-resident form (in-process DirectLinks): ``indices`` may be a
    padded DEVICE row with ``count`` giving the valid prefix — the splice
    then happens as a device gather with no mask/index d2h at all (the
    fetch of the full (F, Na) sift masks was half the in-chain sift cost).
    ``count < 0`` means the legacy dense form (count = len(indices))."""
    indices: np.ndarray  # (K,) int32 indices into Alice's window events
    count: int = -1      # valid prefix length; -1 = len(indices)
    TYPE: ClassVar[MsgType] = MsgType.SIFT_INDEX

    def payload_bytes(self) -> bytes:
        k = self.count if self.count >= 0 else len(self.indices)
        idx = _as_np(self.indices, np.int32)[:k]
        return struct.pack("<I", k) + idx.tobytes()

    @classmethod
    def from_payload(cls, window_id: int, data: bytes) -> "SiftIndex":
        (n,) = struct.unpack_from("<I", data)
        return cls(window_id=window_id,
                   indices=np.frombuffer(data[4:4 + 4 * n], np.int32))


_REGISTRY: dict[int, Type[Message]] = {
    int(c.TYPE): c for c in (WindowOpen, RateSelect, Syndromes, VerifyAck,
                             Abort, TimingBasis, SiftIndex, RetryDisclose)
}


def pack_message(msg: Message) -> bytes:
    payload = msg.payload_bytes()
    header = _HEADER.pack(MAGIC, _HEADER.size + len(payload), int(msg.TYPE),
                          msg.window_id)
    return header + payload


def unpack_message(data: bytes) -> Message:
    magic, total, subtype, window_id = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if total != len(data):
        raise ValueError(f"length mismatch: header {total}, got {len(data)}")
    cls = _REGISTRY.get(subtype)
    if cls is None:
        raise ValueError(f"unknown subtype {subtype}")
    return cls.from_payload(window_id, data[_HEADER.size:])
