"""Final-key artifact store — the type-7 stream equivalent.

Reference capability: the epoch-named type-7 final-key files ecd2 writes
after privacy amplification (SURVEY.md Appendix A).  The TPU build's unit is
the (window, block) pair rather than the epoch, and keys append to one
binary stream file with self-describing records instead of one file per
epoch (the filesystem-as-queue mechanism is replaced by the in-process
pipeline; the durable artifact remains).

Record format (little-endian):
    u32 magic (0x51C07F17)   u32 window_id   u32 block_index
    u32 num_bits             u32 words[ceil(num_bits/32)]
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator

import numpy as np

from qtpu_torch.framing import pack_bits, unpack_bits

__all__ = ["KeyRecord", "write_keys", "read_keys", "KeyWriter"]

MAGIC = 0x51C07F17
_HEAD = struct.Struct("<IIiI")  # signed block_index: stream-PA records use -1 - flush_idx


@dataclasses.dataclass
class KeyRecord:
    window_id: int
    block_index: int
    bits: np.ndarray  # (num_bits,) uint8


class KeyWriter:
    """Appends final-key records as they are produced (durable artifact)."""

    def __init__(self, path: str):
        self._fh: BinaryIO = open(path, "ab")

    def append(self, rec: KeyRecord) -> None:
        words = pack_bits(rec.bits)
        self._fh.write(_HEAD.pack(MAGIC, rec.window_id, rec.block_index,
                                  len(rec.bits)))
        self._fh.write(words.tobytes())
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def write_keys(path: str, records: list[KeyRecord]) -> None:
    w = KeyWriter(path)
    for r in records:
        w.append(r)
    w.close()


def read_keys(path: str) -> Iterator[KeyRecord]:
    with open(path, "rb") as fh:
        while True:
            head = fh.read(_HEAD.size)
            if not head:
                return
            magic, window_id, block_index, num_bits = _HEAD.unpack(head)
            if magic != MAGIC:
                raise ValueError(f"bad key record magic {magic:#x}")
            nw = (num_bits + 31) // 32
            words = np.frombuffer(fh.read(nw * 4), np.uint32)
            yield KeyRecord(window_id=window_id, block_index=block_index,
                            bits=unpack_bits(words, num_bits))


def records_from_session(session) -> list[KeyRecord]:
    """Collect a pipeline session's final keys as addressable records
    (drains any device-resident key chunks first)."""
    session._drain_chunks()
    out = []
    for (w, b), bits in zip(session.final_key_index, session._final_host):
        out.append(KeyRecord(window_id=w, block_index=b, bits=bits))
    return out
