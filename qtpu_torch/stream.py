"""Device-resident sifted-bit stream buffer.

Counterpart of ``qtpu/stream.py``: the stream lives in ONE ``torch.uint8``
arena (one byte per bit) on the session's device with host-side cursors, so
per-window framing is a slice of the arena inside the window programs.

- The arena has a capacity; it grows geometrically (4x) when a push or a
  static-size read would not fit even after compaction.
- Appends write at the write position in place; consumption is host
  bookkeeping only (cursor advance).
- Compaction (when the cursor nears capacity) rolls the unconsumed bits to
  offset 0.

The reference's pow2 upload buckets and bit-packed uploads existed to bound
XLA recompiles and tunnel traffic; PyTorch runs eagerly, so host bits are
copied in as they come.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeviceStream"]


class DeviceStream:
    """Append-only bit stream on a device with a host consumption cursor.

    ``strict_capacity=True`` turns arena growth into a hard error, for
    deployments sized from config that must fail loudly rather than
    reallocate on a burst of sifted input.  Growth is always counted in
    ``grow_events`` and warned once either way."""

    def __init__(self, capacity_bits: int = 1 << 22,
                 strict_capacity: bool = False, device="cpu"):
        cap = 1 << max(15, int(capacity_bits - 1).bit_length())
        self.device = torch.device(device)
        self.arena = torch.zeros((cap,), dtype=torch.uint8, device=self.device)
        self.start = 0   # first unconsumed bit (absolute arena offset)
        self.end = 0     # write position (absolute arena offset)
        self.total_pushed = 0
        self.strict_capacity = strict_capacity
        self.grow_events = 0

    # -- capacity management ---------------------------------------------

    @property
    def capacity(self) -> int:
        return int(self.arena.shape[0])

    @property
    def remaining(self) -> int:
        """Unconsumed bits available."""
        return self.end - self.start

    def _grow_arena(self) -> None:
        if self.strict_capacity:
            raise RuntimeError(
                f"DeviceStream arena would grow past its configured "
                f"capacity ({self.capacity} bits, start={self.start}, "
                f"end={self.end}) with strict_capacity=True — size "
                f"stream_capacity_bits for the peak backlog instead")
        self.grow_events += 1
        if self.grow_events == 1:
            import warnings
            warnings.warn(
                "DeviceStream arena grew beyond its configured capacity. "
                "Size stream_capacity_bits for the peak backlog.",
                RuntimeWarning, stacklevel=3)
        grown = torch.zeros((self.capacity * 4,), dtype=torch.uint8,
                            device=self.device)
        grown[:self.capacity] = self.arena
        self.arena = grown

    def _compact_arena(self) -> None:
        if self.start > 0:
            self.arena = torch.roll(self.arena, -self.start)
            self.end -= self.start
            self.start = 0

    def _make_room(self, tail_bits: int) -> None:
        """Ensure [end, end + tail_bits) fits in the arena: compact first
        (drop consumed prefix), then grow geometrically if still short."""
        if self.end + tail_bits <= self.capacity:
            return
        self._compact_arena()
        while self.end + tail_bits > self.capacity:
            self._grow_arena()

    def ensure_contiguous(self, read_bits: int) -> None:
        """Guarantee that a static-size read of ``read_bits`` starting at the
        cursor stays inside the arena."""
        if self.start + read_bits > self.capacity:
            self._compact_arena()   # moves the cursor to offset 0
        while self.start + read_bits > self.capacity:
            self._grow_arena()

    # -- appends ----------------------------------------------------------

    def push(self, bits, n: int | None = None) -> None:
        """Append bits: a host np.ndarray or a uint8 tensor (a tensor on the
        stream's device is written with no host round trip).

        ``n`` (tensors only): treat ``bits`` as a PADDED buffer whose first
        n entries are valid — only that prefix is appended."""
        if isinstance(bits, torch.Tensor):
            n = int(bits.shape[0]) if n is None else int(n)
            assert n <= bits.shape[0]
            src = bits[:n]
        else:
            assert n is None, "valid-prefix push is a tensor feature"
            src = torch.from_numpy(np.ascontiguousarray(bits, np.uint8))
            n = int(src.shape[0])
        if n == 0:
            return
        self._make_room(n)
        self.arena[self.end:self.end + n].copy_(src.to(torch.uint8))
        self.end += n
        self.total_pushed += n

    # -- consumption ------------------------------------------------------

    def consume(self, nbits: int) -> None:
        assert nbits <= self.remaining, (
            f"stream underflow: take {nbits} > buffered {self.remaining}")
        self.start += nbits

    def peek_host(self, nbits: int, offset: int = 0) -> np.ndarray:
        """Host copy of unconsumed bits [offset, offset+nbits) — tests and
        checkpointing only (forces a device→host transfer)."""
        assert offset + nbits <= self.remaining
        lo = self.start + offset
        return self.arena[lo:lo + nbits].cpu().numpy()

    def snapshot_host(self) -> np.ndarray:
        """All unconsumed bits as host array (checkpointing)."""
        return self.peek_host(self.remaining)
