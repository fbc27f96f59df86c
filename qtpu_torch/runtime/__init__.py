"""Native runtime components (C++) with ctypes bindings.

Counterpart of ``qtpu/runtime``: the classical-channel transport and the
raw-event codec, native C++ behind the same Python interfaces as the
reference:

- `NativeTcpLink` — epoll/background-thread message channel, wire-compatible
  with qtpu_torch.link.TcpLink (4-byte length-prefixed frames).
- `pack_events` / `unpack_events` / `split_epochs` / `pack_bits_native` —
  the 64-bit raw-event record codec and epoch boundary scan.

The sources (``native/*.cpp``, byte copies of the reference's) build with
the system ``c++`` at first use into ``build/qtpu_torch/`` at the repository
root: one library per source, named by a hash of the source and the flags,
written through a per-process temporary file, so two processes starting
together never race on a half-written library.  A failed build raises
`NativeUnavailable`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "NativeUnavailable", "native_available", "NativeTcpLink",
    "pack_events", "unpack_events", "split_epochs", "pack_bits_native",
]

_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = _DIR.parent.parent.parent / "build" / "qtpu_torch"
# The reference's Makefile flags; transferd needs pthreads.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    pass


def _load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``native/<name>.cpp`` as lib<name>."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = _DIR / f"{name}.cpp"
        tag = hashlib.sha256(src.read_bytes()
                             + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
        so = BUILD_DIR / f"libqtpu_{name}-{tag}.so"
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["c++", *CXX_FLAGS, "-o", str(tmp), str(src),
                                "-lpthread"],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except subprocess.CalledProcessError as e:
            raise NativeUnavailable(
                f"could not build {src.name}: {e.stderr}") from e
        except OSError as e:
            raise NativeUnavailable(f"could not build/load {name}: {e}") from e
        _LIBS[name] = lib
        return lib


def native_available() -> bool:
    try:
        _load("framing")
        return True
    except NativeUnavailable:
        return False


# ---------------------------------------------------------------------------
# transferd binding
# ---------------------------------------------------------------------------

def _td() -> ctypes.CDLL:
    lib = _load("transferd")
    if not getattr(lib, "_qtpu_sigs", False):
        lib.td_listen.restype = ctypes.c_void_p
        lib.td_listen.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.td_connect.restype = ctypes.c_void_p
        lib.td_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.td_send.restype = ctypes.c_int
        lib.td_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.td_recv.restype = ctypes.c_long
        lib.td_recv.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32, ctypes.c_int]
        lib.td_pending.restype = ctypes.c_int
        lib.td_pending.argtypes = [ctypes.c_void_p]
        lib.td_bytes_sent.restype = ctypes.c_uint64
        lib.td_bytes_sent.argtypes = [ctypes.c_void_p]
        lib.td_bytes_received.restype = ctypes.c_uint64
        lib.td_bytes_received.argtypes = [ctypes.c_void_p]
        lib.td_close.argtypes = [ctypes.c_void_p]
        lib._qtpu_sigs = True
    return lib


class NativeTcpLink:
    """Drop-in for qtpu_torch.link.TcpLink backed by the C++ transferd
    library.

    Sends never block the caller (background I/O thread owns the socket);
    receives pop completed frames from the native queue.
    """

    MAX_FRAME = 64 * 1024 * 1024

    def __init__(self, handle: int):
        self._lib = _td()
        self._h = handle
        self._buf = ctypes.create_string_buffer(1 << 20)

    @classmethod
    def listen(cls, host: str, port: int) -> "NativeTcpLink":
        h = _td().td_listen(host.encode(), port)
        if not h:
            raise ConnectionError(f"td_listen failed on {host}:{port}")
        return cls(h)

    @classmethod
    def connect(cls, host: str, port: int, retries: int = 50) -> "NativeTcpLink":
        h = _td().td_connect(host.encode(), port, retries)
        if not h:
            raise ConnectionError(f"td_connect failed to {host}:{port}")
        return cls(h)

    def send_bytes(self, data: bytes) -> None:
        if self._lib.td_send(self._h, data, len(data)) != 0:
            raise ConnectionError("native link is dead")

    def recv_bytes(self, timeout: Optional[float] = None) -> Optional[bytes]:
        ms = int((timeout or 0.0) * 1000)
        n = self._lib.td_recv(self._h, self._buf, len(self._buf), ms)
        if n == 0:
            return None
        if n == -1:
            raise ConnectionError("peer closed")
        if n == -2:
            # Frame larger than the scratch buffer: grow and retry.
            if len(self._buf) * 2 > self.MAX_FRAME:
                raise ValueError("frame exceeds MAX_FRAME")
            self._buf = ctypes.create_string_buffer(len(self._buf) * 2)
            return self.recv_bytes(timeout)
        return self._buf.raw[:n]

    def send(self, msg) -> None:
        from qtpu_torch.messages import pack_message
        self.send_bytes(pack_message(msg))

    def recv(self, timeout: Optional[float] = None):
        from qtpu_torch.messages import unpack_message
        data = self.recv_bytes(timeout)
        return None if data is None else unpack_message(data)

    def pending(self) -> int:
        return self._lib.td_pending(self._h)

    @property
    def bytes_sent(self) -> int:
        return self._lib.td_bytes_sent(self._h)

    @property
    def bytes_received(self) -> int:
        return self._lib.td_bytes_received(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.td_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# framing binding
# ---------------------------------------------------------------------------

def _fr() -> ctypes.CDLL:
    lib = _load("framing")
    if not getattr(lib, "_qtpu_sigs", False):
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        lib.fr_pack_events.argtypes = [i64p, u8p, ctypes.c_int64, u64p]
        lib.fr_unpack_events.argtypes = [u64p, ctypes.c_int64, i64p, u8p]
        lib.fr_split_epochs.restype = ctypes.c_int64
        lib.fr_split_epochs.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                        u32p, i64p, i64p, ctypes.c_int64]
        lib.fr_pack_bits.argtypes = [u8p, ctypes.c_int64, u32p]
        lib._qtpu_sigs = True
    return lib


def pack_events(times: np.ndarray, dets: np.ndarray) -> np.ndarray:
    """(times int64, dets uint8) → 64-bit raw event records."""
    times = np.ascontiguousarray(times, np.int64)
    dets = np.ascontiguousarray(dets, np.uint8)
    out = np.empty(len(times), np.uint64)
    _fr().fr_pack_events(times, dets, len(times), out)
    return out


def unpack_events(records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    records = np.ascontiguousarray(records, np.uint64)
    times = np.empty(len(records), np.int64)
    dets = np.empty(len(records), np.uint8)
    _fr().fr_unpack_events(records, len(records), times, dets)
    return times, dets


def split_epochs(times: np.ndarray, units_per_epoch: int):
    """Sorted times → list of (epoch_id, start_index, count)."""
    times = np.ascontiguousarray(times, np.int64)
    cap = len(times) + 1
    ids = np.empty(cap, np.uint32)
    starts = np.empty(cap, np.int64)
    counts = np.empty(cap, np.int64)
    n = _fr().fr_split_epochs(times, len(times), units_per_epoch,
                              ids, starts, counts, cap)
    if n < 0:
        raise RuntimeError("split_epochs overflow")
    return [(int(ids[i]), int(starts[i]), int(counts[i])) for i in range(n)]


def pack_bits_native(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, np.uint8)
    words = np.empty((len(bits) + 31) // 32, np.uint32)
    _fr().fr_pack_bits(bits, len(bits), words)
    return words
