"""The session cell's reference: a block's final key worked out again from
the sifted bits, in plain NumPy.

Frozen copies of the protocol's definitions, independent of the program's
code: the SHA-256 key tree (``qtpu_torch/prng.py``: ``root_key``,
``derive``), the Threefry-2x32 cipher as ``jax.random`` runs it in its
partitionable mode (``fold_in(k, d) = threefry(k, (0, d))``, word j of
``bits`` = x0 ^ x1 of ``threefry(k, (0, j))``), and the Toeplitz hash
T[i, j] = t[i - j + n - 1] over GF(2).

A block's key: the window's PA key is ``derive(root_key(session_seed),
"pa", window, 0)``; block b's Toeplitz seed is the first n + l_max - 1
LSB-first bits of ``bits(fold_in(pa_key, b))``; the key is the first l
bits of the hash of the block's n payload bits, l the block's final
length.  The hash is an exact integer convolution (float64 FFT, whose
error at these lengths is far below 0.5) reduced mod 2.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = ["root_key", "derive", "pa_key", "seed_row", "toeplitz",
           "block_key"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _tag_bytes(p) -> bytes:
    if isinstance(p, str):
        b = p.encode("utf-8")
        return b"s" + struct.pack("<I", len(b)) + b
    return b"i" + struct.pack("<q", int(p))


def root_key(seed: int) -> np.ndarray:
    """The session's root key: the first 8 bytes of SHA-256 over a fixed
    tag and the seed's 64 bits, as two uint32 words."""
    h = hashlib.sha256(b"qtpu-root" + struct.pack(
        "<Q", seed & 0xFFFFFFFFFFFFFFFF)).digest()[:8]
    return np.frombuffer(h, dtype=np.uint32).copy()


def derive(key: np.ndarray, *path) -> np.ndarray:
    """A sub-key: SHA-256 chained over the path's tagged elements, each
    step truncated to 8 bytes."""
    data = np.asarray(key, np.uint32).tobytes()
    for p in path:
        data = hashlib.sha256(data + _tag_bytes(p)).digest()[:8]
    return np.frombuffer(data, dtype=np.uint32).copy()


def pa_key(session_seed: int, window: int) -> np.ndarray:
    return derive(root_key(session_seed), "pa", window, 0)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (wrapping arithmetic)."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def seed_row(key: np.ndarray, row: int, length: int) -> np.ndarray:
    """(length,) uint8 bits of ``bits(fold_in(key, row))``, LSB-first."""
    with np.errstate(over="ignore"):
        a, b = _threefry(key[0], key[1], np.zeros(1, np.uint32),
                         np.array([row & 0xFFFFFFFF], np.uint32))
        count = np.arange(-(-length // 32), dtype=np.uint32)
        x0, x1 = _threefry(a[0], b[0], np.zeros_like(count), count)
    words = x0 ^ x1
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(np.uint8).reshape(-1)[:length]


def toeplitz(t: np.ndarray, x: np.ndarray, m: int) -> np.ndarray:
    """(m,) uint8 GF(2) product T x, T[i, j] = t[i - j + n - 1], as an
    integer convolution by float64 real FFTs."""
    n = x.shape[0]
    L = 1 << (m + n - 2).bit_length()
    conv = np.fft.irfft(np.fft.rfft(t.astype(np.float64), L)
                        * np.fft.rfft(x.astype(np.float64), L),
                        L)[n - 1:n - 1 + m]
    return (np.rint(conv).astype(np.int64) & 1).astype(np.uint8)


def block_key(session_seed: int, window: int, block: int,
              payload: np.ndarray, l_max: int, length: int) -> np.ndarray:
    """The first ``length`` bits of block ``block``'s PA hash of window
    ``window`` over ``payload`` (its n sifted bits)."""
    n = payload.shape[0]
    t = seed_row(pa_key(session_seed, window), block, n + l_max - 1)
    return toeplitz(t, payload, l_max)[:length]
