"""Threefry-2x32 protocol randomness, bit-exact with ``jax.random``.

Counterpart of the ``jax.random`` calls in ``qtpu/window_programs.py``
(``wrap_key_data``, ``fold_in``, ``bits`` and ``randint`` on the default
threefry2x32 implementation with ``jax_threefry_partitionable=True``).  Both
parties derive the shortening fill, the verify seed, the per-block test
offsets, Alice's puncture pad and the PA seeds from these streams, so a port
that differed by one bit would disagree with the reference on every seed.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 key
words; every value stays in [0, 2^32) and each uint32 operation is an int64
operation masked back to 32 bits (PyTorch covers uint32 arithmetic only
partly).  All functions are batched over the key's leading dimensions and
run on the key's device.

The partitionable mode (JAX >= 0.5 default) counts with a 64-bit iota split
into (hi, lo) uint32 words, so for every shape below 2^32 elements:

    fold_in(k, d)      = threefry(k, (0, d))                 (both words)
    split(k, n)[i]     = threefry(k, (0, i))                 (both words)
    bits(k, (W,))[j]   = x0 ^ x1  where (x0, x1) = threefry(k, (0, j))
"""

from __future__ import annotations

import torch

__all__ = ["key_from_data", "threefry2x32", "fold_in", "split", "bits32",
           "uniform", "randint", "seed_rows"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_from_data(data, device) -> torch.Tensor:
    """(2,) int64 key from raw uint32 key data (``jax.random.wrap_key_data``),
    written by two scalar fills: no copy from host memory, so a CUDA key
    costs no host sync."""
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[0], key[1] = int(data[0]), int(data[1])
    return key


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), elementwise with
    broadcasting; all arguments int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def _hash(key: torch.Tensor, count: torch.Tensor):
    """threefry(key, (0, count)) broadcast over key[..., None] x count."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    return threefry2x32(k0, k1, torch.zeros_like(count), count)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (2,) with data (N,) -> keys (N, 2); or
    keys (..., 2) with a scalar -> keys (..., 2)."""
    if isinstance(data, int):
        x0, x1 = _hash(key, torch.full((1,), data & _M32, dtype=torch.int64,
                                       device=key.device))
        return torch.cat([x0, x1], dim=-1)
    x0, x1 = _hash(key, data.to(torch.int64) & _M32)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (foldlike): keys (..., num, 2)."""
    count = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = _hash(key, count)
    return torch.stack([x0, x1], dim=-1)


def bits32(key: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.bits(key, (width,), uint32)``: (..., width) int64."""
    count = torch.arange(width, dtype=torch.int64, device=key.device)
    x0, x1 = _hash(key, count)
    return x0 ^ x1


def uniform(key: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.uniform(key, (width,))`` (float32 in [0, 1)): the top 23
    bits of each word as a float32 mantissa in [1, 2), minus one."""
    mant = (bits32(key, width) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, span: int) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, span, uint32)`` per key: (...,)
    int64.  Reproduces JAX's two-word remainder construction, including
    its uint32 wraparound."""
    assert 0 < span < 1 << 32
    ks = split(key, 2)
    higher = bits32(ks[..., 0, :], 1)[..., 0]
    lower = bits32(ks[..., 1, :], 1)[..., 0]
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((higher % span) * multiplier) & _M32
    offset = (offset + lower % span) & _M32
    return offset % span


def seed_rows(key: torch.Tensor, idx: torch.Tensor, length: int) -> torch.Tensor:
    """(len(idx), length) uint8 protocol bits: row i is the LSB-first bit
    expansion of ``bits(fold_in(key, idx[i]), (ceil(length/32),))``
    (``_seed_rows`` / ``_seed_rows_at`` of the reference)."""
    width = -(-length // 32)
    words = bits32(fold_in(key, idx), width)                   # (b, W)
    shifts = torch.arange(32, dtype=torch.int64, device=key.device)
    bits = ((words[:, :, None] >> shifts) & 1).to(torch.uint8)
    return bits.reshape(idx.shape[0], width * 32)[:, :length]
