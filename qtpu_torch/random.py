"""Threefry-2x32 protocol randomness, bit-exact with ``jax.random``.

Counterpart of the ``jax.random`` calls in ``qtpu/window_programs.py``
(``wrap_key_data``, ``fold_in``, ``bits`` and ``randint`` on the default
threefry2x32 implementation with ``jax_threefry_partitionable=True``).  Both
parties derive the shortening fill, the verify seed, the per-block test
offsets, Alice's puncture pad and the PA seeds from these streams, so a port
that differed by one bit would disagree with the reference on every seed.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32 key
words; every value stays in [0, 2^32).  All functions are batched over the
key's leading dimensions and run on the key's device (or on ``device``).

The partitionable mode (JAX >= 0.5 default) counts with a 64-bit iota split
into (hi, lo) uint32 words, so for every shape below 2^32 elements:

    fold_in(k, d)      = threefry(k, (0, d))                 (both words)
    split(k, n)[i]     = threefry(k, (0, i))                 (both words)
    bits(k, (W,))[j]   = x0 ^ x1  where (x0, x1) = threefry(k, (0, j))

On a CPU tensor (or ``device="cpu"``) each function runs its plain PyTorch
version (the ``*_plain`` functions: each uint32 operation an int64
operation masked back to 32 bits, as PyTorch covers uint32 arithmetic only
partly).  On a CUDA tensor it launches the hand-written kernel
``qtpu_torch/csrc/threefry.cu`` (built at first use by
``qtpu_torch._build``, bound with ctypes) or raises; ``launches`` counts
each of its two entry points' launches.  The plain versions run on any
device and are the kernel's oracle.

The window programs draw through a table of fused draws, whose key words
come from the host (no device key tensor, no fill): ``draws`` takes up to
``MAX_DRAWS`` of them, each ``SeedRows`` (LSB-first bit rows of
``bits(fold_in(... fold_in(key, tag) ..., row), W)``) or ``Randint``
(``randint`` on the same row keys), and makes all of them in one launch;
a program passes every draw it needs in one table.  ``seed_rows_at`` and
``randint_at`` are its one-draw tables.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qtpu_torch import _build

__all__ = ["key_from_data", "fold_in", "split", "bits32", "uniform",
           "SeedRows", "Randint", "draws", "seed_rows_at", "randint_at",
           "fold_in_plain", "split_plain", "bits32_plain", "draws_plain",
           "seed_rows_at_plain", "randint_at_plain", "launches", "LIBRARY",
           "MAX_DRAWS"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# The kernel library (qtpu_torch/csrc/threefry.cu) and the launches of each
# of its entry points since import (or since a caller reset them).
LIBRARY = "threefry"
launches = {"threefry_draws": 0, "threefry_hash": 0}

# The most draws one table (one launch) takes: csrc/threefry.cu's kMaxDraws.
MAX_DRAWS = 8

_U32, _INT, _LL, _PTR = (ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_void_p)
_ARGTYPES = {
    # the table (host array of _DrawEntry), its length; stream
    "threefry_draws": (_PTR, _INT, _PTR),
    # keys, K, counts, count0, W, pair, out; stream
    "threefry_hash": (_PTR, _LL, _PTR, _U32, _LL, _INT, _PTR, _PTR),
}


class _DrawEntry(ctypes.Structure):
    """One draw of a table: csrc/threefry.cu's ``QtpuDraw``, field for
    field."""
    _fields_ = [("kind", ctypes.c_int32), ("ntags", ctypes.c_int32),
                ("key", _U32 * 2), ("tag", _U32 * 2), ("rows", _PTR),
                ("row0", _U32), ("b", ctypes.c_int32), ("size", _LL),
                ("out", _PTR)]


_SEED_ROWS, _RANDINT = 0, 1     # QtpuDraw's kinds


class SeedRows(NamedTuple):
    """A draw of (b, length) uint8 protocol bits (``seed_rows_at``'s
    arguments)."""
    key_words: object
    tags: tuple
    rows: object
    length: int


class Randint(NamedTuple):
    """A draw of (b,) int64 offsets in [0, span) (``randint_at``'s
    arguments)."""
    key_words: object
    tags: tuple
    rows: object
    span: int


def key_from_data(data, device) -> torch.Tensor:
    """(2,) int64 key from raw uint32 key data (``jax.random.wrap_key_data``),
    written by two scalar fills: no copy from host memory, so a CUDA key
    costs no host sync."""
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[0], key[1] = int(data[0]), int(data[1])
    return key


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the CPU path and the kernel's oracle.

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
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


def _hash_plain(key: torch.Tensor, count: torch.Tensor):
    """threefry(key, (0, count)) broadcast over key[..., None] x count."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    return _threefry2x32(k0, k1, torch.zeros_like(count), count)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in``'s plain version, on any device."""
    if isinstance(data, int):
        x0, x1 = _hash_plain(key, torch.full((1,), data & _M32,
                                             dtype=torch.int64,
                                             device=key.device))
        return torch.cat([x0, x1], dim=-1)
    x0, x1 = _hash_plain(key, data.to(torch.int64) & _M32)
    return torch.stack([x0, x1], dim=-1)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split``'s plain version, on any device."""
    count = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = _hash_plain(key, count)
    return torch.stack([x0, x1], dim=-1)


def bits32_plain(key: torch.Tensor, width: int) -> torch.Tensor:
    """``bits32``'s plain version, on any device."""
    count = torch.arange(width, dtype=torch.int64, device=key.device)
    x0, x1 = _hash_plain(key, count)
    return x0 ^ x1


def _unpack(words: torch.Tensor, length: int) -> torch.Tensor:
    """(b, W) uint32 words -> (b, length) uint8 bits, LSB-first."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).to(torch.uint8)
    return bits.reshape(words.shape[0], 32 * words.shape[1])[:, :length]


def _randint_plain(key: torch.Tensor, span: int) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, span, uint32)`` per key: JAX's
    two-word remainder construction, including its uint32 wraparound."""
    if not 0 < span < 1 << 32:
        raise ValueError(f"span {span} outside (0, 2^32)")
    ks = split_plain(key, 2)
    higher = bits32_plain(ks[..., 0, :], 1)[..., 0]
    lower = bits32_plain(ks[..., 1, :], 1)[..., 0]
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = ((higher % span) * multiplier) & _M32
    offset = (offset + lower % span) & _M32
    return offset % span


def _row_index(rows, device) -> torch.Tensor:
    if isinstance(rows, range):
        return torch.arange(rows.start, rows.stop, rows.step,
                            dtype=torch.int64, device=device)
    return rows


def _tagged_plain(key_words, tags, device) -> torch.Tensor:
    key = key_from_data(key_words, device)
    for tag in tags:
        key = fold_in_plain(key, int(tag))
    return key


def seed_rows_at_plain(key_words, tags, rows, length: int,
                       device) -> torch.Tensor:
    """``seed_rows_at``'s plain version (the reference's composition), on
    any device."""
    keys = fold_in_plain(_tagged_plain(key_words, tags, device),
                         _row_index(rows, device))
    return _unpack(bits32_plain(keys, -(-length // 32)), length)


def randint_at_plain(key_words, tags, rows, span: int,
                     device) -> torch.Tensor:
    """``randint_at``'s plain version (the reference's composition), on any
    device."""
    keys = fold_in_plain(_tagged_plain(key_words, tags, device),
                         _row_index(rows, device))
    return _randint_plain(keys, span)


def draws_plain(table, device) -> list:
    """``draws``' plain version, on any device: each draw by its own plain
    function."""
    return [seed_rows_at_plain(*d, device) if isinstance(d, SeedRows)
            else randint_at_plain(*d, device) for d in table]


# ---------------------------------------------------------------------------
# The kernel's wrapper.

def _on_card(device: torch.device) -> bool:
    return _build.on_card(device, "threefry")


def _check(t: torch.Tensor, what: str, ndim=None) -> None:
    """An int64 contiguous tensor on a CUDA device (of ``ndim`` dims)."""
    if t.dtype != torch.int64:
        raise ValueError(f"{what} must be int64, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dimension(s), got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{what} is on {t.device}, the kernel needs a CUDA "
                         f"tensor")


def _hash(key: torch.Tensor, width: int, pair: bool, counts=None,
          count0: int = 0) -> torch.Tensor:
    """threefry(key, (0, c_j)) for j < width, c_j = counts[j] or count0 + j:
    (..., width, 2) words when ``pair``, else (..., width) x0 ^ x1."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"key must be (..., 2), got {tuple(key.shape)}")
    _check(key, "key")
    if counts is not None and counts.device != key.device:
        raise ValueError(f"data on {counts.device}, key on {key.device}")
    _build.entry(LIBRARY, "threefry_hash", _ARGTYPES["threefry_hash"])
    shape = key.shape[:-1] + ((width, 2) if pair else (width,))
    out = torch.empty(shape, dtype=torch.int64, device=key.device)
    K = key.numel() // 2
    if K and width:
        _build.launch(LIBRARY, "threefry_hash", _ARGTYPES["threefry_hash"],
                      launches, key.device, key.data_ptr(), K,
                      None if counts is None else counts.data_ptr(),
                      count0 & _M32, width, int(pair), out.data_ptr())
    return out


def _row_args(key_words, tags, rows, device):
    """(k0, k1, tag count, tag0, tag1, index or None, row0, b, device) of a
    fused call: ``rows`` a ``range`` of step 1, or a CUDA int64 (b,)
    index."""
    k0, k1 = (int(w) & _M32 for w in key_words)
    tags = [int(t) & _M32 for t in tags]
    if len(tags) > 2:
        raise ValueError(f"at most two tags, got {len(tags)}")
    tag0, tag1 = (tags + [0, 0])[:2]
    if isinstance(rows, range):
        if rows.step != 1:
            raise ValueError(f"rows must be a range of step 1, got {rows}")
        return (k0, k1, len(tags), tag0, tag1, None, rows.start & _M32,
                len(rows), device)
    _check(rows, "rows", ndim=1)
    if device.index is not None and rows.device != device:
        raise ValueError(f"rows on {rows.device}, asked for {device}")
    return (k0, k1, len(tags), tag0, tag1, rows, 0, rows.shape[0],
            rows.device)


# ---------------------------------------------------------------------------
# The public functions: plain on the CPU, the kernel on a card.

def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) with data (N,) -> keys
    (..., N, 2); or keys (..., 2) with a scalar -> keys (..., 2)."""
    if not _on_card(key.device):
        return fold_in_plain(key, data)
    if isinstance(data, int):
        return _hash(key, 1, True, count0=data).reshape(key.shape)
    _check(data, "data", ndim=1)
    return _hash(key, data.shape[0], True, counts=data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (foldlike): keys (..., num, 2)."""
    if not _on_card(key.device):
        return split_plain(key, num)
    return _hash(key, num, True)


def bits32(key: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.bits(key, (width,), uint32)``: (..., width) int64."""
    if not _on_card(key.device):
        return bits32_plain(key, width)
    return _hash(key, width, False)


def uniform(key: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.uniform(key, (width,))`` (float32 in [0, 1)): the top 23
    bits of each word as a float32 mantissa in [1, 2), minus one."""
    mant = (bits32(key, width) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def draws(table, device) -> list:
    """Each draw of ``table`` (up to ``MAX_DRAWS`` ``SeedRows`` and
    ``Randint``, whose ``rows`` are a ``range`` of step 1 or a CUDA int64
    (b,) index on ``device``): the list of their outputs, each as
    ``seed_rows_at`` or ``randint_at`` would return it.  One launch on a
    card for the whole table."""
    dev = torch.device(device)
    if not _on_card(dev):
        return draws_plain(table, dev)
    if len(table) > MAX_DRAWS:
        raise ValueError(f"at most {MAX_DRAWS} draws a table, got "
                         f"{len(table)}")
    args = []
    for d in table:
        if not isinstance(d, (SeedRows, Randint)):
            raise ValueError(f"a draw is a SeedRows or a Randint, not {d!r}")
        seed = isinstance(d, SeedRows)
        size = int(d.length) if seed else int(d.span)
        if not seed and not 0 < size < 1 << 32:
            raise ValueError(f"span {size} outside (0, 2^32)")
        args.append((seed, size, *_row_args(d.key_words, d.tags, d.rows,
                                            dev)))
    _build.entry(LIBRARY, "threefry_draws", _ARGTYPES["threefry_draws"])
    outs, entries = [], []
    for seed, size, k0, k1, nt, t0, t1, idx, row0, b, ddev in args:
        out = torch.empty((b, size) if seed else (b,),
                          dtype=torch.uint8 if seed else torch.int64,
                          device=ddev)
        if outs and out.device != outs[0].device:
            raise ValueError(f"draws on {outs[0].device} and {out.device} "
                             f"in one table")
        outs.append(out)
        if out.numel():
            entries.append(_DrawEntry(
                _SEED_ROWS if seed else _RANDINT, nt, (k0, k1), (t0, t1),
                None if idx is None else idx.data_ptr(), row0, b, size,
                out.data_ptr()))
    if entries:
        arr = (_DrawEntry * len(entries))(*entries)
        _build.launch(LIBRARY, "threefry_draws", _ARGTYPES["threefry_draws"],
                      launches, outs[0].device, ctypes.addressof(arr),
                      len(entries))
    return outs


def seed_rows_at(key_words, tags, rows, length: int, device) -> torch.Tensor:
    """(b, length) uint8 protocol bits: row i is the LSB-first bit expansion
    of ``bits(fold_in(... fold_in(key, tags[0]) ..., row_i), W)``,
    W = ceil(length / 32), for the key of uint32 words ``key_words`` (host
    values) and 0-2 ``tags``.  ``rows``: a ``range`` (row_i = rows[i], the
    global block index) or a CUDA int64 (b,) index tensor.  A one-draw
    table: one launch on a card."""
    return draws([SeedRows(key_words, tags, rows, length)], device)[0]


def randint_at(key_words, tags, rows, span: int, device) -> torch.Tensor:
    """(b,) int64 draws of ``jax.random.randint(k_i, (), 0, span, uint32)``
    on the row keys of ``seed_rows_at`` (same arguments).  A one-draw
    table: one launch on a card."""
    return draws([Randint(key_words, tags, rows, span)], device)[0]
