"""Privacy amplification: Toeplitz hashing as FFT convolution, in PyTorch.

Counterpart of ``qtpu/pa.py`` and the port's only FFT Toeplitz hash (the
window programs' per-block PA calls ``_toeplitz_hash`` from here).  A
Toeplitz matrix T ∈ GF(2)^{m×n} built from bits t_0..t_{m+n-2}
(T[i,j] = t[i - j + n - 1]) acting on key x is a linear convolution:

    (T x)_i = Σ_j t[i - j + n - 1] · x_j = (t * x)[i + n - 1]   (mod 2)

so the hash is one real-FFT multiply (``torch.fft``: cuFFT on a CUDA
tensor), batched over blocks.  The convolution counts are integers; the
hash rounds them and reduces mod 2, which is the exact GF(2) product while
every count computed lies within 0.25 of its integer (``toeplitz_margin``).

Streaming: one Toeplitz seed spanning a long key stream is applied segment
by segment (``stream_toeplitz``), each segment's rounded contribution added
in int32 and reduced mod 2 at the end.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = [
    "toeplitz_hash_golden",
    "make_toeplitz_hasher",
    "toeplitz_hash_fft",
    "stream_toeplitz",
    "stream_counts",
    "stream_margin",
    "final_key_length",
    "toeplitz_margin",
]


def toeplitz_hash_golden(t_bits: np.ndarray, x_bits: np.ndarray, m: int) -> np.ndarray:
    """Direct GF(2) Toeplitz mat-vec (numpy golden model).

    t_bits: (m + n - 1,) 0/1 — first column then first row of T.
    x_bits: (n,) 0/1.  Returns (m,) 0/1.
    """
    t_bits = np.asarray(t_bits, np.uint8)
    x = np.asarray(x_bits, np.int64)
    n = x.shape[0]
    assert t_bits.shape[0] == m + n - 1
    out = np.zeros(m, np.int64)
    # T[i, j] = t[i - j + n - 1]
    for i in range(m):
        out[i] = int(np.dot(t_bits[i + n - 1 - np.arange(n)].astype(np.int64), x)) & 1
    return out.astype(np.uint8)


def _toeplitz_conv(t_bits: torch.Tensor, x_bits: torch.Tensor, m: int,
                   precision: torch.dtype = torch.float32) -> torch.Tensor:
    """Rows of the linear convolution t * x over the extracted segment
    [n-1, n-1+m), as ``precision`` values that are integers up to FFT error.

    A cyclic convolution of length L aliases linear index k with k+L; the
    linear convolution's support ends at m+2n-3, so the segment is alias-
    free whenever L >= m+n-1."""
    n = x_bits.shape[-1]
    L = 1 << (m + n - 2).bit_length()
    tf = torch.fft.rfft(t_bits.to(precision), L, dim=-1)
    xf = torch.fft.rfft(x_bits.to(precision), L, dim=-1)
    conv = torch.fft.irfft(tf * xf, L, dim=-1)
    return conv[..., n - 1:n - 1 + m]


def _toeplitz_hash(t_bits: torch.Tensor, x_bits: torch.Tensor, m: int,
                   precision: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched FFT Toeplitz hash ((B, n) x (B, m+n-1) -> (B, m) uint8).
    Exact while every convolution value lies within 0.25 of its integer
    (``toeplitz_margin``): the output is then the exact GF(2) product,
    whatever FFT computed it."""
    seg = _toeplitz_conv(t_bits, x_bits, m, precision)
    return (torch.round(seg).to(torch.int32) & 1).to(torch.uint8)


def toeplitz_margin(t_bits, x_bits, m: int,
                    precision: torch.dtype = torch.float32) -> float:
    """max |conv − round(conv)| of the FFT path over the extracted segment
    — the integer-exactness margin the 2-universal-hash security property
    rides on.  Must stay well below 0.5 (< 0.25 is required)."""
    seg = _toeplitz_conv(torch.as_tensor(t_bits), torch.as_tensor(x_bits), m,
                         precision)
    return float((seg - torch.round(seg)).abs().max())


def toeplitz_hash_fft(t_bits: torch.Tensor, x_bits: torch.Tensor, m: int,
                      precision: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched FFT Toeplitz hash.

    t_bits: (B, m + n - 1) or (m + n - 1,) 0/1 — per-block Toeplitz seeds.
    x_bits: (B, n) or (n,) 0/1 on the same device.
    Returns (B, m) uint8.
    """
    x_bits = torch.atleast_2d(x_bits)
    if t_bits.ndim == 1:
        t_bits = t_bits[None].expand(x_bits.shape[0], t_bits.shape[0])
    return _toeplitz_hash(t_bits, x_bits, m, precision)


def make_toeplitz_hasher(n: int, m: int, precision: torch.dtype = torch.float32):
    """Batched hasher for fixed (n → m) compression."""

    def hasher(t_bits: torch.Tensor, x_bits: torch.Tensor) -> torch.Tensor:
        return toeplitz_hash_fft(t_bits, x_bits, m, precision)

    return hasher


def _stream_segments(t_bits: torch.Tensor, stream: torch.Tensor, m: int,
                     segment: int, precision: torch.dtype
                     ) -> Iterator[torch.Tensor]:
    """Each segment's (m,) contribution to the stream hash, unrounded.

    Segment s (bits [sL, sL+L)) needs t indices (N - 1 + i) - j for j in
    [sL, sL+L), i in [0, m): the slice of length m + L - 1 starting at
    N - L - sL.  Its counts are at most L."""
    N = stream.shape[0]
    L = min(segment, N)
    assert N % L == 0, "pad the stream to a segment multiple"
    for s in range(N // L):
        start = N - L - s * L
        yield _toeplitz_conv(t_bits[start:start + m + L - 1],
                             stream[s * L:(s + 1) * L], m, precision)


def stream_counts(t_bits: torch.Tensor, stream: torch.Tensor, m: int,
                  segment: int = 1 << 20,
                  precision: torch.dtype = torch.float32) -> torch.Tensor:
    """The (m,) int32 counts of ``stream_toeplitz`` before the mod 2: each
    segment's contribution rounded and added in int32 (exact).  A sharded
    hash (``qtpu_torch.parallel``) adds these over its shards first."""
    acc = torch.zeros(m, dtype=torch.int32, device=stream.device)
    for contrib in _stream_segments(t_bits, stream, m, segment, precision):
        acc += torch.round(contrib).to(torch.int32)
    return acc


def stream_toeplitz(t_bits: torch.Tensor, stream: torch.Tensor, m: int,
                    segment: int = 1 << 20,
                    precision: torch.dtype = torch.float32) -> torch.Tensor:
    """Streaming Toeplitz hash of one LONG key stream (overlap-save).

    When one Toeplitz seed must span a whole key stream, the stream is
    processed in ``segment``-bit windows, each contributing its partial
    linear convolution to the m-bit output:

        (T x)_i = Σ_s  conv(t[slice_s], x_s)[i]      (mod 2 after the sum)

    Each contribution is rounded and added in int32 (exact); mod 2 at the
    end.  Exact while every segment's counts come within 0.25 of their
    integers (``stream_margin``); float64 holds that at any stream a
    session hashes.

    t_bits: (m + N - 1,) seed; stream: (N,) 0/1 on the same device, with N
    a multiple of ``segment`` (pad with zeros — zero bits add nothing).
    """
    counts = stream_counts(t_bits, stream, m, segment, precision)
    return (counts & 1).to(torch.uint8)


def stream_margin(t_bits: torch.Tensor, stream: torch.Tensor, m: int,
                  segment: int = 1 << 20,
                  precision: torch.dtype = torch.float32) -> float:
    """max |contribution − round(contribution)| over every segment of
    ``stream_toeplitz`` at this precision (< 0.25 is required)."""
    worst = torch.zeros((), dtype=precision, device=stream.device)
    for contrib in _stream_segments(t_bits, stream, m, segment, precision):
        worst = torch.maximum(worst, (contrib - torch.round(contrib)).abs().max())
    return float(worst)


def final_key_length(n_reconciled: int, leaked_syndrome: int, leaked_qber: int,
                     verify_hash_bits: int, security_bits: int = 64) -> int:
    """Final-key length after subtracting every disclosed bit plus the
    ε-security margin (SURVEY.md Appendix B; reference priv_amp accounting)."""
    return max(0, n_reconciled - leaked_syndrome - leaked_qber
               - verify_hash_bits - security_bits)
