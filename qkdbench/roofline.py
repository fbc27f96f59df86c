"""The least time the card could take for a kernel's work: frozen copies of
``chip_smoke.py``'s ``decode_bound`` and ``toeplitz_bound``, stated
against the published peaks of an NVIDIA H100 SXM (80 GB HBM3, 700 W
board power).  A card set to a lower power limit runs slower under load
than these peaks: every run prints the card's name and power limit beside
its shares.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "OPS_PER_EDGE_LANE",
           "decode_bound_s", "toeplitz_bound_s"]

# The data sheet's HBM3 bandwidth and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# One min-sum edge-lane update (v2c = t - c2v, |v2c|, two compares for
# min1 / min2, the sign product, alpha * min, c2v' - c2v, the total's add,
# the parity) counted as 10 float32 operations.
OPS_PER_EDGE_LANE = 10


def decode_bound_s(n: int, m: int, mb: int, num_edges: int, z: int, B: int,
                   iters_sum: int) -> float:
    """Seconds of one layered decode launch of B blocks at the card's
    peaks: the larger of its bytes (llr, syndrome and the code table read
    once; bits, converged and iterations written once) and its operations
    (the edge-lane updates of the sweeps its blocks ran, ``iters_sum``
    over the batch)."""
    nbytes = B * (4 * n + m + n + 1 + 4) + 4 * (mb + 1 + 2 * num_edges)
    ops = iters_sum * num_edges * z * OPS_PER_EDGE_LANE
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def toeplitz_bound_s(B: int, n: int, m: int) -> float:
    """Seconds of the per-block PA hash of B blocks, (B, n) x (B, m + n - 1)
    -> (B, m) bits, as an FFT convolution of length L = the power of two
    above m + n - 2: the larger of its bytes (both inputs read and the
    output written once, a byte a bit) and its operations (2.5 L log2 L a
    real FFT, three of them, and 6 a product of the L / 2 + 1 complex
    bins)."""
    L = 1 << (m + n - 2).bit_length()
    flops = B * (3 * 2.5 * L * (L.bit_length() - 1) + 6 * (L // 2 + 1))
    nbytes = B * ((m + n - 1) + n + m)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S)
