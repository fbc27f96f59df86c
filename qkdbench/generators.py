"""The benchmark's own inputs, made on the device from ``--seed`` with
torch's Philox generator, in a few large calls: the same seed gives the
same inputs on the same device."""

from __future__ import annotations

import math

__all__ = ["generator", "bsc_pool", "bsc_words", "llr"]

PIECE = 1 << 27


def generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (any whole
    number; folded into 63 bits)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def bsc_pool(seed: int, qber: float, bits: int, device):
    """(alice, bob): two (bits,) uint8 tensors on ``device``, Alice's bits
    uniform and Bob's each flipped with probability ``qber`` (a binary
    symmetric channel, the sift stage's output)."""
    import torch
    g = generator(seed, device)
    a = torch.empty(bits, dtype=torch.uint8, device=device)
    b = torch.empty(bits, dtype=torch.uint8, device=device)
    for lo in range(0, bits, PIECE):
        hi = min(bits, lo + PIECE)
        a[lo:hi] = torch.randint(0, 2, (hi - lo,), generator=g,
                                 device=device, dtype=torch.uint8)
        flips = torch.rand(hi - lo, generator=g, device=device) < qber
        b[lo:hi] = a[lo:hi] ^ flips.to(torch.uint8)
    return a, b


def bsc_words(g, qber: float, B: int, n: int, device):
    """(keys, received): (B, n) uint8 uniform words and the same through
    a BSC(qber), drawn from generator ``g``."""
    import torch
    keys = torch.randint(0, 2, (B, n), generator=g, device=device,
                         dtype=torch.uint8)
    flips = torch.rand((B, n), generator=g, device=device) < qber
    return keys, keys ^ flips.to(torch.uint8)


def llr(received, qber: float):
    """float32 channel LLRs (1 - 2 b) ln((1 - q) / q) of received bits."""
    import torch
    mag = float(math.log((1.0 - qber) / qber))
    return torch.where(received.to(torch.bool),
                       torch.tensor(-mag, dtype=torch.float32,
                                    device=received.device),
                       torch.tensor(mag, dtype=torch.float32,
                                    device=received.device))
