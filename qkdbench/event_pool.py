"""The events cell's input: both parties' detector events of an
entanglement-based (BBM92) source, made on the device from ``--seed`` with
torch's Philox generator and kept on the host, as a time-tagger's buffer.

The pool is a cyclic stream of ``pieces`` pieces of ``piece_s`` seconds
(T = pieces x piece_s): pair times uniform over [0, T); each pair reaches
Alice with probability ``eta_alice`` and Bob with ``eta_bob``, each
detection with its own Gaussian jitter (``jitter_ns``), Bob's on a clock
``offset_ns`` ahead of Alice's; both pick a basis at random, Alice a value
at random, and Bob, where the bases agree, her value flipped with
probability ``error_rate`` (else a random value); each party adds dark
counts at ``dark_rate_hz`` with a random basis and value.  Every time is
taken modulo T in 125 ps units, so the pool can be fed round and round:
piece w of the stream is piece w mod ``pieces`` of the pool, moved by
whole turns, and a pair cut by the pool's end has its other half at the
start of the next turn.  A detector id is basis x 2 + value (the
simulator's 4-detector layout, ``qtpu_torch.channel``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from qkdbench.generators import generator

__all__ = ["UNITS_PER_S", "Pool", "make_pool"]

UNITS_PER_S = 8_000_000_000     # 125 ps units


class Pool(NamedTuple):
    """Each party's events in time order over one turn of the pool
    (``alice_times`` / ``bob_times`` int64 units on the party's own clock,
    ``alice_det`` / ``bob_det`` uint8 detector ids), each piece's first
    event (``alice_cuts`` / ``bob_cuts``, pieces + 1 entries), the piece's
    length in units and the true offset in units."""
    alice_times: np.ndarray
    alice_det: np.ndarray
    bob_times: np.ndarray
    bob_det: np.ndarray
    alice_cuts: np.ndarray
    bob_cuts: np.ndarray
    piece_units: int
    offset_units: int

    @property
    def pieces(self) -> int:
        return len(self.alice_cuts) - 1

    def piece(self, w: int):
        """((alice times, detectors), (bob times, detectors)) of piece
        ``w`` of the stream, in absolute units."""
        k, turn = w % self.pieces, w // self.pieces
        shift = np.int64(turn) * np.int64(self.pieces * self.piece_units)
        a = slice(self.alice_cuts[k], self.alice_cuts[k + 1])
        b = slice(self.bob_cuts[k], self.bob_cuts[k + 1])
        return ((self.alice_times[a] + shift, self.alice_det[a]),
                (self.bob_times[b] + shift, self.bob_det[b]))

    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.alice_times, self.alice_det,
                                      self.bob_times, self.bob_det))


def make_pool(seed: int, source: dict, pieces: int, piece_s: float,
              device) -> Pool:
    """The pool of ``source``'s events (``pair_rate_hz``, ``offset_ns``,
    ``jitter_ns``, ``eta_alice``, ``eta_bob``, ``dark_rate_hz``,
    ``error_rate``) drawn on ``device``."""
    import torch
    g = generator(seed, device)
    piece_units = int(round(piece_s * UNITS_PER_S))
    total = pieces * piece_units
    offset = int(round(float(source["offset_ns"]) * 8))
    jitter = float(source["jitter_ns"]) * 8

    def poisson(mean: float) -> int:
        return int(torch.poisson(torch.tensor([mean], dtype=torch.float64,
                                              device=device),
                                 generator=g).item())

    def bits(n: int):
        return torch.randint(0, 2, (n,), generator=g, device=device,
                             dtype=torch.uint8)

    def uniform(n: int):
        return torch.rand(n, generator=g, device=device)

    def times(n: int):
        return torch.randint(0, total, (n,), generator=g, device=device,
                             dtype=torch.int64)

    def jittered(t, shift: int):
        noise = torch.round(torch.randn(t.shape[0], generator=g,
                                        device=device) * jitter)
        return torch.remainder(t + shift + noise.to(torch.int64), total)

    n_pairs = poisson(float(source["pair_rate_hz"]) * pieces * piece_s)
    t_pair = times(n_pairs)
    basis_a, basis_b, value_a = bits(n_pairs), bits(n_pairs), bits(n_pairs)
    flip = (uniform(n_pairs) < float(source["error_rate"])).to(torch.uint8)
    value_b = torch.where(basis_a == basis_b, value_a ^ flip, bits(n_pairs))
    seen_a = uniform(n_pairs) < float(source["eta_alice"])
    seen_b = uniform(n_pairs) < float(source["eta_bob"])

    def party(seen, t_shift, basis, value):
        t = jittered(t_pair[seen], t_shift)
        det = basis[seen] * 2 + value[seen]
        n_dark = poisson(float(source["dark_rate_hz"]) * pieces * piece_s)
        t = torch.cat([t, times(n_dark)])
        det = torch.cat([det, bits(n_dark) * 2 + bits(n_dark)])
        t, order = torch.sort(t, stable=True)
        det = det[order]
        cuts = torch.searchsorted(
            t, torch.arange(pieces + 1, device=device, dtype=torch.int64)
            * piece_units)
        return t.cpu().numpy(), det.cpu().numpy(), cuts.cpu().numpy()

    at, ad, ac = party(seen_a, 0, basis_a, value_a)
    bt, bd, bc = party(seen_b, offset, basis_b, value_b)
    return Pool(at, ad, bt, bd, ac, bc, piece_units, offset)
