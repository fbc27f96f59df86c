"""Channel and event-stream simulators.

Reference capability: the hardware layer is out of scope for a TPU build
(SURVEY.md §3 #1-2); it is replaced by simulators that generate the same
artifacts the reference's timestamp cards produced:

- `bsc`: binary symmetric channel on sifted keys (the EC-layer test channel,
  BASELINE configs 1-3).
- `EntangledPairSource`: timestamped coincident detector events for the
  sifting chain — correlated pair events with timing jitter, a true time
  offset between parties, detector inefficiency, and uncorrelated dark
  counts (reference: what chopper/chopper2 would read from hardware).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qtpu_torch.framing import EventWindow, TIME_UNITS_PER_NS

__all__ = ["bsc", "EntangledPairSource", "PairEvents"]


def bsc(rng: np.random.Generator, bits: np.ndarray, qber: float) -> np.ndarray:
    """Flip each bit independently with probability qber."""
    flips = (rng.random(bits.shape) < qber).astype(np.uint8)
    return np.asarray(bits, np.uint8) ^ flips


@dataclasses.dataclass
class PairEvents:
    """One simulation window of both parties' raw detector events."""

    alice: EventWindow
    bob: EventWindow
    # Ground truth for tests:
    true_offset_units: int          # Bob's clock minus Alice's clock (125 ps units)
    alice_bits: np.ndarray          # basis-encoded bit per *Alice* event (pairs only)
    pair_alice_idx: np.ndarray      # indices into alice events that are pair events
    pair_bob_idx: np.ndarray        # indices into bob events that are pair events
    alice_basis: np.ndarray         # (num_alice_events,) 0/1 measurement basis
    bob_basis: np.ndarray           # (num_bob_events,) 0/1
    bob_bits: np.ndarray            # bit per Bob event


@dataclasses.dataclass
class EntangledPairSource:
    """Simulates an entanglement-based (BBM92-style) source + two detectors.

    Detector id encodes (basis, bit) as in the reference 4-detector layout:
    id = basis * 2 + bit.
    """

    pair_rate_hz: float = 50_000.0
    window_s: float = 0.1
    offset_ns: float = 13_337.5         # true Alice↔Bob time offset
    jitter_ns: float = 0.6              # per-detector Gaussian timing jitter
    eta_alice: float = 0.9              # detection efficiency
    eta_bob: float = 0.85
    dark_rate_hz: float = 2_000.0       # uncorrelated background per party
    error_rate: float = 0.02            # intrinsic QBER in matched-basis pairs

    def generate(self, rng: np.random.Generator, start_epoch: int = 0) -> PairEvents:
        units_per_s = int(1e9 * TIME_UNITS_PER_NS)
        span = int(self.window_s * units_per_s)
        n_pairs = rng.poisson(self.pair_rate_hz * self.window_s)
        t_pair = np.sort(rng.integers(0, span, n_pairs).astype(np.int64))
        offset_units = int(round(self.offset_ns * TIME_UNITS_PER_NS))
        jitter_units = self.jitter_ns * TIME_UNITS_PER_NS

        # Quantum correlations: shared random bit when bases match.
        basis_a = rng.integers(0, 2, n_pairs).astype(np.uint8)
        basis_b = rng.integers(0, 2, n_pairs).astype(np.uint8)
        bit_a = rng.integers(0, 2, n_pairs).astype(np.uint8)
        flip = (rng.random(n_pairs) < self.error_rate).astype(np.uint8)
        bit_b = np.where(basis_a == basis_b, bit_a ^ flip,
                         rng.integers(0, 2, n_pairs).astype(np.uint8))

        det_a = rng.random(n_pairs) < self.eta_alice
        det_b = rng.random(n_pairs) < self.eta_bob

        def jitter(n):
            return np.round(rng.normal(0, jitter_units, n)).astype(np.int64)

        # Alice's detected pair events
        a_idx = np.flatnonzero(det_a)
        a_times = t_pair[a_idx] + jitter(len(a_idx))
        a_basis = basis_a[a_idx]
        a_bits = bit_a[a_idx]
        # Bob's detected pair events (shifted by the true clock offset)
        b_idx = np.flatnonzero(det_b)
        b_times = t_pair[b_idx] + offset_units + jitter(len(b_idx))
        b_basis = basis_b[b_idx]
        b_bits = bit_b[b_idx]

        # Dark counts (uncorrelated, random basis/bit)
        def darks(rate):
            nd = rng.poisson(rate * self.window_s)
            td = rng.integers(0, span, nd).astype(np.int64)
            bd = rng.integers(0, 2, nd).astype(np.uint8)
            xd = rng.integers(0, 2, nd).astype(np.uint8)
            return td, bd, xd

        da_t, da_b, da_x = darks(self.dark_rate_hz)
        db_t, db_b, db_x = darks(self.dark_rate_hz)

        # Merge + sort each party; remember where the pair events landed.
        def merge(tp, bp, xp, td, bd, xd):
            t = np.concatenate([tp, td])
            bs = np.concatenate([bp, bd])
            xs = np.concatenate([xp, xd])
            is_pair = np.concatenate([np.ones(len(tp), bool), np.zeros(len(td), bool)])
            pair_orig = np.concatenate([np.arange(len(tp)), np.full(len(td), -1)])
            order = np.argsort(t, kind="stable")
            return t[order], bs[order], xs[order], is_pair[order], pair_orig[order]

        at, ab, ax, ap, ao = merge(a_times, a_basis, a_bits, da_t, da_b, da_x)
        bt, bb, bx, bp_, bo = merge(b_times + 0, b_basis, b_bits, db_t, db_b, db_x)

        det_ids_a = (ab * 2 + ax).astype(np.uint8)
        det_ids_b = (bb * 2 + bx).astype(np.uint8)
        wa = EventWindow.from_events(at, det_ids_a, start_epoch, 1)
        wb = EventWindow.from_events(bt, det_ids_b, start_epoch, 1)

        # Ground-truth matching: for every source pair detected on BOTH sides,
        # record its event position in each party's sorted window.  `ao`/`bo`
        # map window position → local detected-pair slot; compose with
        # a_idx/b_idx (detected-pair slot → source pair id).
        src_to_pos_a = {int(a_idx[int(s)]): i for i, s in enumerate(ao) if s >= 0}
        src_to_pos_b = {int(b_idx[int(s)]): i for i, s in enumerate(bo) if s >= 0}
        common = sorted(set(src_to_pos_a) & set(src_to_pos_b))
        pair_alice = np.array([src_to_pos_a[c] for c in common], dtype=np.int64)
        pair_bob = np.array([src_to_pos_b[c] for c in common], dtype=np.int64)

        return PairEvents(
            alice=wa, bob=wb,
            true_offset_units=offset_units,
            alice_bits=ax, pair_alice_idx=pair_alice, pair_bob_idx=pair_bob,
            alice_basis=ab, bob_basis=bb, bob_bits=bx,
        )
