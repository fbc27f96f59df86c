"""Cascade/BICONF golden model (CPU, NumPy) — the upstream interactive
error-correction protocol, kept as a cross-check oracle.

Reference capability: ``errorcorrection/algorithms/cascade_biconf.c``
(SURVEY.md §3 #12, §4.3) — multi-pass permuted parity compare with binary
search on mismatching blocks, cascade-back through earlier passes, and
BICONF refinement rounds.  The ``-ldpc`` fork's whole point is to supersede
this with one-way syndrome reconciliation; per SURVEY.md it is built here
only as a golden model: it validates QBER/leakage accounting, provides a
correctness oracle for small blocks, and quantifies the interactivity cost
LDPC removes (tests compare round-trip counts).

Protocol realism: Alice is modeled as a ``ParityOracle`` that answers parity
queries; every query leaks exactly one bit and costs one round trip.  Block
parities learned once are CACHED — when Bob flips a bit he updates his view
locally and re-uses Alice's known parity, exactly as the reference does (the
round-1 implementation re-queried them, double-counting leakage and rigging
the LDPC-vs-Cascade comparison in LDPC's favor — round-1 verdict finding).
All permutations and BICONF subsets derive from the shared protocol PRNG
(qtpu.prng), as both parties must compute them identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qtpu_torch import prng

__all__ = ["ParityOracle", "cascade_reconcile", "CascadeResult"]


class ParityOracle:
    """Alice's side of Cascade: answers subset-parity queries.

    Counts queries — each is one disclosed bit AND one round trip on the
    classical channel (the reference's interactivity bottleneck).
    """

    def __init__(self, bits: np.ndarray):
        self._bits = np.asarray(bits, np.uint8)
        self.queries = 0

    def parity(self, idx: np.ndarray) -> int:
        self.queries += 1
        return int(self._bits[idx].sum() & 1)


@dataclasses.dataclass
class CascadeResult:
    bits: np.ndarray          # Bob's corrected key
    leaked_bits: int          # parities disclosed
    round_trips: int          # interactive exchanges used
    corrected_errors: int
    biconf_rounds: int = 0    # BICONF refinement rounds run


def _binary_search_flip(oracle: ParityOracle, bob: np.ndarray,
                        idx: np.ndarray) -> int:
    """Find and flip the (an) erroneous bit inside block ``idx`` whose total
    parity mismatches; returns the flipped position."""
    while len(idx) > 1:
        half = len(idx) // 2
        left = idx[:half]
        pa = oracle.parity(left)
        pb = int(bob[left].sum() & 1)
        if pa != pb:
            idx = left
        else:
            idx = idx[half:]
    bob[idx[0]] ^= 1
    return int(idx[0])


def cascade_reconcile(oracle: ParityOracle, bob_bits: np.ndarray,
                      qber_est: float, session_seed: int,
                      num_passes: int = 4, biconf_target: int = 10,
                      biconf_max_rounds: int = 100) -> CascadeResult:
    """Run Cascade + BICONF against a parity oracle (Alice).

    Initial block size k1 ≈ 0.73/q (Brassard–Salvail); doubles each pass;
    cascade-back re-searches earlier-pass blocks whose parity is broken by a
    flip in a later pass.  After the passes, BICONF rounds compare the parity
    of a random half-subset; a mismatch triggers a binary search (and
    cascade-back), and the protocol stops after ``biconf_target`` consecutive
    agreeing rounds (the upstream confirmation criterion).
    """
    bob = np.asarray(bob_bits, np.uint8).copy()
    n = len(bob)
    k1 = max(2, int(round(0.73 / max(qber_est, 1e-3))))
    root = prng.root_key(session_seed)

    blocks: list[list[np.ndarray]] = []    # per pass, per block: positions
    block_of: list[np.ndarray] = []        # per pass: block id of a position
    alice_parity: list[list[int]] = []     # per pass: cached oracle answers
    corrected = 0

    def resolve(queue: list[tuple[int, int]]) -> int:
        """Drain odd-parity blocks: binary-search each true mismatch,
        cascade-back the flip into every other pass.  Bob's parities are
        recomputed locally; Alice's come from the cache (zero extra leak)."""
        fixed = 0
        while queue:
            pp, bi = queue.pop()
            idx = blocks[pp][bi]
            pa = alice_parity[pp][bi]
            pb = int(bob[idx].sum() & 1)
            if pa == pb:
                continue
            pos = _binary_search_flip(oracle, bob, idx)
            fixed += 1
            for p2 in range(len(blocks)):
                if p2 == pp:
                    continue
                queue.append((p2, int(block_of[p2][pos])))
        return fixed

    for p in range(num_passes):
        k = min(n, k1 << p)
        # Deterministic pass permutation from the protocol PRNG (pass 0 is
        # unpermuted, as in the reference).
        perm = (np.arange(n) if p == 0
                else np.argsort(jax_uniform(root, p, n), kind="stable"))
        bl = [perm[i:i + k] for i in range(0, n, k)]
        blocks.append(bl)
        bo = np.empty(n, np.int32)
        for bi, idx in enumerate(bl):
            bo[idx] = bi
        block_of.append(bo)

        # Initial parity sweep: ONE query per block, answers cached.
        pa_list = [oracle.parity(idx) for idx in bl]
        alice_parity.append(pa_list)
        queue = [(p, bi) for bi, idx in enumerate(bl)
                 if pa_list[bi] != int(bob[idx].sum() & 1)]
        corrected += resolve(queue)

    # BICONF refinement (SURVEY.md §3 #12 names it): random half-subset
    # parity compares until `biconf_target` consecutive rounds agree.
    biconf_rounds = 0
    agree = 0
    r = 0
    while agree < biconf_target and r < biconf_max_rounds:
        key = prng.derive(root, "biconf", r)
        pick = prng.random_bits(key, (n,)).astype(bool)
        idx = np.flatnonzero(pick)
        r += 1
        biconf_rounds += 1
        if idx.size == 0:
            continue
        pa = oracle.parity(idx)
        pb = int(bob[idx].sum() & 1)
        if pa == pb:
            agree += 1
            continue
        agree = 0
        pos = _binary_search_flip(oracle, bob, idx)
        corrected += 1
        # Cascade-back into the pass blocks (a BICONF flip breaks them too).
        queue = [(p2, int(block_of[p2][pos])) for p2 in range(len(blocks))]
        corrected += resolve(queue)

    return CascadeResult(bits=bob, leaked_bits=oracle.queries,
                         round_trips=oracle.queries,
                         corrected_errors=corrected,
                         biconf_rounds=biconf_rounds)


def jax_uniform(root, p: int, n: int) -> np.ndarray:
    """Protocol-deterministic uniforms for the pass-p permutation."""
    from qtpu_torch import random
    key = prng.derive(root, "cascade-perm", p)
    return random.uniform(random.key_from_data(key, "cpu"), n).numpy()
