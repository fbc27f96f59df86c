"""Leakage ledger and final-key-length accounting.

Reference capability: the global leaked-bit counters ecd2 keeps in process
globals, and the final-length formula applied before privacy amplification
(SURVEY.md §3 #10/#14, §4.3 "bookkeeping", Appendix B).

TPU-first design: the ledger is a small vector of named counters so that in a
sharded run the global ledger is the sum of the per-shard ledger vectors
over the mesh (BASELINE config 5: "global leaked-bit psum accounting") —
see qtpu_torch.parallel.psum_ledger.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Ledger", "LEDGER_FIELDS", "ledger_to_vector", "ledger_from_vector"]

LEDGER_FIELDS = (
    "sifted_bits",        # bits entering the EC stage
    "qber_test_bits",     # disclosed for QBER estimation
    "syndrome_bits",      # syndrome bits sent (minus punctured credit)
    "verify_hash_bits",   # verification-hash bits sent
    "reconciled_bits",    # payload bits that passed verification
    "discarded_bits",     # payload bits in failed/aborted blocks
    "final_bits",         # secret bits after privacy amplification
    "blocks_ok",          # blocks verified
    "blocks_failed",      # blocks failed verification
    "auth_bits",          # secret key consumed authenticating the channel
)


@dataclasses.dataclass
class Ledger:
    """Cumulative per-party accounting; both parties must agree exactly."""

    sifted_bits: int = 0
    qber_test_bits: int = 0
    syndrome_bits: int = 0
    verify_hash_bits: int = 0
    reconciled_bits: int = 0
    discarded_bits: int = 0
    final_bits: int = 0
    blocks_ok: int = 0
    blocks_failed: int = 0
    auth_bits: int = 0

    def add(self, **kw: int) -> None:
        for k, v in kw.items():
            setattr(self, k, getattr(self, k) + int(v))

    def merge(self, other: "Ledger") -> "Ledger":
        out = Ledger()
        for f in LEDGER_FIELDS:
            setattr(out, f, getattr(self, f) + getattr(other, f))
        return out

    def as_dict(self) -> dict[str, int]:
        return {f: int(getattr(self, f)) for f in LEDGER_FIELDS}

    @property
    def total_leaked(self) -> int:
        return self.qber_test_bits + self.syndrome_bits + self.verify_hash_bits


def ledger_to_vector(ledger: Ledger) -> torch.Tensor:
    """Ledger → (len(LEDGER_FIELDS),) int32 vector (psum-able)."""
    return torch.tensor([getattr(ledger, f) for f in LEDGER_FIELDS], dtype=torch.int32)


def ledger_from_vector(vec) -> Ledger:
    vals = np.asarray(vec).tolist()
    return Ledger(**dict(zip(LEDGER_FIELDS, vals)))
