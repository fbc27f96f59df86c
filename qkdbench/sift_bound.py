"""The least time the card could take to sift a batch of chunks, against
the HBM bandwidth of ``roofline.HBM_BYTES_PER_S``: the events' own bytes
read once (Alice's int32 time and basis byte an event; Bob's int32 time
and detector id, whose byte holds his basis and value, an event) and the
sifted outputs written once (an int32 index and a bit's byte a sifted
event).  The padding the
program adds to its power-of-two capacities is not counted; the matching
is a few comparisons an event, far below the card's operation rate, so
the bytes bound it."""

from __future__ import annotations

from qkdbench.roofline import HBM_BYTES_PER_S

__all__ = ["sift_bytes", "sift_bound_s"]


def sift_bytes(alice_events: int, bob_events: int, sifted: int) -> int:
    return 5 * alice_events + 5 * bob_events + 5 * sifted


def sift_bound_s(alice_events: int, bob_events: int, sifted: int) -> float:
    """Seconds of a batch's sifting at the card's bandwidth."""
    return sift_bytes(alice_events, bob_events, sifted) / HBM_BYTES_PER_S
