"""What a two-party session must have produced, worked out again from the
benchmark's own inputs and the messages the link carried.

The configuration's ladder gives each rung's payload P (the first
(nb - p) z codeword positions: nb = 32 base columns, the last p punctured)
and its syndrome leakage (mb - p) z.  From the log of the link's messages
(each window's Syndromes with its rung r, shortening s and test bits k a
block; each retry's disclosed bits and failed blocks; Bob's last
VerifyAck; every Abort) this module derives, with none of the program's
state:

- each window's place in the sifted stream: windows consume B P(r) bits
  each, in the order Alice sent their Syndromes;
- each verified block's final length: l_max(r) - k - s, less the bits its
  retries disclosed, l_max(r) = P - (mb - p) z - verify_hash_bits -
  ceil(2 log2(1 / eps_sec));
- the ledger both parties must hold.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Rung", "rungs", "SessionLog", "Expected", "expected",
           "LEDGER_FIELDS"]

LEDGER_FIELDS = ("sifted_bits", "qber_test_bits", "syndrome_bits",
                 "verify_hash_bits", "reconciled_bits", "discarded_bits",
                 "final_bits", "blocks_ok", "blocks_failed", "auth_bits")


@dataclasses.dataclass(frozen=True)
class Rung:
    payload: int      # P: stream bits a block
    leaked: int       # syndrome bits charged a block
    l_max: int        # the longest final key a block can give


def rungs(config: dict) -> list:
    """Each rung of the configuration's ladder."""
    pipe, lad = config["pipeline"], config["ladder"]
    nb = lad["nb"]
    z = pipe["n"] // nb
    eps = pipe["security_eps"]
    margin = (int(math.ceil(2.0 * math.log2(1.0 / eps))) if eps is not None
              else pipe["security_margin_bits"])
    out = []
    for rung in lad["rungs"]:
        mb, p = rung["mb"], rung["punct"]
        P, leaked = (nb - p) * z, (mb - p) * z
        out.append(Rung(P, leaked, max(0, P - leaked
                                       - pipe["verify_hash_bits"] - margin)))
    return out


@dataclasses.dataclass
class SessionLog:
    """The messages the link carried, as the benchmark's taps logged them:
    ``syndromes`` [(window, rung, short bits, test bits)] in Alice's send
    order; ``retries`` [(window, round, bits a block, failed mask)];
    ``acks`` {window: Bob's last ok mask}; ``aborts`` [(sender, window,
    reason)]; ``sent`` {party: messages sent}."""

    syndromes: list = dataclasses.field(default_factory=list)
    retries: list = dataclasses.field(default_factory=list)
    acks: dict = dataclasses.field(default_factory=dict)
    aborts: list = dataclasses.field(default_factory=list)
    sent: dict = dataclasses.field(
        default_factory=lambda: {"alice": 0, "bob": 0})


@dataclasses.dataclass
class Expected:
    """``offset`` {window: (first stream bit, rung)}; ``length``
    {(window, block): final key bits} of every block that must have a
    key; ``ok`` {window: verified blocks}; ``ledger``."""

    offset: dict
    length: dict
    ok: dict
    ledger: dict


def expected(config: dict, log: SessionLog, sifted_bits: int,
             auth_bits_per_message: int) -> Expected:
    """The session's due results from its configuration, the stream's
    length and the link's log (a session with no abort: an Abort's
    consumption is the program's to report, so the check refuses any)."""
    pipe = config["pipeline"]
    B, vh = pipe["blocks_per_window"], pipe["verify_hash_bits"]
    lad = rungs(config)
    led = dict.fromkeys(LEDGER_FIELDS, 0)
    led["sifted_bits"] = sifted_bits
    offset, pos, params = {}, 0, {}
    for w, r, s, k in log.syndromes:
        offset[w] = (pos, r)
        params[w] = (r, s, k)
        pos += B * lad[r].payload
        led["qber_test_bits"] += (k + s) * B
        led["syndrome_bits"] += lad[r].leaked * B
        led["verify_hash_bits"] += vh * B
    extra = {}
    for w, _, nbits, failed in log.retries:
        failed = np.asarray(failed).astype(bool)
        led["syndrome_bits"] += nbits * int(failed.sum())
        extra.setdefault(w, np.zeros(B, np.int64))[failed] += nbits
    length, ok_count = {}, {}
    for w, mask in log.acks.items():
        r, s, k = params[w]
        rung = lad[r]
        ok = np.asarray(mask).astype(bool)
        okc = int(ok.sum())
        ok_count[w] = okc
        led["reconciled_bits"] += okc * rung.payload
        led["discarded_bits"] += (B - okc) * rung.payload
        led["blocks_ok"] += okc
        led["blocks_failed"] += B - okc
        base = max(0, rung.l_max - k - s)
        if base == 0:
            continue
        ex = extra.get(w, np.zeros(B, np.int64))
        for b in np.flatnonzero(ok):
            lb = max(0, min(base - int(ex[b]), rung.l_max))
            if lb > 0:
                length[(w, int(b))] = lb
                led["final_bits"] += lb
    led["auth_bits"] = auth_bits_per_message * (log.sent["alice"]
                                                + log.sent["bob"])
    return Expected(offset, length, ok_count, led)
