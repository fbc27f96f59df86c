"""Fault injection on the classical channel, against qtpu_torch's sessions.

Every scenario of tests/test_faults.py, unchanged but for the package:
duplicated messages, window aborts (in every consumption state), lost acks,
and uncorrectable-QBER channels must never produce differing final keys or
diverging accounting.  Then a stream-PA range settled by an abort: the key
it emits must be counted in both parties' ledgers (the reference drops that
credit) and must equal the reference's key."""

import numpy as np
import pytest

from qtpu_torch.link import make_direct_pair, make_loopback_pair
from qtpu_torch.messages import pack_message, unpack_message
from qtpu_torch.pipeline import (AliceSession, BobSession, PipelineConfig,
                           pump_sessions)


def _cfg(**kw):
    base = dict(n=1024, blocks_per_window=2, qber_test_bits=256,
                qber_test_floor=64)
    base.update(kw)
    return PipelineConfig(**base)


def _sessions(cfg, seed, total=20_000, qber=0.02, wire=True):
    rng = np.random.default_rng(seed)
    a_bits = rng.integers(0, 2, total).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(total) < qber).astype(np.uint8)
    la, lb = make_loopback_pair() if wire else make_direct_pair()
    alice = AliceSession(cfg, seed, la, device="cpu")
    bob = BobSession(cfg, seed, lb, device="cpu")
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    return alice, bob, la, lb


class DupLink:
    """Link wrapper that duplicates every Nth sent message."""

    def __init__(self, inner, every=3):
        self._inner = inner
        self._every = every
        self._count = 0

    def send(self, msg):
        self._inner.send(msg)
        self._count += 1
        if self._count % self._every == 0:
            self._inner.send(unpack_message(pack_message(msg)))  # true copy

    def recv(self, timeout=None):
        return self._inner.recv(timeout)


def _assert_synced(alice, bob, expect_key=True):
    ka, kb = alice.final_key_bits(), bob.final_key_bits()
    np.testing.assert_array_equal(ka, kb)
    assert alice.ledger.as_dict() == bob.ledger.as_dict()
    assert alice.final_key_index == bob.final_key_index
    if expect_key:
        assert len(ka) > 0


def test_duplicated_messages_are_idempotent():
    alice, bob, la, lb = _sessions(_cfg(), 10)
    alice.link = DupLink(la, every=2)
    bob.link = DupLink(lb, every=2)
    pump_sessions(alice, bob, la, lb)
    assert bob.window_id >= 2
    _assert_synced(alice, bob)


def test_abort_before_consumption_resynchronizes():
    """Drop Bob's RateSelect for window 0 (nothing consumed yet); Alice
    aborts, both mirror, the stream continues with identical keys."""
    alice, bob, la, lb = _sessions(_cfg(), 11)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> RateSelect
    dropped = la.recv()
    assert type(dropped).__name__ == "RateSelect"
    alice.abort_window(0)
    bob.on_message(lb.recv())
    assert 0 not in alice._inflight and 0 not in bob._inflight
    assert alice.window_id == 1 and bob.window_id == 1
    pump_sessions(alice, bob, la, lb)
    assert bob.window_id >= 2
    _assert_synced(alice, bob)
    assert all(w != 0 for w, _ in alice.final_key_index)


def test_abort_after_alice_consumed_syncs_cursors():
    """Drop Alice's Syndromes for window 0: Alice has consumed payload, Bob
    has not.  The Abort carries Alice's consumed length; Bob must consume-
    and-discard to match or every later window derails (the round-2
    cursor-desync bug)."""
    alice, bob, la, lb = _sessions(_cfg(), 12)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> RateSelect
    alice.on_message(la.recv())        # RateSelect -> Syndromes (consumes!)
    dropped = lb.recv()
    assert type(dropped).__name__ == "Syndromes"
    consumed = alice._inflight[0]["consumed"]
    assert consumed > 0
    bob_before = bob.stream.remaining
    alice.abort_window(0, "timeout")
    bob.on_message(lb.recv())          # Bob mirrors INCLUDING consumption
    assert bob.stream.remaining == bob_before - consumed
    assert alice.ledger.discarded_bits == bob.ledger.discarded_bits == consumed
    pump_sessions(alice, bob, la, lb)
    assert bob.window_id >= 2
    _assert_synced(alice, bob)


def test_bob_initiated_abort_when_alice_consumed_echoes():
    """Bob aborts a window whose Syndromes he never saw (consumed=0) while
    Alice HAS consumed: Alice's echo tells Bob to catch up."""
    alice, bob, la, lb = _sessions(_cfg(), 13)
    alice.start_window()
    bob.on_message(lb.recv())
    alice.on_message(la.recv())        # Alice consumes, Syndromes in flight
    dropped = lb.recv()                # ...and lost
    assert type(dropped).__name__ == "Syndromes"
    bob_before = bob.stream.remaining
    # Bob times out and aborts with his consumed=0.
    bob.abort_window(0, "timeout")
    alice.on_message(la.recv())        # Alice mirrors; echoes her count
    echo = lb.recv()
    assert type(echo).__name__ == "Abort" and echo.consumed > 0
    bob.on_message(echo)
    assert bob.stream.remaining == bob_before - echo.consumed
    assert alice.ledger.discarded_bits == bob.ledger.discarded_bits
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob)


def test_lost_ack_recovered_by_retransmit():
    """Bob finalized a window but his VerifyAck is lost; Alice re-sends the
    Syndromes and Bob's ack cache answers idempotently (at-least-once)."""
    alice, bob, la, lb = _sessions(_cfg(), 14)
    alice.start_window()
    bob.on_message(lb.recv())
    alice.on_message(la.recv())
    bob.on_message(lb.recv())
    bob.flush()
    lost = la.recv()                   # drop the ack
    assert type(lost).__name__ == "VerifyAck"
    assert bob.window_id == 1          # Bob already finalized
    assert alice._inflight[0]["stage"] == "syndromes_sent"
    assert alice.retransmit_window(0)
    bob.on_message(lb.recv())          # duplicate Syndromes -> cached ack
    alice.on_message(la.recv())
    assert 0 not in alice._inflight
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob)


def test_stale_ack_ignored():
    """A replayed VerifyAck for an already-completed window must be a no-op."""
    alice, bob, la, lb = _sessions(_cfg(), 15)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> rate
    alice.on_message(la.recv())        # rate -> syndromes
    bob.on_message(lb.recv())          # syndromes -> (deferred) decode
    bob.flush()                        # resolve -> ack
    ack = la.recv()
    before = alice.ledger.as_dict()
    alice.on_message(ack)
    after_first = alice.ledger.as_dict()
    assert after_first != before       # the real ack did its work
    alice.on_message(ack)              # replay
    assert alice.ledger.as_dict() == after_first, "replayed ack must be a no-op"


def test_abort_after_peer_finalized_resurrects():
    """THE round-3 desync repro: Bob decodes and finalizes window 0, his
    VerifyAck is lost, Alice times out and aborts.  Bob must NOT consume a
    second copy of the window's stream (he already consumed it in the
    normal path) — he answers with the cached ack + a ``completed`` echo,
    and Alice resurrects the window from her limbo stash.  Both parties
    must end with EQUAL final keys and ledgers."""
    alice, bob, la, lb = _sessions(_cfg(), 20)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> RateSelect
    alice.on_message(la.recv())        # rate -> Syndromes (Alice consumes)
    bob.on_message(lb.recv())          # Bob consumes + decodes
    bob.flush()                        # Bob FINALIZES window 0
    lost = la.recv()                   # ...but the ack is lost
    assert type(lost).__name__ == "VerifyAck"
    assert bob.window_id == 1
    bob_cursor = bob.stream.remaining
    alice.abort_window(0, "timeout")   # Alice times out
    bob.on_message(lb.recv())          # Bob: completed -> NO consumption
    assert bob.stream.remaining == bob_cursor, \
        "abort of a finalized window must not consume the stream again"
    # Bob re-sent the cached ack (and possibly a completed echo).
    while (m := lb.recv()) is not None:
        bob.on_message(m)
    while (m := la.recv()) is not None:
        alice.on_message(m)
    assert 0 not in alice._limbo, "ack must resurrect the aborted window"
    pump_sessions(alice, bob, la, lb)
    assert bob.window_id >= 3
    _assert_synced(alice, bob)
    assert any(w == 0 for w, _ in alice.final_key_index), \
        "window 0's key must survive the race"


def test_abort_finalized_window_during_later_windows():
    """Same race, but the duplicate Abort arrives windows later (after more
    traffic): the completed record must still answer it idempotently."""
    alice, bob, la, lb = _sessions(_cfg(), 21)
    pump_sessions(alice, bob, la, lb, max_rounds=60)
    done = bob.window_id
    assert done >= 2
    from qtpu_torch.messages import Abort
    bob_cursor = bob.stream.remaining
    led_before = bob.ledger.as_dict()
    # Replay an abort for long-finalized window 0 (at-least-once noise).
    c0, _d0 = bob._completed[0]
    bob.on_message(Abort(window_id=0, reason="timeout", consumed=c0))
    assert bob.stream.remaining == bob_cursor
    assert bob.ledger.as_dict() == led_before
    # Bob answers with the cached ack and then the completed echo.
    seen = []
    while (m := la.recv()) is not None:
        seen.append(m)
        alice.on_message(m)
    assert any(getattr(m, "reason", None) == "completed" for m in seen)
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob)


def test_abort_during_retry_round():
    """Abort arriving while a window sits mid-retry (Bob acked round 0 with
    failures, RetryDisclose lost): both parties mirror the full consumed
    length and continue in sync."""
    cfg = _cfg(max_retries=1)
    alice, bob, la, lb = _sessions(cfg, 22, qber=0.08, total=30_000)
    alice.start_window()
    bob.on_message(lb.recv())
    alice.on_message(la.recv())
    bob.on_message(lb.recv())
    bob.flush()
    ack = la.recv()
    if ack is not None and getattr(ack, "ok_mask", None) is not None \
            and not ack.ok_mask.astype(bool).all():
        alice.on_message(ack)          # Alice sends RetryDisclose
        dropped = lb.recv()            # ...which is lost
        assert type(dropped).__name__ == "RetryDisclose"
        alice.abort_window(0, "timeout")
        bob.on_message(lb.recv())      # Bob mirrors (window still inflight)
        while (m := la.recv()) is not None:
            alice.on_message(m)
    else:
        if ack is not None:
            alice.on_message(ack)
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob, expect_key=False)


def test_stale_abort_beyond_horizon_dropped():
    """A duplicate Abort for a window far below the history floor must be
    dropped outright — never consume or re-create a memo (round-3 advisor
    medium finding: pruned memos made duplicates double-consume)."""
    alice, bob, la, lb = _sessions(_cfg(), 23)
    pump_sessions(alice, bob, la, lb, max_rounds=60)
    from qtpu_torch.messages import Abort
    bob.window_id += bob.HISTORY_HORIZON + 8   # simulate a long session
    bob._prune_history()
    bob_cursor = bob.stream.remaining
    led = bob.ledger.as_dict()
    bob.on_message(Abort(window_id=0, reason="timeout", consumed=4096))
    assert bob.stream.remaining == bob_cursor
    assert bob.ledger.as_dict() == led
    assert lb.recv() is None or True   # no harmful echo required
    assert 0 not in bob._aborted


def test_unknown_window_abort_never_consumes():
    """An Abort for a window this party has NO record of must never move
    the stream cursor (the v2 consumption order guarantees the peer can
    only have consumed if we hold a record)."""
    alice, bob, la, lb = _sessions(_cfg(), 24)
    from qtpu_torch.messages import Abort
    cursor = bob.stream.remaining
    bob.on_message(Abort(window_id=5, reason="timeout", consumed=8192))
    assert bob.stream.remaining == cursor
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob)


def test_allfail_windows_kill_session():
    """A run of 100%-failed windows (the desync signature) must trip the
    dead-session alarm instead of burning payload forever."""
    cfg = _cfg(max_allfail_windows=3, max_retries=0, qber_initial=0.02)
    rng = np.random.default_rng(25)
    a_bits = rng.integers(0, 2, 40_000).astype(np.uint8)
    b_bits = rng.integers(0, 2, 40_000).astype(np.uint8)  # UNRELATED stream
    la, lb = make_loopback_pair()
    alice = AliceSession(cfg, 25, la, device="cpu")
    bob = BobSession(cfg, 25, lb, device="cpu")
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    pump_sessions(alice, bob, la, lb, max_rounds=400)
    assert bob.dead, "all-failed windows must kill the session"
    assert bob.ledger.final_bits == 0


def test_uncorrectable_qber_aborts_session():
    """At 12% QBER (beyond every calibrated ceiling) the session must stop
    burning payload: after the cold-start window teaches the prior, every
    window aborts at the open stage and both parties go dead (round-2
    verdict: abort-on-uncorrectable-QBER)."""
    cfg = _cfg(blocks_per_window=4, max_uncorrectable_windows=3)
    alice, bob, la, lb = _sessions(cfg, 16, total=60_000, qber=0.12)
    pump_sessions(alice, bob, la, lb, max_rounds=200)
    assert bob.dead and alice.dead, "session must die on uncorrectable QBER"
    # No payload burned beyond the cold-prior pipeline depth: everything
    # after those windows aborts at the open stage, consuming nothing.
    consumed = 60_000 - alice.stream.remaining
    assert consumed <= (cfg.max_inflight_windows
                        * (alice.max_need + cfg.qber_test_bits))
    # The cold window either verified (heavily pinned) or was discarded;
    # either way zero secret key and matching ledgers.
    assert alice.ledger.final_bits == 0
    _assert_synced(alice, bob, expect_key=False)


@pytest.mark.parametrize("pa_mode", ["per_block", "stream"])
def test_resurrect_after_later_window_finalized_stays_ordered(pa_mode):
    """Round-4 advisor medium: window 0's ack is lost, window 1 completes
    normally, THEN the resurrect ack lands — Alice finalizes 1 before 0.
    Both parties must emit identical final keys in identical order:
    per_block sorts the emit lists by (window, block); stream mode buffers
    payloads by window id and flushes id ranges only when settled (the
    limbo stash blocks the range until the resurrection resolves)."""
    cfg = _cfg(pa_mode=pa_mode, pa_stream_windows=2, max_inflight_windows=2)
    alice, bob, la, lb = _sessions(cfg, 20)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> RateSelect
    alice.on_message(la.recv())        # rate -> Syndromes
    bob.on_message(lb.recv())          # Bob consumes + decodes
    bob.flush()                        # Bob finalizes window 0
    lost = la.recv()                   # ...ack for window 0 is LOST
    assert type(lost).__name__ == "VerifyAck"
    assert bob.window_id == 1, "seed must give a clean first-round decode"
    # Window 1 runs to completion while 0 is stuck.
    alice.start_window()
    bob.on_message(lb.recv())
    alice.on_message(la.recv())
    bob.on_message(lb.recv())
    bob.flush()
    ack1 = la.recv()
    assert type(ack1).__name__ == "VerifyAck" and ack1.window_id == 1
    alice.on_message(ack1)             # Alice finalizes 1 BEFORE 0
    if pa_mode == "stream":
        assert alice._stream_flushes == 0, \
            "flush range [0,2) must wait for window 0"
    # Alice times out window 0; Bob's cached ack resurrects it.
    alice.abort_window(0, "timeout")
    bob.on_message(lb.recv())
    while (m := lb.recv()) is not None:
        bob.on_message(m)
    while (m := la.recv()) is not None:
        alice.on_message(m)
    assert 0 not in alice._limbo
    pump_sessions(alice, bob, la, lb)
    _assert_synced(alice, bob)
    assert alice.final_key_index == sorted(alice.final_key_index)
    if pa_mode == "per_block":
        assert any(w == 0 for w, _ in alice.final_key_index)
    else:
        assert alice._stream_flushes >= 1


def _cpu(mod):
    """``device="cpu"`` for the port's entry points (the reference's take
    no device)."""
    return {"device": "cpu"} if mod.__name__.startswith("qtpu_torch") else {}


def _abort_settled_flush(pipe, link):
    """Window 0 completes; window 1's RateSelect is lost and Alice aborts
    it before anything is consumed.  The abort settles the stream-PA range
    [0, 2), so both parties flush it from their abort paths."""
    cfg = pipe.PipelineConfig(n=1024, blocks_per_window=2, qber_test_bits=256,
                              qber_test_floor=64, pa_mode="stream",
                              pa_stream_windows=2)
    rng = np.random.default_rng(20)
    a_bits = rng.integers(0, 2, 20_000).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(20_000) < 0.02).astype(np.uint8)
    la, lb = link.make_loopback_pair()
    alice = pipe.AliceSession(cfg, 20, la, **_cpu(pipe))
    bob = pipe.BobSession(cfg, 20, lb, **_cpu(pipe))
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    alice.start_window()
    bob.on_message(lb.recv())          # open -> RateSelect
    alice.on_message(la.recv())        # rate -> Syndromes
    bob.on_message(lb.recv())
    bob.flush()                        # Bob finalizes window 0
    alice.on_message(la.recv())        # Alice finalizes window 0
    assert alice._stream_flushes == bob._stream_flushes == 0
    alice.start_window()
    bob.on_message(lb.recv())          # open 1 -> RateSelect
    assert type(la.recv()).__name__ == "RateSelect"   # ...lost
    alice.abort_window(1, "timeout")   # settles [0, 2): Alice flushes
    bob.on_message(lb.recv())          # Bob mirrors: Bob flushes
    while (m := la.recv()) is not None:
        alice.on_message(m)
    assert alice._stream_flushes == bob._stream_flushes == 1
    return alice, bob


def test_abort_settled_stream_flush_counts_final_bits():
    import qtpu.link as jlink
    import qtpu.pipeline as jpipe
    import qtpu_torch.link as tlink
    import qtpu_torch.pipeline as tpipe
    ja, jb = _abort_settled_flush(jpipe, jlink)
    alice, bob = _abort_settled_flush(tpipe, tlink)
    key = alice.final_key_bits()
    assert key.size > 0
    np.testing.assert_array_equal(bob.final_key_bits(), key)
    np.testing.assert_array_equal(ja.final_key_bits(), key)
    np.testing.assert_array_equal(jb.final_key_bits(), key)
    assert alice.final_key_index == ja.final_key_index == [(1, -1)]
    for party in (alice, bob):
        assert party.ledger.final_bits == key.size
    # The reference emits the same key but never counts it.
    assert ja.ledger.final_bits == jb.ledger.final_bits == 0
    _assert_synced(alice, bob)
