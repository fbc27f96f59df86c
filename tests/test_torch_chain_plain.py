"""The events -> key chain against the plain sifting reference
(``qkdbench/reference/sift.py``), on the CPU at the events cell's density.

``qtpu_torch.chain``'s two parties run over a direct link with a layered
decoder at n = 2048 on the native3 ladder, fed through ``push_stream`` with
the benchmark's own events (``qkdbench.event_pool``: 10^7 pairs/s, the
simulator's efficiencies and jitter, BASELINE config 4's offset, errors
and dark counts) in pieces of 2 ms that cross a frame boundary, so that
consecutive chunks share frame ids and a sift batch holds several of one
frame.  Each chunk Bob sifts is held to the reference run on the same
piece from the offset the program held at it: its index row, count, Bob's
bits, residual and next offset; either control of
``qkdbench/control_chain.py`` in the program's place differs; and
Alice's final keys are the reference's splice hashed by
``qkdbench/reference/keys.py``.  The chain's spans are recorded under
``tracing.recording()``, one ``sift.batch`` a batch Bob sifts.
"""

import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from qkdbench import control_chain, event_pool
from qkdbench.reference import keys as ref_keys
from qkdbench.reference import session_check
from qkdbench.reference import sift as ref_sift
from qtpu_torch import chain, pipeline, sift, tracing
from qtpu_torch.link import make_direct_pair
from qtpu_torch.messages import SiftIndex, Syndromes, TimingBasis

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "qkdbench"
                     / "configs" / "chain65k.json").read_text())
PIECE_S = 0.002
SEED = (1 << 31) + 21
# Pieces 20-51 of a pool of 64 (40-104 ms): frame 0 ends at 67.1 ms.
FIRST, PIECES = 20, 32
PIPE = dict(CONFIG["pipeline"], n=2048, blocks_per_window=4,
            qber_test_bits=256, qber_test_floor=64,
            stream_capacity_bits=1 << 19, drain_windows=4)


def _chain_config():
    fields = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in PIPE.items()}
    ch = {k: v for k, v in CONFIG["chain"].items() if k != "note"}
    ch.update(window_s=PIECE_S, pfind_bins=1 << 16)
    return chain.ChainConfig(pipeline=pipeline.PipelineConfig(**fields),
                             **ch)


@pytest.fixture(scope="module")
def pool():
    return event_pool.make_pool(SEED, CONFIG["source_events"], 64, PIECE_S,
                                "cpu")


def _run(pool, patches=()):
    """Both chains over the pieces; returns what the program sent and
    sifted, chunk for chunk, and the parties."""
    pipeline._PROGRAM_CACHE.clear()
    ccfg = _chain_config()
    la, lb = make_direct_pair()
    alice = chain.AliceChain(ccfg, SEED, la, device="cpu")
    bob = chain.BobChain(ccfg, SEED, lb, device="cpu")
    state = {"piece": None, "matches": None, "pushed": None}
    chunks, answered, syndromes, batches = [], [], [], []
    unanswered = collections.defaultdict(collections.deque)
    send_a, send_b = la.send, lb.send

    def alice_send(msg):
        if isinstance(msg, TimingBasis):
            ch = {"piece": state["piece"], "frame": int(msg.window_id)}
            chunks.append(ch)
            unanswered[ch["frame"]].append(ch)
        elif isinstance(msg, Syndromes):
            syndromes.append((msg.window_id, msg.rate_index))
        send_a(msg)

    def bob_send(msg):
        if isinstance(msg, SiftIndex):
            ch = unanswered[int(msg.window_id)].popleft()
            ch["count"] = msg.count if msg.count >= 0 else len(msg.indices)
            ch["index"] = np.asarray(msg.indices)[:ch["count"]]
            state["answers"].append(ch)
            answered.append(ch)
        send_b(msg)
    la.send, lb.send = alice_send, bob_send

    def recorded_match(*a):
        r = match(*a)
        state["matches"].append((int(a[5]), np.float32(r.residual)))
        return r

    push = bob.ec.push_sifted

    def recorded_push(bits, n=None):
        state["pushed"] = np.asarray(bits)[:n]
        return push(bits, n)
    bob.ec.push_sifted = recorded_push

    def hook(fn):
        def call(*args):
            state.update(matches=[], answers=[], pushed=None)
            fn(*args)
            batches.append(len(state["answers"]))
            lo = 0
            for i, ch in enumerate(state["answers"]):
                ch["offset"], ch["residual"] = state["matches"][i]
                ch["next"] = (state["matches"][i + 1][0]
                              if i + 1 < len(state["answers"])
                              else bob.offset)
                ch["bits"] = state["pushed"][lo:lo + ch["count"]]
                lo += ch["count"]
        return call
    bob._sift_batch = hook(bob._sift_batch)
    bob._sift_one = hook(bob._sift_one)

    with pytest.MonkeyPatch.context() as mp:
        for target, fn in patches:
            mp.setattr(sift, target, fn)
        match = sift.coincidence_match
        mp.setattr(sift, "coincidence_match", recorded_match)
        for w in range(FIRST, FIRST + PIECES):
            (ta, da), (tb, db) = pool.piece(w)
            state["piece"] = w
            alice.push_stream(ta, da)
            bob.push_stream(tb, db)
            for _ in range(10_000):
                if not (bob.pump() | alice.pump()):
                    break
        bob.flush_sift()
        for _ in range(10_000):
            if not (bob.pump() | alice.pump()):
                break
        alice.ec.drain_final()
    assert len(answered) == len(chunks)
    return {"chunks": answered,
            "syndromes": syndromes, "batches": batches,
            "alice": alice, "bob": bob}


@pytest.fixture(scope="module")
def sound(pool):
    with tracing.recording():
        tracing.clear()
        out = _run(pool)
        out["spans"] = tracing.recorded().spans
        tracing.clear()
    return out


def _reference(pool, ch):
    a = {c.frame: c for c in ref_sift.frame_chunks(*pool.piece(ch["piece"])[0])}
    b = {c.frame: c for c in ref_sift.frame_chunks(*pool.piece(ch["piece"])[1])}
    ca = a[ch["frame"]]
    cb = b.get(ch["frame"], ref_sift.Chunk(ch["frame"], np.zeros(0, np.int32),
                                           np.zeros(0, np.uint8)))
    return ca, ref_sift.match_chunk(ca, cb, ch["offset"],
                                    CONFIG["chain"]["coincidence_window"],
                                    CONFIG["chain"]["servo_gain"])


def _differs(pool, ch) -> bool:
    _, want = _reference(pool, ch)
    return not (ch["count"] == len(want.index)
                and np.array_equal(ch["index"], want.index)
                and np.array_equal(ch["bits"], want.bob_bits)
                and ch["residual"] == want.residual
                and ch["next"] == int(want.next_offset))


def test_each_chunk_is_the_references(pool, sound):
    chunks = sound["chunks"]
    frames = collections.Counter(ch["frame"] for ch in chunks)
    assert len(frames) == 2 and max(frames.values()) >= 8
    assert max(sound["batches"]) == 8 and sound["batches"].count(1) >= 1
    assert len(chunks) == PIECES + 1
    assert sum(ch["count"] for ch in chunks) > 150_000
    assert abs(sound["bob"].offset - pool.offset_units) <= 2
    assert [ch for ch in chunks if _differs(pool, ch)] == []


@pytest.mark.parametrize("part", sorted(control_chain.PARTS))
def test_each_control_differs(pool, part):
    target, fn = control_chain.PARTS[part]
    out = _run(pool, [(target.rsplit(".", 1)[1], fn)])
    wrong = [ch for ch in out["chunks"] if _differs(pool, ch)]
    assert len(wrong) >= len(out["chunks"]) // 2


def test_final_keys_are_the_references_splice_hashed(pool, sound):
    """Alice's stream is the chunks' reference splices in the order Bob
    answered them; each window takes B payloads of its rung in the order
    Alice sent its Syndromes; each key is their Toeplitz hash."""
    stream = np.concatenate([ref_sift.splice(*_splice_args(pool, ch))
                             for ch in sound["chunks"]])
    conf = dict(CONFIG, pipeline=PIPE)
    lad = session_check.rungs(conf)
    B = PIPE["blocks_per_window"]
    offset, pos = {}, 0
    for w, r in sound["syndromes"]:
        offset[w] = (pos, r)
        pos += B * lad[r].payload
    alice = sound["alice"].ec
    keys = list(zip(alice.final_key_index, alice._final_host))
    assert len(keys) >= 40
    for (w, b), bits in keys:
        lo, r = offset[w]
        P = lad[r].payload
        payload = stream[lo + b * P:lo + (b + 1) * P]
        want = ref_keys.block_key(SEED, w, b, payload, lad[r].l_max,
                                  len(bits))
        assert np.array_equal(want, bits), (w, b)
    np.testing.assert_array_equal(sound["bob"].ec.final_key_bits(),
                                  alice.final_key_bits())


@pytest.mark.parametrize("start", ["frame_start", "mid_frame"])
@pytest.mark.parametrize("offset_ns", [50, 300])
def test_pfind_locks_a_small_offset(start, offset_ns):
    """A link whose clock offset lies inside pfind's refinement window
    (+-2 coarse bins: 2 x 1,953 units here, near the cell's 2 x 1,526),
    with a first push that runs past pfind's span, from a frame's start
    (the chunk passed as it is) and from inside a frame (the chunk moved
    back by its first event): the acquired offset is the pool's, never
    the padding's."""
    source = dict(CONFIG["source_events"], offset_ns=offset_ns)
    pool = event_pool.make_pool(SEED + offset_ns, source, 8, 3 * PIECE_S,
                                "cpu")
    ccfg = dataclasses.replace(_chain_config(), pfind_bins=1 << 13)
    la, lb = make_direct_pair()
    alice = chain.AliceChain(ccfg, SEED, la, device="cpu")
    bob = chain.BobChain(ccfg, SEED, lb, device="cpu")
    found = []
    pfind = sift.pfind
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sift, "pfind", lambda *a, **k: found.append(
            int(pfind(*a, **k))) or found[-1])
        (ta, da), (tb, db) = pool.piece(0 if start == "frame_start" else 3)
        span = int(ccfg.window_s * event_pool.UNITS_PER_S)
        assert ta[-1] - ta[0] > span and (ta[0] < span // 2) == \
            (start == "frame_start")
        alice.push_stream(ta, da)
        bob.push_stream(tb, db)
        while bob.pump() and not found:
            pass
    assert len(found) == 1
    assert abs(found[0] - pool.offset_units) <= 1, (found, pool.offset_units)


def test_bob_holds_frames_until_announced():
    """Bob's stream runs 16 pieces of 50 ms (12 frames) ahead of Alice's
    announcements, as a saturating feed can: he keeps every frame she is
    still to announce, so no chunk of hers is answered empty, and he lets
    go of the frames she has moved past."""
    source = dict(CONFIG["source_events"], pair_rate_hz=1e5)
    pool = event_pool.make_pool(SEED, source, 16, 0.05, "cpu")
    ccfg = dataclasses.replace(_chain_config(), window_s=0.05)
    la, lb = make_direct_pair()
    alice = chain.AliceChain(ccfg, SEED, la, device="cpu")
    bob = chain.BobChain(ccfg, SEED, lb, device="cpu")
    counts = []
    send = lb.send

    def bob_send(msg):
        if isinstance(msg, SiftIndex):
            counts.append(msg.count if msg.count >= 0 else len(msg.indices))
        send(msg)
    lb.send = bob_send
    for w in range(16):
        alice.push_stream(*pool.piece(w)[0])
        bob.push_stream(*pool.piece(w)[1])
    assert max(bob._events) - min(bob._events) > 8
    for _ in range(10_000):
        if not (bob.pump() | alice.pump()):
            break
    bob.push_stream(*pool.piece(16)[1])
    bob.flush_sift()
    for _ in range(10_000):
        if not (bob.pump() | alice.pump()):
            break
    frames = 16 * 400_000_000 // ref_sift.FRAME_UNITS + 1
    assert len(counts) >= 16 + frames - 1
    assert min(counts) > 0
    assert set(bob._events) <= {bob._announced, bob._announced + 1}


def _splice_args(pool, ch):
    ca, want = _reference(pool, ch)
    return ca, want.index


def test_chain_spans(sound):
    """One ``sift.batch`` a batch of chunks Bob sifted (its children
    inside it, its window the batch's frame ids), one ``sift.one`` a
    single chunk (``sift.pfind`` inside the first), both parties'
    ``chain.push_stream`` a piece, one ``chain.on_sift_index`` with its
    ``alice.splice`` a chunk; Bob's EC intake outside the sift spans."""
    spans = sound["spans"]
    by_id = {sp.id: sp for sp in spans}
    named = collections.defaultdict(list)
    for sp in spans:
        named[sp.name].append(sp)
    batches = [n for n in sound["batches"] if n > 1]
    assert len(named["sift.batch"]) == len(batches) >= 3
    assert sorted(len(sp.window) for sp in named["sift.batch"]) == \
        sorted(batches)
    for child in ("sift.pad", "sift.upload", "sift.match", "sift.outputs",
                  "sift.fetch"):
        assert len(named[child]) == len(batches)
        for sp in named[child]:
            assert by_id[sp.parent].name == "sift.batch"
            assert sp.window == by_id[sp.parent].window
    ones = sound["batches"].count(1)
    assert len(named["sift.one"]) == ones
    assert len(named["sift.pfind"]) == 1
    assert by_id[named["sift.pfind"][0].parent].name == "sift.one"
    assert len(named["chain.push_stream"]) == 2 * PIECES
    chunks = len(sound["chunks"])
    assert len(named["chain.on_sift_index"]) == chunks
    assert len(named["alice.splice"]) == sum(n for n in batches)
    for sp in named["alice.splice"]:
        assert by_id[sp.parent].name == "chain.on_sift_index"
    frames = {ch["frame"] for ch in sound["chunks"]}
    assert {sp.window for sp in named["chain.on_sift_index"]} == frames
    for sp in named["push_sifted"]:
        assert sp.parent is None
