"""Traffic driver ``chain``: both parties of an entanglement-based QKD link
fed with detector events, in one process, a closed saturating loop, and a
key consumer.

Alice and Bob run as ``qtpu_torch.chain.AliceChain`` and ``BobChain``
(``ChainConfig`` from the configuration file's ``chain`` fields around a
``PipelineConfig`` from its ``pipeline`` fields, the session seed from
``--seed``) over ``qtpu_torch.link.make_direct_pair``, which charges the
authentication bits a message; every message goes through the chains' own
``_dispatch``.  The events are a pool of ``pool_pieces`` pieces of the
chain's ``window_s`` made on the card in set-up (``event_pool``) and kept
on the host as a time-tagger's buffer; piece w of the stream is piece
w mod ``pool_pieces`` moved on by whole turns, handed to both parties'
``push_stream`` in absolute int64 units (the chopper's role) whenever
Alice's sifted stream, with the events of the chunks Bob has not answered
yet (counted at Alice's events, the most they can yield), holds less than
max_need x (max_inflight_windows + 2) bits.  Bob's EC is flushed without
blocking, as the ``session`` driver steps its sessions, and the consumer
pulls the keys every ``pull_windows`` windows Bob finalizes by the
``session`` consumer's rules and names.

The window opens after ``warmup_windows`` windows and one pull and lasts
``--seconds``; then no piece is fed, the open windows finish, and the
check compares, once the program's state is freed:

- the sifting: the chunks drawn from the seed after the traced part
  (``check_chunks`` of them, one in ``chunk_every`` as they come) and
  every chunk a checked window's kept blocks draw from, each against the
  plain matcher (``reference.sift``) run on the same events (framed by
  the reference itself from the piece) from the offset the program held
  at the chunk (recorded by hooks on ``BobChain._sift_batch`` /
  ``_sift_one`` and on ``qtpu_torch.sift``'s matcher): its index row,
  count, Bob's bits, residual and next offset;
- every chunk of the run: none answered empty where Bob's events of its
  piece reach into its frame (a program that does so in the warm-up, as
  one that lets go of frames its peer is still to announce does under this
  feed, is refused there: the run raises before its window);
- ``pfind``'s acquired offset against the pool's true one;
- the sampled blocks' keys against the reference's Toeplitz hash of the
  reference's splice at the block's stream positions (``reference.keys``),
  Alice's keys against Bob's, both ledgers against the link's messages,
  and the decodes of a few windows against the plain layered min-sum,
  as the ``session`` driver checks them (its helpers are reused).

In a traced run the sifting's device work (the matcher, the compaction,
a single chunk's match) runs inside a benchmark ``sift`` span and each
traced batch's events and sifted bits are recorded for
``sift_roofline.chain``.

Workload keys (``traffic``): pool_pieces, auth_bits_per_message,
pull_windows, warmup_windows, keep_every, keep_blocks, check_windows,
decode_skip_windows, decode_windows, check_chunks, chunk_every,
trace_seconds (as in ``session``).
"""

from __future__ import annotations

import collections
import functools
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["run"]


@functools.lru_cache(maxsize=1)
def _session_helpers():
    """The ``session`` driver beside this file, for its helpers."""
    from qkdbench import registry
    return registry.load_module(Path(__file__).with_name("session.py"),
                                "qkdbench_traffic_session_helpers")


def chain_config(config: dict):
    """The configuration file's ``ChainConfig``."""
    from qtpu_torch.chain import ChainConfig
    fields = {k: v for k, v in config["chain"].items() if k != "note"}
    return ChainConfig(pipeline=_session_helpers()._pipeline_config(
        config["pipeline"]), **fields)


class _Chunk:
    """One chunk as the program sifted it: where it came from (piece,
    frame, sequence number in Alice's sends), its place in the sifted
    stream, and the program's outputs while they are held."""
    __slots__ = ("seq", "piece", "frame", "alice_events", "bob_events",
                 "lo", "count", "offset", "residual", "next_offset",
                 "index", "bits", "bits_lo", "kept", "sampled")

    def __init__(self, seq: int, piece: int, frame: int, alice_events: int):
        self.seq, self.piece, self.frame = seq, piece, frame
        self.alice_events, self.bob_events = alice_events, None
        self.lo = self.count = None
        self.offset = self.residual = self.next_offset = None
        self.index = self.bits = None
        self.bits_lo = 0
        self.kept = self.sampled = False

    def keep(self) -> None:
        """Copy the chunk's outputs out of its batch's buffers."""
        import torch
        if self.kept:
            return
        if isinstance(self.index, torch.Tensor):
            self.index = self.index[:self.count].clone()
        if isinstance(self.bits, torch.Tensor):
            self.bits = self.bits[self.bits_lo:self.bits_lo
                                  + self.count].clone()
            self.bits_lo = 0
        self.kept = True

    def release(self) -> None:
        if not self.kept:
            self.index = self.bits = None
            self.offset = self.residual = self.next_offset = None

    def outputs(self) -> dict:
        """The held outputs on the host."""
        def host(x):
            return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

        def scalar(x):
            return None if x is None else (x.item() if hasattr(x, "item")
                                           else x)
        index = np.asarray(host(self.index))[:self.count]
        bits = np.asarray(host(self.bits))[self.bits_lo:self.bits_lo
                                           + self.count]
        res, off, nxt = (scalar(self.residual), scalar(self.offset),
                         scalar(self.next_offset))
        return {"index": index.astype(np.int64),
                "bits": bits.astype(np.uint8),
                "count": self.count,
                "offset": None if off is None else int(off),
                "residual": None if res is None else np.float32(res),
                "next_offset": None if nxt is None else int(nxt)}


class _SiftTap:
    """Hooks on Bob's sifting and on ``qtpu_torch.sift``: which chunk each
    answer is, the offset each was matched from, the residuals and the
    outputs; in a traced run, the benchmark's ``sift`` span around the
    sifting's device work and each traced batch's sizes."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.chunks = []                          # by sequence number
        self.unanswered = collections.defaultdict(collections.deque)
        self.answered = []                        # in the stream's order
        self.stream_end = 0
        self.batch = None
        self.piece = None
        self.in_span = False
        self.batches = 0
        self.traced = []                          # (alice, bob, sifted)
        self.pfind = []
        self.empty = []                           # answered empty, by seq
        self._undo = []

    # -- the module's functions -------------------------------------------
    def _spanned(self, fn):
        tap = self

        def call(*a, **k):
            if tap.in_span or not tap.tracer.on:
                return fn(*a, **k)
            tap.in_span = True
            try:
                with tap.tracer.span("sift"):
                    return fn(*a, **k)
            finally:
                tap.in_span = False
        return call

    def install(self, bob) -> None:
        import qtpu_torch.sift as ps
        sess = _session_helpers()
        sess._require(ps, "coincidence_match", "make_frame_matcher",
                      "sift_outputs", "pfind")
        sess._require(bob, "_sift_batch", "_sift_one", "offset", "ec")
        tap = self
        match, make, outputs, pfind = (ps.coincidence_match,
                                       ps.make_frame_matcher,
                                       ps.sift_outputs, ps.pfind)

        def coincidence_match(*a, **k):
            offset = a[5] if len(a) > 5 else k["offset"]
            r = match(*a, **k)
            if tap.batch is not None:
                tap.batch["matches"].append((offset, r.residual))
            return r

        def make_frame_matcher(*a, **k):
            return tap._spanned(make(*a, **k))

        def sift_outputs(*a, **k):
            out = outputs(*a, **k)
            if tap.batch is not None:
                tap.batch["bits"] = out[2]
            return out

        def pfind_(*a, **k):
            est = pfind(*a, **k)
            tap.pfind.append(est)
            return est

        for name, fn in (("coincidence_match",
                          self._spanned(coincidence_match)),
                         ("make_frame_matcher", make_frame_matcher),
                         ("sift_outputs", self._spanned(sift_outputs)),
                         ("pfind", pfind_)):
            self._undo.append((ps, name, getattr(ps, name)))
            setattr(ps, name, fn)
        for name in ("_sift_batch", "_sift_one"):
            setattr(bob, name, self._hook(bob, getattr(bob, name)))
        push = bob.ec.push_sifted

        def push_sifted(bits, n=None):
            if tap.batch is not None:
                tap.batch["pushed"] = bits
            return push(bits, n)
        bob.ec.push_sifted = push_sifted

    def remove(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []

    # -- Bob's sifting ----------------------------------------------------
    def _hook(self, bob, sift_fn):
        tap = self

        def hooked(*args):
            frames = args[0] if len(args) == 1 else [args]
            sizes = [(len(m.times), len(t)) for m, t, _ in frames]
            tap.batch = {"matches": [], "answers": [], "bits": None,
                         "pushed": None, "sizes": sizes}
            traced = tap.tracer.on
            try:
                sift_fn(*args)
                tap._settle(bob, traced)
            finally:
                tap.batch = None
        return hooked

    def _settle(self, bob, traced: bool) -> None:
        b = self.batch
        self.batches += 1
        answers, matches = b["answers"], b["matches"]
        if len(matches) != len(answers):
            raise RuntimeError(
                "qkdbench: Bob's sifting answered "
                f"{len(answers)} chunks with {len(matches)} matches: the "
                "program no longer matches a chunk a call of "
                "qtpu_torch.sift.coincidence_match")
        # One chunk: Bob's compacted bits went to his EC as they are; a
        # batch: the compaction's frame-major buffer, a chunk a slice.
        bits = b["pushed"] if b["bits"] is None else b["bits"]
        lo = 0
        for i, (ch, index, count) in enumerate(answers):
            ch.alice_events, ch.bob_events = b["sizes"][i]
            ch.offset, ch.residual = matches[i]
            ch.next_offset = (matches[i + 1][0] if i + 1 < len(matches)
                              else bob.offset)
            ch.index, ch.bits, ch.bits_lo = index, bits, lo
            lo += count
            if ch.sampled:
                ch.keep()
        if traced:
            self.traced.append((sum(a for a, _ in b["sizes"]),
                                sum(n for _, n in b["sizes"]), lo))

    # -- the link ---------------------------------------------------------
    def on_timing(self, msg) -> None:
        """Alice announces a chunk."""
        ch = _Chunk(len(self.chunks), self.piece, int(msg.window_id),
                    len(msg.times))
        self.chunks.append(ch)
        self.unanswered[ch.frame].append(ch)

    def on_index(self, msg):
        """Bob answers the oldest chunk of the frame (as Alice pairs
        them); returns it."""
        ch = self.unanswered[int(msg.window_id)].popleft()
        count = msg.count if msg.count >= 0 else len(msg.indices)
        ch.lo, ch.count = self.stream_end, int(count)
        self.stream_end += ch.count
        self.answered.append(ch)
        if self.batch is not None:
            self.batch["answers"].append((ch, msg.indices, ch.count))
        else:
            # A frame Bob held no events for: answered empty, unmatched.
            ch.index, ch.bits, ch.bob_events = np.zeros(0, np.int64), \
                np.zeros(0, np.uint8), 0
            ch.kept = True
            self.empty.append(ch.seq)
        return ch


def run(ctx) -> dict:
    import torch
    from qtpu_torch import _build
    from qtpu_torch import chain as pc
    from qtpu_torch import pipeline as pl
    from qtpu_torch.keystore import records_from_session
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.messages import (RetryDisclose, SiftIndex, Syndromes,
                                     TimingBasis)

    from qkdbench import event_pool, stats
    from qkdbench.reference import codes as ref_codes
    from qkdbench.reference import keys as ref_keys
    from qkdbench.reference import session_check as ref
    from qkdbench.reference import sift as ref_sift
    from qkdbench.reference.minsum import layered_decode
    from qkdbench.run import Check

    sess = _session_helpers()
    _draw, _require = sess._draw, sess._require
    tw = ctx.workload["traffic"]
    ccfg = chain_config(ctx.config)
    cfg = ccfg.pipeline
    dev, tracer, seed = ctx.device, ctx.tracer, ctx.seed
    span = tracer.span
    B = cfg.blocks_per_window
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    _require(pl, "_PROGRAM_CACHE", "programs_made")
    _require(_build, "build_events")
    pl._PROGRAM_CACHE.clear()
    dtap = sess._DecodeTap(tracer, int(tw["decode_windows"]))
    pas = sess._PaSpans(tracer)
    stap = _SiftTap(tracer)
    try:
        dtap.install()
        if tracer.active:
            pas.install()
        pool = event_pool.make_pool(seed, ctx.config["source_events"],
                                    int(tw["pool_pieces"]), ccfg.window_s,
                                    dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        log = ref.SessionLog()
        taps = sess._Taps(log)
        la, lb = make_direct_pair(
            auth_overhead_bits=int(tw["auth_bits_per_message"]))
        taps.wrap(la, "alice")
        taps.wrap(lb, "bob")
        alice = pc.AliceChain(ccfg, seed, la, device=dev)
        bob = pc.BobChain(ccfg, seed, lb, device=dev)
        _require(alice, "_dispatch", "ec")
        _require(bob, "_dispatch", "ec")
        for party in (alice.ec, bob.ec):
            _require(party, "_final_host", "final_key_index", "_completed",
                     "_aborted", "_inflight")
        _require(bob.ec, "_pending")
        stap.install(bob)

        lad = ref.rungs(ctx.config)
        keep_every, keep_blocks = int(tw["keep_every"]), int(tw["keep_blocks"])
        kept_window = {}

        def window_kept(w: int) -> bool:
            if w not in kept_window:
                kept_window[w] = _draw(seed, "window", w) % keep_every == 0
            return kept_window[w]

        consumed = {"end": 0, "next": 0}

        def on_window(w: int, rung: int) -> None:
            """Alice's Syndromes of window w: keep the outputs of the
            chunks a kept window draws from, release those behind it."""
            lo = consumed["end"]
            hi = lo + B * lad[rung].payload
            consumed["end"] = hi
            order = stap.answered
            i = consumed["next"]
            while i < len(order) and order[i].lo + order[i].count <= lo:
                order[i].release()
                i += 1
            consumed["next"] = i
            if window_kept(w):
                j = i
                while j < len(order) and order[j].lo < hi:
                    order[j].keep()
                    j += 1

        sample = {"armed": False, "chunks": []}
        chunk_every, check_chunks = int(tw["chunk_every"]), \
            int(tw["check_chunks"])
        unspliced = {"events": 0, "fifo": collections.defaultdict(
            collections.deque)}

        def wrap_alice(link):
            send = link.send

            def tapped(msg):
                if isinstance(msg, TimingBasis):
                    stap.on_timing(msg)
                    unspliced["events"] += len(msg.times)
                    unspliced["fifo"][int(msg.window_id)].append(
                        len(msg.times))
                elif isinstance(msg, Syndromes):
                    on_window(msg.window_id, msg.rate_index)
                send(msg)
            link.send = tapped

        def wrap_bob(link):
            send = link.send

            def tapped(msg):
                if isinstance(msg, SiftIndex):
                    ch = stap.on_index(msg)
                    if (sample["armed"] and len(sample["chunks"])
                            < check_chunks
                            and _draw(seed, "chunk", ch.seq) % chunk_every
                            == 0):
                        sample["chunks"].append(ch)
                        ch.sampled = True
                send(msg)
            link.send = tapped

        wrap_alice(la)
        wrap_bob(lb)

        limit = alice.ec.max_need * (cfg.max_inflight_windows + 2)
        fed = {"pieces": 0}

        def feed() -> None:
            while alice.ec.stream.remaining + unspliced["events"] < limit:
                w = fed["pieces"]
                (ta, da), (tb, db) = pool.piece(w)
                stap.piece = w
                alice.push_stream(ta, da)
                bob.push_stream(tb, db)
                fed["pieces"] += 1

        def step(open_windows: bool = True) -> bool:
            if open_windows:
                with span("feed"):
                    feed()
            progressed = False
            if open_windows and alice.ec.can_start_window():
                with span("alice.start_window"):
                    alice.ec.start_window()
                progressed = True
            m = lb.recv()
            if m is not None:
                dtap.message = (("first", m.window_id)
                                if isinstance(m, Syndromes) else
                                ("retry", m.window_id)
                                if isinstance(m, RetryDisclose) else None)
                with span("bob.on_message"):
                    bob._dispatch(m)
                dtap.message = None
                progressed = True
            m = la.recv()
            if m is not None:
                if isinstance(m, SiftIndex):
                    unspliced["events"] -= unspliced["fifo"][
                        int(m.window_id)].popleft()
                with span("alice.on_message"):
                    alice._dispatch(m)
                progressed = True
            with span("bob.flush"):
                if bob.ec.flush(block=False):
                    progressed = True
            if not progressed:
                with span("bob.flush_wait"):
                    progressed = bob.ec.flush(limit=1)
            return progressed

        kept = {"alice": {}, "bob": {}}
        pulled = {"alice": set(), "bob": set()}
        settled = {"alice": set(), "bob": set()}
        delivered = {}
        pulls = {"s": 0.0, "count": 0, "finalized": 0}

        def keep(w: int, b: int) -> bool:
            if not window_kept(w):
                return False
            if _draw(seed, "block", w, b) % B < keep_blocks:
                return True
            return bool(taps.retried.get(w, 0) >> b & 1)

        def pull() -> None:
            t = time.perf_counter()
            with span("key_pull"):
                for who, party in (("alice", alice.ec), ("bob", bob.ec)):
                    recs = records_from_session(party)
                    party._final_host = []
                    party.final_key_index = []
                    store, seen = kept[who], pulled[who]
                    for rec in recs:
                        key = (rec.window_id, rec.block_index)
                        if key in seen:
                            raise RuntimeError(
                                f"qkdbench: {who}'s block {key} came back "
                                f"in a later pull: emptying the session's "
                                f"key lists no longer empties them")
                        seen.add(key)
                        if keep(*key):
                            store[key] = rec.bits
                    settled[who] |= set(party._completed) | set(party._aborted)
            done = time.perf_counter()
            for w in (settled["alice"] & settled["bob"]) - delivered.keys():
                delivered[w] = done
            pulls["s"] += done - t
            pulls["count"] += 1
            pulls["finalized"] = len(bob.ec.metrics)

        idle = {"steps": 0}
        pull_windows = int(tw["pull_windows"])

        def pump(until, open_windows: bool = True, steps: int = 0) -> None:
            done = 0
            while not until() or done < steps:
                done += 1
                if step(open_windows):
                    idle["steps"] = 0
                else:
                    idle["steps"] += 1
                    if idle["steps"] > 1000 and not steps:
                        return
                if len(bob.ec.metrics) - pulls["finalized"] >= pull_windows:
                    pull()
                if steps and done >= steps:
                    return

        def dropped() -> int:
            """Chunks Bob answered empty though his events of their piece
            reach into their frame."""
            n = 0
            for s in stap.empty:
                ch = stap.chunks[s]
                tb = pool.piece(ch.piece)[1][0]
                lo, hi = np.searchsorted(
                    tb, [ch.frame * ref_sift.FRAME_UNITS,
                         (ch.frame + 1) * ref_sift.FRAME_UNITS])
                n += int(hi > lo)
            return n

        # Set-up: pfind and the warm-up windows, then one pull.
        warm = int(tw["warmup_windows"])
        pump(lambda: len(bob.ec.metrics) >= warm)
        pull()
        if dropped():
            raise RuntimeError(
                f"qkdbench: Bob answered {dropped()} of Alice's chunks "
                "empty in the warm-up though he held their events: the "
                "program drops frames its peer is still to announce when "
                "its stream runs ahead of her announcements, as this "
                "cell's feed makes it; it cannot run this cell")
        if not dtap.calls or not stap.pfind:
            raise RuntimeError(
                "qkdbench: the warm-up made no call to "
                + ("the decoder window_programs.make_batch_decoder made"
                   if not dtap.calls else "qtpu_torch.sift.pfind"))
        if tracer.active:
            tracer.warm()
        sync()

        # The window.
        made0 = pl.programs_made + _build.build_events
        final0, win0 = bob.ec.ledger.final_bits, len(bob.ec.metrics)
        pull_s0, batches0 = pulls["s"], stap.batches
        trace_s = float(tw["trace_seconds"])
        skip = _draw(seed, "decode") % int(tw["decode_skip_windows"])
        traced = {}
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        if tracer.active:
            tracer.start()
            traced["windows0"] = len(bob.ec.metrics)
        while True:
            now = time.perf_counter()
            if dtap.skip is None and now - t0 >= trace_s:
                dtap.arm(skip)
                sample["armed"] = True
            if tracer.on and tracer.elapsed() >= trace_s:
                tracer.stop()
                traced["windows"] = len(bob.ec.metrics) - traced["windows0"]
            if now >= t_end:
                break
            pump(lambda: True, steps=1)
        if tracer.on:
            tracer.stop()
            traced["windows"] = len(bob.ec.metrics) - traced["windows0"]
        t_stop = time.perf_counter()
        dt = t_stop - t0
        secret = bob.ec.ledger.final_bits - final0
        finalized = len(bob.ec.metrics) - win0
        pull_s = pulls["s"] - pull_s0
        made = pl.programs_made + _build.build_events - made0
        window_metrics = bob.ec.metrics[win0:win0 + finalized]
        opened = {w: t for w, t in taps.opened.items() if t0 <= t < t_stop}
        waits = stats.waits(opened, delivered, t0, t_stop) or [dt]
        if tracer.active and not (dtap.traced and pas.calls and stap.traced):
            raise RuntimeError(
                "qkdbench: the traced window saw no call to "
                + ("the decoder" if not dtap.traced else
                   "the programs' pa" if not pas.calls else
                   "Bob's sifting")
                + ": the program no longer calls what the benchmark wraps")
        batches = stap.batches - batches0

        # After the window: no piece is fed, the open windows finish.
        pump(lambda: not alice.ec._inflight and not bob.ec._inflight
             and not bob.ec._pending and not alice.ec.can_start_window(),
             open_windows=False)
        pull()
        sync()
        chunks_dropped = dropped()
        memory_peak = (torch.cuda.max_memory_reserved(dev) if cuda else 0)

        # The check's inputs, then the program's state is freed.
        exp = ref.expected(ctx.config, log, stap.stream_end,
                           int(tw["auth_bits_per_message"]))
        dead = alice.ec.dead + bob.ec.dead
        ledgers = {"alice": alice.ec.ledger.as_dict(),
                   "bob": bob.ec.ledger.as_dict()}
        kept_windows = sorted({w for w, _ in kept["bob"]} & set(opened))
        order = sorted(kept_windows, key=lambda w: _draw(seed, "check", w))
        check_windows = set(order[:int(tw["check_windows"])])
        blocks = []
        for (w, b), bits in sorted(kept["bob"].items()):
            if w not in check_windows:
                continue
            off, r = exp.offset[w]
            P = lad[r].payload
            blocks.append((w, b, r, off + b * P, off + (b + 1) * P, bits))
        needed = {}
        for ch in stap.answered:
            if ch.sampled or any(ch.lo < hi and lo < ch.lo + ch.count
                                 for _, _, _, lo, hi, _ in blocks):
                needed[ch.seq] = ch
        held = {}
        missing = 0
        for seq, ch in needed.items():
            if not ch.kept or ch.index is None:
                missing += 1
                continue
            held[seq] = ch.outputs()
        pfind_est = [int(e) for e in stap.pfind]
        decoded = [(w, call) for w, calls in dtap.held.items()
                   for call in calls]
        decode_windows, decode_retried = len(dtap.held), dtap.retried()
        sampled = len(sample["chunks"])
        dtap.held = {}
        for ch in stap.chunks:
            ch.index = ch.bits = ch.offset = ch.residual = None
            ch.next_offset = None
        del alice, bob, la, lb
        pl._PROGRAM_CACHE.clear()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        dtap.remove()
        pas.remove()
        stap.remove()

    # The check.
    t_check = time.perf_counter()
    window, gain = ccfg.coincidence_window, ccfg.servo_gain
    chunks_differ = 0
    differing = []
    splices = {}

    @functools.lru_cache(maxsize=4)
    def framed(piece: int):
        """The reference's chunks of a piece, by frame, each party."""
        (ta, da), (tb, db) = pool.piece(piece)
        return ({c.frame: c for c in ref_sift.frame_chunks(ta, da)},
                {c.frame: c for c in ref_sift.frame_chunks(tb, db)})

    for seq, ch in ((s, stap.chunks[s]) for s in sorted(needed)):
        out = held.get(seq)
        ref_a, ref_b = framed(ch.piece)
        a = ref_a.get(ch.frame)
        b = ref_b.get(ch.frame, ref_sift.Chunk(
            ch.frame, np.zeros(0, np.int32), np.zeros(0, np.uint8)))
        if out is None or a is None:
            chunks_differ += 1
            differing.append(f"chunk {seq} (piece {ch.piece}, frame "
                             f"{ch.frame}): "
                             + ("outputs not held" if out is None else
                                "no such frame in the reference's piece"))
            continue
        want = ref_sift.match_chunk(a, b, out["offset"] or 0, window, gain)
        splices[seq] = ref_sift.splice(a, want.index)
        same = (len(a.times) == ch.alice_events
                and len(b.times) == ch.bob_events
                and out["count"] == len(want.index)
                and np.array_equal(out["index"], want.index)
                and np.array_equal(out["bits"], want.bob_bits))
        if out["residual"] is not None:
            same = same and (out["residual"] == want.residual
                             and out["next_offset"] == int(want.next_offset))
        chunks_differ += int(not same)
        if not same:
            differing.append(
                f"chunk {seq} (piece {ch.piece}, frame {ch.frame}, offset "
                f"{out['offset']}): events alice {ch.alice_events} / "
                f"{len(a.times)}, bob {ch.bob_events} / {len(b.times)}; "
                f"count {out['count']} / {len(want.index)}; residual "
                f"{out['residual']} / {want.residual}; next offset "
                f"{out['next_offset']} / {int(want.next_offset)} "
                f"(program / reference)")
    pfind_error = (abs(pfind_est[0] - pool.offset_units) if pfind_est
                   else pool.offset_units)
    wrong = 0
    for w, b, r, lo, hi, bits in blocks:
        want = exp.length.get((w, b))
        parts = [splices[ch.seq][max(0, lo - ch.lo):hi - ch.lo]
                 for ch in stap.answered
                 if ch.seq in splices and ch.lo < hi and lo < ch.lo
                 + ch.count]
        payload = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        if want is None or len(bits) != want or len(payload) != hi - lo:
            wrong += 1
            continue
        ref_bits = ref_keys.block_key(seed, w, b, payload, lad[r].l_max,
                                      want)
        wrong += int(not np.array_equal(ref_bits, bits))
    differ = 0
    for key in kept["alice"].keys() | kept["bob"].keys():
        a, b = kept["alice"].get(key), kept["bob"].get(key)
        differ += int(a is None or b is None or not np.array_equal(a, b))
    for w in kept_windows:
        for b in range(B):
            if keep(w, b) and (w, b) in exp.length and (w, b) not in \
                    kept["bob"]:
                differ += 1
    ledger_wrong = sum(int(ledgers[p][f] != exp.ledger[f])
                       for p in ledgers for f in ref.LEDGER_FIELDS)
    rung_of = {w: r for w, r, _, _ in log.syndromes}
    codes = ref_codes.ladder_codes(ctx.config)
    alpha = float(ctx.config["decoder"]["alpha"])
    code_differs = decode_differ = decode_blocks = 0
    for w, (code, llr, syn, bits, conv, iters) in decoded:
        rcode = codes[rung_of[w]]
        code_differs += ref_codes.differs(code, rcode)
        ref_bits, ref_conv, ref_iters = layered_decode(
            rcode, llr, syn, cfg.max_iters, alpha)
        decode_differ += int(((ref_bits != bits).any(dim=1)
                              | (ref_conv != conv)
                              | (ref_iters != iters)).sum())
        decode_blocks += int(llr.shape[0])
    n_decoded = len(decoded)
    del decoded
    blocks_opened = B * len(opened)
    failed = sum(B - exp.ok.get(w, 0) for w in opened)
    checks = [
        # Exact: the program's sifting is the reference's, bit for bit.
        Check("sift_chunks_differ", chunks_differ + missing, 0),
        Check("sift_chunks_checked", len(needed), check_chunks, ">="),
        # Exact: every chunk of the run is sifted, none answered empty
        # where Bob held its events.
        Check("sift_chunks_dropped", chunks_dropped, 0),
        # The clock offset pfind acquires at the cold start, within one
        # unit (125 ps) of the pool's: the mean lock truncates, so one
        # unit can stay.  It guards against a gross mis-lock only (a wrong
        # lock reads thousands of units); the sifting check holds the rest.
        Check("pfind_error_units", pfind_error, 1),
        Check("blocks_key_wrong", wrong, 0),
        Check("blocks_checked", len(blocks), 1, ">="),
        Check("blocks_parties_differ", differ, 0),
        Check("ledger_fields_wrong", ledger_wrong, 0),
        Check("aborts", len(log.aborts), 0),
        Check("sessions_dead", int(dead), 0),
        Check("code_differs", code_differs, 0),
        Check("decode_blocks_differ", decode_differ, 0),
        Check("decode_blocks_checked", decode_blocks, 1, ">="),
        Check("made_while_timed", made, 0),
    ]
    print(f"chain: {fed['pieces']} pieces fed, {len(stap.chunks)} chunks, "
          f"{batches} sift calls in the window, {len(stap.empty)} chunks "
          f"answered empty; {len(opened)} windows "
          f"opened, {finalized} finalized in {dt:.3f} s; {pulls['count']} "
          f"pulls; chunks checked {len(needed)} ({sampled} sampled); "
          f"decodes checked: {n_decoded} calls of {decode_windows} windows, "
          f"{decode_retried} of them retried; pool {pool.nbytes()} bytes "
          f"on the host; the check took {time.perf_counter() - t_check:.3f} "
          f"s", file=sys.stderr)
    for line in differing[:8]:
        print(f"chain: differs: {line}", file=sys.stderr)

    record = {
        "traced": tracer.active,
        "windows": finalized,
        "pull_s": pull_s,
        "blocks": sum(m.blocks for m in window_metrics),
        "blocks_retried": sum(m.blocks_retried for m in window_metrics),
        "trace_windows": traced.get("windows"),
        "decodes": [(n, m, mb, E, z, b, int(it.sum()))
                    for n, m, mb, E, z, b, it in dtap.traced],
        "pas": list(pas.calls),
        "sift_batches": list(stap.traced),
    }
    return {
        "window_start": t0,
        "attempted": blocks_opened,
        "failed": failed,
        "e2e": {"secret_bits_per_s": stats.rate(secret, dt),
                "key_latency_p95_ms": 1e3 * stats.percentile(waits, 95)},
        "memory_peak_bytes": int(memory_peak),
        "checks": checks,
        "record": record,
    }
