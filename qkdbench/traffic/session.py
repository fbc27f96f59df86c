"""Traffic driver ``session``: both parties of a QKD link in one process, a
closed saturating loop, and a key consumer.

Alice and Bob run as ``qtpu_torch.pipeline.AliceSession`` and
``BobSession`` (``PipelineConfig`` built from the configuration file's
``pipeline`` fields, the session seed from ``--seed``) over
``qtpu_torch.link.make_direct_pair``, which charges the authentication
bits a message.  The sifted stream is a pool of BSC(qber) chunks made on
the card in set-up (``generators.bsc_pool``), fed to both parties in a
cycle whenever Alice's stream holds less than max_need x
(max_inflight_windows + 2) bits.  Every ``pull_windows`` windows Bob
finalizes, the consumer pulls both parties' keys
(``qtpu_torch.keystore.records_from_session``) and empties their host
lists, as a key manager pulls from a keystore; it keeps the keys of a
sample of windows drawn from the seed.

The window opens after a warm-up of ``warmup_windows`` windows (the rung
switch and the first retries) and one pull; it lasts ``--seconds``.
Then no window opens, the open ones finish, and the check compares, once
the program's state is freed: the sampled blocks' keys against the plain
reference (``reference.keys``: each key is the Toeplitz hash of Alice's
sifted bits at the block's stream positions, so Bob's correct key also
proves his corrected payload), Alice's keys against Bob's, both ledgers
against the one the link's messages give (``reference.session_check``),
and the decodes of a few windows drawn from the seed, each first decode
and each retry, against the plain layered min-sum (``reference.minsum``)
on the code the reference lifts from the configuration's base graph.  The decodes are
compared on the decoder's own inputs (the LLRs and syndromes the window
programs assembled); the stage before them is held by the keys.

The consumer and the hooks lean on the program's private names (the
sessions' key lists, ``_completed``, ``_aborted``, ``_inflight``,
``_pending``; ``window_programs.make_batch_decoder``,
``pipeline.make_window_programs`` and the programs' ``pa``): a run raises
where one is missing, where a pull hands out a key an earlier pull had,
or where a hook saw no call.

Workload keys (``traffic``): qber, chunk_bits, pool_chunks,
auth_bits_per_message, pull_windows, warmup_windows, keep_every (one
window in this many has its keys kept), keep_blocks (blocks kept a kept
window, beside its retried ones), check_windows (kept windows checked
against the reference), decode_skip_windows and decode_windows (the
decode check takes decode_windows windows in a row from a window drawn
from the first decode_skip_windows after the traced part), trace_seconds
(the traced part of a ``--trace 1`` window and, in every run, the part
before the decode check's windows).
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np

__all__ = ["run"]


def _draw(seed: int, *path) -> int:
    """A 64-bit number from the seed and a path (the sample's draws)."""
    data = repr((int(seed),) + path).encode()
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "little")


def _pipeline_config(fields: dict):
    from qtpu_torch.pipeline import PipelineConfig
    return PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in fields.items()})


class _Taps:
    """Logs what each party sends (``reference.session_check.SessionLog``)
    and when Alice opens each window."""

    def __init__(self, log):
        self.log = log
        self.opened = {}
        self.retried = {}    # window -> its retried blocks, as bits

    def wrap(self, link, who: str) -> None:
        from qtpu_torch.messages import (Abort, RetryDisclose, Syndromes,
                                         VerifyAck, WindowOpen)
        send, log, opened, retried = (link.send, self.log, self.opened,
                                      self.retried)

        def logged(msg):
            log.sent[who] += 1
            if isinstance(msg, WindowOpen):
                opened[msg.window_id] = time.perf_counter()
            elif isinstance(msg, Syndromes):
                log.syndromes.append((msg.window_id, msg.rate_index,
                                      msg.short_bits, msg.test_bits_pb))
            elif isinstance(msg, RetryDisclose):
                failed = np.array(msg.failed_mask, copy=True)
                log.retries.append((msg.window_id, msg.round, msg.num_bits,
                                    failed))
                retried[msg.window_id] = retried.get(msg.window_id, 0) | sum(
                    1 << int(b) for b in np.flatnonzero(failed))
            elif isinstance(msg, VerifyAck):
                log.acks[msg.window_id] = np.array(msg.ok_mask, copy=True)
            elif isinstance(msg, Abort):
                log.aborts.append((who, msg.window_id, msg.reason))
            send(msg)

        link.send = logged


def _require(obj, *names: str) -> None:
    """Raise where the program no longer has a name the benchmark reads,
    writes or wraps (a renamed attribute would otherwise be created, or
    go unread, without a sound)."""
    missing = [n for n in names if not hasattr(obj, n)]
    if missing:
        raise RuntimeError(
            f"qkdbench: {getattr(obj, '__name__', type(obj).__name__)} no "
            f"longer has {', '.join(missing)}, which the benchmark's "
            f"consumer or hooks use: qkdbench/traffic/session.py must "
            f"follow the program")


class _DecodeTap:
    """The program's decoder, wrapped where the window programs make it
    (``window_programs.make_batch_decoder``).  It counts the calls; in a
    traced run it records each call's shapes and returned iterations while
    the profiler runs; once ``arm``ed it copies, on the card, the inputs
    and outputs of Bob's decodes for the check: past ``skip`` windows, the
    first decode of each of the next ``windows`` windows, and the retry
    decode of each of those that is retried.  ``message`` is the (kind,
    window) Bob is handling: ``"first"`` for its Syndromes, ``"retry"``
    for a RetryDisclose."""

    def __init__(self, tracer, windows: int):
        self.tracer, self.windows = tracer, windows
        self.calls = 0
        self.traced = []
        self.message = None
        self.skip = None
        self.held = {}       # window -> [(code, llr, syndrome, bits, conv, iters)]
        self._undo = None

    def install(self) -> None:
        import qtpu_torch.window_programs as wp
        _require(wp, "make_batch_decoder")
        make, tap = wp.make_batch_decoder, self

        def make_batch_decoder(code, *a, **k):
            dec = make(code, *a, **k)

            def decode(llr, syndrome):
                w = tap._capture()
                inputs = (llr.clone(), syndrome.clone()) if w is not None \
                    else None
                res = dec(llr, syndrome)
                tap.calls += 1
                if tap.tracer.on:
                    tap.traced.append((code.n, code.m, code.mb,
                                       code.num_edges, code.z,
                                       int(llr.shape[0]), res.iterations))
                if w is not None:
                    tap.held.setdefault(w, []).append(
                        (code,) + inputs + (res.bits.clone(),
                                            res.converged.clone(),
                                            res.iterations.clone()))
                return res
            return decode

        wp.make_batch_decoder = make_batch_decoder
        self._undo = (wp, make)

    def remove(self) -> None:
        if self._undo is not None:
            self._undo[0].make_batch_decoder = self._undo[1]

    def arm(self, skip: int) -> None:
        self.skip = skip

    def _capture(self):
        """The window of a call to copy, or None."""
        if self.skip is None or self.message is None:
            return None
        kind, w = self.message
        if kind == "retry":
            return w if w in self.held else None
        if self.skip > 0:
            self.skip -= 1
            return None
        return w if len(self.held) < self.windows else None

    def retried(self) -> int:
        """How many held windows had a retry decode."""
        return sum(len(calls) > 1 for calls in self.held.values())


class _PaSpans:
    """In a traced run: each of the window programs' ``pa`` calls inside a
    ``pa`` span, with its shapes, while the profiler runs."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.calls = []
        self._undo = None

    def install(self) -> None:
        import qtpu_torch.pipeline as pl
        _require(pl, "make_window_programs")
        make, tracer, calls = pl.make_window_programs, self.tracer, \
            self.calls

        def make_window_programs(*a, **k):
            progs = make(*a, **k)
            _require(progs, "pa", "l_max", "_replace")
            pa = progs.pa

            def pa_spanned(payload, key):
                if not tracer.on:
                    return pa(payload, key)
                with tracer.span("pa"):
                    out = pa(payload, key)
                calls.append((int(payload.shape[0]), int(payload.shape[1]),
                              progs.l_max))
                return out
            return progs._replace(pa=pa_spanned)

        pl.make_window_programs = make_window_programs
        self._undo = (pl, make)

    def remove(self) -> None:
        if self._undo is not None:
            self._undo[0].make_window_programs = self._undo[1]


def run(ctx) -> dict:
    import torch
    from qtpu_torch import _build
    from qtpu_torch import pipeline as pl
    from qtpu_torch.keystore import records_from_session
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.messages import RetryDisclose, Syndromes

    from qkdbench import generators, stats
    from qkdbench.reference import codes as ref_codes
    from qkdbench.reference import keys as ref_keys
    from qkdbench.reference import session_check as ref
    from qkdbench.reference.minsum import layered_decode
    from qkdbench.run import Check

    tw = ctx.workload["traffic"]
    cfg = _pipeline_config(ctx.config["pipeline"])
    dev, tracer, seed = ctx.device, ctx.tracer, ctx.seed
    span = tracer.span
    B = cfg.blocks_per_window
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    _require(pl, "_PROGRAM_CACHE", "programs_made")
    _require(_build, "build_events")
    # Programs made by an earlier run in this process hold no hooks.
    pl._PROGRAM_CACHE.clear()
    dtap = _DecodeTap(tracer, int(tw["decode_windows"]))
    pas = _PaSpans(tracer)
    try:
        dtap.install()
        if tracer.active:
            pas.install()
        chunk_bits, pool_chunks = int(tw["chunk_bits"]), int(tw["pool_chunks"])
        pool_a, pool_b = generators.bsc_pool(
            seed, float(tw["qber"]), chunk_bits * pool_chunks, dev)
        chunks_a = pool_a.split(chunk_bits)
        chunks_b = pool_b.split(chunk_bits)

        log = ref.SessionLog()
        taps = _Taps(log)
        la, lb = make_direct_pair(
            auth_overhead_bits=int(tw["auth_bits_per_message"]))
        taps.wrap(la, "alice")
        taps.wrap(lb, "bob")
        alice = pl.AliceSession(cfg, seed, la, private_seed=seed + 1,
                                device=dev)
        bob = pl.BobSession(cfg, seed, lb, device=dev)
        for party in (alice, bob):
            _require(party, "_final_host", "final_key_index", "_completed",
                     "_aborted", "_inflight")
        _require(bob, "_pending")

        fed = {"chunks": 0}
        limit = alice.max_need * (cfg.max_inflight_windows + 2)

        def feed() -> None:
            while alice.stream.remaining < limit:
                i = fed["chunks"] % pool_chunks
                alice.push_sifted(chunks_a[i])
                bob.push_sifted(chunks_b[i])
                fed["chunks"] += 1

        def step(open_windows: bool = True) -> bool:
            with span("feed"):
                feed()
            progressed = False
            if open_windows and alice.can_start_window():
                with span("alice.start_window"):
                    alice.start_window()
                progressed = True
            m = lb.recv()
            if m is not None:
                dtap.message = (("first", m.window_id)
                                if isinstance(m, Syndromes) else
                                ("retry", m.window_id)
                                if isinstance(m, RetryDisclose) else None)
                with span("bob.on_message"):
                    bob.on_message(m)
                dtap.message = None
                progressed = True
            m = la.recv()
            if m is not None:
                with span("alice.on_message"):
                    alice.on_message(m)
                progressed = True
            with span("bob.flush"):
                if bob.flush(block=False):
                    progressed = True
            if not progressed:
                with span("bob.flush_wait"):
                    progressed = bob.flush(limit=1)
            return progressed

        keep_every, keep_blocks = int(tw["keep_every"]), int(tw["keep_blocks"])
        kept = {"alice": {}, "bob": {}}
        pulled = {"alice": set(), "bob": set()}
        settled = {"alice": set(), "bob": set()}
        delivered = {}
        pulls = {"s": 0.0, "count": 0, "finalized": 0}

        kept_window = {}

        def keep(w: int, b: int) -> bool:
            """Whether block b of window w has its keys kept: one window
            in keep_every, keep_blocks of its blocks and its retried ones,
            all drawn from the seed."""
            if w not in kept_window:
                kept_window[w] = _draw(seed, "window", w) % keep_every == 0
            if not kept_window[w]:
                return False
            if _draw(seed, "block", w, b) % B < keep_blocks:
                return True
            return bool(taps.retried.get(w, 0) >> b & 1)

        def pull() -> None:
            t = time.perf_counter()
            with span("key_pull"):
                for who, party in (("alice", alice), ("bob", bob)):
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
            pulls["finalized"] = len(bob.metrics)

        idle = {"steps": 0}
        pull_windows = int(tw["pull_windows"])

        def pump(until, open_windows: bool = True, steps: int = 0) -> None:
            """Step until ``until()`` (or ``steps`` steps, or a thousand
            steps in a row without progress: a session gone dead), pulling
            the keys every ``pull_windows`` windows Bob finalizes."""
            done = 0
            while not until() or done < steps:
                done += 1
                if step(open_windows):
                    idle["steps"] = 0
                else:
                    idle["steps"] += 1
                    if idle["steps"] > 1000 and not steps:
                        return
                if len(bob.metrics) - pulls["finalized"] >= pull_windows:
                    pull()
                if steps and done >= steps:
                    return

        # Set-up: the warm-up windows and one pull.
        warm = int(tw["warmup_windows"])
        pump(lambda: len(bob.metrics) >= warm)
        pull()
        if not dtap.calls:
            raise RuntimeError("qkdbench: the warm-up made no call to the "
                               "decoder window_programs.make_batch_decoder "
                               "made")
        if tracer.active:
            tracer.warm()
        sync()

        # The window.
        made0 = pl.programs_made + _build.build_events
        final0, win0 = bob.ledger.final_bits, len(bob.metrics)
        pull_s0 = pulls["s"]
        trace_s = float(tw["trace_seconds"])
        skip = _draw(seed, "decode") % int(tw["decode_skip_windows"])
        traced = {}
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        if tracer.active:
            tracer.start()
            traced["windows0"] = len(bob.metrics)
        while True:
            now = time.perf_counter()
            if dtap.skip is None and now - t0 >= trace_s:
                dtap.arm(skip)
            if tracer.on and tracer.elapsed() >= trace_s:
                tracer.stop()
                traced["windows"] = len(bob.metrics) - traced["windows0"]
            if now >= t_end:
                break
            pump(lambda: True, steps=1)
        if tracer.on:
            tracer.stop()
            traced["windows"] = len(bob.metrics) - traced["windows0"]
        t_stop = time.perf_counter()
        dt = t_stop - t0
        secret = bob.ledger.final_bits - final0
        finalized = len(bob.metrics) - win0
        pull_s = pulls["s"] - pull_s0
        made = pl.programs_made + _build.build_events - made0
        window_metrics = bob.metrics[win0:win0 + finalized]
        opened = {w: t for w, t in taps.opened.items() if t0 <= t < t_stop}
        # A window not delivered by the end counts with its wait so far;
        # a session that opened none waited the whole window.
        waits = stats.waits(opened, delivered, t0, t_stop) or [dt]
        if tracer.active and not (dtap.traced and pas.calls):
            raise RuntimeError(
                "qkdbench: the traced window saw no call to "
                + ("the decoder" if not dtap.traced else "the programs' pa")
                + ": the program no longer calls what the benchmark wraps")

        # After the window: the open windows finish, the last keys.
        pump(lambda: not alice._inflight and not bob._inflight
             and not bob._pending, open_windows=False)
        pull()
        sync()
        memory_peak = (torch.cuda.max_memory_reserved(dev) if cuda else 0)

        # The check's inputs, then the program's state is freed.
        exp = ref.expected(ctx.config, log, fed["chunks"] * chunk_bits,
                           int(tw["auth_bits_per_message"]))
        dead = alice.dead + bob.dead
        ledgers = {"alice": alice.ledger.as_dict(),
                   "bob": bob.ledger.as_dict()}
        kept_windows = sorted({w for w, _ in kept["bob"]} & set(opened))
        order = sorted(kept_windows, key=lambda w: _draw(seed, "check", w))
        check_windows = set(order[:int(tw["check_windows"])])
        lad = ref.rungs(ctx.config)
        n_pool = chunk_bits * pool_chunks
        samples = []
        for (w, b), bits in sorted(kept["bob"].items()):
            if w not in check_windows:
                continue
            off, r = exp.offset[w]
            P = lad[r].payload
            lo = (off + b * P) % n_pool
            idx = (torch.arange(P, device=dev) + lo) % n_pool
            samples.append((w, b, r, pool_a[idx].cpu().numpy(), bits))
        decoded = [(w, call) for w, calls in dtap.held.items()
                   for call in calls]
        decode_windows, decode_retried = len(dtap.held), dtap.retried()
        dtap.held = {}
        del alice, bob, la, lb, pool_a, pool_b, chunks_a, chunks_b
        pl._PROGRAM_CACHE.clear()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        dtap.remove()
        pas.remove()

    # The check.
    t_check = time.perf_counter()
    wrong = 0
    for w, b, r, payload, bits in samples:
        want = exp.length.get((w, b))
        if want is None or len(bits) != want:
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
    # The decoder: the sampled windows' decodes against the plain layered
    # min-sum in float32 on the reference's own lift of each rung's code.
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
        Check("blocks_key_wrong", wrong, 0),
        Check("blocks_checked", len(samples), 1, ">="),
        Check("blocks_parties_differ", differ, 0),
        Check("ledger_fields_wrong", ledger_wrong, 0),
        Check("aborts", len(log.aborts), 0),
        Check("sessions_dead", int(dead), 0),
        Check("code_differs", code_differs, 0),
        Check("decode_blocks_differ", decode_differ, 0),
        Check("decode_blocks_checked", decode_blocks, 1, ">="),
        Check("made_while_timed", made, 0),
    ]
    print(f"session: {len(opened)} windows opened, {finalized} finalized "
          f"in {dt:.3f} s; {pulls['count']} pulls; decodes checked: "
          f"{n_decoded} calls of {decode_windows} windows, "
          f"{decode_retried} of them retried; the check took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

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
