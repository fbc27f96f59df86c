"""The bench: reconciled key bits per second per card at QBER 3%.

Counterpart of ``bench.py`` and of what it imports:
``benchmarks/config4_full_chain.py`` (``device_bsc_stream``,
``measure_full_chain``, ``measure_party``),
``benchmarks/config4_sifted_chain.py`` (``measure_sifted_chain``) and
``benchmarks/sift_bench.py`` (``synth_frames``).

    python -m qtpu_torch.bench [--device cuda|cpu]
    python -m qtpu_torch.cli [--device cuda|cpu] bench

Prints one JSON line {"metric", "value", "unit", "vs_baseline", "extra"}
with the reference's metric names and extra keys, plus ``extra["device"]``
(the card's name and power limit from nvidia-smi, or "cpu"), and writes it
to ``build/qtpu_torch/bench_last_run.json``.  The line before it,
``bench launches: {...}``, holds each BP kernel's launches per measurement
(the counts are set to 0 before each one).

The judged value is ``measure_party("bob")``: Bob's side of the
production session replayed alone against the recorded peer messages (a
deployment gives each party its own card), the median of the clean runs.
A run is clean when its timed region built or loaded no kernel and made no
window program.  The extras carry the layered decoder alone (regular
n = 4096, B = 1024, 30 iterations), the measured copy bandwidth, both
parties on one card (``measure_full_chain``, median of the clean runs), the
events -> key chain (``measure_sifted_chain``) and the sift matcher
(8 frames of 2^19 events per call).  The sifted stream is the reference's
own threefry BSC stream, bit for bit (``device_bsc_stream``).

The ``full_chain_*`` keys and ``per_chip_bob_window_ms`` keep the
reference's names but hold the median clean run's values, where the
reference reported its best run; ``per_chip_bob_best_bits_per_s`` is the
best clean run.  ``extra["host"]`` names the host the sessions ran on (CPU
model, the cores this process may use, and at the start and the end the
mean clock, the load average, the cost of one eager CPU op and of a fixed
Python loop): the sessions are host-bound.

Runs on ``cuda`` unless ``--device cpu`` is given (there B = 64 and two
repetitions for the decoder, as the reference's CPU branch).  Set
QTPU_PROFILE_DIR to trace the decode region with torch.profiler;
QTPU_BENCH_SKIP_FULL, QTPU_BENCH_SKIP_SIFTED_CHAIN and QTPU_BENCH_SKIP_SIFT
leave out the two-party and per-chip chains, the events -> key chain and
the sift matcher.  A measurement that fails makes the command fail.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qtpu_torch import _build
from qtpu_torch import pipeline as _pipeline
from qtpu_torch.devices import (DEFAULT_DEVICE, device_name, entry_device,
                                resolve_device)
from qtpu_torch.link import DirectLink

__all__ = ["device_bsc_stream", "measure_full_chain", "measure_party",
           "check_replay", "measure_sifted_chain", "synth_frames",
           "decode_inputs", "main"]

AUTH_BITS_PER_MESSAGE = 61   # Wegman-Carter one-time pad (qtpu_torch.auth)
SESSION_SEED = 0x5E55
ARTIFACT = _build.BUILD_DIR / "bench_last_run.json"


def _sync(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (CPU ops are done on return)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _made() -> int:
    """Window programs made plus kernel libraries built or loaded so far."""
    return _pipeline.programs_made + _build.build_events


def device_bsc_stream(total_bits: int, qber: float, seed: int,
                      chunk_bits: int = 1 << 23, device=DEFAULT_DEVICE):
    """(alice_chunks, bob_chunks): lists of fixed-shape uint8 chunks on
    ``device`` (the last one full too) forming a BSC(qber) pair, the
    stand-in for the sift stage's output.  Bit for bit the reference's
    stream: chunk i splits ``fold_in(key, i)`` into two keys; Alice's bits
    are ``uniform < 0.5`` of the first, Bob's flips ``uniform < qber`` (in
    float32) of the second, the key being the seed's uint64 as two uint32
    words."""
    from qtpu_torch import random as tf
    dev = resolve_device(device)
    key = tf.key_from_data(np.frombuffer(np.uint64(seed).tobytes(),
                                         np.uint32), dev)
    p = torch.tensor(np.float32(qber), device=dev)
    a_chunks, b_chunks = [], []
    for i in range(-(-total_bits // chunk_bits)):
        ka, kb = tf.split(tf.fold_in(key, i))
        a = (tf.uniform(ka, chunk_bits) < 0.5).to(torch.uint8)
        a_chunks.append(a)
        b_chunks.append(a ^ (tf.uniform(kb, chunk_bits) < p).to(torch.uint8))
    return a_chunks, b_chunks


def _make_feed(lead, pairs, cfg):
    """``feed()``: push the next chunk to every (session, chunks) of
    ``pairs`` while ``lead``'s stream holds fewer than max_need x
    (max_inflight_windows + 2) bits.  Chunks go in as they are consumed,
    as the sift stage delivers them, so the arena keeps its configured
    size."""
    state = {"i": 0}
    count = len(pairs[0][1])
    limit = lead.max_need * (cfg.max_inflight_windows + 2)

    def feed() -> None:
        i = state["i"]
        while i < count and lead.stream.remaining < limit:
            for sess, chunks in pairs:
                sess.push_sifted(chunks[i])
            i += 1
        state["i"] = i

    return feed


def _pump_until(alice, bob, la, lb, feed, n_windows: int) -> None:
    """Drive both sessions, feeding the stream, until Bob has settled
    ``n_windows`` windows or nothing can progress."""
    for _ in range(1_000_000):
        if bob.window_id >= n_windows:
            return
        feed()
        progressed = False
        if alice.can_start_window():
            alice.start_window()
            progressed = True
        m = lb.recv()
        if m is not None:
            bob.on_message(m)
            progressed = True
        m = la.recv()
        if m is not None:
            alice.on_message(m)
            progressed = True
        if bob.flush(block=False):
            progressed = True
        if not progressed and bob.flush(limit=1):
            progressed = True
        if not progressed:
            return


def measure_full_chain(windows: int = 24, qber: float = 0.03,
                       warmup_windows: int = 8, seed: int = 7, config=None,
                       device=DEFAULT_DEVICE,
                       chunk_bits: int = 1 << 23) -> dict:
    """Both parties of the production session on one device over a direct
    link that charges 61 authentication bits per message, fed the BSC
    stream; times ``windows`` windows after ``warmup_windows`` (the warm-up
    holds the rung switch and the first retry round), final keys drained
    to the host inside the timed region.  Keys and ledgers of the two
    parties must agree (checked after it).  ``trace_growth`` counts the
    kernels built or loaded and the window programs made while timed."""
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import (AliceSession, BobSession,
                                     production_config, pump_sessions)
    dev = resolve_device(device)
    cfg = config or production_config()
    total_bits = (windows + warmup_windows + 2) * cfg.n * cfg.blocks_per_window
    a_chunks, b_chunks = device_bsc_stream(total_bits, qber, seed,
                                           chunk_bits, dev)
    la, lb = make_direct_pair(auth_overhead_bits=AUTH_BITS_PER_MESSAGE)
    alice = AliceSession(cfg, SESSION_SEED, la, device=dev)
    bob = BobSession(cfg, SESSION_SEED, lb, device=dev)
    feed = _make_feed(alice, [(alice, a_chunks), (bob, b_chunks)], cfg)
    feed()
    _pump_until(alice, bob, la, lb, feed, warmup_windows)
    if bob.window_id < warmup_windows:
        raise RuntimeError("full chain: the warm-up did not complete")
    _sync(dev)
    consumed0 = alice.ledger.sifted_bits - alice.stream.remaining
    final0 = bob.ledger.final_bits
    made0 = _made()
    t0 = time.perf_counter()
    _pump_until(alice, bob, la, lb, feed, warmup_windows + windows)
    _sync(dev)
    dt = time.perf_counter() - t0
    growth = _made() - made0
    measured = bob.window_id - warmup_windows
    consumed = (alice.ledger.sifted_bits - alice.stream.remaining) - consumed0
    final = bob.ledger.final_bits - final0
    # Untimed: the loop stops when Bob settles the last window, which may
    # leave Alice's side of it queued.
    pump_sessions(alice, bob, la, lb)
    if not np.array_equal(alice.final_key_bits(), bob.final_key_bits()):
        raise RuntimeError("full chain: the final keys differ")
    if alice.ledger.as_dict() != bob.ledger.as_dict():
        raise RuntimeError("full chain: the ledgers differ")
    mets = bob.metrics[warmup_windows:]
    auth = int(bob.ledger.auth_bits)
    net = final - auth * measured // max(1, bob.window_id)  # measured share
    return {
        "windows": measured,
        "elapsed_s": round(dt, 4),
        "sifted_bits_per_s": round(consumed / dt, 1),
        "secret_bits_per_s": round(final / dt, 1),
        "secret_fraction": round(final / max(1, consumed), 4),
        "auth_bits_total": auth,
        "net_secret_bits_per_s": round(net / dt, 1),
        "window_ms": round(1e3 * dt / max(1, measured), 3),
        "iters_mean": round(float(np.mean([m.iters_mean for m in mets])), 2),
        "fer": round(1.0 - sum(m.blocks_ok for m in mets)
                     / max(1, sum(m.blocks for m in mets)), 5),
        "trace_growth": growth,
    }


class _Tap(DirectLink):
    """A direct link that also logs every message it sends."""

    def __init__(self, tx, rx, log: list):
        super().__init__(tx, rx)
        self._log = log

    def send(self, msg) -> None:
        self._log.append(msg)
        super().send(msg)


def _settled(party) -> set:
    """Windows a session finalized or aborted (within its history horizon,
    the last 64 windows)."""
    return set(party._completed) | set(party._aborted)


def _packed_by_key(msgs, windows) -> dict:
    """{(type, window, round): Counter of packed messages} of the messages
    whose window is in ``windows``."""
    from qtpu_torch.messages import pack_message
    out: dict = {}
    for m in msgs:
        if m.window_id in windows:
            key = (type(m).__name__, m.window_id, getattr(m, "round", -1))
            out.setdefault(key, collections.Counter())[pack_message(m)] += 1
    return out


def check_replay(sent, recorded, settled, n_windows: int,
                 cover=("VerifyAck", "RateSelect")) -> None:
    """Raise RuntimeError unless a replayed party's outbound messages
    ``sent`` equal the ``recorded`` ones: for every window of ``settled``
    (those both runs settled), the same multiset of packed messages per
    (type, window, round), retry and abort traffic included; and for every
    window below ``n_windows``, each type of ``cover`` the recording sent
    for it, the replay sent too."""
    got = _packed_by_key(sent, settled)
    want = _packed_by_key(recorded, settled)
    for key in sorted(got.keys() | want.keys()):
        if got.get(key) != want.get(key):
            raise RuntimeError(
                f"replay diverged from the recording at {key}: "
                f"{sum(got.get(key, {}).values())} sent, "
                f"{sum(want.get(key, {}).values())} recorded")
    sent_keys = {(type(m).__name__, m.window_id) for m in sent}
    for m in recorded:
        t, w = type(m).__name__, m.window_id
        if t in cover and w < n_windows and (t, w) not in sent_keys:
            raise RuntimeError(f"replay never sent {t} for window {w}")


def measure_party(side: str = "bob", windows: int = 24, qber: float = 0.03,
                  warmup_windows: int = 8, seed: int = 7, config=None,
                  device=DEFAULT_DEVICE, chunk_bits: int = 1 << 23) -> dict:
    """Throughput of ONE party's pipeline on one device (the judged metric
    is bits/s per card; a deployment gives each party its own).

    Runs the two-party session once untimed while logging the messages,
    then replays a fresh session of ``side`` ("bob" or "alice") against
    the logged peer messages and times only its handlers, device programs
    and key drains.  Bob's rate choice reads his QBER prior, which depends
    on when a decode lands: the recording logs the choice each window was
    answered with, and the replayed Bob is made to answer each window with
    it (WindowOpens the recorded Bob never answered are not delivered).
    After the timed region the replayed party's outbound messages must
    equal the recording's (``check_replay``).  ``trace_growth`` counts the
    kernels built or loaded and the window programs made while timed; a
    run with none is clean."""
    from qtpu_torch.messages import WindowOpen
    from qtpu_torch.pipeline import AliceSession, BobSession, production_config
    if side not in ("bob", "alice"):
        raise ValueError(f"side must be 'bob' or 'alice', got {side!r}")
    dev = resolve_device(device)
    cfg = config or production_config()
    n_total = windows + warmup_windows
    a_chunks, b_chunks = device_bsc_stream(
        n_total * cfg.n * cfg.blocks_per_window, qber, seed, chunk_bits, dev)

    # Recording pass (untimed).
    qa, qb = collections.deque(), collections.deque()
    to_alice, to_bob = [], []
    la, lb = _Tap(qa, qb, to_bob), _Tap(qb, qa, to_alice)
    alice = AliceSession(cfg, SESSION_SEED, la, device=dev)
    bob = BobSession(cfg, SESSION_SEED, lb, device=dev)
    choices = {}
    bob_choose = bob._choose

    def record_choose():
        # Called for the window at the head of the open queue, again while
        # the stream is short: the last call is the answer sent.
        choices[bob._open_q[0]] = c = bob_choose()
        return c

    bob._choose = record_choose
    feed = _make_feed(alice, [(alice, a_chunks), (bob, b_chunks)], cfg)
    feed()
    _pump_until(alice, bob, la, lb, feed, n_total)
    if bob.window_id < n_total:
        raise RuntimeError("measure_party: the recording did not complete")
    _sync(dev)

    # Replay pass: a fresh session of ``side``, timed.
    sink = collections.deque()
    link = DirectLink(sink, collections.deque())
    if side == "bob":
        sess = BobSession(cfg, SESSION_SEED, link, device=dev)
        sess._choose = lambda: choices[sess._open_q[0]]
        inbound = [m for m in to_bob if not (
            isinstance(m, WindowOpen) and m.window_id not in choices)]
        chunks, recorder, recorded = b_chunks, bob, to_alice
    else:
        sess = AliceSession(cfg, SESSION_SEED, link, device=dev)
        inbound, chunks, recorder, recorded = to_alice, a_chunks, alice, to_bob
    feed = _make_feed(sess, [(sess, chunks)], cfg)
    feed()

    def step(i: int) -> int:
        feed()
        if side == "alice" and sess.can_start_window():
            sess.start_window()
        sess.on_message(inbound[i])
        if side == "bob":
            sess.flush(block=False)
            if len(sess._pending) >= cfg.max_inflight_windows:
                sess.flush(limit=1)   # backpressure: resolve the oldest only
        return i + 1

    def settle() -> None:
        if side == "bob":
            sess.flush()

    i = 0
    while i < len(inbound) and sess.window_id < warmup_windows:
        i = step(i)
    settle()
    _sync(dev)
    consumed0 = sess.ledger.sifted_bits - sess.stream.remaining
    made0 = _made()
    t0 = time.perf_counter()
    while i < len(inbound) and sess.window_id < n_total:
        i = step(i)
    settle()
    sess.drain_final()
    _sync(dev)
    dt = time.perf_counter() - t0
    growth = _made() - made0
    consumed = sess.ledger.sifted_bits - sess.stream.remaining - consumed0
    measured = sess.window_id - warmup_windows
    check_replay(list(sink), recorded, _settled(recorder) & _settled(sess),
                 n_total, ("VerifyAck", "RateSelect") if side == "bob"
                 else ("Syndromes",))
    return {
        "side": side,
        "windows": measured,
        "elapsed_s": round(dt, 4),
        "sifted_bits_per_s": round(consumed / dt, 1),
        "window_ms": round(1e3 * dt / max(1, measured), 3),
        "trace_growth": growth,
    }


def measure_sifted_chain(sim_windows: int = 120, pair_rate: float = 1e7,
                         blocks_per_window: int = 32, device=DEFAULT_DEVICE,
                         pipeline=None) -> dict:
    """The events -> key chain (pfind, batched coincidence sifting with the
    drift servo on the device, splicing, the EC pipeline) with both parties
    on one device, at ``production_config(blocks_per_window=...)`` unless
    ``pipeline`` gives another PipelineConfig.  Detector events are made
    before the timed region (the timestamp hardware's job); the first
    min(6, sim_windows // 3) windows warm up.  Every rate counts only what
    the timed windows added: events, the ledger's sifted bits and the
    final key's length each minus its value at the end of the warm-up."""
    from qtpu_torch.chain import AliceChain, BobChain, ChainConfig
    from qtpu_torch.channel import EntangledPairSource
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import production_config
    dev = resolve_device(device)
    window_s = 0.05
    cfg = ChainConfig(
        pipeline=pipeline or production_config(
            blocks_per_window=blocks_per_window, qber_test_bits=2048,
            stream_capacity_bits=1 << 25, drain_windows=4),
        window_s=window_s, sift_batch_frames=8)
    src = EntangledPairSource(pair_rate_hz=pair_rate, window_s=window_s,
                              offset_ns=4_321.0, error_rate=0.025,
                              dark_rate_hz=20_000.0)
    rng = np.random.default_rng(7)
    span_units = int(window_s * 8e9)
    streams = []
    for w in range(sim_windows):
        ev = src.generate(rng, start_epoch=w)
        base = np.int64(w) * span_units
        streams.append((
            (np.asarray(ev.alice.times[:ev.alice.count], np.int64) + base,
             ev.alice.detectors[:ev.alice.count]),
            (np.asarray(ev.bob.times[:ev.bob.count], np.int64) + base,
             ev.bob.detectors[:ev.bob.count])))
    total_events = sum(len(sa[0]) + len(sb[0]) for sa, sb in streams)

    la, lb = make_direct_pair()
    alice = AliceChain(cfg, SESSION_SEED, la, device=dev)
    bob = BobChain(cfg, SESSION_SEED, lb, device=dev)

    def pump() -> None:
        for _ in range(100_000):
            p = bob.pump()
            p = alice.pump() or p
            if not p:
                return

    warm = min(6, sim_windows // 3)
    for sa, sb in streams[:warm]:
        alice.push_stream(*sa)
        bob.push_stream(*sb)
        pump()
    warm_events = sum(len(sa[0]) + len(sb[0]) for sa, sb in streams[:warm])
    _sync(dev)
    sifted0 = bob.ec.ledger.sifted_bits
    key0 = len(bob.ec.final_key_bits())

    # Groups of 4 simulation windows between pumps, so the frame matcher
    # sees full batches of frames.
    group = 4
    rest = streams[warm:]
    t0 = time.perf_counter()
    for g in range(0, len(rest), group):
        for sa, sb in rest[g:g + group]:
            alice.push_stream(*sa)
            bob.push_stream(*sb)
        pump()
    bob.flush_sift()
    pump()
    bob.ec.flush()
    pump()
    _sync(dev)
    dt = time.perf_counter() - t0

    ka = alice.ec.final_key_bits()
    if not np.array_equal(ka, bob.ec.final_key_bits()):
        raise RuntimeError("events -> key chain: the final keys differ")
    sifted = bob.ec.ledger.sifted_bits
    events = total_events - warm_events
    return {
        "sim_windows": sim_windows - warm,
        "elapsed_s": round(dt, 3),
        "events_processed": events,
        "chain_events_per_s": round(events / dt, 0),
        "sifted_bits_total": int(sifted),
        "sifted_bits_warmup": int(sifted0),
        "final_key_bits": int(len(ka)),
        "final_key_bits_warmup": key0,
        "sifted_bits_per_s_wall": round((sifted - sifted0) / dt, 0),
        "chain_from_events_final_bits_per_s": round((len(ka) - key0) / dt, 0),
        "ec_windows": int(bob.ec.window_id),
        "acquired_offset_units": int(bob.offset),
        "mean_frame_events": round(events / max(1, len(bob.sift_stats)), 0),
        "pair_rate_hz": pair_rate,
        "blocks_per_window": cfg.pipeline.blocks_per_window,
    }


def synth_frames(rng, F, n_events, span, pair_frac=0.5, window=40):
    """Correlated (alice, bob) event frames: ``pair_frac`` of Bob's events
    are true pairs of Alice's (jittered within the coincidence window), the
    rest independent accidentals; both streams time-sorted."""
    ta = np.sort(rng.integers(0, span, (F, n_events)), axis=1).astype(np.int32)
    npair = int(n_events * pair_frac)
    pick = np.sort(rng.permutation(n_events)[:npair])
    tb_pair = ta[:, pick] + rng.integers(-window // 2, window // 2,
                                         (F, npair)).astype(np.int32)
    tb_acc = rng.integers(0, span, (F, n_events - npair)).astype(np.int32)
    tb = np.sort(np.concatenate([tb_pair, tb_acc], axis=1), axis=1)
    da = rng.integers(0, 4, (F, n_events)).astype(np.uint8)
    db = rng.integers(0, 4, (F, n_events)).astype(np.uint8)
    return ta, da, tb, db


def _cpuinfo() -> dict:
    """{field: [values]} of /proc/cpuinfo (empty where there is none)."""
    path = Path("/proc/cpuinfo")
    out: dict = {}
    for ln in (path.read_text().splitlines() if path.exists() else []):
        k, sep, v = ln.partition(":")
        if sep:
            out.setdefault(k.strip(), []).append(v.strip())
    return out


def _host_now() -> dict:
    """What the host gives this process now: the mean clock in MHz, the
    1/5/15-minute load average, the microseconds of one eager PyTorch op
    on a one-element CPU tensor (the dispatch cost the host-bound sessions
    pay per launch) and the milliseconds of a fixed pure-Python loop."""
    mhz = [float(v) for v in _cpuinfo().get("cpu MHz", [])]
    x = torch.zeros(1)
    t0 = time.perf_counter()
    for _ in range(20_000):
        x.add_(1)
    op_us = (time.perf_counter() - t0) / 20_000 * 1e6
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i
    loop_ms = (time.perf_counter() - t0) * 1e3
    return {"mhz_mean": round(float(np.mean(mhz)), 1) if mhz else None,
            "loadavg": [round(v, 2) for v in os.getloadavg()],
            "torch_cpu_op_us": round(op_us, 3),
            "python_loop_ms": round(loop_ms, 2)}


def _host() -> dict:
    """The host this process runs on: the CPU as /proc/cpuinfo names it,
    the cores this process may use and ``_host_now()`` as ``start``."""
    info = _cpuinfo()
    name = info.get("model name", [""])[0]
    if name in ("", "unknown"):      # some sandboxes hide the model name
        name = " ".join(f"{k} {info[k][0]}" for k in
                        ("vendor_id", "cpu family", "model") if k in info)
    return {"cpu": name or "unknown",
            "cores_usable": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count(), "start": _host_now()}


def _median_run(runs: list) -> tuple[dict, list]:
    """(the median run by sifted bits/s, the clean runs sorted by it).  A
    run is clean when its timed region made and built nothing (trace_growth
    0); fewer than two clean runs is a failed measurement."""
    clean = sorted((r for r in runs if r["trace_growth"] == 0),
                   key=lambda r: r["sifted_bits_per_s"])
    if len(clean) < 2:
        raise RuntimeError(f"{len(runs) - len(clean)} of {len(runs)} runs "
                           f"built kernels or made window programs while "
                           f"timed; the median needs two clean runs")
    return clean[len(clean) // 2], clean


DECODE_ITERS = 30


def decode_inputs(dev: torch.device, B: int):
    """(code, llr, syndrome) of the decode-alone measurement: a regular
    n = 4096 code, ``B`` blocks through a BSC(3%) from numpy seed 0."""
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.ldpc.decode import channel_llr
    from qtpu_torch.ldpc.encode import make_batch_encoder
    code = make_regular_code(4096)
    qber = 0.03
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    bob = keys ^ (rng.random((B, code.n)) < qber).astype(np.uint8)
    syn = make_batch_encoder(code)(torch.from_numpy(keys).to(dev)).contiguous()
    llr = channel_llr(torch.from_numpy(bob).to(dev), qber).contiguous()
    return code, llr, syn


def _decode_alone(dev: torch.device, extra: dict) -> float:
    """The layered decoder alone on ``decode_inputs`` (B = 1024 and 50
    calls on a card, B = 64 and 2 on the CPU), 30 iterations; fills the
    decode and copy-bandwidth extras and returns the decoded bits/s."""
    from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
    from qtpu_torch.metrics import profile_trace
    on_card = dev.type == "cuda"
    B = 1024 if on_card else 64
    code, llr, syn = decode_inputs(dev, B)
    dec = make_cuda_decoder(code, DECODE_ITERS, alg="layered")

    _sync(dev)
    t_warm = time.perf_counter()
    res = dec(llr, syn)
    converged = int(res.converged.sum())
    warm_s = time.perf_counter() - t_warm
    iters_sum = int(res.iterations.sum())
    if converged != B:
        raise RuntimeError(f"decode alone: {converged} of {B} blocks "
                           f"converged; the bench workload must converge")
    # The timed calls take ~10 ms on a card: keep it decoding for half a
    # second first, so that they do not start on an idle card.
    while time.perf_counter() - t_warm < warm_s + 0.5:
        dec(llr, syn)
        _sync(dev)
    reps = 50 if on_card else 2
    t0 = time.perf_counter()
    with profile_trace(os.environ.get("QTPU_PROFILE_DIR")):
        for _ in range(reps):
            dec(llr, syn)
        _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    decode_bits = B * code.n / dt
    # Bytes a call must move: llr f32 and syndrome u8 in, bits u8 and the
    # per-block stats out; set against the copy bandwidth measured here.
    decode_bytes_per_s = B * (code.n * 4 + code.m + code.n + 16) / dt

    # Copy bandwidth: v + 1 over 256 MB on a card (past the 50 MB L2), one
    # read and one write per element.
    nbytes = 1 << 28 if on_card else 1 << 26
    v = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev) + 1.0
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        v = v + 1.0
    _sync(dev)
    copy_bytes_per_s = 2 * nbytes * 10 / (time.perf_counter() - t0)
    del v
    extra.update({
        "decode_gbit_s": round(decode_bits / 1e9, 3),
        "decode_step_ms": round(dt * 1e3, 3),
        "decode_hbm_bytes_per_s": round(decode_bytes_per_s, 0),
        "hbm_copy_gbyte_s_measured": round(copy_bytes_per_s / 1e9, 1),
        "decode_hbm_roofline_frac": round(decode_bytes_per_s
                                          / copy_bytes_per_s, 4),
        "warmup_s": round(warm_s, 1),
        "decode_blocks": B,
        "decode_blocks_converged": converged,
        "decode_iterations_sum": iters_sum,
    })
    return decode_bits


def _sift_events_per_s(dev: torch.device) -> float:
    """Raw events of both parties per second through the batched
    coincidence matcher: 8 frames of 2^19 events per call, 10 calls."""
    from qtpu_torch import sift
    F, n_ev = 8, 1 << 19
    ta, da, tb, db = synth_frames(np.random.default_rng(0), F, n_ev,
                                  sift.MAX_SPAN - 1)
    matcher = sift.make_frame_matcher(F, window=40)
    args = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in
                 (ta, (da >> 1) & 1, tb, (db >> 1) & 1, db & 1))
    matcher(*args, 0)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        r = matcher(*args, 0)
    int(r.final_offset)
    _sync(dev)
    return 2 * F * n_ev / ((time.perf_counter() - t0) / 10)


def run(dev: torch.device) -> tuple[dict, dict]:
    """Every measurement of the bench on ``dev``: (the result line, each
    measurement's BP kernel launches)."""
    from qtpu_torch.ldpc import cuda_bp
    launches = {}

    def counted(name, fn):
        for k in cuda_bp.launches:
            cuda_bp.launches[k] = 0
        out = fn()
        _sync(dev)
        launches[name] = dict(cuda_bp.launches)
        return out

    extra = {"device": device_name(dev), "host": _host()}
    # The decoder's bits/s labels a run whose chains were skipped.
    value_bits = counted("decode", lambda: _decode_alone(dev, extra))
    value_kind = "decode_only"

    if os.environ.get("QTPU_BENCH_SKIP_FULL") is None:
        # Both parties on one card.  warmup_windows=8 keeps the rung switch
        # (~window 3) and the first retry round (~window 4) untimed.
        runs = counted("full_chain", lambda: [measure_full_chain(
            windows=16, warmup_windows=8, device=dev) for _ in range(3)])
        fc, _ = _median_run(runs)
        extra["full_chain_run_spread_ms"] = sorted(
            round(r["window_ms"], 1) for r in runs)
        extra["full_chain_traced_runs"] = sum(r["trace_growth"] > 0
                                              for r in runs)
        extra.update({
            "full_chain_sifted_bits_per_s": fc["sifted_bits_per_s"],
            "full_chain_secret_bits_per_s": fc["secret_bits_per_s"],
            "full_chain_net_secret_bits_per_s": fc["net_secret_bits_per_s"],
            "full_chain_secret_fraction": fc["secret_fraction"],
            "full_chain_window_ms": fc["window_ms"],
            "full_chain_fer": fc["fer"],
            "full_chain_auth_bits": fc["auth_bits_total"],
        })
        value_bits = fc["sifted_bits_per_s"]
        value_kind = "two_party_one_chip"

        # The judged number: Bob alone, the median of the clean runs.
        pruns = counted("per_chip", lambda: [measure_party(
            "bob", windows=16, warmup_windows=8, device=dev)
            for _ in range(3)])
        med, clean = _median_run(pruns)
        extra["per_chip_run_spread_ms"] = sorted(
            round(r["window_ms"], 1) for r in pruns)
        extra["per_chip_traced_runs"] = sum(r["trace_growth"] > 0
                                            for r in pruns)
        extra.update({
            "per_chip_bob_median_bits_per_s": med["sifted_bits_per_s"],
            "per_chip_bob_best_bits_per_s": clean[-1]["sifted_bits_per_s"],
            "per_chip_bob_window_ms": med["window_ms"],
        })
        value_bits = med["sifted_bits_per_s"]
        value_kind = "per_chip_median"

    if os.environ.get("QTPU_BENCH_SKIP_SIFTED_CHAIN") is None:
        sc = counted("sifted_chain", lambda: measure_sifted_chain(
            sim_windows=18, pair_rate=1e7, blocks_per_window=32, device=dev))
        extra.update({
            "chain_from_events_per_s": sc["chain_events_per_s"],
            "chain_from_events_sifted_bits_per_s":
                sc["sifted_bits_per_s_wall"],
            "chain_from_events_final_bits_per_s":
                sc["chain_from_events_final_bits_per_s"],
        })

    if os.environ.get("QTPU_BENCH_SKIP_SIFT") is None:
        extra["sift_events_per_s"] = round(_sift_events_per_s(dev), 0)
    extra["host"]["end"] = _host_now()

    metric_by_kind = {
        "per_chip_median":
            "full_chain_reconciled_bits_per_s_per_chip_qber3_median",
        "two_party_one_chip":
            "full_chain_reconciled_bits_per_s_two_party_one_chip_qber3",
        "decode_only": "decode_kernel_bits_per_s_qber3_FALLBACK",
    }
    out = {
        "metric": metric_by_kind[value_kind],
        "value": round(value_bits / 1e9, 4),
        "unit": "Gbit/s",
        "vs_baseline": round(value_bits / 1e9, 4),  # target: 1 Gbit/s
        "extra": extra,
    }
    return out, launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="qtpu_torch.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to measure (default cuda; fails when "
                        "CUDA is missing)")
    args = p.parse_args(argv)
    out, launches = run(entry_device("qtpu_torch.bench", args.device))
    print("bench launches: " + json.dumps(launches), flush=True)
    print(json.dumps(out), flush=True)
    ARTIFACT.parent.mkdir(parents=True, exist_ok=True)
    ARTIFACT.write_text(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
