"""Where the window cycle's time goes: each window program, and the cycle's
host/device split.

Counterparts of ``benchmarks/profile_programs.py`` and
``benchmarks/profile_full_chain.py``:

    python -m qtpu_torch.profiling programs [REPS] [--device cuda|cpu]
    python -m qtpu_torch.profiling chain [WINDOWS] [--serial] [--device cuda|cpu]

``programs`` times each window program of ``production_config()`` at the
rung a 3% QBER prior selects (Alice's, Bob's, PA, pack, the retry of 8
rows), and the pieces the reference decomposes: the session's decoder at
the window's shape (``decode_only``), the verify hash (``verify_hash``)
and the PA seed rows (``pa_seed_gen``).  Per entry, under the reference's
key, the reference's number: ms a call over REPS back-to-back calls and
one synchronize.  On the TPU that was device time; with eager ops on a
card it is mostly the host's dispatch, so on a card each entry also gets
``device_ms`` (the summed kernel time a call in a torch.profiler trace of
REPS more calls, after one the trace leaves out) and ``launches`` (CUDA
kernels a call in that trace), and
``bp_launches`` counts the BP kernels' own launches a call; ``host``
is ``bench._host``'s probe, as in ``chain``.  No program reads a device
result on the host (their indices come from host arrays), so the call ms
is the host's dispatch wherever the card keeps up, and the card's time
where it does not (``decode_only``).

``chain`` drives the production pair over a direct link on the
reference's threefry BSC stream (QBER 3%, seed 7; ``bench.device_bsc_stream``)
with the reference's fixed-chunk feed and pump loop: WARMUP windows, then
WINDOWS timed ones.  Host timers under the reference's names wrap the
sessions' handlers, PA, the key drain, the affine stride and
``prng.derive``; with ``--serial`` each rung's device programs also
synchronize inside their timer, so a phase's number is its dispatch plus
device time.  It prints ``window_ms`` and ``sifted_bits_per_s`` and the
host probe of ``bench._host``, since the sessions are host-bound.  On a
card a torch.profiler trace of WINDOWS further windows gives the kernel
launches, kernel ms and busy ms per window (the union of the kernels'
intervals) and the ten kernels that take the most device time; those
windows are traced apart from the timed ones, since the profiler slows
the host several-fold: ``busy_share`` is the traced windows' busy ms per
window over the timed windows' ms per window (two runs: ``busy_share_of``
says so), ``traced_busy_share`` the same over the traced windows' own.
``mix`` (timed) and ``trace["mix"]`` (traced) give each run's windows a
rung, retried blocks and mean iterations, so a reader can see whether the
two did the same device work.  The patched methods are restored on exit,
also when the run fails.

Both run on ``cuda`` unless ``--device cpu`` is given (there nothing is
traced), and fail without a card.  Each prints one JSON line last, with
``"device"``: the card's name and power limit from nvidia-smi, or "cpu".
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import sys
import time
from unittest import mock

import numpy as np
import torch

from qtpu_torch.devices import (DEFAULT_DEVICE, device_name, entry_device,
                                resolve_device)
from qtpu_torch.ldpc import cuda_bp

__all__ = ["programs", "full_chain", "device_trace", "Timers", "main"]

PROGRAMS = ("alice_program", "bob_program", "pa", "pack", "retry_small",
            "decode_only", "verify_hash", "pa_seed_gen")
QBER = 0.03
TOP_KERNELS = 10


REGION = "qtpu_torch.profiling:"


class _Trace:
    """What a ``device_trace`` ran on the card: each kernel's (name,
    start µs, end µs), each copy's or memset's (start, end) and each
    region's (start, end) on the card's timeline.  ``kernels`` is None
    where nothing was traced (the CPU)."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.kernels = None
        self.copies = None
        self.regions = {}

    def region(self, name: str):
        """A context marking a region of the trace (a
        ``record_function`` range); a no-op where nothing is traced."""
        if not self.tracing:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(REGION + name)

    def part(self, name: str) -> "_Trace":
        """The kernels and copies that started inside region ``name``."""
        lo, hi = self.regions[name]
        out = _Trace(self.tracing)
        out.kernels = [k for k in self.kernels if lo <= k[1] <= hi]
        out.copies = [c for c in self.copies if lo <= c[0] <= hi]
        return out

    def busy_ms(self) -> float:
        """The union of the kernels' intervals, in ms."""
        total, end = 0.0, None
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e3

    def kernel_ms(self) -> float:
        return sum(e - s for _, s, e in self.kernels) / 1e3

    def copy_ms(self) -> float:
        return sum(e - s for s, e in self.copies) / 1e3

    def top(self, k: int) -> list:
        """The ``k`` kernel names with the most summed time: name (cut to
        120 characters), ms, launches."""
        ms, count = collections.Counter(), collections.Counter()
        for name, s, e in self.kernels:
            ms[name] += (e - s) / 1e3
            count[name] += 1
        return [{"name": name[:120], "ms": round(t, 4),
                 "launches": count[name]} for name, t in ms.most_common(k)]


@contextlib.contextmanager
def device_trace(dev: torch.device):
    """A torch.profiler trace (CPU and CUDA activity) of the block on a
    card, read into a ``_Trace`` on exit; on the CPU the block runs
    untraced and the ``_Trace`` stays empty.  The profiler stops on exit,
    also when the block raises.  Count only what a ``region`` of the
    trace ran: the profiler can miss a kernel or two launched right
    after it starts."""
    out = _Trace(dev.type == "cuda")
    if not out.tracing:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    out.kernels, out.copies, host_regions = [], [], {}
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        on_card = e.device_type == DeviceType.CUDA
        if e.name.startswith(REGION):
            # A region is a host range and, where it launched work, the
            # same range on the card's timeline (a "user annotation" over
            # its kernels): the latter is on the kernels' own clock.
            (out.regions if on_card else host_regions)[
                e.name[len(REGION):]] = span
        elif on_card and e.name.startswith(("Memcpy", "Memset")):
            out.copies.append(span)
        elif on_card:
            out.kernels.append((e.name, *span))
    out.regions = {**host_regions, **out.regions}


def _call_ms(dev, fn, reps: int) -> float:
    """ms a call: one warm call, then ``reps`` back-to-back calls between
    two synchronizes (the reference's ``bench``)."""
    from qtpu_torch.bench import _sync
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _measure(dev, fn, reps: int) -> dict:
    """``_call_ms``, then a trace of one more call and ``reps`` calls in a
    region: device ms and CUDA kernel launches a call in the region (None
    on the CPU), and the BP kernels' launches a call."""
    from qtpu_torch.bench import _sync
    ms = _call_ms(dev, fn, reps)
    with device_trace(dev) as tr:
        fn()
        _sync(dev)
        before = dict(cuda_bp.launches)
        with tr.region("calls"):
            for _ in range(reps):
                fn()
            _sync(dev)
    bp = {k: (v - before[k]) / reps for k, v in cuda_bp.launches.items()}
    if not tr.tracing:
        return {"ms": ms, "device_ms": None, "launches": None,
                "bp_launches": bp}
    calls = tr.part("calls")
    return {"ms": ms, "device_ms": calls.kernel_ms() / reps,
            "launches": len(calls.kernels) / reps, "bp_launches": bp}


def programs(device=DEFAULT_DEVICE, reps: int = 20, cfg=None) -> dict:
    """Every window program of ``cfg`` (default ``production_config()``)
    at the rung Bob's 3% prior selects, and the decode, verify-hash and
    PA-seed pieces at the window's shape, on one window of numpy-seeded
    bits; see the module docstring."""
    from qtpu_torch import random as tr
    from qtpu_torch.ldpc.decode import channel_llr, make_batch_decoder
    from qtpu_torch.link import DirectLink
    from qtpu_torch.pipeline import AliceSession, BobSession, production_config
    from qtpu_torch.window_programs import _check_exact_matmul, make_header
    from qtpu_torch.bench import SESSION_SEED, _host, _host_now
    dev = resolve_device(device)
    cfg = cfg or production_config()
    host = _host()
    qa, qb = collections.deque(), collections.deque()
    alice = AliceSession(cfg, SESSION_SEED, DirectLink(qa, qb), device=dev)
    bob = BobSession(cfg, SESSION_SEED, DirectLink(qb, qa), device=dev)
    bob.qest.update_prior(QBER * 1e6, 1e6)
    _, r, s, k_pb = bob._choose()
    prog_a, prog_b = alice.programs(r), bob.programs(r)
    P, B = alice.payload_per_block(r), cfg.blocks_per_window

    # The stream holds one window of bits.
    take = alice.window_payload_bits(r)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, take).astype(np.uint8)
    alice.stream.push(bits)
    bob.stream.push(bits ^ (rng.random(take) < QBER).astype(np.uint8))
    header_a = make_header(0, s, alice._window_key(0), alice._private_key(0),
                           test_bits_pb=k_pb, affine=alice._affine_for(0, P))
    header_b = make_header(0, s, bob._window_key(0), test_bits_pb=k_pb,
                           affine=bob._affine_for(0, P))
    arena_a, arena_b = alice.stream.arena, bob.stream.arena
    payload, syn, hashes, test_bits, short_vals = prog_a.alice(arena_a,
                                                               header_a)
    mag = np.float32(np.log((1 - QBER) / QBER))
    bob_args = (arena_b, header_b, test_bits, short_vals, syn, hashes, mag)
    hat, rx_orig, rx_pin, pinmask, stats = prog_b.bob(*bob_args)
    pakey = alice._pa_key(0, 0)
    fk = prog_a.pa(payload, pakey)
    R = 8 if B >= 8 else B
    positions = alice._retry_positions(0, 0, P, prog_a.retry_bits)
    retry_args = (arena_b, header_b, rx_orig, rx_pin, pinmask, hat, stats,
                  np.arange(R, dtype=np.int32), np.ones(R, np.uint8),
                  positions, prog_a.retry_gather(payload, positions), syn,
                  hashes, mag)

    step = alice.ladder.steps[r]
    dec = make_batch_decoder(step.code, cfg.max_iters, cfg.alg)
    llr = channel_llr(torch.from_numpy(
        rng.integers(0, 2, (B, step.code.n)).astype(np.uint8)).to(dev), QBER)
    syn_full = torch.from_numpy(rng.integers(
        0, 2, (B, step.code.m)).astype(np.uint8)).to(dev)
    # The reference hashes each block against its own P + 63 seed bits;
    # the port hashes a window against one (64, P) Toeplitz matrix (row j
    # is t[j : j + P]) with a float32 matmul: the first row's seed here.
    t = torch.from_numpy(rng.integers(
        0, 2, (B, P + cfg.verify_hash_bits - 1)).astype(np.uint8)).to(dev)[0]
    x = torch.from_numpy(rng.integers(0, 2, (B, P)).astype(np.uint8)).to(dev)

    def verify_hash():
        _check_exact_matmul(x)
        acc = x.to(torch.float32) @ t.unfold(0, P, 1).to(torch.float32).T
        return (acc.to(torch.int32) & 1).to(torch.uint8)

    rows = torch.arange(B, dtype=torch.int64, device=dev)
    calls = {
        "alice_program": lambda: prog_a.alice(arena_a, header_a),
        "bob_program": lambda: prog_b.bob(*bob_args),
        "pa": lambda: prog_a.pa(payload, pakey),
        "pack": lambda: prog_a.pack(fk),
        "retry_small": lambda: prog_b.retry_small(*retry_args),
        "decode_only": lambda: dec(llr, syn_full),
        "verify_hash": verify_hash,
        "pa_seed_gen": lambda: tr.seed_rows(tr.key_from_data(pakey, dev),
                                            rows, P + prog_a.l_max - 1),
    }
    res = {name: _measure(dev, calls[name], reps) for name in PROGRAMS}
    host["end"] = _host_now()
    return {"rung": r, "short_bits": s, "k_pb": k_pb, "P": P, "B": B,
            "reps": reps,
            **{name: round(m["ms"], 2) for name, m in res.items()},
            "device_ms": {name: None if m["device_ms"] is None
                          else round(m["device_ms"], 4)
                          for name, m in res.items()},
            "launches": {name: m["launches"] for name, m in res.items()},
            "bp_launches": {name: m["bp_launches"]
                            for name, m in res.items()},
            "host": host}


class Timers:
    """Host timers by name: total seconds and calls.  ``wrap`` times a
    function; with ``sync`` (a device) the timer also waits for the
    device's queued work, so it holds dispatch plus device time."""

    def __init__(self):
        self.times = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    def clear(self) -> None:
        self.times.clear()
        self.counts.clear()

    def wrap(self, name: str, fn, sync=None):
        from qtpu_torch.bench import _sync

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync is not None:
                _sync(sync)
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1
            return out
        return timed

    def table(self) -> dict:
        """{name: {total_ms, calls, ms_per_call}}, most time first."""
        return {name: {"total_ms": round(1e3 * t, 1),
                       "calls": self.counts[name],
                       "ms_per_call": round(1e3 * t / max(1,
                                                          self.counts[name]),
                                            3)}
                for name, t in sorted(self.times.items(),
                                      key=lambda kv: -kv[1])}


def _host_timers(pl, prng):
    """(owner, attribute, timer name) of the reference's host timers."""
    return (
        (pl.AliceSession, "start_window", "alice.start_window"),
        (pl.AliceSession, "_on_rate_select", "alice.on_rate_select"),
        (pl.AliceSession, "_on_verify_ack", "alice.on_verify_ack"),
        (pl.BobSession, "_service_opens", "bob.service_opens"),
        (pl.BobSession, "_on_syndromes", "bob.on_syndromes"),
        (pl.BobSession, "_resolve_decode", "bob.resolve_decode"),
        (pl._Party, "_privacy_amplify", "pa.host_total"),
        (pl._Party, "_drain_chunks", "drain_final_keys"),
        (pl._Party, "_affine_for", "host.affine_for"),
        (prng, "derive", "host.prng_derive"),
    )


# The program fields ``--serial`` times, and their timers' names.
SERIAL_PROGRAMS = (("alice", "alice_program"), ("bob", "bob_program"),
                   ("pa", "pa"), ("pack", "pack"),
                   ("retry_small", "retry_small"), ("retry", "retry"))


BUSY_SHARE_OF = ("the traced windows' busy ms a window over the timed "
                 "windows' ms a window: two runs of one session, compared "
                 "by their mix")


def _window_mix(metrics, lo: int, hi: int) -> dict:
    """What device work Bob's windows ``lo`` .. ``hi`` - 1 did: the
    windows a rung, the retried blocks and the mean iterations."""
    ms = [m for m in metrics if lo <= m.window_id < hi]
    rungs = collections.Counter(m.rate_index for m in ms)
    return {"rungs": {str(r): c for r, c in sorted(rungs.items())},
            "blocks_retried": sum(m.blocks_retried for m in ms),
            "iters_mean": round(float(np.mean([m.iters_mean for m in ms]))
                                if ms else 0.0, 2)}


def full_chain(device=DEFAULT_DEVICE, windows: int = 6, warmup: int = 6,
               serial: bool = False, cfg=None,
               chunk_bits: int = 1 << 23) -> dict:
    """The production pair's window cycle with host timers (and, with
    ``serial``, synchronizing timers on each rung's programs); on a card
    also a trace of ``windows`` further windows.  See the module
    docstring."""
    from qtpu_torch import pipeline as pl
    from qtpu_torch import prng
    from qtpu_torch.bench import (SESSION_SEED, _host, _host_now, _make_feed,
                                  _sync, device_bsc_stream)
    from qtpu_torch.link import make_direct_pair
    dev = resolve_device(device)
    cfg = cfg or pl.production_config()
    traced = dev.type == "cuda"
    per_window = cfg.n * cfg.blocks_per_window
    # A flush may settle two windows at once: each run may take one more.
    total_bits = (windows * (2 if traced else 1) + warmup + 4) * per_window
    a_chunks, b_chunks = device_bsc_stream(total_bits, QBER, 7, chunk_bits,
                                           dev)
    host = _host()
    timers = Timers()
    orig_programs = pl._Party.programs

    def serial_programs(self, rate_index):
        fresh = rate_index not in self._programs
        prog = orig_programs(self, rate_index)
        if fresh:
            who = type(self).__name__[:1].lower()
            prog = prog._replace(**{
                field: timers.wrap(f"dev.{label}[{who}]",
                                   getattr(prog, field), sync=self.device)
                for field, label in SERIAL_PROGRAMS})
            self._programs[rate_index] = prog
        return prog

    with contextlib.ExitStack() as patches:
        for owner, attr, name in _host_timers(pl, prng):
            patches.enter_context(mock.patch.object(
                owner, attr, timers.wrap(name, getattr(owner, attr))))
        if serial:
            patches.enter_context(mock.patch.object(pl._Party, "programs",
                                                    serial_programs))
        la, lb = make_direct_pair()
        alice = pl.AliceSession(cfg, SESSION_SEED, la, device=dev)
        bob = pl.BobSession(cfg, SESSION_SEED, lb, device=dev)
        # Fixed-shape chunks, pushed as the sessions consume them (the
        # sift stage's behavior).
        feed = _make_feed(alice, [(alice, a_chunks), (bob, b_chunks)], cfg)
        feed()

        def pump_until(n_windows: int) -> None:
            while bob.window_id < n_windows:
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
                if not progressed and not bob.flush():
                    return

        pump_until(warmup)
        _sync(dev)
        timers.clear()
        w_timed = bob.window_id
        t0 = time.perf_counter()
        pump_until(w_timed + windows)
        _sync(dev)
        total = time.perf_counter() - t0
        measured = bob.window_id - w_timed
        phases = timers.table()
        trace = None
        if traced:
            w0 = bob.window_id
            with device_trace(dev) as tr:
                torch.ones(1, device=dev).sum()
                _sync(dev)
                with tr.region("windows"):
                    t1 = time.perf_counter()
                    pump_until(w0 + windows)
                    _sync(dev)
                    wall = time.perf_counter() - t1
            part = tr.part("windows")
            n_tr = max(1, bob.window_id - w0)
            busy = part.busy_ms() / n_tr
            trace = {"windows": bob.window_id - w0,
                     "mix": _window_mix(bob.metrics, w0, bob.window_id),
                     "window_ms": round(1e3 * wall / n_tr, 3),
                     "busy_ms_per_window": round(busy, 3),
                     "busy_share": round(busy * measured / (1e3 * total), 4),
                     "busy_share_of": BUSY_SHARE_OF,
                     "traced_busy_share": round(part.busy_ms()
                                                / (1e3 * wall), 4),
                     "kernel_ms_per_window": round(part.kernel_ms() / n_tr,
                                                   3),
                     "copy_ms_per_window": round(part.copy_ms() / n_tr, 3),
                     "launches_per_window": round(len(part.kernels) / n_tr,
                                                  1),
                     "top_kernels": part.top(TOP_KERNELS)}
    host["end"] = _host_now()
    sifted = measured * per_window
    return {"mode": "serial" if serial else "pipelined",
            "windows": measured,
            "mix": _window_mix(bob.metrics, w_timed, w_timed + measured),
            "window_ms": round(1e3 * total / max(1, measured), 1),
            "sifted_bits_per_s": round(sifted / total, 1),
            "phases": phases, "trace": trace, "host": host}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="qtpu_torch.profiling", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("what", choices=("programs", "chain"))
    p.add_argument("count", nargs="?", type=int,
                   help="programs: calls per entry (20); chain: timed "
                        "windows (6)")
    p.add_argument("--serial", action="store_true",
                   help="chain: synchronize inside each program's timer")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; fails when CUDA is "
                        "missing)")
    args = p.parse_args(argv)
    dev = entry_device("qtpu_torch.profiling", args.device)
    before = dict(cuda_bp.launches)
    if args.what == "programs":
        out = programs(dev, reps=args.count or 20)
        print(f"rung={out['rung']} s={out['short_bits']} k_pb={out['k_pb']} "
              f"P={out['P']} B={out['B']}")
        for name in PROGRAMS:
            print(f"  {name:14s} {out[name]:9.2f} ms/call  device "
                  f"{out['device_ms'][name]} ms/call  launches "
                  f"{out['launches'][name]}/call")
    else:
        out = full_chain(dev, windows=args.count or 6, serial=args.serial)
        for name, row in out["phases"].items():
            print(f"  {name:26s} {row['total_ms']:9.1f} ms total  "
                  f"{row['calls']:4d} calls  {row['ms_per_call']:8.3f} "
                  f"ms/call")
    out["bp_launches_total"] = {k: v - before[k]
                             for k, v in cuda_bp.launches.items()}
    out["device"] = device_name(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
