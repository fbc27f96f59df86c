"""Host timers inside the bench's timed regions: where the per-chip
replay of Bob spends the time that two parties on one card do not.

    python -m qtpu_torch.replay_timers [--device cuda|cpu]

Runs the bench's two-party session (``bench.measure_full_chain``) and its
replay of Bob alone (``bench.measure_party``) as the bench runs them, at 7
timed windows after 6 and at 16 after 8, with ``profiling chain``'s host
timers and timers on the loops' own calls (``top.*``), all counted inside
each function's timed region only (between its two ``bench._made()``
calls).  Per run and side: the bench's own result, ``timed_ms`` (the
region's wall time), ``outside_ms`` (its time outside every ``top.*``
call), ``gc_ms`` (the garbage collector's pauses in it), ``settle_ms``
(the time from one settled window to the next) and ``timers``.  The
patched methods are restored on exit, also when a run fails.  Prints one
JSON line last, with ``"device"``: the card's name and power limit from
nvidia-smi, or "cpu".  Nothing else runs it: it is a measurement, kept
so that its numbers can be made again.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from unittest import mock

import numpy as np

from qtpu_torch.devices import (DEFAULT_DEVICE, device_name, entry_device,
                                resolve_device)
from qtpu_torch.profiling import Timers, _host_timers

__all__ = ["replay", "main"]

# The runs: (timed windows, warm-up windows).
RUNS = ((7, 6), (16, 8))


def _loop_timers(pl):
    """The calls the bench's loops make themselves (the top level)."""
    from qtpu_torch.link import DirectLink
    return (
        (pl.AliceSession, "start_window", "top.alice.start_window"),
        (pl.AliceSession, "can_start_window", "top.alice.can_start_window"),
        (pl.AliceSession, "on_message", "top.alice.on_message"),
        (pl.BobSession, "on_message", "top.bob.on_message"),
        (pl.BobSession, "flush", "top.bob.flush"),
        (pl._Party, "push_sifted", "top.push_sifted"),
        (pl._Party, "drain_final", "top.drain_final"),
        (DirectLink, "recv", "top.link.recv"),
    )


def _timed_region(fn, dev, **kw) -> dict:
    """``fn`` (a bench measurement) run as the bench runs it, with host
    timers counted only between its two ``bench._made()`` calls, which
    open and close its timed region."""
    from qtpu_torch import bench
    from qtpu_torch import pipeline as pl
    from qtpu_torch import prng
    timers, st = Timers(), {"made": 0, "on": False, "gc": 0.0, "settled": []}
    made, flush = bench._made, pl.BobSession.flush

    def region_edge():
        st["made"] += 1
        st["on"] = st["made"] == 1
        st["t1" if st["made"] == 2 else "t0"] = time.perf_counter()
        if st["on"]:
            timers.clear()
        else:
            st["table"] = timers.table()
        return made()

    def settling_flush(self, *a, **k):
        before = self.window_id
        out = flush(self, *a, **k)
        if st["on"] and self.window_id != before:
            st["settled"].append(time.perf_counter())
        return out

    def on_gc(phase, info):
        if phase == "start":
            st["gc0"] = time.perf_counter()
        elif st["on"]:
            st["gc"] += time.perf_counter() - st["gc0"]

    gc.callbacks.append(on_gc)
    try:
        with contextlib.ExitStack() as patches:
            patches.enter_context(mock.patch.object(bench, "_made",
                                                    region_edge))
            patches.enter_context(mock.patch.object(pl.BobSession, "flush",
                                                    settling_flush))
            for owner, attr, name in (*_host_timers(pl, prng),
                                      *_loop_timers(pl)):
                patches.enter_context(mock.patch.object(
                    owner, attr, timers.wrap(name, getattr(owner, attr))))
            res = fn(device=dev, **kw)
    finally:
        gc.callbacks.remove(on_gc)
    wall = 1e3 * (st["t1"] - st["t0"])
    top = sum(row["total_ms"] for name, row in st["table"].items()
              if name.startswith("top."))
    return {**res, "timed_ms": round(wall, 1),
            "outside_ms": round(wall - top, 1),
            "gc_ms": round(1e3 * st["gc"], 1),
            "settle_ms": [round(1e3 * x, 1) for x in
                          np.diff([st["t0"], *st["settled"]])],
            "timers": st["table"]}


def replay(device=DEFAULT_DEVICE, runs=RUNS, cfg=None,
           chunk_bits: int = 1 << 23) -> dict:
    """Host timers on the bench's two-party session and on its replay of
    Bob, at each (timed, warm-up) window count of ``runs``.  See the
    module docstring."""
    from qtpu_torch import bench
    dev = resolve_device(device)
    out = {"host": bench._host()}
    for windows, warmup in runs:
        kw = dict(windows=windows, warmup_windows=warmup, config=cfg,
                  chunk_bits=chunk_bits)
        out[f"{windows}_after_{warmup}"] = {
            "two_party": _timed_region(bench.measure_full_chain, dev, **kw),
            "replay": _timed_region(bench.measure_party, dev, side="bob",
                                    **kw)}
    out["host"]["end"] = bench._host_now()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="qtpu_torch.replay_timers", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; fails when CUDA is "
                        "missing)")
    args = p.parse_args(argv)
    dev = entry_device("qtpu_torch.replay_timers", args.device)
    out = replay(dev)
    for run in (k for k in out if k != "host"):
        for side, row in out[run].items():
            print(f"  {run} {side}: {row['window_ms']} ms a window, "
                  f"{row['timed_ms']} ms timed, outside the loop's "
                  f"calls {row['outside_ms']} ms, drain_final "
                  f"{row['timers'].get('top.drain_final')}")
    out["device"] = device_name(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
