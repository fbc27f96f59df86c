"""The program's spans inside the bench's timed regions: where the
per-chip replay of Bob spends the time that two parties on one card do
not.

    python -m qtpu_torch.replay_timers [--device cuda|cpu]

Runs the bench's two-party session (``bench.measure_full_chain``) and its
replay of Bob alone (``bench.measure_party``) as the bench runs them, at 7
timed windows after 6 and at 16 after 8, recording the program's spans
(``qtpu_torch.tracing``) and keeping those inside each function's timed
region (between its two ``bench._made()`` calls).  Per run and side: the
bench's own result, ``timed_ms`` (the region's wall time), ``outside_ms``
(its time outside every top-level span of the loop's thread: the loop's
own Python and ``AliceSession.can_start_window``, which no span covers),
``gc_ms`` (the garbage collector's pauses in it), ``settle_ms`` (the time
from the region's start to the first window Bob finalized, then from one
to the next), ``timers`` (each span name's summed time and calls) and
``dropped`` (spans the recorder's full buffer dropped).  The bench's
``_made`` and ``link.DirectLink.recv`` are wrapped while a run lasts and
restored after it, also when it fails.  Prints one JSON line last, with
``"device"``: the card's name and power limit from nvidia-smi, or "cpu".
Nothing else runs it: it is a measurement, kept so that its numbers can
be made again.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import threading
import time
from unittest import mock

import numpy as np

from qtpu_torch import tracing
from qtpu_torch.devices import (DEFAULT_DEVICE, device_name, entry_device,
                                resolve_device)

__all__ = ["replay", "main"]

# The runs: (timed windows, warm-up windows).
RUNS = ((7, 6), (16, 8))


def _recv_spanned(recv):
    """``DirectLink.recv`` inside a ``link.recv`` span.  The bench's loop
    polls the link every step, outside every handler, so no span of the
    program covers the call; wrapping it keeps its time out of
    ``outside_ms``.  ``AliceSession.can_start_window``, which no span
    covers either, is not wrapped: no method of a session is patched to
    time it, so its time stays in ``outside_ms``."""
    def spanned(self):
        with tracing.span("link.recv"):
            return recv(self)
    return spanned


def _timed_region(fn, dev, **kw) -> dict:
    """``fn`` (a bench measurement) run as the bench runs it, recording
    the program's spans; those between its two ``bench._made()`` calls,
    which open and close its timed region, are counted."""
    from qtpu_torch import bench
    from qtpu_torch.link import DirectLink
    st = {"made": 0, "on": False, "gc": 0.0}
    made = bench._made

    def region_edge():
        st["made"] += 1
        st["on"] = st["made"] == 1
        st["t1" if st["made"] == 2 else "t0"] = time.time_ns()
        return made()

    def on_gc(phase, info):
        if phase == "start":
            st["gc0"] = time.perf_counter()
        elif st["on"]:
            st["gc"] += time.perf_counter() - st["gc0"]

    tracing.clear()
    gc.callbacks.append(on_gc)
    try:
        with contextlib.ExitStack() as patches:
            patches.enter_context(mock.patch.object(bench, "_made",
                                                    region_edge))
            patches.enter_context(mock.patch.object(
                DirectLink, "recv", _recv_spanned(DirectLink.recv)))
            patches.enter_context(tracing.recording())
            res = fn(device=dev, **kw)
    finally:
        gc.callbacks.remove(on_gc)
    t0, t1 = st["t0"], st["t1"]
    rec = tracing.recorded()
    spans = [sp for sp in rec.spans if t0 <= sp.start_ns and sp.end_ns <= t1]
    loop = threading.get_ident()
    top = sum(sp.end_ns - sp.start_ns for sp in spans
              if sp.parent is None and sp.thread == loop)
    settled = sorted(sp.end_ns for sp in spans if sp.name == "bob.finalize")
    return {**res, "timed_ms": round((t1 - t0) / 1e6, 1),
            "outside_ms": round((t1 - t0 - top) / 1e6, 1),
            "gc_ms": round(1e3 * st["gc"], 1),
            "settle_ms": [round(x / 1e6, 1) for x in np.diff([t0, *settled])],
            "timers": tracing.table(spans), "dropped": rec.dropped}


def replay(device=DEFAULT_DEVICE, runs=RUNS, cfg=None,
           chunk_bits: int = 1 << 23) -> dict:
    """The program's spans in the bench's two-party session and in its
    replay of Bob, at each (timed, warm-up) window count of ``runs``.  See
    the module docstring."""
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
                  f"spans {row['outside_ms']} ms, drain "
                  f"{row['timers'].get('drain')}")
    out["device"] = device_name(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
