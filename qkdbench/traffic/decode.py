"""Traffic driver ``decode``: the program's batch decoder called back to back,
as the window programs call it, with no session around it.

The code is built by the program (``qtpu_torch.ldpc.codes.
make_regular_code``) and by the reference's frozen copy
(``reference.codes``), which must agree edge for edge.  The decoder is
``qtpu_torch.ldpc.decode.make_batch_decoder(code, max_iters, alg,
alpha)``.  Set-up makes a pool of ``batches_per_qber`` batches a QBER on
the card from ``--seed``: uniform words, the words through a BSC(q), the
benchmark's own syndromes of the words and the float32 LLRs of the
received bits; a call takes the next pooled batch, so the QBERs come in
turn.  At most ``max_inflight`` calls are in flight: each call's converged
flags and iterations go to pinned host memory by a non-blocking copy, and
a call waits for the oldest one's copy before it launches.

The window lasts ``--seconds`` and ends when the last call launched in it
has reached the host.  A sample of the calls, drawn from the seed over each
QBER's calls in the window (a reservoir for each QBER), keeps its outputs; after the window the
check decodes each sampled batch again with the plain float32 layered
min-sum (``reference.minsum``) and counts the blocks whose bits, iteration
count or converged flag differ, and the libraries built or loaded while
timed (``made_while_timed``, which must be 0).

Workload keys (``traffic``): qbers, batches_per_qber, max_inflight,
check_calls_per_qber, trace_seconds.
"""

from __future__ import annotations

import collections
import random
import sys
import time

import numpy as np

__all__ = ["run"]


def run(ctx) -> dict:
    import torch
    from qtpu_torch import _build
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.ldpc.decode import make_batch_decoder

    from qkdbench import generators, stats
    from qkdbench.reference import codes as ref_codes
    from qkdbench.reference.minsum import layered_decode
    from qkdbench.run import Check

    cc, dc = ctx.config["code"], ctx.config["decoder"]
    tw = ctx.workload["traffic"]
    dev, tracer, seed = ctx.device, ctx.tracer, ctx.seed
    span = tracer.span
    cuda = dev.type == "cuda"
    B, max_iters, alpha = int(dc["batch"]), int(dc["max_iters"]), \
        float(dc["alpha"])

    code = make_regular_code(cc["n"], cc["dv"], cc["dc"], seed=cc["seed"])
    rcode = ref_codes.make_regular_code(cc["n"], cc["dv"], cc["dc"],
                                        seed=cc["seed"])
    code_differs = ref_codes.differs(code, rcode)
    decoder = make_batch_decoder(code, max_iters, alg=dc["alg"], alpha=alpha)

    g = generators.generator(seed, dev)
    pool = []
    for _ in range(int(tw["batches_per_qber"])):
        for q in tw["qbers"]:
            words, received = generators.bsc_words(g, float(q), B, rcode.n,
                                                   dev)
            pool.append((generators.llr(received, float(q)).contiguous(),
                         ref_codes.syndromes(rcode, words).contiguous()))
            del words, received
    # A slot a call in flight: pinned host buffers for its converged flags
    # and iterations, and the event that marks their copy done.
    depth = int(tw["max_inflight"])
    host = [(torch.empty(B, dtype=torch.bool, pin_memory=cuda),
             torch.empty(B, dtype=torch.int32, pin_memory=cuda),
             torch.cuda.Event() if cuda else None) for _ in range(depth)]
    converged_np = [h[0].numpy() for h in host]
    inflight = collections.deque()
    tally = {"calls": 0, "failed": 0}
    sample_rng = random.Random(seed)
    k_sample = int(tw["check_calls_per_qber"])
    n_q = len(tw["qbers"])
    sample = {q: {} for q in range(n_q)}
    seen = [0] * n_q
    traced_calls = []

    def launch(i: int) -> None:
        llr, syn = pool[i % len(pool)]
        with span("decode"):
            res = decoder(llr, syn)
        conv_h, it_h, event = host[i % depth]
        with span("stats_copy"):
            conv_h.copy_(res.converged, non_blocking=True)
            it_h.copy_(res.iterations, non_blocking=True)
            if cuda:
                event.record()
        if tracer.on:
            traced_calls.append(res.iterations)
        inflight.append((i, res))

    def retire() -> None:
        i, res = inflight.popleft()
        event = host[i % depth][2]
        if cuda:
            with span("stats_wait"):
                event.synchronize()
        tally["failed"] += B - int(np.count_nonzero(converged_np[i % depth]))
        tally["calls"] += 1
        # A uniform sample of each QBER's calls in the window, drawn from
        # the seed (a reservoir a QBER).
        q = (i % len(pool)) % n_q
        c = seen[q]
        seen[q] += 1
        j = c if c < k_sample else sample_rng.randrange(c + 1)
        if j < k_sample:
            sample[q][j] = (i, res)

    # Set-up: every pooled batch once, through the same path.
    for i in range(len(pool)):
        launch(i)
        while len(inflight) >= depth:
            retire()
    while inflight:
        retire()
    tally.update(calls=0, failed=0)
    seen[:] = [0] * n_q
    for kept in sample.values():
        kept.clear()
    if tracer.active:
        tracer.warm()
    if cuda:
        torch.cuda.synchronize(dev)

    # The window.
    made0 = _build.build_events
    trace_s = float(tw["trace_seconds"])
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    if tracer.active:
        tracer.start()
    i = 0
    while True:
        now = time.perf_counter()
        if tracer.on and tracer.elapsed() >= trace_s:
            tracer.stop()
        if now >= t_end:
            break
        while len(inflight) >= depth:
            retire()
        launch(i)
        i += 1
    while inflight:
        retire()
    if tracer.on:
        tracer.stop()
    dt = time.perf_counter() - t0
    made = _build.build_events - made0
    calls, failed = tally["calls"], tally["failed"]
    memory_peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    traced = [(code.n, code.m, code.mb, code.num_edges, code.z, B,
               int(it.sum())) for it in traced_calls]
    print(f"decode: {calls} calls of {B} blocks in {dt:.3f} s",
          file=sys.stderr)

    # The check: the sampled calls against the plain float32 reference.
    del decoder
    differ = 0
    checked = [ir for kept in sample.values() for ir in kept.values()]
    for i, res in checked:
        llr, syn = pool[i % len(pool)]
        bits, conv, iters = layered_decode(rcode, llr, syn, max_iters, alpha)
        bad = ((bits != res.bits).any(dim=1) | (conv != res.converged)
               | (iters != res.iterations))
        differ += int(bad.sum())
    checks = [Check("code_differs", code_differs, 0),
              Check("blocks_checked", B * len(checked), 1, ">="),
              Check("blocks_differ", differ, 0),
              Check("made_while_timed", made, 0)]
    return {
        "window_start": t0,
        "attempted": calls * B,
        "failed": failed,
        "e2e": {"decoded_bits_per_s": stats.rate(calls * B * code.n, dt)},
        "memory_peak_bytes": int(memory_peak),
        "checks": checks,
        "record": {"traced": tracer.active, "calls": calls,
                   "decodes": traced},
    }
