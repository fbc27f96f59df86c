#!/usr/bin/env python3
"""Drive qtpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root; needs a card

Phases (each prints one flushed line; any failure ends the run non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: both BP kernels from qtpu_torch/csrc/, one nvcc each, in
   parallel, with each kernel entry's registers and spills (-Xptxas -v);
3. layered kernel vs its plain PyTorch decoder, bits / iterations /
   converged equal, at a production native3 rung (n = 65536, B = 128 and
   B = 8), at every native3 rung of n = 65536 at B = 8 (the cluster size
   follows the rung's mb), at every native3 rung at B = 32 (the bench's
   events -> key chain), at a regular n = 4096 code at B = 256, and on the
   bench's own decode-alone inputs (``qtpu_torch.bench.decode_inputs``:
   regular n = 4096, B = 1024, 30 iterations), with the times of a decoder call, of one launch replayed from a CUDA graph
   (device time, no host cost) and of the plain decoder, the bound and the
   share of bound; the launch plan (cluster size, shared memory per CTA,
   cudaOccupancyMaxActiveClusters), the memory one B = 128 decode adds
   (<= 17 MB: outputs only), and the kernel at every cluster size that
   fits (phase 3's rung at B = 128 and on the batch's 8 slowest blocks,
   the mb = 4 rung at B = 128, regular n = 4096);
4. flooding kernel vs its plain decoder, the same checks: a regular
   n = 4096 code at B = 1024 over QBER 1-5% (max_iters 60; one CTA per
   block, with the memory one decode adds, <= outputs + 1 MB), rung 1
   (r0.600, punctured) of the n = 4096 mixed min-sum ladder at B = 64 and
   8, and phase 3's native3 rung (n = 65536, a cluster per block) at
   B = 128 and 8; the launch plan at every shape, the kernel at every
   cluster size that fits and 256, 512 and 1024 threads per CTA (regular
   B = 1024, mixed B = 64, native3 B = 128 and 8), and the device time of
   one round from blocks that never converge (regular n = 4096 at B = 1
   and 1024, the native3 rung at B = 1);
5. the PA FFT's integer margin at the production shape (< 0.25);
6. session: production_config(), Alice and Bob on this card over a direct
   link, fed a BSC(3%) stream generated on the card, for 20 windows —
   identical non-empty keys, equal ledgers, FER <= 0.05, a rung switch, a
   retry round, and the layered kernel launched by the session (its
   launches per window and their batch sizes printed);
7. min-sum session: n = 4096 mixed ladder, flooding decoder, B = 1024, the
   same checks, and only the flooding kernel launched;
8. chain: the events -> key entry point (simulated detector events at 10^7
   pairs/s, pfind, batched sifting, splice, min-sum EC) on this card —
   pfind within 50 units of the true offset, identical non-empty keys,
   equal ledgers, the flooding kernel launched;
9. cross-device parity: small layered and min-sum configs run on the card
   and on the CPU with identical input give identical keys, ledgers and
   per-window metrics;
10. stream PA: ``qtpu_torch.pa.stream_toeplitz`` on the card equals the
    golden GF(2) product at a small shape crossing segment boundaries, and
    at the production flush shape (4 windows x 128 blocks of the native3
    rung with the largest PA output, N = 2^25) the session's float64 flush
    equals the CPU's run of the same call; prints the float32 margin at the
    reference's 2^16-bit segments, the float64 margin, and both flush
    times;
11. stream-PA production session: production_config(pa_mode="stream") for
    8 windows (>= 2 flushes) — identical non-empty keys, equal ledgers,
    ledger.final_bits == the emitted key length, the layered kernel
    launched;
12. the CLI on the card: ``cli.main([... "demo"])`` in process with phase
    8's chain settings (identical keys, the flooding kernel launched),
    ``fer --rung 1 --qber 0.03 --blocks 1024`` at n = 4096 (the flooding
    kernel launched), and ``python -m qtpu_torch.cli ... alice`` / ``bob``
    as two processes on this card over 127.0.0.1 with channel
    authentication (equal key digests and ledgers, auth_bits > 0);
13. sharded decode: ``qtpu_torch.parallel.make_sharded_decoder`` over a
    mesh of 4 shards on this card — layered at phase 3's production rung
    (B = 128) and flooding at phase 4's regular n = 4096 batch (B = 1024) —
    equals one unsharded launch (bits, iterations, converged), launches its
    kernel exactly 4 times per call, and 8 blocks of each equal the golden
    model (``qtpu_torch.ldpc.golden``); both times;
14. mesh session: production_config(max_inflight_windows=1), Alice
    unsharded and Bob on a 4-shard mesh on this card, over BSC(3%) for 12
    windows, against an unsharded pair on the same input — identical
    non-empty keys, all four ledgers equal, every window's psum'd ledger
    equal to its host metrics, >= 4 layered launches per window;
15. mesh stream PA: at the production flush shape the 4- and 8-shard
    float64 flush equals the unsharded one, and the reference's float32
    sharded flush (each shard's L = N/4 or N/8 bits unsegmented) prints its
    margin; then production_config(pa_mode="stream") with the mesh Bob for
    8 windows (>= 2 flushes): identical keys, ledger.final_bits == the
    emitted key bits;
16. two processes: ``chip_smoke.py --mesh-worker RANK PORT`` twice on this
    card, joined by ``init_distributed(backend="gloo")``, each owning 2 of
    4 shards of Bob's program at phase 3's rung (B = 128): both psum'd
    ledgers equal each other and the one-process 4-shard program's on the
    same window;
17. the bench: ``python -m qtpu_torch.cli bench`` as a subprocess on this
    card (the decoder alone, the copy bandwidth, both parties on the card,
    Bob's replayed session three times each, the events -> key chain, the
    sift matcher; the reference's threefry BSC stream): its last line names
    the per-chip median metric with a value > 0, >= 2 of the per-chip runs
    are clean, the two-party FER <= 0.05, every decode-alone block
    converged, the measured copy bandwidth is below 1.05 x 3,350 GB/s, and
    its ``bench launches`` line shows the layered kernel launched by every
    measurement; the bound of its decode-alone call, from the iterations
    the bench's own call reported, equals phase 3's on the same inputs and
    is printed with the share of bound.  The line is printed;
18. the measuring scripts as subprocesses on this card, each JSON line
    printed: ``python -m qtpu_torch.baseline`` config1 (converged, the key
    exact), config2 (five QBER rows at B = 1024, the layered kernel
    launched on every call, its bits, iterations and converged flags at
    QBER 5% on config 2's own inputs == the plain decoder's here, each
    row's bound and share of bound), config3 (every rung of the n = 4096
    mixed ladder, one flooding launch each; the flooding kernel == the
    plain decoder on every rung's own B = 256 inputs; rungs 0, 1 and the
    last == ``measure_fer`` on the CPU), config5 (two gloo processes: ok,
    equal ledgers, == the one-process 8-shard program's on the card and on
    the CPU, 8 flooding launches) and efficiency (five rows, identical
    keys, ledger final bits == key bits; the layered kernel == the plain
    decoder on every rung of the sessions' ladder at B = 64 and at the
    retry's 8 rows with n/10 bits pinned); ``python -m
    qtpu_torch.profiling programs 10`` (every program
    launches kernels, device ms <= 1.05 x call ms, decode_only launches
    the layered kernel once a call) and ``chain 6`` (>= 6 timed windows,
    a busy share in (0, 1], launches per window printed).  The kernels line
    gains each kernel's launches on these paths.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
QBER = 0.03
SESSION_WINDOWS = 20
MINSUM_WINDOWS = 12
CHAIN_WINDOWS = 16
CHAIN_WARMUP = 3
STREAM_WINDOWS = 8
MESH_SHARDS = 4
MESH_WINDOWS = 12
DEMO_WINDOWS = 8
TCP_WINDOWS = 6
# benchmarks/config4_sifted_chain.py's source (BASELINE config 4).
CHAIN_SOURCE = dict(pair_rate_hz=1e7, window_s=0.05, offset_ns=4_321.0,
                    error_rate=0.025, dark_rate_hz=20_000.0)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def decode_inputs(code, B, qbers, seed, device, punct_cols=()):
    """Random codewords, BSC noise at per-block QBERs, channel LLRs at 3%
    (punctured columns at LLR 0), and the target syndromes."""
    import numpy as np
    import torch
    from qtpu_torch.ldpc.decode import channel_llr
    from qtpu_torch.ldpc.encode import make_batch_encoder
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (B, code.n), dtype=np.uint8)
    noise = (rng.random((B, code.n)) < np.asarray(qbers)[:, None])
    keys_t = torch.from_numpy(keys).to(device)
    llr = channel_llr(keys_t ^ torch.from_numpy(noise).to(device), QBER)
    for c in punct_cols:
        llr[:, c * code.z:(c + 1) * code.z] = 0.0
    syn = make_batch_encoder(code)(keys_t)
    return llr.contiguous(), syn.contiguous()


def time_cuda(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3
# bytes per second and float32 operations per second outside the tensor
# cores.  One min-sum edge-lane update (v2c = t - c2v, |v2c|, two compares
# for min1/min2, the sign product, alpha * min, c2v' - c2v, the total's
# add, the parity) is counted as 10 float32 operations.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_EDGE_LANE = 10


def decode_bound(code, B, iters_sum):
    """The least time the card could take for one decode launch: (ms,
    "bytes" or "operations").  Bytes: llr, syndrome and the code table read
    once, bits, converged and iterations written once.  Operations: the
    edge-lane updates of the sweeps (rounds) this run's blocks needed."""
    nbytes = B * (4 * code.n + code.m + code.n + 1 + 4) + 4 * (
        code.mb + 1 + 2 * code.num_edges)
    ops = iters_sum * code.num_edges * code.z * OPS_PER_EDGE_LANE
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_summary(log: str) -> list:
    """Per kernel entry of an ``-Xptxas -v`` log: registers and spills,
    each instantiation named by row width and layout (the layered kernel's
    also by its thread family)."""
    import re
    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb([01])E(?:Li(\d+)ELi(\d+)E)?",
                          m.group(1))
            layout = "cluster" if t and t.group(2) == "1" else "one CTA"
            name = (m.group(1) if not t else
                    f"<dmax {t.group(1)}, {layout}>" if t.group(3) is None
                    else f"<dmax {t.group(1)}, {layout}, {t.group(3)} "
                         f"threads x {t.group(4)} per SM>")
        elif "spill" in ln:
            spills = ln.strip()
        elif "Used" in ln and name:
            out.append(f"{name} {ln.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def plan_text(plan) -> str:
    return (f"C={plan.cluster}, {plan.smem} B/CTA, {plan.threads} threads, "
            f"{plan.max_clusters} resident")


def cluster_sweep(label, code, llr, syn, max_iters, reps, alg="layered",
                  threads=()):
    """The kernel at every cluster size that fits (the decoder picks one),
    and at each of ``threads`` per CTA (default: the plan's): {(C, threads):
    (device ms, resident blocks)}, each shape's result checked against the
    decoder's."""
    import torch
    from qtpu_torch.ldpc import cuda_bp
    B = llr.shape[0]
    dev = llr.device
    name = cuda_bp.KERNELS[alg]
    plan_for, tables = ((cuda_bp.layered_plan, cuda_bp.code_tables)
                        if alg == "layered" else
                        (cuda_bp.flooding_plan, cuda_bp.flooding_tables))
    ref = cuda_bp.make_cuda_decoder(code, max_iters, alg=alg)(llr, syn)
    tab = torch.from_numpy(tables(code)).to(dev)
    shape = (code.mb, code.nb, code.z, code.num_edges, cuda_bp._max_dc(code))
    out = {}
    for C in cuda_bp.CLUSTER_SIZES:
        try:
            plan = plan_for(code, dev, B, cluster=C)
        except ValueError:
            continue
        for t in threads or (plan.threads,):
            sh = cuda_bp._cluster_shape(name, *shape, C, t, dev.index)
            if sh is None or sh[2] <= 0:
                continue
            p = cuda_bp.KernelPlan(C, *sh)

            def run():
                return cuda_bp._launch(name, code, tab, llr, syn, max_iters,
                                       0.8125, p)
            got = run()
            assert torch.equal(got.bits, ref.bits) and torch.equal(
                got.iterations, ref.iterations) and torch.equal(
                got.converged, ref.converged), f"{label}: {C}x{t} disagrees"
            out[C, t] = (graph_ms(run, reps), p.max_clusters)
    chosen = plan_for(code, dev, B)
    say(f"cluster sweep {label} B={B} (device ms): " + ", ".join(
        f"C={C} x {t} threads {ms:.3f} ms ({act} resident)"
        + (" <- chosen" if (C, t) == (chosen.cluster, chosen.threads)
           else "") for (C, t), (ms, act) in out.items()))
    return out


def round_cost(label, code, llr, syn, alg="minsum"):
    """Device time of one decoding round (sweep), from blocks that never
    converge: the slope of a launch's device time between max_iters 10 and
    40.  Returns us per round of the launch."""
    from qtpu_torch.ldpc import cuda_bp
    t = {}
    for it in (10, 40):
        dec = cuda_bp.make_cuda_decoder(code, it, alg=alg)
        assert not bool(dec(llr, syn).converged.any()), label
        t[it] = graph_ms(lambda: dec(llr, syn), 3)
    us = 1e3 * (t[40] - t[10]) / 30
    B = llr.shape[0]
    say(f"round cost {label} B={B}: {us:.2f} us per round "
        f"({1e3 * us / B:.1f} ns per block-round); launch at max_iters 10 "
        f"{t[10]:.4f} ms, 40 {t[40]:.4f} ms")
    return us


def decode_added(kern, llr, syn) -> int:
    """Bytes of device memory one decode adds (max_memory_allocated)."""
    import torch
    dev = llr.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    res = kern(llr, syn)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated(dev) - before
    del res
    return added


def graph_ms(fn, reps):
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph
    and replayed once between CUDA events, so no host launch cost is in
    it (the plain ``time_cuda`` of a small batch times the host)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Timing(NamedTuple):
    err: int            # max |kernel - plain| over bits, iterations, flags
    ms: float           # one decoder call, CUDA events over back-to-back calls
    device_ms: float    # one launch replayed from a CUDA graph
    plain_ms: float     # the plain decoder, host clock
    bound_ms: float
    bound_by: str


def hold_to_plain(label, code, llr, syn, max_iters, alg="layered"):
    """The kernel's bits, iterations and converged flags == the plain
    decoder's on the same card inputs: (the plain result, its ms on the
    host clock)."""
    import torch
    from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
    from qtpu_torch.ldpc.decode import (make_flooding_decoder,
                                        make_layered_decoder)
    kern = make_cuda_decoder(code, max_iters, alg=alg)
    plain = (make_layered_decoder if alg == "layered"
             else make_flooding_decoder)(code, max_iters)
    torch.cuda.synchronize()
    got = kern(llr, syn)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = plain(llr, syn)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    assert torch_equal(got, ref), \
        f"{label}: kernel disagrees with the plain decoder"
    return ref, plain_ms


def kernel_vs_plain(label, code, llr, syn, max_iters, reps, alg="layered"):
    """Kernel against the plain decoder on the same card inputs, with both
    times, the device time and the bound."""
    from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
    kern = make_cuda_decoder(code, max_iters, alg=alg)
    ref, plain_ms = hold_to_plain(label, code, llr, syn, max_iters, alg)
    err = 0
    ms = time_cuda(lambda: kern(llr, syn), reps)
    dev_ms = graph_ms(lambda: kern(llr, syn), reps)
    iters = float(ref.iterations.float().mean())
    B = llr.shape[0]
    bound_ms, bound_by = decode_bound(code, B, int(ref.iterations.sum()))
    say(f"kernel {label}: B={B} n={code.n} max_abs_err={err} "
        f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.1f} "
        f"iters_mean={iters:.2f} iters_max={int(ref.iterations.max())} "
        f"converged={int(ref.converged.sum())}/{B} bound_ms={bound_ms:.4f} "
        f"({bound_by}) share_of_bound={bound_ms / ms:.4f} (device "
        f"{bound_ms / dev_ms:.4f})")
    return Timing(err, ms, dev_ms, plain_ms, bound_ms, bound_by)


def reset_launches():
    from qtpu_torch.ldpc import cuda_bp
    for name in cuda_bp.launches:
        cuda_bp.launches[name] = 0
        cuda_bp.launch_batches[name].clear()


def read_launches() -> dict:
    import torch
    from qtpu_torch.ldpc import cuda_bp
    torch.cuda.synchronize()
    return dict(cuda_bp.launches)


def bsc_on_card(dev, total, seed):
    """Alice's uniform bits and Bob's copy through a BSC(QBER), generated
    on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    a_src = torch.randint(0, 2, (total,), generator=g, device=dev,
                          dtype=torch.uint8)
    flips = (torch.rand((total,), generator=g, device=dev) < QBER)
    return a_src, a_src ^ flips.to(torch.uint8)


def check_session(label, alice, bob, timed, launches, kernel):
    """Identical non-empty keys, equal ledgers, FER <= 0.05 and the
    kernel launched; prints the session's line and returns its metrics."""
    import numpy as np
    ka, kb = alice.final_key_bits(), bob.final_key_bits()
    assert ka.size > 0 and np.array_equal(ka, kb), \
        f"{label}: final keys differ/empty"
    assert alice.ledger.as_dict() == bob.ledger.as_dict(), \
        f"{label}: ledgers differ"
    mets = bob.metrics
    fer = 1.0 - sum(m.blocks_ok for m in mets) / sum(m.blocks for m in mets)
    led = bob.ledger
    consumed = led.reconciled_bits + led.discarded_bits
    assert fer <= 0.05, f"{label}: FER {fer}"
    assert launches[kernel] > 0, f"{label}: {kernel} never launched"
    retried = sum(m.blocks_retried for m in mets)
    dt, n_timed = timed
    say(f"{label}: {len(mets)} windows, window_ms={1e3 * dt / n_timed:.2f} "
        f"(over {n_timed} windows after the first two) "
        f"iters_mean={np.mean([m.iters_mean for m in mets]):.2f} "
        f"fer={fer:.5f} secret_fraction={led.final_bits / consumed:.4f} "
        f"rungs={sorted({m.rate_index for m in mets})} "
        f"blocks_retried={retried} launches={launches} key_bits={ka.size}")
    return mets


def run_chain(cfg, dev, windows, warmup):
    """The events -> key chain on ``dev`` over a direct link, fed
    pre-generated detector events (the timestamp hardware's job, untimed).
    Returns (alice, bob, true offset, pfind estimate, events per second
    over the windows after ``warmup``)."""
    import numpy as np
    import torch
    from qtpu_torch import sift
    from qtpu_torch.chain import AliceChain, BobChain
    from qtpu_torch.channel import EntangledPairSource
    from qtpu_torch.framing import TIME_UNITS_PER_NS
    from qtpu_torch.link import make_direct_pair
    src = EntangledPairSource(**CHAIN_SOURCE)
    rng = np.random.default_rng(7)
    span = int(cfg.window_s * 1e9 * TIME_UNITS_PER_NS)
    streams, counts, true = [], [], None
    for w in range(windows):
        ev = src.generate(rng, start_epoch=w)
        true = ev.true_offset_units
        if w == 0:
            est = int(sift.pfind(
                torch.from_numpy(sift.rebase_times(ev.alice.times, 0)).to(dev),
                torch.from_numpy(sift.rebase_times(ev.bob.times, 0)).to(dev),
                span, num_bins=cfg.pfind_bins))
        base = np.int64(w) * span
        streams.append((
            (np.asarray(ev.alice.times[:ev.alice.count], np.int64) + base,
             ev.alice.detectors[:ev.alice.count]),
            (np.asarray(ev.bob.times[:ev.bob.count], np.int64) + base,
             ev.bob.detectors[:ev.bob.count])))
        counts.append(ev.alice.count + ev.bob.count)
    la, lb = make_direct_pair()
    alice = AliceChain(cfg, 0x5E55, la, device=dev)
    bob = BobChain(cfg, 0x5E55, lb, device=dev)

    def pump():
        for _ in range(100_000):
            p = bob.pump()
            p = alice.pump() or p
            if not p:
                return

    t = None
    for w, (sa, sb) in enumerate(streams):
        if w == warmup:
            torch.cuda.synchronize()
            t = time.perf_counter()
        alice.push_stream(*sa)
        bob.push_stream(*sb)
        pump()
    bob.flush_sift()
    pump()
    alice.ec.drain_final()
    bob.ec.drain_final()
    torch.cuda.synchronize()
    rate = sum(counts[warmup:]) / (time.perf_counter() - t)
    return alice, bob, true, est, rate


def run_session(cfg, alice_src, bob_src, device, windows, feed_chunk=None,
                mesh=None):
    """Both parties on ``device`` over a direct link (Bob on ``mesh`` when
    given); the stream is fed in chunks as the session consumes it.
    Returns (alice, bob, timed): timed is (elapsed s, windows Bob finalized
    in that time), from Bob's second settled window until his
    ``windows``-th; the rest is drained untimed."""
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import AliceSession, BobSession, pump_sessions
    la, lb = make_direct_pair()
    alice = AliceSession(cfg, 0x5E55, la, device=device)
    bob = BobSession(cfg, 0x5E55, lb, device=device, mesh=mesh)
    chunk = feed_chunk or len(alice_src)
    state = {"off": 0}

    def feed():
        lim = alice.max_need * (cfg.max_inflight_windows + 2)
        while state["off"] < len(alice_src) and alice.stream.remaining < lim:
            o = state["off"]
            alice.push_sifted(alice_src[o:o + chunk])
            bob.push_sifted(bob_src[o:o + chunk])
            state["off"] = o + chunk

    def pump_until(n):
        for _ in range(1_000_000):
            if bob.window_id >= n:
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

    feed()
    pump_until(2)
    t, done = time.perf_counter(), len(bob.metrics)
    pump_until(windows)
    timed = (time.perf_counter() - t, len(bob.metrics) - done)
    pump_sessions(alice, bob, la, lb)
    return alice, bob, timed


def stream_pa_phase(dev, P, l_max):
    """Phase 10: stream PA on the card against golden (small) and against
    the CPU's run of the same call (the production flush of a rung with P
    payload bits and l_max PA bits per block)."""
    import numpy as np
    import torch
    from qtpu_torch import pa, prng
    rng = np.random.default_rng(10)
    n_small, m, seg = 2048, 300, 512
    x = rng.integers(0, 2, n_small, dtype=np.uint8)
    t = rng.integers(0, 2, n_small + m - 1, dtype=np.uint8)
    want = pa.toeplitz_hash_golden(t, x, m)
    for precision in (torch.float32, torch.float64):
        got = pa.stream_toeplitz(torch.from_numpy(t).to(dev),
                                 torch.from_numpy(x).to(dev), m,
                                 segment=seg, precision=precision)
        assert np.array_equal(got.cpu().numpy(), want), \
            f"stream_toeplitz ({precision}) != golden on the card"
    # The production flush: 4 windows of 128 verified blocks of P bits,
    # padded to N = 2^25, m = the windows' PA output.
    size = 4 * 128 * P
    N = 1 << (size - 1).bit_length()
    m = 4 * 128 * l_max
    g = torch.Generator(device=dev).manual_seed(10)
    stream = torch.zeros(N, dtype=torch.uint8, device=dev)
    stream[:size] = torch.randint(0, 2, (size,), generator=g, device=dev,
                                  dtype=torch.uint8)
    t0 = time.perf_counter()
    seed = prng.random_bits(prng.derive(prng.root_key(1), "pa-stream", 0),
                            (m + N - 1,))
    seed_ms = 1e3 * (time.perf_counter() - t0)
    t_dev = torch.from_numpy(seed).to(dev)
    flush = dict(segment=N // 2, precision=torch.float64)   # the session's
    ref_shape = dict(segment=1 << 16, precision=torch.float32)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t1)

    fk, flush_ms = timed(lambda: pa.stream_toeplitz(t_dev, stream, m, **flush))
    t1 = time.perf_counter()
    cpu = pa.stream_toeplitz(t_dev.cpu(), stream.cpu(), m, **flush)
    cpu_ms = 1e3 * (time.perf_counter() - t1)
    assert torch.equal(fk.cpu(), cpu), "card flush != CPU flush"
    f32, f32_ms = timed(lambda: pa.stream_toeplitz(t_dev, stream, m,
                                                   **ref_shape))
    margin32 = pa.stream_margin(t_dev, stream, m, **ref_shape)
    margin64 = pa.stream_margin(t_dev, stream, m, **flush)
    assert margin64 < 0.25, f"float64 flush margin {margin64}"
    say(f"stream pa: card == golden at N={n_small} (4 segments); flush "
        f"P={P} N=2^{N.bit_length() - 1} m={m} ({m / N:.3f} N): card == cpu "
        f"(float64, 2 segments of 2^{N.bit_length() - 2}), margin "
        f"{margin64:.3g}, flush_ms={flush_ms:.2f} "
        f"(cpu {cpu_ms:.0f} ms), host seed bits {seed_ms:.0f} ms ; float32 "
        f"in 2^16-bit segments (the reference's): margin {margin32:.4f}, "
        f"{f32_ms:.2f} ms, equal to float64: {torch.equal(f32, fk)}")
    return margin32, margin64, flush_ms, f32_ms


def cli_json(argv) -> tuple[dict, float]:
    """``qtpu_torch.cli.main(argv)`` in this process; its JSON output and
    its wall time in seconds."""
    import contextlib
    import io
    from qtpu_torch import cli
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    dt = time.perf_counter() - t
    assert rc == 0, f"cli {argv[-1]} exited {rc}"
    return json.loads(buf.getvalue()), dt


def chain_sets(windows) -> list:
    """Phase 8's chain settings as CLI --set overrides."""
    sets = {"chain.pipeline.n": 4096, "chain.pipeline.family": '"mixed"',
            "chain.pipeline.alg": '"minsum"',
            "chain.pipeline.blocks_per_window": 64,
            "chain.pipeline.stream_capacity_bits": 1 << 25,
            "chain.window_s": CHAIN_SOURCE["window_s"],
            "chain.sift_batch_frames": 8, "num_windows": windows,
            **{f"source.{k}": v for k, v in CHAIN_SOURCE.items()}}
    return [a for k, v in sets.items() for a in ("--set", f"{k}={v}")]


def cli_tcp_phase(windows, timeout):
    """``python -m qtpu_torch.cli ... alice`` and ``... bob`` as two
    processes on this card over 127.0.0.1 with channel authentication;
    returns their JSON outputs and the wall time."""
    import os
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = [sys.executable, "-m", "qtpu_torch.cli", *chain_sets(windows)]
    auth = ["--auth-seed", "0xC0FFEE"]
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    procs = {}
    try:
        for party in ("alice", "bob"):
            procs[party] = subprocess.Popen(
                [*base, "--set", f'metrics_path="{out_dir}/{party}.jsonl"',
                 party, f"127.0.0.1:{port}", *auth],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        outs = {}
        for party, proc in procs.items():
            out, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, \
                f"cli {party} exited {proc.returncode}: {err[-2000:]}"
            outs[party] = json.loads(out)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs, time.perf_counter() - t


def sharded_decode_phase(label, code, llr, syn, max_iters, alg, reps):
    """Phase 13: the sharded decoder over MESH_SHARDS shards on the card
    against one unsharded launch and the golden model.  Returns (launches
    per sharded call, sharded ms, unsharded ms)."""
    import numpy as np
    import torch
    from qtpu_torch.ldpc import golden
    from qtpu_torch.ldpc.cuda_bp import KERNELS, launches, make_cuda_decoder
    from qtpu_torch.parallel import make_mesh, make_sharded_decoder
    dev = llr.device
    sharded = make_sharded_decoder(code, make_mesh(devices=[dev] * MESH_SHARDS),
                                   max_iters, alg)
    single = make_cuda_decoder(code, max_iters, alg=alg)
    name = KERNELS[alg]
    torch.cuda.synchronize()
    before = launches[name]
    got = sharded(llr, syn)
    torch.cuda.synchronize()
    per_call = launches[name] - before
    assert per_call == MESH_SHARDS, f"{label}: {per_call} launches per call"
    ref = single(llr, syn)
    for a, b, what in zip(got, ref, ("bits", "converged", "iterations")):
        assert torch.equal(a, b), f"{label}: sharded {what} != unsharded"
    B = llr.shape[0]
    llr_h, syn_h = llr.cpu().numpy(), syn.cpu().numpy()
    bits, conv, iters = (x.cpu().numpy() for x in got)
    for b in (*range(4), *range(B - 4, B)):
        g = golden.decode(code, llr_h[b], syn_h[b], max_iters=max_iters,
                          alg=alg)
        assert np.array_equal(g.bits.reshape(-1), bits[b]) and \
            (g.iterations, g.converged) == (iters[b], conv[b]), \
            f"{label}: block {b} differs from golden"
    ms = time_cuda(lambda: sharded(llr, syn), reps)
    ms1 = time_cuda(lambda: single(llr, syn), reps)
    bound_ms, bound_by = decode_bound(code, B, int(iters.sum()))
    say(f"sharded {label}: {MESH_SHARDS} shards of {B // MESH_SHARDS} on "
        f"{dev} == one launch of B={B} (bits, iterations, converged), "
        f"{per_call} {name} launches per call, 8 blocks == golden; "
        f"sharded_ms={ms:.3f} unsharded_ms={ms1:.3f} bound_ms="
        f"{bound_ms:.4f} ({bound_by}) share_of_bound {bound_ms / ms:.4f}")
    return per_call, ms, ms1


def check_gled(bob):
    """Every window's psum'd decode ledger equals its host metrics
    (__graft_entry__.dryrun_multichip's check)."""
    from qtpu_torch.accounting import LEDGER_FIELDS
    idx = {f: i for i, f in enumerate(LEDGER_FIELDS)}
    assert sorted(bob.gled_by_window) == sorted(m.window_id for m in bob.metrics)
    for met in bob.metrics:
        g = bob.gled_by_window[met.window_id]
        assert g[idx["syndrome_bits"]] == met.leaked_syndrome
        assert g[idx["verify_hash_bits"]] == met.leaked_hash
        assert g[idx["qber_test_bits"]] == met.leaked_qber
        assert g[idx["blocks_ok"]] + g[idx["blocks_failed"]] == met.blocks


def mesh_session_phase(dev, cfg, windows, seed):
    """Phase 14: Alice unsharded, Bob on a MESH_SHARDS mesh of ``dev``,
    against an unsharded pair on the same input.  Returns the mesh run's
    launches."""
    import numpy as np
    from qtpu_torch.parallel import make_mesh
    a_src, b_src = bsc_on_card(
        dev, (windows + 4) * cfg.n * cfg.blocks_per_window, seed)
    reset_launches()
    alice, bob, timed = run_session(
        cfg, a_src, b_src, dev, windows, feed_chunk=1 << 23,
        mesh=make_mesh(devices=[dev] * MESH_SHARDS))
    launches = read_launches()
    mets = check_session("mesh session", alice, bob, timed, launches,
                         "bp_layered")
    check_gled(bob)
    assert launches["bp_layered"] >= MESH_SHARDS * len(mets), launches
    alice1, bob1, timed1 = run_session(cfg, a_src, b_src, dev, windows,
                                       feed_chunk=1 << 23)
    key = bob.final_key_bits()
    assert np.array_equal(bob1.final_key_bits(), key), \
        "mesh session: keys differ from the unsharded run's"
    assert (bob.ledger.as_dict() == alice1.ledger.as_dict()
            == bob1.ledger.as_dict()), "mesh session: ledgers differ"
    assert [m.as_dict() for m in mets] == [m.as_dict() for m in bob1.metrics]
    say(f"mesh session: == the unsharded pair (keys, 4 ledgers, window "
        f"metrics) over {len(mets)} windows; gled == host metrics in every "
        f"window; unsharded window_ms="
        f"{1e3 * timed1[0] / timed1[1]:.2f}")
    return launches


def reference_sharded_margin(t_bits, stream, m, shards):
    """The reference's sharded float32 flush (qtpu/parallel.py:109-143):
    each shard's whole slice of L = N / shards bits in one float32
    convolution of the next power of two >= m + 2L - 2 points; the worst
    distance of a count from its integer over every shard."""
    import torch
    N = stream.shape[0]
    L = N // shards
    need = m + 2 * L - 2
    n_fft = 1 << (need - 1).bit_length()
    worst = 0.0
    for s in range(shards):
        start = N - (s + 1) * L
        tf = torch.fft.rfft(t_bits[start:start + m + L - 1].float(), n_fft)
        xf = torch.fft.rfft(stream[s * L:(s + 1) * L].float(), n_fft)
        c = torch.fft.irfft(tf * xf, n_fft)[L - 1:L - 1 + m]
        worst = max(worst, float((c - torch.round(c)).abs().max()))
        del tf, xf, c
    return worst


def sharded_flush_phase(dev, P, l_max):
    """Phase 15, first half: phase 10's production flush sharded over 4
    and 8 shards of the card (float64) against the unsharded flush, and the
    reference's float32 sharded margin.  Returns the margins by shard
    count."""
    import torch
    from qtpu_torch import pa, prng
    from qtpu_torch.parallel import make_mesh, make_stream_pa
    size = 4 * 128 * P
    N = 1 << (size - 1).bit_length()
    m = 4 * 128 * l_max
    g = torch.Generator(device=dev).manual_seed(10)
    stream = torch.zeros(N, dtype=torch.uint8, device=dev)
    stream[:size] = torch.randint(0, 2, (size,), generator=g, device=dev,
                                  dtype=torch.uint8)
    t_dev = torch.from_numpy(prng.random_bits(
        prng.derive(prng.root_key(1), "pa-stream", 0), (m + N - 1,))).to(dev)
    fk = pa.stream_toeplitz(t_dev, stream, m, segment=N // 2,
                            precision=torch.float64)
    margins, times = {}, {}
    for shards in (MESH_SHARDS, 2 * MESH_SHARDS):
        flush = make_stream_pa(make_mesh(devices=[dev] * shards), N, m)
        got = flush(t_dev, stream)
        assert torch.equal(got, fk), f"{shards}-shard flush != unsharded"
        times[shards] = time_cuda(lambda: flush(t_dev, stream), 1)
        margins[shards] = reference_sharded_margin(t_dev, stream, m, shards)
    one_ms = time_cuda(lambda: pa.stream_toeplitz(
        t_dev, stream, m, segment=N // 2, precision=torch.float64), 1)
    say(f"sharded stream pa: N=2^{N.bit_length() - 1} m={m} "
        f"({m / N:.3f} N): the {MESH_SHARDS}- and {2 * MESH_SHARDS}-shard "
        f"float64 flush == unsharded; flush_ms {MESH_SHARDS} shards "
        f"{times[MESH_SHARDS]:.2f}, {2 * MESH_SHARDS} shards "
        f"{times[2 * MESH_SHARDS]:.2f}, unsharded {one_ms:.2f}; the "
        f"reference's float32 sharded flush, margin (exact only < 0.25): "
        f"L=N/{MESH_SHARDS} {margins[MESH_SHARDS]:.4f}, "
        f"L=N/{2 * MESH_SHARDS} {margins[2 * MESH_SHARDS]:.4f}")
    return margins


def mesh_program_window(dev, mesh):
    """One window of Bob's program at phase 3's production rung (B = 128)
    on ``mesh``, inputs from a numpy seed (identical in every process):
    (psum'd ledger, this process's stats rows)."""
    import numpy as np
    import torch
    from qtpu_torch import prng
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import BobSession, production_config
    from qtpu_torch.window_programs import (choose_affine, make_header,
                                            make_window_programs)
    cfg = production_config()
    probe = BobSession(cfg, 0x5E55, make_direct_pair()[1], device=dev)
    r, _ = probe.ladder.select_fine(QBER, granularity=cfg.short_granularity)
    one = probe.programs(r)
    pos = probe._step_positions[r]
    progs = make_window_programs(
        probe.ladder.steps[r].code, pos["payload"], pos["punct"],
        pos["short"], cfg.max_iters, cfg.alg, cfg.verify_hash_bits,
        one.l_max, batch=cfg.blocks_per_window, k_pb=one.k_pb,
        s_max=one.s_max, retry_bits=one.retry_bits, device=dev, mesh=mesh)
    B, P = cfg.blocks_per_window, pos["payload"].size
    rng = np.random.default_rng(16)
    a_bits = rng.integers(0, 2, B * P, dtype=np.uint8)
    b_bits = a_bits ^ (rng.random(B * P) < QBER).astype(np.uint8)
    wkey = prng.key_data(prng.derive(prng.root_key(16), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(17), "punct", 0))
    a, ainv = choose_affine(rng.integers(2, P, size=64), P)
    s = one.s_max // 64 * 32
    hdr = dict(test_bits_pb=one.k_pb, affine=(a, ainv, 5))
    _, syn, hashes, test, short = one.alice(
        torch.from_numpy(a_bits).to(dev), make_header(0, s, wkey, pkey, **hdr))
    out = progs.bob(torch.from_numpy(b_bits).to(dev),
                    make_header(0, s, wkey, **hdr), test, short, syn, hashes,
                    np.float32(np.log((1 - QBER) / QBER)))
    return out[5].cpu().tolist(), out[4].cpu().tolist()


def mesh_worker(rank: int, port: int) -> int:
    """``chip_smoke.py --mesh-worker RANK PORT``: one of phase 16's two
    processes; prints its psum'd ledger, stats rows and launches as JSON."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qtpu_torch.parallel import init_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    backend = init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(devices=[dev] * (MESH_SHARDS // 2))
        reset_launches()
        gled, stats = mesh_program_window(dev, mesh)
        print(json.dumps({"rank": rank, "backend": backend,
                          "first": mesh.first, "size": mesh.size,
                          "gled": gled, "stats": stats,
                          "launches": read_launches()}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def two_process_phase(dev, timeout):
    """Phase 16: two ``--mesh-worker`` processes on this card against the
    one-process 4-shard program; returns the ranks' summed launches."""
    import os
    import socket
    from qtpu_torch.parallel import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
                 str(rank), str(port)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, \
                f"mesh worker {rank} exited {proc.returncode}: {err[-2000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t
    gled, stats = mesh_program_window(dev,
                                      make_mesh(devices=[dev] * MESH_SHARDS))
    bl = len(stats) // MESH_SHARDS
    for o in outs:
        assert (o["backend"], o["size"]) == ("gloo", MESH_SHARDS), o
        assert o["gled"] == gled, f"rank {o['rank']}: ledger != one process"
        assert o["stats"] == stats[o["first"] * bl:
                                   (o["first"] + MESH_SHARDS // 2) * bl]
        assert o["launches"]["bp_layered"] == MESH_SHARDS // 2, o["launches"]
    launches = sum(o["launches"]["bp_layered"] for o in outs)
    say(f"two processes (gloo over CUDA tensors): ranks 0 and 1 each own "
        f"{MESH_SHARDS // 2} of {MESH_SHARDS} shards on {dev}; psum'd "
        f"ledger {gled} on both == the one-process program's; stats rows "
        f"equal; {launches} bp_layered launches; {wall:.1f} s for both")
    return launches


def bench_phase(timeout, code, decode):
    """Phase 17: ``python -m qtpu_torch.cli bench`` as a user runs it, on
    this card; ``code`` and ``decode`` (a Timing) are phase 3's run of the
    layered kernel on the bench's decode-alone inputs.  Returns (its JSON
    line, its launches per measurement, its wall time in seconds, the
    decode-alone bound in ms)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "qtpu_torch.cli", "bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t
    assert proc.returncode == 0, \
        f"bench exited {proc.returncode}: {proc.stderr[-3000:]}"
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    launches = json.loads(lines[-2].split("bench launches: ", 1)[1])
    x = out["extra"]
    assert out["metric"] == \
        "full_chain_reconciled_bits_per_s_per_chip_qber3_median", out
    assert out["value"] > 0, out
    assert 3 - x["per_chip_traced_runs"] >= 2, x
    assert x["full_chain_fer"] <= 0.05, x
    assert x["decode_blocks_converged"] == x["decode_blocks"] == 1024, x
    assert x["hbm_copy_gbyte_s_measured"] < 1.05 * HBM_BYTES_PER_S / 1e9, x
    for name, counts in launches.items():
        assert counts["bp_layered"] > 0, f"bench {name}: no bp_layered"
    bound_ms, bound_by = decode_bound(code, x["decode_blocks"],
                                      x["decode_iterations_sum"])
    assert (bound_ms, bound_by) == (decode.bound_ms, decode.bound_by), \
        f"bench decode alone: bound {bound_ms} != phase 3's {decode.bound_ms}"
    say(f"bench decode alone: {x['decode_step_ms']} ms a call, "
        f"{x['decode_iterations_sum'] / x['decode_blocks']:.2f} iterations "
        f"a block, bound {bound_ms:.4f} ms ({bound_by}), share of bound "
        f"{bound_ms / x['decode_step_ms']:.4f}; host {x['host']}")
    return out, launches, wall, bound_ms


def module_json(module, argv, timeout) -> tuple[dict, float]:
    """``python -m module argv`` as a subprocess on this card, as a user
    runs it; (its last line as JSON, its wall time in seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t
    assert proc.returncode == 0, \
        f"{module} {' '.join(argv)} exited {proc.returncode}: " \
        f"{proc.stderr[-3000:]}"
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"{module} {' '.join(argv)} ({wall:.1f} s): {json.dumps(out)}")
    return out, wall


def baseline_phase(dev) -> dict:
    """Phase 18, first part: ``python -m qtpu_torch.baseline`` config1,
    config2, config3, config5 and efficiency on this card, held to the
    plain decoders, the CPU and a one-process program.  Returns each
    config's BP kernel launches."""
    import torch
    from qtpu_torch import baseline
    from qtpu_torch.ldpc.calibrate import fer_inputs, measure_fer
    from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
    from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
    from qtpu_torch.ldpc.decode import make_layered_decoder
    from qtpu_torch.parallel import make_mesh
    c1, _ = module_json("qtpu_torch.baseline", ["config1"], 120)
    assert c1["converged"] and c1["key_exact"], c1

    c2, _ = module_json("qtpu_torch.baseline", ["config2"], 300)
    rows = c2["sweep"]
    assert c2["batch"] == 1024, c2
    assert [r["qber"] for r in rows] == list(baseline.CONFIG2_QBERS), rows
    for r in rows:   # a warm call and 20 timed ones per QBER
        assert r["launches"] == {"bp_layered": 21, "bp_flooding": 0}, r
    code = make_regular_code(4096)
    q, llr, syn = baseline.config2_inputs(code, 1024, dev)[-1]
    got = make_cuda_decoder(code, baseline.CONFIG2_ITERS)(llr, syn)
    ref = make_layered_decoder(code, baseline.CONFIG2_ITERS)(llr, syn)
    assert torch_equal(got, ref), f"config2 QBER {q}: kernel != plain"
    iters = ref.iterations.cpu().numpy()
    assert rows[-1]["iters_sum"] == int(iters.sum()), rows[-1]
    assert rows[-1]["fer"] == 1.0 - float(ref.converged.cpu().numpy().mean())
    for r in rows:
        bound_ms, bound_by = decode_bound(code, c2["batch"], r["iters_sum"])
        say(f"config2 QBER {r['qber']}: {r['gbit_s']} Gbit/s, {r['ms']} ms a "
            f"call, iterations mean {r['iters_mean']} p99 {r['iters_p99']}, "
            f"FER {r['fer']}; bound {bound_ms:.4f} ms ({bound_by}), share "
            f"of bound {bound_ms / r['ms']:.4f}")
    say(f"config2 QBER {q}: the layered kernel's bits, iterations and "
        f"converged flags on config 2's own inputs == the plain decoder's")

    c3, _ = module_json("qtpu_torch.baseline", ["config3"], 300)
    ladder = make_rate_ladder(4096)
    assert [r["rung"] for r in c3["rungs"]] == [s.name for s in ladder.steps]
    for r in c3["rungs"]:
        assert r["launches"] == {"bp_layered": 0, "bp_flooding": 1}, r
    # The flooding kernel on config 3's own inputs, every rung (other
    # mother codes, punctured and shortened ones included).
    for idx, (step, r) in enumerate(zip(ladder.steps, c3["rungs"])):
        _, llr, syn, _ = fer_inputs(step, r["qber"], 256, seed=idx,
                                    device=dev)
        ref, _ = hold_to_plain(f"config3 rung {r['rung']}", step.code, llr,
                               syn, 60, alg="minsum")
        assert round(float(ref.iterations.double().mean()), 1) == \
            r["iters_mean"], (r, float(ref.iterations.double().mean()))
    say(f"config3: the flooding kernel's bits, iterations and converged "
        f"flags on every rung's own inputs (B = 256) == the plain "
        f"decoder's")
    # The CPU's plain decoder on the first rung, the punctured rung 1 and
    # the last rung (all five take ~40 s of the host).
    for idx in (0, 1, len(ladder.steps) - 1):
        r = c3["rungs"][idx]
        fer, it = measure_fer(ladder.steps[idx], r["qber"], blocks=256,
                              seed=idx, device="cpu")
        assert (r["fer"], r["iters_mean"]) == (round(fer, 4), round(it, 1)), \
            f"config3 rung {r['rung']}: card {r} != cpu {fer} {it}"
    say("config3: rungs 0, 1 (punctured) and "
        f"{len(ladder.steps) - 1}: card (fer, iters_mean) == the CPU's")

    c5, _ = module_json("qtpu_torch.baseline", ["config5"], 300)
    assert c5["ok"] and c5["ledgers_agree"], c5
    one = baseline.config5_window(dev, make_mesh(
        devices=[dev] * baseline.CONFIG5_SHARDS))
    assert json.loads(c5["global_ledger"]) == one, (c5, one)
    assert c5["launches"] == {"bp_layered": 0, "bp_flooding": 8}, c5
    cpu = torch.device("cpu")
    on_cpu = baseline.config5_window(cpu, make_mesh(
        devices=[cpu] * baseline.CONFIG5_SHARDS))
    assert on_cpu == one, (on_cpu, one)
    say(f"config5: both ranks' psum'd ledger == the one-process 8-shard "
        f"program's on the card == on the CPU (plain decoders) {one}")

    ef, _ = module_json("qtpu_torch.baseline", ["efficiency"], 400)
    assert [r["qber"] for r in ef["rows"]] == list(baseline.EFFICIENCY_QBERS)
    for r in ef["rows"]:
        assert r["final_bits"] == r["key_bits"], r
        assert r["qber"] > 0.05 or r["key_bits"] > 0, r
    assert ef["launches"]["bp_layered"] > 0, ef
    efficiency_ladder_holds(dev)
    return {name: out["launches"] for name, out in
            (("config2", c2), ("config3", c3), ("config5", c5),
             ("efficiency", ef))}


def efficiency_ladder_holds(dev) -> None:
    """Phase 18: the layered kernel on every rung of the ladder the
    efficiency sweep's sessions run (``PipelineConfig(n=4096,
    blocks_per_window=64)``: the mixed ladder of the sessions' code seed,
    its own mother codes and punctured rungs), at each rung's calibrated
    ceiling, held to the plain decoder at the window's B = 64 and at the
    retry's 8 rows with a tenth of n pinned at +-BIG, as the sessions pin
    disclosed and shortened bits."""
    from qtpu_torch.ldpc.calibrate import fer_inputs
    from qtpu_torch.ldpc.codes import make_rate_ladder
    from qtpu_torch.pipeline import PipelineConfig
    cfg = PipelineConfig(n=4096, blocks_per_window=64, qber_test_bits=8192)
    ladder = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                              seed=cfg.code_seed, alg=cfg.alg,
                              family=cfg.family)
    rows = []
    for idx, step in enumerate(ladder.steps):
        q = ladder.max_qber[idx] or 0.02
        for B, pinned in ((cfg.blocks_per_window, 0), (8, cfg.n // 10)):
            _, llr, syn, _ = fer_inputs(step, q, B, seed=180 + idx,
                                        extra_short_bits=pinned, device=dev)
            ref, _ = hold_to_plain(f"efficiency rung {step.name} B={B}",
                                   step.code, llr, syn, cfg.max_iters)
            rows.append(f"{step.name} B={B}: "
                        f"{int(ref.converged.sum())}/{B} converged, "
                        f"iterations mean "
                        f"{float(ref.iterations.double().mean()):.2f}")
    say(f"efficiency ladder (layered, QBER at each rung's ceiling): the "
        f"kernel == the plain decoder on every rung at B = 64 and at 8 rows "
        f"with n/10 pinned; " + "; ".join(rows))


def torch_equal(got, ref) -> bool:
    """Two BatchDecodeResults hold the same bits, iterations and flags."""
    import torch
    return (torch.equal(got.bits, ref.bits)
            and torch.equal(got.iterations, ref.iterations)
            and torch.equal(got.converged, ref.converged))


def profiling_phase() -> dict:
    """Phase 18, second part: ``python -m qtpu_torch.profiling programs
    10`` and ``chain 6`` on this card.  Returns their summed BP kernel
    launches."""
    from qtpu_torch.profiling import PROGRAMS
    pr, _ = module_json("qtpu_torch.profiling", ["programs", "10"], 300)
    for name in PROGRAMS:
        assert pr["launches"][name] > 0, (name, pr["launches"])
        assert pr["device_ms"][name] <= 1.05 * pr[name], \
            (name, pr["device_ms"][name], pr[name])
    assert pr["bp_launches"]["decode_only"] == {"bp_layered": 1.0,
                                                "bp_flooding": 0.0}, pr
    ch, _ = module_json("qtpu_torch.profiling", ["chain", "6"], 400)
    tr = ch["trace"]
    # The reference's loop stops once Bob has settled 6 windows; a flush
    # may settle two at once.
    assert ch["windows"] >= 6 and 0 < tr["busy_share"] <= 1, ch
    say(f"profiling chain: {ch['windows']} timed windows, "
        f"{ch['window_ms']} ms a window, busy share {tr['busy_share']} "
        f"({tr['busy_ms_per_window']} busy ms a window in {tr['windows']} "
        f"traced ones; {tr['busy_share_of']}; timed mix {ch['mix']}, traced "
        f"mix {tr['mix']}); {tr['launches_per_window']} kernel launches and "
        f"{tr['kernel_ms_per_window']} kernel ms a window")
    return {k: pr["bp_launches_total"][k] + ch["bp_launches_total"][k]
            for k in pr["bp_launches_total"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "qtpu_torch" / "csrc" / "bp_flooding.cu").exists():
        print("chip_smoke: run it from the repository (qtpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from qtpu_torch import _build
    from qtpu_torch.chain import ChainConfig
    from qtpu_torch.ldpc import cuda_bp
    from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
    from qtpu_torch.pipeline import PipelineConfig, production_config
    from qtpu_torch.pa import toeplitz_margin

    assert "jax" not in sys.modules
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    say(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc per source, in parallel
    t = time.perf_counter()
    _build.build(*cuda_bp.KERNELS.values())
    dt = time.perf_counter() - t
    for name in cuda_bp.KERNELS.values():
        _build.load(name)
        say(f"build: {name} (both in {dt:.1f} s) | "
            + " | ".join(ptxas_summary(_build.build_log(name))))

    # 3. layered kernel vs plain decoder
    cfg = production_config()
    ladder = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                              seed=cfg.code_seed, alg=cfg.alg,
                              family=cfg.family)
    rung, _ = ladder.select_fine(QBER, granularity=cfg.short_granularity)
    step = ladder.steps[rung]
    label = f"native3 rung {rung} ({step.name})"
    qb = np.linspace(0.02, 0.04, 128)
    llr, syn = decode_inputs(step.code, 128, qb, 1, dev, step.punct_cols)
    lay = kernel_vs_plain(
        label, step.code, llr, syn, cfg.max_iters, reps=5)
    plan = cuda_bp.layered_plan(step.code, dev, 128)
    added = decode_added(cuda_bp.make_cuda_decoder(step.code, cfg.max_iters),
                         llr, syn)
    assert added <= 17e6, f"one B=128 decode adds {added} bytes"
    say(f"layered plan {label} B=128: cluster C={plan.cluster}, "
        f"{plan.smem} bytes of dynamic shared memory and {plan.threads} "
        f"threads per CTA, cudaOccupancyMaxActiveClusters="
        f"{plan.max_clusters}; one decode adds {added / 1e6:.3f} MB "
        f"(max_memory_allocated); bound {lay.bound_ms:.4f} ms "
        f"({lay.bound_by}), share of bound {lay.bound_ms / lay.ms:.4f}")
    l8, s8 = llr[:8].contiguous(), syn[:8].contiguous()
    lay8 = kernel_vs_plain(label, step.code, l8, s8,
                                      cfg.max_iters, reps=5)
    slow8 = (llr[-8:].contiguous(), syn[-8:].contiguous())
    cluster_sweep(label, step.code, llr, syn, cfg.max_iters, reps=3)
    cluster_sweep(f"{label}, the batch's 8 slowest", step.code, *slow8,
                  cfg.max_iters, reps=5)
    # every rung at B = 8: the cluster size follows the rung's mb
    for r, st in enumerate(ladder.steps):
        lr, sr = decode_inputs(st.code, 8, np.linspace(0.02, 0.04, 8),
                               30 + r, dev, st.punct_cols)
        p = cuda_bp.layered_plan(st.code, dev, 8)
        kernel_vs_plain(f"native3 rung {r} ({st.name}, mb={st.code.mb}, "
                        f"C={p.cluster}, {p.smem} B/CTA)", st.code, lr, sr,
                        cfg.max_iters, reps=3)
    reg = make_regular_code(4096)
    llr4, syn4 = decode_inputs(reg, 256, np.linspace(0.005, 0.06, 256), 2,
                               dev)
    c_reg = cuda_bp.layered_plan(reg, dev, 256).cluster
    kernel_vs_plain(f"regular (3,6) C={c_reg}", reg, llr4, syn4,
                    cfg.max_iters, reps=5)
    cluster_sweep("regular (3,6)", reg, llr4, syn4, cfg.max_iters, reps=5)
    # the bench's shapes: its decode alone, and every rung at its events ->
    # key chain's B = 32
    from qtpu_torch import bench
    b_code, b_llr, b_syn = bench.decode_inputs(dev, 1024)
    b_dec = kernel_vs_plain(
        f"bench decode alone, regular (3,6) C="
        f"{cuda_bp.layered_plan(b_code, dev, 1024).cluster}", b_code, b_llr,
        b_syn, bench.DECODE_ITERS, reps=5)
    del b_llr, b_syn
    for r, st in enumerate(ladder.steps):
        lr, sr = decode_inputs(st.code, 32, np.linspace(0.02, 0.04, 32),
                               50 + r, dev, st.punct_cols)
        p = cuda_bp.layered_plan(st.code, dev, 32)
        kernel_vs_plain(f"native3 rung {r} ({st.name}, C={p.cluster})",
                        st.code, lr, sr, cfg.max_iters, reps=3)
    low = ladder.steps[-1]          # mb = 4: the smallest cluster that fits
    cluster_sweep(f"native3 rung {len(ladder.steps) - 1} ({low.name})",
                  low.code, *decode_inputs(low.code, 128, qb, 5, dev,
                                           low.punct_cols),
                  cfg.max_iters, reps=3)

    # 4. flooding kernel vs plain decoder
    llr_f, syn_f = decode_inputs(reg, 1024, np.linspace(0.01, 0.05, 1024), 3,
                                 dev)
    f_plan = cuda_bp.flooding_plan(reg, dev, 1024)
    flo = kernel_vs_plain(
        f"flooding regular (3,6) {plan_text(f_plan)}", reg, llr_f, syn_f, 60,
        reps=5, alg="minsum")
    f_added = decode_added(cuda_bp.make_cuda_decoder(reg, 60, alg="minsum"),
                           llr_f, syn_f)
    f_outputs = 1024 * (reg.n + 1 + 4)
    assert f_added <= f_outputs + (1 << 20), \
        f"one B=1024 flooding decode adds {f_added} bytes"
    say(f"flooding plan regular (3,6) B=1024: {plan_text(f_plan)}; one "
        f"decode adds {f_added / 1e6:.3f} MB (outputs {f_outputs / 1e6:.3f} "
        f"MB); bound {flo.bound_ms:.4f} ms ({flo.bound_by}), share of bound "
        f"{flo.bound_ms / flo.ms:.4f}")
    mixed = make_rate_ladder(4096, family="mixed", alg="minsum").steps[1]
    assert mixed.name == "r0.600" and mixed.punct_cols
    llr_m, syn_m = decode_inputs(mixed.code, 64, np.linspace(0.01, 0.05, 64),
                                 4, dev, mixed.punct_cols)
    f_rows = {}
    for b in (64, 8):
        p = cuda_bp.flooding_plan(mixed.code, dev, b)
        f_rows[f"mixed_b{b}"] = kernel_vs_plain(
            f"flooding mixed rung 1 ({mixed.name}, punct {mixed.punct_cols}) "
            f"{plan_text(p)}", mixed.code, llr_m[:b].contiguous(),
            syn_m[:b].contiguous(), 60, reps=5, alg="minsum")
    # phase 3's native3 rung: a block's state spans a cluster
    for b in (128, 8):
        p = cuda_bp.flooding_plan(step.code, dev, b)
        f_rows[f"native3_b{b}"] = kernel_vs_plain(
            f"flooding {label} {plan_text(p)}", step.code,
            llr[:b].contiguous(), syn[:b].contiguous(), cfg.max_iters,
            reps=3, alg="minsum")
    f_err = max([flo.err] + [r.err for r in f_rows.values()])
    widths = (256, 512, 1024)
    cluster_sweep("flooding regular (3,6)", reg, llr_f, syn_f, 60, reps=5,
                  alg="minsum", threads=widths)
    cluster_sweep(f"flooding mixed rung 1 ({mixed.name})", mixed.code,
                  llr_m, syn_m, 60, reps=5, alg="minsum", threads=widths)
    for b in (128, 8):
        cluster_sweep(f"flooding {label}", step.code, llr[:b].contiguous(),
                      syn[:b].contiguous(), cfg.max_iters, reps=3,
                      alg="minsum", threads=widths)
    # the cost of a round: one block alone, and a full card of them
    l12, s12 = decode_inputs(reg, 1024, np.full(1024, 0.12), 5, dev)
    for b in (1, 1024):
        round_cost("flooding regular (3,6) at QBER 12%", reg,
                   l12[:b].contiguous(), s12[:b].contiguous())
    l6, s6 = decode_inputs(step.code, 1, [0.06], 5, dev, step.punct_cols)
    round_cost(f"flooding {label} at QBER 6%", step.code, l6, s6)

    # 5. PA FFT integer margin at the production shape
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import BobSession
    probe = BobSession(cfg, 0x5E55, make_direct_pair()[1], device=dev)
    r_pa = next(i for i in range(len(ladder.steps))
                if probe.payload_per_block(i) == 61440)
    l_max = probe.programs(r_pa).l_max
    g = torch.Generator(device=dev).manual_seed(4)
    tb = torch.randint(0, 2, (128, 61440 + l_max - 1), generator=g,
                       device=dev, dtype=torch.uint8)
    xb = torch.randint(0, 2, (128, 61440), generator=g, device=dev,
                       dtype=torch.uint8)
    margin = toeplitz_margin(tb, xb, l_max)
    assert margin < 0.25, f"PA FFT integer margin {margin} >= 0.25"
    say(f"pa: B=128 P=61440 l_max={l_max} integer margin {margin:.4f} < 0.25")

    # 6. the production session on this card
    a_src, b_src = bsc_on_card(
        dev, (SESSION_WINDOWS + 4) * cfg.n * cfg.blocks_per_window, 7)
    reset_launches()
    alice, bob, timed = run_session(cfg, a_src, b_src, dev, SESSION_WINDOWS,
                                    feed_chunk=1 << 23)
    prod = read_launches()
    prod_batches = dict(cuda_bp.launch_batches["bp_layered"])
    mets = check_session("session", alice, bob, timed, prod, "bp_layered")
    assert len({m.rate_index for m in mets}) > 1, "no rung switch"
    assert sum(m.blocks_retried for m in mets) > 0, "no retry round"
    per_window = prod["bp_layered"] / len(mets)
    say(f"session layered launches: {prod['bp_layered']} over {len(mets)} "
        f"windows = {per_window:.3f} per window; launches by batch size "
        f"{dict(sorted(prod_batches.items()))}")
    del alice, bob, a_src, b_src

    # 7. the min-sum session (flooding decoder) on this card
    ms_cfg = PipelineConfig(n=4096, family="mixed", alg="minsum",
                            blocks_per_window=1024, qber_test_bits=8192,
                            stream_capacity_bits=1 << 25)
    a_src, b_src = bsc_on_card(
        dev, (MINSUM_WINDOWS + 4) * ms_cfg.n * ms_cfg.blocks_per_window, 8)
    reset_launches()
    alice, bob, timed = run_session(ms_cfg, a_src, b_src, dev,
                                    MINSUM_WINDOWS, feed_chunk=1 << 23)
    ms_launches = read_launches()
    ms_mets = check_session("minsum session", alice, bob, timed,
                            ms_launches, "bp_flooding")
    f_per_window = ms_launches["bp_flooding"] / len(ms_mets)
    assert ms_launches["bp_layered"] == 0, "min-sum session ran bp_layered"
    del alice, bob, a_src, b_src

    # 8. the events -> key chain on this card
    chain_cfg = ChainConfig(
        pipeline=PipelineConfig(n=4096, family="mixed", alg="minsum",
                                blocks_per_window=64,
                                stream_capacity_bits=1 << 25),
        window_s=CHAIN_SOURCE["window_s"], sift_batch_frames=8)
    reset_launches()
    alice, bob, true, est, rate = run_chain(chain_cfg, dev, CHAIN_WINDOWS,
                                            CHAIN_WARMUP)
    chain_launches = read_launches()
    assert abs(est - true) < 50, f"pfind {est} vs true offset {true}"
    assert abs(bob.offset - true) < 50, f"servo {bob.offset} vs {true}"
    ka, kb = alice.ec.final_key_bits(), bob.ec.final_key_bits()
    assert ka.size > 0 and np.array_equal(ka, kb), "chain keys differ/empty"
    assert alice.ec.ledger.as_dict() == bob.ec.ledger.as_dict(), \
        "chain ledgers differ"
    assert chain_launches["bp_flooding"] > 0, "chain never ran bp_flooding"
    assert chain_launches["bp_layered"] == 0, "chain ran bp_layered"
    led = bob.ec.ledger
    say(f"chain: {CHAIN_WINDOWS} simulation windows at "
        f"{CHAIN_SOURCE['pair_rate_hz']:.0e} pairs/s, pfind error "
        f"{est - true} units, final offset error {bob.offset - true}, "
        f"events_per_s={rate:.0f} (windows {CHAIN_WARMUP + 1}.."
        f"{CHAIN_WINDOWS}, incl. sift + EC drain), frames="
        f"{len(bob.sift_stats)} sifted_bits={led.sifted_bits} "
        f"ec_windows={len(bob.ec.metrics)} key_bits={ka.size} "
        f"launches={chain_launches}")
    del alice, bob

    # 9. cross-device parity (CPU vs card, identical input)
    rng = np.random.default_rng(11)
    nbits = 6 * 4096 * 16 + 20_000
    a_np = rng.integers(0, 2, nbits, dtype=np.uint8)
    b_np = a_np ^ (rng.random(nbits) < QBER).astype(np.uint8)
    for alg in ("layered", "minsum"):
        small = PipelineConfig(n=4096, blocks_per_window=16,
                               qber_test_bits=512, max_inflight_windows=1,
                               alg=alg)
        runs = {}
        for d in ("cpu", dev):
            a, b, _ = run_session(small, a_np, b_np, d, 6)
            runs[str(d)] = (a.final_key_bits(), b.final_key_bits(),
                            a.ledger.as_dict(), b.ledger.as_dict(),
                            [m.as_dict() for m in b.metrics])
        c, g_ = runs["cpu"], runs[str(dev)]
        assert c[0].size > 0
        for x, y in ((c[0], g_[0]), (c[1], g_[1]), (c[0], c[1])):
            assert np.array_equal(x, y), f"{alg}: keys differ across devices"
        assert c[2] == g_[2] == c[3] == g_[3], \
            f"{alg}: ledgers differ across devices"
        assert c[4] == g_[4], f"{alg}: window metrics differ across devices"
        say(f"parity {alg}: cpu == cuda over {len(c[4])} windows, "
            f"{c[0].size} key bits, ledgers and metrics equal")

    # 10. stream PA at the production flush shape
    # (the rung whose flush hashes the most bits: the largest m at N = 2^25)
    r_st = max(range(len(ladder.steps)), key=lambda i: probe.programs(i).l_max)
    stream_pa_phase(dev, probe.payload_per_block(r_st),
                    probe.programs(r_st).l_max)

    # 11. the stream-PA production session
    st_cfg = production_config(pa_mode="stream")
    a_src, b_src = bsc_on_card(
        dev, (STREAM_WINDOWS + 4) * st_cfg.n * st_cfg.blocks_per_window, 12)
    reset_launches()
    alice, bob, timed = run_session(st_cfg, a_src, b_src, dev,
                                    STREAM_WINDOWS, feed_chunk=1 << 23)
    st_launches = read_launches()
    check_session("stream-pa session", alice, bob, timed, st_launches,
                  "bp_layered")
    key = bob.final_key_bits()
    assert bob._stream_flushes >= 2, f"{bob._stream_flushes} stream flushes"
    for party in (alice, bob):
        assert party.ledger.final_bits == key.size, \
            "stream-pa: ledger final_bits != emitted key bits"
    assert all(b < 0 for _, b in bob.final_key_index)
    say(f"stream-pa session: {bob._stream_flushes} flushes of "
        f"{st_cfg.pa_stream_windows} windows, ledger final_bits == key bits "
        f"== {key.size}")
    del alice, bob, a_src, b_src

    # 12. the CLI on the card
    reset_launches()
    log_dir = ROOT / "build" / "chip_smoke"
    log_dir.mkdir(parents=True, exist_ok=True)
    demo, demo_s = cli_json([*chain_sets(DEMO_WINDOWS), "--set",
                             f'metrics_path="{log_dir}/demo.jsonl"', "demo"])
    demo_launches = read_launches()
    assert demo["keys_identical"] and demo["final_key_bits"] > 0, demo
    assert demo["device"].startswith("cuda"), demo["device"]
    assert demo_launches["bp_flooding"] > 0, "cli demo never ran bp_flooding"
    say(f"cli demo: {DEMO_WINDOWS} windows in {demo_s:.1f} s, "
        f"{demo['final_key_bits']} identical key bits, "
        f"{demo['final_bits_per_s_wallclock']} final bits/s wall clock, "
        f"ledger {demo['ledger']}, launches={demo_launches}")
    reset_launches()
    fer, fer_s = cli_json(["--set", "chain.pipeline.n=4096", "fer", "--rung",
                           "1", "--qber", "0.03", "--blocks", "1024"])
    fer_launches = read_launches()
    assert fer_launches["bp_flooding"] > 0, "cli fer never ran bp_flooding"
    assert 0.0 <= fer["fer"] <= 0.05, fer
    say(f"cli fer: {fer} in {fer_s:.2f} s, launches={fer_launches}")
    outs, tcp_s = cli_tcp_phase(TCP_WINDOWS, timeout=400)
    a, b = outs["alice"], outs["bob"]
    assert a["key_digest"] == b["key_digest"] != "empty", (a, b)
    assert a["ledger"] == b["ledger"] and a["windows"] == b["windows"]
    assert b["ledger"]["auth_bits"] > 0
    assert b["ledger"]["final_bits"] == b["final_key_bits"] > 0
    say(f"cli alice/bob over tcp: {TCP_WINDOWS} simulation windows, "
        f"{b['windows']} EC windows, digest {b['key_digest']} on both, "
        f"{b['final_key_bits']} key bits, auth_bits "
        f"{b['ledger']['auth_bits']}, {tcp_s:.1f} s for both processes")

    # 13. sharded decode over a 4-shard mesh of this card
    sh_l, sh_ms, sh_ms1 = sharded_decode_phase(
        f"layered native3 rung {rung}", step.code, llr, syn, cfg.max_iters,
        "layered", reps=5)
    sh_f, shf_ms, shf_ms1 = sharded_decode_phase(
        "flooding regular (3,6)", reg, llr_f, syn_f, 60, "minsum", reps=5)

    # 14. the production session with Bob on the mesh
    mesh_launches = mesh_session_phase(
        dev, production_config(max_inflight_windows=1), MESH_WINDOWS, 14)

    # 15. stream PA on the mesh: the production flush, then a session
    from qtpu_torch.parallel import make_mesh
    sharded_flush_phase(dev, probe.payload_per_block(r_st),
                        probe.programs(r_st).l_max)
    a_src, b_src = bsc_on_card(
        dev, (STREAM_WINDOWS + 4) * st_cfg.n * st_cfg.blocks_per_window, 15)
    reset_launches()
    alice, bob, timed = run_session(
        st_cfg, a_src, b_src, dev, STREAM_WINDOWS, feed_chunk=1 << 23,
        mesh=make_mesh(devices=[dev] * MESH_SHARDS))
    mst_launches = read_launches()
    check_session("mesh stream-pa session", alice, bob, timed, mst_launches,
                  "bp_layered")
    check_gled(bob)
    key = bob.final_key_bits()
    assert bob._stream_flushes >= 2, f"{bob._stream_flushes} stream flushes"
    for party in (alice, bob):
        assert party.ledger.final_bits == key.size, \
            "mesh stream-pa: ledger final_bits != emitted key bits"
    say(f"mesh stream-pa session: {bob._stream_flushes} sharded flushes == "
        f"Alice's unsharded ones, ledger final_bits == key bits == "
        f"{key.size}")
    del alice, bob, a_src, b_src

    # 16. two processes, each owning half of the mesh
    two_launches = two_process_phase(dev, timeout=300)

    # 17. the bench, through the CLI
    bench_out, bench_launches, bench_s, b_bound = bench_phase(
        700, b_code, b_dec)
    say(f"bench ({bench_s:.1f} s; launches {bench_launches}): "
        f"{json.dumps(bench_out)}")

    # 18. the measuring scripts, as subprocesses
    t = time.perf_counter()
    measured = baseline_phase(dev)
    measured["profiling"] = profiling_phase()
    say(f"measuring scripts: {time.perf_counter() - t:.1f} s; BP launches "
        f"{measured}")

    def path_launches(kernel):
        return {f"launches_{name}": counts[kernel]
                for name, counts in measured.items()}

    say(json.dumps({"kernels": [{
        "name": "bp_layered", "route": "cuda",
        "source": "qtpu_torch/csrc/bp_layered.cu",
        "replaces": "qtpu/ldpc/pallas_bp.py:168",
        "launches": prod["bp_layered"],
        "launches_stream_pa_session": st_launches["bp_layered"],
        "launches_sharded_decode_call": sh_l,
        "launches_mesh_session": mesh_launches["bp_layered"],
        "launches_mesh_stream_pa_session": mst_launches["bp_layered"],
        "launches_two_processes": two_launches,
        "launches_bench": {k: v["bp_layered"]
                           for k, v in bench_launches.items()},
        **path_launches("bp_layered"),
        "launches_per_window": round(per_window, 4),
        "launch_batches": {str(b): c for b, c in sorted(prod_batches.items())},
        "sharded_ms": round(sh_ms, 4), "unsharded_ms": round(sh_ms1, 4),
        "max_abs_err": float(lay.err), "ms": round(lay.ms, 4),
        "device_ms": round(lay.device_ms, 4), "ms_b8": round(lay8.ms, 4),
        "device_ms_b8": round(lay8.device_ms, 4),
        "plain_ms": round(lay.plain_ms, 2), "bound_ms": round(lay.bound_ms, 4),
        "bound_by": lay.bound_by, "library_ms": None, "cluster": plan.cluster,
        "smem_per_cta": plan.smem, "max_active_clusters": plan.max_clusters,
        "decode_added_mb": round(added / 1e6, 3),
        "bench_decode_ms": bench_out["extra"]["decode_step_ms"],
        "bench_decode_device_ms": round(b_dec.device_ms, 4),
        "bench_decode_plain_ms": round(b_dec.plain_ms, 2),
        "bench_decode_bound_ms": round(b_bound, 4)}, {
        "name": "bp_flooding", "route": "cuda",
        "source": "qtpu_torch/csrc/bp_flooding.cu",
        "replaces": "qtpu/ldpc/pallas_bp.py:262",
        "launches": chain_launches["bp_flooding"],
        "launches_minsum_session": ms_launches["bp_flooding"],
        "launches_cli_demo": demo_launches["bp_flooding"],
        "launches_cli_fer": fer_launches["bp_flooding"],
        "launches_sharded_decode_call": sh_f,
        **path_launches("bp_flooding"),
        "launches_per_window": round(f_per_window, 4),
        "sharded_ms": round(shf_ms, 4), "unsharded_ms": round(shf_ms1, 4),
        "max_abs_err": float(f_err),
        "ms": round(flo.ms, 4), "device_ms": round(flo.device_ms, 4),
        "plain_ms": round(flo.plain_ms, 2),
        "bound_ms": round(flo.bound_ms, 4), "bound_by": flo.bound_by,
        "library_ms": None, "cluster": f_plan.cluster,
        "smem_per_cta": f_plan.smem, "threads": f_plan.threads,
        "max_active_clusters": f_plan.max_clusters,
        "decode_added_mb": round(f_added / 1e6, 3),
        **{f"{f}_{k}": round(getattr(r, f), 4) for k, r in f_rows.items()
           for f in ("ms", "device_ms", "bound_ms")}}]}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
