#!/usr/bin/env python3
"""Drive qtpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root; needs a card

Phases (each prints one flushed line; any failure ends the run non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: both BP kernels, the threefry kernel, the syndrome encoder, the
   pin/LLR kernel and the verify kernel from qtpu_torch/csrc/, one nvcc
   each, in parallel, with each kernel entry's registers and spills
   (-Xptxas -v);
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
5. the PA FFT's integer margin at the production shape (< 0.25), and
   the hash's call and device time there beside its bound (bytes at 3.35
   TB/s, or the FFTs' operations at 67 TFLOP/s of float32);
5b. threefry: both entry points of ``qtpu_torch/csrc/threefry.cu`` == their
   plain PyTorch versions (``qtpu_torch.random``'s ``*_plain``) bit for
   bit on the card: the draw table, one launch a table, with each draw
   alone at every rung of the production ladder (the PA seed, B = 128
   rows of P + l_max - 1 bits; the verify seed, P + 63 bits; the puncture
   pad; the 128 test offsets in [0, P)) and the tables Alice's and Bob's
   programs make there (and Alice's and the retry's with a shortening
   fill), at the retry's 8 index rows, at 4 shards' row0 offsets (their
   rows == the unsharded draw's), at the shortening fill's draw (B = 128,
   one z = 2,048 column); the hash on one 2^23-bit chunk of the bench's
   BSC stream (fold_in, split, bits, uniform); at the production rung each
   draw's and table's call time, the device time of a CUDA-graph replay,
   the plain version's time and the bound (bytes at 3.35 TB/s, or the
   cipher's shifts and xors on the 64-lane INT32 pipe with its adds free
   to issue on the FMA pipe), and no library call (no PyTorch call
   computes threefry2x32);
5c. window kernels: ``qtpu_torch/csrc/qc_encode.cu`` (the syndrome
   encoder reading the codeword's payload, fill and pad parts) and both
   entry points of ``qtpu_torch/csrc/pin_llr.cu`` (Bob's pins, mismatch
   count and LLR; the retries' LLR) == their plain PyTorch versions bit
   for bit (LLRs by their float32 bit patterns) at every production rung
   (B = 128, a retry of all B rows), at 4 shards' rows (b = 32, == the
   unsharded call's rows), at the retry's 1 and 8 rows, at every rung
   of the n = 4096 mixed ladder (B = 1024) and with every input one byte
   off alignment (pin_llr at B = 128, llr at 8 rows: two aligned loads a
   run), and at z = 24 and 10 (no ladder's: the byte bodies; the encoder
   on codes with parallel edges), aligned and one byte off; the encoder
   also at 300 blocks (a CTA walks 2-3 through two stages), with the pad
   or every part one byte off (its threads' bodies), at z = 8,192 (column
   groups) and on the regular n = 4096 code at B = 1024, and the parts
   ``alice_program`` hands it are 16-byte aligned;
   at the rung a 3% prior selects each one's call time, the device time
   of a CUDA-graph replay, the plain version's time and the bound (bytes
   at 3.35 TB/s, or its 32-bit operations at the SM's issue rate), and no
   library call; the encoder's also at the first and last rung, a shard's
   rows, every timed shape above and every n = 4096 rung, each with the
   launch it makes (body, grid, threads, shared memory a CTA, stages,
   column groups);
5d. verify: both entry points of ``qtpu_torch/csrc/verify.cu`` (the verify
   hash; Bob's decode tail: payload extract, pin merge, hash check, error
   count and each retry's merge) == their plain PyTorch versions bit for
   bit: hash and the first decode's tail at every production rung (B =
   128), timed at the first, the 3%-prior and the last rung; a shard's
   32 rows (== the unsharded call's rows, timed); the retry's rows merge
   at B = 128 of 11 rows and of all 128 rows (timed) and of 1 row; the
   hash and the first decode's tail at 1 and 8 rows
   (timed); every input one byte off alignment (hash, tail at B = 128
   and the rows merge of 11 and of all B rows); z = 24 and 10 in each
   mode (the rows merge of 11 and of all B rows), aligned and one byte
   off;
   every rung of the n = 4096 mixed ladder at B = 1024 (z = 16); Vh = 1,
   31 and 33; each timed shape's launch plan (``window_verify.plan``:
   cluster size, CTAs a row, a CTA's groups of 16 words, threads, shared
   memory, the kept rows' CTAs), call time, device time (a CUDA-graph
   replay; a profiler trace for the retries, whose row order is uploaded
   a call), plain time and bound (bytes at 3.35 TB/s, or half a funnel
   shift and a three-input AND-XOR a row word and hash bit on the INT32
   pipe); the hash's library call is the float32 cuBLAS chain it replaces,
   timed on the same inputs.  A profiler trace of alice, bob and the
   retry (11 rows) at the 3%-prior rung shows each launching the verify
   kernel and no GEMM.  The traces run after phase
   19: a torch.profiler session before phase 13's one-call trace left
   that trace without its kernels;
6. session: production_config(), Alice and Bob on this card over a direct
   link, fed a BSC(3%) stream generated on the card, for 20 windows —
   identical non-empty keys, equal ledgers, FER <= 0.05, a rung switch, a
   retry round, and the layered kernel launched by the session (its
   launches per window and their batch sizes printed); the threefry
   kernel launched once a draw table, at most 4 tables a window (Alice's,
   Bob's, each party's PA) and one a retry round (per window printed),
   and no plain int64 threefry op and no key fill run; the
   encoder, pin_llr and the retries' llr launched (per window printed),
   and no plain encoder or pin/LLR assembly run, every encoder launch
   with 16-byte aligned parts (the bulk body); the verify hash and tail
   launched (per window printed), the tail in a retry mode in a retried
   window, and no plain hash or tail run;
7. min-sum session: n = 4096 mixed ladder, flooding decoder, B = 1024, the
   same checks, only the flooding kernel launched, and the encoder and
   pin_llr launched (per window printed);
8. chain: the events -> key entry point (simulated detector events at 10^7
   pairs/s, pfind, batched sifting, splice, min-sum EC) on this card —
   pfind within 50 units of the true offset, identical non-empty keys,
   equal ledgers, the flooding kernel, the encoder and pin_llr launched;
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
    model (``qtpu_torch.ldpc.golden``); a torch.profiler trace of one
    sharded call puts its 4 launches on 4 distinct CUDA streams (each
    shard's own, ``Mesh.run_shards``; the span from the first start to the
    last end printed beside the kernels' summed time); the sharded and the
    unsharded call's times side by side;
14. mesh session: production_config(max_inflight_windows=1), Alice
    unsharded and Bob on a 4-shard mesh on this card, over BSC(3%) for 12
    windows, against an unsharded pair on the same input — identical
    non-empty keys, all four ledgers equal, every window's psum'd ledger
    equal to its host metrics, >= 4 layered launches per window; the mesh
    run's window ms beside the unsharded pair's;
15. mesh stream PA: at the production flush shape the 4- and 8-shard
    float64 flush equals the unsharded one (with the device memory each
    adds at its peak: its shards' FFTs overlap on their streams), and the
    reference's float32 sharded flush (each shard's L = N/4 or N/8 bits unsegmented) prints its
    margin; then production_config(pa_mode="stream") with the mesh Bob for
    8 windows (>= 2 flushes): identical keys, ledger.final_bits == the
    emitted key bits;
16. two processes: ``chip_smoke.py --mesh-worker RANK PORT`` twice on this
    card, joined by ``init_distributed(backend="gloo")``, each owning 2 of
    4 shards of Bob's program at phase 3's rung (B = 128): both psum'd
    ledgers equal each other and the one-process 4-shard program's on the
    same window, and each rank launched pin_llr and the verify tail once
    a shard; in the one-process window each of the 4 shards' tails, on 4
    streams, == the plain tail on its inputs;
17. the bench: ``python -m qtpu_torch.cli bench`` as a subprocess on this
    card (the decoder alone, the copy bandwidth, both parties on the card,
    Bob's replayed session three times each, the events -> key chain, the
    sift matcher; the reference's threefry BSC stream): its last line names
    the per-chip median metric with a value > 0, >= 2 of the per-chip runs
    are clean, the two-party FER <= 0.05, every decode-alone block
    converged, the measured copy bandwidth is below 1.05 x 3,350 GB/s, and
    its ``bench launches`` line shows the layered kernel launched by every
    measurement, the threefry kernel's two entry points, pin_llr and the
    verify tail by both parties' and Bob's sessions (the BSC stream, the
    window programs), the encoder and the verify hash by both parties';
    the bound of its decode-alone call, from the iterations
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
    the layered kernel once a call, pa_seed_gen one threefry kernel a call,
    alice, bob and retry <= 40 launches a call) and ``chain 6``
    (>= 6 timed windows, a busy share in (0, 1], fewer launches a window
    than PR 9's tree's 648.3, printed beside it, no int64 elementwise
    kernel and no ``roll`` launched once a window or more among the top
    kernels, which are printed).  The kernels line gains each kernel's
    launches on these paths;
19. the scaling curve: ``python -m qtpu_torch.scaling 8`` as a subprocess
    on this card (the reference curve's workload, Bob's program on 1, 2, 4
    and 8 shards of the card, then the isolated psum and sharded-decode
    probes at each): exit 0, every point printed with equal keys and >= D
    layered launches a timed window at D shards, the probes printed.  The
    kernels line gains the layered launches a window at each D.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.

    python3 chip_smoke.py --verify-against DIR

runs phase 5d alone (the verify library's build, then both parts) on the
tree at DIR (a ``git archive`` of another commit, its own build) and on this
one, in turns (DIR, this, this, DIR), each in a process of its own on one
card; it prints each timed shape's device time and share of bound, and
writes the runs' whole output to ``build/chip_smoke/verify_against.log``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple
from unittest import mock

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
    also by its thread family), a plain kernel by its name."""
    import re
    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)ELb([01])E(?:Li(\d+)ELi(\d+)E)?",
                          m.group(1))
            plain = re.search(r"\d([a-z][a-z_]*_kernel)(I(?:L[bi]\d+E)+E)?E",
                              m.group(1))
            layout = "cluster" if t and t.group(2) == "1" else "one CTA"
            if plain:
                args = re.findall(r"L([bi])(\d+)E", plain.group(2) or "")
                plain = plain.group(1) + ("<" + ", ".join(
                    ("false", "true")[int(v)] if k == "b" else v
                    for k, v in args) + ">" if args else "")
            name = ((plain or m.group(1)) if not t else
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
                return cuda_bp._run(name, code.n, tab.data_ptr(),
                                    cuda_bp._launch_args(code, B, max_iters,
                                                         0.8125, p),
                                    llr, syn)
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


# The card's int32 issue outside the tensor cores, from the Hopper
# architecture white paper's SM (the data sheet gives no int32 rate): shifts
# and logic ops run on the INT32 pipe, 64 lanes an SM; integer adds may also
# issue as IMAD on the FMA pipe; an SM issues at most 128 lane operations a
# clock.  132 SMs at 1.98 GHz.
ALU_OPS_PER_S = 64 * 132 * 1.98e9
ISSUE_OPS_PER_S = 128 * 132 * 1.98e9


def cipher_ops(ciphers, keys, words):
    """(shift and logic ops, adds) of ``ciphers`` threefry2x32 calls whose
    counter's high word is 0, on ``keys`` distinct keys, ``words`` of them
    taken as x0 ^ x1.  A call: one add for x1's first key word (x0's is a
    move), 20 rounds of an add, a rotate (one funnel shift) and an xor, and
    5 injections of two adds.  A key: its third word (one three-input xor)
    and the injection constants folded into its schedule (5 adds).  A word:
    its xor."""
    return 40 * ciphers + keys + words, 31 * ciphers + 5 * keys


def threefry_bound(nbytes, ops):
    """The least time the card could take for one threefry draw: (ms,
    "bytes" or "operations").  Bytes: the draw's inputs read once and its
    output written once; operations: ``ops`` = (shift and logic ops, adds)
    of the cipher calls it needs, the former on the INT32 pipe alone, all
    of them within the SM's issue rate."""
    alu, adds = ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(alu / ALU_OPS_PER_S, (alu + adds) / ISSUE_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Draw(NamedTuple):
    err: int            # max |kernel - plain| over the draw's values
    ms: float           # one call, CUDA events over back-to-back calls
    device_ms: float    # one launch replayed from a CUDA graph
    plain_ms: float     # the plain version on the card, host clock
    bound_ms: float
    bound_by: str


def hold_kernel(kind, label, fn, plain, bound=(0.0, "bytes"), reps=0):
    """The kernel's outputs ``fn()`` (a tensor or a tuple of them) ==
    its plain version's ``plain()`` on the card, bit for bit (float32 by
    bit pattern); with ``reps``, also its times beside ``bound`` = (ms,
    "bytes" or "operations") (a Draw, printed), else None."""
    import torch
    got = fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)

    def ints(t):   # float32 outputs compare as their bit patterns
        return (t.view(torch.int32) if t.is_floating_point()
                else t).to(torch.int64)
    err = 0
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            f"{kind} {label}: {g.dtype} {tuple(g.shape)} != plain " \
            f"{w.dtype} {tuple(w.shape)}"
        if g.numel():
            err = max(err, int((ints(g) - ints(w)).abs().max()))
    assert err == 0, f"{kind} {label}: kernel != plain (max err {err})"
    if not reps:
        return None
    ms = time_cuda(fn, reps)
    dev_ms = graph_ms(fn, reps)
    bound_ms, bound_by = bound
    shapes = ", ".join(f"{tuple(g.shape)} {g.dtype}" for g in got)
    say(f"{kind} {label}: {shapes} == plain; "
        f"kernel_ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.2f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) share_of_bound "
        f"{bound_ms / dev_ms:.4f} (device) library_ms=null")
    return Draw(err, ms, dev_ms, plain_ms, bound_ms, bound_by)


def hold_draw(label, fn, plain, nbytes=0, ops=(0, 0), reps=0):
    """``hold_kernel`` of a threefry draw, bound by ``threefry_bound``."""
    return hold_kernel("threefry", label, fn, plain,
                       threefry_bound(nbytes, ops), reps)


def prior_rung(cfg, dev) -> int:
    """The rung Bob's 3% prior selects (as ``qtpu_torch.profiling
    programs``)."""
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import BobSession
    prior = BobSession(cfg, 0x5E55, make_direct_pair()[1], device=dev)
    prior.qest.update_prior(QBER * 1e6, 1e6)
    return prior._choose()[1]


# The card's float32 rate outside the tensor cores (NVIDIA's data sheet).
FP32_FLOPS = 67e12


def toeplitz_bound(B, n, m):
    """The least time the card could take for the per-block PA hash of B
    blocks, (B, n) x (B, m + n - 1) -> (B, m) bits, as pa.py computes it
    (a real FFT of length L of both, their product, an inverse real FFT):
    (ms, "bytes" or "operations", L, operations).  Bytes: the two inputs
    read and the output written once, a byte a bit.  Operations: 2.5 L
    log2 L a real FFT of length L (half a complex one's 5 L log2 L), three
    of them, and 6 a product of the L / 2 + 1 complex bins, at the float32
    rate."""
    L = 1 << (m + n - 2).bit_length()
    flops = B * (3 * 2.5 * L * (L.bit_length() - 1) + 6 * (L // 2 + 1))
    t_bytes = B * ((m + n - 1) + n + m) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), L, flops


def draw_cost(d):
    """(bytes, (shift and logic ops, adds)) of one draw of a table: the
    least cipher work is the tag chain once (each tag one call on a new
    key), each row's fold once on the tagged key, then each word (seed
    rows: W a row on the row's key) or each row's randint (split into two
    keys, one word from each; its remainder's few multiply-adds are not
    counted); an index of rows is read once."""
    from qtpu_torch import random as tr
    b, nt = len(d.rows), len(d.tags)
    index = 0 if isinstance(d.rows, range) else 8 * b
    if isinstance(d, tr.SeedRows):
        W = -(-d.length // 32)
        return (b * d.length + index,
                cipher_ops(nt + b + b * W, nt + 1 + b, b * W))
    return 8 * b + index, cipher_ops(nt + 5 * b, nt + 1 + 3 * b, 2 * b)


def threefry_phase(dev, cfg, ladder, probe) -> dict:
    """Phase 5b: the threefry kernel's two entry points == their plain
    versions on the card at the main path's shapes (``probe``: a
    BobSession of ``cfg`` on ``ladder``): each draw alone (a one-draw
    table) and every table a window program makes, one launch a table;
    timed at the rung Bob's 3% prior selects (as ``qtpu_torch.profiling
    programs``) and on the bench's chunk.  Returns {name: Draw} of the
    timed draws that represent each use (the PA seed, the test offsets,
    Alice's and Bob's tables, the bench chunk's bits)."""
    import numpy as np
    import torch
    from qtpu_torch import random as tr
    from qtpu_torch.window_programs import (TAG_SHORTFILL, TAG_TOFF,
                                            TAG_VERIFY)
    rung = prior_rung(cfg, dev)
    rng = np.random.default_rng(55)
    wkey, pkey, pakey = (rng.integers(0, 2**32, 2, dtype=np.uint64)
                         .astype(np.uint32) for _ in range(3))
    B, Vh = cfg.blocks_per_window, cfg.verify_hash_bits

    def table_draw(label, table, reps=0):
        """The table in one launch (launches + 1) == its plain draws."""
        costs = [draw_cost(d) for d in table]
        before = tr.launches["threefry_draws"]
        tr.draws(table, dev)
        assert tr.launches["threefry_draws"] == before + 1, label
        return hold_draw(
            label, lambda: tr.draws(table, dev),
            lambda: tr.draws_plain(table, dev), sum(c[0] for c in costs),
            tuple(sum(c[1][i] for c in costs) for i in (0, 1)), reps)

    def rows_draw(label, words, tags, rows, length, reps=0):
        return table_draw(label, [tr.SeedRows(words, tags, rows, length)],
                          reps)

    def offsets_draw(label, rows, span, reps=0):
        return table_draw(label, [tr.Randint(wkey, (TAG_TOFF,), rows, span)],
                          reps)

    out, shapes = {}, []
    idx = torch.from_numpy(np.sort(rng.choice(B, 8, replace=False))).to(dev)
    for r, st in enumerate(ladder.steps):
        P, l_max = probe.payload_per_block(r), probe.programs(r).l_max
        z = st.code.z
        pad = len(np.unique(probe._step_positions[r]["punct"] // z)) * z
        reps = 20 if r == rung else 0
        name = f"rung {r} ({st.name}, P={P})"
        if l_max:
            d = rows_draw(f"PA seed {name} B={B}", pakey, (), range(B),
                          P + l_max - 1, reps)
            if r == rung:
                out["pa_seed"] = d
        rows_draw(f"verify seed {name}", wkey, (TAG_VERIFY,), range(1),
                  P + Vh - 1, reps)
        if pad:
            rows_draw(f"puncture pad {name} B={B}", pkey, (), range(B), pad,
                      reps)
        d = offsets_draw(f"test offsets {name} B={B}", range(B), P, reps)
        if r == rung:
            out["offsets"] = d
        # The programs' tables, and Alice's and the retry's with a
        # shortening fill of one z column (no rung of this ladder shortens,
        # so its programs draw none).
        verify = tr.SeedRows(wkey, (TAG_VERIFY,), range(1), P + Vh - 1)
        offsets = tr.Randint(wkey, (TAG_TOFF,), range(B), P)
        fill = tr.SeedRows(wkey, (TAG_SHORTFILL,), range(B), z)
        alice = ([tr.SeedRows(pkey, (), range(B), pad)] if pad else []) \
            + [verify, offsets]
        d = table_draw(f"alice table {name}", alice, reps)
        if r == rung:
            out["alice_table"] = d
        d = table_draw(f"bob table {name}", [offsets, verify], reps)
        if r == rung:
            out["bob_table"] = d
        table_draw(f"alice table with a fill {name}", alice + [fill])
        table_draw(f"retry table with a fill {name}",
                   [tr.SeedRows(wkey, (TAG_SHORTFILL,), idx, z), verify])
        shapes.append(f"r{r}: PA {B}x{P + l_max - 1}, verify "
                      f"{P + Vh - 1}, pad {B}x{pad}, offsets {B} in [0, {P})")
    say("threefry: every rung of the production ladder == plain: "
        + "; ".join(shapes))
    P = probe.payload_per_block(rung)
    l_max = probe.programs(rung).l_max
    z = ladder.steps[rung].code.z
    # The retry's failed rows, an index tensor on the card.
    rows_draw("retry 8 index rows, shortening fill", wkey,
              (TAG_SHORTFILL,), idx, z, reps=20)
    rows_draw("retry 8 index rows, PA length", pakey, (), idx,
              P + l_max - 1)
    offsets_draw("retry 8 index rows, test offsets", idx, P)
    # 4 shards' rows from row0 = g * bl: the unsharded draw's rows.
    bl = B // MESH_SHARDS
    full_pad = tr.seed_rows_at(pkey, (), range(B), 2 * z, dev)
    full_off = tr.randint_at(wkey, (TAG_TOFF,), range(B), P, dev)
    for g in range(MESH_SHARDS):
        rows = range(g * bl, (g + 1) * bl)
        rows_draw(f"shard {g} pad rows from row0={g * bl}", pkey, (), rows,
                  2 * z)
        offsets_draw(f"shard {g} offsets from row0={g * bl}", rows, P)
        assert torch.equal(tr.seed_rows_at(pkey, (), rows, 2 * z, dev),
                           full_pad[g * bl:(g + 1) * bl])
        assert torch.equal(tr.randint_at(wkey, (TAG_TOFF,), rows, P, dev),
                           full_off[g * bl:(g + 1) * bl])
    say(f"threefry: {MESH_SHARDS} shards' rows (row0 = g * {bl}) == "
        f"plain and == the unsharded draw's rows")
    # The shortening fill's draw: no ladder of the repo uses it today.
    rows_draw(f"shortening fill B={B} one z={z} column", wkey,
              (TAG_SHORTFILL,), range(B), z, reps=20)
    # One 2^23-bit chunk of the bench's BSC stream (chunk 0 of seed 7).
    n = 1 << 23
    key = tr.key_from_data(np.frombuffer(np.uint64(7).tobytes(), np.uint32),
                           dev)
    hold_draw("bench chunk fold_in", lambda: tr.fold_in(key, 0),
              lambda: tr.fold_in_plain(key, 0))
    kf = tr.fold_in(key, 0)
    hold_draw("bench chunk split", lambda: tr.split(kf),
              lambda: tr.split_plain(kf))
    ka, kb = tr.split(kf)
    out["hash"] = hold_draw(
        f"bench chunk bits ({n} words)", lambda: tr.bits32(ka, n),
        lambda: tr.bits32_plain(ka, n), 16 + 8 * n, cipher_ops(n, 1, n),
        reps=10)
    for k in (ka, kb):
        hold_draw("bench chunk uniform", lambda: tr.uniform(k, n),
                  lambda: ((tr.bits32_plain(k, n) >> 9) | 0x3F800000)
                  .to(torch.int32).view(torch.float32) - 1.0)
    say(f"threefry: one {n}-bit chunk of the bench's BSC stream (fold_in, "
        f"split, bits, uniform of both keys) == plain")
    return out


def window_layout(probe, r):
    """(code, ColumnLayout) of rung ``r`` of ``probe``'s ladder, as its
    window programs build them (payload | shortened | punctured)."""
    import numpy as np
    from qtpu_torch.ldpc.encode import ColumnLayout
    code = probe.ladder.steps[r].code
    pos = probe._step_positions[r]
    cols = [np.unique(np.asarray(pos[k]) // code.z) if len(pos[k]) else []
            for k in ("payload", "short", "punct")]
    return code, ColumnLayout(code.nb, code.z, *cols)


def window_bound(nbytes, ops):
    """The least time the card could take for ``nbytes`` of traffic and
    ``ops`` 32-bit integer operations within an SM's issue of 128 lanes a
    clock: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ISSUE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def encoder_bound(code, B):
    """``window_bound`` of one encoder launch: the codeword read once, the
    syndromes written once, the table; a 32-bit XOR a word of each edge."""
    return window_bound(B * code.n + B * code.m
                        + 4 * (code.mb + 1 + 2 * code.num_edges + 2 * code.nb),
                        B * code.num_edges * -(-code.z // 4))


def window_kernels_phase(dev, cfg, probe, ms_probe) -> dict:
    """Phase 5c: the syndrome encoder (``qtpu_torch/csrc/qc_encode.cu``)
    and both pin/LLR entry points (``qtpu_torch/csrc/pin_llr.cu``) == their
    plain versions on the card, bit for bit, at the main path's shapes:
    every production rung at B = 128 (``probe``: a BobSession of ``cfg``),
    4 shards' rows (b = 32, == the unsharded call's rows), the retry's 1
    and 8 rows and all B rows, and every rung of the n = 4096 mixed
    ladder at B = 1024 (``ms_probe``).  Timed at the rung a 3% prior
    selects, and with every input one byte off alignment.  The encoder
    is also held and timed at the first and last rung, a shard's rows, 300
    blocks (a CTA walks several), parts off alignment, every n = 4096 rung
    and the regular n = 4096 code at B = 1024, z = 8,192 (column groups),
    and held at z = 24 and 10, each with the launch it makes (body, grid,
    threads, shared memory a CTA, stages, column groups); the parts
    ``alice_program`` hands it are 16-byte aligned.  Returns {"qc_encode",
    "pin_llr", "pin_llr_off", "llr_8": Draw, "qc_encode_shapes": {label:
    (Draw, plan)}}."""
    import numpy as np
    import torch
    from qtpu_torch import _build
    from qtpu_torch import window_assembly as wa
    from qtpu_torch.ldpc import encode as enc
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.window_programs import make_header
    g = torch.Generator(device=dev).manual_seed(56)
    out = {"qc_encode_shapes": {}}

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def rung_inputs(session, r, B):
        code, layout = window_layout(session, r)
        z = code.z
        P = layout.widths[0] * z
        prog = session.programs(r)
        parts = [bits(B, w * z) if w else None for w in layout.widths]
        a, ainv, b_s = session._affine_for(r, P)
        pins = dict(rx=bits(B, P), short_alice=bits(B, prog.s_max),
                    test_alice=bits(B, prog.k_pb),
                    boff_t=torch.randint(0, P, (B,), generator=g,
                                         device=dev),
                    affine=(a, ainv, b_s), s=prog.s_max, k=prog.k_pb,
                    s_max=prog.s_max, fill=parts[1],
                    qmag=float(np.float32(np.log((1 - QBER) / QBER))),
                    layout=layout)
        return code, layout, parts, pins

    def hold_encoder(label, code, layout, parts, reps=0):
        """The encoder == plain on ``parts``; with ``reps`` also its times
        and the launch it makes (printed, kept in qc_encode_shapes)."""
        encode = enc.make_parts_encoder(code, layout)
        B = next(t for t in parts if t is not None).shape[0]
        d = hold_kernel("qc_encode", label, lambda: encode(*parts),
                        lambda: enc.encode_parts_plain(code, layout, parts),
                        encoder_bound(code, B), reps)
        if reps:
            plan = enc.launch_plan(code, layout, parts)
            say(f"qc_encode {label}: body {plan['body']}, grid "
                f"{plan['grid']}, {plan['threads']} threads, {plan['smem']} "
                f"B of shared memory a CTA, {plan['stages']} stage(s), "
                f"{plan['groups']} column group(s)")
            out["qc_encode_shapes"][label] = (d, plan)
        return d

    def check_rung(session, r, B, label, reps, enc_reps=None):
        code, layout, parts, pins = rung_inputs(session, r, B)
        z, P = code.z, layout.widths[0] * code.z
        d = hold_encoder(f"{label} B={B}", code, layout, parts,
                         reps if enc_reps is None else enc_reps)
        fill_bytes = B * layout.widths[1] * z
        d_pin = hold_kernel(
            "pin_llr", f"{label} B={B}", lambda: wa.pin_llr(**pins),
            lambda: wa.pin_llr_plain(**pins),
            window_bound(B * (3 * P + pins["s"] + pins["k"] + 8 + 4
                              + 4 * code.n) + fill_bytes + 8 * code.nb,
                         2 * B * P), reps)
        rx_pin, pin = wa.pin_llr(**pins)[:2]
        pin = pin | (torch.rand(pin.shape, generator=g, device=dev) < 0.05)
        hold_kernel("llr", f"{label} retry of all rows B={B}",
                    lambda: wa.llr(rx_pin, pin, parts[1], pins["qmag"],
                                   layout),
                    lambda: wa.llr_plain(rx_pin, pin, parts[1],
                                         pins["qmag"], layout))
        return d, d_pin, code, layout, parts, pins, rx_pin, pin

    B = cfg.blocks_per_window
    rung = prior_rung(cfg, dev)
    last = len(probe.ladder.steps) - 1
    for r, st in enumerate(probe.ladder.steps):
        reps = 20 if r == rung else 0
        res = check_rung(probe, r, B, f"rung {r} ({st.name})", reps,
                         20 if r in (0, rung, last) else 0)
        if r == rung:
            (out["qc_encode"], out["pin_llr"], code, layout, parts, pins,
             rx_pin, pin) = res
    say(f"window kernels: every rung of the production ladder at B={B} == "
        f"plain (qc_encode, pin_llr, llr)")
    # The parts as alice_program hands them to the encoder (a payload
    # framed at an odd cursor): 16-byte aligned, so the bulk body.
    prog = probe.programs(rung)
    P = layout.widths[0] * code.z
    handed = []

    def spy(library, name, argtypes, counts, dev_, *args,
            real=_build.launch):
        if library == enc.LIBRARY:
            handed.append([p for p in args[:3] if p is not None])
        return real(library, name, argtypes, counts, dev_, *args)
    header = make_header(3, prog.s_max, np.array([1, 2]), np.array([3, 4]),
                         test_bits_pb=prog.k_pb,
                         affine=probe._affine_for(0, P))
    with mock.patch.object(_build, "launch", spy):
        prog.alice(bits(B * P + 64), header)
    assert len(handed) == 1 and handed[0], handed
    assert all(p % 16 == 0 for p in handed[0]), \
        f"alice_program's parts off 16-byte alignment: {handed}"
    say(f"qc_encode: alice_program at rung {rung} hands over "
        f"{len(handed[0])} parts, each 16-byte aligned (the bulk body)")
    # 300 blocks: a CTA walks 2-3 of them through two stages.
    wide = [bits(300, w * code.z) if w else None for w in layout.widths]
    hold_encoder(f"rung {rung} B=300", code, layout, wide, 20)
    # Parts off alignment: the pad alone (mixed body), then every part.
    if parts[2] is not None:
        hold_encoder(f"rung {rung} B={B}, pad one byte off", code, layout,
                     parts[:2] + [one_byte_off(parts[2])], 20)
    hold_encoder(f"rung {rung} B={B}, every part one byte off", code,
                 layout, [None if t is None else one_byte_off(t)
                          for t in parts], 20)
    # 4 shards' rows: each shard's call == plain and == the unsharded rows.
    bl = B // MESH_SHARDS
    full = wa.pin_llr(**pins)
    for sh in range(MESH_SHARDS):
        rows = slice(sh * bl, (sh + 1) * bl)
        part = dict(pins, **{k: pins[k][rows].contiguous() for k in
                             ("rx", "short_alice", "test_alice", "boff_t")},
                    fill=None if pins["fill"] is None
                    else pins["fill"][rows].contiguous())
        hold_kernel("pin_llr", f"shard {sh} rows {sh * bl}..",
                    lambda: wa.pin_llr(**part),
                    lambda: wa.pin_llr_plain(**part))
        for x, y in zip(wa.pin_llr(**part), full):
            assert torch.equal(x, y[rows]), f"shard {sh}: != unsharded rows"
        shard_parts = [None if t is None else t[rows].contiguous()
                       for t in parts]
        hold_encoder(f"rung {rung} shard {sh} rows {sh * bl}.. B={bl}",
                     code, layout, shard_parts, 20 if sh == 0 else 0)
        assert torch.equal(enc.make_parts_encoder(code, layout)(*shard_parts),
                           enc.make_parts_encoder(code, layout)(*parts)[rows])
    say(f"window kernels: {MESH_SHARDS} shards' rows (b = {bl}) == plain "
        f"and == the unsharded call's rows")
    # The retry: 1 and 8 failed rows (index-selected, as the program does).
    idx = torch.randperm(B, generator=g, device=dev)[:8].sort().values
    for nrows in (1, 8):
        sel = idx[:nrows]
        rows_args = (rx_pin[sel], pin[sel],
                     None if parts[1] is None else parts[1][sel],
                     pins["qmag"], layout)
        n_bytes = nrows * (2 * layout.widths[0] * code.z + 4 * code.n
                           + layout.widths[1] * code.z) + 8 * code.nb
        d = hold_kernel("llr", f"retry {nrows} rows",
                        lambda: wa.llr(*rows_args),
                        lambda: wa.llr_plain(*rows_args),
                        window_bound(n_bytes, 0), 20 if nrows == 8 else 0)
        if nrows == 8:
            out["llr_8"] = d
    # Every input one byte off alignment: two aligned loads a run.
    off = dict(pins, **{k: one_byte_off(pins[k])
                        for k in ("rx", "short_alice", "test_alice")})
    if off["fill"] is not None:
        off["fill"] = one_byte_off(off["fill"])
    out["pin_llr_off"] = hold_kernel(
        "pin_llr", f"rung {rung} B={B}, every input one byte off "
        f"alignment", lambda: wa.pin_llr(**off),
        lambda: wa.pin_llr_plain(**off), out["pin_llr"][4:], 20)
    sel = idx[:8]
    off_args = (one_byte_off(rx_pin[sel]), one_byte_off(pin[sel]),
                None if parts[1] is None else one_byte_off(parts[1][sel]),
                pins["qmag"], layout)
    hold_kernel("llr", "retry 8 rows one byte off alignment",
                lambda: wa.llr(*off_args), lambda: wa.llr_plain(*off_args))
    # z not a multiple of 16 (no ladder of the repo has one): the kernels'
    # byte bodies, with every input aligned and one byte off; the encoder
    # on a code with parallel edges and a shortened and a punctured column.
    for lay in (enc.ColumnLayout(8, 24, [0, 2, 3, 5, 6, 7], [1], [4]),
                enc.ColumnLayout(24, 10, list(range(2, 24)), [0], [1])):
        zcode = enc.random_qc_code(lay.z, lay.nb, 4 if lay.z == 24 else 6)
        zparts = [bits(B, w * lay.z) for w in lay.widths]
        for moved in (False, True):
            hold_encoder(f"z={lay.z} B={B}" + (", one byte off" if moved
                                               else ""), zcode, lay,
                         [one_byte_off(t) for t in zparts] if moved
                         else zparts)
        P = lay.widths[0] * lay.z
        a = 5 if P % 5 else 7
        boff_t = torch.randint(0, P, (B,), generator=g, device=dev)
        zin = dict(rx=bits(B, P), short_alice=bits(B, 96),
                   test_alice=bits(B, 16), boff_t=boff_t,
                   affine=(a, pow(a, -1, P), (a * 96 + int(boff_t[0])) % P),
                   s=48, k=8, s_max=96, fill=bits(B, lay.widths[1] * lay.z),
                   qmag=pins["qmag"], layout=lay)
        for moved in (False, True):
            args = dict(zin, **{k: one_byte_off(zin[k]) for k in
                                ("rx", "short_alice", "test_alice", "fill")
                                if moved})
            label = f"z={lay.z} B={B}" + (", one byte off" if moved else "")
            hold_kernel("pin_llr", label, lambda: wa.pin_llr(**args),
                        lambda: wa.pin_llr_plain(**args))
            zpin, zmask = wa.pin_llr(**args)[:2]
            zmask = zmask | (torch.rand(zmask.shape, generator=g,
                                        device=dev) < 0.05)
            if moved:
                zpin, zmask = one_byte_off(zpin), one_byte_off(zmask)
            hold_kernel("llr", label,
                        lambda: wa.llr(zpin, zmask, args["fill"],
                                       args["qmag"], lay),
                        lambda: wa.llr_plain(zpin, zmask, args["fill"],
                                             args["qmag"], lay))
    say(f"window kernels: z = 24 and 10 (the byte bodies) at B={B}, "
        f"aligned and one byte off == plain (qc_encode, pin_llr, llr)")
    # z = 8,192: a block's columns do not fit in shared memory at once.
    wcode = enc.random_qc_code(8192, 32, 4)
    wlay = enc.ColumnLayout.whole(wcode)
    hold_encoder("z=8192 nb=32 B=8", wcode, wlay, [bits(8, wcode.n)], 20)
    # The n = 4096 mixed ladder at B = 1024 (min-sum sessions, the chain),
    # and the regular n = 4096 code (BASELINE configs 2 and 3).
    mB = ms_probe.config.blocks_per_window
    for r, st in enumerate(ms_probe.ladder.steps):
        check_rung(ms_probe, r, mB, f"n=4096 mixed rung {r} ({st.name})", 0,
                   20)
    reg = make_regular_code(4096)
    hold_encoder(f"regular n=4096 B={mB}", reg, enc.ColumnLayout.whole(reg),
                 [bits(mB, reg.n)], 20)
    say(f"window kernels: every rung of the n = 4096 mixed ladder and the "
        f"regular n = 4096 code at B={mB} == plain")
    return out


def verify_bound(nbytes, hashed):
    """The least time the card could take for ``nbytes`` of traffic and,
    for each of ``hashed`` (row word, hash bit) pairs, half a funnel shift
    and one three-input AND-XOR (LOP3) on the INT32 pipe (a word's shift
    for bit j is reused for bit j + 32 of the word before): (ms, "bytes"
    or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 1.5 * hashed / ALU_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hash_bound(b, P, vh):
    """``verify_bound`` of a hash of b rows: the rows and the seed read
    once, the hashes written once."""
    return verify_bound(b * P + (P + vh - 1) + b * vh, b * -(-P // 32) * vh)


def tail_bound(layout, b, B, vh, mode, merged=None):
    """``verify_bound`` of a tail: each merged row reads its payload
    columns of the bits, rx_pin, the pin mask, rx_orig, its expected hash,
    flag, iterations and mismatch or old stats, and writes hat and stats;
    a retry's other rows read and write hat and stats; the seed, the column
    table and the row map once."""
    P = layout.widths[0] * layout.z
    merged = b if merged is None else merged
    row = 5 * P + vh + 1 + 4 + 16 + (4 if mode == "first" else 16)
    kept = 0 if mode == "first" else (B - merged) * (2 * P + 32)
    nbytes = (merged * row + kept + (P + vh - 1) + 8 * layout.nb
              + (0 if mode == "first" else 4 * B))
    return verify_bound(nbytes, merged * -(-P // 32) * vh)


def verify_plan_text(dev, rows, merged, P, vh, layout=None) -> str:
    """The launch ``window_verify.launch_plan`` makes for a hash (no
    ``layout``) or a tail of ``merged`` of ``rows`` rows."""
    from qtpu_torch import window_verify as wv
    p = wv.launch_plan(dev.index, rows, merged, P, vh,
                       *((layout.nb, layout.z) if layout else ()))
    how = "a CTA a row" if p.cluster == 1 else f"a row over {p.cluster} CTAs"
    return (f"plan C={p.cluster} ({how}; {p.groups} groups of 16 words a "
            f"CTA, {p.threads} threads, {p.smem} B shared; "
            f"{p.decoded_ctas} + {p.kept_ctas} kept CTAs; {p.resident} "
            f"clusters resident)")


def verify_sweep(label, dev, want, P, vh, rows, merged, run, layout=None,
                 reps=20) -> dict:
    """Every launch ``window_verify.plan`` can make with all its clusters
    resident for a call of ``merged`` of ``rows`` rows (a tail where
    ``layout`` is given, else a hash): ``run(plan)``'s outputs == ``want``
    (the plain version's) at each, and its device time (a CUDA-graph
    replay): {plan text: ms}, printed with the plan the call takes
    marked."""
    import torch
    from qtpu_torch import window_verify as wv
    idx = dev.index
    tail = layout is not None
    shape = (layout.nb, layout.z) if tail else ()
    chosen = wv.launch_plan(idx, rows, merged, P, vh, *shape)
    vec = P % 16 == 0 and (not tail or layout.z % 16 == 0)
    occupancy = (lambda C, t, m: wv._max_clusters(idx, tail, vec, C, t, m))
    G = wv._groups(P)
    out, seen = {}, set()
    for C in wv.CLUSTER_SIZES:
        q = -(-G // C)
        for w in wv.WARP_CAPS:
            try:
                p = wv.plan(rows, merged, P, vh, shape[0] if tail else 0,
                            tail, wv._sms(idx), occupancy, cluster=C,
                            threads=32 * min(w, q))
            except (ValueError, RuntimeError):
                continue
            if p in seen or (p.grid // C > p.resident and p != chosen):
                continue
            seen.add(p)
            got = run(p)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, want,
                                                         strict=True)), \
                f"verify {label}: {p} != plain"
            text = f"C={C} {p.threads}t {p.grid} CTAs"
            out[text] = graph_ms(lambda: run(p), reps)
            if p == chosen:
                out[text + " <- chosen"] = out.pop(text)
    say(f"verify plans {label} (device ms, each == plain): " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in out.items()))
    return out


def trace_ms(fn, reps, kernel="verify_kernel"):
    """Device ms of one ``fn()`` from a torch.profiler trace of ``reps``
    calls: the mean time of the kernels named ``kernel`` in them."""
    import torch
    from qtpu_torch.profiling import device_trace
    fn()
    torch.cuda.synchronize()
    with device_trace(torch.device("cuda", 0)) as tr:
        for _ in range(3):      # the profiler may miss its first launches
            fn()
        with tr.region("timed"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    found = [k for k in tr.part("timed").kernels if kernel in k[0]]
    assert 0 < len(found) <= reps, (len(found), reps)
    return sum(e - s for _, s, e in found) / 1e3 / len(found)


def program_kernels(dev, probe, rung):
    """The CUDA kernels alice, bob and the retry (11 failed rows) launch at
    ``rung`` of ``probe``'s ladder, from a torch.profiler trace of one
    window's calls: {program: kernel names}."""
    import numpy as np
    import torch
    from qtpu_torch.profiling import device_trace
    from qtpu_torch.window_programs import make_header
    prog = probe.programs(rung)
    B, P = probe.config.blocks_per_window, probe.payload_per_block(rung)
    rng = np.random.default_rng(58)
    a_bits = rng.integers(0, 2, B * P, dtype=np.uint8)
    b_bits = a_bits ^ (rng.random(B * P) < QBER).astype(np.uint8)
    hdr = dict(test_bits_pb=prog.k_pb, affine=probe._affine_for(0, P))
    s = prog.s_max // 2
    alice = (lambda: prog.alice(torch.from_numpy(a_bits).to(dev),
                                make_header(0, s, [1, 2], [3, 4], **hdr)))
    payload, syn, hashes, test, short = alice()
    arena = torch.from_numpy(b_bits).to(dev)
    header = make_header(0, s, [1, 2], **hdr)
    mag = np.float32(np.log((1 - QBER) / QBER))
    bob = (lambda: prog.bob(arena, header, test, short, syn, hashes, mag))
    hat, rx_orig, rx_pin, pinmask, stats = bob()
    positions = np.sort(rng.choice(P, prog.retry_bits, replace=False)
                        ).astype(np.int32)
    bits = prog.retry_gather(payload, positions)
    rows = np.sort(rng.choice(B, 11, replace=False))
    common = (arena, header, rx_orig, rx_pin, pinmask, hat, stats)
    calls = {
        "alice_program": alice, "bob_program": bob,
        "retry": lambda: prog.retry(*common, rows, positions, bits, syn,
                                    hashes, mag)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with device_trace(dev) as tr:
        for fn in calls.values():   # the profiler may miss its first launches
            fn()
        torch.cuda.synchronize()
        for name, fn in calls.items():
            with tr.region(name):
                fn()
                torch.cuda.synchronize()
    return {name: [k[0] for k in tr.part(name).kernels] for name in calls}


def verify_phase(dev, cfg, probe, ms_probe) -> dict:
    """Phase 5d: both entry points of ``qtpu_torch/csrc/verify.cu`` ==
    their plain versions on the card, bit for bit, at the main path's
    shapes (``probe``: a BobSession of ``cfg``; ``ms_probe``: of the mixed
    n = 4096 ladder), each tail mode; timed at the first, the 3%-prior
    and the last rung, a shard's rows and the retry's rows merge of 11 and
    of all B rows.  Returns {"hash", "tail", "tail_off", "tail_shard",
    "retry", "retry_all": Draw, "hash_chain": (call ms, device ms),
    "hash_tail_max_err": int}."""
    import numpy as np
    import torch
    from qtpu_torch import window_verify as wv
    g = torch.Generator(device=dev).manual_seed(57)
    out = {"untraced": {}}
    vh = cfg.verify_hash_bits

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    def inputs(layout, b, B):
        """A decode's tail arguments (b decoded rows, 5% pins, 90%
        converged) in a window of B rows whose expected hashes are the
        decode's own on every other row and one bit off elsewhere."""
        P = layout.widths[0] * layout.z
        args = dict(bits=bits(b, layout.nb * layout.z), rx_pin=bits(b, P),
                    pin=torch.rand((b, P), generator=g, device=dev) < 0.05,
                    rx_orig=bits(B, P), seed=bits(P + vh - 1),
                    converged=torch.rand(b, generator=g, device=dev) < 0.9,
                    iterations=torch.randint(1, 60, (b,), generator=g,
                                             device=dev, dtype=torch.int32),
                    layout=layout)
        hat, _ = wv.tail_plain(**dict(args, rx_orig=args["rx_orig"][:b]),
                               exp_hashes=bits(b, vh),
                               mism=torch.zeros(b, dtype=torch.int32,
                                                device=dev))
        exp = bits(B, vh)
        exp[:b] = wv.hash_plain(hat, args["seed"])
        exp[1:b:2, 0] ^= 1
        return dict(args, exp_hashes=exp)

    def merge(mode, b, B, P):
        if mode == "first":
            return dict(mism=torch.randint(0, 9, (b,), generator=g,
                                           device=dev, dtype=torch.int32))
        old = torch.randint(0, 60, (B, 4), generator=g, device=dev,
                            dtype=torch.int32)
        pick = torch.randperm(B, generator=g, device=dev).cpu().numpy()
        return dict(hat=bits(B, P), stats=old, rows=pick[:b])

    def off(d):
        return {k: one_byte_off(v) if isinstance(v, torch.Tensor) else v
                for k, v in d.items()}

    def hold_tail(label, layout, mode, b, B, moved=False, reps=0, key=None):
        """The tail of b decoded rows of a window of B == plain (``mode``
        "first" or "rows"); with ``reps`` its times, a retry's kept under
        ``key`` for the traced phase."""
        P = layout.widths[0] * layout.z
        args, m = inputs(layout, b, B), merge(mode, b, B, P)
        if moved:
            args, m = off(args), off(m)
        if reps:
            label += " | " + verify_plan_text(dev, B, b, P, vh, layout)
        d = hold_kernel("verify_tail", f"{mode} {label}",
                        lambda: wv.tail(**args, **m),
                        lambda: wv.tail_plain(**args, **m),
                        tail_bound(layout, b, B, vh, mode),
                        reps if mode == "first" else 0)
        if reps and mode != "first":
            # The retries upload their row map a call (no graph capture):
            # their device time comes from a profiler trace, taken after
            # phase 13 (``verify_traced_phase``).
            t = time.perf_counter()
            wv.tail_plain(**args, **m)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t)
            ms = time_cuda(lambda: wv.tail(**args, **m), reps)
            out["untraced"][key] = (f"{mode} {label}",
                                    lambda: wv.tail(**args, **m), reps,
                                    Draw(0, ms, 0.0, plain_ms, *tail_bound(
                                        layout, b, B, vh, mode)))
        return d, args

    def hold_hash(label, x, seed, reps=0):
        b, P = x.shape
        if reps:
            label += " | " + verify_plan_text(dev, b, b, P,
                                              seed.numel() - P + 1)
        return hold_kernel("verify_hash", label, lambda: wv.hash(x, seed),
                           lambda: wv.hash_plain(x, seed),
                           hash_bound(b, P, seed.numel() - P + 1), reps)

    B = cfg.blocks_per_window
    rung = prior_rung(cfg, dev)
    last = len(probe.ladder.steps) - 1
    for r, st in enumerate(probe.ladder.steps):
        _, layout = window_layout(probe, r)
        reps = 20 if r in (0, rung, last) else 0
        d, args = hold_tail(f"rung {r} ({st.name}) B={B}", layout, "first",
                            B, B, reps=reps)
        x = args["rx_orig"]
        h = hold_hash(f"rung {r} ({st.name}) B={B}", x, args["seed"], reps)
        if r == rung:
            out["tail"], out["hash"], r_layout, r_args = d, h, layout, args
            chain = (lambda: wv.hash_plain(x, args["seed"]))
            out["hash_chain"] = (time_cuda(chain, 20), graph_ms(chain, 20))
            say(f"verify_hash rung {r} B={B}: the float32 cuBLAS chain it "
                f"replaces (hash_plain: unfold, casts, matmul, & 1) "
                f"call_ms={out['hash_chain'][0]:.4f} device_ms="
                f"{out['hash_chain'][1]:.4f}; the kernel's device_ms="
                f"{h.device_ms:.4f}")
    say(f"verify: every rung of the production ladder at B={B} == plain "
        f"(hash, first decode's tail)")
    # 4 shards' rows: the first shard timed, each == the unsharded rows.
    bl = B // MESH_SHARDS
    first = dict(mism=torch.randint(0, 9, (B,), generator=g, device=dev,
                                    dtype=torch.int32))
    full = wv.tail(**r_args, **first)
    for sh in range(MESH_SHARDS):
        rows = slice(sh * bl, (sh + 1) * bl)
        part = {k: (v[rows].contiguous() if isinstance(v, torch.Tensor)
                    and v.dim() and k != "seed" else v)
                for k, v in r_args.items()}
        m = dict(mism=first["mism"][rows].contiguous())
        plan = (" | " + verify_plan_text(dev, bl, bl, part["rx_pin"].shape[1],
                                         vh, r_layout) if sh == 0 else "")
        d = hold_kernel("verify_tail", f"first shard {sh} rows {sh * bl}.. "
                        f"B={bl}{plan}", lambda: wv.tail(**part, **m),
                        lambda: wv.tail_plain(**part, **m),
                        tail_bound(r_layout, bl, bl, vh, "first"),
                        20 if sh == 0 else 0)
        if sh == 0:
            out["tail_shard"] = d
        for x, y in zip(wv.tail(**part, **m), full):
            assert torch.equal(x, y[rows]), f"shard {sh}: != unsharded rows"
    say(f"verify: {MESH_SHARDS} shards' rows (b = {bl}) == plain and == "
        f"the unsharded call's rows")
    # Every resident plan at the timed shapes of the 3%-prior rung.
    P = r_layout.widths[0] * r_layout.z
    sweeps = out["sweeps"] = {}

    def sweep_tail(label, mode, b, B, m):
        args = inputs(r_layout, b, B)
        hat_o = torch.empty((B, P), dtype=torch.uint8, device=dev)
        st_o = torch.empty((B, 4), dtype=torch.int32, device=dev)
        order, merged, code = None, B, wv.FIRST
        if mode != "first":
            order, merged = wv._row_order(wv._source_rows(m["rows"], b, B))
            order, code = torch.from_numpy(order).to(dev), wv.ROWS

        def run(p):
            wv._launch_tail(args["bits"], args["rx_pin"], args["pin"],
                            args["rx_orig"], args["seed"],
                            args["exp_hashes"], args["converged"],
                            args["iterations"], r_layout, m.get("mism"),
                            m.get("hat"), m.get("stats"), code, order,
                            merged, hat_o, st_o, p)
            return hat_o, st_o
        sweeps[label] = verify_sweep(label, dev,
                                     wv.tail_plain(**args, **m), P, vh, B,
                                     merged, run, r_layout)

    def sweep_hash(label, x, seed):
        o = torch.empty((x.shape[0], vh), dtype=torch.uint8, device=dev)

        def run(p):
            wv._launch_hash(x, seed, o, p)
            return (o,)
        sweeps[label] = verify_sweep(label, dev, (wv.hash_plain(x, seed),),
                                     P, vh, x.shape[0], x.shape[0], run)
    sweep_hash(f"hash B={B}", r_args["rx_orig"], r_args["seed"])
    for bb in (1, 8):
        sweep_hash(f"hash b={bb}", r_args["rx_orig"][:bb].contiguous(),
                   r_args["seed"])
    for label, mode, b in ((f"first B={B}", "first", B),
                           (f"first shard b={bl}", "first", bl),
                           ("first b=1", "first", 1),
                           ("first b=8", "first", 8),
                           (f"rows 11 of B={B}", "rows", 11),
                           (f"rows {B} of B={B}", "rows", B)):
        Bw = b if mode == "first" else B
        sweep_tail(label, mode, b, Bw, merge(mode, b, Bw, P))
    # The retry's rows merge, timed at 11 and all B rows; 1 row too.
    hold_tail(f"rung {rung} 11 rows of B={B}", r_layout, "rows", 11, B,
              reps=20, key="retry")
    hold_tail(f"rung {rung} {B} rows of B={B}", r_layout, "rows", B, B,
              reps=20, key="retry_all")
    hold_tail(f"rung {rung} 1 row of B={B}", r_layout, "rows", 1, B)
    # A decode (and a hash) of 1 and of 8 rows: too few rows to fill the
    # card a row a CTA.
    for bb in (1, 8):
        out[f"tail_b{bb}"] = hold_tail(f"rung {rung} b={bb}", r_layout,
                                       "first", bb, bb, reps=20)[0]
        out[f"hash_b{bb}"] = hold_hash(
            f"rung {rung} b={bb}", r_args["rx_orig"][:bb].contiguous(),
            r_args["seed"], 20)
    # Every input one byte off alignment.
    out["tail_off"] = hold_tail(f"rung {rung} B={B}, every input one byte "
                                f"off alignment", r_layout, "first", B, B,
                                moved=True, reps=20)[0]
    hold_tail(f"rung {rung} 11 rows of B={B}, every input one byte off",
              r_layout, "rows", 11, B, moved=True)
    hold_tail(f"rung {rung} {B} rows of B={B}, every input one byte off",
              r_layout, "rows", B, B, moved=True)
    hold_hash(f"rung {rung} B={B}, x and seed one byte off",
              one_byte_off(r_args["rx_orig"]), one_byte_off(r_args["seed"]),
              20)
    for h_bits in (1, 31, 33):
        P = r_layout.widths[0] * r_layout.z
        hold_hash(f"rung {rung} B={B} Vh={h_bits}", r_args["rx_orig"],
                  bits(P + h_bits - 1))
    # z = 24 and 10 (P not a multiple of 32), every mode.
    from qtpu_torch.ldpc.encode import ColumnLayout
    for lay in (ColumnLayout(8, 24, [0, 2, 3, 5, 6, 7], [1], [4]),
                ColumnLayout(24, 10, list(range(2, 24)), [0], [1])):
        for moved in (False, True):
            label = f"z={lay.z}" + (", one byte off" if moved else "")
            for mode, b in (("first", B), ("rows", 11), ("rows", B)):
                hold_tail(f"{label} b={b}", lay, mode, b, B, moved=moved)
            x = bits(B, lay.widths[0] * lay.z)
            seed = bits(lay.widths[0] * lay.z + vh - 1)
            hold_hash(f"{label} B={B}", one_byte_off(x) if moved else x,
                      one_byte_off(seed) if moved else seed)
    say(f"verify: z = 24 and 10 at B={B}, every mode, aligned and one byte "
        f"off == plain")
    # The mixed n = 4096 ladder at B = 1024 (z = 16: a word spans two
    # columns): the min-sum sessions' and the chain's tails.
    mB = ms_probe.config.blocks_per_window
    for r, st in enumerate(ms_probe.ladder.steps):
        _, layout = window_layout(ms_probe, r)
        _, args = hold_tail(f"n=4096 mixed rung {r} ({st.name}) B={mB}",
                            layout, "first", mB, mB)
        if r == 0:
            hold_hash(f"n=4096 mixed rung 0 B={mB}", args["rx_orig"],
                      args["seed"])
    say(f"verify: every rung of the n = 4096 mixed ladder at B={mB} == plain")
    return out


def verify_traced_phase(dev, cfg, probe, verified) -> None:
    """Phase 5d's traced part, run after phase 19 (a profiler session
    before phase 13's one-call trace leaves that trace without its
    kernels): the retry's device time from a torch.profiler trace (into
    ``verified["retry"]``, 11 rows, and ``["retry_all"]``, all B rows),
    and a trace of alice, bob and the retry at the 3%-prior rung launching
    the verify kernel once each and no GEMM."""
    for key, (label, fn, reps, d) in verified.pop("untraced").items():
        dev_ms = trace_ms(fn, reps)
        say(f"verify_tail {label}: == plain; kernel_ms={d.ms:.4f} "
            f"device_ms={dev_ms:.4f} (trace) plain_ms={d.plain_ms:.2f} "
            f"bound_ms={d.bound_ms:.5f} ({d.bound_by}) share_of_bound "
            f"{d.bound_ms / dev_ms:.4f} (device) library_ms=null")
        verified[key] = d._replace(device_ms=dev_ms)
    rung = prior_rung(cfg, dev)
    for name, kernels in program_kernels(dev, probe, rung).items():
        gemm = [k for k in kernels if re.search(GEMM_KERNEL, k)]
        n_verify = sum("verify_kernel" in k for k in kernels)
        assert n_verify == 1 and not gemm, (name, n_verify, gemm)
        say(f"verify: {name} at rung {rung} launched the verify kernel "
            f"once and no GEMM ({len(kernels)} kernels)")


def one_byte_off(t):
    """A contiguous copy of ``t`` whose storage starts one byte past an
    aligned address."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def window_kernel_launches(launches: dict) -> tuple[int, int, int]:
    """(qc_encode, pin_llr + llr, verify_hash + verify_tail) launches of a
    path."""
    return (launches.get("qc_encode", 0),
            launches.get("pin_llr", 0) + launches.get("llr", 0),
            launches.get("verify_hash", 0) + launches.get("verify_tail", 0))


def _counters():
    from qtpu_torch import random as tr
    from qtpu_torch import window_assembly as wa
    from qtpu_torch import window_verify as wv
    from qtpu_torch.ldpc import cuda_bp
    from qtpu_torch.ldpc import encode as enc
    return cuda_bp.launches, tr.launches, enc.launches, wa.launches, \
        wv.launches


def check_window_kernels(label, launches, windows, retried=False) -> dict:
    """A path launched the encoder, the pin/LLR kernel and both verify
    entry points (and, where it ``retried``, the retries' LLR entry point);
    prints and returns their launches a window."""
    names = ("qc_encode", "pin_llr", "verify_hash", "verify_tail") + (
        ("llr",) if retried else ())
    for name in names:
        assert launches[name] > 0, f"{label} never launched {name}"
    per = {k: round(launches[k] / windows, 3)
           for k in ("qc_encode", "pin_llr", "llr", "verify_hash",
                     "verify_tail")}
    say(f"{label} window-kernel launches a window over {windows} windows: "
        f"{per}")
    return per


def reset_launches():
    from qtpu_torch.ldpc import cuda_bp
    for counts in _counters():
        for name in counts:
            counts[name] = 0
    for name in cuda_bp.launches:
        cuda_bp.launch_batches[name].clear()


def read_launches() -> dict:
    """The BP kernels', the threefry entry points', the encoder's, the
    pin/LLR and the verify entry points' launches."""
    import torch
    torch.cuda.synchronize()
    return {k: v for counts in _counters() for k, v in counts.items()}


def threefry_launches(launches: dict) -> int:
    from qtpu_torch import random as tr
    return sum(launches.get(name, 0) for name in tr.launches)


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
    streams, span_ms, busy_ms = kernel_streams(lambda: sharded(llr, syn),
                                               f"{name}_kernel")
    assert len(streams) == MESH_SHARDS and len(set(streams)) == MESH_SHARDS, \
        f"{label}: the trace's {name} launches ran on streams {streams}"
    ms = time_cuda(lambda: sharded(llr, syn), reps)
    ms1 = time_cuda(lambda: single(llr, syn), reps)
    bound_ms, bound_by = decode_bound(code, B, int(iters.sum()))
    say(f"sharded {label}: {MESH_SHARDS} shards of {B // MESH_SHARDS} on "
        f"{dev} == one launch of B={B} (bits, iterations, converged), "
        f"{per_call} {name} launches per call, 8 blocks == golden; traced "
        f"call: its {MESH_SHARDS} launches on streams {streams}, first start "
        f"to last end {span_ms:.3f} ms for {busy_ms:.3f} ms of kernel time; "
        f"sharded_ms={ms:.3f} unsharded_ms={ms1:.3f} bound_ms="
        f"{bound_ms:.4f} ({bound_by}) share_of_bound {bound_ms / ms:.4f}")
    return per_call, ms, ms1


def kernel_streams(fn, kernel):
    """A torch.profiler trace of one ``fn()``: (the CUDA stream of each
    launch of a kernel whose name holds ``kernel``, in launch order; ms
    from the first such launch's start to the last one's end; their
    summed ms).  The streams come from the trace's kernel events
    (``args.stream`` of its Chrome trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "qtpu_torch" / "kernel_streams_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") == "kernel" and kernel in e["name"]),
                    key=lambda e: e["ts"])
    path.unlink()
    assert events, f"the trace holds no {kernel} launch"
    span = max(e["ts"] + e["dur"] for e in events) - events[0]["ts"]
    return ([e["args"]["stream"] for e in events], span / 1e3,
            sum(e["dur"] for e in events) / 1e3)


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
    assert launches["verify_tail"] >= MESH_SHARDS * len(mets), launches
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
        f"window; window_ms {MESH_SHARDS} shards "
        f"{1e3 * timed[0] / timed[1]:.2f}, unsharded "
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
    margins, times, peak = {}, {}, {}
    for shards in (MESH_SHARDS, 2 * MESH_SHARDS):
        flush = make_stream_pa(make_mesh(devices=[dev] * shards), N, m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = flush(t_dev, stream)
        assert torch.equal(got, fk), f"{shards}-shard flush != unsharded"
        peak[shards] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        times[shards] = time_cuda(lambda: flush(t_dev, stream), 1)
        margins[shards] = reference_sharded_margin(t_dev, stream, m, shards)
    one_ms = time_cuda(lambda: pa.stream_toeplitz(
        t_dev, stream, m, segment=N // 2, precision=torch.float64), 1)
    say(f"sharded stream pa: N=2^{N.bit_length() - 1} m={m} "
        f"({m / N:.3f} N): the {MESH_SHARDS}- and {2 * MESH_SHARDS}-shard "
        f"float64 flush == unsharded; flush_ms {MESH_SHARDS} shards "
        f"{times[MESH_SHARDS]:.2f}, {2 * MESH_SHARDS} shards "
        f"{times[2 * MESH_SHARDS]:.2f}, unsharded {one_ms:.2f}; GB a "
        f"flush adds at its peak: {MESH_SHARDS} shards "
        f"{peak[MESH_SHARDS]:.2f}, {2 * MESH_SHARDS} shards "
        f"{peak[2 * MESH_SHARDS]:.2f}; the "
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
    one-process 4-shard program; returns the ranks' summed launches (the
    layered kernel's, the threefry entry points', (qc_encode, pin_llr,
    verify))."""
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
    # The one-process window: each shard's tail (on its own stream) held
    # to the plain tail on its inputs.
    import torch
    from qtpu_torch import window_verify as wv
    tails = []

    def tail_spy(*args, real=wv.tail, **kwargs):
        out = real(*args, **kwargs)
        tails.append((args, kwargs, out,
                      torch.cuda.current_stream(dev).cuda_stream))
        return out
    with mock.patch.object(wv, "tail", tail_spy):
        gled, stats = mesh_program_window(
            dev, make_mesh(devices=[dev] * MESH_SHARDS))
    torch.cuda.synchronize()
    assert len(tails) == MESH_SHARDS and len({s for *_, s in tails}) \
        == MESH_SHARDS, [s for *_, s in tails]
    for args, kwargs, out, _ in tails:
        assert all(torch.equal(x, y) for x, y in zip(
            out, wv.tail_plain(*args, **kwargs), strict=True)), \
            "a shard's tail != plain"
    bl = len(stats) // MESH_SHARDS
    for o in outs:
        assert (o["backend"], o["size"]) == ("gloo", MESH_SHARDS), o
        assert o["gled"] == gled, f"rank {o['rank']}: ledger != one process"
        assert o["stats"] == stats[o["first"] * bl:
                                   (o["first"] + MESH_SHARDS // 2) * bl]
        assert o["launches"]["bp_layered"] == MESH_SHARDS // 2, o["launches"]
        assert o["launches"]["verify_tail"] == MESH_SHARDS // 2, \
            o["launches"]
    launches = sum(o["launches"]["bp_layered"] for o in outs)
    threefry = sum(threefry_launches(o["launches"]) for o in outs)
    assert all(o["launches"]["threefry_draws"] > 0 for o in outs), outs
    assert all(o["launches"]["pin_llr"] == MESH_SHARDS // 2
               for o in outs), outs
    window = tuple(map(sum, zip(*(window_kernel_launches(o["launches"])
                                  for o in outs))))
    say(f"two processes (gloo over CUDA tensors): ranks 0 and 1 each own "
        f"{MESH_SHARDS // 2} of {MESH_SHARDS} shards on {dev}; psum'd "
        f"ledger {gled} on both == the one-process program's; stats rows "
        f"equal; {launches} bp_layered, {threefry} threefry, {window[0]} "
        f"qc_encode, {window[1]} pin_llr and {window[2]} verify launches; "
        f"{wall:.1f} s for both; the one-process window's {MESH_SHARDS} "
        f"tails, on {MESH_SHARDS} streams, == plain")
    return launches, threefry, window


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
    for name in ("full_chain", "per_chip"):
        for entry in ("threefry_draws", "threefry_hash", "pin_llr",
                      "verify_tail"):
            assert launches[name][entry] > 0, f"bench {name}: no {entry}"
    for entry in ("qc_encode", "verify_hash"):
        assert launches["full_chain"][entry] > 0, launches["full_chain"]
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


def scaling_phase(windows, timeout) -> dict:
    """Phase 19: ``python -m qtpu_torch.scaling WINDOWS`` as a subprocess
    on this card.  Every point printed, its keys equal and at least D
    layered launches a timed window at D shards; the isolated probes
    printed.  Returns {shards: layered launches a window}."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "qtpu_torch.scaling",
                           str(windows)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    assert proc.returncode == 0, \
        f"qtpu_torch.scaling exited {proc.returncode}: {proc.stderr[-3000:]}"
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    rows = [ln for ln in lines if "shards" in ln]
    probes = [ln for ln in lines if "probes" in ln]
    assert [r["shards"] for r in rows] == [1, 2, 4, 8], rows
    assert len(probes) == 1, probes
    base = rows[0]["windows_per_s"]
    for r in rows:
        assert r["keys_equal"] and r["final_key_bits"] > 0, r
        assert r["windows"] >= windows, r
        assert r["bp_layered_per_window"] >= r["shards"], r
        say(f"scaling D={r['shards']} on {r['devices']} card(s): "
            f"{r['windows']} windows in {r['elapsed_s']:.4f} s, "
            f"{r['windows_per_s']:.3f} windows/s "
            f"({r['windows_per_s'] / base:.2f}x of D=1), "
            f"{r['sifted_bits_per_s']:.0f} sifted bits/s, "
            f"{r['bp_layered_per_window']:.3f} bp_layered launches a window, "
            f"{r['final_key_bits']} equal key bits; {r['device']}; host "
            f"{json.dumps(r['host'])}")
    for p in probes[0]["probes"]:
        say(f"scaling isolated D={p['shards']}: psum_ledger alone "
            f"{p['psum_ms']:.4f} ms, sharded decode alone "
            f"(B={probes[0]['blocks']}, rung {probes[0]['rung']}) "
            f"{p['decode_ms']:.4f} ms")
    say(f"scaling: {wall:.1f} s for the command")
    return {r["shards"]: r["bp_layered_per_window"] for r in rows}


def baseline_phase(dev) -> dict:
    """Phase 18, first part: ``python -m qtpu_torch.baseline`` config1,
    config2, config3, config5 and efficiency on this card, held to the
    plain decoders, the CPU and a one-process program.  Returns each
    config's BP kernel and threefry launches."""
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
    assert c5["threefry_launches"]["threefry_draws"] > 0, c5
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
    assert ef["threefry_launches"]["threefry_draws"] > 0, ef
    efficiency_ladder_holds(dev)
    return {name: {**out["launches"], **out["threefry_launches"]}
            for name, out in (("config2", c2), ("config3", c3),
                              ("config5", c5), ("efficiency", ef))}


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


# Kernel names of int64 xor and or, which only the plain threefry rounds
# launch on the window cycle, and of torch.roll, which the plain syndrome
# encoder launched once a base edge (the stream's arena compaction rolls
# once in ~15 production windows).
INT64_THREEFRY_OP = r"Bitwise(Xor|Or)Functor<long>"
# Kernel names of cuBLAS's matrix products (the plain verify hash's).
GEMM_KERNEL = r"(?i)gemm|gemv|splitk|cutlass|xmma"
ROLL_OP = r"roll_cuda_kernel"
# Launches a call of the programs whose eager op chains have kernels now
# (before the window kernels: alice 352, bob 61, the retry of 8 rows 44),
# and a two-party production window's launches on that tree.
PROGRAM_LAUNCH_LIMITS = {"alice_program": 40, "bob_program": 40,
                         "retry": 40}
PARENT_LAUNCHES_PER_WINDOW = 648.3
# Threefry launches a production window outside its retry rounds: one
# draw table a program call that draws (Alice's, Bob's, each party's PA).
THREEFRY_PER_WINDOW = 4


def profiling_phase() -> dict:
    """Phase 18, second part: ``python -m qtpu_torch.profiling programs
    10`` and ``chain 6`` on this card.  Returns their summed BP kernel,
    threefry, encoder and pin/LLR launches."""
    import re
    from qtpu_torch.profiling import PROGRAMS
    pr, _ = module_json("qtpu_torch.profiling", ["programs", "10"], 300)
    for name in PROGRAMS:
        assert pr["launches"][name] > 0, (name, pr["launches"])
        assert pr["device_ms"][name] <= 1.05 * pr[name], \
            (name, pr["device_ms"][name], pr[name])
    for name, limit in PROGRAM_LAUNCH_LIMITS.items():
        assert pr["launches"][name] <= limit, (name, pr["launches"][name])
    assert pr["bp_launches"]["decode_only"] == {"bp_layered": 1.0,
                                                "bp_flooding": 0.0}, pr
    assert pr["launches"]["pa_seed_gen"] == 1, pr["launches"]
    ch, _ = module_json("qtpu_torch.profiling", ["chain", "6"], 400)
    tr = ch["trace"]
    # The reference's loop stops once Bob has settled 6 windows; a flush
    # may settle two at once.
    assert ch["windows"] >= 6 and 0 < tr["busy_share"] <= 1, ch
    plain_ops = [k["name"] for k in tr["top_kernels"]
                 if re.search(INT64_THREEFRY_OP, k["name"])
                 or (re.search(ROLL_OP, k["name"])
                     and k["launches"] >= tr["windows"])]
    assert not plain_ops, f"plain threefry or encoder ops among the top: " \
        f"{plain_ops}"
    assert tr["launches_per_window"] < PARENT_LAUNCHES_PER_WINDOW, \
        tr["launches_per_window"]
    say(f"profiling programs launches a call: "
        + ", ".join(f"{k} {pr['launches'][k]}" for k in PROGRAMS))
    say(f"profiling chain: {ch['windows']} timed windows, "
        f"{ch['window_ms']} ms a window, busy share {tr['busy_share']} "
        f"({tr['busy_ms_per_window']} busy ms a window in {tr['windows']} "
        f"traced ones; {tr['busy_share_of']}; timed mix {ch['mix']}, traced "
        f"mix {tr['mix']}); {tr['launches_per_window']} kernel launches a "
        f"window (PR 9's tree: {PARENT_LAUNCHES_PER_WINDOW}) and "
        f"{tr['kernel_ms_per_window']} kernel ms a window; top kernels "
        + "; ".join(f"{k['name'][:60]} {k['ms']} ms x {k['launches']}"
                    for k in tr["top_kernels"]))
    return {k: pr[total][k] + ch[total][k]
            for total in ("bp_launches_total", "threefry_launches_total",
                          "window_kernel_launches_total")
            for k in pr[total]}


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
    from qtpu_torch import random as tr
    from qtpu_torch import window_assembly as wa
    from qtpu_torch import window_verify as wv
    from qtpu_torch.chain import ChainConfig
    from qtpu_torch.ldpc import cuda_bp
    from qtpu_torch.ldpc import encode as enc
    from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
    from qtpu_torch.pipeline import PipelineConfig, production_config
    from qtpu_torch.pa import _toeplitz_hash, toeplitz_margin

    assert "jax" not in sys.modules
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    say(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build, one nvcc per source, in parallel
    t = time.perf_counter()
    libraries = (*cuda_bp.KERNELS.values(), tr.LIBRARY, enc.LIBRARY,
                 wa.LIBRARY, wv.LIBRARY)
    _build.build(*libraries)
    dt = time.perf_counter() - t
    for name in libraries:
        _build.load(name)
        say(f"build: {name} (all {len(libraries)} in {dt:.1f} s) | "
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
    fft_ms = time_cuda(lambda: _toeplitz_hash(tb, xb, l_max), 10)
    fft_dev = graph_ms(lambda: _toeplitz_hash(tb, xb, l_max), 10)
    fft_bound, fft_by, fft_len, fft_flops = toeplitz_bound(128, 61440, l_max)
    say(f"pa fft (cuFFT, qtpu_torch.pa._toeplitz_hash): B=128 n=61440 "
        f"m={l_max}, FFT length {fft_len}, {fft_flops / 1e9:.3f} GFLOP "
        f"counted; kernel_ms={fft_ms:.4f} device_ms={fft_dev:.4f} "
        f"bound_ms={fft_bound:.4f} ({fft_by}) share_of_bound "
        f"{fft_bound / fft_dev:.4f} (device)")

    # 5b. the threefry kernel vs its plain versions
    draws = threefry_phase(dev, cfg, ladder, probe)

    # 5c. the syndrome encoder and the pin/LLR kernel vs their plain versions
    ms_cfg = PipelineConfig(n=4096, family="mixed", alg="minsum",
                            blocks_per_window=1024, qber_test_bits=8192,
                            stream_capacity_bits=1 << 25)
    ms_probe = BobSession(ms_cfg, 0x5E55, make_direct_pair()[1], device=dev)
    assembled = window_kernels_phase(dev, cfg, probe, ms_probe)

    # 5d. the verify hash and decode tail vs their plain versions
    verified = verify_phase(dev, cfg, probe, ms_probe)

    # 6. the production session on this card
    a_src, b_src = bsc_on_card(
        dev, (SESSION_WINDOWS + 4) * cfg.n * cfg.blocks_per_window, 7)
    reset_launches()
    plain_calls = collections.Counter()
    # The session's draw tables and retry rounds.
    made = collections.Counter()

    def counted(name, fn, into=plain_calls):
        def call(*args, **kwargs):
            into[name] += 1
            return fn(*args, **kwargs)
        return call
    # No plain (int64) threefry op, no key fill and no plain encoder or
    # pin/LLR assembly on the card's main path.
    plain_fns = [(tr, "_threefry2x32"), (tr, "key_from_data"),
                 (enc, "encode_plain"), (enc, "encode_parts_plain"),
                 (wa, "pin_llr_plain"), (wa, "llr_plain"),
                 (wv, "hash_plain"), (wv, "tail_plain")]
    from qtpu_torch.pipeline import BobSession
    # The encoder's launches whose parts lie off 16-byte alignment (the
    # threads' body): none on the main path.  The verify tail's launches by
    # mode (the kernel's 17th argument).
    off_parts = collections.Counter()
    tail_modes = collections.Counter()

    def launch_spy(library, name, argtypes, counts, dev_, *args,
                   real=_build.launch):
        if library == enc.LIBRARY:
            off_parts[name] += any(p is not None and p % 16
                                   for p in args[:3])
        elif name == "verify_tail":
            tail_modes[("first", "rows")[args[16]]] += 1
        return real(library, name, argtypes, counts, dev_, *args)
    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(_build, "launch", launch_spy))
        for owner, name in plain_fns:
            patches.enter_context(mock.patch.object(
                owner, name, counted(name, getattr(owner, name))))
        for owner, name in ((tr, "draws"), (BobSession, "_on_retry")):
            patches.enter_context(mock.patch.object(
                owner, name, counted(name, getattr(owner, name), made)))
        alice, bob, timed = run_session(cfg, a_src, b_src, dev,
                                        SESSION_WINDOWS, feed_chunk=1 << 23)
    prod = read_launches()
    assert not plain_calls, f"session ran plain versions: {plain_calls}"
    prod_batches = dict(cuda_bp.launch_batches["bp_layered"])
    mets = check_session("session", alice, bob, timed, prod, "bp_layered")
    assert len({m.rate_index for m in mets}) > 1, "no rung switch"
    assert sum(m.blocks_retried for m in mets) > 0, "no retry round"
    per_window = prod["bp_layered"] / len(mets)
    say(f"session layered launches: {prod['bp_layered']} over {len(mets)} "
        f"windows = {per_window:.3f} per window; launches by batch size "
        f"{dict(sorted(prod_batches.items()))}")
    assert prod["threefry_draws"] > 0, "session never launched threefry"
    tf_per_window = threefry_launches(prod) / len(mets)
    # One launch a draw table, one table a program call that draws:
    # Alice's, Bob's and both parties' PA in a window, and each retry's.
    tf_limit = THREEFRY_PER_WINDOW * len(mets) + made["_on_retry"]
    assert prod["threefry_draws"] == made["draws"], (prod, made)
    assert threefry_launches(prod) <= tf_limit, (prod, made, len(mets))
    say(f"session threefry launches: {threefry_launches(prod)} over "
        f"{len(mets)} windows = {tf_per_window:.3f} per window (<= "
        f"{THREEFRY_PER_WINDOW} a window + {made['_on_retry']} retry "
        f"rounds = {tf_limit}; {made['draws']} draw tables; "
        + ", ".join(f"{k} {prod[k] / len(mets):.3f}" for k in tr.launches)
        + "); no plain threefry op, no key fill")
    wk_per_window = check_window_kernels("session", prod, len(mets),
                                         retried=True)
    assert off_parts["qc_encode"] == 0, off_parts
    say(f"session qc_encode: all {prod['qc_encode']} launches had 16-byte "
        f"aligned parts (the bulk body)")
    # Each Bob decode ends in one tail launch: the first decode's a window,
    # the rows merge a retry round; Alice hashes once a window.
    assert tail_modes["first"] >= len(mets) and sum(tail_modes.values()) \
        == prod["verify_tail"], (tail_modes, prod, len(mets))
    assert 0 < tail_modes["rows"] <= made["_on_retry"], (tail_modes, made)
    assert prod["verify_hash"] >= len(mets), prod
    say(f"session verify: {prod['verify_hash']} hash and "
        f"{prod['verify_tail']} tail launches over {len(mets)} windows "
        f"(tail by mode {dict(tail_modes)}, {made['_on_retry']} retry "
        f"rounds); no plain hash or tail")
    del alice, bob, a_src, b_src

    # 7. the min-sum session (flooding decoder) on this card, at 5c's
    # ms_cfg
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
    check_window_kernels("minsum session", ms_launches, len(ms_mets))
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
    check_window_kernels("chain", chain_launches, len(bob.ec.metrics))
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
    two_launches, two_threefry, two_window = two_process_phase(dev,
                                                               timeout=300)

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

    # 19. the scaling curve, as a subprocess
    scaling_launches = scaling_phase(8, timeout=300)

    # 5d, traced part (a profiler trace before phase 13's breaks its own)
    verify_traced_phase(dev, cfg, probe, verified)

    def path_launches(kernel):
        return {f"launches_{name}": counts[kernel]
                for name, counts in measured.items()}

    tf_paths = {
        "session": prod, "minsum_session": ms_launches,
        "chain": chain_launches, "stream_pa_session": st_launches,
        "cli_demo": demo_launches, "cli_fer": fer_launches,
        "mesh_session": mesh_launches,
        "mesh_stream_pa_session": mst_launches,
        **{f"bench_{k}": v for k, v in bench_launches.items()}, **measured}
    seed, offsets, chunk = draws["pa_seed"], draws["offsets"], draws["hash"]
    vtail = verified["tail"]
    encoder, pins, llr8 = (assembled["qc_encode"], assembled["pin_llr"],
                           assembled["llr_8"])
    wk_paths = {name: window_kernel_launches(counts)
                for name, counts in tf_paths.items()}

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
        "launches_per_window_scaling": {str(d): n for d, n
                                        in scaling_launches.items()},
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
           for f in ("ms", "device_ms", "bound_ms")}}, {
        "name": "threefry", "route": "cuda",
        "source": "qtpu_torch/csrc/threefry.cu",
        "replaces": "qtpu/window_programs.py:280-308",
        "launches": threefry_launches(prod),
        "launches_by_entry": {k: prod[k] for k in tr.launches},
        **{f"launches_{name}": threefry_launches(counts)
           for name, counts in tf_paths.items()},
        "launches_two_processes": two_threefry,
        "launches_per_window": round(tf_per_window, 4),
        "max_abs_err": max(d.err for d in draws.values()),
        "ms": round(seed.ms, 4), "device_ms": round(seed.device_ms, 4),
        "plain_ms": round(seed.plain_ms, 2),
        "bound_ms": round(seed.bound_ms, 5), "bound_by": seed.bound_by,
        "library_ms": None,
        "timed": "draws: the PA seed at the production rung",
        **{f"{f}_{entry}": float(f"{getattr(d, f):.4g}")
           for entry, d in (("offsets", offsets), ("hash", chunk),
                            ("alice_table", draws["alice_table"]),
                            ("bob_table", draws["bob_table"]))
           for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "bound_by_offsets": offsets.bound_by,
        "bound_by_hash": chunk.bound_by}, {
        "name": "qc_encode", "route": "cuda",
        "source": "qtpu_torch/csrc/qc_encode.cu",
        "replaces": "qtpu/window_programs.py:269-278",
        "replaces_also": ["qtpu/window_programs.py:389-400",
                          "qtpu/ldpc/encode.py:34-52"],
        "launches": prod["qc_encode"],
        **{f"launches_{name}": n[0] for name, n in wk_paths.items()},
        "launches_two_processes": two_window[0],
        "launches_per_window": wk_per_window["qc_encode"],
        "max_abs_err": float(encoder.err), "ms": round(encoder.ms, 4),
        "device_ms": round(encoder.device_ms, 4),
        "plain_ms": round(encoder.plain_ms, 2),
        "bound_ms": round(encoder.bound_ms, 5),
        "bound_by": encoder.bound_by, "library_ms": None,
        "timed": "the rung a 3% prior selects, B = 128",
        "shapes": {label: {"ms": round(d.ms, 4),
                           "device_ms": round(d.device_ms, 4),
                           "bound_ms": round(d.bound_ms, 5),
                           "bound_by": d.bound_by, **plan}
                   for label, (d, plan)
                   in assembled["qc_encode_shapes"].items()}}, {
        "name": "pin_llr", "route": "cuda",
        "source": "qtpu_torch/csrc/pin_llr.cu",
        "replaces": "qtpu/window_programs.py:345-362",
        "replaces_also": ["qtpu/window_programs.py:423-453",
                          "qtpu/window_programs.py:455-471"],
        "launches": prod["pin_llr"] + prod["llr"],
        "launches_by_entry": {k: prod[k] for k in wa.launches},
        **{f"launches_{name}": n[1] for name, n in wk_paths.items()},
        "launches_two_processes": two_window[1],
        "launches_per_window": round(wk_per_window["pin_llr"]
                                     + wk_per_window["llr"], 3),
        "max_abs_err": float(max(pins.err, llr8.err)),
        "ms": round(pins.ms, 4), "device_ms": round(pins.device_ms, 4),
        "plain_ms": round(pins.plain_ms, 2),
        "bound_ms": round(pins.bound_ms, 5), "bound_by": pins.bound_by,
        "library_ms": None,
        "timed": "pin_llr: Bob's first decode at the rung a 3% prior "
                 "selects, B = 128",
        "device_ms_inputs_off_alignment":
            round(assembled["pin_llr_off"].device_ms, 4),
        **{f"{f}_llr_8_rows": float(f"{getattr(llr8, f):.4g}")
           for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "bound_by_llr_8_rows": llr8.bound_by}, {
        "name": "verify", "route": "cuda",
        "source": "qtpu_torch/csrc/verify.cu",
        "replaces": "qtpu/window_programs.py:364-387",
        "replaces_also": ["qtpu/window_programs.py:473-481",
                          "qtpu/window_programs.py:553-563",
                          "qtpu/window_programs.py:598-618"],
        "launches": prod["verify_hash"] + prod["verify_tail"],
        "launches_by_entry": {k: prod[k] for k in wv.launches},
        **{f"launches_{name}": n[2] for name, n in wk_paths.items()},
        "launches_two_processes": two_window[2],
        "launches_per_window": round(wk_per_window["verify_hash"]
                                     + wk_per_window["verify_tail"], 3),
        "max_abs_err": float(max(d.err for d in verified.values()
                                 if isinstance(d, Draw))),
        "ms": round(vtail.ms, 4), "device_ms": round(vtail.device_ms, 4),
        "plain_ms": round(vtail.plain_ms, 2),
        "bound_ms": round(vtail.bound_ms, 5), "bound_by": vtail.bound_by,
        "library_ms": None,
        "timed": "verify_tail: Bob's first decode at the rung a 3% prior "
                 "selects, B = 128",
        **{f"{f}_{k}": float(f"{getattr(verified[k], f):.4g}")
           for k in ("hash", "tail_off", "tail_shard", "retry",
                     "retry_all", "tail_b1", "tail_b8", "hash_b1",
                     "hash_b8")
           for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
        **{f"bound_by_{k}": verified[k].bound_by
           for k in ("hash", "retry", "retry_all", "tail_b1", "hash_b1")},
        "library_ms_hash": round(verified["hash_chain"][1], 4),
        "plan_sweeps_device_ms": {k: {p: round(ms, 5) for p, ms in v.items()}
                                  for k, v in verified["sweeps"].items()},
        "library_call_hash": "the float32 cuBLAS chain verify_hash "
                             "replaces (hash_plain), device ms"}]}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# Phase 5d alone in a process, for a tree given as its argument: only
# functions both this tree's chip_smoke.py and its parent's have.
VERIFY_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from qtpu_torch import _build
from qtpu_torch import window_verify as wv
from qtpu_torch.link import make_direct_pair
from qtpu_torch.pipeline import BobSession, PipelineConfig, production_config
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
_build.build(wv.LIBRARY)
_build.load(wv.LIBRARY)
cs.say("build: " + " | ".join(cs.ptxas_summary(_build.build_log(wv.LIBRARY))))
cfg = production_config()
probe = BobSession(cfg, 0x5E55, make_direct_pair()[1], device=dev)
ms_probe = BobSession(PipelineConfig(
    n=4096, family="mixed", alg="minsum", blocks_per_window=1024,
    qber_test_bits=8192, stream_capacity_bits=1 << 25), 0x5E55,
    make_direct_pair()[1], device=dev)
verified = cs.verify_phase(dev, cfg, probe, ms_probe)
cs.verify_traced_phase(dev, cfg, probe, verified)
"""

TIMED_LINE = re.compile(r"^(verify_\w+) (.*?)(?: \| plan (.*?))?: .*"
                        r"device_ms=([\d.]+).*share_of_bound ([\d.]+)")


def verify_against(other: str) -> int:
    """``--verify-against DIR``: phase 5d of the tree at DIR and of this
    one in turns, each in its own process (see the module docstring)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    say(nvidia_smi())
    log_dir = ROOT / "build" / "chip_smoke"
    log_dir.mkdir(parents=True, exist_ok=True)
    trees = [("parent", Path(other).resolve()), ("change", ROOT)]
    with open(log_dir / "verify_against.log", "w") as log:
        for run, (tag, root) in enumerate(trees + trees[::-1]):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", VERIFY_CHILD, str(root)], cwd=root,
                env=dict(__import__("os").environ, PYTHONPATH=str(root)),
                capture_output=True, text=True, timeout=900)
            log.write(f"### {tag} run {run + 1} rc={proc.returncode}\n"
                      f"{proc.stdout}{proc.stderr}\n")
            if proc.returncode != 0:
                say(f"{tag} run {run + 1} failed: {proc.stderr[-3000:]}")
                return 1
            for ln in proc.stdout.splitlines():
                m = TIMED_LINE.match(ln)
                if ln.startswith("build:"):
                    say(f"{tag} run {run + 1} {ln[:600]}")
                elif m:
                    say(f"{tag} run {run + 1} {m[1]} {m[2]}: device_ms "
                        f"{m[4]} share {m[5]}" + (f" [{m[3]}]" if m[3]
                                                  else ""))
            say(f"{tag} run {run + 1}: {time.perf_counter() - t:.1f} s")
    say(nvidia_smi())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3])))
    if sys.argv[1:2] == ["--verify-against"]:
        sys.exit(verify_against(sys.argv[2]))
    sys.exit(main())
