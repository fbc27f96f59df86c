#!/usr/bin/env python3
"""Drive qtpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root; needs a card

Phases (each prints one flushed line; any failure ends the run non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: the layered-BP kernel from qtpu_torch/csrc/ with nvcc;
3. kernel vs plain PyTorch decoder, bits / iterations / converged equal,
   at a production native3 rung (n = 65536, B = 128 and B = 8) and a
   regular n = 4096 code at B = 256, with both times;
4. the PA FFT's integer margin at the production shape (< 0.25);
5. session: production_config(), Alice and Bob on this card over a direct
   link, fed a BSC(3%) stream generated on the card, for 20 windows —
   identical non-empty keys, equal ledgers, FER <= 0.05, a rung switch, a
   retry round, and the kernel launched by the session;
6. cross-device parity: a small config run on the card and on the CPU with
   identical input gives identical keys, ledgers and per-window metrics.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
QBER = 0.03
SESSION_WINDOWS = 20


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


def kernel_vs_plain(label, code, llr, syn, max_iters, reps):
    """Kernel against the plain decoder on the same card inputs; returns
    (max_abs_err, kernel ms, plain ms, mean iterations)."""
    import torch
    from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
    from qtpu_torch.ldpc.decode import make_layered_decoder
    kern = make_cuda_decoder(code, max_iters)
    plain = make_layered_decoder(code, max_iters)
    torch.cuda.synchronize()
    got = kern(llr, syn)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = plain(llr, syn)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err = max(int((got.bits.int() - ref.bits.int()).abs().max()),
              int((got.iterations - ref.iterations).abs().max()),
              int((got.converged.int() - ref.converged.int()).abs().max()))
    assert err == 0, f"{label}: kernel disagrees with the plain decoder"
    ms = time_cuda(lambda: kern(llr, syn), reps)
    iters = float(ref.iterations.float().mean())
    say(f"kernel {label}: B={llr.shape[0]} n={code.n} max_abs_err={err} "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} iters_mean={iters:.2f} "
        f"converged={int(ref.converged.sum())}/{llr.shape[0]}")
    return err, ms, plain_ms, iters


def run_session(cfg, alice_src, bob_src, device, windows, feed_chunk=None):
    """Both parties on ``device`` over a direct link; the stream is fed in
    chunks as the session consumes it.  Returns (alice, bob, elapsed s of
    the windows after the first two)."""
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import AliceSession, BobSession, pump_sessions
    la, lb = make_direct_pair()
    alice = AliceSession(cfg, 0x5E55, la, device=device)
    bob = BobSession(cfg, 0x5E55, lb, device=device)
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
    t = time.perf_counter()
    pump_until(windows)
    dt = time.perf_counter() - t
    pump_sessions(alice, bob, la, lb)
    return alice, bob, dt


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "qtpu_torch" / "csrc" / "bp_layered.cu").exists():
        print("chip_smoke: run it from the repository (qtpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from qtpu_torch import _build
    from qtpu_torch.ldpc import cuda_bp
    from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
    from qtpu_torch.pipeline import PipelineConfig, production_config
    from qtpu_torch.window_programs import toeplitz_margin

    assert "jax" not in sys.modules
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    say(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t = time.perf_counter()
    _build.load("bp_layered")
    ptx = [ln.strip() for ln in _build.build_log("bp_layered").splitlines()
           if "registers" in ln or "spill" in ln]
    say(f"build: bp_layered in {time.perf_counter() - t:.1f} s | "
        + " | ".join(ptx))

    # 3. kernel vs plain decoder
    cfg = production_config()
    ladder = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                              seed=cfg.code_seed, alg=cfg.alg,
                              family=cfg.family)
    rung, _ = ladder.select_fine(QBER, granularity=cfg.short_granularity)
    step = ladder.steps[rung]
    qb = np.linspace(0.02, 0.04, 128)
    llr, syn = decode_inputs(step.code, 128, qb, 1, dev, step.punct_cols)
    err, ms, plain_ms, _ = kernel_vs_plain(
        f"native3 rung {rung} ({step.name})", step.code, llr, syn,
        cfg.max_iters, reps=5)
    kernel_vs_plain(f"native3 rung {rung} ({step.name})", step.code,
                    llr[:8].contiguous(), syn[:8].contiguous(), cfg.max_iters,
                    reps=5)
    reg = make_regular_code(4096)
    llr4, syn4 = decode_inputs(reg, 256, np.linspace(0.005, 0.06, 256), 2,
                               dev)
    kernel_vs_plain("regular (3,6)", reg, llr4, syn4, cfg.max_iters, reps=5)

    # 4. PA FFT integer margin at the production shape
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

    # 5. the production session on this card
    per_window = cfg.n * cfg.blocks_per_window
    total = (SESSION_WINDOWS + 4) * per_window
    g = torch.Generator(device=dev).manual_seed(7)
    a_src = torch.randint(0, 2, (total,), generator=g, device=dev,
                          dtype=torch.uint8)
    flips = (torch.rand((total,), generator=g, device=dev) < QBER)
    b_src = a_src ^ flips.to(torch.uint8)
    cuda_bp.launches = 0
    alice, bob, dt = run_session(cfg, a_src, b_src, dev, SESSION_WINDOWS,
                                 feed_chunk=1 << 23)
    torch.cuda.synchronize()
    launches = cuda_bp.launches
    ka, kb = alice.final_key_bits(), bob.final_key_bits()
    assert ka.size > 0 and np.array_equal(ka, kb), "final keys differ/empty"
    assert alice.ledger.as_dict() == bob.ledger.as_dict(), "ledgers differ"
    mets = bob.metrics
    fer = 1.0 - sum(m.blocks_ok for m in mets) / sum(m.blocks for m in mets)
    led = bob.ledger
    consumed = led.reconciled_bits + led.discarded_bits
    assert fer <= 0.05, f"FER {fer}"
    assert launches > 0, "the session never launched the kernel"
    assert len({m.rate_index for m in mets}) > 1, "no rung switch"
    retried = sum(m.blocks_retried for m in mets)
    assert retried > 0, "no retry round"
    say(f"session: {len(mets)} windows, window_ms={1e3 * dt / (len(mets) - 2):.2f} "
        f"(windows 3..{len(mets)}) iters_mean="
        f"{np.mean([m.iters_mean for m in mets]):.2f} fer={fer:.5f} "
        f"secret_fraction={led.final_bits / consumed:.4f} "
        f"rungs={sorted({m.rate_index for m in mets})} blocks_retried={retried} "
        f"kernel_launches={launches} key_bits={ka.size}")

    # 6. cross-device parity (CPU vs card, identical input)
    small = PipelineConfig(n=4096, blocks_per_window=16, qber_test_bits=512,
                           max_inflight_windows=1)
    rng = np.random.default_rng(11)
    nbits = 6 * 4096 * 16 + 20_000
    a_np = rng.integers(0, 2, nbits, dtype=np.uint8)
    b_np = a_np ^ (rng.random(nbits) < QBER).astype(np.uint8)
    runs = {}
    for d in ("cpu", dev):
        a, b, _ = run_session(small, a_np, b_np, d, 6)
        runs[str(d)] = (a.final_key_bits(), b.final_key_bits(),
                        a.ledger.as_dict(), b.ledger.as_dict(),
                        [m.as_dict() for m in b.metrics])
    c, g_ = runs["cpu"], runs[str(dev)]
    assert c[0].size > 0
    for x, y in ((c[0], g_[0]), (c[1], g_[1]), (c[0], c[1])):
        assert np.array_equal(x, y), "final keys differ across devices"
    assert c[2] == g_[2] == c[3] == g_[3], "ledgers differ across devices"
    assert c[4] == g_[4], "window metrics differ across devices"
    say(f"parity: cpu == cuda over {len(c[4])} windows, "
        f"{c[0].size} key bits, ledgers and metrics equal")

    say(json.dumps({"kernels": [{
        "name": "bp_layered", "route": "cuda",
        "source": "qtpu_torch/csrc/bp_layered.cu",
        "replaces": "qtpu/ldpc/pallas_bp.py:168",
        "launches": launches, "max_abs_err": float(err),
        "ms": round(ms, 4), "plain_ms": round(plain_ms, 2)}]}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
