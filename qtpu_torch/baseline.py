"""The BASELINE configs and the efficiency sweep.

Counterparts of ``benchmarks/config1_smoke.py``, ``config2_batch.py``,
``config3_rate_adaptive.py``, ``config5_multihost.py`` (with its worker,
``tests/multihost_worker.py``) and ``benchmarks/efficiency.py``:

    python -m qtpu_torch.baseline config1
    python -m qtpu_torch.baseline config2 [--device cuda|cpu]
    python -m qtpu_torch.baseline config3 [--device cuda|cpu]
    python -m qtpu_torch.baseline config5 [--port PORT] [--device cuda|cpu]
    python -m qtpu_torch.baseline efficiency [n [blocks_per_window] |
                                              production] [--device cuda|cpu]

Each config is a function that returns the reference's dict, with the
reference's keys; ``main`` prints it as one JSON line and adds
``"device"`` (the card's name and power limit from nvidia-smi, or "cpu"),
``"launches"`` (each BP kernel's launches over the run) and
``"threefry_launches"`` (each threefry entry point's).  Every input is
drawn with numpy from the reference script's own seeds, so both packages
see the same bits.

- config1: the golden model (``qtpu_torch.ldpc.golden``) on one regular
  n = 4096 block at QBER 2%; BASELINE's "(CPU)" config, numpy on the CPU.
- config2: the layered decoder on B blocks of a regular n = 4096 code,
  60 iterations, QBER 1-5%: Gbit/s (B·n over the time of one call), mean
  and p99 iterations, FER, and the call's ms; B = 1024 and 20 timed calls
  on a card (the layered kernel), 32 and 2 on the CPU.  Every timed region
  starts and ends with ``torch.cuda.synchronize``.
- config3: ``measure_fer`` (flooding min-sum; the flooding kernel on a
  card) on every rung of the n = 4096 mixed ladder at its calibrated QBER
  ceiling, 256 blocks, seed = rung index.
- config5: two processes (``--config5-worker RANK PORT``) joined over gloo
  on 127.0.0.1, each owning 4 of 8 shards of Bob's window program (regular
  n = 1024, B = 16, flooding min-sum, 20 iterations), with Alice's side
  computed locally in each; each checks the reference's four ledger
  identities and prints its psum'd ledger.  gloo, because NCCL refuses two
  ranks on one card.
- efficiency: ``run_loopback`` at QBER 1/2/3/5/7% over
  max(800,000, 8·B·n) sifted bits each: f, secret fraction, failed blocks,
  windows, mean iterations and wall seconds (plus the final bits the ledger
  counts and the key bits emitted); the keys of the two parties must be
  identical.

Every config but config1 runs on ``cuda`` unless ``--device cpu`` is given,
and fails without a card.  A config that fails makes the command fail.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qtpu_torch.devices import (DEFAULT_DEVICE, device_name, entry_device,
                                resolve_device)
from qtpu_torch import random as tr
from qtpu_torch.ldpc import cuda_bp

__all__ = ["config1", "config2", "config2_inputs", "config3", "config5",
           "config5_window", "config5_worker", "efficiency", "h2", "main"]

ROOT = Path(__file__).resolve().parent.parent
CONFIG2_QBERS = (0.01, 0.02, 0.03, 0.04, 0.05)
CONFIG2_ITERS = 60
CONFIG5_SHARDS = 8              # 4 in each of the two processes
EFFICIENCY_QBERS = (0.01, 0.02, 0.03, 0.05, 0.07)


def _threefry_since(before: dict) -> dict:
    """Each threefry entry point's launches since the counts were
    ``before``."""
    return {k: v - before[k] for k, v in tr.launches.items()}


def _launches_since(before: dict) -> dict:
    """Each BP kernel's launches since the counts were ``before``."""
    return {k: v - before[k] for k, v in cuda_bp.launches.items()}


def config1() -> dict:
    """BASELINE config 1: the golden model's min-sum on one regular
    rate-1/2 n = 4096 block through a BSC(2%), 60 iterations, numpy seed
    1, on the CPU."""
    from qtpu_torch.ldpc import golden
    from qtpu_torch.ldpc.codes import make_regular_code
    code = make_regular_code(4096)
    rng = np.random.default_rng(1)
    key = rng.integers(0, 2, code.n).astype(np.uint8)
    bob = key ^ (rng.random(code.n) < 0.02).astype(np.uint8)
    llr = golden.channel_llr(bob, 0.02).reshape(code.nb, code.z)
    syn = golden.encode_syndrome(code, key)
    t0 = time.perf_counter()
    res = golden.decode(code, llr, syn, max_iters=60, alg="minsum")
    dt = time.perf_counter() - t0
    return {"config": 1, "converged": bool(res.converged),
            "iterations": int(res.iterations),
            "key_exact": bool(np.array_equal(res.bits.reshape(-1), key)),
            "decode_s": round(dt, 4)}


def config2_inputs(code, batch: int, device) -> list:
    """[(qber, llr (B, n) float32, syndrome (B, m) uint8)] of config 2 on
    ``device``, one per QBER of the sweep, in the reference's draw order
    from numpy seed 0: per QBER the keys, then the BSC flips."""
    from qtpu_torch.ldpc.decode import channel_llr
    from qtpu_torch.ldpc.encode import make_batch_encoder
    enc = make_batch_encoder(code)
    rng = np.random.default_rng(0)
    out = []
    for q in CONFIG2_QBERS:
        keys = rng.integers(0, 2, (batch, code.n)).astype(np.uint8)
        bob = keys ^ (rng.random((batch, code.n)) < q).astype(np.uint8)
        syn = enc(torch.from_numpy(keys).to(device)).contiguous()
        llr = channel_llr(torch.from_numpy(bob).to(device), q).contiguous()
        out.append((q, llr, syn))
    return out


def config2(device=DEFAULT_DEVICE, n: int = 4096, batch: int | None = None,
            reps: int | None = None) -> dict:
    """BASELINE config 2: B concurrent blocks of a regular n-bit code,
    layered min-sum, 60 iterations, QBER 1-5%.  Per QBER: one warm call,
    then ``reps`` calls timed between two synchronizes.  Each row also
    holds the calls' ms, the iterations' sum (for the bound) and the BP
    kernels' launches over its reps + 1 calls."""
    from qtpu_torch.bench import _sync
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.ldpc.decode import make_batch_decoder
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    B = batch or (1024 if on_card else 32)
    reps = reps or (20 if on_card else 2)
    code = make_regular_code(n)
    dec = make_batch_decoder(code, max_iters=CONFIG2_ITERS, alg="layered")
    rows = []
    for q, llr, syn in config2_inputs(code, B, dev):
        before = dict(cuda_bp.launches)
        dec(llr, syn)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            res = dec(llr, syn)
        _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        iters = res.iterations.cpu().numpy()
        rows.append({
            "qber": q, "gbit_s": round(B * code.n / dt / 1e9, 3),
            "iters_mean": round(float(iters.mean()), 2),
            "iters_p99": int(np.percentile(iters, 99)),
            "fer": 1.0 - float(res.converged.cpu().numpy().mean()),
            "ms": round(dt * 1e3, 4), "iters_sum": int(iters.sum()),
            "launches": _launches_since(before)})
    return {"config": 2, "batch": B, "sweep": rows}


def config3(device=DEFAULT_DEVICE, n: int = 4096, blocks: int = 256) -> dict:
    """BASELINE config 3: the FER and mean iterations of every rung of the
    n-bit mixed ladder at its calibrated QBER ceiling (``measure_fer``:
    flooding min-sum, 60 iterations, seed = rung index), with each rung's
    BP kernel launches."""
    from qtpu_torch.ldpc.calibrate import measure_fer
    from qtpu_torch.ldpc.codes import make_rate_ladder
    dev = resolve_device(device)
    ladder = make_rate_ladder(n)
    rows = []
    for idx, step in enumerate(ladder.steps):
        q = ladder.max_qber[idx] if ladder.max_qber else 0.02
        if q <= 0:
            continue
        before = dict(cuda_bp.launches)
        fer, iters = measure_fer(step, q, blocks=blocks, seed=idx, device=dev)
        rows.append({
            "rung": step.name, "rate_eff": round(step.effective_rate(), 4),
            "qber": q, "fer": round(fer, 4), "iters_mean": round(iters, 1),
            "leak_per_payload": round(step.leaked_bits()
                                      / step.payload_bits(), 4),
            "launches": _launches_since(before)})
    return {"config": 3, "rungs": rows}


def config5_window(dev: torch.device, mesh) -> list:
    """The psum'd ledger (a list of ints in ``LEDGER_FIELDS`` order) of one
    window of Bob's program sharded over ``mesh``, on config 5's inputs
    (``tests/multihost_worker.py``): regular n = 1024, B = 16, k_pb = 8,
    flooding min-sum, 20 iterations, l_max = 128, s_max = 32, numpy seed 0
    at QBER 2%, the window key of root 3 and the puncture key of root 7.
    Alice's side runs unsharded on ``dev``.  Raises RuntimeError unless the
    reference's four ledger identities hold."""
    from qtpu_torch import prng
    from qtpu_torch.accounting import LEDGER_FIELDS
    from qtpu_torch.ldpc.codes import make_regular_code
    from qtpu_torch.stream import DeviceStream
    from qtpu_torch.window_programs import (choose_affine, make_header,
                                            make_window_programs)
    code = make_regular_code(1024)
    pay = np.arange(code.n, dtype=np.int64)
    empty = np.zeros(0, np.int64)
    B, k_pb = 16, 8
    kwargs = dict(max_iters=20, alg="minsum", verify_hash_bits=64, l_max=128,
                  batch=B, k_pb=k_pb, s_max=32, device=dev)
    progs = make_window_programs(code, pay, empty, empty, mesh=mesh, **kwargs)
    local = make_window_programs(code, pay, empty, empty, **kwargs)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    bob = keys ^ (rng.random((B, code.n)) < 0.02).astype(np.uint8)
    wkey = prng.key_data(prng.derive(prng.root_key(3), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(7), "punct", 0))
    a, ainv = choose_affine(iter([7]), code.n)
    header = make_header(0, 0, wkey, pkey, test_bits_pb=k_pb,
                         affine=(a, ainv, 3))
    sa = DeviceStream(1 << 16, device=dev)
    sb = DeviceStream(1 << 16, device=dev)
    sa.push(keys.reshape(-1))
    sb.push(bob.reshape(-1))
    _, syn, hashes, test, short = local.alice(sa.arena, header)
    out = progs.bob(sb.arena, header, test, short, syn, hashes,
                    np.float32(np.log(0.98 / 0.02)))
    gl = out[5].cpu().tolist()
    f = {name: i for i, name in enumerate(LEDGER_FIELDS)}
    checks = {"syndrome_bits == B·m": gl[f["syndrome_bits"]] == B * code.m,
              "qber_test_bits == B·k_pb": gl[f["qber_test_bits"]] == B * k_pb,
              "blocks_ok + blocks_failed == B":
                  gl[f["blocks_ok"]] + gl[f["blocks_failed"]] == B,
              "blocks_ok == B (all verify at 2%)": gl[f["blocks_ok"]] == B}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"config 5 ledger {gl}: {', '.join(failed)} fails")
    return gl


def config5_worker(rank: int, port: int, device=DEFAULT_DEVICE) -> int:
    """``--config5-worker RANK PORT``: one of config 5's two processes.
    Joins the other over gloo at 127.0.0.1:PORT, owns shards 4·RANK ..
    4·RANK + 3 of 8 on ``device`` and prints the reference worker's
    ``MULTIHOST_OK`` line, then its BP kernel and threefry launches."""
    from qtpu_torch.parallel import init_distributed, make_mesh
    dev = entry_device("qtpu_torch.baseline --config5-worker", device)
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(devices=[dev] * (CONFIG5_SHARDS // 2))
        before, tf_before = dict(cuda_bp.launches), dict(tr.launches)
        gl = config5_window(dev, mesh)
        launches = _launches_since(before)
        threefry = _threefry_since(tf_before)
    finally:
        torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK proc={rank} ledger={gl}", flush=True)
    print("launches: " + json.dumps(launches), flush=True)
    print("threefry launches: " + json.dumps(threefry), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def config5(device=DEFAULT_DEVICE, port: int | None = None,
            timeout: float = 600) -> dict:
    """BASELINE config 5: two worker processes on ``device`` joined at
    127.0.0.1:``port`` (a free port by default); ``ok`` when both exit 0
    with their ledger line, ``ledgers_agree`` when the two psum'd ledgers
    are equal, ``global_ledger`` the first one (as the worker printed it),
    ``launches`` the BP kernel launches of both and ``threefry_launches``
    their threefry launches.  A worker that fails has
    its output written to stderr."""
    dev = resolve_device(device)
    port = _free_port() if port is None else port
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "qtpu_torch.baseline",
                 "--config5-worker", str(rank), str(port), "--device",
                 str(dev)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 and "MULTIHOST_OK" in o
             for p, o in zip(procs, outs))
    if not ok:
        for rank, o in enumerate(outs):
            print(f"config5 worker {rank}:\n{o[-3000:]}", file=sys.stderr)
    ledgers = [ln.split("ledger=")[1] for o in outs for ln in o.splitlines()
               if "MULTIHOST_OK" in ln]
    counts = {"launches: ": {k: 0 for k in cuda_bp.launches},
              "threefry launches: ": {k: 0 for k in tr.launches}}
    for o in outs:
        for ln in o.splitlines():
            for head, total in counts.items():
                if ln.startswith(head):
                    for k, v in json.loads(ln[len(head):]).items():
                        total[k] += v
    return {"config": 5, "ok": ok, "ledgers_agree": len(set(ledgers)) == 1,
            "global_ledger": ledgers[0] if ledgers else None,
            "launches": counts["launches: "],
            "threefry_launches": counts["threefry launches: "]}


def h2(p: float) -> float:
    """Binary entropy in bits."""
    return float(-p * np.log2(p) - (1 - p) * np.log2(1 - p))


def efficiency(device=DEFAULT_DEVICE, n: int = 4096, bpw=64, config=None,
               qbers=EFFICIENCY_QBERS, min_total: int = 800_000) -> dict:
    """Reconciliation efficiency against QBER: the two-party loopback
    protocol (inline QBER estimation, fine rate adaptation, retries, PA)
    on max(``min_total``, 8·B·n) sifted bits per QBER, drawn from numpy
    seed 1 in the order of ``qbers``.  f = syndrome leak / (reconciled
    bits · h2(q)), 1.0 being Shannon's limit; the secret fraction is the
    final bits over the sifted bits consumed.

    The session config: ``config`` when given, else
    ``production_config()`` for ``bpw="production"``, else
    ``PipelineConfig(n=n, blocks_per_window=bpw, qber_test_bits=8192)``.
    Raises RuntimeError when the two parties' keys differ."""
    from qtpu_torch.pipeline import (PipelineConfig, production_config,
                                     run_loopback)
    dev = resolve_device(device)
    if config is None:
        config = (production_config() if bpw == "production" else
                  PipelineConfig(n=n, blocks_per_window=bpw,
                                 qber_test_bits=8192))
    n, bpw = config.n, config.blocks_per_window
    rng = np.random.default_rng(1)
    rows = []
    for q in qbers:
        total = max(min_total, 8 * bpw * n)
        a_bits = rng.integers(0, 2, total).astype(np.uint8)
        b_bits = a_bits ^ (rng.random(total) < q).astype(np.uint8)
        before = dict(cuda_bp.launches)
        t0 = time.perf_counter()
        alice, bob = run_loopback(config, a_bits, b_bits, device=dev)
        ka, kb = alice.final_key_bits(), bob.final_key_bits()
        if not (ka.size == kb.size and (ka == kb).all()):
            raise RuntimeError(f"efficiency at QBER {q}: keys differ")
        led = alice.ledger
        consumed = led.sifted_bits - alice.stream.remaining
        rows.append({
            "qber": q,
            "f": round(led.syndrome_bits / max(1, led.reconciled_bits)
                       / h2(q), 3),
            "secret_fraction": round(led.final_bits / max(1, consumed), 4),
            "blocks_failed": int(led.blocks_failed),
            "windows": len(bob.metrics),
            "mean_iters": round(float(np.mean([m.iters_mean
                                               for m in bob.metrics])), 1),
            "wall_s": round(time.perf_counter() - t0, 1),
            "final_bits": int(led.final_bits), "key_bits": int(ka.size),
            "launches": _launches_since(before)})
    return {"config": "efficiency", "n": n, "blocks_per_window": bpw,
            "rows": rows}


CONFIGS = ("config1", "config2", "config3", "config5", "efficiency")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="qtpu_torch.baseline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", nargs="?", choices=CONFIGS)
    p.add_argument("sizes", nargs="*",
                   help="efficiency: [n [blocks_per_window]] or production")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; fails when CUDA is "
                        "missing)")
    p.add_argument("--port", type=int,
                   help="config5: the rendezvous port (default: a free one)")
    p.add_argument("--config5-worker", nargs=2, type=int,
                   metavar=("RANK", "PORT"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.config5_worker is not None:
        return config5_worker(*args.config5_worker, device=args.device)
    if args.config is None:
        p.error("name a config")
    if args.sizes and args.config != "efficiency":
        p.error(f"{args.config} takes no sizes")
    before, tf_before = dict(cuda_bp.launches), dict(tr.launches)
    if args.config == "config1":
        out, dev = config1(), torch.device("cpu")
    else:
        dev = entry_device("qtpu_torch.baseline", args.device)
        if args.config == "config2":
            out = config2(dev)
        elif args.config == "config3":
            out = config3(dev)
        elif args.config == "config5":
            out = config5(dev, args.port)
        elif args.sizes[:1] == ["production"]:
            out = efficiency(dev, bpw="production")
        else:
            sizes = [int(s) for s in args.sizes] + [4096, 64][len(args.sizes):]
            out = efficiency(dev, n=sizes[0], bpw=sizes[1])
    out.setdefault("launches", _launches_since(before))
    out.setdefault("threefry_launches", _threefry_since(tf_before))
    out["device"] = device_name(dev)
    print(json.dumps(out), flush=True)
    return 0 if out.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
