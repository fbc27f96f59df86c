"""Scaling curve: full-chain windows/s against the shard count of Bob's mesh.

Counterpart of ``benchmarks/scaling_curve.py``:

    python -m qtpu_torch.scaling [WINDOWS] [--device cuda|cpu]
                                 [--shards 1,2,4,8]

Workload: the reference's (``benchmarks/scaling_curve.py:35-52``).  Both
parties in one process over a direct link, ``PipelineConfig(n=4096,
blocks_per_window=64, qber_test_bits=1024, max_inflight_windows=2,
drain_windows=4, max_retries=0)``, session seed 0x5E55, numpy
``default_rng(0)`` bits through a BSC(2%), (WINDOWS + 7)·n·B of them.
Alice is unsharded; Bob's window program runs on a mesh of D shards
(``qtpu_torch.parallel``), shard i on ``cuda:(i % device_count)``, so on a
one-card machine all D shards share the card, each on a stream of its own
(``Mesh.run_shards``): the counterpart of the reference's 8 virtual CPU
devices sharing one host.  Each point pumps 4 warm-up windows, then
WINDOWS timed (default 8) the way the reference's ``pump_until`` does,
then ``pump_sessions``; Alice's and Bob's final keys must be equal.

Output, per point, one JSON line: ``devices`` (distinct cards),
``shards``, ``windows``, ``elapsed_s``, ``windows_per_s``,
``sifted_bits_per_s``, the layered kernel's launches a timed window, the
final key's bits, ``host`` (as ``qtpu_torch.bench`` reports it) and
``device`` (the card's name and power limit from nvidia-smi, or "cpu").
Then one JSON line of the isolated probes of the reference's round-5
section of ``SCALING.md``, at every D: ``psum_ledger`` of a
(len(LEDGER_FIELDS),) int32 vector alone, and ``make_sharded_decoder``
alone at B = 64 on the curve's rung (the rung Bob chose most at D = 1),
both timed with CUDA events on a card.  The tables go to
``build/qtpu_torch/SCALING.md``; the repository's ``SCALING.md`` is the
reference's output and is never written here.

Every point runs in this one process: torch fixes no device count at
process start (the reference's XLA_FLAGS do), so the reference's
subprocess per point has no reason here.  A point whose keys differ, or
whose run raises, makes the command exit non-zero: nothing falls back.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch

from qtpu_torch import _build
from qtpu_torch.accounting import LEDGER_FIELDS
from qtpu_torch.bench import _host, _sync
from qtpu_torch.devices import DEFAULT_DEVICE, device_name, entry_device
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.decode import channel_llr
from qtpu_torch.ldpc.encode import make_batch_encoder
from qtpu_torch.link import make_direct_pair
from qtpu_torch.parallel import make_mesh, make_sharded_decoder, psum_ledger
from qtpu_torch.pipeline import (AliceSession, BobSession, PipelineConfig,
                                 pump_sessions)

__all__ = ["curve_config", "curve_bits", "shard_devices", "run_point",
           "probe", "write_markdown", "main"]

SESSION_SEED = 0x5E55
QBER = 0.02
WARMUP = 4
SHARDS = (1, 2, 4, 8)
PROBE_BLOCKS = 64
OUT = _build.BUILD_DIR / "SCALING.md"


def curve_config(**overrides) -> PipelineConfig:
    """The reference curve's configuration, with ``overrides``."""
    base = dict(n=4096, blocks_per_window=64, qber_test_bits=1024,
                max_inflight_windows=2, drain_windows=4, max_retries=0)
    base.update(overrides)
    return PipelineConfig(**base)


def curve_bits(config: PipelineConfig, windows: int):
    """(Alice's, Bob's) sifted bits for a point of ``windows`` timed
    windows: (windows + 7)·n·B numpy ``default_rng(0)`` bits, Bob's through
    a BSC(2%), as the reference curve draws them."""
    total = (windows + 7) * config.n * config.blocks_per_window
    rng = np.random.default_rng(0)
    a_bits = rng.integers(0, 2, total).astype(np.uint8)
    return a_bits, a_bits ^ (rng.random(total) < QBER).astype(np.uint8)


def shard_devices(dev: torch.device, shards: int) -> list[torch.device]:
    """Shard i's device: ``cuda:(i % device_count)`` for a card, else
    ``dev`` for every shard."""
    if dev.type != "cuda":
        return [dev] * shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(shards)]


def _pump_until(alice, bob, la, lb, n: int) -> None:
    """The reference curve's pump: until Bob has settled ``n`` windows, a
    blocking flush only when nothing else progressed."""
    for _ in range(10 ** 6):
        if bob.window_id >= n:
            return
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


def run_point(dev: torch.device, shards: int, windows: int = 8,
              warmup: int = WARMUP, config: PipelineConfig | None = None):
    """One point of the curve: ``(row, alice, bob)``, Bob on a mesh of
    ``shards`` shards (``shard_devices``), Alice unsharded on its first
    device.  Raises when the parties' final keys or ledgers differ."""
    cfg = config or curve_config()
    mesh = make_mesh(devices=shard_devices(dev, shards))
    la, lb = make_direct_pair()
    alice = AliceSession(cfg, SESSION_SEED, la, device=mesh.devices[0])
    bob = BobSession(cfg, SESSION_SEED, lb, mesh=mesh)
    B = cfg.blocks_per_window
    a_bits, b_bits = curve_bits(cfg, windows)
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    _pump_until(alice, bob, la, lb, warmup)
    for d in set(mesh.devices):
        _sync(d)
    before = cuda_bp.launches["bp_layered"]
    t0 = time.perf_counter()
    _pump_until(alice, bob, la, lb, warmup + windows)
    for d in set(mesh.devices):
        _sync(d)
    dt = time.perf_counter() - t0
    done = bob.window_id - warmup
    launches = cuda_bp.launches["bp_layered"] - before
    pump_sessions(alice, bob, la, lb)
    key = bob.final_key_bits()
    if not np.array_equal(alice.final_key_bits(), key):
        raise RuntimeError(f"{shards} shards: Alice's and Bob's final keys "
                           f"differ")
    if alice.ledger.as_dict() != bob.ledger.as_dict():
        raise RuntimeError(f"{shards} shards: the parties' ledgers differ")
    row = {"devices": len(set(mesh.devices)), "shards": shards,
           "windows": done, "elapsed_s": dt, "windows_per_s": done / dt,
           "sifted_bits_per_s": done * cfg.n * B / dt,
           "bp_layered_per_window": launches / done,
           "final_key_bits": int(key.size), "keys_equal": True,
           "host": _host(), "device": device_name(dev)}
    return row, alice, bob


def _time_ms(fn, dev: torch.device, reps: int) -> float:
    """ms a call of ``fn``: CUDA events over ``reps`` calls after one
    untimed call on a card, the host clock over ``reps`` calls on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _decode_inputs(step, dev: torch.device, B: int):
    """B random codewords of ``step``'s code through a BSC(2%): channel
    LLRs (punctured columns at 0) and the codewords' syndromes."""
    code = step.code
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 2, (B, code.n),
                                         dtype=np.uint8)).to(dev)
    noise = torch.from_numpy((rng.random((B, code.n)) < QBER)
                             .astype(np.uint8)).to(dev)
    llr = channel_llr(keys ^ noise, QBER)
    for c in step.punct_cols:
        llr[:, c * code.z:(c + 1) * code.z] = 0.0
    return llr.contiguous(), make_batch_encoder(code)(keys).contiguous()


def probe(dev: torch.device, shards: int, step, config: PipelineConfig,
          reps: tuple[int, int] = (200, 10)) -> dict:
    """The isolated probes at ``shards`` shards: ms of ``psum_ledger`` of
    one (len(LEDGER_FIELDS),) int32 vector a shard, and of one
    ``make_sharded_decoder`` call on PROBE_BLOCKS blocks of ``step``'s
    code; ``reps`` calls each."""
    mesh = make_mesh(devices=shard_devices(dev, shards))
    vecs = [torch.ones(len(LEDGER_FIELDS), dtype=torch.int32, device=d)
            for _, d in mesh.local_shards()]
    decode = make_sharded_decoder(step.code, mesh, config.max_iters,
                                  config.alg)
    llr, syn = _decode_inputs(step, mesh.devices[0], PROBE_BLOCKS)
    return {"shards": shards, "devices": len(set(mesh.devices)),
            "psum_ms": _time_ms(lambda: psum_ledger(vecs, mesh), dev,
                                reps[0]),
            "decode_ms": _time_ms(lambda: decode(llr, syn), dev, reps[1])}


def write_markdown(rows: list, probes: dict, windows: int,
                   path=OUT) -> None:
    """The curve's and the probes' tables, as Markdown, to ``path``
    (under ``build/qtpu_torch/``)."""
    base = rows[0]["windows_per_s"]
    md = [
        "# Scaling (qtpu_torch): full-chain windows/s against Bob's shards",
        "",
        f"Written by `python -m qtpu_torch.scaling {windows}` on "
        f"{rows[0]['device']} (host: {rows[0]['host']['cpu']}).  The "
        "reference's curve is `benchmarks/scaling_curve.py`, whose output "
        "is the repository's `SCALING.md` (a forced-CPU mesh).",
        "",
        "Workload: the reference's.  n = 4096 mixed ladder, 64-block "
        "windows, QBER 2%, both parties in one process, Alice unsharded, "
        f"Bob's window program on D shards; {windows} timed windows after "
        f"{WARMUP}.  Shard i runs on card i % (cards), each shard on a "
        "CUDA stream of its own; where D exceeds the cards, shards share "
        "a card, as the reference's virtual devices share one host.",
        "",
        "| shards | devices | windows/s | vs 1 shard | sifted bits/s | "
        "layered launches a window |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        md.append(f"| {r['shards']} | {r['devices']} | "
                  f"{r['windows_per_s']:.3f} | "
                  f"{r['windows_per_s'] / base:.2f}x | "
                  f"{r['sifted_bits_per_s']:.0f} | "
                  f"{r['bp_layered_per_window']:.2f} |")
    md += [
        "",
        "## The isolated probes",
        "",
        f"Rung {probes['rung']} (the rung Bob chose most at D = "
        f"{rows[0]['shards']}); ms a call: "
        + ("CUDA events." if rows[0]["device"] != "cpu" else
           "the host clock (a CPU run: no device time)."),
        "",
        "| shards | psum alone (ledger-size) ms | sharded decode alone "
        f"(B={PROBE_BLOCKS}) ms |",
        "|---|---|---|",
    ]
    for p in probes["probes"]:
        md.append(f"| {p['shards']} | {p['psum_ms']:.4f} | "
                  f"{p['decode_ms']:.3f} |")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(md) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="qtpu_torch.scaling", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("windows", nargs="?", type=int, default=8,
                   help="timed windows a point (default 8)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; fails when CUDA is "
                        "missing)")
    p.add_argument("--shards", default=",".join(map(str, SHARDS)),
                   help="comma-separated shard counts (default 1,2,4,8)")
    args = p.parse_args(argv)
    try:
        shards = [int(s) for s in args.shards.split(",")]
    except ValueError:
        p.error(f"--shards {args.shards!r}: not a list of integers")
    cfg = curve_config()
    if args.windows < 1 or any(d < 1 or cfg.blocks_per_window % d
                               for d in shards):
        p.error(f"need WINDOWS >= 1 and shard counts that divide "
                f"{cfg.blocks_per_window} blocks")
    dev = entry_device("qtpu_torch.scaling", args.device)
    rows, rung = [], None
    for d in shards:
        row, _, bob = run_point(dev, d, args.windows, config=cfg)
        if rung is None:
            rung = collections.Counter(
                m.rate_index for m in bob.metrics).most_common(1)[0][0]
        rows.append(row)
        print(json.dumps(row), flush=True)
    step = bob.ladder.steps[rung]
    reps = (200, 10) if dev.type == "cuda" else (2, 1)
    probes = {"rung": rung, "blocks": PROBE_BLOCKS,
              "probes": [probe(dev, d, step, cfg, reps) for d in shards]}
    print(json.dumps(probes), flush=True)
    write_markdown(rows, probes, args.windows)
    print(f"wrote {OUT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
