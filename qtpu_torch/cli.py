"""Command-line interface of qtpu_torch (counterpart of ``qtpu/cli.py``).

    python -m qtpu_torch.cli demo       # full chain, both parties in-process
    python -m qtpu_torch.cli alice ...  # source-side party over TCP
    python -m qtpu_torch.cli bob ...    # receiver-side party over TCP
    python -m qtpu_torch.cli bench      # judge-metric benchmark (one JSON line)
    python -m qtpu_torch.cli calibrate  # re-measure rate-ladder QBER ceilings
    python -m qtpu_torch.cli fer        # FER of one ladder rung at one QBER
    python -m qtpu_torch.cli cascade    # Cascade golden model vs the ladder

``--device`` (default ``cuda``) is where every device-side step runs: the
sifting, the window programs and the BP decoders (the Hopper kernels on a
CUDA device).  When CUDA is missing the command fails; it never carries on
on the CPU unless ``--device cpu`` asks for it.

Two-process mode (`alice`/`bob`) carries the full protocol over a real TCP
socket (the transferd role).  Without quantum hardware both processes
simulate the same entangled source from a shared source seed, each keeping
its own party's detector events — the classical channel then behaves exactly
as deployed.  Both parties may share one card: each process builds or loads
the kernels on its own, through per-process temporary files.  The wire
format is the reference's, so either party may be a ``qtpu`` process.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from qtpu_torch.config import RunConfig, apply_overrides, load_config


def _build_chain_parts(cfg: RunConfig):
    from qtpu_torch.channel import EntangledPairSource

    s = cfg.source
    src = EntangledPairSource(
        pair_rate_hz=s.pair_rate_hz, window_s=s.window_s,
        offset_ns=s.offset_ns, jitter_ns=s.jitter_ns,
        eta_alice=s.eta_alice, eta_bob=s.eta_bob,
        dark_rate_hz=s.dark_rate_hz, error_rate=s.error_rate)
    return src


def _device(name: str):
    """The torch device named by ``--device``; fails when it is a CUDA
    device and CUDA is missing."""
    from qtpu_torch.devices import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError:
        raise SystemExit(f"qtpu_torch: --device {name}: CUDA is not "
                         f"available (pass --device cpu to run on the CPU)")


def cmd_demo(cfg: RunConfig, args) -> int:
    from qtpu_torch.chain import run_chain_loopback
    from qtpu_torch.metrics import MetricsLogger, RateMeter

    log = MetricsLogger(path=cfg.metrics_path or None)
    meter = RateMeter()
    src = _build_chain_parts(cfg)
    import time as _time
    t0 = _time.time()
    alice, bob = run_chain_loopback(cfg.chain, num_windows=cfg.num_windows,
                                    source=src, seed=cfg.source.seed,
                                    session_seed=cfg.session_seed,
                                    device=args.device)
    for s in bob.sift_stats:
        log.log("sift", **s)
    for m in bob.ec.metrics:
        log.window(m)
        meter.add(m.final_bits)
    ka, kb = alice.ec.final_key_bits(), bob.ec.final_key_bits()
    ok = np.array_equal(ka, kb)
    st = bob.sift_stats
    summary = {
        "windows": bob.ec.window_id,
        "final_key_bits": int(len(ka)),
        "keys_identical": bool(ok),
        "acquired_offset_units": bob.offset,
        "final_bits_per_s_wallclock": round(meter.total_bits
                                            / max(1e-9, _time.time() - t0), 1),
        "sift": {
            "frames": len(st),
            "coincidences": sum(s["coincidences"] for s in st),
            "accidentals_est": round(sum(s["accidentals_est"] for s in st), 1),
            "sifted_bits": sum(s["sifted_bits"] for s in st),
            "servo_residual_last": st[-1]["servo_residual_units"] if st else None,
        },
        "ledger": bob.ec.ledger.as_dict(),
        "device": str(args.device),
    }
    print(json.dumps(summary, indent=2))
    if cfg.checkpoint_path:
        with open(cfg.checkpoint_path, "w") as f:
            json.dump(bob.ec.checkpoint_state(), f)
    if cfg.keystore_path:
        from qtpu_torch import keystore
        keystore.write_keys(cfg.keystore_path,
                            keystore.records_from_session(bob.ec))
    return 0 if ok and len(ka) > 0 else 1


def _run_party(cfg: RunConfig, args, party: str) -> int:
    """One party of a two-process TCP run (simulation-correlated source)."""
    from qtpu_torch import sift
    from qtpu_torch.chain import AliceChain, BobChain
    from qtpu_torch.link import TcpLink
    from qtpu_torch.metrics import MetricsLogger

    host, _, port = args.address.rpartition(":")
    host = host or "127.0.0.1"
    if args.link == "native":
        from qtpu_torch.runtime import NativeTcpLink as LinkCls
    else:
        LinkCls = TcpLink
    if party == "alice":
        link = LinkCls.listen(host, int(port))
    else:
        # Retry for about a minute: the peer may still be starting up (a
        # process needs seconds to import torch and reach its card).
        link = LinkCls.connect(host, int(port), retries=600)
    if args.auth_seed is not None:
        from qtpu_torch.auth import AuthedLink
        link = AuthedLink(link, int(args.auth_seed, 0), party == "alice")
        link.close = link._inner.close  # passthrough
    if party == "alice":
        chain = AliceChain(cfg.chain, cfg.session_seed, link,
                           device=args.device)
    else:
        chain = BobChain(cfg.chain, cfg.session_seed, link,
                         device=args.device)

    src = _build_chain_parts(cfg)
    rng = np.random.default_rng(cfg.source.seed)
    log = MetricsLogger(path=cfg.metrics_path or None)

    import os
    dbg = (lambda *a: print(f"[{party}]", *a, file=sys.stderr, flush=True)) \
        if os.environ.get("QTPU_DEBUG") else (lambda *a: None)

    for w in range(cfg.num_windows):
        ev = src.generate(rng, start_epoch=w)
        mine = ev.alice if party == "alice" else ev.bob
        chain.push_events(sift.rebase_times(mine.times, 0), mine.detectors)
        # Drain link traffic; block briefly for the peer.
        while True:
            msg = link.recv(timeout=0.05)
            if msg is None:
                # Resolve deferred decodes before going back to acquisition
                # (their acks unblock the peer's next windows).
                if getattr(chain.ec, "flush", lambda: False)():
                    continue
                break
            dbg("window-loop got", type(msg).__name__, msg.window_id)
            chain._dispatch(msg)

    # Shutdown handshake — Alice-initiated (she drives the EC protocol, so
    # only she knows when no further windows can start): when idle AND quiet
    # she sends 'bye'; Bob replies 'bye' and both close.  Only idleness —
    # not time — triggers the offer, and a generous hard limit guards
    # against a dead peer.
    from qtpu_torch.messages import Abort
    BYE = 0xFFFFFFFF
    done = False
    hard_limit = 900
    waited = 0
    sent_bye = False
    while not done and waited < hard_limit:
        try:
            msg = link.recv(timeout=1.0)
        except (ConnectionError, OSError):
            break  # peer closed after its bye — session over
        if msg is None:
            if getattr(chain.ec, "flush", lambda: False)():
                continue
            if party == "bob" and chain._ready_frames:
                # No more events will come: sift the partial batch (left
                # queued, Alice would never turn idle and offer the bye).
                chain.flush_sift()
                continue
            waited += 1
            # Stalled in-flight windows (lost message / wedged peer): Alice
            # aborts them after a long quiet spell so the stream cursor can
            # resync instead of hanging until the hard limit (SURVEY §6.3).
            if waited == 300 and party == "alice":
                for w in list(chain.ec._inflight):
                    dbg("stall -> aborting window", w)
                    chain.ec.abort_window(w, reason="stall-timeout")
            if party == "alice" and chain.idle() and not sent_bye:
                dbg("idle -> sending bye")
                link.send(Abort(window_id=BYE, reason="bye"))
                sent_bye = True
            continue
        waited = 0
        if isinstance(msg, Abort) and msg.reason == "bye":
            dbg("got bye")
            if party == "bob":
                link.send(Abort(window_id=BYE, reason="bye"))
            done = True
            continue
        dbg("shutdown-loop got", type(msg).__name__, msg.window_id)
        chain._dispatch(msg)
    link.close()

    ec = chain.ec
    for m in ec.metrics:
        log.window(m)
    if cfg.keystore_path:
        from qtpu_torch import keystore
        keystore.write_keys(cfg.keystore_path,
                            keystore.records_from_session(ec))
    out = {
        "party": party,
        "windows": ec.window_id,
        "final_key_bits": int(len(ec.final_key_bits())),
        "ledger": ec.ledger.as_dict(),
        "key_digest": _digest(ec.final_key_bits()),
        "device": str(args.device),
    }
    print(json.dumps(out, indent=2))
    return 0


def _digest(bits: np.ndarray) -> str:
    import hashlib

    from qtpu_torch.framing import pack_bits
    if len(bits) == 0:
        return "empty"
    return hashlib.sha256(pack_bits(bits).tobytes()).hexdigest()[:16]


def cmd_bench(cfg: RunConfig, args) -> int:
    from qtpu_torch import bench
    return bench.main(["--device", str(args.device)])


def cmd_calibrate(cfg: RunConfig, args) -> int:
    from qtpu_torch.ldpc.calibrate import calibrate_ladder
    from qtpu_torch.ldpc.codes import make_rate_ladder
    n = cfg.chain.pipeline.n
    ladder = make_rate_ladder(n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    ceilings = calibrate_ladder(ladder, verbose=True, blocks=args.blocks,
                                device=args.device)
    print(json.dumps({"n": n, "max_qber": list(ceilings)}))
    return 0


def cmd_cascade(cfg: RunConfig, args) -> int:
    """Cross-check: run the Cascade golden model and contrast its leakage and
    interactivity with the LDPC ladder at the same QBER."""
    from qtpu_torch.ldpc.cascade import ParityOracle, cascade_reconcile
    from qtpu_torch.ldpc.codes import make_rate_ladder
    rng = np.random.default_rng(args.seed)
    n, q = args.n, args.qber
    alice = rng.integers(0, 2, n).astype(np.uint8)
    bob = alice ^ (rng.random(n) < q).astype(np.uint8)
    res = cascade_reconcile(ParityOracle(alice), bob, q, session_seed=args.seed)
    ok = bool(np.array_equal(res.bits, alice))
    ladder = make_rate_ladder(cfg.chain.pipeline.n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    step = ladder.steps[ladder.select(q)]
    print(json.dumps({
        "n": n, "qber": q, "corrected": ok,
        "cascade": {"leaked_bits": res.leaked_bits,
                    "round_trips": res.round_trips,
                    "errors_fixed": res.corrected_errors},
        "ldpc": {"rung": step.name,
                 "leaked_bits_per_block": step.leaked_bits(),
                 "payload_bits_per_block": step.payload_bits(),
                 "round_trips": 1},
    }))
    return 0 if ok else 1


def cmd_fer(cfg: RunConfig, args) -> int:
    from qtpu_torch.ldpc.calibrate import measure_fer
    from qtpu_torch.ldpc.codes import make_rate_ladder
    ladder = make_rate_ladder(cfg.chain.pipeline.n, cfg.chain.pipeline.dv,
                              cfg.chain.pipeline.target_rates)
    step = ladder.steps[args.rung]
    fer, iters = measure_fer(step, args.qber, blocks=args.blocks,
                             device=args.device)
    print(json.dumps({"rung": step.name, "qber": args.qber, "fer": fer,
                      "mean_iters": iters, "device": str(args.device)}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qtpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="override a config leaf, e.g. --set source.error_rate=0.03")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device-side work (default "
                        "cuda; fails when CUDA is missing)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("demo")
    for party in ("alice", "bob"):
        sp = sub.add_parser(party)
        sp.add_argument("address", help="host:port (alice listens, bob connects)")
        sp.add_argument("--link", choices=("python", "native"), default="python",
                        help="classical-channel transport: pure-Python TcpLink "
                             "or the C++ transferd library (qtpu_torch.runtime)")
        sp.add_argument("--auth-seed", default=None,
                        help="pre-shared authentication seed (hex/int): wraps "
                             "the link in a Wegman-Carter MAC; consumption is "
                             "charged to the ledger as auth_bits")
    sub.add_parser(
        "bench", help="judge-metric benchmark: reconciled bits/s per card "
                      "at QBER 3%% (Bob's replayed session), with the "
                      "decoder, two-party, events->key and sift extras; "
                      "one JSON line (qtpu_torch.bench)")
    spc = sub.add_parser("calibrate")
    spc.add_argument("--blocks", type=int, default=256)
    spf = sub.add_parser("fer")
    spf.add_argument("--rung", type=int, required=True)
    spf.add_argument("--qber", type=float, required=True)
    spf.add_argument("--blocks", type=int, default=256)
    spk = sub.add_parser("cascade")
    spk.add_argument("--n", type=int, default=4096)
    spk.add_argument("--qber", type=float, default=0.03)
    spk.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    import os
    if os.environ.get("QTPU_DEBUG"):
        import faulthandler
        faulthandler.dump_traceback_later(int(os.environ.get("QTPU_DEBUG_HANG_S", "120")),
                                          exit=True)
    args.device = _device(args.device)
    cfg = apply_overrides(load_config(args.config), args.set)

    if args.cmd == "demo":
        return cmd_demo(cfg, args)
    if args.cmd in ("alice", "bob"):
        return _run_party(cfg, args, args.cmd)
    if args.cmd == "bench":
        return cmd_bench(cfg, args)
    if args.cmd == "calibrate":
        return cmd_calibrate(cfg, args)
    if args.cmd == "fer":
        return cmd_fer(cfg, args)
    if args.cmd == "cascade":
        return cmd_cascade(cfg, args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
