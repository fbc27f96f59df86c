"""The port's tooling around the sessions, against the reference.

qtpu_torch's channel authentication, keystore, config, checkpoints, native
runtime, Cascade model, calibration tools and CLI, each run with the cases
of the reference's own tests (tests/test_auth.py, test_keystore.py,
test_config_checkpoint.py, test_runtime_native.py, test_cascade.py) and
held to qtpu on the same inputs: MAC frames, keystore bytes, config
dictionaries, checkpoints restored across packages (the restored session
continues to the same keys), Cascade results, FER measurements and the
``demo`` command's keystore file.  Tolerance: exact.
"""

import json
import struct
import threading

import jax
import numpy as np
import pytest

import qtpu.pipeline as jpipe
import qtpu_torch.pipeline as tpipe
from qtpu_torch import keystore, runtime
from qtpu_torch.auth import AuthedLink, AuthError
from qtpu_torch.config import RunConfig, apply_overrides, load_config, to_dict
from qtpu_torch.framing import EPOCH_UNITS, pack_bits
from qtpu_torch.link import make_loopback_pair
from qtpu_torch.messages import RateSelect, Syndromes


@pytest.fixture(scope="module", autouse=True)
def settled_reference_flush():
    orig = jpipe.BobSession.flush

    def flush(self, block=True, limit=0):
        for w in self._pending:
            st = self._inflight.get(w)
            if st is not None and "stats_dev" in st:
                jax.block_until_ready(st["stats_dev"])
        return orig(self, block, limit)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe.BobSession, "flush", flush)
        yield


def _sifted(seed, total, qber=0.02):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, total).astype(np.uint8)
    return a, a ^ (rng.random(total) < qber).astype(np.uint8)


# -- channel authentication (tests/test_auth.py) ---------------------------

def _authed_pair(seed=0xC0FFEE):
    la, lb = make_loopback_pair()
    return AuthedLink(la, seed, True), AuthedLink(lb, seed, False), la, lb


def test_auth_roundtrip():
    a, b, _, _ = _authed_pair()
    a.send(RateSelect(window_id=3, qber_milli=30, rate_index=2))
    m = b.recv()
    assert isinstance(m, RateSelect) and m.window_id == 3 and m.rate_index == 2
    b.send(RateSelect(window_id=4, qber_milli=10, rate_index=1))
    assert a.recv().window_id == 4


def test_auth_tampered_frame_rejected():
    a, b, la, lb = _authed_pair()
    a.send(RateSelect(window_id=1, qber_milli=30, rate_index=2))
    frame = bytearray(lb.recv_bytes())
    frame[8] ^= 0x40
    la._tx.append(bytes(frame))
    with pytest.raises(AuthError, match="MAC mismatch"):
        b.recv()


def test_auth_replayed_frame_rejected():
    a, b, la, lb = _authed_pair()
    a.send(RateSelect(window_id=1, qber_milli=30, rate_index=2))
    raw = lb.recv_bytes()
    la._tx.append(raw)
    la._tx.append(raw)
    assert b.recv() is not None
    with pytest.raises(AuthError, match="sequence"):
        b.recv()


def test_auth_wrong_preshared_key_rejected():
    la, lb = make_loopback_pair()
    a = AuthedLink(la, 1111, True)
    b = AuthedLink(lb, 2222, False)
    a.send(RateSelect(window_id=1, qber_milli=30, rate_index=2))
    with pytest.raises(AuthError):
        b.recv()


def test_auth_frames_interoperate_with_reference():
    """A port sender's frames are the reference's bytes, and a reference
    receiver verifies them (and the reverse)."""
    from qtpu.auth import AuthedLink as JAuthedLink
    from qtpu.link import make_loopback_pair as j_pair
    from qtpu.messages import RateSelect as JRateSelect
    ta, _, _, tlb = _authed_pair()
    ja_, jb_ = j_pair()
    ja = JAuthedLink(ja_, 0xC0FFEE, True)
    for w in range(3):
        ta.send(RateSelect(window_id=w, qber_milli=30, rate_index=2))
        ja.send(JRateSelect(window_id=w, qber_milli=30, rate_index=2))
        assert tlb.recv_bytes() == jb_.recv_bytes()
    la, lb = make_loopback_pair()
    jrx = JAuthedLink(lb, 7, False)
    tx = AuthedLink(la, 7, True)
    tx.send(RateSelect(window_id=9, qber_milli=1, rate_index=0))
    assert jrx.recv().window_id == 9


def test_auth_session_ledgers_charge_auth_bits():
    a_bits, b_bits = _sifted(0, 40_000)
    la, lb = make_loopback_pair()
    cfg = tpipe.PipelineConfig(n=1024, blocks_per_window=4, qber_test_bits=512)
    alice = tpipe.AliceSession(cfg, 7, AuthedLink(la, 0xC0FFEE, True),
                               device="cpu")
    bob = tpipe.BobSession(cfg, 7, AuthedLink(lb, 0xC0FFEE, False),
                           device="cpu")
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    tpipe.pump_sessions(alice, bob, alice.link, bob.link)
    alice._sync_auth_bits()
    bob._sync_auth_bits()
    np.testing.assert_array_equal(alice.final_key_bits(), bob.final_key_bits())
    assert len(alice.final_key_bits()) > 0
    assert alice.ledger.auth_bits > 0, "auth consumption must be charged"
    assert alice.ledger.as_dict() == bob.ledger.as_dict()
    msgs = alice.link._tx_seq + bob.link._tx_seq
    assert alice.ledger.auth_bits == 2 * 61 + 61 * msgs


# -- keystore (tests/test_keystore.py) -------------------------------------

def _records(rng, blocks=(0, 1)):
    return [keystore.KeyRecord(window_id=w, block_index=b,
                               bits=rng.integers(0, 2, 500 + w).astype(np.uint8))
            for w in range(3) for b in blocks]


def test_keystore_roundtrip(tmp_path):
    recs = _records(np.random.default_rng(0))
    path = str(tmp_path / "keys.bin")
    keystore.write_keys(path, recs)
    back = list(keystore.read_keys(path))
    assert len(back) == len(recs)
    for a, b in zip(recs, back):
        assert (a.window_id, a.block_index) == (b.window_id, b.block_index)
        np.testing.assert_array_equal(a.bits, b.bits)


def test_keystore_append_mode(tmp_path):
    path = str(tmp_path / "keys.bin")
    keystore.write_keys(path, [keystore.KeyRecord(0, 0, np.ones(64, np.uint8))])
    keystore.write_keys(path, [keystore.KeyRecord(1, 0, np.zeros(32, np.uint8))])
    back = list(keystore.read_keys(path))
    assert [(r.window_id, len(r.bits)) for r in back] == [(0, 64), (1, 32)]


def test_keystore_corrupt_magic_rejected(tmp_path):
    path = str(tmp_path / "keys.bin")
    keystore.write_keys(path, [keystore.KeyRecord(0, 0, np.ones(8, np.uint8))])
    data = bytearray(open(path, "rb").read())
    data[0] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        list(keystore.read_keys(path))


def test_keystore_records_from_session(tmp_path):
    a_bits, b_bits = _sifted(1, 20_000)
    cfg = tpipe.PipelineConfig(n=1024, blocks_per_window=2, qber_test_bits=256)
    alice, bob = tpipe.run_loopback(cfg, a_bits, b_bits, device="cpu")
    ra = keystore.records_from_session(alice)
    rb = keystore.records_from_session(bob)
    assert len(ra) == len(rb) > 0
    path = str(tmp_path / "alice.bin")
    keystore.write_keys(path, ra)
    for rec, orig in zip(keystore.read_keys(path), rb):
        assert (rec.window_id, rec.block_index) == (orig.window_id, orig.block_index)
        np.testing.assert_array_equal(rec.bits, orig.bits)


def test_keystore_bytes_equal_reference(tmp_path):
    """Every record the reference can write gives the same bytes."""
    from qtpu import keystore as jkeystore
    recs = _records(np.random.default_rng(2))
    keystore.write_keys(str(tmp_path / "port.bin"), recs)
    jkeystore.write_keys(str(tmp_path / "ref.bin"), [
        jkeystore.KeyRecord(r.window_id, r.block_index, r.bits) for r in recs])
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()


def test_keystore_stream_pa_records_round_trip(tmp_path):
    """A stream-PA session's records carry block index -1 - flush_idx: the
    port stores and reads them back, where the reference's unsigned header
    cannot pack them."""
    from qtpu import keystore as jkeystore
    a_bits, b_bits = _sifted(3, 60_000)
    cfg = tpipe.PipelineConfig(n=1024, blocks_per_window=8, qber_test_bits=512,
                               pa_mode="stream", pa_stream_windows=2)
    alice, bob = tpipe.run_loopback(cfg, a_bits, b_bits, session_seed=11,
                                    device="cpu")
    recs = keystore.records_from_session(bob)
    assert len(recs) >= 2 and all(r.block_index < 0 for r in recs)
    path = str(tmp_path / "stream.bin")
    keystore.write_keys(path, recs)
    back = list(keystore.read_keys(path))
    assert [(r.window_id, r.block_index) for r in back] == bob.final_key_index
    np.testing.assert_array_equal(np.concatenate([r.bits for r in back]),
                                  alice.final_key_bits())
    with pytest.raises(struct.error):
        jkeystore.write_keys(str(tmp_path / "ref.bin"), [
            jkeystore.KeyRecord(r.window_id, r.block_index, r.bits)
            for r in recs])


# -- config and checkpoints (tests/test_config_checkpoint.py) ---------------

def test_config_defaults_reproduce_baseline_config():
    cfg = RunConfig()
    assert cfg.chain.pipeline.n == 4096
    assert cfg.chain.pipeline.dv == 3
    assert cfg.chain.pipeline.target_rates[0] == 0.5


def test_config_override_leaves():
    cfg = apply_overrides(RunConfig(), [
        "source.error_rate=0.04", "chain.pipeline.n=1024", "num_windows=7",
        'chain.pipeline.pa_mode="stream"'])
    assert cfg.source.error_rate == 0.04
    assert cfg.chain.pipeline.n == 1024
    assert cfg.num_windows == 7
    assert cfg.chain.pipeline.pa_mode == "stream"
    assert cfg.chain.pipeline.dv == 3


def test_config_override_unknown_key_rejected():
    with pytest.raises(KeyError):
        apply_overrides(RunConfig(), ["does.not.exist=1"])
    with pytest.raises(ValueError):
        apply_overrides(RunConfig(), ["missing-equals"])


def test_config_json_roundtrip_across_packages(tmp_path):
    from qtpu import config as jconfig
    cfg = apply_overrides(RunConfig(), ["chain.pipeline.n=2048"])
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(to_dict(cfg)))
    back = load_config(str(p))
    assert back.chain.pipeline.n == 2048
    assert to_dict(back) == to_dict(cfg)
    assert jconfig.to_dict(jconfig.load_config(str(p))) == to_dict(cfg)
    assert jconfig.to_dict(jconfig.RunConfig()) == to_dict(RunConfig())


def _ckpt_cfg(mod):
    return mod.PipelineConfig(n=1024, blocks_per_window=4, qber_test_bits=512,
                              max_inflight_windows=1)


def test_checkpoint_roundtrip():
    a_bits, b_bits = _sifted(0, 20_000)
    alice, bob = tpipe.run_loopback(_ckpt_cfg(tpipe), a_bits, b_bits,
                                    device="cpu")
    state = json.loads(json.dumps(bob.checkpoint_state()))
    assert state["window_id"] == bob.window_id
    assert state["ledger"] == bob.ledger.as_dict()
    fresh = tpipe.BobSession(_ckpt_cfg(tpipe), 0x5E55,
                             make_loopback_pair()[1], device="cpu")
    fresh.restore_state(state)
    assert fresh.window_id == bob.window_id
    assert fresh.ledger.as_dict() == bob.ledger.as_dict()
    np.testing.assert_array_equal(fresh.stream.snapshot_host(),
                                  bob.stream.snapshot_host())


def _cpu(mod):
    """``device="cpu"`` for the port's entry points (the reference's take
    no device)."""
    return {"device": "cpu"} if mod.__name__.startswith("qtpu_torch") else {}


def _continue(pipe, link_mod, states, extra, seed=0x5E55):
    """Fresh sessions of ``pipe`` restored from (alice, bob) checkpoint
    states, fed ``extra`` sifted bits and pumped to quiescence."""
    la, lb = link_mod.make_loopback_pair()
    alice = pipe.AliceSession(_ckpt_cfg(pipe), seed, la, **_cpu(pipe))
    bob = pipe.BobSession(_ckpt_cfg(pipe), seed, lb, **_cpu(pipe))
    alice.restore_state(states[0])
    bob.restore_state(states[1])
    alice.push_sifted(extra[0])
    bob.push_sifted(extra[1])
    pipe.pump_sessions(alice, bob, la, lb)
    return alice, bob


@pytest.mark.parametrize("writer", ["qtpu", "qtpu_torch"])
def test_checkpoint_restores_across_packages(writer):
    """Checkpoints (JSON) written by one package's sessions restore into the
    other's, and the restored sessions continue to the same keys and
    ledgers as the original sessions running on."""
    import qtpu.link as jlink
    import qtpu_torch.link as tlink
    src, dst = (jpipe, (tpipe, tlink)) if writer == "qtpu" else (
        tpipe, (jpipe, jlink))
    a_bits, b_bits = _sifted(4, 36_000, 0.03)
    alice, bob = src.run_loopback(_ckpt_cfg(src), a_bits[:20_000],
                                  b_bits[:20_000], **_cpu(src))
    w0 = bob.window_id
    assert w0 >= 2
    states = [json.loads(json.dumps(p.checkpoint_state()))
              for p in (alice, bob)]
    ra, rb = _continue(*dst, states, (a_bits[20_000:], b_bits[20_000:]))
    # The originals run on over the same links.
    alice.push_sifted(a_bits[20_000:])
    bob.push_sifted(b_bits[20_000:])
    src.pump_sessions(alice, bob, alice.link, bob.link)
    bob.drain_final()
    later = [i for i, (w, _) in enumerate(bob.final_key_index) if w >= w0]
    key = np.concatenate([bob._final_host[i] for i in later])
    assert key.size > 0 and rb.window_id == bob.window_id > w0
    np.testing.assert_array_equal(ra.final_key_bits(), key)
    np.testing.assert_array_equal(rb.final_key_bits(), key)
    assert rb.final_key_index == [bob.final_key_index[i] for i in later]
    assert (ra.ledger.as_dict() == rb.ledger.as_dict() == alice.ledger.as_dict()
            == bob.ledger.as_dict())


# -- native runtime (tests/test_runtime_native.py) --------------------------

def test_runtime_pack_unpack_events_roundtrip():
    rng = np.random.default_rng(0)
    times = np.sort(rng.integers(0, 2 ** 48, 10_000))
    dets = rng.integers(0, 16, 10_000).astype(np.uint8)
    t2, d2 = runtime.unpack_events(runtime.pack_events(times, dets))
    np.testing.assert_array_equal(t2, times)
    np.testing.assert_array_equal(d2, dets)


def test_runtime_split_epochs():
    rng = np.random.default_rng(1)
    times = np.sort(rng.integers(0, 5 * EPOCH_UNITS, 50_000))
    spans = runtime.split_epochs(times, EPOCH_UNITS)
    assert sum(c for _, _, c in spans) == len(times)
    for eid, start, count in spans:
        np.testing.assert_array_equal(times[start:start + count] // EPOCH_UNITS,
                                      eid)
    assert [s for _, s, _ in spans] == sorted(s for _, s, _ in spans)


def test_runtime_pack_bits_matches_numpy():
    rng = np.random.default_rng(2)
    for n in (1, 31, 32, 1000, 4096):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        np.testing.assert_array_equal(runtime.pack_bits_native(bits),
                                      pack_bits(bits))


def test_runtime_builds_into_the_build_directory():
    runtime.pack_bits_native(np.ones(8, np.uint8))
    libs = sorted(p.name for p in runtime.BUILD_DIR.glob("libqtpu_*.so"))
    assert any(n.startswith("libqtpu_framing-") for n in libs), libs
    assert not list(runtime._DIR.glob("*.so"))


def _serve(link_cls, port, results, n):
    link = link_cls.listen("127.0.0.1", port)
    msgs = []
    for _ in range(n):
        m = link.recv(timeout=10.0)
        msgs.append(m)
        link.send(RateSelect(window_id=m.window_id, qber_milli=1, rate_index=0))
    results["server"] = msgs
    results["server_link"] = link


def test_runtime_native_link_roundtrip():
    port, results = 19881, {}
    t = threading.Thread(target=_serve,
                         args=(runtime.NativeTcpLink, port, results, 3))
    t.start()
    client = runtime.NativeTcpLink.connect("127.0.0.1", port)
    rng = np.random.default_rng(3)
    big = Syndromes(window_id=2, rate_index=1, num_blocks=64,
                    syndrome_bits=2048,
                    syndromes=rng.integers(0, 2, (64, 2048)).astype(np.uint8),
                    verify_hashes=rng.integers(0, 2, (64, 64)).astype(np.uint8))
    client.send(RateSelect(window_id=0, qber_milli=30, rate_index=2))
    client.send(RateSelect(window_id=1, qber_milli=31, rate_index=3))
    client.send(big)
    acks = [client.recv(timeout=10.0) for _ in range(3)]
    t.join(timeout=20)
    assert not t.is_alive()
    got = results["server"]
    assert [m.window_id for m in got] == [0, 1, 2]
    np.testing.assert_array_equal(got[2].syndromes, big.syndromes)
    assert [a.window_id for a in acks] == [0, 1, 2]
    assert client.bytes_sent > 0 and client.bytes_received > 0
    client.close()
    results["server_link"].close()


def test_runtime_native_link_interop_with_python_tcplink():
    from qtpu_torch.link import TcpLink
    port, results = 19883, {}
    t = threading.Thread(target=_serve, args=(TcpLink, port, results, 1))
    t.start()
    client = runtime.NativeTcpLink.connect("127.0.0.1", port)
    client.send(RateSelect(window_id=41, qber_milli=5, rate_index=0))
    back = client.recv(timeout=10.0)
    t.join(timeout=20)
    assert not t.is_alive()
    assert results["server"][0].window_id == 41 and back.window_id == 41
    client.close()
    results["server_link"].close()


def test_runtime_native_link_carries_authed_frames():
    """The native link exposes the byte interface AuthedLink wraps (the
    reference's lacks it, so its ``--link native --auth-seed`` fails)."""
    port, results = 19885, {}

    def server():
        link = AuthedLink(runtime.NativeTcpLink.listen("127.0.0.1", port),
                          5, True)
        results["got"] = link.recv(timeout=10.0)
        link.send(RateSelect(window_id=8, qber_milli=2, rate_index=1))
        results["link"] = link

    t = threading.Thread(target=server)
    t.start()
    client = AuthedLink(runtime.NativeTcpLink.connect("127.0.0.1", port), 5,
                        False)
    client.send(RateSelect(window_id=7, qber_milli=3, rate_index=1))
    back = client.recv(timeout=10.0)
    t.join(timeout=20)
    assert not t.is_alive()
    assert results["got"].window_id == 7 and back.window_id == 8
    assert client.consumed_bits == results["link"].consumed_bits > 0
    client._inner.close()
    results["link"]._inner.close()


def test_runtime_recv_timeout_returns_none():
    port = 19887

    def server():
        link = runtime.NativeTcpLink.listen("127.0.0.1", port)
        import time
        time.sleep(1.0)
        link.close()

    t = threading.Thread(target=server)
    t.start()
    client = runtime.NativeTcpLink.connect("127.0.0.1", port)
    assert client.recv(timeout=0.2) is None
    t.join(timeout=10)
    assert not t.is_alive()
    client.close()


# -- Cascade (tests/test_cascade.py) -----------------------------------------

def _pair(rng, n, q):
    a = rng.integers(0, 2, n).astype(np.uint8)
    return a, a ^ (rng.random(n) < q).astype(np.uint8)


@pytest.mark.parametrize("qber", [0.01, 0.03, 0.05])
def test_cascade_matches_reference(qber):
    """Corrects every error, and equals the reference's run (the pass
    permutations come from the bit-exact uniform)."""
    from qtpu.ldpc.cascade import ParityOracle as JOracle
    from qtpu.ldpc.cascade import cascade_reconcile as j_reconcile
    from qtpu_torch.ldpc.cascade import ParityOracle, cascade_reconcile
    alice, bob = _pair(np.random.default_rng(int(qber * 1e4)), 4096, qber)
    res = cascade_reconcile(ParityOracle(alice), bob, qber, session_seed=1)
    np.testing.assert_array_equal(res.bits, alice)
    assert res.corrected_errors >= int((alice != bob).sum())
    ref = j_reconcile(JOracle(alice), bob, qber, session_seed=1)
    assert (res.leaked_bits, res.round_trips, res.corrected_errors,
            res.biconf_rounds) == (ref.leaked_bits, ref.round_trips,
                                   ref.corrected_errors, ref.biconf_rounds)


def test_cascade_leakage_scales_and_is_interactive():
    from qtpu_torch.ldpc.cascade import ParityOracle, cascade_reconcile
    rng = np.random.default_rng(9)
    leaks = []
    for q in (0.01, 0.05):
        alice, bob = _pair(rng, 4096, q)
        res = cascade_reconcile(ParityOracle(alice), bob, q, session_seed=2)
        np.testing.assert_array_equal(res.bits, alice)
        leaks.append(res.leaked_bits)
    assert leaks[1] > leaks[0]
    assert res.round_trips > 100, "cascade is highly interactive"


def test_cascade_leakage_order():
    from qtpu_torch.ldpc.cascade import ParityOracle, cascade_reconcile
    q = 0.03
    alice, bob = _pair(np.random.default_rng(5), 8192, q)
    res = cascade_reconcile(ParityOracle(alice), bob, q, session_seed=7)
    np.testing.assert_array_equal(res.bits, alice)
    h2 = -q * np.log2(q) - (1 - q) * np.log2(1 - q)
    assert 0.9 * h2 * len(alice) < res.leaked_bits < 2.5 * h2 * len(alice)


# -- calibration tools and the CLI -------------------------------------------

@pytest.mark.parametrize("alg", ["minsum", "sumprod"])
def test_measure_fer_matches_reference(alg):
    """Same numpy batch, same frame errors, on the port's plain flooding
    decoders: min-sum (the ``fer``/``calibrate`` default) and sum-product.
    The layered schedule is left out: on blocks that never converge the
    reference's CPU decoder departs from golden (an FMA XLA forms), which
    FER at 6% counts."""
    from qtpu.ldpc.calibrate import measure_fer as j_measure_fer
    from qtpu.ldpc.codes import make_rate_ladder as j_ladder
    from qtpu_torch.ldpc.calibrate import measure_fer
    from qtpu_torch.ldpc.codes import make_rate_ladder
    kw = dict(n=1024, family="mixed", alg=alg)
    step, jstep = make_rate_ladder(**kw).steps[1], j_ladder(**kw).steps[1]
    for q, s in ((0.03, 0), (0.06, 0), (0.06, 96)):
        fer, iters = measure_fer(step, q, blocks=32, seed=5, alg=alg,
                                 extra_short_bits=s, device="cpu")
        jfer, jiters = j_measure_fer(jstep, q, blocks=32, seed=5, alg=alg,
                                     extra_short_bits=s)
        assert fer == jfer
        assert 0 < iters
    assert fer > 0


def test_calibrate_ladder_and_bisect_small():
    from qtpu_torch.ldpc.calibrate import calibrate_ladder, ceiling_bisect
    from qtpu_torch.ldpc.codes import make_rate_ladder
    ladder = make_rate_ladder(1024, family="regular", alg="minsum")
    ceil = calibrate_ladder(ladder, blocks=16, qber_grid=[0.01, 0.05, 0.2],
                            device="cpu")
    assert len(ceil) == len(ladder.steps)
    assert ceil[0] >= 0.01 and all(c < 0.2 for c in ceil)
    c = ceiling_bisect(ladder.steps[0], 0.01, 0.2, blocks=16, tol=0.02,
                       alg="minsum", device="cpu")
    assert 0.01 <= c < 0.2


def _cli(capsys, *argv):
    from qtpu_torch import cli
    rc = cli.main(list(argv))
    return rc, capsys.readouterr().out


def test_cli_needs_cuda_unless_told_cpu(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("demo", "bench"):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            _cli(capsys, cmd)


def test_cli_fer_and_cascade(capsys):
    rc, out = _cli(capsys, "--device", "cpu", "--set", "chain.pipeline.n=1024",
                   "fer", "--rung", "1", "--qber", "0.03", "--blocks", "16")
    res = json.loads(out)
    assert rc == 0 and res["device"] == "cpu" and 0 <= res["fer"] <= 1
    rc, out = _cli(capsys, "--device", "cpu", "cascade", "--n", "2048")
    assert rc == 0 and json.loads(out)["corrected"]


DEMO = ["--set", "chain.pipeline.n=1024",
        "--set", "chain.pipeline.blocks_per_window=4",
        "--set", "chain.pipeline.qber_test_bits=512",
        "--set", "chain.pipeline.max_inflight_windows=1",
        "--set", "num_windows=5"]


def test_cli_demo_keystore_equals_reference(tmp_path, capsys, monkeypatch):
    """``demo`` on the CPU writes the reference demo's keystore file, byte
    for byte, with the same summary."""
    from qtpu import cli as jcli
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    port_ks, ref_ks = tmp_path / "port.bin", tmp_path / "ref.bin"
    rc, out = _cli(capsys, "--device", "cpu", *DEMO,
                   "--set", f"keystore_path={port_ks}", "demo")
    assert rc == 0
    port = json.loads(out)
    assert jcli.main([*DEMO, "--set", f"keystore_path={ref_ks}", "demo"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port["keys_identical"] and port["final_key_bits"] > 0
    for k in ("windows", "final_key_bits", "acquired_offset_units", "sift",
              "ledger"):
        assert port[k] == ref[k], k
    assert port_ks.read_bytes() == ref_ks.read_bytes()
