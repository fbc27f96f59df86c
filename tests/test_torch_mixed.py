"""Mixed sessions: a qtpu party against a qtpu_torch party.

In process, a ``qtpu`` Alice with a ``qtpu_torch`` Bob and the reverse, over
a link that packs each message with the sender's package and unpacks it
with the receiver's: for the layered and the flooding min-sum decoder and
for stream PA; then the same with the other package's Bob on a mesh of 8
shards (8 CPU shards in the port, the conftest's 8 forced CPU devices in
qtpu), layered and stream PA, at sizes where the reference's float32
sharded flush is exact; and a ``qtpu`` Alice with a port Bob at B = 16
whose retry round re-decodes more than 8 of a window's rows.  Both parties must end with identical final keys,
key index and ledgers, equal to a port-only unsharded session's.  Then one two-process run over
TCP: ``python -m qtpu.cli alice`` against ``python -m qtpu_torch.cli
--device cpu bob`` with channel authentication; both must report the same
key digest, window count and ledger.  Every session runs with
``max_inflight_windows=1``, so no protocol decision depends on when a
decode lands.
"""

import collections
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import qtpu.link as jlink
import qtpu.parallel as jpar
import qtpu.pipeline as jpipe
import qtpu_torch.link as tlink
import qtpu_torch.parallel as tpar
import qtpu_torch.pipeline as tpipe

ROOT = Path(__file__).resolve().parent.parent


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


CONFIGS = {
    "layered": dict(),
    "minsum": dict(alg="minsum"),
    "stream": dict(pa_mode="stream", pa_stream_windows=2),
}


MESH = 8


def _cpu(mod):
    """``device="cpu"`` for the port's entry points (the reference's take
    no device)."""
    return {"device": "cpu"} if mod.__name__.startswith("qtpu_torch") else {}


def _run(alice_pkg, bob_pkg, kind, blocks=4, bob_mesh=None):
    """Alice from ``alice_pkg`` (a (pipeline, link) pair), Bob from
    ``bob_pkg`` (on ``bob_mesh`` when given), over one byte channel;
    returns (alice, bob)."""
    (apipe, alink), (bpipe, blink) = alice_pkg, bob_pkg
    rng = np.random.default_rng(3)
    total = 12_500 * blocks
    a_bits = rng.integers(0, 2, total).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(total) < 0.03).astype(np.uint8)
    kw = dict(n=1024, blocks_per_window=blocks, qber_test_bits=512,
              max_inflight_windows=1, **CONFIGS[kind])
    a2b, b2a = collections.deque(), collections.deque()
    la = alink.LoopbackLink(a2b, b2a)
    lb = blink.LoopbackLink(b2a, a2b)
    alice = apipe.AliceSession(apipe.PipelineConfig(**kw), 0x5E55, la,
                               **_cpu(apipe))
    bob = bpipe.BobSession(bpipe.PipelineConfig(**kw), 0x5E55, lb,
                           mesh=bob_mesh, **_cpu(bpipe))
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    tpipe.pump_sessions(alice, bob, la, lb)
    return alice, bob


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("alice_side", ["qtpu", "qtpu_torch"])
def test_mixed_session_keys_and_ledgers(alice_side, kind):
    ref, port = (jpipe, jlink), (tpipe, tlink)
    alice, bob = _run(*((ref, port) if alice_side == "qtpu" else (port, ref)),
                      kind)
    pa, pb = _run(port, port, kind)
    key = pb.final_key_bits()
    assert key.size > 0 and bob.window_id == pb.window_id >= 4
    np.testing.assert_array_equal(alice.final_key_bits(), key)
    np.testing.assert_array_equal(bob.final_key_bits(), key)
    assert alice.final_key_index == bob.final_key_index == pb.final_key_index
    assert (alice.ledger.as_dict() == bob.ledger.as_dict()
            == pb.ledger.as_dict())
    assert bob.ledger.final_bits == key.size
    if kind == "stream":
        assert all(b < 0 for _, b in pb.final_key_index)


@pytest.mark.parametrize("kind", ["layered", "stream"])
@pytest.mark.parametrize("alice_side", ["qtpu", "qtpu_torch"])
def test_mixed_mesh_session_keys_and_ledgers(alice_side, kind):
    """The other package's Bob on a mesh of 8 shards, B = 8: identical keys,
    key index and ledgers on both parties, equal to a port-only unsharded
    session's; the mesh Bob took his decode leakage from his psum'd
    ledgers."""
    ref, port = (jpipe, jlink), (tpipe, tlink)
    if alice_side == "qtpu":
        mesh = tpar.make_mesh(num=MESH, devices=["cpu"] * MESH)
        alice, bob = _run(ref, port, kind, MESH, mesh)
    else:
        mesh = jpar.make_mesh("blocks", num=MESH)
        alice, bob = _run(port, ref, kind, MESH, mesh)
    _, pb = _run(port, port, kind, MESH)
    key = pb.final_key_bits()
    assert key.size > 0 and bob.window_id == pb.window_id >= 4
    assert sorted(bob.gled_by_window) == sorted(m.window_id
                                                for m in bob.metrics)
    np.testing.assert_array_equal(alice.final_key_bits(), key)
    np.testing.assert_array_equal(bob.final_key_bits(), key)
    assert alice.final_key_index == bob.final_key_index == pb.final_key_index
    assert (alice.ledger.as_dict() == bob.ledger.as_dict()
            == pb.ledger.as_dict())
    assert bob.ledger.final_bits == key.size
    if kind == "stream":
        assert pb._stream_flushes >= 2
        assert all(b < 0 for _, b in pb.final_key_index)


def test_mixed_session_wide_retry():
    """A ``qtpu`` Alice with a port Bob at B = 16, the bits of
    tests/test_torch_tracing.py (3%, one window at 9%): a retry round
    re-decodes more than 8 of a window's 16 rows, and both parties end
    with the keys, key index and ledgers of a port-only session."""
    rng = np.random.default_rng(1)
    n = 1024 * 16 * 8
    a_bits = rng.integers(0, 2, n).astype(np.uint8)
    q = np.full(n, 0.03)
    q[4 * 1024 * 16:5 * 1024 * 16] = 0.09
    b_bits = a_bits ^ (rng.random(n) < q).astype(np.uint8)
    kw = dict(n=1024, blocks_per_window=16, qber_test_bits=512,
              max_inflight_windows=1)

    def run(apipe, alink):
        a2b, b2a = collections.deque(), collections.deque()
        la = alink.LoopbackLink(a2b, b2a)
        lb = tlink.LoopbackLink(b2a, a2b)
        alice = apipe.AliceSession(apipe.PipelineConfig(**kw), 0x5E55, la,
                                   **_cpu(apipe))
        bob = tpipe.BobSession(tpipe.PipelineConfig(**kw), 0x5E55, lb,
                               device="cpu")
        alice.push_sifted(a_bits)
        bob.push_sifted(b_bits)
        tpipe.pump_sessions(alice, bob, la, lb)
        return alice, bob

    alice, bob = run(jpipe, jlink)
    pa, pb = run(tpipe, tlink)
    assert max(m.blocks_retried for m in bob.metrics) > 8
    key = pb.final_key_bits()
    assert key.size > 0 and bob.window_id == pb.window_id >= 4
    np.testing.assert_array_equal(alice.final_key_bits(), key)
    np.testing.assert_array_equal(bob.final_key_bits(), key)
    assert alice.final_key_index == bob.final_key_index == pb.final_key_index
    assert (alice.ledger.as_dict() == bob.ledger.as_dict()
            == pb.ledger.as_dict())
    assert [m.as_dict() for m in bob.metrics] == [m.as_dict()
                                                 for m in pb.metrics]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mixed_tcp_reference_alice_port_bob():
    port = _free_port()
    sets = ["--set", "chain.pipeline.n=1024",
            "--set", "chain.pipeline.blocks_per_window=4",
            "--set", "chain.pipeline.qber_test_bits=512",
            "--set", "chain.pipeline.max_inflight_windows=1",
            "--set", "num_windows=6"]
    party = ["--auth-seed", "0xC0FFEE"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    alice = subprocess.Popen(
        [sys.executable, "-m", "qtpu.cli", *sets, "alice",
         f"127.0.0.1:{port}", *party],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        bob = subprocess.run(
            [sys.executable, "-m", "qtpu_torch.cli", "--device", "cpu", *sets,
             "bob", f"127.0.0.1:{port}", *party],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if bob.returncode != 0:
            alice.kill()
        a_out, _ = alice.communicate(timeout=120)
    finally:
        alice.kill()
        alice.wait()
    assert bob.returncode == 0 and alice.returncode == 0, bob.stderr[-2000:]
    a, b = json.loads(a_out), json.loads(bob.stdout)
    assert (a["party"], b["party"], b["device"]) == ("alice", "bob", "cpu")
    assert a["key_digest"] == b["key_digest"] != "empty"
    assert a["windows"] == b["windows"] >= 4
    assert a["ledger"] == b["ledger"]
    assert b["ledger"]["auth_bits"] > 0
    assert b["ledger"]["final_bits"] == b["final_key_bits"] > 0
