"""The whole slice: qtpu_torch.pipeline.run_loopback vs qtpu.pipeline's.

Both packages run the same numpy bits with the config of
tests/test_pipeline.py, on the CPU, with the layered and the flooding
min-sum decoder; final keys (both parties), key index,
ledgers and per-window WindowMetrics must be identical.  Tolerance: exact.

Resolution timing is made the same on both sides: a CPU tensor is complete
when its op returns, so the port's non-blocking ``flush`` always finds the
stats landed; the JAX reference dispatches asynchronously, and whether a
decode has landed when Bob answers the next WindowOpen decides which prior
his rate choice sees.  The reference's flush therefore waits for pending
stats first here — the protocol then takes the same path in both packages.
"""

import jax
import numpy as np
import pytest

import qtpu.pipeline as jpipe
import qtpu_torch.pipeline as tpipe
from qtpu_torch.link import make_direct_pair


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


def _cfg(mod, **kw):
    base = dict(n=1024, blocks_per_window=4, qber_test_bits=512, max_iters=60,
                verify_hash_bits=64, security_margin_bits=64)
    base.update(kw)
    return mod.PipelineConfig(**base)


def _both(alice_bits, bob_bits, wire=False, **kw):
    ja, jb = jpipe.run_loopback(_cfg(jpipe, **kw), alice_bits, bob_bits,
                                wire=wire)
    ta, tb = tpipe.run_loopback(_cfg(tpipe, **kw), alice_bits, bob_bits,
                                wire=wire, device="cpu")
    key = ta.final_key_bits()
    assert key.size > 0
    np.testing.assert_array_equal(ja.final_key_bits(), key)
    np.testing.assert_array_equal(jb.final_key_bits(), key)
    np.testing.assert_array_equal(tb.final_key_bits(), key)
    assert ta.final_key_index == ja.final_key_index == tb.final_key_index
    assert (ta.ledger.as_dict() == tb.ledger.as_dict()
            == ja.ledger.as_dict() == jb.ledger.as_dict())
    assert [m.as_dict() for m in tb.metrics] == [m.as_dict()
                                                for m in jb.metrics]
    assert tb.window_id == jb.window_id >= 2
    return ta, tb


def _sifted(seed, total, qber):
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, total).astype(np.uint8)
    return alice, alice ^ (rng.random(total) < qber).astype(np.uint8)


@pytest.mark.parametrize("alg", ["layered", "minsum"])
@pytest.mark.parametrize("qber", [0.01, 0.03, 0.05])
def test_loopback_matches_reference(qber, alg):
    _both(*_sifted(int(qber * 1000), 40_000, qber), alg=alg)


def test_loopback_wire_matches_reference():
    _both(*_sifted(30, 40_000, 0.03), wire=True)


def _burst(seed, blocks, windows, burst):
    """Sifted bits at 3% whose window ``burst`` (of ``blocks`` n = 1024
    blocks a window, at most) runs at 9%."""
    rng = np.random.default_rng(seed)
    n = 1024 * blocks * windows
    alice = rng.integers(0, 2, n).astype(np.uint8)
    q = np.full(n, 0.03)
    q[burst * 1024 * blocks:(burst + 1) * 1024 * blocks] = 0.09
    return alice, alice ^ (rng.random(n) < q).astype(np.uint8)


@pytest.mark.parametrize("alg,scenario", [
    pytest.param("layered", "cold_prior", id="layered"),
    pytest.param("minsum", "cold_prior", id="minsum"),
    pytest.param("layered", "burst16", id="layered-burst16")])
def test_loopback_retry_matches_reference(alg, scenario):
    """tests/test_pipeline.py's blind-retry scenario: the channel runs
    6.8% against a 4% cold prior, so windows fail blocks and a retry round
    runs.  ``burst16``: B = 16 blocks a window and a burst of errors in one
    window (tests/test_torch_tracing.py's), so a retry round re-decodes
    more than 8 of its 16 rows."""
    if scenario == "cold_prior":
        _, tb = _both(*_sifted(3, 30_000, 0.068), qber_initial=0.04,
                      qber_test_bits=64, qber_test_floor=32, max_retries=1,
                      alg=alg)
        assert sum(m.blocks_retried for m in tb.metrics) > 0
    else:
        _, tb = _both(*_burst(1, 16, 8, 4), blocks_per_window=16, alg=alg)
        assert max(m.blocks_retried for m in tb.metrics) > 8


def test_unported_options_raise():
    """The mesh Bob is ported for a mesh local to the session's process; a
    mesh spanning a process group is refused, and so is a device other
    than the mesh's first."""
    from qtpu_torch.parallel import Mesh
    _, lb = make_direct_pair()
    with pytest.raises(ValueError, match="process group"):
        tpipe.BobSession(_cfg(tpipe), 1, lb,
                         mesh=Mesh("blocks", ["cpu"], 0, 2, group=object()))
    with pytest.raises(ValueError, match="first device"):
        tpipe.BobSession(_cfg(tpipe), 1, lb, mesh=Mesh("blocks", ["cpu"]),
                         device="meta")


def test_program_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(tpipe, "_PROGRAM_CACHE_MAX", 2)
    tpipe._PROGRAM_CACHE.clear()
    bob = tpipe.BobSession(_cfg(tpipe), 1, make_direct_pair()[1],
                           device="cpu")
    for r in range(len(bob.ladder.steps)):
        bob.programs(r)
    assert list(k[1] for k in tpipe._PROGRAM_CACHE) == [
        len(bob.ladder.steps) - 2, len(bob.ladder.steps) - 1]


def test_checkpoint_round_trip():
    a_bits, b_bits = _sifted(8, 20_000, 0.03)
    ta, tb = tpipe.run_loopback(_cfg(tpipe), a_bits, b_bits, device="cpu")
    state = tb.checkpoint_state()
    fresh = tpipe.BobSession(_cfg(tpipe), 0x5E55, make_direct_pair()[1],
                             device="cpu")
    fresh.restore_state(state)
    assert fresh.window_id == tb.window_id
    np.testing.assert_array_equal(fresh.stream.snapshot_host(),
                                  tb.stream.snapshot_host())
    assert fresh.ledger.as_dict() == tb.ledger.as_dict()
