"""The events -> key chain: qtpu_torch.chain vs qtpu.chain.

Both packages run ``run_chain_loopback`` on the same simulated detector
events (tests/test_chain.py's small config and source, with the flooding
min-sum decoder) on the CPU: the acquired offset, the sift statistics,
final keys (both parties), key index, ledgers and per-window metrics must
be identical.  The port runs once over the wire format (as the reference)
and once over a DirectLink, where the sift index and sifted bits stay
tensors.  As in tests/test_torch_pipeline.py, the reference's Bob waits for
his pending decode stats before a flush, so both packages take the same
protocol path.
"""

import jax
import numpy as np
import pytest

import qtpu.chain as jchain
import qtpu.pipeline as jpipe
import qtpu_torch.chain as tchain
import qtpu_torch.pipeline as tpipe
from qtpu.channel import EntangledPairSource as JSource
from qtpu_torch.channel import EntangledPairSource as TSource

WINDOWS = 6
SRC = dict(pair_rate_hz=150_000, window_s=0.05, offset_ns=4_321.0,
           error_rate=0.025, dark_rate_hz=2_000)


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


def _cfg(chain, pipe):
    return chain.ChainConfig(
        pipeline=pipe.PipelineConfig(n=1024, blocks_per_window=2,
                                     qber_test_bits=256, alg="minsum"),
        window_s=0.05)


@pytest.fixture(scope="module")
def reference():
    return jchain.run_chain_loopback(_cfg(jchain, jpipe), num_windows=WINDOWS,
                                     source=JSource(**SRC), seed=3)


@pytest.mark.parametrize("wire", [True, False])
def test_chain_matches_reference(reference, wire):
    ja, jb = reference
    ta, tb = tchain.run_chain_loopback(_cfg(tchain, tpipe),
                                       num_windows=WINDOWS,
                                       source=TSource(**SRC), seed=3,
                                       wire=wire, device="cpu")
    assert tb.offset == jb.offset
    assert abs(tb.offset - int(round(4_321.0 * 8))) < 60
    assert tb.sift_stats == jb.sift_stats
    key = ta.ec.final_key_bits()
    assert key.size > 0
    for other in (tb.ec, ja.ec, jb.ec):
        np.testing.assert_array_equal(other.final_key_bits(), key)
    assert ta.ec.final_key_index == ja.ec.final_key_index
    assert (ta.ec.ledger.as_dict() == tb.ec.ledger.as_dict()
            == ja.ec.ledger.as_dict() == jb.ec.ledger.as_dict())
    assert tb.ec.ledger.sifted_bits > 5_000
    assert [m.as_dict() for m in tb.ec.metrics] == [
        m.as_dict() for m in jb.ec.metrics]
    assert tb.ec.window_id == jb.ec.window_id >= 1
