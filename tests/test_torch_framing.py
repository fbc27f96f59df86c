"""qtpu_torch.framing's bit unpack against qtpu.framing's, and the drain
that unpacks every final key with it.

``unpack_bits`` is held to the reference on words with the top bit set
(uint32 and int32), 1-D and 2-D inputs, non-contiguous slices and widths
from 0 bits to every bit of the words; ``pack_bits`` and ``unpack_bits``
round-trip.  The drain of a tiny CPU session, on the worker thread and
inline, hands out the bits of the per-block shift-and-mask unpack the port
used before, in (window, block) order, each key an array of its own (its
base, if any, at most 31 bytes longer), so a kept key never holds its
window's chunk.  Tolerance: exact.
"""

import numpy as np
import pytest

from qtpu import framing as jframing
from qtpu_torch import framing as tframing
from qtpu_torch import keystore
import qtpu_torch.pipeline as tpipe

W = 5


def _words(layout, dtype):
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, size=(3, 2 * W), dtype=np.uint32)
    words[:, 0] |= np.uint32(1 << 31)
    words = {"1d": words[0, :W], "2d": words[:, :W],
             "slice": words[:, ::2]}[layout]
    return words.view(np.int32) if dtype == "int32" else words


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 32 * W])
@pytest.mark.parametrize("layout", ["1d", "2d", "slice"])
@pytest.mark.parametrize("dtype", ["uint32", "int32"])
def test_unpack_bits_matches_reference(n, layout, dtype):
    words = _words(layout, dtype)
    got = tframing.unpack_bits(words, n)
    want = jframing.unpack_bits(words, n)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == words.shape[:-1] + (n,)
    np.testing.assert_array_equal(got, want)


def test_unpack_bits_of_a_list_matches_reference():
    words = _words("2d", "uint32").tolist()
    for n in (0, 45, 32 * W):
        np.testing.assert_array_equal(tframing.unpack_bits(words, n),
                                      jframing.unpack_bits(words, n))


@pytest.mark.parametrize("layout", ["1d", "2d", "slice"])
def test_pack_unpack_round_trip(layout):
    words = _words(layout, "uint32")
    bits = tframing.unpack_bits(words, 32 * W)
    np.testing.assert_array_equal(tframing.pack_bits(bits), words)
    for n in (1, 33, 32 * W - 1):
        np.testing.assert_array_equal(
            tframing.unpack_bits(tframing.pack_bits(bits[..., :n]), n),
            bits[..., :n])


def _per_block_unpack(words, n):
    """The drain's unpack before it went through bytes: one uint32 shift
    and mask a bit."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((words[..., :, None] >> shifts) & 1).astype(np.uint8)
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n]


@pytest.mark.parametrize("path", ["worker", "inline"])
def test_drain_hands_out_each_key_on_its_own(path):
    rng = np.random.default_rng(5)
    a_bits = rng.integers(0, 2, 24_000).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(a_bits.size) < 0.02).astype(np.uint8)
    cfg = tpipe.PipelineConfig(n=1024, blocks_per_window=4,
                               qber_test_bits=256, drain_windows=1_000)
    alice, bob = tpipe.run_loopback(cfg, a_bits, b_bits, device="cpu")
    for party in (alice, bob):
        chunks = list(party._final_chunks)
        assert len(chunks) >= 2
        want = sorted(
            ((c["window"], b),
             _per_block_unpack(c["packed"].numpy().view(np.uint32)[b], l))
            for c in chunks for b, l in c["blocks"])
        if path == "worker":
            party._submit_drain()
            assert not party._final_chunks and party._drain_futs
        recs = keystore.records_from_session(party)
        assert [(r.window_id, r.block_index) for r in recs] == [
            k for k, _ in want]
        for rec, (_, bits) in zip(recs, want):
            assert rec.bits.dtype == np.uint8 and rec.bits.ndim == 1
            np.testing.assert_array_equal(rec.bits, bits)
            base = rec.bits.base
            assert base is None or base.nbytes <= rec.bits.nbytes + 31
    np.testing.assert_array_equal(alice.final_key_bits(), bob.final_key_bits())
