"""The port's plain layered decoder and codes vs the reference.

The plain PyTorch decoder (the CPU path, and the CUDA kernel's oracle on the
card) must equal three references on mixed-QBER batches: the XLA layered
decoder, the Pallas kernel in interpret mode, and the golden model — bits,
iterations and converged flags, exactly.  A native3 rung at n=2048 (z=64,
row degree 27) is held to golden, including blocks that never converge
(XLA on the CPU fuses ``alpha*min - c2v`` into one FMA there, the golden
model rounds twice, and so do the port and the kernel).  The port's own
``make_rate_ladder`` must rebuild the reference's ladders array for array.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qtpu.ldpc import golden
from qtpu.ldpc.codes import make_rate_ladder as j_make_rate_ladder
from qtpu.ldpc.codes import make_regular_code
from qtpu.ldpc.decode import channel_llr, make_batch_decoder
from qtpu.ldpc.encode import make_batch_encoder
from qtpu.ldpc.pallas_bp import make_pallas_decoder
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import code_from_reference, make_rate_ladder
from qtpu_torch.ldpc.decode import make_layered_decoder
from qtpu_torch.window_programs import _pick_decoder

MAX_ITERS = 40


def _scenario(code, qbers, seed, B):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    noise = (rng.random((B, code.n)) < np.asarray(qbers)[:, None])
    syn = np.array(make_batch_encoder(code)(jnp.asarray(keys)))
    llr = np.array(channel_llr(jnp.asarray(keys ^ noise), 0.03))
    return llr, syn


@pytest.fixture(scope="module")
def regular():
    """tests/test_pallas_bp.py's scenario: n=1024, B=8, mixed QBER."""
    code = make_regular_code(1024)
    llr, syn = _scenario(code, np.repeat([0.005, 0.02, 0.04, 0.06], 2), 0, 8)
    res = make_layered_decoder(code_from_reference(code), MAX_ITERS)(
        torch.from_numpy(llr), torch.from_numpy(syn))
    return code, llr, syn, res


def _assert_same(ref, res):
    np.testing.assert_array_equal(np.asarray(ref.bits), res.bits.numpy())
    np.testing.assert_array_equal(np.asarray(ref.iterations),
                                  res.iterations.numpy())
    np.testing.assert_array_equal(np.asarray(ref.converged),
                                  res.converged.numpy())


def _assert_same_as_golden(code, llr, syn, res):
    for b in range(llr.shape[0]):
        g = golden.decode(code, llr[b], syn[b], max_iters=MAX_ITERS,
                          alg="layered")
        np.testing.assert_array_equal(g.bits.reshape(-1), res.bits[b].numpy())
        assert g.iterations == int(res.iterations[b])
        assert g.converged == bool(res.converged[b])


def test_plain_vs_xla_layered(regular):
    code, llr, syn, res = regular
    ref = make_batch_decoder(code, max_iters=MAX_ITERS, alg="layered")(
        jnp.asarray(llr), jnp.asarray(syn))
    _assert_same(ref, res)


def test_plain_vs_pallas_interpret(regular):
    code, llr, syn, res = regular
    ref = make_pallas_decoder(code, max_iters=MAX_ITERS, batch_tile=8,
                              interpret=True, alg="layered")(
        jnp.asarray(llr), jnp.asarray(syn))
    _assert_same(ref, res)


def test_plain_vs_golden_regular(regular):
    _assert_same_as_golden(*regular)


def test_plain_vs_golden_native3_rung():
    ladder = j_make_rate_ladder(2048, family="native3", alg="layered")
    code = ladder.steps[-1].code          # z=64, row degree up to 27
    assert code.z == 64 and code.dc_max == 27
    llr, syn = _scenario(code, np.repeat([0.002, 0.008, 0.02, 0.04], 2), 5, 8)
    res = make_layered_decoder(code_from_reference(code), MAX_ITERS)(
        torch.from_numpy(llr), torch.from_numpy(syn))
    assert res.converged.any() and not res.converged.all()
    _assert_same_as_golden(code, llr, syn, res)


def test_cuda_wrapper_runs_plain_decoder_on_cpu(regular):
    code, llr, syn, res = regular
    before = cuda_bp.launches
    got = cuda_bp.make_cuda_decoder(code_from_reference(code), MAX_ITERS)(
        torch.from_numpy(llr), torch.from_numpy(syn))
    _assert_same(res, got)
    assert cuda_bp.launches == before   # the plain version launches nothing


def test_cuda_wrapper_rejects_mixed_devices(regular):
    code, llr, syn, _ = regular
    dec = cuda_bp.make_cuda_decoder(code_from_reference(code), MAX_ITERS)
    with pytest.raises(ValueError, match="CUDA"):
        dec(torch.from_numpy(llr).to("meta"), torch.from_numpy(syn))


def test_code_tables_row_order_and_parallel_edges():
    code = code_from_reference(make_regular_code(1024))
    tab = cuda_bp.code_tables(code)
    start = tab[:code.mb + 1]
    E = code.num_edges
    cols, shifts = tab[code.mb + 1:code.mb + 1 + E], tab[code.mb + 1 + E:]
    for i, row in enumerate(code.row_edges):
        slots = [e for e in row if e >= 0]
        np.testing.assert_array_equal(cols[start[i]:start[i + 1]],
                                      code.edge_col[slots])
        np.testing.assert_array_equal(shifts[start[i]:start[i + 1]],
                                      code.edge_shift[slots])
    dup = code_from_reference(code)
    e0, e1 = [e for e in dup.row_edges[0] if e >= 0][:2]
    dup.edge_col[e1] = dup.edge_col[e0]
    with pytest.raises(ValueError, match="parallel"):
        cuda_bp.code_tables(dup)


@pytest.mark.parametrize("alg", ["minsum", "sumprod"])
def test_flooding_schedules_not_ported(alg):
    code = code_from_reference(make_regular_code(1024))
    with pytest.raises(NotImplementedError, match=alg):
        _pick_decoder(code, 10, alg)


@pytest.mark.parametrize("n,family", [(65536, "native3"), (1024, "mixed")])
def test_rate_ladder_matches_reference(n, family):
    kw = dict(seed=0x51C0DE, alg="layered", family=family)
    ref = j_make_rate_ladder(n, **kw)
    got = make_rate_ladder(n, **kw)
    assert len(ref.steps) == len(got.steps)
    for a, b in zip(ref.steps, got.steps):
        assert (a.name, a.punct_cols, a.short_cols) == (
            b.name, b.punct_cols, b.short_cols)
        for f in ("edge_row", "edge_col", "edge_shift", "row_edges",
                  "col_edges"):
            np.testing.assert_array_equal(getattr(a.code, f),
                                          getattr(b.code, f))
        assert (a.code.z, a.code.mb, a.code.nb) == (b.code.z, b.code.mb,
                                                    b.code.nb)
    assert (ref.max_qber, ref.short_grid, ref.short_ceilings,
            ref.calib_step) == (got.max_qber, got.short_grid,
                                got.short_ceilings, got.calib_step)


def test_code_from_reference_round_trip():
    ref = make_regular_code(2048)
    got = code_from_reference(ref)
    np.testing.assert_array_equal(ref.to_dense(), got.to_dense())
