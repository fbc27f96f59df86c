"""The port's plain decoders and codes vs the reference.

Each plain PyTorch decoder (the CPU path, and its CUDA kernel's oracle on
the card) must equal three references on mixed-QBER batches: the XLA
decoder, the Pallas kernel in interpret mode, and the golden model — bits,
iterations and converged flags, exactly.  For the layered schedule:  A native3 rung at n=2048 (z=64,
row degree 27) is held to golden, including blocks that never converge
(XLA on the CPU fuses ``alpha*min - c2v`` into one FMA there, the golden
model rounds twice, and so do the port and the kernel).  For flooding
min-sum: a regular n=1024 batch that includes blocks which never converge,
and rung 1 (r0.600) of the n=1024 mixed ladder with its punctured columns
at LLR 0.  The port's own ``make_rate_ladder`` must rebuild the
reference's ladders array for array.  Sum-product (no TPU kernel; plain
PyTorch on every device) is held to XLA and golden on the same batches,
within the tolerance ``_assert_same_converged`` states.
"""

import hypothesis.extra.numpy as hnp
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qtpu.ldpc import golden
from qtpu.ldpc.codes import make_rate_ladder as j_make_rate_ladder
from qtpu.ldpc.codes import make_regular_code
from qtpu.ldpc.decode import channel_llr, make_batch_decoder
from qtpu.ldpc.encode import make_batch_encoder
from qtpu.ldpc.pallas_bp import make_pallas_decoder
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import code_from_reference, make_rate_ladder
from qtpu_torch.ldpc import decode as tdecode
from qtpu_torch.ldpc.decode import (BatchDecodeResult, _minsum_row,
                                    make_flooding_decoder,
                                    make_layered_decoder)

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


def _assert_same_as_golden(code, llr, syn, res, alg="layered"):
    for b in range(llr.shape[0]):
        g = golden.decode(code, llr[b], syn[b], max_iters=MAX_ITERS,
                          alg=alg)
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
    before = dict(cuda_bp.launches)
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


def test_code_tables_reject_rows_wider_than_max_dc():
    """A row wider than the kernels' register arrays raises when the
    decoder is made, before any launch."""
    import qtpu_torch.ldpc.codes as tcodes
    d = cuda_bp.MAX_DC + 1
    rows = np.zeros(d, np.int32)
    cols = np.arange(d, dtype=np.int32)
    code = tcodes.QCCode(z=32, mb=1, nb=d, edge_row=rows, edge_col=cols,
                         edge_shift=np.zeros(d, np.int32),
                         row_edges=tcodes._group_edges(rows, 1),
                         col_edges=tcodes._group_edges(cols, d))
    for alg in ("layered", "minsum"):
        with pytest.raises(ValueError, match=f"degree {d}"):
            cuda_bp.make_cuda_decoder(code, MAX_ITERS, alg=alg)


def _compact_check_state(msgs: torch.Tensor, syndrome: torch.Tensor):
    """The layered kernel's check-node state of one base row
    (``qtpu_torch/csrc/bp_layered.cu``) in plain PyTorch: from the row's v2c
    messages ``msgs`` (d, lanes) float32 and the syndrome bits (lanes,),
    ``(min1, min2, argmin, signs)`` — the two
    smallest magnitudes (strict ``<``: the first of equal minima is the
    argmin), the argmin slot, and per lane a word whose bit k is the sign of
    c2v_k (syndrome XOR the sign of every message XOR the sign of msg k;
    sign(0) = +1)."""
    d, lanes = msgs.shape
    min1 = torch.full((lanes,), float("inf"), dtype=torch.float32)
    min2 = min1.clone()
    amin = torch.full((lanes,), 255, dtype=torch.int64)
    neg = msgs < 0
    for k in range(d):
        a = msgs[k].abs()
        first = a < min1
        second = ~first & (a < min2)
        min2 = torch.where(first, min1, torch.where(second, a, min2))
        min1 = torch.where(first, a, min1)
        amin = torch.where(first, k, amin)
    flip = (syndrome.to(torch.int64) ^ neg.to(torch.int64).sum(0)) & 1
    weights = torch.tensor([1 << k for k in range(d)], dtype=torch.int64)
    signs = (neg.to(torch.int64) * weights[:, None]).sum(0)
    signs = signs ^ (flip * ((1 << d) - 1))
    return min1, min2, amin, signs


def _c2v_from_compact(min1, min2, amin, signs, d: int,
                      alpha: float = 0.8125) -> torch.Tensor:
    """Every c2v message (d, lanes) of a row rebuilt from its compact
    state, as the layered kernel does: ``sign ? -m : m`` with
    ``m = alpha * (k == argmin ? min2 : min1)``."""
    out = []
    a = torch.tensor(alpha, dtype=torch.float32)
    for k in range(d):
        m = a * torch.where(amin == k, min2, min1)
        out.append(torch.where(((signs >> k) & 1).bool(), -m, m))
    return torch.stack(out)


# v2c magnitudes that make ties, signed zeros and subnormals likely.
_V2C = st.one_of(
    st.sampled_from([float(np.float32(x)) for x in
                     (0.0, -0.0, 1.5, -1.5, 2.0, -2.0, 1e-40, -1e-40,
                      3.4e38, -3.4e38)]),
    st.floats(-1e6, 1e6, width=32))


def _per_edge_c2v(msgs, syn, alpha):
    """Every new c2v of a row in the per-edge form, in the plain decoder's
    float32 operation order (``decode._minsum_row``); the leave-one-out
    minimum of a row with one edge is +inf, as the kernels compute it."""
    coset = 1.0 - 2.0 * syn.to(torch.float32)
    if msgs.shape[0] > 1:
        return torch.stack(_minsum_row(list(msgs), coset, alpha))
    sign = torch.where(msgs[0] < 0, -1.0, 1.0)
    return (alpha * coset * sign * sign * float("inf"))[None]


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, cuda_bp.MAX_DC), data=st.data())
def test_compact_check_state_rebuilds_every_c2v(d, data):
    """(min1, min2, argmin, sign bits) rebuild each c2v of a row bit for
    bit (int32 views, so -0.0 != +0.0) against the per-edge form."""
    msgs = torch.from_numpy(data.draw(hnp.arrays(np.float32, (d, 16),
                                                 elements=_V2C)))
    syn = torch.from_numpy(data.draw(hnp.arrays(
        np.uint8, (16,), elements=st.integers(0, 1))))
    want = _per_edge_c2v(msgs, syn, 0.8125)
    got = _c2v_from_compact(*_compact_check_state(msgs, syn), d,
                            0.8125)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_compact_check_state_initial_and_ties():
    """The zero state rebuilds to +0.0 messages (the per-edge form's
    initial c2v); equal minima keep the first as argmin."""
    zeros = torch.zeros(4, dtype=torch.float32)
    none = torch.zeros(4, dtype=torch.int64)
    got = _c2v_from_compact(zeros, zeros, none, none, 6)
    assert got.numpy().view(np.int32).tolist() == [[0] * 4] * 6
    msgs = torch.tensor([[3.0], [-1.0], [1.0], [-0.0]])
    min1, min2, amin, signs = _compact_check_state(
        msgs, torch.tensor([1], dtype=torch.uint8))
    assert (float(min1), float(min2), int(amin)) == (0.0, 1.0, 3)
    # syndrome 1, one negative message (-1.0; -0.0 counts as +):
    # signs = (1 ^ 1) ^ [0, 1, 0, 0] = 0b0010
    assert int(signs) == 0b0010


@pytest.fixture(scope="module", params=["regular", "mixed_r1"])
def flooding(request):
    """(reference code, llr, syn, plain flooding result): a regular n=1024
    batch from QBER 0.5% to 9% (the top blocks never converge), or rung 1
    of the n=1024 mixed ladder (irregular, punctured columns at LLR 0)."""
    if request.param == "regular":
        code = make_regular_code(1024)
        llr, syn = _scenario(code, np.repeat([0.005, 0.03, 0.06, 0.09], 2),
                             11, 8)
    else:
        step = j_make_rate_ladder(1024, family="mixed", alg="minsum").steps[1]
        code = step.code
        assert step.name == "r0.600" and step.punct_cols == (13, 4)
        llr, syn = _scenario(code, np.repeat([0.005, 0.02, 0.04, 0.06], 2),
                             12, 8)
        for c in step.punct_cols:
            llr[:, c * code.z:(c + 1) * code.z] = 0.0
    res = make_flooding_decoder(code_from_reference(code), MAX_ITERS)(
        torch.from_numpy(llr), torch.from_numpy(syn))
    if request.param == "regular":
        assert res.converged.any() and not res.converged.all()
    return code, llr, syn, res


def test_flooding_vs_xla_minsum(flooding):
    code, llr, syn, res = flooding
    ref = make_batch_decoder(code, max_iters=MAX_ITERS, alg="minsum")(
        jnp.asarray(llr), jnp.asarray(syn))
    _assert_same(ref, res)


def test_flooding_vs_pallas_interpret(flooding):
    code, llr, syn, res = flooding
    ref = make_pallas_decoder(code, max_iters=MAX_ITERS, batch_tile=8,
                              interpret=True, alg="minsum")(
        jnp.asarray(llr), jnp.asarray(syn))
    _assert_same(ref, res)


def test_flooding_vs_golden(flooding):
    _assert_same_as_golden(*flooding, alg="minsum")


def test_flooding_wrapper_runs_plain_decoder_on_cpu(flooding):
    code, llr, syn, res = flooding
    before = dict(cuda_bp.launches)
    got = cuda_bp.make_cuda_decoder(code_from_reference(code), MAX_ITERS,
                                    alg="minsum")(
        torch.from_numpy(llr), torch.from_numpy(syn))
    _assert_same(res, got)
    assert cuda_bp.launches == before


def _flooding_table_parts(code, tab):
    """The flooding kernel's table split into its seven arrays."""
    mb, nb, E = code.mb, code.nb, code.num_edges
    cuts = np.cumsum([mb + 1, E, E, nb + 1, E, E])
    return np.split(tab, cuts)


def _walk_flooding_kernel(code, llr, syn, max_iters, alpha=0.8125):
    """The flooding kernel's dataflow (``qtpu_torch/csrc/bp_flooding.cu``)
    in plain PyTorch, driven by ``cuda_bp.flooding_tables``: phase A per
    (row, lane) from the compact record (alpha*min1, alpha*min2, argmin,
    sign bits), phase B per (column, lane) from each column edge's (row,
    slot, shift), rebuilding c2v' from the record of row i at lane
    (v - s) mod z, added in column slot order.  Every round it also forms,
    from the code's own edge lists and not from the table, each rolled
    total, each c2v' in the per-edge form (``decode._minsum_row``) and the
    totals from those, and holds them to the compact path bit for bit
    (int32 views).  Returns (bits, iterations, converged, final totals)."""
    mb, nb, z = code.mb, code.nb, code.z
    row_start, rcol, rshift, col_start, crow, cslot, cshift = \
        _flooding_table_parts(code, cuda_bp.flooding_tables(code))
    B = llr.shape[0]
    L = torch.from_numpy(llr).reshape(B, nb, z)
    S = torch.from_numpy(syn).reshape(B, mb, z).to(torch.int64)
    a = torch.tensor(alpha, dtype=torch.float32)
    lanes = torch.arange(z)
    row_edges = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    col_edges = [[int(e) for e in col if e >= 0] for col in code.col_edges]
    m1, m2 = torch.zeros(B, mb, z), torch.zeros(B, mb, z)
    sg = torch.zeros(B, mb, z, dtype=torch.int64)
    am = torch.zeros(B, mb, z, dtype=torch.int64)
    tot = L.clone()
    bits = torch.zeros(B, nb, z, dtype=torch.uint8)
    iters = torch.zeros(B, dtype=torch.int32)
    conv = torch.zeros(B, dtype=torch.bool)
    done = torch.zeros(B, dtype=torch.bool)

    def rebuild(rec, i, k, p):
        """c2v of row i's slot k at lanes p from the records ``rec``."""
        r1, r2, rsg, ram = (x[:, i, p] for x in rec)
        mag = torch.where(ram == k, r2, r1)
        return torch.where(((rsg >> k) & 1).bool(), -mag, mag)

    def same(x, y):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))

    for it in range(max_iters + 1):
        new = [m1.clone(), m2.clone(), sg.clone(), am.clone()]
        per_edge = {}
        ok = torch.ones(B, dtype=torch.bool)
        for i in range(mb):
            s0, d = row_start[i], row_start[i + 1] - row_start[i]
            par = S[:, i].clone()
            min1 = torch.full((B, z), float("inf"))
            min2 = min1.clone()
            amin = torch.full((B, z), 255, dtype=torch.int64)
            vneg = torch.zeros((B, z), dtype=torch.int64)
            msgs = []
            for k in range(d):
                t = tot[:, rcol[s0 + k], (lanes + rshift[s0 + k]) % z]
                e = row_edges[i][k]
                same(t, torch.roll(tot[:, code.edge_col[e]],
                                   -int(code.edge_shift[e]), 1))
                par ^= (t < 0).long()
                m = t - rebuild((m1, m2, sg, am), i, k, lanes)
                msgs.append(m)
                vneg |= (m < 0).long() << k
                mag = m.abs()
                first = mag < min1
                second = ~first & (mag < min2)
                min2 = torch.where(first, min1, torch.where(second, mag, min2))
                min1 = torch.where(first, mag, min1)
                amin = torch.where(first, k, amin)
            ok &= (par == 0).all(dim=1)
            flip = (S[:, i] ^ sum((vneg >> k) & 1 for k in range(d))) & 1
            new[0][:, i], new[1][:, i] = a * min1, a * min2
            new[2][:, i] = vneg ^ (flip * 0xFFFFFFFF)
            new[3][:, i] = amin
            want = _minsum_row(msgs, 1.0 - 2.0 * S[:, i].float(), alpha)
            for k in range(d):
                per_edge[row_edges[i][k]] = want[k]
                same(rebuild(new, i, k, lanes), want[k])
        stop = ~done & (ok | (it == max_iters))
        iters[stop] = it
        conv[stop] = ok[stop]
        bits[stop] = (tot[stop] < 0).to(torch.uint8)
        done |= stop
        if bool(done.all()):
            break
        run = ~done
        m1, m2, sg, am = (torch.where(run[:, None, None], x, y)
                          for x, y in zip(new, (m1, m2, sg, am)))
        nxt = tot.clone()
        for j in range(nb):
            acc, acc_edge = L[:, j].clone(), L[:, j].clone()
            for e in range(col_start[j], col_start[j + 1]):
                i, k, s = crow[e], cslot[e], cshift[e]
                acc = acc + rebuild((m1, m2, sg, am), i, k, (lanes - s) % z)
            for e in col_edges[j]:
                acc_edge = acc_edge + torch.roll(
                    per_edge[e], int(code.edge_shift[e]), 1)
            same(acc[run], acc_edge[run])
            nxt[:, j] = acc
        tot = torch.where(run[:, None, None], nxt, tot)
    return (bits.reshape(B, nb * z), iters, conv, tot.reshape(B, nb * z))


@pytest.fixture(scope="module")
def flooding_walk(flooding):
    code, llr, syn, _ = flooding
    return _walk_flooding_kernel(code_from_reference(code), llr, syn,
                                 MAX_ITERS)


@pytest.mark.parametrize("ref", ["plain", "pallas_interpret", "xla"])
def test_flooding_kernel_walk(flooding, flooding_walk, ref):
    """The kernel's table and compact-state round, walked on the CPU, equal
    the plain decoder, the Pallas kernel in interpret mode and the XLA
    decoder (bits, iterations, converged), exactly."""
    code, llr, syn, res = flooding
    if ref == "pallas_interpret":
        res = make_pallas_decoder(code, max_iters=MAX_ITERS, batch_tile=8,
                                  interpret=True, alg="minsum")(
            jnp.asarray(llr), jnp.asarray(syn))
    elif ref == "xla":
        res = make_batch_decoder(code, max_iters=MAX_ITERS, alg="minsum")(
            jnp.asarray(llr), jnp.asarray(syn))
    bits, iters, conv, _ = flooding_walk
    _assert_same(res, BatchDecodeResult(bits, conv, iters))


def _sumprod(code, llr, syn):
    """The port's sum-product through the sessions' decoder."""
    before = dict(cuda_bp.launches)
    res = tdecode.make_batch_decoder(code_from_reference(code), MAX_ITERS,
                                     "sumprod")(
        torch.from_numpy(llr), torch.from_numpy(syn))
    assert cuda_bp.launches == before    # no kernel: plain on every device
    return res


def _assert_same_converged(bits, converged, iterations, res):
    """Sum-product tolerance: tanh/atanh come from each library's own
    math, so a block that never converges may part in its last bits after
    many iterations.  Converged blocks must agree exactly (bits, iterations,
    flag); on the others only the flag is compared."""
    conv = np.asarray(converged)
    np.testing.assert_array_equal(conv, res.converged.numpy())
    assert conv.any()
    np.testing.assert_array_equal(np.asarray(bits)[conv],
                                  res.bits.numpy()[conv])
    np.testing.assert_array_equal(np.asarray(iterations)[conv],
                                  res.iterations.numpy()[conv])


def test_sumprod_vs_xla(flooding):
    code, llr, syn, _ = flooding
    ref = make_batch_decoder(code, max_iters=MAX_ITERS, alg="sumprod")(
        jnp.asarray(llr), jnp.asarray(syn))
    _assert_same_converged(ref.bits, ref.converged, ref.iterations,
                           _sumprod(code, llr, syn))


def test_sumprod_vs_golden(flooding):
    code, llr, syn, _ = flooding
    gold = [golden.decode(code, llr[b], syn[b], max_iters=MAX_ITERS,
                          alg="sumprod") for b in range(llr.shape[0])]
    _assert_same_converged([g.bits.reshape(-1) for g in gold],
                           [g.converged for g in gold],
                           [g.iterations for g in gold],
                           _sumprod(code, llr, syn))


def test_pick_decoder_routes_minsum_to_flooding(flooding):
    code, llr, syn, res = flooding
    got = tdecode.make_batch_decoder(code_from_reference(code), MAX_ITERS,
                                     "minsum")(
        torch.from_numpy(llr), torch.from_numpy(syn))
    _assert_same(res, got)


def _parallel_edge_code(pkg):
    """A small QC code whose base row 0 holds two edges into column 0 and
    row 1 two into column 3 (in ``pkg``, the reference's or the port's
    ``codes`` module)."""
    rows = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1], np.int32)
    cols = np.array([0, 0, 1, 2, 1, 2, 3, 3, 0], np.int32)
    shifts = np.array([0, 5, 3, 7, 1, 2, 0, 9, 4], np.int32)
    return pkg.QCCode(z=16, mb=2, nb=4, edge_row=rows, edge_col=cols,
                      edge_shift=shifts,
                      row_edges=pkg._group_edges(rows, 2),
                      col_edges=pkg._group_edges(cols, 4))


def test_flooding_takes_parallel_edges():
    """The flooding table of a code with parallel edges: each row slot's
    column and shift in row order, each column edge's (row, slot within the
    row, shift) in column slot order; the kernel's walk over it equals the
    golden model, the plain decoder, the XLA decoder and the Pallas kernel
    in interpret mode."""
    import qtpu.ldpc.codes as jcodes
    import qtpu_torch.ldpc.codes as tcodes
    ref, code = _parallel_edge_code(jcodes), _parallel_edge_code(tcodes)
    with pytest.raises(ValueError, match="parallel"):
        cuda_bp.code_tables(code)
    tab = cuda_bp.flooding_tables(code)
    assert len(tab) == code.mb + code.nb + 2 + 5 * code.num_edges
    row_start, rcol, rshift, col_start, crow, cslot, cshift = \
        _flooding_table_parts(code, tab)
    assert list(row_start) == [0, 4, 9] and list(col_start) == [0, 3, 5, 7, 9]
    rows = [[e for e in row if e >= 0] for row in code.row_edges]
    order = [e for row in rows for e in row]
    np.testing.assert_array_equal(rcol, code.edge_col[order])
    np.testing.assert_array_equal(rshift, code.edge_shift[order])
    for j, col in enumerate(code.col_edges):
        slots = [e for e in col if e >= 0]
        got = range(col_start[j], col_start[j + 1])
        assert [rows[crow[g]][cslot[g]] for g in got] == slots
        np.testing.assert_array_equal(cshift[col_start[j]:col_start[j + 1]],
                                      code.edge_shift[slots])
    llr, syn = _scenario(ref, np.repeat([0.01, 0.05, 0.1, 0.2], 2), 13, 8)
    res = cuda_bp.make_cuda_decoder(code, MAX_ITERS, alg="minsum")(
        torch.from_numpy(llr), torch.from_numpy(syn))
    _assert_same_as_golden(ref, llr, syn, res, alg="minsum")
    walk = _walk_flooding_kernel(code, llr, syn, MAX_ITERS)
    walk = BatchDecodeResult(walk[0], walk[2], walk[1])
    _assert_same(res, walk)
    for dec in (make_batch_decoder(ref, max_iters=MAX_ITERS, alg="minsum"),
                make_pallas_decoder(ref, max_iters=MAX_ITERS, batch_tile=8,
                                    interpret=True, alg="minsum")):
        _assert_same(dec(jnp.asarray(llr), jnp.asarray(syn)), walk)


@pytest.mark.parametrize("n,family,alg", [
    (65536, "native3", "layered"), (1024, "mixed", "layered"),
    (4096, "mixed", "minsum"), (1024, "regular", "minsum")])
def test_rate_ladder_matches_reference(n, family, alg):
    kw = dict(seed=0x51C0DE, alg=alg, family=family)
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
