"""qtpu_torch.window_programs vs qtpu.window_programs, program by program.

The same arena bits and the same header go through the JAX programs and
their PyTorch counterparts (CPU tensors, so the decoder is the plain PyTorch
one); every output must be identical: payload, syndromes, verify hashes,
test/short disclosures, hat, rx_orig, rx_pin, pin mask, stats, the retry
outputs, PA rows and packed words.  Geometry: the n=1024, B=4 ladder of
tests/test_pipeline.py (a punctured rung), plus a regular n=1024 code with
one shortened and one punctured column (PRNG shortening fill).

Tolerance: exact everywhere, with one stated exception.  XLA on the CPU
contracts the decoder's ``alpha*min - c2v`` into one FMA, where the golden
model (and the port, and the CUDA kernel) round twice; on blocks that never
converge the two trajectories part after many sweeps.  So the decoded
payload ``hat`` and its error count are compared on verified blocks only
(tests/test_torch_decode.py holds the port to golden on non-converging
blocks too).  Everything else — verify flags, iteration counts, pins,
mismatch counts — is compared on every block.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from qtpu import prng
from qtpu.ldpc import golden
from qtpu.ldpc.codes import make_regular_code
from qtpu.link import make_direct_pair
from qtpu.pipeline import BobSession, PipelineConfig
from qtpu.window_programs import make_header as j_make_header
from qtpu.window_programs import make_window_programs as j_make_programs
from qtpu_torch.ldpc.codes import code_from_reference
from qtpu_torch.pa import _toeplitz_hash, toeplitz_margin
from qtpu_torch.window_programs import make_header, make_window_programs

B, MAX_ITERS, VH = 4, 60, 64


def _expand(cols, z):
    cols = np.asarray(sorted(cols), np.int64)
    if cols.size == 0:
        return np.zeros(0, np.int64)
    return (cols[:, None] * z + np.arange(z)[None, :]).reshape(-1)


def _geometry(kind):
    """(code, pay_pos, punct_pos, short_pos, l_max, k_pb, s_max, retry)."""
    if kind == "pipeline_rung":
        cfg = PipelineConfig(n=1024, blocks_per_window=B, qber_test_bits=512,
                             max_iters=MAX_ITERS, verify_hash_bits=VH,
                             security_margin_bits=64)
        party = BobSession(cfg, 0x5E55, make_direct_pair()[1])
        r = 1
        pos = party._step_positions[r]
        prog = party.programs(r)
        return (party.ladder.steps[r].code, pos["payload"], pos["punct"],
                pos["short"], prog.l_max, prog.k_pb, prog.s_max,
                prog.retry_bits)
    code = make_regular_code(1024)
    z = code.z
    pay = _expand([c for c in range(code.nb) if c not in (3, 9)], z)
    return code, pay, _expand([9], z), _expand([3], z), 300, 16, 96, 100


@pytest.fixture(scope="module", params=["pipeline_rung", "short_and_punct"])
def case(request):
    code, pay, punct, short, l_max, k_pb, s_max, kr = _geometry(request.param)
    P = pay.size
    args = (pay, punct, short, MAX_ITERS, "layered", VH, l_max, B, k_pb)
    kw = dict(s_max=s_max, retry_bits=kr)
    jp = j_make_programs(code, *args, **kw)
    tp = make_window_programs(code_from_reference(code), *args, **kw,
                              device="cpu")
    rng = np.random.default_rng(21)
    cap, cursor = 1 << 15, 77
    a_arena = rng.integers(0, 2, cap, dtype=np.uint8)
    # Blocks 0-1 clean-ish, 2-3 noisy enough to fail the first decode.
    q = np.zeros(cap)
    q[cursor:cursor + B * P] = np.repeat([0.01, 0.02, 0.09, 0.12], P)
    b_arena = a_arena ^ (rng.random(cap) < q).astype(np.uint8)
    a, ainv = 5, pow(5, -1, P)
    wkey = prng.key_data(prng.derive(prng.root_key(9), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(10), "punct", 0))
    hdr_a = j_make_header(cursor, s_max // 2, wkey, pkey, test_bits_pb=k_pb // 2,
                          affine=(a, ainv, 11))
    hdr_b = j_make_header(cursor, s_max // 2, wkey, test_bits_pb=k_pb // 2,
                          affine=(a, ainv, 11))
    assert np.array_equal(hdr_a, make_header(cursor, s_max // 2, wkey, pkey,
                                             test_bits_pb=k_pb // 2,
                                             affine=(a, ainv, 11)))
    qmag = np.float32(np.log(0.97 / 0.03))
    j_alice = jp.alice(jnp.asarray(a_arena), jnp.asarray(hdr_a))
    t_alice = tp.alice(torch.from_numpy(a_arena), hdr_a)
    payload, syn, hashes, test_v, short_v = (np.asarray(x) for x in j_alice)
    j_bob = jp.bob(jnp.asarray(b_arena), jnp.asarray(hdr_b),
                   jnp.asarray(test_v), jnp.asarray(short_v),
                   jnp.asarray(syn), jnp.asarray(hashes), jnp.float32(qmag))
    t_bob = tp.bob(torch.from_numpy(b_arena), hdr_b,
                   torch.from_numpy(test_v.copy()),
                   torch.from_numpy(short_v.copy()),
                   torch.from_numpy(syn.copy()),
                   torch.from_numpy(hashes.copy()), qmag)
    return dict(code=code, jp=jp, tp=tp, P=P, B=B, hdr_b=hdr_b, qmag=qmag,
                a_arena=a_arena, b_arena=b_arena, j_alice=j_alice,
                t_alice=t_alice, j_bob=j_bob, t_bob=t_bob, kr=kr)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy())


def _eq_decoded(j_hat, t_hat, j_stats, t_stats):
    """Decode outputs: stats [ok, iters, mismatches] on every block; hat
    and errs on verified blocks (see the module docstring)."""
    js, ts = np.asarray(j_stats), t_stats.numpy()
    np.testing.assert_array_equal(js[:, [0, 1, 3]], ts[:, [0, 1, 3]])
    ok = ts[:, 0].astype(bool)
    np.testing.assert_array_equal(js[ok, 2], ts[ok, 2])
    np.testing.assert_array_equal(np.asarray(j_hat)[ok], t_hat.numpy()[ok])


def test_alice_program(case):
    for j, t in zip(case["j_alice"], case["t_alice"]):
        _eq(j, t)


def test_bob_program(case):
    jb, tb = case["j_bob"], case["t_bob"]
    for j, t in zip(jb[1:4], tb[1:4]):    # rx_orig, rx_pin, pinmask
        _eq(j, t)
    _eq_decoded(jb[0], tb[0], jb[4], tb[4])
    stats = case["t_bob"][4].numpy()
    # The geometry exercises both outcomes: blocks that verify and fail.
    assert stats[:, 0].any() and not stats[:, 0].all()


def _retry_inputs(case):
    P, kr = case["P"], case["kr"]
    stats = case["t_bob"][4].numpy()
    failed = ~stats[:, 0].astype(bool)
    positions = np.asarray(prng.subset_indices(prng.root_key(3), P, kr),
                           np.int32)
    j_bits = np.asarray(case["jp"].retry_gather(
        jnp.asarray(case["j_alice"][0]), jnp.asarray(positions)))
    t_bits = case["tp"].retry_gather(case["t_alice"][0], positions)
    _eq(j_bits, t_bits)
    return failed, positions, j_bits


def test_retry_program(case):
    """The port's one retry on the failed rows == the reference's
    ``retry_program``, which re-decodes every row and merges the failed
    ones: an unfailed row re-decodes from its own pins to its own
    iterations, so the two agree where the old stats are the first
    decode's, as the protocol hands them over."""
    failed, positions, bits = _retry_inputs(case)
    jb, tb = case["j_bob"], case["t_bob"]
    jt = case["jp"].retry(
        jnp.asarray(case["b_arena"]), jnp.asarray(case["hdr_b"]), jb[1],
        jb[2], jb[3], jb[0], jb[4], jnp.asarray(failed.astype(np.uint8)),
        jnp.asarray(positions), jnp.asarray(bits),
        case["j_alice"][1], case["j_alice"][2], jnp.float32(case["qmag"]))
    tt = case["tp"].retry(
        torch.from_numpy(case["b_arena"]), case["hdr_b"], tb[1], tb[2], tb[3],
        tb[0], tb[4], np.flatnonzero(failed), positions,
        torch.from_numpy(bits.copy()), case["t_alice"][1],
        case["t_alice"][2], case["qmag"])
    _eq(jt[1], tt[1])
    _eq(jt[2], tt[2])
    _eq_decoded(jt[0], tt[0], jt[3], tt[3])


def test_retry_small_program(case):
    """The port's one retry == the reference's ``retry_small``, whose
    fixed R-row index pads the failed rows with the out-of-range row B
    and a ``valid`` mask (XLA shape artifacts the port has not)."""
    failed, positions, bits = _retry_inputs(case)
    R = case["B"]
    nf = int(failed.sum())
    rows = np.full(R, case["B"], np.int32)
    rows[:nf] = np.flatnonzero(failed)
    valid = np.zeros(R, np.uint8)
    valid[:nf] = 1
    jb, tb = case["j_bob"], case["t_bob"]
    jt = case["jp"].retry_small(
        jnp.asarray(case["b_arena"]), jnp.asarray(case["hdr_b"]), jb[1],
        jb[2], jb[3], jb[0], jb[4], jnp.asarray(rows), jnp.asarray(valid),
        jnp.asarray(positions), jnp.asarray(bits), case["j_alice"][1],
        case["j_alice"][2], jnp.float32(case["qmag"]))
    tt = case["tp"].retry(
        torch.from_numpy(case["b_arena"]), case["hdr_b"], tb[1], tb[2], tb[3],
        tb[0], tb[4], np.flatnonzero(failed), positions,
        torch.from_numpy(bits.copy()), case["t_alice"][1],
        case["t_alice"][2], case["qmag"])
    _eq(jt[1], tt[1])
    _eq(jt[2], tt[2])
    _eq_decoded(jt[0], tt[0], jt[3], tt[3])


def test_pa_and_pack(case):
    pakey = prng.key_data(prng.derive(prng.root_key(5), "pa", 0, 0))
    jfk = case["jp"].pa(case["j_alice"][0], jnp.asarray(pakey))
    tfk = case["tp"].pa(case["t_alice"][0], pakey)
    _eq(jfk, tfk)
    jw = np.asarray(case["jp"].pack(jfk))
    tw = case["tp"].pack(tfk).numpy().view(np.uint32)
    np.testing.assert_array_equal(jw, tw)


def test_verified_blocks_recover_payload(case):
    """Every block that passed verification decoded to Alice's payload."""
    payload = case["t_alice"][0].numpy()
    hat = case["t_bob"][0].numpy()
    ok = case["t_bob"][4].numpy()[:, 0].astype(bool)
    np.testing.assert_array_equal(hat[ok], payload[ok])


def test_toeplitz_hash_exact_gf2():
    """The FFT Toeplitz hash is the exact GF(2) product (margin < 0.25)."""
    rng = np.random.default_rng(4)
    b, n, m = 4, 700, 300
    t = rng.integers(0, 2, (b, m + n - 1), dtype=np.uint8)
    x = rng.integers(0, 2, (b, n), dtype=np.uint8)
    got = _toeplitz_hash(torch.from_numpy(t), torch.from_numpy(x), m).numpy()
    for r in range(b):
        T = np.stack([t[r, i:i + n][::-1] for i in range(m)])
        want = (T.astype(np.int64) @ x[r].astype(np.int64)) & 1
        np.testing.assert_array_equal(got[r], want)
    assert toeplitz_margin(t, x, m) < 0.25


def test_encoder_matches_golden():
    from qtpu_torch.ldpc.encode import make_batch_encoder
    code = make_regular_code(1024)
    keys = np.random.default_rng(2).integers(0, 2, (4, code.n),
                                             dtype=np.uint8)
    syn = make_batch_encoder(code_from_reference(code))(
        torch.from_numpy(keys)).numpy()
    for b in range(keys.shape[0]):
        np.testing.assert_array_equal(
            syn[b], golden.encode_syndrome(code, keys[b]).reshape(-1))
