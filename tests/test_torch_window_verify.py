"""The verify hash and Bob's decode tail (``qtpu_torch.window_verify``)
against the reference, a model of their kernel's word algorithm, and the
host side of the kernel's wrappers.

``hash_plain`` and ``tail_plain`` are held to ``qtpu``'s programs on one
window of a regular n = 1024 code with a shortened and a punctured column
(B = 12, ten blocks noisy enough to fail): Alice's hashes; Bob's first
decode; the port's retry of the ten failed rows against the reference's
``retry_program``, which re-decodes every row and merges the failed ones
(the two agree because the old stats are the first decode's own, as the
protocol hands them over: an unfailed row re-decodes to its own
iterations); its retry of four of the failed rows against the
reference's ``retry_small``; its retry of all twelve rows against
``retry_program`` with every row failed.  The port's programs call
``window_verify.tail`` (on CPU tensors its plain version); each call's
arguments are recorded and ``tail_plain`` is called on them again.  Tolerance: exact, except that hat and the error count are
compared on verified blocks only (XLA on the CPU contracts the decoder's
``alpha*min - c2v`` into an FMA, see tests/test_torch_window_programs.py).

A numpy model of ``qtpu_torch/csrc/verify.cu`` (runs of 16 bytes packed
to 16 bits by four multiplies, two runs to a word, lane l's hash bits l
and l + 32 from funnel shifts of seed words (w, w + 1) and (w + 1, w + 2),
the second reused as the first of word w + 1, parity by popcount, the
slices' words XORed; the payload column of a position by the kernel's
reciprocal of z; each mode's merge through the row map the wrapper
builds) is held to the plain versions, exactly: the hash at P = 0, 1 and
31 (mod 32), Vh = 1, 31, 32, 33 and 64, and rows that start one byte off
alignment; the tail on every recorded call (the first decode, and the
rows merge at 4, 10 and all 12 rows).

The launch plan (``window_verify.plan``, on a model of an H100's
occupancy: the resident clusters the card reported) is held to the split
the kernel makes: for every plan at 1, 8, 11, 32, 128 and 300 rows (the
hash, the first decode and a retry of a few of them), P of production
rungs 0, 4 and 9 and of z = 16, 24 and 10 codes, Vh 1, 31, 33 and 64,
rows at offset 0 and one byte off, the XOR of the slices' partial hashes,
each group's against only the 20 seed words its warp packs (every other
seed word random), is ``hash_plain``'s, and the slices' error counts sum
to ``tail_plain``'s.
The plan's properties: every word in exactly one slice, whole groups of
16 words, C <= 16, shared memory under the limit, a retry's kept rows on
CTAs of their own after the merged rows' clusters, and a plan no card
can schedule raises.

The wrappers' checks run without a card: with ``_on_card`` patched to take
the CPU for a card, malformed arguments raise ValueError before anything
is built, and a well-formed call raises when the kernel cannot be built
instead of falling back to the plain version.  The kernel itself is held
to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 5d).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu import prng
from qtpu.ldpc.codes import make_regular_code
from qtpu.window_programs import make_header as j_make_header
from qtpu.window_programs import make_window_programs as j_make_programs
from qtpu_torch import _build
from qtpu_torch import random as tr
from qtpu_torch import window_verify as wv
from qtpu_torch.ldpc.codes import code_from_reference
from qtpu_torch.ldpc.encode import ColumnLayout
from qtpu_torch.window_programs import TAG_VERIFY, make_window_programs

B, MAX_ITERS, VH = 12, 60, 64


def _expand(cols, z):
    return (np.asarray(sorted(cols), np.int64)[:, None] * z
            + np.arange(z)[None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# A numpy model of the kernel.

def _low_bits16(w: np.ndarray) -> np.ndarray:
    """(..., 4) little-endian words of 16 bytes -> their lowest bits, byte m
    at bit m: four multiplies (the kernel's low_bits16)."""
    w = w.astype(np.uint64)
    nib = (((w & np.uint64(0x01010101)) * np.uint64(0x10204080))
           & np.uint64(0xFFFFFFFF)) >> np.uint64(28)
    return (nib << np.arange(0, 16, 4, dtype=np.uint64)).sum(axis=-1).astype(
        np.uint32)


def _pack(row: np.ndarray, words: int) -> np.ndarray:
    """``row``'s lowest bits, LSB-first, in ``words`` uint32 words (zeros
    past its end), as the kernel packs them: a lane's run of 16 bytes to 16
    bits, two lanes' runs (a shuffle) to a word."""
    buf = np.zeros(32 * words, np.uint8)
    buf[:row.size] = row
    runs = _low_bits16(buf.view("<u4").reshape(-1, 4))
    return runs[0::2] | (runs[1::2] << np.uint32(16))


def _funnel(lo, hi, shift):
    """__funnelshift_r(lo, hi, shift) for shift in 0..31, each word of lo
    and hi (n,) against each shift (32,): (n, 32)."""
    v = ((np.asarray(hi, np.uint64)[:, None] << np.uint64(32))
         | np.asarray(lo, np.uint64)[:, None])
    return ((v >> shift.astype(np.uint64)[None, :])
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _slice_hash(X: np.ndarray, S: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """(2,) partial hash words (bit l of word h: hash bit l + 32 h) of row
    words X[w0:w1] against seed words S (S[w] the seed word of row word w,
    read up to w1 + 1): lane l's accumulators take X[w] & fs(S[w], S[w + 1],
    l) and X[w] & fs(S[w + 1], S[w + 2], l), parity by popcount."""
    lanes = np.arange(32)
    w = np.arange(w0, w1)
    H = np.zeros(2, np.uint32)
    if not w.size:
        return H
    for h, lo in enumerate((w, w + 1)):
        acc = np.bitwise_xor.reduce(X[w, None] & _funnel(S[lo], S[lo + 1],
                                                         lanes), axis=0)
        parity = (np.bitwise_count(acc) & 1).astype(np.uint64)
        H[h] = int((parity << lanes.astype(np.uint64)).sum())
    return H


def _hash_bits(H: np.ndarray, vh: int) -> np.ndarray:
    j = np.arange(vh)
    return ((H[j // 32] >> (j % 32).astype(np.uint32)) & 1).astype(np.uint8)


def _model_hash_row(x: np.ndarray, S: np.ndarray, vh: int) -> np.ndarray:
    """(vh,) hash bits of one row ``x`` (P bytes) against the packed seed
    ``S`` (zeros past the seed, through word 16 G + 3): the row's groups of
    16 words, each hashed by one warp, XORed."""
    G = wv._groups(x.size)
    return _hash_bits(_slice_hash(_pack(x, 16 * G), S, 0, 16 * G), vh)


def _packed_seed(seed: np.ndarray, words: int) -> np.ndarray:
    """The seed packed to ``words`` words (zeros past it)."""
    return _pack(seed, words)


def _model_hash(buf: np.ndarray, offset: int, b: int, P: int,
                seed: np.ndarray) -> np.ndarray:
    """(b, Vh) hashes of the rows of ``buf`` from byte ``offset`` on, row d
    at offset + d·P (the kernel's addressing)."""
    vh = seed.size - P + 1
    S = _packed_seed(seed, 16 * (wv._groups(P) + 1))
    return np.stack([_model_hash_row(buf[offset + d * P:offset + (d + 1) * P],
                                     S, vh) for d in range(b)])


def _payload_source(layout: ColumnLayout) -> np.ndarray:
    """(P,) each payload position's place in a decoded row: its column by
    the kernel's reciprocal of z (and one correction), looked up in the
    table the kernel builds from the layout's sources."""
    z, nb = layout.z, layout.nb
    P = layout.widths[0] * z
    cols = np.zeros(nb, np.int64)
    for j in range(nb):
        if layout.sources[0, j] == 0:
            cols[layout.sources[1, j]] = j
    zinv = ((1 << 32) + z - 1) // z
    p = np.arange(P, dtype=np.uint64)
    q = ((p * np.uint64(zinv)) >> np.uint64(32)).astype(np.int64)
    q -= q * z > p.astype(np.int64)
    return cols[q] * z + p.astype(np.int64) - q * z


def _model_tail(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
                iterations, layout, mism=None, *, hat=None, stats=None,
                rows=None):
    """The kernel's tail, row by row, on numpy copies of the arguments."""
    n = (lambda t: None if t is None else t.numpy())
    bits, rx_pin, pin, rx_orig, seed, exp, conv, iters, mism, hat, stats = (
        n(t) for t in (bits, rx_pin, pin, rx_orig, seed, exp_hashes,
                       converged, iterations, mism, hat, stats))
    mode = wv._mode(mism, hat, stats, rows)
    b, P = rx_pin.shape
    vh = seed.size - P + 1
    rows_out = b if mode == wv.FIRST else hat.shape[0]
    src = (np.arange(b) if mode == wv.FIRST
           else wv._source_rows(rows, b, rows_out))
    where = _payload_source(layout)
    S = _packed_seed(seed, 16 * (wv._groups(P) + 1))
    hat_out = np.zeros((rows_out, P), np.uint8)
    st = np.zeros((rows_out, 4), np.int32)
    for d in range(rows_out):
        i = src[d]
        if i < 0:
            hat_out[d] = hat[d]
            st[d] = stats[d]
            continue
        h = np.where(pin[i], rx_pin[i], bits[i, where])
        hat_out[d] = h
        ok = bool(np.array_equal(_model_hash_row(h, S, vh), exp[d])
                  and conv[i])
        errs = int((h ^ rx_orig[d]).astype(np.int64).sum())
        if mode == wv.FIRST:
            st[d] = [ok, iters[i], errs, mism[d]]
        else:
            st[d] = [ok, max(stats[d, 1], iters[i]), errs, stats[d, 3]]
    return hat_out, st


@pytest.mark.parametrize("P", [32 * 7, 32 * 9 + 1, 32 * 11 + 31, 32 * 70])
@pytest.mark.parametrize("vh", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_word_model_equals_hash_plain(P, vh, offset):
    """The kernel's word algorithm == hash_plain, at P = 0, 1 and 31
    (mod 32), Vh across the two words a lane holds, rows at offset 0 and
    one byte off alignment (each row P bytes after the last); P = 2,240
    is 5 groups of 16 words, the last with 6."""
    rng = np.random.default_rng(P * 100 + vh)
    b = 3
    buf = rng.integers(0, 2, offset + b * P, dtype=np.uint8)
    seed = rng.integers(0, 2, P + vh - 1, dtype=np.uint8)
    x = torch.from_numpy(buf[offset:].reshape(b, P).copy())
    want = wv.hash_plain(x, torch.from_numpy(seed)).numpy()
    np.testing.assert_array_equal(_model_hash(buf, offset, b, P, seed), want)


def test_kernel_run_arithmetic():
    """A run of 16 bytes, as the kernel's vector body takes it: the four
    multiplies give each byte's lowest bit, the select by pin bytes (0/1
    times 0xFF) is where(pin, rx_pin, bits), and the byte sums (__vsadu4)
    of hat ^ rx_orig are the plain error count, for bytes 0..255."""
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (500, 16), dtype=np.uint8)
    bits = _low_bits16(data.view("<u4"))
    want = ((data & 1).astype(np.uint32)
            << np.arange(16, dtype=np.uint32)).sum(axis=1)
    np.testing.assert_array_equal(bits, want)
    rp, bt, ro = (rng.integers(0, 256, (500, 16), dtype=np.uint8)
                  for _ in range(3))
    pm = rng.integers(0, 2, (500, 16), dtype=np.uint8)
    m = pm.view("<u4") * np.uint32(0xFF)
    hat = (rp.view("<u4") & m) | (bt.view("<u4") & ~m)
    np.testing.assert_array_equal(hat.view(np.uint8),
                                  np.where(pm == 1, rp, bt))
    sums = (hat.view(np.uint8) ^ ro).astype(np.int64).sum(axis=1)
    plain = (torch.from_numpy(np.where(pm == 1, rp, bt) ^ ro)
             .to(torch.int32).sum(dim=1, dtype=torch.int32))
    np.testing.assert_array_equal(sums, plain.numpy())


def test_hash_plain_is_the_toeplitz_product():
    """Hash bit j of row x is parity(sum_i x[i] t[i + j])."""
    rng = np.random.default_rng(3)
    P, vh = 97, 5
    x = rng.integers(0, 2, (4, P), dtype=np.uint8)
    t = rng.integers(0, 2, P + vh - 1, dtype=np.uint8)
    want = np.stack([[int(x[r] @ t[j:j + P]) & 1 for j in range(vh)]
                     for r in range(4)])
    got = wv.hash_plain(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("z", [10, 16, 24, 64, 2048])
def test_kernel_column_lookup_equals_the_payload_extract(z):
    """The kernel's position -> (column, offset) by a reciprocal of z ==
    the plain version's column gather, payload columns spread over the
    base columns."""
    nb = 12
    layout = ColumnLayout(nb, z, [0, 2, 3, 5, 8, 9, 11], [1, 4], [6, 7, 10])
    P = layout.widths[0] * z
    bits = np.random.default_rng(z).integers(0, 256, (2, nb * z),
                                             dtype=np.uint8)
    pay = wv._payload_columns(layout)
    want = bits.reshape(2, nb, z)[:, pay, :].reshape(2, P)
    np.testing.assert_array_equal(bits[:, _payload_source(layout)], want)


# ---------------------------------------------------------------------------
# The launch plan and the split it makes.

# cudaOccupancyMaxActiveClusters of the tail's kernel on an NVIDIA H100
# 80GB HBM3 (132 SMs) at one, two and four CTAs an SM (1,024, 512 and 256
# threads at 64 registers a thread), by cluster size.
H100_CLUSTERS = {1: (132, 264, 528), 2: (66, 132, 264), 4: (30, 62, 124),
                 8: (15, 30, 62), 16: (7, 14, 28)}


def _occupancy(C, threads, smem):
    """A model of cudaOccupancyMaxActiveClusters on an H100: the CTAs an
    SM holds (2,048 threads and 65,536 registers at 64 a thread, 32 CTAs,
    227 KB of shared memory), and the clusters the card reported at one,
    two and four CTAs an SM (more CTAs an SM: four's, in proportion)."""
    per_sm = min(2048 // threads, 65536 // (64 * threads), 32,
                 232448 // (smem + 1024))
    if per_sm <= 0:
        return 0
    one, two, four = H100_CLUSTERS[C]
    return {1: one, 2: two, 3: two, 4: four}.get(per_sm, four * per_sm // 4)


SMS = 132
PLAN_ROWS = [1, 8, 11, 32, 128, 300]


@pytest.fixture(scope="module")
def plan_layouts():
    """name -> ColumnLayout: production rungs 0, 4 and 9 (z = 2,048), and
    codes of z = 16, 24 and 10."""
    from qtpu_torch.ldpc.codes import make_rate_ladder
    from qtpu_torch.pipeline import production_config
    cfg = production_config()
    steps = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                             seed=cfg.code_seed, alg=cfg.alg,
                             family=cfg.family).steps
    out = {}
    for r in (0, 4, 9):
        st = steps[r]
        sh, pu = list(st.short_cols), list(st.punct_cols)
        out[f"r{r}"] = ColumnLayout(st.code.nb, st.code.z,
                                    [c for c in range(st.code.nb)
                                     if c not in sh + pu], sh, pu)
    out["z=16"] = ColumnLayout(12, 16, [0, 2, 3, 5, 8, 9, 11], [1, 4],
                               [6, 7, 10])
    out["z=24"] = ColumnLayout(8, 24, [0, 2, 3, 5, 6, 7], [1], [4])
    out["z=10"] = ColumnLayout(24, 10, list(range(2, 24)), [0], [1])
    return out


def _plans(rows, P, vh, nb):
    """{label: Plan} of a call at ``rows``: the hash, the first decode and
    (more than one row) a retry that merges rows // 12 + 1 of them."""
    out = {"hash": wv.plan(rows, rows, P, vh, 0, False, SMS, _occupancy),
           "first": wv.plan(rows, rows, P, vh, nb, True, SMS, _occupancy)}
    if rows > 1:
        out["retry"] = wv.plan(rows, rows // 12 + 1, P, vh, nb, True, SMS,
                               _occupancy)
    return out


def _group_seed(g, full, rng):
    """The seed words a warp packs for group g, indexed by row word: the
    group's 16 and the next 4 (from the seed's runs, zeros past it), every
    other word random."""
    S = rng.integers(0, 1 << 32, full.size, dtype=np.uint64).astype(np.uint32)
    S[16 * g:16 * g + 20] = full[16 * g:16 * g + 20]
    return S


@pytest.mark.parametrize("layout_name", ["r0", "r4", "r9", "z=16", "z=24",
                                         "z=10"])
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_split_slices_equal_the_plain_versions(plan_layouts, rows,
                                               layout_name):
    """For every plan: the XOR of the slices' partial hashes, each group's
    against only the seed words its warp packs, == hash_plain, and the
    slices' error counts sum to tail_plain's, at Vh 1, 31, 33 and 64, rows
    at offset 0 and one byte off alignment (two rows a plan)."""
    layout = plan_layouts[layout_name]
    P = layout.widths[0] * layout.z
    rng = np.random.default_rng(rows * 7 + P)
    for vh in (1, 31, 33, 64):
        plans = _plans(rows, P, vh, layout.nb)
        for offset in (0, 1):
            b = 2
            t = (lambda *shape: torch.from_numpy(
                rng.integers(0, 2, shape, dtype=np.uint8)))
            buf = rng.integers(0, 2, offset + b * P, dtype=np.uint8)
            rx_pin = torch.from_numpy(buf[offset:].reshape(b, P).copy())
            seed = t(P + vh - 1)
            rx_orig = t(b, P)
            hat, stats = wv.tail_plain(
                t(b, layout.nb * layout.z), rx_pin,
                t(b, P).to(torch.bool), rx_orig, seed, t(b, vh),
                torch.ones(b, dtype=torch.bool),
                torch.zeros(b, dtype=torch.int32), layout,
                torch.zeros(b, dtype=torch.int32))
            want = wv.hash_plain(hat, seed).numpy()
            diff = (hat ^ rx_orig).numpy().astype(np.int64)
            G = wv._groups(P)
            X = [_pack(h, 16 * G + 4) for h in hat.numpy()]
            full = _packed_seed(seed.numpy(), 16 * G + 20)
            seeds = [_group_seed(g, full, rng) for g in range(G)]
            for label, p in plans.items():
                for d in range(b):
                    H = np.zeros(2, np.uint32)
                    errs = 0
                    for rank in range(p.cluster):
                        w0, w1 = p.words(rank, P)
                        for g in range(w0 // 16, w1 // 16):
                            H ^= _slice_hash(X[d], seeds[g], 16 * g,
                                             16 * g + 16)
                        errs += int(diff[d, 32 * w0:32 * w1].sum())
                    np.testing.assert_array_equal(
                        _hash_bits(H, vh), want[d],
                        err_msg=f"{label} {p} vh={vh} offset={offset}")
                    assert errs == int(stats[d, 2]), (label, p, vh)


@pytest.mark.parametrize("P", [144, 220, 112, 3584, 2240, 61440, 63488,
                               1 << 17])
@pytest.mark.parametrize("vh", [1, 64])
def test_plan_properties(P, vh):
    """At every row count and merged count: the slices cover each of the
    row's words exactly once in whole groups of 16 (a group's hash reads
    the seed words of the group and the next two, within the 20 its warp
    packs); C <= 16, each CTA at least one group; shared memory under the
    limit; the merged rows' CTAs are whole clusters, and a retry's kept
    rows have CTAs of their own after them."""
    W = -(-P // 32)
    G = wv._groups(P)
    for rows in PLAN_ROWS + [1024]:
        for merged in sorted({rows, rows // 12 + 1, 1, 0, rows - 1}):
            if not 0 <= merged <= rows:
                continue
            for tail in (True, False):
                if not tail and merged != rows:
                    continue
                p = wv.plan(rows, merged, P, vh, 32, tail, SMS, _occupancy)
                C = p.cluster
                assert all(type(v) is int for v in p), p
                assert C in wv.CLUSTER_SIZES and C <= G, p
                assert p.groups == (G if C == 1 else -(-G // C)), p
                assert p.smem == wv.smem_bytes(p.threads, 32 if tail else 0)
                assert p.smem <= wv.SMEM_MAX and p.threads % 32 == 0 \
                    and 32 <= p.threads <= 1024, p
                assert p.decoded_ctas == C * merged, p
                assert p.kept_ctas % C == 0, p
                assert (p.kept_ctas > 0) == (rows > merged), (rows, merged, p)
                covered = np.zeros(16 * G, np.int64)
                for rank in range(C):
                    w0, w1 = p.words(rank, P)
                    assert w0 % 16 == 0 and w1 % 16 == 0 and w0 <= w1, p
                    covered[w0:w1] += 1
                np.testing.assert_array_equal(covered[:W], 1)
                np.testing.assert_array_equal(covered, covered.clip(0, 1))


def test_plan_picks_by_occupancy_and_raises_when_nothing_fits():
    """The split follows the card: with clusters of 16 unschedulable the
    one-row plan takes a smaller C; with no cluster schedulable it
    raises; a call it does not take is refused."""
    P = 63488
    p = wv.plan(1, 1, P, 64, 32, True, SMS, _occupancy)
    assert p.cluster >= 8, p
    # B = 128: a CTA a row of 1,024 threads.
    p = wv.plan(128, 128, P, 64, 32, True, SMS, _occupancy)
    assert (p.cluster, p.threads, p.decoded_ctas) == (1, 1024, 128), p
    # A shard's 32 rows: each over a cluster of CTAs, 64 or more in all.
    p = wv.plan(32, 32, P, 64, 32, True, SMS, _occupancy)
    assert p.cluster > 1 and p.decoded_ctas >= 64, p
    only4 = (lambda C, t, s: _occupancy(C, t, s) if C <= 4 else 0)
    p = wv.plan(1, 1, P, 64, 32, True, SMS, only4)
    assert p.cluster == 4, p
    with pytest.raises(RuntimeError, match="can be scheduled"):
        wv.plan(32, 32, P, 64, 32, True, SMS, lambda C, t, s: 0)
    with pytest.raises(ValueError, match="no plan"):
        wv.plan(4, 2, P, 64, 0, False, SMS, _occupancy)
    with pytest.raises(ValueError, match="no plan"):
        wv.plan(4, 4, P, 65, 32, True, SMS, _occupancy)


@pytest.mark.parametrize("rows", [[9, 2, 7], [3, 11, 0, 5, 1, 10, 2, 8, 6,
                                          4, 9, 7]], ids=["some", "all"])
def test_row_order_puts_merged_rows_first(rows):
    """A retry's row order: the merged window rows in the order of their
    decoded rows (which need not be contiguous or sorted), then the kept
    rows, each row once; the kernel's decoded row of item k is k."""
    B = 12
    src = wv._source_rows(np.array(rows), len(rows), B)
    order, merged = wv._row_order(src)
    assert sorted(order.tolist()) == list(range(B))
    assert (src[order[:merged]] >= 0).all() and (src[order[merged:]] < 0).all()
    assert merged == len(rows)
    for k in range(merged):
        assert src[order[k]] == k
    assert order[:merged].tolist() == rows


# ---------------------------------------------------------------------------
# The plain versions against the reference's programs.

@pytest.fixture(scope="module")
def window():
    """One window through the reference's and the port's programs: Alice,
    Bob's first decode and three retries from it (the port's ``retry`` of
    the failed rows, all but the two clean ones, against the reference's
    ``retry_program``; of four of the failed rows against its
    ``retry_small``; of every row against ``retry_program`` with every row
    failed); each ``window_verify.tail`` call's arguments and result
    recorded, in that order (``CALLS``)."""
    jcode = make_regular_code(1024)
    z = jcode.z
    pay = _expand([c for c in range(jcode.nb) if c not in (3, 9)], z)
    P = pay.size
    k_pb, s_max, kr = 16, 96, 100
    args = (pay, _expand([9], z), _expand([3], z), MAX_ITERS, "layered", VH,
            300, B, k_pb)
    jp = j_make_programs(jcode, *args, s_max=s_max, retry_bits=kr)
    tp = make_window_programs(code_from_reference(jcode), *args, s_max=s_max,
                              retry_bits=kr, device="cpu")
    calls = []
    real = wv.tail

    def recorded(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wv, "tail", recorded)
        return dict(P=P, calls=calls, **_run_window(jp, tp, P, k_pb, s_max,
                                                    kr))


def _run_window(jp, tp, P, k_pb, s_max, kr):
    """The programs' calls of ``window``."""
    rng = np.random.default_rng(41)
    cap, cursor = 1 << 15, 29
    a_arena = rng.integers(0, 2, cap, dtype=np.uint8)
    q = np.zeros(cap)
    q[cursor:cursor + B * P] = np.repeat(
        [0.01, 0.015] + list(np.linspace(0.12, 0.15, B - 2)), P)
    b_arena = a_arena ^ (rng.random(cap) < q).astype(np.uint8)
    a, ainv = 5, pow(5, -1, P)
    wkey = prng.key_data(prng.derive(prng.root_key(19), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(20), "punct", 0))
    kw = dict(test_bits_pb=k_pb // 2, affine=(a, ainv, 11))
    hdr_a = j_make_header(cursor, s_max // 2, wkey, pkey, **kw)
    hdr_b = j_make_header(cursor, s_max // 2, wkey, **kw)
    qmag = np.float32(np.log(0.97 / 0.03))
    j_alice = [np.asarray(v) for v in jp.alice(jnp.asarray(a_arena),
                                               jnp.asarray(hdr_a))]
    t_alice = tp.alice(torch.from_numpy(a_arena), hdr_a)
    payload, syn, hashes, test_v, short_v = j_alice
    j_bob = jp.bob(jnp.asarray(b_arena), jnp.asarray(hdr_b),
                   jnp.asarray(test_v), jnp.asarray(short_v),
                   jnp.asarray(syn), jnp.asarray(hashes), jnp.float32(qmag))
    t = (lambda v: torch.from_numpy(np.array(v)))
    t_bob = tp.bob(t(b_arena), hdr_b, t(test_v), t(short_v), t(syn),
                   t(hashes), qmag)
    failed = ~t_bob[4].numpy()[:, 0].astype(bool)
    positions = np.asarray(prng.subset_indices(prng.root_key(3), P, kr),
                           np.int32)
    bits = payload[:, positions]
    # The old stats are the first decode's own, as the protocol hands them
    # over (the reference's maximum of the iterations over every row then
    # changes none).
    stats_prev = t_bob[4].numpy().copy()

    def j_retry(failed_rows):
        return jp.retry(jnp.asarray(b_arena), jnp.asarray(hdr_b), *j_bob[1:4],
                        j_bob[0], jnp.asarray(stats_prev),
                        jnp.asarray(failed_rows.astype(np.uint8)),
                        jnp.asarray(positions), jnp.asarray(bits),
                        jnp.asarray(syn), jnp.asarray(hashes),
                        jnp.float32(qmag))

    def t_retry(rows):
        return tp.retry(t(b_arena), hdr_b, *t_bob[1:4], t_bob[0],
                        t(stats_prev), rows, positions, t(bits), t(syn),
                        t(hashes), qmag)
    jr, tt = j_retry(failed), t_retry(np.flatnonzero(failed))
    R = 8
    sel = np.flatnonzero(failed)[[0, 3, 5, 8]]
    rows = np.full(R, B, np.int32)
    rows[:sel.size] = sel
    valid = np.zeros(R, np.uint8)
    valid[:sel.size] = 1
    jrs = jp.retry_small(jnp.asarray(b_arena), jnp.asarray(hdr_b),
                         *j_bob[1:4], j_bob[0], j_bob[4], jnp.asarray(rows),
                         jnp.asarray(valid), jnp.asarray(positions),
                         jnp.asarray(bits), jnp.asarray(syn),
                         jnp.asarray(hashes), jnp.float32(qmag))
    trs = t_retry(sel)
    jall, tall = j_retry(np.ones(B, bool)), t_retry(np.arange(B))
    vseed = tr.seed_rows_at_plain(wkey, (TAG_VERIFY,), range(1), P + VH - 1,
                                  "cpu")[0]
    return dict(failed=failed, stats_prev=stats_prev, vseed=vseed,
                j_alice=j_alice, t_alice=t_alice, j_bob=j_bob, t_bob=t_bob,
                jr=jr, tt=tt, jrs=jrs, trs=trs, jall=jall, tall=tall)


def _eq_decoded(j_hat, t_hat, j_stats, t_stats):
    """stats [ok, iters, mism] on every block; hat and errs on verified
    blocks (see the module docstring)."""
    js, ts = np.asarray(j_stats), t_stats.numpy()
    np.testing.assert_array_equal(js[:, [0, 1, 3]], ts[:, [0, 1, 3]])
    ok = ts[:, 0].astype(bool)
    np.testing.assert_array_equal(js[ok, 2], ts[ok, 2])
    np.testing.assert_array_equal(np.asarray(j_hat)[ok], t_hat.numpy()[ok])


# The window's tail calls, in the order the fixture makes them.
CALLS = ("first", "retry", "retry_small", "all_rows")


def _call(window, name):
    """The recorded tail call ``name`` of ``CALLS`` (its arguments, its
    result)."""
    assert len(window["calls"]) == len(CALLS)
    return window["calls"][CALLS.index(name)]


def test_hash_plain_equals_reference(window):
    """Alice's hashes: the reference's int8 matmul against its (P, Vh)
    matrix == hash_plain against the window's verify seed, and the port's
    program's."""
    payload, hashes = window["j_alice"][0], window["j_alice"][2]
    got = wv.hash_plain(torch.from_numpy(payload.copy()), window["vseed"])
    np.testing.assert_array_equal(got.numpy(), hashes)
    np.testing.assert_array_equal(window["t_alice"][2].numpy(), hashes)


def test_tail_plain_first_decode_equals_reference(window):
    jb, tb = window["j_bob"], window["t_bob"]
    a, kw, (hat, stats) = _call(window, "first")
    assert stats.shape == (B, 4) and stats.dtype == torch.int32
    _eq_decoded(jb[0], hat, jb[4], stats)
    assert torch.equal(tb[0], hat) and torch.equal(tb[4], stats)
    again = wv.tail_plain(*a, **kw)
    assert torch.equal(again[0], hat) and torch.equal(again[1], stats)
    ok = stats[:, 0].numpy().astype(bool)
    assert ok[:2].all() and (~ok).sum() > 8


def test_tail_plain_retry_program_equals_reference(window):
    """The rows merge of more than 8 failed rows == the reference's
    ``retry_program`` merge: equal only because the old stats are the first
    decode's own (the unfailed rows, which the port leaves as they were,
    re-decode there to their own iterations)."""
    jr, tt = window["jr"], window["tt"]
    a, kw, (hat, stats) = _call(window, "retry")
    assert list(kw["rows"]) == list(np.flatnonzero(window["failed"]))
    assert len(kw["rows"]) > 8
    _eq_decoded(jr[0], hat, jr[3], stats)
    assert torch.equal(tt[0], hat) and torch.equal(tt[3], stats)
    unfailed = ~window["failed"]
    np.testing.assert_array_equal(stats.numpy()[unfailed],
                                  window["stats_prev"][unfailed])
    np.testing.assert_array_equal(hat.numpy()[unfailed],
                                  window["t_bob"][0].numpy()[unfailed])
    again = wv.tail_plain(*a, **kw)
    assert torch.equal(again[0], hat) and torch.equal(again[1], stats)


def test_tail_plain_retry_small_equals_reference(window):
    jrs, trs = window["jrs"], window["trs"]
    a, kw, (hat, stats) = _call(window, "retry_small")
    assert list(kw["rows"]) == list(np.flatnonzero(window["failed"])[
        [0, 3, 5, 8]])
    _eq_decoded(jrs[0], hat, jrs[3], stats)
    assert torch.equal(trs[0], hat) and torch.equal(trs[3], stats)
    untouched = np.setdiff1d(np.arange(B), kw["rows"])
    np.testing.assert_array_equal(stats.numpy()[untouched],
                                  window["t_bob"][4].numpy()[untouched])
    again = wv.tail_plain(*a, **kw)
    assert torch.equal(again[0], hat) and torch.equal(again[1], stats)


def test_tail_plain_all_rows_equals_reference(window):
    """The rows merge of every row of the window (no row kept) == the
    reference's ``retry_program`` with every row failed: the clean rows
    verify again with the extra pins."""
    jall, tall = window["jall"], window["tall"]
    a, kw, (hat, stats) = _call(window, "all_rows")
    assert list(kw["rows"]) == list(range(B))
    _eq_decoded(jall[0], hat, jall[3], stats)
    assert torch.equal(tall[0], hat) and torch.equal(tall[3], stats)
    assert stats.numpy()[~window["failed"], 0].all()
    again = wv.tail_plain(*a, **kw)
    assert torch.equal(again[0], hat) and torch.equal(again[1], stats)


@pytest.mark.parametrize("name", ["first", "retry_small", "over_8_rows",
                                  "all_rows"])
def test_kernel_model_of_the_tail_equals_tail_plain(window, name):
    """The kernel's row-by-row tail (the row map the wrapper builds, the
    column lookup, the word hash, each mode's merge and its rows left as
    they were) == tail_plain on the program's own call, every row: the
    first decode and the rows merge of 4, 10 (more than 8) and all 12
    rows."""
    a, kw, (hat, stats) = _call(window, "retry" if name == "over_8_rows"
                                else name)
    got_hat, got_stats = _model_tail(*a, **kw)
    np.testing.assert_array_equal(got_hat, hat.numpy())
    np.testing.assert_array_equal(got_stats, stats.numpy())


# ---------------------------------------------------------------------------
# The wrappers' host side.

@pytest.fixture
def cpu_as_card(monkeypatch):
    """CPU tensors take the kernel path (no CUDA tensor exists here) and
    ``_build.load`` raises, as it does without nvcc or a card."""
    def fail(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(wv, "_on_card", lambda dev: True)
    _build.entry.cache_clear()
    yield
    _build.entry.cache_clear()


def _small(vh=VH):
    """A three-part layout of a regular n = 1024 code (z = 64, P = 896)
    and one decode's tail arguments at B = 3."""
    layout = ColumnLayout(16, 64, list(range(2, 16)), [0], [1])
    rng = np.random.default_rng(2)
    b, P = 3, 14 * 64
    t = (lambda *shape: torch.from_numpy(
        rng.integers(0, 2, shape, dtype=np.uint8)))
    return dict(bits=t(b, 1024), rx_pin=t(b, P), pin=t(b, P).to(torch.bool),
                rx_orig=t(b, P), seed=t(P + vh - 1), exp_hashes=t(b, vh),
                converged=torch.ones(b, dtype=torch.bool),
                iterations=torch.arange(b, dtype=torch.int32),
                layout=layout)


def _retry(d):
    return dict(hat=d["rx_orig"].clone(),
                stats=torch.zeros((3, 4), dtype=torch.int32))


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    d = _small()
    before = dict(wv.launches)
    wv.hash(d["rx_pin"], d["seed"])
    wv.tail(**d, mism=torch.zeros(3, dtype=torch.int32))
    wv.tail(**d, **_retry(d), rows=np.array([2, 0, 1]))
    assert wv.launches == before


def test_a_call_that_would_launch_raises_without_the_kernel(cpu_as_card):
    """No fallback: each entry point and mode raises when the library
    cannot be built, and counts nothing."""
    d = _small()
    before = dict(wv.launches)
    with pytest.raises(RuntimeError, match="cannot build verify"):
        wv.hash(d["rx_pin"], d["seed"])
    for mode in (dict(mism=torch.zeros(3, dtype=torch.int32)),
                 dict(_retry(d), rows=np.array([2, 0]))):
        args = dict(d)
        if "rows" in mode:
            args.update({k: d[k][:2] for k in ("bits", "rx_pin", "pin",
                                               "converged", "iterations")})
        with pytest.raises(RuntimeError, match="cannot build verify"):
            wv.tail(**args, **mode)
    assert wv.launches == before


@pytest.mark.parametrize("x,seed,match", [
    (lambda d: d["rx_pin"].to(torch.int32), lambda d: d["seed"],
     "x must be torch.uint8"),
    (lambda d: d["rx_pin"].T.contiguous().T, lambda d: d["seed"],
     "contiguous"),
    (lambda d: d["rx_pin"], lambda d: torch.zeros(896 + 64,
                                                  dtype=torch.uint8),
     "Vh = 65 outside 1..64"),
    (lambda d: d["rx_pin"], lambda d: torch.zeros(895, dtype=torch.uint8),
     "Vh = 0 outside"),
    (lambda d: d["rx_pin"], lambda d: d["seed"][None], "seed must be"),
])
def test_bad_hash_arguments_raise_before_a_build(cpu_as_card, x, seed,
                                                 match):
    d = _small()
    with pytest.raises(ValueError, match=match):
        wv.hash(x(d), seed(d))


@pytest.mark.parametrize("change,match", [
    (dict(bits=lambda d: d["bits"][:, :960]), "bits must be"),
    (dict(pin=lambda d: d["pin"].to(torch.uint8)), "pin must be"),
    (dict(iterations=lambda d: d["iterations"].to(torch.int64)),
     "iterations must be"),
    (dict(converged=lambda d: d["converged"][:2]), "converged must be"),
    (dict(exp_hashes=lambda d: d["exp_hashes"][:, :32]), "exp_hashes must"),
    (dict(seed=lambda d: torch.zeros(896 + 70, dtype=torch.uint8)),
     "Vh = 71 outside"),
    (dict(mism=lambda d: None), "exactly one of"),
    (dict(rows=lambda d: np.array([1, 0, 2])), "exactly one of"),
    (dict(hat=lambda d: d["rx_orig"]), "hat and stats go with"),
    (dict(mism=lambda d: torch.zeros(3, dtype=torch.int64)), "mism must be"),
])
def test_bad_tail_arguments_raise_before_a_build(cpu_as_card, change, match):
    d = _small()
    args = dict(d, mism=torch.zeros(3, dtype=torch.int32))
    args.update({k: f(d) for k, f in change.items()})
    with pytest.raises(ValueError, match=match):
        wv.tail(**args)


@pytest.mark.parametrize("mode,match", [
    (dict(rows=np.array([2, 0, 2])), "repeats a row"),
    (dict(rows=np.array([0, 1, 3])), "rows must be"),
    (dict(rows=np.array([0, 1])), "rows must be"),
    (dict(rows=torch.tensor([0, 1, 2], device="meta")),
     "must be a host array"),
    (dict(rows=np.array([0, 1, 2]), stats=torch.zeros((3, 3),
                                                      dtype=torch.int32)),
     "stats must be"),
])
def test_bad_retry_merges_raise_before_a_build(cpu_as_card, mode, match):
    """A row map with a repeated row (the kernel's rows would race), rows
    outside the window or not one a decoded row, rows on a device (the
    host builds the row order), old stats of another shape."""
    d = _small()
    with pytest.raises(ValueError, match=match):
        wv.tail(**d, **dict(_retry(d), **mode))


def test_other_devices_raise():
    d = _small()
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        wv.hash(d["rx_pin"].to("meta"), d["seed"].to("meta"))
