"""The window programs' syndrome encoder and pin/LLR assembly against the
reference, and the host side of their kernels' wrappers.

``qtpu_torch.ldpc.encode`` takes Alice's codeword in parts (payload,
shortening fill, puncture pad) through a ``ColumnLayout``; its plain
version assembles the codeword as the reference's ``_build_codeword`` does
and rolls and XORs.  Here it is held to ``qtpu.ldpc.encode``'s encoder on
the same codeword, assembled in numpy from the same numpy-seeded parts, on
every rung of the n = 1024 and the mixed n = 4096 ladders (punctured
rungs), on regular n = 1024 codes with shortened columns, on one production
n = 65536 rung at B = 2, on a code with parallel edges and on two codes
whose z (24, 10) is not a multiple of 16; the kernel's table (each edge's
column by its position among the parts' columns) is held to the same
encoder.

``qtpu_torch.window_assembly.pin_llr_plain`` is held to the reference's
``alice_program`` -> ``bob_program`` on the same arena and header: the
pinned payload, the pin mask and the mismatch count, with the shortening
and test families forced to overlap.  The LLR, which the reference's
programs do not return, is held to a numpy construction of its formula
(``qtpu/window_programs.py``, ``_decode_core``).  Tolerance: exact (LLRs by
their float32 bit patterns).

The wrappers' checks run without a card: CPU tensors take the plain path
and launch nothing; with ``_on_card`` patched to take the CPU for a card,
malformed arguments raise ValueError before anything is built, and a
well-formed call raises when the kernel cannot be built instead of falling
back to the plain version.  The kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 5c).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu import prng
from qtpu.ldpc import encode as jencode
from qtpu.ldpc.codes import make_rate_ladder, make_regular_code
from qtpu.pipeline import PipelineConfig, production_config
from qtpu.window_programs import make_header as j_make_header
from qtpu.window_programs import make_window_programs as j_make_programs
from qtpu_torch import _build
from qtpu_torch import random as tr
from qtpu_torch import window_assembly as wa
from qtpu_torch import window_verify as wv
from qtpu_torch.ldpc import encode as enc
from qtpu_torch.ldpc.codes import QCCode, _group_edges, code_from_reference
from qtpu_torch.window_programs import TAG_SHORTFILL, TAG_TOFF


def _ladder_geometry(cfg, r):
    """(reference code, payload, shortened, punctured base columns) of rung
    ``r`` of ``cfg``'s ladder."""
    lad = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                           seed=cfg.code_seed, alg=cfg.alg, family=cfg.family)
    st = lad.steps[r]
    short, punct = list(st.short_cols), list(st.punct_cols)
    pay = [c for c in range(st.code.nb) if c not in short + punct]
    return st.code, pay, short, punct


def _parallel_edge_code():
    """Base row 0 with two edges into column 0 (shifts 0 and 5), row 1 two
    into column 3 (shifts 0 and 9)."""
    rows = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1], np.int32)
    cols = np.array([0, 0, 1, 2, 1, 2, 3, 3, 0], np.int32)
    return QCCode(z=16, mb=2, nb=4, edge_row=rows, edge_col=cols,
                  edge_shift=np.array([0, 5, 3, 7, 1, 2, 0, 9, 4], np.int32),
                  row_edges=_group_edges(rows, 2),
                  col_edges=_group_edges(cols, 4))


def _regular(short, punct):
    code = make_regular_code(1024)
    pay = [c for c in range(code.nb) if c not in short + punct]
    return code, pay, short, punct


LADDER_1024 = PipelineConfig(n=1024)
MIXED_4096 = PipelineConfig(n=4096, family="mixed", alg="minsum")
GEOMETRIES = {
    **{f"ladder1024_r{r}": (lambda r=r: _ladder_geometry(LADDER_1024, r), 4)
       for r in range(5)},
    **{f"mixed4096_r{r}": (lambda r=r: _ladder_geometry(MIXED_4096, r), 4)
       for r in range(5)},
    "regular1024_short_and_punct": (lambda: _regular([3], [9]), 4),
    "regular1024_short_only": (lambda: _regular([0, 5], []), 3),
    "production_r4": (lambda: _ladder_geometry(production_config(), 4), 2),
    "parallel_edges": (lambda: (_parallel_edge_code(), [0, 3], [2], [1]), 5),
    "odd_z24": (lambda: (enc.random_qc_code(24, 8, 4), [0, 2, 3, 5, 6, 7],
                         [1], [4]), 5),
    "odd_z10": (lambda: (enc.random_qc_code(10, 24, 6), list(range(2, 24)),
                         [0], [1]), 3),
}


def _parts(code, pay, short, punct, B, seed):
    """Numpy-seeded (payload, fill, pad) and the codeword they make."""
    rng = np.random.default_rng(seed)
    z = code.z
    parts = [rng.integers(0, 2, (B, len(c) * z), dtype=np.uint8)
             for c in (pay, short, punct)]
    x = np.zeros((B, code.nb * z), np.uint8)
    for cols, part in zip((pay, short, punct), parts):
        for q, j in enumerate(cols):
            x[:, j * z:(j + 1) * z] = part[:, q * z:(q + 1) * z]
    return parts, x


@pytest.mark.parametrize("which", list(GEOMETRIES))
def test_parts_encoder_equals_reference(which):
    make, B = GEOMETRIES[which]
    jcode, pay, short, punct = make()
    code = code_from_reference(jcode)
    parts, x = _parts(code, pay, short, punct, B, len(which))
    want = np.asarray(jencode.make_batch_encoder(jcode)(jnp.asarray(x)))
    layout = enc.ColumnLayout(code.nb, code.z, pay, short, punct)
    tparts = [torch.from_numpy(p) if p.size else None for p in parts]
    assert np.array_equal(layout.assemble_plain(tparts).numpy(), x)
    got = enc.encode_parts_plain(code, layout, tparts)
    assert got.dtype == torch.uint8 and got.shape == (B, code.m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        enc.make_parts_encoder(code, layout)(*tparts).numpy(), want)
    np.testing.assert_array_equal(
        enc.make_batch_encoder(code)(torch.from_numpy(x)).numpy(), want)


def _table_syndromes(code, layout, parts):
    """The syndromes the kernel's table describes, in numpy: the parts'
    columns side by side; an edge (position, shift) of row i XORs the
    column at that position rotated left by shift."""
    table = enc.code_table(code, layout)
    mb, z, E = code.mb, code.z, code.num_edges
    start = table[:mb + 1]
    head = (mb + 2) & ~1
    edges = table[head:head + 2 * E].reshape(E, 2)
    assert table.size % 4 == 0 and not table[head + 2 * E:].any()
    x = np.concatenate([p for p in parts if p.size], axis=1)
    syn = np.zeros((x.shape[0], mb, z), np.uint8)
    for i in range(mb):
        for pos, shift in edges[start[i]:start[i + 1]]:
            assert 0 <= shift < z
            syn[:, i] ^= np.roll(x[:, pos * z:(pos + 1) * z], -shift, axis=1)
    return syn.reshape(x.shape[0], mb * z)


@pytest.mark.parametrize("which", list(GEOMETRIES))
def test_kernel_table_describes_the_reference_encoder(which):
    """The kernel's table (each edge's column by its position among the
    parts' columns, shifts mod z, padded to 16 bytes) encodes what
    ``qtpu``'s encoder does."""
    make, B = GEOMETRIES[which]
    jcode, pay, short, punct = make()
    code = code_from_reference(jcode)
    parts, x = _parts(code, pay, short, punct, B, len(which) + 1)
    want = np.asarray(jencode.make_batch_encoder(jcode)(jnp.asarray(x)))
    layout = enc.ColumnLayout(code.nb, code.z, pay, short, punct)
    np.testing.assert_array_equal(_table_syndromes(code, layout, parts),
                                  want)


@pytest.mark.parametrize("which", list(GEOMETRIES))
def test_parts_encoder_reads_each_bytes_lowest_bit(which):
    """Parts of bytes 0..255 encode as their lowest bits do, through the
    table that ``qtpu``'s encoder is held to (the kernel's bodies read each
    byte's lowest bit too)."""
    make, B = GEOMETRIES[which]
    jcode, pay, short, punct = make()
    code = code_from_reference(jcode)
    rng = np.random.default_rng(len(which) + 2)
    parts = [rng.integers(0, 256, (B, len(c) * code.z), dtype=np.uint8)
             for c in (pay, short, punct)]
    layout = enc.ColumnLayout(code.nb, code.z, pay, short, punct)
    want = _table_syndromes(code, layout, [p & 1 for p in parts])
    tparts = [torch.from_numpy(p) if p.size else None for p in parts]
    np.testing.assert_array_equal(
        enc.make_parts_encoder(code, layout)(*tparts).numpy(), want)


def test_roll_direction():
    """One edge of shift 3: check c reads variable (c + 3) mod z."""
    rows = np.zeros(1, np.int32)
    code = QCCode(z=8, mb=1, nb=1, edge_row=rows, edge_col=rows,
                  edge_shift=np.array([3], np.int32),
                  row_edges=_group_edges(rows, 1),
                  col_edges=_group_edges(rows, 1))
    x = np.array([[1, 1, 0, 0, 1, 0, 1, 0]], np.uint8)
    got = enc.encode_plain(code, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[0], x[0, (np.arange(8) + 3) % 8])


def test_layout_rejects_columns_missing_or_twice():
    with pytest.raises(ValueError, match="each of the 4 base columns once"):
        enc.ColumnLayout(4, 16, [0, 1], [1], [3])
    with pytest.raises(ValueError, match="1 to 3 parts"):
        enc.ColumnLayout(4, 16, [0], [1], [2], [3])


# ---------------------------------------------------------------------------
# Bob's pins and LLRs against the reference's programs.

MAX_ITERS, VH = 60, 64


def _np_llr(rx_pin, pin, fill, qmag, layout):
    """The reference's LLR formula in numpy float32."""
    b, z = rx_pin.shape[0], layout.z
    one, two, big = np.float32(1), np.float32(2), np.float32(1e9)
    sign = one - two * rx_pin.astype(np.float32)
    mag = np.where(pin, big, np.float32(qmag)).astype(np.float32)
    parts = [(sign * mag).reshape(b, -1, z)]
    if layout.widths[1]:
        parts.append(((one - two * fill.astype(np.float32)) * big)
                     .reshape(b, -1, z))
    if layout.widths[2]:
        parts.append(np.zeros((b, layout.widths[2], z), np.float32))
    return np.concatenate(parts, axis=1)[:, layout.inv, :].reshape(b, -1)


def _bits_equal(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.astype(np.float32).view(np.int32))


@pytest.fixture(scope="module",
                params=["regular1024_short_and_punct", "ladder1024_r1"])
def bob_case(request):
    """Alice's and Bob's reference programs on one window, the shortening
    family's offset chosen so that block 0's first min(s, k) test
    positions are shortening positions too."""
    jcode, pay, short, punct = GEOMETRIES[request.param][0]()
    B, z = 4, jcode.z
    expand = (lambda cols: (np.asarray(sorted(cols), np.int64)[:, None] * z
                            + np.arange(z)).reshape(-1))
    P = len(pay) * z
    k_pb, s_max = 16, 96
    jp = j_make_programs(jcode, expand(pay), expand(punct), expand(short),
                         MAX_ITERS, "layered", VH, 300, B, k_pb, s_max=s_max,
                         retry_bits=64)
    rng = np.random.default_rng(31)
    cap, cursor = 1 << 14, 13
    a_arena = rng.integers(0, 2, cap, dtype=np.uint8)
    b_arena = a_arena ^ (rng.random(cap) < 0.05).astype(np.uint8)
    wkey = prng.key_data(prng.derive(prng.root_key(9), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(10), "punct", 0))
    boff_t = tr.randint_at_plain(wkey, (TAG_TOFF,), range(B), P, "cpu")
    a = 5
    affine = (a, pow(a, -1, P), (a * s_max + int(boff_t[0])) % P)
    s, k = s_max // 2, k_pb // 2
    hdr_a = j_make_header(cursor, s, wkey, pkey, test_bits_pb=k,
                          affine=affine)
    hdr_b = j_make_header(cursor, s, wkey, test_bits_pb=k, affine=affine)
    qmag = np.float32(np.log(0.95 / 0.05))
    payload, syn, hashes, test_v, short_v = (
        np.asarray(v) for v in jp.alice(jnp.asarray(a_arena),
                                        jnp.asarray(hdr_a)))
    _, rx_orig, rx_pin, pinmask, stats = (
        np.asarray(v) for v in jp.bob(
            jnp.asarray(b_arena), jnp.asarray(hdr_b), jnp.asarray(test_v),
            jnp.asarray(short_v), jnp.asarray(syn), jnp.asarray(hashes),
            jnp.float32(qmag)))
    fill = (tr.seed_rows_at_plain(wkey, (TAG_SHORTFILL,), range(B),
                                  len(short) * z, "cpu") if short else None)
    layout = enc.ColumnLayout(jcode.nb, z, pay, short, punct)
    return dict(rx_orig=rx_orig, rx_pin=rx_pin, pinmask=pinmask, stats=stats,
                test_v=test_v, short_v=short_v, boff_t=boff_t, affine=affine,
                s=s, k=k, s_max=s_max, fill=fill, qmag=qmag, layout=layout)


def _pin_llr_plain(c):
    return wa.pin_llr_plain(
        torch.from_numpy(c["rx_orig"].copy()),
        torch.from_numpy(c["short_v"].copy()),
        torch.from_numpy(c["test_v"].copy()), c["boff_t"], c["affine"],
        c["s"], c["k"], c["s_max"], c["fill"], c["qmag"], c["layout"])


def test_pin_llr_plain_equals_reference(bob_case):
    c = bob_case
    # The families overlap in block 0: fewer pinned positions than s + k.
    assert c["pinmask"][0].sum() == c["s"] + c["k"] - min(c["s"], c["k"])
    rx_pin, pin, mism, llr = _pin_llr_plain(c)
    assert pin.dtype == torch.bool and mism.dtype == torch.int32
    np.testing.assert_array_equal(rx_pin.numpy(), c["rx_pin"])
    np.testing.assert_array_equal(pin.numpy(), c["pinmask"])
    np.testing.assert_array_equal(mism.numpy(), c["stats"][:, 3])
    fill = None if c["fill"] is None else c["fill"].numpy()
    _bits_equal(llr, _np_llr(c["rx_pin"], c["pinmask"], fill, c["qmag"],
                             c["layout"]))


def test_llr_plain_equals_formula(bob_case):
    """The retries' LLR from a given pinned payload and mask (here with
    extra random pins, as a retry round adds)."""
    c = bob_case
    rng = np.random.default_rng(5)
    rx_pin = rng.integers(0, 2, c["rx_pin"].shape, dtype=np.uint8)
    pin = c["pinmask"] | (rng.random(c["pinmask"].shape) < 0.1)
    got = wa.llr_plain(torch.from_numpy(rx_pin), torch.from_numpy(pin),
                       c["fill"], c["qmag"], c["layout"])
    fill = None if c["fill"] is None else c["fill"].numpy()
    _bits_equal(got, _np_llr(rx_pin, pin, fill, c["qmag"], c["layout"]))


def test_test_value_wins_where_the_families_overlap():
    """Alice's shortening and test values disagree at the shared positions
    (they never do in a session): rx_pin takes the test value."""
    z, B = 16, 2
    layout = enc.ColumnLayout(4, z, [0, 1, 2, 3], [], [])
    P = 4 * z
    boff_t = torch.tensor([7, 40], dtype=torch.int64)
    a, s_max, s, k = 3, 8, 8, 4
    affine = (a, pow(a, -1, P), (a * s_max + 7) % P)
    rx = torch.zeros((B, P), dtype=torch.uint8)
    short = torch.ones((B, s_max), dtype=torch.uint8)
    test = torch.zeros((B, k), dtype=torch.uint8)
    rx_pin, pin, mism, _ = wa.pin_llr_plain(rx, short, test, boff_t, affine,
                                            s, k, s_max, None, 1.5, layout)
    pos_s, pos_t = wa.disclosure_positions(affine, boff_t, P, s_max, k)
    shared = set(pos_s.tolist()) & set(pos_t[0].tolist())
    assert len(shared) == min(s, k)
    assert all(rx_pin[0, p] == 0 and pin[0, p] for p in shared)
    assert mism.tolist() == [s - len(shared), s]


# ---------------------------------------------------------------------------
# The wrappers' host side.

@pytest.fixture
def no_kernel(monkeypatch):
    """``_build.load`` raises, as it does without nvcc or a card."""
    def fail(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", fail)
    _build.entry.cache_clear()
    yield
    _build.entry.cache_clear()


@pytest.fixture
def cpu_as_card(monkeypatch, no_kernel):
    """CPU tensors take the kernel path (no CUDA tensor exists here)."""
    monkeypatch.setattr(enc, "_on_card", lambda dev: True)
    monkeypatch.setattr(wa, "_on_card", lambda dev: True)


def _small():
    """A regular n = 1024 code in three parts, and one window's inputs."""
    code = code_from_reference(make_regular_code(1024))
    z = code.z
    layout = enc.ColumnLayout(code.nb, z, list(range(2, 16)), [0], [1])
    rng = np.random.default_rng(2)
    B, P = 3, 14 * z
    t = (lambda *shape: torch.from_numpy(
        rng.integers(0, 2, shape, dtype=np.uint8)))
    return dict(code=code, layout=layout, payload=t(B, P), fill=t(B, z),
                pad=t(B, z), short=t(B, 32), test=t(B, 8),
                boff_t=torch.tensor([3, 500, 890], dtype=torch.int64),
                affine=(5, pow(5, -1, P), 11),
                pin=torch.zeros((B, P), dtype=torch.bool))


def _pin_args(d, **kw):
    args = dict(rx=d["payload"], short_alice=d["short"], test_alice=d["test"],
                boff_t=d["boff_t"], affine=d["affine"], s=16, k=8, s_max=32,
                fill=d["fill"], qmag=2.0, layout=d["layout"])
    args.update(kw)
    return args


def test_cpu_tensors_take_the_plain_path_and_launch_nothing(no_kernel):
    d = _small()
    before = (dict(enc.launches), dict(wa.launches))
    enc.make_batch_encoder(d["code"])(torch.zeros((2, 1024),
                                                  dtype=torch.uint8))
    enc.make_parts_encoder(d["code"], d["layout"])(d["payload"], d["fill"],
                                                   d["pad"])
    wa.pin_llr(**_pin_args(d))
    wa.llr(d["payload"], d["pin"], d["fill"], 2.0, d["layout"])
    assert (enc.launches, wa.launches) == before


def test_a_call_that_would_launch_raises_without_the_kernel(cpu_as_card):
    """No fallback: the kernel path raises when the library cannot be
    built, and counts nothing."""
    d = _small()
    before = (dict(enc.launches), dict(wa.launches))
    with pytest.raises(RuntimeError, match="cannot build qc_encode"):
        enc.make_parts_encoder(d["code"], d["layout"])(
            d["payload"], d["fill"], d["pad"])
    with pytest.raises(RuntimeError, match="cannot build qc_encode"):
        enc.make_batch_encoder(d["code"])(torch.zeros((2, 1024),
                                                      dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="cannot build pin_llr"):
        wa.pin_llr(**_pin_args(d))
    with pytest.raises(RuntimeError, match="cannot build pin_llr"):
        wa.llr(d["payload"], d["pin"], d["fill"], 2.0, d["layout"])
    assert (enc.launches, wa.launches) == before


@pytest.mark.parametrize("part,value,match", [
    (0, lambda d: d["payload"].to(torch.int32), "must be torch.uint8"),
    (0, lambda d: d["payload"][:, :-64], r"\(3, 896\)"),
    (0, lambda d: d["payload"].repeat(1, 2)[:, ::2], "contiguous"),
    (1, lambda d: None, "part 1 is missing"),
    (2, lambda d: d["pad"][:2], r"\(3, 64\)"),
])
def test_bad_encoder_parts_raise_before_a_launch(cpu_as_card, part, value,
                                                 match):
    d = _small()
    parts = [d["payload"], d["fill"], d["pad"]]
    parts[part] = value(d)
    with pytest.raises(ValueError, match=match):
        enc.make_parts_encoder(d["code"], d["layout"])(*parts)


def test_encoder_refuses_a_circulant_wider_than_it_stages(cpu_as_card):
    """z above MAX_Z raises before anything is built or launched."""
    z = 2 * enc.MAX_Z
    rows = np.zeros(1, np.int32)
    code = QCCode(z=z, mb=1, nb=1, edge_row=rows, edge_col=rows,
                  edge_shift=np.array([3], np.int32),
                  row_edges=_group_edges(rows, 1),
                  col_edges=_group_edges(rows, 1))
    before = dict(enc.launches)
    with pytest.raises(ValueError, match=f"z = {z} > {enc.MAX_Z}"):
        enc.make_batch_encoder(code)(torch.zeros((1, z), dtype=torch.uint8))
    assert enc.launches == before


@pytest.mark.parametrize("name,value,match", [
    ("rx", lambda d: d["payload"].to(torch.int64), "rx must be"),
    ("rx", lambda d: d["payload"].T.contiguous().T, "contiguous"),
    ("short_alice", lambda d: d["short"][:2], "short_alice must be"),
    ("test_alice", lambda d: d["test"].to(torch.bool), "test_alice must be"),
    ("boff_t", lambda d: d["boff_t"].to(torch.int32), "boff_t must be"),
    ("fill", lambda d: None, "need a fill"),
    ("fill", lambda d: d["fill"][:, :32], "fill must be"),
    ("s", lambda d: 33, "do not fit"),
    ("k", lambda d: 9, "do not fit"),
    ("affine", lambda d: (5, 896, 0), "outside"),
])
def test_bad_pin_llr_arguments_raise_before_a_launch(cpu_as_card, name, value,
                                                     match):
    d = _small()
    with pytest.raises(ValueError, match=match):
        wa.pin_llr(**_pin_args(d, **{name: value(d)}))


@pytest.mark.parametrize("arg,match", [
    ("rx_pin", "rx_pin must be"), ("pin", "pin must be")])
def test_bad_llr_arguments_raise_before_a_launch(cpu_as_card, arg, match):
    d = _small()
    args = dict(rx_pin=d["payload"], pin=d["pin"])
    args[arg] = args[arg].to(torch.float32)
    with pytest.raises(ValueError, match=match):
        wa.llr(args["rx_pin"], args["pin"], d["fill"], 2.0, d["layout"])


def test_each_program_draws_in_one_table(monkeypatch):
    """Every window program that draws makes all of its draws in one
    ``random.draws`` call (one launch on a card): Alice the pad, fill,
    verify seed and offsets, Bob the offsets, fill and verify seed (the
    verify seed no longer after the decode), the retry the fill and the
    verify seed (at any number of rows), the PA its seed; the outputs equal the draws made one by
    one, as before, and no program depends on what ran before it."""
    from qtpu_torch.ldpc.codes import make_regular_code as t_regular
    from qtpu_torch.window_programs import make_header, make_window_programs
    code = t_regular(1024)
    z, B = code.z, 4
    cols = lambda cs: (np.asarray(cs)[:, None] * z
                       + np.arange(z)[None, :]).reshape(-1)
    pay = cols([c for c in range(code.nb) if c not in (3, 9)])
    progs = make_window_programs(code, pay, cols([9]), cols([3]), 20,
                                 "layered", 64, 300, B, 16, s_max=96,
                                 retry_bits=100, device="cpu")
    calls = []
    draws = tr.draws

    def counted(table, device):
        calls.append([type(d).__name__ for d in table])
        return draws(table, device)
    monkeypatch.setattr(tr, "draws", counted)
    rng = np.random.default_rng(5)
    arena = torch.from_numpy(rng.integers(0, 2, 1 << 14, dtype=np.uint8))
    P = pay.size
    hdr = make_header(7, 48, [1, 2], [3, 4], test_bits_pb=8,
                      affine=(5, pow(5, -1, P), 11))
    payload, syn, hashes, test_v, short_v = progs.alice(arena, hdr)
    assert calls == [["SeedRows", "SeedRows", "SeedRows", "Randint"]]
    # Alice's pad, fill and verify-hash matrix from the draws made alone.
    pad = tr.seed_rows_at(hdr[4:6], (), range(B), z, "cpu")
    fill = tr.seed_rows_at(hdr[2:4], (5,), range(B), z, "cpu")
    layout = enc.ColumnLayout(code.nb, z, [c for c in range(code.nb)
                                           if c not in (3, 9)], [3], [9])
    assert torch.equal(syn, enc.encode_parts_plain(code, layout,
                                                   [payload, fill, pad]))
    bob_hdr = hdr.copy()
    bob_hdr[4:6] = 0
    calls.clear()
    hat, rx_orig, rx_pin, pinmask, stats = progs.bob(
        arena, bob_hdr, test_v, short_v, syn, hashes, 2.0)
    assert calls == [["Randint", "SeedRows", "SeedRows"]]
    calls.clear()
    failed = np.array([0, 2])
    positions = np.arange(0, P, 7)[:100]
    bits = payload[:, torch.from_numpy(positions)]
    progs.retry(arena, bob_hdr, rx_orig, rx_pin, pinmask, hat, stats, failed,
                positions, bits, syn, hashes, 2.0)
    progs.retry(arena, bob_hdr, rx_orig, rx_pin, pinmask, hat, stats,
                np.arange(B), positions, bits, syn, hashes, 2.0)
    progs.pa(payload, [9, 10])
    assert calls == [["SeedRows", "SeedRows"]] * 2 + [["SeedRows"]]
    # A program set that ran nothing before gives the same retry.
    other = make_window_programs(code, pay, cols([9]), cols([3]), 20,
                                 "layered", 64, 300, B, 16, s_max=96,
                                 retry_bits=100, device="cpu")
    calls.clear()
    got = other.retry(arena, bob_hdr, rx_orig, rx_pin, pinmask, hat, stats,
                      failed, positions, bits, syn, hashes, 2.0)
    assert calls == [["SeedRows", "SeedRows"]]
    want = progs.retry(arena, bob_hdr, rx_orig, rx_pin, pinmask, hat, stats,
                       failed, positions, bits, syn, hashes, 2.0)
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)


def test_other_devices_raise():
    d = _small()
    meta = torch.zeros((2, 1024), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        enc.make_batch_encoder(d["code"])(meta)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        wa.llr(d["payload"].to("meta"), d["pin"].to("meta"), None, 2.0,
               d["layout"])


@pytest.mark.parametrize("module", [enc, wa, wv],
                         ids=["qc_encode", "pin_llr", "verify"])
def test_bindings_match_the_kernel_source(module):
    """Every C entry point of the kernel's source is bound, with as many
    argument types as it has parameters, and each that launches (all but
    a ``_plan`` query) has a launch counter."""
    src = (_build._CSRC / f"{module.LIBRARY}.cu").read_text()
    entries = dict(re.findall(r'extern "C" int qtpu_(\w+)\(([^)]*)\)', src))
    assert set(entries) == set(module._ARGTYPES)
    assert set(module.launches) == {n for n in entries
                                    if not n.endswith("_plan")}
    for name, params in entries.items():
        assert len(params.split(",")) == len(module._ARGTYPES[name]), name
