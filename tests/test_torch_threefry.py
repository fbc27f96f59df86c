"""qtpu_torch.random's fused window-program draws against the reference, and
the host side of the threefry kernel's wrapper.

``draws`` makes every protocol seed of a window program (verify seed, test
offsets, shortening fill, puncture pad, PA seeds) in one table;
``seed_rows_at`` and ``randint_at`` are its one-draw tables.  On the CPU
they run their plain versions, which are held here to
the reference's own constructions in ``qtpu/window_programs.py``
(``_block_keys``, ``_keys_at``, ``_seed_rows``, ``_seed_rows_at``: a
``jax.vmap`` of ``fold_in`` and ``bits``, then the LSB-first unpack; the
test offsets' ``jax.random.randint``), on numpy-seeded keys.  Tolerance:
exact.  A table's outputs equal its draws made one by one.

The wrapper's checks run without a card: CPU tensors take the plain path
and launch nothing, malformed arguments raise before any launch, and a call
that would launch raises when the kernel cannot be built instead of falling
back to the plain version.  The kernel itself is held to the plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 5b).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu_torch import _build
from qtpu_torch import random as tr

# The reference's window-key fold tags (qtpu/window_programs.py).
TAG_VERIFY, TAG_TOFF, TAG_SHORTFILL = 3, 4, 5


def _key_words(seed):
    data = np.random.default_rng(seed).integers(0, 2**32, 2, dtype=np.uint64)
    return data.astype(np.uint32)


def _tagged(words, tags):
    key = jax.random.wrap_key_data(jnp.asarray(words))
    for t in tags:
        key = jax.random.fold_in(key, t)
    return key


# The reference's constructions, as qtpu/window_programs.py builds them.
def _keys_at(key, idx):
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(
        idx.astype(jnp.uint32))


def _block_keys(key, b, row0):
    return _keys_at(key, row0 + jnp.arange(b, dtype=jnp.uint32))


def _unpack(words, b, length):
    W = words.shape[1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((words[:, :, None] >> shifts) & 1).astype(jnp.uint8)
    return bits.reshape(b, W * 32)[:, :length]


def _seed_rows(key, b, length, row0):
    W = -(-length // 32)
    words = jax.vmap(lambda k: jax.random.bits(k, (W,), jnp.uint32))(
        _block_keys(key, b, jnp.uint32(row0)))
    return np.asarray(_unpack(words, b, length))


def _seed_rows_at(key, idx, length):
    W = -(-length // 32)
    words = jax.vmap(lambda k: jax.random.bits(k, (W,), jnp.uint32))(
        _keys_at(key, idx))
    return np.asarray(_unpack(words, idx.shape[0], length))


LENGTHS = [1, 31, 33, 2048, 63551, 110460]
TAGS = [(), (TAG_VERIFY,), (TAG_TOFF, TAG_SHORTFILL)]


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("tags", TAGS, ids=["0tags", "1tag", "2tags"])
def test_seed_rows_at_equals_reference(tags, length):
    """Rows from row0 = 0, 32 and 96 (global block indices of a shard)."""
    words = _key_words(length + len(tags))
    key = _tagged(words, tags)
    b = 2 if length > 4096 else 4
    for row0 in (0, 32, 96):
        got = tr.seed_rows_at(words, tags, range(row0, row0 + b), length,
                              "cpu")
        assert got.dtype == torch.uint8 and got.shape == (b, length)
        np.testing.assert_array_equal(got.numpy(),
                                      _seed_rows(key, b, length, row0))


@pytest.mark.parametrize("length", [33, 2048, 63551])
def test_seed_rows_at_index_rows_equal_reference(length):
    """A retry's failed rows: an index tensor, any order, a full-width
    uint32 row included."""
    words = _key_words(7)
    idx = np.array([5, 0, 127, 3, 96, 2**32 - 1], np.int64)
    got = tr.seed_rows_at(words, (TAG_SHORTFILL,), torch.from_numpy(idx),
                          length, "cpu")
    want = _seed_rows_at(_tagged(words, (TAG_SHORTFILL,)),
                         jnp.asarray(idx.astype(np.uint32)), length)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("span", [3, 1000, 61440, 63488, 65536, 100003,
                                  2**31 + 5, 2**32 - 1])
def test_randint_at_equals_reference(span):
    """The per-block test offsets of ``_disclosure_positions`` (spans: the
    ladder's P values and small ones), and spans past 2^16, where JAX's
    uint32 remainder wraps."""
    words = _key_words(span)
    key = _tagged(words, (TAG_TOFF,))
    for row0, b in ((0, 128), (96, 32)):
        keys = _block_keys(key, b, jnp.uint32(row0))
        want = jax.vmap(lambda k: jax.random.randint(
            k, (), jnp.uint32(0), jnp.uint32(span), dtype=jnp.uint32))(keys)
        got = tr.randint_at(words, (TAG_TOFF,), range(row0, row0 + b), span,
                            "cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


def test_fused_calls_are_the_generic_compositions():
    """The fused calls' plain versions equal the compositions of the
    generic functions (fold_in, split, bits32) that the reference's
    constructions name."""
    words = _key_words(11)
    key = tr.key_from_data(words, "cpu")
    rows = torch.tensor([0, 9, 4], dtype=torch.int64)
    keys = tr.fold_in(tr.fold_in(tr.fold_in(key, TAG_TOFF), TAG_VERIFY), rows)
    bits = ((tr.bits32(keys, 4)[:, :, None] >> torch.arange(32)) & 1)
    assert torch.equal(
        tr.seed_rows_at(words, (TAG_TOFF, TAG_VERIFY), rows, 100, "cpu"),
        bits.to(torch.uint8).reshape(3, 128)[:, :100])
    span = 63488
    keys = tr.fold_in(tr.fold_in(key, TAG_TOFF), rows)
    want = []
    for k in keys:
        hi, lo = (int(tr.bits32(s, 1)[0]) for s in tr.split(k, 2))
        mult = ((1 << 16) % span) ** 2 % 2**32 % span
        want.append((((hi % span) * mult) % 2**32 + lo % span) % 2**32
                    % span)
    assert tr.randint_at(words, (TAG_TOFF,), rows, span, "cpu").tolist() \
        == want


# ---------------------------------------------------------------------------
# The wrapper's host side.

@pytest.fixture
def no_kernel(monkeypatch):
    """``_build.load`` raises, as it does without nvcc or a card."""
    def fail(name):
        raise RuntimeError(f"cannot build {name}")
    monkeypatch.setattr(_build, "load", fail)
    _build.entry.cache_clear()
    yield
    _build.entry.cache_clear()


def test_cpu_tensors_take_the_plain_path_and_launch_nothing(no_kernel):
    before = dict(tr.launches)
    key = tr.key_from_data(_key_words(3), "cpu")
    idx = torch.arange(5, dtype=torch.int64)
    tr.fold_in(key, 7)
    tr.fold_in(key, idx)
    tr.split(key, 3)
    tr.bits32(key, 40)
    tr.uniform(key, 40)
    tr.seed_rows_at(_key_words(3), (TAG_VERIFY,), range(4), 70, "cpu")
    tr.seed_rows_at(_key_words(3), (), idx, 70, torch.device("cpu"))
    tr.randint_at(_key_words(3), (TAG_TOFF,), range(4), 1000, "cpu")
    assert tr.launches == before


def test_a_call_that_would_launch_raises_without_the_kernel(no_kernel):
    """No fallback: the CUDA path raises when the library cannot be built,
    and counts nothing."""
    before = dict(tr.launches)
    with pytest.raises(RuntimeError, match="cannot build threefry"):
        tr.seed_rows_at(_key_words(1), (TAG_VERIFY,), range(4), 64, "cuda")
    with pytest.raises(RuntimeError, match="cannot build threefry"):
        tr.randint_at(_key_words(1), (TAG_TOFF,), range(4), 1000, "cuda")
    assert tr.launches == before


@pytest.mark.parametrize("rows,match", [
    (torch.zeros(4, dtype=torch.int32), "must be int64"),
    (torch.zeros((2, 2), dtype=torch.int64), "1 dimension"),
    (torch.zeros(8, dtype=torch.int64)[::2], "contiguous"),
    (torch.zeros(4, dtype=torch.int64), "needs a CUDA tensor"),
    (range(0, 8, 2), "step 1"),
])
def test_bad_rows_raise_before_a_launch(no_kernel, rows, match):
    for call, arg in ((tr.seed_rows_at, 64), (tr.randint_at, 1000)):
        with pytest.raises(ValueError, match=match):
            call(_key_words(2), (), rows, arg, "cuda")


def test_bad_arguments_raise_before_a_launch(no_kernel):
    words = _key_words(2)
    with pytest.raises(ValueError, match="at most two tags"):
        tr.seed_rows_at(words, (1, 2, 3), range(4), 64, "cuda")
    for span in (0, 1 << 32):
        with pytest.raises(ValueError, match="span"):
            tr.randint_at(words, (), range(4), span, "cuda")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tr.seed_rows_at(words, (), range(4), 64, "meta")


@pytest.mark.parametrize("key,match", [
    (torch.zeros((4, 2), dtype=torch.int32), "must be int64"),
    (torch.zeros((4, 3), dtype=torch.int64), r"\(\.\.\., 2\)"),
    (torch.zeros((2, 4), dtype=torch.int64).T, "contiguous"),
    (torch.zeros((4, 2), dtype=torch.int64), "needs a CUDA tensor"),
])
def test_bad_keys_raise_before_a_launch(no_kernel, key, match):
    with pytest.raises(ValueError, match=match):
        tr._hash(key, 8, False)


def test_bindings_match_the_kernel_source():
    """Every C entry point of csrc/threefry.cu is bound, with as many
    argument types as it has parameters, and has a launch counter."""
    src = (_build._CSRC / f"{tr.LIBRARY}.cu").read_text()
    entries = dict(re.findall(r'extern "C" int qtpu_(\w+)\(([^)]*)\)', src))
    assert set(entries) == set(tr._ARGTYPES) == set(tr.launches)
    for name, params in entries.items():
        assert len(params.split(",")) == len(tr._ARGTYPES[name]), name


# ---------------------------------------------------------------------------
# The draw table: a window program's draws in one call (one launch on a
# card).

def _reference_draw(words, d):
    """One draw as the reference constructs it (numpy)."""
    key = _tagged(words, d.tags)
    rows = d.rows
    if isinstance(rows, range):
        idx = jnp.arange(rows.start, rows.stop, dtype=jnp.uint32)
    else:
        idx = jnp.asarray(rows.numpy().astype(np.uint32))
    if isinstance(d, tr.SeedRows):
        return _seed_rows_at(key, idx, d.length)
    want = jax.vmap(lambda k: jax.random.randint(
        k, (), jnp.uint32(0), jnp.uint32(d.span), dtype=jnp.uint32))(
        _keys_at(key, idx))
    return np.asarray(want).astype(np.int64)


_IDX = torch.tensor([5, 0, 127, 3, 96, 2**32 - 1], dtype=torch.int64)
TABLES = {
    # Alice's program: puncture pad, shortening fill, verify seed, offsets.
    "alice": lambda w: [
        tr.SeedRows(w, (), range(4), 2048),
        tr.SeedRows(w, (TAG_SHORTFILL,), range(4), 64),
        tr.SeedRows(w, (TAG_VERIFY,), range(1), 1087),
        tr.Randint(w, (TAG_TOFF,), range(4), 1024)],
    # A shard of Bob's program: rows from row0 = 96.
    "bob_shard": lambda w: [
        tr.Randint(w, (TAG_TOFF,), range(96, 128), 63488),
        tr.SeedRows(w, (TAG_SHORTFILL,), range(96, 128), 2048),
        tr.SeedRows(w, (TAG_VERIFY,), range(1), 63551)],
    # The retry: index rows beside a range.
    "retry": lambda w: [
        tr.SeedRows(w, (TAG_SHORTFILL,), _IDX, 33),
        tr.SeedRows(w, (TAG_VERIFY,), range(1), 100)],
    # Eight draws (the most a table takes): every kind, 0-2 tags, range
    # and index rows, ragged lengths, spans past 2^16 and 2^31.
    "eight_ragged": lambda w: [
        tr.SeedRows(w, (), range(3), 1),
        tr.SeedRows(w, (TAG_VERIFY,), range(2, 5), 31),
        tr.SeedRows(w, (TAG_TOFF, TAG_SHORTFILL), _IDX, 16421),
        tr.Randint(w, (), _IDX, 3),
        tr.Randint(w, (TAG_TOFF, TAG_VERIFY), range(7), 2**32 - 1),
        tr.SeedRows(w, (5,), range(0), 64),
        tr.Randint(w, (TAG_TOFF,), range(32, 40), 100003),
        tr.SeedRows(w, (1, 2), range(1), 110460)],
}


@pytest.mark.parametrize("which", list(TABLES))
def test_draw_table_equals_single_draws_and_reference(which):
    """Each output of a table == the same draw alone == the reference's
    construction; the plain table is the list of the plain draws."""
    words = _key_words(len(which))
    table = TABLES[which](words)
    got = tr.draws(table, "cpu")
    assert len(got) == len(table) == len(tr.draws_plain(table, "cpu"))
    for d, g, p in zip(table, got, tr.draws_plain(table, "cpu")):
        if isinstance(d, tr.SeedRows):
            alone = tr.seed_rows_at(*d, "cpu")
            assert g.dtype == torch.uint8 and g.shape == (len(d.rows),
                                                          d.length)
        else:
            alone = tr.randint_at(*d, "cpu")
            assert g.dtype == torch.int64 and g.shape == (len(d.rows),)
        assert torch.equal(g, alone) and torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), _reference_draw(words, d))


@pytest.fixture
def table_as_card(monkeypatch):
    """CPU tensors stand in for CUDA ones and the launch is recorded: each
    call's table as the kernel would read it."""
    calls = []

    def call(library, name, argtypes, dev, addr, n):
        entries = (tr._DrawEntry * n).from_address(addr)
        calls.append([{f: (tuple(getattr(e, f)) if f in ("key", "tag")
                           else getattr(e, f)) for f, _ in e._fields_}
                      for e in entries])
    monkeypatch.setattr(tr, "_on_card", lambda dev: True)
    monkeypatch.setattr(_build, "entry", lambda *a: None)
    monkeypatch.setattr(_build, "call", call)
    return calls


def test_a_table_is_one_launch_of_its_live_draws(table_as_card):
    """The wrapper fills one entry a draw with rows (in order: kind, tag
    count, key words, tags, range start, rows, size, its output) and
    launches once; an empty draw gets its empty output and no entry."""
    words = [0x12345678, 0x9ABCDEF0]
    before = tr.launches["threefry_draws"]
    table = [tr.SeedRows(words, (TAG_VERIFY,), range(2, 5), 70),
             tr.SeedRows(words, (), range(3, 3), 64),
             tr.Randint(words, (TAG_TOFF, 2**32 + 7), range(9), 1000)]
    outs = tr.draws(table, "cpu")
    assert [tuple(o.shape) for o in outs] == [(3, 70), (0, 64), (9,)]
    assert tr.launches["threefry_draws"] == before + 1
    [entries] = table_as_card
    assert [(e["kind"], e["ntags"], e["key"], e["tag"], e["row0"], e["b"],
             e["size"], e["out"]) for e in entries] == [
        (0, 1, tuple(words), (TAG_VERIFY, 0), 2, 3, 70, outs[0].data_ptr()),
        (1, 2, tuple(words), (TAG_TOFF, 7), 0, 9, 1000,
         outs[2].data_ptr())]
    assert all(e["rows"] is None for e in entries)
    # A table without a live draw launches nothing.
    assert tr.draws([tr.SeedRows(words, (), range(0), 8)], "cpu")[0].shape \
        == (0, 8)
    assert tr.launches["threefry_draws"] == before + 1
    assert len(table_as_card) == 1


def test_bad_tables_raise_before_a_launch(no_kernel):
    words = _key_words(4)
    before = dict(tr.launches)
    with pytest.raises(ValueError, match="at most 8 draws"):
        tr.draws([tr.SeedRows(words, (), range(1), 8)] * 9, "cuda")
    with pytest.raises(ValueError, match="SeedRows or a Randint"):
        tr.draws([(words, (), range(1), 8)], "cuda")
    with pytest.raises(ValueError, match="span"):
        tr.draws([tr.SeedRows(words, (), range(1), 8),
                  tr.Randint(words, (), range(1), 0)], "cuda")
    with pytest.raises(RuntimeError, match="cannot build threefry"):
        tr.draws([tr.SeedRows(words, (), range(1), 8),
                  tr.Randint(words, (), range(4), 9)], "cuda")
    assert tr.launches == before


def test_draw_entry_matches_the_kernel_source():
    """random._DrawEntry lays out csrc/threefry.cu's QtpuDraw field for
    field, and MAX_DRAWS is the kernel's kMaxDraws."""
    src = (_build._CSRC / f"{tr.LIBRARY}.cu").read_text()
    body = re.search(r"struct QtpuDraw \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w\s\*]+?)\s*(\w+)(\[\d\])?;", body, re.M)
    c_types = {"int32_t": ctypes.c_int32, "uint32_t": ctypes.c_uint32,
               "long long": ctypes.c_longlong, "const int64_t*":
               ctypes.c_void_p, "void*": ctypes.c_void_p}
    got = [(name, c_types[" ".join(t.split())] * int(n[1:-1]) if n
            else c_types[" ".join(t.split())]) for t, name, n in fields]
    want = tr._DrawEntry._fields_
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(b) and (
            getattr(a, "_type_", a) == getattr(b, "_type_", b))
    assert int(re.search(r"kMaxDraws = (\d+);", src).group(1)) \
        == tr.MAX_DRAWS
