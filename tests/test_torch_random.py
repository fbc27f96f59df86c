"""qtpu_torch.random vs jax.random: threefry2x32 bit for bit.

The window programs derive every protocol seed (shortening fill, verify
seed, per-block test offsets, puncture pad, PA seeds) from jax.random on the
default threefry2x32 implementation with ``jax_threefry_partitionable``
on; the port must reproduce those streams exactly or the two packages
disagree on every seed.  Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu_torch import random as tr


def _words(seed):
    data = np.random.default_rng(seed).integers(0, 2**32, 2, dtype=np.uint64)
    return data.astype(np.uint32)


def _key(seed):
    data = _words(seed)
    return jax.random.wrap_key_data(jnp.asarray(data)), tr.key_from_data(
        data, "cpu")


def test_partitionable_mode_is_the_reference():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_chain(seed):
    jk, tk = _key(seed)
    for d in (0, 1, 5, 2**31 + 7, 2**32 - 1, 12345):
        jk, tk = jax.random.fold_in(jk, d), tr.fold_in(tk, d)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jk)).astype(np.int64), tk.numpy())


def test_fold_in_batched():
    jk, tk = _key(3)
    idx = np.arange(0, 3000, 7, dtype=np.uint32)
    want = jax.vmap(lambda i: jax.random.key_data(jax.random.fold_in(jk, i)))(
        jnp.asarray(idx))
    got = tr.fold_in(tk, torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("width", [1, 3, 32, 97, 1000])
def test_bits(width):
    jk, tk = _key(width)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (width,), jnp.uint32)).astype(np.int64),
        tr.bits32(tk, width).numpy())


@pytest.mark.parametrize("length", [1, 31, 33, 100, 4097])
def test_seed_rows(length):
    """The reference's ``_seed_rows``: per-row folded keys, uint32 words,
    LSB-first bit unpack, truncated to a length that need not be a
    multiple of 32."""
    jk, tk = _key(length)
    rows = np.array([0, 1, 2, 7, 1000], np.uint32)
    W = -(-length // 32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(rows))
    words = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (W,), jnp.uint32))(keys))
    want = ((words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1)
    want = want.astype(np.uint8).reshape(len(rows), W * 32)[:, :length]
    got = tr.seed_rows_at(_words(length), (),
                          torch.from_numpy(rows.astype(np.int64)), length,
                          "cpu")
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("span", [61440, 63488, 65536, 1000, 3])
def test_randint(span):
    jk, _ = _key(span)
    idx = np.arange(64, dtype=np.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.asarray(idx))
    want = jax.vmap(lambda k: jax.random.randint(
        k, (), 0, span, dtype=jnp.uint32))(keys)
    got = tr.randint_at(_words(span), (),
                        torch.from_numpy(idx.astype(np.int64)), span, "cpu")
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())
