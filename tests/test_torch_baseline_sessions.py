"""qtpu_torch.baseline's session-level configs against the reference, on
the CPU: the efficiency sweep (``benchmarks/efficiency.py``: the two-party
loopback protocol) and BASELINE config 5 (``benchmarks/config5_multihost.py``
with ``tests/multihost_worker.py``: Bob's window program over two gloo
processes), on the reference scripts' own numpy inputs at a small size.
Tolerance: exact; times are not compared.  The single-call configs and the
decoder API names are in tests/test_torch_baseline.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import qtpu.parallel as jpar
import qtpu.pipeline as jpipe
from qtpu import prng as jprng
from qtpu.accounting import LEDGER_FIELDS
from qtpu.ldpc import codes as jcodes
from qtpu.stream import DeviceStream as JStream
from qtpu.window_programs import choose_affine as j_choose_affine
from qtpu.window_programs import make_header as j_make_header
from qtpu.window_programs import make_window_programs as j_make_programs
import qtpu_torch.pipeline as tpipe
from qtpu_torch import baseline
from qtpu_torch.parallel import make_mesh


@pytest.fixture(scope="module", autouse=True)
def settled_reference_flush():
    """The reference's flush waits for pending stats, so its rung choices
    see the same prior as the port's (tests/test_torch_pipeline.py)."""
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


def test_efficiency_matches_reference():
    """n = 1024, B = 4, QBER 2% and 5%, one window in flight, 8·B·n bits
    each: the rows equal efficiency.py's formulas over the reference's
    run_loopback on the same default_rng(1) draws."""
    kw = dict(n=1024, blocks_per_window=4, qber_test_bits=8192,
              max_inflight_windows=1)
    qbers = (0.02, 0.05)
    got = baseline.efficiency(device="cpu", config=tpipe.PipelineConfig(**kw),
                              qbers=qbers, min_total=0)
    assert (got["config"], got["n"], got["blocks_per_window"]) == (
        "efficiency", 1024, 4)
    rng = np.random.default_rng(1)
    for row, q in zip(got["rows"], qbers):
        total = 8 * 4 * 1024
        a = rng.integers(0, 2, total).astype(np.uint8)
        b = a ^ (rng.random(total) < q).astype(np.uint8)
        alice, bob = jpipe.run_loopback(jpipe.PipelineConfig(**kw), a, b)
        key = alice.final_key_bits()
        np.testing.assert_array_equal(bob.final_key_bits(), key)
        led = alice.ledger
        consumed = led.sifted_bits - alice.stream.remaining
        want = {
            "qber": q,
            "f": round(led.syndrome_bits / max(1, led.reconciled_bits)
                       / baseline.h2(q), 3),
            "secret_fraction": round(led.final_bits / max(1, consumed), 4),
            "blocks_failed": led.blocks_failed,
            "windows": len(bob.metrics),
            "mean_iters": round(float(np.mean([m.iters_mean
                                               for m in bob.metrics])), 1),
            "final_bits": led.final_bits, "key_bits": key.size}
        assert {k: row[k] for k in want} == want
        assert row["windows"] >= 4 and row["key_bits"] > 0


def _reference_config5_ledger() -> list:
    """tests/multihost_worker.py's window in one process: Bob's program
    sharded over the conftest's 8 forced JAX CPU devices."""
    jmesh = jpar.make_mesh("blocks", num=8)
    code = jcodes.make_regular_code(1024)
    pay = np.arange(code.n, dtype=np.int64)
    empty = np.zeros(0, np.int64)
    B, k_pb = 16, 8
    kwargs = dict(max_iters=20, alg="minsum", verify_hash_bits=64, l_max=128,
                  batch=B, k_pb=k_pb, s_max=32)
    progs = j_make_programs(code, pay, empty, empty, mesh=jmesh, **kwargs)
    local = j_make_programs(code, pay, empty, empty, **kwargs)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    bob = keys ^ (rng.random((B, code.n)) < 0.02).astype(np.uint8)
    wkey = jprng.key_data(jprng.derive(jprng.root_key(3), "win", 0))
    pkey = jprng.key_data(jprng.derive(jprng.root_key(7), "punct", 0))
    a, ainv = j_choose_affine(iter([7]), code.n)
    header = jnp.asarray(j_make_header(0, 0, wkey, pkey, test_bits_pb=k_pb,
                                       affine=(a, ainv, 3)))
    sa, sb = JStream(1 << 16), JStream(1 << 16)
    sa.push(keys.reshape(-1))
    sb.push(bob.reshape(-1))
    _, syn, hashes, test, short = local.alice(sa.arena, header)
    sh = NamedSharding(jmesh, P("blocks", None))
    out = progs.bob(sb.arena, header, *(jax.device_put(x, sh) for x in
                                        (test, short, syn, hashes)),
                    jnp.float32(np.log(0.98 / 0.02)))
    return np.asarray(out[5]).tolist()


def test_config5_two_processes_match_reference():
    """Two gloo CPU processes (a free port), 4 of 8 shards each: both
    psum'd ledgers equal, and equal to the reference's 8-device program's
    and to the port's one-process 8-shard program's."""
    got = baseline.config5(device="cpu", timeout=240)
    assert got["ok"] and got["ledgers_agree"], got
    ledger = json.loads(got["global_ledger"])
    assert ledger == _reference_config5_ledger()
    one = baseline.config5_window(torch.device("cpu"),
                                  make_mesh(devices=["cpu"] * 8))
    assert ledger == one
    f = {name: i for i, name in enumerate(LEDGER_FIELDS)}
    assert ledger[f["blocks_ok"]] == 16 and ledger[f["syndrome_bits"]] == 8192
