"""qtpu_torch.parallel and the mesh Bob vs qtpu.parallel, on the CPU.

The shapes of tests/test_parallel.py: a regular n = 1024 code, B = 16
blocks, a mesh of 8 shards — 8 CPU shards in the port, the conftest's 8
forced CPU devices in JAX.  Every comparison is exact unless a test states
otherwise.  The layered schedule is held to golden on blocks that never
converge (XLA on the CPU forms an FMA there that golden, the port and the
CUDA kernel do not; ROADMAP.md §3) and to the JAX decoder on the rest.
"""

import datetime
import queue
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__
import qtpu.parallel as jpar
import qtpu.pipeline as jpipe
from qtpu.ldpc.decode import channel_llr
from qtpu.ldpc.encode import make_batch_encoder
from qtpu.ldpc.golden import decode as golden_decode
from qtpu.window_programs import make_window_programs as j_make_programs
import qtpu_torch.link as tlink
import qtpu_torch.pipeline as tpipe
from qtpu_torch import pa, prng
from qtpu_torch.accounting import LEDGER_FIELDS
from qtpu_torch.ldpc.codes import code_from_reference, make_regular_code
from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
from qtpu_torch.parallel import (Mesh, init_distributed, make_mesh,
                                 make_sharded_decoder, make_stream_pa,
                                 psum_ledger, sharded_stream_toeplitz)
from qtpu_torch.stream import DeviceStream
from qtpu_torch.window_programs import (choose_affine, make_header,
                                        make_window_programs)

B, N_CODE, SHARDS = 16, 1024, 8
IDX = {f: i for i, f in enumerate(LEDGER_FIELDS)}


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= SHARDS, "conftest must force 8 CPU devices"
    return jpar.make_mesh("blocks", num=SHARDS)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(num=SHARDS, devices=["cpu"] * SHARDS)


def _decode_inputs(qbers, seed):
    code = make_regular_code(N_CODE)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    noise = rng.random((B, code.n)) < np.asarray(qbers)[:, None]
    syn = np.array(make_batch_encoder(code)(jnp.asarray(keys)))
    llr = np.array(channel_llr(jnp.asarray(keys ^ noise), 0.02))
    return code, llr, syn


def _np(res):
    return tuple(np.asarray(x) for x in res)


@pytest.mark.parametrize("alg", ["minsum", "layered", "sumprod"])
def test_sharded_decoder_matches_unsharded_and_reference(mesh, jmesh, alg):
    """Port sharded == port unsharded (bits, iterations, converged) for
    every schedule.  Against the JAX sharded decoder: every block for
    min-sum; converged blocks for layered (golden on the rest); converged
    blocks' bits and flags for sum-product, whose tanh/atanh differ in the
    last bit between the libraries."""
    qbers = np.repeat([0.01, 0.02, 0.03, 0.09], 4)
    code, llr, syn = _decode_inputs(qbers, 0)
    tcode = code_from_reference(code)
    args = (torch.from_numpy(llr), torch.from_numpy(syn))
    sharded = _np(make_sharded_decoder(tcode, mesh, 40, alg)(*args))
    single = _np(make_cuda_decoder(tcode, 40, alg=alg)(*args))
    plain = _np(make_sharded_decoder(tcode, mesh, 40, alg,
                                     use_kernel=False)(*args))
    for a, b, c in zip(sharded, single, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    bits, conv, iters = sharded
    assert conv.any() and not conv.all()
    sh = NamedSharding(jmesh, P("blocks", None))
    ref = _np(jpar.make_sharded_decoder(code, jmesh, max_iters=40, alg=alg)(
        jax.device_put(jnp.asarray(llr), sh),
        jax.device_put(jnp.asarray(syn), sh)))
    ok = ref[1]
    if alg == "minsum":
        ok = np.ones(B, bool)
    np.testing.assert_array_equal(conv[ok], ref[1][ok])
    np.testing.assert_array_equal(bits[ok], ref[0][ok])
    if alg != "sumprod":
        np.testing.assert_array_equal(iters[ok], ref[2][ok])
    if alg == "layered":
        for b in np.flatnonzero(~ok):
            g = golden_decode(code, llr[b], syn[b], max_iters=40,
                              alg="layered")
            np.testing.assert_array_equal(g.bits.reshape(-1), bits[b])
            assert (g.iterations, g.converged) == (iters[b], conv[b])


def _bob_inputs(pkg_programs, alg="minsum"):
    """One window of tests/test_parallel.py:47-96: programs, Bob's arena,
    the header and Alice's outputs (numpy) from the unsharded port."""
    code = make_regular_code(N_CODE)
    rng = np.random.default_rng(1)
    k_pb = 8
    keys = rng.integers(0, 2, (B, code.n)).astype(np.uint8)
    bob = keys ^ (rng.random((B, code.n)) < 0.02).astype(np.uint8)
    pay = np.arange(code.n, dtype=np.int64)
    empty = np.zeros(0, np.int64)
    kwargs = dict(max_iters=40, alg=alg, verify_hash_bits=64, l_max=128,
                  batch=B, k_pb=k_pb, s_max=32)
    sa, sb = DeviceStream(1 << 16), DeviceStream(1 << 16)
    sa.push(keys.reshape(-1))
    sb.push(bob.reshape(-1))
    wkey = prng.key_data(prng.derive(prng.root_key(3), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(7), "punct", 0))
    a, ainv = choose_affine(iter([7]), code.n)
    header = make_header(0, 0, wkey, pkey, test_bits_pb=k_pb,
                         affine=(a, ainv, 3))
    single = make_window_programs(code_from_reference(code), pay, empty,
                                  empty, **kwargs)
    _, syn, hashes, test, short = single.alice(sa.arena, header)
    alice = [x.numpy() for x in (test, short, syn, hashes)]   # bob's order
    progs = pkg_programs(code, pay, empty, kwargs)
    return progs, single, sb.arena, header, alice, keys


def _port_bob(mesh, alg="minsum"):
    """(sharded outputs, unsharded outputs, keys) of the port's bob."""
    progs, single, arena, header, alice, keys = _bob_inputs(
        lambda code, pay, e, kw: make_window_programs(
            code_from_reference(code), pay, e, e, mesh=mesh, **kw), alg)
    args = (header, *(torch.from_numpy(x) for x in alice),
            np.float32(np.log(0.98 / 0.02)))
    return progs.bob(arena, *args), single.bob(arena, *args), keys


def test_mesh_bob_program_matches_unsharded_and_reference(mesh, jmesh):
    """hat, rx_orig, rx_pin, pin mask, stats and the psum'd ledger: port
    mesh == port unsharded == JAX mesh program (exact)."""
    out8, out1, keys = _port_bob(mesh)
    for a, b in zip(out8[:5], out1):
        np.testing.assert_array_equal(a.numpy(), b.numpy().astype(a.numpy().dtype))
    assert out8[3].dtype == torch.uint8
    jprogs, _, arena, header, alice, _ = _bob_inputs(
        lambda code, pay, e, kw: j_make_programs(code, pay, e, e,
                                                 mesh=jmesh, **kw))
    ref = jprogs.bob(jnp.asarray(arena.numpy()), jnp.asarray(header),
                     *(jnp.asarray(x) for x in alice),
                     jnp.float32(np.log(0.98 / 0.02)))
    for a, b in zip(out8, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gl = out8[5].numpy()
    okc = int(out8[4][:, 0].sum())
    assert okc == B and np.array_equal(out8[0].numpy(), keys)
    assert gl[IDX["syndrome_bits"]] == B * 512
    assert gl[IDX["verify_hash_bits"]] == B * 64
    assert gl[IDX["qber_test_bits"]] == B * 8
    assert gl[IDX["reconciled_bits"]] == okc * N_CODE
    assert gl[IDX["blocks_ok"]] + gl[IDX["blocks_failed"]] == B


def test_sharded_stream_toeplitz_matches_golden_and_reference(mesh, jmesh):
    """D = 8, L = 256, m = 128: the shards' summed counts mod 2, the port's
    make_stream_pa, golden and JAX make_stream_pa agree (exact)."""
    rng = np.random.default_rng(3)
    D, L, m = SHARDS, 256, 128
    x = rng.integers(0, 2, D * L).astype(np.uint8)
    t = rng.integers(0, 2, m + D * L - 1).astype(np.uint8)
    want = pa.toeplitz_hash_golden(t, x, m)
    tt, xt = torch.from_numpy(t), torch.from_numpy(x)
    counts = [sharded_stream_toeplitz(tt, xt[s * L:(s + 1) * L], m, mesh, s)
              for s in range(D)]
    assert all(c.dtype == torch.int32 for c in counts)
    np.testing.assert_array_equal(
        (psum_ledger(counts, mesh) & 1).numpy(), want)
    np.testing.assert_array_equal(make_stream_pa(mesh, D * L, m)(tt, xt),
                                  want)
    ref = jpar.make_stream_pa(jmesh, D * L, m)(jnp.asarray(t), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref), want)


def _port_session(cfg, a_bits, b_bits, mesh=None):
    """__graft_entry__._run_session on the port: the same wire loopback and
    the same pump (a blocking flush only when nothing else progressed)."""
    la, lb = tlink.make_loopback_pair()
    alice = tpipe.AliceSession(cfg, 0x5E55, la, device="cpu")
    bob = tpipe.BobSession(cfg, 0x5E55, lb, mesh=mesh, device="cpu")
    alice.push_sifted(a_bits)
    bob.push_sifted(b_bits)
    for _ in range(100_000):
        progressed = False
        if alice.can_start_window():
            alice.start_window()
            progressed = True
        for link, party in ((lb, bob), (la, alice)):
            m = link.recv()
            if m is not None:
                party.on_message(m)
                progressed = True
        if not progressed and bob.flush():
            progressed = True
        if not progressed:
            break
    return alice, bob


def test_mesh_session_matches_unsharded_and_reference(mesh, jmesh):
    """__graft_entry__.dryrun_multichip(8)'s session: the port's mesh Bob,
    its unsharded Bob and the JAX mesh Bob end with the same keys, ledgers,
    per-window metrics and per-window psum'd ledgers; each window's gled
    equals its host metrics."""
    kw = dict(n=1024, blocks_per_window=2 * SHARDS, qber_test_bits=512,
              max_iters=30)
    rng = np.random.default_rng(0)
    total = 3 * 1024 * kw["blocks_per_window"] + 4096
    a_bits = rng.integers(0, 2, total).astype(np.uint8)
    b_bits = a_bits ^ (rng.random(total) < 0.02).astype(np.uint8)
    alice, bob = _port_session(tpipe.PipelineConfig(**kw), a_bits, b_bits,
                               mesh)
    _, bob1 = _port_session(tpipe.PipelineConfig(**kw), a_bits, b_bits)
    ja, jb, jgled = __graft_entry__._run_session(
        jpipe.PipelineConfig(**kw), a_bits, b_bits, mesh=jmesh)
    key = bob.final_key_bits()
    assert key.size > 0 and len(bob.gled_by_window) >= 2
    for k in (alice.final_key_bits(), bob1.final_key_bits(),
              ja.final_key_bits(), jb.final_key_bits()):
        np.testing.assert_array_equal(k, key)
    led = bob.ledger.as_dict()
    assert led == alice.ledger.as_dict() == bob1.ledger.as_dict()
    assert led == jb.ledger.as_dict() == ja.ledger.as_dict()
    assert [m.as_dict() for m in bob.metrics] == \
        [m.as_dict() for m in jb.metrics] == [m.as_dict() for m in bob1.metrics]
    assert sorted(bob.gled_by_window) == sorted(jgled)
    for w, g in bob.gled_by_window.items():
        np.testing.assert_array_equal(g, np.asarray(jgled[w]))
    assert not bob1.gled_by_window
    for met in bob.metrics:
        g = bob.gled_by_window[met.window_id]
        assert g[IDX["syndrome_bits"]] == met.leaked_syndrome
        assert g[IDX["verify_hash_bits"]] == met.leaked_hash
        assert g[IDX["qber_test_bits"]] == met.leaked_qber
        assert g[IDX["blocks_ok"]] + g[IDX["blocks_failed"]] == met.blocks


def test_mesh_validation():
    """Uneven splits and a process-group session mesh raise; the default
    mesh is the CPU's; init_distributed is a no-op for one process."""
    code = code_from_reference(make_regular_code(N_CODE))
    pay = np.arange(code.n, dtype=np.int64)
    empty = np.zeros(0, np.int64)
    m8 = make_mesh(num=SHARDS, devices=["cpu"] * 16)
    assert (m8.size, m8.first, m8.group) == (SHARDS, 0, None)
    assert [g for g, _ in m8.local_shards()] == list(range(SHARDS))
    with pytest.raises(ValueError, match="split"):
        make_window_programs(code, pay, empty, empty, 10, "minsum", 64, 0,
                             batch=12, k_pb=8, mesh=m8)
    with pytest.raises(ValueError, match="split"):
        make_stream_pa(m8, 1001, 8)
    with pytest.raises(ValueError, match="split"):
        make_sharded_decoder(code, m8, 10)(torch.zeros(4, code.n),
                                           torch.zeros(4, code.m,
                                                       dtype=torch.uint8))
    with pytest.raises(ValueError, match="fit"):
        Mesh("blocks", ["cpu"] * 2, first=3, size=4)
    with pytest.raises(ValueError, match="process group"):
        tpipe.BobSession(tpipe.PipelineConfig(n=1024), 1, None,
                         mesh=Mesh("blocks", ["cpu"], 0, 2, group=object()))
    assert make_mesh().devices == [torch.device("cpu")]
    assert init_distributed(None, 1, 0) is None


# -- two processes over gloo --------------------------------------------------

def _gloo_worker(rank, port, out):
    """One of two processes: 4 of the 8 CPU shards, the sharded bob program
    on identical global inputs, the psum'd ledger and the local stats."""
    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", 2, rank,
                            backend="gloo") == "gloo"
    try:
        mesh = make_mesh(devices=["cpu"] * (SHARDS // 2))
        out8, _, _ = _port_bob(mesh, alg="layered")
        out.put((rank, mesh.first, mesh.size, out8[5].tolist(),
                 out8[4].numpy()))
    finally:
        torch.distributed.destroy_process_group()


def test_two_process_gloo_ledgers_equal(mesh):
    """Two spawned processes (gloo, a free port), each owning 4 of 8
    shards: the psum'd ledger is equal on both ranks and to the
    one-process mesh's, and each rank's stats are its rows of the
    one-process stats (exact).  Limited to 120 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    one, _, _ = _port_bob(mesh, alg="layered")
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=120)
    try:
        got = {}
        while len(got) < 2:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, first, size, gled, stats = out.get(timeout=max(left, 1))
            except queue.Empty:
                pytest.fail(f"two-process run: {sorted(got)} of 2 ranks "
                            f"answered in 120 s")
            got[rank] = (first, size, gled, stats)
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive() and p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert got[0][2] == got[1][2] == one[5].tolist()
    for rank, (first, size, _, stats) in got.items():
        assert (first, size) == (rank * 4, SHARDS)
        rows = slice(first * 2, (first + 4) * 2)
        np.testing.assert_array_equal(stats, one[4].numpy()[rows])
