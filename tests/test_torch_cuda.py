"""qtpu_torch on the card: both BP kernels, the threefry kernel, the
syndrome encoder, pin/LLR and verify kernels, sessions and sifting on
CUDA.

Marked ``cuda``; every test skips without a CUDA device.  On a machine with
a card (which has no JAX, so the JAX import of tests/conftest.py must be
switched off):

    QTPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact — each kernel against its plain PyTorch decoder (bits,
iterations, converged; the layered kernel at every native3 rung of
n = 65536, hence at every cluster size the production ladder uses; a
launch a decoder prepared at its first call at a batch size against that
call and the plain decoder, and on the caller's side stream), the
threefry kernel's two entry points against the plain PyTorch versions
of ``qtpu_torch.random`` (seed rows at the PA seed's, the verify seed's and
the pad's lengths, offsets at the ladder's spans, every draw table of the
production ladder's programs, one launch a table), the encoder and the
pin/LLR kernels against their plain versions (every rung of the n = 1024
and n = 4096 ladders, shortened and parallel-edge codes, z = 24 and 10,
unaligned parts; each body of the encoder with the launch it makes:
production rungs at 32, 128 and 300 blocks, a part or every part off
alignment, 5,000 n = 4096 blocks, z = 8,192 in column groups;
pin_llr and llr at z = 2,048, 64 and 16, B = 1 to 128, every input
aligned or off alignment; LLRs by their float32 bit patterns), the
verify kernel's hash and its tail in each mode against their plain
versions (production rungs, z = 16, 24, 10 and 64, Vh 1 to 64, 1 to 300
rows, every input aligned or one byte off; a retry's rows merge of 11
rows, of all rows (it keeps none) and of one (it keeps all but one), on
rows that are not contiguous; the kernel refuses a plan that is not the
host's), a session on the card against the
same session on
the CPU (final keys, ledgers, per-window metrics), the bench's BSC stream
on the card against the CPU and its per-chip replay on the card, and the
sift functions on the card against the CPU on the same events (residuals
to 1e-5 relative: their float32 division may round differently on the
card).
"""

import functools

import numpy as np
import pytest
import torch

from qtpu_torch import sift
from qtpu_torch.channel import EntangledPairSource
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import (QCCode, _group_edges, make_rate_ladder,
                                   make_regular_code)
from qtpu_torch.ldpc.decode import (channel_llr, make_flooding_decoder,
                                    make_layered_decoder)
from qtpu_torch.ldpc.encode import make_batch_encoder, random_qc_code
from qtpu_torch.pipeline import PipelineConfig, run_loopback

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(code, qbers, seed, dev, punct_cols=()):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (len(qbers), code.n), dtype=np.uint8)
    noise = rng.random((len(qbers), code.n)) < np.asarray(qbers)[:, None]
    keys = torch.from_numpy(keys).to(dev)
    llr = channel_llr(keys ^ torch.from_numpy(noise).to(dev), 0.03)
    for c in punct_cols:
        llr[:, c * code.z:(c + 1) * code.z] = 0.0
    return llr, make_batch_encoder(code)(keys)


def _same(got, ref):
    assert torch.equal(got.bits, ref.bits)
    assert torch.equal(got.iterations, ref.iterations)
    assert torch.equal(got.converged, ref.converged)


@pytest.mark.parametrize("which", ["regular1024", "native3_2048"])
def test_kernel_matches_plain(dev, which):
    if which == "regular1024":
        code, qbers = make_regular_code(1024), np.linspace(0.005, 0.06, 8)
    else:
        code = make_rate_ladder(2048, family="native3",
                                alg="layered").steps[-1].code
        qbers = np.linspace(0.001, 0.03, 16)
    llr, syn = _inputs(code, qbers, 1, dev)
    before = dict(cuda_bp.launches)
    got = cuda_bp.make_cuda_decoder(code, 40)(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches == dict(before, bp_layered=before["bp_layered"]
                                    + 1)
    _same(got, make_layered_decoder(code, 40)(llr, syn))


@functools.cache
def _native3_65536():
    return make_rate_ladder(65536, family="native3", alg="layered")


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("rung", range(10))
def test_layered_kernel_every_native3_rung(dev, rung, B):
    """Every production rung (mb 4-16, so cluster sizes 2-8) at a single
    block, a retry round and more blocks than one wave of clusters."""
    steps = _native3_65536().steps
    assert len(steps) == 10
    step = steps[rung]
    llr, syn = _inputs(step.code, np.linspace(0.02, 0.04, B), 40 + rung, dev,
                       step.punct_cols)
    before = cuda_bp.launches["bp_layered"]
    got = cuda_bp.make_cuda_decoder(step.code, 60)(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches["bp_layered"] == before + 1
    _same(got, make_layered_decoder(step.code, 60)(llr, syn))


def test_layered_kernel_block_running_every_sweep(dev):
    """B = 8 on the highest rung above its ceiling: blocks run all 60
    sweeps and end unconverged, bit for bit with the plain decoder."""
    step = _native3_65536().steps[-1]
    llr, syn = _inputs(step.code, np.full(8, 0.05), 7, dev, step.punct_cols)
    ref = make_layered_decoder(step.code, 60)(llr, syn)
    assert int(ref.iterations.max()) == 60 and not bool(ref.converged.all())
    _same(cuda_bp.make_cuda_decoder(step.code, 60)(llr, syn), ref)


def test_layered_kernel_regular_4096_one_cta(dev):
    """An n = 4096 code's whole state fits one CTA: cluster size 1."""
    code = make_regular_code(4096)
    assert cuda_bp.layered_plan(code, dev, 64).cluster == 1
    llr, syn = _inputs(code, np.linspace(0.005, 0.07, 64), 8, dev)
    _same(cuda_bp.make_cuda_decoder(code, 60)(llr, syn),
          make_layered_decoder(code, 60)(llr, syn))


def test_layered_plan_and_memory(dev):
    """The production plan: a cluster whose CTAs fit the opt-in shared
    memory and that the card can schedule (the C occupancy query); one
    decode allocates its outputs and nothing else."""
    step = _native3_65536().steps[6]
    plan = cuda_bp.layered_plan(step.code, dev, 128)
    optin = cuda_bp._lib("bp_layered").qtpu_bp_layered_smem_optin(0)
    assert plan.cluster > 1 and plan.max_clusters > 0
    assert 0 < plan.smem <= optin
    B = 32
    llr, syn = _inputs(step.code, np.full(B, 0.03), 9, dev, step.punct_cols)
    dec = cuda_bp.make_cuda_decoder(step.code, 60)
    dec(llr, syn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    res = dec(llr, syn)
    torch.cuda.synchronize()
    outputs = B * step.code.n + B + 4 * B
    assert torch.cuda.max_memory_allocated(dev) - before <= outputs + (1 << 20)
    del res


def _one_row_code(z, nb, d=3):
    """One base row of d edges over nb base columns."""
    rows = np.zeros(d, np.int32)
    cols = np.arange(d, dtype=np.int32)
    return QCCode(z=z, mb=1, nb=nb, edge_row=rows, edge_col=cols,
                  edge_shift=np.arange(d, dtype=np.int32) % z,
                  row_edges=_group_edges(rows, 1),
                  col_edges=_group_edges(cols, nb))


def test_layered_kernel_raises_before_launch_on_shapes_it_cannot_take(dev):
    """Totals of 2048 columns x z = 64 (512 KB) fit no cluster size with
    z / C >= 32; a row of 33 edges exceeds the register arrays.  Both raise
    and nothing launches."""
    before = dict(cuda_bp.launches)
    wide = _one_row_code(64, 2048)
    llr = torch.zeros((2, wide.n), dtype=torch.float32, device=dev)
    syn = torch.zeros((2, wide.m), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="fits no cluster size"):
        cuda_bp.make_cuda_decoder(wide, 10)(llr, syn)
    with pytest.raises(ValueError, match="degree 33"):
        cuda_bp.make_cuda_decoder(_one_row_code(32, 40, d=33), 10)
    assert cuda_bp.launches == before


def _parallel_edge_code():
    """Base row 0 with two edges into column 0, row 1 two into column 3."""
    rows = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1], np.int32)
    cols = np.array([0, 0, 1, 2, 1, 2, 3, 3, 0], np.int32)
    return QCCode(z=16, mb=2, nb=4, edge_row=rows, edge_col=cols,
                  edge_shift=np.array([0, 5, 3, 7, 1, 2, 0, 9, 4], np.int32),
                  row_edges=_group_edges(rows, 2),
                  col_edges=_group_edges(cols, 4))


@pytest.mark.parametrize("which", ["regular1024", "mixed4096_r1",
                                   "parallel_edges"])
def test_flooding_kernel_matches_plain(dev, which):
    punct = ()
    if which == "regular1024":
        code, qbers = make_regular_code(1024), np.linspace(0.005, 0.09, 16)
    elif which == "mixed4096_r1":
        step = make_rate_ladder(4096, family="mixed", alg="minsum").steps[1]
        code, punct = step.code, step.punct_cols
        qbers = np.linspace(0.005, 0.06, 16)
    else:
        code, qbers = _parallel_edge_code(), np.linspace(0.01, 0.2, 16)
    llr, syn = _inputs(code, qbers, 4, dev, punct)
    before = dict(cuda_bp.launches)
    got = cuda_bp.make_cuda_decoder(code, 40, alg="minsum")(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches == dict(before, bp_flooding=before["bp_flooding"]
                                    + 1)
    ref = make_flooding_decoder(code, 40)(llr, syn)
    _same(got, ref)
    if which == "regular1024":
        assert ref.converged.any() and not ref.converged.all()


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("rung", range(10))
def test_flooding_kernel_every_native3_rung(dev, rung, B):
    """The flooding kernel on the cluster path: every rung of n = 65536
    (a block's state spans a cluster) at one block, a retry-sized batch and
    more blocks than one wave of clusters."""
    step = _native3_65536().steps[rung]
    assert cuda_bp.flooding_plan(step.code, dev, B).cluster > 1
    llr, syn = _inputs(step.code, np.linspace(0.02, 0.04, B), 60 + rung, dev,
                       step.punct_cols)
    before = cuda_bp.launches["bp_flooding"]
    got = cuda_bp.make_cuda_decoder(step.code, 60, alg="minsum")(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches["bp_flooding"] == before + 1
    _same(got, make_flooding_decoder(step.code, 60)(llr, syn))


@pytest.mark.parametrize("which", ["regular4096", "native3_65536"])
def test_flooding_kernel_block_running_every_round(dev, which):
    """Blocks above the code's threshold run all 60 rounds and the check-only
    round and end unconverged, bit for bit with the plain decoder, on one
    CTA and on a cluster."""
    if which == "regular4096":
        code, punct, qber = make_regular_code(4096), (), 0.12
    else:
        step = _native3_65536().steps[-1]
        code, punct, qber = step.code, step.punct_cols, 0.05
    llr, syn = _inputs(code, np.full(8, qber), 7, dev, punct)
    ref = make_flooding_decoder(code, 60)(llr, syn)
    assert int(ref.iterations.max()) == 60 and not bool(ref.converged.all())
    _same(cuda_bp.make_cuda_decoder(code, 60, alg="minsum")(llr, syn), ref)


def test_flooding_kernel_regular_4096_one_cta(dev):
    """An n = 4096 block's state (totals and records, ~49 KB) fits one
    CTA; at a batch that runs in waves two CTAs of 512 share an SM, and a
    batch resident at once gets CTAs of 1024."""
    code = make_regular_code(4096)
    plan = cuda_bp.flooding_plan(code, dev, 1024)
    assert plan.cluster == 1 and plan.threads == 512
    assert plan.max_clusters >= 2 * 132
    assert cuda_bp.flooding_plan(code, dev, 64).threads == 1024
    llr, syn = _inputs(code, np.linspace(0.005, 0.07, 256), 8, dev)
    _same(cuda_bp.make_cuda_decoder(code, 60, alg="minsum")(llr, syn),
          make_flooding_decoder(code, 60)(llr, syn))


@pytest.mark.parametrize("which", ["regular4096", "native3_65536"])
def test_flooding_plan_and_memory(dev, which):
    """The plan fits the opt-in shared memory and can be scheduled; one
    decode allocates its outputs and nothing else."""
    if which == "regular4096":
        code, punct, B = make_regular_code(4096), (), 1024
    else:
        step = _native3_65536().steps[6]
        code, punct, B = step.code, step.punct_cols, 32
    plan = cuda_bp.flooding_plan(code, dev, B)
    optin = cuda_bp._lib("bp_flooding").qtpu_bp_flooding_smem_optin(0)
    assert plan.max_clusters > 0 and 0 < plan.smem <= optin
    llr, syn = _inputs(code, np.full(B, 0.03), 9, dev, punct)
    dec = cuda_bp.make_cuda_decoder(code, 60, alg="minsum")
    dec(llr, syn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    res = dec(llr, syn)
    torch.cuda.synchronize()
    outputs = B * code.n + B + 4 * B
    assert torch.cuda.max_memory_allocated(dev) - before <= outputs + (1 << 20)
    del res


def test_flooding_plan_fits_every_ladder(dev):
    """Every code the min-sum ladders build, n = 1024 to 131072, has a
    launch plan; the largest state (n = 131072, mixed rung 0: 1.5 MB over
    a cluster of 8) decodes bit for bit with the plain decoder."""
    for n in (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072):
        for family in ("mixed", "native3", "regular", "irregular"):
            for step in make_rate_ladder(n, family=family,
                                         alg="minsum").steps:
                assert cuda_bp.flooding_plan(step.code, dev, 1).max_clusters
    step = make_rate_ladder(131072, family="mixed", alg="minsum").steps[0]
    assert (step.code.mb, step.code.nb) == (64, 128)
    assert cuda_bp.flooding_plan(step.code, dev, 2).cluster == 8
    llr, syn = _inputs(step.code, [0.01, 0.03], 10, dev, step.punct_cols)
    _same(cuda_bp.make_cuda_decoder(step.code, 20, alg="minsum")(llr, syn),
          make_flooding_decoder(step.code, 20)(llr, syn))


def test_flooding_kernel_raises_before_launch_on_shapes_it_cannot_take(dev):
    """Totals of 2048 columns x z = 64 (512 KB) fit no cluster size with
    z / C >= 32; a row of 33 edges exceeds the kernel's sign word.  Both
    raise and nothing launches."""
    before = dict(cuda_bp.launches)
    wide = _one_row_code(64, 2048)
    llr = torch.zeros((2, wide.n), dtype=torch.float32, device=dev)
    syn = torch.zeros((2, wide.m), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="fits no cluster size"):
        cuda_bp.make_cuda_decoder(wide, 10, alg="minsum")(llr, syn)
    with pytest.raises(ValueError, match="degree 33"):
        cuda_bp.make_cuda_decoder(_one_row_code(32, 40, d=33), 10,
                                  alg="minsum")
    assert cuda_bp.launches == before


def _rows_of(res, k):
    return type(res)(res.bits[:k], res.converged[:k], res.iterations[:k])


@pytest.mark.parametrize("alg", ["layered", "minsum"])
@pytest.mark.parametrize("which,sizes", [
    ("regular4096", (1024,)),
    ("native3_65536", (128,)),
    ("native3_65536", tuple(range(1, 12))),
])
def test_prepared_launch_matches_planning_call_and_plain(dev, alg, which,
                                                         sizes):
    """At each batch size the decoder's first call plans; later calls,
    on the same inputs and on copies at other addresses, reuse the plan.
    All equal the plain decoder bit for bit (retry-sized batches of 1-11
    rows against the plain decoder's first rows of one batch of 11)."""
    if which == "regular4096":
        code, punct = make_regular_code(4096), ()
        qbers = np.linspace(0.01, 0.05, max(sizes))
    else:
        step = _native3_65536().steps[6]
        code, punct = step.code, step.punct_cols
        qbers = np.linspace(0.02, 0.04, max(sizes))
    llr, syn = _inputs(code, qbers, 11, dev, punct)
    plain = (make_layered_decoder if alg == "layered" else
             make_flooding_decoder)(code, 60)(llr, syn)
    dec = cuda_bp.make_cuda_decoder(code, 60, alg=alg)
    name = cuda_bp.KERNELS[alg]
    for B in sizes:
        x, s = llr[:B].contiguous(), syn[:B].contiguous()
        plans = cuda_bp.plans_made[name]
        first = dec(x, s)
        assert cuda_bp.plans_made[name] == plans + 1
        again, moved = dec(x, s), dec(x.clone(), s.clone())
        torch.cuda.synchronize()
        assert cuda_bp.plans_made[name] == plans + 1
        for res in (first, again, moved):
            _same(res, _rows_of(plain, B))


@pytest.mark.parametrize("planned", [False, True])
def test_decoder_launches_on_the_callers_stream(dev, planned):
    """A call made on a side stream launches there, whether it plans or
    reuses a plan: held behind an event of a sleeping stream, its kernel
    has not run when the call returns, the default stream is idle, and
    after the wait its outputs equal the plain decoder's."""
    step = _native3_65536().steps[6]
    llr, syn = _inputs(step.code, np.linspace(0.02, 0.04, 128), 12, dev,
                       step.punct_cols)
    dec = cuda_bp.make_cuda_decoder(step.code, 60)
    if planned:
        dec(llr, syn)
    torch.cuda.synchronize()
    side, sleeper = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    with torch.cuda.stream(sleeper):
        torch.cuda._sleep(200_000_000)
        held = torch.cuda.Event()
        held.record()
    side.wait_event(held)
    with torch.cuda.stream(side):
        res = dec(llr, syn)
    assert not side.query()
    assert torch.cuda.current_stream(dev).query()
    side.synchronize()
    _same(res, make_layered_decoder(step.code, 60)(llr, syn))


def test_kernel_rejects_bad_inputs(dev):
    code = make_regular_code(1024)
    llr, syn = _inputs(code, [0.01] * 4, 2, dev)
    dec = cuda_bp.make_cuda_decoder(code, 10)
    with pytest.raises(ValueError, match="float32"):
        dec(llr.double(), syn)
    with pytest.raises(ValueError, match="uint8"):
        dec(llr, syn.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        dec(llr.t().contiguous().t(), syn)


def test_flooding_kernel_rejects_bad_inputs(dev):
    code = make_regular_code(1024)
    llr, syn = _inputs(code, [0.01] * 4, 2, dev)
    dec = cuda_bp.make_cuda_decoder(code, 10, alg="minsum")
    before = dict(cuda_bp.launches)
    with pytest.raises(ValueError, match="float32"):
        dec(llr.double(), syn)
    with pytest.raises(ValueError, match="uint8"):
        dec(llr, syn.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        dec(llr.t().contiguous().t(), syn)
    with pytest.raises(ValueError, match="CUDA"):
        dec(llr, syn.cpu())
    with pytest.raises(ValueError, match=str(code.n)):
        dec(llr[:, :-1].contiguous(), syn)
    assert cuda_bp.launches == before


@pytest.mark.parametrize("alg", ["layered", "minsum"])
def test_session_on_card_matches_cpu(dev, alg):
    cfg = PipelineConfig(n=1024, blocks_per_window=4, qber_test_bits=512,
                         max_inflight_windows=1, alg=alg)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, 30_000, dtype=np.uint8)
    b = a ^ (rng.random(30_000) < 0.03).astype(np.uint8)
    ca, cb = run_loopback(cfg, a, b, device="cpu")
    ga, gb = run_loopback(cfg, a, b, device=dev)
    key = ca.final_key_bits()
    assert key.size > 0
    np.testing.assert_array_equal(ga.final_key_bits(), key)
    np.testing.assert_array_equal(gb.final_key_bits(), key)
    assert ga.ledger.as_dict() == gb.ledger.as_dict() == ca.ledger.as_dict()
    assert [m.as_dict() for m in gb.metrics] == [m.as_dict()
                                                for m in cb.metrics]


def test_bench_stream_on_card_equals_cpu(dev):
    """The bench's threefry BSC stream (equal to the reference's on the CPU,
    tests/test_torch_bench.py) is the same bits on the card."""
    from qtpu_torch.bench import device_bsc_stream
    got = device_bsc_stream(5000, 0.03, 7, chunk_bits=2048, device=dev)
    want = device_bsc_stream(5000, 0.03, 7, chunk_bits=2048, device="cpu")
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.is_cuda and torch.equal(g.cpu(), w)


# The threefry kernel's shapes: the production ladder's PA seed rows
# (P + l_max - 1 bits, 32,637-57,213 + P - 1), the verify seed (P + 63
# bits), the puncture pad and shortening fill (2,048 bits), ragged lengths.
THREEFRY_LENGTHS = [1, 31, 33, 2048, 63551, 110460, 94076]


@pytest.mark.parametrize("length", THREEFRY_LENGTHS)
@pytest.mark.parametrize("tags", [(), (3,), (4, 5)],
                         ids=["0tags", "1tag", "2tags"])
def test_threefry_seed_rows_on_card_matches_plain(dev, tags, length):
    from qtpu_torch import random as tr
    words = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    idx = torch.tensor([7, 0, 127, 2**32 - 1, 3], dtype=torch.int64,
                       device=dev)
    for rows in (range(128), range(96, 128), idx):
        before = tr.launches["threefry_draws"]
        got = tr.seed_rows_at(words, tags, rows, length, dev)
        torch.cuda.synchronize()
        assert tr.launches["threefry_draws"] == before + 1
        assert got.is_cuda and torch.equal(
            got, tr.seed_rows_at_plain(words, tags, rows, length, dev))


@pytest.mark.parametrize("span", [1, 3, 1000, 61440, 63488, 65536,
                                  2**31 + 5, 2**32 - 1])
def test_threefry_randint_on_card_matches_plain(dev, span):
    from qtpu_torch import random as tr
    words = np.array([0xDEADBEEF, 0x0BADF00D], np.uint32)
    idx = torch.arange(0, 1024, 7, dtype=torch.int64, device=dev)
    for rows in (range(128), range(96, 128), idx):
        before = tr.launches["threefry_draws"]
        got = tr.randint_at(words, (4,), rows, span, dev)
        torch.cuda.synchronize()
        assert tr.launches["threefry_draws"] == before + 1
        assert torch.equal(got, tr.randint_at_plain(words, (4,), rows, span,
                                                    dev))


def _production_draw_tables(dev):
    """(label, table) of every draw table the window programs make at each
    rung of the production ladder (``chip_smoke.py`` phase 5b's shapes),
    with the shortening fill of one z = 2,048 column, the retry's 8 index
    rows, 4 shards' row ranges and tables of ragged lengths."""
    from qtpu_torch import random as tr
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import BobSession, production_config
    cfg = production_config()
    probe = BobSession(cfg, 0x5E55, make_direct_pair()[1], device="cpu")
    rng = np.random.default_rng(57)
    wkey, pkey, pakey = (rng.integers(0, 2**32, 2, dtype=np.uint64)
                         .astype(np.uint32) for _ in range(3))
    B, Vh, z = cfg.blocks_per_window, cfg.verify_hash_bits, 2048
    idx = torch.from_numpy(np.sort(rng.choice(B, 8, replace=False))).to(dev)
    out = []
    for r, st in enumerate(probe.ladder.steps):
        P, l_max = probe.payload_per_block(r), probe.programs(r).l_max
        pad = len(st.punct_cols) * st.code.z
        verify = tr.SeedRows(wkey, (3,), range(1), P + Vh - 1)
        offsets = tr.Randint(wkey, (4,), range(B), P)
        fill = tr.SeedRows(wkey, (5,), range(B), z)
        alice = [tr.SeedRows(pkey, (), range(B), pad)] if pad else []
        out += [(f"r{r} alice", alice + [fill, verify, offsets]),
                (f"r{r} bob", [offsets, fill, verify]),
                (f"r{r} retry", [tr.SeedRows(wkey, (5,), idx, z), verify]),
                (f"r{r} pa", [tr.SeedRows(pakey, (), range(B),
                                          P + l_max - 1)] if l_max else [])]
        out += [(f"r{r} shard {g}",
                 [tr.Randint(wkey, (4,), range(g * 32, g * 32 + 32), P),
                  tr.SeedRows(wkey, (5,), range(g * 32, g * 32 + 32), z),
                  verify]) for g in range(4)]
    ragged = [tr.SeedRows(wkey, tags, range(3), length)
              for tags, length in (((), 1), ((3,), 31), ((4, 5), 33),
                                   ((), 94076), ((3,), 16421))]
    out.append(("ragged", ragged + [tr.Randint(pkey, (), idx, 2**32 - 1),
                                    tr.SeedRows(pkey, (1, 2), idx, 63551),
                                    tr.Randint(wkey, (4,), range(5), 3)]))
    return [(label, table) for label, table in out if table]


def test_threefry_draw_tables_on_card_match_plain(dev):
    """Every table of the window programs at the production ladder's
    shapes: one launch a table, each draw bit for bit its plain version."""
    from qtpu_torch import random as tr
    for label, table in _production_draw_tables(dev):
        before = dict(tr.launches)
        got = tr.draws(table, dev)
        torch.cuda.synchronize()
        assert tr.launches == dict(
            before, threefry_draws=before["threefry_draws"] + 1), label
        for d, g, w in zip(table, got, tr.draws_plain(table, dev),
                           strict=True):
            assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w), \
                (label, d)


def test_threefry_hash_on_card_matches_plain(dev):
    """fold_in (scalar and tensor data), split, bits32 and uniform through
    the generic entry point, one launch each."""
    from qtpu_torch import random as tr
    key = tr.key_from_data(np.array([7, 0], np.uint32), dev)
    keys = tr.fold_in_plain(key, torch.arange(5, dtype=torch.int64,
                                              device=dev))
    data = torch.tensor([0, 5, 2**31 + 7, 2**32 - 1, -1], dtype=torch.int64,
                        device=dev)
    cases = [
        (lambda: tr.fold_in(key, 12345), tr.fold_in_plain(key, 12345)),
        (lambda: tr.fold_in(keys, 2**32 - 1),
         tr.fold_in_plain(keys, 2**32 - 1)),
        (lambda: tr.fold_in(key, data), tr.fold_in_plain(key, data)),
        (lambda: tr.split(keys, 3), tr.split_plain(keys, 3)),
        (lambda: tr.bits32(keys, 1000), tr.bits32_plain(keys, 1000)),
        (lambda: tr.bits32(key, 1 << 20), tr.bits32_plain(key, 1 << 20)),
    ]
    for fn, want in cases:
        before = tr.launches["threefry_hash"]
        got = fn()
        torch.cuda.synchronize()
        assert tr.launches["threefry_hash"] == before + 1
        assert got.shape == want.shape and torch.equal(got, want)
    u = tr.uniform(keys, 4096)
    assert u.dtype == torch.float32 and torch.equal(
        u, ((tr.bits32_plain(keys, 4096) >> 9) | 0x3F800000)
        .to(torch.int32).view(torch.float32) - 1.0)


def test_threefry_rejects_bad_inputs_on_card(dev):
    from qtpu_torch import random as tr
    before = dict(tr.launches)
    words = np.array([1, 2], np.uint32)
    bad_rows = [torch.zeros(4, dtype=torch.int32, device=dev),
                torch.zeros(8, dtype=torch.int64, device=dev)[::2],
                torch.zeros((2, 2), dtype=torch.int64, device=dev)]
    for rows in bad_rows:
        with pytest.raises(ValueError):
            tr.seed_rows_at(words, (), rows, 64, dev)
        with pytest.raises(ValueError):
            tr.randint_at(words, (), rows, 64, dev)
    key = torch.zeros((2, 4), dtype=torch.int64, device=dev).T
    with pytest.raises(ValueError, match="contiguous"):
        tr.bits32(key, 8)
    with pytest.raises(ValueError, match="int64"):
        tr.fold_in(torch.zeros(2, dtype=torch.int64, device=dev),
                   torch.zeros(3, dtype=torch.int32, device=dev))
    assert tr.launches == before


# The window programs' syndrome encoder (csrc/qc_encode.cu) and pin/LLR
# assembly (csrc/pin_llr.cu); chip_smoke.py phase 5c holds both at every
# production rung.

# z = 24 and 10 (no ladder's: the encoder's general body), each with a
# shortened and a punctured column: (code, payload, shortened, punctured).
ODD_Z = {24: (lambda: random_qc_code(24, 8, 4), [0, 2, 3, 5, 6, 7], [1], [4]),
         10: (lambda: random_qc_code(10, 24, 6), list(range(2, 24)), [0], [1])}


def _window_layouts():
    """(name, code, ColumnLayout): every rung of the n = 1024 and mixed
    n = 4096 ladders, the z = 24 and 10 codes, a regular n = 1024 code with
    shortened and punctured columns, and a code with parallel edges
    (z = 16)."""
    from qtpu_torch.ldpc.encode import ColumnLayout
    out = []
    for cfg in (PipelineConfig(n=1024),
                PipelineConfig(n=4096, family="mixed", alg="minsum")):
        lad = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                               seed=cfg.code_seed, alg=cfg.alg,
                               family=cfg.family)
        for r, st in enumerate(lad.steps):
            sh, pu = list(st.short_cols), list(st.punct_cols)
            pay = [c for c in range(st.code.nb) if c not in sh + pu]
            out.append((f"n{cfg.n} r{r}", st.code,
                        ColumnLayout(st.code.nb, st.code.z, pay, sh, pu)))
    for z, (make, pay, sh, pu) in ODD_Z.items():
        code = make()
        out.append((f"z={z}", code, ColumnLayout(code.nb, z, pay, sh, pu)))
    reg = make_regular_code(1024)
    out.append(("regular short+punct", reg,
                ColumnLayout(reg.nb, reg.z, [c for c in range(reg.nb)
                                             if c not in (3, 9)], [3], [9])))
    par = _parallel_edge_code()
    out.append(("parallel edges", par, ColumnLayout(4, 16, [0, 3], [2], [1])))
    return out


def _card_parts(layout, B, g, offset=0, high=2):
    """Random uint8 parts in [0, high) on the card (bits by default), each
    ``offset`` bytes (one number, or one a part) into its own buffer
    (offset 1: no part is 16-byte aligned)."""
    offsets = ([offset] * len(layout.widths) if isinstance(offset, int)
               else offset)
    out = []
    for w, offset in zip(layout.widths, offsets):
        if not w:
            out.append(None)
            continue
        size = B * w * layout.z
        buf = torch.randint(0, high, (size + offset,), generator=g,
                            device=g.device, dtype=torch.uint8)
        out.append(buf[offset:].view(B, w * layout.z))
    return out


@pytest.mark.parametrize("B", [1, 8, 33])
def test_qc_encode_on_card_matches_plain(dev, B):
    from qtpu_torch.ldpc import encode as enc
    g = torch.Generator(device=dev).manual_seed(B)
    for name, code, layout in _window_layouts():
        kern = enc.make_parts_encoder(code, layout)
        for offset in (0, 1):
            parts = _card_parts(layout, B, g, offset)
            before = enc.launches["qc_encode"]
            got = kern(*parts)
            torch.cuda.synchronize()
            assert enc.launches["qc_encode"] == before + 1
            assert got.is_cuda and torch.equal(
                got, enc.encode_parts_plain(code, layout, parts)), \
                (name, offset)
        x = torch.randint(0, 2, (B, code.n), generator=g, device=dev,
                          dtype=torch.uint8)
        assert torch.equal(enc.make_batch_encoder(code)(x),
                           enc.encode_plain(code, x)), name


def _production_layout(rung):
    """(code, ColumnLayout) of production rung ``rung`` (z = 2,048)."""
    from qtpu_torch.ldpc.encode import ColumnLayout
    from qtpu_torch.pipeline import production_config
    cfg = production_config()
    st = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                          seed=cfg.code_seed, alg=cfg.alg,
                          family=cfg.family).steps[rung]
    sh, pu = list(st.short_cols), list(st.punct_cols)
    return st.code, ColumnLayout(st.code.nb, st.code.z,
                                 [c for c in range(st.code.nb)
                                  if c not in sh + pu], sh, pu)


def _encoder_case(code):
    """(code, ColumnLayout) of a name: a production rung ("r4"), the
    n = 4096 mixed ladder's rung 0, the wide z = 8,192 code, or an odd
    z ("z=24")."""
    from qtpu_torch.ldpc.encode import ColumnLayout
    if code[0] == "r":
        return _production_layout(int(code[1:]))
    if code == "n4096 r0":
        c = make_rate_ladder(4096, family="mixed", alg="minsum").steps[0].code
        return c, ColumnLayout.whole(c)
    if code == "z=8192":
        # A block does not fit in shared memory at once: column groups.
        c = random_qc_code(8192, 32, 4)
        return c, ColumnLayout.whole(c)
    make, pay, sh, pu = ODD_Z[int(code[2:])]
    c = make()
    return c, ColumnLayout(c.nb, c.z, pay, sh, pu)


# (code, b, bytes each part lies off alignment, the body it takes)
ENCODER_BODIES = [
    ("r4", 128, 0, "bulk"), ("r4", 32, 0, "bulk"), ("r4", 300, 0, "bulk"),
    ("r0", 128, 0, "bulk"), ("r9", 128, 0, "bulk"),
    ("r4", 128, (0, 0, 1), "mixed"), ("r4", 128, 1, "threads"),
    ("n4096 r0", 5000, 0, "bulk"), ("z=8192", 4, 0, "bulk"),
    ("z=24", 33, 0, "threads"), ("z=10", 33, 0, "threads")]


@pytest.mark.parametrize("code,b,off,body", ENCODER_BODIES)
def test_qc_encode_bodies_on_card(dev, code, b, off, body):
    """Each body of the encoder == plain, with the launch it makes:
    production rungs take the bulk copies (one CTA a block at b <= 132;
    at b = 300 a CTA walks 2-3 blocks through two stages); the pad one
    byte off alignment is staged by the threads (mixed), all parts off by
    the threads alone; n = 4096 at b = 5,000 (more than 132 SMs hold)
    walks blocks too; z = 8,192 stages each block in column groups; z = 24
    and 10 take the byte body."""
    from qtpu_torch.ldpc import encode as enc
    code_, layout = _encoder_case(code)
    g = torch.Generator(device=dev).manual_seed(b)
    parts = _card_parts(layout, b, g, off)
    plan = enc.launch_plan(code_, layout, parts)
    assert plan["body"] == body, plan
    assert plan["grid"] <= b and 0 < plan["smem"] <= 232448, plan
    if code == "z=8192":
        assert plan["groups"] > 1 and plan["stages"] == 2, plan
    elif b in (300, 5000):
        assert plan["grid"] < b and plan["stages"] == 2, plan
    else:
        assert plan["grid"] == b and plan["stages"] == 1, plan
    before = enc.launches["qc_encode"]
    got = enc.make_parts_encoder(code_, layout)(*parts)
    torch.cuda.synchronize()
    assert enc.launches["qc_encode"] == before + 1
    assert torch.equal(got, enc.encode_parts_plain(code_, layout, parts)), \
        plan


@pytest.mark.parametrize("code,off", [("r4", 0), ("r4", 1), ("z=8192", 0),
                                      ("z=24", 0), ("z=10", 1)])
def test_qc_encode_reads_each_bytes_lowest_bit(dev, code, off):
    """Parts of bytes 0..255: every body (bits packed from bulk copies or
    from the threads' staging, column groups, the byte body) reads each
    byte's lowest bit, as the plain version does."""
    from qtpu_torch.ldpc import encode as enc
    code_, layout = _encoder_case(code)
    b = 4 if code == "z=8192" else 33
    g = torch.Generator(device=dev).manual_seed(7)
    parts = _card_parts(layout, b, g, off, high=256)
    got = enc.make_parts_encoder(code_, layout)(*parts)
    bits = [None if t is None else t & 1 for t in parts]
    want = enc.encode_parts_plain(code_, layout, bits)
    assert torch.equal(got, want)
    assert torch.equal(enc.encode_parts_plain(code_, layout, parts), want)


def _pin_inputs(layout, B, g, s_max=96, k_max=16):
    """Random disclosures whose shortening family overlaps block 0's test
    family on min(s, k) positions, Alice's values there disagreeing."""
    P = layout.widths[0] * layout.z
    dev = g.device
    bits = (lambda *shape: torch.randint(0, 2, shape, generator=g,
                                         device=dev, dtype=torch.uint8))
    boff_t = torch.randint(0, P, (B,), generator=g, device=dev)
    a = 5 if P % 5 else 7
    affine = (a, pow(a, -1, P), (a * s_max + int(boff_t[0])) % P)
    fill = bits(B, layout.widths[1] * layout.z) if layout.widths[1] else None
    return dict(rx=bits(B, P), short_alice=bits(B, s_max),
                test_alice=bits(B, k_max), boff_t=boff_t, affine=affine,
                s=s_max // 2, k=k_max // 2, s_max=s_max, fill=fill,
                qmag=float(np.float32(np.log(0.97 / 0.03))), layout=layout)


@pytest.mark.parametrize("B", [1, 8, 33])
def test_pin_llr_on_card_matches_plain(dev, B):
    from qtpu_torch import window_assembly as wa
    g = torch.Generator(device=dev).manual_seed(100 + B)
    for name, _, layout in _window_layouts():
        if layout.widths[0] * layout.z < 256:
            continue            # the disclosures need P >= s_max + k_max
        args = _pin_inputs(layout, B, g)
        before = dict(wa.launches)
        got = wa.pin_llr(**args)
        torch.cuda.synchronize()
        assert wa.launches == dict(before, pin_llr=before["pin_llr"] + 1)
        want = wa.pin_llr_plain(**args)
        for x, y in zip(got, want):
            assert x.is_cuda and x.dtype == y.dtype and torch.equal(
                x.view(torch.int32) if x.is_floating_point() else x,
                y.view(torch.int32) if y.is_floating_point() else y), name
        pin = got[1] | (torch.rand(got[1].shape, generator=g,
                                   device=dev) < 0.1)
        out = wa.llr(got[0], pin, args["fill"], args["qmag"], layout)
        ref = wa.llr_plain(got[0], pin, args["fill"], args["qmag"], layout)
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), \
            name


def _off_alignment(t, off):
    """A copy of ``t`` whose storage starts ``off`` bytes past an aligned
    address (contiguous, so the kernel takes it)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:] = t.reshape(-1)
    return buf[off:].view(t.shape)


@pytest.mark.parametrize("B", [1, 8, 33, 128])
def test_pin_llr_at_every_width_on_card_matches_plain(dev, B):
    """z = 2,048 (the production rung), 64 and 16, with pins of both
    families overlapping, and every input aligned or 1, 4, 7, 8 or 13
    bytes off alignment (each shift of two aligned 16-byte loads); z = 24
    and 10, which no ladder has, take the kernel's byte body."""
    from qtpu_torch import window_assembly as wa
    from qtpu_torch.ldpc.encode import ColumnLayout
    from qtpu_torch.pipeline import production_config
    cfg = production_config()
    st = make_rate_ladder(cfg.n, cfg.dv, cfg.target_rates,
                          seed=cfg.code_seed, alg=cfg.alg,
                          family=cfg.family).steps[4]
    sh, pu = list(st.short_cols), list(st.punct_cols)
    layouts = [ColumnLayout(st.code.nb, st.code.z,
                            [c for c in range(st.code.nb)
                             if c not in sh + pu], sh, pu),
               ColumnLayout(8, 64, [0, 2, 3, 5, 6, 7], [1], [4]),
               ColumnLayout(24, 16, list(range(2, 24)), [0], [1]),
               ColumnLayout(8, 24, [0, 2, 3, 5, 6, 7], [1], [4]),
               ColumnLayout(24, 10, list(range(2, 24)), [0], [1])]
    g = torch.Generator(device=dev).manual_seed(200 + B)
    for layout in layouts:
        assert layout.z in (2048, 64, 16, 24, 10)
        for off in (0, 1, 4, 7, 8, 13):
            args = _pin_inputs(layout, B, g)
            if off:
                args.update({k: _off_alignment(args[k], off) for k in
                             ("rx", "short_alice", "test_alice")})
                if args["fill"] is not None:
                    args["fill"] = _off_alignment(args["fill"], off)
            before = dict(wa.launches)
            got = wa.pin_llr(**args)
            torch.cuda.synchronize()
            assert wa.launches == dict(before,
                                       pin_llr=before["pin_llr"] + 1)
            want = wa.pin_llr_plain(**args)
            for x, y in zip(got, want, strict=True):
                assert x.dtype == y.dtype and torch.equal(
                    x.view(torch.int32) if x.is_floating_point() else x,
                    y.view(torch.int32) if y.is_floating_point() else y), \
                    (layout.z, off)
            rx_pin = _off_alignment(got[0], off)
            pin = _off_alignment(got[1] | (torch.rand(
                got[1].shape, generator=g, device=dev) < 0.1), off)
            out = wa.llr(rx_pin, pin, args["fill"], args["qmag"], layout)
            assert wa.launches["llr"] == before["llr"] + 1
            ref = wa.llr_plain(rx_pin, pin, args["fill"], args["qmag"],
                               layout)
            assert torch.equal(out.view(torch.int32),
                               ref.view(torch.int32)), (layout.z, off)


def test_window_kernels_reject_bad_inputs_on_card(dev):
    from qtpu_torch import window_assembly as wa
    from qtpu_torch.ldpc import encode as enc
    name, code, layout = _window_layouts()[-2]
    g = torch.Generator(device=dev).manual_seed(9)
    parts = _card_parts(layout, 4, g)
    args = _pin_inputs(layout, 4, g)
    before = (dict(enc.launches), dict(wa.launches))
    kern = enc.make_parts_encoder(code, layout)
    with pytest.raises(ValueError, match="contiguous"):
        kern(parts[0].T.contiguous().T, *parts[1:])
    with pytest.raises(ValueError, match="is on cpu"):
        kern(parts[0], parts[1].cpu(), parts[2])
    with pytest.raises(ValueError, match="boff_t must be"):
        wa.pin_llr(**dict(args, boff_t=args["boff_t"].to(torch.int32)))
    with pytest.raises(ValueError, match="pin must be"):
        wa.llr(args["rx"], args["rx"], args["fill"], 1.0, layout)
    assert (enc.launches, wa.launches) == before


def _verify_layouts():
    """(name, ColumnLayout) the verify kernel is held at: production rungs
    0, 4 and 9 (z = 2,048), the mixed n = 4096 ladder's rung 1 (z = 16: a
    word spans two columns), the z = 24 and 10 codes (P not a multiple of
    32) and a regular n = 1024 code (z = 64)."""
    from qtpu_torch.ldpc.encode import ColumnLayout
    out = [(f"r{r}", _production_layout(r)[1]) for r in (0, 4, 9)]
    for name, code, layout in _window_layouts():
        if name in ("n4096 r1", "z=24", "z=10", "regular short+punct"):
            out.append((name, layout))
    assert len(out) == 7 and all(isinstance(lay, ColumnLayout)
                                 for _, lay in out)
    return out


def _tail_inputs(layout, b, B, g, vh=64):
    """One decode's tail arguments: b decoded rows (random bits, 5% pins,
    converged mostly) of a window of B rows whose expected hashes are the
    first decode's own on every other row and one bit off elsewhere."""
    from qtpu_torch import window_verify as wv
    dev = g.device
    P = layout.widths[0] * layout.z
    bits = (lambda *shape: torch.randint(0, 2, shape, generator=g,
                                         device=dev, dtype=torch.uint8))
    args = dict(bits=bits(b, layout.nb * layout.z), rx_pin=bits(b, P),
                pin=torch.rand((b, P), generator=g, device=dev) < 0.05,
                rx_orig=bits(B, P), seed=bits(P + vh - 1),
                converged=torch.rand(b, generator=g, device=dev) < 0.9,
                iterations=torch.randint(1, 60, (b,), generator=g,
                                         device=dev, dtype=torch.int32),
                layout=layout)
    hat, _ = wv.tail_plain(**dict(args, rx_orig=args["rx_orig"][:b]),
                           exp_hashes=bits(b, vh),
                           mism=torch.zeros(b, dtype=torch.int32,
                                            device=dev))
    exp = bits(B, vh)
    exp[:b] = wv.hash_plain(hat, args["seed"])
    exp[1:b:2, 0] ^= 1
    args["exp_hashes"] = exp
    return args


def _same_out(got, want, what):
    for x, y in zip(got, want, strict=True):
        assert x.is_cuda and x.dtype == y.dtype and torch.equal(x, y), what


VERIFY_ROWS = [1, 8, 32, 128, 300]


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("vh", [1, 31, 33, 64])
@pytest.mark.parametrize("b", VERIFY_ROWS)
def test_verify_hash_on_card_matches_plain(dev, b, vh, off):
    """Every layout's P at b rows (each row count a plan of its own: a row
    split over a cluster at 1-32 rows, a row a CTA at 128 and 300), every
    input aligned or one byte off alignment; one launch a call, bit for
    bit."""
    from qtpu_torch import window_verify as wv
    g = torch.Generator(device=dev).manual_seed(300 + vh + off + b)
    for name, layout in _verify_layouts():
        P = layout.widths[0] * layout.z
        x = torch.randint(0, 2, (b, P), generator=g, device=dev,
                          dtype=torch.uint8)
        seed = torch.randint(0, 2, (P + vh - 1,), generator=g,
                             device=dev, dtype=torch.uint8)
        if off:
            x, seed = _off_alignment(x, off), _off_alignment(seed, off)
        before = wv.launches["verify_hash"]
        got = wv.hash(x, seed)
        torch.cuda.synchronize()
        assert wv.launches["verify_hash"] == before + 1
        _same_out((got,), (wv.hash_plain(x, seed),), (name, b))


def _tail_calls(mode, b):
    """(decoded rows, window rows) of ``mode``'s calls at b: the first
    decode of b rows; the rows merge of min(11, b) rows, of all b (it keeps
    none) and of one (it keeps all but one) of a window of b, and of b
    rows of a window of 128 where b < 128."""
    if mode == "first":
        return [(b, b)]
    calls = [(min(11, b), b), (b, b), (1, b)] + ([(b, 128)] if b < 128
                                                  else [])
    return list(dict.fromkeys(calls))


def _tail_merge(mode, n, B, P, g):
    """The merge kwargs of ``mode`` for n decoded rows of a window of B:
    the first decode's mismatch counts; the rows merge's old hat and
    stats (old iterations below and above the new) and its rows, window
    rows that are not contiguous (a random permutation's first n)."""
    dev = g.device
    if mode == "first":
        return dict(mism=torch.randint(0, 9, (n,), generator=g, device=dev,
                                       dtype=torch.int32))
    st = torch.randint(0, 60, (B, 4), generator=g, device=dev,
                       dtype=torch.int32)
    st[:, 0] = torch.randint(0, 3, (B,), generator=g, device=dev)
    rows = torch.randperm(B, generator=g, device=dev).cpu().numpy()[:n]
    assert n < 2 or n == B or np.ptp(rows) >= n, rows
    return dict(hat=torch.randint(0, 2, (B, P), generator=g, device=dev,
                                  dtype=torch.uint8), stats=st, rows=rows)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("mode", ["first", "rows"])
@pytest.mark.parametrize("b", VERIFY_ROWS)
def test_verify_tail_on_card_matches_plain(dev, b, mode, off):
    """Each mode at every layout and b rows (``_tail_calls``): the first
    decode (B = b); the rows merge of 11, all and one of B = b rows, and
    of b of B = 128; every input aligned or one byte off alignment; one
    launch a call, bit for bit."""
    from qtpu_torch import window_verify as wv
    g = torch.Generator(device=dev).manual_seed(400 + off + b)
    for name, layout in _verify_layouts():
        P = layout.widths[0] * layout.z
        for n, B in _tail_calls(mode, b):
            args = _tail_inputs(layout, n, B, g)
            merge = _tail_merge(mode, n, B, P, g)
            if off:
                args, merge = ({k: (_off_alignment(v, off)
                                    if isinstance(v, torch.Tensor) else v)
                                for k, v in d.items()} for d in (args, merge))
            before = wv.launches["verify_tail"]
            got = wv.tail(**args, **merge)
            torch.cuda.synchronize()
            assert wv.launches["verify_tail"] == before + 1
            want = wv.tail_plain(**args, **merge)
            _same_out(got, want, (name, n, B))
            if mode == "first" and b >= 8:
                ok = want[1][:, 0].bool().cpu()
                assert ok.any() and not ok.all(), (name, b)


def test_verify_kernel_rejects_bad_inputs_on_card(dev):
    from qtpu_torch import window_verify as wv
    name, layout = _verify_layouts()[1]
    g = torch.Generator(device=dev).manual_seed(9)
    args = _tail_inputs(layout, 4, 4, g)
    before = dict(wv.launches)
    with pytest.raises(ValueError, match="Vh = 65"):
        wv.hash(args["rx_pin"], torch.zeros(layout.widths[0] * layout.z
                                            + 64, dtype=torch.uint8,
                                            device=dev))
    with pytest.raises(ValueError, match="is on cpu"):
        wv.tail(**dict(args, rx_orig=args["rx_orig"].cpu()),
                mism=torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="repeats a row"):
        wv.tail(**args, hat=args["rx_orig"],
                stats=torch.zeros((4, 4), dtype=torch.int32, device=dev),
                rows=np.array([1, 1, 2, 3]))
    assert wv.launches == before
    # The kernel takes only the plan's own numbers: shared memory a word
    # short, or a slice that leaves a group out, is refused (-1).
    from qtpu_torch import _build
    x, seed = args["rx_pin"], args["seed"]
    b, P = x.shape
    vh = seed.numel() - P + 1
    p = wv.launch_plan(dev.index, b, b, P, vh)
    out = torch.empty((b, vh), dtype=torch.uint8, device=dev)
    for bad in (p._replace(smem=p.smem - 4),
                p._replace(cluster=2, groups=1),
                p._replace(cluster=3)):
        with pytest.raises(RuntimeError, match=r"code -1"):
            _build.call(wv.LIBRARY, "verify_hash",
                        wv._ARGTYPES["verify_hash"], dev,
                        x.data_ptr(), seed.data_ptr(), b, P, vh,
                        out.data_ptr(), bad.cluster, bad.groups,
                        bad.threads, bad.smem)


def test_bench_replay_on_card(dev):
    """On the card a decode lands while the host runs on, so Bob's rate
    choices at max_inflight_windows=3 vary with timing: the replay still
    sends the recorded messages, and a second run is clean."""
    from qtpu_torch.bench import measure_party
    cfg = PipelineConfig(n=1024, blocks_per_window=4, qber_test_bits=512,
                         max_inflight_windows=3)
    runs = [measure_party("bob", windows=4, warmup_windows=2, config=cfg,
                          device=dev, chunk_bits=1 << 14) for _ in range(2)]
    assert all(r["windows"] >= 4 for r in runs)
    assert runs[1]["trace_growth"] == 0


@pytest.fixture(scope="module")
def sift_frames():
    """Two windows of detector events padded to one capacity."""
    src = EntangledPairSource(pair_rate_hz=1e6, window_s=0.05,
                              offset_ns=4_321.0, error_rate=0.025,
                              dark_rate_hz=20_000)
    rng = np.random.default_rng(21)
    evs = [src.generate(rng, start_epoch=w) for w in range(2)]
    na = max(e.alice.count for e in evs)
    nb = max(e.bob.count for e in evs)
    arrs = [np.full((2, na), sift.DEVICE_PAD, np.int32),
            np.zeros((2, na), np.uint8),
            np.full((2, nb), sift.DEVICE_PAD, np.int32),
            np.zeros((2, nb), np.uint8), np.zeros((2, nb), np.uint8)]
    for i, e in enumerate(evs):
        da = e.alice.detectors[:e.alice.count].astype(np.int32)
        db = e.bob.detectors[:e.bob.count].astype(np.int32)
        arrs[0][i, :e.alice.count] = sift.rebase_times(
            e.alice.times[:e.alice.count], 0)
        arrs[1][i, :e.alice.count] = da >> 1
        arrs[2][i, :e.bob.count] = sift.rebase_times(
            e.bob.times[:e.bob.count], 0)
        arrs[3][i, :e.bob.count] = db >> 1
        arrs[4][i, :e.bob.count] = db & 1
    return arrs, evs[0].true_offset_units


def test_sift_on_card_matches_cpu(dev, sift_frames):
    arrs, true = sift_frames
    cpu = [torch.from_numpy(a) for a in arrs]
    gpu = [a.to(dev) for a in cpu]
    span = int(0.05 * 8e9)
    off_c = sift.pfind(cpu[0][0], cpu[2][0], span, num_bins=1 << 18)
    off_g = sift.pfind(gpu[0][0], gpu[2][0], span, num_bins=1 << 18)
    assert int(off_g) == int(off_c) and abs(int(off_c) - true) < 50
    r_c = sift.make_frame_matcher(2, 40)(*cpu, int(off_c))
    r_g = sift.make_frame_matcher(2, 40)(*gpu, int(off_c))
    for f in ("sift_mask", "bob_bits", "matched_counts", "sifted_counts",
              "final_offset"):
        assert torch.equal(getattr(r_g, f).cpu(), getattr(r_c, f)), f
    np.testing.assert_allclose(r_g.residuals.cpu().numpy(),
                               r_c.residuals.numpy(), rtol=1e-5)
    out_c = sift.sift_outputs(r_c.sift_mask, r_c.bob_bits)
    out_g = sift.sift_outputs(r_g.sift_mask, r_g.bob_bits)
    assert torch.equal(out_g[0].cpu(), out_c[0])
    assert torch.equal(out_g[1].cpu(), out_c[1])
    total = int(out_c[1].sum())
    assert total > 10_000
    assert torch.equal(out_g[2][:total].cpu(), out_c[2][:total])
    k = int(out_c[1][0])
    raw = cpu[1][0]
    assert torch.equal(sift.splice(raw.to(dev), out_g[0][0, :k]).cpu(),
                       sift.splice(raw, out_c[0][0, :k]))


def test_stream_toeplitz_card_matches_golden(dev):
    from qtpu_torch import pa
    rng = np.random.default_rng(0)
    N, m = 2048, 300
    x = rng.integers(0, 2, N).astype(np.uint8)
    t = rng.integers(0, 2, m + N - 1).astype(np.uint8)
    want = pa.toeplitz_hash_golden(t, x, m)
    for precision in (torch.float32, torch.float64):
        got = pa.stream_toeplitz(torch.from_numpy(t).to(dev),
                                 torch.from_numpy(x).to(dev), m, segment=512,
                                 precision=precision)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_stream_pa_session_card_matches_cpu(dev):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, 60_000).astype(np.uint8)
    b = a ^ (rng.random(60_000) < 0.02).astype(np.uint8)
    cfg = PipelineConfig(n=1024, blocks_per_window=8, qber_test_bits=512,
                         pa_mode="stream", pa_stream_windows=2,
                         max_inflight_windows=1)
    ca, cb = run_loopback(cfg, a, b, device="cpu")
    ga, gb = run_loopback(cfg, a, b, device=dev)
    key = cb.final_key_bits()
    assert key.size > 0 and cb.ledger.final_bits == key.size
    for s in (ca, ga, gb):
        np.testing.assert_array_equal(s.final_key_bits(), key)
    assert ga.ledger.as_dict() == cb.ledger.as_dict()


def test_measure_fer_card_matches_cpu(dev):
    from qtpu_torch.ldpc.calibrate import measure_fer
    step = make_rate_ladder(4096, family="mixed", alg="minsum").steps[1]
    before = cuda_bp.launches["bp_flooding"]
    got = measure_fer(step, 0.05, blocks=64, seed=2, device=dev)
    assert cuda_bp.launches["bp_flooding"] == before + 1
    assert got == measure_fer(step, 0.05, blocks=64, seed=2, device="cpu")


def test_baseline_config2_on_card_matches_plain(dev):
    """BASELINE config 2 at its full width (B = 1024, n = 4096, 60
    iterations, QBER 1-5%): every row from the layered kernel equals the
    plain decoder's on the same inputs on the card, per block."""
    from qtpu_torch import baseline
    out = baseline.config2(dev)
    assert out["batch"] == 1024
    code = make_regular_code(4096)
    kern = cuda_bp.make_cuda_decoder(code, baseline.CONFIG2_ITERS)
    plain = make_layered_decoder(code, baseline.CONFIG2_ITERS)
    for row, (q, llr, syn) in zip(out["sweep"],
                                  baseline.config2_inputs(code, 1024, dev)):
        ref = plain(llr, syn)
        _same(kern(llr, syn), ref)
        iters = ref.iterations.cpu().numpy()
        assert row["qber"] == q
        assert row["fer"] == 1.0 - float(ref.converged.cpu().numpy().mean())
        assert row["iters_mean"] == round(float(iters.mean()), 2)
        assert row["iters_p99"] == int(np.percentile(iters, 99))
        assert row["iters_sum"] == int(iters.sum())
        assert row["launches"] == {"bp_layered": 21, "bp_flooding": 0}


def test_baseline_config3_on_card_matches_plain(dev):
    """BASELINE config 3 on the card (the flooding kernel, every rung of
    the n = 4096 mixed ladder): the first and the last rung equal
    ``measure_fer`` on the CPU (the plain decoder) on the same seed."""
    from qtpu_torch import baseline
    from qtpu_torch.ldpc.calibrate import measure_fer
    out = baseline.config3(dev)
    ladder = make_rate_ladder(4096)
    assert [r["rung"] for r in out["rungs"]] == [s.name for s in ladder.steps]
    for idx in (0, len(ladder.steps) - 1):
        row = out["rungs"][idx]
        fer, iters = measure_fer(ladder.steps[idx], row["qber"], blocks=256,
                                 seed=idx, device="cpu")
        assert (row["fer"], row["iters_mean"]) == (round(fer, 4),
                                                   round(iters, 1))
        assert row["launches"] == {"bp_layered": 0, "bp_flooding": 1}


# -- the mesh: shards of one card, shards on several cards, NCCL processes --

def _cards(k):
    """The first k cards, or a skip when the machine has fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} CUDA devices")
    return [torch.device("cuda", i) for i in range(k)]


@pytest.mark.parametrize("alg", ["layered", "minsum"])
def test_sharded_decoder_on_card_matches_one_launch(dev, alg):
    from qtpu_torch.parallel import make_mesh, make_sharded_decoder
    code = make_rate_ladder(4096, family="mixed", alg=alg).steps[1].code
    llr, syn = _inputs(code, np.linspace(0.005, 0.06, 32), 5, dev)
    mesh = make_mesh(devices=[dev] * 4)
    before = cuda_bp.launches[cuda_bp.KERNELS[alg]]
    got = make_sharded_decoder(code, mesh, 40, alg)(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches[cuda_bp.KERNELS[alg]] == before + 4
    _same(got, cuda_bp.make_cuda_decoder(code, 40, alg=alg)(llr, syn))


def test_mesh_shards_run_on_streams_of_their_own(dev):
    """A 4-shard mesh of one card runs each shard on a stream of its own
    (4 distinct streams, none the caller's); a CPU mesh makes none."""
    from qtpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=[dev] * 4)
    seen = mesh.run_shards(lambda g, d: torch.cuda.current_stream(d))
    ids = [s.cuda_stream for s in seen]
    assert len(set(ids)) == 4
    assert torch.cuda.current_stream(dev).cuda_stream not in ids
    assert ids == [mesh.stream(g).cuda_stream for g in range(4)]
    assert ids == [s.cuda_stream for s in mesh.run_shards(
        lambda g, d: torch.cuda.current_stream(d))]
    cpu = make_mesh(devices=["cpu"] * 4)
    assert cpu.run_shards(lambda g, d: g) == [0, 1, 2, 3]
    assert all(cpu.stream(g) is None for g in range(4)) and not cpu._streams


def _bob_windows(dev, sets, B=64):
    """Bob's program at B blocks of a regular n = 4096 code on a 4-shard
    mesh of ``dev``, on a 1-shard mesh and unsharded, with ``sets`` windows
    of its inputs (QBER 2-8%, Alice's outputs from the unsharded alice
    program) over one arena."""
    from qtpu_torch import prng
    from qtpu_torch.parallel import make_mesh
    from qtpu_torch.stream import DeviceStream
    from qtpu_torch.window_programs import (choose_affine, make_header,
                                            make_window_programs)
    code = make_regular_code(4096)
    pay, empty = np.arange(code.n, dtype=np.int64), np.zeros(0, np.int64)
    progs = [make_window_programs(
        code, pay, empty, empty, 40, "layered", 64, 128, batch=B, k_pb=8,
        s_max=32, device=dev, mesh=m)
        for m in (make_mesh(devices=[dev] * 4), make_mesh(devices=[dev]),
                  None)]
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2, (sets, B * code.n), dtype=np.uint8)
    qber = np.linspace(0.02, 0.08, sets)[:, None]
    noisy = keys ^ (rng.random(keys.shape) < qber).astype(np.uint8)
    sa, sb = DeviceStream(keys.size, device=dev), DeviceStream(
        keys.size, device=dev)
    sa.push(keys.reshape(-1))
    sb.push(noisy.reshape(-1))
    a, ainv = choose_affine(iter([7]), code.n)
    inputs = []
    for w in range(sets):
        wkey = prng.key_data(prng.derive(prng.root_key(3), "win", w))
        pkey = prng.key_data(prng.derive(prng.root_key(7), "punct", w))
        hdr = dict(test_bits_pb=8, affine=(a, ainv, 3))
        _, syn, hashes, test, short = progs[2].alice(
            sa.arena, make_header(w * B * code.n, 0, wkey, pkey, **hdr))
        inputs.append((make_header(w * B * code.n, 0, wkey, **hdr),
                       (test, short, syn, hashes)))
    return progs, sb.arena, inputs


@pytest.mark.parametrize("what", ["layered", "minsum", "bob_program"])
def test_mesh_on_card_race_probe(dev, what):
    """50 calls back to back of the 4-shard sharded decoder (or mesh bob
    program) on one card, each on inputs reallocated for the call (and the
    freed inputs' memory written over on the caller's stream at once), ==
    the unsharded call on the same inputs: the shard streams' joins and
    the allocator's reuse across streams must never let a call read or
    return another's memory.  The bob program's psum'd ledger == a
    1-shard mesh's."""
    from qtpu_torch.parallel import make_mesh, make_sharded_decoder
    torch.backends.cuda.matmul.allow_tf32 = False
    sets = 4
    if what == "bob_program":
        progs, arena, inputs = _bob_windows(dev, sets)
        qmag = np.float32(np.log(0.98 / 0.02))
        want = [progs[2].bob(arena, h, *x, qmag) for h, x in inputs]
        want_gled = [progs[1].bob(arena, h, *x, qmag)[5] for h, x in inputs]

        def call(i):
            h, x = inputs[i % sets]
            fresh = [t.clone() for t in x]
            out = progs[0].bob(arena, h, *fresh, qmag)
            del fresh
            _scribble = [torch.full_like(t, 1) for t in x]
            return out
    else:
        code = make_rate_ladder(4096, family="mixed", alg=what).steps[1].code
        inputs = [_inputs(code, np.linspace(0.005, 0.06 + 0.01 * i, 32), i,
                          dev) for i in range(sets)]
        single = cuda_bp.make_cuda_decoder(code, 40, alg=what)
        want = [single(*x) for x in inputs]
        sharded = make_sharded_decoder(code, make_mesh(devices=[dev] * 4),
                                       40, what)

        def call(i):
            fresh = [t.clone() for t in inputs[i % sets]]
            out = sharded(*fresh)
            del fresh
            _scribble = [torch.full_like(t, 1) for t in inputs[i % sets]]
            return out
    got = [call(i) for i in range(50)]
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        ref = want[i % sets]
        if what == "bob_program":
            for a, b in zip(out[:5], ref):
                assert torch.equal(a, b.to(a.dtype)), f"call {i}"
            assert torch.equal(out[5], want_gled[i % sets]), f"call {i}"
        else:
            _same(out, ref)


def _mesh_cfg(**kw):
    return PipelineConfig(n=1024, blocks_per_window=8, qber_test_bits=512,
                          max_inflight_windows=1, **kw)


def _mesh_session(cfg, mesh, device):
    from qtpu_torch.link import make_direct_pair
    from qtpu_torch.pipeline import AliceSession, BobSession, pump_sessions
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, 80_000, dtype=np.uint8)
    b = a ^ (rng.random(80_000) < 0.03).astype(np.uint8)
    la, lb = make_direct_pair()
    alice = AliceSession(cfg, 0x5E55, la, device=device)
    bob = BobSession(cfg, 0x5E55, lb, mesh=mesh, device=device)
    alice.push_sifted(a)
    bob.push_sifted(b)
    pump_sessions(alice, bob, la, lb)
    return alice, bob


@pytest.mark.parametrize("pa_mode", ["per_block", "stream"])
def test_mesh_session_on_card_matches_cpu(dev, pa_mode):
    """Bob on 4 shards of the card == Bob on 4 CPU shards (keys, ledgers,
    metrics, psum'd ledgers), every shard a kernel launch."""
    from qtpu_torch.parallel import make_mesh
    cfg = _mesh_cfg(pa_mode=pa_mode, pa_stream_windows=2)
    ca, cb = _mesh_session(cfg, make_mesh(devices=["cpu"] * 4), "cpu")
    before = cuda_bp.launches["bp_layered"]
    ga, gb = _mesh_session(cfg, make_mesh(devices=[dev] * 4), dev)
    key = cb.final_key_bits()
    assert key.size > 0
    for s in (ca, ga, gb):
        np.testing.assert_array_equal(s.final_key_bits(), key)
    assert gb.ledger.as_dict() == cb.ledger.as_dict() == ga.ledger.as_dict()
    assert [m.as_dict() for m in gb.metrics] == [m.as_dict()
                                                for m in cb.metrics]
    assert sorted(gb.gled_by_window) == sorted(cb.gled_by_window)
    for w, g in cb.gled_by_window.items():
        np.testing.assert_array_equal(gb.gled_by_window[w], g)
    assert cuda_bp.launches["bp_layered"] - before >= 4 * len(gb.metrics)


def test_mesh_across_cards_matches_one_card():
    """Shards on cards 0..k-1 of one process: the sharded decoder, the
    sharded stream hash and a mesh session equal the same mesh on one
    card (per-device kernel tables, launches on each shard's card)."""
    from qtpu_torch import pa
    from qtpu_torch.parallel import make_mesh, make_sharded_decoder, \
        make_stream_pa
    cards = _cards(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    k = len(cards)
    spread = make_mesh(devices=cards)
    stacked = make_mesh(devices=[cards[0]] * k)
    code = make_rate_ladder(4096, family="mixed", alg="layered").steps[1].code
    llr, syn = _inputs(code, np.linspace(0.005, 0.06, 8 * k), 6, cards[0])
    for alg in ("layered", "minsum"):
        got = make_sharded_decoder(code, spread, 40, alg)(llr, syn)
        _same(got, make_sharded_decoder(code, stacked, 40, alg)(llr, syn))
        assert got.bits.device == cards[0]
    rng = np.random.default_rng(7)
    m, N = 300, 512 * k
    x = rng.integers(0, 2, N).astype(np.uint8)
    t = rng.integers(0, 2, m + N - 1).astype(np.uint8)
    got = make_stream_pa(spread, N, m)(torch.from_numpy(t).to(cards[0]),
                                       torch.from_numpy(x).to(cards[0]))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  pa.toeplitz_hash_golden(t, x, m))
    cfg = _mesh_cfg()
    sa, sb = _mesh_session(cfg, spread, cards[0])
    oa, ob = _mesh_session(cfg, stacked, cards[0])
    np.testing.assert_array_equal(sb.final_key_bits(), ob.final_key_bits())
    assert sb.ledger.as_dict() == ob.ledger.as_dict() == sa.ledger.as_dict()


def _mesh_window(mesh, device):
    """One window of Bob's layered program (n = 1024, B = 16) on ``mesh``
    from a numpy seed: (psum'd ledger, this process's stats rows)."""
    from qtpu_torch import prng
    from qtpu_torch.window_programs import (choose_affine, make_header,
                                            make_window_programs)
    code = make_regular_code(1024)
    B = 16
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2, B * code.n, dtype=np.uint8)
    bob = keys ^ (rng.random(B * code.n) < 0.03).astype(np.uint8)
    pay, empty = np.arange(code.n, dtype=np.int64), np.zeros(0, np.int64)
    kw = dict(max_iters=40, alg="layered", verify_hash_bits=64, l_max=128,
              batch=B, k_pb=8, s_max=32, device=device)
    wkey = prng.key_data(prng.derive(prng.root_key(3), "win", 0))
    pkey = prng.key_data(prng.derive(prng.root_key(7), "punct", 0))
    a, ainv = choose_affine(iter([7]), code.n)
    hdr = dict(test_bits_pb=8, affine=(a, ainv, 3))
    one = make_window_programs(code, pay, empty, empty, **kw)
    _, syn, hashes, test, short = one.alice(
        torch.from_numpy(keys).to(device), make_header(0, 0, wkey, pkey, **hdr))
    out = make_window_programs(code, pay, empty, empty, mesh=mesh, **kw).bob(
        torch.from_numpy(bob).to(device), make_header(0, 0, wkey, **hdr),
        test, short, syn, hashes, np.float32(np.log(0.97 / 0.03)))
    return out[5].cpu().tolist(), out[4].cpu().tolist()


def _mesh_process(rank, world, port, backend, out):
    """One process of a ``world``-process mesh, one shard each: on card
    ``rank`` for NCCL, on the CPU for gloo."""
    from qtpu_torch.parallel import init_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            backend=backend) == backend
    try:
        device = (torch.device("cuda", rank) if backend == "nccl"
                  else torch.device("cpu"))
        mesh = make_mesh(devices=[device])
        assert (mesh.first, mesh.size) == (rank, world)
        out.put((rank, *_mesh_window(mesh, device)))
    finally:
        torch.distributed.destroy_process_group()


def run_mesh_processes(world, backend, timeout=180):
    """Spawn ``world`` ``_mesh_process``es on a free port; {rank: (gled,
    stats rows)}."""
    import queue
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_mesh_process,
                         args=(r, world, port, backend, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, gled, stats = out.get(timeout=timeout)
            except queue.Empty:
                pytest.fail(f"{sorted(got)} of {world} ranks answered")
            got[rank] = (gled, stats)
        for p in procs:
            p.join(timeout=60)
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got


def test_nccl_processes_across_cards():
    """One process per card over NCCL, one shard each: every rank's psum'd
    ledger and stats rows equal the one-process mesh's on card 0."""
    from qtpu_torch.parallel import make_mesh
    cards = _cards(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = len(cards)
    got = run_mesh_processes(world, "nccl")
    gled, stats = _mesh_window(make_mesh(devices=[cards[0]] * world),
                               cards[0])
    bl = len(stats) // world
    for rank, (g, st) in got.items():
        assert g == gled
        assert st == stats[rank * bl:(rank + 1) * bl]
