"""qtpu_torch on the card: both BP kernels, sessions and sifting on CUDA.

Marked ``cuda``; every test skips without a CUDA device.  On a machine with
a card (which has no JAX, so the JAX import of tests/conftest.py must be
switched off):

    QTPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact — each kernel against its plain PyTorch decoder (bits,
iterations, converged; the layered kernel at every native3 rung of
n = 65536, hence at every cluster size the production ladder uses), a
session on the card against the same session on
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
from qtpu_torch.ldpc.encode import make_batch_encoder
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
