"""qtpu_torch on the card: the layered-BP kernel and the session on CUDA.

Marked ``cuda``; every test skips without a CUDA device.  On a machine with
a card (which has no JAX, so the JAX import of tests/conftest.py must be
switched off):

    QTPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact — the kernel against the plain PyTorch decoder (bits,
iterations, converged), and a session on the card against the same session
on the CPU (final keys, ledgers, per-window metrics).
"""

import numpy as np
import pytest
import torch

from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import make_rate_ladder, make_regular_code
from qtpu_torch.ldpc.decode import channel_llr, make_layered_decoder
from qtpu_torch.ldpc.encode import make_batch_encoder
from qtpu_torch.pipeline import PipelineConfig, run_loopback

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(code, qbers, seed, dev):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2, (len(qbers), code.n), dtype=np.uint8)
    noise = rng.random((len(qbers), code.n)) < np.asarray(qbers)[:, None]
    keys = torch.from_numpy(keys).to(dev)
    llr = channel_llr(keys ^ torch.from_numpy(noise).to(dev), 0.03)
    return llr, make_batch_encoder(code)(keys)


@pytest.mark.parametrize("which", ["regular1024", "native3_2048"])
def test_kernel_matches_plain(dev, which):
    if which == "regular1024":
        code, qbers = make_regular_code(1024), np.linspace(0.005, 0.06, 8)
    else:
        code = make_rate_ladder(2048, family="native3",
                                alg="layered").steps[-1].code
        qbers = np.linspace(0.001, 0.03, 16)
    llr, syn = _inputs(code, qbers, 1, dev)
    before = cuda_bp.launches
    got = cuda_bp.make_cuda_decoder(code, 40)(llr, syn)
    torch.cuda.synchronize()
    assert cuda_bp.launches == before + 1
    ref = make_layered_decoder(code, 40)(llr, syn)
    assert torch.equal(got.bits, ref.bits)
    assert torch.equal(got.iterations, ref.iterations)
    assert torch.equal(got.converged, ref.converged)


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


def test_session_on_card_matches_cpu(dev):
    cfg = PipelineConfig(n=1024, blocks_per_window=4, qber_test_bits=512,
                         max_inflight_windows=1)
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
