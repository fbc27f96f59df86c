"""The port's entry points run on the card unless the caller asks for the
CPU.

Without a card every entry point that takes ``device`` fails on its default
with a message that names ``device='cpu'``, and never carries on on the
CPU.  Whether a card is present is decided inside the test: with one, the
default runs there and the test skips.
"""

import numpy as np
import pytest
import torch

import qtpu_torch.chain as tchain
import qtpu_torch.pipeline as tpipe
from qtpu_torch.devices import DEFAULT_DEVICE, resolve_device
from qtpu_torch.ldpc import calibrate
from qtpu_torch.ldpc.codes import make_rate_ladder
from qtpu_torch.link import make_direct_pair


def _cfg():
    return tpipe.PipelineConfig(n=1024, blocks_per_window=4,
                                qber_test_bits=512)


def _ladder():
    return make_rate_ladder(1024, family="mixed", alg="minsum")


_BITS = np.zeros(8192, np.uint8)

ENTRY_POINTS = {
    "AliceSession": lambda: tpipe.AliceSession(_cfg(), 1,
                                               make_direct_pair()[0]),
    "BobSession": lambda: tpipe.BobSession(_cfg(), 1, make_direct_pair()[1]),
    "run_loopback": lambda: tpipe.run_loopback(_cfg(), _BITS, _BITS),
    "AliceChain": lambda: tchain.AliceChain(
        tchain.ChainConfig(pipeline=_cfg()), 1, make_direct_pair()[0]),
    "BobChain": lambda: tchain.BobChain(
        tchain.ChainConfig(pipeline=_cfg()), 1, make_direct_pair()[1]),
    "run_chain_loopback": lambda: tchain.run_chain_loopback(
        tchain.ChainConfig(pipeline=_cfg()), num_windows=1),
    "measure_fer": lambda: calibrate.measure_fer(_ladder().steps[0], 0.03,
                                                 blocks=4),
    "calibrate_ladder": lambda: calibrate.calibrate_ladder(
        _ladder(), blocks=4, qber_grid=[0.03]),
    "ceiling_bisect": lambda: calibrate.ceiling_bisect(
        _ladder().steps[0], 0.01, 0.05, blocks=4),
    "calibrate_short": lambda: calibrate.calibrate_short(
        _ladder(), fracs=(0.0,), blocks=4, qber_grid=[0.03]),
}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA is not available.*cpu"):
        ENTRY_POINTS[entry]()


def test_resolve_device():
    assert DEFAULT_DEVICE == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("meta")).type == "meta"
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
