"""qtpu_torch — the qtpu QKD post-processing pipeline in PyTorch and CUDA.

The port of ``qtpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for an NVIDIA H100.  It mirrors ``qtpu``'s module names so each
module's counterpart is easy to find, imports ``torch`` and never ``jax``,
and takes a ``device`` wherever it allocates: its entry points run on
``"cuda"`` unless the caller asks for the CPU (``qtpu_torch.devices``).  ``qtpu`` stays the
reference: on identical input the port gives the same syndromes, decoded
bits, hashes, final keys and ledgers.

Ported so far: the entry point ``python -m qtpu_torch.cli`` (``demo``, the
TCP parties ``alice``/``bob``, ``fer``, ``calibrate``, ``cascade``; takes
``--device``), the events -> key chain (``chain``: simulated detector
events from ``channel``, sifting in ``sift``) and the two-party per-window
reconciliation session (``pipeline``, per-block and stream privacy
amplification) with everything it runs: the protocol and tooling modules
(``framing``, ``prng``, ``messages``, ``link``, ``qber``, ``accounting``,
``channel``, ``auth``, ``keystore``, ``config``, ``ldpc.codes``,
``ldpc.designed``, ``ldpc.cascade`` and the calibration tables — numpy
copies of the reference's, since the machine with the card has no JAX),
``metrics`` (torch.profiler traces), the native C++ runtime (``runtime``:
TCP transport and event codec, built with ``c++`` at first use), the
threefry protocol PRNG (``random``), the device stream (``stream``), the
Toeplitz hashes (``pa``, torch.fft), the window programs
(``window_programs``), the FER measuring tools (``ldpc.calibrate``), the
syndrome encoder (``ldpc.encode``) and the layered and flooding min-sum
decoders: plain PyTorch (``ldpc.decode``) and the Hopper kernels
(``ldpc.cuda_bp`` + ``csrc/bp_layered.cu``, ``csrc/bp_flooding.cu``).
"""

__version__ = "0.1.0"

from qtpu_torch.pipeline import (PipelineConfig, AliceSession,  # noqa: F401
                                 BobSession, production_config,
                                 run_loopback, pump_sessions)
from qtpu_torch.ldpc import QCCode, make_rate_ladder  # noqa: F401
