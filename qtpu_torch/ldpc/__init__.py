"""LDPC reconciliation core: QC codes and the rate ladder, the syndrome
encoder, and the layered and flooding min-sum decoders (plain PyTorch and
the Hopper kernels)."""

from qtpu_torch.ldpc.codes import (QCCode, RateLadder,  # noqa: F401
                                   code_from_reference, make_rate_ladder)
