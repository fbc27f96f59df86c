"""Batched LDPC syndrome encoding in PyTorch.

Counterpart of ``qtpu/ldpc/encode.py``: with a quasi-cyclic code the sparse
GF(2) mat-vec ``syndrome = H · bits`` is a static sequence of circulant
rolls and XORs, one per base edge, in the natural ``(B, nb, z)`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.ldpc.codes import QCCode

__all__ = ["make_batch_encoder", "encode_syndrome_batch"]


def make_batch_encoder(code: QCCode):
    """Build a ``(B, n) uint8 -> (B, m) uint8`` syndrome encoder."""
    edge_row = [int(x) for x in code.edge_row]
    edge_col = [int(x) for x in code.edge_col]
    edge_shift = [int(x) for x in code.edge_shift]
    mb, nb, z = code.mb, code.nb, code.z

    def encode(bits: torch.Tensor) -> torch.Tensor:
        b = bits.shape[0]
        x = bits.to(torch.uint8).reshape(b, nb, z)
        syn = [None] * mb
        for e in range(len(edge_row)):
            i, j, s = edge_row[e], edge_col[e], edge_shift[e]
            # Check (i, zc) touches variable (j, (zc + s) % z).
            contrib = torch.roll(x[:, j], -s, dims=1)
            syn[i] = contrib if syn[i] is None else syn[i] ^ contrib
        return torch.stack(syn, dim=1).reshape(b, mb * z)

    return encode


def encode_syndrome_batch(code: QCCode, bits: np.ndarray) -> np.ndarray:
    """Convenience eager wrapper (tests): (B, n) numpy bits -> (B, m) uint8
    syndromes, encoded on the CPU."""
    return make_batch_encoder(code)(torch.from_numpy(np.asarray(bits))).numpy()
