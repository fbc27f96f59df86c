"""Where the port's entry points run: on the card unless the caller asks
for the CPU.

Sessions, chains, loopback runs and the FER tools take ``device`` with the
default ``"cuda"``.  Without a card that default fails here, with a message
that names the way out, and never carries on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; raises RuntimeError when it is a CUDA
    device and CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available "
                           f"(pass device='cpu' to run on the CPU)")
    return dev
