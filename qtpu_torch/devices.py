"""Where the port's entry points run: on the card unless the caller asks
for the CPU.

Sessions, chains, loopback runs and the FER tools take ``device`` with the
default ``"cuda"``.  Without a card that default fails here, with a message
that names the way out, and never carries on on the CPU.  The command-line
entry points (``bench``, ``baseline``, ``profiling``) get onto their device
through ``entry_device`` and name it with ``device_name``.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "entry_device",
           "device_name"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; raises RuntimeError when it is a CUDA
    device and CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available "
                           f"(pass device='cpu' to run on the CPU)")
    return dev


def entry_device(prog: str, device=DEFAULT_DEVICE) -> torch.device:
    """``resolve_device`` for the command ``prog``: exits with a message
    naming ``--device cpu`` when CUDA is not available, and turns TF32 off
    on a card (the verify hash is an exact float32 product)."""
    try:
        dev = resolve_device(device)
    except RuntimeError:
        raise SystemExit(f"{prog}: --device {device}: CUDA is not available "
                         f"(pass --device cpu to run on the CPU)")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]
