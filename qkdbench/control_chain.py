"""The controls of the events cell's sifting check, run on the card: the
program's matcher broken in one of two ways, so the check's numbers can
be read for it on the cell's own sizes and load.

    python3 -m qkdbench.control_chain --workload chain65k-pairs1e7 \\
        --seeds <a,b,...> --seconds <s> [--parts residual,rank]

runs the cell once a seed in this one process, each run as
``qkdbench.run`` runs it (its result line, the check's numbers under
``checks``), with:

- ``residual``: the servo's residual, the mean of the matched pairs' time
  differences (``qtpu_torch.sift._int_mean``), taken in bfloat16, the
  nearest precision below the configuration's float32;
- ``rank``: the one-to-one rule's claimants of a Bob event ranked by
  their Alice index alone, not by (distance, index)
  (``qtpu_torch.sift.coincidence_match`` replaced).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from unittest import mock

__all__ = ["int_mean_bf16", "match_by_index", "PARTS", "main"]


def int_mean_bf16(values, mask, count):
    """The masked integers' mean with the sum and the count rounded to
    bfloat16 and divided there (the program: an exact int64 sum divided in
    float32)."""
    import torch
    total = torch.where(mask, values, 0).sum(dtype=torch.int64)
    return (total.to(torch.bfloat16) / count.to(torch.bfloat16)).to(
        torch.float32)


def match_by_index(times_a, basis_a, times_b, basis_b, bits_b, offset,
                   window):
    """``coincidence_match`` with the claimants of a Bob event ranked by
    their Alice index alone."""
    import torch
    from qtpu_torch.sift import DEVICE_PAD, SiftResult, _int_mean
    pad = int(DEVICE_PAD)
    ta = times_a + offset
    nb = times_b.shape[0]
    pos = torch.searchsorted(times_b, ta, side="left")
    right = pos.clamp(0, nb - 1)
    left = (pos - 1).clamp(0, nb - 1)
    d_right = (times_b[right] - ta).abs()
    d_left = (times_b[left] - ta).abs()
    take_left = d_left <= d_right
    best = torch.where(take_left, left, right)
    dist = torch.where(take_left, d_left, d_right)
    matched = (dist <= window) & (times_a < pad) & (times_b[best] < pad)
    idx = torch.arange(times_a.shape[0], dtype=torch.int64,
                       device=times_a.device)
    big = torch.iinfo(torch.int64).max
    key = torch.where(matched, idx, big)
    win = torch.full((nb,), big, dtype=torch.int64,
                     device=times_a.device).scatter_reduce(
        0, best, key, reduce="amin", include_self=True)
    matched = matched & (key == win[best])
    residual = _int_mean(times_b[best] - ta, matched,
                         matched.sum().clamp(min=1))
    return SiftResult(matched=matched, bob_index=best.to(torch.int32),
                      basis_ok=basis_a == basis_b[best],
                      bob_bits=bits_b[best].to(torch.uint8),
                      residual=residual, offset_used=offset)


PARTS = {"residual": ("qtpu_torch.sift._int_mean", int_mean_bf16),
         "rank": ("qtpu_torch.sift.coincidence_match", match_by_index)}


def main(argv=None) -> int:
    from qkdbench import run
    p = argparse.ArgumentParser(prog="qkdbench.control_chain")
    p.add_argument("--workload", default="chain65k-pairs1e7")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--parts", default="residual,rank")
    args = p.parse_args(argv)
    rc = 0
    for seed in args.seeds.split(","):
        with contextlib.ExitStack() as stack:
            for part in args.parts.split(","):
                stack.enter_context(mock.patch(*PARTS[part]))
            rc |= run.main(["--workload", args.workload, "--seed", seed,
                            "--seconds", str(args.seconds), "--trace", "0"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
