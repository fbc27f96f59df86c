"""The controls of the correctness check, run on the card: the plain
reference put in the program's place in the nearest precision below the
configuration's float32 (bfloat16), so the check's numbers can be read for
it on the cell's own sizes and load.

    python3 -m qkdbench.control --workload <cell> --seeds <a,b,...> \\
        --seconds <s> [--parts pa,decoder]

runs the cell once a seed in this one process, each run as ``qkdbench.run``
runs it (its result line, the check's numbers under ``checks``), with:

- in the session cell, the PA hash (``qtpu_torch.window_programs``'s
  ``_toeplitz_hash``) replaced by the reference's Toeplitz product with
  both spectra and their product held in bfloat16, and the window
  programs' decoder by the reference's layered min-sum with bfloat16
  messages and totals;
- in the decode cell, the decoder replaced by that bfloat16 min-sum.

``--parts`` puts only the named parts in the program's place (the
session cell's ``pa`` and ``decoder``; the decode cell's ``decoder``).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from unittest import mock

__all__ = ["toeplitz_bf16", "decoder_bf16", "main"]


def toeplitz_bf16(t, x, m, *_, **__):
    """(b, m) uint8: the GF(2) Toeplitz product of ``reference.keys.
    toeplitz`` with its spectra and their product rounded to bfloat16, on
    the inputs' device."""
    import torch
    n = x.shape[-1]
    L = 1 << (m + n - 2).bit_length()

    def rnd(c):
        return torch.complex(c.real.to(torch.bfloat16).to(torch.float64),
                             c.imag.to(torch.bfloat16).to(torch.float64))
    tf = torch.fft.rfft(t.to(torch.float64), L, dim=-1)
    xf = torch.fft.rfft(x.to(torch.float64), L, dim=-1)
    conv = torch.fft.irfft(rnd(rnd(tf) * rnd(xf)), L, dim=-1)
    return (torch.round(conv[..., n - 1:n - 1 + m]).to(torch.int64)
            & 1).to(torch.uint8)


def decoder_bf16(code, max_iters, alg="layered", alpha=0.8125):
    """A decoder with ``make_batch_decoder``'s signature: the reference's
    layered min-sum in bfloat16."""
    from qtpu_torch.ldpc.decode import BatchDecodeResult

    from qkdbench.reference.codes import RegularCode
    from qkdbench.reference.minsum import layered_decode
    rc = RegularCode(code.z, code.mb, code.nb, code.edge_row, code.edge_col,
                     code.edge_shift, code.row_edges)

    def decode(llr, syndrome):
        import torch
        return BatchDecodeResult(*layered_decode(
            rc, llr, syndrome, max_iters, alpha, dtype=torch.bfloat16))
    return decode


def main(argv=None) -> int:
    from qkdbench import registry, run
    p = argparse.ArgumentParser(prog="qkdbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--parts", default="pa,decoder")
    args = p.parse_args(argv)
    driver = registry.cell("BENCHMARK.json", args.workload).workload[
        "driver"]
    targets = {"session": {"pa": ("qtpu_torch.window_programs."
                                  "_toeplitz_hash", toeplitz_bf16),
                           "decoder": ("qtpu_torch.window_programs."
                                       "make_batch_decoder", decoder_bf16)},
               "decode": {"decoder": ("qtpu_torch.ldpc.decode."
                                      "make_batch_decoder", decoder_bf16)}}[
        driver]
    targets = [targets[part] for part in args.parts.split(",")
               if part in targets]
    rc = 0
    for seed in args.seeds.split(","):
        with contextlib.ExitStack() as stack:
            for target, control in targets:
                stack.enter_context(mock.patch(target, control))
            rc |= run.main(["--workload", args.workload, "--seed", seed,
                            "--seconds", str(args.seconds), "--trace", "0"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
