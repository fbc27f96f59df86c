"""Batched row-layered min-sum decoding in plain PyTorch.

Counterpart of ``qtpu/ldpc/decode.py``: the result type, the channel LLR,
and the layered decoder ``_make_layered_decoder`` (``decode.py:217-306``)
op for op — same float32 operation order, so bits, iteration counts and
converged flags equal the reference's (and ``qtpu.ldpc.golden``'s) exactly.

This is the plain version beside the Hopper kernel
(``qtpu_torch.ldpc.cuda_bp``): the CPU path of the pipeline runs it, the
tests hold it to the JAX decoders, and ``chip_smoke.py`` holds the kernel to
it on the card.  Layout is the natural ``(B, nb, z)``: each base column or
edge is a ``(B, z)`` slice and a circulant permutation is ``torch.roll``
along z.  Flooding min-sum and sum-product are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qtpu_torch.ldpc.codes import QCCode

__all__ = ["make_layered_decoder", "BatchDecodeResult", "channel_llr",
           "BIG_LLR"]

BIG_LLR = 1e9  # shortened-bit prior magnitude (matches golden.BIG_LLR)


def channel_llr(bits: torch.Tensor, qber) -> torch.Tensor:
    """BSC LLRs log(P(0)/P(1)) for observed bits; qber may be per-block."""
    q = torch.as_tensor(qber, dtype=torch.float32, device=bits.device)
    mag = torch.log((1.0 - q) / q)
    mag = torch.broadcast_to(mag[..., None] if mag.ndim else mag, bits.shape)
    return torch.where(bits.to(torch.bool), -mag, mag).to(torch.float32)


class BatchDecodeResult(NamedTuple):
    """Decoder output.  ``converged`` is the layered decoder's fused
    per-sweep parity flag, which is optimistic by design (a later row of
    the declaring sweep may flip an earlier row's parity): only the
    pipeline's verification hash guarantees a block."""
    bits: torch.Tensor        # (B, n) uint8 hard decisions (all n variables)
    converged: torch.Tensor   # (B,) bool
    iterations: torch.Tensor  # (B,) int32 — sweeps consumed


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, -1.0, 1.0).to(torch.float32)


def _leave_one_out_min(mags):
    """other[k] = min over j != k of mags[j] via prefix/suffix running mins
    (exact float min — the same construction as the reference)."""
    d = len(mags)
    pre = [None] * d
    run = None
    for k in range(d):
        pre[k] = run
        run = mags[k] if run is None else torch.minimum(run, mags[k])
    suf = None
    out = [None] * d
    for k in range(d - 1, -1, -1):
        if suf is None:
            out[k] = pre[k]
        elif pre[k] is None:
            out[k] = suf
        else:
            out[k] = torch.minimum(pre[k], suf)
        suf = mags[k] if suf is None else torch.minimum(suf, mags[k])
    return out


def make_layered_decoder(code: QCCode, max_iters: int, alpha: float = 0.8125):
    """``(llr (B,n) f32, syndrome (B,m)) -> BatchDecodeResult``: row-layered
    normalized min-sum in plain PyTorch; op order mirrors
    ``qtpu.ldpc.decode._make_layered_decoder`` exactly."""
    edge_col = [int(x) for x in code.edge_col]
    edge_shift = [int(x) for x in code.edge_shift]
    row_edges = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    alpha_f = float(alpha)

    def _roll_chk(t, shift):
        return torch.roll(t, -shift, dims=1)

    def _syndrome_ok(totals, syn_sign):
        worst = None
        for i in range(mb):
            prod = syn_sign[i]
            for e in row_edges[i]:
                prod = prod * _sign(_roll_chk(totals[edge_col[e]],
                                              edge_shift[e]))
            row_min = prod.amin(dim=1)
            worst = row_min if worst is None else torch.minimum(worst, row_min)
        return worst > 0

    def _sweep(totals, c2v, syn_sign):
        """One layered sweep with the fused convergence flag (each row's
        parity from the rolled totals before that row's update)."""
        c2v = list(c2v)
        totals = list(totals)
        worst = None
        for i in range(mb):
            slots = row_edges[i]
            t_chk = [_roll_chk(totals[edge_col[e]], edge_shift[e])
                     for e in slots]
            prod = syn_sign[i]
            for t in t_chk:
                prod = prod * _sign(t)
            row_min = prod.amin(dim=1)
            worst = row_min if worst is None else torch.minimum(worst, row_min)
            msgs = [t_chk[k] - c2v[e] for k, e in enumerate(slots)]
            signs = [_sign(m) for m in msgs]
            mags = [torch.abs(m) for m in msgs]
            sign_all = signs[0]
            for sgn in signs[1:]:
                sign_all = sign_all * sgn
            others = _leave_one_out_min(mags)
            coset = syn_sign[i]
            for k, e in enumerate(slots):
                new = alpha_f * coset * sign_all * signs[k] * others[k]
                delta = new - c2v[e]
                c2v[e] = new
                j = edge_col[e]
                totals[j] = totals[j] + torch.roll(delta, edge_shift[e],
                                                   dims=1)
        return totals, c2v, worst > 0

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        bsz = llr.shape[0]
        llr3 = llr.reshape(bsz, nb, z).to(torch.float32)
        syn3 = syndrome.reshape(bsz, mb, z)
        syn_sign = [1.0 - 2.0 * syn3[:, i].to(torch.float32)
                    for i in range(mb)]
        totals = [llr3[:, j] + 0.0 for j in range(nb)]
        c2v = [torch.zeros((bsz, z), dtype=torch.float32, device=llr.device)
               for _ in range(E)]
        ok = _syndrome_ok(totals, syn_sign)
        iters = torch.zeros((bsz,), dtype=torch.int32, device=llr.device)
        it = 0
        while it < max_iters and not bool(ok.all()):
            totals_new, c2v_new, ok_new = _sweep(totals, c2v, syn_sign)
            keep = ok[:, None]  # freeze converged blocks
            totals = [torch.where(keep, a, b)
                      for a, b in zip(totals, totals_new)]
            c2v = [torch.where(keep, a, b) for a, b in zip(c2v, c2v_new)]
            iters = torch.where(ok, iters, torch.full_like(iters, it + 1))
            ok = ok | ok_new
            it += 1
        bits = (torch.stack(totals, dim=1) < 0).to(torch.uint8)
        return BatchDecodeResult(bits=bits.reshape(bsz, nb * z),
                                 converged=ok, iterations=iters)

    return decode
