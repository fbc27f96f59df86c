"""Batched BP decoding in plain PyTorch: layered and flooding min-sum, and
flooding sum-product.

Counterpart of ``qtpu/ldpc/decode.py``: the result type, the channel LLR,
the layered decoder ``_make_layered_decoder`` (``decode.py:217-306``) and
the flooding branch of ``make_batch_decoder`` (``decode.py:75-214``) op
for op — same float32 operation order, so min-sum bits, iteration counts
and converged flags equal the reference's (and ``qtpu.ldpc.golden``'s)
exactly.  Sum-product's tanh / atanh come from each library's own math, so
it agrees with the reference up to their last-bit differences.

The min-sum decoders are the plain versions beside the Hopper kernels
(``qtpu_torch.ldpc.cuda_bp``): the CPU path of the pipeline runs them, the
tests hold them to the JAX decoders, and ``chip_smoke.py`` holds the kernels
to them on the card.  Sum-product had no TPU kernel (XLA only in the
reference): this plain form is its port on every device.  Layout is the
natural ``(B, nb, z)``: each base column or edge is a ``(B, z)`` slice and a
circulant permutation is ``torch.roll`` along z.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qtpu_torch.ldpc.codes import QCCode

__all__ = ["make_layered_decoder", "make_flooding_decoder",
           "BatchDecodeResult", "channel_llr", "BIG_LLR"]

BIG_LLR = 1e9  # shortened-bit prior magnitude (matches golden.BIG_LLR)


def channel_llr(bits: torch.Tensor, qber) -> torch.Tensor:
    """BSC LLRs log(P(0)/P(1)) for observed bits; qber may be per-block."""
    q = torch.as_tensor(qber, dtype=torch.float32, device=bits.device)
    mag = torch.log((1.0 - q) / q)
    mag = torch.broadcast_to(mag[..., None] if mag.ndim else mag, bits.shape)
    return torch.where(bits.to(torch.bool), -mag, mag).to(torch.float32)


class BatchDecodeResult(NamedTuple):
    """Decoder output.  ``converged`` depends on the schedule: flooding's is
    an exact syndrome check of the returned bits; layered's is the fused
    per-sweep parity flag, optimistic by design (a later row of the
    declaring sweep may flip an earlier row's parity).  Only the pipeline's
    verification hash guarantees a block."""
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


def _minsum_row(msgs, coset, alpha: float):
    """Normalized min-sum check update of one base row: the new c2v of
    each slot, ``alpha*coset*sign_all*sign_k*min_{l!=k}|msg_l|`` multiplied
    left to right."""
    signs = [_sign(m) for m in msgs]
    mags = [torch.abs(m) for m in msgs]
    sign_all = signs[0]
    for sgn in signs[1:]:
        sign_all = sign_all * sgn
    others = _leave_one_out_min(mags)
    return [alpha * coset * sign_all * signs[k] * others[k]
            for k in range(len(msgs))]


def _sumprod_row(msgs, coset):
    """Sum-product check update of one base row (``_check_update_sumprod``
    of the reference): tanh rule with leave-one-out prefix/suffix products,
    messages clipped to +-30 and products to +-(1 - 1e-7)."""
    tanhs = [torch.tanh(torch.clamp(m, -30.0, 30.0) * 0.5) for m in msgs]
    d = len(msgs)
    prefix = [torch.ones_like(tanhs[0])]
    for k in range(d - 1):
        prefix.append(prefix[-1] * tanhs[k])
    suffix = [torch.ones_like(tanhs[0])]
    for k in range(d - 1, 0, -1):
        suffix.append(suffix[-1] * tanhs[k])
    suffix = suffix[::-1]
    out = []
    for k in range(d):
        t = torch.clamp(prefix[k] * suffix[k], -1 + 1e-7, 1 - 1e-7)
        val = 2.0 * torch.atanh(t) * coset
        out.append(torch.where(t.abs() < 1e-12, 0.0, val))
    return out


def make_flooding_decoder(code: QCCode, max_iters: int,
                          alpha: float = 0.8125, alg: str = "minsum"):
    """``(llr (B,n) f32, syndrome (B,m)) -> BatchDecodeResult``: flooding
    BP in plain PyTorch, normalized min-sum (``alg="minsum"``) or
    sum-product (``alg="sumprod"``, ``alpha`` unused); op order mirrors the
    flooding branch of ``qtpu.ldpc.decode.make_batch_decoder``.

    Round semantics: ``iterations`` counts check updates; a block whose
    channel hard decision already satisfies the syndrome reports 0, a block
    that never converges reports ``max_iters`` and the hard decision after
    exactly ``max_iters`` updates.  ``converged`` is an exact syndrome
    check (sign(0) = +1 means bit 0)."""
    edge_col = [int(x) for x in code.edge_col]
    edge_shift = [int(x) for x in code.edge_shift]
    row_edges = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    col_edges = [[int(e) for e in col if e >= 0] for col in code.col_edges]
    if alg not in ("minsum", "sumprod"):
        raise ValueError(f"unknown flooding alg {alg!r}")
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    alpha_f = float(alpha)

    def _totals(llr3, c2v):
        """Posterior totals per base column from check-view c2v, summed in
        column slot order (the golden-model contract)."""
        out = []
        for j in range(nb):
            t = llr3[:, j]
            for e in col_edges[j]:
                t = t + torch.roll(c2v[e], edge_shift[e], dims=1)
            out.append(t)
        return out

    def _chk_view_and_ok(totals, c2v, syn_bool):
        """v2c messages (check view) and the per-block exact syndrome
        check of the totals' hard decision."""
        t_chk = [torch.roll(totals[edge_col[e]], -edge_shift[e], dims=1)
                 for e in range(E)]
        v2c = [t_chk[e] - c2v[e] for e in range(E)]
        bad = None
        for i in range(mb):
            p = None
            for e in row_edges[i]:
                b = t_chk[e] < 0
                p = b if p is None else p ^ b
            miss = p != syn_bool[i]
            bad = miss if bad is None else bad | miss
        return v2c, ~bad.any(dim=1)

    def _check_update(v2c, syn_sign):
        out = [None] * E
        for i in range(mb):
            slots = row_edges[i]
            msgs = [v2c[e] for e in slots]
            new = (_minsum_row(msgs, syn_sign[i], alpha_f) if alg == "minsum"
                   else _sumprod_row(msgs, syn_sign[i]))
            for k, e in enumerate(slots):
                out[e] = new[k]
        return out

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        bsz = llr.shape[0]
        llr3 = llr.reshape(bsz, nb, z).to(torch.float32)
        syn3 = syndrome.reshape(bsz, mb, z)
        syn_sign = [1.0 - 2.0 * syn3[:, i].to(torch.float32)
                    for i in range(mb)]
        syn_bool = [syn3[:, i].to(torch.bool) for i in range(mb)]
        c2v = [torch.zeros((bsz, z), dtype=torch.float32, device=llr.device)
               for _ in range(E)]
        totals = _totals(llr3, c2v)
        v2c, ok = _chk_view_and_ok(totals, c2v, syn_bool)
        iters = torch.zeros((bsz,), dtype=torch.int32, device=llr.device)
        it = 0
        while it < max_iters and not bool(ok.all()):
            c2v_new = _check_update(v2c, syn_sign)
            totals_new = _totals(llr3, c2v_new)
            v2c_new, ok_new = _chk_view_and_ok(totals_new, c2v_new, syn_bool)
            keep = ok[:, None]  # freeze converged blocks
            c2v = [torch.where(keep, a, b) for a, b in zip(c2v, c2v_new)]
            totals = [torch.where(keep, a, b)
                      for a, b in zip(totals, totals_new)]
            v2c = [torch.where(keep, a, b) for a, b in zip(v2c, v2c_new)]
            iters = torch.where(ok, iters, torch.full_like(iters, it + 1))
            ok = ok | ok_new
            it += 1
        bits = (torch.stack(totals, dim=1) < 0).to(torch.uint8)
        return BatchDecodeResult(bits=bits.reshape(bsz, nb * z),
                                 converged=ok, iterations=iters)

    return decode


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
            new_row = _minsum_row(msgs, syn_sign[i], alpha_f)
            for e, new in zip(slots, new_row):
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
