"""Row-layered normalized min-sum in plain PyTorch: the decode cell's
reference.

A frozen copy of ``qtpu_torch/ldpc/decode.py``'s ``make_layered_decoder``
(itself op for op the JAX reference's layered decoder), so the bits,
iteration counts and converged flags it returns in float32 are the ones a
correct layered min-sum gives.  ``dtype`` is the precision of the
messages and totals: float32 is the reference, bfloat16 the control (the
nearest precision below the configuration's float32, which the check has
to refuse).
"""

from __future__ import annotations

import torch

__all__ = ["layered_decode"]


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def _leave_one_out_min(mags):
    """other[k] = min over j != k of mags[j], by prefix and suffix mins."""
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
    """The new check-to-variable message of each slot of one base row:
    alpha * coset * sign_all * sign_k * min_{l != k} |msg_l|, multiplied
    left to right."""
    signs = [_sign(m) for m in msgs]
    mags = [torch.abs(m) for m in msgs]
    sign_all = signs[0]
    for sgn in signs[1:]:
        sign_all = sign_all * sgn
    others = _leave_one_out_min(mags)
    return [alpha * coset * sign_all * signs[k] * others[k]
            for k in range(len(msgs))]


def layered_decode(code, llr: torch.Tensor, syndrome: torch.Tensor,
                   max_iters: int, alpha: float = 0.8125,
                   dtype: torch.dtype = torch.float32):
    """(bits (B, n) uint8, converged (B,) bool, iterations (B,) int32) of
    a layered min-sum decode of ``llr`` (B, n) against ``syndrome`` (B, m)
    on ``code`` (a ``reference.codes.RegularCode``), on the inputs' device.
    A block whose channel decision already satisfies the syndrome reports
    0 sweeps; converged blocks are frozen; ``converged`` is the fused
    per-sweep parity flag."""
    edge_col = [int(x) for x in code.edge_col]
    edge_shift = [int(x) for x in code.edge_shift]
    row_edges = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    bsz = llr.shape[0]
    llr3 = llr.reshape(bsz, nb, z).to(dtype)
    syn3 = syndrome.reshape(bsz, mb, z)
    syn_sign = [(1.0 - 2.0 * syn3[:, i].to(torch.float32)).to(dtype)
                for i in range(mb)]

    def roll_chk(t, shift):
        return torch.roll(t, -shift, dims=1)

    def syndrome_ok(totals):
        worst = None
        for i in range(mb):
            prod = syn_sign[i]
            for e in row_edges[i]:
                prod = prod * _sign(roll_chk(totals[edge_col[e]],
                                             edge_shift[e]))
            row_min = prod.amin(dim=1)
            worst = row_min if worst is None else torch.minimum(worst, row_min)
        return worst > 0

    def sweep(totals, c2v):
        c2v = list(c2v)
        totals = list(totals)
        worst = None
        for i in range(mb):
            slots = row_edges[i]
            t_chk = [roll_chk(totals[edge_col[e]], edge_shift[e])
                     for e in slots]
            prod = syn_sign[i]
            for t in t_chk:
                prod = prod * _sign(t)
            row_min = prod.amin(dim=1)
            worst = row_min if worst is None else torch.minimum(worst, row_min)
            msgs = [t_chk[k] - c2v[e] for k, e in enumerate(slots)]
            for e, new in zip(slots, _minsum_row(msgs, syn_sign[i], alpha)):
                delta = new - c2v[e]
                c2v[e] = new
                j = edge_col[e]
                totals[j] = totals[j] + torch.roll(delta, edge_shift[e],
                                                   dims=1)
        return totals, c2v, worst > 0

    totals = [llr3[:, j] + 0.0 for j in range(nb)]
    c2v = [torch.zeros((bsz, z), dtype=dtype, device=llr.device)
           for _ in range(E)]
    ok = syndrome_ok(totals)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=llr.device)
    it = 0
    while it < max_iters and not bool(ok.all()):
        totals_new, c2v_new, ok_new = sweep(totals, c2v)
        keep = ok[:, None]
        totals = [torch.where(keep, a, b) for a, b in zip(totals, totals_new)]
        c2v = [torch.where(keep, a, b) for a, b in zip(c2v, c2v_new)]
        iters = torch.where(ok, iters, torch.full_like(iters, it + 1))
        ok = ok | ok_new
        it += 1
    bits = (torch.stack(totals, dim=1) < 0).to(torch.uint8)
    return bits.reshape(bsz, nb * z), ok, iters
