"""Golden-model LDPC reconciliation in pure NumPy.

The reference binary is absent (SURVEY.md §0), so this module IS the golden
model the accelerated decoders must match (SURVEY.md §5.1): syndrome encode
and belief-propagation decoding (normalized min-sum and sum-product) with the
syndrome-coset trick for reconciliation, in float32 with a fixed, documented
operation order so the JAX/Pallas decoders can match it **bit-exactly** for
min-sum (SURVEY.md Appendix B).

Reference capability: the BP decoder of the ``-ldpc`` fork
(``errorcorrection/`` LDPC path, SURVEY.md §4.4).

Operation-order contract (shared with qtpu.ldpc.decode / pallas_bp):
  * slot reductions (variable sums, check sign/min) accumulate sequentially
    over the padded slot axis, slot 0 first;
  * the min-tie convention is "first minimal slot wins" (argmin semantics);
  * all message arithmetic is float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qtpu_torch.ldpc.codes import QCCode

__all__ = [
    "channel_llr",
    "encode_syndrome",
    "decode",
    "DecodeResult",
]

_F32 = np.float32
# Magnitude used for "infinite" LLRs (shortened bits). Large enough to pin the
# bit, small enough that sums of a few of them stay finite in float32.
BIG_LLR = _F32(1e9)


def channel_llr(bits: np.ndarray, qber: float) -> np.ndarray:
    """BSC log-likelihood ratios log(P(0)/P(1)) for observed ``bits``.

    bits: int/bool array of Bob's observed bits (any shape).
    """
    mag = _F32(np.log((1.0 - qber) / qber))
    return np.where(bits.astype(bool), -mag, mag).astype(_F32)


def encode_syndrome(code: QCCode, bits: np.ndarray) -> np.ndarray:
    """Syndrome s = H @ bits over GF(2), using the QC structure.

    bits: (nb*z,) or (nb, z) 0/1 array → returns (mb, z) uint8.
    """
    b = np.asarray(bits).reshape(code.nb, code.z).astype(np.uint8)
    syn = np.zeros((code.mb, code.z), dtype=np.uint8)
    for e in range(code.num_edges):
        i, j, s = int(code.edge_row[e]), int(code.edge_col[e]), int(code.edge_shift[e])
        # Check (i, zc) touches variable (j, (zc + s) % z):
        syn[i] ^= np.roll(b[j], -s)
    return syn


@dataclasses.dataclass
class DecodeResult:
    bits: np.ndarray        # (nb, z) uint8 hard decisions
    converged: bool         # syndrome matched within max_iters
    iterations: int         # iterations actually used (1-based)


def _sign(x: np.ndarray) -> np.ndarray:
    """±1 sign with sign(0) = +1 (contract shared with the JAX decoders)."""
    return np.where(x < 0, _F32(-1.0), _F32(1.0))


def _leave_one_out_min(mags):
    """other[k] = min over j != k of mags[j], via prefix/suffix running mins.

    float32 min is exact, so this equals the earlier two-smallest-magnitude
    scan value-for-value while using fewer ops and no index bookkeeping —
    the op-order contract is on *values*, which are unchanged.
    """
    d = len(mags)
    pre = [None] * d
    run = None
    for k in range(d):
        pre[k] = run
        run = mags[k] if run is None else np.minimum(run, mags[k])
    suf = None
    out = [None] * d
    for k in range(d - 1, -1, -1):
        if suf is None:
            out[k] = pre[k]
        elif pre[k] is None:
            out[k] = suf
        else:
            out[k] = np.minimum(pre[k], suf)
        suf = mags[k] if suf is None else np.minimum(suf, mags[k])
    return out


def decode(code: QCCode,
           llr: np.ndarray,
           syndrome: np.ndarray,
           max_iters: int = 50,
           alg: str = "minsum",
           alpha: float = 0.8125,
           ) -> DecodeResult:
    """Decode one block to the coset defined by ``syndrome``.

    Args:
      llr: (nb, z) float32 channel LLRs (log P(0)/P(1)), already including any
        puncturing (0) / shortening (±BIG_LLR) priors.
      syndrome: (mb, z) 0/1 target syndrome (Alice's).
      alg: "minsum" (normalized flooding, factor ``alpha``), "sumprod"
        (flooding), or "layered" (row-layered normalized min-sum — checks
        update sequentially by base row with immediate posterior updates;
        converges in roughly half the sweeps of flooding).
      alpha: min-sum normalization; 0.8125 = 13/16 is exactly representable.

    Returns hard-decision bits for **all** n variables (incl. punctured and
    shortened positions); the caller extracts payload columns.
    """
    if alg == "layered":
        return _decode_layered(code, llr, syndrome, max_iters, alpha)
    llr = np.asarray(llr, dtype=_F32).reshape(code.nb, code.z)
    syn_sign = (_F32(1.0) - _F32(2.0) * np.asarray(syndrome, dtype=_F32)
                ).reshape(code.mb, code.z)  # ±1, -1 where syndrome bit is 1
    e_count, z = code.num_edges, code.z
    alpha = _F32(alpha)

    c2v_chk = np.zeros((e_count, z), dtype=_F32)  # check-side view
    bits = (llr < 0).astype(np.uint8)
    syn_target = np.asarray(syndrome, dtype=np.uint8).reshape(code.mb, z)
    if np.array_equal(encode_syndrome(code, bits), syn_target):
        return DecodeResult(bits=bits, converged=True, iterations=0)

    it_used = 0
    for it in range(max_iters):
        it_used = it + 1
        # ---- variable side: totals and v2c messages --------------------
        c2v_var = np.empty_like(c2v_chk)
        for e in range(e_count):
            c2v_var[e] = np.roll(c2v_chk[e], int(code.edge_shift[e]))
        total = llr.copy()
        for j in range(code.nb):
            for slot in range(code.dv_max):
                e = int(code.col_edges[j, slot])
                if e >= 0:
                    total[j] = total[j] + c2v_var[e]
        v2c_chk = np.empty_like(c2v_chk)
        for e in range(e_count):
            v_var = total[int(code.edge_col[e])] - c2v_var[e]
            v2c_chk[e] = np.roll(v_var, -int(code.edge_shift[e]))

        # ---- check side: normalized min-sum / sum-product --------------
        if alg == "minsum":
            for i in range(code.mb):
                slots = [int(e) for e in code.row_edges[i] if e >= 0]
                msgs = [v2c_chk[e] for e in slots]
                signs = [_sign(m) for m in msgs]
                mags = [np.abs(m) for m in msgs]
                # Sequential sign product; leave-one-out mins.
                sign_all = signs[0]
                for sgn in signs[1:]:
                    sign_all = sign_all * sgn
                others = _leave_one_out_min(mags)
                coset = syn_sign[i]
                for k, e in enumerate(slots):
                    out = alpha * coset * sign_all * signs[k] * others[k]
                    c2v_chk[e] = out.astype(_F32)
        elif alg == "sumprod":
            for i in range(code.mb):
                slots = [int(e) for e in code.row_edges[i] if e >= 0]
                msgs = [np.clip(v2c_chk[e], -30.0, 30.0) for e in slots]
                tanhs = [np.tanh(m * _F32(0.5)) for m in msgs]
                d = len(slots)
                # Leave-one-out products via prefix/suffix (sequential order).
                prefix = [np.ones((z,), dtype=_F32)]
                for k in range(d - 1):
                    prefix.append(prefix[-1] * tanhs[k])
                suffix = [np.ones((z,), dtype=_F32)]
                for k in range(d - 1, 0, -1):
                    suffix.append(suffix[-1] * tanhs[k])
                suffix = suffix[::-1]
                coset = syn_sign[i]
                eps = _F32(1e-12)
                for k, e in enumerate(slots):
                    t = np.clip(prefix[k] * suffix[k], -1 + 1e-7, 1 - 1e-7)
                    out = _F32(2.0) * np.arctanh(t) * coset
                    c2v_chk[e] = np.where(np.abs(t) < eps, _F32(0.0), out).astype(_F32)
        else:
            raise ValueError(f"unknown alg {alg!r}")

        # ---- posterior, hard decision, syndrome check ------------------
        c2v_var = np.empty_like(c2v_chk)
        for e in range(e_count):
            c2v_var[e] = np.roll(c2v_chk[e], int(code.edge_shift[e]))
        post = llr.copy()
        for j in range(code.nb):
            for slot in range(code.dv_max):
                e = int(code.col_edges[j, slot])
                if e >= 0:
                    post[j] = post[j] + c2v_var[e]
        bits = (post < 0).astype(np.uint8)
        syn_hat = encode_syndrome(code, bits)
        if np.array_equal(syn_hat, syn_target):
            return DecodeResult(bits=bits, converged=True, iterations=it_used)

    return DecodeResult(bits=bits, converged=False, iterations=it_used)


def _decode_layered(code: QCCode, llr: np.ndarray, syndrome: np.ndarray,
                    max_iters: int, alpha: float) -> DecodeResult:
    """Row-layered normalized min-sum (the golden model for alg="layered").

    Operation-order contract shared with the JAX/Pallas layered decoders:
    layers sweep base rows in ascending order; within a layer the slot order
    is `row_edges[i]` order; totals update immediately via delta rolls.

    Convergence (v2, fused): each row's parity is checked ON THE FLY from
    the sign of the rolled totals the sweep computes anyway — evaluated
    when the row is processed (after rows < i of the same sweep, before
    row i's own update).  A sweep where every row passed declares
    convergence with the END-of-sweep hard decision.  This removes the
    separate per-sweep syndrome pass (a third of the rolls — measured ~35%
    of Pallas iteration cost) at the price of a *rare* optimistic flag: a
    later row's update can flip an earlier row's parity within the
    declaring sweep, so H·x̂ = s is NOT re-verified here — the pipeline's
    per-block verification hash catches such blocks exactly like any other
    decode failure (they fail verification and retry).  An initial exact
    syndrome check still short-circuits already-clean inputs at
    iterations=0.
    """
    llr = np.asarray(llr, dtype=_F32).reshape(code.nb, code.z)
    syn_target = np.asarray(syndrome, dtype=np.uint8).reshape(code.mb, code.z)
    syn_sign = (_F32(1.0) - _F32(2.0) * syn_target.astype(_F32))
    z = code.z
    alpha = _F32(alpha)

    totals = llr.copy()
    c2v = np.zeros((code.num_edges, z), dtype=_F32)  # chk-view
    bits = (totals < 0).astype(np.uint8)
    if np.array_equal(encode_syndrome(code, bits), syn_target):
        return DecodeResult(bits=bits, converged=True, iterations=0)

    for it in range(max_iters):
        ok_sweep = True
        for i in range(code.mb):
            slots = [int(e) for e in code.row_edges[i] if e >= 0]
            t_chk = [np.roll(totals[int(code.edge_col[e])],
                             -int(code.edge_shift[e])) for e in slots]
            prod = syn_sign[i]
            for t in t_chk:
                prod = prod * _sign(t)
            if prod.min() <= 0:
                ok_sweep = False
            msgs = [t_chk[k] - c2v[e] for k, e in enumerate(slots)]
            signs = [_sign(m) for m in msgs]
            mags = [np.abs(m) for m in msgs]
            sign_all = signs[0]
            for sgn in signs[1:]:
                sign_all = sign_all * sgn
            others = _leave_one_out_min(mags)
            coset = syn_sign[i]
            for k, e in enumerate(slots):
                new = (alpha * coset * sign_all * signs[k] * others[k]).astype(_F32)
                delta = new - c2v[e]
                c2v[e] = new
                j, s = int(code.edge_col[e]), int(code.edge_shift[e])
                totals[j] = totals[j] + np.roll(delta, s)
        bits = (totals < 0).astype(np.uint8)
        if ok_sweep:
            return DecodeResult(bits=bits, converged=True, iterations=it + 1)
    return DecodeResult(bits=bits, converged=False, iterations=max_iters)
