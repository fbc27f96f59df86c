"""Density-evolution code design for BSC min-sum reconciliation.

Reference capability: the `-ldpc` fork ships fixed parity-check matrices
(SURVEY.md §3 #13 "parity-check matrix construction/loading"); qtpu
constructs codes programmatically (qtpu.ldpc.codes) and this module supplies
the *design* step: given a target rate, find the base-column degree profile
with the best asymptotic decoding threshold under the production decoder
(normalized min-sum, alpha = 13/16) on the BSC.

Discrete density evolution (Chen & Fossorier's min-sum DE, specialized to
the two-point BSC channel density):

  * Message densities live on a uniform signed LLR grid (saturating ends).
  * Variable update = pmf convolution (channel ⊛ (dv-1)-fold c2v).
  * Min-sum check update is EXACT on the grid via magnitude tail sums:
    for iid inputs with magnitude-tail F(m) = P(|X| >= m) and signed tail
    S(m) = sum_{|x|>=m} sign(x) p(x),
        P(min >= m, sign prod = +1) = (F(m)^k + S(m)^k) / 2
    so the output pmf falls out of first differences; the alpha scaling is
    a magnitude re-bin (floor — conservative).
  * sign(0) = +1, matching the golden model/kernels (qtpu.ldpc.golden).

Degree distributions are taken at BASE-GRAPH granularity: nb columns with
integer degrees (each lifted to z variables), balanced row degrees q/q+1 —
exactly what make_irregular_code realizes — so a DE-optimized profile maps
1:1 onto a buildable QC code.

Everything is plain NumPy on host: code design is an offline step (the
output — a degree profile — is protocol configuration, like the frozen
calibration tables in qtpu.ldpc.calibrate).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["MinSumDE", "de_threshold", "optimize_profile",
           "ProtographDE", "proto_threshold", "optimize_base_graph"]


class MinSumDE:
    """Density evolution for normalized min-sum over BSC(q).

    Args:
      qber: BSC crossover probability of the evolved channel.
      alpha: min-sum normalization factor (production decoder uses 13/16).
      bins: number of magnitude bins (grid has 2*bins+1 signed points).
      max_llr_mult: saturation magnitude, in units of the channel LLR
        magnitude (messages rarely exceed ~dv * channel magnitude before
        saturation matters; 16 is generous for dv <= 12).
    """

    def __init__(self, qber: float, alpha: float = 0.8125,
                 bins: int = 1024, max_llr_mult: float = 16.0):
        assert 0.0 < qber < 0.5
        self.q = float(qber)
        self.alpha = float(alpha)
        self.B = int(bins)
        self.mag = float(np.log((1.0 - qber) / qber))
        self.delta = max_llr_mult * self.mag / self.B
        # Channel density: +mag w.p. 1-q, -mag w.p. q (all-zero codeword,
        # symmetric channel — the coset trick makes reconciliation identical).
        self.ch = np.zeros(2 * self.B + 1)
        kb = min(self.B, int(round(self.mag / self.delta)))
        self.ch[self.B + kb] = 1.0 - self.q
        self.ch[self.B - kb] = self.q
        # Precompute alpha re-bin map for magnitudes 0..B.  floor() would
        # send magnitude-1 messages to 0, folding their sign into +0
        # (sign(0)=+1) — an optimistic bias at coarse grids; clamp nonzero
        # magnitudes to stay nonzero instead.
        m = np.arange(self.B + 1)
        self.alpha_map = np.floor(self.alpha * m).astype(np.int64)
        self.alpha_map[1:] = np.maximum(self.alpha_map[1:], 1)

    def err(self, pmf: np.ndarray) -> float:
        """Message error probability: P(x < 0) + P(x == 0)/2."""
        return float(pmf[: self.B].sum() + 0.5 * pmf[self.B])

    def var_update(self, c2v: np.ndarray, dvs: Sequence[int],
                   edge_frac: Sequence[float]) -> np.ndarray:
        """Edge-averaged v2c density: ch ⊛ (d-1)-fold c2v, mixed over the
        edge-perspective degree fractions."""
        out = np.zeros_like(c2v)
        # Build d-fold convolutions incrementally (degrees sorted).
        order = np.argsort(dvs)
        acc = self.ch.copy()
        have = 0  # number of c2v factors folded into acc
        for idx in order:
            d = int(dvs[idx])
            while have < d - 1:
                acc = self._conv(acc, c2v)
                have += 1
            out += float(edge_frac[idx]) * acc
        s = out.sum()
        return out / s if s > 0 else out

    def _conv(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Signed-grid convolution with saturation at the grid ends."""
        full = np.convolve(a, b)
        B = self.B
        c = 2 * B  # index of 0 in `full` (length 4B+1)
        out = full[c - B: c + B + 1].copy()
        out[0] += full[: c - B].sum()
        out[-1] += full[c + B + 1:].sum()
        return out

    def chk_update(self, v2c: np.ndarray, dcs: Sequence[int],
                   edge_frac: Sequence[float]) -> np.ndarray:
        """Edge-averaged c2v density under normalized min-sum (exact)."""
        B = self.B
        p_pos = v2c[B:].copy()          # magnitudes 0..B, positive sign
        p_pos[0] = v2c[B]               # sign(0) = +1 (golden convention)
        p_neg = np.zeros(B + 1)
        p_neg[1:] = v2c[B - 1:: -1]     # magnitudes 1..B, negative sign
        f = p_pos + p_neg               # magnitude pmf
        s = p_pos - p_neg               # signed difference
        # Tail sums over magnitude >= m  (index m = 0..B; F[B+1] = 0).
        F = np.concatenate([np.cumsum(f[::-1])[::-1], [0.0]])
        S = np.concatenate([np.cumsum(s[::-1])[::-1], [0.0]])
        out = np.zeros(2 * B + 1)
        for d, w in zip(dcs, edge_frac):
            k = int(d) - 1
            if k <= 0 or w == 0.0:
                continue
            Tp = 0.5 * (F ** k + S ** k)   # P(min >= m, sign +)
            Tm = 0.5 * (F ** k - S ** k)   # P(min >= m, sign -)
            pp = Tp[:-1] - Tp[1:]          # P(min == m, sign +)
            pm = Tm[:-1] - Tm[1:]
            # alpha re-bin (floor) onto the same grid.
            qp = np.bincount(self.alpha_map, weights=pp, minlength=B + 1)
            qm = np.bincount(self.alpha_map, weights=pm, minlength=B + 1)
            out[B:] += w * qp
            out[B - 1:: -1] += w * qm[1:]
            out[B] += w * qm[0]            # -0 == +0
        t = out.sum()
        return out / t if t > 0 else out

    def run(self, col_degrees: Sequence[int], mb: int,
            max_iters: int = 200, target: float = 1e-4) -> tuple[bool, int]:
        """Evolve densities for the (col_degrees, balanced-rows mb) ensemble.

        Returns (converged to < target message error, iterations used).
        Also stops early (failure) when the error stalls — the classic DE
        fixed-point plateau — to keep threshold searches fast.

        Why target 1e-4, not ~0: profiles with heavy degree-2 mass violate
        the asymptotic stability condition (the ensemble has a ~1e-5 error
        floor) yet their STRUCTURED finite realizations (cycle-broken QC
        lift, greedy distinct-row base graph, n ~ 1e4) decode cleanly —
        empirically irregular_profile_v2 (floor ~5e-5 at 2%) beats the
        stability-respecting legacy profile by +0.25% QBER at every rung.
        The design criterion must match the finite-length FER<=5% regime:
        residual message error ~1e-4 ≈ O(1) raw bit errors per block,
        which the waterfall has already decided.  Empirical calibration
        (qtpu.ldpc.calibrate) remains the ground truth gate.
        """
        dvs = sorted(set(int(d) for d in col_degrees))
        cnt = {d: 0 for d in dvs}
        for d in col_degrees:
            cnt[int(d)] += 1
        E = float(sum(col_degrees))
        v_frac = [cnt[d] * d / E for d in dvs]
        total = int(sum(col_degrees))
        qd, r = divmod(total, mb)
        dcs, c_frac = [], []
        if mb - r:
            dcs.append(qd)
            c_frac.append((mb - r) * qd / E)
        if r:
            dcs.append(qd + 1)
            c_frac.append(r * (qd + 1) / E)

        c2v = np.zeros(2 * self.B + 1)
        c2v[self.B] = 1.0  # iteration 0: no check info
        prev = 1.0
        stall = 0
        for it in range(1, max_iters + 1):
            v2c = self.var_update(c2v, dvs, v_frac)
            c2v = self.chk_update(v2c, dcs, c_frac)
            e = self.err(c2v)
            if e < target:
                return True, it
            # Stall = no RELATIVE progress.  DE just below threshold passes
            # through a characteristically slow plateau (error shrinking by
            # <0.1%/iter for tens of iterations) before the waterfall; an
            # absolute criterion (e > prev - 1e-9) misclassifies that plateau
            # as a fixed point and systematically underestimates thresholds
            # (round-1 advisor finding).
            if e > prev * (1.0 - 1e-4):
                stall += 1
                if stall >= 12:
                    return False, it
            else:
                stall = 0
            prev = e
        return False, max_iters


def de_threshold(col_degrees: Sequence[int], mb: int, alpha: float = 0.8125,
                 lo: float = 0.005, hi: float = 0.14, tol: float = 2.5e-4,
                 bins: int = 1024, max_iters: int = 200,
                 target: float = 1e-4) -> float:
    """Largest BSC error rate where DE converges (bisection to ``tol``)."""
    # Expand-verify the bracket ends first.
    if MinSumDE(hi, alpha, bins).run(col_degrees, mb, max_iters, target)[0]:
        return hi
    if not MinSumDE(lo, alpha, bins).run(col_degrees, mb, max_iters, target)[0]:
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        ok, _ = MinSumDE(mid, alpha, bins).run(col_degrees, mb, max_iters,
                                               target)
        if ok:
            lo = mid
        else:
            hi = mid
    return lo


def optimize_profile(nb: int, mb: int, alpha: float = 0.8125,
                     max_deg: Optional[int] = None, bins: int = 768,
                     max_iters: int = 150, seed: int = 7,
                     rounds: int = 400, init: Optional[Sequence[int]] = None,
                     verbose: bool = False) -> tuple[list[int], float]:
    """Hill-climb the base-column degree profile for the best DE threshold.

    Constraints mirror the QC constructor's cycle-safety limits
    (qtpu.ldpc.codes): degrees in [2, min(mb, max_deg)], at most mb-1
    degree-2 columns (a simple base graph needs distinct rows per column and
    too much degree-2 mass creates low-weight cycle structures), and at most
    nb//2 degree-2 columns overall.

    Moves: bump one column's degree +/-1 (profiles are kept sorted — column
    identity is irrelevant at ensemble level).  Accept on strictly better
    threshold.  Deterministic from ``seed``.
    """
    cap = min(mb, max_deg if max_deg is not None else 12)
    max_d2 = min(mb - 1, nb // 2)
    rng = np.random.default_rng(seed)

    def legal(prof: list[int]) -> bool:
        return (len(prof) == nb and all(2 <= d <= cap for d in prof)
                and sum(1 for d in prof if d == 2) <= max_d2)

    if init is None:
        from qtpu_torch.ldpc.codes import irregular_profile_v2
        init = irregular_profile_v2(nb, mb)
        init = [min(d, cap) for d in init]
    cur = sorted(int(d) for d in init)
    assert legal(cur), "initial profile violates constraints"
    cur_t = de_threshold(cur, mb, alpha, bins=bins, max_iters=max_iters)
    if verbose:
        print(f"init mb={mb}: threshold {cur_t:.4f} profile {cur}")
    for step in range(rounds):
        cand = list(cur)
        j = int(rng.integers(0, nb))
        cand[j] += int(rng.choice([-1, 1]))
        cand.sort()
        if not legal(cand) or cand == cur:
            continue
        t = de_threshold(cand, mb, alpha, bins=bins, max_iters=max_iters,
                         lo=max(0.005, cur_t - 0.01), hi=min(0.14, cur_t + 0.02))
        if t > cur_t + 1e-5:
            cur, cur_t = cand, t
            if verbose:
                print(f"  step {step}: threshold {cur_t:.4f} profile {cur}")
    # The search brackets were clipped around the incumbent for speed; an
    # accepted candidate whose true threshold exceeds the clip stores the
    # truncated value.  Re-measure the winner on the full bracket (round-1
    # advisor finding).
    cur_t = de_threshold(cur, mb, alpha, bins=bins, max_iters=max_iters)
    return cur, cur_t


# ---------------------------------------------------------------------------
# Protograph (multi-edge-type) density evolution — the production design tool
# ---------------------------------------------------------------------------

class ProtographDE:
    """Per-base-edge min-sum density evolution on the BSC.

    Why this exists (round-2 finding): qtpu codes are QC lifts of a small
    base graph.  The *unconditioned* irregular ensemble with the same degree
    profile can be drastically worse than the protograph ensemble the
    constructor actually samples — e.g. the native2 mb=13/nb=32 profile has a
    profile-DE fixed-point floor (~1e-3 residual error at 4% QBER, threshold
    2.4%) while its lifted realization measures a 6.25% FER<=5% ceiling at
    n=16384.  Protograph DE tracks one density per base EDGE, so slot-specific
    message quality (a check mixing one weak degree-2 input with strong
    high-degree inputs) is modeled exactly; it converges to the structured
    ensemble's true asymptotics as z → ∞.

    Numerics: densities on a signed LLR grid of 2*bins+1 points.  Variable
    updates are exact pmf convolutions via f64 FFT on a padded grid with ONE
    saturation at the end (roundoff ≲ 1e-12, folded into bins ≥ 1e-12 mass).
    Check updates use the exact min-sum order-statistics identity per slot:
    with per-input magnitude tails F_e(m) = P(|X_e| >= m) and signed tails
    S_e(m), the leave-one-out products give
        P(min_{e'≠e} >= m, sign prod = +1) = (∏ F_{e'} + ∏ S_{e'}) / 2
    and the output pmf falls out of first differences; alpha scaling re-bins
    magnitudes (nonzero magnitudes clamped to stay nonzero).
    """

    def __init__(self, edge_row: np.ndarray, edge_col: np.ndarray,
                 qber: float, alpha: float = 0.8125, bins: int = 256,
                 max_llr_mult: float = 16.0,
                 punct_cols: tuple = ()):
        assert 0.0 < qber < 0.5
        self.q = float(qber)
        self.alpha = float(alpha)
        self.B = int(bins)
        self.mag = float(np.log((1.0 - qber) / qber))
        self.delta = max_llr_mult * self.mag / self.B
        self.edge_row = np.asarray(edge_row, np.int64)
        self.edge_col = np.asarray(edge_col, np.int64)
        self.E = int(self.edge_row.shape[0])
        self.mb = int(self.edge_row.max()) + 1
        self.nb = int(self.edge_col.max()) + 1
        self.col_slots = [np.flatnonzero(self.edge_col == j)
                          for j in range(self.nb)]
        self.row_slots = [np.flatnonzero(self.edge_row == i)
                          for i in range(self.mb)]
        B = self.B
        self.ch = np.zeros(2 * B + 1)
        kb = min(B, int(round(self.mag / self.delta)))
        self.ch[B + kb] = 1.0 - self.q
        self.ch[B - kb] = self.q
        # Punctured protograph nodes (the AR4JA/5G-NR state-variable trick):
        # their z variables carry transmitter-private random pad — decoder
        # prior is a delta at LLR 0.  Crucial for near-capacity thresholds at
        # high rates; the rate machinery credits their parities as unleaked
        # (RateStep.leaked_bits = m - p).
        self.punct = set(int(c) for c in punct_cols)
        self.ch0 = np.zeros(2 * B + 1)
        self.ch0[B] = 1.0
        m = np.arange(B + 1)
        self.alpha_map = np.floor(self.alpha * m).astype(np.int64)
        self.alpha_map[1:] = np.maximum(self.alpha_map[1:], 1)
        # FFT plan per column degree: product of d pmfs (ch + d-1 messages)
        # has support d*2B+1; one shared padded length per degree.
        self._fftlen = {}

    def _fft_len(self, nfactors: int) -> int:
        if nfactors not in self._fftlen:
            need = nfactors * 2 * self.B + 1
            self._fftlen[nfactors] = 1 << (need - 1).bit_length()
        return self._fftlen[nfactors]

    def _saturate(self, full: np.ndarray, nfactors: int) -> np.ndarray:
        """Fold a length-(nfactors*2B+1)+pad conv result onto the ±B grid."""
        B = self.B
        c = nfactors * B  # index of LLR 0
        out = full[c - B: c + B + 1].copy()
        out[0] += full[: c - B].sum()
        out[-1] += full[c + B + 1: nfactors * 2 * B + 1].sum()
        np.maximum(out, 0.0, out=out)  # FFT roundoff can go -1e-17
        s = out.sum()
        return out / s if s > 0 else out

    def var_update(self, c2v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """v2c[e] = saturate(ch ⊛ (⊛_{e' in col(e), e'≠e} c2v[e'])).

        Also returns the per-column POSTERIOR bit-error probabilities
        P(ch + Σ_all c2v < 0) + P(== 0)/2 — the quantity that decides frame
        errors.  Message densities on weak edge classes (degree-2 chains)
        retain a genuine fixed-point floor while the posterior converges to
        ~0; gating on messages wildly underestimates thresholds (round-2
        finding: native2 mb=13 measures a 6.25% ceiling; the message-error
        gate says 1.2%).
        """
        B = self.B
        v2c = np.empty_like(c2v)
        post_err = np.empty(self.nb)
        for j, slots in enumerate(self.col_slots):
            d = len(slots)
            L = self._fft_len(d)
            fs = np.fft.rfft(c2v[slots], L, axis=-1)
            chf = np.fft.rfft(self.ch0 if j in self.punct else self.ch, L)
            # Leave-one-out products via prefix/suffix (d is tiny).
            pre = np.empty_like(fs)
            suf = np.empty_like(fs)
            run = chf
            for k in range(d):
                pre[k] = run
                run = run * fs[k]
            run = np.ones(fs.shape[-1], np.complex128)
            for k in range(d - 1, -1, -1):
                suf[k] = run
                run = run * fs[k]
            full = np.fft.irfft(pre * suf, L, axis=-1)
            for k, e in enumerate(slots):
                v2c[e] = self._saturate(full[k], d)
            # Posterior: product of ALL d message factors and the channel.
            # Support (d+1)*2B+1 exceeds L for power-of-two overshoot margins
            # only when d*2B+1 was already ~L; use the dedicated length.
            Lp = self._fft_len(d + 1)
            if Lp == L:
                pf = pre[d - 1] * fs[d - 1]
            else:
                fs2 = np.fft.rfft(c2v[slots], Lp, axis=-1)
                pf = np.fft.rfft(self.ch0 if j in self.punct else self.ch, Lp)
                for k in range(d):
                    pf = pf * fs2[k]
            fullp = np.fft.irfft(pf, Lp)
            c = (d + 1) * B
            neg = fullp[:c]
            post_err[j] = max(0.0, neg.sum()) + 0.5 * max(0.0, fullp[c])
        return v2c, post_err

    def chk_update(self, v2c: np.ndarray) -> np.ndarray:
        """Exact normalized-min-sum check update, per base edge."""
        B = self.B
        # Per-edge magnitude pmf f (0..B) and signed pmf s; sign(0) = +1.
        p_pos = v2c[:, B:].copy()
        p_neg = np.zeros((self.E, B + 1))
        p_neg[:, 1:] = v2c[:, B - 1:: -1]
        f = p_pos + p_neg
        sgn = p_pos - p_neg
        # Tail sums over magnitude >= m (index 0..B; [B+1] = 0).
        F = np.concatenate([np.cumsum(f[:, ::-1], axis=1)[:, ::-1],
                            np.zeros((self.E, 1))], axis=1)
        S = np.concatenate([np.cumsum(sgn[:, ::-1], axis=1)[:, ::-1],
                            np.zeros((self.E, 1))], axis=1)
        out = np.zeros((self.E, 2 * B + 1))
        for slots in self.row_slots:
            d = len(slots)
            Fx, Sx = F[slots], S[slots]
            pre_f = np.empty_like(Fx); suf_f = np.empty_like(Fx)
            pre_s = np.empty_like(Sx); suf_s = np.empty_like(Sx)
            rf = np.ones(B + 2); rs = np.ones(B + 2)
            for k in range(d):
                pre_f[k], pre_s[k] = rf, rs
                rf = rf * Fx[k]
                rs = rs * Sx[k]
            rf = np.ones(B + 2); rs = np.ones(B + 2)
            for k in range(d - 1, -1, -1):
                suf_f[k], suf_s[k] = rf, rs
                rf = rf * Fx[k]
                rs = rs * Sx[k]
            Fo = pre_f * suf_f   # ∏_{e'≠e} F_{e'}, per slot
            So = pre_s * suf_s
            Tp = 0.5 * (Fo + So)
            Tm = 0.5 * (Fo - So)
            pp = Tp[:, :-1] - Tp[:, 1:]   # P(min == m, sign +), m = 0..B
            pm = Tm[:, :-1] - Tm[:, 1:]
            for k, e in enumerate(slots):
                qp = np.bincount(self.alpha_map, weights=pp[k], minlength=B + 1)
                qm = np.bincount(self.alpha_map, weights=pm[k], minlength=B + 1)
                o = out[e]
                o[B:] += qp
                o[B - 1:: -1] += qm[1:]
                o[B] += qm[0]          # -0 == +0
                t = o.sum()
                if t > 0:
                    o /= t
        return out

    def run(self, max_iters: int = 300,
            target: float = 3e-6) -> tuple[bool, int]:
        """Evolve to (converged, iterations).

        Convergence = mean per-column posterior bit error < ``target``.
        target ≈ (acceptable residual errors per block) / n in the finite
        regime the design serves — 3e-6 ≈ 0.05 expected raw errors for
        n = 16384, matching the FER<=5% calibration gate; the empirical
        calibration (qtpu.ldpc.calibrate) remains the ground truth.
        Stall exit: no relative progress on the posterior for 12 iterations.
        """
        c2v = np.zeros((self.E, 2 * self.B + 1))
        c2v[:, self.B] = 1.0
        prev = 1.0
        stall = 0
        # Frame errors count PAYLOAD mismatches only; punctured columns carry
        # discarded pad bits, so they are excluded from the gate.
        pay = np.asarray([j for j in range(self.nb) if j not in self.punct])
        for it in range(1, max_iters + 1):
            v2c, post = self.var_update(c2v)
            c2v = self.chk_update(v2c)
            e = float(post[pay].mean())
            if e < target:
                return True, it
            if e > prev * (1.0 - 1e-4):
                stall += 1
                if stall >= 12:
                    return False, it
            else:
                stall = 0
            prev = e
        return False, max_iters


def capacity_init_graph(nb: int, mb: int, seed: int = 5,
                        max_deg: int = 16,
                        lam2: float = 0.24) -> tuple[np.ndarray, np.ndarray]:
    """Capacity-informed initial base graph for optimize_base_graph.

    Classic optimized irregular ensembles put ~lam2 of the EDGE mass on
    degree-2 variables, a small degree-3/4 body, and a high-degree tail; the
    v2 profiles (capped at mb-1 degree-2 columns) can't reach that regime,
    which is exactly what the odd-shift-sum lift repair unlocks.  Rows are
    balanced; degree-2 row pairs are kept distinct.
    """
    cap = min(mb, max_deg)
    rng = np.random.default_rng(seed)
    ntail = max(2, nb // 20)
    # Solve n2 from the target edge fraction with a deg-3 body.
    body = nb - ntail
    n2 = int(round(lam2 * (3 * body + cap * ntail) / (2 + lam2)))
    n2 = min(n2, body - 1)
    prof = [2] * n2 + [3] * (body - n2) + [cap] * ntail
    E = sum(prof)
    q, r = divmod(E, mb)
    row_cap = np.asarray([q + 1] * r + [q] * (mb - r), np.int64)
    rows_out, cols_out = [], []
    seen_pairs: set = set()
    order = sorted(range(nb), key=lambda j: -prof[j])
    for j in order:
        d = prof[j]
        for attempt in range(200):
            pri = row_cap + rng.random(mb)
            chosen = np.argsort(-pri)[:d]
            if d == 2:
                pair = tuple(sorted(int(x) for x in chosen))
                if pair in seen_pairs:
                    # Swap the second row for the next-best unseen one.
                    for alt in np.argsort(-pri)[2:]:
                        pair2 = tuple(sorted((int(chosen[0]), int(alt))))
                        if pair2 not in seen_pairs:
                            chosen = np.asarray([chosen[0], alt])
                            pair = pair2
                            break
                    else:
                        continue
                seen_pairs.add(pair)
            break
        row_cap[chosen] -= 1
        rows_out.extend(int(x) for x in chosen)
        cols_out.extend([j] * d)
    return np.asarray(rows_out, np.int64), np.asarray(cols_out, np.int64)


def optimize_base_graph(nb: int, mb: int, alpha: float = 0.8125,
                        bins: int = 256, max_iters: int = 300,
                        rounds: int = 300, seed: int = 11,
                        max_deg: Optional[int] = None,
                        init: Optional[tuple[np.ndarray, np.ndarray]] = None,
                        target: float = 3e-6,
                        num_punct: int = 0,
                        verbose: bool = False
                        ) -> tuple[np.ndarray, np.ndarray, float]:
    """Hill-climb the base GRAPH (not just the degree profile) for the best
    protograph-DE threshold.

    Moves (random, deterministic from ``seed``):
      * rewire (60%): move one edge to a different row (simplicity kept);
      * add    (20%): grow a column of degree < max_deg by one edge;
      * remove (20%): shrink a column of degree > 2 by one edge.
    Accept on strictly better threshold (one DE-grid step).  The search
    bracket is clipped around the incumbent for speed; the winner is
    re-measured on the full bracket before returning.

    Degree-2 mass is NOT capped at mb-1 (the round-1 profile rule): the QC
    lift makes degree-2 base cycles harmless when their circulant shift sums
    are odd (codes._fix_deg2_cycle_shifts), which unlocks the
    capacity-approaching λ2 regime.  The only structural rule kept here is
    that no two degree-2 columns may span the same row PAIR (a base length-4
    degree-2 cycle — kept out so composite cycles stay long).  DE's posterior
    gate rejects profiles past the stability limit on its own.

    Returns (edge_row, edge_col, threshold).
    """
    cap = min(mb, max_deg if max_deg is not None else 16)
    rng = np.random.default_rng(seed)
    # Punctured protograph nodes (AR4JA-style): by convention the LAST
    # num_punct columns; they carry private pad (channel = delta at 0) and
    # want high degree, so their cap is the full mb.
    punct = tuple(range(nb - num_punct, nb))
    if init is None:
        from qtpu_torch.ldpc.codes import irregular_profile_v2, make_irregular_code
        prof = [min(d, cap) for d in irregular_profile_v2(nb, mb)]
        # Punctured state nodes want high degree, but BP can only seed their
        # recovery through checks touching exactly ONE punctured column: a
        # single punctured column may span every row, while multiple must
        # leave singly-covered checks (degree ~mb/2 each; with full degree
        # every check would touch >= 2 unknowns and the threshold is 0).
        for j in punct:
            prof[j] = min(mb, 16) if num_punct == 1 else max(3, (mb + 1) // 2)
        c = make_irregular_code(nb * 8, prof, mb=mb, z=8, seed=int(seed))
        rows, cols = c.edge_row.astype(np.int64), c.edge_col.astype(np.int64)
    else:
        rows, cols = (np.asarray(init[0], np.int64),
                      np.asarray(init[1], np.int64))

    def col_deg(rows_, cols_, j):
        return int(np.sum(cols_ == j))

    def has_edge(rows_, cols_, i, j):
        return bool(np.any((rows_ == i) & (cols_ == j)))

    def deg2_pairs_ok(rows_, cols_):
        """No two degree-2 columns over the same row pair."""
        seen = set()
        for j in range(nb):
            es = np.flatnonzero(cols_ == j)
            if len(es) != 2:
                continue
            pair = tuple(sorted((int(rows_[es[0]]), int(rows_[es[1]]))))
            if pair in seen:
                return False
            seen.add(pair)
        return True

    def propose(rows_, cols_):
        rows_, cols_ = rows_.copy(), cols_.copy()
        kind = rng.choice(["rewire", "rewire", "rewire", "add", "remove"])
        if kind == "rewire":
            for _ in range(50):
                e = int(rng.integers(0, len(rows_)))
                j = int(cols_[e])
                r_new = int(rng.integers(0, mb))
                if r_new != int(rows_[e]) and not has_edge(rows_, cols_, r_new, j):
                    old = rows_[e]
                    rows_[e] = r_new
                    if deg2_pairs_ok(rows_, cols_):
                        return rows_, cols_
                    rows_[e] = old
            return None
        if kind == "add":
            for _ in range(50):
                j = int(rng.integers(0, nb))
                if col_deg(rows_, cols_, j) >= (mb if j in punct else cap):
                    continue
                r_new = int(rng.integers(0, mb))
                if not has_edge(rows_, cols_, r_new, j):
                    out = (np.append(rows_, r_new), np.append(cols_, j))
                    if deg2_pairs_ok(*out):
                        return out
            return None
        # remove
        for _ in range(50):
            e = int(rng.integers(0, len(rows_)))
            j = int(cols_[e])
            i = int(rows_[e])
            if col_deg(rows_, cols_, j) <= 2:
                continue
            if int(np.sum(rows_ == i)) <= 2:   # keep every check useful
                continue
            keep = np.ones(len(rows_), bool)
            keep[e] = False
            if deg2_pairs_ok(rows_[keep], cols_[keep]):
                return rows_[keep], cols_[keep]
        return None

    cur_t = proto_threshold(rows, cols, alpha, bins=bins,
                            max_iters=max_iters, target=target,
                            punct_cols=punct)
    if verbose:
        print(f"init nb={nb} mb={mb} p={num_punct}: threshold {cur_t:.4f} "
              f"E={len(rows)}", flush=True)
    for step in range(rounds):
        cand = propose(rows, cols)
        if cand is None:
            continue
        t = proto_threshold(cand[0], cand[1], alpha, bins=bins,
                            max_iters=max_iters, target=target,
                            punct_cols=punct,
                            lo=max(0.005, cur_t - 0.0075),
                            hi=min(0.14, cur_t + 0.0125))
        if t > cur_t + 1e-5:
            rows, cols = cand
            cur_t = t
            if verbose:
                print(f"  step {step}: threshold {cur_t:.4f} E={len(rows)}",
                      flush=True)
    cur_t = proto_threshold(rows, cols, alpha, bins=bins,
                            max_iters=max_iters, target=target,
                            punct_cols=punct)
    return rows, cols, cur_t


def proto_threshold(edge_row: np.ndarray, edge_col: np.ndarray,
                    alpha: float = 0.8125, lo: float = 0.005, hi: float = 0.14,
                    tol: float = 2.5e-4, bins: int = 256,
                    max_iters: int = 300, target: float = 3e-6,
                    punct_cols: tuple = ()) -> float:
    """Largest BSC error rate where protograph DE converges (bisection)."""
    def run(q):
        return ProtographDE(edge_row, edge_col, q, alpha, bins,
                            punct_cols=punct_cols).run(max_iters, target)[0]
    if run(hi):
        return hi
    if not run(lo):
        return 0.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if run(mid):
            lo = mid
        else:
            hi = mid
    return lo
