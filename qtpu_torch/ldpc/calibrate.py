"""Rate-ladder calibration: measured per-rung QBER ceilings.

Counterpart of ``qtpu/ldpc/calibrate.py``: for each ladder rung, measure
the frame-error rate on simulated BSC batches and record the largest QBER
whose FER stays under a target; ``RateLadder.select`` then picks the
highest rung whose ceiling admits the estimate.  The measuring tools decode
through the sessions' decoder (``qtpu_torch.ldpc.decode.make_batch_decoder``):
the Hopper kernels on a CUDA device, their plain PyTorch versions on the
CPU (sum-product, which had no TPU kernel, is plain PyTorch on both); the
error flags are reduced on the device, so only the FER and the mean
iteration count cross to the host.

Run ``python -m qtpu_torch.ldpc.calibrate [--device cuda] [spec ...]`` to
(re)produce the tables; the frozen results below (copies of the
reference's, so ``make_rate_ladder`` attaches the same ceilings in both
packages) are properties of the codes and the decoder's algorithm, not of
the device that measured them.
"""

from __future__ import annotations

import numpy as np
import torch

from qtpu_torch.devices import DEFAULT_DEVICE, resolve_device
from qtpu_torch.ldpc.codes import RateLadder, RateStep, make_rate_ladder
from qtpu_torch.ldpc.decode import BIG_LLR, make_batch_decoder
from qtpu_torch.ldpc.encode import make_batch_encoder

__all__ = ["measure_fer", "fer_inputs", "calibrate_ladder", "calibrate_short",
           "ceiling_bisect", "SHORT_FRACS", "DEFAULT_CALIBRATION",
           "DEFAULT_SHORT_CALIBRATION", "FINE_CALIBRATION"]


def _positions(step: RateStep):
    z, nb = step.code.z, step.code.nb
    special = set(step.punct_cols) | set(step.short_cols)
    def expand(cs):
        cs = np.asarray(sorted(cs), np.int32)
        if cs.size == 0:
            return np.zeros(0, np.int64)
        return (cs[:, None] * z + np.arange(z)[None, :]).reshape(-1)
    return (expand([c for c in range(nb) if c not in special]),
            expand(step.punct_cols), expand(step.short_cols))


def fer_inputs(step: RateStep, qber: float, blocks: int = 256,
               seed: int = 0, extra_short_bits: int = 0,
               device=DEFAULT_DEVICE, _cache: dict = {}):
    """``measure_fer``'s batch on ``device``, drawn from ``seed`` with
    numpy as the reference draws it: (codewords (B, n) uint8, llr (B, n)
    float32, syndromes (B, m) uint8, the payload positions that count).
    Payload LLRs come from a BSC(qber), punctured columns are 0, shortened
    columns and ``extra_short_bits`` payload positions +-BIG."""
    device = resolve_device(device)
    code = step.code
    if id(code) not in _cache:
        _cache[id(code)] = make_batch_encoder(code)
    pay, pun, sho = _positions(step)
    rng = np.random.default_rng(seed)
    if extra_short_bits:
        sel = rng.choice(pay.size, size=extra_short_bits, replace=False)
        mask = np.ones(pay.size, bool)
        mask[sel] = False
        xsho, pay = pay[~mask], pay[mask]
        sho = np.concatenate([sho, xsho])
    B, n = blocks, code.n
    x = rng.integers(0, 2, (B, n)).astype(np.uint8)       # incl punct+short fill
    x_dev = torch.from_numpy(x).to(device)
    syn = _cache[id(code)](x_dev).contiguous()
    noise = (rng.random((B, pay.size)) < qber).astype(np.uint8)
    y_pay = x[:, pay] ^ noise
    mag = np.float32(np.log((1.0 - qber) / qber))
    llr = np.zeros((B, n), np.float32)
    llr[:, pay] = np.where(y_pay.astype(bool), -mag, mag)
    if sho.size:
        llr[:, sho] = np.where(x[:, sho].astype(bool), -BIG_LLR, BIG_LLR)
    return x_dev, torch.from_numpy(llr).to(device), syn, pay


def measure_fer(step: RateStep, qber: float, blocks: int = 256, seed: int = 0,
                max_iters: int = 60, alg: str = "minsum",
                extra_short_bits: int = 0, alpha: float = 0.8125,
                device=DEFAULT_DEVICE,
                _cache: dict = {}) -> tuple[float, float]:
    """Simulate `blocks` reconciliations at the given true QBER on
    ``device``.

    Returns (frame error rate, mean BP iterations).  A frame errs if the
    decoded payload differs from Alice's payload anywhere (verification-hash
    failures in the real pipeline).  The inputs are the reference's
    (``fer_inputs``), drawn from ``seed`` with numpy, so both packages
    measure the same batch.

    extra_short_bits: payload positions additionally pinned to known values
    (LLR ±BIG) — the fine rate-adaptation mechanism; errors are counted on
    the remaining (true payload) positions only.
    """
    device = resolve_device(device)
    ck = (id(step.code), max_iters, alg, alpha)
    if ck not in _cache:
        _cache[ck] = make_batch_decoder(step.code, max_iters, alg, alpha)
    x_dev, llr, syn, pay = fer_inputs(step, qber, blocks, seed,
                                      extra_short_bits, device)
    res = _cache[ck](llr, syn)
    pay_dev = torch.from_numpy(pay).to(device)
    errs = (res.bits[:, pay_dev] != x_dev[:, pay_dev]).any(dim=1)
    stats = torch.stack([errs.to(torch.float64).mean(),
                         res.iterations.to(torch.float64).mean()]).cpu()
    return float(stats[0]), float(stats[1])


def calibrate_ladder(ladder: RateLadder, fer_target: float = 0.05,
                     blocks: int = 256, qber_grid=None,
                     max_iters: int = 60, alg: str = "minsum",
                     verbose: bool = False,
                     device=DEFAULT_DEVICE) -> tuple[float, ...]:
    """Largest grid QBER per rung with FER <= fer_target (0.0 if none)."""
    if qber_grid is None:
        qber_grid = [x / 400 for x in range(1, 45)]  # 0.25% .. 11%
    out = []
    for step in ladder.steps:
        best = 0.0
        for q in qber_grid:
            fer, iters = measure_fer(step, q, blocks, seed=int(q * 1e6),
                                     max_iters=max_iters, alg=alg,
                                     device=device)
            if fer <= fer_target:
                best = q
            else:
                if verbose:
                    print(f"  {step.name}: q={q:.4f} FER={fer:.3f} iters={iters:.1f} -> ceiling {best:.4f}")
                break
        if verbose:
            print(f"{step.name}: max_qber={best:.4f}")
        out.append(best)
    return tuple(out)


def ceiling_bisect(step: RateStep, lo: float, hi: float,
                   fer_target: float = 0.05, blocks: int = 256,
                   tol: float = 5e-4, max_iters: int = 60,
                   alg: str = "layered", extra_short_bits: int = 0,
                   seed_base: int = 0, device=DEFAULT_DEVICE) -> float:
    """Largest QBER with FER <= target, by bisection to ``tol``.  Two
    measurements at the same q use different seeds, so a noisy FER near the
    waterfall bisects to the conservative side on average."""
    def fer(q: float) -> float:
        f, _ = measure_fer(step, q, blocks, seed=seed_base + int(q * 4e6),
                           max_iters=max_iters, alg=alg,
                           extra_short_bits=extra_short_bits, device=device)
        return f
    if fer(lo) > fer_target:
        return 0.0
    if fer(hi) <= fer_target:
        return hi
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if fer(mid) <= fer_target:
            lo = mid
        else:
            hi = mid
    return round(lo, 5)


SHORT_FRACS = (0.0, 0.05, 0.10, 0.15, 0.20, 0.25)


def calibrate_short(ladder: RateLadder, fracs=SHORT_FRACS,
                    fer_target: float = 0.05, blocks: int = 256,
                    qber_grid=None, max_iters: int = 60,
                    alg: str = "minsum", verbose: bool = False,
                    device=DEFAULT_DEVICE
                    ) -> tuple[tuple[float, ...], tuple[tuple[float, ...], ...]]:
    """Ceiling-vs-extra-shortening curves for fine rate adaptation.

    For each rung and each extra-shortening fraction (of n), the largest grid
    QBER with FER <= fer_target.  Returns (fracs, per-rung ceiling tuples) in
    the ``RateLadder.short_grid/short_ceilings`` format.  Curves are made
    monotone non-decreasing (shortening only ever strengthens the code;
    measurement noise is clamped the safe way, downward).
    """
    if qber_grid is None:
        qber_grid = [x / 400 for x in range(1, 61)]  # 0.25% .. 15%
    n = ladder.steps[0].code.n
    out = []
    for step in ladder.steps:
        curve = []
        start = 0  # ceilings are monotone: resume the grid walk where the
        for frac in fracs:   # previous fraction's ceiling stopped
            s = int(frac * n)
            best = qber_grid[start - 1] if start else 0.0
            for gi in range(start, len(qber_grid)):
                q = qber_grid[gi]
                fer, _ = measure_fer(step, q, blocks, seed=int(q * 1e6) + s,
                                     max_iters=max_iters, alg=alg,
                                     extra_short_bits=s, device=device)
                if fer <= fer_target:
                    best, start = q, gi + 1
                else:
                    break
            curve.append(best)
            if verbose:
                print(f"  {step.name} short={frac:.2f}: ceiling {best:.4f}")
        # Enforce monotone non-decreasing the safe way.
        for k in range(1, len(curve)):
            curve[k] = max(curve[k], curve[k - 1])
        out.append(tuple(curve))
    return tuple(fracs), tuple(out)


# Measured with blocks=256, fer_target=0.05, max_iters=60, grid step 0.25% —
# regenerate with `python -m qtpu.ldpc.calibrate`.
# Key: (n, dv, alg, family) -> per-rung max QBER for the default target_rates.
# (TPU v5 lite runs, 2026-08-17; minsum = normalized alpha 13/16.)
DEFAULT_CALIBRATION: dict[tuple[int, int, str, str], tuple[float, ...]] = {
    (1024, 3, "minsum", "regular"): (0.065, 0.045, 0.0225, 0.0125, 0.005),
    (4096, 3, "minsum", "regular"): (0.0725, 0.0525, 0.0275, 0.015, 0.0075),
    # Sum-product matches normalized min-sum on these codes (alpha=13/16 is
    # near-optimal here) — min-sum stays the production path.
    (1024, 3, "sumprod", "regular"): (0.065, 0.045, 0.0225, 0.01, 0.005),
    (4096, 3, "sumprod", "regular"): (0.0725, 0.0525, 0.03, 0.015, 0.0075),
    # Irregular mothers (irregular_profile): better at low rates, worse at
    # rate 0.8 — hence the "mixed" default family below.
    (1024, 3, "minsum", "irregular"): (0.07, 0.05, 0.0225, 0.01, 0.005),
    (4096, 3, "minsum", "irregular"): (0.0775, 0.055, 0.0275, 0.0125, 0.0075),
    # Mixed = irregular rungs 0-1 + regular rungs 2-4 (per-rung winners).
    (1024, 3, "minsum", "mixed"): (0.07, 0.05, 0.0225, 0.0125, 0.005),
    (4096, 3, "minsum", "mixed"): (0.0775, 0.055, 0.0275, 0.015, 0.0075),
    # Layered (production schedule): slightly better thresholds than
    # flooding on top of ~2x fewer sweeps.
    (1024, 3, "layered", "mixed"): (0.07, 0.05, 0.0225, 0.0125, 0.005),
    (4096, 3, "layered", "mixed"): (0.08, 0.0575, 0.03, 0.015, 0.0075),
    # n=16384: ~+0.25% per rung over n=4096 (finite-length gain).
    (16384, 3, "layered", "mixed"): (0.0825, 0.06, 0.0325, 0.0175, 0.01),
    (16384, 3, "layered", "irregular"): (0.0825, 0.06, 0.03, 0.015, 0.01),
    (16384, 3, "layered", "regular"): (0.075, 0.055, 0.0325, 0.0175, 0.01),
    # Native-rate irregular mothers (no puncturing): the 0.688 rung beats the
    # punctured 0.7 rung by +0.5% QBER at n=16384.
    (4096, 3, "layered", "native"): (0.0775, 0.0525, 0.0325, 0.0125, 0.005),
    # Several rung counts for one configuration live in a {num_rungs: tuple}
    # dict (the 5-rung default ladder and the 7-rung production ladder of
    # benchmarks/calibrate_production.py).
    (16384, 3, "layered", "native"): {
        5: (0.0825, 0.0575, 0.0375, 0.015, 0.0075),
        7: (0.0825, 0.0575, 0.0425, 0.03, 0.02, 0.01, 0.0075),
    },
    # native2 = irregular_profile_v2 mothers (benchmarks/calibrate_native2.py,
    # TPU v5 lite 2026-08-19): beats native by +0.25-0.5% QBER on rungs 1-5
    # (the 1-5% operating range); only the rate-0.5 rung regresses (7.75% vs
    # 8.25%), which bounds the usable-QBER tail, not the operating point.
    (16384, 3, "layered", "native2"): {
        7: (0.0775, 0.0625, 0.0475, 0.0325, 0.02, 0.0125, 0.0075),
    },
    # native3 = DE-designed punctured protographs (qtpu.ldpc.designed,
    # round-2): 10 rungs at rate_eff 0.533-0.903.  At matched rates the
    # punctured rungs beat native2 decisively where it counts: rate 0.742
    # decodes at 3.0% where native2's 0.719 stopped at 3.25% (same ceiling,
    # +2.3% rate), rate 0.767 reaches 2.75%, and rate 0.533 reaches 8.0%
    # (vs 7.75% at rate 0.5).  (TPU v5 lite 2026-08-19, blocks=256,
    # FER<=5%, max_iters=60.)
    (16384, 3, "layered", "native3"): (
        0.08, 0.0525, 0.04, 0.0325, 0.03, 0.0275, 0.0275, 0.015, 0.01,
        0.005),
}

# Fine rate adaptation: per-rung QBER ceiling at each extra-shortening
# fraction of n (qtpu.ldpc.codes.RateLadder.select_fine).  Measured with
# blocks=256, fer_target=0.05 — regenerate with
# ``python -m qtpu.ldpc.calibrate short:<alg>:<family>``.
# Key: (n, dv, alg, family) -> (fracs, per-rung ceiling tuples).
DEFAULT_SHORT_CALIBRATION: dict[
    tuple[int, int, str, str],
    tuple[tuple[float, ...], tuple[tuple[float, ...], ...]]] = {
    # TPU v5 lite runs, 2026-08-18.
    (4096, 3, "layered", "mixed"): (
        (0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
        ((0.08, 0.085, 0.0925, 0.10, 0.11, 0.1225),
         (0.0575, 0.0625, 0.0675, 0.075, 0.085, 0.0925),
         (0.03, 0.0325, 0.035, 0.0375, 0.0425, 0.0475),
         (0.015, 0.0175, 0.0175, 0.02, 0.0225, 0.025),
         (0.0075, 0.0075, 0.01, 0.01, 0.0125, 0.0125))),
    (16384, 3, "layered", "mixed"): (
        (0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
        ((0.0825, 0.09, 0.0975, 0.105, 0.1175, 0.13),
         (0.06, 0.0675, 0.0725, 0.08, 0.09, 0.10),
         (0.0325, 0.035, 0.0375, 0.0425, 0.0475, 0.0525),
         (0.0175, 0.0175, 0.02, 0.0225, 0.025, 0.0275),
         (0.01, 0.01, 0.01, 0.0125, 0.0125, 0.015))),
    (4096, 3, "layered", "native"): (
        (0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
        ((0.0775, 0.085, 0.09, 0.1025, 0.1125, 0.125),
         (0.0525, 0.0575, 0.0625, 0.0675, 0.075, 0.085),
         (0.0325, 0.0375, 0.04, 0.0425, 0.0475, 0.0525),
         (0.0125, 0.0125, 0.015, 0.0175, 0.02, 0.02),
         (0.005, 0.005, 0.0075, 0.0075, 0.0075, 0.01))),
    (16384, 3, "layered", "native"): {
        5: ((0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
            ((0.0825, 0.0875, 0.0975, 0.1075, 0.1175, 0.13),
             (0.0575, 0.06, 0.0675, 0.0725, 0.08, 0.09),
             (0.0375, 0.04, 0.0425, 0.0475, 0.0525, 0.0575),
             (0.015, 0.0175, 0.0175, 0.02, 0.02, 0.025),
             (0.0075, 0.0075, 0.0075, 0.01, 0.01, 0.0125))),
        # 7-rung production ladder (benchmarks/calibrate_production.py).
        7: ((0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
            ((0.0825, 0.0875, 0.0975, 0.1075, 0.1175, 0.13),
             (0.0575, 0.06, 0.0675, 0.0725, 0.08, 0.09),
             (0.0425, 0.0475, 0.05, 0.055, 0.06, 0.0675),
             (0.03, 0.0325, 0.035, 0.04, 0.0425, 0.0475),
             (0.02, 0.0225, 0.0225, 0.025, 0.0275, 0.0325),
             (0.01, 0.0125, 0.0125, 0.015, 0.015, 0.0175),
             (0.0075, 0.0075, 0.0075, 0.01, 0.01, 0.0125))),
    },
    # native2 7-rung production ladder (benchmarks/calibrate_native2.py,
    # TPU v5 lite 2026-08-19).
    (16384, 3, "layered", "native2"): {
        7: ((0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
            ((0.0775, 0.0825, 0.0975, 0.11, 0.1175, 0.1375),
             (0.0625, 0.065, 0.0725, 0.0775, 0.0875, 0.095),
             (0.0475, 0.05, 0.055, 0.06, 0.065, 0.0725),
             (0.0325, 0.035, 0.04, 0.0425, 0.0475, 0.05),
             (0.02, 0.0225, 0.025, 0.0275, 0.03, 0.0325),
             (0.0125, 0.0125, 0.015, 0.015, 0.0175, 0.0175),
             (0.0075, 0.0075, 0.01, 0.01, 0.0125, 0.0125))),
    },
    # native3 DE-designed ladder (TPU v5 lite 2026-08-19, this round).
    (16384, 3, "layered", "native3"): (
        (0.0, 0.05, 0.10, 0.15, 0.20, 0.25),
        ((0.08, 0.0875, 0.095, 0.105, 0.115, 0.1275),
         (0.0525, 0.0575, 0.0625, 0.07, 0.0775, 0.085),
         (0.04, 0.0425, 0.0475, 0.0525, 0.0575, 0.0625),
         (0.0325, 0.0375, 0.04, 0.0425, 0.0475, 0.0525),
         (0.03, 0.035, 0.0375, 0.04, 0.0425, 0.0475),
         (0.0275, 0.03, 0.0325, 0.035, 0.0375, 0.0425),
         (0.0275, 0.03, 0.0325, 0.035, 0.0375, 0.0425),
         (0.015, 0.015, 0.0175, 0.0175, 0.02, 0.0225),
         (0.01, 0.01, 0.0125, 0.0125, 0.015, 0.015),
         (0.005, 0.0075, 0.0075, 0.0075, 0.0075, 0.01))),
}


# Bisection-measured calibration at 0.05% resolution (ceiling_bisect;
# benchmarks/calibrate_fine.py).  Wins over the grid tables above; the
# resolution travels as calib_step so rate selection's guard matches it.
# Key: (n, dv, alg, family) -> {"max_qber", "short_grid", "short_ceilings",
# "calib_step"}.
FINE_CALIBRATION: dict[tuple[int, int, str, str], dict] = {
    # native3 DE-designed ladder at n=65536 (TPU v5 lite 2026-08-19,
    # blocks=192, FER<=5%, layered, max_iters=60): ceilings improve on the
    # n=16384 grid values by 0.2-0.6% at the operating rungs (rate 0.742
    # reaches 3.38%, 0.767 reaches 2.94%, 0.871 reaches 1.19%) — exactly the
    # sub-grid gains the 0.25% grid quantized away.
    (65536, 3, "layered", "native3"): {
        "max_qber": (0.08288, 0.05819, 0.04319, 0.03381, 0.03381, 0.02975,
                     0.02944, 0.01663, 0.01194, 0.00781),
        "short_grid": (0.0, 0.05, 0.1, 0.15, 0.2, 0.25),
        "short_ceilings": (
            (0.08288, 0.09008, 0.0986, 0.10712, 0.11859, 0.13146),
            (0.05819, 0.0631, 0.06833, 0.07422, 0.08077, 0.08961),
            (0.04319, 0.04646, 0.05038, 0.05463, 0.05986, 0.06608),
            (0.03381, 0.03642, 0.04001, 0.04557, 0.04884, 0.0544),
            (0.03381, 0.03609, 0.03936, 0.0423, 0.04655, 0.0508),
            (0.02975, 0.03105, 0.03432, 0.03759, 0.04118, 0.0451),
            (0.02944, 0.03172, 0.034, 0.03661, 0.0402, 0.04478),
            (0.01663, 0.0176, 0.01922, 0.02085, 0.02247, 0.02508),
            (0.01194, 0.01258, 0.01388, 0.01485, 0.01615, 0.01777),
            (0.00781, 0.00812, 0.00876, 0.00973, 0.0107, 0.01167)),
        "calib_step": 0.0005,
    },
    # native3 ladder at n=131072 (z=4096 lifts; TPU v5 lite 2026-08-21,
    # blocks=96, rungs 3-6 measured live, others borrowed from n=65536 —
    # borrowed smaller-n ceilings are conservative for these ensembles).
    # MEASURED NEGATIVE RESULT (round 5): the z=4096 lifts of the
    # UNPUNCTURED protographs (rungs 3 = mb9p0 and 5 = mb8p0) show an FER
    # floor of ~1-3% from small trapping sets (5-6 residual bits after 60
    # sweeps; reproduced bit-exactly on both the Pallas and the XLA
    # decoders, so it is the code, not a kernel) — their ceilings collapse
    # below the bisect bracket and are recorded as measured (0.0 = FER
    # floor above target even at the bracket floor).  Rung 6's ceiling
    # also drops 2.76% vs 2.94% at n=65536.  Net effect: n=131072 offers
    # NO efficiency gain over n=65536 on this ladder (the rate-0.767 rung
    # needs ~5% shortening at 3% QBER, erasing its rate advantage), and
    # production stays at n=65536.  A girth/ACE-aware shift assignment for
    # large z is the structural fix (backlog).  Selection with this table
    # is safe: the floored rungs' honest 0.0 ceilings simply exclude them.
    (131072, 3, "layered", "native3"): {
        "max_qber": (0.08288, 0.05819, 0.04319, 0.0, 0.03387, 0.0,
                     0.02763, 0.01663, 0.01194, 0.00781),
        "short_grid": (0.0, 0.05, 0.1, 0.15, 0.2, 0.25),
        "short_ceilings": (
            (0.08288, 0.09008, 0.0986, 0.10712, 0.11859, 0.13146),
            (0.05819, 0.0631, 0.06833, 0.07422, 0.08077, 0.08961),
            (0.04319, 0.04646, 0.05038, 0.05463, 0.05986, 0.06608),
            (0.0, 0.0, 0.02, 0.03936, 0.04886, 0.05377),
            (0.03387, 0.03681, 0.03942, 0.04269, 0.04628, 0.05119),
            (0.0, 0.02, 0.03332, 0.03757, 0.04116, 0.04541),
            (0.02763, 0.03188, 0.03449, 0.03743, 0.0407, 0.04495),
            (0.01663, 0.0176, 0.01922, 0.02085, 0.02247, 0.02508),
            (0.01194, 0.01258, 0.01388, 0.01485, 0.01615, 0.01777),
            (0.00781, 0.00812, 0.00876, 0.00973, 0.0107, 0.01167)),
        "calib_step": 0.0005,
    },
}


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(prog="qtpu_torch.ldpc.calibrate")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    p.add_argument("specs", nargs="*", default=["minsum:regular"],
                   help="alg:family[:n...] or short:alg:family[:n...]")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate: CUDA is not available (pass --device cpu "
                         "to measure on the CPU)")
    for spec in a.specs:
        parts = spec.split(":")
        if parts[0] == "short":
            alg = parts[1] if len(parts) > 1 else "layered"
            family = parts[2] if len(parts) > 2 else "mixed"
            ns = [int(x) for x in parts[3:]] or [4096]
            for n in ns:
                ladder = make_rate_ladder(n, family=family, alg=alg)
                print(f"short-calibration n={n} alg={alg} family={family}:")
                fracs, curves = calibrate_short(ladder, verbose=True, alg=alg,
                                                device=a.device)
                print(f"  ({n}, 3, {alg!r}, {family!r}): ({fracs}, {curves}),")
            continue
        alg = parts[0]
        family = parts[1] if len(parts) > 1 else "regular"
        ns = [int(x) for x in parts[2:]] or [1024, 4096]
        for n in ns:
            ladder = make_rate_ladder(n, family=family, alg=alg)
            print(f"n={n} alg={alg} family={family}:")
            ceilings = calibrate_ladder(ladder, verbose=True, alg=alg,
                                        device=a.device)
            print(f"  ({n}, 3, {alg!r}, {family!r}): {ceilings},")


if __name__ == "__main__":
    main()
