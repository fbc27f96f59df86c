"""Frozen rate-ladder calibration tables (measured per-rung QBER ceilings).

The three tables of ``qtpu/ldpc/calibrate.py``, copied verbatim so that
``make_rate_ladder`` attaches the same ceilings in both packages.  The
measuring tools (``measure_fer``, ``calibrate_ladder``, ...) are not ported
yet; the ceilings are properties of the codes and the decoder's algorithm,
not of the device that measured them.
"""

from __future__ import annotations

__all__ = ["DEFAULT_CALIBRATION", "DEFAULT_SHORT_CALIBRATION",
           "FINE_CALIBRATION"]


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

