"""Quasi-cyclic LDPC code construction and the rate-adaptation ladder.

Reference capability: parity-check-matrix construction/loading and the
puncture/shorten rate ladder of the ``-ldpc`` fork (SURVEY.md §3 #13, §8 step 4;
BASELINE.json configs 1 and 3).

TPU-first design choice (NOT how a CPU C implementation would store H):
the code is **quasi-cyclic (QC)** — H is an ``mb x nb`` grid of ``z x z``
circulant permutation blocks.  Check node ``(i, zc)`` touches variable
``(j, (zc + shift) % z)`` for every base-graph edge ``(i, j, shift)``.  The
payoff is that converting a belief-propagation message tensor between
check-major and variable-major edge order — the only "irregular" data movement
in BP — becomes a circular roll along the ``z`` axis:

    var_view[e]   = roll(chk_view[e], +shift_e)   # axis = z
    chk_view[e]   = roll(var_view[e], -shift_e)

Rolls are static-shape, gather-free, VPU-friendly, and supported directly in
Pallas (``pltpu.roll``).  This is the same reason 5G-NR and 802.11 LDPC codes
are QC — the structure is hardware-native, and a TPU is hardware.

All arrays describing a code are tiny (base graph has ~50 edges); per-block
work tensors are shaped ``(num_base_edges, z, batch)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "QCCode",
    "make_regular_code",
    "make_irregular_code",
    "make_qc_from_base",
    "RateLadder",
    "RateStep",
    "make_rate_ladder",
    "PRODUCTION_RATES",
]

# The 7-rung production ladder targets (family="native", nb=32: mb = 16, 13,
# 11, 9, 7, 5, 4) — calibrated at n=16384 in benchmarks/calibrate_production.
PRODUCTION_RATES = (0.5, 0.59375, 0.65625, 0.71875, 0.78125, 0.84375, 0.875)


@dataclasses.dataclass(frozen=True)
class QCCode:
    """A quasi-cyclic LDPC code described by its base graph.

    Attributes:
      z: circulant (lifting) size.
      mb, nb: base-graph rows (checks) and columns (variables).
      edge_row: (E,) int32 — base row index of each base edge.
      edge_col: (E,) int32 — base column index of each base edge.
      edge_shift: (E,) int32 — circulant shift of each base edge, in [0, z).
      row_edges: (mb, dc_max) int32 — edge ids per base row, padded with -1.
      col_edges: (nb, dv_max) int32 — edge ids per base column, padded with -1.
    """

    z: int
    mb: int
    nb: int
    edge_row: np.ndarray
    edge_col: np.ndarray
    edge_shift: np.ndarray
    row_edges: np.ndarray
    col_edges: np.ndarray

    @property
    def n(self) -> int:
        """Code length in bits."""
        return self.nb * self.z

    @property
    def m(self) -> int:
        """Number of parity checks (syndrome length in bits)."""
        return self.mb * self.z

    @property
    def num_edges(self) -> int:
        return int(self.edge_row.shape[0])

    @property
    def dc_max(self) -> int:
        return int(self.row_edges.shape[1])

    @property
    def dv_max(self) -> int:
        return int(self.col_edges.shape[1])

    @property
    def rate(self) -> float:
        return 1.0 - self.m / self.n

    def to_dense(self) -> np.ndarray:
        """Materialize H as a dense uint8 array (tests / golden model only)."""
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        zc = np.arange(self.z)
        for e in range(self.num_edges):
            i, j, s = self.edge_row[e], self.edge_col[e], self.edge_shift[e]
            rows = i * self.z + zc
            cols = j * self.z + (zc + s) % self.z
            h[rows, cols] ^= 1
        return h

    def validate(self) -> None:
        e = self.num_edges
        assert self.edge_row.shape == (e,)
        assert self.edge_col.shape == (e,)
        assert self.edge_shift.shape == (e,)
        assert self.edge_row.min() >= 0 and self.edge_row.max() < self.mb
        assert self.edge_col.min() >= 0 and self.edge_col.max() < self.nb
        assert self.edge_shift.min() >= 0 and self.edge_shift.max() < self.z
        # Groupings must partition the edge set.
        got = sorted(x for x in self.row_edges.ravel() if x >= 0)
        assert got == list(range(e)), "row_edges must cover every edge once"
        got = sorted(x for x in self.col_edges.ravel() if x >= 0)
        assert got == list(range(e)), "col_edges must cover every edge once"


def _group_edges(keys: np.ndarray, num_groups: int) -> np.ndarray:
    """Group edge ids by key into a (num_groups, max_deg) array padded with -1."""
    buckets: list[list[int]] = [[] for _ in range(num_groups)]
    for e, k in enumerate(keys):
        buckets[int(k)].append(e)
    deg = max(len(b) for b in buckets)
    out = np.full((num_groups, deg), -1, dtype=np.int32)
    for g, b in enumerate(buckets):
        out[g, : len(b)] = b
    return out


def _base_graph_regular(mb: int, nb: int, dv: int, dc: int, rng: np.random.Generator,
                        max_tries: int = 200) -> tuple[np.ndarray, np.ndarray]:
    """Random (dv, dc)-biregular bipartite base graph without parallel edges.

    Permutation-construction: the multiset {col j repeated dv times} is shuffled
    and dealt into rows (dc slots each); resample on parallel edges.
    """
    assert nb * dv == mb * dc, "degree constraint nb*dv == mb*dc violated"
    stubs = np.repeat(np.arange(nb, dtype=np.int32), dv)
    rows = np.repeat(np.arange(mb, dtype=np.int32), dc)
    rng.shuffle(stubs)
    # Repair parallel edges by swapping conflicting stubs between rows.
    for _ in range(max_tries * 100):
        seen: dict[tuple[int, int], int] = {}
        conflict = -1
        for idx in range(len(rows)):
            key = (int(rows[idx]), int(stubs[idx]))
            if key in seen:
                conflict = idx
                break
            seen[key] = idx
        if conflict < 0:
            return rows.copy(), stubs.copy()
        # Swap the conflicting stub with a random other stub; accept any swap
        # that removes this conflict without re-checking globally (the outer
        # loop re-verifies) — random swaps converge quickly.
        other = int(rng.integers(0, len(rows)))
        if int(rows[other]) != int(rows[conflict]):
            stubs[conflict], stubs[other] = stubs[other], stubs[conflict]
    raise RuntimeError("could not construct a simple biregular base graph")


def _break_base_4cycles(edge_row: np.ndarray, edge_col: np.ndarray,
                        shifts: np.ndarray, z: int, rng: np.random.Generator,
                        passes: int = 30) -> np.ndarray:
    """Resample circulant shifts until no lifted 4-cycles remain (best effort).

    A 4-cycle survives lifting through base entries (i1,j1),(i1,j2),(i2,j2),
    (i2,j1) iff s(i1,j1) - s(i1,j2) + s(i2,j2) - s(i2,j1) == 0 (mod z).
    """
    e = len(shifts)
    shifts = shifts.copy()
    # Precompute, for every pair of edges sharing a column, the partner data.
    by_col: dict[int, list[int]] = {}
    for idx in range(e):
        by_col.setdefault(int(edge_col[idx]), []).append(idx)
    for _ in range(passes):
        bad = []
        # Any two edges sharing a column give a (row pair); two column-sharing
        # edge pairs with the same row pair form a potential 4-cycle.
        pair_map: dict[tuple[int, int, int, int], int] = {}
        found = False
        for _, edges in by_col.items():
            for a_i in range(len(edges)):
                for b_i in range(a_i + 1, len(edges)):
                    ea, eb = edges[a_i], edges[b_i]
                    r1, r2 = int(edge_row[ea]), int(edge_row[eb])
                    if r1 == r2:
                        continue
                    if r1 > r2:
                        ea, eb = eb, ea
                        r1, r2 = r2, r1
                    delta = (int(shifts[ea]) - int(shifts[eb])) % z
                    key = (r1, r2, delta, 0)
                    if key in pair_map:
                        bad.append(ea)
                        found = True
                    else:
                        pair_map[key] = ea
        if not found:
            return shifts
        for ea in bad:
            shifts[ea] = rng.integers(0, z)
    return shifts  # best effort; girth-6 not guaranteed for dense base graphs


def make_regular_code(n: int, dv: int = 3, dc: int = 6, z: Optional[int] = None,
                      seed: int = 0x51C0DE) -> QCCode:
    """Construct a (dv, dc)-regular QC-LDPC code of length ``n``.

    Defaults give the BASELINE.json config-1 code: (3,6)-regular rate-1/2,
    n=4096 → base graph 8x16 lifted by z=256.

    Args:
      n: code length in bits; must be divisible by the chosen z and nb.
      dv: variable (column) degree.
      dc: check (row) degree.
      z: circulant size; default picks the largest power-of-two z such that
         nb = n/z gives a constructible base graph (nb >= 2*dc typically).
      seed: deterministic construction seed — both parties must build the
        identical code, so this seed is part of the protocol configuration.
    """
    if z is None:
        # Prefer large z (more structure, smaller base graph) subject to the
        # base graph remaining simple: need nb >= dc (ideally > dc).
        z = 1
        for cand in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
            if n % cand == 0 and (n // cand) >= 2 * dc and ((n // cand) * dv) % dc == 0:
                z = cand
                break
    assert n % z == 0, f"n={n} not divisible by z={z}"
    nb = n // z
    assert (nb * dv) % dc == 0, "nb*dv must be divisible by dc"
    mb = nb * dv // dc
    rng = np.random.default_rng(seed)
    edge_row, edge_col = _base_graph_regular(mb, nb, dv, dc, rng)
    shifts = rng.integers(0, z, size=edge_row.shape[0]).astype(np.int32)
    shifts = _break_base_4cycles(edge_row, edge_col, shifts, z, rng)
    code = QCCode(
        z=z, mb=mb, nb=nb,
        edge_row=edge_row.astype(np.int32),
        edge_col=edge_col.astype(np.int32),
        edge_shift=shifts.astype(np.int32),
        row_edges=_group_edges(edge_row, mb),
        col_edges=_group_edges(edge_col, nb),
    )
    code.validate()
    return code


def _base_graph_greedy(col_degrees: Sequence[int], row_degrees: Sequence[int],
                       mb: int, rng: np.random.Generator
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Simple-by-construction bipartite base graph for dense profiles.

    Columns are placed in decreasing-degree order; each column takes its
    ``d`` DISTINCT rows from the rows with the most remaining capacity
    (random tie-break), which both avoids parallel edges and keeps row
    degrees balanced.  Requires max(col_degrees) <= mb.
    """
    if max(col_degrees) > mb:
        raise ValueError(f"column degree {max(col_degrees)} exceeds mb={mb}")
    cap = np.asarray(row_degrees, np.int64).copy()
    order = sorted(range(len(col_degrees)),
                   key=lambda j: -int(col_degrees[j]))
    rows_out: list[int] = []
    cols_out: list[int] = []
    for j in order:
        d = int(col_degrees[j])
        pri = cap.astype(np.float64) + rng.random(mb)  # random tie-break
        chosen = np.argsort(-pri)[:d]
        if np.any(cap[chosen] <= 0):
            # Capacity exhausted on some row: take the d highest-capacity
            # rows anyway (overflows by at most 1 — row balance is a
            # heuristic, simplicity is the invariant).
            pass
        cap[chosen] -= 1
        rows_out.extend(int(r) for r in chosen)
        cols_out.extend([j] * d)
    return (np.asarray(rows_out, np.int32), np.asarray(cols_out, np.int32))


def make_irregular_code(n: int, col_degrees: Sequence[int], mb: int,
                        z: Optional[int] = None,
                        seed: int = 0x1BBE) -> QCCode:
    """Construct an irregular QC-LDPC code from per-base-column degrees.

    Irregular degree distributions close much of the regular-code gap to
    capacity (Richardson–Urbanke); at base-graph granularity the column
    degree sequence approximates the target edge distribution.  Row degrees
    are balanced automatically (±1).

    Args:
      n: code length; nb = len(col_degrees) base columns, z = n / nb.
      col_degrees: variable degree per base column.
      mb: number of base rows (checks); rate = 1 - mb/nb.
    """
    nb = len(col_degrees)
    if z is None:
        assert n % nb == 0, f"n={n} not divisible by nb={nb}"
        z = n // nb
    assert nb * z == n
    rng = np.random.default_rng(seed)
    total = int(sum(col_degrees))
    # Balanced row degrees: total = mb*q + r → r rows of (q+1), rest q.
    q, r = divmod(total, mb)
    row_degrees = [q + 1] * r + [q] * (mb - r)
    stubs = np.concatenate([
        np.full(d, j, np.int32) for j, d in enumerate(col_degrees)])
    rows = np.concatenate([
        np.full(d, i, np.int32) for i, d in enumerate(row_degrees)])
    rng.shuffle(stubs)
    # Parallel-edge repair (same scheme as the regular constructor).
    for _ in range(200 * 100):
        seen: dict[tuple[int, int], int] = {}
        conflict = -1
        for idx in range(len(rows)):
            key = (int(rows[idx]), int(stubs[idx]))
            if key in seen:
                conflict = idx
                break
            seen[key] = idx
        if conflict < 0:
            break
        other = int(rng.integers(0, len(rows)))
        if int(rows[other]) != int(rows[conflict]):
            stubs[conflict], stubs[other] = stubs[other], stubs[conflict]
    else:
        # Dense profiles (e.g. columns of degree == mb, which must hit every
        # row exactly once) defeat random stub swaps; fall back to a greedy
        # distinct-row assignment.  Only reached when the legacy path fails,
        # so codes (and frozen calibration) for existing seeds are unchanged.
        rows, stubs = _base_graph_greedy(col_degrees, row_degrees, mb, rng)
    shifts = rng.integers(0, z, size=len(rows)).astype(np.int32)
    shifts = _break_base_4cycles(rows, stubs, shifts, z, rng)
    code = QCCode(
        z=z, mb=mb, nb=nb,
        edge_row=rows.astype(np.int32),
        edge_col=stubs.astype(np.int32),
        edge_shift=shifts.astype(np.int32),
        row_edges=_group_edges(rows, mb),
        col_edges=_group_edges(stubs, nb),
    )
    code.validate()
    return code


def _fix_deg2_cycle_shifts(edge_row: np.ndarray, edge_col: np.ndarray,
                           shifts: np.ndarray, z: int) -> np.ndarray:
    """Give every fundamental cycle of the degree-2 subgraph an ODD shift sum.

    Degree-2 base columns form a multigraph on the check rows (each column =
    one row-row edge carrying weight shift(e1) - shift(e2)).  A base cycle of
    degree-2 columns lifts to circulant cycles whose length multiplies by the
    order of the cycle's shift sum in Z_z; a zero sum would lift to z
    length-L codewords of weight L.  With z a power of two, an ODD sum has
    order z, so the lifted cycle has weight L*z — harmless.  Processing each
    non-tree edge of a spanning forest independently fixes exactly its own
    fundamental cycle (composite cycles have base length >= 6 by the design
    constraint, and even-sum composites still lift to weight >= 2L — beyond
    the error-floor horizon at the operating QBERs).  This is what makes
    dense degree-2 profiles (the capacity-approaching regime) safe for the
    QC construction — the round-1 'at most mb-1 degree-2 columns' rule is
    obsolete."""
    if z % 2 != 0:
        return shifts
    shifts = shifts.copy()
    by_col: dict[int, list[int]] = {}
    for e in range(len(edge_row)):
        by_col.setdefault(int(edge_col[e]), []).append(e)
    parent = list(range(int(edge_row.max()) + 1))
    pot = [0] * len(parent)   # shift-sum potential to the root

    def find(x):
        path = []
        while parent[x] != x:
            path.append(x)
            x = parent[x]
        s = 0
        for y in reversed(path):
            s += pot[y]
            pot[y] = s
            parent[y] = x
        return x

    for j, es in sorted(by_col.items()):
        if len(es) != 2:
            continue
        e1, e2 = es
        r1, r2 = int(edge_row[e1]), int(edge_row[e2])
        w = int(shifts[e1]) - int(shifts[e2])     # traversal r1 -> j -> r2
        ra, rb = find(r1), find(r2)
        if ra != rb:                               # tree edge
            parent[ra] = rb
            pot[ra] = -pot[r1] + w + pot[r2]
        else:                                      # closes a fundamental cycle
            cyc = pot[r1] + w - pot[r2]
            if cyc % 2 == 0:
                shifts[e1] = (int(shifts[e1]) + 1) % z
    return shifts


def make_qc_from_base(edge_row: Sequence[int], edge_col: Sequence[int],
                      mb: int, nb: int, z: int, seed: int = 0x1BBE) -> QCCode:
    """Lift an EXPLICIT base graph (edge list) into a QC code.

    Used for density-evolution-DESIGNED base graphs (qtpu.ldpc.design.
    optimize_base_graph → qtpu.ldpc.designed): the protograph itself is
    protocol configuration; only the circulant shifts are sampled here
    (deterministically from ``seed``) with lifted-4-cycle breaking and
    odd-sum degree-2 cycle repair (see _fix_deg2_cycle_shifts).
    """
    rows = np.asarray(edge_row, np.int32)
    cols = np.asarray(edge_col, np.int32)
    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, z, size=len(rows)).astype(np.int32)
    shifts = _break_base_4cycles(rows, cols, shifts, z, rng)
    shifts = _fix_deg2_cycle_shifts(rows, cols, shifts, z)
    code = QCCode(
        z=z, mb=mb, nb=nb,
        edge_row=rows, edge_col=cols,
        edge_shift=shifts.astype(np.int32),
        row_edges=_group_edges(rows, mb),
        col_edges=_group_edges(cols, nb),
    )
    code.validate()
    return code


# ---------------------------------------------------------------------------
# Rate adaptation: puncture / shorten ladder (BASELINE.json config 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RateStep:
    """One rung of the rate ladder: a mother code plus light puncture/shorten.

    Each rung has its OWN mother code — a (dv, dc)-regular code whose design
    rate 1 - dv/dc sits at or just below the rung's target — because heavy
    puncturing of a single low-rate mother destroys BP convergence (a lesson
    from round-1 loopback testing: >35% punctured variables never decode).
    Whole base columns are punctured or shortened so the QC structure (and all
    static shapes) survive:

      * punctured column: z variables carry bits *random and undisclosed*
        (decoder prior LLR = 0; recovered by BP, then discarded);
      * shortened column: z variables carry bits *known to both parties* from
        the shared protocol PRNG (prior LLR = ±inf).

    Effective rate for syndrome reconciliation with p punctured and s
    shortened bits out of n, syndrome length m (Elkouss-style scheme):

        payload  k_eff = n - p - s          (sifted-key bits carried)
        leakage  = m - p                    (syndrome reveals m parities, but p
                                             of the involved bits were random
                                             pads unknown to the adversary)
        R_eff    = 1 - (m - p) / (n - p - s)
    """

    name: str
    code: QCCode
    punct_cols: tuple[int, ...]   # base columns carrying random pad bits
    short_cols: tuple[int, ...]   # base columns carrying PRNG-known bits

    def effective_rate(self, code: Optional[QCCode] = None) -> float:
        code = code or self.code
        p = len(self.punct_cols) * code.z
        s = len(self.short_cols) * code.z
        return 1.0 - (code.m - p) / (code.n - p - s)

    def payload_bits(self, code: Optional[QCCode] = None) -> int:
        code = code or self.code
        return code.n - (len(self.punct_cols) + len(self.short_cols)) * code.z

    def leaked_bits(self, code: Optional[QCCode] = None) -> int:
        code = code or self.code
        return code.m - len(self.punct_cols) * code.z


@dataclasses.dataclass(frozen=True)
class RateLadder:
    """Ordered rate steps (low rate → high rate), one mother code each.

    Rate selection: given a QBER estimate, pick the highest-rate step with
    R_eff <= 1 - f * h2(qber) for reconciliation efficiency f (>1).  f
    absorbs the gap to capacity of finite-length regular codes under
    normalized min-sum; 1.35-1.5 is realistic for n ~ 4k (f=1.1 was tried
    and produced high frame-error rates).

    Fine-grained adaptation (``select_fine``): on top of the rung grid, a
    per-window number of *extra shortened bits* (payload positions pinned to
    shared-PRNG values, LLR ±inf) interpolates the effective rate between
    rungs, so the code strength tracks the QBER estimate instead of jumping
    a whole rung (Elkouss-style rate-compatible reconciliation).  Requires
    the measured ceiling-vs-shortening curves from
    ``qtpu.ldpc.calibrate.calibrate_short``.
    """

    steps: tuple[RateStep, ...]
    # Measured per-rung QBER ceilings (see qtpu.ldpc.calibrate); when present
    # they override the capacity formula — empirical beats analytic here.
    max_qber: Optional[tuple[float, ...]] = None
    # Fine adaptation: extra-shortening fractions grid (of n) and, per rung,
    # the measured QBER ceiling at each grid fraction (non-decreasing).
    short_grid: Optional[tuple[float, ...]] = None
    short_ceilings: Optional[tuple[tuple[float, ...], ...]] = None
    # Resolution of the measured ceilings (select_fine's default guard):
    # 0.25% for grid-walk calibration, 0.05% for bisection calibration.
    calib_step: float = 0.0025

    def select(self, qber: float, efficiency: float = 1.4) -> int:
        """Return the index of the chosen step for a given QBER estimate.

        With calibration data: the highest rung whose measured ceiling admits
        the estimate (falls back to rung 0 — strongest code — beyond all
        ceilings; callers should abort the window if even rung 0's ceiling is
        exceeded).  Without: capacity formula with efficiency factor f.
        """
        if self.max_qber is not None:
            # Rungs are rate-ascending with descending ceilings; pick the
            # highest-rate admissible rung.
            admissible = [i for i, c in enumerate(self.max_qber) if qber <= c]
            return max(admissible) if admissible else 0
        capacity = 1.0 - efficiency * _h2(qber)
        best = 0
        for idx, step in enumerate(self.steps):
            if step.effective_rate() <= capacity:
                best = idx
        return best

    def rates(self) -> list[float]:
        return [s.effective_rate() for s in self.steps]

    def _min_short_frac(self, rung: int, qber: float) -> Optional[float]:
        """Smallest extra-shortening fraction whose interpolated measured
        ceiling admits ``qber`` on this rung; None if out of reach."""
        grid, ceils = self.short_grid, self.short_ceilings[rung]
        if qber <= ceils[0]:
            return 0.0
        for k in range(1, len(grid)):
            if qber <= ceils[k]:
                c0, c1 = ceils[k - 1], ceils[k]
                if c1 <= c0:  # flat/non-monotonic segment: take the safe end
                    return grid[k]
                t = (qber - c0) / (c1 - c0)
                return grid[k - 1] + t * (grid[k] - grid[k - 1])
        return None

    def select_fine(self, qber: float, granularity: int = 32,
                    efficiency: float = 1.4,
                    overhead_bits: int = 0,
                    guard: Optional[float] = None) -> tuple[int, int]:
        """Pick (rung, extra shortened bits per block) maximizing net key.

        For each rung, the minimal extra shortening that lifts its measured
        QBER ceiling to the estimate is interpolated from the calibration
        curve; the rung with the lowest resulting (leak + fixed overhead) per
        payload bit wins — ``overhead_bits`` carries the per-block fixed
        costs (verification hash, security margin, amortized QBER test bits)
        so heavy shortening is only chosen when it pays *net*.
        ``granularity`` rounds the shortening up (safe direction) to keep the
        choice space small.  ``guard`` inflates the estimate by one
        calibration-grid step — the measured ceilings are FER thresholds read
        off a 0.25%-QBER grid with finite blocks, so interpolating a flat
        noisy segment (the high-rate rungs) can otherwise land past the true
        ceiling.  Falls back to (coarse select, 0) when the ladder has no
        shortening calibration.
        """
        if self.short_grid is None or self.short_ceilings is None:
            return self.select(qber, efficiency), 0
        qber = qber + (self.calib_step if guard is None else guard)
        n = self.steps[0].code.n
        best: Optional[tuple[float, int, int]] = None
        for idx, step in enumerate(self.steps):
            frac = self._min_short_frac(idx, qber)
            if frac is None:
                continue
            s = int(-(-frac * n // granularity) * granularity)
            payload = step.payload_bits() - s
            if payload <= 0:
                continue
            ratio = (step.leaked_bits() + overhead_bits) / payload
            if best is None or ratio < best[0] - 1e-12:
                best = (ratio, idx, s)
        if best is None:
            # Beyond every calibrated curve: strongest rung, maximal grid
            # shortening — callers should expect failures/aborts out here.
            s = int(self.short_grid[-1] * n)
            return 0, s
        return best[1], best[2]


def _h2(p: float) -> float:
    if p <= 0.0 or p >= 1.0:
        return 0.0
    return float(-p * np.log2(p) - (1 - p) * np.log2(1 - p))


def _attach_calibration(num_steps: int, n: int, dv: int, alg: str,
                        family: str):
    """Look up frozen calibration for this ladder configuration.

    Bisection-measured FINE tables (0.05% resolution) win over the legacy
    0.25%-grid tables; the resolution travels with the data so rate
    selection's safety guard matches how the ceilings were measured.
    Table values are either a flat tuple (one rung-count measured) or a
    {num_rungs: value} dict when several rung counts exist for the same
    (n, dv, alg, family).  Returns (max_qber, short_grid, short_ceilings,
    calib_step); the first three may be None.
    """
    from qtpu_torch.ldpc.calibrate import (DEFAULT_CALIBRATION,
                                     DEFAULT_SHORT_CALIBRATION,
                                     FINE_CALIBRATION)
    fine = FINE_CALIBRATION.get((n, dv, alg, family))
    if fine is not None and len(fine["max_qber"]) == num_steps:
        return (tuple(fine["max_qber"]), tuple(fine["short_grid"]),
                tuple(tuple(c) for c in fine["short_ceilings"]),
                fine.get("calib_step", 0.0005))
    max_qber = DEFAULT_CALIBRATION.get((n, dv, alg, family))
    if isinstance(max_qber, dict):
        max_qber = max_qber.get(num_steps)
    if max_qber is not None and len(max_qber) != num_steps:
        max_qber = None
    short_grid = short_ceilings = None
    short_cal = DEFAULT_SHORT_CALIBRATION.get((n, dv, alg, family))
    if isinstance(short_cal, dict):
        short_cal = short_cal.get(num_steps)
    if short_cal is not None and len(short_cal[1]) == num_steps:
        short_grid, short_ceilings = short_cal
    return max_qber, short_grid, short_ceilings, 0.0025


def irregular_profile(nb: int, mb: int) -> list[int]:
    """Column-degree profile for an irregular mother code of rate 1 - mb/nb.

    Shape found by round-1 threshold sweeps (the classic irregular recipe at
    base-graph granularity): ~mb/2 degree-2 columns, two high-degree columns
    at the maximum simple degree (mb), the rest degree 3.  At n=4096 rate 1/2
    this lifted the min-sum FER<=5% ceiling from 7.25% to ~8% QBER and cut
    mean iterations ~25% vs (3,6)-regular.
    """
    n2 = max(0, mb // 2)
    nhigh = 2 if mb > 3 else 0
    rest = nb - n2 - nhigh
    prof = [2] * n2 + [3] * rest + [min(mb, 8)] * nhigh
    assert len(prof) == nb
    return prof


def irregular_profile_v2(nb: int, mb: int) -> list[int]:
    """Optimized column-degree profile ("max2_t3_d4body" in the 2026-08-19
    head-to-head sweeps, benchmarks/profile_sweep_prod.py): degree-2 mass
    pushed to the cycle-safety limit (mb - 1 columns, capped at nb/2), a
    6-column degree-4 shoulder, a 3-column high-degree tail, rest degree 3.

    Measured on TPU vs `irregular_profile` at n=16384, nb=32, layered
    min-sum, FER<=5%: mb=9 rung ceiling 3.00% -> 3.25% QBER at comparable
    iterations.  Used by the "native2" ladder family; "native" keeps the
    legacy profile because its frozen calibration was measured with it.
    """
    n2 = min(max(0, mb - 1), nb // 2)
    nsh = min(6, max(0, nb - n2 - 3))
    ntail = min(3, max(0, nb - n2 - nsh))
    rest = nb - n2 - nsh - ntail
    prof = ([2] * n2 + [3] * rest + [min(mb, 4)] * nsh
            + [min(mb, 10)] * ntail)
    assert len(prof) == nb
    return prof


def make_rate_ladder(n: int, dv: int = 3,
                     target_rates: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.875),
                     seed: int = 0x0AD0,
                     max_punct_frac: float = 0.15,
                     z: Optional[int] = None,
                     alg: str = "minsum",
                     family: str = "mixed") -> RateLadder:
    """Build the rate ladder for length-n blocks.

    family="regular": for each target rate R the highest (dv, dc)-regular
    design rate 1 - dv/dc <= R (with dc a divisor of nb*dv) picks the mother
    code.  family="irregular": mother codes use `irregular_profile` degree
    sequences.  family="mixed" (default): per-rung choice frozen from the
    round-1 calibration sweeps — irregular mothers for the low-rate rungs
    (where degree-2 columns buy threshold: +0.5% QBER at rate 1/2) and
    regular for the high-rate rungs (where the shallow irregular profile
    loses: 1.25% vs 1.5% ceiling at rate 0.8).  Either way the residual gap
    to R closes by puncturing whole columns (capped at ``max_punct_frac`` of
    n), or by shortening when the mother overshoots.

    family="native": one irregular mother at EVERY rung with mb chosen so the
    design rate lands on the target directly — no puncturing at all.
    Irregular construction has no divisibility constraint on mb (unlike
    regular dc | nb*dv), and the profile sweeps showed puncturing costs real
    threshold: a native rate-0.69 irregular mother reaches 3.75% QBER at
    n=16384 where the punctured rate-0.625 regular mother stops at 3.25%.
    Targets are snapped to the nearest mb/nb grid point (nb=32 when n allows,
    giving 1/32-rate granularity); fine shortening interpolates between.

    All choices are deterministic from ``seed`` — the ladder is protocol
    configuration shared by both parties.
    """
    steps = []
    if family == "native3":
        # DE-designed punctured protographs (qtpu.ldpc.designed): the rung
        # set is fixed by NATIVE3_LADDER (target_rates is ignored — the
        # designed rate grid IS the ladder); only the lift size z = n/32
        # and the shift seed vary.
        from qtpu_torch.ldpc.designed import DESIGNED_GRAPHS, NATIVE3_LADDER
        nb3 = 32
        assert n % nb3 == 0, f"native3 needs 32 | n, got n={n}"
        zz = n // nb3
        for mb3, p3 in NATIVE3_LADDER:
            g = DESIGNED_GRAPHS[(nb3, mb3, p3)]
            code = make_qc_from_base(g["edge_row"], g["edge_col"], mb3, nb3,
                                     z=zz, seed=seed + 8 * mb3 + p3)
            steps.append(RateStep(
                name=f"r{g['rate_eff']:.3f}", code=code,
                punct_cols=tuple(range(nb3 - p3, nb3)), short_cols=()))
        max_qber, short_grid, short_ceilings, cstep = _attach_calibration(
            len(steps), n, dv, alg, family)
        return RateLadder(steps=tuple(steps), max_qber=max_qber,
                          short_grid=short_grid,
                          short_ceilings=short_ceilings, calib_step=cstep)
    if family in ("native", "native2"):
        profile_fn = irregular_profile_v2 if family == "native2" else irregular_profile
        nb_native = 32 if n % 32 == 0 and n // 32 >= 64 else 16
        zz = n // nb_native
        seen_mb = set()
        for r in target_rates:
            mb_mother = max(2, int(round(nb_native * (1.0 - r))))
            while mb_mother in seen_mb:  # distinct rungs only
                mb_mother -= 1
            seen_mb.add(mb_mother)
            code = make_irregular_code(
                n, profile_fn(nb_native, mb_mother), mb=mb_mother,
                z=zz, seed=seed + mb_mother)
            steps.append(RateStep(name=f"r{code.rate:.3f}", code=code,
                                  punct_cols=(), short_cols=()))
        max_qber, short_grid, short_ceilings, cstep = _attach_calibration(
            len(steps), n, dv, alg, family)
        return RateLadder(steps=tuple(steps), max_qber=max_qber,
                          short_grid=short_grid,
                          short_ceilings=short_ceilings, calib_step=cstep)
    probe = make_regular_code(n, dv, 2 * dv, z=z, seed=seed)  # fixes nb, z
    nb, zz = probe.nb, probe.z
    # dc must divide nb*dv and stay <= nb (else a simple base graph can't
    # host row degree dc over nb columns).
    divisors = [d for d in range(dv + 1, nb + 1) if (nb * dv) % d == 0]
    rng = np.random.default_rng(seed)
    # family="mixed": measured per-rung winners (round-1 calibration).
    MIXED = ("irregular", "irregular", "regular", "regular", "regular")
    for ri, r in enumerate(target_rates):
        # Mother design rate at or just below target.
        cands = [d for d in divisors if 1.0 - dv / d <= r + 1e-9]
        dc = max(cands) if cands else min(divisors)
        fam = family
        if family == "mixed":
            fam = MIXED[ri] if ri < len(MIXED) else "regular"
        if fam == "irregular":
            mb_mother = nb * dv // dc
            code = make_irregular_code(n, irregular_profile(nb, mb_mother),
                                       mb=mb_mother, z=zz, seed=seed + dc)
        else:
            code = make_regular_code(n, dv, dc, z=zz, seed=seed + dc)
        col_order = rng.permutation(code.nb)
        r0 = code.rate
        if r > r0 + 1e-9:
            # Puncture up: p = (m - (1 - R) n) / R, capped.
            p_bits = (code.m - (1.0 - r) * code.n) / r
            p_cols = int(round(p_bits / code.z))
            p_cols = max(0, min(p_cols, int(max_punct_frac * code.nb)))
            steps.append(RateStep(name=f"r{r:.3f}", code=code,
                                  punct_cols=tuple(int(c) for c in col_order[:p_cols]),
                                  short_cols=()))
        else:
            # Shorten down: s = n - m / (1 - R).
            s_bits = code.n - code.m / max(1e-9, (1.0 - r))
            s_cols = int(round(max(0.0, s_bits) / code.z))
            s_cols = min(s_cols, code.nb - code.mb - 1)
            steps.append(RateStep(name=f"r{r:.3f}", code=code,
                                  punct_cols=(),
                                  short_cols=tuple(int(c) for c in col_order[:s_cols])))
    # Attach measured QBER ceilings when this configuration has been
    # calibrated (qtpu.ldpc.calibrate).
    max_qber, short_grid, short_ceilings, cstep = _attach_calibration(
        len(steps), n, dv, alg, family)
    return RateLadder(steps=tuple(steps), max_qber=max_qber,
                      short_grid=short_grid, short_ceilings=short_ceilings,
                      calib_step=cstep)


# ---------------------------------------------------------------------------
# Port-only additions (everything above this line is a verbatim copy of
# qtpu/ldpc/codes.py; tests/test_torch_imports.py holds it to that).
# ---------------------------------------------------------------------------

def code_from_reference(obj) -> QCCode:
    """Build this package's ``QCCode`` from any object carrying the
    reference's numpy fields (``z, mb, nb, edge_row, edge_col, edge_shift,
    row_edges, col_edges``) — e.g. a ``qtpu.ldpc.codes.QCCode``.  The code
    geometry is the only state the two packages share."""
    code = QCCode(
        z=int(obj.z), mb=int(obj.mb), nb=int(obj.nb),
        edge_row=np.asarray(obj.edge_row, np.int32).copy(),
        edge_col=np.asarray(obj.edge_col, np.int32).copy(),
        edge_shift=np.asarray(obj.edge_shift, np.int32).copy(),
        row_edges=np.asarray(obj.row_edges, np.int32).copy(),
        col_edges=np.asarray(obj.col_edges, np.int32).copy(),
    )
    code.validate()
    return code
