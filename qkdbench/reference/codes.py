"""The quasi-cyclic LDPC codes the cells decode, built again from their
published recipes: frozen copies of the constructions in
``qtpu_torch/ldpc/codes.py``, in plain NumPy.  ``make_regular_code`` is
BASELINE config 2's (dv, dc)-regular code; ``ladder_codes`` lifts each
rung of a configuration's ladder from the base graph its file holds
(``make_qc_from_base``).  The benchmark computes its syndromes with these
copies, and each decode check holds the program's code to them edge for
edge (``differs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["RegularCode", "make_regular_code", "make_qc_from_base",
           "ladder_codes", "differs", "syndromes"]


@dataclasses.dataclass(frozen=True)
class RegularCode:
    """A QC-LDPC code by its base graph: lift size ``z``, ``mb`` x ``nb``
    base rows and columns, and per base edge its row, column and circulant
    shift; ``row_edges`` lists each base row's edges (padded with -1)."""

    z: int
    mb: int
    nb: int
    edge_row: np.ndarray
    edge_col: np.ndarray
    edge_shift: np.ndarray
    row_edges: np.ndarray

    @property
    def n(self) -> int:
        return self.nb * self.z

    @property
    def m(self) -> int:
        return self.mb * self.z

    @property
    def num_edges(self) -> int:
        return int(self.edge_row.shape[0])


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
                      seed: int = 0x51C0DE) -> RegularCode:
    """The (dv, dc)-regular code of length ``n`` built from ``seed``: the
    largest power-of-two lift z with nb = n / z >= 2 dc, a random
    biregular base graph, random shifts with lifted 4-cycles broken."""
    if z is None:
        z = 1
        for cand in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
            if n % cand == 0 and (n // cand) >= 2 * dc and ((n // cand) * dv) % dc == 0:
                z = cand
                break
    if n % z or (n // z * dv) % dc:
        raise ValueError(f"no ({dv}, {dc})-regular code of length {n} at z={z}")
    nb = n // z
    mb = nb * dv // dc
    rng = np.random.default_rng(seed)
    edge_row, edge_col = _base_graph_regular(mb, nb, dv, dc, rng)
    shifts = rng.integers(0, z, size=edge_row.shape[0]).astype(np.int32)
    shifts = _break_base_4cycles(edge_row, edge_col, shifts, z, rng)
    return RegularCode(z=z, mb=mb, nb=nb, edge_row=edge_row.astype(np.int32),
                       edge_col=edge_col.astype(np.int32),
                       edge_shift=shifts.astype(np.int32),
                       row_edges=_group_edges(edge_row, mb))


def _fix_deg2_cycle_shifts(edge_row: np.ndarray, edge_col: np.ndarray,
                           shifts: np.ndarray, z: int) -> np.ndarray:
    """Give every fundamental cycle of the degree-2 subgraph (degree-2
    base columns as row-to-row edges weighted shift(e1) - shift(e2)) an
    odd shift sum, by a union-find over the rows; z odd is left alone."""
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


def make_qc_from_base(edge_row, edge_col, mb: int, nb: int, z: int,
                      seed: int) -> RegularCode:
    """A base graph given edge by edge, lifted by z: shifts drawn from
    ``seed``, lifted 4-cycles broken, degree-2 cycles given odd sums."""
    rows = np.asarray(edge_row, np.int32)
    cols = np.asarray(edge_col, np.int32)
    rng = np.random.default_rng(seed)
    shifts = rng.integers(0, z, size=len(rows)).astype(np.int32)
    shifts = _break_base_4cycles(rows, cols, shifts, z, rng)
    shifts = _fix_deg2_cycle_shifts(rows, cols, shifts, z)
    return RegularCode(z=z, mb=mb, nb=nb, edge_row=rows, edge_col=cols,
                       edge_shift=shifts.astype(np.int32),
                       row_edges=_group_edges(rows, mb))


def ladder_codes(config: dict) -> list:
    """Each rung's code of a configuration's ladder (its file's
    ``ladder.rungs``: base rows, punctured columns and edges), lifted by
    z = n / nb with the shift seed code_seed + 8 mb + punct."""
    pipe, lad = config["pipeline"], config["ladder"]
    nb = lad["nb"]
    return [make_qc_from_base(r["edge_row"], r["edge_col"], r["mb"], nb,
                              pipe["n"] // nb,
                              pipe["code_seed"] + 8 * r["mb"] + r["punct"])
            for r in lad["rungs"]]


def differs(code, ref: RegularCode) -> int:
    """How many of a code's base-graph fields (lift, shape, each edge's
    row, column and shift, each row's edges) are not the reference's."""
    shape = int((code.z, code.mb, code.nb) != (ref.z, ref.mb, ref.nb))
    return shape + sum(
        int(not np.array_equal(getattr(code, f), getattr(ref, f)))
        for f in ("edge_row", "edge_col", "edge_shift", "row_edges"))


def syndromes(code: RegularCode, words):
    """(B, m) uint8 syndromes of (B, n) uint8 words (a torch tensor, on its
    own device): check i*z + r is the XOR over base row i's edges e of word
    bit edge_col[e]*z + (r + edge_shift[e]) % z."""
    import torch
    B, z = words.shape[0], code.z
    cols = words.reshape(B, code.nb, z)
    out = torch.zeros((B, code.mb, z), dtype=torch.uint8, device=words.device)
    for e in range(code.num_edges):
        i, j, s = (int(code.edge_row[e]), int(code.edge_col[e]),
                   int(code.edge_shift[e]))
        out[:, i] ^= torch.roll(cols[:, j], -s, dims=1)
    return out.reshape(B, code.m)
