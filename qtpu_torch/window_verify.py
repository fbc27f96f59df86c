"""The window programs' verify hash and Bob's decode tail, and their Hopper
kernel.

Counterpart of the verification the reference's jitted window programs
fuse (``qtpu/window_programs.py``: ``_vmatrix`` and ``_verify_hash``, the
tail of ``_decode_core`` with ``_extract_payload``, and the merge of
its compact retry):

- ``hash``: the GF(2) Toeplitz hash of a (b, P) payload against the
  window-level verify seed t of P + Vh - 1 bits: hash bit j of a row x is
  parity(sum_i x[i] t[i + j]) (row j of the reference's matrix is
  t[j : j + P]).  Alice's program.
- ``tail``: Bob's decode after the decoder.  hat = where(pin, rx_pin, the
  payload columns of the decoded bits), ok = all(hash(hat) == the
  expected hashes) & converged, errs = popcount(hat ^ rx_orig), in one
  of two modes: the first decode (stats [ok, iters, errs, mism]) and a
  retry's merge (``rows``: the re-decoded rows' places in the window).

On CPU tensors each function runs its plain PyTorch version (``*_plain``:
the window programs' eager chain, a float32 matmul for the hash); on CUDA
tensors it launches the hand-written kernel ``qtpu_torch/csrc/verify.cu``
(built at first use by ``qtpu_torch._build``, bound with ctypes) or raises.
``launches`` counts each entry point's launches.  ``plan`` is the host's
launch plan of a call (the cluster of CTAs a row, each CTA's slice of the
row's words, the CTAs that copy a retry's kept rows), a pure function of
the shape and the card's occupancy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from qtpu_torch import _build
from qtpu_torch.ldpc.encode import ColumnLayout
from qtpu_torch.window_assembly import _check

__all__ = ["hash", "tail", "hash_plain", "tail_plain", "launches", "LIBRARY",
           "MAX_VH", "Plan", "plan", "launch_plan"]

# The kernel library (qtpu_torch/csrc/verify.cu) and the launches of each
# of its entry points since import (or since a caller reset them).
LIBRARY = "verify"
launches = {"verify_hash": 0, "verify_tail": 0}

MAX_P = 1 << 17
MAX_VH = 64      # hash bits the kernel takes (two 32-bit words a lane)
# tail's modes (the kernel's): the first decode, a retry's rows merge.
FIRST, ROWS = 0, 1

_U32, _INT, _PTR = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    # x, seed; b; P; vh; out; cluster, groups, threads, smem; stream
    "verify_hash": (_PTR, _PTR, _INT, _U32, _INT, _PTR) + (_INT,) * 4
    + (_PTR,),
    # bits, sources; nb, z; rx_pin, pin, rx_orig, seed, expected; vh;
    # converged, iterations, mism, order, hat_old, stats_old; mode, rows,
    # merged; P; hat, stats; cluster, groups, threads, smem, kept_ctas;
    # stream
    "verify_tail": (_PTR, _PTR, _INT, _INT) + (_PTR,) * 5 + (_INT,)
    + (_PTR,) * 6 + (_INT, _INT, _INT, _U32) + (_PTR,) * 2 + (_INT,) * 5
    + (_PTR,),
    # tail, vec, cluster, threads, smem (no stream)
    "verify_plan": (_INT,) * 5,
}

# The launch plan.  Cluster sizes (16 needs the non-portable attribute,
# which the kernel sets), the dynamic shared memory a CTA may use (the
# kernel's kMaxSmem) and a warp's share of it (16 row and 20 seed words:
# kWarpWords), the fewest bytes a kept rows' CTA copies.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMEM_MAX = 232448 - 2048
WARP_WORDS = 40
KEPT_MIN_BYTES = 1 << 14
# The warps a CTA may have: one a group of its slice, up to each cap (a
# narrower CTA lets two or four share an SM, and more clusters be resident).
WARP_CAPS = (32, 16, 8)
# The cost model's weights.  A warp reads 1.25 seed bytes a row byte (the
# four words past its group too) from L2, at a quarter of a row byte's
# cost; a kept row's byte (a copy, no hashing) costs half.  A cluster's
# gather and barriers are charged ~24 KB of an SM's streaming (about a
# microsecond), so a row is split only where that buys more.  An SM's
# throughput at so many threads resident, as a share of 1,024's: one
# row's hash or tail on one CTA of 256, 512 and 1,024 threads took 1.75,
# 1.19 and 1 times as long (NVIDIA H100 80GB HBM3, chip_smoke.py phase
# 5d's plan sweep on the kernel's first version; on the last, 1.47 and
# 1.1, with which the plan would give a retry's rows CTAs of 512 threads,
# which the sweep times slower than 992).
SEED_WEIGHT = 1.25 * 0.25
KEPT_WEIGHT = 0.5
CLUSTER_BYTES = 24 << 10
WIDTH_SHARE = ((0, 0.0), (256, 0.57), (512, 0.84), (1024, 1.0))


def _width_share(threads: int) -> float:
    """WIDTH_SHARE at ``threads`` resident an SM (linear between its
    points, 1 from 1,024 on)."""
    for (t0, s0), (t1, s1) in zip(WIDTH_SHARE, WIDTH_SHARE[1:]):
        if threads <= t1:
            return s0 + (s1 - s0) * (threads - t0) / (t1 - t0)
    return 1.0


class Plan(NamedTuple):
    """One launch of the verify kernel: clusters of ``cluster`` CTAs, the
    merged rows' first (cluster k merged row k, CTA rank r its groups
    [r·groups, (r + 1)·groups) of 16 words), then ``kept_ctas`` CTAs
    copying a retry's kept rows."""
    cluster: int        # C: CTAs a merged row
    groups: int         # groups of 16 row words a CTA's slice (C = 1: G)
    threads: int        # threads a CTA
    smem: int           # dynamic shared memory a CTA, bytes
    decoded_ctas: int   # the merged rows' CTAs (merged * C)
    kept_ctas: int      # the kept rows' CTAs after them (a multiple of C)
    resident: int       # cudaOccupancyMaxActiveClusters at this shape

    @property
    def grid(self) -> int:
        return self.decoded_ctas + self.kept_ctas

    def words(self, rank: int, P: int) -> tuple[int, int]:
        """Row words [w0, w1) CTA ``rank`` of a row's CTAs takes (a whole
        number of groups of 16; w1 may pass the row's last word)."""
        G = _groups(P)
        g0 = min(G, rank * self.groups)
        return 16 * g0, 16 * min(G, g0 + self.groups)


def _groups(P: int) -> int:
    """Groups of 16 words (512 positions) of a P-bit row."""
    words = -(-P // 32)
    return -(-words // 16)


def smem_bytes(threads: int, cols: int) -> int:
    """A CTA's dynamic shared memory (the kernel's smem_need): WARP_WORDS
    a warp and ``cols`` payload-column entries."""
    return 4 * (WARP_WORDS * (threads // 32) + cols)


def plan(rows: int, merged: int, P: int, vh: int, cols: int, tail: bool,
         sms: int, max_clusters: Callable[[int, int, int], int], *,
         cluster: int | None = None, threads: int | None = None) -> Plan:
    """The launch of a call that hashes ``merged`` of ``rows`` output rows
    of P bits (Vh hash bits; ``tail``: the decode tail, ``cols`` its
    layout's base columns, and the other rows kept), on a card of ``sms``
    SMs where ``max_clusters(C, threads, smem)`` clusters can be resident.

    Each cluster size C (the CTAs a row, each at least one group) and CTA
    width (a warp a group of the slice, up to 32, 16 or 8 warps) whose
    clusters are all resident at once, the kept rows' CTAs included (as
    many as fill the SMs the merged rows leave, at least KEPT_MIN_BYTES
    each), is priced by the weighted bytes of its busiest CTA times the
    CTAs an SM holds (k = ceil(CTAs / sms)) over the SM's throughput at k
    such CTAs (``WIDTH_SHARE``), at least the call's weighted bytes spread
    over every SM; the cheapest wins, then the one with fewer CTAs, then
    the wider CTA, then the smaller C.  A merged row moves 5 P bytes in
    the tail (four inputs, hat) or P in the hash and reads 1.25 P of seed
    (SEED_WEIGHT), a kept row 2 P (KEPT_WEIGHT), a cluster costs
    CLUSTER_BYTES more.  Where no plan is all resident (1,024 rows) the
    cheapest with a CTA a row runs in waves.  ``cluster`` and ``threads``
    restrict the choice (to time the others).  Raises RuntimeError when no
    cluster can be scheduled."""
    if not (0 <= merged <= rows and rows > 0 and 0 < P <= MAX_P
            and 1 <= vh <= MAX_VH and (tail or merged == rows)):
        raise ValueError(f"no plan for {merged} of {rows} rows, P = {P}, "
                         f"Vh = {vh}")
    G = _groups(P)
    row = (5 if tail else 1) * P + SEED_WEIGHT * P
    kept = KEPT_WEIGHT * 2 * P * (rows - merged)
    total = merged * row + kept
    best = None
    for C in CLUSTER_SIZES if cluster is None else (cluster,):
        if C > G:
            continue
        q = -(-G // C)
        widths = ({32 * min(w, q) for w in WARP_CAPS} if threads is None
                  else {threads})
        for T in sorted(widths, reverse=True):
            smem = smem_bytes(T, cols if tail else 0)
            if smem > SMEM_MAX:
                continue
            res = max_clusters(C, T, smem)
            if res <= 0:
                continue
            kc = 0
            if rows > merged:
                kc = max(1, min(res - merged, (sms - merged * C) // C,
                                int(-(-kept // (C * KEPT_MIN_BYTES)))))
            ctas = (merged + kc) * C
            busiest = max(row / C, kept / (kc * C) if kc else 0) + (
                CLUSTER_BYTES if C > 1 else 0)
            per_sm = -(-ctas // sms)
            cost = max(busiest * per_sm / _width_share(per_sm * T),
                       total / sms)
            resident = merged + kc <= res
            if resident or C == 1:
                p = Plan(C, q, T, smem, merged * C, kc * C, res)
                key = (not resident, cost, ctas, -T, C, p)
                best = min(best or key, key)
    if best is None:
        raise RuntimeError(f"the verify kernel: no cluster of any size in "
                           f"{CLUSTER_SIZES} can be scheduled for P = {P}")
    return best[-1]


def _check_exact_matmul(x: torch.Tensor) -> None:
    # The plain hash is an exact GF(2) product through a float32 matmul:
    # products are 0/1 and sums <= P <= 2^17 < 2^24, exact only without TF32.
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the verify hash needs full-float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _mode(mism, hat, stats, rows) -> int:
    """tail's mode from which of ``mism`` / ``rows`` is given (exactly one;
    ``rows`` with the previous round's ``hat`` and ``stats``)."""
    if (mism is None) == (rows is None):
        raise ValueError("give exactly one of mism (the first decode) and "
                         "rows (a retry)")
    mode = FIRST if rows is None else ROWS
    if (hat is None) != (mode == FIRST) or (stats is None) != (mode == FIRST):
        raise ValueError("hat and stats go with rows, and only with them")
    return mode


def _payload_columns(layout: ColumnLayout) -> np.ndarray:
    """The base columns of ``layout``'s payload part, in payload order."""
    return np.argsort(layout.inv)[:layout.widths[0]]


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the CPU path and the kernel's oracle.

def hash_plain(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``hash``'s plain version, on any device: (b, P) x (P, Vh) -> (b, Vh)
    through the (Vh, P) float32 Toeplitz matrix whose row j is
    seed[j : j + P]."""
    P = x.shape[1]
    _check_exact_matmul(x)
    t_mat = seed.unfold(0, P, 1).to(torch.float32)
    acc = x.to(torch.float32) @ t_mat.T
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def tail_plain(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
               iterations, layout: ColumnLayout, mism=None, *, hat=None,
               stats=None, rows=None):
    """``tail``'s plain version, on any device."""
    mode = _mode(mism, hat, stats, rows)
    b, dev = bits.shape[0], bits.device
    P = rx_pin.shape[1]
    pay = torch.as_tensor(_payload_columns(layout), device=dev)
    new = bits.reshape(b, layout.nb, layout.z)[:, pay, :].reshape(b, P)
    new = torch.where(pin, rx_pin, new)
    if mode == ROWS:
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        rx_orig, exp_hashes = rx_orig[sel], exp_hashes[sel]
    hashes = hash_plain(new, seed)
    ok = (hashes == exp_hashes).all(dim=1) & converged
    errs = (new ^ rx_orig).to(torch.int32).sum(dim=1, dtype=torch.int32)
    st = torch.stack([ok.to(torch.int32), iterations.to(torch.int32), errs],
                     dim=1)
    if mode == FIRST:
        return new, torch.cat([st, mism[:, None]], dim=1)
    hat_m = hat.clone()
    hat_m[sel] = new
    st_rows = stats[sel]
    st_new = torch.stack([st[:, 0], torch.maximum(st_rows[:, 1], st[:, 1]),
                          st[:, 2], st_rows[:, 3]], dim=1)
    stats_m = stats.clone()
    stats_m[sel] = st_new
    return hat_m, stats_m


# ---------------------------------------------------------------------------
# The kernel's wrappers.

@functools.cache
def _max_clusters(device: int, tail: bool, vec: bool, cluster: int,
                  threads: int, smem: int) -> int:
    """cudaOccupancyMaxActiveClusters of an instantiation at a shape on
    CUDA ``device``, asked once (the kernel's attributes set first)."""
    fn = _build.entry(LIBRARY, "verify_plan", _ARGTYPES["verify_plan"])
    with torch.cuda.device(device):
        return int(fn(int(tail), int(vec), cluster, threads, smem))


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def launch_plan(device: int, rows: int, merged: int, P: int, vh: int,
                nb: int = 0, z: int = 0) -> Plan:
    """The plan of a call on CUDA ``device`` (``nb``, ``z``: the tail's
    layout; 0 for the hash), from the card's SMs and the occupancy of the
    instantiation the call takes (vec: P, and the tail's z, multiples of
    16; the outputs are 16-byte aligned)."""
    tail = nb > 0
    vec = P % 16 == 0 and (not tail or z % 16 == 0)
    return plan(rows, merged, P, vh, nb, tail, _sms(device),
                functools.partial(_max_clusters, device, tail, vec))


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _on_card(dev: torch.device) -> bool:
    return _build.on_card(dev, "the verify hash")


def _hash_bits(seed: torch.Tensor, P: int, dev) -> int:
    """Vh of a (P + Vh - 1,) uint8 seed; raises unless 1 <= Vh <= MAX_VH
    and 0 < P <= MAX_P."""
    _check(seed, "seed", torch.uint8, (None,), dev)
    vh = seed.shape[0] - P + 1
    if not (0 < P <= MAX_P and 1 <= vh <= MAX_VH):
        raise ValueError(f"a seed of {seed.shape[0]} bits for P = {P}: "
                         f"Vh = {vh} outside 1..{MAX_VH} or P outside "
                         f"1..{MAX_P}")
    return vh


def _host(v, what: str) -> np.ndarray:
    """A host array of ``v`` (numpy, a sequence or a CPU tensor)."""
    if isinstance(v, torch.Tensor) and v.device.type != "cpu":
        raise ValueError(f"{what} must be a host array, not on {v.device}")
    return np.asarray(v)


def _row_order(src: np.ndarray) -> tuple[np.ndarray, int]:
    """(order, merged) of a retry's row map ``src``: the merged window
    rows in the order of their decoded rows, then the kept rows."""
    merged = np.flatnonzero(src >= 0)
    merged = merged[np.argsort(src[merged], kind="stable")]
    order = np.concatenate([merged, np.flatnonzero(src < 0)])
    return order.astype(np.int32), int(merged.size)


def _source_rows(rows, b: int, B: int) -> np.ndarray:
    """(B,) int32: each window row's decoded row, or -1 where the retry
    leaves it as it was; raises on a map the kernel would race on."""
    r = _host(rows, "rows").astype(np.int64)
    if r.shape != (b,) or (b and (r.min() < 0 or r.max() >= B)):
        raise ValueError(f"rows must be ({b},) rows of the window's {B}, "
                         f"got {r.shape}")
    if np.unique(r).size != b:
        raise ValueError(f"rows repeats a row: {r.tolist()}")
    src = np.full(B, -1, np.int32)
    src[r] = np.arange(b, dtype=np.int32)
    return src


def hash(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """(b, Vh) uint8 verify hashes of the (b, P) uint8 bits ``x`` against
    the (P + Vh - 1,) uint8 seed ``seed`` (Vh <= 64 on a card).  One launch
    on a card."""
    dev = x.device
    if not _on_card(dev):
        return hash_plain(x, seed)
    _check(x, "x", torch.uint8, (None, None), dev)
    b, P = x.shape
    vh = _hash_bits(seed, P, dev)
    _build.entry(LIBRARY, "verify_hash", _ARGTYPES["verify_hash"])
    out = torch.empty((b, vh), dtype=torch.uint8, device=dev)
    if b:
        _launch_hash(x, seed, out, launch_plan(_device_index(dev), b, b, P,
                                               vh))
    return out


def _launch_hash(x, seed, out, p: Plan) -> None:
    """One launch of the hash on checked CUDA inputs at plan ``p``."""
    b, P = x.shape
    _build.launch(LIBRARY, "verify_hash", _ARGTYPES["verify_hash"], launches,
                  x.device, x.data_ptr(), seed.data_ptr(), b, P,
                  out.shape[1], out.data_ptr(), p.cluster, p.groups,
                  p.threads, p.smem)


def tail(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
         iterations, layout: ColumnLayout, mism=None, *, hat=None,
         stats=None, rows=None):
    """(hat (B, P) uint8, stats (B, 4) int32) of Bob's decode of b rows.

    bits (b, nb·z) uint8, converged (b,) bool, iterations (b,) int32: the
    decoder's result; rx_pin (b, P) uint8 and pin (b, P) bool: its pins;
    seed: the (P + Vh - 1,) verify seed; layout: the rung's columns (part 0
    the payload).  rx_orig (B, P) uint8 and exp_hashes (B, Vh) uint8 are
    the window's rows.  The mode:

    - ``mism`` (b,) int32 (B = b): the first decode, stats [ok, iters,
      errs, mism];
    - ``rows`` (b,) host ints, each row once: a retry's merge into the
      previous round's ``hat`` and ``stats``: decoded row i lands in window
      row rows[i] with its hat, ok and errs, max(old, new) iterations and
      the old mismatch count; the other rows as they were.

    One launch on a card."""
    mode = _mode(mism, hat, stats, rows)
    dev = bits.device
    if not _on_card(dev):
        return tail_plain(bits, rx_pin, pin, rx_orig, seed, exp_hashes,
                          converged, iterations, layout, mism, hat=hat,
                          stats=stats, rows=rows)
    b = bits.shape[0]
    P = layout.widths[0] * layout.z
    _check(bits, "bits", torch.uint8, (b, layout.nb * layout.z), dev)
    _check(rx_pin, "rx_pin", torch.uint8, (b, P), dev)
    _check(pin, "pin", torch.bool, (b, P), dev)
    _check(converged, "converged", torch.bool, (b,), dev)
    _check(iterations, "iterations", torch.int32, (b,), dev)
    vh = _hash_bits(seed, P, dev)
    B = b if mode == FIRST else hat.shape[0]
    _check(rx_orig, "rx_orig", torch.uint8, (B, P), dev)
    _check(exp_hashes, "exp_hashes", torch.uint8, (B, vh), dev)
    order, merged = None, B
    if mode == FIRST:
        _check(mism, "mism", torch.int32, (b,), dev)
    else:
        _check(hat, "hat", torch.uint8, (B, P), dev)
        _check(stats, "stats", torch.int32, (B, 4), dev)
        order, merged = _row_order(_source_rows(rows, b, B))
        order = torch.from_numpy(order)
    _build.entry(LIBRARY, "verify_tail", _ARGTYPES["verify_tail"])
    if order is not None:
        # The row order goes up from pinned memory without a host sync.
        order = order.pin_memory().to(dev, non_blocking=True)
    hat_out = torch.empty((B, P), dtype=torch.uint8, device=dev)
    stats_out = torch.empty((B, 4), dtype=torch.int32, device=dev)
    if B:
        _launch_tail(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
                     iterations, layout, mism, hat, stats, mode, order,
                     merged, hat_out, stats_out,
                     launch_plan(_device_index(dev), B, merged, P, vh,
                                 layout.nb, layout.z))
    return hat_out, stats_out


def _launch_tail(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
                 iterations, layout: ColumnLayout, mism, hat, stats,
                 mode: int, order, merged: int, hat_out, stats_out,
                 p: Plan) -> None:
    """One launch of the tail on checked CUDA inputs (``order``: a
    retry's row order on the card) at plan ``p``."""
    def ptr(t):
        return None if t is None else t.data_ptr()
    dev = bits.device
    B, P = hat_out.shape
    _build.launch(LIBRARY, "verify_tail", _ARGTYPES["verify_tail"], launches,
                  dev, bits.data_ptr(), layout.on(dev)[1].data_ptr(),
                  layout.nb, layout.z, rx_pin.data_ptr(), pin.data_ptr(),
                  rx_orig.data_ptr(), seed.data_ptr(), exp_hashes.data_ptr(),
                  exp_hashes.shape[1], converged.data_ptr(),
                  iterations.data_ptr(), ptr(mism), ptr(order), ptr(hat),
                  ptr(stats), mode, B, merged, P, hat_out.data_ptr(),
                  stats_out.data_ptr(), p.cluster, p.groups, p.threads,
                  p.smem, p.kept_ctas)
