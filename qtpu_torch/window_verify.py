"""The window programs' verify hash and Bob's decode tail, and their Hopper
kernel.

Counterpart of the verification the reference's jitted window programs
fuse (``qtpu/window_programs.py``: ``_vmatrix`` and ``_verify_hash``, the
tail of ``_decode_core`` with ``_extract_payload``, and the merges of
``retry_program`` and ``retry_small``):

- ``hash``: the GF(2) Toeplitz hash of a (b, P) payload against the
  window-level verify seed t of P + Vh - 1 bits: hash bit j of a row x is
  parity(sum_i x[i] t[i + j]) (row j of the reference's matrix is
  t[j : j + P]).  Alice's program.
- ``tail``: Bob's decode after the decoder.  hat = where(pin, rx_pin, the
  payload columns of the decoded bits), ok = all(hash(hat) == the
  expected hashes) & converged, errs = popcount(hat ^ rx_orig), merged in
  one of three modes: the first decode (stats [ok, iters, errs, mism]),
  ``retry_program``'s (``failed``: every row re-decoded, the failed ones
  merged) and ``retry_small``'s (``rows``: the re-decoded rows' places in
  the window).

On CPU tensors each function runs its plain PyTorch version (``*_plain``:
the window programs' eager chain, a float32 matmul for the hash); on CUDA
tensors it launches the hand-written kernel ``qtpu_torch/csrc/verify.cu``
(built at first use by ``qtpu_torch._build``, bound with ctypes) or raises.
``launches`` counts each entry point's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qtpu_torch.ldpc.encode import ColumnLayout
from qtpu_torch.window_assembly import _check

__all__ = ["hash", "tail", "hash_plain", "tail_plain", "launches", "LIBRARY",
           "MAX_VH"]

# The kernel library (qtpu_torch/csrc/verify.cu) and the launches of each
# of its entry points since import (or since a caller reset them).
LIBRARY = "verify"
launches = {"verify_hash": 0, "verify_tail": 0}

MAX_P = 1 << 17
MAX_VH = 64      # hash bits the kernel takes (two 32-bit words a lane)
# tail's modes (the kernel's): the first decode, retry_program's merge,
# retry_small's.
FIRST, RETRY, RETRY_SMALL = 0, 1, 2

_U32, _INT, _PTR = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    # x, seed; b; P; vh; out; stream
    "verify_hash": [_PTR, _PTR, _INT, _U32, _INT, _PTR, _PTR],
    # bits, sources; nb, z; rx_pin, pin, rx_orig, seed, expected; vh;
    # converged, iterations, mism, source_row, hat_old, stats_old; mode,
    # rows; P; hat, stats; stream
    "verify_tail": [_PTR, _PTR, _INT, _INT] + [_PTR] * 5 + [_INT]
    + [_PTR] * 6 + [_INT, _INT, _U32] + [_PTR] * 3,
}


def _check_exact_matmul(x: torch.Tensor) -> None:
    # The plain hash is an exact GF(2) product through a float32 matmul:
    # products are 0/1 and sums <= P <= 2^17 < 2^24, exact only without TF32.
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the verify hash needs full-float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _mode(mism, hat, stats, failed, rows) -> int:
    """tail's mode from which of ``mism`` / ``failed`` / ``rows`` is given
    (exactly one; the retries with the previous round's ``hat`` and
    ``stats``)."""
    given = [v is not None for v in (mism, failed, rows)]
    if sum(given) != 1:
        raise ValueError("give exactly one of mism (the first decode), "
                         "failed (retry_program) and rows (retry_small)")
    mode = given.index(True)
    if (hat is None) != (mode == FIRST) or (stats is None) != (mode == FIRST):
        raise ValueError("hat and stats go with failed or rows, and only "
                         "with them")
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
               stats=None, failed=None, rows=None):
    """``tail``'s plain version, on any device."""
    mode = _mode(mism, hat, stats, failed, rows)
    b, dev = bits.shape[0], bits.device
    P = rx_pin.shape[1]
    pay = torch.as_tensor(_payload_columns(layout), device=dev)
    new = bits.reshape(b, layout.nb, layout.z)[:, pay, :].reshape(b, P)
    new = torch.where(pin, rx_pin, new)
    if mode == RETRY_SMALL:
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        rx_orig, exp_hashes = rx_orig[sel], exp_hashes[sel]
    hashes = hash_plain(new, seed)
    ok = (hashes == exp_hashes).all(dim=1) & converged
    errs = (new ^ rx_orig).to(torch.int32).sum(dim=1, dtype=torch.int32)
    st = torch.stack([ok.to(torch.int32), iterations.to(torch.int32), errs],
                     dim=1)
    if mode == FIRST:
        return new, torch.cat([st, mism[:, None]], dim=1)
    if mode == RETRY:
        failed_b = torch.as_tensor(np.asarray(failed).astype(bool),
                                   device=dev)
        ok = stats[:, 0].to(torch.bool) | (failed_b & st[:, 0].to(torch.bool))
        hat_m = torch.where(failed_b[:, None], new, hat)
        iters_m = torch.maximum(stats[:, 1], st[:, 1])
        errs_m = torch.where(failed_b, st[:, 2], stats[:, 2])
        return hat_m, torch.stack([ok.to(torch.int32), iters_m, errs_m,
                                   stats[:, 3]], dim=1)
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

def _entry(name: str):
    """Entry point ``qtpu_<name>`` of the built library, typed."""
    from qtpu_torch import _build
    return _build.entry(LIBRARY, name, tuple(_ARGTYPES[name]))


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call entry point ``name`` with ``args`` on ``dev``'s current stream
    (raises when it fails) and count the launch."""
    from qtpu_torch import _build
    _build.call(LIBRARY, name, tuple(_ARGTYPES[name]), dev, *args)
    launches[name] += 1


def _on_card(dev: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for another."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the verify hash runs on the CPU or a CUDA "
                         f"device, not {dev}")
    return dev.type == "cuda"


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


def _source_rows(mode: int, failed, rows, b: int, B: int) -> np.ndarray:
    """(B,) int32: each window row's decoded row, or -1 where the retry
    leaves it as it was; raises on a map the kernel would race on."""
    if mode == RETRY:
        f = _host(failed, "failed").astype(bool)
        if f.shape != (B,) or b != B:
            raise ValueError(f"failed must be ({B},) for a decode of all "
                             f"{B} rows, got {f.shape} and {b} rows")
        return np.where(f, np.arange(B), -1).astype(np.int32)
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
    _entry("verify_hash")
    out = torch.empty((b, vh), dtype=torch.uint8, device=dev)
    if b:
        _launch("verify_hash", dev, x.data_ptr(), seed.data_ptr(), b, P, vh,
                out.data_ptr())
    return out


def tail(bits, rx_pin, pin, rx_orig, seed, exp_hashes, converged,
         iterations, layout: ColumnLayout, mism=None, *, hat=None,
         stats=None, failed=None, rows=None):
    """(hat (B, P) uint8, stats (B, 4) int32) of Bob's decode of b rows.

    bits (b, nb·z) uint8, converged (b,) bool, iterations (b,) int32: the
    decoder's result; rx_pin (b, P) uint8 and pin (b, P) bool: its pins;
    seed: the (P + Vh - 1,) verify seed; layout: the rung's columns (part 0
    the payload).  rx_orig (B, P) uint8 and exp_hashes (B, Vh) uint8 are
    the window's rows.  The mode:

    - ``mism`` (b,) int32 (B = b): the first decode, stats [ok, iters,
      errs, mism];
    - ``failed`` (B,) host bools (b = B): ``retry_program``'s merge into
      the previous round's ``hat`` and ``stats``: the failed rows' hat,
      ok | old ok and errs, the other rows' as they were, max(old, new)
      iterations on every row, the old mismatch count;
    - ``rows`` (b,) host ints, each row once: ``retry_small``'s: decoded
      row i lands in window row rows[i] with its hat, ok and errs, max(old,
      new) iterations and the old mismatch count; the other rows as they
      were.

    One launch on a card."""
    mode = _mode(mism, hat, stats, failed, rows)
    dev = bits.device
    if not _on_card(dev):
        return tail_plain(bits, rx_pin, pin, rx_orig, seed, exp_hashes,
                          converged, iterations, layout, mism, hat=hat,
                          stats=stats, failed=failed, rows=rows)
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
    src = None
    if mode == FIRST:
        _check(mism, "mism", torch.int32, (b,), dev)
    else:
        _check(hat, "hat", torch.uint8, (B, P), dev)
        _check(stats, "stats", torch.int32, (B, 4), dev)
        src = torch.from_numpy(_source_rows(mode, failed, rows, b, B))
    _entry("verify_tail")
    if src is not None:
        # The row map goes up from pinned memory without a host sync.
        src = src.pin_memory().to(dev, non_blocking=True)
    hat_out = torch.empty((B, P), dtype=torch.uint8, device=dev)
    stats_out = torch.empty((B, 4), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    if B:
        _launch("verify_tail", dev, bits.data_ptr(),
                layout.on(dev)[1].data_ptr(), layout.nb, layout.z,
                rx_pin.data_ptr(), pin.data_ptr(), rx_orig.data_ptr(),
                seed.data_ptr(), exp_hashes.data_ptr(), vh,
                converged.data_ptr(), iterations.data_ptr(), ptr(mism),
                ptr(src), ptr(hat), ptr(stats), mode, B, P,
                hat_out.data_ptr(), stats_out.data_ptr())
    return hat_out, stats_out
