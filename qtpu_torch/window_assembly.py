"""Bob's disclosure pins and channel LLRs, and their Hopper kernel.

Counterpart of the pin and LLR assembly the reference's jitted Bob programs
fuse (``qtpu/window_programs.py``: ``_pin_masks``, the pin scatters and the
mismatch count of ``_bob_core``, the LLR assembly of ``_decode_core`` and
of its retries):

- ``pin_llr``: Bob's first decode.  From the received payload, Alice's
  disclosed shortening and test bits and the per-block test offsets, the
  pinned payload ``rx_pin``, the pin mask, the per-block mismatch count
  (every disclosed bit is a ground-truth channel sample) and the (b, n)
  float32 LLR in base-column order.
- ``llr``: the retries.  The LLR from a given ``rx_pin`` and pin mask.

The disclosure family is affine: shortening position i < s of every block
is (a·i mod P + b_s) mod P, test position Sm + j < Sm + k of block r is
(a·(Sm + j) mod P + boff_t[r]) mod P (``disclosure_positions``).  Payload
LLRs are (1 - 2·rx_pin)·(pin ? BIG_LLR : qmag), shortening-fill columns
(1 - 2·fill)·BIG_LLR, punctured columns 0; a ``ColumnLayout``
(``qtpu_torch.ldpc.encode``) says which base column is which.

On CPU tensors each function runs its plain PyTorch version (``*_plain``:
the window programs' scatters and elementwise masks); on CUDA tensors it
launches the hand-written kernel ``qtpu_torch/csrc/pin_llr.cu`` (built at
first use by ``qtpu_torch._build``, bound with ctypes) or raises.
``launches`` counts each entry point's launches.
"""

from __future__ import annotations

import ctypes

import torch

from qtpu_torch import _build
from qtpu_torch.ldpc.decode import BIG_LLR
from qtpu_torch.ldpc.encode import ColumnLayout

__all__ = ["pin_llr", "llr", "pin_llr_plain", "llr_plain",
           "disclosure_positions", "launches", "LIBRARY"]

# The kernel library (qtpu_torch/csrc/pin_llr.cu) and the launches of each
# of its entry points since import (or since a caller reset them).
LIBRARY = "pin_llr"
launches = {"pin_llr": 0, "llr": 0}

# The affine positions' arithmetic (and the kernel's 64-bit products)
# assume P <= 2^17.
MAX_P = 1 << 17

_U32, _INT, _LL, _PTR, _FLOAT = (ctypes.c_uint32, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_float)
_ARGTYPES = {
    # rx, short, its stride, test, its stride, boff_t; ainv, b_s, s, k,
    # s_max; fill, its stride, sources; b, nb, z; P; qmag; rx_pin, pin,
    # mism, llr; stream
    "pin_llr": (_PTR, _PTR, _LL, _PTR, _LL, _PTR) + (_U32,) * 5
    + (_PTR, _LL, _PTR) + (_INT,) * 3 + (_U32, _FLOAT) + (_PTR,) * 5,
    # rx_pin, pin, fill, its stride, sources; b, nb, z; P; qmag; llr; stream
    "llr": (_PTR, _PTR, _PTR, _LL, _PTR) + (_INT,) * 3 + (_U32, _FLOAT)
    + (_PTR,) * 2,
}


def disclosure_positions(affine, boff_t: torch.Tensor, P: int, s_max: int,
                         k_max: int):
    """(pos_s (s_max,), pos_t (b, k_max)) int64 on ``boff_t``'s device: the
    shortening family is window-level (stride a, offset b_s of ``affine`` =
    (a, a^-1, b_s)), the test family continues the same stride at the
    per-block offsets ``boff_t``."""
    a, _, b_s = (int(v) for v in affine)
    dev = boff_t.device
    i = torch.arange(s_max, dtype=torch.int64, device=dev)
    pos_s = (a * i % P + b_s) % P
    j = torch.arange(s_max, s_max + k_max, dtype=torch.int64, device=dev)
    pos_t = ((a * j % P)[None, :] + boff_t[:, None]) % P
    return pos_s, pos_t


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the CPU path and the kernel's oracle.

def _pin_masks(affine, s: int, k: int, s_max: int, boff_t, P: int):
    """Elementwise pin masks: position p is a shortening pin iff
    a^-1(p - b) mod P < s, a test pin iff its per-block inverse lands in
    [Sm, Sm + k)."""
    _, ainv, b_s = (int(v) for v in affine)
    p_idx = torch.arange(P, dtype=torch.int64, device=boff_t.device)
    inv_s = ainv * ((p_idx + P - b_s) % P) % P
    m_short = (inv_s < s)[None, :]
    inv_t = ainv * ((p_idx[None, :] + P - boff_t[:, None]) % P) % P
    m_test = (inv_t >= s_max) & (inv_t < s_max + k)
    return m_short | m_test


def llr_plain(rx_pin, pin, fill, qmag, layout: ColumnLayout) -> torch.Tensor:
    """``llr``'s plain version, on any device."""
    b = rx_pin.shape[0]
    z = layout.z
    sign = 1.0 - 2.0 * rx_pin.to(torch.float32)
    mag = torch.where(pin, BIG_LLR, float(qmag))    # float32
    parts = [(sign * mag).reshape(b, -1, z)]
    if layout.widths[1]:
        ssign = 1.0 - 2.0 * fill.to(torch.float32)
        parts.append((ssign * BIG_LLR).reshape(b, -1, z))
    if layout.widths[2]:
        parts.append(torch.zeros((b, layout.widths[2], z),
                                 dtype=torch.float32, device=rx_pin.device))
    out = torch.cat(parts, dim=1)[:, layout.on(rx_pin.device)[0], :]
    return out.reshape(b, layout.nb * z).contiguous()


def pin_llr_plain(rx, short_alice, test_alice, boff_t, affine, s: int, k: int,
                  s_max: int, fill, qmag, layout: ColumnLayout):
    """``pin_llr``'s plain version, on any device."""
    P = rx.shape[1]
    pos_s, pos_t = disclosure_positions(affine, boff_t, P, s_max,
                                        test_alice.shape[1])
    # Pin disclosed positions to Alice's (true) values: disclosure doubles
    # as shortening.  Only the first s / k columns of the static-width
    # disclosures are live.
    rx_pin = rx.clone()
    rx_pin[:, pos_s[:s]] = short_alice[:, :s]
    rx_pin.scatter_(1, pos_t[:, :k], test_alice[:, :k])
    pin = _pin_masks(affine, s, k, s_max, boff_t, P)
    # Every disclosed bit is a ground-truth channel sample.
    mism = (rx_pin ^ rx).to(torch.int32).sum(dim=1, dtype=torch.int32)
    return rx_pin, pin, mism, llr_plain(rx_pin, pin, fill, qmag, layout)


# ---------------------------------------------------------------------------
# The kernel's wrapper.

def _on_card(dev: torch.device) -> bool:
    return _build.on_card(dev, "pin/LLR assembly")


def _check(t: torch.Tensor, what: str, dtype, shape, dev) -> None:
    """A contiguous ``dtype`` tensor of ``shape`` (None: any size) on
    ``dev``."""
    if t.dtype != dtype or t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{what} must be {dtype} of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _payload_width(layout: ColumnLayout) -> int:
    """P; raises unless ``layout`` is payload | shortened | punctured."""
    if len(layout.widths) != 3:
        raise ValueError(f"the layout must have 3 parts (payload, "
                         f"shortened, punctured), not {len(layout.widths)}")
    return layout.widths[0] * layout.z


def _fill_arg(fill, b: int, dev, layout: ColumnLayout):
    """(pointer, row bytes) of the shortening fill, checked; (None, 0)
    without shortened columns."""
    width = layout.widths[1] * layout.z
    if not width:
        if fill is not None and fill.numel():
            raise ValueError("a fill for a layout without shortened columns")
        return None, 0
    if fill is None:
        raise ValueError("the layout's shortened columns need a fill")
    _check(fill, "fill", torch.uint8, (b, width), dev)
    return fill.data_ptr(), width


def llr(rx_pin, pin, fill, qmag, layout: ColumnLayout) -> torch.Tensor:
    """(b, n) float32 LLR in base-column order from the pinned payload
    ``rx_pin`` (b, P) uint8, its pin mask ``pin`` (b, P) bool, the
    shortening fill ``fill`` ((b, Ns·z) uint8, or None without shortened
    columns) and the channel magnitude ``qmag``.  One launch on a card."""
    dev = rx_pin.device
    if not _on_card(dev):
        return llr_plain(rx_pin, pin, fill, qmag, layout)
    b = rx_pin.shape[0]
    shape = (b, _payload_width(layout))
    _check(rx_pin, "rx_pin", torch.uint8, shape, dev)
    _check(pin, "pin", torch.bool, shape, dev)
    fill_ptr, fill_stride = _fill_arg(fill, b, dev, layout)
    _build.entry(LIBRARY, "llr", _ARGTYPES["llr"])
    out = torch.empty((b, layout.nb * layout.z), dtype=torch.float32,
                      device=dev)
    if b:
        _build.launch(LIBRARY, "llr", _ARGTYPES["llr"], launches, dev,
                      rx_pin.data_ptr(), pin.data_ptr(), fill_ptr,
                      fill_stride, layout.on(dev)[1].data_ptr(), b,
                      layout.nb, layout.z, shape[1], float(qmag),
                      out.data_ptr())
    return out


def pin_llr(rx, short_alice, test_alice, boff_t, affine, s: int, k: int,
            s_max: int, fill, qmag, layout: ColumnLayout):
    """(rx_pin (b, P) uint8, pin (b, P) bool, mism (b,) int32, llr (b, n)
    float32) of Bob's first decode.  rx: the received payload (b, P)
    uint8; short_alice (b, >= s) and test_alice (b, k_max >= k): Alice's
    disclosed bits; boff_t (b,) int64: the test offsets; affine = (a, a^-1,
    b_s), s, k, s_max: the header's disclosure family
    (``disclosure_positions``); fill, qmag, layout as for ``llr``.  Where a
    position is both a shortening and a test pin the test value wins.  One
    launch on a card."""
    dev = rx.device
    if not _on_card(dev):
        return pin_llr_plain(rx, short_alice, test_alice, boff_t, affine, s,
                             k, s_max, fill, qmag, layout)
    b = rx.shape[0]
    P = _payload_width(layout)
    shape = (b, P)
    _check(rx, "rx", torch.uint8, shape, dev)
    _check(short_alice, "short_alice", torch.uint8, (b, None), dev)
    _check(test_alice, "test_alice", torch.uint8, (b, None), dev)
    _check(boff_t, "boff_t", torch.int64, (b,), dev)
    _, ainv, b_s = (int(v) for v in affine)
    if not (0 < P <= MAX_P and 0 <= ainv < P and 0 <= b_s < P):
        raise ValueError(f"affine {tuple(affine)} outside [0, P = {P}) or P "
                         f"> {MAX_P}")
    if not (0 <= s <= short_alice.shape[1] and 0 <= k <= test_alice.shape[1]
            and 0 <= s_max and s_max + k <= P):
        raise ValueError(f"s = {s}, k = {k} and s_max = {s_max} do not fit "
                         f"disclosures of {tuple(short_alice.shape)} and "
                         f"{tuple(test_alice.shape)} in P = {P}")
    fill_ptr, fill_stride = _fill_arg(fill, b, dev, layout)
    _build.entry(LIBRARY, "pin_llr", _ARGTYPES["pin_llr"])
    rx_pin = torch.empty(shape, dtype=torch.uint8, device=dev)
    pin = torch.empty(shape, dtype=torch.bool, device=dev)
    mism = torch.empty((b,), dtype=torch.int32, device=dev)
    out = torch.empty((b, layout.nb * layout.z), dtype=torch.float32,
                      device=dev)
    if b:
        _build.launch(LIBRARY, "pin_llr", _ARGTYPES["pin_llr"], launches,
                      dev, rx.data_ptr(), short_alice.data_ptr(),
                      short_alice.shape[1], test_alice.data_ptr(),
                      test_alice.shape[1], boff_t.data_ptr(), ainv, b_s, s,
                      k, s_max, fill_ptr, fill_stride,
                      layout.on(dev)[1].data_ptr(), b, layout.nb, layout.z,
                      P, float(qmag), rx_pin.data_ptr(), pin.data_ptr(),
                      mism.data_ptr(), out.data_ptr())
    return rx_pin, pin, mism, out
