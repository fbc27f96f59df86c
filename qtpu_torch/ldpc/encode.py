"""Batched LDPC syndrome encoding in PyTorch, and its Hopper kernel.

Counterpart of ``qtpu/ldpc/encode.py``: with a quasi-cyclic code the sparse
GF(2) mat-vec ``syndrome = H · bits`` is a static sequence of circulant
rolls and XORs, one per base edge: check (i, c) touches variable
(j, (c + s) mod z) for a base edge (i, j, s).

The encoder also takes a codeword in parts, as Alice's window program
holds it (``qtpu/window_programs.py``, ``_build_codeword``): a
``ColumnLayout`` says which column of which part (payload, shortening
fill, puncture pad) each base column is, so the codeword itself is never
assembled on a card.

On a CPU tensor an encoder runs its plain PyTorch version (``encode_plain``
and ``encode_parts_plain``: the roll-XOR, after assembling the codeword
the way ``_build_codeword`` does); on a CUDA tensor it launches the
hand-written kernel ``qtpu_torch/csrc/qc_encode.cu`` (built at first use
by ``qtpu_torch._build``, bound with ctypes) or raises.
``launches["qc_encode"]`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qtpu_torch import _build
from qtpu_torch.ldpc.codes import QCCode, _group_edges

__all__ = ["make_batch_encoder", "make_parts_encoder", "encode_syndrome_batch",
           "encode_plain", "encode_parts_plain", "ColumnLayout", "launches",
           "launch_plan", "random_qc_code", "LIBRARY"]

# The kernel library (qtpu_torch/csrc/qc_encode.cu) and its launches since
# import (or since a caller reset them).
LIBRARY = "qc_encode"
launches = {"qc_encode": 0}

# Parts a codeword may come in, and the widest circulant the kernel takes
# (a block's columns staged in shared memory in groups where they do not
# fit at once: z = 8192 at nb = 32; no ladder of the repo goes past 4096).
MAX_PARTS = 3
MAX_Z = 8192

_INT, _PTR = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    # parts 0-2, their widths in columns, table, b, mb, nb, z, E, out;
    # stream
    "qc_encode": (_PTR,) * 3 + (_INT,) * 3 + (_PTR,) + (_INT,) * 5
    + (_PTR, _PTR),
    # parts 0-2, their widths, b, mb, nb, z, E, int32[8] out
    "qc_encode_plan": (_PTR,) * 3 + (_INT,) * 8 + (_PTR,),
}
# The kernel's bodies (csrc/qc_encode.cu): every part of a block staged by
# TMA bulk copies, some of them, or none (the CTA's threads stage them).
BODIES = ("bulk", "mixed", "threads")


class ColumnLayout:
    """Where each base column of a codeword lies: column ``sources[1, j]``
    of part ``sources[0, j]``, the parts holding ``part_cols[p]`` (base
    column indices, in that order) side by side.  ``inv[j]`` is base column
    j's position in the parts' concatenation (the reference's
    ``inv_order``)."""

    def __init__(self, nb: int, z: int, *part_cols):
        if not 0 < len(part_cols) <= MAX_PARTS:
            raise ValueError(f"1 to {MAX_PARTS} parts, got {len(part_cols)}")
        cols = [np.asarray(c, np.int64).reshape(-1) for c in part_cols]
        order = np.concatenate(cols)
        if not np.array_equal(np.sort(order), np.arange(nb)):
            raise ValueError(f"the parts' columns must hold each of the "
                             f"{nb} base columns once")
        self.nb, self.z = int(nb), int(z)
        self.widths = tuple(int(c.size) for c in cols)
        self.inv = np.argsort(order)
        part = np.repeat(np.arange(len(cols)), self.widths)
        within = np.concatenate([np.arange(w) for w in self.widths])
        self.sources = np.stack([part[self.inv], within[self.inv]]).astype(
            np.int32)
        self._on = {}

    @classmethod
    def whole(cls, code: QCCode) -> "ColumnLayout":
        """One part: the codeword itself."""
        return cls(code.nb, code.z, np.arange(code.nb))

    def on(self, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv int64, sources int32 (2, nb)) on ``dev``, made once."""
        if dev not in self._on:
            self._on[dev] = (torch.as_tensor(self.inv, device=dev),
                             torch.as_tensor(self.sources, device=dev))
        return self._on[dev]

    def check_parts(self, parts, b: int, dev) -> list:
        """``parts`` (a tensor, or None for a part of no columns) as uint8
        (b, width · z) tensors on ``dev``, contiguous; raises on anything
        else.  A part's bytes are bits: the encoders read each byte's
        lowest bit only (not checked: it would cost a pass over them)."""
        what = "codeword"
        if len(parts) != len(self.widths):
            raise ValueError(f"{len(self.widths)} {what} parts, got "
                             f"{len(parts)}")
        out = []
        for p, (t, w) in enumerate(zip(parts, self.widths)):
            if t is None and w == 0:
                out.append(None)
                continue
            if t is None:
                raise ValueError(f"{what} part {p} is missing")
            if t.dtype != torch.uint8 or t.shape != (b, w * self.z):
                raise ValueError(f"{what} part {p} must be torch.uint8 "
                                 f"({b}, {w * self.z}), got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.device != dev:
                raise ValueError(f"{what} part {p} is on {t.device}, not "
                                 f"{dev}")
            if not t.is_contiguous():
                raise ValueError(f"{what} part {p} must be contiguous")
            out.append(t if w else None)
        return out

    def assemble_plain(self, parts) -> torch.Tensor:
        """(b, nb · z): the parts' columns in base-column order (the
        reference's column concatenation and one static permutation)."""
        given = [t for t, w in zip(parts, self.widths) if w]
        b = given[0].shape[0]
        x = torch.cat([t.reshape(b, -1, self.z) for t in given], dim=1)
        return x[:, self.on(x.device)[0], :].reshape(b, self.nb * self.z)


def random_qc_code(z: int, nb: int, mb: int) -> QCCode:
    """A QC code of any lift ``z``, made from seed ``z``, to hold the
    encoder at shapes no ladder has (z not a multiple of 16, z = 8,192):
    every base column once in row c % mb, nb more edges at random, and
    edges (0, 0) and (1, 1) twice (parallel edges, which cancel)."""
    rng = np.random.default_rng(z)
    rows = np.concatenate([np.arange(nb) % mb, rng.integers(0, mb, nb),
                           [0, 1]]).astype(np.int32)
    cols = np.concatenate([np.arange(nb), rng.permutation(nb),
                           [0, 1]]).astype(np.int32)
    return QCCode(z=z, mb=mb, nb=nb, edge_row=rows, edge_col=cols,
                  edge_shift=rng.integers(0, z, rows.size).astype(np.int32),
                  row_edges=_group_edges(rows, mb),
                  col_edges=_group_edges(cols, nb))


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the CPU path and the kernel's oracle.

def encode_plain(code: QCCode, bits: torch.Tensor) -> torch.Tensor:
    """(B, n) -> (B, m) uint8 syndromes by roll + XOR, one per base edge,
    on any device; each byte's lowest bit is its bit, as the kernel reads
    it."""
    b = bits.shape[0]
    mb, nb, z = code.mb, code.nb, code.z
    x = bits.to(torch.uint8).reshape(b, nb, z) & 1
    syn = [None] * mb
    for i, j, s in zip(code.edge_row.tolist(), code.edge_col.tolist(),
                       code.edge_shift.tolist()):
        # Check (i, zc) touches variable (j, (zc + s) % z).
        contrib = torch.roll(x[:, j], -s, dims=1)
        syn[i] = contrib if syn[i] is None else syn[i] ^ contrib
    return torch.stack(syn, dim=1).reshape(b, mb * z)


def encode_parts_plain(code: QCCode, layout: ColumnLayout,
                       parts) -> torch.Tensor:
    """The syndromes of the codeword ``layout`` assembles from ``parts``,
    on any device."""
    return encode_plain(code, layout.assemble_plain(parts))


# ---------------------------------------------------------------------------
# The kernel's wrapper.

def _on_card(dev: torch.device) -> bool:
    return _build.on_card(dev, "the encoder")


def code_table(code: QCCode, layout: ColumnLayout) -> np.ndarray:
    """The kernel's int32 table: row_start[mb + 1] padded to an even count,
    then (position, shift mod z) for each edge grouped by base row
    (parallel edges kept: they cancel), padded to whole 16 bytes.  An
    edge's position is its base column's place among the parts' columns
    side by side (``layout.inv``), where the kernel stages it."""
    order = np.argsort(code.edge_row, kind="stable")
    start = np.searchsorted(code.edge_row[order], np.arange(code.mb + 1))
    head = np.zeros((code.mb + 2) & ~1, np.int64)
    head[:code.mb + 1] = start
    edges = np.stack([layout.inv[code.edge_col[order]],
                      code.edge_shift[order] % code.z], axis=1)
    table = np.concatenate([head, edges.reshape(-1)])
    return np.concatenate([table, np.zeros(-table.size % 4, np.int64)]
                          ).astype(np.int32)


def _part_args(layout: ColumnLayout, given) -> list:
    """The entry points' first six arguments: the parts' pointers (None for
    a part of no columns) and widths, padded to MAX_PARTS."""
    pad = MAX_PARTS - len(given)
    return ([None if t is None else t.data_ptr() for t in given]
            + [None] * pad + list(layout.widths) + [0] * pad)


def launch_plan(code: QCCode, layout: ColumnLayout, parts) -> dict:
    """The launch the kernel makes for ``parts`` (CUDA tensors, as
    ``make_parts_encoder``'s encoder takes them): grid, threads, dynamic
    shared memory a CTA, stages, columns a stage, column groups a block,
    and which body stages the parts (``BODIES``)."""
    first = next(t for t in parts if t is not None)
    dev, b = first.device, first.shape[0]
    given = layout.check_parts(parts, b, dev)
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(dev):
        rc = _build.entry(LIBRARY, "qc_encode_plan",
                          _ARGTYPES["qc_encode_plan"])(
            *_part_args(layout, given), b, code.mb, code.nb, code.z,
            code.num_edges, out)
    if rc != 0:
        raise RuntimeError(f"qc_encode_plan failed (code {rc})")
    keys = ("grid", "threads", "smem", "stages", "group", "groups")
    return dict(zip(keys, out[:6]), body=BODIES[out[7]])


def make_parts_encoder(code: QCCode, layout: ColumnLayout):
    """Build ``encode(*parts) -> (b, m) uint8``: the syndromes of the
    codeword ``layout`` assembles from ``parts`` (uint8 (b, width · z) of
    bits, or None for a part of no columns; each byte's lowest bit is
    read).  CPU parts take the plain version; CUDA parts launch the kernel
    once, or raise."""
    if (layout.nb, layout.z) != (code.nb, code.z):
        raise ValueError(f"layout of {layout.nb} x {layout.z} for a code of "
                         f"{code.nb} x {code.z}")
    table_np = code_table(code, layout)
    tables: dict = {}

    def encode(*parts) -> torch.Tensor:
        first = next((t for t in parts if t is not None), None)
        if first is None:
            raise ValueError("no part holds a column")
        dev = first.device
        if not _on_card(dev):
            return encode_parts_plain(code, layout, parts)
        b = first.shape[0]
        given = layout.check_parts(parts, b, dev)
        if code.z > MAX_Z:
            raise ValueError(f"z = {code.z} > {MAX_Z}: the kernel stages "
                             f"columns in shared memory")
        _build.entry(LIBRARY, "qc_encode", _ARGTYPES["qc_encode"])
        out = torch.empty((b, code.m), dtype=torch.uint8, device=dev)
        if dev not in tables:
            tables[dev] = torch.from_numpy(table_np).to(dev)
        if b:
            _build.launch(LIBRARY, "qc_encode", _ARGTYPES["qc_encode"],
                          launches, dev, *_part_args(layout, given),
                          tables[dev].data_ptr(), b, code.mb, code.nb,
                          code.z, code.num_edges, out.data_ptr())
        return out

    return encode


def make_batch_encoder(code: QCCode):
    """Build a ``(B, n) uint8 -> (B, m) uint8`` syndrome encoder: the
    codeword as its one part."""
    return make_parts_encoder(code, ColumnLayout.whole(code))


def encode_syndrome_batch(code: QCCode, bits: np.ndarray) -> np.ndarray:
    """Convenience eager wrapper (tests): (B, n) numpy bits -> (B, m) uint8
    syndromes, encoded on the CPU."""
    return make_batch_encoder(code)(torch.from_numpy(np.asarray(bits))).numpy()
