"""Min-sum BP decoding on Hopper: the CUDA kernels' wrapper.

Two kernels, one per schedule, each built at first use by
``qtpu_torch._build`` (CUDA C++ for sm_90a, plain C entry point bound with
ctypes):

- ``bp_layered`` (``qtpu_torch/csrc/bp_layered.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel_layered`` (``alg="layered"``), the
  production decoder of the reference;
- ``bp_flooding`` (``qtpu_torch/csrc/bp_flooding.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel`` (``alg="minsum"``, flooding).

What bounds them on an H100: the per-block decoder state (totals and c2v
messages: ~1.1 MB at n = 65536, ~71 KB at n = 4096) lives in global memory
and every sweep streams it through L2/HBM; at production batch sizes the
state exceeds the 50 MB L2, so both kernels are memory-bound.  The design
answers with one CTA per block looping over sweeps (no launch per sweep, no
host sync), coalesced z-contiguous accesses, per-lane row values in
registers, and a CTA that exits as soon as its own block converges.

On a CPU tensor the decoder runs the plain PyTorch version
(``qtpu_torch.ldpc.decode``); on a CUDA tensor it launches the kernel or
raises.  ``launches[name]`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.ldpc.decode import (BatchDecodeResult, make_flooding_decoder,
                                    make_layered_decoder)

__all__ = ["make_cuda_decoder", "code_tables", "flooding_tables", "launches",
           "KERNELS"]

MAX_DC = 32           # per-lane row arrays held in registers (both kernels)
MAX_THREADS = 512

# The kernel of each schedule and its plain PyTorch version.
KERNELS = {"layered": "bp_layered", "minsum": "bp_flooding"}

# Kernel launches per kernel since import (or since a caller reset them).
launches = {name: 0 for name in KERNELS.values()}


def code_tables(code: QCCode) -> np.ndarray:
    """The layered kernel's int32 code table: row_start[mb+1], then each
    row's edge columns and shifts in ``row_edges`` slot order.  Raises for
    a row with parallel edges (the layered kernel's in-row race freedom
    rests on distinct columns) or wider than MAX_DC."""
    rows = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    start, cols, shifts = [0], [], []
    for i, slots in enumerate(rows):
        c = [int(code.edge_col[e]) for e in slots]
        if len(set(c)) != len(c):
            raise ValueError(f"base row {i} has parallel edges")
        if len(c) > MAX_DC:
            raise ValueError(f"base row {i} has degree {len(c)} > {MAX_DC}")
        cols += c
        shifts += [int(code.edge_shift[e]) for e in slots]
        start.append(len(cols))
    return np.asarray(start + cols + shifts, np.int32)


def flooding_tables(code: QCCode) -> np.ndarray:
    """The flooding kernel's int32 code table.  c2v is stored by row slot
    (edges in ``row_edges`` order, row after row); the table holds
    row_start[mb+1], each row slot's column and shift, col_start[nb+1], and
    each column's edges in ``col_edges`` slot order as (row slot, shift).
    Parallel edges are allowed; raises for a row wider than MAX_DC."""
    rows = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    cols = [[int(e) for e in col if e >= 0] for col in code.col_edges]
    order = [e for slots in rows for e in slots]
    slot_of = {e: k for k, e in enumerate(order)}
    for i, slots in enumerate(rows):
        if len(slots) > MAX_DC:
            raise ValueError(f"base row {i} has degree {len(slots)} > "
                             f"{MAX_DC}")
    row_start = np.cumsum([0] + [len(s) for s in rows])
    col_start = np.cumsum([0] + [len(s) for s in cols])
    col_order = [e for slots in cols for e in slots]
    return np.concatenate([
        row_start, code.edge_col[order], code.edge_shift[order], col_start,
        [slot_of[e] for e in col_order], code.edge_shift[col_order],
    ]).astype(np.int32)


@functools.cache
def _kernel(name: str):
    """The built kernel's C entry point, with its argument types (both
    kernels share one signature)."""
    from qtpu_torch import _build
    fn = getattr(_build.load(name), f"qtpu_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def make_cuda_decoder(code: QCCode, max_iters: int, alpha: float = 0.8125,
                      alg: str = "layered"):
    """``(llr (B,n) f32, syndrome (B,m) uint8) -> BatchDecodeResult`` for
    ``alg`` "layered" or "minsum" (flooding): the Hopper kernel for CUDA
    tensors, the plain decoder for CPU ones.  "sumprod" had no TPU kernel
    (XLA only in the reference): its plain PyTorch decoder is its port and
    runs on every device."""
    if alg == "layered":
        tab_np = code_tables(code)
        plain = make_layered_decoder(code, max_iters, alpha)
    elif alg == "minsum":
        tab_np = flooding_tables(code)
        plain = make_flooding_decoder(code, max_iters, alpha)
    elif alg == "sumprod":
        return make_flooding_decoder(code, max_iters, alpha, alg="sumprod")
    else:
        raise ValueError(f"unknown alg {alg!r}")
    name = KERNELS[alg]
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    max_dc = max(int((row >= 0).sum()) for row in code.row_edges)
    # Layered: one thread per lane of a row; flooding: per (row, lane) pair.
    items = z if alg == "layered" else mb * z
    threads = min(MAX_THREADS, -(-items // 32) * 32)
    tables: dict = {}

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        if llr.device.type == "cpu" and syndrome.device.type == "cpu":
            return plain(llr, syndrome)
        if not (llr.is_cuda and syndrome.device == llr.device):
            raise ValueError(f"llr on {llr.device}, syndrome on "
                             f"{syndrome.device}: need both on one CUDA "
                             f"device (or both on the CPU)")
        B = llr.shape[0]
        if llr.dtype != torch.float32 or llr.shape != (B, nb * z):
            raise ValueError(f"llr must be float32 (B, {nb * z}), got "
                             f"{llr.dtype} {tuple(llr.shape)}")
        if syndrome.dtype != torch.uint8 or syndrome.shape != (B, mb * z):
            raise ValueError(f"syndrome must be uint8 (B, {mb * z}), got "
                             f"{syndrome.dtype} {tuple(syndrome.shape)}")
        if not (llr.is_contiguous() and syndrome.is_contiguous()):
            raise ValueError("llr and syndrome must be contiguous")
        dev = llr.device
        if dev not in tables:
            tables[dev] = torch.from_numpy(tab_np).to(dev)
        bits = torch.empty((B, nb * z), dtype=torch.uint8, device=dev)
        converged = torch.empty((B,), dtype=torch.bool, device=dev)
        iterations = torch.empty((B,), dtype=torch.int32, device=dev)
        if B == 0:
            return BatchDecodeResult(bits, converged, iterations)
        totals = torch.empty((B, nb * z), dtype=torch.float32, device=dev)
        c2v = torch.empty((B, E * z), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _kernel(name)(llr.data_ptr(), syndrome.data_ptr(),
                               tables[dev].data_ptr(), totals.data_ptr(),
                               c2v.data_ptr(), bits.data_ptr(),
                               converged.data_ptr(), iterations.data_ptr(), B,
                               mb, nb, z, E, max_dc, int(max_iters),
                               float(alpha), threads, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed (code {rc})")
        launches[name] += 1
        return BatchDecodeResult(bits=bits, converged=converged,
                                 iterations=iterations)

    return decode
