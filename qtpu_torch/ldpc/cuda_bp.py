"""Layered min-sum BP decoding on Hopper: the CUDA kernel's wrapper.

Replaces ``qtpu/ldpc/pallas_bp.py::kernel_layered`` (through
``make_pallas_decoder(alg="layered")``), the production decoder of the
reference.  The kernel is ``qtpu_torch/csrc/bp_layered.cu`` (CUDA C++ for
sm_90a, plain C entry point bound with ctypes, built at first use by
``qtpu_torch._build``).

What bounds it on an H100: the per-block decoder state (256 KB of totals and
~0.9 MB of c2v messages at n = 65536) does not fit the 227 KB of shared
memory a CTA may use, so unlike the TPU kernel (all state in VMEM) it lives
in global memory; each sweep streams ~4 MB per block, and at B = 128 the
~155 MB of state exceeds the 50 MB L2 — the kernel is memory-bound.  The
design answers with one CTA per block looping over sweeps (no launch per
sweep, no host sync), coalesced z-contiguous accesses, per-lane row values
in registers, and a CTA that exits as soon as its own block converges.

On a CPU tensor the decoder runs the plain PyTorch version
(``qtpu_torch.ldpc.decode.make_layered_decoder``); on a CUDA tensor it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.ldpc.decode import BatchDecodeResult, make_layered_decoder

__all__ = ["make_cuda_decoder", "code_tables", "launches"]

MAX_DC = 32           # per-lane row arrays held in registers (bp_layered.cu)
MAX_THREADS = 512

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def code_tables(code: QCCode) -> np.ndarray:
    """The kernel's int32 code table: row_start[mb+1], then each row's edge
    columns and shifts in ``row_edges`` slot order.  Raises for a row with
    parallel edges (the kernel's in-row race freedom rests on distinct
    columns) or wider than MAX_DC."""
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


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its argument types."""
    from qtpu_torch import _build
    fn = _build.load("bp_layered").qtpu_bp_layered
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def make_cuda_decoder(code: QCCode, max_iters: int, alpha: float = 0.8125):
    """``(llr (B,n) f32, syndrome (B,m) uint8) -> BatchDecodeResult``:
    the Hopper kernel for CUDA tensors, the plain decoder for CPU ones."""
    tab_np = code_tables(code)
    plain = make_layered_decoder(code, max_iters, alpha)
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    max_dc = max(int((row >= 0).sum()) for row in code.row_edges)
    threads = min(MAX_THREADS, -(-z // 32) * 32)
    tables: dict = {}

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        global launches
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
            rc = _kernel()(llr.data_ptr(), syndrome.data_ptr(),
                           tables[dev].data_ptr(), totals.data_ptr(),
                           c2v.data_ptr(), bits.data_ptr(),
                           converged.data_ptr(), iterations.data_ptr(), B,
                           mb, nb, z, E, max_dc, int(max_iters),
                           float(alpha), threads, stream)
        if rc != 0:
            raise RuntimeError(f"bp_layered launch failed (code {rc})")
        launches += 1
        return BatchDecodeResult(bits=bits, converged=converged,
                                 iterations=iterations)

    return decode
