"""Min-sum BP decoding on Hopper: the CUDA kernels' wrapper.

Two kernels, one per schedule, each built at first use by
``qtpu_torch._build`` (CUDA C++ for sm_90a, plain C entry point bound with
ctypes):

- ``bp_layered`` (``qtpu_torch/csrc/bp_layered.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel_layered`` (``alg="layered"``), the
  production decoder of the reference.  A code block's whole decoder state
  (totals and compact check-node state) lives in the shared memory of a
  thread-block cluster of C CTAs; the wrapper picks C from the code's shape
  (``layered_plan``) and allocates only the outputs.
- ``bp_flooding`` (``qtpu_torch/csrc/bp_flooding.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel`` (``alg="minsum"``, flooding).  One CTA
  per block with its state (~71 KB at n = 4096) in global scratch that
  every round streams through L2.

On a CPU tensor the decoder runs the plain PyTorch version
(``qtpu_torch.ldpc.decode``); on a CUDA tensor it launches the kernel or
raises.  ``launches[name]`` counts each kernel's launches and
``launch_batches[name]`` how many launches ran at each batch size.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.ldpc.decode import (BatchDecodeResult, make_flooding_decoder,
                                    make_layered_decoder)

__all__ = ["make_cuda_decoder", "code_tables", "flooding_tables", "launches",
           "launch_batches", "KERNELS", "LayeredPlan", "layered_plan"]

MAX_DC = 32           # per-lane row arrays held in registers (both kernels)
MAX_THREADS = 512
# Cluster sizes the layered kernel may use: 8 is the portable limit, 16
# needs the non-portable attribute (the C side sets it).  From 8 CTAs per
# cluster on, its CTAs are narrow: at most 256 threads, 3 to an SM.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
NARROW_FROM_CLUSTER, NARROW_THREADS = 8, 256

# The kernel of each schedule and its plain PyTorch version.
KERNELS = {"layered": "bp_layered", "minsum": "bp_flooding"}

# Kernel launches per kernel since import (or since a caller reset them),
# and per kernel the number of launches at each batch size.
launches = {name: 0 for name in KERNELS.values()}
launch_batches = {name: collections.Counter() for name in KERNELS.values()}

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "bp_layered": [_PTR] * 6 + [_INT] * 7 + [_FLOAT] + [_INT] * 3 + [_PTR],
    "bp_flooding": [_PTR] * 8 + [_INT] * 7 + [_FLOAT, _INT, _PTR],
}


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


class LayeredPlan(NamedTuple):
    """How the layered kernel runs a code on one device."""
    cluster: int        # CTAs per code block
    smem: int           # dynamic shared memory per CTA, bytes
    threads: int        # threads per CTA
    max_clusters: int   # cudaOccupancyMaxActiveClusters at this shape


@functools.cache
def _kernel(name: str):
    """The built kernel's C entry point, with its argument types."""
    from qtpu_torch import _build
    fn = getattr(_build.load(name), f"qtpu_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


@functools.cache
def _layered_lib():
    """The layered kernel's library with its planning functions typed."""
    from qtpu_torch import _build
    lib = _build.load("bp_layered")
    lib.qtpu_bp_layered_smem.restype = ctypes.c_longlong
    lib.qtpu_bp_layered_smem.argtypes = [_INT] * 5
    lib.qtpu_bp_layered_smem_optin.restype = _INT
    lib.qtpu_bp_layered_smem_optin.argtypes = [_INT]
    lib.qtpu_bp_layered_max_clusters.restype = _INT
    lib.qtpu_bp_layered_max_clusters.argtypes = [_INT] * 5
    return lib


def _max_dc(code: QCCode) -> int:
    return max(int((row >= 0).sum()) for row in code.row_edges)


@functools.cache
def _cluster_shape(mb: int, nb: int, z: int, E: int, max_dc: int,
                   cluster: int, device: int):
    """(smem bytes, threads, max active clusters) of the layered kernel at
    ``cluster`` CTAs per block on CUDA device ``device``, or None when the
    cluster does not split z into power-of-two parts of >= 32 lanes or a
    CTA's share of the state exceeds the shared memory it may opt in to."""
    zc = z // cluster
    if cluster > 1 and (z % cluster or zc < 32 or zc & (zc - 1)):
        return None
    lib = _layered_lib()
    smem = int(lib.qtpu_bp_layered_smem(mb, nb, z, E, cluster))
    if not 0 < smem <= lib.qtpu_bp_layered_smem_optin(device):
        return None
    limit = NARROW_THREADS if cluster >= NARROW_FROM_CLUSTER else MAX_THREADS
    threads = min(limit, -(-zc // 32) * 32)
    with torch.cuda.device(device):
        active = lib.qtpu_bp_layered_max_clusters(max_dc, z, cluster,
                                                  threads, smem)
    return smem, threads, active


def layered_plan(code: QCCode, device, batch: int,
                 cluster: int | None = None) -> LayeredPlan:
    """The layered kernel's launch shape for ``batch`` blocks of ``code``
    on CUDA ``device`` (or at the given ``cluster`` size).

    One CTA per block when the whole state fits one CTA's shared memory
    (no distributed shared memory, CTA barriers).  Otherwise the cluster
    size, up to the portable 8, that keeps the most blocks resident
    (min(batch, cudaOccupancyMaxActiveClusters)), the larger on a tie: the
    kernel is bound by latency per base row, so at equal residency a block
    spread over more SMs (and warps) sweeps faster, while at large batch
    the residency decides (chip_smoke.py phase 3 times every size).
    Raises ValueError when no cluster size fits the shared memory and
    RuntimeError when the card cannot schedule one such cluster."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (code.mb, code.nb, code.z, code.num_edges, _max_dc(code))
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    shapes = {C: sh for C in sizes
              if (sh := _cluster_shape(*args, C, index)) is not None}
    if not shapes:
        raise ValueError(
            f"the layered kernel's state of a code with nb={code.nb}, "
            f"mb={code.mb}, z={code.z}, E={code.num_edges} fits no cluster "
            f"size {sizes} in the shared memory of a CTA on {dev}")
    if cluster is None:
        if 1 in shapes:
            cluster = 1
        else:
            cands = [C for C in shapes if C <= 8] or list(shapes)
            cluster = max(cands, key=lambda C: (
                min(batch, max(shapes[C][2], 0)), C))
    smem, threads, active = shapes[cluster]
    if active <= 0:
        raise RuntimeError(
            f"bp_layered: no cluster of {cluster} CTAs x {smem} bytes can "
            f"be scheduled on {dev} (cudaOccupancyMaxActiveClusters -> "
            f"{active})")
    return LayeredPlan(cluster, smem, threads, active)


def _outputs(B: int, n: int, dev):
    return (torch.empty((B, n), dtype=torch.uint8, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _run(name: str, dev, *args) -> None:
    """Call kernel ``name``'s C entry point with ``args`` and the current
    stream of ``dev``; raises when the launch fails."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def _layered(code: QCCode, table: torch.Tensor, llr: torch.Tensor,
             syndrome: torch.Tensor, max_iters: int, alpha: float,
             plan: LayeredPlan) -> BatchDecodeResult:
    """One launch of the layered kernel on checked CUDA inputs at
    ``plan``'s cluster size.  Counts nothing: ``make_cuda_decoder``'s
    decoder does."""
    B, dev = llr.shape[0], llr.device
    bits, converged, iterations = _outputs(B, code.n, dev)
    _run("bp_layered", dev, llr.data_ptr(), syndrome.data_ptr(),
         table.data_ptr(), bits.data_ptr(), converged.data_ptr(),
         iterations.data_ptr(), B, code.mb, code.nb, code.z, code.num_edges,
         _max_dc(code), int(max_iters), float(alpha), plan.cluster,
         plan.threads, plan.smem)
    return BatchDecodeResult(bits, converged, iterations)


def _flooding(code: QCCode, table: torch.Tensor, llr: torch.Tensor,
              syndrome: torch.Tensor, max_iters: int,
              alpha: float) -> BatchDecodeResult:
    """One launch of the flooding kernel on checked CUDA inputs, one
    thread per (row, lane) pair; its state lives in global scratch."""
    B, dev = llr.shape[0], llr.device
    mb, nb, z, E = code.mb, code.nb, code.z, code.num_edges
    bits, converged, iterations = _outputs(B, code.n, dev)
    totals = torch.empty((B, nb * z), dtype=torch.float32, device=dev)
    c2v = torch.empty((B, E * z), dtype=torch.float32, device=dev)
    _run("bp_flooding", dev, llr.data_ptr(), syndrome.data_ptr(),
         table.data_ptr(), totals.data_ptr(), c2v.data_ptr(),
         bits.data_ptr(), converged.data_ptr(), iterations.data_ptr(), B, mb,
         nb, z, E, _max_dc(code), int(max_iters), float(alpha),
         min(MAX_THREADS, -(-(mb * z) // 32) * 32))
    return BatchDecodeResult(bits, converged, iterations)


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
    mb, nb, z = code.mb, code.nb, code.z
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
        if B == 0:
            return BatchDecodeResult(*_outputs(0, nb * z, dev))
        if dev not in tables:
            tables[dev] = torch.from_numpy(tab_np).to(dev)
        if alg == "layered":
            res = _layered(code, tables[dev], llr, syndrome, max_iters,
                           alpha, layered_plan(code, dev, B))
        else:
            res = _flooding(code, tables[dev], llr, syndrome, max_iters,
                            alpha)
        launches[name] += 1
        launch_batches[name][B] += 1
        return res

    return decode
