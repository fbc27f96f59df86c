"""Min-sum BP decoding on Hopper: the CUDA kernels' wrapper.

Two kernels, one per schedule, each built at first use by
``qtpu_torch._build`` (CUDA C++ for sm_90a, plain C entry point bound with
ctypes):

- ``bp_layered`` (``qtpu_torch/csrc/bp_layered.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel_layered`` (``alg="layered"``), the
  production decoder of the reference.
- ``bp_flooding`` (``qtpu_torch/csrc/bp_flooding.cu``) replaces
  ``qtpu/ldpc/pallas_bp.py::kernel`` (``alg="minsum"``, flooding).

In both, a code block's whole decoder state (totals and compact check-node
state) lives in the shared memory of one CTA or of a thread-block cluster
of C CTAs; the wrapper picks C and the threads per CTA from the code's
shape and the batch (``layered_plan``, ``flooding_plan``) and allocates
only the outputs.  A decoder plans its launch at the first call on a
device at a batch size and keeps it: a later call there checks its
inputs, allocates the outputs and makes one call of the entry point.

On a CPU tensor the decoder runs the plain PyTorch version
(``qtpu_torch.ldpc.decode``); on a CUDA tensor it launches the kernel or
raises.  ``launches[name]`` counts each kernel's launches,
``launch_batches[name]`` how many launches ran at each batch size and
``plans_made[name]`` the launches its decoders planned (one a decoder,
device and batch size; ``1 - plans_made / launches`` of the launches
reused a plan).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from qtpu_torch import _build, tracing
from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.ldpc.decode import (BatchDecodeResult, make_flooding_decoder,
                                    make_layered_decoder)

__all__ = ["make_cuda_decoder", "code_tables", "flooding_tables", "launches",
           "launch_batches", "plans_made", "KERNELS", "KernelPlan",
           "layered_plan", "flooding_plan"]

MAX_DC = 32           # edges of a base row the kernels take (both kernels)
MAX_THREADS = 512
# Cluster sizes the kernels may use: 8 is the portable limit, 16 needs the
# non-portable attribute (the C side sets it).  From 8 CTAs per cluster on,
# the layered kernel's CTAs are narrow: at most 256 threads, 3 to an SM.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
NARROW_FROM_CLUSTER, NARROW_THREADS = 8, 256
# Threads per CTA the flooding plan weighs (its registers are capped at 64
# a thread, so two CTAs of 512 or one of 1024 fill an SM's registers).
FLOODING_THREADS = (512, 1024)

# The kernel of each schedule and its plain PyTorch version.
KERNELS = {"layered": "bp_layered", "minsum": "bp_flooding"}

# Kernel launches per kernel since import (or since a caller reset them),
# per kernel the number of launches at each batch size, and per kernel the
# launches a decoder planned (its first at a device and batch size).
launches = {name: 0 for name in KERNELS.values()}
launch_batches = {name: collections.Counter() for name in KERNELS.values()}
plans_made = {name: 0 for name in KERNELS.values()}

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Both entry points: llr, syndrome, table, bits, converged, iterations; B,
# mb, nb, z, E, max_dc, max_iters; alpha; cluster, threads, smem; stream.
_ARGTYPES = (_PTR,) * 6 + (_INT,) * 7 + (_FLOAT,) + (_INT,) * 3 + (_PTR,)


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
    """The flooding kernel's int32 code table: row_start[mb+1], each row
    slot's column and shift (edges in ``row_edges`` order, row after row),
    col_start[nb+1], then each column's edges in ``col_edges`` slot order
    as their base row, their slot within that row and their shift.  Parallel
    edges are allowed; raises for a row wider than MAX_DC."""
    rows = [[int(e) for e in row if e >= 0] for row in code.row_edges]
    cols = [[int(e) for e in col if e >= 0] for col in code.col_edges]
    for i, slots in enumerate(rows):
        if len(slots) > MAX_DC:
            raise ValueError(f"base row {i} has degree {len(slots)} > "
                             f"{MAX_DC}")
    row_order = [e for slots in rows for e in slots]
    slot_in_row = {e: k for slots in rows for k, e in enumerate(slots)}
    col_order = [e for slots in cols for e in slots]
    return np.concatenate([
        np.cumsum([0] + [len(s) for s in rows]), code.edge_col[row_order],
        code.edge_shift[row_order], np.cumsum([0] + [len(s) for s in cols]),
        code.edge_row[col_order], [slot_in_row[e] for e in col_order],
        code.edge_shift[col_order],
    ]).astype(np.int32)


class KernelPlan(NamedTuple):
    """How a BP kernel runs a code on one device."""
    cluster: int        # CTAs per code block
    smem: int           # dynamic shared memory per CTA, bytes
    threads: int        # threads per CTA
    max_clusters: int   # cudaOccupancyMaxActiveClusters at this shape


@functools.cache
def _lib(name: str):
    """Kernel ``name``'s library with its planning functions typed."""
    lib = _build.load(name)
    getattr(lib, f"qtpu_{name}_smem").restype = ctypes.c_longlong
    getattr(lib, f"qtpu_{name}_smem").argtypes = [_INT] * 5
    getattr(lib, f"qtpu_{name}_smem_optin").restype = _INT
    getattr(lib, f"qtpu_{name}_smem_optin").argtypes = [_INT]
    getattr(lib, f"qtpu_{name}_max_clusters").restype = _INT
    getattr(lib, f"qtpu_{name}_max_clusters").argtypes = [_INT] * 5
    return lib


def _max_dc(code: QCCode) -> int:
    return max(int((row >= 0).sum()) for row in code.row_edges)


@functools.cache
def _cluster_shape(name: str, mb: int, nb: int, z: int, E: int, max_dc: int,
                   cluster: int, threads: int, device: int):
    """(smem bytes, threads, max active clusters) of kernel ``name`` at
    ``cluster`` CTAs of ``threads`` threads per block on CUDA device
    ``device``, or None when the cluster does not split z into power-of-two
    parts of >= 32 lanes or a CTA's share of the state exceeds the shared
    memory it may opt in to."""
    zc = z // cluster
    if cluster > 1 and (z % cluster or zc < 32 or zc & (zc - 1)):
        return None
    lib = _lib(name)
    smem = int(getattr(lib, f"qtpu_{name}_smem")(mb, nb, z, E, cluster))
    if not 0 < smem <= getattr(lib, f"qtpu_{name}_smem_optin")(device):
        return None
    with torch.cuda.device(device):
        active = getattr(lib, f"qtpu_{name}_max_clusters")(
            max_dc, z, cluster, threads, smem)
    return smem, threads, active


def _plan(name: str, code: QCCode, device, batch: int, cluster,
          thread_choices) -> KernelPlan:
    """Kernel ``name``'s launch shape for ``batch`` blocks of ``code`` on
    CUDA ``device``: at each cluster size (or the given one) the thread
    count of ``thread_choices(C)`` that keeps the most blocks resident, the
    larger on a tie; then one CTA per block when the state fits one CTA,
    else the cluster size, up to the portable 8, that keeps the most blocks
    resident (min(batch, cudaOccupancyMaxActiveClusters)), the larger on a
    tie.  Raises ValueError when no cluster size fits the shared memory and
    RuntimeError when the card cannot schedule one such cluster."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    args = (code.mb, code.nb, code.z, code.num_edges, _max_dc(code))

    def resident(sh):
        return min(batch, max(sh[2], 0))

    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    shapes = {}
    for C in sizes:
        fits = [sh for t in thread_choices(C)
                if (sh := _cluster_shape(name, *args, C, t, index)) is not None]
        if fits:
            shapes[C] = max(fits, key=lambda sh: (resident(sh), sh[1]))
    if not shapes:
        raise ValueError(
            f"the {name} kernel's state of a code with nb={code.nb}, "
            f"mb={code.mb}, z={code.z}, E={code.num_edges} fits no cluster "
            f"size {sizes} in the shared memory of a CTA on {dev}")
    if cluster is None:
        if 1 in shapes:
            cluster = 1
        else:
            cands = [C for C in shapes if C <= 8] or list(shapes)
            cluster = max(cands, key=lambda C: (resident(shapes[C]), C))
    smem, threads, active = shapes[cluster]
    if active <= 0:
        raise RuntimeError(
            f"{name}: no cluster of {cluster} CTAs x {smem} bytes can be "
            f"scheduled on {dev} (cudaOccupancyMaxActiveClusters -> "
            f"{active})")
    return KernelPlan(cluster, smem, threads, active)


def _warps(lanes: int) -> int:
    return -(-lanes // 32) * 32


def layered_plan(code: QCCode, device, batch: int,
                 cluster: int | None = None) -> KernelPlan:
    """The layered kernel's launch shape for ``batch`` blocks of ``code``
    on CUDA ``device`` (or at the given ``cluster`` size): one thread per
    lane of a CTA's share of a base row, up to 512 (256 for the narrow CTAs
    of clusters of 8 and more).  The kernel is bound by latency per base
    row, so at equal residency a block spread over more SMs (and warps)
    sweeps faster, while at large batch the residency decides (chip_smoke.py
    phase 3 times every size)."""
    def threads(C):
        limit = NARROW_THREADS if C >= NARROW_FROM_CLUSTER else MAX_THREADS
        return (min(limit, _warps(code.z // C)),)
    return _plan("bp_layered", code, device, batch, cluster, threads)


def flooding_plan(code: QCCode, device, batch: int,
                  cluster: int | None = None) -> KernelPlan:
    """The flooding kernel's launch shape for ``batch`` blocks of ``code``
    on CUDA ``device`` (or at the given ``cluster`` size): one CTA per
    block whenever the state fits (every code up to n = 16384 at mb <= 8),
    else a cluster; 1024 threads per CTA when the whole batch is resident
    at once with them, else 512, which keeps twice the blocks resident (no
    more than a CTA's share of the base columns' lanes).  A round is bound
    by the SM's throughput, so wider CTAs finish each block sooner, while a
    batch that runs in waves needs the residency (chip_smoke.py phase 4
    times both and every cluster size at n = 65536)."""
    def threads(C):
        cap = _warps(code.nb * (code.z // C))
        return tuple(sorted({min(t, cap) for t in FLOODING_THREADS}))
    return _plan("bp_flooding", code, device, batch, cluster, threads)


def _outputs(B: int, n: int, dev):
    return (torch.empty((B, n), dtype=torch.uint8, device=dev),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _launch_args(code: QCCode, B: int, max_iters: int, alpha: float,
                 plan: KernelPlan) -> tuple:
    """A launch's arguments after its six pointers: B, mb, nb, z, E,
    max_dc, max_iters, alpha, cluster, threads, smem."""
    return (B, code.mb, code.nb, code.z, code.num_edges, _max_dc(code),
            int(max_iters), float(alpha), plan.cluster, plan.threads,
            plan.smem)


def _run(name: str, n: int, table: int, args: tuple, llr: torch.Tensor,
         syndrome: torch.Tensor) -> BatchDecodeResult:
    """One launch of kernel ``name`` (its library's entry point of the
    same name) on checked CUDA inputs, with the code table at device
    address ``table`` and ``_launch_args``' ``args``.  Counts nothing:
    ``make_cuda_decoder``'s decoder does."""
    dev = llr.device
    bits, converged, iterations = _outputs(args[0], n, dev)
    _build.call(name, name, _ARGTYPES, dev, llr.data_ptr(),
                syndrome.data_ptr(), table, bits.data_ptr(),
                converged.data_ptr(), iterations.data_ptr(), *args)
    return BatchDecodeResult(bits, converged, iterations)


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def make_cuda_decoder(code: QCCode, max_iters: int, alpha: float = 0.8125,
                      alg: str = "layered"):
    """``(llr (B,n) f32, syndrome (B,m) uint8) -> BatchDecodeResult`` for
    ``alg`` "layered" or "minsum" (flooding): the Hopper kernel for CUDA
    tensors, the plain decoder for CPU ones.  "sumprod" had no TPU kernel
    (XLA only in the reference): its plain PyTorch decoder is its port and
    runs on every device."""
    if alg == "layered":
        tab_np, plan = code_tables(code), layered_plan
        plain = make_layered_decoder(code, max_iters, alpha)
    elif alg == "minsum":
        tab_np, plan = flooding_tables(code), flooding_plan
        plain = make_flooding_decoder(code, max_iters, alpha)
    elif alg == "sumprod":
        return make_flooding_decoder(code, max_iters, alpha, alg="sumprod")
    else:
        raise ValueError(f"unknown alg {alg!r}")
    name = KERNELS[alg]
    n, m = code.nb * code.z, code.mb * code.z
    tables: dict = {}
    # (device, B) -> (code table's address, _launch_args): the launch
    # planned at the first call there.
    prepared: dict = {}

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        with tracing.span("decode"):
            return checked(llr, syndrome)

    def checked(llr: torch.Tensor,
                syndrome: torch.Tensor) -> BatchDecodeResult:
        dev, sdev = llr.device, syndrome.device
        card = _on_card(dev)
        if not card and dev.type == "cpu" and sdev.type == "cpu":
            return plain(llr, syndrome)
        if not (card and sdev == dev):
            raise ValueError(f"llr on {dev}, syndrome on {sdev}: need both "
                             f"on one CUDA device (or both on the CPU)")
        B = llr.shape[0]
        if llr.dtype != torch.float32 or llr.shape != (B, n):
            raise ValueError(f"llr must be float32 (B, {n}), got "
                             f"{llr.dtype} {tuple(llr.shape)}")
        if syndrome.dtype != torch.uint8 or syndrome.shape != (B, m):
            raise ValueError(f"syndrome must be uint8 (B, {m}), got "
                             f"{syndrome.dtype} {tuple(syndrome.shape)}")
        if not (llr.is_contiguous() and syndrome.is_contiguous()):
            raise ValueError("llr and syndrome must be contiguous")
        if B == 0:
            return BatchDecodeResult(*_outputs(0, n, dev))
        res = _run(name, n, *(prepared.get((dev, B)) or prepare(dev, B)),
                   llr, syndrome)
        launches[name] += 1
        launch_batches[name][B] += 1
        return res

    def prepare(dev: torch.device, B: int) -> tuple:
        """Plan the launch at (dev, B), once: the code table on ``dev``,
        the plan, the entry point and every argument no call changes."""
        with tracing.span("decode.plan"):
            if dev not in tables:
                tables[dev] = torch.from_numpy(tab_np).to(dev)
            shape = plan(code, dev, B)
            _build.entry(name, name, _ARGTYPES)
            launch = (tables[dev].data_ptr(),
                      _launch_args(code, B, max_iters, alpha, shape))
        prepared[dev, B] = launch
        plans_made[name] += 1
        return launch

    return decode
