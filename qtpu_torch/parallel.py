"""Meshes, sharded decoding, the psum'd ledger and sharded stream PA.

Counterpart of ``qtpu/parallel.py``, with the same names:

- **DP over key blocks** ("blocks" mesh axis): each shard decodes its
  slice of the block batch with the single-device decoder — the Hopper
  kernel on a CUDA tensor (``qtpu_torch.ldpc.cuda_bp``) — and there is no
  communication inside the decode.
- **Global accounting**: the leakage ledger is the sum of the per-shard
  ledger vectors (``psum_ledger``; BASELINE config 5: "global leaked-bit
  psum accounting").
- **Sharded stream PA**: one Toeplitz seed spans the whole key stream; each
  shard convolves its slice of the stream with its slice of the seed and
  the m-bit output combines with an integer psum, mod 2 after the sum
  (``sharded_stream_toeplitz`` / ``make_stream_pa``).

A ``Mesh`` is a plain list of shards.  A process owns ``devices`` (one
``torch.device`` per shard; a device may repeat, so D shards can share one
card) starting at global shard ``first`` of ``size``; with a
``torch.distributed`` process group the sums end in an ``all_reduce`` over
it.  PyTorch runs eagerly, so a "shard program" is the single-device code
called once per local shard on that shard's device, with no host sync
between the calls (``Mesh.run_shards``).  Each CUDA shard runs on a
stream of its own, so shards overlap on one card as on several: the
counterpart of the reference's one SPMD program, whose shards run
concurrently.

The reference's float32 fault, not inherited here: its
``sharded_stream_toeplitz`` convolves each shard's whole slice
(L = N / D bits) in float32 with no segmenting.  At the production flush
(N = 2^25, m ~ 0.873 N) a count then lands 0.5 from its integer for
D = 8 and D = 4 (``jnp.fft`` on a CPU), so the hash is not the GF(2)
product and a mesh Bob hashes differently from his unsharded Alice.  Here
each shard runs float64 in sub-segments of at most 2^24 bits, whose counts
(<= 2^24) float64 rounds exactly, as the single-device flush does.

Multi-process entry: ``init_distributed()`` wraps
``torch.distributed.init_process_group``; ``make_mesh`` then spans every
process's shards.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch

from qtpu_torch import pa as pa_mod
from qtpu_torch.ldpc import decode as plain
from qtpu_torch.ldpc.cuda_bp import make_cuda_decoder
from qtpu_torch.ldpc.decode import BatchDecodeResult

__all__ = [
    "Mesh", "init_distributed", "make_mesh", "psum_ledger",
    "make_sharded_decoder",
    "sharded_stream_toeplitz", "make_stream_pa",
]

# Largest sub-segment a shard's stream hash convolves at once: its counts
# (<= 2^24) stay far inside float64's exact rounding.
STREAM_SEGMENT = 1 << 24


class Mesh:
    """A 1-D mesh: this process's shards ``first .. first + len(devices)``
    of ``size``, shard i on ``devices[i - first]``; ``group`` is the
    process group the sums reduce over (None in one process)."""

    def __init__(self, axis: str, devices: Sequence, first: int = 0,
                 size: Optional[int] = None, group=None):
        self.axis = axis
        self.devices = [torch.device(d) for d in devices]
        self.first = int(first)
        self.size = len(self.devices) if size is None else int(size)
        self.group = group
        last = self.first + len(self.devices)
        if not self.devices or last > self.size:
            raise ValueError(f"shards {self.first}..{last} do not fit a "
                             f"mesh of {self.size}")
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._events: dict[tuple, torch.cuda.Event] = {}

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(global shard index, device) of every shard this process owns."""
        return list(enumerate(self.devices, self.first))

    def stream(self, g: int) -> Optional[torch.cuda.Stream]:
        """Local shard ``g``'s own CUDA stream on its device, made on first
        use; None for a CPU shard."""
        dev = self.devices[g - self.first]
        if dev.type != "cuda":
            return None
        if g not in self._streams:
            self._streams[g] = torch.cuda.Stream(dev)
        return self._streams[g]

    def _event(self, key: tuple) -> torch.cuda.Event:
        """The mesh's CUDA event ``key``, made on first use.  Each call
        records it anew; a wait takes the record that precedes it."""
        if key not in self._events:
            self._events[key] = torch.cuda.Event()
        return self._events[key]

    def run_shards(self, fn) -> list:
        """``[fn(g, dev) for g, dev in self.local_shards()]``, each CUDA
        shard's call on the shard's own stream, so that the shards of one
        card run concurrently.

        A shard's stream first waits for the work queued on the current
        streams of its device and of the home device (``devices[0]``):
        the inputs, such as Bob's arena, were written there.  After the
        last call those current streams wait for every shard's stream, so
        whatever reads the results (``torch.cat``, ``psum_ledger``) runs
        after the shards, and every tensor a call returned is recorded on
        its device's current stream, so that the caching allocator hands
        out none of their memory before those reads are done.  CPU shards
        are called in turn, as they always were."""
        cards = {_index(d) for d in self.devices if d.type == "cuda"}
        if not cards:
            return [fn(g, dev) for g, dev in self.local_shards()]
        home = _index(self.devices[0]) if self.devices[0].type == "cuda" \
            else None
        caller = {i: torch.cuda.current_stream(i) for i in cards}
        for i in cards:
            self._event(("fork", i)).record(caller[i])
        device = torch.cuda.current_device()
        outs = []
        try:
            for g, dev in self.local_shards():
                s = self.stream(g)
                if s is None:
                    outs.append(fn(g, dev))
                    continue
                for i in {s.device_index, home} - {None}:
                    s.wait_event(self._event(("fork", i)))
                torch.cuda.set_stream(s)
                try:
                    outs.append(fn(g, dev))
                finally:
                    torch.cuda.set_stream(caller[s.device_index])
        finally:
            torch.cuda.set_device(device)
        for g, out in zip(range(self.first, self.first + len(outs)), outs):
            s = self.stream(g)
            if s is None:
                continue
            done = self._event(("join", g))
            done.record(s)
            for i in {s.device_index, home} - {None}:
                caller[i].wait_event(done)
            for t in _tensors(out):
                if t.is_cuda:
                    t.record_stream(caller.get(t.device.index)
                                    or torch.cuda.current_stream(t.device))
        return outs


def _index(dev: torch.device) -> int:
    """A CUDA device's index (the current device's for a bare "cuda")."""
    return torch.cuda.current_device() if dev.index is None else dev.index


def _tensors(out):
    """The tensors in ``out``: a tensor, or tuples and lists of them."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> Optional[str]:
    """Multi-process bring-up (``torch.distributed``); a no-op for one
    process.  ``coordinator`` is rank 0's "host:port".  ``backend``
    defaults to "nccl" when every process has a card of its own and
    "gloo" otherwise (gloo reduces CUDA tensors through host memory).
    Returns the backend, or None for one process."""
    if num_processes is None or num_processes <= 1:
        return None
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards >= num_processes else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % cards)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=120))
    return backend


def make_mesh(axis: str = "blocks", num: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (or the first ``num`` of them), one shard
    each.  The default devices: every CUDA card of a one-process run, this
    process's card under ``torch.distributed``, else the CPU.  Under an
    initialized process group of W > 1 processes, each process owns the
    same number of shards and the mesh spans all W·len(devices)."""
    dist = torch.distributed
    multi = (dist.is_available() and dist.is_initialized()
             and dist.get_world_size() > 1)
    if devices is None:
        if not torch.cuda.is_available():
            devices = [torch.device("cpu")]
        elif multi:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if num is not None:
        devs = devs[:num]
    if not multi:
        return Mesh(axis, devs)
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(axis, devs, first=rank * len(devs), size=world * len(devs),
                group=dist.group.WORLD)


def psum_ledger(local_vecs: Sequence[torch.Tensor],
                mesh: Mesh) -> torch.Tensor:
    """The global sum of per-shard int32 vectors (the leakage ledger, or a
    sharded hash's counts): the local shards' vectors summed on the first
    one's device, then ``all_reduce(SUM)`` over the mesh's process group."""
    total = local_vecs[0].clone()
    for v in local_vecs[1:]:
        total += v.to(total.device)
    if mesh.group is not None:
        torch.distributed.all_reduce(total, group=mesh.group)
    return total


def make_sharded_decoder(code, mesh: Mesh, max_iters: int = 50,
                         alg: str = "minsum", use_kernel: bool = True):
    """DP decode: ``(llr (B, n), syndrome (B, m)) -> BatchDecodeResult``
    with the block batch split into the mesh's ``size`` equal shards; each
    local shard runs the single-device decoder on its device and stream
    (``Mesh.run_shards``; the Hopper
    kernel on CUDA tensors; ``use_kernel=False`` runs the plain PyTorch
    decoder there instead), with no collectives.  The inputs are the whole
    batch; the result holds this process's shards' rows in global block
    order, on the first shard's device."""
    if use_kernel:
        local = make_cuda_decoder(code, max_iters, alg=alg)
    elif alg == "layered":
        local = plain.make_layered_decoder(code, max_iters)
    else:
        local = plain.make_flooding_decoder(code, max_iters, alg=alg)

    def decode(llr: torch.Tensor, syndrome: torch.Tensor) -> BatchDecodeResult:
        B = llr.shape[0]
        if B % mesh.size:
            raise ValueError(f"batch {B} does not split into {mesh.size} "
                             f"shards")
        bl = B // mesh.size

        def shard(g, dev):
            rows = slice(g * bl, (g + 1) * bl)
            return local(llr[rows].to(dev).contiguous(),
                         syndrome[rows].to(dev).contiguous())

        parts = mesh.run_shards(shard)
        home = mesh.devices[0]
        return BatchDecodeResult(*(torch.cat([p[i].to(home) for p in parts])
                                   for i in range(3)))

    return decode


def sharded_stream_toeplitz(t_bits: torch.Tensor, x_local: torch.Tensor,
                            m: int, mesh: Mesh, shard: int) -> torch.Tensor:
    """Shard ``shard``'s (m,) int32 contribution to the Toeplitz hash of a
    stream of N = size·L bits, of which ``x_local`` (L,) is its slice:

        (T x)_i = XOR_s  conv(t_slice_s, x_s)[i]        i in [0, m)

    t_bits is the whole (m + N - 1,) seed; shard s needs t indices
    (N - 1 + i) - j for j in [sL, sL + L): the slice of length m + L - 1 at
    N - (s + 1)·L.  The convolution runs in float64 in sub-segments of at
    most 2^24 bits on ``x_local``'s device; the caller sums the shards'
    counts (``psum_ledger``) and takes the sum mod 2."""
    L = x_local.shape[0]
    start = mesh.size * L - (shard + 1) * L
    t_slice = t_bits[start:start + m + L - 1].to(x_local.device)
    return pa_mod.stream_counts(t_slice, x_local, m,
                                segment=min(L, STREAM_SEGMENT),
                                precision=torch.float64)


def make_stream_pa(mesh: Mesh, n_stream: int, m: int):
    """Sharded streaming privacy amplification (the session's stream-PA
    flush on a mesh): ``pa(t_bits (m + n_stream - 1,), stream (n_stream,))
    -> (m,) uint8`` on the first shard's device.  The stream splits into
    the mesh's shards, each local shard hashes its slice on its device and
    stream (``Mesh.run_shards``), the
    int32 counts sum over every shard, and the sum is taken mod 2.  Equal
    to ``qtpu_torch.pa.toeplitz_hash_golden``."""
    if n_stream % mesh.size:
        raise ValueError(f"stream of {n_stream} bits does not split into "
                         f"{mesh.size} shards (pad with zeros)")
    L = n_stream // mesh.size

    def pa(t_bits: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
        counts = mesh.run_shards(lambda g, dev: sharded_stream_toeplitz(
            t_bits, stream[g * L:(g + 1) * L].to(dev), m, mesh, g))
        return (psum_ledger(counts, mesh) & 1).to(torch.uint8)

    return pa
