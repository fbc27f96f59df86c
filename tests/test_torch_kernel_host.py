"""The host side of the CUDA kernels, checked without a compiler or a card.

Build tags: a library is rebuilt when its source, a header the source
includes, or the flags change (``qtpu_torch._build._paths``).  Launch
plans: ``cuda_bp.flooding_plan``'s choice of cluster size and threads per
CTA, against a stand-in for the kernel libraries whose shared-memory sizes
follow ``bp_flooding.cu``'s and ``bp_layered.cu``'s layouts and whose
occupancy follows an H100's limits (132 SMs, 227 KB of shared memory and
64 K registers per SM, 64 registers per thread for flooding, 128 for
layered).  The decoder's launch on that stand-in card (CPU tensors taken
for CUDA ones, the entry point a recorder): planned once a device and
batch size, with the arguments the plan gives, after the same input
checks; and ``_build.call``'s device guard and stream."""

import contextlib
import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from qtpu_torch import _build
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import (QCCode, _group_edges, make_rate_ladder,
                                   make_regular_code)
from qtpu_torch.ldpc.cuda_bp import KERNELS, code_tables, flooding_tables

HEADER = "cluster_state.cuh"


def _tags(monkeypatch, csrc):
    monkeypatch.setattr(_build, "_CSRC", csrc)
    return {name: _build._paths(name)[1].name for name in KERNELS.values()}


def test_both_kernels_include_the_shared_header():
    for name in KERNELS.values():
        src = _build._CSRC / f"{name}.cu"
        assert _build._sources(src) == [src, _build._CSRC / HEADER]


def test_editing_the_header_rebuilds_both_libraries(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    before = _tags(monkeypatch, csrc)
    assert before == _tags(monkeypatch, _build._CSRC)
    with open(csrc / HEADER, "a") as f:
        f.write("\n// edited\n")
    after = _tags(monkeypatch, csrc)
    assert all(after[name] != before[name] for name in KERNELS.values())
    with open(csrc / "bp_flooding.cu", "a") as f:
        f.write("\n// edited\n")
    again = _tags(monkeypatch, csrc)
    assert again["bp_layered"] == after["bp_layered"]
    assert again["bp_flooding"] != after["bp_flooding"]


SMEM_PER_SM, SMEM_OPTIN, SMS = 233472, 232448, 132


class _CardLib:
    """Stands in for ``libbp_flooding`` and ``libbp_layered``: their
    shared-memory layouts per CTA and cudaOccupancyMaxActiveClusters on an
    H100."""

    def __init__(self, schedulable=True):
        self.schedulable = schedulable

    def _max_clusters(self, regs, cluster, threads, smem):
        per_sm = min(SMEM_PER_SM // (smem + 1024),
                     65536 // (regs * threads), 2048 // threads)
        return SMS * per_sm // cluster if self.schedulable else 0

    def qtpu_bp_flooding_smem(self, mb, nb, z, E, cluster):
        zc = z // cluster
        table = (16 * E + 4 * (mb + 1) + 4 * (nb + 1) + 15) // 16 * 16
        return table + 16 + 16 * mb * zc + 4 * nb * zc

    def qtpu_bp_flooding_smem_optin(self, device):
        return SMEM_OPTIN

    def qtpu_bp_flooding_max_clusters(self, max_dc, z, cluster, threads,
                                      smem):
        return self._max_clusters(64, cluster, threads, smem)

    def qtpu_bp_layered_smem(self, mb, nb, z, E, cluster):
        zc = z // cluster
        return (mb + 1 + 2 * E + 3) // 4 * 16 + 16 + 4 * nb * zc \
            + 14 * mb * zc

    def qtpu_bp_layered_smem_optin(self, device):
        return SMEM_OPTIN

    def qtpu_bp_layered_max_clusters(self, max_dc, z, cluster, threads,
                                     smem):
        return self._max_clusters(128, cluster, threads, smem)


@pytest.fixture
def fake_card(monkeypatch):
    """cuda_bp planning against ``_CardLib`` on a CPU-only build."""
    lib = _CardLib()
    monkeypatch.setattr(cuda_bp, "_lib", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda_bp._cluster_shape.cache_clear()
    yield lib
    cuda_bp._cluster_shape.cache_clear()


@pytest.mark.parametrize("which,batch,want", [
    ("regular4096", 1024, (1, 512, 264)),    # waves: 2 CTAs of 49 KB per SM
    ("regular4096", 8, (1, 1024, 132)),      # one wave: the widest CTAs
    ("regular16384", 64, (1, 1024, 132)),    # 192 KB still fits one CTA
    ("native3_65536", 128, (8, 512, 33)),    # a cluster, most resident
    ("native3_65536", 8, (8, 1024, 16)),     # the portable size on a tie
])
def test_flooding_plan_rules(fake_card, which, batch, want):
    if which == "native3_65536":
        code = make_rate_ladder(65536, family="native3",
                                alg="layered").steps[6].code
    else:
        code = make_regular_code(int(which[len("regular"):]))
    plan = cuda_bp.flooding_plan(code, torch.device("cuda", 0), batch)
    assert (plan.cluster, plan.threads, plan.max_clusters) == want
    assert plan.smem == fake_card.qtpu_bp_flooding_smem(
        code.mb, code.nb, code.z, code.num_edges, plan.cluster)


def test_flooding_plan_raises_when_nothing_fits(fake_card):
    """Totals of 2048 columns x z = 64 fit no cluster size with z / C >=
    32; a shape the card cannot schedule raises too."""
    rows, cols = np.zeros(3, np.int32), np.arange(3, dtype=np.int32)
    wide = QCCode(z=64, mb=1, nb=2048, edge_row=rows, edge_col=cols,
                  edge_shift=cols, row_edges=_group_edges(rows, 1),
                  col_edges=_group_edges(cols, 2048))
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="fits no cluster size"):
        cuda_bp.flooding_plan(wide, dev, 4)
    fake_card.schedulable = False
    with pytest.raises(RuntimeError, match="can be scheduled"):
        cuda_bp.flooding_plan(make_regular_code(4096), dev, 4)


# ---------------------------------------------------------------------------
# The decoder's launch, planned once a device and batch size.

STREAM = 0x5EED   # the raw handle the stand-in card gives as current stream


class _Entry:
    """Stands in for a typed entry point: records each call's arguments
    and returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def card_decoder(fake_card, monkeypatch):
    """The decoder's CUDA path on ``fake_card`` with CPU tensors: the entry
    point is an ``_Entry``, the current stream ``STREAM``."""
    fn = _Entry()
    monkeypatch.setattr(cuda_bp, "_on_card", lambda dev: True)
    monkeypatch.setattr(_build, "entry", lambda library, name, argtypes: fn)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: STREAM, raising=False)
    return fn


def _code(which):
    if which == "native3_65536":
        return make_rate_ladder(65536, family="native3",
                                alg="layered").steps[6].code
    return make_regular_code(int(which[len("regular"):]))


def _zeros(code, B):
    return (torch.zeros((B, code.n), dtype=torch.float32),
            torch.zeros((B, code.m), dtype=torch.uint8))


def _counts(name):
    return (cuda_bp.plans_made[name], cuda_bp.launches[name])


@pytest.mark.parametrize("alg", ["layered", "minsum"])
def test_decoder_plans_once_a_device_and_batch(card_decoder, alg):
    """Many calls at one batch size plan once; a new batch size plans
    again, one seen before does not; every call launches once."""
    code = make_regular_code(1024)
    name = KERNELS[alg]
    dec = cuda_bp.make_cuda_decoder(code, 20, alg=alg)
    big, small = _zeros(code, 64), _zeros(code, 3)
    plans, launches = _counts(name)
    for _ in range(5):
        dec(*big)
    assert _counts(name) == (plans + 1, launches + 5)
    dec(*small)
    assert _counts(name) == (plans + 2, launches + 6)
    for inputs in (big, small, big, small):
        dec(*inputs)
    assert _counts(name) == (plans + 2, launches + 10)
    assert len(card_decoder.calls) == 10
    assert [c[6] for c in card_decoder.calls] == [64] * 5 + [3, 64, 3, 64, 3]


@pytest.mark.parametrize("alg,which,B", [
    ("layered", "regular4096", 1024),
    ("minsum", "regular4096", 1024),
    ("layered", "native3_65536", 128),
    ("layered", "native3_65536", 3),
    ("minsum", "native3_65536", 128),
    ("minsum", "native3_65536", 3),
])
def test_prepared_launch_passes_the_plans_arguments(card_decoder, alg, which,
                                                    B):
    """The planning call and a prepared one pass what ``layered_plan`` /
    ``flooding_plan`` give at (device, B), the code's table, the inputs'
    and outputs' addresses and the current stream, as the launch did
    before it was prepared."""
    code = _code(which)
    plan_for, table_of = ((cuda_bp.layered_plan, code_tables)
                          if alg == "layered" else
                          (cuda_bp.flooding_plan, flooding_tables))
    plan = plan_for(code, torch.device("cpu"), B)
    max_dc = int(np.bincount(code.edge_row).max())
    dec = cuda_bp.make_cuda_decoder(code, 60, alg=alg)
    llr, syn = _zeros(code, B)
    results = [dec(llr, syn), dec(llr, syn)]
    assert len(card_decoder.calls) == 2
    tables = {c[2] for c in card_decoder.calls}
    assert len(tables) == 1
    want = table_of(code)
    got = np.ctypeslib.as_array(
        (ctypes.c_int32 * want.size).from_address(tables.pop()))
    np.testing.assert_array_equal(got, want)
    for args, res in zip(card_decoder.calls, results):
        assert args == (
            llr.data_ptr(), syn.data_ptr(), args[2], res.bits.data_ptr(),
            res.converged.data_ptr(), res.iterations.data_ptr(), B, code.mb,
            code.nb, code.z, code.num_edges, max_dc, 60, 0.8125,
            plan.cluster, plan.threads, plan.smem, STREAM)
        assert (res.bits.shape, res.bits.dtype) == ((B, code.n), torch.uint8)
        assert (res.converged.shape, res.converged.dtype) == ((B,),
                                                              torch.bool)
        assert (res.iterations.shape, res.iterations.dtype) == ((B,),
                                                                torch.int32)


def _bad(kind, llr, syn):
    if kind == "llr_dtype":
        return llr.double(), syn
    if kind == "llr_shape":
        return llr[:, :-1].contiguous(), syn
    if kind == "syndrome_dtype":
        return llr, syn.to(torch.int32)
    if kind == "device":
        return llr, syn.to("meta")
    return llr.t().contiguous().t(), syn


@pytest.mark.parametrize("alg", ["layered", "minsum"])
@pytest.mark.parametrize("kind,message", [
    ("llr_dtype", "llr must be float32 (B, 1024), got torch.float64 "
                  "(4, 1024)"),
    ("llr_shape", "llr must be float32 (B, 1024), got torch.float32 "
                  "(4, 1023)"),
    ("syndrome_dtype", "syndrome must be uint8 (B, 512), got torch.int32 "
                       "(4, 512)"),
    ("device", "llr on cpu, syndrome on meta: need both on one CUDA device "
               "(or both on the CPU)"),
    ("contiguous", "llr and syndrome must be contiguous"),
])
def test_bad_inputs_raise_before_a_plan_or_launch(card_decoder, alg, kind,
                                                  message):
    """Bad inputs raise the same errors on a planned decoder as on a new
    one, and neither plan nor launch."""
    code = make_regular_code(1024)
    name = KERNELS[alg]
    fresh = cuda_bp.make_cuda_decoder(code, 10, alg=alg)
    planned = cuda_bp.make_cuda_decoder(code, 10, alg=alg)
    llr, syn = _zeros(code, 4)
    planned(llr, syn)
    before, calls = _counts(name), len(card_decoder.calls)
    for dec in (fresh, planned):
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            dec(*_bad(kind, llr, syn))
    assert _counts(name) == before and len(card_decoder.calls) == calls


class _Guard:
    """Stands in for ``torch.cuda.device``: records the devices entered."""

    def __init__(self):
        self.entered = []

    def __call__(self, index):
        self.entered.append(index)
        return contextlib.nullcontext()


@pytest.mark.parametrize("dev,guarded", [
    (torch.device("cuda"), []),
    (torch.device("cuda", 0), []),
    (torch.device("cuda", 1), [1]),
])
def test_call_guards_the_device_only_off_the_current_one(monkeypatch, dev,
                                                         guarded):
    """``_build.call`` passes the raw current stream of ``dev`` (the
    current device when it names none) and makes ``dev`` current around
    the call only when it is not; a non-zero return raises."""
    fn, guard = _Entry(), _Guard()
    monkeypatch.setattr(_build, "entry", lambda library, name, argtypes: fn)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 100 + index, raising=False)
    _build.call("lib", "kernel", (), dev, 7, 8)
    want = 100 + (dev.index or 0)
    assert fn.calls == [(7, 8, want)] and guard.entered == guarded
    monkeypatch.setattr(_build, "entry", lambda *a: lambda *args: 3)
    with pytest.raises(RuntimeError, match=r"kernel launch failed \(code 3\)"):
        _build.call("lib", "kernel", (), dev)
