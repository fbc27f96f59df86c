"""The host side of the CUDA kernels, checked without a compiler or a card.

Build tags: a library is rebuilt when its source, a header the source
includes, or the flags change (``qtpu_torch._build._paths``).  Launch
plans: ``cuda_bp.flooding_plan``'s choice of cluster size and threads per
CTA, against a stand-in for the kernel library whose shared-memory sizes
follow ``bp_flooding.cu``'s layout and whose occupancy follows an H100's
limits (132 SMs, 227 KB of shared memory and 64 K registers per SM, 64
registers per thread)."""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from qtpu_torch import _build
from qtpu_torch.ldpc import cuda_bp
from qtpu_torch.ldpc.codes import (QCCode, _group_edges, make_rate_ladder,
                                   make_regular_code)
from qtpu_torch.ldpc.cuda_bp import KERNELS

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


class _FloodingLib:
    """Stands in for ``libbp_flooding``: its shared-memory layout per CTA
    and cudaOccupancyMaxActiveClusters on an H100."""

    def __init__(self, schedulable=True):
        self.schedulable = schedulable

    def qtpu_bp_flooding_smem(self, mb, nb, z, E, cluster):
        zc = z // cluster
        table = (16 * E + 4 * (mb + 1) + 4 * (nb + 1) + 15) // 16 * 16
        return table + 16 + 16 * mb * zc + 4 * nb * zc

    def qtpu_bp_flooding_smem_optin(self, device):
        return SMEM_OPTIN

    def qtpu_bp_flooding_max_clusters(self, max_dc, z, cluster, threads,
                                      smem):
        per_sm = min(SMEM_PER_SM // (smem + 1024), 65536 // (64 * threads),
                     2048 // threads)
        return SMS * per_sm // cluster if self.schedulable else 0


@pytest.fixture
def fake_card(monkeypatch):
    """cuda_bp planning against ``_FloodingLib`` on a CPU-only build."""
    lib = _FloodingLib()
    monkeypatch.setattr(cuda_bp, "_lib", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
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
