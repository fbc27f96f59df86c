"""Each cell as the benchmark runs it, on the card at its own size, for a
short window: exit 0, a result line, ``correct`` true.  Skipped where no
CUDA card is found (decided in the fixture, never at import)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from qkdbench.tests.tiny import DECODE, REPO, SESSION


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [SESSION, DECODE])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "qkdbench.run", "--workload", cell, "--seed",
         str((1 << 31) + 4242), "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
