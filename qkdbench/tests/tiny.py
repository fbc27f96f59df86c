"""A copy of the benchmark at a size the CPU holds: the cells' own files
with smaller numbers, written into a temporary folder beside a
``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from qkdbench import registry

SESSION = "prod65k-bsc3"
DECODE = "reg4k-b1024-bsc1to5"
REPO = registry.HERE.parent

TINY_PIPELINE = {"n": 2048, "blocks_per_window": 4, "qber_test_bits": 256,
                 "qber_test_floor": 64, "stream_capacity_bits": 1 << 18,
                 "drain_windows": 4}
TINY_SESSION = {"chunk_bits": 1 << 14, "pool_chunks": 64, "pull_windows": 4,
                "warmup_windows": 16, "keep_every": 2, "keep_blocks": 2,
                "check_windows": 4, "decode_skip_windows": 4,
                "decode_windows": 4,
                "trace_seconds": 0.5}
TINY_DECODE = {"batches_per_qber": 1, "qbers": [0.05, 0.07]}


def _edit(path: Path, **parts) -> None:
    data = json.loads(path.read_text())
    for key, values in parts.items():
        data[key].update(values)
    path.write_text(json.dumps(data))


def tiny_copy(dst: Path) -> tuple[Path, Path]:
    """(BENCHMARK.json, the benchmark's folder) of a tiny copy under
    ``dst``."""
    root = dst / "qkdbench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _edit(root / "configs" / "prod65k.json", pipeline=TINY_PIPELINE)
    _edit(root / "workloads" / f"{SESSION}.json", traffic=TINY_SESSION)
    _edit(root / "configs" / "reg4k.json", decoder={"batch": 64})
    _edit(root / "workloads" / f"{DECODE}.json", traffic=TINY_DECODE)
    bench = dst / "BENCHMARK.json"
    shutil.copy(REPO / "BENCHMARK.json", bench)
    return bench, root
