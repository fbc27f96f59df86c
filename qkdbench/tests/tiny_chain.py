"""The events cell at a size the CPU holds: ``tiny.tiny_copy`` with the
events cell's own files made smaller (short pieces at the cell's event
density, short blocks, few blocks a window)."""

from __future__ import annotations

from pathlib import Path

from qkdbench.tests.tiny import _edit, tiny_copy

CHAIN = "chain65k-pairs1e7"

TINY_PIPELINE = {"n": 2048, "blocks_per_window": 4, "qber_test_bits": 256,
                 "qber_test_floor": 64, "stream_capacity_bits": 1 << 18,
                 "drain_windows": 4}
# Pieces of 0.25 ms at 10^7 pairs/s: a frame (2^29 units, 67 ms) spans
# ~270 pieces, so consecutive chunks share frame ids and a batch holds 8 of
# one; the loop's backlog (5 windows' need, 41 kbit) holds a batch's 8
# unanswered pieces (18k of Alice's events).
TINY_CHAIN = {"window_s": 0.00025, "pfind_bins": 1 << 14}
TINY_TRAFFIC = {"pull_windows": 4, "warmup_windows": 12, "keep_every": 1,
                "keep_blocks": 2, "check_windows": 4,
                "decode_skip_windows": 2, "decode_windows": 2,
                "check_chunks": 4, "chunk_every": 2, "trace_seconds": 0.5}


def tiny_chain_copy(dst: Path) -> tuple[Path, Path]:
    """(BENCHMARK.json, the benchmark's folder) of a tiny copy under
    ``dst``, the events cell made small."""
    bench, root = tiny_copy(dst)
    _edit(root / "configs" / "chain65k.json", pipeline=TINY_PIPELINE,
          chain=TINY_CHAIN)
    _edit(root / "workloads" / f"{CHAIN}.json", traffic=TINY_TRAFFIC)
    return bench, root
