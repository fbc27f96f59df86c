"""Run one cell of the benchmark of ``qtpu_torch`` and print its result.

    python3 -m qkdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the measured package.  One process, in order: find the cell's files by
name (``registry``), refuse to run without the CUDA cards the cell asks
for, hand the cell to its traffic driver (which builds or loads the
kernels, makes its inputs on the card from ``--seed``, warms up, measures
for ``--seconds`` and checks what the timed path produced against the
plain reference under ``reference/``), then print the check's numbers with
their limits as the last lines on standard error and the result as the
last line on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` part of the window runs under ``torch.profiler`` and the
metrics are the cell's per-layer metrics, each read by its own file under
``layer_metrics/``.  The run exits non-zero and prints no result where no
card is found or where ``jax``, ``jaxlib``, ``flax`` or ``qtpu`` (the JAX
package, a whole top-level module name) has been loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

__all__ = ["main", "forbidden_modules", "Context", "Check"]

FORBIDDEN = ("jax", "jaxlib", "flax", "qtpu")
# Caches of the program's toolchain, at fixed paths inside the checkout
# (so that only a checkout's first run builds) and never under a shared
# fixed path.
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda_cache"}


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose whole top-level name is one of
    ``FORBIDDEN`` (so ``qtpu_torch`` is not ``qtpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class Check:
    """One number the correctness check compares, with its limit: it
    passes when ``value <= limit`` (``op`` "<=") or ``value >= limit``
    (">=")."""

    def __init__(self, name: str, value, limit, op: str = "<="):
        if op not in ("<=", ">="):
            raise ValueError(f"unknown comparison {op!r}")
        self.name, self.value, self.limit, self.op = name, value, limit, op

    @property
    def ok(self) -> bool:
        return (self.value <= self.limit if self.op == "<="
                else self.value >= self.limit)

    def as_dict(self) -> dict:
        return {"value": self.value, "limit": self.limit, "op": self.op}


class Context:
    """What a traffic driver gets: the seed, the window's length, the
    device, the configuration and workload files, and the tracer."""

    def __init__(self, seed: int, seconds: float, device, config: dict,
                 workload: dict, tracer):
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.config = config
        self.workload = workload
        self.tracer = tracer


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def _parse(argv):
    p = argparse.ArgumentParser(prog="qkdbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, bench_path="BENCHMARK.json", root=None,
         require_card: bool = True) -> int:
    """Run the cell; returns the exit code.  ``require_card=False`` (the
    harness's CPU tests only) skips the look for a card and runs on the
    CPU."""
    from qkdbench import registry
    args = _parse(argv)
    found = forbidden_modules()
    if found:
        print(f"qkdbench: refused: loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    cell = registry.cell(bench_path, args.workload,
                         registry.HERE if root is None else Path(root))
    checkout = Path(bench_path).resolve().parent
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(checkout / "build" / "qkdbench" / sub)
    import torch
    from qkdbench.trace import Tracer
    if require_card:
        if not torch.cuda.is_available():
            print("qkdbench: no CUDA card: refusing to measure",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"qkdbench: the cell needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    # Every float32 product of the program and the reference in full
    # float32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer(bool(args.trace), device)
    ctx = Context(args.seed, args.seconds, device, cell.config,
                  cell.workload, tracer)
    out = cell.driver().run(ctx)

    found = forbidden_modules()
    if found:
        print(f"qkdbench: refused: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    setup_s = out["window_start"] - PROCESS_START
    if args.trace:
        record = dict(out["record"], trace=tracer.record()
                      if out["record"].get("traced") else None)
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit": _power_limit() if device.type == "cuda" else None}
    result = {"correct": all(c.ok for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and record["trace"] is not None:
        tr = record["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {c.name: c.as_dict() for c in out["checks"]}
    sys.stdout.flush()
    for c in out["checks"]:
        print(f"check {c.name}: {c.value} (limit {c.op} {c.limit}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
