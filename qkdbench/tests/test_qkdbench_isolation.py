"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``qtpu`` (compared by whole top-level names, so ``qtpu_torch``
passes), and the reference imports none of them nor ``qtpu_torch``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from qkdbench import registry, run
from qkdbench.tests.tiny import DECODE, REPO, SESSION


def _imports(path) -> set:
    """Top-level names of every module a Python file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_names_are_whole_top_level_names():
    mods = ["qtpu_torch", "qtpu_torch.pipeline", "jaxtyping", "numpy"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["qtpu.pipeline", "jax"]) == \
        ["jax", "qtpu.pipeline"]


def test_sources_import_no_jax_and_reference_no_program():
    for path in registry.HERE.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path
    for path in (registry.HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "qtpu",
                                     "qtpu_torch"}, path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """Each cell run in a fresh interpreter on the CPU at a small size:
    the modules loaded by the end of the run hold no forbidden name."""
    script = f"""
import json, sys
from pathlib import Path
from qkdbench.tests.tiny import tiny_copy
from qkdbench import run
bench, root = tiny_copy(Path({str(tmp_path)!r}))
for cell in ({SESSION!r}, {DECODE!r}):
    assert run.main(["--workload", cell, "--seed", "3", "--seconds", "1",
                     "--trace", "0"], bench_path=bench, root=root,
                    require_card=False) == 0
print("LOADED", json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED")]
    loaded = json.loads(line[-1][len("LOADED "):])
    assert "qtpu_torch.pipeline" in loaded
    assert run.forbidden_modules(loaded) == []
