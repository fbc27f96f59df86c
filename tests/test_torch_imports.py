"""qtpu_torch stays JAX-free, and its numpy copies stay copies.

The machine with the card has no JAX, so importing any qtpu_torch module
must not import jax (checked in a fresh interpreter).  The host-side
protocol modules are numpy copies of qtpu's (qtpu's package import pulls in
JAX); each copy must equal its original with the package name normalized,
except for import lines and the device lines listed here.
"""

import difflib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# Lines a copy may change beyond its import lines (stripped text).
DEVICE_LINES = {
    "accounting.py": {
        'def ledger_to_vector(ledger: Ledger) -> jnp.ndarray:',
        'return jnp.asarray([getattr(ledger, f) for f in LEDGER_FIELDS], jnp.int32)',
        'def ledger_to_vector(ledger: Ledger) -> torch.Tensor:',
        'return torch.tensor([getattr(ledger, f) for f in LEDGER_FIELDS], dtype=torch.int32)',
        # The docstring names the port's psum instead of jax.lax.psum.
        'TPU-first design: the ledger is a small vector of named counters so that in a',
        'sharded run the global ledger is literally ``jax.lax.psum`` of the per-shard',
        'ledgers over the mesh (BASELINE config 5: "global leaked-bit psum',
        'accounting") — see qtpu.parallel.',
        'sharded run the global ledger is the sum of the per-shard ledger vectors',
        'over the mesh (BASELINE config 5: "global leaked-bit psum accounting") —',
        'see qtpu.parallel.psum_ledger.',
    },
    "messages.py": {'a = a.cpu() if hasattr(a, "cpu") else a'},
    # The signed block index lets stream-PA records (-1 - flush_idx) pack.
    "keystore.py": {
        '_HEAD = struct.Struct("<IIII")',
        '_HEAD = struct.Struct("<IIiI")  # signed block_index: stream-PA '
        'records use -1 - flush_idx',
    },
    # jax.random.uniform on the host CPU -> the bit-exact threefry uniform.
    "cascade.py": {
        'with jax.default_device(jax.devices("cpu")[0]):',
        'return np.asarray(jax.random.uniform(key, (n,)))',
        'return random.uniform(random.key_from_data(key, "cpu"), n).numpy()',
    },
}
PORT_ONLY_MARKER = "# Port-only additions"


def test_no_module_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qtpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(qtpu_torch.__path__,"
        " 'qtpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 33, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'qtpu' or m.startswith('qtpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_imports_no_jax():
    """The mesh module runs on the card's machine, which has no JAX."""
    code = ("import sys\n"
            "import qtpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'qtpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bench_imports_no_jax():
    """The bench runs on the card's machine, which has no JAX."""
    code = ("import sys\n"
            "import qtpu_torch.bench\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'qtpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _is_import(line: str) -> bool:
    s = line.strip()
    return s.startswith(("import ", "from "))


@pytest.mark.parametrize("rel", [
    "framing.py", "prng.py", "qber.py", "link.py", "messages.py",
    "accounting.py", "channel.py", "ldpc/codes.py", "ldpc/designed.py",
    "auth.py", "keystore.py", "config.py", "ldpc/cascade.py",
    "ldpc/golden.py", "ldpc/design.py"])
def test_numpy_copy_matches_original(rel):
    orig = (ROOT / "qtpu" / rel).read_text().splitlines()
    port = (ROOT / "qtpu_torch" / rel).read_text()
    if PORT_ONLY_MARKER in port:   # drop the marker block's rule line too
        port = port.split(PORT_ONLY_MARKER)[0].rstrip().rsplit("\n", 1)[0]
    port = port.replace("qtpu_torch", "qtpu").rstrip().splitlines()
    allowed = DEVICE_LINES.get(rel.split("/")[-1], set())
    sm = difflib.SequenceMatcher(a=orig, b=port, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        for line in orig[i1:i2] + port[j1:j2]:
            assert _is_import(line) or not line.strip() or \
                line.strip() in allowed, f"{rel}: {tag} {line!r}"


def test_calibration_tables_match_original():
    def tables(pkg):
        text = (ROOT / pkg / "ldpc" / "calibrate.py").read_text()
        return text[text.index("# Measured with blocks=256"):
                    text.index("def main(")].rstrip()
    assert tables("qtpu_torch") == tables("qtpu")


@pytest.mark.parametrize("name", ["framing.cpp", "transferd.cpp"])
def test_native_sources_are_byte_copies(name):
    orig = ROOT / "qtpu" / "runtime" / "native" / name
    port = ROOT / "qtpu_torch" / "runtime" / "native" / name
    assert port.read_bytes() == orig.read_bytes()
