"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``qtpu_torch/csrc/<name>.cu`` has a plain C entry point; it compiles to
``build/qtpu_torch/lib<name>-<hash>.so`` at the repository root (the hash
covers the source, the headers it includes and the flags, so an edited
source or header rebuilds) and loads with ``ctypes``.  Nothing here runs at import time: the CPU path never needs
a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "build_log", "entry", "call",
           "launch", "on_card"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qtpu_torch"

# -fmad=false: the reference rounds every multiply and add separately (see
# csrc/bp_layered.cu, csrc/bp_flooding.cu); never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}
# nvcc runs started and libraries loaded since import (the bench counts
# those inside a timed region).
build_events = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of qtpu_torch build from source at first use")
    return found


def _sources(src: Path) -> list[Path]:
    """``src`` and every header it includes with ``#include "..."`` from
    ``csrc/``, transitively, each once."""
    out, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path not in out:
            out.append(path)
            todo += [_CSRC / inc for inc in re.findall(
                r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)]
    return out


def _paths(name: str) -> tuple[Path, Path, Path]:
    """(source, library, compiler log) of ``csrc/<name>.cu``; the library's
    tag hashes the source, the headers it includes and the flags."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:12]
    return (src, BUILD_DIR / f"lib{name}-{tag}.so",
            BUILD_DIR / f"lib{name}-{tag}.log")


def build(*names: str) -> list[Path]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    ``nvcc`` per source, all started together; returns the libraries'
    paths.  Every started compiler is waited for before a failure raises."""
    global build_events
    jobs = []
    for name in names:
        src, out, log = _paths(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((proc, src, tmp, out, log))
            build_events += 1
    failed = []
    for proc, src, tmp, out, log in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{stdout}{stderr}")
            continue
        # Another process may build the same library at the same moment:
        # both write their own temporary files and rename them into place.
        log_tmp = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        log_tmp.write_text(stdout + stderr)
        os.replace(log_tmp, log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    paths = []
    for name in names:
        _, out, log = _paths(name)
        _LOGS[name] = log.read_text() if log.exists() else ""
        paths.append(out)
    return paths


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    global build_events
    if name not in _LIBS:
        from qtpu_torch import tracing
        with tracing.span("build"):
            _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
        build_events += 1
    return _LIBS[name]


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``: registers, spills, shared
    memory) from the build of ``name``."""
    return _LOGS.get(name, "")


@functools.cache
def entry(library: str, name: str, argtypes: tuple):
    """Entry point ``qtpu_<name>`` of ``library`` (built and loaded at
    first use), typed: an int return code, ``argtypes``."""
    fn = getattr(load(library), f"qtpu_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def call(library: str, name: str, argtypes: tuple, dev, *args) -> None:
    """Call entry point ``qtpu_<name>`` of ``library`` with ``args`` and
    the current stream of CUDA device ``dev`` (a ``torch.device``), by its
    raw handle; makes ``dev`` the current device around the call only when
    it is not already.  Raises when the entry point returns an error (a
    refused launch, arguments it does not take)."""
    import torch
    fn = entry(library, name, argtypes)
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (code {rc})")


def launch(library: str, name: str, argtypes: tuple, counts: dict, dev,
           *args) -> None:
    """``call`` entry point ``qtpu_<name>`` of ``library`` (typed by
    ``argtypes``) on the current stream of ``dev``, then add one to
    ``counts[name]``, the caller's launch counter."""
    call(library, name, argtypes, dev, *args)
    counts[name] += 1


def on_card(dev, what: str) -> bool:
    """True for a CUDA device, False for the CPU; raises ValueError naming
    ``what`` for another."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on the CPU or a CUDA device, not "
                         f"{dev}")
    return dev.type == "cuda"
