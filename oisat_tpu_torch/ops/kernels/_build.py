"""Build and load the port's CUDA sources.

Each ``oisat_tpu_torch/csrc/<name>.cu`` exposes a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``oisat_tpu_torch/_build/lib<name>.so`` at first use, rebuilt when the source
or a header of ``csrc/`` is newer, and loaded with ``ctypes``.  A failed
build raises with nvcc's output: there is no fallback.  ptxas's register /
spill report is kept next to the library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library", "build_log"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards the two dicts below
_locks: dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _build(src: Path, lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per-pid temp + atomic rename: a concurrent process never loads a
    # half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if missing
    or older than its source or a ``csrc/*.cuh`` header.  Different libraries
    build concurrently when called from several threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        hit = _loaded.get(name)
        if hit is not None:
            return hit
        src = CSRC_DIR / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
        if not lib.exists() or lib.stat().st_mtime < newest:
            _build(src, lib)
        handle = ctypes.CDLL(str(lib))
        with _lock:
            _loaded[name] = handle
        return handle


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of ``name`` ('' if none kept)."""
    log = BUILD_DIR / f"lib{name}.log"
    return log.read_text() if log.exists() else ""
