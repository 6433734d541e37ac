"""Build a hand-written CUDA source into a shared library and load it.

Each kernel in ``csrc/`` has a plain C entry point (no PyTorch headers), so
``nvcc`` builds it in seconds. :func:`build` compiles one source for sm_90a
into the gitignored ``_build/`` directory, once per source content;
:func:`load` builds it, opens it with ctypes and lets the caller declare the
entry point's argument types. Nothing is built or loaded when a module is
imported: a kernel's wrapper calls :func:`load` at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

__all__ = ["CSRC", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` into ``_build/`` (once per source content) and
    return the shared library's path. ``verbose`` prints ptxas's register
    and shared-memory report."""
    src = source.read_bytes()
    lib_path = _BUILD_DIR / f"lib{source.stem}_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.parent / f"tmp{os.getpid()}_{threading.get_ident()}_{lib_path.name}"
    cmd = [
        _nvcc(),
        "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-o",
        str(tmp),
        str(source),
    ]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr.strip())
    os.replace(tmp, lib_path)
    return lib_path


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from ``source``, opened once per process;
    ``bind`` declares its entry points' argtypes/restype on first open."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
        return lib
