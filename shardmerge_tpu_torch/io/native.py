"""ctypes bindings for the host-IO library ``csrc/stio.cpp`` (counterpart of
shardmerge_tpu/io/native.py): multi-threaded memcpy, bf16 <-> f32
conversions (the narrowing rounds to nearest even, bit-exact with torch's
cast on every non-NaN value), parallel ``pread`` of byte ranges and a
readahead hint.

The library is built at first use with the system C++ compiler into the
gitignored ``shardmerge_tpu_torch/_build/`` (once per source content); a
failed build raises with the compiler's message. Nothing falls back to
torch quietly.

Not wired into the merge. The JAX package uses it for the owned copy of a
read (``get_tensor(copy=True)``) and the writer's f32 -> bf16 narrowing,
where numpy and ml_dtypes run on one thread; torch's ``copy_`` and cast
already run on its intra-op threads. On the card machine's host (8 cores,
NVIDIA H100 80GB HBM3 machine at 700.00 W), at a (14336, 4096) f32
tensor, chip_smoke.py's ``[inputs]`` phase measured, in GB/s of bytes read
and written, in three runs: copy 44.03, 29.27 and 32.68 against torch's
58.26, 45.11 and 50.71, cast 36.07, 22.55 and 24.72 against 42.58, 39.52
and 41.17 (the later two interleaved the four, medians of 11, this
library on torch's 8 threads).

torch's own copy and cast won every time, so the index and the writer
keep them (PERF.md, section 6).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

__all__ = ["load", "bf16_to_f32", "f32_to_bf16", "parallel_copy", "read_blocks", "prefault_file"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "stio.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    src = SOURCE.read_bytes()
    lib_path = _BUILD_DIR / f"libstio_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if lib_path.exists():
        return lib_path
    cc = next((c for c in (os.environ.get("CXX"), "c++", "g++", "clang++") if c and shutil.which(c)), None)
    if cc is None:
        raise RuntimeError(f"no C++ compiler (c++, g++, clang++ or $CXX) to build {SOURCE}")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"tmp{os.getpid()}_{lib_path.name}"
    cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-std=c++17", str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The library, built and opened once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.stio_read_blocks.restype = ctypes.c_int
            lib.stio_read_blocks.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64, ctypes.c_int,
            ]
            for name in ("stio_bf16_to_f32", "stio_f32_to_bf16", "stio_memcpy"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            lib.stio_prefault.restype = None
            lib.stio_prefault.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                                          ctypes.c_int]
            _lib = lib
        return _lib


def _threads(nthreads: int) -> int:
    """Worker threads of a call: torch's intra-op count unless given (the
    library's own default, the machine's core count, can exceed the cores
    a container may use)."""
    return nthreads or torch.get_num_threads()


def _host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu":
        raise ValueError(f"host-IO functions take CPU tensors, got one on {t.device}")
    return t.contiguous()


def _out(src: torch.Tensor, dtype: torch.dtype, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty(src.shape, dtype=dtype)
    if out.shape != src.shape or out.dtype != dtype or not out.is_contiguous() or out.device.type != "cpu":
        raise ValueError(f"out must be a contiguous CPU {dtype} tensor of shape {tuple(src.shape)}")
    return out


def parallel_copy(src: torch.Tensor, out: Optional[torch.Tensor] = None, nthreads: int = 0) -> torch.Tensor:
    """An owned copy of a (possibly mmap-backed) CPU tensor, into ``out``
    (e.g. page-locked) when given."""
    src = _host(src)
    dst = _out(src, src.dtype, out)
    nbytes = src.numel() * src.element_size()
    if nbytes:
        load().stio_memcpy(dst.data_ptr(), src.data_ptr(), nbytes, _threads(nthreads))
    return dst


def bf16_to_f32(src: torch.Tensor, out: Optional[torch.Tensor] = None, nthreads: int = 0) -> torch.Tensor:
    """Widen bf16 to f32."""
    src = _host(src)
    if src.dtype != torch.bfloat16:
        raise ValueError(f"expected bfloat16, got {src.dtype}")
    dst = _out(src, torch.float32, out)
    if src.numel():
        load().stio_bf16_to_f32(src.data_ptr(), dst.data_ptr(), src.numel(), _threads(nthreads))
    return dst


def f32_to_bf16(src: torch.Tensor, out: Optional[torch.Tensor] = None, nthreads: int = 0) -> torch.Tensor:
    """Narrow f32 to bf16, rounding to nearest even."""
    src = _host(src)
    if src.dtype != torch.float32:
        raise ValueError(f"expected float32, got {src.dtype}")
    dst = _out(src, torch.bfloat16, out)
    if src.numel():
        load().stio_f32_to_bf16(src.data_ptr(), dst.data_ptr(), src.numel(), _threads(nthreads))
    return dst


def read_blocks(path, offsets: Sequence[int], sizes: Sequence[int], buffers: Sequence[torch.Tensor],
                nthreads: int = 0) -> bool:
    """Parallel pread of byte ranges of ``path`` into contiguous CPU
    tensors; returns whether every read was complete."""
    n = len(offsets)
    for buf, size in zip(buffers, sizes):
        if not buf.is_contiguous() or buf.numel() * buf.element_size() < size:
            raise ValueError("each buffer must be contiguous and hold its range")
    off_arr = (ctypes.c_uint64 * n)(*offsets)
    size_arr = (ctypes.c_uint64 * n)(*sizes)
    dest_arr = (ctypes.c_void_p * n)(*[buf.data_ptr() for buf in buffers])
    fd = os.open(path, os.O_RDONLY)
    try:
        rc = load().stio_read_blocks(fd, off_arr, size_arr, dest_arr, n, _threads(nthreads))
    finally:
        os.close(fd)
    return rc == 0


def prefault_file(path, offset: int = 0, length: Optional[int] = None) -> None:
    """Advise the kernel that a byte range of ``path`` is about to be read."""
    size = os.path.getsize(path)
    length = size - offset if length is None else min(length, size - offset)
    fd = os.open(path, os.O_RDONLY)
    try:
        load().stio_prefault(fd, offset, length, None, 0)
    finally:
        os.close(fd)
