"""int4 GEMV: the hand-written CUDA kernel and its plain version
(counterpart of shardmerge_tpu/models/quant_kernels.py).

``int4_matmul(x, q, scale)`` computes ``x @ dequant({q, scale}).T`` for the
split-half packed layout of models/quant.py, accumulating in f32 and
returning x's dtype. On a CUDA tensor it launches ``csrc/int4_gemv.cu``
(built for sm_90a with ``nvcc`` at first use, bound with ctypes) or raises;
on a CPU tensor it runs :func:`int4_matmul_plain`. The TPU kernel's
byte-plus-low-nibble identity (a Mosaic workaround) is not carried over:
the CUDA kernel extracts both nibbles directly.

Each launch of the kernel adds one to ``launch_counts["int4_gemv"]``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import torch

from .. import kernel_build
from .quant import dequant

__all__ = [
    "int4_matmul",
    "int4_matmul_plain",
    "supported",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

MAX_ROWS = 64  # decode / small-batch token counts; larger products use matmul
_SOURCE = kernel_build.CSRC / "int4_gemv.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def supported(x_shape, q_shape) -> bool:
    """True when the kernel takes this (x, packed q) pair: at most
    ``MAX_ROWS`` rows of x and a packed row of whole 16-byte vectors."""
    if len(q_shape) != 2:
        return False
    kh = q_shape[1]
    if x_shape[-1] != 2 * kh or kh % 16:
        return False
    rows = 1
    for d in x_shape[:-1]:
        rows *= d
    return 1 <= rows <= MAX_ROWS


def build(verbose: bool = False) -> Path:
    """Compile the kernel into ``_build/`` (once per source content) and
    return the shared library's path."""
    return kernel_build.build(_SOURCE, verbose)


def _bind(lib) -> None:
    lib.int4_gemv.argtypes = [
        ctypes.c_void_p,  # x
        ctypes.c_void_p,  # q
        ctypes.c_void_p,  # scale
        ctypes.c_void_p,  # y
        ctypes.c_int,  # B
        ctypes.c_int,  # N
        ctypes.c_int,  # K / 2
        ctypes.c_int,  # dtype code
        ctypes.c_void_p,  # stream
    ]
    lib.int4_gemv.restype = ctypes.c_int


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, scale).T`` with f32 accumulation, output in x.dtype."""
    w = dequant({"q": q, "scale": scale.reshape(-1, 1)}, torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def int4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant({q, scale}).T`` for x (..., K), q (N, K/2) uint8,
    scale (N, 1) f32. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return int4_matmul_plain(x, q, scale)
    n, kh = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if not supported(x.shape, q.shape):
        raise ValueError(
            f"int4_matmul: unsupported shapes x {tuple(x.shape)}, q {tuple(q.shape)} "
            f"(need x[..., 2*K/2], K/2 % 16 == 0, at most {MAX_ROWS} rows)"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.uint8 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("int4_matmul: q must be a contiguous, 16-byte aligned uint8 tensor")
    if scale.numel() != n or scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError("int4_matmul: scale must be a contiguous f32 tensor of N values")
    if not (q.device == x.device == scale.device):
        raise ValueError("int4_matmul: x, q and scale must be on one device")
    y = torch.empty((x2.shape[0], n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel_build.load(_SOURCE, _bind).int4_gemv(
            x2.data_ptr(),
            q.data_ptr(),
            scale.data_ptr(),
            y.data_ptr(),
            x2.shape[0],
            n,
            kh,
            _DTYPE_CODES[x.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_gemv launch failed: cudaError {err}")
    launch_counts["int4_gemv"] += 1
    return y.reshape(*lead, n)
