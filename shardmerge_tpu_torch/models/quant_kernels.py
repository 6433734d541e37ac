"""int4 GEMV: the hand-written CUDA kernel and its plain version
(counterpart of shardmerge_tpu/models/quant_kernels.py).

``int4_matmul(x, q, scale)`` computes ``x @ dequant({q, scale}).T`` for the
split-half packed layout of models/quant.py, accumulating in f32 and
returning x's dtype. On a CUDA tensor it launches ``csrc/int4_gemv.cu``
(built for sm_90a with ``nvcc`` at first use, bound with ctypes) or raises;
on a CPU tensor it runs :func:`int4_matmul_plain`. The TPU kernel's
byte-plus-low-nibble identity (a Mosaic workaround) is not carried over:
the CUDA kernel extracts both nibbles directly (bf16 x on the tensor cores,
f32 x on the CUDA cores).

The kernel's launch plan is :func:`plan`, a function of the weight's
(N, K) and x's dtype alone: how many splits of K/2 run in parallel (the
splits of a row tile are one thread block cluster, whose first block adds
their partial sums in split order). It never depends on the rows of x, so a
row's result has the same bits alone as in a batch of up to 64.
:func:`int4_matmul_split_order` is that split structure in plain torch.

Each launch of the kernel adds one to ``launch_counts["int4_gemv"]``.

:class:`Int4Matmul` is the product as an autograd function (JAX's
``custom_vjp``): its forward is :func:`int4_matmul`, its backward
``dx = g @ dequant(W)`` in g's dtype as a plain matmul (JAX runs it on XLA
outside the Pallas kernel), and the frozen ``q`` and ``scale`` get no
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from .. import kernel_build
from .quant import dequant

__all__ = [
    "int4_matmul",
    "Int4Matmul",
    "int4_matmul_plain",
    "int4_matmul_split_order",
    "supported",
    "plan",
    "Plan",
    "TILES",
    "MAX_SPLITS",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

MAX_ROWS = 64  # decode / small-batch token counts; larger products use matmul
_SOURCE = kernel_build.CSRC / "int4_gemv.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# (output rows a block owns, packed bytes of a row a pipeline stage holds) by
# x's dtype: the kernel's (kRows, kChunk) for bf16 x (at B <= 16; twice the
# rows above) and (kFmaRows, kFmaChunk) for f32 x
TILES = {torch.bfloat16: (32, 256), torch.float32: (32, 64)}
MAX_SPLITS = 8  # a thread block cluster holds at most 8 blocks (the kernel's kMaxSplits)
_TARGET_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
_MIN_CHUNKS = 4  # chunks a split streams at least, so that its pipeline fills

launch_counts: Counter = Counter()


class Plan(NamedTuple):
    """The kernel's launch plan for an (N, K) weight: ``splits`` runs of
    ``chunks_per_split`` chunks of K/2 of ``chunk`` bytes each (the last
    run may be shorter)."""

    splits: int
    chunks_per_split: int
    chunk: int


@functools.lru_cache(maxsize=None)
def plan(n: int, k: int, dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The launch plan for an (N, K) weight and x's dtype, whatever the rows
    of x: enough splits of K/2 that the grid holds about two blocks per SM,
    at most ``MAX_SPLITS``, each split at least ``_MIN_CHUNKS`` chunks long,
    and no split empty."""
    row_tile, chunk = TILES[dtype]
    chunks = -(-(k // 2) // chunk)
    tiles = -(-n // row_tile)
    want = max(1, round(_TARGET_BLOCKS / tiles))
    splits = max(1, min(want, MAX_SPLITS, chunks // _MIN_CHUNKS))
    per = -(-chunks // splits)
    return Plan(-(-chunks // per), per, chunk)


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
        ctypes.c_int,  # chunks per split
        ctypes.c_int,  # dtype code
        ctypes.c_void_p,  # stream
    ]
    lib.int4_gemv.restype = ctypes.c_int


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, scale).T`` with f32 accumulation, output in x.dtype."""
    w = dequant({"q": q, "scale": scale.reshape(-1, 1)}, torch.float32)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def int4_matmul_split_order(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's split structure in plain torch: K/2 cut by
    ``plan(N, K, x.dtype)`` into runs of ``chunks_per_split * chunk`` bytes; each
    run's f32 partial sums (low nibbles against x[:, j], high nibbles
    against x[:, K/2 + j]) added in run order, then scaled once and rounded
    once to x's dtype."""
    n, kh = q.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, 2 * kh).to(torch.float32)
    lo = ((q & 0xF).to(torch.int32) - 8).to(torch.float32)
    hi = ((q >> 4).to(torch.int32) - 8).to(torch.float32)
    p = plan(n, 2 * kh, x.dtype)
    run = p.chunks_per_split * p.chunk
    total = None
    for start in range(0, kh, run):
        end = min(kh, start + run)
        part = xf[:, start:end] @ lo[:, start:end].T + xf[:, kh + start : kh + end] @ hi[:, start:end].T
        total = part if total is None else total + part
    return (total * scale.reshape(1, n)).to(x.dtype).reshape(*lead, n)


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
    if x2.data_ptr() % 16:  # a view at an odd offset: cp.async copies 16 aligned bytes
        x2 = x2.clone()
    rows = x2.shape[0]
    p = plan(n, 2 * kh, x.dtype)
    dev = x.device
    y = torch.empty((rows, n), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = kernel_build.load(_SOURCE, _bind).int4_gemv(
            x2.data_ptr(),
            q.data_ptr(),
            scale.data_ptr(),
            y.data_ptr(),
            rows,
            n,
            kh,
            p.chunks_per_split,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_gemv launch failed: cudaError {err}")
    launch_counts["int4_gemv"] += 1
    return y.reshape(*lead, n)


class Int4Matmul(torch.autograd.Function):
    """``x @ dequant({q, scale}).T`` with a gradient for x: the forward is
    :func:`int4_matmul` (the kernel on a CUDA tensor), the backward
    ``g @ dequant(W)`` in g's dtype; q and scale are frozen."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, scale)
        return int4_matmul(x, q, scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, scale = ctx.saved_tensors
        w = dequant({"q": q, "scale": scale.reshape(-1, 1)}, g.dtype)
        return g @ w, None, None
