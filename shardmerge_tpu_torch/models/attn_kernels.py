"""Flash-decode attention: the hand-written CUDA kernel and its plain
version (counterpart of shardmerge_tpu/models/attn_kernels.py).

``flash_decode(q, k_cache, v_cache, mask)`` is the masked attention of one
query token per row: q (B, KVH, G, D) f32, already scaled by 1/sqrt(D); the
bf16 caches (B, KVH, S, D); the additive f32 mask (B, Sm), Sm <= S, that
``LlamaModel.forward`` builds (0 valid / -1e9 masked; slots from Sm on are
masked), so causal horizons, left pads and the continuous pool's join gaps
ride through unchanged. It returns (B, KVH, G, D) f32.

The kernel reads only each row's valid slots and splits them into blocks
of 64 in slot order, so a row's result does not depend on the batch, the
cache length or where its gaps fall: a request decoded in the pool gets the
same bits as decoded alone, and its greedy tokens match the solo stream.
On a CUDA tensor it launches ``csrc/flash_decode.cu`` (built for sm_90a
with ``nvcc`` at first use, bound with ctypes) or raises; on a CPU tensor
it runs :func:`flash_decode_plain`.

Unlike the JAX package, where the kernel is opt-in, the port routes every
T=1 decode attention on the card through it (:func:`use_flash_decode`):
the einsum path casts the whole cache layer to f32 twice per step and runs
several launches where the kernel reads the bf16 cache once. There is no
environment switch and no fallback: a model whose attention the kernel
cannot take is refused when it is built on the card
(:func:`check_geometry`), and a call with inputs the kernel cannot take
raises.

Each launch adds one to ``launch_counts["flash_decode"]``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import torch

from .. import kernel_build

__all__ = [
    "flash_decode",
    "flash_decode_plain",
    "supported",
    "check_geometry",
    "use_flash_decode",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

HEAD_DIMS = (64, 128)  # the kernel's D: D / 8 lanes of 16-byte loads per row
MAX_GROUP = 8  # query heads per KV head: one warp each for the softmax
SPLIT = 64  # valid slots per block (the kernel's kSplit)
_SOURCE = kernel_build.CSRC / "flash_decode.cu"

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def supported(q_shape, s: int) -> bool:
    """True when the kernel takes a (B, KVH, G, D) query over an S-slot
    cache: D = 64 or 128, 1 <= G <= 8, any S >= 1 (the engine's buckets are
    multiples of 256)."""
    b, kvh, g, d = q_shape
    return d in HEAD_DIMS and 1 <= g <= MAX_GROUP and b >= 1 and kvh >= 1 and s >= 1


def check_geometry(cfg) -> None:
    """Raise ``NotImplementedError`` for a model whose decode attention the
    kernel cannot take (head_dim not 64 or 128, or more than 8 query heads
    per KV head). Called when a model is built on the card, so such a
    model fails at load instead of at its first decode step."""
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    if not supported((1, cfg.num_key_value_heads, group, cfg.head_dim), 1):
        raise NotImplementedError(
            f"flash_decode on the card takes head_dim in {HEAD_DIMS} and at most "
            f"{MAX_GROUP} query heads per KV head; this model has head_dim "
            f"{cfg.head_dim} and {group}"
        )


def use_flash_decode(cfg, t: int, q: torch.Tensor) -> bool:
    """Route one attention call: True for a single query token (T = 1) on a
    CUDA tensor, whatever its geometry (:func:`flash_decode` raises on one
    it cannot take). Prefill (T > 1) and CPU tensors take the einsum path.
    Attention sinks and logit softcaps, which the kernel does not compute,
    never reach it: ModelConfig rejects the configs that have them."""
    return t == 1 and q.is_cuda


def build(verbose: bool = False) -> Path:
    """Compile the kernel into ``_build/`` (once per source content) and
    return the shared library's path."""
    return kernel_build.build(_SOURCE, verbose)


def _bind(lib) -> None:
    lib.flash_decode.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.flash_decode.restype = ctypes.c_int


def flash_decode_plain(q, k_cache, v_cache, mask) -> torch.Tensor:
    """The einsum / f32-softmax semantics of the decode attention:
    softmax(q k^T + mask) v per (b, kvh, g) over the mask's Sm slots, all
    in f32."""
    sm = mask.shape[-1]
    k = k_cache[:, :, :sm].to(torch.float32)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.to(torch.float32), k)
    scores = scores + mask.to(torch.float32)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", probs, v_cache[:, :, :sm].to(torch.float32))


def flash_decode(q, k_cache, v_cache, mask) -> torch.Tensor:
    """Masked decode attention, (B, KVH, G, D) f32. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, mask)
    b, kvh, g, d = q.shape
    s = k_cache.shape[2]
    if not supported(q.shape, s):
        raise ValueError(
            f"flash_decode: unsupported query {tuple(q.shape)} over {s} slots "
            f"(need D in {HEAD_DIMS}, 1 <= G <= {MAX_GROUP})"
        )
    if q.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("flash_decode: q and mask must be float32")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.shape != (b, kvh, s, d) or c.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode: {name} must be bf16 of shape {(b, kvh, s, d)}")
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and 16-byte aligned")
        if c.device != q.device:
            raise ValueError("flash_decode: q and the caches must be on one device")
    sm = mask.shape[-1]
    if mask.dim() != 2 or mask.shape[0] != b or not 1 <= sm <= s or mask.device != q.device:
        raise ValueError(f"flash_decode: mask must be ({b}, Sm <= {s}) on q's device")
    q = q.contiguous()
    mask = mask.contiguous()
    nsplit = -(-sm // SPLIT)
    dev = q.device
    idx = torch.empty((b, sm), dtype=torch.int32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    part_m = torch.empty((b, kvh, nsplit, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kvh, nsplit, g, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernel_build.load(_SOURCE, _bind).flash_decode(
            q.data_ptr(),
            k_cache.data_ptr(),
            v_cache.data_ptr(),
            mask.data_ptr(),
            idx.data_ptr(),
            count.data_ptr(),
            part_m.data_ptr(),
            part_l.data_ptr(),
            part_acc.data_ptr(),
            out.data_ptr(),
            b,
            kvh,
            g,
            d,
            sm,
            s,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    launch_counts["flash_decode"] += 1
    return out
