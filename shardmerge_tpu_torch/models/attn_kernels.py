"""Flash-decode attention: the hand-written CUDA kernel and its plain
version (counterpart of shardmerge_tpu/models/attn_kernels.py).

``flash_decode(q, k_cache, v_cache, mask, slots=None)`` is the masked
attention of one query token per row: q (B, KVH, G, D) f32, already scaled
by 1/sqrt(D); the bf16 caches (B, KVH, S, D); the additive f32 mask (B, Sm),
Sm <= S, that ``LlamaModel.forward`` builds (0 valid / -1e9 masked; slots
from Sm on are masked), so causal horizons, left pads and the continuous
pool's join gaps ride through unchanged. It returns (B, KVH, G, D) f32.

The kernel reads only each row's valid slots, from a slot list that
:func:`compact` builds once per decode step and mask kind (the mask is the
same in every layer of a kind; ``LlamaModel.forward`` hands one
:class:`Slots` for the full mask, one for the sliding window and one for
Llama-4's chunked mask to the layers of each kind, and a list is compacted
at its first use), and splits them into blocks of
``SPLIT`` in slot order, merged in split order. So a row's result does not
depend on the batch, the cache length or where its gaps fall: a request
decoded in the pool gets the same bits as decoded alone, and its greedy
tokens match the solo stream. :func:`flash_decode_split_order` is that
order in plain torch. Called without ``slots``, ``flash_decode`` compacts
the mask itself. On a CUDA tensor it launches ``csrc/flash_decode.cu``
(built for sm_90a with ``nvcc`` at first use, bound with ctypes) or raises;
on a CPU tensor it runs :func:`flash_decode_plain`.

Unlike the JAX package, where the kernel is opt-in, the port routes every
T=1 decode attention on the card whose geometry the kernel takes (head_dim
64 or 128, 1 to 64 query heads per KV head: :func:`supported`) and whose
config has no logit softcap and no attention sinks through it
(:func:`use_flash_decode`): the einsum path casts the whole cache layer to
f32 twice per step and runs several launches where the kernel reads the
bf16 cache once. Every other geometry (head_dim 96 or 256, more than 64
query heads per KV head), every softcapped config and GPT-OSS's sinks take
the einsum path on the card, the JAX model's default route. The route is chosen by shape alone, never by a
failure: a call to the kernel with inputs it cannot take raises.

Each attention launch adds one to ``launch_counts["flash_decode"]``, each
compaction launch one to ``launch_counts["flash_compact"]``: their sum is
the device launches, one per call after the step's compaction. A T=1 call
on the card that the route sends to the einsum path adds one to
``launch_counts["decode_einsum"]`` instead.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import kernel_build

__all__ = [
    "flash_decode",
    "flash_decode_plain",
    "flash_decode_split_order",
    "Slots",
    "compact",
    "compact_plain",
    "supported",
    "head_chunks",
    "use_flash_decode",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

HEAD_DIMS = (64, 128)  # the kernel's D: D / 8 lanes of 16-byte loads per row
MAX_GROUP = 64  # query heads per KV head (the JAX kernel's limit)
CHUNK_GROUP = 4  # query heads a kernel block takes (the kernel's kMaxG: more spill its registers)
SPLIT = 256  # valid slots per block (the kernel's kSplit)
_MASKED_AT = -1e8  # mask values at or below: a masked slot (the kernel's kMaskedAt)
_SOURCE = kernel_build.CSRC / "flash_decode.cu"

launch_counts: Counter = Counter()
# per (device, stream): the kernel's partials and its counters (one per
# row, KV head and head chunk), grown on demand; every launch writes its
# partials before it reads them and leaves the counters zero, so launches
# in stream order may share them
_scratch: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def supported(q_shape, s: int) -> bool:
    """True when the kernel takes a (B, KVH, G, D) query over an S-slot
    cache: D = 64 or 128, 1 <= G <= 64, any S >= 1 (the engine's buckets are
    multiples of 256)."""
    b, kvh, g, d = q_shape
    return d in HEAD_DIMS and 1 <= g <= MAX_GROUP and b >= 1 and kvh >= 1 and s >= 1


def head_chunks(g: int) -> Tuple[int, int]:
    """(chunks, heads per chunk): the kernel's grid splits a KV head's G
    query heads into ceil(G / 4) chunks of at most 4, balanced; the last
    may hold fewer. A head's arithmetic does not depend on its chunk."""
    n = -(-g // CHUNK_GROUP)
    return n, -(-g // n)


def use_flash_decode(cfg, t: int, q: torch.Tensor) -> bool:
    """Route one attention call: True for a single query token (T = 1) on a
    CUDA tensor whose geometry the kernel takes (:func:`supported`) and
    whose layers carry neither an attention logit softcap (Gemma-2) nor
    sinks (GPT-OSS: ``cfg.has_sinks``, a sink logit in every layer), which
    the kernel does not compute (the JAX route's rule, shardmerge_tpu/
    models/attn_kernels.py:89). A T=1 call on the card that the route sends
    to the einsum path is counted under ``launch_counts["decode_einsum"]``.
    Prefill (T > 1) and CPU tensors take the einsum path. A tensor-parallel
    rank's query heads a KV head may be fewer than the model's H / KVH (a
    divisor of it), which the kernel takes whenever it takes the model's."""
    if t != 1 or not q.is_cuda:
        return False
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    if not (cfg.attn_logit_softcapping or cfg.has_sinks) and supported(
            (1, cfg.num_key_value_heads, group, cfg.head_dim), 1):
        return True
    launch_counts["decode_einsum"] += 1
    return False


def build(verbose: bool = False) -> Path:
    """Compile the kernel into ``_build/`` (once per source content) and
    return the shared library's path."""
    return kernel_build.build(_SOURCE, verbose)


def _bind(lib) -> None:
    lib.flash_compact.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.flash_compact.restype = ctypes.c_int
    lib.flash_decode.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def compact_plain(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row b's valid slots (mask > -1e8) in slot order as idx[b, :count[b]]
    (int32; the rest of the row 0), and count (B,) int32: the compaction
    kernel's output in plain torch."""
    valid = mask > _MASKED_AT
    count = valid.sum(dim=-1, dtype=torch.int32)
    slot = torch.arange(mask.shape[-1], device=mask.device, dtype=torch.int32).expand_as(mask)
    # stable sort puts the valid slots first, in slot order
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    idx = torch.where(slot < count[:, None], torch.gather(slot, -1, order), torch.zeros_like(slot))
    return idx.to(torch.int32), count


class Slots:
    """A decode step's valid-slot list: the (B, Sm) mask and, once compacted
    (at the first :func:`flash_decode` that takes it, or by :func:`compact`),
    the kernel's idx (B, Sm) and count (B,) int32 tensors. One per forward
    step, shared by every layer."""

    __slots__ = ("mask", "idx", "count")

    def __init__(self, mask: torch.Tensor):
        self.mask = mask
        self.idx: Optional[torch.Tensor] = None
        self.count: Optional[torch.Tensor] = None


def compact(mask_or_slots) -> Slots:
    """Compact a (B, Sm) mask (or fill a :class:`Slots`) into the valid-slot
    list: one launch of the compaction kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    slots = mask_or_slots if isinstance(mask_or_slots, Slots) else Slots(mask_or_slots)
    mask = slots.mask
    if not mask.is_cuda:
        slots.idx, slots.count = compact_plain(mask)
        return slots
    if mask.dtype != torch.float32 or mask.dim() != 2 or not mask.is_contiguous():
        raise ValueError("compact: the mask must be a contiguous (B, Sm) float32 tensor")
    b, sm = mask.shape
    dev = mask.device
    idx = torch.empty((b, sm), dtype=torch.int32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kernel_build.load(_SOURCE, _bind).flash_compact(
            mask.data_ptr(), idx.data_ptr(), count.data_ptr(), b, sm, torch.cuda.current_stream(dev).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"flash_compact launch failed: cudaError {err}")
    launch_counts["flash_compact"] += 1
    slots.idx, slots.count = idx, count
    return slots


def flash_decode_split_order(q, k_cache, v_cache, mask) -> torch.Tensor:
    """The kernel's order in plain torch: each row's valid slots in slot
    order, cut into blocks of ``SPLIT``; each block's f32 (max, sum, p @ V)
    and the blocks merged in block order. A row with no valid slot gives
    zeros. Every value a row's result depends on is gathered from that row
    alone, so it does not change with the other rows, the gaps or the cache
    length."""
    b, kvh, g, d = q.shape
    idx, count = compact_plain(mask)
    out = torch.zeros((b, kvh, g, d), dtype=torch.float32, device=q.device)
    for row in range(b):
        slots = idx[row, : int(count[row])].long()
        if slots.numel() == 0:
            continue
        m_all = l_all = acc_all = None
        for s0 in range(0, slots.numel(), SPLIT):
            blk = slots[s0 : s0 + SPLIT]
            k = k_cache[row][:, blk].to(torch.float32)  # (KVH, n, D)
            v = v_cache[row][:, blk].to(torch.float32)
            s = torch.einsum("hgd,hnd->hgn", q[row].to(torch.float32), k) + mask[row, blk].to(torch.float32)
            m = s.max(dim=-1).values
            p = torch.exp(s - m[..., None])
            l, acc = p.sum(dim=-1), torch.einsum("hgn,hnd->hgd", p, v)
            if m_all is None:
                m_all, l_all, acc_all = m, l, acc
                continue
            mm = torch.maximum(m_all, m)
            a, c = torch.exp(m_all - mm), torch.exp(m - mm)
            m_all, l_all, acc_all = mm, l_all * a + l * c, acc_all * a[..., None] + acc * c[..., None]
        out[row] = acc_all / l_all[..., None]
    return out


def _scratch_for(dev: torch.device, stream: int, n_part: int, n_row: int) -> Dict[str, torch.Tensor]:
    """The (device, stream)'s partials, grown to at least ``n_part`` (m, l)
    entries (their acc rows sized for the largest head dim), and its
    counters, grown to ``n_row`` (new counters start at zero)."""
    buf = _scratch.setdefault((dev.index, stream), {})
    if "part_m" not in buf or buf["part_m"].numel() < n_part:
        buf["part_m"] = torch.empty(n_part, dtype=torch.float32, device=dev)
        buf["part_l"] = torch.empty(n_part, dtype=torch.float32, device=dev)
        buf["part_acc"] = torch.empty(n_part * max(HEAD_DIMS), dtype=torch.float32, device=dev)
    if "counter" not in buf or buf["counter"].numel() < n_row:
        buf["counter"] = torch.zeros(n_row, dtype=torch.int32, device=dev)
    return buf


def flash_decode(q, k_cache, v_cache, mask, slots: Optional[Slots] = None) -> torch.Tensor:
    """Masked decode attention, (B, KVH, G, D) f32. CUDA tensors launch the
    kernel (and, without ``slots`` or with ``slots`` not yet compacted, the
    compaction first); CPU tensors take the plain version."""
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
    if slots is None:
        slots = Slots(mask)
    elif slots.mask.data_ptr() != mask.data_ptr() or slots.mask.shape != mask.shape:
        raise ValueError("flash_decode: slots were built from another mask")
    if slots.idx is None:
        compact(slots)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    nsplit = -(-sm // SPLIT)
    buf = _scratch_for(dev, stream, b * kvh * nsplit * g, b * kvh * head_chunks(g)[0])
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernel_build.load(_SOURCE, _bind).flash_decode(
            q.data_ptr(),
            k_cache.data_ptr(),
            v_cache.data_ptr(),
            mask.data_ptr(),
            slots.idx.data_ptr(),
            slots.count.data_ptr(),
            buf["part_m"].data_ptr(),
            buf["part_l"].data_ptr(),
            buf["part_acc"].data_ptr(),
            buf["counter"].data_ptr(),
            out.data_ptr(),
            b,
            kvh,
            g,
            d,
            sm,
            s,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err}")
    launch_counts["flash_decode"] += 1
    return out
