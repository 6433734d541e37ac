"""Weight-only int8 / packed int4 quantization (counterpart of
shardmerge_tpu/models/quant.py).

Per-output-channel absmax scales, computed on the host at load time (the
JAX package's numpy arithmetic in torch's f32 ops, bit for bit). int4 is
stored in the SPLIT-HALF layout: for an (N, K) weight the packed (N, K/2)
uint8 byte j holds column j in its low nibble and column j + K/2 in its
high nibble, each as value + 8 in [1, 15]; the scale is an (N, 1) f32.

The fused expert stacks of GPT-OSS and Llama-4, (E, in, out) used as
``x @ W``, quantize per (expert, output channel) (:func:`quantize_stacked`:
the reduction axis is the middle one, so the int4 bytes pack it split-half
and the dict's key is ``q3``), and GPT-OSS's shipped MXFP4 stacks decode to
f32 (:func:`dequant_mxfp4`).

``dequant_matmul`` routes a packed-int4 product with at most 64 rows on a
CUDA tensor to the hand-written GEMV (quant_kernels.int4_matmul), and one
whose x requires grad (training through a frozen int4 base) to
``quant_kernels.Int4Matmul``, the same kernel with a backward. Every other
product takes the plain path, which stands for the JAX package's XLA
split-half decomposition: two matmuls over the dequantized halves in
x.dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["quantize", "dequant", "dequant_matmul", "quantize_stacked", "dequant_stacked", "dequant_mxfp4",
           "dequant_gptq", "dequant_awq"]


def _pack4(q):
    """Split-half nibble pack along axis 1 (int8 in [-7, 7]; numpy or torch,
    2-D or a 3-D stack)."""
    if q.shape[1] % 2:
        raise ValueError("int4 requires an even reduction dim")
    h = q.shape[1] // 2
    if isinstance(q, np.ndarray):
        u = (q + 8).astype(np.uint8)
        return (u[:, :h] | (u[:, h:] << 4)).astype(np.uint8)
    u = (q + 8).to(torch.uint8)
    return u[:, :h] | (u[:, h:] << 4)


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack4`: int8 values, halves joined on axis 1."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=1)


def quantize(w, bits: int = 4) -> Dict[str, torch.Tensor]:
    """Quantize an (out, in) weight per output channel ON THE HOST.

    Returns CPU tensors {"q": int8 (N, K) or packed uint8 (N, K/2),
    "scale": f32 (N, 1)}; the bit width is carried by the storage dtype."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w32 = torch.as_tensor(w).detach().to("cpu", torch.float32)
    absmax = w32.abs().amax(dim=1, keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = (absmax / qmax).clamp_min_(1e-12)
    q = torch.round(w32 / scale).clamp_(-qmax, qmax).to(torch.int8)
    if bits == 4:
        q = _pack4(q)
    return {"q": q, "scale": scale}


def dequant(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    q = wq["q"]
    if q.dtype == torch.uint8:
        q = _unpack4(q)
    return (q.to(torch.float32) * wq["scale"]).to(dtype)


def quantize_stacked(w, bits: int = 4) -> Dict[str, torch.Tensor]:
    """Quantize an (E, in, out) expert stack per (expert, output channel),
    on the device ``w`` lies on (the loader passes host tensors, and
    GPT-OSS's MXFP4 stacks decoded where they are placed).

    Returns {"q3": int8 (E, in, out) or split-half packed uint8
    (E, in/2, out), "scale": f32 (E, 1, out)}: :func:`quantize`'s
    arithmetic over the middle axis. The divisor qmax is a tensor on the
    stack's device: PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, which rounds some scales one ulp off the host's."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w32 = torch.as_tensor(w).detach().to(torch.float32)
    absmax = w32.abs().amax(dim=1, keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = (absmax / absmax.new_full((), qmax)).clamp_min_(1e-12)
    q = torch.round(w32 / scale).clamp_(-qmax, qmax).to(torch.int8)
    del w32
    if bits == 4:
        q = _pack4(q)
    return {"q3": q, "scale": scale}


def dequant_stacked(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    q = wq["q3"]
    if q.dtype == torch.uint8:  # split-half packed on the middle (reduction) axis
        q = _unpack4(q)
    return (q.to(torch.float32) * wq["scale"]).to(dtype)


# the FP4 e2m1 values by nibble (sign in bit 3), as OpenAI's MXFP4 releases
# decode (transformers' integrations/mxfp4.py FP4_VALUES)
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as f32 for integer e in [-126, 127], built from its exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def dequant_mxfp4(blocks, scales) -> torch.Tensor:
    """Decode MXFP4 expert stacks to f32 on their device.

    ``blocks``: (..., OUT, G, 16) uint8, 32 fp4 values a 16-byte block,
    LOW nibble first; ``scales``: (..., OUT, G) uint8 e8m0 exponents, bias
    127, one a block. Returns (..., IN, OUT), IN = 32 G: the last two axes
    swapped into the bf16 checkpoint's orientation. Each value is
    ``ldexp(fp4, scale - 127)``, taken as two exact power-of-two products
    (each factor within f32's normal range), so the result is the exact
    one, or inf where that overflows, bit for bit numpy's ``ldexp``."""
    blocks, scales = torch.as_tensor(blocks), torch.as_tensor(scales)
    if blocks.shape[:-1] != scales.shape or blocks.shape[-1] != 16:
        raise ValueError(
            f"MXFP4 shape mismatch: blocks {tuple(blocks.shape)} vs scales {tuple(scales.shape)} "
            "(want blocks = scales + (16,))"
        )
    table = torch.tensor(_FP4_VALUES, dtype=torch.float32, device=blocks.device)
    lo = table[(blocks & 0x0F).to(torch.int64)]
    hi = table[(blocks >> 4).to(torch.int64)]
    vals = torch.stack([lo, hi], dim=-1).reshape(*blocks.shape[:-1], 32)  # byte b -> [lo_b, hi_b]
    del lo, hi
    e = scales.to(torch.int32) - 127  # [-127, 128]
    half = torch.div(e, 2, rounding_mode="floor")  # [-64, 64]; e - half in [-63, 64]
    vals = vals * _pow2(half)[..., None]
    vals = vals * _pow2(e - half)[..., None]
    *prefix, out_dim, g, _ = vals.shape
    return vals.reshape(*prefix, out_dim, g * 32).transpose(-1, -2).contiguous()


def dequant_matmul(x: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ dequant(W).T`` in x.dtype."""
    q, s = wq["q"], wq["scale"]
    if q.dtype == torch.uint8:
        from .quant_kernels import Int4Matmul, int4_matmul, supported

        if supported(x.shape, q.shape):
            if x.requires_grad and torch.is_grad_enabled():
                return Int4Matmul.apply(x, q, s)
            if x.is_cuda:
                return int4_matmul(x, q, s)
        h = q.shape[1]
        wl = (((q & 0xF).to(torch.int8) - 8) * s).to(x.dtype)
        wh = (((q >> 4).to(torch.int8) - 8) * s).to(x.dtype)
        return x[..., :h] @ wl.T + x[..., h:] @ wh.T
    return x @ dequant(wq, x.dtype).T


def _fields(words: torch.Tensor, bits: int, order=None) -> torch.Tensor:
    """(rows, cols) int32 words -> (rows, cols * 32/bits) f32 values: field
    k of a word (low bits first) lands at position ``order[k]`` of its run
    (k by default). One shift-and-mask pass per field (an arithmetic shift;
    the mask keeps the field's bits), written straight into f32."""
    per = 32 // bits
    words = words.to(torch.int32)
    out = torch.empty(words.shape + (per,), dtype=torch.float32, device=words.device)
    for k in range(per):
        out[:, :, k if order is None else order[k]] = (words >> (bits * k)) & ((1 << bits) - 1)
    return out.view(words.shape[0], -1)


# AWQ's GEMM kernels store logical column [0,2,4,6,1,3,5,7][k] of each
# 8-value pack in nibble k
_AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _scaled(q: torch.Tensor, zeros: torch.Tensor, scales: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``scales[:, g] * (q - zeros[:, g])`` for f32 q (out, in) and
    per-group zeros and scales (out, groups), in place on q; groups that
    are contiguous runs of ``in`` broadcast instead of gathering."""
    out_dim, in_dim = q.shape
    n_groups = zeros.shape[1]
    w = q
    size = in_dim // n_groups
    if in_dim % n_groups == 0 and torch.equal(g, torch.arange(in_dim, device=g.device) // size):
        v = w.view(out_dim, n_groups, size)
        v.sub_(zeros[:, :, None]).mul_(scales[:, :, None])
    else:
        w.sub_(zeros[:, g]).mul_(scales[:, g])
    return w


def dequant_awq(qweight, qzeros, scales, bits: int = 4) -> torch.Tensor:
    """AutoAWQ GEMM-format parts -> the (out, in) f32 weight, on the host.

    ``qweight`` int32 (in, out/8) and ``qzeros`` int32 (in/group, out/8)
    hold 8 nibbles a word along OUT in AWQ's interleaved order, true zeros;
    ``scales`` fp16 (in/group, out); groups are contiguous runs of input
    rows: ``W[i, o] = scales[i//gs, o] * (q[i, o] - zero[i//gs, o])``."""
    if bits != 4:
        raise ValueError(f"AWQ GEMM packs 4-bit only, got bits={bits}")

    def unpack_t(packed):  # (rows, cols) words -> (8 cols, rows) in logical order
        return _fields(torch.as_tensor(packed), bits, _AWQ_ORDER).T

    q = unpack_t(qweight).contiguous()
    zeros = unpack_t(qzeros)
    in_dim, n_groups = q.shape[1], zeros.shape[1]
    if in_dim % n_groups:
        raise ValueError(f"AWQ group count {n_groups} does not divide in_dim {in_dim}")
    g = torch.arange(in_dim) // (in_dim // n_groups)
    return _scaled(q, zeros, torch.as_tensor(scales).to(torch.float32).T, g)


def dequant_gptq(qweight, qzeros, scales, g_idx, bits: int, v1_zero_offset: bool = True) -> torch.Tensor:
    """AutoGPTQ-format parts -> the (out, in) f32 weight, on the host.

    ``qweight`` int32 (in/per, out) packs per = 32/bits values along IN,
    low bits first; ``qzeros`` int32 (groups, out/per) packs along OUT
    (v1 stores zero - 1, which ``v1_zero_offset`` adds back; gptq_v2 stores
    the true zero); ``scales`` fp16 (groups, out); ``g_idx`` (in,) maps each
    input row to its group (shuffled under act-order):
    ``W[i, o] = scales[g_idx[i], o] * (q[i, o] - zero[g_idx[i], o])``.
    Unpacked straight into the (out, in) layout."""
    if bits not in (4, 8):
        raise ValueError(f"GPTQ bits must be 4 or 8, got {bits}")
    qw = torch.as_tensor(qweight)
    q = _fields(qw.T.contiguous(), bits).reshape(qw.shape[1], -1)  # (out, in)
    qz = torch.as_tensor(qzeros)
    zeros = _fields(qz, bits).reshape(qz.shape[0], -1)  # (groups, out)
    if v1_zero_offset:
        zeros = zeros + 1
    g = torch.as_tensor(g_idx).to(torch.int64)
    return _scaled(q, zeros.T, torch.as_tensor(scales).to(torch.float32).T, g)
