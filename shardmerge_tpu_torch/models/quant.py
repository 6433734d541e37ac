"""Weight-only int8 / packed int4 quantization (counterpart of
shardmerge_tpu/models/quant.py).

Per-output-channel absmax scales, computed on the host with numpy at load
time. int4 is stored in the SPLIT-HALF layout: for an (N, K) weight the
packed (N, K/2) uint8 byte j holds column j in its low nibble and column
j + K/2 in its high nibble, each as value + 8 in [1, 15]; the scale is an
(N, 1) f32.

``dequant_matmul`` routes a packed-int4 product with at most 64 rows on a
CUDA tensor to the hand-written GEMV (quant_kernels.int4_matmul). Every other
product takes the plain path, which stands for the JAX package's XLA
split-half decomposition: two matmuls over the dequantized halves in
x.dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["quantize", "dequant", "dequant_matmul"]


def _pack4(q: np.ndarray) -> np.ndarray:
    """Split-half nibble pack along axis 1 (int8 in [-7, 7])."""
    if q.shape[1] % 2:
        raise ValueError("int4 requires an even reduction dim")
    h = q.shape[1] // 2
    u = (q + 8).astype(np.uint8)
    return (u[:, :h] | (u[:, h:] << 4)).astype(np.uint8)


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
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    w32 = np.asarray(w, dtype=np.float32)
    absmax = np.max(np.abs(w32), axis=1, keepdims=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = np.maximum(absmax / qmax, 1e-12).astype(np.float32)
    q = np.clip(np.round(w32 / scale), -qmax, qmax).astype(np.int8)
    if bits == 4:
        q = _pack4(q)
    return {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}


def dequant(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    q = wq["q"]
    if q.dtype == torch.uint8:
        q = _unpack4(q)
    return (q.to(torch.float32) * wq["scale"]).to(dtype)


def dequant_matmul(x: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``x @ dequant(W).T`` in x.dtype."""
    q, s = wq["q"], wq["scale"]
    if q.dtype == torch.uint8:
        from .quant_kernels import int4_matmul, supported

        if x.is_cuda and supported(x.shape, q.shape):
            return int4_matmul(x, q, s)
        h = q.shape[1]
        wl = (((q & 0xF).to(torch.int8) - 8) * s).to(x.dtype)
        wh = (((q >> 4).to(torch.int8) - 8) * s).to(x.dtype)
        return x[..., :h] @ wl.T + x[..., h:] @ wh.T
    return x @ dequant(wq, x.dtype).T
