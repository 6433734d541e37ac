"""Llama-family forward pass in PyTorch (counterpart of
shardmerge_tpu/models/llama.py, Llama family only).

- RMSNorm in f32, RoPE with llama3 (or linear) scaling, GQA attention with
  an f32 softmax (the einsum path for prefill and on the CPU; the CUDA
  flash-decode kernel, models/attn_kernels.py, for T=1 decode on the card),
  SwiGLU MLP, untied or tied lm_head;
- weights are bf16 (or f32) tensors, or int8 / packed-int4 dicts
  ``{"q", "scale"}`` whose product dequantizes on the fly (models/quant.py,
  and the CUDA int4 GEMV for decode-sized products on the card);
- one ``forward`` serves chunked prefill and single-token decode against a
  stacked KV cache ``(L, B, KVH, S, D)`` that is updated IN PLACE (the JAX
  version donates the buffer to get the same effect).

Other families (MoE, MLA, sinks, softcaps, sliding windows) are not ported
yet; their configs raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import attn_kernels
from .quant import dequant_matmul

__all__ = [
    "ModelConfig",
    "LlamaModel",
    "rms_norm",
    "rope_tables",
    "init_kv_cache",
    "matmul",
]


@dataclass
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    model_type: str = "llama"
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, config: dict) -> "ModelConfig":
        model_type = config.get("model_type", "llama")
        if model_type != "llama":
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported yet (llama only)"
            )
        unported = [
            k
            for k in ("num_local_experts", "sliding_window", "attn_logit_softcapping")
            if config.get(k)
        ]
        if config.get("attention_bias") or config.get("mlp_bias"):
            unported.append("attention_bias/mlp_bias")
        if config.get("hidden_act", "silu") != "silu":
            unported.append(f"hidden_act={config['hidden_act']}")
        if unported:
            raise NotImplementedError(f"llama config features not ported yet: {unported}")
        return cls(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_hidden_layers=config["num_hidden_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get(
                "num_key_value_heads", config["num_attention_heads"]
            ),
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            model_type=model_type,
            head_dim_override=config.get("head_dim"),
        )

    @classmethod
    def from_pretrained(cls, model_path) -> "ModelConfig":
        return cls.from_hf_config(json.loads((Path(model_path) / "config.json").read_text()))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x.dtype."""
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def _rope_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Rotary inverse frequencies with the configured scaling (llama3 or
    linear); other scaling types raise instead of silently mis-roping."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    scaling = cfg.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type"))
    if rope_type == "llama3":
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        original = scaling["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv_freq
        low_wavelen = original / low
        high_wavelen = original / high
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (original / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_medium, smoothed, scaled)
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling["factor"]
    elif rope_type not in (None, "default"):
        raise NotImplementedError(
            f"rope_scaling type {rope_type!r} is not ported yet (llama3, linear)"
        )
    return inv_freq.astype(np.float32)


def rope_tables(cfg: ModelConfig, max_len: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 tables of shape (max_len, head_dim)."""
    inv_freq = _rope_inv_freq(cfg)
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (
        torch.from_numpy(np.cos(emb)).to(device),
        torch.from_numpy(np.sin(emb)).to(device),
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin, positions):
    """q, k: (B, H, T, D); positions: (B, T); rotation in f32."""
    cos_p = cos[positions][:, None]
    sin_p = sin[positions][:, None]
    q_out = q * cos_p + _rotate_half(q) * sin_p
    k_out = k * cos_p + _rotate_half(k) * sin_p
    return q_out.to(q.dtype), k_out.to(k.dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ W.T`` in x.dtype; ``w`` is an (out, in) tensor or a quantized
    ``{"q", "scale"}`` dict."""
    if isinstance(w, dict):
        return dequant_matmul(x, w)
    return x @ w.T


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Projection(nn.Module):
    """A bias-free linear map holding a dense (out, in) weight or a
    quantized ``{"q", "scale"}`` pair as buffers."""

    def __init__(self, w):
        super().__init__()
        if isinstance(w, dict):
            self.register_buffer("q", w["q"])
            self.register_buffer("scale", w["scale"])
            self.weight = None
        else:
            self.register_buffer("weight", w)
            self.q = self.scale = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            return matmul(x, {"q": self.q, "scale": self.scale})
        return matmul(x, self.weight)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: dict):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Projection(layer[name]))

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, T, H, D).transpose(1, 2)
        k = self.k_proj(x).reshape(B, T, KVH, D).transpose(1, 2)
        v = self.v_proj(x).reshape(B, T, KVH, D).transpose(1, 2)
        q, k = apply_rope(q, k, cos, sin, positions)

        k_buf, v_buf = kv_cache["k"], kv_cache["v"]
        k_buf[layer_idx, :, :, cache_pos : cache_pos + T] = k.to(k_buf.dtype)
        v_buf[layer_idx, :, :, cache_pos : cache_pos + T] = v.to(v_buf.dtype)
        k_cache, v_cache = k_buf[layer_idx], v_buf[layer_idx]

        group = H // KVH
        qg = q.reshape(B, KVH, group, T, D)
        scale = float(np.sqrt(np.float32(D)))
        if attn_kernels.use_flash_decode(cfg, T, q):
            # decode: the kernel reads the bf16 cache once; same additive
            # mask, same f32 softmax semantics as the einsum path below; the
            # step's slot list is compacted once and shared by every layer
            qs = qg[:, :, :, 0, :].to(torch.float32) / scale
            ctx = attn_kernels.flash_decode(qs, k_cache, v_cache, mask[:, 0, :], slots=slots)
            return self.o_proj(ctx.reshape(B, T, H * D).to(x.dtype))
        # the mask covers the first attn_len slots; the rest are masked
        sm = mask.shape[-1]
        scores = torch.einsum(
            "bkgtd,bksd->bkgts", qg.to(torch.float32), k_cache[:, :, :sm].to(torch.float32)
        ) / scale
        scores = scores + mask[:, None, None, :, :]  # mask: (B, T, attn_len)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bksd->bkgtd", probs, v_cache[:, :, :sm].to(torch.float32))
        out = out.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
        return self.o_proj(out.to(x.dtype))


class MLP(nn.Module):
    def __init__(self, layer: dict):
        super().__init__()
        for name in ("gate_proj", "up_proj", "down_proj"):
            setattr(self, name, Projection(layer[name]))

    def forward(self, x):
        act = torch.nn.functional.silu(self.gate_proj(x).to(torch.float32))
        return self.down_proj(act.to(x.dtype) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: dict):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.register_buffer("input_layernorm", layer["input_layernorm"])
        self.register_buffer("post_attention_layernorm", layer["post_attention_layernorm"])
        self.self_attn = Attention(cfg, layer)
        self.mlp = MLP(layer)

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        h = rms_norm(x, self.input_layernorm, self.eps)
        x = x + self.self_attn(h, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots)
        h = rms_norm(x, self.post_attention_layernorm, self.eps)
        return x + self.mlp(h)


class LlamaModel(nn.Module):
    """Embedding, decoder stack, final norm and lm_head over a params dict
    ``{"embed_tokens", "norm", "lm_head"?, "layers": [dict, ...]}`` (the
    JAX param pytree's layout; see models/loader.py and models/convert.py)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("embed_tokens", params["embed_tokens"])
        self.register_buffer("norm", params["norm"])
        self.layers = nn.ModuleList(DecoderLayer(cfg, layer) for layer in params["layers"])
        head = params.get("lm_head")
        self.lm_head = Projection(head if head is not None else params["embed_tokens"])

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, T)
        positions: torch.Tensor,  # (B, T) RoPE positions
        kv_cache: Dict[str, torch.Tensor],
        cache_pos: int,  # first cache slot this call writes
        rope: Tuple[torch.Tensor, torch.Tensor],
        attn_len: int,  # valid cache slots after this call
        mask_positions: Optional[torch.Tensor] = None,  # (B, T) cache slots
        token_valid: Optional[torch.Tensor] = None,  # (B, S) bool
        key_positions: Optional[torch.Tensor] = None,  # (B, S) true positions
    ):
        """One forward (prefill when T > 1, decode when T == 1).

        ``mask_positions`` carries each query's cache slot (its causal
        horizon) when it differs from its RoPE position (left-padded
        batches); ``token_valid`` masks pad slots out of attention.
        ``key_positions`` (the continuous pool's slot -> position map) is
        accepted for the windowed families, which compare positions across a
        row's join gap; the Llama family has no window and does not read it.
        The additive mask covers only the first ``attn_len`` slots (every
        later slot is masked), so a row's attention does not depend on the
        cache length: a request prefilled into a short admission cache gets
        the bits of the same prefill into a longer one.
        Returns (f32 logits (B, T, V), kv_cache), the cache updated in
        place."""
        del key_positions
        x = self.embed_tokens[input_ids]
        slot = torch.arange(attn_len, device=x.device)[None, None, :]
        mpos = positions if mask_positions is None else mask_positions
        valid = slot <= mpos[:, :, None]
        if token_valid is not None:
            valid = valid & token_valid[:, None, :attn_len]
        mask = torch.where(
            valid,
            torch.zeros((), dtype=torch.float32, device=x.device),
            torch.full((), -1e9, dtype=torch.float32, device=x.device),
        )
        cos, sin = rope
        slots = attn_kernels.Slots(mask[:, 0, :]) if input_ids.shape[1] == 1 else None
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, positions, kv_cache, i, cache_pos, mask, slots)
        x = rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        logits = self.lm_head(x).to(torch.float32)
        return logits, kv_cache
