"""The dense decoder families' forward pass in PyTorch (counterpart of
shardmerge_tpu/models/llama.py, dense families only): Llama 2/3, Qwen2,
Qwen3, Mistral, Gemma 1/2/3, Phi-3, OLMo-2, SmolLM3 and GLM-4.

- RMSNorm in f32 (Gemma's zero-centred ``(1 + w)`` form too), RoPE with
  llama3, linear, longrope (Phi-3) or yarn scaling, Gemma-3's dual tables,
  GLM-4's partial interleaved rotary and SmolLM3's NoPE layers; GQA
  attention with an f32 softmax (the einsum path for prefill, on the CPU and
  for the geometries the kernel does not take; the CUDA flash-decode kernel,
  models/attn_kernels.py, for T=1 decode on the card) with q/k/v biases,
  per-head or full-vector q/k norms, Gemma-2's score scale and logit
  softcaps, and sliding windows beside full attention; SwiGLU or GeGLU MLP;
  the post-norm blocks of Gemma-2/3, OLMo-2 and GLM-4; untied or tied
  lm_head;
- weights are bf16 (or f32) tensors, or int8 / packed-int4 dicts
  ``{"q", "scale"}`` whose product dequantizes on the fly (models/quant.py,
  and the CUDA int4 GEMV for decode-sized products on the card);
- one ``forward`` serves chunked prefill and single-token decode against a
  stacked KV cache ``(L, B, KVH, S, D)`` that is updated IN PLACE (the JAX
  version donates the buffer to get the same effect).

The families with experts, latent attention, sinks or chunked attention
(Mixtral, Qwen3-MoE, DeepSeek V2/V3, GPT-OSS, Llama-4) are not ported yet:
their configs raise ``NotImplementedError`` naming the feature.
"""

from __future__ import annotations

import dataclasses
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
    "layer_rope",
    "init_kv_cache",
    "init_params",
    "matmul",
]

# model types whose forward is ported, and those refused by name with the
# feature each needs
FAMILIES = ("llama", "qwen2", "qwen3", "mistral", "gemma", "gemma2", "gemma3_text", "phi3", "olmo2",
            "smollm3", "glm4")
NOT_PORTED = {
    "mixtral": "experts (MoE)",
    "qwen3_moe": "experts (MoE)",
    "deepseek_v2": "latent attention (MLA) and experts",
    "deepseek_v3": "latent attention (MLA) and experts",
    "gpt_oss": "attention sinks and MXFP4 experts",
    "llama4": "chunked attention, L2 q/k norms and experts",
    "llama4_text": "chunked attention, L2 q/k norms and experts",
}
_GELU = ("gelu_pytorch_tanh", "gelu_tanh", "gelu")


@dataclass
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # qwen2 / glm4: q/k/v biases
    model_type: str = "llama"
    # qwen3 / gemma3: per-head RMSNorm on q/k before RoPE
    qk_norm: bool = False
    # olmo2: RMSNorm over the FULL projected q/k, and post-norm residuals
    # with no input_layernorm
    qk_norm_full: bool = False
    head_dim_override: Optional[int] = None
    hidden_act: str = "silu"  # gemma: gelu_pytorch_tanh (GeGLU)
    query_pre_attn_scalar: Optional[float] = None  # gemma2/3 score scale
    attn_logit_softcapping: Optional[float] = None  # gemma2
    final_logit_softcapping: Optional[float] = None  # gemma2
    sliding_window: Optional[int] = None
    # per-layer attention kinds ("sliding_attention" / "full_attention");
    # None falls back to the model_type patterns of layer_is_sliding
    layer_types: Optional[tuple] = None
    # phi3 longrope: the pretraining context (the factors switch there)
    original_max_position_embeddings: Optional[int] = None
    rope_interleave: bool = False  # glm4: (2i, 2i+1) rotary pairs
    partial_rotary_factor: float = 1.0  # glm4: only the first half rotates
    # smollm3: 1 = the layer ropes, 0 = a NoPE layer; None ropes everywhere
    no_rope_layers: Optional[tuple] = None
    # gemma3: sliding layers rope at this base with no scaling
    rope_local_base_freq: Optional[float] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def rope_dims(self) -> int:
        """Head dims the rotary tables cover (glm4: a fraction)."""
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def is_gemma(self) -> bool:
        return self.model_type.startswith("gemma")

    @property
    def is_gemma2(self) -> bool:
        return self.model_type == "gemma2"

    @property
    def is_gemma3(self) -> bool:
        return self.model_type == "gemma3_text"

    @property
    def is_olmo2(self) -> bool:
        return self.model_type == "olmo2"

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """gemma2 windows its even layers, mistral every layer, gemma3 and
        smollm3 the layers their layer_types name."""
        if self.sliding_window is None:
            return False
        if self.layer_types is not None:
            return self.layer_types[layer_idx] == "sliding_attention"
        if self.is_gemma2:
            return layer_idx % 2 == 0
        return self.model_type == "mistral"

    def layer_uses_rope(self, layer_idx: int) -> bool:
        if self.no_rope_layers is None:
            return True
        return bool(self.no_rope_layers[layer_idx])

    @classmethod
    def from_hf_config(cls, config: dict) -> "ModelConfig":
        model_type = config.get("model_type", "llama")
        if model_type in NOT_PORTED:
            raise NotImplementedError(
                f"model_type {model_type!r} needs {NOT_PORTED[model_type]}, not ported yet"
            )
        if model_type == "gemma3" and isinstance(config.get("text_config"), dict):
            # multimodal wrapper (Gemma3ForConditionalGeneration)
            config = config["text_config"]
            model_type = config.get("model_type", "gemma3_text")
        if model_type not in FAMILIES:
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported (dense families: {', '.join(FAMILIES)})"
            )
        experts = config.get("num_local_experts") or config.get("num_experts") or config.get("n_routed_experts")
        if experts or config.get("kv_lora_rank"):
            raise NotImplementedError(f"{model_type} config with experts or latent attention is not ported yet")
        if config.get("mlp_bias"):
            raise NotImplementedError("mlp_bias is not ported")
        hidden_act = config.get("hidden_activation", config.get("hidden_act", "silu"))
        if hidden_act not in ("silu",) + _GELU:
            raise NotImplementedError(f"hidden_act {hidden_act!r} is not ported (silu, gelu tanh)")
        n_layers = config["num_hidden_layers"]
        no_rope = config.get("no_rope_layers")
        layer_types = config.get("layer_types")
        if model_type == "gemma3_text" and layer_types is None:
            # HF's 5-local:1-global default (sliding unless (i+1) % pattern == 0)
            p = config.get("sliding_window_pattern", 6)
            layer_types = ["sliding_attention" if (i + 1) % p else "full_attention" for i in range(n_layers)]
        if model_type == "smollm3":
            # NoPE every no_rope_layer_interval layers; sliding exactly on them
            if no_rope is None:
                interval = config.get("no_rope_layer_interval", 4)
                no_rope = [int((i + 1) % interval != 0) for i in range(n_layers)]
            if layer_types is None:
                sw = config.get("use_sliding_window") and config.get("sliding_window")
                layer_types = [
                    "sliding_attention" if (sw and not no_rope[i]) else "full_attention" for i in range(n_layers)
                ]
        windowed = model_type in ("gemma2", "gemma3_text", "mistral") or (
            model_type == "smollm3" and config.get("use_sliding_window")
        )
        return cls(
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_hidden_layers=n_layers,
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get("num_key_value_heads", config["num_attention_heads"]),
            max_position_embeddings=config.get("max_position_embeddings", 4096),
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=config.get("rope_scaling"),
            # gemma and smollm3 tie by default
            tie_word_embeddings=config.get(
                "tie_word_embeddings", model_type.startswith("gemma") or model_type == "smollm3"
            ),
            attention_bias=config.get("attention_bias", model_type in ("qwen2", "glm4")),
            model_type=model_type,
            qk_norm=model_type == "qwen3" or model_type == "gemma3_text",
            qk_norm_full=model_type == "olmo2",
            head_dim_override=config.get("head_dim"),
            hidden_act=hidden_act,
            query_pre_attn_scalar=config.get("query_pre_attn_scalar"),
            attn_logit_softcapping=config.get("attn_logit_softcapping"),
            final_logit_softcapping=config.get("final_logit_softcapping"),
            sliding_window=config.get("sliding_window") if windowed else None,
            layer_types=tuple(layer_types) if layer_types else None,
            original_max_position_embeddings=config.get("original_max_position_embeddings"),
            rope_interleave=model_type == "glm4",
            partial_rotary_factor=config.get("partial_rotary_factor", 0.5 if model_type == "glm4" else 1.0),
            no_rope_layers=tuple(no_rope) if no_rope is not None else None,
            rope_local_base_freq=(
                config.get("rope_local_base_freq", 10000.0) if model_type == "gemma3_text" else None
            ),
        )

    @classmethod
    def from_pretrained(cls, model_path) -> "ModelConfig":
        return cls.from_hf_config(json.loads((Path(model_path) / "config.json").read_text()))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x.dtype; ``plus_one``: Gemma's
    zero-centred weights multiply by (1 + w)."""
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    w32 = weight.to(torch.float32)
    if plus_one:
        w32 = 1.0 + w32
    return (normed * w32).to(x.dtype)


def _rope_inv_freq(cfg: ModelConfig, seq_len: int = 0) -> Tuple[np.ndarray, float]:
    """Rotary inverse frequencies and the cos/sin post-scale, with the
    configured scaling (llama3, linear, longrope, yarn); other scaling types
    raise instead of silently mis-roping. Longrope picks its long factors
    when ``seq_len`` (the table's length) exceeds the pretraining context."""
    head_dim = cfg.rope_dims
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    scaling = cfg.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type"))
    if rope_type == "longrope":
        original = cfg.original_max_position_embeddings or cfg.max_position_embeddings
        factor = scaling.get("factor")
        if cfg.original_max_position_embeddings:
            factor = cfg.max_position_embeddings / original
        attention_factor = scaling.get("attention_factor")
        if attention_factor is None:
            attention_factor = (
                1.0 if (factor or 1.0) <= 1.0 else float(np.sqrt(1 + np.log(factor) / np.log(original)))
            )
        ext = np.asarray(
            scaling["long_factor"] if seq_len > original else scaling["short_factor"], dtype=np.float64
        )
        return (inv_freq / ext).astype(np.float32), float(attention_factor)
    if rope_type == "yarn":
        factor = scaling["factor"]
        attention_factor = scaling.get("attention_factor")
        mscale = scaling.get("mscale")
        mscale_all_dim = scaling.get("mscale_all_dim")
        original = scaling.get("original_max_position_embeddings") or cfg.max_position_embeddings

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * np.log(scale) + 1.0

        if attention_factor is None:
            if mscale and mscale_all_dim:
                attention_factor = float(get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim))
            else:
                attention_factor = float(get_mscale(factor))
        beta_fast = scaling.get("beta_fast") or 32
        beta_slow = scaling.get("beta_slow") or 1

        def correction_dim(n_rot):
            return head_dim * np.log(original / (n_rot * 2 * np.pi)) / (2 * np.log(cfg.rope_theta))

        low, high = correction_dim(beta_fast), correction_dim(beta_slow)
        if scaling.get("truncate", True):
            low, high = np.floor(low), np.ceil(high)
        low = max(low, 0)
        high = min(high, head_dim - 1)
        if low == high:
            high = high + 0.001  # transformers' singularity guard
        ramp = np.clip((np.arange(head_dim // 2, dtype=np.float64) - low) / (high - low), 0, 1)
        extrapolation = 1 - ramp
        inv_freq = (inv_freq / factor) * (1 - extrapolation) + inv_freq * extrapolation
        return inv_freq.astype(np.float32), float(attention_factor)
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
            f"rope_scaling type {rope_type!r} is not supported (llama3, linear, longrope, yarn)"
        )
    return inv_freq.astype(np.float32), 1.0


def rope_tables(cfg: ModelConfig, max_len: int, device=None) -> Tuple[torch.Tensor, ...]:
    """(cos, sin) f32 tables of shape (max_len, rope_dims), or Gemma-3's
    dual (cos_g, sin_g, cos_l, sin_l): sliding layers rope at
    rope_local_base_freq with no scaling (:func:`layer_rope` picks)."""
    inv_freq, attention_factor = _rope_inv_freq(cfg, seq_len=max_len)
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    tables = (
        torch.from_numpy(np.cos(emb) * attention_factor).to(device),
        torch.from_numpy(np.sin(emb) * attention_factor).to(device),
    )
    if cfg.rope_local_base_freq is None:
        return tables
    local = dataclasses.replace(cfg, rope_theta=cfg.rope_local_base_freq, rope_scaling=None,
                                rope_local_base_freq=None)
    return tables + rope_tables(local, max_len, device)


def layer_rope(cfg: ModelConfig, rope, layer_idx: int):
    """A layer's (cos, sin): Gemma-3's sliding layers take the local pair."""
    if len(rope) == 4:
        return (rope[2], rope[3]) if cfg.layer_is_sliding(layer_idx) else (rope[0], rope[1])
    return rope


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


def _uninterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., d) interleaved (even, odd) pairs -> [evens | odds]: q and k
    move alike, so the scores equal the interleaved rotation's."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(*x.shape[:-1], d)


def apply_rope_cfg(cfg: ModelConfig, q, k, cos, sin, positions):
    """RoPE over the first rope_dims of each head (glm4: half), in the
    interleaved pair layout where the config has it."""
    d = cos.shape[-1]
    if d == q.shape[-1] and not cfg.rope_interleave:
        return apply_rope(q, k, cos, sin, positions)
    q_rot, q_pass = q[..., :d], q[..., d:]
    k_rot, k_pass = k[..., :d], k[..., d:]
    if cfg.rope_interleave:
        q_rot, k_rot = _uninterleave(q_rot), _uninterleave(k_rot)
    q_rot, k_rot = apply_rope(q_rot, k_rot, cos, sin, positions)
    return torch.cat([q_rot, q_pass], dim=-1), torch.cat([k_rot, k_pass], dim=-1)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ W.T`` in x.dtype; ``w`` is an (out, in) tensor or a quantized
    ``{"q", "scale"}`` dict."""
    if isinstance(w, dict):
        return dequant_matmul(x, w)
    return x @ w.T


def _act(g32: torch.Tensor, hidden_act: str) -> torch.Tensor:
    """The gate activation in f32: tanh GeGLU for the gelu family, else SiLU."""
    if hidden_act in _GELU:
        return torch.nn.functional.gelu(g32, approximate="tanh")
    return torch.nn.functional.silu(g32)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def layer_keys(cfg: ModelConfig) -> set:
    """The leaves every layer of ``cfg``'s params holds."""
    keys = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
            "post_attention_layernorm"}
    if not cfg.is_olmo2:
        keys.add("input_layernorm")
    if cfg.attention_bias:
        keys |= {"q_bias", "k_bias", "v_bias"}
    if cfg.qk_norm or cfg.qk_norm_full:
        keys |= {"q_norm", "k_norm"}
    if cfg.is_olmo2:
        keys.add("post_feedforward_layernorm")
    if cfg.is_gemma2 or cfg.is_gemma3 or cfg.model_type == "glm4":
        keys |= {"pre_feedforward_layernorm", "post_feedforward_layernorm"}
    return keys


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    """Random params with ``cfg``'s leaves (the JAX ``init_params`` layout):
    matrices and biases N(0, 0.02) from a seeded generator on ``device``,
    norms ones (zeros for Gemma's (1 + w) form)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, q_dim, kv_dim = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def norm(n):
        return (torch.zeros if cfg.is_gemma else torch.ones)(n, dtype=dtype, device=device)

    shapes = {
        "q_proj": (q_dim, h), "k_proj": (kv_dim, h), "v_proj": (kv_dim, h), "o_proj": (h, q_dim),
        "gate_proj": (cfg.intermediate_size, h), "up_proj": (cfg.intermediate_size, h),
        "down_proj": (h, cfg.intermediate_size), "q_bias": (q_dim,), "k_bias": (kv_dim,), "v_bias": (kv_dim,),
        "q_norm": (q_dim if cfg.qk_norm_full else cfg.head_dim,),
        "k_norm": (kv_dim if cfg.qk_norm_full else cfg.head_dim,),
    }
    params = {"embed_tokens": dense(cfg.vocab_size, h), "norm": norm(h), "layers": []}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.vocab_size, h)
    for _ in range(cfg.num_hidden_layers):
        layer = {}
        for key in sorted(layer_keys(cfg)):
            if key.endswith("layernorm"):
                layer[key] = norm(h)
            elif key.endswith("_norm"):
                layer[key] = norm(shapes[key][0])
            else:
                layer[key] = dense(*shapes[key])
        params["layers"].append(layer)
    return params


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
    def __init__(self, cfg: ModelConfig, layer: dict, use_rope: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_rope = use_rope
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Projection(layer[name]))
        for name in ("q_bias", "k_bias", "v_bias", "q_norm", "k_norm"):
            self.register_buffer(name, layer.get(name))

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.q_bias is not None:
            q, k, v = q + self.q_bias, k + self.k_bias, v + self.v_bias
        if cfg.qk_norm_full:  # olmo2: the FULL vectors, before the head split
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        q = q.reshape(B, T, H, D).transpose(1, 2)
        k = k.reshape(B, T, KVH, D).transpose(1, 2)
        v = v.reshape(B, T, KVH, D).transpose(1, 2)
        if self.q_norm is not None and not cfg.qk_norm_full:
            # qwen3 / gemma3 (its zero-centred weights: the (1 + w) form)
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps, cfg.is_gemma)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps, cfg.is_gemma)
        if self.use_rope:  # smollm3's NoPE layers skip rotary
            q, k = apply_rope_cfg(cfg, q, k, cos, sin, positions)

        k_buf, v_buf = kv_cache["k"], kv_cache["v"]
        k_buf[layer_idx, :, :, cache_pos : cache_pos + T] = k.to(k_buf.dtype)
        v_buf[layer_idx, :, :, cache_pos : cache_pos + T] = v.to(v_buf.dtype)
        k_cache, v_cache = k_buf[layer_idx], v_buf[layer_idx]

        group = H // KVH
        qg = q.reshape(B, KVH, group, T, D)
        scale = float(np.sqrt(np.float32(cfg.query_pre_attn_scalar or D)))
        if attn_kernels.use_flash_decode(cfg, T, q):
            # decode: the kernel reads the bf16 cache once; same additive
            # mask, same f32 softmax semantics as the einsum path below; the
            # step's slot list of this layer's mask kind is compacted once
            # and shared by every layer of that kind
            qs = qg[:, :, :, 0, :].to(torch.float32) / scale
            ctx = attn_kernels.flash_decode(qs, k_cache, v_cache, mask[:, 0, :], slots=slots)
            return self.o_proj(ctx.reshape(B, T, H * D).to(x.dtype))
        # the mask covers the first attn_len slots; the rest are masked
        sm = mask.shape[-1]
        scores = torch.einsum(
            "bkgtd,bksd->bkgts", qg.to(torch.float32), k_cache[:, :, :sm].to(torch.float32)
        ) / scale
        if cfg.attn_logit_softcapping:
            cap = float(np.float32(cfg.attn_logit_softcapping))
            scores = cap * torch.tanh(scores / cap)
        scores = scores + mask[:, None, None, :, :]  # mask: (B, T, attn_len)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bksd->bkgtd", probs, v_cache[:, :, :sm].to(torch.float32))
        out = out.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
        return self.o_proj(out.to(x.dtype))


class MLP(nn.Module):
    def __init__(self, layer: dict, hidden_act: str = "silu"):
        super().__init__()
        self.hidden_act = hidden_act
        for name in ("gate_proj", "up_proj", "down_proj"):
            setattr(self, name, Projection(layer[name]))

    def forward(self, x):
        act = _act(self.gate_proj(x).to(torch.float32), self.hidden_act)
        return self.down_proj(act.to(x.dtype) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: dict, layer_idx: int):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.olmo2 = cfg.is_olmo2
        self.po = cfg.is_gemma  # (1 + w) norms
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            self.register_buffer(name, layer.get(name))
        self.self_attn = Attention(cfg, layer, cfg.layer_uses_rope(layer_idx))
        self.mlp = MLP(layer, cfg.hidden_act)

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        eps, po = self.eps, self.po
        # olmo2 has no input norm: attention reads the raw residual
        h = x if self.olmo2 else rms_norm(x, self.input_layernorm, eps, po)
        attn = self.self_attn(h, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots)
        if self.olmo2:  # post-norm residuals, no pre-FFN norm
            x = x + rms_norm(attn, self.post_attention_layernorm, eps)
            return x + rms_norm(self.mlp(x), self.post_feedforward_layernorm, eps)
        if self.pre_feedforward_layernorm is not None:  # gemma2/3, glm4 sandwich norms
            x = x + rms_norm(attn, self.post_attention_layernorm, eps, po)
            h = rms_norm(x, self.pre_feedforward_layernorm, eps, po)
            return x + rms_norm(self.mlp(h), self.post_feedforward_layernorm, eps, po)
        x = x + attn
        h = rms_norm(x, self.post_attention_layernorm, eps, po)
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
        self.layers = nn.ModuleList(DecoderLayer(cfg, layer, i) for i, layer in enumerate(params["layers"]))
        head = params.get("lm_head")
        self.lm_head = Projection(head if head is not None else params["embed_tokens"])
        self.sliding = [cfg.layer_is_sliding(i) for i in range(len(self.layers))]

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
        rope: Tuple[torch.Tensor, ...],
        attn_len: int,  # valid cache slots after this call
        mask_positions: Optional[torch.Tensor] = None,  # (B, T) cache slots
        token_valid: Optional[torch.Tensor] = None,  # (B, S) bool
        key_positions: Optional[torch.Tensor] = None,  # (B, S) true positions
    ):
        """One forward (prefill when T > 1, decode when T == 1).

        ``mask_positions`` carries each query's cache slot (its causal
        horizon) when it differs from its RoPE position (left-padded
        batches); ``token_valid`` masks pad slots out of attention.
        ``key_positions`` (the continuous pool's slot -> position map) makes
        the sliding window compare true positions across a row's join gap;
        without it the window compares slots, which left pads shift alike on
        both sides. The additive masks cover only the first ``attn_len``
        slots (every later slot is masked), so a row's attention does not
        depend on the cache length: a request prefilled into a short
        admission cache gets the bits of the same prefill into a longer
        one. A decode step builds one slot list per mask kind (full,
        sliding), each compacted at its first use.
        Returns (f32 logits (B, T, V), kv_cache), the cache updated in
        place."""
        cfg = self.cfg
        x = self.embed_tokens[input_ids]
        if cfg.is_gemma:
            # sqrt(hidden), rounded to the activations' dtype first
            x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype, device=x.device)
        slot = torch.arange(attn_len, device=x.device)[None, None, :]
        mpos = positions if mask_positions is None else mask_positions
        valid = slot <= mpos[:, :, None]
        if token_valid is not None:
            valid = valid & token_valid[:, None, :attn_len]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        masked = torch.full((), -1e9, dtype=torch.float32, device=x.device)
        mask = torch.where(valid, zero, masked)
        mask_sliding = None
        if cfg.sliding_window is not None:
            if key_positions is None:
                recent = slot > mpos[:, :, None] - cfg.sliding_window
            else:
                recent = key_positions[:, None, :attn_len] > positions[:, :, None] - cfg.sliding_window
            mask_sliding = torch.where(valid & recent, zero, masked)
        decode = input_ids.shape[1] == 1
        slots = attn_kernels.Slots(mask[:, 0, :]) if decode else None
        slots_sliding = attn_kernels.Slots(mask_sliding[:, 0, :]) if decode and mask_sliding is not None else None
        for i, layer in enumerate(self.layers):
            cos, sin = layer_rope(cfg, rope, i)
            if self.sliding[i]:
                x = layer(x, cos, sin, positions, kv_cache, i, cache_pos, mask_sliding, slots_sliding)
            else:
                x = layer(x, cos, sin, positions, kv_cache, i, cache_pos, mask, slots)
        x = rms_norm(x, self.norm, cfg.rms_norm_eps, cfg.is_gemma)
        logits = self.lm_head(x).to(torch.float32)
        if cfg.final_logit_softcapping:
            cap = float(np.float32(cfg.final_logit_softcapping))
            logits = cap * torch.tanh(logits / cap)
        return logits, kv_cache
