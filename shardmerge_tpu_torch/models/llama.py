"""The decoder families' forward pass in PyTorch (counterpart of
shardmerge_tpu/models/llama.py): Llama 2/3, Qwen2, Qwen3, Mistral, Gemma
1/2/3, Phi-3, OLMo-2, SmolLM3 and GLM-4, the expert and latent-attention
families Mixtral, Qwen3-MoE and DeepSeek V2/V3, GPT-OSS and Llama-4.

- RMSNorm in f32 (Gemma's zero-centred ``(1 + w)`` form too), RoPE with
  llama3, linear, longrope (Phi-3) or yarn scaling, Gemma-3's dual tables,
  GLM-4's partial interleaved rotary and SmolLM3's NoPE layers; GQA
  attention with an f32 softmax (the einsum path for prefill, on the CPU and
  for the geometries the kernel does not take; the CUDA flash-decode kernel,
  models/attn_kernels.py, for T=1 decode on the card) with q/k/v biases,
  per-head or full-vector q/k norms, Gemma-2's score scale and logit
  softcaps, GPT-OSS's attention sinks and o_proj bias, sliding windows and
  Llama-4's chunk-aligned windows beside full attention, Llama-4's
  weightless L2 q/k norm (rope layers) and query temperature (NoPE
  layers); SwiGLU or GeGLU MLP;
  the post-norm blocks of Gemma-2/3, OLMo-2 and GLM-4; untied or tied
  lm_head;
- experts (:class:`MoE`): Mixtral / Qwen3-MoE softmax top-k routing and
  DeepSeek's (V2 greedy and group-limited, V3 ``noaux_tc``) with shared
  experts and dense first layers, every expert computed and masked
  (dense-and-mask, the JAX route of quantized experts); top-k breaks exact ties toward the lower index, as ``jax.lax.top_k`` does;
  or, with ``moe_dispatch="capacity"`` and raw experts stacked (W1, W3, W2)
  (``stack_expert_weights``, ``LlamaModel.stack_experts``), the capacity
  dispatch: each expert's tokens gathered into a block of C slots in the
  token-major order of the top-k table, the overflow dropped;
- the fused expert stacks ``(E, in, out)``: GPT-OSS's (:class:`GptOssMoE`:
  a biased top-k-then-softmax router, interleaved gate/up columns, the
  clamped SwiGLU, biases) and Llama-4's (:class:`Llama4MoE`: sigmoid of the
  selected logits scaling each expert's input, contiguous gate/up halves,
  f32 experts, a shared expert), raw or int8 / packed-int4 ``{"q3",
  "scale"}`` stacks dequantized at use (models/quant.dequant_stacked);
- DeepSeek's multi-head latent attention (:class:`LatentAttention`) over a
  compressed cache ``{"ckv": (L, B, S, kv_lora_rank), "kpe": (L, B, S,
  qk_rope_head_dim)}`` with ``kv_b_proj`` absorbed into the einsums (on the
  card too: it is not a flash-decode shape);
- weights are bf16 (or f32) tensors, or int8 / packed-int4 dicts
  ``{"q", "scale"}`` whose product dequantizes on the fly (models/quant.py,
  and the CUDA int4 GEMV for decode-sized products on the card);
- one ``forward`` serves chunked prefill and single-token decode against a
  stacked KV cache ``(L, B, KVH, S, D)`` (or the compressed one) that is
  updated IN PLACE (the JAX version donates the buffer to get the same
  effect);
- tensor parallelism (``LlamaModel(..., tp=TPGroup)``, parallel/tp.py): the
  params are one rank's slices (parallel/train.py) and the modules run the
  collectives GSPMD inserts in the JAX package: split attention (its heads,
  its KV heads in the cache) and MLP / expert blocks end in one all-reduce,
  with GPT-OSS's o_proj bias and the replicated shared experts added once,
  after it; the vocab-parallel embedding is a masked local lookup and an
  all-reduce; the vocab-parallel logits are gathered to the full vocab
  before the final softcap;
- training (``forward_train``, ``block_train``, ``embed_matrix``): the
  same math as functions of the params dict, cache-free (S = T; MLA over its
  own latents), differentiable through every leaf that requires grad, with
  per-block recompute (``remat``) and the tensor-parallel f/g operators of
  parallel/train.py, and two hooks of ``block_train``: ``attend`` (context
  parallelism's ring, parallel/ring.py) and ``ffn`` (expert parallelism's
  dispatch, parallel/moe.py); the serving modules stay inference-only. GPT-OSS's
  o_proj bias is added as serving adds it (the JAX ``block_train`` leaves
  it out).
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
from .quant import dequant, dequant_matmul, dequant_stacked

__all__ = [
    "ModelConfig",
    "LlamaModel",
    "rms_norm",
    "rope_tables",
    "layer_rope",
    "init_kv_cache",
    "init_params",
    "matmul",
    "layer_keys",
    "topk",
    "deepseek_topk",
    "gptoss_router_scores",
    "gptoss_expert_math",
    "llama4_router_scores",
    "route_experts",
    "capacity_of",
    "capacity_tables_from_topk",
    "capacity_tables",
    "capacity_experts_apply",
    "routed_capacity",
    "experts_quantized",
    "expert_stacks",
    "stack_expert_weights",
    "l2_qk",
    "nope_temp_q",
    "embed_matrix",
    "block_train",
    "train_masks",
    "embed_train",
    "blocks_train",
    "head_train",
    "forward_train",
]

# model types whose forward is ported (llama4 and gemma3 as multimodal
# wrappers around their text_config too)
FAMILIES = ("llama", "qwen2", "qwen3", "mistral", "gemma", "gemma2", "gemma3_text", "phi3", "olmo2",
            "smollm3", "glm4", "mixtral", "qwen3_moe", "deepseek_v2", "deepseek_v3", "gpt_oss", "llama4_text")
_WRAPPERS = {"llama4": "llama4_text", "gemma3": "gemma3_text"}
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
    # experts (Mixtral / Qwen3-MoE / DeepSeek): 0 experts is a dense MLP;
    # Qwen3-MoE's and DeepSeek's experts are narrower than the dense width
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    # expert dispatch: "dense" runs every expert on every token and masks
    # (exact); "capacity" gathers each expert's tokens into blocks of
    # C = min(ceil(S k / n_exp * moe_capacity_factor), S) slots
    # (:func:`capacity_tables`), dropping what overflows: the serving route
    # of raw experts that an engine stacks (inference.py)
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    # DeepSeek multi-head latent attention, on when kv_lora_rank is set
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None
    # DeepSeek MoE: dense first layers, always-on shared experts, routed
    # weight scaling, group-limited selection; "greedy" /
    # "group_limited_greedy" (V2, softmax) or "noaux_tc" (V3, sigmoid with
    # the selection bias)
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    topk_method: str = "greedy"
    # llama4: interleaved dense / MoE layers (the MoE layers' indices),
    # chunk-aligned windows on the rope layers, temperature-scaled queries
    # on the NoPE layers, a weightless L2 q/k norm after rope; its dense
    # layers' MLP width (intermediate_size is the experts' and the shared
    # expert's)
    moe_layers: Optional[tuple] = None
    attention_chunk_size: Optional[int] = None
    attn_temperature_tuning: bool = False
    floor_scale: float = 8192.0
    attn_scale: float = 0.1
    qk_norm_l2: bool = False
    intermediate_size_mlp: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def rope_dims(self) -> int:
        """Head dims the rotary tables cover (MLA: the shared qk_rope part;
        glm4: a fraction)."""
        if self.is_mla:
            return self.qk_rope_head_dim
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def mla_softmax_scale(self) -> float:
        """MLA score scale: qk_head_dim^-0.5, times mscale^2 under V3's yarn
        with mscale_all_dim (HF's deepseek_v2 applies no mscale: so here)."""
        scale = self.qk_head_dim**-0.5
        if self.model_type == "deepseek_v3" and self.rope_scaling:
            mscale_all_dim = self.rope_scaling.get("mscale_all_dim", 0)
            factor = self.rope_scaling.get("factor", 1.0)
            if mscale_all_dim and factor > 1:
                mscale = 0.1 * mscale_all_dim * float(np.log(factor)) + 1.0
                scale = scale * mscale * mscale
        return scale

    @property
    def has_sinks(self) -> bool:
        """GPT-OSS: every layer carries a per-head sink logit (``sinks``,
        which :func:`layer_keys` requires)."""
        return self.model_type == "gpt_oss"

    def layer_is_moe(self, layer_idx: int) -> bool:
        """The JAX per-layer MoE table: Llama-4's explicit ``moe_layers``,
        else every layer follows num_local_experts (DeepSeek's dense first
        layers are :meth:`layer_has_experts`'s rule)."""
        if self.moe_layers is None:
            return self.num_local_experts > 0
        return layer_idx in self.moe_layers

    def layer_has_experts(self, layer_idx: int) -> bool:
        """Experts in this layer's params: MoE layers past DeepSeek's
        first_k_dense_replace dense ones (the JAX ``init_params`` rule)."""
        return self.layer_is_moe(layer_idx) and layer_idx >= self.first_k_dense_replace

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

    def layer_is_chunked(self, layer_idx: int) -> bool:
        """Llama-4's rope layers attend within attention_chunk_size-aligned
        chunks ("chunked_attention" in layer_types); NoPE layers globally."""
        return bool(
            self.attention_chunk_size
            and self.layer_types is not None
            and self.layer_types[layer_idx] == "chunked_attention"
        )

    @classmethod
    def from_hf_config(cls, config: dict) -> "ModelConfig":
        model_type = config.get("model_type", "llama")
        if model_type in _WRAPPERS and isinstance(config.get("text_config"), dict):
            # multimodal wrappers (Llama4ForConditionalGeneration,
            # Gemma3ForConditionalGeneration): the decoder's geometry sits
            # in text_config
            config = config["text_config"]
            model_type = config.get("model_type", _WRAPPERS[model_type])
        if model_type not in FAMILIES:
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported (families: {', '.join(FAMILIES)})"
            )
        if config.get("mlp_bias"):
            raise NotImplementedError("mlp_bias is not ported")
        hidden_act = config.get("hidden_activation", config.get("hidden_act", "silu"))
        if hidden_act not in ("silu",) + _GELU:
            raise NotImplementedError(f"hidden_act {hidden_act!r} is not ported (silu, gelu tanh)")
        n_layers = config["num_hidden_layers"]
        no_rope = config.get("no_rope_layers")
        layer_types = config.get("layer_types")
        moe_layers = config.get("moe_layers")
        if model_type == "llama4_text":
            # HF's derived tables where config.json omits them: NoPE every
            # no_rope_layer_interval-th layer, MoE every
            # interleave_moe_layer_step-th, chunked attention exactly on the
            # rope layers
            if not no_rope:
                interval = config.get("no_rope_layer_interval", 4)
                no_rope = [int((i + 1) % interval != 0) for i in range(n_layers)]
            if moe_layers is None:
                step = config.get("interleave_moe_layer_step", 1)
                moe_layers = list(range(step - 1, n_layers, step))
            if layer_types is None:
                layer_types = ["chunked_attention" if uses_rope else "full_attention" for uses_rope in no_rope]
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
        llama4 = model_type == "llama4_text"
        windowed = model_type in ("gemma2", "gemma3_text", "mistral", "gpt_oss") or (
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
            qk_norm=model_type.startswith("qwen3") or model_type == "gemma3_text",
            qk_norm_full=model_type == "olmo2",
            head_dim_override=config.get("head_dim"),
            hidden_act=hidden_act,
            query_pre_attn_scalar=config.get("query_pre_attn_scalar"),
            attn_logit_softcapping=config.get("attn_logit_softcapping"),
            final_logit_softcapping=config.get("final_logit_softcapping"),
            sliding_window=config.get("sliding_window") if windowed else None,
            layer_types=tuple(layer_types) if layer_types else None,
            original_max_position_embeddings=config.get("original_max_position_embeddings"),
            # deepseek_v2 always ropes interleaved pairs, deepseek_v3 unless
            # its config says otherwise
            rope_interleave=model_type in ("glm4", "deepseek_v2", "llama4_text")
            or (model_type == "deepseek_v3" and config.get("rope_interleave", True)),
            partial_rotary_factor=config.get("partial_rotary_factor", 0.5 if model_type == "glm4" else 1.0),
            no_rope_layers=tuple(no_rope) if no_rope is not None else None,
            rope_local_base_freq=(
                config.get("rope_local_base_freq", 10000.0) if model_type == "gemma3_text" else None
            ),
            # Mixtral names the expert count num_local_experts, Qwen3-MoE
            # num_experts, DeepSeek n_routed_experts
            num_local_experts=config.get(
                "num_local_experts", config.get("num_experts", config.get("n_routed_experts", 0))
            ) or 0,
            num_experts_per_tok=config.get("num_experts_per_tok", 2),
            moe_intermediate_size=config.get("moe_intermediate_size"),
            norm_topk_prob=config.get("norm_topk_prob", True),
            q_lora_rank=config.get("q_lora_rank"),
            kv_lora_rank=config.get("kv_lora_rank"),
            qk_nope_head_dim=config.get("qk_nope_head_dim", 0),
            qk_rope_head_dim=config.get("qk_rope_head_dim", 0),
            v_head_dim=config.get("v_head_dim"),
            n_shared_experts=config.get("n_shared_experts") or 0,
            first_k_dense_replace=config.get("first_k_dense_replace", 0),
            routed_scaling_factor=config.get("routed_scaling_factor", 1.0),
            n_group=config.get("n_group"),
            topk_group=config.get("topk_group"),
            topk_method="noaux_tc" if model_type == "deepseek_v3" else config.get("topk_method", "greedy"),
            moe_layers=tuple(moe_layers) if llama4 and moe_layers is not None else None,
            attention_chunk_size=config.get("attention_chunk_size", 8192) if llama4 else None,
            attn_temperature_tuning=llama4 and bool(config.get("attn_temperature_tuning", True)),
            floor_scale=float(config.get("floor_scale", 8192)),
            attn_scale=float(config.get("attn_scale", 0.1)),
            qk_norm_l2=llama4 and bool(config.get("use_qk_norm", True)),
            intermediate_size_mlp=config.get("intermediate_size_mlp") if llama4 else None,
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


def _l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMS normalization in f32, returned in x.dtype (HF's
    Llama4TextL2Norm)."""
    x32 = x.to(torch.float32)
    return (x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def l2_qk(cfg: ModelConfig, q, k):
    """Llama-4's weightless L2 q/k norm, applied after rope on the rope
    layers only (a permutation-invariant norm: the un-interleaved rope
    layout does not change it)."""
    if not cfg.qk_norm_l2:
        return q, k
    return _l2_norm(q, cfg.rms_norm_eps), _l2_norm(k, cfg.rms_norm_eps)


def nope_temp_q(cfg: ModelConfig, q: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Llama-4's NoPE layers scale the queries (B, H, T, D) by
    ``log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1`` in f32."""
    if not cfg.attn_temperature_tuning:
        return q
    scales = torch.log1p(torch.floor((positions.to(torch.float32) + 1.0) / cfg.floor_scale))
    scales = scales * float(np.float32(cfg.attn_scale)) + 1.0
    return (q.to(torch.float32) * scales[:, None, :, None]).to(q.dtype)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ W.T`` in x.dtype; ``w`` is an (out, in) tensor (taken in x's
    dtype: a QLoRA-merged bf16 weight under f32 activations) or a quantized
    ``{"q", "scale"}`` dict."""
    if isinstance(w, dict):
        return dequant_matmul(x, w)
    return x @ (w if w.dtype == x.dtype else w.to(x.dtype)).T


def _act(g32: torch.Tensor, hidden_act: str) -> torch.Tensor:
    """The gate activation in f32: tanh GeGLU for the gelu family, else SiLU."""
    if hidden_act in _GELU:
        return torch.nn.functional.gelu(g32, approximate="tanh")
    return torch.nn.functional.silu(g32)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None, kv_heads: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """The stacked cache: ``k``/``v`` (L, B, KVH, S, D), or MLA's compressed
    latent ``ckv`` (L, B, S, kv_lora_rank) and shared roped key ``kpe``
    (L, B, S, qk_rope_head_dim). ``kv_heads``: a tensor-parallel rank's
    KV heads (default KVH)."""
    L = cfg.num_hidden_layers
    if cfg.is_mla:
        return {
            "ckv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            "kpe": torch.zeros((L, batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        }
    shape = (L, batch, kv_heads or cfg.num_key_value_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


# the per-layer leaves that go through a quantized product when loaded with
# int8/int4 (kv_b_proj is dequantized at use by the absorbed MLA einsums);
# an expert's w1/w3/w2 are quantized alike
QUANTIZABLE = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj", "q_a_proj",
               "q_b_proj", "kv_a_proj", "kv_b_proj", "shared_gate_proj", "shared_up_proj", "shared_down_proj"}


# the keys of the fused expert stacks' dicts
STACK_KEYS = {"gptoss_experts": {"gate_up", "gate_up_bias", "down", "down_bias"},
              "llama4_experts": {"gate_up", "down"}}


def layer_keys(cfg: ModelConfig, layer_idx: int = 0) -> set:
    """The leaves layer ``layer_idx`` of ``cfg``'s params holds (``experts``
    is a list of ``{"w1", "w3", "w2"}`` dicts; ``gptoss_experts`` and
    ``llama4_experts`` dicts of :data:`STACK_KEYS`)."""
    if cfg.is_mla:
        keys = {"kv_a_proj", "kv_a_layernorm", "kv_b_proj", "o_proj", "input_layernorm",
                "post_attention_layernorm"}
        keys |= {"q_a_proj", "q_a_layernorm", "q_b_proj"} if cfg.q_lora_rank else {"q_proj"}
    else:
        keys = {"q_proj", "k_proj", "v_proj", "o_proj", "post_attention_layernorm"}
        if not cfg.is_olmo2:
            keys.add("input_layernorm")
    if cfg.model_type == "gpt_oss":
        keys |= {"sinks", "moe_gate", "moe_gate_bias", "gptoss_experts"}
        if cfg.attention_bias:
            keys.add("o_bias")
    elif cfg.model_type == "llama4_text" and cfg.layer_is_moe(layer_idx):
        keys |= {"moe_gate", "llama4_experts", "shared_gate_proj", "shared_up_proj", "shared_down_proj"}
    elif cfg.layer_has_experts(layer_idx):
        keys |= {"moe_gate", "experts"}
        if cfg.topk_method == "noaux_tc":
            keys.add("gate_bias")
        if cfg.n_shared_experts:
            keys |= {"shared_gate_proj", "shared_up_proj", "shared_down_proj"}
    else:
        keys |= {"gate_proj", "up_proj", "down_proj"}
    if cfg.attention_bias:
        keys |= {"q_bias", "k_bias", "v_bias"}
    if cfg.qk_norm or cfg.qk_norm_full:
        keys |= {"q_norm", "k_norm"}
    if cfg.is_olmo2:
        keys.add("post_feedforward_layernorm")
    if cfg.is_gemma2 or cfg.is_gemma3 or cfg.model_type == "glm4":
        keys |= {"pre_feedforward_layernorm", "post_feedforward_layernorm"}
    return keys


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None, project=None,
                project_stacked=None) -> dict:
    """Random params with ``cfg``'s leaves (the JAX ``init_params`` layout;
    Llama-4's, which that init does not build, in the loader's): matrices,
    biases and GPT-OSS's sinks N(0, 0.02) from a seeded generator on
    ``device``, norms ones (zeros for Gemma's (1 + w) form), V3's
    selection bias f32 zeros. ``project(w)``, when given, replaces
    each per-layer projection and expert matrix as soon as it is drawn (a
    quantizer: a model whose bf16 experts would not fit never holds them
    all); ``project_stacked(w)`` each fused (E, in, out) expert stack."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, q_dim, kv_dim = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    H = cfg.num_attention_heads
    n_exp, moe_inter = cfg.num_local_experts, cfg.moe_intermediate_size or cfg.intermediate_size
    shared, inter = moe_inter * cfg.n_shared_experts, cfg.intermediate_size
    if cfg.model_type == "llama4_text":
        # one shared expert of the experts' width; the dense layers' MLP is the wider one
        shared, inter = cfg.intermediate_size, cfg.intermediate_size_mlp or cfg.intermediate_size

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def matrix(*shape):
        w = dense(*shape)
        return w if project is None else project(w)

    def norm(n):
        return (torch.zeros if cfg.is_gemma else torch.ones)(n, dtype=dtype, device=device)

    def stack(*shape):
        w = dense(*shape)
        return w if project_stacked is None else project_stacked(w)

    shapes = {
        "q_proj": (H * cfg.qk_head_dim if cfg.is_mla else q_dim, h), "k_proj": (kv_dim, h),
        "v_proj": (kv_dim, h), "o_proj": (h, H * cfg.v_head_dim if cfg.is_mla else q_dim),
        "gate_proj": (inter, h), "up_proj": (inter, h),
        "down_proj": (h, inter), "q_bias": (q_dim,), "k_bias": (kv_dim,), "v_bias": (kv_dim,),
        "q_norm": (q_dim if cfg.qk_norm_full else cfg.head_dim,),
        "k_norm": (kv_dim if cfg.qk_norm_full else cfg.head_dim,),
        "q_a_proj": (cfg.q_lora_rank, h), "q_a_layernorm": (cfg.q_lora_rank,),
        "q_b_proj": (H * cfg.qk_head_dim, cfg.q_lora_rank),
        "kv_a_proj": ((cfg.kv_lora_rank or 0) + cfg.qk_rope_head_dim, h), "kv_a_layernorm": (cfg.kv_lora_rank,),
        "kv_b_proj": (H * (cfg.qk_nope_head_dim + (cfg.v_head_dim or 0)), cfg.kv_lora_rank),
        "moe_gate": (n_exp, h), "shared_gate_proj": (shared, h), "shared_up_proj": (shared, h),
        "shared_down_proj": (h, shared), "sinks": (H,), "moe_gate_bias": (n_exp,), "o_bias": (h,),
    }
    params = {"embed_tokens": dense(cfg.vocab_size, h), "norm": norm(h), "layers": []}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.vocab_size, h)
    for i in range(cfg.num_hidden_layers):
        layer = {}
        for key in sorted(layer_keys(cfg, i)):
            if key == "experts":
                layer[key] = [{"w1": matrix(moe_inter, h), "w3": matrix(moe_inter, h), "w2": matrix(h, moe_inter)}
                              for _ in range(cfg.num_local_experts)]
            elif key == "gptoss_experts":
                layer[key] = {"gate_up": stack(n_exp, h, 2 * moe_inter), "gate_up_bias": dense(n_exp, 2 * moe_inter),
                              "down": stack(n_exp, moe_inter, h), "down_bias": dense(n_exp, h)}
            elif key == "llama4_experts":
                layer[key] = {"gate_up": stack(n_exp, h, 2 * moe_inter), "down": stack(n_exp, moe_inter, h)}
            elif key == "gate_bias":
                layer[key] = torch.zeros(cfg.num_local_experts, dtype=torch.float32, device=device)
            elif key in ("q_a_layernorm", "kv_a_layernorm"):
                layer[key] = torch.ones(shapes[key], dtype=dtype, device=device)
            elif key.endswith("layernorm"):
                layer[key] = norm(h)
            elif key.endswith("_norm"):
                layer[key] = norm(shapes[key][0])
            elif key in QUANTIZABLE:
                layer[key] = matrix(*shapes[key])
            else:
                layer[key] = dense(*shapes[key])
        params["layers"].append(layer)
    return params


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, exact ties
    toward the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none): a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _dense_weights(idx: torch.Tensor, w: torch.Tensor, n_exp: int) -> torch.Tensor:
    """Per-expert weights (..., n_exp) f32 from top-k (idx, w): zero off
    the chosen experts (the JAX one-hot einsum, exact)."""
    out = torch.zeros(idx.shape[:-1] + (n_exp,), dtype=torch.float32, device=idx.device)
    return out.scatter_(-1, idx, w.to(torch.float32))


def deepseek_topk(cfg: ModelConfig, gate_w, gate_bias, x):
    """DeepSeek expert routing -> (topk_idx, topk_w), each (..., k).

    V3 (``noaux_tc``): sigmoid scores; selection adds
    e_score_correction_bias, a group's score is the sum of its top-2
    biased scores, the top ``topk_group`` groups survive and the biased
    scores outside them are set to 0.0 (not -inf: a negative biased score
    ranks below a masked one) before the top-k; the weights are the
    UNBIASED scores, normalized over the top-k (+ 1e-20) when
    norm_topk_prob, then scaled by routed_scaling_factor.
    V2 (``greedy`` / ``group_limited_greedy``): softmax scores, a group's
    score its max; the weights are the (masked) scores themselves scaled by
    routed_scaling_factor, never normalized (HF's V2 skips norm_topk_prob).
    """
    n_exp, k = cfg.num_local_experts, cfg.num_experts_per_tok
    v3 = cfg.topk_method == "noaux_tc"
    logits = torch.einsum("...e,ne->...n", x.to(torch.float32), gate_w.to(torch.float32))
    scores = torch.sigmoid(logits) if v3 else torch.softmax(logits, dim=-1)
    choice = scores + gate_bias.to(torch.float32) if v3 else scores
    if cfg.topk_method in ("noaux_tc", "group_limited_greedy") and cfg.n_group:
        G = cfg.n_group
        grouped = choice.reshape(*choice.shape[:-1], G, n_exp // G)
        if v3:
            group_scores = topk(grouped, min(2, n_exp // G))[0].sum(dim=-1)
        else:
            group_scores = grouped.amax(dim=-1)
        group_idx = topk(group_scores, cfg.topk_group)[1]
        keep = torch.zeros(group_scores.shape, dtype=torch.bool, device=x.device).scatter_(-1, group_idx, True)
        keep = keep.repeat_interleave(n_exp // G, dim=-1)
        choice = torch.where(keep, choice, torch.zeros((), dtype=choice.dtype, device=x.device))
    topk_choice, topk_idx = topk(choice, k)
    if v3:
        topk_w = torch.gather(scores, -1, topk_idx)
        if cfg.norm_topk_prob:
            topk_w = topk_w / (topk_w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        topk_w = topk_choice
    return topk_idx, topk_w * float(np.float32(cfg.routed_scaling_factor))


def gptoss_router_scores(cfg: ModelConfig, gate_w, gate_b, x) -> torch.Tensor:
    """GPT-OSS's dense router scores (..., n_exp) f32: the biased f32
    logits, the top-k of the RAW logits, a softmax over those k values,
    zero elsewhere."""
    logits = torch.einsum("...e,ne->...n", x.to(torch.float32), gate_w.to(torch.float32))
    top_v, top_i = topk(logits + gate_b.to(torch.float32), cfg.num_experts_per_tok)
    return _dense_weights(top_i, torch.softmax(top_v, dim=-1), cfg.num_local_experts)


def gptoss_expert_math(x, gate_up_w, gate_up_bias, down_w, down_bias, scores) -> torch.Tensor:
    """GPT-OSS's fused experts, every one on every token, in x.dtype:
    ``gate_up`` (E, hidden, 2I) with INTERLEAVED gate/up columns plus its
    bias, gate clamped to <= 7 and up to [-7, 7], ``glu = g sigmoid(1.702
    g)`` in f32 cast back, ``(up + 1) glu @ down + down_bias``; the
    score-weighted sum over experts in f32. Returns f32 (B, T, hidden)."""
    B, T, D = x.shape
    n_exp = gate_up_w.shape[0]
    # (E, B*T, 2I): one batched product over the experts, x broadcast
    gu = torch.matmul(x.reshape(1, B * T, D), gate_up_w).permute(1, 0, 2).reshape(B, T, n_exp, -1) + gate_up_bias
    gate = gu[..., ::2].clamp(max=7.0)
    up = gu[..., 1::2].clamp(-7.0, 7.0)
    g32 = gate.to(torch.float32)
    glu = (g32 * torch.sigmoid(g32 * 1.702)).to(gu.dtype)
    h = ((up + 1.0) * glu).reshape(B * T, n_exp, -1).permute(1, 0, 2)  # (E, B*T, I)
    out = torch.matmul(h, down_w).permute(1, 0, 2).reshape(B, T, n_exp, D) + down_bias
    return (out.to(torch.float32) * scores[..., None]).sum(dim=2)


def llama4_router_scores(cfg: ModelConfig, gate_w, xf) -> torch.Tensor:
    """Llama-4's router on f32 tokens (N, hidden): the f32 logits' top-k,
    the SIGMOID of the selected logits, zero elsewhere -> (N, n_exp)."""
    logits = xf @ gate_w.to(torch.float32).T
    _, top_i = topk(logits, cfg.num_experts_per_tok)
    sel = torch.zeros_like(logits).scatter_(-1, top_i, 1.0)
    return torch.sigmoid(logits) * sel


def route_experts(cfg: ModelConfig, gate_w, gate_bias, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(topk_idx, topk_w) of tokens ``x`` (..., hidden) for an expert list:
    :func:`deepseek_topk`, or Mixtral / Qwen3-MoE's router (the product in
    x.dtype, an f32 softmax, the top-k renormalized when norm_topk_prob)."""
    if cfg.model_type.startswith("deepseek"):
        return deepseek_topk(cfg, gate_w, gate_bias, x)
    probs = torch.softmax(matmul(x, gate_w).to(torch.float32), dim=-1)
    w, idx = topk(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return idx, w


def capacity_of(cfg: ModelConfig, tokens: int, capacity_factor: Optional[float]) -> int:
    """An expert's slots for ``tokens`` routed tokens: ``min(ceil(S k /
    n_exp * capacity_factor), S)``; None is every token (nothing dropped)."""
    if capacity_factor is None:
        return tokens
    k, n_exp = cfg.num_experts_per_tok, cfg.num_local_experts
    return min(int(np.ceil(tokens * k / n_exp * capacity_factor)), tokens)


def capacity_tables_from_topk(topk_idx: torch.Tensor, topk_probs: torch.Tensor, n_exp: int, capacity: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch tables from (S, k) top-k choices: ``gather_idx`` (n_exp, C)
    int64, the token of each expert slot (S, a zero row, where the slot is
    empty), and ``w_slot`` (n_exp, C) f32, its routing weight. An
    assignment's slot is its rank among its expert's assignments in the
    token-major order of the (S, k) table (a cumulative count); those past
    the capacity land in a trash column that is cut off: dropped."""
    S, k = topk_idx.shape
    dev = topk_idx.device
    expert_ids = topk_idx.reshape(-1).to(torch.int64)
    token_ids = torch.arange(S, device=dev).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(expert_ids, n_exp)
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    slot = pos.clamp(max=capacity)
    gather_idx = torch.full((n_exp, capacity + 1), S, dtype=torch.int64, device=dev)
    gather_idx = gather_idx.index_put((expert_ids, slot), token_ids)
    w_slot = torch.zeros((n_exp, capacity + 1), dtype=torch.float32, device=dev)
    w_slot = w_slot.index_put((expert_ids, slot), topk_probs.reshape(-1).to(torch.float32))
    return gather_idx[:, :capacity], w_slot[:, :capacity]


def capacity_tables(router_probs: torch.Tensor, k: int, capacity: int, norm_topk: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`capacity_tables_from_topk` of (S, n_exp) router probabilities:
    their top-k (ties to the lower index), renormalized when ``norm_topk``."""
    n_exp = router_probs.shape[1]
    w, idx = topk(router_probs, k)
    if norm_topk:
        w = w / w.sum(dim=-1, keepdim=True)
    return capacity_tables_from_topk(idx, w, n_exp, capacity)


def capacity_experts_apply(xf: torch.Tensor, gather_idx: torch.Tensor, w_slot: torch.Tensor, W1, W3, W2,
                           hidden_act: str) -> torch.Tensor:
    """Gather the tokens ``xf`` (S, hidden) into expert blocks (n, C,
    hidden), run the stacked SwiGLU (W1, W3 (n, I, hidden), W2 (n, hidden,
    I); a local slice of the experts with the tables' rows to match), and
    add each slot's output times its weight back to its token. Returns f32
    (S, hidden)."""
    S, E = xf.shape
    xe = torch.cat([xf, xf.new_zeros((1, E))])[gather_idx]  # row S: the empty slot's zeros
    gate = torch.matmul(xe, W1.to(xe.dtype).transpose(1, 2))
    up = torch.matmul(xe, W3.to(xe.dtype).transpose(1, 2))
    h = _act(gate.to(torch.float32), hidden_act).to(xe.dtype) * up
    ye = torch.matmul(h, W2.to(xe.dtype).transpose(1, 2))
    contrib = ye.to(torch.float32) * w_slot[..., None]
    out = torch.zeros((S + 1, E), dtype=torch.float32, device=xf.device)
    return out.index_add(0, gather_idx.reshape(-1), contrib.reshape(-1, E))[:S]


def experts_quantized(experts) -> bool:
    """True when an expert list's weights are int8 / int4 ``{"q", "scale"}``
    dicts: the capacity dispatch needs raw matrices."""
    return isinstance(experts[0]["w1"], dict)


def expert_stacks(layer) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A layer's (W1, W3, W2) stacks: ``experts_stacked``, or its expert
    list stacked."""
    if "experts_stacked" in layer:
        return tuple(layer["experts_stacked"])
    return tuple(torch.stack([e[w] for e in layer["experts"]]) for w in ("w1", "w3", "w2"))


def routed_capacity(cfg: ModelConfig, idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor, stacks,
                    capacity_factor: Optional[float], xe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The capacity dispatch of tokens ``x`` (B, T, hidden) routed by top-k
    (idx, w) (B, T, k) over the (W1, W3, W2) ``stacks``: f32 (B, T,
    hidden). ``xe``: the tokens the experts read, when they differ from x
    (a tensor-parallel rank's entered copy)."""
    B, T, E = x.shape
    C = capacity_of(cfg, B * T, capacity_factor)
    tables = capacity_tables_from_topk(idx.reshape(B * T, -1), w.reshape(B * T, -1), cfg.num_local_experts, C)
    out = capacity_experts_apply((x if xe is None else xe).reshape(B * T, E), *tables, *stacks, cfg.hidden_act)
    return out.reshape(B, T, E)


def _moe_capacity(cfg: ModelConfig, layer, x: torch.Tensor, capacity_factor: float = 1.25) -> torch.Tensor:
    """The capacity dispatch of Mixtral / Qwen3-MoE experts (JAX's
    ``_moe_capacity``): the router's top-k (:func:`capacity_tables`' own),
    the stacked experts over the gathered blocks. x.dtype out."""
    idx, w = route_experts(cfg, layer["moe_gate"], None, x)
    return routed_capacity(cfg, idx, w, x, expert_stacks(layer), capacity_factor).to(x.dtype)


def _moe_deepseek_capacity(cfg: ModelConfig, layer, x: torch.Tensor, capacity_factor: float) -> torch.Tensor:
    """DeepSeek's experts by capacity dispatch (JAX's
    ``_moe_deepseek_capacity``): :func:`deepseek_topk` into the tables,
    plus the shared experts. x.dtype out."""
    idx, w = deepseek_topk(cfg, layer["moe_gate"], layer.get("gate_bias"), x)
    out = routed_capacity(cfg, idx, w, x, expert_stacks(layer), capacity_factor)
    if "shared_gate_proj" in layer:
        out = out + _mlp_fn(layer, x, cfg.hidden_act, "shared_").to(torch.float32)
    return out.to(x.dtype)


def stack_expert_weights(params: dict) -> bool:
    """Replace every layer's ``experts`` list by ``experts_stacked`` = (W1,
    W3, W2), (n_exp, ., .) each, once (JAX's ``stack_expert_weights``).
    Returns False, changing nothing, when the params have no expert list
    or quantized experts (the capacity dispatch needs raw matrices)."""
    layers = params.get("layers", [])
    if not any("experts" in layer for layer in layers):
        return False
    if any("experts" in layer and experts_quantized(layer["experts"]) for layer in layers):
        return False
    for layer in layers:
        if "experts" in layer:
            layer["experts_stacked"] = expert_stacks(layer)
            del layer["experts"]
    return True


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

    def dense(self, dtype: torch.dtype) -> torch.Tensor:
        """The (out, in) weight in ``dtype``, dequantized when quantized."""
        if self.weight is None:
            return dequant({"q": self.q, "scale": self.scale}, dtype)
        return self.weight.to(dtype)


class Stack(nn.Module):
    """A fused (E, in, out) expert stack: a dense tensor or a quantized
    ``{"q3", "scale"}`` pair (models/quant.quantize_stacked) as buffers."""

    def __init__(self, w):
        super().__init__()
        if isinstance(w, dict):
            self.register_buffer("q3", w["q3"])
            self.register_buffer("scale", w["scale"])
            self.weight = None
        else:
            self.register_buffer("weight", w)
            self.q3 = self.scale = None

    def dense(self, dtype: torch.dtype) -> torch.Tensor:
        """The stack in ``dtype``, dequantized when quantized."""
        if self.weight is None:
            return dequant_stacked({"q3": self.q3, "scale": self.scale}, dtype)
        return self.weight.to(dtype)


class Attention(nn.Module):
    """GQA attention; with ``tp`` and a head-parallel layer plan ``lp`` over
    the rank's query heads [h0, h1) and KV heads [k0, k1) (its slices of the
    projections and of the cache), replicated per-head leaves (sinks,
    OLMo-2's full-vector norms) cut to them at build, and one all-reduce
    after o_proj."""

    def __init__(self, cfg: ModelConfig, layer: dict, use_rope: bool = True, tp=None, lp=None):
        super().__init__()
        self.cfg = cfg
        self.use_rope = use_rope
        self.tp = tp if lp is not None and lp.heads is not None else None
        H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        (h0, h1), (k0, k1) = (lp.heads, lp.kv_heads) if self.tp is not None else ((0, H), (0, KVH))
        self.n_heads, self.n_kv = h1 - h0, k1 - k0
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Projection(layer[name]))
        for name in ("q_bias", "k_bias", "v_bias", "o_bias"):
            self.register_buffer(name, layer.get(name))
        sinks, q_norm, k_norm = layer.get("sinks"), layer.get("q_norm"), layer.get("k_norm")
        if self.tp is not None:
            sinks = None if sinks is None else sinks[h0:h1]
            if cfg.qk_norm_full:
                q_norm, k_norm = q_norm[h0 * D:h1 * D], k_norm[k0 * D:k1 * D]
        self.register_buffer("sinks", sinks)
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("k_norm", k_norm)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """o_proj (summed over the ranks), plus GPT-OSS's o_proj bias."""
        out = self.o_proj(out)
        if self.tp is not None:
            out = self.tp.all_reduce(out)
        return out if self.o_bias is None else out + self.o_bias

    def _full_norm(self, x: torch.Tensor, weight: torch.Tensor, n: int) -> torch.Tensor:
        """OLMo-2's RMSNorm over the FULL projected vector of ``n`` entries,
        of which this rank holds a slice: the sum of squares is all-reduced."""
        x32 = x.to(torch.float32)
        ss = self.tp.all_reduce((x32 * x32).sum(dim=-1, keepdim=True))
        return (x32 * torch.rsqrt(ss / n + self.cfg.rms_norm_eps) * weight.to(torch.float32)).to(x.dtype)

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KVH, D = self.n_heads, self.n_kv, cfg.head_dim
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if self.q_bias is not None:
            q, k, v = q + self.q_bias, k + self.k_bias, v + self.v_bias
        if cfg.qk_norm_full and self.tp is not None:  # the full vectors span the ranks
            q = self._full_norm(q, self.q_norm, cfg.num_attention_heads * D)
            k = self._full_norm(k, self.k_norm, cfg.num_key_value_heads * D)
        elif cfg.qk_norm_full:  # olmo2: the FULL vectors, before the head split
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps)
        q = q.reshape(B, T, H, D).transpose(1, 2)
        k = k.reshape(B, T, KVH, D).transpose(1, 2)
        v = v.reshape(B, T, KVH, D).transpose(1, 2)
        if self.q_norm is not None and not cfg.qk_norm_full:
            # qwen3 / gemma3 (its zero-centred weights: the (1 + w) form)
            q = rms_norm(q, self.q_norm, cfg.rms_norm_eps, cfg.is_gemma)
            k = rms_norm(k, self.k_norm, cfg.rms_norm_eps, cfg.is_gemma)
        if self.use_rope:  # smollm3's and llama4's NoPE layers skip rotary
            q, k = apply_rope_cfg(cfg, q, k, cos, sin, positions)
            q, k = l2_qk(cfg, q, k)
        else:
            q = nope_temp_q(cfg, q, positions)

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
            return self._out(ctx.reshape(B, T, H * D).to(x.dtype))
        # the mask covers the first attn_len slots; the rest are masked
        sm = mask.shape[-1]
        scores = torch.einsum(
            "bkgtd,bksd->bkgts", qg.to(torch.float32), k_cache[:, :, :sm].to(torch.float32)
        ) / scale
        if cfg.attn_logit_softcapping:
            cap = float(np.float32(cfg.attn_logit_softcapping))
            scores = cap * torch.tanh(scores / cap)
        scores = scores + mask[:, None, None, :, :]  # mask: (B, T, attn_len)
        if self.sinks is not None:
            # GPT-OSS: each head's sink logit joins the softmax's
            # normalization and its probability is dropped, without
            # materializing the extra column
            sinks = self.sinks.to(torch.float32).reshape(1, KVH, group, 1, 1)
            mx = torch.maximum(scores.amax(dim=-1, keepdim=True), sinks)
            e = torch.exp(scores - mx)
            probs = e / (e.sum(dim=-1, keepdim=True) + torch.exp(sinks - mx))
        else:
            probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bksd->bkgtd", probs, v_cache[:, :, :sm].to(torch.float32))
        out = out.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
        return self._out(out.to(x.dtype))


class LatentAttention(nn.Module):
    """DeepSeek multi-head latent attention over the compressed cache: q
    (through the q_lora bottleneck when the config has one) splits into a
    per-head no-position part and a roped part; the cache keeps the
    normalized kv_lora_rank latent and the roped key shared by the heads;
    ``kv_b_proj`` (dequantized to f32 at use) is absorbed into the query and
    output sides, scores = (W_k^T q_nope)^T c + q_pe k_pe, out = (probs c)
    W_v. The einsum path on every device: a T=1 call on the card counts
    under ``attn_kernels.launch_counts["decode_einsum"]``."""

    def __init__(self, cfg: ModelConfig, layer: dict, tp=None, lp=None):
        super().__init__()
        self.cfg = cfg
        # head-parallel: the rank's heads [h0, h1) over the replicated latent
        # cache (q_proj and o_proj are its slices; q_b_proj and kv_b_proj
        # replicate and are cut to the heads at use), one all-reduce after o_proj
        self.tp = tp if lp is not None and lp.heads is not None else None
        self.h0, self.h1 = lp.heads if self.tp is not None else (0, cfg.num_attention_heads)
        for name in ("q_proj", "q_a_proj", "q_b_proj", "kv_a_proj", "kv_b_proj", "o_proj"):
            setattr(self, name, Projection(layer[name]) if name in layer else None)
        for name in ("q_a_layernorm", "kv_a_layernorm"):
            self.register_buffer(name, layer.get(name))

    def forward(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        cfg = self.cfg
        B, T, _ = x.shape
        h0, h1 = self.h0, self.h1
        H, dn, dr, dc, dv = (h1 - h0, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim)
        if self.q_proj is not None:  # no q_lora_rank (V2-Lite)
            q = self.q_proj(x)
        else:
            q = self.q_b_proj(rms_norm(self.q_a_proj(x), self.q_a_layernorm, cfg.rms_norm_eps))
            q = q.reshape(B, T, -1, dn + dr)[:, :, h0:h1]
        q = q.reshape(B, T, H, dn + dr).transpose(1, 2)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        ckv = self.kv_a_proj(x)  # (B, T, dc + dr)
        c = rms_norm(ckv[..., :dc], self.kv_a_layernorm, cfg.rms_norm_eps)
        q_pe, k_pe = apply_rope_cfg(cfg, q_pe, ckv[..., dc:][:, None], cos, sin, positions)

        c_buf, pe_buf = kv_cache["ckv"], kv_cache["kpe"]
        c_buf[layer_idx, :, cache_pos : cache_pos + T] = c.to(c_buf.dtype)
        pe_buf[layer_idx, :, cache_pos : cache_pos + T] = k_pe[:, 0].to(pe_buf.dtype)
        sm = mask.shape[-1]  # the mask covers the first attn_len slots
        c_keys = c_buf[layer_idx, :, :sm].to(torch.float32)
        pe_keys = pe_buf[layer_idx, :, :sm].to(torch.float32)
        if T == 1 and x.is_cuda:
            attn_kernels.launch_counts["decode_einsum"] += 1

        wkb = self.kv_b_proj.dense(torch.float32).reshape(-1, dn + dv, dc)[h0:h1]
        q_abs = torch.einsum("bhtd,hdc->bhtc", q_nope.to(torch.float32), wkb[:, :dn])
        scores = torch.einsum("bhtc,bsc->bhts", q_abs, c_keys) + torch.einsum(
            "bhtd,bsd->bhts", q_pe.to(torch.float32), pe_keys
        )
        scores = scores * float(np.float32(cfg.mla_softmax_scale)) + mask[:, None]
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhts,bsc->bhtc", probs, c_keys)
        out = torch.einsum("bhtc,hvc->bhtv", ctx, wkb[:, dn:])
        out = out.transpose(1, 2).reshape(B, T, H * dv)
        out = self.o_proj(out.to(x.dtype))
        return out if self.tp is None else self.tp.all_reduce(out)


class MLP(nn.Module):
    """SwiGLU / GeGLU; with ``tp`` its slices (gate/up rows, down columns)
    and one all-reduce after down_proj."""

    def __init__(self, layer: dict, hidden_act: str = "silu", tp=None):
        super().__init__()
        self.hidden_act = hidden_act
        self.tp = tp
        for name in ("gate_proj", "up_proj", "down_proj"):
            setattr(self, name, Projection(layer[name]))

    def forward(self, x):
        act = _act(self.gate_proj(x).to(torch.float32), self.hidden_act)
        out = self.down_proj(act.to(x.dtype) * self.up_proj(x))
        return out if self.tp is None else self.tp.all_reduce(out)


class MoE(nn.Module):
    """Routed experts: Mixtral / Qwen3-MoE (bf16 router product, softmax,
    top-k, renormalized per norm_topk_prob) or DeepSeek
    (:func:`deepseek_topk`, plus the always-on shared-experts MLP).
    Dense-and-mask: every expert runs on every token and its output is
    weighted (zero off its tokens), summed in f32 in expert order; with
    quantized experts each product is a quantized matmul (the int4 GEMV at
    decode on the card). With ``tp`` each expert is its slices (w1/w3 rows,
    w2 columns): the weighted sum is one all-reduce, and the replicated
    shared experts are added after it.

    Stacked experts (``experts_stacked``, or :meth:`stack` of the list)
    under ``cfg.moe_dispatch == "capacity"`` take the capacity dispatch
    (:func:`capacity_tables_from_topk`, :func:`capacity_experts_apply`):
    each expert runs on the tokens routed to it, up to its capacity; under
    tp on the rank's slices, the same one all-reduce after."""

    def __init__(self, cfg: ModelConfig, layer: dict, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.register_buffer("moe_gate", layer["moe_gate"])
        self.register_buffer("gate_bias", layer.get("gate_bias"))
        self.experts = nn.ModuleList(
            MLP({"gate_proj": e["w1"], "up_proj": e["w3"], "down_proj": e["w2"]}, cfg.hidden_act)
            for e in layer.get("experts", ())
        )
        self.stacks = None if "experts_stacked" not in layer else tuple(layer["experts_stacked"])
        self.shared = None
        if "shared_gate_proj" in layer:
            self.shared = MLP({k: layer["shared_" + k] for k in ("gate_proj", "up_proj", "down_proj")},
                              cfg.hidden_act)

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(topk_idx, topk_w) of tokens ``x`` (..., E)."""
        return route_experts(self.cfg, self.moe_gate, self.gate_bias, x)

    def stack(self) -> bool:
        """Hold the experts as (W1, W3, W2) stacks instead of modules
        (:func:`stack_expert_weights` of the module); False, changing
        nothing, when they are quantized."""
        if self.stacks is not None:
            return True
        if self.experts[0].gate_proj.weight is None:
            return False
        self.stacks = tuple(torch.stack([getattr(e, name).weight for e in self.experts])
                            for name in ("gate_proj", "up_proj", "down_proj"))
        self.experts = nn.ModuleList()
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_exp = self.cfg.num_local_experts
        idx, w = self.route(x)
        if self.stacks is not None and self.cfg.moe_dispatch == "capacity":
            out = routed_capacity(self.cfg, idx, w, x, self.stacks, self.cfg.moe_capacity_factor)
        else:
            weights = _dense_weights(idx, w, n_exp)
            out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for e in range(n_exp):
                if self.stacks is None:
                    h = self.experts[e](x)
                else:  # stacked under the dense dispatch: expert e's slices
                    W1, W3, W2 = (s[e] for s in self.stacks)
                    h = _mlp_fn({"gate_proj": W1, "up_proj": W3, "down_proj": W2}, x, self.cfg.hidden_act)
                out = out + h.to(torch.float32) * weights[..., e : e + 1]
        if self.tp is not None:
            out = self.tp.all_reduce(out)
        if self.shared is not None:
            out = out + self.shared(x).to(torch.float32)
        return out.to(x.dtype)


class GptOssMoE(nn.Module):
    """GPT-OSS's expert block: :func:`gptoss_router_scores` (a biased
    router) and :func:`gptoss_expert_math` over the fused stacks, int8 /
    int4 stacks dequantized to x.dtype at use. With ``tp`` and a stack plan
    [e0, e1) the rank runs its experts end to end (their per-expert biases
    with them) and the score-weighted sum is one all-reduce."""

    def __init__(self, cfg: ModelConfig, layer: dict, tp=None, lp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp if lp is not None and lp.stacks is not None else None
        self.e0, self.e1 = lp.stacks if self.tp is not None else (0, cfg.num_local_experts)
        e = layer["gptoss_experts"]
        self.register_buffer("moe_gate", layer["moe_gate"])
        self.register_buffer("moe_gate_bias", layer["moe_gate_bias"])
        self.register_buffer("gate_up_bias", e["gate_up_bias"])
        self.register_buffer("down_bias", e["down_bias"])
        self.gate_up, self.down = Stack(e["gate_up"]), Stack(e["down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scores = gptoss_router_scores(self.cfg, self.moe_gate, self.moe_gate_bias, x)[..., self.e0:self.e1]
        out = gptoss_expert_math(x, self.gate_up.dense(x.dtype), self.gate_up_bias, self.down.dense(x.dtype),
                                 self.down_bias, scores)
        if self.tp is not None:
            out = self.tp.all_reduce(out)
        return out.to(x.dtype)


class Llama4MoE(nn.Module):
    """Llama-4's expert block: :func:`llama4_router_scores`; each expert's
    INPUT scaled by its score (zero off the chosen experts, so their
    bias-free SwiGLU gives exactly 0); ``gate_up`` (E, hidden, 2I) split
    into contiguous halves; every product in f32 over stacks dequantized to
    f32 (the JAX semantics: each MoE layer holds the f32 stacks only while
    it runs); plus the always-on shared expert. With ``tp`` and a stack plan
    [e0, e1) the rank runs its experts, the routed sum is one all-reduce and
    the replicated shared expert is added after it."""

    def __init__(self, cfg: ModelConfig, layer: dict, tp=None, lp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp if lp is not None and lp.stacks is not None else None
        self.e0, self.e1 = lp.stacks if self.tp is not None else (0, cfg.num_local_experts)
        e = layer["llama4_experts"]
        self.register_buffer("moe_gate", layer["moe_gate"])
        self.gate_up, self.down = Stack(e["gate_up"]), Stack(e["down"])
        self.shared = MLP({k: layer["shared_" + k] for k in ("gate_proj", "up_proj", "down_proj")}, cfg.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        xf = x.reshape(B * T, D).to(torch.float32)
        scores = llama4_router_scores(self.cfg, self.moe_gate, xf)[:, self.e0:self.e1]
        scaled = xf[None] * scores.T[:, :, None]  # (E, N, hidden)
        gu = torch.matmul(scaled, self.gate_up.dense(torch.float32))
        del scaled
        gate, up = gu.chunk(2, dim=-1)
        h = _act(gate, self.cfg.hidden_act) * up
        del gu, gate, up
        routed = torch.einsum("eni,eih->nh", h, self.down.dense(torch.float32))
        if self.tp is not None:
            routed = self.tp.all_reduce(routed)
        out = routed.reshape(B, T, D) + self.shared(x).to(torch.float32)
        return out.to(x.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer: dict, layer_idx: int, tp=None):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.olmo2 = cfg.is_olmo2
        self.po = cfg.is_gemma  # (1 + w) norms
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            self.register_buffer(name, layer.get(name))
        lp = tp.plan.layers[layer_idx] if tp is not None else None
        if cfg.is_mla:
            self.self_attn = LatentAttention(cfg, layer, tp, lp)
        else:
            self.self_attn = Attention(cfg, layer, cfg.layer_uses_rope(layer_idx), tp, lp)
        if "gptoss_experts" in layer:
            self.mlp = GptOssMoE(cfg, layer, tp, lp)
        elif "llama4_experts" in layer:
            self.mlp = Llama4MoE(cfg, layer, tp, lp)
        elif "experts" in layer or "experts_stacked" in layer:
            self.mlp = MoE(cfg, layer, tp if lp is not None and lp.experts else None)
        else:
            self.mlp = MLP(layer, cfg.hidden_act, tp if lp is not None and lp.mlp else None)

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
    JAX param pytree's layout; see models/loader.py and models/convert.py).
    With ``tp`` (parallel/tp.TPGroup) the params are the rank's slices
    (parallel/train.shard_params of ``tp.plan``)."""

    def __init__(self, cfg: ModelConfig, params: dict, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.vocab = tp.plan.vocab if tp is not None else None
        self.register_buffer("embed_tokens", params["embed_tokens"])
        self.register_buffer("norm", params["norm"])
        self.layers = nn.ModuleList(DecoderLayer(cfg, layer, i, tp) for i, layer in enumerate(params["layers"]))
        # the KV heads of this rank's cache (every layer shares the plan)
        self.kv_heads = self.layers[0].self_attn.n_kv if not cfg.is_mla else None
        head = params.get("lm_head")
        self.lm_head = Projection(head if head is not None else params["embed_tokens"])
        # each layer's mask kind
        self.kinds = ["chunked" if cfg.layer_is_chunked(i) else "sliding" if cfg.layer_is_sliding(i) else "full"
                      for i in range(len(self.layers))]

    def stack_experts(self) -> bool:
        """Stack every expert list once for the capacity dispatch (the
        engine's ``stack_expert_weights``); False, changing nothing, when
        the model has no expert list or its experts are quantized."""
        moes = [layer.mlp for layer in self.layers if isinstance(layer.mlp, MoE)]
        if not moes or any(m.stacks is None and m.experts[0].gate_proj.weight is None for m in moes):
            return False
        return all([m.stack() for m in moes])

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
        both sides. Llama-4's chunked mask (key j visible to query i iff j
        >= floor(i / C) * C) always compares positions: floor division does
        not commute with a pad shift, so without ``key_positions`` a key's
        position is its slot minus the row's pad (mask slot minus rope
        position). The additive masks cover only the first ``attn_len``
        slots (every later slot is masked), so a row's attention does not
        depend on the cache length: a request prefilled into a short
        admission cache gets the bits of the same prefill into a longer
        one. A decode step builds one slot list per mask kind (full,
        sliding, chunked), each compacted at its first use.
        Returns (f32 logits (B, T, V), kv_cache), the cache updated in
        place."""
        cfg = self.cfg
        if self.vocab is None:
            x = self.embed_tokens[input_ids]
        else:  # vocab-parallel: the rows this rank holds, zeros elsewhere, summed
            local = input_ids - self.vocab[0]
            held = (local >= 0) & (local < self.embed_tokens.shape[0])
            x = self.embed_tokens[local.clamp(0, self.embed_tokens.shape[0] - 1)]
            x = self.tp.all_reduce(torch.where(held[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)))
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
        mask_chunked = None
        if cfg.attention_chunk_size is not None:
            C = cfg.attention_chunk_size
            if key_positions is None:
                kpos = slot - (mpos - positions)[:, :, None]
            else:
                kpos = key_positions[:, None, :attn_len]
            chunk_start = torch.div(positions, C, rounding_mode="floor")[:, :, None] * C
            mask_chunked = torch.where(valid & (kpos >= chunk_start), zero, masked)
        masks = {"full": mask, "sliding": mask_sliding, "chunked": mask_chunked}
        # the flash kernel's slot lists: the K/V route's decode only
        decode = input_ids.shape[1] == 1 and not cfg.is_mla
        slots = {kind: attn_kernels.Slots(m[:, 0, :]) for kind, m in masks.items() if decode and m is not None}
        for i, layer in enumerate(self.layers):
            cos, sin = layer_rope(cfg, rope, i)
            kind = self.kinds[i]
            x = layer(x, cos, sin, positions, kv_cache, i, cache_pos, masks[kind], slots.get(kind))
        x = rms_norm(x, self.norm, cfg.rms_norm_eps, cfg.is_gemma)
        logits = self.lm_head(x).to(torch.float32)
        if self.vocab is not None:
            logits = self.tp.gather_vocab(logits)
        if cfg.final_logit_softcapping:
            cap = float(np.float32(cfg.final_logit_softcapping))
            logits = cap * torch.tanh(logits / cap)
        return logits, kv_cache


# ---------------------------------------------------------------------------
# Training: the cache-free causal forward on the params dict
# ---------------------------------------------------------------------------
#
# Functions of a params dict whose leaves may require grad (the serving
# modules above hold their weights as buffers and stay inference-only).
# ``split`` is one rank's view of a tensor-parallel layer (parallel/train.py
# ``LayerSplit``): the heads / MLP / experts / stacks its leaves are slices of
# (the fields of parallel/train.LayerPlan) and Megatron's three operators:
# ``enter`` (identity forward, gradient all-reduced backward) on every
# replicated tensor that feeds a split computation, ``share`` (rank 0's value,
# zeros elsewhere, gradient passed through) on every replicated term of a
# partial sum, and ``psum`` (all-reduce both ways) for OLMo-2's full-vector
# norm statistic. Each attention and FFN then returns this rank's partial sum,
# which ``reduce`` (the row-parallel all-reduce) completes. ``split=None``
# is the one-device block.


def embed_matrix(params: dict) -> torch.Tensor:
    """The embedding table as a matrix, dequantized when quantized (the one
    definition every forward entry reads)."""
    embed = params["embed_tokens"]
    return dequant(embed) if isinstance(embed, dict) else embed


def _mlp_fn(layer, x: torch.Tensor, hidden_act: str, prefix: str = "") -> torch.Tensor:
    act = _act(matmul(x, layer[prefix + "gate_proj"]).to(torch.float32), hidden_act)
    return matmul(act.to(x.dtype) * matmul(x, layer[prefix + "up_proj"]), layer[prefix + "down_proj"])


def _stack_of(w, dtype: torch.dtype) -> torch.Tensor:
    return dequant_stacked(w, dtype) if isinstance(w, dict) else w.to(dtype)


def _full_rms(v: torch.Tensor, w: torch.Tensor, width: int, psum, eps: float) -> torch.Tensor:
    """RMSNorm over a vector of ``width`` entries of which ``v`` holds a
    slice: the sum of squares is summed over the ranks."""
    v32 = v.to(torch.float32)
    ss = psum((v32 * v32).sum(dim=-1, keepdim=True))
    return (v32 * torch.rsqrt(ss / width + eps) * w.to(torch.float32)).to(v.dtype)


def _attention_train(cfg: ModelConfig, layer, h, cos, sin, positions, mask, use_rope, split, attend=None):
    """GQA attention over this call's own keys (S = T): the serving
    einsum path's math. ``mask`` (T, T) additive.

    ``attend(q, k, v, scale, sinks)`` replaces the scores, softcap, mask,
    sinks and softmax (context parallelism's ring, parallel/ring.py, which
    masks by global positions: ``mask`` is then unused): q (B, H, T, D), k
    and v (B, KVH, T, D) after rope, ``scale`` the score multiplier, ``sinks``
    the (H,) sink logits of the heads computed here or None; it returns the
    f32 (B, H, T, D) attention output."""
    B, T, _ = h.shape
    H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    heads = split is not None and split.heads is not None
    enter = split.enter if heads else (lambda t: t)
    if heads:
        (h0, h1), (k0, k1) = split.heads, split.kv_heads
        H, KVH = h1 - h0, k1 - k0
        h = enter(h)
    q, k, v = matmul(h, layer["q_proj"]), matmul(h, layer["k_proj"]), matmul(h, layer["v_proj"])
    if "q_bias" in layer:
        q, k, v = q + layer["q_bias"], k + layer["k_bias"], v + layer["v_bias"]
    if cfg.qk_norm_full:  # olmo2: the FULL vectors, before the head split
        if heads:
            q = _full_rms(q, enter(layer["q_norm"])[h0 * D:h1 * D], cfg.num_attention_heads * D, split.psum,
                          cfg.rms_norm_eps)
            k = _full_rms(k, enter(layer["k_norm"])[k0 * D:k1 * D], cfg.num_key_value_heads * D, split.psum,
                          cfg.rms_norm_eps)
        else:
            q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps)
    q = q.reshape(B, T, H, D).transpose(1, 2)
    k = k.reshape(B, T, KVH, D).transpose(1, 2)
    v = v.reshape(B, T, KVH, D).transpose(1, 2)
    if "q_norm" in layer and not cfg.qk_norm_full:  # qwen3 / gemma3 per head
        q = rms_norm(q, enter(layer["q_norm"]), cfg.rms_norm_eps, cfg.is_gemma)
        k = rms_norm(k, enter(layer["k_norm"]), cfg.rms_norm_eps, cfg.is_gemma)
    if use_rope:
        q, k = apply_rope_cfg(cfg, q, k, cos, sin, positions)
        q, k = l2_qk(cfg, q, k)
    else:
        q = nope_temp_q(cfg, q, positions)
    group = H // KVH
    scale = float(np.sqrt(np.float32(cfg.query_pre_attn_scalar or D)))
    sinks = None
    if "sinks" in layer:  # gpt-oss: the sink logit joins the normalization
        sinks = enter(layer["sinks"])
        if heads:
            sinks = sinks[h0:h1]
    if attend is not None:
        out = attend(q, k, v, 1.0 / scale, sinks)
    else:
        qg = q.reshape(B, KVH, group, T, D)
        scores = torch.einsum("bkgtd,bksd->bkgts", qg.to(torch.float32), k.to(torch.float32)) / scale
        if cfg.attn_logit_softcapping:
            cap = float(np.float32(cfg.attn_logit_softcapping))
            scores = cap * torch.tanh(scores / cap)
        scores = scores + mask
        if sinks is not None:
            sinks = sinks.to(torch.float32).reshape(1, KVH, group, 1, 1)
            mx = torch.maximum(scores.amax(dim=-1, keepdim=True), sinks)
            e = torch.exp(scores - mx)
            probs = e / (e.sum(dim=-1, keepdim=True) + torch.exp(sinks - mx))
        else:
            probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgts,bksd->bkgtd", probs, v.to(torch.float32))
    out = out.reshape(B, H, T, D).transpose(1, 2).reshape(B, T, H * D)
    out = matmul(out.to(h.dtype), layer["o_proj"])
    if split is not None and not heads:  # replicated attention: one rank's term
        out = split.share(out)
    if "o_bias" in layer:  # after the sum, once: rank 0's term
        out = out + (layer["o_bias"] if split is None else split.share(layer["o_bias"]))
    return out


def _mla_train(cfg: ModelConfig, layer, h, cos, sin, positions, mask, split):
    """DeepSeek MLA, cache-free: attention over this call's own latents
    (S = T), the serving path's absorbed einsums."""
    B, T, _ = h.shape
    H = cfg.num_attention_heads
    dn, dr, dc, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
    heads = split is not None and split.heads is not None
    enter = split.enter if heads else (lambda t: t)
    h0, h1 = split.heads if heads else (0, H)
    if "q_proj" in layer:  # no q_lora_rank (V2-Lite): q_proj is split by heads
        q = matmul(enter(h), layer["q_proj"]).reshape(B, T, h1 - h0, dn + dr)
    else:
        q = matmul(rms_norm(matmul(h, layer["q_a_proj"]), layer["q_a_layernorm"], cfg.rms_norm_eps),
                   layer["q_b_proj"])
        q = enter(q.reshape(B, T, H, dn + dr))[:, :, h0:h1]
    q = q.transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = matmul(h, layer["kv_a_proj"])
    c = enter(rms_norm(ckv[..., :dc], layer["kv_a_layernorm"], cfg.rms_norm_eps))
    q_pe, k_pe = apply_rope_cfg(cfg, q_pe, enter(ckv[..., dc:][:, None]), cos, sin, positions)
    wkb = layer["kv_b_proj"]
    wkb = dequant(wkb, torch.float32) if isinstance(wkb, dict) else wkb.to(torch.float32)
    wkb = enter(wkb.reshape(H, dn + dv, dc))[h0:h1]
    c32, pe32 = c.to(torch.float32), k_pe[:, 0].to(torch.float32)
    q_abs = torch.einsum("bhtd,hdc->bhtc", q_nope.to(torch.float32), wkb[:, :dn])
    scores = torch.einsum("bhtc,bsc->bhts", q_abs, c32) + torch.einsum("bhtd,bsd->bhts", q_pe.to(torch.float32), pe32)
    scores = scores * float(np.float32(cfg.mla_softmax_scale)) + mask
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhts,bsc->bhtc", probs, c32)
    out = torch.einsum("bhtc,hvc->bhtv", ctx, wkb[:, dn:])
    out = matmul(out.transpose(1, 2).reshape(B, T, (h1 - h0) * dv).to(h.dtype), layer["o_proj"])
    return split.share(out) if split is not None and not heads else out


def _experts_train(cfg: ModelConfig, layer, x, split):
    """Expert lists or stacks (Mixtral / Qwen3-MoE / DeepSeek), plus
    DeepSeek's shared experts; the serving ``MoE``'s math: dense-and-mask,
    or the capacity dispatch of stacked experts under ``cfg.moe_dispatch ==
    "capacity"``."""
    n_exp = cfg.num_local_experts
    idx, w = route_experts(cfg, layer["moe_gate"], layer.get("gate_bias"), x)
    split_e = split is not None and split.experts
    xe = split.enter(x) if split_e else x
    if "experts_stacked" in layer and cfg.moe_dispatch == "capacity":
        w = split.enter(w) if split_e else w
        out = routed_capacity(cfg, idx, w, x, layer["experts_stacked"], cfg.moe_capacity_factor, xe)
    else:
        weights = _dense_weights(idx, w, n_exp)
        weights = split.enter(weights) if split_e else weights
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for e in range(n_exp):
            if "experts_stacked" in layer:
                W1, W3, W2 = (s[e] for s in layer["experts_stacked"])
            else:
                ex = layer["experts"][e]
                W1, W3, W2 = ex["w1"], ex["w3"], ex["w2"]
            h = _mlp_fn({"gate_proj": W1, "up_proj": W3, "down_proj": W2}, xe, cfg.hidden_act)
            out = out + h.to(torch.float32) * weights[..., e:e + 1]
    if split is not None and not split_e:
        out = split.share(out)
    if "shared_gate_proj" in layer:
        shared = _mlp_fn(layer, x, cfg.hidden_act, "shared_").to(torch.float32)
        out = out + (shared if split is None else split.share(shared))
    return out.to(x.dtype)


def _gptoss_train(cfg: ModelConfig, layer, x, split):
    e = layer["gptoss_experts"]
    scores = gptoss_router_scores(cfg, layer["moe_gate"], layer["moe_gate_bias"], x)
    split_s = split is not None and split.stacks is not None
    xe = x
    if split_s:
        e0, e1 = split.stacks
        scores, xe = split.enter(scores)[..., e0:e1], split.enter(x)
    out = gptoss_expert_math(xe, _stack_of(e["gate_up"], x.dtype), e["gate_up_bias"], _stack_of(e["down"], x.dtype),
                             e["down_bias"], scores)
    if split is not None and not split_s:
        out = split.share(out)
    return out.to(x.dtype)


def _llama4_train(cfg: ModelConfig, layer, x, split):
    e = layer["llama4_experts"]
    B, T, D = x.shape
    xf = x.reshape(B * T, D).to(torch.float32)
    scores = llama4_router_scores(cfg, layer["moe_gate"], xf)
    split_s = split is not None and split.stacks is not None
    xe = xf
    if split_s:
        e0, e1 = split.stacks
        scores, xe = split.enter(scores)[:, e0:e1], split.enter(xf)
    gu = torch.matmul(xe[None] * scores.T[:, :, None], _stack_of(e["gate_up"], torch.float32))
    gate, up = gu.chunk(2, dim=-1)
    routed = torch.einsum("eni,eih->nh", _act(gate, cfg.hidden_act) * up, _stack_of(e["down"], torch.float32))
    if split is not None and not split_s:
        routed = split.share(routed)
    shared = _mlp_fn(layer, x, cfg.hidden_act, "shared_").to(torch.float32)
    out = routed.reshape(B, T, D) + (shared if split is None else split.share(shared))
    return out.to(x.dtype)


def _ffn_train(cfg: ModelConfig, layer, x, split, ffn=None):
    """The layer's FFN: this rank's partial sum under ``split``; ``ffn(cfg,
    layer, x)``, when given, instead (expert parallelism's dispatch,
    parallel/moe.py)."""
    if ffn is not None:
        return ffn(cfg, layer, x)
    if "gptoss_experts" in layer:
        return _gptoss_train(cfg, layer, x, split)
    if "llama4_experts" in layer:
        return _llama4_train(cfg, layer, x, split)
    if "experts" in layer or "experts_stacked" in layer:
        return _experts_train(cfg, layer, x, split)
    if split is None:
        return _mlp_fn(layer, x, cfg.hidden_act)
    if split.mlp:
        return _mlp_fn(layer, split.enter(x), cfg.hidden_act)
    return split.share(_mlp_fn(layer, x, cfg.hidden_act))


def block_train(cfg: ModelConfig, layer, x, cos, sin, positions, mask, reduce=None, use_rope: bool = True,
                split=None, attend=None, ffn=None):
    """One cache-free decoder block (attention + FFN with residuals),
    differentiable; ``mask`` (T, T) additive.

    ``reduce``: the partial-sum reduction applied to the attention output
    (after o_proj) and the FFN output (after down_proj), Megatron's two
    row-parallel products: with ``split``'s slices it is the ranks'
    all-reduce; None is the one-device block. ``attend`` replaces the
    attention's score-to-output math (:func:`_attention_train`; not MLA's)
    and ``ffn`` the FFN (:func:`_ffn_train`): the hooks of context and
    expert parallelism."""
    po = cfg.is_gemma
    h = x if cfg.is_olmo2 else rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps, po)
    if cfg.is_mla:
        attn_out = _mla_train(cfg, layer, h, cos, sin, positions, mask, split)
    else:
        attn_out = _attention_train(cfg, layer, h, cos, sin, positions, mask, use_rope, split, attend)
    return _block_tail(cfg, layer, x, attn_out, reduce, po, split, ffn)


def _block_tail(cfg: ModelConfig, layer, x, attn_out, reduce, po: bool, split=None, ffn=None):
    """The reduce / residual / FFN tail every attention shares: OLMo-2's
    post-norms, Gemma-2/3's and GLM-4's sandwich norms, the pre-norm block."""
    eps = cfg.rms_norm_eps
    if reduce is not None:
        attn_out = reduce(attn_out)
    if cfg.is_olmo2:  # post-norm residuals, no pre-FFN norm
        x = x + rms_norm(attn_out, layer["post_attention_layernorm"], eps)
        ffn_out = _ffn_train(cfg, layer, x, split, ffn)
        if reduce is not None:
            ffn_out = reduce(ffn_out)
        return x + rms_norm(ffn_out, layer["post_feedforward_layernorm"], eps)
    if "pre_feedforward_layernorm" in layer:  # sandwich norms
        x = x + rms_norm(attn_out, layer["post_attention_layernorm"], eps, po)
        ffn_out = _ffn_train(cfg, layer, rms_norm(x, layer["pre_feedforward_layernorm"], eps, po), split, ffn)
        if reduce is not None:
            ffn_out = reduce(ffn_out)
        return x + rms_norm(ffn_out, layer["post_feedforward_layernorm"], eps, po)
    x = x + attn_out
    ffn_out = _ffn_train(cfg, layer, rms_norm(x, layer["post_attention_layernorm"], eps, po), split, ffn)
    if reduce is not None:
        ffn_out = reduce(ffn_out)
    return x + ffn_out


def train_masks(cfg: ModelConfig, T: int, device=None) -> Dict[str, torch.Tensor]:
    """The additive (T, T) f32 masks of a cache-free forward by kind: full
    (causal), sliding (the window) and chunked (Llama-4's chunk-aligned)."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    causal = j <= i
    zero = torch.zeros((), dtype=torch.float32, device=device)
    masked = torch.full((), -1e9, dtype=torch.float32, device=device)
    masks = {"full": torch.where(causal, zero, masked)}
    if cfg.sliding_window is not None:
        masks["sliding"] = torch.where(causal & (j > i - cfg.sliding_window), zero, masked)
    if cfg.attention_chunk_size is not None:
        C = cfg.attention_chunk_size
        masks["chunked"] = torch.where(causal & (j >= torch.div(i, C, rounding_mode="floor") * C), zero, masked)
    return masks


def embed_train(params: dict, cfg: ModelConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """The embedded (B, T) ids, Gemma's sqrt(hidden) scale applied: the
    first step of :func:`forward_train`."""
    x = embed_matrix(params)[input_ids]
    if cfg.is_gemma:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype, device=x.device)
    return x


def blocks_train(cfg: ModelConfig, layers, x: torch.Tensor, remat: bool = False, tp=None, ffn=None) -> torch.Tensor:
    """``x`` through ``layers``, (global layer index, layer) pairs in order:
    each block with its own index's mask, rope table, rope gate and
    tensor-parallel split (:func:`forward_train`'s middle; a pipeline stage
    runs its own layers through it); ``ffn`` as for :func:`block_train`."""
    from torch.utils.checkpoint import checkpoint

    B, T = x.shape[:2]
    rope = rope_tables(cfg, T, x.device)
    positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
    masks = train_masks(cfg, T, x.device)

    def blk(layer, x, mask, cos, sin, use_rope, split):
        return block_train(cfg, layer, x, cos, sin, positions, mask, None if tp is None else tp.reduce,
                           use_rope, split, ffn=ffn)

    for i, layer in layers:
        kind = "chunked" if cfg.layer_is_chunked(i) else "sliding" if cfg.layer_is_sliding(i) else "full"
        cos, sin = layer_rope(cfg, rope, i)
        args = (layer, x, masks[kind], cos, sin, cfg.layer_uses_rope(i), None if tp is None else tp.splits[i])
        if remat:
            x = checkpoint(blk, *args, use_reentrant=False)
        else:
            x = blk(*args)
    return x


def head_train(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm, the lm_head (the embedding when tied) and the final
    softcap: f32 logits, :func:`forward_train`'s last step."""
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, cfg.is_gemma)
    head = params.get("lm_head")
    logits = matmul(x, head if head is not None else params["embed_tokens"]).to(torch.float32)
    if cfg.final_logit_softcapping:
        cap = float(np.float32(cfg.final_logit_softcapping))
        logits = cap * torch.tanh(logits / cap)
    return logits


def forward_train(params: dict, cfg: ModelConfig, input_ids: torch.Tensor, remat: bool = False, tp=None
                  ) -> torch.Tensor:
    """Cache-free causal forward for training: (B, T) ids -> f32 logits
    (B, T, V), differentiable through every leaf that requires grad.

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes a block's activations instead
    of holding every layer's, with the same ops in the same order.
    ``tp`` (parallel/train.py ``TrainTP``): the params are one rank's
    tensor-parallel slices; ``tp.splits[i]`` is layer i's view and
    ``tp.reduce`` the row-parallel all-reduce. The embedding and the
    lm_head are whole on every rank."""
    x = embed_train(params, cfg, input_ids)
    x = blocks_train(cfg, enumerate(params["layers"]), x, remat, tp)
    return head_train(params, cfg, x)
