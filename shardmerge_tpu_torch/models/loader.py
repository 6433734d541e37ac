"""Load an HF safetensors checkpoint into the port's params dict
(counterpart of shardmerge_tpu/models/loader.py).

Each tensor is read as a view of its shard file and copied to the device
once. With ``quant_bits`` the per-layer projections (``llama.QUANTIZABLE``:
attention, MLP, DeepSeek's MLA and shared-expert matrices) and every
expert's w1/w3/w2, one expert at a time, are quantized ON THE HOST before
the copy (a device-side quantize would first place the full-width weight,
the very memory quantization is meant to save); embeddings, norms, biases,
routers and lm_head stay in ``dtype``. Mixtral's
``block_sparse_moe.experts.E.w{1,2,3}`` and Qwen3-MoE's and DeepSeek's
``mlp.experts.E.{gate,up,down}_proj`` fill the ``experts`` list. Phi-3's fused
``qkv_proj`` and ``gate_up_proj`` split by head geometry before that (each
part quantized on its own), and GLM-4's sandwich norms land in the Gemma-2
slots, as the JAX loader maps them. GPT-OSS's and Llama-4's fused expert
stacks (``mlp.experts.gate_up_proj`` / ``down_proj`` with GPT-OSS's biases;
``feed_forward.experts.*``) fill ``gptoss_experts`` / ``llama4_experts``,
quantized per (expert, output channel) with ``quant_bits``
(``quant.quantize_stacked``); Llama-4's ``feed_forward.*`` MLP and
``shared_expert`` take the dense and shared-expert slots, its multimodal
checkpoints' ``language_model.`` prefix is dropped, and the MoE layers
found must be the config's ``moe_layers``. GPT-OSS's shipped MXFP4 stacks
(``*_blocks`` / ``*_scales``, the halves possibly in different shards) are
staged until both halves are in, then decoded to f32 on ``device``
(``quant.dequant_mxfp4``) and, with ``quant_bits``, quantized there.

With ``tp`` (a rank's parallel/train.Plan) each tensor is cut to this
rank's slice on the host before its copy (parallel/train.shard_leaf), so a
rank never holds the whole model on its device: quantized weights are
quantized whole first (a row-parallel slice keeps the full row's scale) and
a packed-int4 row slice is re-packed over its own columns; GPT-OSS's MXFP4
halves are cut to the rank's experts before they are decoded.

A PEFT LoRA adapter directory loads as its base checkpoint with the pairs
fused per tensor as they are read (``resolve_checkpoint_dir``; the fuse is
``tools/fuse_lora.fuse_pair``, so loading an adapter equals loading its
``fuse-lora`` output). A GPTQ or AWQ checkpoint (``config.json``
``quantization_config``) has each module's packed parts staged and decoded
on the host to the f32 weight, which then takes the same route (adapter
fuse, then int8/int4 re-quantization on the host).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import torch

from ..io.safetensors_io import SafeTensorsReader
from .llama import QUANTIZABLE, STACK_KEYS, ModelConfig, layer_keys
from .quant import dequant_mxfp4, quantize, quantize_stacked

logger = logging.getLogger(__name__)

__all__ = ["load_params", "resolve_checkpoint_dir"]


def resolve_checkpoint_dir(model_path):
    """(weights_dir, adapter or None) for a checkpoint or a PEFT LoRA
    adapter directory; an adapter resolves to its declared base checkpoint
    with {"pairs", "scale"} to fuse at load."""
    model_path = Path(model_path)
    if (model_path / "adapter_config.json").is_file() and not (
        (model_path / "model.safetensors.index.json").exists() or (model_path / "model.safetensors").exists()
    ):
        from ..tools.fuse_lora import load_adapter

        pairs, scale = load_adapter(model_path)
        base_ref = str(json.loads((model_path / "adapter_config.json").read_text())
                       .get("base_model_name_or_path") or "")
        if not base_ref or not Path(base_ref).is_dir():
            raise FileNotFoundError(
                f"adapter {model_path} declares base_model_name_or_path={base_ref!r}, which is not a "
                "local checkpoint directory; set it to the adapter's base checkpoint"
            )
        logger.info("Loading LoRA adapter %s fused onto base %s (%d tensor pairs, scale %g)",
                    model_path, base_ref, len(pairs), scale)
        return Path(base_ref), {"pairs": pairs, "scale": float(scale)}
    return model_path, None


def _packed_format(model_path: Path) -> Optional[dict]:
    """The GPTQ/AWQ format a checkpoint's config.json announces, or None."""
    from ..io.index import packed_quant_info

    cfg_path = model_path / "config.json"
    if not cfg_path.is_file():
        return None
    qc = json.loads(cfg_path.read_text()).get("quantization_config") or {}
    try:
        info = packed_quant_info(qc)
    except ValueError as e:
        raise ValueError(f"{model_path}: {e} — dequantize to bf16 first") from e
    if info is None and qc.get("quant_method") not in (None, "mxfp4"):
        raise ValueError(
            f"{model_path} uses quant_method {qc.get('quant_method')!r}; supported quantized "
            "formats are GPTQ, AWQ (gemm) and MXFP4 (gpt-oss) — dequantize to bf16 first"
        )
    if info is not None:
        logger.info("%s checkpoint (bits=%d): decoding packed tensors at load", info["fmt"].upper(), info["bits"])
    return info

_LAYER_WEIGHTS = {
    "self_attn.q_proj.weight": "q_proj",
    "self_attn.k_proj.weight": "k_proj",
    "self_attn.v_proj.weight": "v_proj",
    "self_attn.o_proj.weight": "o_proj",
    "mlp.gate_proj.weight": "gate_proj",
    "mlp.up_proj.weight": "up_proj",
    "mlp.down_proj.weight": "down_proj",
    "input_layernorm.weight": "input_layernorm",
    "post_attention_layernorm.weight": "post_attention_layernorm",
    # qwen2 / glm4 q/k/v biases (kept in the dtype)
    "self_attn.q_proj.bias": "q_bias",
    "self_attn.k_proj.bias": "k_bias",
    "self_attn.v_proj.bias": "v_bias",
    # gemma2/3 post-norm blocks, olmo2's post-FFN norm
    "pre_feedforward_layernorm.weight": "pre_feedforward_layernorm",
    "post_feedforward_layernorm.weight": "post_feedforward_layernorm",
    # qwen3/gemma3 per-head and olmo2 full-vector q/k norms
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    # deepseek v2/v3 multi-head latent attention
    "self_attn.q_a_proj.weight": "q_a_proj",
    "self_attn.q_a_layernorm.weight": "q_a_layernorm",
    "self_attn.q_b_proj.weight": "q_b_proj",
    "self_attn.kv_a_proj_with_mqa.weight": "kv_a_proj",
    "self_attn.kv_a_layernorm.weight": "kv_a_layernorm",
    "self_attn.kv_b_proj.weight": "kv_b_proj",
    # the routers (mixtral; qwen3-moe and deepseek), deepseek's shared
    # experts and V3's selection bias
    "block_sparse_moe.gate.weight": "moe_gate",
    "mlp.gate.weight": "moe_gate",
    "mlp.shared_experts.gate_proj.weight": "shared_gate_proj",
    "mlp.shared_experts.up_proj.weight": "shared_up_proj",
    "mlp.shared_experts.down_proj.weight": "shared_down_proj",
    "mlp.gate.e_score_correction_bias": "gate_bias",
    # gpt-oss's biased router, sinks and o_proj bias; llama4's router, its
    # feed_forward MLP (dense layers) and shared expert
    "mlp.router.weight": "moe_gate",
    "mlp.router.bias": "moe_gate_bias",
    "self_attn.sinks": "sinks",
    "self_attn.o_proj.bias": "o_bias",
    "feed_forward.router.weight": "moe_gate",
    "feed_forward.gate_proj.weight": "gate_proj",
    "feed_forward.up_proj.weight": "up_proj",
    "feed_forward.down_proj.weight": "down_proj",
    "feed_forward.shared_expert.gate_proj.weight": "shared_gate_proj",
    "feed_forward.shared_expert.up_proj.weight": "shared_up_proj",
    "feed_forward.shared_expert.down_proj.weight": "shared_down_proj",
}
# the fused expert stacks: (params key, stack key); gpt-oss's biases stay
# in the dtype, its stacks and llama4's quantize
_STACKS = {
    "mlp.experts.gate_up_proj": ("gptoss_experts", "gate_up"),
    "mlp.experts.gate_up_proj_bias": ("gptoss_experts", "gate_up_bias"),
    "mlp.experts.down_proj": ("gptoss_experts", "down"),
    "mlp.experts.down_proj_bias": ("gptoss_experts", "down_bias"),
    "feed_forward.experts.gate_up_proj": ("llama4_experts", "gate_up"),
    "feed_forward.experts.down_proj": ("llama4_experts", "down"),
}
# qwen3-moe / deepseek expert weights use the MLP names; the params keep
# mixtral's w1/w3/w2
_EXPERT_WEIGHTS = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2", "w1": "w1", "w2": "w2", "w3": "w3"}
# glm4's sandwich norms in the gemma2 slots: its post_attention_layernorm
# is the PRE-ffn norm
_GLM4_NORMS = {
    "post_self_attn_layernorm.weight": "post_attention_layernorm",
    "post_attention_layernorm.weight": "pre_feedforward_layernorm",
    "post_mlp_layernorm.weight": "post_feedforward_layernorm",
}


def _split_fused(suffix: str, arr, cfg: ModelConfig):
    """phi3 (and glm4's MLP) fuse projections row-wise: qkv_proj splits by
    head geometry, gate_up_proj into equal halves. None for other names."""
    if suffix == "self_attn.qkv_proj.weight":
        q_dim = cfg.num_attention_heads * cfg.head_dim
        kv_dim = cfg.num_key_value_heads * cfg.head_dim
        return zip(("q_proj", "k_proj", "v_proj"), torch.split(arr, [q_dim, kv_dim, kv_dim], dim=0))
    if suffix == "mlp.gate_up_proj.weight":
        return zip(("gate_proj", "up_proj"), torch.chunk(arr, 2, dim=0))
    return None


def load_params(
    model_path,
    cfg: Optional[ModelConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    quant_bits: Optional[int] = None,
    device="cpu",
    resolved=None,
    tp=None,
) -> dict:
    """Params dict ``{"embed_tokens", "norm", "lm_head"?, "layers"}`` on
    ``device``, projections quantized to ``quant_bits`` (4 or 8) if given.
    ``model_path`` may be an adapter directory; a caller that resolved it
    already passes ``resolved=(weights_dir, adapter)``. ``tp``: a rank's
    tensor-parallel plan (parallel/train.plan); the params are then its
    slices."""
    from ..io.index import PACKED_PARTS
    from ..tools.fuse_lora import fuse_pair
    from .quant import dequant_awq, dequant_gptq

    model_path, adapter = resolved if resolved is not None else resolve_checkpoint_dir(model_path)
    packed = _packed_format(model_path)
    packed_parts = PACKED_PARTS[packed["fmt"]] if packed else ()
    pending: dict = {}  # module root -> its packed parts so far
    if cfg is None:
        cfg = ModelConfig.from_pretrained(model_path)
    index_path = model_path / "model.safetensors.index.json"
    if index_path.exists():
        shards = sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    elif (model_path / "model.safetensors").exists():
        shards = ["model.safetensors"]
    else:
        raise FileNotFoundError(f"No safetensors weights in {model_path}")

    def cut(leaf, key, layer_idx=None, stack=None):
        """This rank's slice of a host leaf (the whole leaf without ``tp``)."""
        if tp is None:
            return leaf
        from ..parallel.train import shard_leaf

        return shard_leaf(cfg, tp, key, leaf, layer_idx, stack)

    def place(t):
        return t.to(device=device, dtype=dtype)

    def place_weight(w, key, layer_idx, quantized):
        """A projection or expert matrix: quantized whole on the host when
        asked, then cut, then copied."""
        if quantized:
            return {k: v.to(device) for k, v in cut(quantize(w, quant_bits), key, layer_idx).items()}
        return place(cut(w, key, layer_idx))

    def place_stack(w, key, layer_idx, group, whole=True):
        """A fused stack (``whole``: not yet cut to the rank's experts)."""
        if quant_bits and key in ("gate_up", "down"):
            qd = quantize_stacked(w, quant_bits)
            qd = cut(qd, key, layer_idx, group) if whole else qd
            return {k: v.to(device) for k, v in qd.items()}
        return place(cut(w, key, layer_idx, group) if whole else w)

    mxfp4_pending: dict = {}  # (layer, gate_up_proj | down_proj) -> its blocks / scales so far

    params: dict = {"layers": [dict() for _ in range(cfg.num_hidden_layers)]}
    for shard in shards:
        with SafeTensorsReader(model_path / shard) as reader:
            for name in reader.keys():
                arr = reader.get_tensor(name)
                if name.startswith("language_model."):
                    # llama4's multimodal checkpoints nest the decoder; the
                    # vision tensors fall through to the warning below
                    name = name[len("language_model."):]
                root, _, part = name.rpartition(".")
                if part in packed_parts:
                    # stage the module's parts (copied: they may span
                    # shards) and decode once all are in
                    pend = pending.setdefault(root, {})
                    pend[part] = arr.clone()
                    if len(pend) < len(packed_parts):
                        continue
                    del pending[root]
                    if packed["fmt"] == "awq":
                        arr = dequant_awq(pend["qweight"], pend["qzeros"], pend["scales"], bits=packed["bits"])
                    else:
                        arr = dequant_gptq(pend["qweight"], pend["qzeros"], pend["scales"], pend["g_idx"],
                                           packed["bits"], v1_zero_offset=packed["v1"])
                    name = root + ".weight"
                if adapter is not None and name in adapter["pairs"]:
                    # fuse before quantization: the same weight as a
                    # fuse-lora'd checkpoint's (the JAX loader's
                    # _apply_lora_pair)
                    pair = adapter["pairs"][name]
                    arr = fuse_pair(arr, pair["A"], pair["B"], adapter["scale"])
                if name == "model.embed_tokens.weight":
                    params["embed_tokens"] = place(cut(arr, "embed_tokens"))
                elif name == "model.norm.weight":
                    params["norm"] = place(arr)
                elif name == "lm_head.weight":
                    params["lm_head"] = place(cut(arr, "lm_head"))
                elif name.startswith("model.layers."):
                    parts = name.split(".")
                    suffix = ".".join(parts[3:])
                    li = int(parts[2])
                    layer = params["layers"][li]
                    if suffix in _STACKS:
                        group, key = _STACKS[suffix]
                        layer.setdefault(group, {})[key] = place_stack(arr, key, li, group)
                        continue
                    if suffix.startswith("mlp.experts.") and suffix.endswith(("_blocks", "_scales")):
                        # gpt-oss's MXFP4 stacks: stage each half (copied:
                        # the halves may sit in different shards), decode
                        # once both are in
                        stem, _, half = suffix[len("mlp.experts."):].rpartition("_")
                        pend = mxfp4_pending.setdefault((int(parts[2]), stem), {})
                        pend[half] = arr.clone()
                        if len(pend) == 2:
                            del mxfp4_pending[(int(parts[2]), stem)]
                            group, key = _STACKS["mlp.experts." + stem]
                            # the halves lead with the expert axis: cut them
                            # to the rank's experts before decoding
                            blocks, scales = (cut(pend[h], key, li, group) for h in ("blocks", "scales"))
                            w = dequant_mxfp4(blocks.to(device), scales.to(device))
                            layer.setdefault(group, {})[key] = place_stack(w, key, li, group, whole=False)
                        continue
                    if suffix.startswith(("block_sparse_moe.experts.", "mlp.experts.")) and parts[5].isdigit():
                        # model.layers.N.block_sparse_moe.experts.E.w{1,2,3}.weight (mixtral)
                        # model.layers.N.mlp.experts.E.{gate,up,down}_proj.weight (qwen3-moe, deepseek)
                        experts = layer.setdefault("experts", [dict() for _ in range(cfg.num_local_experts)])
                        wname = _EXPERT_WEIGHTS[parts[6]]
                        experts[int(parts[5])][wname] = place_weight(arr, wname, li, bool(quant_bits))
                        continue
                    if cfg.model_type == "glm4" and suffix in _GLM4_NORMS:
                        pieces = [(_GLM4_NORMS[suffix], arr)]
                    else:
                        pieces = _split_fused(suffix, arr, cfg)
                        if pieces is None:
                            key = _LAYER_WEIGHTS.get(suffix)
                            if key is None:
                                raise NotImplementedError(
                                    f"weight {name} belongs to a feature not ported yet"
                                )
                            pieces = [(key, arr)]
                    for key, w in pieces:
                        layer[key] = place_weight(w, key, li, bool(quant_bits) and key in QUANTIZABLE)
                else:
                    logger.warning("Skipping unknown weight %s", name)

    if pending:
        raise ValueError(f"{model_path}: packed modules with missing parts: {sorted(pending)[:4]}")
    if mxfp4_pending:
        raise ValueError(
            f"Checkpoint at {model_path} has incomplete MXFP4 expert tensors (blocks without scales or "
            f"vice versa): {sorted(mxfp4_pending)[:4]}"
        )
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    if cfg.moe_layers is not None:
        # llama4: the expert stacks found must sit exactly on the config's
        # MoE layers (a missing stack would serve that layer dense)
        wrong = [i for i, layer in enumerate(params["layers"]) if ("llama4_experts" in layer) != cfg.layer_is_moe(i)]
        if wrong:
            raise ValueError(
                f"Checkpoint at {model_path} disagrees with the config's moe_layers table at layers {wrong[:4]}: "
                "expert stacks present where the config says dense (or vice versa)"
            )
    missing = [
        i for i, layer in enumerate(params["layers"])
        if set(layer) != layer_keys(cfg, i)
        or any(set(e) != {"w1", "w2", "w3"} for e in layer.get("experts", []))
        or any(set(layer[g]) != keys for g, keys in STACK_KEYS.items() if g in layer)
    ]
    if missing or "embed_tokens" not in params or "norm" not in params:
        raise ValueError(
            f"Checkpoint at {model_path} is incomplete or does not match its config "
            f"(embed/norm, or layers {missing[:4]} against "
            f"{sorted(layer_keys(cfg, missing[0] if missing else 0))})"
        )
    if not cfg.tie_word_embeddings and "lm_head" not in params:
        raise ValueError(f"Checkpoint at {model_path} has no lm_head.weight")
    return params
