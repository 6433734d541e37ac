"""Load an HF Llama safetensors checkpoint into the port's params dict
(counterpart of shardmerge_tpu/models/loader.py, Llama family only).

Each tensor is read as a view of its shard file and copied to the device
once. With ``quant_bits`` the seven per-layer projections are quantized ON
THE HOST before the copy (a device-side quantize would first place the
full-width weight, the very memory quantization is meant to save);
embeddings, norms and lm_head stay in ``dtype``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import torch

from ..io.safetensors_io import SafeTensorsReader
from .llama import ModelConfig
from .quant import quantize

logger = logging.getLogger(__name__)

__all__ = ["load_params"]

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
}
_QUANTIZABLE = {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}


def load_params(
    model_path,
    cfg: Optional[ModelConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    quant_bits: Optional[int] = None,
    device="cpu",
) -> dict:
    """Params dict ``{"embed_tokens", "norm", "lm_head"?, "layers"}`` on
    ``device``, projections quantized to ``quant_bits`` (4 or 8) if given."""
    model_path = Path(model_path)
    if cfg is None:
        cfg = ModelConfig.from_pretrained(model_path)
    index_path = model_path / "model.safetensors.index.json"
    if index_path.exists():
        shards = sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    elif (model_path / "model.safetensors").exists():
        shards = ["model.safetensors"]
    else:
        raise FileNotFoundError(f"No safetensors weights in {model_path}")

    def place(t):
        return t.to(device=device, dtype=dtype)

    params: dict = {"layers": [dict() for _ in range(cfg.num_hidden_layers)]}
    for shard in shards:
        with SafeTensorsReader(model_path / shard) as reader:
            for name in reader.keys():
                arr = reader.get_tensor(name)
                if name == "model.embed_tokens.weight":
                    params["embed_tokens"] = place(arr)
                elif name == "model.norm.weight":
                    params["norm"] = place(arr)
                elif name == "lm_head.weight":
                    params["lm_head"] = place(arr)
                elif name.startswith("model.layers."):
                    parts = name.split(".")
                    key = _LAYER_WEIGHTS.get(".".join(parts[3:]))
                    if key is None:
                        raise NotImplementedError(
                            f"weight {name} belongs to a feature not ported yet"
                        )
                    if quant_bits and key in _QUANTIZABLE:
                        w = {k: v.to(device) for k, v in quantize(arr, quant_bits).items()}
                    else:
                        w = place(arr)
                    params["layers"][int(parts[2])][key] = w
                else:
                    logger.warning("Skipping unknown weight %s", name)

    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    missing = [i for i, layer in enumerate(params["layers"]) if set(layer) != set(_LAYER_WEIGHTS.values())]
    if missing or "embed_tokens" not in params or "norm" not in params:
        raise ValueError(
            f"Checkpoint at {model_path} is incomplete "
            f"(embed/norm or layers {missing[:4]})"
        )
    if not cfg.tie_word_embeddings and "lm_head" not in params:
        raise ValueError(f"Checkpoint at {model_path} has no lm_head.weight")
    return params
