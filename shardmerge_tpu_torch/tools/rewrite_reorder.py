"""Reorder tensors into canonical transformer order and reshard
(counterpart of shardmerge_tpu/tools/rewrite_reorder.py).

``transformer_sort_key`` orders embeddings, then each decoder layer's
components (norm, q/k/v/o, norm, MLP, with the alternative namings), then
the final norm and the head; ``reshard_and_reorder`` assigns tensors in
that order greedily to size-balanced shards, names them for the count
actually used and writes a sorted index. Tensors stay views of their
input shards until each output shard is written.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional

from ..io.safetensors_io import SafeTensorsReader, save_file

__all__ = ["transformer_sort_key", "reshard_and_reorder"]

# Component priorities within a decoder layer (lower = earlier); includes the
# reference's alternative-naming aliases.
_COMPONENT_ORDER = {
    "input_layernorm": 0,
    "self_attn.q_proj": 1,
    "self_attn.k_proj": 2,
    "self_attn.v_proj": 3,
    "self_attn.o_proj": 4,
    "post_attention_layernorm": 5,
    "mlp.gate_proj": 6,
    "mlp.up_proj": 7,
    "mlp.down_proj": 8,
    "mlp.fc_in": 6,
    "mlp.fc_out": 7,
    "attention.wq": 1,
    "attention.wk": 2,
    "attention.wv": 3,
    "attention.wo": 4,
    "ffn_norm": 5,
    "feed_forward.w1": 6,
    "feed_forward.w3": 7,
    "feed_forward.w2": 8,
}
_LAYER_TYPE_ORDER = {
    "model.embed_tokens": 0,
    "tok_embeddings": 0,
    "model.layers": 1,
    "layers": 1,
    "model.norm": 2,
    "norm": 2,
    "lm_head": 3,
    "output": 3,
}
_MAX_LAYER_TYPE = max(_LAYER_TYPE_ORDER.values()) + 1
_MAX_COMPONENT = max(_COMPONENT_ORDER.values()) + 1


def transformer_sort_key(tensor_name: str):
    """Sort key: embeddings -> per-layer (ln, qkvo, ln, mlp) -> norm -> head."""
    parts = tensor_name.split(".")

    layer_type_key = ""
    if parts[0] == "model" and len(parts) > 1:
        if parts[1] in ("embed_tokens", "layers", "norm"):
            layer_type_key = f"model.{parts[1]}"
    elif parts[0] in _LAYER_TYPE_ORDER:
        layer_type_key = parts[0]
    else:
        layer_type_key = parts[0]
    layer_type_priority = _LAYER_TYPE_ORDER.get(layer_type_key, _MAX_LAYER_TYPE)

    layer_num = -1
    component_idx = -1
    dots = layer_type_key.count(".")
    if (
        "layers" in layer_type_key
        and len(parts) > dots + 1
        and parts[dots + 1].isdigit()
    ):
        layer_num = int(parts[dots + 1])
        component_idx = dots + 2
    elif len(parts) > 2 and parts[1] == "layer" and parts[2].isdigit():
        layer_num = int(parts[2])
        component_idx = 3

    component_priority = _MAX_COMPONENT
    sub_component = ""
    if component_idx != -1 and len(parts) > component_idx:
        match = ""
        for i in range(component_idx, len(parts) - 1):
            key = ".".join(parts[component_idx : i + 1])
            if key in _COMPONENT_ORDER:
                match = key
        if match:
            component_priority = _COMPONENT_ORDER[match]
        else:
            sub_component = ".".join(parts[component_idx:])
    elif layer_type_priority not in (_MAX_LAYER_TYPE, 0):
        sub_component = ".".join(parts[dots + 1 :])

    qualifier = parts[-1] if len(parts) > 1 else ""
    return (
        layer_type_priority,
        layer_num,
        component_priority,
        sub_component,
        qualifier,
        tensor_name,
    )


_AUX_FILES = [
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "tokenizer.model",
]


def balanced_shards(sorted_names: List[str], sizes: Dict[str, int], num_shards: int):
    """Greedy size-balanced assignment: advance to the next shard when the
    tensor would take the current one past total/num_shards. Returns the
    non-empty name lists and their byte sizes."""
    target = sum(sizes.values()) / num_shards
    assignments: List[List[str]] = [[] for _ in range(num_shards)]
    shard_sizes = [0] * num_shards
    current = 0
    for name in sorted_names:
        size = sizes[name]
        if shard_sizes[current] > 0 and shard_sizes[current] + size > target and current < num_shards - 1:
            current += 1
        assignments[current].append(name)
        shard_sizes[current] += size
    kept = [i for i, a in enumerate(assignments) if a]
    return [assignments[i] for i in kept], [shard_sizes[i] for i in kept]


def reshard_and_reorder(input_dir, output_dir, num_shards: Optional[int] = None):
    """Rewrite a model directory with canonically ordered, size-balanced shards."""
    input_path, output_path = Path(input_dir), Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    shard_files = sorted(input_path.glob("*.safetensors"))
    if not shard_files:
        raise FileNotFoundError(f"No .safetensors files found in {input_path}")

    readers = [SafeTensorsReader(f) for f in shard_files]
    locations: Dict[str, SafeTensorsReader] = {}
    sizes: Dict[str, int] = {}
    for reader in readers:
        for key in reader.keys():
            if key in locations:
                print(f"Warning: Duplicate tensor key {key!r} found. Overwriting.")
            locations[key] = reader
            sizes[key] = reader.nbytes(key)
    total_size = sum(sizes.values())
    print(f"Loaded {len(locations)} tensors. Total size: {total_size / 1024**3:.2f} GB")

    if num_shards is None:
        num_shards = max(1, len(shard_files))
    if num_shards <= 0:
        raise ValueError("Number of shards must be positive")
    sorted_names = sorted(locations.keys(), key=transformer_sort_key)
    groups, group_sizes = balanced_shards(sorted_names, sizes, num_shards)
    actual = len(groups)
    weight_map: Dict[str, str] = {}
    for i, (names, nbytes) in enumerate(zip(groups, group_sizes)):
        filename = f"model-{i + 1:05d}-of-{actual:05d}.safetensors"
        save_file({name: locations[name].get_tensor(name) for name in names}, output_path / filename,
                  metadata={"format": "pt"})
        for name in names:
            weight_map[name] = filename
        print(f"  Saved {filename} ({len(names)} tensors, {nbytes / 1024**2:.2f} MB)")

    index = {
        "metadata": {"total_size": total_size, "num_shards_requested": num_shards, "num_shards_actual": actual},
        "weight_map": {name: weight_map[name] for name in sorted_names},
    }
    with open(output_path / "model.safetensors.index.json", "w") as f:
        json.dump(index, f, indent=2)
    for filename in _AUX_FILES:
        src = input_path / filename
        if src.is_file():
            shutil.copyfile(src, output_path / filename)
            print(f"  Copied {filename}")
    for reader in readers:
        reader.close()
    print(f"Resharding complete: {actual} shards in {output_path}")
