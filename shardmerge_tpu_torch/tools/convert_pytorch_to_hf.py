"""Convert PyTorch ``.bin`` checkpoints to sharded safetensors (counterpart
of shardmerge_tpu/tools/convert_pytorch_to_hf.py).

Sharded ``pytorch_model-*.bin`` files become same-named safetensors under
the existing index's layout; a single ``pytorch_model.bin`` becomes N
shards in canonical transformer order, size-balanced as
``rewrite_reorder`` balances them. Files are read with
``torch.load(weights_only=True)``; bf16 stays bf16.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from ..io.safetensors_io import save_file
from .rewrite_reorder import balanced_shards, transformer_sort_key

__all__ = ["convert"]


def _load(path: Path) -> dict:
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return {name: t.detach().contiguous() for name, t in state_dict.items()}


def _convert_sharded(input_dir: Path, output_dir: Path):
    """pytorch_model-XXXXX-of-YYYYY.bin shards -> same-named safetensors,
    keeping the index's layout."""
    index = json.loads((input_dir / "pytorch_model.bin.index.json").read_text())
    bin_to_st = {}
    new_weight_map = {}
    for tensor_name, bin_file in index["weight_map"].items():
        st_file = bin_file.replace("pytorch_model", "model").replace(".bin", ".safetensors")
        bin_to_st[bin_file] = st_file
        new_weight_map[tensor_name] = st_file
    for bin_file, st_file in sorted(bin_to_st.items()):
        print(f"Converting {bin_file} -> {st_file}")
        save_file(_load(input_dir / bin_file), output_dir / st_file, metadata={"format": "pt"})
    new_index = {"metadata": index.get("metadata", {}), "weight_map": new_weight_map}
    with open(output_dir / "model.safetensors.index.json", "w") as f:
        json.dump(new_index, f, indent=2)
    print(f"Converted {len(bin_to_st)} shards")


def _convert_single(bin_path: Path, output_dir: Path, num_shards: int):
    """A single pytorch_model.bin -> N sorted, size-balanced shards."""
    tensors = _load(bin_path)
    sorted_names = sorted(tensors.keys(), key=transformer_sort_key)
    sizes = {name: tensors[name].numel() * tensors[name].element_size() for name in sorted_names}
    groups, _ = balanced_shards(sorted_names, sizes, num_shards)
    actual = len(groups)
    weight_map = {}
    for i, names in enumerate(groups):
        filename = f"model-{i + 1:05d}-of-{actual:05d}.safetensors"
        save_file({name: tensors[name] for name in names}, output_dir / filename, metadata={"format": "pt"})
        for name in names:
            weight_map[name] = filename
        print(f"  Saved {filename} ({len(names)} tensors)")
    index = {
        "metadata": {"total_size": sum(sizes.values())},
        "weight_map": {name: weight_map[name] for name in sorted_names},
    }
    with open(output_dir / "model.safetensors.index.json", "w") as f:
        json.dump(index, f, indent=2)
    print(f"Converted {bin_path.name} into {actual} shards")


def convert(input_path, output_dir, num_shards: Optional[int] = None):
    """Convert a .bin checkpoint (file or directory) to safetensors shards."""
    input_path, output_dir = Path(input_path), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if input_path.is_dir():
        if (input_path / "pytorch_model.bin.index.json").exists():
            _convert_sharded(input_path, output_dir)
            return
        single = input_path / "pytorch_model.bin"
        if not single.exists():
            raise FileNotFoundError(f"No pytorch_model.bin or pytorch_model.bin.index.json in {input_path}")
        input_path = single
    _convert_single(input_path, output_dir, num_shards or 1)
