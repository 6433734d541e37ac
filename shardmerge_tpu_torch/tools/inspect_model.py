"""Model inspection and comparison (counterpart of
shardmerge_tpu/tools/inspect_model.py).

- ``inspect_model``: shards, tensor count, dtype histogram, total size and
  layer count of a safetensors model directory.
- ``compare_models``: per-tensor max/mean absolute and relative error of
  two models, worst first: the check after a merge.

Dtypes are named as numpy names them (``bfloat16``, ``float32``) and the
error statistics are taken in f32 numpy, so both print and return what the
JAX tool does.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.safetensors_io import SafeTensorsReader

__all__ = ["inspect_model", "compare_models"]


def _iter_tensors(model_dir: Path):
    """(name, shard, reader) across all shards of a model directory."""
    model_dir = Path(model_dir)
    index_path = model_dir / "model.safetensors.index.json"
    if index_path.exists():
        shards = sorted(set(json.loads(index_path.read_text())["weight_map"].values()))
    else:
        shards = sorted(p.name for p in model_dir.glob("*.safetensors"))
    for shard in shards:
        with SafeTensorsReader(model_dir / shard) as reader:
            for name in reader.keys():
                yield name, shard, reader


def inspect_model(model_dir) -> dict:
    """Return (and print) a structural summary of a model directory."""
    model_dir = Path(model_dir)
    dtypes: Counter = Counter()
    shards: Counter = Counter()
    total_bytes = 0
    n_tensors = 0
    layers = set()
    for name, shard, reader in _iter_tensors(model_dir):
        n_tensors += 1
        dtypes[str(reader.get_tensor(name).dtype).removeprefix("torch.")] += 1
        nbytes = reader.nbytes(name)
        total_bytes += nbytes
        shards[shard] += nbytes
        if name.startswith("model.layers."):
            layers.add(int(name.split(".")[2]))
    summary = {
        "model_dir": str(model_dir),
        "tensors": n_tensors,
        "total_gib": round(total_bytes / 2**30, 3),
        "dtypes": dict(dtypes),
        "num_layers": len(layers),
        "shards": {k: round(v / 2**30, 3) for k, v in sorted(shards.items())},
    }
    print(f"Model: {model_dir}")
    print(f"  tensors: {n_tensors}  layers: {len(layers)}  size: {summary['total_gib']} GiB")
    print(f"  dtypes: {summary['dtypes']}")
    for shard, gib in summary["shards"].items():
        print(f"  {shard}: {gib} GiB")
    return summary


def compare_models(dir_a, dir_b, top: int = 10) -> Tuple[List[dict], List[str], List[str]]:
    """Tensor-wise comparison of two model directories: (per-tensor stats
    sorted by max relative error, worst first; names only in A; names only
    in B), with a printed report."""

    def load_map(d):
        return {name: (shard, Path(d)) for name, shard, _ in _iter_tensors(Path(d))}

    map_a, map_b = load_map(dir_a), load_map(dir_b)
    only_a = sorted(set(map_a) - set(map_b))
    only_b = sorted(set(map_b) - set(map_a))
    common = sorted(set(map_a) & set(map_b))

    stats: List[dict] = []
    readers: Dict[Tuple[Path, str], SafeTensorsReader] = {}

    def get(dirpath, shard, name) -> torch.Tensor:
        key = (dirpath, shard)
        if key not in readers:
            readers[key] = SafeTensorsReader(dirpath / shard)
        return readers[key].get_tensor(name)

    for name in common:
        shard_a, da = map_a[name]
        shard_b, db = map_b[name]
        ta, tb = get(da, shard_a, name), get(db, shard_b, name)
        if ta.shape != tb.shape:
            stats.append({"name": name, "shape_mismatch": (tuple(ta.shape), tuple(tb.shape))})
            continue
        fa = ta.to(torch.float32).numpy()
        fb = tb.to(torch.float32).numpy()
        diff = np.abs(fa - fb)
        scale = float(np.abs(fb).max()) or 1.0
        stats.append({
            "name": name,
            "max_abs": float(diff.max()),
            "mean_abs": float(diff.mean()),
            "max_rel": float(diff.max()) / scale,
            "identical": bool((diff == 0).all()),
        })
    for reader in readers.values():
        reader.close()

    stats.sort(key=lambda s: s.get("max_rel", float("inf")), reverse=True)
    identical = sum(1 for s in stats if s.get("identical"))
    print(f"Compared {len(common)} tensors: {identical} bit-identical, "
          f"{len(only_a)} only in A, {len(only_b)} only in B")
    for s in stats[:top]:
        if "shape_mismatch" in s:
            print(f"  {s['name']}: SHAPE MISMATCH {s['shape_mismatch']}")
        elif not s["identical"]:
            print(f"  {s['name']}: max_abs={s['max_abs']:.3e} mean_abs={s['mean_abs']:.3e} max_rel={s['max_rel']:.3e}")
    if only_a:
        print(f"  only in A: {only_a[:5]}{'...' if len(only_a) > 5 else ''}")
    if only_b:
        print(f"  only in B: {only_b[:5]}{'...' if len(only_b) > 5 else ''}")
    return stats, only_a, only_b
