"""Multi-model index over local checkpoint directories (counterpart of
shardmerge_tpu/io/index.py, offline half).

Tensors resolve to zero-copy CPU views of the shard files (see
safetensors_io); the merge engine moves each one to its device once.
``preload_tensor`` reads a tensor ahead into an owned (optionally pinned)
host copy from a worker thread; ``get_tensor`` then returns that copy (the
caller tracks reads in flight and waits for them). Only local
directories are supported in this port: a Hub reference, a PEFT adapter or
a GPTQ/AWQ checkpoint raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

import torch

from .safetensors_io import SafeTensorsReader

logger = logging.getLogger(__name__)

__all__ = ["OfflineMultiModelIndex", "ordered_weights", "require_local"]


def require_local(refs: Iterable[str]) -> None:
    """Raise unless every model reference is an existing local directory."""
    remote = sorted(r for r in set(refs) if not Path(r).is_dir())
    if remote:
        raise NotImplementedError(
            f"model references {remote} are not local directories; "
            "HuggingFace Hub references are not ported yet"
        )


def ordered_weights(weight_map: Dict[str, str]) -> List[str]:
    """Canonical weight order: embed_tokens, per-layer components (sorted
    within each layer), model.norm, lm_head, then everything else sorted
    (the JAX package's ``ordered_weights``)."""
    weights = list(weight_map.keys())
    embed = sorted(w for w in weights if "embed_tokens" in w)
    layer_weights = [w for w in weights if "layers." in w]
    norm = sorted(w for w in weights if "model.norm.weight" in w)
    lm_head = sorted(w for w in weights if "lm_head" in w)
    special = set(embed + layer_weights + norm + lm_head)
    other = sorted(w for w in weights if w not in special)

    per_layer: Dict[int, List[str]] = {}
    for w in layer_weights:
        per_layer.setdefault(int(w.split("layers.")[1].split(".")[0]), []).append(w)
    layers = [w for n in sorted(per_layer) for w in sorted(per_layer[n])]

    result = embed + layers + norm + lm_head + other
    if set(result) != set(weights):
        raise ValueError(
            f"Weight ordering mismatch! Missing: {set(weights) - set(result)}, "
            f"Extra: {set(result) - set(weights)}"
        )
    return result


def _single_file_index(model_path: Path) -> dict:
    """A one-shard index for a single ``model.safetensors`` checkpoint,
    built from its header alone."""
    shard = "model.safetensors"
    with SafeTensorsReader(model_path / shard) as reader:
        names = list(reader.keys())
        total = sum(reader.nbytes(n) for n in names)
    return {
        "metadata": {"total_size": total},
        "weight_map": {name: shard for name in names},
    }


class OfflineMultiModelIndex:
    """Index over local model directories; a model is known by its
    directory name and by the path strings used to add it."""

    def __init__(self):
        self.model_indexes: Dict[str, dict] = {}
        self.model_paths: Dict[str, Path] = {}
        self._ordered: Dict[str, List[str]] = {}
        self._aliases: Dict[str, str] = {}
        self._readers: Dict[Path, SafeTensorsReader] = {}
        self._tensor_cache: Dict[Tuple[str, str], torch.Tensor] = {}
        # guards the two dicts above (worker threads preload while the merge
        # thread reads and releases)
        self._lock = threading.Lock()

    def _resolve(self, model_id) -> str:
        return self._aliases.get(str(model_id), str(model_id))

    def add_model(self, model_path) -> None:
        model_path = Path(model_path)
        if not model_path.is_dir():
            raise NotADirectoryError(
                f"Provided model path is not a directory: {model_path}"
            )
        model_id = model_path.name
        if model_id in self.model_indexes:
            logger.warning("Model %r already added. Skipping.", model_id)
        else:
            index_path = model_path / "model.safetensors.index.json"
            if index_path.exists():
                try:
                    index = json.loads(index_path.read_text())
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"Failed to parse index file {index_path}: {e}"
                    ) from e
            elif (model_path / "model.safetensors").exists():
                index = _single_file_index(model_path)
            elif (model_path / "adapter_config.json").exists():
                raise NotImplementedError(
                    f"{model_path} is a PEFT adapter; adapters are not ported yet"
                )
            else:
                raise FileNotFoundError(
                    "Neither 'model.safetensors.index.json' nor "
                    f"'model.safetensors' found in {model_path}"
                )
            cfg_file = model_path / "config.json"
            if cfg_file.is_file():
                qc = json.loads(cfg_file.read_text()).get("quantization_config")
                if qc:
                    raise NotImplementedError(
                        f"{model_path} is a quantized checkpoint "
                        f"({qc.get('quant_method')}); not ported yet"
                    )
            if "weight_map" not in index:
                raise ValueError(f"Index for {model_id!r} missing 'weight_map' key")
            self.model_indexes[model_id] = index
            self.model_paths[model_id] = model_path
            self._ordered[model_id] = ordered_weights(index["weight_map"])
            logger.info(
                "Initialized %d shards for model %s",
                len(set(index["weight_map"].values())),
                model_id,
            )
        for alias in (model_id, str(model_path), str(model_path.resolve())):
            self._aliases[alias] = model_id

    def _known(self, model_id) -> str:
        resolved = self._resolve(model_id)
        if resolved not in self.model_indexes:
            raise KeyError(f"Model {model_id} not found in index")
        return resolved

    def get_layer_order(self, model_id) -> List[str]:
        return list(self._ordered[self._known(model_id)])

    def get_model_keys(self, model_id) -> Set[str]:
        return set(self.model_indexes[self._known(model_id)]["weight_map"])

    def get_index(self, model_id) -> dict:
        return self.model_indexes[self._known(model_id)]

    def _reader(self, model_id: str, tensor_name: str) -> SafeTensorsReader:
        weight_map = self.model_indexes[model_id]["weight_map"]
        if tensor_name not in weight_map:
            raise KeyError(f"Tensor {tensor_name!r} not found in model {model_id!r}")
        shard_path = self.model_paths[model_id] / weight_map[tensor_name]
        with self._lock:
            reader = self._readers.get(shard_path)
            if reader is None:
                if not shard_path.exists():
                    raise FileNotFoundError(f"Shard file not found: {shard_path}")
                reader = self._readers[shard_path] = SafeTensorsReader(shard_path)
        return reader

    def _view(self, model_id: str, tensor_name: str) -> torch.Tensor:
        return self._reader(model_id, tensor_name).get_tensor(tensor_name)

    def advise_tensor(self, model_id, tensor_name: str) -> None:
        """Start the kernel's read of the tensor's bytes without copying them
        (read-ahead for a tensor that is only passed through to the writer,
        which reads its shard-file view)."""
        model_id = self._known(model_id)
        self._reader(model_id, tensor_name).advise(tensor_name)

    def get_tensor(self, model_id, tensor_name: str) -> torch.Tensor:
        """The tensor on the host (cached until :meth:`release_tensor`): the
        copy a read-ahead made, else a CPU view of its shard file."""
        model_id = self._known(model_id)
        key = (model_id, tensor_name)
        with self._lock:
            cached = self._tensor_cache.get(key)
        if cached is not None:
            return cached
        tensor = self._view(model_id, tensor_name)
        with self._lock:
            return self._tensor_cache.setdefault(key, tensor)

    def preload_tensor(self, model_id, tensor_name: str, *, pin_memory: bool = False) -> torch.Tensor:
        """Read the tensor into an owned host copy (page-locked with
        ``pin_memory``, for asynchronous copies to a card) and cache it; safe
        to call from worker threads. A cached tensor is returned as it is;
        of two reads of one tensor at once, the first cached wins."""
        model_id = self._known(model_id)
        key = (model_id, tensor_name)
        with self._lock:
            cached = self._tensor_cache.get(key)
        if cached is not None:
            return cached
        view = self._view(model_id, tensor_name)
        host = torch.empty(view.shape, dtype=view.dtype, pin_memory=pin_memory)
        host.copy_(view)
        with self._lock:
            return self._tensor_cache.setdefault(key, host)

    def release_tensor(self, model_id, tensor_name: str) -> None:
        with self._lock:
            self._tensor_cache.pop((self._resolve(model_id), tensor_name), None)

    def close(self) -> None:
        with self._lock:
            self._tensor_cache.clear()
            for reader in self._readers.values():
                reader.close()
            self._readers.clear()

    def __contains__(self, model_id) -> bool:
        return self._resolve(model_id) in self.model_indexes
