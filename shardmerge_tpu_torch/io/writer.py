"""Output writer mirroring the base model's shard layout (counterpart of
shardmerge_tpu/io/writer.py).

The output directory gets a copy of the base's ``model.safetensors.index.json``
(same shard file names, ``weight_map`` and ``metadata.total_size``), and each
shard file is written ONCE, when its last tensor arrives. Existing shards are
validated and their tensors marked written, which is what makes a merge
resumable.

``write_through=True`` rewrites a tensor's shard as soon as the tensor
arrives, merged with what is already on disk (a cut merge then loses at most
the tensors in flight, at the cost of rewriting the shard per tensor).
``read_only=True`` (a dry run's plan, a merge rank other than rank 0)
creates and writes nothing: no directory, no index, no shard; its tensors
are only marked written. ``background_flush=True`` writes shards on one worker thread, so file IO
overlaps the merge; ``drain``/``finalize`` wait for it. A save that fails
drops the file and unmarks its staged tensors, and ``finalize`` reports them
missing.
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Generator, List, Set

import torch

from ..constants import INPUT_LAYER, OUTPUT_LAYER
from .safetensors_io import SafeTensorsReader, save_file

logger = logging.getLogger(__name__)

__all__ = ["ShardLayer", "ModelWriter"]


@dataclass
class ShardLayer:
    layer_order_idx: int
    shard_name: str
    layer_name: str
    written: bool

    @property
    def layer_number(self) -> int:
        """embed_tokens -> INPUT_LAYER, model.norm/lm_head -> OUTPUT_LAYER,
        model.layers.N -> N, anything else raises."""
        if self.layer_name.startswith("model.embed_tokens.weight"):
            return INPUT_LAYER
        if self.layer_name.startswith(("model.norm.weight", "lm_head.weight")):
            return OUTPUT_LAYER
        if self.layer_name.startswith("model.layers."):
            part = self.layer_name.split(".")[2]
            if str(int(part)) == part:
                return int(part)
        raise ValueError(f"Unknown layer name: {self.layer_name}")


@dataclass
class ModelWriter:
    base_index: dict
    output_path: Path
    layer_order: List[str]
    output_astype: torch.dtype = torch.bfloat16
    write_through: bool = False
    background_flush: bool = False
    read_only: bool = False
    written_shard_layers: Set[tuple] = field(default_factory=set)
    shard_to_tensors: Dict[str, Set[str]] = field(default_factory=dict)

    def __post_init__(self):
        self.output_path = Path(self.output_path)
        if not self.read_only:
            self.output_path.mkdir(parents=True, exist_ok=True)
        # guards written_shard_layers and _pending: the flush thread unmarks
        # tensors of a failed save while add_tensor stages on the merge
        # thread; never held across file IO
        self._state_lock = threading.Lock()
        # one worker: a shard may be rewritten repeatedly (write_through)
        self._executor = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="shard-flush")
            if self.background_flush
            else None
        )
        self._flush_futures: List[Future] = []
        self.index_path = self.output_path / "model.safetensors.index.json"
        if self.index_path.exists():
            logger.info("Index already exists: %s", self.index_path)
            self.base_index = json.loads(self.index_path.read_text())
        elif not self.read_only:
            self.index_path.write_text(json.dumps(self.base_index, indent=2))
        self.shard_to_tensors = {}
        for tensor_name, shard_name in self.base_index["weight_map"].items():
            self.shard_to_tensors.setdefault(shard_name, set()).add(tensor_name)
        self._pending: Dict[str, Dict[str, torch.Tensor]] = {}
        self._check_existing_shards()

    def _check_existing_shards(self):
        for shard_name, tensor_names in self.shard_to_tensors.items():
            shard_path = self.output_path / shard_name
            if not shard_path.exists():
                continue
            with SafeTensorsReader(shard_path) as reader:
                for layer in reader.keys():
                    if layer not in tensor_names:
                        raise ValueError(
                            f"Tensor {layer} found in {shard_path} but not in "
                            "base model"
                        )
                    self.written_shard_layers.add((shard_name, layer))

    def add_tensor(self, layer_name: str, tensor: torch.Tensor):
        """Stage a merged CPU tensor; its shard is written once complete
        (or at once with ``write_through``)."""
        shard_name = self.base_index["weight_map"][layer_name]
        with self._state_lock:
            already = (shard_name, layer_name) in self.written_shard_layers
        if already:
            logger.info("Skipping %s: already in written shard %s", layer_name, shard_name)
            return
        t = tensor.detach().to("cpu")
        if t.dtype != self.output_astype:
            t = t.to(self.output_astype)
        with self._state_lock:
            self._pending.setdefault(shard_name, {})[layer_name] = t
            self.written_shard_layers.add((shard_name, layer_name))
            done = all(
                (shard_name, name) in self.written_shard_layers
                for name in self.shard_to_tensors[shard_name]
            )
        if self.write_through or done:
            self._flush_shard(shard_name)

    def _flush_shard(self, shard_name: str):
        with self._state_lock:
            staged = self._pending.pop(shard_name, {})
        if self.read_only:
            return
        if self._executor is None:
            self._save(shard_name, staged)
        else:
            self._flush_futures.append(
                self._executor.submit(self._save, shard_name, staged)
            )

    def _save(self, shard_name: str, staged: Dict[str, torch.Tensor]):
        shard_path = self.output_path / shard_name
        tensors: Dict[str, torch.Tensor] = {}
        if shard_path.exists():  # resume / write_through: keep what is on disk
            with SafeTensorsReader(shard_path) as reader:
                for name in reader.keys():
                    tensors[name] = reader.get_tensor(name, copy=True)
        tensors.update(staged)
        ordered = {n: tensors[n] for n in self.layer_order if n in tensors}
        try:
            save_file(ordered, shard_path, metadata={"format": "pt"})
            logger.info("Wrote shard %s (%d tensors)", shard_name, len(ordered))
        except Exception as e:
            # drop the corrupt file and unmark the tensors; finalize() then
            # reports the run incomplete
            logger.error("Error saving shard %s: %s", shard_name, e)
            if shard_path.exists():
                shard_path.unlink()
            with self._state_lock:
                for name in staged:
                    self.written_shard_layers.discard((shard_name, name))

    def drain(self):
        """Wait for the shard writes in flight (raising a worker's error)."""
        futures, self._flush_futures = self._flush_futures, []
        for future in futures:
            future.result()

    def close(self):
        """Wait for the shard writes in flight and stop the flush thread."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def finalize(self):
        """Raise unless every tensor of the index was written."""
        self.drain()
        with self._state_lock:
            missing = [
                (shard, name)
                for shard, names in self.shard_to_tensors.items()
                for name in names
                if (shard, name) not in self.written_shard_layers
            ]
        if missing:
            logger.error("Failed to write all layers. Missing: %s", missing)
            raise RuntimeError(
                f"Incomplete model output: missing {len(missing)} layers"
            )

    def shard_layers(self) -> Generator[List[ShardLayer], None, None]:
        """Per-shard lists of ShardLayer in ``layer_order``, shards sorted
        by name."""
        position = {name: i for i, name in enumerate(self.layer_order)}
        for shard_name, tensors in sorted(self.shard_to_tensors.items()):
            yield [
                ShardLayer(
                    position[name],
                    shard_name,
                    name,
                    (shard_name, name) in self.written_shard_layers,
                )
                for name in sorted(tensors, key=position.__getitem__)
            ]

    @classmethod
    def from_huggingface(cls, model_id: str, output_path, layer_order: List[str], revision: str = "main",
                         output_astype: torch.dtype = torch.bfloat16, write_through: bool = False,
                         token=None) -> "ModelWriter":
        """A writer over a Hub model's index, its config files (not its
        weights) downloaded into ``output_path`` first; ``token``
        authenticates gated or private repos."""
        from huggingface_hub import snapshot_download

        from .download import resolve_hf_token

        output_path = Path(output_path)
        output_path.mkdir(parents=True, exist_ok=True)
        snapshot_download(
            repo_id=model_id,
            revision=revision,
            ignore_patterns=["*.bin", "*.safetensors", "*.msgpack"],
            local_dir=output_path,
            token=resolve_hf_token(token),
        )
        index_path = output_path / "model.safetensors.index.json"
        if not index_path.exists():
            raise FileNotFoundError(f"Model index not found at {index_path}")
        return cls(
            base_index=json.loads(index_path.read_text()),
            output_path=output_path,
            layer_order=layer_order,
            output_astype=output_astype,
            write_through=write_through,
        )
