"""Merge orchestration base (counterpart of shardmerge_tpu/merge/base.py).

Per tensor: a CPU view of the shard file -> one copy to the merge device ->
f32 deltas -> the engine's reduction -> ``base + delta`` -> bf16 -> host ->
writer. Every tensor merges on the one device the engine was given; the JAX
package's size-based routing to the host (``small_tensor_numel``,
``huge_tensor_numel``) exists for TPU compile cost and a 16 GB chip and has
no counterpart here.
"""

from __future__ import annotations

import logging
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

import torch

from ..config import MergeConfig, MergeModel
from ..io.index import OfflineMultiModelIndex
from ..io.writer import ModelWriter, ShardLayer
from ..ops.profiling import MergeStats, phase_profiler

logger = logging.getLogger(__name__)


class MergeTensorsBase(ABC):
    """Merges finetuned models by computing and combining their deltas."""

    def __init__(
        self,
        config: MergeConfig,
        index_manager: Optional[OfflineMultiModelIndex] = None,
        *,
        device,
    ):
        self.config = config
        self.index_manager = (
            index_manager if index_manager is not None else OfflineMultiModelIndex()
        )
        self.device = torch.device(device)
        self.stats = MergeStats()
        # wall seconds per merged tensor, merge through write staging
        self.tensor_seconds: Dict[str, float] = {}
        # (model_uri, tensor_name) -> tensor already on the device for the
        # layer being merged: a shared base is copied once, not per delta
        self._placed: dict = {}

    @abstractmethod
    def get_readme(self) -> str:
        """README text for the output model."""

    @abstractmethod
    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        """The merged tensor for one layer (on the device or the host)."""

    def _fetch(self, model_uri: str, tensor_name: str) -> torch.Tensor:
        """The tensor on the merge device, copied once per layer."""
        key = (model_uri, tensor_name)
        cached = self._placed.get(key)
        if cached is not None:
            self.stats.h2d_dedup_hits += 1
            return cached
        t0 = time.perf_counter()
        host = self.index_manager.get_tensor(model_uri, tensor_name)
        t1 = time.perf_counter()
        placed = host.to(self.device)
        self.stats.span_fetch_s += t1 - t0
        self.stats.span_h2d_s += time.perf_counter() - t1
        self.stats.h2d_bytes += host.numel() * host.element_size()
        self._placed[key] = placed
        return placed

    def get_base_output_tensor(self, shard_layer: ShardLayer) -> torch.Tensor:
        """Output-base tensor in f32."""
        t = self._fetch(self.config.output_base_model, shard_layer.layer_name)
        return t.to(torch.float32)

    def _passthrough(self, shard_layer: ShardLayer, which: str) -> torch.Tensor:
        """Input/output layer passthrough: the first model flagged
        is_input/is_output, else the base (host copy, never merged)."""
        flag = "is_input" if which == "input" else "is_output"
        chosen = next(
            (m for m in self.config.finetune_merge if getattr(m, flag)), None
        )
        if chosen is None:
            chosen = MergeModel(
                model=self.config.output_base_model,
                base=self.config.output_base_model,
            )
        logger.info(
            "Passthrough - %s is an %s layer, using %s",
            shard_layer.layer_name,
            which,
            chosen.model,
        )
        return self.index_manager.get_tensor(chosen.model, shard_layer.layer_name)

    def initialize(self):
        """Register every model and require identical key sets."""
        self.index_manager.add_model(self.config.output_base_model)
        self.index_doc = self.index_manager.get_index(self.config.output_base_model)
        for model in self.config.finetune_merge:
            for ref in (model.base, model.model):
                if ref not in self.index_manager:
                    self.index_manager.add_model(ref)
        base_keys = self.index_manager.get_model_keys(self.config.output_base_model)
        for model in self.config.finetune_merge:
            model_keys = self.index_manager.get_model_keys(model.model)
            if model_keys != base_keys:
                raise ValueError(
                    f"Model {model.model} architecture mismatch with base model "
                    f"{self.config.output_base_model}\n"
                    f"Missing keys: {base_keys - model_keys}\n"
                    f"Extra keys: {model_keys - base_keys}"
                )

    def merge(self) -> MergeStats:
        """Run the whole merge; tensors already in the output are skipped."""
        self.initialize()
        layer_order = self.index_manager.get_layer_order(self.config.output_base_model)
        writer = ModelWriter(
            base_index=self.index_doc,
            output_path=self.config.output_path,
            layer_order=layer_order,
            output_astype=self.config.output_astype,
        )
        for shard_layers in writer.shard_layers():
            self._process_layers(writer, [sl for sl in shard_layers if not sl.written])
        writer.finalize()
        (self.config.output_path / "README.md").write_text(self.get_readme())
        logger.info("Merge complete. Output saved to %s", self.config.output_path)
        logger.info("Merge stats: %s", self.stats.summary())
        return self.stats

    def _process_layers(self, writer: ModelWriter, shard_layers: List[ShardLayer]):
        for shard_layer in shard_layers:
            name = shard_layer.layer_name
            t0 = time.perf_counter()
            try:
                with phase_profiler(f"merge {name}", device=self.device):
                    out = self._merge_layer(shard_layer)
                t1 = time.perf_counter()
                self._check_deferred(name)
                host = out.to("cpu")
                writer.add_tensor(name, host)
            except Exception as e:
                logger.error("Error processing %s: %s", name, e)
                raise
            t2 = time.perf_counter()
            self.stats.span_merge_s += t1 - t0
            self.stats.span_flush_s += t2 - t1
            self.stats.tensors_merged += 1
            self.stats.bytes_written += host.numel() * host.element_size()
            self.tensor_seconds[name] = t2 - t0
            self._evict_layer(name)

    def _check_deferred(self, layer_name: str):
        """Hook for engines that check device-side flags at write time."""

    def _evict_layer(self, tensor_name: str):
        """Drop the layer's device copies and host views."""
        for key in [k for k in self._placed if k[1] == tensor_name]:
            del self._placed[key]
        models = {self.config.output_base_model}
        for m in self.config.finetune_merge:
            models.update((m.model, m.base))
        for model in models:
            self.index_manager.release_tensor(model, tensor_name)
