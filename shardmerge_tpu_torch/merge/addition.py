"""Delta-addition merge (counterpart of shardmerge_tpu/merge/addition.py):
``out = sum_m(ft_m - output base)`` in f32, in config order.

Kept from the reference tool (REF-QUIRK): the base is not added back
(``add_base=True`` adds it), alphas and layer gates do not apply, and every
tensor is merged, the input/output layers included. The f32 sum is cast
once to the output dtype.
"""

from __future__ import annotations

import logging

import torch

from ..io.writer import ShardLayer
from .base import MergeTensorsBase

logger = logging.getLogger(__name__)


class AdditionMerge(MergeTensorsBase):
    """out = sum(ft - base)."""

    OPTIONS = frozenset({"add_base"})

    _README_HOW = "from each finetuned model relative to the base model."

    def __init__(self, *args, add_base: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_base = add_base

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

This model was created by computing and combining the delta weights
{self._README_HOW}
"""

    def _layer_sources(self, shard_layer: ShardLayer):
        """The output base and every finetune, on every layer."""
        uris = [self.config.output_base_model] + [m.model for m in self.config.finetune_merge]
        return list(dict.fromkeys(uris)), None

    def _base_and_deltas(self, shard_layer: ShardLayer):
        """(the output base in f32, an iterator of each finetune's f32 delta
        against it in config order; a finetune leaves the device cache once
        its delta is taken)."""
        name = shard_layer.layer_name
        base = self._fetch(self.config.output_base_model, name).to(torch.float32)

        def deltas():
            for m in self.config.finetune_merge:
                delta = self._fetch(m.model, name).to(torch.float32) - base
                if m.model != self.config.output_base_model:
                    self._placed.pop((m.model, name), None)
                yield delta

        return base, deltas()

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        logger.info("Processing layer: %s", shard_layer.layer_name)
        base, deltas = self._base_and_deltas(shard_layer)
        out = torch.zeros_like(base)
        for delta in deltas:
            out.add_(delta)
        return out + base if self.add_base else out
