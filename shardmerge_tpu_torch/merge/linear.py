"""Linear (weighted-average) merge (counterpart of
shardmerge_tpu/merge/linear.py): per tensor

    out = base + sum_m(alpha_m * (ft_m - base)) / Z

with ``Z = sum_m(alpha_m)`` over the models covering the layer when
``normalize`` (the default: an alpha-weighted mean of the finetunes) or
``Z = 1`` (raw task arithmetic).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.writer import ShardLayer
from .base import MergeTensorsBase
from .ties import sum_in_order

logger = logging.getLogger(__name__)


class LinearMerge(MergeTensorsBase):
    """out = base + weighted mean (or raw sum) of alpha-scaled deltas."""

    OPTIONS = frozenset({"normalize"})

    def __init__(self, *args, normalize: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.normalize = bool(normalize)

    def get_readme(self) -> str:
        how = (
            "an alpha-weighted average of the finetune deltas"
            if self.normalize
            else "the sum of the alpha-scaled finetune deltas"
        )
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged linearly: the base model plus {how}.
"""

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        z = sum(m.alpha for m in models) if self.normalize else 1.0
        if self.normalize and abs(z) < 1e-12:
            raise ValueError(
                f"linear normalize=True with alphas summing to {z}; "
                "the weighted mean is undefined"
            )
        deltas = self.get_delta_for_models(models, shard_layer)
        return base + sum_in_order(deltas) * float(np.float32(1.0 / z))
