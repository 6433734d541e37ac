"""Model Stock merging: interpolation toward the base by the angle between
the task deltas (counterpart of shardmerge_tpu/merge/modelstock.py).

Per tensor, with raw deltas ``d_m = ft_m - base`` (alpha not applied) of the
N >= 2 covering models:

1. ``cos_theta``: the mean pairwise cosine over all model pairs, from the
   Gram matrix of the flattened deltas (f32 products and sums,
   ``ops/pairing.py`` ``dim0_gram``: no TF32 whatever the caller set); a
   zero-norm delta contributes cosine 0;
2. ``t = N cos_theta / (1 + (N - 1) cos_theta)``, 0 where the denominator
   is within 1e-6 of 0, clamped to [0, 1];
3. ``out = base + t * mean(d_m)``.

The ratio is computed per tensor and stays on the device. Fewer than two
configured finetunes is refused; a layer that fewer than two models cover
passes the base through.
"""

from __future__ import annotations

import logging

import torch

from ..config import ConfigError
from ..io.writer import ShardLayer
from ..ops.pairing import dim0_gram
from .base import MergeTensorsBase

logger = logging.getLogger(__name__)


def stock_ratio(flat: torch.Tensor) -> torch.Tensor:
    """The interpolation ratio t (0-d f32) of an (N, numel) delta stack."""
    n = flat.shape[0]
    gram = dim0_gram(flat)
    norms = torch.sqrt(torch.diagonal(gram))
    denom = torch.outer(norms, norms)
    cos = torch.where(denom > 0.0, gram / torch.clamp(denom, min=1e-30), 0.0)
    cos_theta = (cos.sum() - torch.trace(cos)) / float(n * n - n)
    t_denom = 1.0 + (n - 1) * cos_theta
    t = torch.where(t_denom.abs() > 1e-6, n * cos_theta / t_denom, 0.0)
    return torch.clamp(t, 0.0, 1.0)


class ModelStockMerge(MergeTensorsBase):
    """Angle-ratio interpolation between the base and the finetune mean."""

    OPTIONS = frozenset()

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if len(self.config.finetune_merge) < 2:
            raise ConfigError(
                "model-stock needs at least two finetunes (the ratio is "
                f"computed from the angle between their deltas); got "
                f"{len(self.config.finetune_merge)}"
            )
        if any(m.alpha != 1.0 for m in self.config.finetune_merge):
            logger.warning(
                "model-stock ignores per-model alpha values: the "
                "interpolation ratio is derived from the raw delta "
                "geometry (arXiv:2403.19522)"
            )

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged with Model Stock: per tensor, the base was interpolated toward the
average of the finetunes with the ratio t = N cos(theta) / (1 + (N-1)
cos(theta)) derived from the mean pairwise angle between the task deltas.
"""

    def _layer_sources(self, shard_layer: ShardLayer):
        uris, passthrough = super()._layer_sources(shard_layer)
        if passthrough is None and len(self._covering(shard_layer)) < 2:
            return [self.config.output_base_model], None
        return uris, passthrough

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        if len(models) < 2:
            logger.warning(
                "model-stock: only %d model(s) cover layer %s; passing base through "
                "(the angle ratio needs two deltas)", len(models), shard_layer.layer_name,
            )
            self.stats.tensors_passthrough += 1
            return base
        stack = torch.stack(self.get_delta_for_models(models, shard_layer, apply_alpha=False))
        t = stock_ratio(stack.reshape(stack.shape[0], -1))
        return base + t * stack.mean(dim=0)
