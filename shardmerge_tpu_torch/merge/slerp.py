"""Weight-space SLERP merge (counterpart of shardmerge_tpu/merge/slerp.py).

Per tensor, spherical interpolation between two checkpoints, each tensor
one flat vector: with one configured finetune the endpoints are (base,
ft), with two (ft1, ft2); a layer-gated endpoint is replaced by the base.
``t`` (0 = first endpoint, 1 = second):

    u_i = v_i / ||v_i||,  theta = acos(u0 . u1)
    out = (sin((1-t) theta) u0 + sin(t theta) u1) / sin(theta)
          * ((1-t) ||v0|| + t ||v1||)

falling back to the plain lerp where the endpoints are near colinear
(|u0 . u1| > 0.9995, which covers identical tensors) or a norm is zero.
Not the fourier engines' spectral slerp (ops/blend.py). The regime is
chosen on the device (no host sync).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..constants import INPUT_LAYER
from ..io.writer import ShardLayer
from .base import MergeTensorsBase

logger = logging.getLogger(__name__)

_COLINEAR = 0.9995


def slerp_pair(v0: torch.Tensor, v1: torch.Tensor, t: float) -> torch.Tensor:
    """Weight-space SLERP of two tensors in f32 at f32 ``t``."""
    v0 = v0.to(torch.float32)
    v1 = v1.to(torch.float32)
    t32 = np.float32(t)
    s, t = float(np.float32(1.0) - t32), float(t32)
    n0 = torch.sqrt(torch.sum(v0 * v0))
    n1 = torch.sqrt(torch.sum(v1 * v1))
    u0 = v0 / torch.clamp(n0, min=1e-12)
    u1 = v1 / torch.clamp(n1, min=1e-12)
    dot = torch.clamp(torch.sum(u0 * u1), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.clamp(torch.sin(theta), min=1e-12)
    out_dir = (torch.sin(s * theta) * u0 + torch.sin(t * theta) * u1) / sin_theta
    spherical = out_dir * (s * n0 + t * n1)
    lerp = s * v0 + t * v1
    degenerate = (dot.abs() > _COLINEAR) | (n0 == 0.0) | (n1 == 0.0)
    return torch.where(degenerate, lerp, spherical)


class SlerpMerge(MergeTensorsBase):
    """Spherical interpolation between exactly two checkpoints."""

    OPTIONS = frozenset({"t"})

    def __init__(self, *args, t: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= t <= 1.0:
            raise ValueError(f"slerp t must be in [0, 1], got {t}")
        self.t = float(t)
        n = len(self.config.finetune_merge)
        if n not in (1, 2):
            raise ValueError(
                f"slerp interpolates exactly two checkpoints: configure one "
                f"finetune (endpoints base -> model) or two (model -> model); "
                f"got {n}"
            )

    def get_readme(self) -> str:
        names = [m.model for m in self.config.finetune_merge]
        if len(names) == 1:
            endpoints = f"{self.config.output_base_model} -> {names[0]}"
        else:
            endpoints = f"{names[0]} -> {names[1]}"
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + n for n in names)}

Merged by per-tensor spherical interpolation (t={self.t}) along
{endpoints}, with lerp fallback for near-colinear tensors.
"""

    def _layer_sources(self, shard_layer: ShardLayer):
        """The two endpoints (the base alone when no model covers the
        layer); input/output layers pass through."""
        uris, passthrough = super()._layer_sources(shard_layer)
        if passthrough is not None:
            return uris, passthrough
        models = self._covering(shard_layer)
        base = self.config.output_base_model
        if not models:
            return [base], None
        if len(self.config.finetune_merge) == 1:
            return [base, models[0].model], None
        return [m.model if m in models else base for m in self.config.finetune_merge], None

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        name = shard_layer.layer_name
        uris, passthrough = self._layer_sources(shard_layer)
        if passthrough is not None:
            which = "input" if shard_layer.layer_number == INPUT_LAYER else "output"
            return self._passthrough(shard_layer, which, passthrough)
        if len(uris) == 1:
            logger.warning("No models cover layer %s; passing base through", name)
            return self.get_base_output_tensor(shard_layer)
        if len(self.config.finetune_merge) == 2:
            for m in self.config.finetune_merge:
                if not m.use_layer_index(shard_layer.layer_number):
                    logger.warning("slerp endpoint %s gated out at layer %s; using base", m.model, name)
        return slerp_pair(self._fetch(uris[0], name), self._fetch(uris[1], name), self.t)
