"""Model Breadcrumbs merging: mask both tails of each delta's magnitudes
(counterpart of shardmerge_tpu/merge/breadcrumbs.py).

Per tensor, with f32 alpha-weighted deltas ``d_m = alpha_m * (ft_m - base)``:

1. drop the ``beta`` fraction of each model's smallest-|.| entries and the
   ``gamma`` fraction of its largest, keeping the band between. Both
   thresholds are exact order statistics of ``|d_m|`` (ops/select.py). Ties:
   entries equal to the lower threshold are kept (the smallest surviving
   magnitude), entries equal to the upper one dropped (the smallest
   discarded magnitude);
2. combine: ``sum`` (default) or ``ties`` (sign election + disjoint mean).

Output ``base + lam * combined`` (``add_base=False``: ``lam * combined``).
The mask is per tensor and taken one model at a time; no randomness.
"""

from __future__ import annotations

import logging

import torch

from ..io.writer import ShardLayer
from ..ops.select import kth_smallest_nonneg
from .base import MergeTensorsBase
from .ties import elect_disjoint_mean, finish, sum_in_order

logger = logging.getLogger(__name__)


def tail_counts(n: int, beta: float, gamma: float):
    """(k_low, k_top): how many smallest / largest entries are dropped from
    an n-element tensor; the count-space band is kept nonempty on tiny
    tensors (mask_tails_ works in value space, so a tensor whose magnitudes
    all tie at the upper threshold still zeroes entirely)."""
    k_low = int(round(beta * n))
    k_top = int(round(gamma * n))
    if k_low + k_top >= n:
        k_top = min(k_top, n - 1)
        k_low = min(k_low, n - 1 - k_top)
    return k_low, k_top


def mask_tails_(delta: torch.Tensor, k_low: int, k_top: int) -> torch.Tensor:
    """Zero, in place, the k_low smallest-|.| and k_top largest-|.| entries
    of ``delta`` (exact thresholds of its magnitudes before any zeroing)."""
    n = delta.numel()
    mags = delta.abs()
    hi = kth_smallest_nonneg(mags, n - k_top) if k_top > 0 else None
    lo = kth_smallest_nonneg(mags, k_low) if k_low > 0 else None
    if hi is not None:  # s[n - k_top], the smallest of the top set: drop >= it
        delta.masked_fill_(mags >= hi, 0.0)
    if lo is not None:  # s[k_low], the smallest survivor: keep >= it
        delta.masked_fill_(mags.ge(lo).logical_not_(), 0.0)
    return delta


class BreadcrumbsMerge(MergeTensorsBase):
    """Two-tail magnitude-masked delta merge (Model Breadcrumbs)."""

    OPTIONS = frozenset({"beta", "gamma", "combine", "lam", "add_base"})

    def __init__(self, *args, beta: float = 0.85, gamma: float = 0.01, combine: str = "sum",
                 lam: float = 1.0, add_base: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= beta < 1.0:
            raise ValueError(f"breadcrumbs beta must be in [0, 1), got {beta}")
        if not 0.0 <= gamma < 1.0:
            raise ValueError(f"breadcrumbs gamma must be in [0, 1), got {gamma}")
        if beta + gamma >= 1.0:
            raise ValueError(
                f"breadcrumbs beta + gamma must be < 1 (got {beta} + {gamma}"
                " — the kept band would be empty)"
            )
        if combine not in ("sum", "ties"):
            raise ValueError(f"breadcrumbs combine must be 'sum' or 'ties', got {combine!r}")
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.combine = combine
        self.lam = float(lam)
        self.add_base = bool(add_base)

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged with Model Breadcrumbs: each delta was masked to its middle
magnitude band (bottom {self.beta:.0%} and top {self.gamma:.0%} of entries
dropped), then combined via {self.combine} (lambda={self.lam}).
"""

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        deltas = self.get_delta_for_models(models, shard_layer)
        k_low, k_top = tail_counts(base.numel(), self.beta, self.gamma)
        for d in deltas:
            mask_tails_(d, k_low, k_top)
        combined = elect_disjoint_mean(deltas) if self.combine == "ties" else sum_in_order(deltas)
        return finish(combined, base, self.lam, self.add_base)
