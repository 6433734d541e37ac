"""TIES merging: trim, elect sign, disjoint mean (counterpart of
shardmerge_tpu/merge/ties.py).

Per tensor, with f32 alpha-weighted deltas ``d_m = alpha_m * (ft_m - base)``:

1. trim: keep each model's ``density`` fraction of entries largest by
   magnitude; the threshold is the exact order statistic of ``|d_m|``
   (ops/select.py) and entries tied with it are all kept;
2. elect: per entry, the sign of the summed trimmed values;
3. disjoint mean: the mean of the trimmed values whose sign matches the
   elected one, zero where none does.

Output ``base + lam * merged`` (``add_base=False``: ``lam * merged``). The
trim is per tensor. Models are trimmed one at a time (one model's
magnitudes and select keys at once, not N), and every sum over models runs
in config order.
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch

from ..io.writer import ShardLayer
from ..ops.select import kth_smallest_nonneg
from .base import MergeTensorsBase

logger = logging.getLogger(__name__)


def keep_count(n: int, density: float) -> int:
    """How many entries of an n-element tensor survive the trim."""
    return max(1, min(n, int(round(density * n))))


def sum_in_order(deltas: Sequence[torch.Tensor]) -> torch.Tensor:
    """d_0 + d_1 + ... in list (config) order, accumulated into d_0."""
    out = deltas[0]
    for d in deltas[1:]:
        out.add_(d)
    return out


def elect_disjoint_mean(deltas: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sign election and disjoint mean over N same-shaped deltas: the
    elected sign is that of the per-entry sum (a mass vote); the result is
    the mean of the nonzero entries agreeing with it, or zero. An entry
    agrees where ``d * sign > 0``: the same sign, neither zero, no NaN.
    Besides the result, it holds one f32 scratch, the sign (int8), the
    count (int16) and one bool mask."""
    total = deltas[0].clone()
    for d in deltas[1:]:
        total.add_(d)
    gamma = total.sign_().to(torch.int8)
    total.zero_()
    count = torch.zeros(total.shape, dtype=torch.int16, device=total.device)
    scratch = torch.empty_like(total)
    agree = torch.empty(total.shape, dtype=torch.bool, device=total.device)
    zero = torch.zeros((), dtype=total.dtype, device=total.device)
    for d in deltas:
        torch.gt(torch.mul(d, gamma, out=scratch), 0.0, out=agree)
        count.add_(agree)
        total.add_(torch.where(agree, d, zero, out=scratch))
    # where no entry agrees, total is +0.0 and the count is clamped to 1
    return total.div_(count.clamp_min_(1))


def trim_(delta: torch.Tensor, k_keep: int) -> torch.Tensor:
    """Zero, in place, all but (at least) the k_keep entries of ``delta``
    largest by magnitude (every entry tied with the threshold stays)."""
    n = delta.numel()
    if k_keep >= n:
        return delta
    mags = delta.abs()
    # ascending order s[0..n-1]: the top k_keep start at s[n - k_keep]
    thr = kth_smallest_nonneg(mags, n - k_keep)
    return delta.masked_fill_(mags.ge(thr).logical_not_(), 0.0)


def finish(combined: torch.Tensor, base: torch.Tensor, lam: float, add_base: bool) -> torch.Tensor:
    """``base + lam * combined``, or ``lam * combined`` without the base,
    in place in ``combined``."""
    combined.mul_(lam)
    return combined.add_(base) if add_base else combined


class TiesMerge(MergeTensorsBase):
    """Trim / elect-sign / disjoint-mean delta merge (TIES)."""

    OPTIONS = frozenset({"density", "lam", "add_base"})

    def __init__(self, *args, density: float = 0.2, lam: float = 1.0, add_base: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 < density <= 1.0:
            raise ValueError(f"ties density must be in (0, 1], got {density}")
        self.density = float(density)
        self.lam = float(lam)
        self.add_base = bool(add_base)

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged with TIES: each model's delta was trimmed to its top
{self.density:.0%} of entries by magnitude, a sign was elected per entry
by summed mass, and agreeing entries were averaged (lambda={self.lam}).
"""

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        deltas = self.get_delta_for_models(models, shard_layer)
        k_keep = keep_count(base.numel(), self.density)
        for d in deltas:
            trim_(d, k_keep)
        return finish(elect_disjoint_mean(deltas), base, self.lam, self.add_base)
