"""DELLA merging: magnitude-ranked stochastic drop, rescale, election
(counterpart of shardmerge_tpu/merge/della.py).

DARE's drop and rescale, with each entry's keep probability set by its
magnitude rank within its matrix row (the whole tensor for 1-D):

    k_i = density + epsilon * (1/2 - rank_i / max(row_len - 1, 1))

(rank 0 = largest |.|, ties in stable order); Bernoulli(k_i) per entry,
survivors divided by k_i; then ``combine``: ``ties`` (default) or ``sum``.
Validation keeps every k_i in (0, 1]. Output ``base + lam * combined``
(``add_base=False``: ``lam * combined``).

Probabilities bit-equal to the JAX engine's: XLA on the CPU turns the
division by the constant ``row_len - 1`` into a multiplication by its f32
reciprocal ``c`` and contracts both multiply-adds into FMAs, so JAX computes
``fma(fma(-rank, c, 1/2), epsilon, density)``; ``keep_probs`` computes the
same with an exact f32 FMA (``fma_f32``). The masks are jax.random's
threefry2x32 bits under the key of (tensor, model), as in the DARE engine
(ops/prng.py). Ranks, probabilities and masks are taken one model and one
block of rows at a time (at most ``prng.CHUNK`` elements), so no argsort
holds a whole tensor's int64 indices.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.writer import ShardLayer
from ..ops import prng
from ..ops.prng import fma_f32
from .base import MergeTensorsBase
from .dare import tensor_key
from .ties import elect_disjoint_mean, finish, sum_in_order

logger = logging.getLogger(__name__)


def keep_probs(rows: torch.Tensor, density: float, epsilon: float) -> torch.Tensor:
    """Keep probabilities of a (R, C) block of rows from within-row
    magnitude ranks, as the JAX engine computes them (f32)."""
    c = rows.shape[-1]
    d32, e32 = float(np.float32(density)), float(np.float32(epsilon))
    if c == 1:  # no rank spread: exactly density
        return torch.full(rows.shape, d32, dtype=torch.float32, device=rows.device)
    order = torch.argsort(rows.abs().neg_(), dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(c, device=rows.device).expand_as(order)
    ).to(torch.float32)
    recip = float(np.float32(1.0 / (c - 1)))
    return fma_f32(fma_f32(ranks, -recip, 0.5), e32, d32)


def sample_(delta: torch.Tensor, key, density: float, epsilon: float) -> torch.Tensor:
    """In place: ``where(bernoulli(key, probs), delta / probs, 0)``, block of
    rows by block of rows."""
    c = delta.shape[-1]
    rows = delta.reshape(-1, c)
    step = max(1, prng.CHUNK // c)
    for r0 in range(0, rows.shape[0], step):
        block = rows[r0:r0 + step]
        probs = keep_probs(block, density, epsilon)
        mask = prng.bernoulli_range(key, probs.reshape(-1), r0 * c, r0 * c + block.numel())
        block.div_(probs).masked_fill_(mask.logical_not_().reshape(block.shape), 0.0)
    return delta


class DellaMerge(MergeTensorsBase):
    """Magnitude-ranked drop-and-rescale delta merge (DELLA)."""

    OPTIONS = frozenset({"density", "epsilon", "combine", "seed", "lam", "add_base"})

    def __init__(self, *args, density: float = 0.2, epsilon: float = 0.1, combine: str = "ties",
                 seed: int = 0, lam: float = 1.0, add_base: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if epsilon < 0.0:
            raise ValueError(f"della epsilon must be >= 0, got {epsilon}")
        lo, hi = density - epsilon / 2.0, density + epsilon / 2.0
        if not (0.0 < lo and hi <= 1.0):
            raise ValueError(
                f"della density={density} with epsilon={epsilon} puts keep "
                f"probabilities in [{lo}, {hi}], outside (0, 1]"
            )
        if combine not in ("sum", "ties"):
            raise ValueError(f"della combine must be 'sum' or 'ties', got {combine!r}")
        self.density = float(density)
        self.epsilon = float(epsilon)
        self.combine = combine
        self.seed = int(seed)
        self.lam = float(lam)
        self.add_base = bool(add_base)

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged with DELLA: each delta entry was dropped with probability set by
its within-row magnitude rank (mean keep {self.density:.0%}, spread
{self.epsilon:.0%}, seed={self.seed}), survivors rescaled to keep the
delta's expectation, then combined via {self.combine}
(lambda={self.lam}).
"""

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        deltas = self.get_delta_for_models(models, shard_layer)
        named = tensor_key(self.seed, shard_layer.layer_name)
        for m, d in enumerate(deltas):
            sample_(d, prng.fold_in(named, m), self.density, self.epsilon)
        combined = elect_disjoint_mean(deltas) if self.combine == "ties" else sum_in_order(deltas)
        return finish(combined, base, self.lam, self.add_base)
