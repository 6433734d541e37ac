"""DARE merging: random delta drop and rescale, then sum or sign election
(counterpart of shardmerge_tpu/merge/dare.py).

Each entry of a finetune's delta is kept with probability
``keep = 1 - drop_rate`` and the survivors are divided by ``keep`` (a
division, as in JAX), then the models combine: ``sum`` (DARE-linear) or
``ties`` (sign election + disjoint mean, no magnitude trim).

The mask of (tensor, model m) is ``bernoulli(fold_in(fold_in(key(seed),
crc32(name) & 0x7FFFFFFF), m), keep)``: jax.random's threefry2x32 bits,
reproduced bit for bit by ops/prng.py, so a resumed merge (or the JAX
engine) draws the same masks. Output ``base + lam * combined``
(``add_base=False``: ``lam * combined``).
"""

from __future__ import annotations

import logging
import zlib

import torch

from ..io.writer import ShardLayer
from ..ops import prng
from .base import MergeTensorsBase, _f32
from .ties import elect_disjoint_mean, finish, sum_in_order

logger = logging.getLogger(__name__)


def tensor_key(seed: int, name: str):
    """The key of a tensor, before folding in the model's index."""
    return prng.fold_in(prng.key(seed), zlib.crc32(name.encode()) & 0x7FFFFFFF)


def drop_and_rescale_(delta: torch.Tensor, key, keep: float) -> torch.Tensor:
    """In place: ``where(bernoulli(key, keep), delta / keep, 0)`` with
    ``keep`` taken as f32."""
    mask = prng.bernoulli(key, keep, delta.shape, device=delta.device)
    return delta.div_(_f32(keep, delta.device)).masked_fill_(mask.logical_not_(), 0.0)


class DareMerge(MergeTensorsBase):
    """Drop-and-rescale delta merge (DARE), linear or TIES-combined."""

    OPTIONS = frozenset({"drop_rate", "combine", "seed", "lam", "add_base"})

    def __init__(self, *args, drop_rate: float = 0.9, combine: str = "sum", seed: int = 0,
                 lam: float = 1.0, add_base: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 <= drop_rate < 1.0:
            raise ValueError(f"dare drop_rate must be in [0, 1), got {drop_rate}")
        if combine not in ("sum", "ties"):
            raise ValueError(f"dare combine must be 'sum' or 'ties', got {combine!r}")
        self.drop_rate = float(drop_rate)
        self.combine = combine
        self.seed = int(seed)
        self.lam = float(lam)
        self.add_base = bool(add_base)

    def get_readme(self) -> str:
        return f"""# Merged Model

Base Model: {self.config.output_base_model}
Finetuned Models:
{chr(10).join('- ' + model.model for model in self.config.finetune_merge)}

Merged with DARE: {self.drop_rate:.0%} of each model's delta entries were
dropped at random (seed={self.seed}) and the survivors rescaled to keep the
delta's expectation, then combined via {self.combine}
(lambda={self.lam}).
"""

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        models, base = self._delta_engine_inputs(shard_layer)
        if models is None:
            return base
        deltas = self.get_delta_for_models(models, shard_layer)
        named = tensor_key(self.seed, shard_layer.layer_name)
        keep = 1.0 - self.drop_rate
        for m, d in enumerate(deltas):
            drop_and_rescale_(d, prng.fold_in(named, m), keep)
        combined = elect_disjoint_mean(deltas) if self.combine == "ties" else sum_in_order(deltas)
        return finish(combined, base, self.lam, self.add_base)
