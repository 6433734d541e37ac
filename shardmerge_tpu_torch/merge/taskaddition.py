"""Sign-agreement addition merge (counterpart of
shardmerge_tpu/merge/taskaddition.py): the majority sign
``sign(sum_m sign(d_m))`` of the deltas ``d_m = ft_m - output base``, and the
sum of the deltas that agree with it.

Kept from the reference tool, as in the addition engine (REF-QUIRK): the base
is not added back (``add_base=True`` adds it), alphas and layer gates do not
apply, and the input/output layers are merged too.
"""

from __future__ import annotations

import logging

import torch

from ..io.writer import ShardLayer
from .addition import AdditionMerge

logger = logging.getLogger(__name__)


class TaskAdditionMerge(AdditionMerge):
    """Addition merge with majority sign agreement."""

    _README_HOW = ("from each finetuned model relative to the base model, "
                   "using sign agreement.")

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        logger.info("Processing layer: %s", shard_layer.layer_name)
        base, deltas = self._base_and_deltas(shard_layer)
        deltas = list(deltas)
        majority = torch.zeros_like(base)
        for d in deltas:
            majority.add_(torch.sign(d))
        majority.sign_()
        out = torch.zeros_like(base)
        for d in deltas:
            out.add_(d * (torch.sign(d) == majority))
        return out + base if self.add_base else out
