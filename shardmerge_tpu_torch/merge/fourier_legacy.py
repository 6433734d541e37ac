"""The legacy Fourier merge engine (counterpart of
shardmerge_tpu/merge/fourier_legacy.py, the reference tool's older module).

It differs from the fourier engine, and keeps the reference's quirks:

- deltas are taken against the OUTPUT base tensor; ``model.base`` is never
  read (REF-QUIRK);
- pairs are chosen by the cosine-similarity correlation of the current
  stack, least correlated first (``ops/pairing.py``), every round;
- ``target_norm`` is the LOWER median of the first round's delta norms;
- a model's identity (and so its membership of ``task_add_models``) is
  looked up by its position among the layer-gated-in models against the
  FULL config list (REF-QUIRK), and the slerp regime's alphas by stack
  position into the config list (REF-QUIRK);
- the task-add side stack is applied at the end by sign-free FFT
  arithmetic;
- the input/output passthrough raises when no model is flagged
  is_input/is_output (the fast engine falls back to the base);
- every pair merge takes the exact complex-FFT path (never the rfft
  half-spectrum path), and the result is returned in f32 (cast for the
  output on the way out).

Deltas and norms are f32. Norms and the correlation are read back once per
round; NaN counts and Inf flags wait on the device until the tensor's
write-back (``raise_deferred``).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MergeConfig
from ..constants import INPUT_LAYER, OUTPUT_LAYER
from ..io.writer import ShardLayer
from ..ops import blend
from ..ops.pairing import correlated_pairs, cosine_correlation
from .base import MergeTensorsBase, _f32
from .fourier import _batched_norms, _pair_add, _pair_lowratio, _pair_slerp, _ranks, raise_deferred

logger = logging.getLogger(__name__)


def _lower_median(values: List[float]) -> float:
    """torch.median semantics: the lower of the two middle elements."""
    s = sorted(values)
    return s[(len(s) - 1) // 2]


class LegacyFourierMerge(MergeTensorsBase):
    def __init__(
        self,
        config: MergeConfig,
        index_manager=None,
        *,
        task_add_models: Optional[List[str]] = None,
        target_norm_offset: float = 1e-10,
        cull_start_pct: float = 0.20,
        **pipeline,
    ):
        super().__init__(config, index_manager, **pipeline)
        self.task_add_models = task_add_models or []
        self.target_norm_offset = target_norm_offset
        self.cull_start_pct = cull_start_pct
        # layer name -> ([(nan_count, inf_flag)], final_inf), read at write time
        self._deferred: Dict[str, tuple] = {}

    def get_readme(self) -> str:
        models = "\n".join(f"- {m.model}" for m in self.config.finetune_merge)
        return f"""# SLERP-FFT Merged Model
Base: {self.config.output_base_model}
Models merged:
{models}
"""

    def _flagged(self, shard_layer: ShardLayer):
        flag = "is_input" if shard_layer.layer_number == INPUT_LAYER else "is_output"
        return next((m for m in self.config.finetune_merge if getattr(m, flag)), None)

    def _layer_sources(self, shard_layer: ShardLayer):
        """An input/output layer passes the flagged model through (nothing
        when none is flagged: the merge raises); any other fetches the
        output base and each covering finetune, never ``model.base``."""
        if shard_layer.layer_number in (INPUT_LAYER, OUTPUT_LAYER):
            model = self._flagged(shard_layer)
            return [], model.model if model is not None else None
        uris = [self.config.output_base_model] + [m.model for m in self._covering(shard_layer)]
        return list(dict.fromkeys(uris)), None

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        name = shard_layer.layer_name
        if shard_layer.layer_number in (INPUT_LAYER, OUTPUT_LAYER):
            which = "input" if shard_layer.layer_number == INPUT_LAYER else "output"
            model = self._flagged(shard_layer)
            if model is None:
                raise ValueError(f"No {which} model found")
            return self._passthrough(shard_layer, which, model.model)

        base = self.get_base_output_tensor(shard_layer)
        layer_stack, add_stack = [], []
        for i, model in enumerate(self._covering(shard_layer)):
            delta = self._fetch(model.model, name).to(torch.float32) - base
            if model.model != self.config.output_base_model:
                self._placed.pop((model.model, name), None)
            # REF-QUIRK: the identity of the i-th gated-in model is the i-th
            # entry of the full config list
            identity = self.config.finetune_merge[i].model
            (add_stack if identity in self.task_add_models else layer_stack).append((identity, delta))
        if not layer_stack:
            logger.warning("No models cover layer %s; passing base through", name)
            return base

        merged, checks = self.reduce(layer_stack)
        for model_name, delta in add_stack:
            merged = blend.task_arithmetic_fft2(merged, delta, 1.0, agreement=False)
            logger.info("Arithmetic merged %s", model_name)
        result = base + merged
        result = result.masked_fill(torch.isnan(result), 0.0)
        self._deferred[name] = (checks, torch.isinf(result).any())
        return result

    def reduce(self, layer_stack, trace: Optional[list] = None):
        """Reduce a stack of (name, f32 delta) pairwise to one delta:
        (merged, [(nan_count, inf_flag)] of the FFT pair merges). A
        ``trace`` list gets (regime, x, y, norm_a, norm_b, target_norm,
        cull_pct, a_prop, a, b, merged) for every pair merge, with the
        operands, norms and blend weight as the merge saw them."""
        checks: list = []
        target_norm = _lower_median(_batched_norms([d for _, d in layer_stack])) + self.target_norm_offset
        self.stats.host_syncs += 1
        cull_pct = self.cull_start_pct
        while len(layer_stack) > 1:
            logger.info("Processing %d layers : %s", len(layer_stack), ", ".join(n for n, _ in layer_stack))
            correlation = cosine_correlation(torch.stack([d for _, d in layer_stack]))
            current_norms = _batched_norms([d for _, d in layer_stack])
            self.stats.host_syncs += 2
            next_stack = []
            for x, y, _ in correlated_pairs(correlation, way="least"):
                if y < 0:
                    next_stack.append(layer_stack[x])
                    continue
                (a_key, a), (b_key, b) = layer_stack[x], layer_stack[y]
                norm_a, norm_b = current_norms[x], current_norms[y]
                if abs(norm_a) < abs(norm_b):
                    a, b, a_key, b_key, norm_a, norm_b = b, a, b_key, a_key, norm_b, norm_a
                regime, merged, check = self._merge_pair(a, b, x, y, norm_a, norm_b, target_norm, cull_pct)
                if check is not None:
                    checks.append(check)
                if trace is not None:
                    trace.append((regime, x, y, norm_a, norm_b, target_norm, cull_pct, self._a_prop(x, y),
                                  a, b, merged))
                self.stats.record_pair(regime)
                next_stack.append((f"{a_key}_{b_key}", merged))
            layer_stack = next_stack
            cull_pct = cull_pct / 2.0
        return layer_stack[0][1], checks

    def _a_prop(self, x: int, y: int) -> float:
        """The blend weight of the pair at stack positions (x, y).
        REF-QUIRK: the alphas are looked up by stack position into the
        config list, in every round."""
        a_weight = self.config.finetune_merge[x].alpha
        return a_weight / (a_weight + self.config.finetune_merge[y].alpha)

    def _merge_pair(self, a, b, x, y, norm_a, norm_b, target_norm, cull_pct):
        """One pair merge, ``a`` the larger norm: (regime, merged, (nan_count,
        inf_flag) or None). The regime is chosen on the host from the
        norms, as in the reference."""
        cnorm_a = abs(norm_a / target_norm)
        cnorm_b = abs(norm_b / target_norm)
        n_ratio = cnorm_b / (cnorm_a + 1e-10)
        dev = a.device
        if cnorm_a < 1e-6:
            return "add", _pair_add(a, b), None
        if cnorm_b < 1e-6 or n_ratio < 0.1:
            # the legacy path does not weight-scale b
            scaled_a = a * float(np.float32(target_norm / norm_a))
            return "arith", blend.task_arithmetic_fft2(scaled_a, b, 1.0, agreement=True), None
        a_prop = self._a_prop(x, y)
        norm_a_t, norm_b_t, a_prop_t, target_t = _f32([norm_a, norm_b, a_prop, target_norm], dev)
        if norm_b < 1e-4 or norm_a < 1e-4:
            return "early", (a / norm_a_t) * float(np.float32(target_norm)), None
        if norm_b / (norm_a + 1e-10) < 0.1:
            merged, nan_count, has_inf = _pair_lowratio(a, b, norm_a_t, norm_b_t, a_prop_t, target_t)
            return "lowratio", merged, (nan_count, has_inf)
        merged, nan_count, has_inf = _pair_slerp(
            a, b, norm_a_t, norm_b_t, a_prop_t, *_ranks(a.numel(), cull_pct),
            target_t, use_cutoff=True, use_cull=cull_pct > 0,
        )
        return "slerp", merged, (nan_count, has_inf)

    def _check_deferred(self, layer_name: str):
        raise_deferred(self.stats, layer_name, self._deferred.pop(layer_name, None))
