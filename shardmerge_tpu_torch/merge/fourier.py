"""Fourier merge engine, base + any number of finetunes (counterpart of
shardmerge_tpu/merge/fourier.py).

Per tensor:

- each delta is taken against its model's own base, WITHOUT alpha; alphas
  only weight the pair interpolation;
- target_norm = mean of the f32 delta norms + offset;
- the stack of deltas is reduced pairwise, pairing least "correlated" first
  by the norm-product matrix of the FIRST round's norms indexed by current
  stack position (REF-QUIRK: never recomputed from merged entries);
- each pair is ordered by its fresh norms, the weights stay positional
  (REF-QUIRK), and one of five regimes merges it: add, sign-agreement
  arithmetic, early return, low-ratio additive FFT, masked SLERP-FFT with an
  exact 8% cutoff and a cull that starts at 20% and halves every round;
- merged entries are named ``name_hash(a_b)`` and weigh the mean of the
  pair's weights;
- base + delta, NaN -> 0, Inf raises, bfloat16.

Two paths compute this. One or two finetunes (no ``hbm_budget_bytes``) take
the fused programs ``_fused_single`` / ``_fused_pair``, where the JAX engine
picks the regime in-graph; here the same f32 predicates run on the device
and the regime is read back with ONE sync per tensor, then only that branch
runs. Every other case takes the stack path (``reduce_deltas``): the regimes
are decided on the host from norms read back once per round, the entries
stay on the device unless ``hbm_budget_bytes`` spills them to page-locked
host memory, and ``batch_rounds`` stacks a round's same-regime pairs on a
leading axis for their forward FFTs (``_forward``; the blend and inverse
stay per pair, ``_inverse``). NaN counts and Inf flags stay on the device
until the tensor's write-back (``_check_deferred``), which still aborts
before it is written.
Large 2-D tensors take the rfft half-spectrum path with the analytic
fast-imag identity (see ``_FAST_IMAG_MIN_NUMEL``).

Across merge ranks (``comm``, parallel/comm.py; the JAX engine's ``mesh``),
tensors of ``shard_min_bytes`` or more, or of ``huge_tensor_numel``
elements, are split over the ranks (``_sharding_for``): 2-D tensors by rows
(zero-padded to a multiple of the ranks) when the columns divide the ranks,
merged by the distributed-FFT pair merges of parallel/merge.py; ndim >= 3
stacks by their leading dim when it divides the ranks, merged by the
single-device pair merges with every FFT rank-local and every reduction
all-reduced. Every reduction the JAX engine gets from GSPMD is written out:
the delta norms, the merged entries' norms, the pair merges' NaN counts and
Inf flags and ``_finalize``'s Inf flag are global, so every rank takes the
same regimes and raises at the same tensor. On ranks every tensor takes the
stack path (no fused path, no ``batch_rounds``), as in the JAX engine on a
mesh.
"""

from __future__ import annotations

import hashlib
import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ConfigError, MergeConfig
from ..constants import INPUT_LAYER, OUTPUT_LAYER
from ..io.writer import ShardLayer
from ..ops import blend
from ..ops.pairing import correlated_pairs, norm_product_matrix
from ..parallel import merge as pmerge
from .base import MergeTensorsBase, Placement, _f32

logger = logging.getLogger(__name__)

# The reference's imaginary recursion FFTs the imaginary planes again and
# blends their real parts, which are pure rounding noise for real input; its
# output reduces analytically to passing Im(F0) through ("fast imag",
# 3 FFTs instead of 6). Where the noise rounds to EXACT zeros (small or 1-D
# tensors, FFT-library dependent) the reference divides 0/0 and scrubs most
# of the tensor to zero, which the fast path would not reproduce — so the
# fast path is gated to large 2-D tensors, exactly as in the JAX package.
_FAST_IMAG_MIN_NUMEL = 1 << 20

FUSED_REGIMES = ("add", "arith", "slerp-early", "lowratio", "slerp")


def _use_fast_imag(exact_imag: bool, arr: torch.Tensor, numel: Optional[int] = None) -> bool:
    """``numel``: the whole tensor's element count when ``arr`` is one
    rank's share of it."""
    numel = arr.numel() if numel is None else numel
    return (not exact_imag) and arr.ndim >= 2 and numel >= _FAST_IMAG_MIN_NUMEL


def _rfft2(x):
    return torch.fft.rfftn(x, dim=(-2, -1))


def _irfft2(h, shape):
    return torch.fft.irfftn(h, s=shape[-2:], dim=(-2, -1))


def _fft_stack(x):
    """fft2 of every entry of a stack (k, *entry): 1-D entries by fft."""
    x = x.to(torch.float32)
    return torch.fft.fft(x, dim=-1) if x.ndim == 2 else torch.fft.fftn(x, dim=(-2, -1))


def _scrub(merged, target_norm, group=None):
    """NaN -> 0 (counted), Inf flagged, then rescale to target_norm; with
    ``group`` the count and the flag are global."""
    merged, nan_count, has_inf = blend._scrub_nans(merged, group)
    return merged * target_norm, nan_count, has_inf


def _pair_add(a, b):
    """Regime 0: plain sum."""
    return a + b


def _forward(regime, a, b, scalars, fast, batched=False):
    """The forward half of a pair merge of regime arith, lowratio or slerp:
    the spectra its blend reads. ``scalars`` are the pair's (norm_scale,
    weight_scale) for arith, else (norm_a, norm_b, t). With ``batched``, a
    and b carry a leading axis of pairs and the scalars are shaped to
    broadcast over it."""
    if fast:
        fft = _rfft2
    else:
        fft = _fft_stack if batched else blend.fft2
    if regime == "arith":
        norm_scale, weight_scale = scalars
        return fft(a * norm_scale), fft(b * weight_scale * norm_scale)
    norm_a, norm_b, t = scalars
    if regime == "lowratio":
        return (fft(a / norm_a) + t * fft(b / norm_b),)
    if fast:  # 1/norm on the spectrum (FFT linearity), as in the JAX kernel
        return fft(a) * (1.0 / norm_a), fft(b) * (1.0 / norm_b)
    return fft(a / norm_a), fft(b / norm_b)


def _inverse(regime, spectra, shape, t, ranks, target_norm, fast, *, use_cull, use_cutoff=True, group=None):
    """The inverse half of ONE pair merge, from its spectra (``_forward``):
    (merged, nan_count, has_inf), the last two None for arith. With
    ``group`` the entries are one rank's leading-dim share of a stack: the
    reductions (and the NaN count and Inf flag) are global.

    - arith: sign-agreement FFT arithmetic at t=1, with the double-FFT
      imaginary recursion on the exact path; on the half spectrum the
      disagreeing lanes take v1 (REF-QUIRK);
    - lowratio: the additive blend's inverse;
    - slerp: the masked SLERP-FFT blend (exact 8% cutoff, cull) on the full
      spectrum with the imaginary recursion, or on the half spectrum;

    then NaN -> 0 (counted), Inf flagged, rescaled to target_norm."""
    if regime == "arith":
        f0, f1 = spectra
        if not fast:
            out = blend.arithmetic_fft_components(f0, f1, 1.0, agreement=True, do_imag=True)
            return blend.ifft2_real(out), None, None
        r0, r1 = f0.real, f1.real
        res_real = torch.where(torch.sign(r0) == torch.sign(r1), r0 + r1, r1)
        return _irfft2(torch.complex(res_real, f0.imag), shape), None, None
    if regime == "lowratio":
        (h,) = spectra
        merged = _irfft2(h, shape) if fast else blend.ifft2_real(h)
    elif fast:
        h0, h1 = spectra
        result = blend.interpolate_half_spectrum(
            h0, h1, t, 1.0, *ranks,
            blend.hermitian_col_weights(shape[-1], device=h0.device),
            use_cutoff=use_cutoff, use_cull=use_cull, group=group,
        )
        merged = _irfft2(result, shape)
    else:
        f0, f1 = spectra
        result = blend.interpolate_fft_components(
            f0, f1, t, 1.0, *ranks, use_cutoff=use_cutoff, use_cull=use_cull, interp_imag=True, group=group
        )
        merged = blend.ifft2_real(result)
    if group is None:
        return _scrub(merged, target_norm)
    return _scrub(merged, target_norm, group)


def _pair(regime, a, b, scalars, ranks, target_norm, fast, *, use_cull, use_cutoff=True, group=None):
    """One pair merge of regime arith, lowratio or slerp (``_inverse``)."""
    spectra = _forward(regime, a, b, scalars, fast)
    return _inverse(regime, spectra, a.shape, scalars[-1], ranks, target_norm, fast,
                    use_cull=use_cull, use_cutoff=use_cutoff, group=group)


def _pair_lowratio(a, b, norm_a, norm_b, t, target_norm):
    """Regime 3, exact path: additive FFT blend."""
    return _pair("lowratio", a, b, (norm_a, norm_b, t), (), target_norm, False, use_cull=False)


def _pair_lowratio_rfft(a, b, norm_a, norm_b, t, target_norm):
    """Regime 3 on the half spectrum."""
    return _pair("lowratio", a, b, (norm_a, norm_b, t), (), target_norm, True, use_cull=False)


def _pair_slerp(a, b, norm_a, norm_b, t, cutoff_k, cull_k, cull_count_limit,
                target_norm, *, use_cutoff, use_cull):
    """Regime 4, exact path: normalized masked SLERP-FFT blend with the
    double-FFT imaginary recursion."""
    return _pair("slerp", a, b, (norm_a, norm_b, t), (cutoff_k, cull_k, cull_count_limit),
                 target_norm, False, use_cull=use_cull, use_cutoff=use_cutoff)


def _ranks(numel: int, cull_pct: float):
    """The exact order-statistic ranks of a slerp over ``numel`` elements:
    (cutoff rank at 8%, cull rank, cull count limit)."""
    return (
        blend.cutoff_rank(numel, 0.08),
        blend.cull_rank(numel, cull_pct),
        blend.cull_limit(numel, cull_pct),
    )


def _finalize(base32, delta, group=None):
    """base + delta, NaN -> 0, Inf flag (over ``group``'s ranks), bfloat16."""
    result = base32 + delta
    result = result.masked_fill(torch.isnan(result), 0.0)
    has_inf = torch.isinf(result).any()
    if group is not None:
        has_inf = group.all_reduce(has_inf.to(torch.int64)) > 0
    return result.to(torch.bfloat16), has_inf


def _fused_single(out_base, ft_base, ft):
    """One finetune: out_base + (ft - ft_base), alpha not applied."""
    delta = ft.to(torch.float32) - ft_base.to(torch.float32)
    return _finalize(out_base.to(torch.float32), delta)


def _fused_pair(
    base,
    ft1_base,
    ft1,
    ft2_base,
    ft2,
    alpha1,
    alpha2,
    target_norm_offset,
    cutoff_k,
    cull_k,
    cull_count_limit,
    *,
    use_cull: bool,
    fast_imag: bool,
):
    """Two finetunes: the reference's one-round stack reduction.

    Returns (bf16 result, nan_count, pair_inf, final_inf, regime) with the
    regime index into ``FUSED_REGIMES`` as a Python int (the one host
    sync); nan_count counts NaNs scrubbed from the pair merge's inverse
    FFT."""
    dev = base.device
    alpha1, alpha2, offset = _f32([alpha1, alpha2, target_norm_offset], dev)
    base32 = base.to(torch.float32)
    d1 = ft1.to(torch.float32) - ft1_base.to(torch.float32)
    d2 = ft2.to(torch.float32) - ft2_base.to(torch.float32)
    n1 = torch.linalg.vector_norm(d1.reshape(-1))
    n2 = torch.linalg.vector_norm(d2.reshape(-1))
    target_norm = (n1 + n2) / 2.0 + offset

    swap = n1.abs() < n2.abs()
    norm_a = torch.where(swap, n2, n1)
    norm_b = torch.where(swap, n1, n2)
    a_weight, b_weight = alpha1, alpha2  # REF-QUIRK: never swapped

    cnorm_a = (norm_a / target_norm).abs()
    cnorm_b = (norm_b / target_norm).abs()
    n_ratio = cnorm_b / (cnorm_a + 1e-10)
    ratio = norm_b / (norm_a + 1e-10)
    a_prop = a_weight / (a_weight + b_weight)

    regime = torch.where(
        cnorm_a < 1e-6,
        0,
        torch.where(
            (cnorm_b < 1e-6) | (n_ratio < 0.1),
            1,
            torch.where(
                (norm_b < 1e-4) | (norm_a < 1e-4),
                2,
                torch.where(ratio < 0.1, 3, 4),
            ),
        ),
    )
    regime, swapped = torch.stack([regime, swap.to(torch.int64)]).tolist()
    a, b = (d2, d1) if swapped else (d1, d2)

    nan_count = torch.zeros((), dtype=torch.int64, device=dev)
    pair_inf = torch.zeros((), dtype=torch.bool, device=dev)
    ranks = (cutoff_k, cull_k, cull_count_limit)
    if regime == 0:
        merged = _pair_add(a, b)
    elif regime == 1:
        norm_scale = target_norm / norm_a
        weight_scale = b_weight / (a_weight + 1e-10)
        merged = _pair("arith", a, b, (norm_scale, weight_scale), (), None, fast_imag,
                       use_cull=False)[0]
    elif regime == 2:
        merged = (a / norm_a) * target_norm
    else:
        merged, nan_count, pair_inf = _pair(
            "lowratio" if regime == 3 else "slerp", a, b, (norm_a, norm_b, a_prop), ranks,
            target_norm, fast_imag, use_cull=use_cull,
        )
    out, final_inf = _finalize(base32, merged)
    return out, nan_count, pair_inf, final_inf, regime


# --- the stack reduction ----------------------------------------------------


def name_hash(name: str) -> str:
    """The stack name of a merged entry: each ``_``-separated part cut to 4
    characters, then 8 hex digits of the full name's sha256."""
    subnames = [n[:4] for n in name.split("_")]
    return "_".join(subnames) + "::" + hashlib.sha256(name.encode()).hexdigest()[:8]


def clamp(value: float, min_value: float, max_value: float) -> float:
    return max(min_value, min(value, max_value))


def _batched_norms(arrays: List[torch.Tensor], group=None) -> List[float]:
    """f32 norms of same-shaped tensors, read back with one host sync; with
    ``group`` the arrays are one rank's shares and the norms global (one
    all-reduce of the squares)."""
    norms = torch.stack([torch.linalg.vector_norm(a.reshape(-1)) for a in arrays])
    if group is not None:
        norms = group.all_reduce(norms.square()).sqrt()
    return norms.tolist()


def _select_regime(norm_a, norm_b, a_weight, b_weight, target_norm):
    """(regime, host params) of a pair ordered by norm, in float64 on the
    host."""
    cnorm_a = abs(norm_a / target_norm)
    cnorm_b = abs(norm_b / target_norm)
    n_ratio = cnorm_b / (cnorm_a + 1e-10)
    if cnorm_a < 1e-6:
        return "add", ()
    if cnorm_b < 1e-6 or n_ratio < 0.1:
        return "arith", (target_norm / norm_a, b_weight / (a_weight + 1e-10))
    # the <1e-4 early return can still fire for a tiny target_norm
    if norm_b < 1e-4 or norm_a < 1e-4:
        return "early", (norm_a,)
    params = (norm_a, norm_b, a_weight / (a_weight + b_weight))
    if norm_b / (norm_a + 1e-10) < 0.1:
        return "lowratio", params
    return "slerp", params


def _plan_round(stack, weights, norms, first_norms, target_norm):
    """One reduction round on the host.

    Returns (jobs, next stack, next weights): a job is (regime, a, b,
    output name, params) with a the larger-norm entry; leftovers carry over
    in their pairing position."""
    pairs = correlated_pairs(norm_product_matrix(first_norms[: len(stack)]), way="least")
    jobs, next_stack, next_weights = [], [], []
    for x, y, _ in pairs:
        if y < 0:
            next_stack.append(stack[x])
            next_weights.append(weights[x])
            continue
        a_model, b_model = stack[x], stack[y]
        a_weight, b_weight = weights[x], weights[y]  # REF-QUIRK: never swapped
        norm_a, norm_b = norms[x], norms[y]
        if abs(norm_a) < abs(norm_b):
            a_model, b_model = b_model, a_model
            norm_a, norm_b = norm_b, norm_a
        regime, params = _select_regime(norm_a, norm_b, a_weight, b_weight, target_norm)
        name = name_hash(f"{a_model}_{b_model}")
        next_stack.append(name)
        next_weights.append((a_weight + b_weight) / 2.0)
        jobs.append((regime, a_model, b_model, name, params))
    return jobs, next_stack, next_weights


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, page-locked and issued without blocking when
    ``t`` is on a card (the stream orders it before any copy back)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=True)
    return host


class FourierMerge(MergeTensorsBase):
    """The default merge engine: base + any number of finetunes."""

    # across ranks, tensors of this many elements split whatever their bytes:
    # the JAX engine's bound for a tensor too large to merge on one chip
    huge_tensor_numel = 1 << 29

    # same-regime pairs per batched dispatch (batch_rounds): bounds the
    # stacked operands' copy
    _BATCH_CHUNK = 4

    def __init__(
        self,
        config: MergeConfig,
        index_manager=None,
        *,
        device,
        target_norm_offset: float = 1e-10,
        cull_start_pct: float = 0.20,
        exact_imag: bool = False,
        hbm_budget_bytes: Optional[int] = None,
        batch_rounds: bool = False,
        comm=None,
        shard_min_bytes: int = 1 << 30,
        **pipeline,
    ):
        super().__init__(config, index_manager, device=device, **pipeline)
        models = [m.model for m in config.finetune_merge]
        twice = sorted({m for m in models if models.count(m) > 1})
        if twice and (len(models) > 2 or hbm_budget_bytes is not None):
            # the stack keys its entries by model: a duplicate would lose a
            # delta (the JAX engine raises KeyError on some tensors then)
            raise ConfigError(
                f"finetune_merge lists {twice} more than once; with 3 or more "
                "finetunes, or with hbm_budget_gb set, each model may appear once"
            )
        self.target_norm_offset = target_norm_offset
        self.cull_start_pct = cull_start_pct
        # True: the literal double-FFT imaginary recursion everywhere
        self.exact_imag = exact_imag
        # device bytes the delta stack may hold; above it every resident
        # entry moves to page-locked host memory until its next pair merge.
        # Setting it (even huge) sends 1-2 finetunes through the stack path.
        self.hbm_budget_bytes = hbm_budget_bytes
        # a round's same-regime pairs share their forward FFTs (same bits on
        # the host)
        self.batch_rounds = batch_rounds
        # the merge ranks (parallel/comm.py) and the sharding trigger in
        # input bytes (the other is huge_tensor_numel)
        self.comm = comm
        self.shard_min_bytes = shard_min_bytes
        # layer name -> ([(nan_count, pair_inf)], final_inf) device scalars,
        # read back once at write time
        self._deferred: Dict[str, tuple] = {}

    def _sharding_for(self, host: torch.Tensor) -> Optional[Placement]:
        comm = self.comm
        if comm is None or host.ndim < 2:
            return None
        if host.nbytes < self.shard_min_bytes and host.numel() < self.huge_tensor_numel:
            return None
        if host.ndim >= 3:
            # fused expert stacks: the FFT runs over the last two dims per
            # leading slice, so leading-dim shards keep every FFT rank-local;
            # a leading dim that does not divide the ranks is not padded
            # (zero slices would enter the global percentile ranks)
            if host.shape[0] % comm.size:
                logger.info("%d-D tensor's leading dim %d does not divide the %d ranks; not sharding",
                            host.ndim, host.shape[0], comm.size)
                return None
            return Placement(comm, "lead", tuple(host.shape))
        # the all-to-all splits the columns over the ranks; rows are padded
        if host.shape[-1] % comm.size:
            return None
        return Placement(comm, "rows", tuple(host.shape))

    def get_readme(self) -> str:
        models = "\n".join(
            f"- {m.model} (vs {m.base})" for m in self.config.finetune_merge
        )
        return (
            "# SLERP-FFT Merged Model\n"
            f"Base: {self.config.output_base_model}\n"
            f"Models merged:\n{models}\n"
        )

    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        if shard_layer.layer_number == INPUT_LAYER:
            return self._passthrough(shard_layer, "input")
        if shard_layer.layer_number == OUTPUT_LAYER:
            return self._passthrough(shard_layer, "output")

        models = [
            m
            for m in self.config.finetune_merge
            if m.use_layer_index(shard_layer.layer_number)
        ]
        if not models:
            logger.warning(
                "No models cover layer %s; passing base through",
                shard_layer.layer_name,
            )
            return self.get_base_output_tensor(shard_layer).to(torch.bfloat16)
        if len(models) <= 2 and self.hbm_budget_bytes is None and self.comm is None:
            return self._merge_layer_fused(shard_layer, models)

        name = shard_layer.layer_name
        entries = []
        for model in models:
            (delta,) = self.get_delta_for_models([model], shard_layer, apply_alpha=False)
            entries.append((model.model, delta, model.alpha))
        placement = self._placements.get(name)
        merged, checks = self.reduce_deltas(entries, placement=placement)
        out, final_inf = _finalize(self.get_base_output_tensor(shard_layer), merged,
                                   placement.comm if placement is not None else None)
        self._deferred[name] = (checks, final_inf)
        return out

    def _merge_layer_fused(self, shard_layer: ShardLayer, models) -> torch.Tensor:
        name = shard_layer.layer_name
        base_t = self._fetch(self.config.output_base_model, name)
        fts = [self._fetch(m.model, name) for m in models]
        ft_bases = [self._fetch(m.base, name) for m in models]
        if len(models) == 1:
            out, final_inf = _fused_single(base_t, ft_bases[0], fts[0])
            self.stats.record_pair("fused1")
            self._deferred[name] = ([], final_inf)
            return out

        numel = base_t.numel()
        cull_pct = self.cull_start_pct
        out, nan_count, pair_inf, final_inf, regime = _fused_pair(
            base_t,
            ft_bases[0],
            fts[0],
            ft_bases[1],
            fts[1],
            models[0].alpha,
            models[1].alpha,
            self.target_norm_offset,
            *_ranks(numel, cull_pct),
            use_cull=cull_pct > 0,
            fast_imag=_use_fast_imag(self.exact_imag, base_t),
        )
        self.stats.host_syncs += 1
        self.stats.record_pair(FUSED_REGIMES[regime])
        self._deferred[name] = ([(nan_count, pair_inf)], final_inf)
        return out

    def reduce_deltas(
        self,
        entries: List[Tuple[str, torch.Tensor, float]],
        trace: Optional[list] = None,
        placement: Optional[Placement] = None,
    ):
        """Reduce a stack of f32 deltas pairwise to one delta.

        ``entries`` are (name, delta, weight) in config order; the list is
        consumed (emptied), so the deltas free as the reduction merges them.
        A ``trace`` list gets (job, target_norm, cull_pct, a, b, merged) for
        every pair merge, the tensors as the merge saw them (to hold one
        device's pair merges to another's on the same inputs). With
        ``placement`` the deltas are this rank's shares of a tensor split
        over the merge ranks (``_sharding_for``).

        Returns (merged delta, checks): the pair merges' (nan_count,
        inf_flag) device scalars."""
        cache: Dict[str, torch.Tensor] = {}
        layer_stack: List[str] = []
        stack_weights: List[float] = []
        while entries:
            name, delta, weight = entries.pop(0)
            cache[name] = delta
            layer_stack.append(name)
            stack_weights.append(weight)
        checks: list = []
        if len(layer_stack) == 1:
            return cache[layer_stack[0]], checks

        comm = placement.comm if placement is not None else None
        layer_norms = _batched_norms([cache[n] for n in layer_stack], comm)
        self.stats.host_syncs += 1
        if not all(math.isfinite(n) for n in layer_norms):
            # the pairing cannot rank a non-finite norm: a round would pair
            # nothing and the reduction would never end
            raise ValueError(
                f"a delta of the stack has a non-finite norm ({layer_norms}): "
                "an Inf/NaN input or a difference that overflows float32"
            )
        # floats are read back; merged entries' norms stay device scalars
        # until the next round reads them all in one sync
        norms_by_name: Dict[str, object] = dict(zip(layer_stack, layer_norms))
        spilled: set = set()
        budget = self.hbm_budget_bytes

        def cache_put(name, value, norm=None):
            """Put a device value on the stack; above the budget, move every
            resident entry to host memory."""
            if norm is None:
                norm = torch.linalg.vector_norm(value.reshape(-1))
                # a rank's share: its square, summed over the ranks at the read
                norm = norm.square() if comm is not None else norm
            norms_by_name[name] = norm
            cache[name] = value
            spilled.discard(name)
            if budget is None:
                return
            resident = [n for n in cache if n not in spilled]
            nbytes = sum(cache[n].nbytes for n in resident)
            if nbytes > budget:
                for n in resident:
                    cache[n] = _host_copy(cache[n])
                    spilled.add(n)
                self.stats.hbm_spills += len(resident)
                logger.info(
                    "HBM budget exceeded: spilled %d stack entries (%.2f GiB) to host RAM",
                    len(resident),
                    nbytes / 2**30,
                )

        def cache_get(name):
            value = cache[name]
            return value.to(self.device, non_blocking=True) if name in spilled else value

        if budget is not None:
            for n in list(cache):
                if n not in spilled:  # the first put may spill them all
                    cache_put(n, cache[n], norm=norms_by_name[n])

        # target_norm = mean of the ORIGINAL delta norms + offset
        target_norm = (
            float(np.mean(np.asarray(layer_norms, dtype=np.float32)))
            + self.target_norm_offset
        )
        cull_pct = self.cull_start_pct
        can_batch = self.batch_rounds and budget is None and placement is None
        fast_imag = _use_fast_imag(self.exact_imag, cache[layer_stack[0]])

        while len(layer_stack) > 1:
            logger.info(
                "Processing %d layers : %s", len(layer_stack), ", ".join(layer_stack)
            )
            pending = [n for n in layer_stack if not isinstance(norms_by_name[n], float)]
            if pending:
                fetched = torch.stack([norms_by_name[n] for n in pending])
                if comm is not None:
                    fetched = comm.all_reduce(fetched).sqrt()
                fetched = fetched.tolist()
                for n, v in zip(pending, fetched):
                    norms_by_name[n] = v
                self.stats.host_syncs += 1
            current_norms = [norms_by_name[n] for n in layer_stack]
            jobs, next_stack, next_weights = _plan_round(
                layer_stack, stack_weights, current_norms, layer_norms, target_norm
            )
            if not jobs:
                raise ValueError(
                    f"no pair in a stack of {len(layer_stack)}: the norm products "
                    f"of {layer_norms[: len(layer_stack)]} overflow float32"
                )

            groups: Dict[str, list] = {}
            for job in jobs:
                groups.setdefault(job[0], []).append(job)
            for regime, group in groups.items():
                if can_batch and len(group) >= 2 and regime != "early":
                    for i in range(0, len(group), self._BATCH_CHUNK):
                        self._dispatch_batch(
                            group[i:i + self._BATCH_CHUNK], cache, cache_put,
                            target_norm, cull_pct, fast_imag, checks, trace,
                        )
                else:
                    for job in group:
                        a, b = cache_get(job[1]), cache_get(job[2])
                        merged, check = self.merge_pair(job, a, b, target_norm, cull_pct, placement)
                        if check is not None:
                            checks.append(check)
                        if trace is not None:
                            trace.append((job, target_norm, cull_pct, a, b, merged))
                        cache_put(job[3], merged)
                for _, a_model, b_model, _, _ in group:
                    self.stats.record_pair(regime if regime in ("add", "arith") else "slerp")
                    logger.info("%s merged %s and %s", regime.upper(), a_model, b_model)

            # free consumed operands: the stack's device bytes stay bounded
            # by its width
            for _, a_model, b_model, _, _ in jobs:
                for n in (a_model, b_model):
                    cache.pop(n, None)
                    norms_by_name.pop(n, None)
                    spilled.discard(n)
            layer_stack, stack_weights = next_stack, next_weights
            cull_pct = cull_pct / 2.0

        return cache_get(layer_stack[0]), checks

    def merge_pair(self, job, a, b, target_norm, cull_pct, placement: Optional[Placement] = None):
        """One pair merge of a planned job (``_plan_round``) on its operands
        ``a`` (the larger norm) and ``b``: (merged, (nan_count, inf_flag) or
        None for the regimes that flag nothing). With ``placement``, ``a``
        and ``b`` are this rank's shares."""
        regime, _, _, _, params = job
        if regime == "add":
            return _pair_add(a, b), None
        dev = a.device
        if regime == "early":
            norm_a, target = _f32([params[0], target_norm], dev)
            return (a / norm_a) * target, None
        *scalars, target = _f32([*params, target_norm], dev)
        if placement is None:
            # exact order statistics rank over the entry's element count
            merged, nan_count, has_inf = _pair(
                regime, a, b, scalars, _ranks(a.numel(), cull_pct), target,
                _use_fast_imag(self.exact_imag, a), use_cull=cull_pct > 0,
            )
            return merged, None if nan_count is None else (nan_count, has_inf)
        comm = placement.comm
        # the fast-imag gate sees the whole (padded) tensor, as the JAX
        # engine's does; the order statistics rank over the TRUE element
        # count (padded rows never enter the spectrum)
        fast = _use_fast_imag(self.exact_imag, a, a.numel() * comm.size)
        ranks = _ranks(placement.numel, cull_pct)
        if placement.kind == "lead":
            # every FFT is rank-local; the reductions are global
            merged, nan_count, has_inf = _pair(regime, a, b, scalars, ranks, target, fast,
                                               use_cull=cull_pct > 0, group=comm)
            return merged, None if nan_count is None else (nan_count, has_inf)
        true_m = placement.true_m
        if regime == "arith":
            return pmerge.sharded_pair_arith(comm, a, b, *scalars, fast_imag=fast, true_m=true_m), None
        if regime == "lowratio":
            merged, nan_count, has_inf = pmerge.sharded_pair_lowratio(
                comm, a, b, *scalars, target, fast_imag=fast, true_m=true_m)
        else:
            merged, nan_count, has_inf = pmerge.sharded_pair_slerp(
                comm, a, b, *scalars, *ranks, target, use_cull=cull_pct > 0, fast_imag=fast, true_m=true_m)
        return merged, (nan_count, has_inf)

    def _dispatch_batch(self, group, cache, cache_put, target_norm, cull_pct,
                        fast_imag, checks, trace):
        """Same-regime pairs of one round stacked on a leading axis: their
        forward FFTs and the elementwise passes before them run once over the
        batch (``_forward``), the blend with its order statistics and the
        inverse FFT per pair (``_inverse``; a batched inverse along a
        non-last axis changes bits on the host, where this path must give the
        per-pair bits)."""
        # each entry is consumed by exactly one pair a round: the originals
        # free as soon as the stack holds them
        A = torch.stack([cache.pop(j[1]) for j in group])
        B = torch.stack([cache.pop(j[2]) for j in group])
        regime = group[0][0]
        if regime == "add":
            outs = [(m, None) for m in (A + B).unbind(0)]
        else:
            dev = A.device
            scalars = _f32([list(j[4]) for j in group], dev)
            col = (len(group),) + (1,) * (A.ndim - 1)
            spectra = _forward(regime, A, B, [s.reshape(col) for s in scalars.unbind(1)],
                               fast_imag, batched=True)
            target = _f32(target_norm, dev)
            ranks = _ranks(A[0].numel(), cull_pct)
            outs = []
            for i in range(len(group)):
                merged, nan_count, has_inf = _inverse(
                    regime, [f[i] for f in spectra], A.shape[1:], scalars[i, -1], ranks, target,
                    fast_imag, use_cull=cull_pct > 0,
                )
                outs.append((merged, None if nan_count is None else (nan_count, has_inf)))
        for i, (job, (merged, check)) in enumerate(zip(group, outs)):
            if check is not None:
                checks.append(check)
            if trace is not None:
                trace.append((job, target_norm, cull_pct, A[i], B[i], merged))
            cache_put(job[3], merged)

    def _check_deferred(self, layer_name: str):
        raise_deferred(self.stats, layer_name, self._deferred.pop(layer_name, None))


def raise_deferred(stats, layer_name: str, entry) -> None:
    """Read a layer's deferred (checks, final_inf) device flags in one sync:
    count the scrubbed NaNs, and raise before the tensor is written on an
    Inf in a pair merge or in the result."""
    if entry is None:
        return
    checks, final_inf = entry
    flags = [v.to(torch.int64) for pair in checks for v in pair]
    values = torch.stack(flags + [final_inf.to(torch.int64)]).tolist()
    scrubbed = sum(values[0:-1:2])
    if scrubbed:
        logger.info("Warning: NaN in ifft output: %d", scrubbed)
        stats.nans_scrubbed += scrubbed
    if any(values[1:-1:2]):
        raise ValueError("Inf in ifft output")
    if values[-1]:
        raise ValueError(f"Inf in merged tensor for {layer_name}")
