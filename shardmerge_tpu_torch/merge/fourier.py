"""Fourier merge engine, base + 1 or 2 finetunes (counterpart of
shardmerge_tpu/merge/fourier.py).

Per tensor, as the JAX ``_fused_single`` / ``_fused_pair`` programs:

- each delta is taken against its model's own base, WITHOUT alpha; alphas
  only weight the pair interpolation;
- target_norm = mean of the f32 delta norms + offset;
- the pair is ordered by norm, the weights stay positional (REF-QUIRK);
- one of five regimes merges it: 0 add, 1 sign-agreement arithmetic,
  2 early return, 3 low-ratio additive FFT, 4 masked SLERP-FFT with exact
  8% cutoff and 20% cull;
- base + delta, NaN -> 0, Inf raises, bfloat16.

The JAX program picks the regime in-graph (``lax.switch``); here the same
f32 predicates run on the device and the regime is read back with ONE sync
per tensor, then only that branch runs. Large 2-D tensors take the rfft
half-spectrum path with the analytic fast-imag identity (see
``_FAST_IMAG_MIN_NUMEL``).

Three or more finetunes (the pairwise stack reduction) are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from ..config import MergeConfig
from ..constants import INPUT_LAYER, OUTPUT_LAYER
from ..io.writer import ShardLayer
from ..ops import blend
from .base import MergeTensorsBase

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


def _use_fast_imag(exact_imag: bool, arr: torch.Tensor) -> bool:
    return (not exact_imag) and arr.ndim >= 2 and arr.numel() >= _FAST_IMAG_MIN_NUMEL


def _rfft2(x):
    return torch.fft.rfftn(x, dim=(-2, -1))


def _irfft2(h, shape):
    return torch.fft.irfftn(h, s=shape[-2:], dim=(-2, -1))


def _scrub(merged, target_norm):
    """NaN -> 0 (counted), Inf flagged, then rescale to target_norm."""
    nan = torch.isnan(merged)
    nan_count = nan.sum()
    merged = merged.masked_fill(nan, 0.0)
    has_inf = torch.isinf(merged).any()
    return merged * target_norm, nan_count, has_inf


def _pair_add(a, b):
    """Regime 0: plain sum."""
    return a + b


def _pair_arith(a, b, norm_scale, weight_scale):
    """Regime 1, exact path: rescale, sign-agreement FFT arithmetic, t=1."""
    scaled_a = a * norm_scale
    scaled_b = b * weight_scale * norm_scale
    out = blend.arithmetic_fft_components(
        blend.fft2(scaled_a), blend.fft2(scaled_b), 1.0, agreement=True, do_imag=True
    )
    return blend.ifft2_real(out)


def _pair_arith_rfft(a, b, norm_scale, weight_scale):
    """Regime 1 on the half spectrum."""
    h0 = _rfft2(a * norm_scale)
    h1 = _rfft2(b * weight_scale * norm_scale)
    r0, r1 = h0.real, h1.real
    # REF-QUIRK: disagreeing lanes take v1
    res_real = torch.where(torch.sign(r0) == torch.sign(r1), r0 + r1, r1)
    return _irfft2(torch.complex(res_real, h0.imag), a.shape)


def _pair_lowratio(a, b, norm_a, norm_b, t, target_norm):
    """Regime 3, exact path: additive FFT blend."""
    merged = blend.ifft2_real(blend.fft2(a / norm_a) + t * blend.fft2(b / norm_b))
    return _scrub(merged, target_norm)


def _pair_lowratio_rfft(a, b, norm_a, norm_b, t, target_norm):
    h = _rfft2(a / norm_a) + t * _rfft2(b / norm_b)
    return _scrub(_irfft2(h, a.shape), target_norm)


def _pair_slerp(a, b, norm_a, norm_b, t, cutoff_k, cull_k, cull_count_limit,
                target_norm, *, use_cutoff, use_cull):
    """Regime 4, exact path: normalized masked SLERP-FFT blend with the
    double-FFT imaginary recursion."""
    result = blend.interpolate_fft_components(
        blend.fft2(a / norm_a),
        blend.fft2(b / norm_b),
        t,
        1.0,
        cutoff_k,
        cull_k,
        cull_count_limit,
        use_cutoff=use_cutoff,
        use_cull=use_cull,
        interp_imag=True,
    )
    return _scrub(blend.ifft2_real(result), target_norm)


def _pair_slerp_rfft(a, b, norm_a, norm_b, t, cutoff_k, cull_k, cull_count_limit,
                     target_norm, *, use_cutoff, use_cull):
    """Regime 4 on the rfft half spectrum (fast imag). The 1/norm scale is
    applied to the spectrum (FFT linearity), as in the JAX kernel."""
    h0 = _rfft2(a) * (1.0 / norm_a)
    h1 = _rfft2(b) * (1.0 / norm_b)
    result = blend.interpolate_half_spectrum(
        h0,
        h1,
        t,
        1.0,
        cutoff_k,
        cull_k,
        cull_count_limit,
        blend.hermitian_col_weights(a.shape[-1], device=a.device),
        use_cutoff=use_cutoff,
        use_cull=use_cull,
    )
    return _scrub(_irfft2(result, a.shape), target_norm)


def _finalize(base32, delta):
    """base + delta, NaN -> 0, Inf flag, bfloat16."""
    result = base32 + delta
    result = result.masked_fill(torch.isnan(result), 0.0)
    return result.to(torch.bfloat16), torch.isinf(result).any()


def _fused_single(out_base, ft_base, ft):
    """One finetune: out_base + (ft - ft_base), alpha not applied."""
    delta = ft.to(torch.float32) - ft_base.to(torch.float32)
    return _finalize(out_base.to(torch.float32), delta)


def _f32(value, device):
    return torch.as_tensor(value, dtype=torch.float32, device=device)


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
    alpha1, alpha2 = _f32(alpha1, dev), _f32(alpha2, dev)
    offset = _f32(target_norm_offset, dev)
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

    def code(c):
        return torch.tensor(c, dtype=torch.int64, device=dev)

    regime = torch.where(
        cnorm_a < 1e-6,
        code(0),
        torch.where(
            (cnorm_b < 1e-6) | (n_ratio < 0.1),
            code(1),
            torch.where(
                (norm_b < 1e-4) | (norm_a < 1e-4),
                code(2),
                torch.where(ratio < 0.1, code(3), code(4)),
            ),
        ),
    )
    regime, swapped = torch.stack([regime, swap.to(torch.int64)]).tolist()
    a, b = (d2, d1) if swapped else (d1, d2)

    nan_count = torch.zeros((), dtype=torch.int64, device=dev)
    pair_inf = torch.zeros((), dtype=torch.bool, device=dev)
    if regime == 0:
        merged = _pair_add(a, b)
    elif regime == 1:
        norm_scale = target_norm / norm_a
        weight_scale = b_weight / (a_weight + 1e-10)
        pair = _pair_arith_rfft if fast_imag else _pair_arith
        merged = pair(a, b, norm_scale, weight_scale)
    elif regime == 2:
        merged = (a / norm_a) * target_norm
    elif regime == 3:
        pair = _pair_lowratio_rfft if fast_imag else _pair_lowratio
        merged, nan_count, pair_inf = pair(a, b, norm_a, norm_b, a_prop, target_norm)
    else:
        pair = _pair_slerp_rfft if fast_imag else _pair_slerp
        merged, nan_count, pair_inf = pair(
            a, b, norm_a, norm_b, a_prop, cutoff_k, cull_k, cull_count_limit,
            target_norm, use_cutoff=True, use_cull=use_cull,
        )
    out, final_inf = _finalize(base32, merged)
    return out, nan_count, pair_inf, final_inf, regime


class FourierMerge(MergeTensorsBase):
    """The default merge engine for base + 1 or 2 finetunes."""

    def __init__(
        self,
        config: MergeConfig,
        index_manager=None,
        *,
        device,
        target_norm_offset: float = 1e-10,
        cull_start_pct: float = 0.20,
        exact_imag: bool = False,
    ):
        super().__init__(config, index_manager, device=device)
        self.target_norm_offset = target_norm_offset
        self.cull_start_pct = cull_start_pct
        # True: the literal double-FFT imaginary recursion everywhere
        self.exact_imag = exact_imag
        # layer name -> (nan_count, pair_inf, final_inf) device scalars,
        # read back once at write time
        self._deferred: Dict[str, tuple] = {}

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
            self.stats.tensors_passthrough += 1
            return self._passthrough(shard_layer, "input")
        if shard_layer.layer_number == OUTPUT_LAYER:
            self.stats.tensors_passthrough += 1
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
        if len(models) > 2:
            raise NotImplementedError(
                f"{len(models)} finetunes cover {shard_layer.layer_name}; the "
                "stack reduction for 3 or more finetunes is not ported yet"
            )

        name = shard_layer.layer_name
        base_t = self._fetch(self.config.output_base_model, name)
        fts = [self._fetch(m.model, name) for m in models]
        ft_bases = [self._fetch(m.base, name) for m in models]
        if len(models) == 1:
            out, final_inf = _fused_single(base_t, ft_bases[0], fts[0])
            self.stats.record_pair("fused1")
            self._deferred[name] = (None, None, final_inf)
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
            blend.cutoff_rank(numel, 0.08),
            blend.cull_rank(numel, cull_pct),
            blend.cull_limit(numel, cull_pct),
            use_cull=cull_pct > 0,
            fast_imag=_use_fast_imag(self.exact_imag, base_t),
        )
        self.stats.record_pair(FUSED_REGIMES[regime])
        self._deferred[name] = (nan_count, pair_inf, final_inf)
        return out

    def _check_deferred(self, layer_name: str):
        entry = self._deferred.pop(layer_name, None)
        if entry is None:
            return
        nan_count, pair_inf, final_inf = entry
        if nan_count is not None:
            scrubbed, pair_inf = torch.stack(
                [nan_count, pair_inf.to(torch.int64)]
            ).tolist()
            if scrubbed:
                logger.info("Warning: NaN in ifft output: %d", scrubbed)
                self.stats.nans_scrubbed += scrubbed
            if pair_inf:
                raise ValueError("Inf in ifft output")
        if bool(final_inf):
            raise ValueError(f"Inf in merged tensor for {layer_name}")
