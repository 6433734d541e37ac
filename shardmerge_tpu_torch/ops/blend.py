"""Spectral merge numerics (counterpart of shardmerge_tpu/ops/blend.py).

Plain torch functions on tensors; the FFTs are ``torch.fft`` (cuFFT on the
card, pocketfft on the host), as the JAX package runs them on XLA's FFT
outside any Pallas kernel. Masked reductions stand in for the reference's
gathered subsets, and percentile thresholds are exact order statistics
(ops/select.py) instead of a sort.

The reference tool's quirks are kept, each marked REF-QUIRK:

- both cutoff "small value" masks test ``|Re v1|``, never v0;
- in ``arithmetic_fft_components`` disagreeing lanes always take v1.

Across ranks (parallel/merge.py), ``group`` (a parallel/comm.py ``Comm``)
makes every reduction of the blends global: the order-statistic counts, the
cull's count and the SLERP's dot and norms are summed over the ranks (JAX's
``axis_name`` psums), and ``fft_fn``/``ifft_fn`` carry the distributed FFTs
of the imaginary recursion.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .select import kth_smallest_nonneg, kth_smallest_nonneg2, kth_smallest_weighted

__all__ = [
    "fft2",
    "ifft2_real",
    "normalize_tensor",
    "slerp",
    "interpolate_fft_components",
    "interpolate_half_spectrum",
    "arithmetic_fft_components",
    "task_arithmetic_fft2",
    "merge_tensors_fft2_slerp",
    "hermitian_col_weights",
    "cutoff_rank",
    "cull_rank",
    "cull_limit",
]


def fft2(x: torch.Tensor) -> torch.Tensor:
    """f32 -> complex64 FFT; 1-D uses fft, >=2-D fftn over the last two axes."""
    x = x.to(torch.float32)
    if x.ndim == 1:
        return torch.fft.fft(x)
    return torch.fft.fftn(x, dim=(-2, -1))


def ifft2_real(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fft2`, real part."""
    if x.ndim == 1:
        return torch.fft.ifft(x).real
    return torch.fft.ifftn(x, dim=(-2, -1)).real


# Host-side ranks: the reference indexes a sorted array at int(len * pct)
# (int() truncates toward zero).


def cutoff_rank(numel_each: int, cutoff_pct: float) -> int:
    """Rank into sorted concat(|Re v0|, |Re v1|), clamped to the maximum."""
    total = 2 * numel_each
    return min(int(total * cutoff_pct), total - 1)


def cull_rank(numel: int, cull_pct: float) -> int:
    return int(numel * cull_pct)


def cull_limit(numel: int, cull_pct: float) -> int:
    """``count > len * (cull_pct * 2)`` as an integer bound."""
    return int(math.floor(numel * (cull_pct * 2)))


def normalize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x / ||x||, ||x||); x unchanged when the norm is 0."""
    norm = torch.linalg.vector_norm(x.reshape(-1))
    return torch.where(norm != 0, x / norm, x), norm


def _wsum(x: torch.Tensor, col_weights: Optional[torch.Tensor]) -> torch.Tensor:
    if col_weights is not None:
        x = x * col_weights
    return x.sum()


def _gsum(parts, group=None):
    """The local sums ``parts`` (0-d tensors), summed over ``group``'s ranks
    in one all-reduce when given."""
    if group is None:
        return parts
    return group.all_reduce(torch.stack(parts)).unbind(0)


def _masked_slerp(v0, v1, t, mask, col_weights=None, group=None):
    """Global-dot SLERP over the masked element subset; ``col_weights``
    weights each column by its Hermitian multiplicity (half spectra). The
    relative vector's norm is clamped at 1e-12 like
    ``torch.nn.functional.normalize``. With ``group`` the dot and the norms
    are global (two all-reduces: the dot and both norms, then the relative
    vector's norm)."""
    zero = torch.zeros((), dtype=v0.dtype, device=v0.device)
    dot_num, s0, s1 = _gsum([
        _wsum(torch.where(mask, v0 * v1, zero), col_weights),
        _wsum(torch.where(mask, v0 * v0, zero), col_weights),
        _wsum(torch.where(mask, v1 * v1, zero), col_weights),
    ], group)
    n0, n1 = torch.sqrt(s0), torch.sqrt(s1)
    dot = torch.clamp(dot_num / (n0 * n1), -1.0, 1.0)
    theta = torch.arccos(dot) * t
    rel = v1 - v0 * dot
    (rel_sq,) = _gsum([_wsum(torch.where(mask, rel * rel, zero), col_weights)], group)
    rel_norm = torch.sqrt(rel_sq)
    rel = rel / torch.clamp(rel_norm, min=1e-12)
    return v0 * torch.cos(theta) + rel * torch.sin(theta)


def slerp(v0: torch.Tensor, v1: torch.Tensor, t) -> torch.Tensor:
    """Global-dot spherical interpolation."""
    return _masked_slerp(v0, v1, t, torch.ones(v0.shape, dtype=torch.bool, device=v0.device))


def _blend_real(r0, r1, t, t_sum, cutoff_thr, col_weights=None, group=None):
    """The shared masked blend of two real planes."""
    a0, a1 = r0.abs(), r1.abs()
    sign_mask = torch.sign(r0) == torch.sign(r1)
    small = a1 < cutoff_thr  # REF-QUIRK: |Re v1| on both masks
    slerp_mask = sign_mask & ~small
    sum_mask = sign_mask & small
    larger = a0 > a1
    slerp_vals = _masked_slerp(r0, r1, t, slerp_mask, col_weights, group)
    return torch.where(
        slerp_mask,
        slerp_vals,
        torch.where(sum_mask, r0 + t_sum * r1, torch.where(larger, r0, r1)),
    )


def _cull(res_real, cull_thr, below, cull_count_limit):
    """Zero |res| < threshold unless that would zero more than the limit
    (mass ties at the threshold). Decided on the device: no host sync."""
    return res_real.masked_fill((res_real.abs() < cull_thr) & (below <= cull_count_limit), 0.0)


def interpolate_fft_components(
    v0_fft: torch.Tensor,
    v1_fft: torch.Tensor,
    t,
    t_sum,
    cutoff_k,
    cull_k,
    cull_count_limit,
    *,
    use_cutoff: bool,
    use_cull: bool,
    interp_imag: bool = True,
    group=None,
    fft_fn=None,
    ifft_fn=None,
) -> torch.Tensor:
    """Masked spectral blend of two complex FFTs.

    ``cutoff_k``/``cull_k`` are global ranks from :func:`cutoff_rank` /
    :func:`cull_rank`, ``cull_count_limit`` from :func:`cull_limit`. With
    ``interp_imag`` the imaginary planes are FFT'd again and blended with
    cutoff = cull = 0 (the reference's double-FFT recursion); without it the
    imaginary part of v0 passes through. Across ranks, ``group`` makes the
    reductions global and ``fft_fn``/``ifft_fn`` are the recursion's
    distributed transforms (default: :func:`fft2`, :func:`ifft2_real`)."""
    fft_fn = fft_fn or fft2
    ifft_fn = ifft_fn or ifft2_real
    r0, r1 = v0_fft.real, v1_fft.real
    if use_cutoff:
        cutoff_thr = kth_smallest_nonneg2(r0.abs(), r1.abs(), cutoff_k, group)
    else:
        cutoff_thr = torch.zeros((), dtype=torch.float32, device=r0.device)
    res_real = _blend_real(r0, r1, t, t_sum, cutoff_thr, group=group)

    if use_cull:
        abs_res = res_real.abs()
        cull_thr = kth_smallest_nonneg(abs_res, cull_k, group)
        (below,) = _gsum([(abs_res < cull_thr).sum()], group)
        res_real = _cull(res_real, cull_thr, below, cull_count_limit)

    if interp_imag:
        inner = interpolate_fft_components(
            fft_fn(v0_fft.imag),
            fft_fn(v1_fft.imag),
            t,
            t_sum,
            0,
            0,
            0,
            use_cutoff=False,
            use_cull=False,
            interp_imag=False,
            group=group,
        )
        res_imag = ifft_fn(inner)
    else:
        res_imag = v0_fft.imag
    return torch.complex(res_real, res_imag)


def hermitian_col_weights(n_cols_full: int, device=None) -> torch.Tensor:
    """Multiplicity of each rfft half-spectrum column in the full spectrum:
    2 for interior columns, 1 for DC and (even N) Nyquist."""
    c = n_cols_full // 2 + 1
    w = torch.full((c,), 2.0, dtype=torch.float32, device=device)
    w[0] = 1.0
    if n_cols_full % 2 == 0:
        w[-1] = 1.0
    return w


def interpolate_half_spectrum(
    h0: torch.Tensor,
    h1: torch.Tensor,
    t,
    t_sum,
    cutoff_k,
    cull_k,
    cull_count_limit,
    col_weights: torch.Tensor,
    *,
    use_cutoff: bool,
    use_cull: bool,
    group=None,
) -> torch.Tensor:
    """The fast-imag blend on rfft half spectra (M, N//2+1).

    Elementwise steps are mirror-symmetric, so they run on the half as is;
    every reduction weights column j by ``col_weights[j]``, reproducing the
    full-spectrum values (ranks are the full-spectrum ranks). The imaginary
    part of h0 passes through. With ``group`` the reductions are global
    (a rank's columns weighed by its own ``col_weights``)."""
    r0, r1 = h0.real, h1.real
    wrow = col_weights.reshape(1, -1) if r0.ndim >= 2 else col_weights
    if use_cutoff:
        cutoff_thr = kth_smallest_weighted(r0.abs(), cutoff_k, col_weights, y=r1.abs(), group=group)
    else:
        cutoff_thr = torch.zeros((), dtype=torch.float32, device=r0.device)
    res_real = _blend_real(r0, r1, t, t_sum, cutoff_thr, wrow, group)

    if use_cull:
        abs_res = res_real.abs()
        cull_thr = kth_smallest_weighted(abs_res, cull_k, col_weights, group=group)
        # integer-weighted count: exact beyond 2^24 elements
        per_col = (abs_res < cull_thr).reshape(-1, abs_res.shape[-1]).sum(dim=0)
        (below,) = _gsum([(per_col * col_weights.to(torch.int64)).sum()], group)
        res_real = _cull(res_real, cull_thr, below, cull_count_limit)
    return torch.complex(res_real, h0.imag)


def arithmetic_fft_components(
    v0_fft: torch.Tensor,
    v1_fft: torch.Tensor,
    t,
    *,
    agreement: bool,
    do_imag: bool = True,
    fft_fn=None,
    ifft_fn=None,
) -> torch.Tensor:
    """Sign-agreement arithmetic on FFT real parts, with the same imaginary
    recursion as :func:`interpolate_fft_components` (elementwise, so any
    layout; ``fft_fn``/``ifft_fn`` as there)."""
    fft_fn = fft_fn or fft2
    ifft_fn = ifft_fn or ifft2_real
    r0, r1 = v0_fft.real, v1_fft.real
    if agreement:
        sign_mask = torch.sign(r0) == torch.sign(r1)
    else:
        sign_mask = torch.ones(r0.shape, dtype=torch.bool, device=r0.device)
    # REF-QUIRK: the reference's larger-magnitude mask compares v0 with
    # itself, so disagreeing lanes always take v1
    res_real = torch.where(sign_mask, r0 + t * r1, r1)
    if do_imag:
        inner = arithmetic_fft_components(
            fft_fn(v0_fft.imag), fft_fn(v1_fft.imag), t, agreement=agreement, do_imag=False
        )
        res_imag = ifft_fn(inner)
    else:
        res_imag = v0_fft.imag
    return torch.complex(res_real, res_imag)


def task_arithmetic_fft2(v0: torch.Tensor, v1: torch.Tensor, t, *, agreement: bool = True) -> torch.Tensor:
    """FFT both, :func:`arithmetic_fft_components` (with the imaginary
    recursion), inverse FFT, real part."""
    return ifft2_real(arithmetic_fft_components(fft2(v0), fft2(v1), t, agreement=agreement))


# --- the full pair merge: spectral bodies and the host wrapper ---------------
# The reference's public pair-merge API, kept for parity with the JAX
# module's (its own callers are tests and a benchmark). No engine calls it:
# the fourier engines merge pairs through merge/fourier.py's ``_pair_*``.


def _norms2(v0: torch.Tensor, v1: torch.Tensor):
    return torch.linalg.vector_norm(v0.reshape(-1)), torch.linalg.vector_norm(v1.reshape(-1))


def _scrub_nans(merged: torch.Tensor, group=None):
    """(merged with NaN -> 0, NaN count, Inf flag); with ``group`` the count
    and the flag are summed over its ranks (one all-reduce)."""
    nan = torch.isnan(merged)
    merged = merged.masked_fill(nan, 0.0)
    nan_count, has_inf = nan.sum(), torch.isinf(merged).any()
    if group is not None:
        nan_count, infs = group.all_reduce(torch.stack([nan_count, has_inf.to(torch.int64)])).unbind(0)
        has_inf = infs > 0
    return merged, nan_count, has_inf


def _slerp_merge_body(v0n, v1n, t, t_sum, cutoff_k, cull_k, cull_count_limit, *, use_cutoff, use_cull):
    """The masked SLERP-FFT blend of two normalized tensors, inverted:
    (merged, NaN count, Inf flag)."""
    result = interpolate_fft_components(
        fft2(v0n), fft2(v1n), t, t_sum, cutoff_k, cull_k, cull_count_limit,
        use_cutoff=use_cutoff, use_cull=use_cull,
    )
    return _scrub_nans(ifft2_real(result))


def _lowrank_add_body(v0n, v1n, t):
    """The additive path of a low norm ratio: ifft(fft(v0n) + t fft(v1n))."""
    return _scrub_nans(ifft2_real(fft2(v0n) + t * fft2(v1n)))


def merge_tensors_fft2_slerp(
    v0: torch.Tensor,
    v1: torch.Tensor,
    t: float,
    b: float = 0.1,
    t_sum: float = 1.0,
    cutoff_pct: float = 0.0,
    cull_pct: float = 0.0,
    norms: Optional[Tuple[float, float]] = None,
):
    """The full pair merge: (merged, norm_v0, norm_v1), unscaled (the
    caller rescales). The norm-dependent branches run on the host: tiny
    norms return the normalized v0, a norm ratio below ``b`` takes the
    additive path, anything else the masked SLERP-FFT blend; an Inf in the
    inverse raises. Pass ``norms`` to skip reading them back."""
    if norms is None:
        norm_v0, norm_v1 = (float(n) for n in torch.stack(_norms2(v0, v1)).tolist())
    else:
        norm_v0, norm_v1 = float(norms[0]), float(norms[1])
    # divide by f32 device scalars: a division by a Python float on a card
    # multiplies by its reciprocal
    n0, n1 = (torch.tensor(n, dtype=torch.float32, device=v0.device) for n in (norm_v0, norm_v1))
    v0n = v0 / n0 if norm_v0 != 0 else v0
    v1n = v1 / n1 if norm_v1 != 0 else v1
    if norm_v1 < 1e-4 or norm_v0 < 1e-4:
        return v0n, norm_v0, norm_v1
    ratio = norm_v1 / (norm_v0 + 1e-10)
    t32 = float(np.float32(t))
    if ratio < b:
        merged, _, has_inf = _lowrank_add_body(v0n, v1n, t32)
    else:
        numel = v0.numel()
        merged, _, has_inf = _slerp_merge_body(
            v0n, v1n, t32, float(np.float32(t_sum)),
            cutoff_rank(numel, cutoff_pct), cull_rank(numel, cull_pct), cull_limit(numel, cull_pct),
            use_cutoff=cutoff_pct > 0, use_cull=cull_pct > 0,
        )
    if bool(has_inf):
        raise ValueError("Inf in ifft output")
    return merged, norm_v0, norm_v1
