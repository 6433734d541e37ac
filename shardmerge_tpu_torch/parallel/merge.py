"""Distributed pair merges: the fourier merge's regimes across ranks
(counterpart of shardmerge_tpu/parallel/merge.py).

A 2-D tensor row-sharded over the merge ranks runs the single-device blend
math with distributed FFTs (parallel/fft2d.py) and all-reduced reductions
(ops/blend.py and ops/select.py with ``group``). Numerics match the
single-device path: the order-statistic thresholds are exact global ranks,
from bit bisection over all-reduced counts.

The slerp runs on the rfft half spectrum when ``fast_imag`` is on and
N % 2P == 0 (the ragged Nyquist column rides replicated with a
position-0-only weight; fft2d.rfft2_rs_half); otherwise on the full complex
spectrum. Arguments ``a``/``b`` are this rank's row blocks of the (possibly
zero-padded) tensors; scalars are floats or 0-d f32 tensors. NaN counts and
Inf flags come back global (one all-reduce), so every rank raises at the
same tensor.

The JAX module caches one compiled program per (mesh, kernel, flags)
(``_KERNEL_CACHE``); these are eager torch calls with nothing to compile, so
the port keeps no such cache.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from ..ops import blend
from .fft2d import fft2_cs, fft2_rs, half_col_weights, ifft2_cs, ifft2_rs, irfft2_half_rs, rfft2_rs_half

__all__ = ["sharded_pair_slerp", "sharded_pair_arith", "sharded_pair_lowratio", "use_rfft"]


def use_rfft(fast_imag: bool, n_cols: int, ranks: int) -> bool:
    """Whether a pair of ``n_cols`` columns merges on the half spectrum."""
    return fast_imag and n_cols % (2 * ranks) == 0


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    t = torch.tensor(float(v), dtype=torch.float32)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _scrub(merged: torch.Tensor, target_norm, comm) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NaN -> 0 (counted over the ranks), the Inf flag over the ranks, then
    the rescale: (merged, nan_count, has_inf)."""
    merged, nan_count, has_inf = blend._scrub_nans(merged, comm)
    return merged * target_norm, nan_count, has_inf


def _pads(comm, a, true_m):
    """(true_m, pad_m): pad_m is the padded global row count."""
    return true_m, (a.shape[0] * comm.size if true_m is not None else None)


def sharded_pair_slerp(
    comm,
    a: torch.Tensor,
    b: torch.Tensor,
    norm_a,
    norm_b,
    t,
    cutoff_k: int,
    cull_k: int,
    cull_count_limit: int,
    target_norm,
    use_cull: bool,
    fast_imag: bool = True,
    true_m: Optional[int] = None,
):
    """Regime (c), the masked SLERP-FFT blend, across the ranks: the contract
    of merge/fourier.py's slerp pair merge on row blocks. ``true_m``: the
    true global row count when the caller zero-padded rows to divide the
    ranks (merged rows beyond it are zeros; the engine drops them).

    Returns (merged rows, nan_count, has_inf)."""
    dev = a.device
    true_m, pad_m = _pads(comm, a, true_m)
    norm_a, norm_b, t, target_norm = (_f32(v, dev) for v in (norm_a, norm_b, t, target_norm))
    n = a.shape[-1]
    if use_rfft(fast_imag, n, comm.size):
        h0 = rfft2_rs_half(a / norm_a, comm, true_m)
        h1 = rfft2_rs_half(b / norm_b, comm, true_m)
        result = blend.interpolate_half_spectrum(
            h0, h1, t, 1.0, cutoff_k, cull_k, cull_count_limit,
            half_col_weights(n, h0.shape[1] - 1, comm),
            use_cutoff=True, use_cull=use_cull, group=comm,
        )
        merged = irfft2_half_rs(result, comm, n, pad_m)
    else:
        result = blend.interpolate_fft_components(
            fft2_rs(a / norm_a, comm, true_m),
            fft2_rs(b / norm_b, comm, true_m),
            t, 1.0, cutoff_k, cull_k, cull_count_limit,
            use_cutoff=True, use_cull=use_cull, interp_imag=not fast_imag, group=comm,
            # the imaginary planes: CS -> RS (padding rows ride as zeros) and back
            fft_fn=partial(fft2_cs, comm=comm, pad_m=pad_m),
            ifft_fn=partial(ifft2_rs, comm=comm, true_m=true_m),
        )
        merged = ifft2_cs(result, comm, pad_m)
    return _scrub(merged, target_norm, comm)


def sharded_pair_arith(
    comm, a, b, norm_scale, weight_scale, fast_imag: bool = True, true_m: Optional[int] = None
) -> torch.Tensor:
    """Regime (b), sign-agreement arithmetic at t=1, across the ranks:
    merged rows (no reduction, so nothing to flag)."""
    dev = a.device
    true_m, pad_m = _pads(comm, a, true_m)
    norm_scale, weight_scale = _f32(norm_scale, dev), _f32(weight_scale, dev)
    n = a.shape[-1]
    if use_rfft(fast_imag, n, comm.size):
        h0 = rfft2_rs_half(a * norm_scale, comm, true_m)
        h1 = rfft2_rs_half(b * weight_scale * norm_scale, comm, true_m)
        r0, r1 = h0.real, h1.real
        # REF-QUIRK: disagreeing lanes take v1
        res_real = torch.where(torch.sign(r0) == torch.sign(r1), r0 + r1, r1)
        return irfft2_half_rs(torch.complex(res_real, h0.imag), comm, n, pad_m)
    out = blend.arithmetic_fft_components(
        fft2_rs(a * norm_scale, comm, true_m),
        fft2_rs(b * weight_scale * norm_scale, comm, true_m),
        1.0,
        agreement=True,
        fft_fn=partial(fft2_cs, comm=comm, pad_m=pad_m),
        ifft_fn=partial(ifft2_rs, comm=comm, true_m=true_m),
    )
    return ifft2_cs(out, comm, pad_m)


def sharded_pair_lowratio(
    comm, a, b, norm_a, norm_b, t, target_norm, fast_imag: bool = True, true_m: Optional[int] = None
):
    """Regime (c) at a low norm ratio, the additive FFT blend, across the
    ranks: (merged rows, nan_count, has_inf)."""
    dev = a.device
    true_m, pad_m = _pads(comm, a, true_m)
    norm_a, norm_b, t, target_norm = (_f32(v, dev) for v in (norm_a, norm_b, t, target_norm))
    n = a.shape[-1]
    if use_rfft(fast_imag, n, comm.size):
        h = rfft2_rs_half(a / norm_a, comm, true_m) + t * rfft2_rs_half(b / norm_b, comm, true_m)
        merged = irfft2_half_rs(h, comm, n, pad_m)
    else:
        f = fft2_rs(a / norm_a, comm, true_m) + t * fft2_rs(b / norm_b, comm, true_m)
        merged = ifft2_cs(f, comm, pad_m)
    return _scrub(merged, target_norm, comm)
