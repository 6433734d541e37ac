"""Four-step DFT kernels for Hopper (counterpart of
shardmerge_tpu/ops/pallas_fft.py).

``dft_rows(xr, xi)`` is the complex DFT along the last axis of (M, N) f32
real/imaginary planes, ``dft_cols`` the same along the first axis, and
``fft2_mxu``/``ifft2_mxu`` compose the two into a 2-D transform. Each axis
of length n runs the four-step (Cooley-Tukey as matrix products)
decomposition of the JAX module, with n = n1*n2 from :func:`good_split`,
input index n2*N1 + n1 and output index k1*N2 + k2:

    X[k1*N2 + k2] = sum_n1 W1[k1,n1] * w^(n1*k2) *
                        ( sum_n2 W2[k2,n2] * x[n2*N1 + n1] )

On a CUDA tensor each wrapper launches ``csrc/four_step_dft.cu`` (built
for sm_90a with ``nvcc`` at first use, bound with ctypes) or raises: f32
FMAs on the CUDA cores, never TF32. On a CPU tensor it runs the plain
version (:func:`dft_rows_plain`, :func:`dft_cols_plain`), the same
arithmetic in f32 torch matmuls. The W1/W2/twiddle tables are built in
float64 numpy and rounded to f32, bit-equal to the JAX module's.

Like the JAX module, nothing in the merge calls these transforms: the merge
engines keep the library FFT (``torch.fft``).

Each launch adds one to ``launch_counts["dft_rows"]`` or
``launch_counts["dft_cols"]``.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernel_build

__all__ = [
    "dft_rows",
    "dft_cols",
    "fft2_mxu",
    "ifft2_mxu",
    "good_split",
    "dft_rows_plain",
    "dft_cols_plain",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

_SOURCE = kernel_build.CSRC / "four_step_dft.cu"

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def build(verbose: bool = False) -> Path:
    """Compile the kernels into ``_build/`` (once per source content) and
    return the shared library's path."""
    return kernel_build.build(_SOURCE, verbose)


def good_split(n: int) -> Tuple[int, int]:
    """Split n = n1*n2 with factors as close as possible (n2 >= n1); a
    prime n gives (1, n)."""
    for n1 in range(int(math.isqrt(n)), 0, -1):
        if n % n1 == 0:
            return (n1, n // n1)
    return (1, n)


@lru_cache(maxsize=32)
def _factors(n: int, inverse: bool, device="cpu") -> Tuple[torch.Tensor, ...]:
    """DFT matrices W1 (n1, n1), W2 (n2, n2) and twiddles tw (n1, n2),
    built in float64 numpy and rounded once to f32, as re/im planes (w1r,
    w1i, w2r, w2i, twr, twi) on ``device``; cached per (n, inverse,
    device)."""
    n1, n2 = good_split(n)
    sign = 2j if inverse else -2j
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    w1 = np.exp(sign * np.pi * np.outer(k1, k1) / n1)
    w2 = np.exp(sign * np.pi * np.outer(k2, k2) / n2)
    tw = np.exp(sign * np.pi * np.outer(k1, k2) / n)
    planes = (w1.real, w1.imag, w2.real, w2.imag, tw.real, tw.imag)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in planes)


def _check_tf32(x: torch.Tensor) -> None:
    """The JAX kernel multiplies at Precision.HIGHEST: on the card the
    plain version's matmuls must not round their inputs to TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain DFT needs full f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _cmm(ar, ai, br, bi):
    """Complex matmul on real planes, as 4 real products."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def dft_rows_plain(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """The four-step arithmetic of ``_rows_kernel`` in f32 torch."""
    _check_tf32(xr)
    m, n = xr.shape
    n1, n2 = good_split(n)
    w1r, w1i, w2r, w2i, twr, twi = _factors(n, inverse, xr.device)
    # input split n = n2*N1 + n1: (M, N) -> (M, n1, n2) after the swap;
    # contract n2 with W2[k2, n2] -> (M, n1, k2)
    x3r = xr.reshape(m, n2, n1).transpose(1, 2)
    x3i = xi.reshape(m, n2, n1).transpose(1, 2)
    br, bi = _cmm(x3r, x3i, w2r.T, w2i.T)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # contract n1 with W1[k1, n1] -> (M, k1, k2); output k = k1*N2 + k2
    dr, di = _cmm(w1r, w1i, cr, ci)
    out_r = dr.reshape(m, n)
    out_i = di.reshape(m, n)
    if inverse:
        out_r = out_r / n
        out_i = out_i / n
    return out_r, out_i


def dft_cols_plain(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """The four-step arithmetic of ``_cols_kernel`` in f32 torch."""
    _check_tf32(xr)
    m, n = xr.shape
    m1, m2 = good_split(m)
    w1r, w1i, w2r, w2i, twr, twi = _factors(m, inverse, xr.device)
    # input split r = r2*M1 + r1: (M, N) -> (m2, m1*N); contract r2 with
    # W2[k2, r2] -> (k2, r1, N)
    br, bi = _cmm(w2r, w2i, xr.reshape(m2, m1 * n), xi.reshape(m2, m1 * n))
    br = br.reshape(m2, m1, n)
    bi = bi.reshape(m2, m1, n)
    tr = twr.T[:, :, None]  # tw[r1, k2] -> (k2, r1, 1)
    ti = twi.T[:, :, None]
    cr = br * tr - bi * ti
    ci = br * ti + bi * tr
    # contract r1 with W1[k1, r1] -> (k2, k1, N); output row k = k1*M2 + k2
    dr, di = _cmm(w1r, w1i, cr, ci)
    out_r = dr.transpose(0, 1).reshape(m, n)
    out_i = di.transpose(0, 1).reshape(m, n)
    if inverse:
        out_r = out_r / m
        out_i = out_i / m
    return out_r, out_i


def _bind(lib) -> None:
    for name in ("dft_rows", "dft_cols"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _launch(name: str, xr: torch.Tensor, xi: torch.Tensor, inverse: bool):
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the planes must be float32")
    if xr.dim() != 2 or xi.shape != xr.shape or xi.device != xr.device:
        raise ValueError(f"{name}: need two 2-D planes of one shape on one device")
    m, n = xr.shape
    if m < 1 or n < 1:
        raise ValueError(f"{name}: empty planes {tuple(xr.shape)}")
    length = n if name == "dft_rows" else m
    a, b = good_split(length)
    xr = xr.contiguous()
    xi = xi.contiguous()
    dev = xr.device
    tables = _factors(length, inverse, dev)
    scratch_r = torch.empty_like(xr)
    scratch_i = torch.empty_like(xr)
    out_r = torch.empty_like(xr)
    out_i = torch.empty_like(xr)
    with torch.cuda.device(dev):
        err = getattr(kernel_build.load(_SOURCE, _bind), name)(
            xr.data_ptr(),
            xi.data_ptr(),
            *(t.data_ptr() for t in tables),
            scratch_r.data_ptr(),
            scratch_i.data_ptr(),
            out_r.data_ptr(),
            out_i.data_ptr(),
            m,
            n,
            a,
            b,
            int(inverse),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launch_counts[name] += 1
    return out_r, out_i


def dft_rows(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """Complex DFT along the last axis of (M, N) f32 planes -> (re, im);
    the inverse includes the 1/N scale. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if not xr.is_cuda:
        return dft_rows_plain(xr, xi, inverse=inverse)
    return _launch("dft_rows", xr, xi, inverse)


def dft_cols(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False):
    """Complex DFT along the first axis of (M, N) f32 planes -> (re, im);
    the inverse includes the 1/M scale."""
    if not xr.is_cuda:
        return dft_cols_plain(xr, xi, inverse=inverse)
    return _launch("dft_cols", xr, xi, inverse)


def fft2_mxu(xr: torch.Tensor, xi: Optional[torch.Tensor] = None):
    """2-D DFT of f32 planes through the two kernels; returns (re, im)."""
    if xi is None:
        xi = torch.zeros_like(xr)
    yr, yi = dft_rows(xr, xi)
    return dft_cols(yr, yi)


def ifft2_mxu(xr: torch.Tensor, xi: torch.Tensor):
    yr, yi = dft_cols(xr, xi, inverse=True)
    return dft_rows(yr, yi, inverse=True)
