"""Complex DFT kernels for Hopper (counterpart of
shardmerge_tpu/ops/pallas_fft.py).

``dft_rows(xr, xi)`` is the complex DFT along the last axis of (M, N) f32
real/imaginary planes, ``dft_cols`` the same along the first axis, and
``fft2_mxu``/``ifft2_mxu`` compose the two into a 2-D transform. They
replace the TPU kernels ``_rows_kernel`` (pallas_call at
shardmerge_tpu/ops/pallas_fft.py:157) and ``_cols_kernel`` (:222), which run
each axis as the four-step decomposition n = n1*n2 (:func:`good_split`) with
dense W1 (n1, n1) and W2 (n2, n2) products on the MXU.

On a CUDA tensor each wrapper launches ``csrc/four_step_dft.cu`` (built for
sm_90a with ``nvcc`` at first use, bound with ctypes) or raises. The kernel
does an FFT's arithmetic, not the dense products: mixed-radix Stockham
stages (radices 8, 4, 2, 7, 5, 3 and a direct-sum stage for any other
prime) on whole lines held in shared memory, f32 FMAs, never TF32. On the
card it is bound by bytes: 16 per element where a line (or a strip of
adjacent columns) fits in one block, one launch; 32 per element where it
does not, two launches of the four-step split n = n1*n2 through an (M, N)
scratch pair, each running its short FFTs on strips of adjacent columns.
:func:`_plan` decides the route and every pass's index maps on the host;
:func:`_simulate` runs that schedule in float64 numpy, so the CPU tests
check the maps without a card. The roots and twiddles come from one table
of e^(sign*2*pi*i*t/n), computed in float64 and rounded once to f32
(:func:`_roots`).

On a CPU tensor each wrapper runs the plain version (:func:`dft_rows_plain`,
:func:`dft_cols_plain`): the JAX module's four-step arithmetic in f32 torch
matmuls, with W1/W2/twiddle tables bit-equal to the JAX module's
(:func:`_factors`).

Like the JAX module, nothing in the merge calls these transforms: the merge
engines keep the library FFT (``torch.fft``).

Each wrapper call adds one to ``launch_counts["dft_rows"]`` or
``launch_counts["dft_cols"]``, whether its route makes one device launch or
two.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

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


# complex values a thread holds in a stage: 16, or r * (16 // r) for a
# radix r of 3, 5 or 7 (15, 15, 14)
_PER_THREAD = 16
# values a block may hold at 16 per thread: 1024 threads, or 512 threads
# (two blocks per SM) for blocks of at most _SMALL_BLOCK
_MAX_BLOCK = 1024 * _PER_THREAD
_SMALL_BLOCK = 512 * _PER_THREAD
# at most this many adjacent columns per block (128 contiguous bytes)
_MAX_STRIP = 32
# a single-pass column block takes at least this many adjacent columns
# (16 contiguous bytes per row); longer columns take the two-pass route
_MIN_COL_STRIP = 4


def _radices(n: int) -> Tuple[int, ...]:
    """The stages of a length-n FFT: radix 8 while it divides, then one 4
    or 2, then 7, 5 and 3, then any other prime factor (a direct-sum
    stage); n = 1 has none."""
    out = []
    while n % 8 == 0:
        out.append(8)
        n //= 8
    for r in (4, 2):
        if n % r == 0:
            out.append(r)
            n //= r
    for r in (7, 5, 3):
        while n % r == 0:
            out.append(r)
            n //= r
    p = 11
    while n > 1:
        if p * p > n:
            p = n
        if n % p == 0:
            out.append(p)
            n //= p
        else:
            p += 2
    return tuple(out)


class _Pass(NamedTuple):
    """One device launch: FFTs of length L along lines (g1, cg), g1 < G1,
    cg < lines, element i of line (g1, cg) at g1*in_s1 + cg*in_sc +
    i*in_si of the input plane and output k at the same with the out_
    strides. A block takes W adjacent lines cg of one g1. After the FFT,
    output k is multiplied by tab[(f*k) % n], f = g1*tw_g1 + cg*tw_c (when
    twiddle), and, in the inverse, divided by div (when div > 0). threads = 0 is the direct
    O(L^2) sum for a length no block holds."""

    L: int
    radices: Tuple[int, ...]
    W: int
    G1: int
    lines: int
    in_s1: int
    in_sc: int
    in_si: int
    out_s1: int
    out_sc: int
    out_si: int
    twiddle: bool
    tw_g1: int
    tw_c: int
    div: int
    threads: int


def _capacity(length: int, small: bool = False) -> int:
    """Complex values a block holds for a length-``length`` FFT."""
    per = min([_PER_THREAD] + [r * (_PER_THREAD // r) for r in _radices(length) if r in (3, 5, 7)])
    return (_SMALL_BLOCK if small else _MAX_BLOCK) * per // _PER_THREAD


def _threads(w: int, length: int) -> int:
    e = w * length
    if e > _capacity(length):
        return 0
    return 512 if e <= _capacity(length, small=True) else 1024


def _strip(length: int, lines: int, cap: int = _MAX_STRIP) -> int:
    """Adjacent lines per block: as many as fit, at most ``cap``."""
    return max(1, min(lines, cap, _capacity(length) // length))


def _pass(L, W, G1, lines, ins, outs, *, twiddle=(0, 0), div=0) -> _Pass:
    W = W if L <= _capacity(L) else 1
    return _Pass(L, _radices(L), W, G1, lines, *ins, *outs, twiddle != (0, 0), *twiddle, div, _threads(W, L))


@lru_cache(maxsize=64)
def _plan(name: str, m: int, n: int) -> Tuple[_Pass, ...]:
    """The launches of ``dft_rows`` or ``dft_cols`` on (m, n) planes.

    One pass where a block holds whole lines (:func:`_capacity`): rows of
    up to 16384 values, several rows per block for short ones; columns of
    up to 4096 values, in strips of at least _MIN_COL_STRIP adjacent
    columns.
    Otherwise two passes of the four-step split length = n1*n2
    (good_split), input index r1 + n1*r2, output k2 + n2*k1: pass 1 runs
    the length-n2 FFTs over r2 in place and multiplies by
    w_length^(r1*k2); pass 2 the length-n1 FFTs over r1, writing the
    output order. The inverse's 1/length scale is in the last pass."""
    if name == "dft_rows":
        if n <= _capacity(n):
            w = max(1, min(m, _capacity(n, small=True) // n))
            return (_pass(n, w, 1, m, (0, n, 1), (0, n, 1), div=n),)
        n1, n2 = good_split(n)
        return (
            # lines (row, r1), elements r2 at stride n1
            _pass(n2, _strip(n2, n1), m, n1, (n, 1, n1), (n, 1, n1), twiddle=(0, 1)),
            # lines (row, k2), elements r1 contiguous; output k2 + n2*k1
            _pass(n1, _strip(n1, n2, _capacity(n1, small=True) // n1), m, n2, (n, n1, 1), (n, 1, n2), div=n),
        )
    if m * min(n, _MIN_COL_STRIP) <= _capacity(m):
        return (_pass(m, _strip(m, n), 1, n, (0, 1, n), (0, 1, n), div=m),)
    m1, m2 = good_split(m)
    return (
        # lines (r1, column), elements r2 at stride m1 rows
        _pass(m2, _strip(m2, n), m1, n, (n, 1, m1 * n), (n, 1, m1 * n), twiddle=(1, 0)),
        # lines (k2, column), elements r1; output row k2 + m2*k1
        _pass(m1, _strip(m1, n), m2, n, (m1 * n, 1, n), (n, 1, m2 * n), div=m),
    )


@lru_cache(maxsize=32)
def _roots(n: int, inverse: bool, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """e^(sign*2*pi*i*t/n) for t in [0, n), computed in float64 and
    rounded once to f32, as (re, im) planes on ``device``: every root and
    twiddle of a length-n transform's passes."""
    w = np.exp((2j if inverse else -2j) * np.pi * np.arange(n) / n)
    return (torch.from_numpy(w.real.astype(np.float32)).to(device),
            torch.from_numpy(w.imag.astype(np.float32)).to(device))


def _stage_table(length: int, radices: Tuple[int, ...], inverse: bool) -> np.ndarray:
    """The twiddles of a length-``length`` FFT's stages, in float64: for the
    stage of radix r at sub-length m, w_m^(p*e) at (e - 1)*(m/r) + p, e in
    [1, r), p in [0, m/r), the stages one after another (the kernel's
    toff); one unused entry where there is no stage."""
    sign = 2j if inverse else -2j
    parts, m = [], length
    for r in radices:
        mn = m // r
        parts.append(np.exp(sign * np.pi * np.outer(np.arange(1, r), np.arange(mn)).ravel() / m))
        m = mn
    return np.concatenate(parts) if parts else np.ones(1, complex)


@lru_cache(maxsize=32)
def _stage_twiddles(length: int, radices: Tuple[int, ...], inverse: bool, device="cpu") -> torch.Tensor:
    """:func:`_stage_table` rounded once to f32, as (K, 2) (re, im) pairs on
    ``device``: the kernel reads a stage's twiddles contiguously in p, one
    8-byte load each."""
    w = _stage_table(length, radices, inverse)
    return torch.from_numpy(np.stack([w.real, w.imag], axis=1).astype(np.float32)).to(device)


def _simulate(p: _Pass, n: int, x: np.ndarray, tab: np.ndarray, out: np.ndarray, inverse: bool) -> None:
    """Run pass ``p`` of a length-n transform on the flat complex array
    ``x`` into ``out`` in numpy, with the kernel's index maps, stage order
    and table indices (``tab``: the n-entry root table; the stages'
    twiddles from :func:`_stage_table`)."""
    L, rs = p.L, n // p.L
    g1 = np.arange(p.G1)[:, None, None]
    cg = np.arange(p.lines)[None, :, None]
    i = np.arange(L)[None, None, :]
    y = x[g1 * p.in_s1 + cg * p.in_sc + i * p.in_si].reshape(-1, L)
    if p.threads == 0:
        k = np.arange(L)
        y = y @ tab[(np.outer(k, k) % L) * rs]
    else:
        stw = _stage_table(L, p.radices, inverse)
        m, s, toff = L, 1, 0
        for r in p.radices:
            mn = m // r
            # input (j*mn + p)*s + so -> output p*r*s + e*s + so
            a = y.reshape(-1, r, mn, s)
            roots = tab[(np.outer(np.arange(r), np.arange(r)) % r) * (L // r) * rs]
            b = np.einsum("ej,ljps->leps", roots, a)
            tw = np.concatenate([np.ones((1, mn)), stw[toff:toff + (r - 1) * mn].reshape(r - 1, mn)])
            y = (b * tw[None, :, :, None]).transpose(0, 2, 1, 3).reshape(-1, L)
            toff += (r - 1) * mn
            m, s = mn, s * r
    k = np.arange(L)[None, :]
    if p.twiddle:
        f = (np.arange(p.G1)[:, None] * p.tw_g1 + np.arange(p.lines)[None, :] * p.tw_c).reshape(-1, 1)
        y = y * tab[(f * k) % n]
    if inverse and p.div:
        y = y / p.div
    out[g1 * p.out_s1 + cg * p.out_sc + i * p.out_si] = y.reshape(p.G1, p.lines, L)


def _desc(p: _Pass, n: int, inverse: bool) -> np.ndarray:
    """The pass as the int64 descriptor ``dft_pass`` reads (csrc order)."""
    fields = (p.L, p.W, p.G1, p.lines, p.in_s1, p.in_sc, p.in_si, p.out_s1, p.out_sc, p.out_si,
              n // p.L, n, int(p.twiddle), p.tw_g1, p.tw_c, p.div if inverse else 0, p.threads, int(inverse), len(p.radices))
    return np.array(fields + p.radices, dtype=np.int64)


def _bind(lib) -> None:
    lib.dft_pass.argtypes = [ctypes.c_void_p] * 9
    lib.dft_pass.restype = ctypes.c_int


def _launch(name: str, xr: torch.Tensor, xi: torch.Tensor, inverse: bool):
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"{name}: the planes must be float32")
    if xr.dim() != 2 or xi.shape != xr.shape or xi.device != xr.device:
        raise ValueError(f"{name}: need two 2-D planes of one shape on one device")
    m, n = xr.shape
    if m < 1 or n < 1:
        raise ValueError(f"{name}: empty planes {tuple(xr.shape)}")
    if m * n >= 2**31:
        raise ValueError(f"{name}: {m * n} elements exceed the kernel's 32-bit line indices")
    length = n if name == "dft_rows" else m
    passes = _plan(name, m, n)
    xr = xr.contiguous()
    xi = xi.contiguous()
    dev = xr.device
    tr, ti = _roots(length, inverse, dev)
    fn = kernel_build.load(_SOURCE, _bind).dft_pass
    src = (xr, xi)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for p in passes:  # the two-pass route's first output is its scratch pair
            dst = (torch.empty_like(xr), torch.empty_like(xr))
            desc = _desc(p, length, inverse)
            w = _stage_twiddles(p.L, p.radices, inverse, dev)
            err = fn(src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(), dst[1].data_ptr(),
                     tr.data_ptr(), ti.data_ptr(), w.data_ptr(), desc.ctypes.data, stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            src = dst
    launch_counts[name] += 1
    return src


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
