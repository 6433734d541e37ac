"""Batched Stockham FFT kernel for Hopper and the rfft2/irfft2 built on it
(counterpart of shardmerge_tpu/ops/fft_vpu.py).

``fft_batched(zr, zi, inverse)`` is the complex FFT along the last axis of
batch-major (B, N) f32 planes, in natural order, with the 1/N scale on the
inverse. N = 8*m with m a product of the radices {4, 2, 7, 3, 5}, N <= 4096
(the JAX module's gate). On a CUDA tensor it launches
``csrc/stockham_fft.cu`` (built for sm_90a with ``nvcc`` at first use,
bound with ctypes) or raises; on a CPU tensor it runs
:func:`fft_batched_plain`, the JAX module's ``_flat_stockham`` in f32 torch
(the flat (m, s*b) layout, quarter-turn twiddles snapped exact, the DFT-8
as a matmul, and the reorder to natural order).

The kernel runs decimation-in-time Stockham passes of large radices
(:func:`_schedule`: 16s, then 8, 4 or 2, then 7, 5, 3): the first pass
reads the input planes into registers, the last writes natural order, and
the passes between exchange through shared memory. :func:`_simulate` runs
that schedule, with the kernel's index maps, table indices and exchange
swizzle (:func:`_swizzle`), in float64 numpy for the CPU tests; the roots
and twiddles come from one table (:func:`_table`).

``rfft2_vpu``/``irfft2_vpu`` are the JAX module's functions in plain torch
around ``fft_batched``: the rows pass packs even/odd samples into an
N/2-point complex FFT and untangles it, the columns pass transforms the
padded, transposed half spectrum. The shape gate (:func:`vpu_supported`)
is the JAX module's, ``_MAX_LEN = 4096`` included, though that limit is
the TPU's VMEM and not the card's.

Like the JAX module, nothing in the merge calls these transforms: the merge
engines keep the library FFT (``torch.fft``).

Each launch adds one to ``launch_counts["fft_batched"]``.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernel_build

__all__ = [
    "rfft2_vpu",
    "irfft2_vpu",
    "vpu_supported",
    "factorize",
    "fft_batched",
    "fft_batched_plain",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

_RADICES = (4, 2, 7, 3, 5)
# the JAX module's limit (its kernel keeps a whole axis in the TPU's scoped
# VMEM); kept so that both accept the same shapes
_MAX_LEN = 4096
_SOURCE = kernel_build.CSRC / "stockham_fft.cu"

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def build(verbose: bool = False) -> Path:
    """Compile the kernel into ``_build/`` (once per source content) and
    return the shared library's path."""
    return kernel_build.build(_SOURCE, verbose)


def factorize(n: int) -> Optional[List[int]]:
    """Radix sequence for n, largest radices first; None if unsupported."""
    fs: List[int] = []
    for r in _RADICES:
        while n % r == 0:
            fs.append(r)
            n //= r
    return fs if n == 1 else None


def _supported_len(n: int) -> bool:
    return n >= 8 and n % 8 == 0 and n <= _MAX_LEN and factorize(n // 8) is not None


def _pick_b(batch: int) -> Optional[int]:
    for b in (32, 16, 8):
        if batch % b == 0:
            return b
    return None


def _cmul_scalar(xr, xi, c: complex):
    """(xr + i xi) * c for a scalar c, multiplier-free for 1, -1, i, -i."""
    if c == 1:
        return xr, xi
    if c == -1:
        return -xr, -xi
    if c == -1j:
        return xi, -xr
    if c == 1j:
        return -xi, xr
    cr, ci = c.real, c.imag
    return xr * cr - xi * ci, xr * ci + xi * cr


def _snap(z: complex) -> complex:
    """Snap a quarter-turn root of unity to its exact value."""

    def snap1(v):
        return round(v) if abs(v - round(v)) < 1e-12 else v

    return complex(snap1(z.real), snap1(z.imag))


def _flat_stockham(yr, yi, n: int, inverse: bool):
    """Complex FFT of length n over (n, b) f32 planes in the JAX module's
    flat form: data (m, s*b), col = s_idx*b + batch; a radix-r DIF stage
    maps it to (m/r, r*s*b); a DFT-8 matmul ends it, and the result
    (8, (n//8)*b) is row-major-identical to (n, b)."""
    radices = factorize(n // 8)
    assert radices is not None, n
    sgn = 2.0 * math.pi if inverse else -2.0 * math.pi
    sgnc = 2j * np.pi if inverse else -2j * np.pi
    dev = yr.device
    m = n
    for r in radices:
        m_new = m // r
        wr_e = tuple(_snap(complex(np.exp(sgnc * j / r))) for j in range(r))
        ar = [yr[j * m_new:(j + 1) * m_new] for j in range(r)]
        ai = [yi[j * m_new:(j + 1) * m_new] for j in range(r)]
        # w[p] = e^{sign*2pi*i*p/m} from an f32 angle, constant across columns
        ang = torch.arange(m_new, device=dev, dtype=torch.float32)[:, None] * np.float32(sgn / m)
        wre = torch.cos(ang)
        wim = torch.sin(ang)
        outs_r, outs_i = [], []
        for e in range(r):
            br_ = ar[0]
            bi_ = ai[0]
            for j in range(1, r):
                tr, ti = _cmul_scalar(ar[j], ai[j], wr_e[(j * e) % r])
                br_ = br_ + tr
                bi_ = bi_ + ti
            er, ei = br_, bi_
            for _ in range(e):  # w^e by repeated multiplication
                er, ei = er * wre - ei * wim, er * wim + ei * wre
            outs_r.append(er)
            outs_i.append(ei)
        yr = torch.cat(outs_r, dim=1)
        yi = torch.cat(outs_i, dim=1)
        m = m_new
    # tail: DFT-8 over the remaining 8 rows as one f32 matmul
    k = torch.arange(8, device=dev, dtype=torch.float32)
    ang = np.float32(sgn / 8.0) * k[:, None] * k[None, :]
    w8r = torch.cos(ang)
    w8i = torch.sin(ang)
    outr = w8r @ yr - w8i @ yi
    outi = w8r @ yi + w8i @ yr
    if inverse:
        outr = outr * np.float32(1.0 / n)
        outi = outi * np.float32(1.0 / n)
    return outr, outi


def fft_batched_plain(zr: torch.Tensor, zi: torch.Tensor, inverse: bool):
    """The JAX ``_fft_batched`` in f32 torch: FFT along axis -1 of (B, N)
    planes, natural order. Every column of the flat form is one line, so
    all B lines run as one (N, B) block (the TPU kernel's grid of b-line
    blocks computes the same values), and the (8, s*B) result is
    reordered."""
    if zr.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain FFT's DFT-8 matmul needs allow_tf32 = False")
    B, N = zr.shape
    assert _pick_b(B) is not None and _supported_len(N), (B, N)
    fr, fi = _flat_stockham(zr.T, zi.T, N, inverse)

    # (8, s, B) [k, s_idx, batch] -> (batch, k, s_idx): frequency k*s + s_idx
    def reorder(f):
        return f.reshape(8, N // 8, B).permute(2, 0, 1).reshape(B, N)

    return reorder(fr), reorder(fi)


def _schedule(n: int) -> Tuple[int, ...]:
    """The kernel's radices for a line of n: 16s over the power of two, its
    remainder (8, 4 or 2) after them, then the odd factors 7, 5, 3 (the
    C++ ``schedule`` checks the host's list against its own)."""
    assert _supported_len(n), n
    two = n & -n
    lg = two.bit_length() - 1
    radices = [16] * (lg // 4) + ([1 << (lg % 4)] if lg % 4 else [])
    odd = n // two
    for r in (7, 5, 3):
        while odd % r == 0:
            radices.append(r)
            odd //= r
    return tuple(radices)


def _swizzle(f: np.ndarray, ns: int, r: int) -> np.ndarray:
    """Where the exchange written by a pass of (Ns, R) keeps block-local
    index f (the 2^k instance's ``swz``): the low five bits XOR the bits from
    max(5, log2(Ns*R)) up, times Ns. A permutation within each aligned run of
    32, so the next pass's contiguous reads stay free of bank conflicts."""
    shift = max(5, (ns * r).bit_length() - 1)
    return f ^ (((f >> shift) * ns) & 31)


def _simulate(n: int, x: np.ndarray, tab: np.ndarray, inverse: bool) -> np.ndarray:
    """The kernel's passes on (lines, n) complex x in float64 numpy:
    butterfly j of a radix-R pass with Ns before it reads x[j + r*n/R],
    multiplies by tab[(j mod Ns)*r*n/(Ns*R)], takes the DFT-R over the roots
    tab[q*n/R] and writes (j div Ns)*Ns*R + (j mod Ns) + r*Ns. A 2^k length's
    exchanges go through :func:`_swizzle`, as the kernel's shared planes do."""
    pow2 = n & (n - 1) == 0
    lines = x.shape[0]
    data = x.reshape(-1)
    line0 = (np.arange(lines) * n)[:, None, None]
    radices = _schedule(n)
    ns, prev = 1, None
    for p, r in enumerate(radices):
        j = np.arange(n // r)[None, :, None]
        e = np.arange(r)[None, None, :]
        k = j % ns
        src = line0 + j + e * (n // r)
        if p and pow2:
            src = _swizzle(src, *prev)
        v = data[src] * tab[k * e * (n // (ns * r))]
        v = v @ tab[(np.outer(np.arange(r), np.arange(r)) % r) * (n // r)]
        dst = line0 + (j // ns) * ns * r + k + e * ns
        if p + 1 < len(radices) and pow2:
            dst = _swizzle(dst, ns, r)
        data = np.full_like(data, np.nan)
        data[dst] = v
        prev, ns = (ns, r), ns * r
    out = data.reshape(lines, n)
    return out / n if inverse else out


@lru_cache(maxsize=32)
def _table(n: int, inverse: bool, device) -> torch.Tensor:
    """e^{sign*2pi*i*t/n} for t in [0, n), computed in float64 with the
    quarter turns snapped exact, rounded once to f32: an (n, 2) re/im
    tensor on ``device`` (the kernel reads it as float2)."""
    sgnc = 2j * np.pi if inverse else -2j * np.pi
    w = np.array([_snap(complex(v)) for v in np.exp(sgnc * np.arange(n) / n)])
    return torch.from_numpy(np.stack([w.real, w.imag], axis=1).astype(np.float32)).to(device)


@lru_cache(maxsize=32)
def _radix_arg(n: int):
    radices = _schedule(n)
    return (ctypes.c_int * len(radices))(*radices), len(radices)


def _bind(lib) -> None:
    lib.stockham_fft.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.stockham_fft.restype = ctypes.c_int


def fft_batched(zr: torch.Tensor, zi: torch.Tensor, inverse: bool):
    """Complex FFT along axis -1 of batch-major (B, N) f32 planes, natural
    order; the inverse includes the 1/N scale. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    B, N = zr.shape
    if _pick_b(B) is None or not _supported_len(N):
        raise ValueError(f"fft_batched: unsupported (B, N) = {(B, N)} (B % 8 == 0, N = 8*m <= {_MAX_LEN})")
    if not zr.is_cuda:
        return fft_batched_plain(zr, zi, inverse)
    if zr.dtype != torch.float32 or zi.dtype != torch.float32:
        raise TypeError("fft_batched: the planes must be float32")
    if zi.shape != zr.shape or zi.device != zr.device:
        raise ValueError("fft_batched: the planes must have one shape on one device")
    zr = zr.contiguous()
    zi = zi.contiguous()
    dev = zr.device
    tab = _table(N, inverse, dev)
    radices, npass = _radix_arg(N)
    out_r = torch.empty_like(zr)
    out_i = torch.empty_like(zr)
    with torch.cuda.device(dev):
        err = kernel_build.load(_SOURCE, _bind).stockham_fft(
            zr.data_ptr(),
            zi.data_ptr(),
            tab.data_ptr(),
            out_r.data_ptr(),
            out_i.data_ptr(),
            B,
            N,
            int(inverse),
            radices,
            npass,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fft_batched launch failed: cudaError {err}")
    launch_counts["fft_batched"] += 1
    return out_r, out_i


def _untangle_w(n: int, device="cpu"):
    """e^{-2pi i k/N} for k in [0, M), as (M,) f32 planes."""
    m = n // 2
    wk = np.exp(-2j * np.pi * np.arange(m) / n)
    return (
        torch.from_numpy(wk.real.astype(np.float32)).to(device),
        torch.from_numpy(wk.imag.astype(np.float32)).to(device),
    )


def _plan(shape: Tuple[int, ...]):
    if len(shape) != 2:
        return None
    rows, n = shape
    if n % 2:
        return None
    m = n // 2
    if not (_supported_len(m) and _supported_len(rows)):
        return None
    b1 = _pick_b(rows)
    if b1 is None:
        return None
    b2 = _pick_b(m + 1) or 32  # pass-2 batch is padded up to a multiple
    p = -(-(m + 1) // b2) * b2
    return {"rows": rows, "n": n, "m": m, "p": p}


def vpu_supported(shape) -> bool:
    """True if rfft2_vpu can handle this 2-D f32 shape."""
    return _plan(tuple(shape)) is not None


def rfft2_vpu(x: torch.Tensor) -> torch.Tensor:
    """rfftn(x, dim=(-2, -1)) for 2-D f32 x through ``fft_batched``;
    returns complex64 (rows, n//2 + 1)."""
    plan = _plan(tuple(x.shape))
    assert plan is not None, x.shape
    rows, n, m, p = plan["rows"], plan["n"], plan["m"], plan["p"]
    x = x.to(torch.float32)

    # rows pass: rfft of length n as an m-point complex FFT of the packed
    # even/odd samples, untangled to the standard half spectrum [0..m]
    zr = x[:, 0::2]
    zi = x[:, 1::2]
    Zr, Zi = fft_batched(zr, zi, inverse=False)
    Zfr = torch.roll(torch.flip(Zr, dims=(-1,)), 1, dims=-1)
    Zfi = -torch.roll(torch.flip(Zi, dims=(-1,)), 1, dims=-1)  # conj Z[(M-k)%M]
    zer = 0.5 * (Zr + Zfr)
    zei = 0.5 * (Zi + Zfi)
    zor = 0.5 * (Zi - Zfi)
    zoi = -0.5 * (Zr - Zfr)
    wkr, wki = _untangle_w(n, x.device)
    Ar = zer + wkr * zor - wki * zoi
    Ai = zei + wkr * zoi + wki * zor
    nyq_r = zer[:, :1] - zor[:, :1]
    nyq_i = zei[:, :1] - zoi[:, :1]
    Ar = torch.cat([Ar, nyq_r], dim=-1)  # (rows, m+1)
    Ai = torch.cat([Ai, nyq_i], dim=-1)

    # cols pass: complex FFT over the row axis, batched over the (padded)
    # half-spectrum columns
    pad = (0, p - (m + 1))
    At_r = torch.nn.functional.pad(Ar, pad).T  # (p, rows) batch-major
    At_i = torch.nn.functional.pad(Ai, pad).T
    St_r, St_i = fft_batched(At_r, At_i, inverse=False)
    return torch.complex(St_r[: m + 1].T, St_i[: m + 1].T)


def irfft2_vpu(spec: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """irfftn(spec, s=shape, dim=(-2, -1)) through ``fft_batched``."""
    plan = _plan(tuple(shape))
    assert plan is not None, shape
    rows, n, m, p = plan["rows"], plan["n"], plan["m"], plan["p"]

    # inverse cols pass
    pad = (0, p - (m + 1))
    St_r = torch.nn.functional.pad(spec.real.to(torch.float32), pad).T  # (p, rows)
    St_i = torch.nn.functional.pad(spec.imag.to(torch.float32), pad).T
    At_r, At_i = fft_batched(St_r, St_i, inverse=True)
    Ar = At_r[: m + 1].T  # (rows, m+1)
    Ai = At_i[: m + 1].T

    # inverse rows pass: retangle the half spectrum into the packed m-point
    # complex signal, inverse FFT, interleave
    main_r = Ar[:, :m]
    main_i = Ai[:, :m]
    flip_r = torch.flip(Ar[:, 1:m + 1], dims=(-1,))  # A[M-k], k in [0, M)
    flip_i = torch.flip(Ai[:, 1:m + 1], dims=(-1,))
    zer = 0.5 * (main_r + flip_r)
    zei = 0.5 * (main_i - flip_i)
    dr = 0.5 * (main_r - flip_r)
    di = 0.5 * (main_i + flip_i)
    wkr, wki = _untangle_w(n, spec.device)
    wki = -wki  # inverse untangle uses the conjugate twiddle
    zor = wkr * dr - wki * di
    zoi = wkr * di + wki * dr
    Zcr = zer - zoi  # Zc = ze + i*zo
    Zci = zei + zor
    zr, zi = fft_batched(Zcr, Zci, inverse=True)
    # out[2j] = Re z_j, out[2j+1] = Im z_j
    return torch.stack([zr, zi], dim=-1).reshape(rows, n)
