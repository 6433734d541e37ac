"""Distributed 2-D FFT over the merge ranks (counterpart of
shardmerge_tpu/parallel/fft2d.py).

A (M, N) tensor is sharded row-wise over P ranks. The 2-D FFT is separable:
FFT the local axis, transpose the shard axis with an all-to-all, FFT the
other axis. The per-rank FFTs are ``torch.fft`` (cuFFT on a card), as the
single-device merge runs them.

Layouts (P ranks, position p; parallel/comm.py):

- RS (row-sharded):    local block (M/P, N), rows [p M/P, (p+1) M/P)
- CS (column-sharded): local block (M, N/P), columns [p N/P, (p+1) N/P)

``fft2_rs`` maps RS -> CS; ``ifft2_cs`` maps CS -> RS (its real part); the
``*_cs``/``*_rs`` duals serve the imaginary double-FFT recursion, which
starts from the opposite layout.

Rows that do not divide P are zero-padded by the caller to M_pad; ``true_m``
slices the padding off after the all-to-all, so every spectral op sees the
true (true_m, N) spectrum, and ``pad_m`` puts the zero rows back before the
all-to-all of an inverse.

These take one rank's local block and run collectives: every rank must
call them with its own block, in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "fft2_rs",
    "ifft2_cs",
    "fft2_cs",
    "ifft2_rs",
    "rfft2_rs_half",
    "irfft2_half_rs",
    "half_col_weights",
]


def _pad_rows(x: torch.Tensor, pad_m: int) -> torch.Tensor:
    if pad_m == x.shape[0]:
        return x
    pad = torch.zeros((pad_m - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _complex(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_complex() else x.to(torch.complex64)


def rfft2_rs_half(x: torch.Tensor, comm, true_m: Optional[int] = None) -> torch.Tensor:
    """Distributed 2-D rfft of a row-sharded REAL block.

    Returns the half spectrum in a unified local layout (M, Nb + 1): the
    ``Nb = (N/2)/P`` body columns of this rank (its slice of columns
    0..N/2-1 after the all-to-all) plus the Nyquist column, replicated on
    every rank (C = N/2+1 is ragged for the all-to-all; reductions weigh
    the copy on position 0 only, see :func:`half_col_weights`). Requires
    N % 2P == 0."""
    h = torch.fft.rfft(x, dim=-1)  # (M/P, N/2+1)
    body = comm.a2a_rs_to_cs(h[:, :-1])  # (M, (N/2)/P)
    nyq = comm.all_gather_rows(h[:, -1:])  # (M, 1)
    h2 = torch.cat([body, nyq], dim=1)
    if true_m is not None:
        h2 = h2[:true_m]
    return torch.fft.fft(h2, dim=0)


def irfft2_half_rs(h: torch.Tensor, comm, n: int, pad_m: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`rfft2_rs_half`: unified half spectrum -> row-sharded
    (M/P, N) real. ``pad_m`` re-inserts the zero rows the forward sliced off
    (the caller slices the final result back to true_m rows)."""
    h = torch.fft.ifft(h, dim=0)
    if pad_m is not None:
        h = _pad_rows(h, pad_m)
    body = comm.a2a_cs_to_rs(h[:, :-1])  # (M/P, N/2)
    mp = body.shape[0]
    nyq_rows = h[comm.position * mp:(comm.position + 1) * mp, -1:]
    return torch.fft.irfft(torch.cat([body, nyq_rows], dim=1), n=n, dim=-1)


def half_col_weights(n: int, n_body_local: int, comm) -> torch.Tensor:
    """Hermitian multiplicities of the unified half-spectrum layout: global
    column 0 (DC) weighs 1, the other body columns 2, and the replicated
    Nyquist column 1 on position 0 and 0 elsewhere, so global reductions
    count it once."""
    del n
    global_col = comm.position * n_body_local + torch.arange(n_body_local, device=comm.device)
    body_w = torch.where(global_col == 0, 1.0, 2.0).to(torch.float32)
    nyq_w = torch.full((1,), 1.0 if comm.position == 0 else 0.0, dtype=torch.float32, device=comm.device)
    return torch.cat([body_w, nyq_w])


def fft2_rs(x: torch.Tensor, comm, true_m: Optional[int] = None) -> torch.Tensor:
    """2-D FFT of a row-sharded real or complex block; returns column-sharded.
    ``true_m`` slices off the caller's zero rows after the all-to-all."""
    y = torch.fft.fft(_complex(x), dim=-1)
    y = comm.a2a_rs_to_cs(y)
    if true_m is not None:
        y = y[:true_m]
    return torch.fft.fft(y, dim=-2)


def ifft2_cs(x: torch.Tensor, comm, pad_m: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`fft2_rs`: column-sharded complex -> row-sharded real.
    ``pad_m`` re-inserts the zero rows before the all-to-all back."""
    y = torch.fft.ifft(x, dim=-2)
    if pad_m is not None:
        y = _pad_rows(y, pad_m)
    y = comm.a2a_cs_to_rs(y)
    return torch.fft.ifft(y, dim=-1).real


def fft2_cs(x: torch.Tensor, comm, pad_m: Optional[int] = None) -> torch.Tensor:
    """2-D FFT of a column-sharded block; returns row-sharded (the imaginary
    recursion's input lives in CS). With ``pad_m``, zero rows are appended
    AFTER the axis(-2) FFT only to make the all-to-all divide; they stay zero
    through the row FFT and the inner blend, and :func:`ifft2_rs` slices
    them off before its axis(-2) inverse."""
    y = torch.fft.fft(_complex(x), dim=-2)
    if pad_m is not None:
        y = _pad_rows(y, pad_m)
    y = comm.a2a_cs_to_rs(y)
    return torch.fft.fft(y, dim=-1)


def ifft2_rs(x: torch.Tensor, comm, true_m: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`fft2_cs`: row-sharded complex -> column-sharded real."""
    y = torch.fft.ifft(x, dim=-1)
    y = comm.a2a_rs_to_cs(y)
    if true_m is not None:
        y = y[:true_m]
    return torch.fft.ifft(y, dim=-2).real
