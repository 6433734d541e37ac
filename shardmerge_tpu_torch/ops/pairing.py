"""Host-side greedy pair scheduling for the delta reduction (counterpart of
shardmerge_tpu/ops/pairing.py).

The pairing decisions are data-dependent control flow over tiny (n <= ~16)
matrices, so they stay on the host in numpy; only ``cosine_correlation``
reads the stack, as one batched torch computation on the stack's device.

- ``norm_product_matrix``: the fourier engine's pseudo-correlation, the
  upper triangle of pairwise delta-norm products (REF-QUIRK: not a
  correlation).
- ``correlated_pairs``: greedy least/most |coefficient| pairing over the
  upper triangle; leftovers are yielded as ``(i, -1, diag)``.
- ``cosine_correlation``: mean cosine similarity along dim 0 (eps 1e-8,
  NaN -> 0, diagonal 0), for the legacy engine.
- ``dim0_gram``: the pairwise dot products along dim 0 of a stack's
  members, from elementwise products and sums (no matrix product, so
  TF32 settings do not reach it), for that correlation and model-stock.
"""

from __future__ import annotations

from typing import Generator, List, Literal, Tuple

import numpy as np
import torch

__all__ = ["correlated_pairs", "cosine_correlation", "dim0_gram", "norm_product_matrix"]


def norm_product_matrix(norms: List[float]) -> np.ndarray:
    """Upper-triangular f32 matrix of pairwise norm products; the diagonal
    and lower triangle stay 0 (the diagonal is what leftovers report)."""
    n = len(norms)
    matrix = np.zeros((n, n), dtype=np.float32)
    v = np.asarray(norms, dtype=np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            matrix[i, j] = v[i] * v[j]
    return matrix


def dim0_gram(stack: torch.Tensor) -> torch.Tensor:
    """(n, n, *rest) f32: entry [i, j] is the sum along dim 0 of
    ``stack[i] * stack[j]`` for an (n, d, *rest) stack. One pair at a time,
    so one member's product is the only temporary; the result does not
    depend on ``torch.backends.cuda.matmul.allow_tf32``."""
    n = stack.shape[0]
    out = stack.new_empty((n, n) + tuple(stack.shape[2:]))
    for i in range(n):
        for j in range(i, n):
            out[i, j] = (stack[i] * stack[j]).sum(dim=0)
            out[j, i] = out[i, j]
    return out


def cosine_correlation(stack) -> np.ndarray:
    """n x n matrix of mean cosine similarity along dim 0 between the
    stacked tensors (norms clamped at eps 1e-8, NaN -> 0, diagonal 0),
    computed for every pair at once. A stack of 1-D tensors is widened to
    (n, d, 1): the dim-0 cosine of a vector is one scalar."""
    stack = torch.as_tensor(stack).to(torch.float32)
    if stack.ndim == 2:
        stack = stack[:, :, None]
    flat = stack.reshape(stack.shape[0], stack.shape[1], -1)  # (n, d0, rest)
    norms = torch.clamp(torch.linalg.vector_norm(flat, dim=1), min=1e-8)  # (n, rest)
    dots = dim0_gram(flat)  # (n, n, rest)
    cos = dots / (norms[:, None, :] * norms[None, :, :])
    cos = torch.where(torch.isnan(cos), torch.zeros_like(cos), cos)
    matrix = cos.mean(dim=-1).cpu().numpy().copy()
    np.fill_diagonal(matrix, 0.0)  # the reference never fills the diagonal
    return matrix


def correlated_pairs(
    correlation_matrix: np.ndarray,
    way: Literal["least", "most"] = "least",
) -> Generator[Tuple[int, int, float], None, None]:
    """Greedy pairing by extreme |coefficient| over the upper triangle.

    Yields (x, y, coefficient) with x < y; a used index's row and column
    are masked out, the first match in ``argwhere`` order wins a tie, and
    odd leftovers are yielded last as (i, -1, diag value)."""
    matrix = np.asarray(correlation_matrix, dtype=np.float64)
    n = matrix.shape[0]
    available = np.triu(np.ones((n, n), dtype=bool), k=1)
    items = list(range(n))

    while available.any():
        valid = np.where(available, matrix, np.inf)
        finite = valid[valid != np.inf]
        if finite.size == 0:
            break
        if way == "least":
            match_val = np.min(np.abs(finite))
        elif way == "most":
            match_val = np.max(np.abs(finite))
        else:
            raise ValueError("Invalid way. Choose 'least' or 'most'.")

        match_idx = np.argwhere(np.abs(valid) == match_val)
        if match_idx.size == 0:
            break
        x, y = int(match_idx[0][0]), int(match_idx[0][1])
        yield (x, y, float(matrix[x, y]))

        available[x, :] = False
        available[:, x] = False
        available[y, :] = False
        available[:, y] = False
        items.remove(x)
        items.remove(y)

    for i in items:
        yield (i, -1, float(matrix[i, i]))
