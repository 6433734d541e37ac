"""Exact order statistics without sorting (counterpart of
shardmerge_tpu/ops/select.py).

For non-negative IEEE-754 floats the bit pattern, read as an UNSIGNED 32-bit
integer, is monotone in the value (NaNs, exponent all ones, rank last, as in
``torch.sort``). The k-th smallest element is found by bisecting that bit
pattern two bits per round: 16 rounds, each counting the elements strictly
below three candidate prefixes, with no sort and no host sync.

torch has no ordered uint32 compare, so the bit patterns are compared as
int32 after flipping the sign bit (``bits ^ 0x80000000``): that maps the
unsigned order [0, 2^32) onto the signed order [-2^31, 2^31) exactly, so
round 0's candidates ``1<<30 .. 3<<30`` (negative as plain int32) compare
correctly while the keys stay 4 bytes wide. Counts are int64 and exact.

With ``group`` (a parallel/comm.py ``Comm``) the array is one rank's share of
a distributed array: each round's three counts are summed over the ranks in
one all-reduce, so the threshold is the global order statistic, bit-equal to
the single-device one on the same elements.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kth_smallest_nonneg", "kth_smallest_nonneg2", "kth_smallest_weighted"]

_BITS_PER_ROUND = 2
_ROUNDS = 32 // _BITS_PER_ROUND
_SIGN = -(1 << 31)  # int32 0x80000000


def _keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 keys of f32 ``x``'s unsigned bit patterns."""
    return x.to(torch.float32).contiguous().view(torch.int32) ^ _SIGN


def _bisect(count_below, k, device, group=None) -> torch.Tensor:
    """Largest unsigned pattern p with count_below(p) <= k, as f32.

    ``count_below(c)`` counts elements whose pattern is strictly below the
    int32 key ``c``; ``k`` may be a Python int (compared as a scalar: no
    copy to the device, which would wait for its stream) or a 0-d tensor.
    With ``group`` a round's counts are summed over its ranks."""
    prefix = torch.zeros((), dtype=torch.int64, device=device)  # unsigned
    for i in range(_ROUNDS):
        shift = 32 - _BITS_PER_ROUND * (i + 1)
        counts = torch.stack([
            count_below(((prefix + (digit << shift)) - (1 << 31)).to(torch.int32))  # as signed key
            for digit in range(1, 2**_BITS_PER_ROUND)
        ])
        if group is not None:
            counts = group.all_reduce(counts)
        step = (counts <= k).to(torch.int64).sum()
        prefix = prefix + (step << shift)
    signed = torch.where(prefix >= (1 << 31), prefix - (1 << 32), prefix)
    return signed.to(torch.int32).reshape(1).view(torch.float32)[0]


def kth_smallest_nonneg(x: torch.Tensor, k, group=None) -> torch.Tensor:
    """k-th smallest (0-indexed) element of non-negative f32 ``x``;
    exactly ``torch.sort(x.ravel())[0][k]``, NaNs ranking last."""
    keys = _keys(x).reshape(-1)
    return _bisect(lambda c: (keys < c).sum(), k, x.device, group)


def kth_smallest_nonneg2(x: torch.Tensor, y: torch.Tensor, k, group=None) -> torch.Tensor:
    """k-th smallest of the multiset union of ``x`` and ``y`` without
    materializing the concatenation."""
    kx = _keys(x).reshape(-1)
    ky = _keys(y).reshape(-1)
    return _bisect(lambda c: (kx < c).sum() + (ky < c).sum(), k, x.device, group)


def kth_smallest_weighted(
    x: torch.Tensor,
    k,
    col_weights: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """k-th smallest of a column-weighted multiset of one or two arrays.

    Each element in column j (last axis) counts ``col_weights[j]`` times —
    the rfft half spectrum standing for its Hermitian full spectrum. Counts
    are taken per column, then dotted with the integer weights."""
    w = torch.as_tensor(col_weights, device=x.device).to(torch.int64)
    arrays = [x] if y is None else [x, y]
    keys = [_keys(a).reshape(-1, a.shape[-1]) for a in arrays]

    def count_below(c):
        return sum(((kk < c).sum(dim=0) * w).sum() for kk in keys)

    return _bisect(count_below, k, x.device, group)
