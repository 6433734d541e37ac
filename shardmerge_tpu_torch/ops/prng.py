"""The random bits that the DARE and DELLA engines draw from ``jax.random``,
reproduced bit for bit (counterpart of what shardmerge_tpu/merge/dare.py and
della.py ask of jax.random).

JAX's default PRNG is threefry2x32 with ``jax_threefry_partitionable`` on:

- ``key(seed)`` is the pair ``(0, seed)`` for a uint32 seed;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- the bits of an array of ``shape`` come from one threefry2x32 call per
  element, its counter the element's row-major flat index split into
  ``(idx >> 32, idx & 0xFFFFFFFF)``, and are ``out0 ^ out1``;
- ``split(key, num)``: key i is ``threefry2x32(key, (0, i))`` (the flat
  index as the counter again);
- ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1, then scales to [minval, maxval) as ``u * (maxval -
  minval) + minval`` in f32 (XLA contracts it into one FMA on the CPU),
  floored at minval; ``bernoulli(key, p)`` is ``u < p``.

torch has no unsigned 32-bit shifts on every device, so the words live in
int64 tensors masked to 32 bits; the same code runs on CPU and CUDA tensors.
Keys are Python ints (a key is two words). Because each element's bits
depend only on its flat index, a mask is computed in chunks of the flat
range (``chunk`` elements: the int64 temporaries of a chunk, not of the
whole tensor) and is exact for any chunking. ``torch.Generator`` and
``torch.rand`` draw other bits and are never used here.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["threefry2x32", "key", "fold_in", "split", "random_bits", "uniform", "bernoulli", "bernoulli_range",
           "fma_f32", "CHUNK"]

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # 1.0f
# elements per chunk of the flat range: five int64 words of 32 MiB each
CHUNK = 1 << 22

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M


def threefry2x32(k: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds on the counter words (x0, x1) under key
    ``k``: Python ints, or int64 tensors of 32-bit values (not modified)."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    if not isinstance(x0, torch.Tensor):
        x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1]) & _M
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1) & _M
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]) & _M
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
        return x0, x1
    # in place on two fresh words: one temporary a round
    x0 = (x0 + ks[0]).bitwise_and_(_M)
    x1 = (x1 + ks[1]).bitwise_and_(_M)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            low = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(_M).bitwise_or_(low).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(jnp.uint32(seed))``'s key data."""
    return (0, seed & _M)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, jnp.uint32(data))``'s key data."""
    return threefry2x32(k, 0, data & _M)


def split(k: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(k, num)``'s keys."""
    return tuple(threefry2x32(k, 0, i) for i in range(num))


def random_bits(k: Key, start: int, stop: int, device) -> torch.Tensor:
    """The 32-bit words (int64) of flat elements [start, stop) of any array
    drawn under ``k``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32(k, idx >> 32, idx.bitwise_and_(_M))
    return out0.bitwise_xor_(out1)


def _uniform_of(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from the top 23 bits, as ``jax.random.uniform``."""
    mantissa = bits.bitwise_right_shift_(9).bitwise_or_(_ONE_BITS).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


def fma_f32(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, for f32 ``a`` and f32 values ``b``,
    ``c`` (a Python float, or a tensor for ``c``). The product is exact in
    f64; the sum is rounded to odd there (Boldo-Melquiond), so its rounding
    to f32 is the correctly rounded fused result."""
    p = a.to(torch.float64) * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # s + err == p + c exactly (TwoSum)
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & even, bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: f32 on
    ``device``."""
    shape = tuple(shape)
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    u = _uniform_of(random_bits(k, 0, _numel(shape), device))
    return torch.clamp_min(fma_f32(u, span, lo), lo).reshape(shape)


def bernoulli(k: Key, p, shape: Sequence[int], device=None, chunk: int = CHUNK) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` for f32 ``p``: a Python float
    (taken as float32), a 0-d tensor, or a tensor of ``shape``. Returns a
    bool tensor of ``shape`` on ``device`` (``p``'s device for a tensor of
    ``shape``, or when ``device`` is None)."""
    shape = tuple(shape)
    if isinstance(p, torch.Tensor) and p.ndim:
        if tuple(p.shape) != shape:
            raise ValueError(f"bernoulli p of shape {tuple(p.shape)} for shape {shape}")
        p = p.reshape(-1)
    return bernoulli_range(k, p, 0, _numel(shape), device, chunk).reshape(shape)


def bernoulli_range(k: Key, p, start: int, stop: int, device=None, chunk: int = CHUNK) -> torch.Tensor:
    """Flat elements [start, stop) of any ``bernoulli(k, p, shape)`` mask
    that holds them: ``p`` a Python float, a 0-d tensor or a 1-D tensor of
    ``stop - start`` probabilities. Drawn ``chunk`` elements at a time."""
    if isinstance(p, torch.Tensor):
        if p.ndim or device is None:
            device = p.device
        p = p.to(torch.float32)
    else:  # a 0-d host scalar compares as f32 on any device, with no copy
        p = torch.tensor(p, dtype=torch.float32)
    out = torch.empty(stop - start, dtype=torch.bool, device=device)
    for s in range(start, stop, chunk):
        e = min(stop, s + chunk)
        u = _uniform_of(random_bits(k, s, e, out.device))
        torch.lt(u, p[s - start:e - start] if p.ndim else p, out=out[s - start:e - start])
    return out


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
