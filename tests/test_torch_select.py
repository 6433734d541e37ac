"""Port vs JAX: exact order statistics (shardmerge_tpu_torch/ops/select.py
against shardmerge_tpu/ops/select.py). Selections are exact, so every
comparison is bit-for-bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.ops import select as jsel
from shardmerge_tpu_torch.ops import select as tsel


def _bits(x) -> int:
    return int(np.asarray(x, dtype=np.float32).reshape(1).view(np.int32)[0])


def _sample(rng, n, nans=0):
    x = np.abs(rng.standard_normal(n)).astype(np.float32)
    x[rng.choice(n, size=n // 5, replace=False)] *= 1e30  # high exponent bits
    x[:3] = 0.0  # ties at zero
    if nans:
        x[rng.choice(n, size=nans, replace=False)] = np.nan
    return x


@pytest.mark.parametrize("nans", [0, 7])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_kth_smallest_nonneg_matches_jax_and_sort(nans, where):
    rng = np.random.default_rng(11)
    x = _sample(rng, 301, nans)
    k = {"first": 0, "middle": 150, "last": x.size - 1}[where]
    got = tsel.kth_smallest_nonneg(torch.from_numpy(x), k)
    want_sort = torch.sort(torch.from_numpy(x))[0][k]
    want_jax = jsel.kth_smallest_nonneg(jnp.asarray(x), k)
    assert _bits(got) == _bits(want_sort) == _bits(want_jax)


@pytest.mark.parametrize("k", [0, 211, 399])
def test_kth_smallest_nonneg2_matches_concat_sort(k):
    rng = np.random.default_rng(12)
    x, y = _sample(rng, 250, nans=2), _sample(rng, 150)
    got = tsel.kth_smallest_nonneg2(torch.from_numpy(x), torch.from_numpy(y), k)
    cat = torch.from_numpy(np.concatenate([x, y]))
    want_jax = jsel.kth_smallest_nonneg2(jnp.asarray(x), jnp.asarray(y), k)
    assert _bits(got) == _bits(torch.sort(cat)[0][k]) == _bits(want_jax)


@pytest.mark.parametrize("cols", [9, 10])  # odd and even half-spectrum widths
def test_kth_smallest_weighted_matches_mirrored_sort(cols):
    rng = np.random.default_rng(13)
    x = _sample(rng, 6 * cols).reshape(6, cols)
    y = _sample(rng, 6 * cols, nans=1).reshape(6, cols)
    w = np.full(cols, 2, np.int32)
    w[0] = 1
    w[-1] = 1
    expanded = np.concatenate(
        [np.repeat(x, w, axis=1).ravel(), np.repeat(y, w, axis=1).ravel()]
    )
    total = expanded.size
    for k in (0, total // 3, total - 1):
        got = tsel.kth_smallest_weighted(
            torch.from_numpy(x), k, torch.from_numpy(w), y=torch.from_numpy(y)
        )
        want_sort = torch.sort(torch.from_numpy(expanded))[0][k]
        want_jax = jsel.kth_smallest_weighted(
            jnp.asarray(x), k, jnp.asarray(w), y=jnp.asarray(y)
        )
        assert _bits(got) == _bits(want_sort) == _bits(want_jax), k


def test_kth_smallest_weighted_counts_stay_exact_past_2_pow_24():
    """~1.7e8 weighted elements from a (5, 8) array: float counts would
    lose the rank; integer counts keep it exact."""
    rng = np.random.default_rng(14)
    x = _sample(rng, 40).reshape(5, 8)
    w = (np.arange(1, 9, dtype=np.int64) << 22).astype(np.int32)
    total = int(w.sum()) * 5
    assert total > 2**24
    order = np.argsort(x, axis=None, kind="stable")
    counts = np.broadcast_to(w, x.shape).ravel()[order]
    cum = np.cumsum(counts)
    for k in (2**24 + 1, total // 2 + 3, total - 1):
        want = x.ravel()[order][np.searchsorted(cum, k, side="right")]
        got = tsel.kth_smallest_weighted(torch.from_numpy(x), k, torch.from_numpy(w))
        want_jax = jsel.kth_smallest_weighted(jnp.asarray(x), k, jnp.asarray(w))
        assert _bits(got) == _bits(want) == _bits(want_jax), k
