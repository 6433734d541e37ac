"""Port vs JAX: the stack reduction's pair scheduling
(shardmerge_tpu_torch/ops/pairing.py against shardmerge_tpu/ops/pairing.py).

``norm_product_matrix`` and ``correlated_pairs`` are numpy in both packages
and must agree exactly, ties, zeros and odd counts included;
``cosine_correlation`` is a batched device computation in both and agrees
within 1e-6."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from shardmerge_tpu.ops import pairing as jpairing
from shardmerge_tpu_torch.ops import pairing as tpairing

NORM_CASES = {
    "one": [3.0],
    "two": [1.0, 2.0],
    "odd": [0.5, 4.0, 1.5],
    "ties": [2.0, 2.0, 2.0, 2.0],
    "tied_products": [1.0, 6.0, 2.0, 3.0],
    "zeros": [0.0, 1.0, 0.0, 2.0, 5.0],
    "all_zero": [0.0, 0.0, 0.0],
    "wide_range": [1e-9, 2e-9, 1e-2, 3e-2, 8e-2],
    "seven": [7.0, 1.0, 5.0, 3.0, 2.0, 6.0, 4.0],
}


@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_norm_product_matrix_and_pairs_match_jax(name):
    norms = NORM_CASES[name]
    ours = tpairing.norm_product_matrix(norms)
    theirs = jpairing.norm_product_matrix(norms)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    for way in ("least", "most"):
        assert list(tpairing.correlated_pairs(ours, way)) == list(
            jpairing.correlated_pairs(theirs, way)
        )


def test_pairs_shape_of_a_reduction():
    """x < y for every pair, the first argwhere match wins a tie, and the
    odd leftover comes last as (i, -1, diag)."""
    pairs = list(tpairing.correlated_pairs(tpairing.norm_product_matrix([2.0] * 5)))
    assert pairs == [(0, 1, 4.0), (2, 3, 4.0), (4, -1, 0.0)]
    with pytest.raises(ValueError, match="Invalid way"):
        list(tpairing.correlated_pairs(np.ones((2, 2)), "median"))


@settings(max_examples=40, deadline=None, database=None)
@given(
    st.lists(
        st.one_of(
            st.just(0.0),
            st.sampled_from([1.0, 2.0, 3.0]),
            st.floats(0.0, 1e3, allow_nan=False, allow_infinity=False, width=32),
        ),
        min_size=1,
        max_size=9,
    )
)
def test_random_norm_vectors_pair_like_jax(norms):
    m = tpairing.norm_product_matrix(norms)
    np.testing.assert_array_equal(m, jpairing.norm_product_matrix(norms))
    assert list(tpairing.correlated_pairs(m)) == list(jpairing.correlated_pairs(m))


@pytest.mark.parametrize(
    "shape", [(4, 16), (3, 8, 6), (5, 4, 3, 2)], ids=["1-D", "2-D", "3-D"]
)
@pytest.mark.parametrize("with_zero", [False, True], ids=["random", "zero_tensor"])
def test_cosine_correlation_matches_jax(shape, with_zero):
    """A zero tensor's cosines are 0/eps^2 = 0 exactly; NaNs (none arise from
    finite input with the eps clamp) would map to 0 in both."""
    stack = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    if with_zero:
        stack[1] = 0.0
    ours = tpairing.cosine_correlation(stack)
    theirs = jpairing.cosine_correlation(stack)
    assert ours.shape == theirs.shape == (shape[0], shape[0])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    assert np.all(np.diag(ours) == 0)
    if with_zero:
        assert np.all(ours[1] == 0) and np.all(ours[:, 1] == 0)
