"""Port vs JAX: jax.random's threefry2x32 keys, uniforms and Bernoulli masks
(shardmerge_tpu_torch/ops/prng.py against jax.random with its default
threefry2x32 implementation, partitionable), bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.ops import prng


def _jax_key(seed, *data):
    k = jax.random.key(jnp.uint32(seed))
    for d in data:
        k = jax.random.fold_in(k, jnp.uint32(d))
    return k


def _port_key(seed, *data):
    k = prng.key(seed)
    for d in data:
        k = prng.fold_in(k, d)
    return k


def test_jax_runs_the_implementation_the_port_reproduces():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize(
    "seed,data",
    [(0, (123, 1)), (0, ()), (7, (0x7FFFFFFF,)), (2**32 - 1, (5, 0, 3)), (123456789, (2**31 + 5, 9))],
)
def test_key_data_bit_equal(seed, data):
    want = np.asarray(jax.random.key_data(_jax_key(seed, *data))).tolist()
    assert list(_port_key(seed, *data)) == want


def test_threefry_on_tensors_equals_the_scalar_path():
    """The in-place tensor rounds give the Python-int rounds' words, and
    leave the counter words as they were."""
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.integers(0, 2**32, 257, dtype=np.int64))
    x1 = torch.from_numpy(rng.integers(0, 2**32, 257, dtype=np.int64))
    k = _port_key(3, 4)
    before = (x0.clone(), x1.clone())
    o0, o1 = prng.threefry2x32(k, x0, x1)
    assert torch.equal(x0, before[0]) and torch.equal(x1, before[1])
    for i in (0, 1, 128, 256):
        assert (int(o0[i]), int(o1[i])) == prng.threefry2x32(k, int(x0[i]), int(x1[i]))


# (37, 53) odd; (300, 301) > 2^16 elements; (7,) 1-D
SHAPES = [(37, 53), (300, 301), (7,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_bit_equal(shape):
    """The 32-bit words under a key: ``jax.random.bits`` of the shape,
    flattened row-major."""
    want = np.asarray(jax.random.bits(_jax_key(11, 99, 2), shape, jnp.uint32)).reshape(-1)
    n = int(np.prod(shape))
    got = prng.random_bits(_port_key(11, 99, 2), 0, n, "cpu").numpy()
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9], ids=lambda p: f"p{p}")
def test_bernoulli_scalar_p_bit_equal(shape, p):
    want = np.asarray(jax.random.bernoulli(_jax_key(5, 17), jnp.float32(p), shape))
    got = prng.bernoulli(_port_key(5, 17), p, shape).numpy()
    assert np.array_equal(got, want)
    # a 0-d tensor p is the same f32
    assert np.array_equal(prng.bernoulli(_port_key(5, 17), torch.tensor(p), shape).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bernoulli_array_p_bit_equal(shape):
    p = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(jax.random.bernoulli(_jax_key(8, 3, 1), jnp.asarray(p)))
    got = prng.bernoulli(_port_key(8, 3, 1), torch.from_numpy(p), shape).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chunk", [777, 1000, 4096, 1 << 22])
def test_chunked_equals_unchunked(chunk):
    """The counter is the flat index, so any chunking of the flat range (and
    any sub-range) gives the whole mask's bits."""
    shape = (300, 301)
    p = torch.from_numpy(np.random.default_rng(2).random(shape).astype(np.float32))
    k = _port_key(1, 2, 3)
    whole = prng.bernoulli(k, p, shape, chunk=shape[0] * shape[1])
    assert torch.equal(prng.bernoulli(k, p, shape, chunk=chunk), whole)
    flat_p = p.reshape(-1)
    part = prng.bernoulli_range(k, flat_p[1234:50000], 1234, 50000, chunk=chunk)
    assert torch.equal(part, whole.reshape(-1)[1234:50000])


def test_bernoulli_refuses_a_p_of_another_shape():
    with pytest.raises(ValueError, match="shape"):
        prng.bernoulli(_port_key(0), torch.zeros(3, 4), (4, 3))
