"""Port vs JAX: int4 weight quantization and the int4 GEMV
(shardmerge_tpu_torch/models/quant.py, quant_kernels.py against
shardmerge_tpu/models/quant.py, quant_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.models import quant as jquant
from shardmerge_tpu.models.quant_kernels import int4_matmul as jax_int4_matmul
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.models import quant_kernels as tk


@pytest.fixture
def w(rng):
    return rng.standard_normal((128, 256)).astype(np.float32)


def test_pack4_bytes_equal_jax(rng):
    q = rng.integers(-7, 8, size=(16, 64)).astype(np.int8)
    want = jquant._pack4(q)
    np.testing.assert_array_equal(tquant._pack4(q), want)
    np.testing.assert_array_equal(tquant._unpack4(torch.from_numpy(want)).numpy(), q)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_bit_equal_to_jax_host_quantize(w, bits):
    ours = tquant.quantize(w, bits=bits)
    theirs = jquant.quantize(w, bits=bits)
    np.testing.assert_array_equal(ours["q"].numpy(), theirs["q"])
    np.testing.assert_array_equal(ours["scale"].numpy(), theirs["scale"])
    np.testing.assert_array_equal(
        tquant.dequant(ours, torch.float32).numpy(),
        np.asarray(jquant.dequant(theirs, jnp.float32)),
    )


@pytest.mark.parametrize("lead", [(1,), (3,), (2, 4)])
def test_int4_matmul_plain_matches_jax_kernel_interpret(w, rng, lead):
    """As tests/test_models.py runs the Pallas kernel on the host
    (interpret mode): rtol/atol 5e-4 for f32 x (the JAX kernel folds the
    +8 offset out of the product, a different f32 association)."""
    wq = jquant.quantize(w, bits=4)
    x = rng.standard_normal(lead + (256,)).astype(np.float32)
    theirs = np.asarray(jax_int4_matmul(jnp.asarray(x), jnp.asarray(wq["q"]), jnp.asarray(wq["scale"])))
    ours = tk.int4_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(wq["q"]), torch.from_numpy(wq["scale"])
    )
    assert ours.shape == theirs.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_matmul_plain_path_matches_jax_xla_path(w, rng, bits):
    """On host tensors both packages take the plain path (split-half
    decomposition for int4, dequantized matmul for int8); f32 reduction
    order only (1e-5)."""
    wq = tquant.quantize(w, bits=bits)
    before = dict(tk.launch_counts)
    for lead in [(1,), (70,)]:
        x = rng.standard_normal(lead + (256,)).astype(np.float32)
        ours = tquant.dequant_matmul(torch.from_numpy(x), wq).numpy()
        theirs = np.asarray(
            jquant.dequant_matmul(
                jnp.asarray(x), {"q": jnp.asarray(wq["q"].numpy()), "scale": jnp.asarray(wq["scale"].numpy())}
            )
        )
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    assert dict(tk.launch_counts) == before  # host tensors never launch


def test_int4_matmul_on_host_tensor_is_the_plain_version(w, rng):
    wq = tquant.quantize(w, bits=4)
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32)).to(torch.bfloat16)
    before = dict(tk.launch_counts)
    got = tk.int4_matmul(x, wq["q"], wq["scale"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tk.int4_matmul_plain(x, wq["q"], wq["scale"]))
    assert dict(tk.launch_counts) == before


def test_supported_shapes():
    assert tk.supported((1, 4096), (4096, 2048))
    assert tk.supported((4, 16, 14336), (4096, 7168))  # 64 rows
    assert not tk.supported((65, 4096), (4096, 2048))  # > 64 rows
    assert not tk.supported((1, 4096), (4096, 1024))  # K mismatch
    assert not tk.supported((1, 40), (8, 20))  # K/2 not a multiple of 16


# (N, K) of the decode GEMVs: Llama-3.1-8B (q/o, k/v, gate/up, down),
# Llama-3.1-70B (the same four), and a ragged shape (N, K/2 off every tile)
PLAN_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (8192, 8192), (1024, 8192), (28672, 8192), (8192, 28672), (1000, 1056)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,k", PLAN_SHAPES)
def test_plan_cuts_k_into_at_most_eight_nonempty_splits(n, k, dtype):
    """The plan is a function of the weight's (N, K) and x's dtype alone
    (no row count reaches it, so a row's K order is the same at every B);
    its splits are whole chunks, at most one cluster's 8 blocks, none
    empty, and they cover K/2 exactly once."""
    import inspect

    assert list(inspect.signature(tk.plan).parameters) == ["n", "k", "dtype"]
    p = tk.plan(n, k, dtype)
    assert p.chunk == tk.TILES[dtype][1]
    run = p.chunks_per_split * p.chunk
    assert 1 <= p.splits <= tk.MAX_SPLITS
    assert (p.splits - 1) * run < k // 2 <= p.splits * run


@pytest.mark.parametrize("n,k", [(128, 4096), (128, 8192)])
def test_split_order_model_matches_jax_kernel_and_plain(rng, n, k, monkeypatch):
    """The kernel's split structure in plain torch (two and four splits
    here) against the JAX kernel in interpret mode and the plain version,
    f32 x, relL2 <= 1e-5 (f32 association only). At B = 1, 4, 8, 32 and 64
    it asks the plan for the same (N, K)."""
    wq = jquant.quantize(rng.standard_normal((n, k)).astype(np.float32), bits=4)
    q, s = torch.from_numpy(wq["q"]), torch.from_numpy(wq["scale"])
    assert tk.plan(n, k, torch.float32).splits > 1
    asked = []
    plan = tk.plan
    monkeypatch.setattr(tk, "plan", lambda *a: asked.append(a) or plan(*a))
    for rows in (1, 4, 8, 32, 64):
        x = rng.standard_normal((rows, k)).astype(np.float32)
        got = tk.int4_matmul_split_order(torch.from_numpy(x), q, s)
        plain = tk.int4_matmul_plain(torch.from_numpy(x), q, s)
        assert got.shape == (rows, n) and got.dtype == torch.float32
        assert float((got - plain).norm() / plain.norm()) <= 1e-5
        if rows in (1, 8):  # the JAX kernel in interpret mode, at the generate and pool batches
            theirs = np.asarray(jax_int4_matmul(jnp.asarray(x), jnp.asarray(wq["q"]), jnp.asarray(wq["scale"])))
            assert np.linalg.norm(got.numpy() - theirs) / np.linalg.norm(theirs) <= 1e-5
    assert set(asked) == {(n, k, torch.float32)}


def test_split_order_model_rounds_bf16_once(rng):
    """bf16 x (its own plan: two splits of 256-byte chunks here): the
    model's f32 sums rounded once to bf16, within the card's bf16 gate
    (4e-3) of the plain version."""
    wq = tquant.quantize(rng.standard_normal((128, 8192)).astype(np.float32), bits=4)
    assert tk.plan(128, 8192).splits > 1
    x = torch.from_numpy(rng.standard_normal((8, 8192)).astype(np.float32)).to(torch.bfloat16)
    got = tk.int4_matmul_split_order(x, wq["q"], wq["scale"])
    want = tk.int4_matmul_plain(x, wq["q"], wq["scale"])
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= 4e-3
