"""Tests of the port that need a CUDA card (marker ``cuda``; each skips on a
host without one). This file imports neither JAX nor the JAX package, so on
a machine without JAX it runs with the JAX suite's conftest switched off:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

chip_smoke.py holds the kernel to its plain version at the full Llama-3.1-8B
decode shapes; these tests cover the wrapper's contract and the routing.
"""

import numpy as np
import pytest
import torch

from shardmerge_tpu_torch.models import quant
from shardmerge_tpu_torch.models import quant_kernels as qk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _weights(n, k, card, seed=0):
    rng = np.random.default_rng(seed)
    wq = quant.quantize(rng.standard_normal((n, k)).astype(np.float32), bits=4)
    return wq["q"].to(card), wq["scale"].to(card)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("rows", [1, 3, 9, 64])
def test_kernel_matches_plain_version(card, dtype, tol, rows):
    """Ragged shapes: N not a multiple of the 16-row block, K/2 not a
    multiple of the 512-byte tile, row counts across the 1/4/8 variants."""
    q, s = _weights(1000, 1056, card)
    x = torch.randn((rows, 1056), device=card).to(dtype)
    got = qk.int4_matmul(x, q, s)
    want = qk.int4_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, 1000)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= tol, rel


def test_kernel_counts_launches_and_keeps_leading_dims(card):
    q, s = _weights(256, 512, card)
    qk.reset_launch_counts()
    x = torch.randn((2, 3, 512), device=card, dtype=torch.bfloat16)
    y = qk.int4_matmul(x, q, s)
    assert y.shape == (2, 3, 256)
    assert qk.launch_counts["int4_gemv"] == 1


def test_wrapper_raises_instead_of_falling_back(card):
    q, s = _weights(256, 512, card)
    with pytest.raises(ValueError):
        qk.int4_matmul(torch.randn((65, 512), device=card), q, s)  # > 64 rows
    with pytest.raises(TypeError):
        qk.int4_matmul(torch.randn((1, 512), device=card, dtype=torch.float16), q, s)
    with pytest.raises(ValueError):
        qk.int4_matmul(torch.randn((1, 512), device=card), q.cpu(), s)


def test_dequant_matmul_routes_decode_rows_to_the_kernel(card):
    """<= 64 rows on the card take the kernel; a prefill-sized product
    takes the plain split-half matmul; both agree with the plain GEMV."""
    q, s = _weights(512, 1024, card)
    wq = {"q": q, "scale": s}
    qk.reset_launch_counts()
    small = torch.randn((4, 1024), device=card)
    big = torch.randn((2, 80, 1024), device=card)
    y_small = quant.dequant_matmul(small, wq)
    assert qk.launch_counts["int4_gemv"] == 1
    y_big = quant.dequant_matmul(big, wq)
    assert qk.launch_counts["int4_gemv"] == 1
    for x, y in ((small, y_small), (big, y_big)):
        want = qk.int4_matmul_plain(x, q, s)
        assert float((y - want).norm() / want.norm()) <= 1e-5
