"""Port vs JAX: the spectral blend (shardmerge_tpu_torch/ops/blend.py against
shardmerge_tpu/ops/blend.py), on IDENTICAL spectra computed once and fed to
both, so masks and thresholds must agree bit for bit; blended values differ
only by reduction order (tolerances stated per test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.ops import blend as jblend
from shardmerge_tpu.ops import select as jsel
from shardmerge_tpu_torch.merge import fourier as tfourier
from shardmerge_tpu_torch.ops import blend as tblend
from shardmerge_tpu_torch.ops import select as tsel

from . import oracle_torch as oracle


def _spectra(rng, shape):
    v0 = np.fft.fftn(rng.standard_normal(shape), axes=(-2, -1)).astype(np.complex64)
    v1 = np.fft.fftn(rng.standard_normal(shape), axes=(-2, -1)).astype(np.complex64)
    return v0, v1


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_rank_helpers_match():
    for n, pct in [(16, 0.08), (1 << 20, 0.08), (384, 0.2), (1000, 0.1)]:
        assert tblend.cutoff_rank(n, pct) == jblend.cutoff_rank(n, pct)
        assert tblend.cull_rank(n, pct) == jblend.cull_rank(n, pct)
        assert tblend.cull_limit(n, pct) == jblend.cull_limit(n, pct)
    for n in (10, 11):
        np.testing.assert_array_equal(
            tblend.hermitian_col_weights(n).numpy(), jblend.hermitian_col_weights(n)
        )


@pytest.mark.parametrize("t", [0.3, 0.9])
def test_slerp_matches_jax(t):
    rng = np.random.default_rng(25)
    v0 = rng.standard_normal((6, 10)).astype(np.float32)
    v1 = rng.standard_normal((6, 10)).astype(np.float32)
    got = tblend.slerp(torch.from_numpy(v0), torch.from_numpy(v1), t).numpy()
    want = np.asarray(jblend.slerp(jnp.asarray(v0), jnp.asarray(v1), t))
    # global dot and norms: f32 reduction order only
    assert _rel_l2(got, want) <= 1e-6


@pytest.mark.parametrize("zero", [False, True])
def test_normalize_tensor_matches_jax(zero):
    rng = np.random.default_rng(26)
    x = np.zeros((6, 10), np.float32) if zero else rng.standard_normal((6, 10)).astype(np.float32)
    got, norm_t = tblend.normalize_tensor(torch.from_numpy(x))
    want, norm_j = jblend.normalize_tensor(jnp.asarray(x))
    # one f32 norm, summed in another order: 1e-6 relative
    assert float(norm_t) == pytest.approx(float(norm_j), rel=1e-6, abs=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_thresholds_and_masks_bit_equal_on_identical_spectra():
    rng = np.random.default_rng(21)
    v0, v1 = _spectra(rng, (12, 20))
    r0, r1 = v0.real, v1.real
    a0, a1 = np.abs(r0), np.abs(r1)
    k = jblend.cutoff_rank(r0.size, 0.08)
    thr_t = tsel.kth_smallest_nonneg2(torch.from_numpy(a0), torch.from_numpy(a1), k)
    thr_j = jsel.kth_smallest_nonneg2(jnp.asarray(a0), jnp.asarray(a1), k)
    assert np.float32(thr_t).tobytes() == np.float32(thr_j).tobytes()
    thr = float(thr_t)
    sign_t = torch.sign(torch.from_numpy(r0)) == torch.sign(torch.from_numpy(r1))
    sign_j = jnp.sign(jnp.asarray(r0)) == jnp.sign(jnp.asarray(r1))
    np.testing.assert_array_equal(sign_t.numpy(), np.asarray(sign_j))
    # REF-QUIRK: the "small" mask tests |Re v1| only
    small = a1 < thr
    assert small.sum() > 0 and (a0 < thr).sum() != small.sum()

    # cull threshold on the blended real plane, and the full blend output
    args = (0.6, 1.0, k, jblend.cull_rank(r0.size, 0.2), jblend.cull_limit(r0.size, 0.2))
    out_t = tblend.interpolate_fft_components(
        torch.from_numpy(v0), torch.from_numpy(v1), *args,
        use_cutoff=True, use_cull=True, interp_imag=False,
    ).numpy()
    out_j = np.asarray(
        jblend.interpolate_fft_components(
            jnp.asarray(v0), jnp.asarray(v1), *args,
            use_cutoff=True, use_cull=True, interp_imag=False,
        )
    )
    # culled lanes are exact zeros on both sides: the cull mask is shared
    np.testing.assert_array_equal(out_t.real == 0, out_j.real == 0)
    assert (out_t.real == 0).sum() >= jblend.cull_rank(r0.size, 0.2)
    # values: f32 reduction order only (slerp dot/norms)
    assert _rel_l2(out_t.real, out_j.real) <= 1e-6
    np.testing.assert_array_equal(out_t.imag, out_j.imag)


@pytest.mark.parametrize("interp_imag", [False, True])
def test_interpolate_fft_components_matches_jax(interp_imag):
    rng = np.random.default_rng(22)
    v0, v1 = _spectra(rng, (8, 12))
    args = (0.3, 1.0, jblend.cutoff_rank(96, 0.08), jblend.cull_rank(96, 0.2),
            jblend.cull_limit(96, 0.2))
    out_t = tblend.interpolate_fft_components(
        torch.from_numpy(v0), torch.from_numpy(v1), *args,
        use_cutoff=True, use_cull=True, interp_imag=interp_imag,
    ).numpy()
    out_j = np.asarray(
        jblend.interpolate_fft_components(
            jnp.asarray(v0), jnp.asarray(v1), *args,
            use_cutoff=True, use_cull=True, interp_imag=interp_imag,
        )
    )
    # the imaginary recursion blends FFT rounding noise: its values are
    # library dependent at the noise level, so compare at 1e-4 relL2
    assert _rel_l2(out_t.real, out_j.real) <= 1e-6
    assert _rel_l2(out_t.imag, out_j.imag) <= (1e-4 if interp_imag else 0)


def test_arithmetic_fft_components_matches_jax():
    rng = np.random.default_rng(23)
    v0, v1 = _spectra(rng, (8, 12))
    out_t = tblend.arithmetic_fft_components(
        torch.from_numpy(v0), torch.from_numpy(v1), 1.0, agreement=True, do_imag=False
    ).numpy()
    out_j = np.asarray(
        jblend.arithmetic_fft_components(
            jnp.asarray(v0), jnp.asarray(v1), 1.0, agreement=True, do_imag=False
        )
    )
    np.testing.assert_array_equal(out_t, out_j)  # elementwise only: exact


@pytest.mark.parametrize("shape", [(16, 24), (16, 23)])  # even and odd N
def test_half_spectrum_equals_full_spectrum_fast_imag(shape):
    """interpolate_half_spectrum on rfft halves == the full-spectrum blend
    with the imaginary part passed through, restricted to the half."""
    rng = np.random.default_rng(24)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    n = a.numel()
    args = (0.6, 1.0, tblend.cutoff_rank(n, 0.08), tblend.cull_rank(n, 0.2),
            tblend.cull_limit(n, 0.2))
    full = tblend.interpolate_fft_components(
        tblend.fft2(a), tblend.fft2(b), *args,
        use_cutoff=True, use_cull=True, interp_imag=False,
    )
    half = tblend.interpolate_half_spectrum(
        torch.fft.rfftn(a, dim=(-2, -1)), torch.fft.rfftn(b, dim=(-2, -1)), *args,
        tblend.hermitian_col_weights(shape[-1]), use_cutoff=True, use_cull=True,
    )
    ref = full[..., : half.shape[-1]].numpy()
    got = half.numpy()
    assert _rel_l2(got.real, ref.real) <= 1e-6
    assert _rel_l2(got.imag, ref.imag) <= 1e-6


def _even_symmetric(rng, n):
    x = np.zeros(n, np.float32)
    x[: n // 2 + 1] = rng.standard_normal(n // 2 + 1).astype(np.float32)
    for k in range(1, n // 2):
        x[n - k] = x[k]
    return x


def test_exact_path_reproduces_nan_cascade_quirk():
    """The pinned reference quirk (tests/test_ops_blend.py
    test_nan_cascade_quirk_pinned): on this even-symmetric (16,) pair the
    inner SLERP divides 0/0 and the scrub zeroes most lanes. The port's
    exact path cascades identically to the torch oracle and the JAX exact
    path: same lanes, bit-equal survivors."""
    from shardmerge_tpu.merge.fourier import _pair_slerp as jax_pair_slerp

    n = 16
    rng = np.random.default_rng(3)
    a = _even_symmetric(rng, n)
    b = _even_symmetric(rng, n)
    theirs, _, _ = oracle.merge_tensors_fft2_slerp(
        torch.from_numpy(a), torch.from_numpy(b), t=0.6, cutoff_pct=0.08, cull_pct=0.2
    )
    ranks = (tblend.cutoff_rank(n, 0.08), tblend.cull_rank(n, 0.2), tblend.cull_limit(n, 0.2))
    ours, nan_count, _ = tfourier._pair_slerp(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.tensor(np.linalg.norm(a), dtype=torch.float32),
        torch.tensor(np.linalg.norm(b), dtype=torch.float32),
        0.6, *ranks, 1.0, use_cutoff=True, use_cull=True,
    )
    jax_out, jax_nans, _ = jax_pair_slerp(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(np.linalg.norm(a)),
        jnp.float32(np.linalg.norm(b)), jnp.float32(0.6),
        *[jnp.int32(r) for r in ranks], jnp.float32(1.0),
        use_cutoff=True, use_cull=True, fast_imag=False,
    )
    assert int(nan_count) == int(jax_nans) > n // 2
    np.testing.assert_array_equal(ours.numpy(), theirs.numpy())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_out))
    assert not tfourier._use_fast_imag(False, torch.from_numpy(a))
    assert not tfourier._use_fast_imag(False, torch.zeros(512, 512))
    assert tfourier._use_fast_imag(False, torch.zeros(1024, 1024))
    assert not tfourier._use_fast_imag(True, torch.zeros(1024, 1024))  # exact_imag


@pytest.mark.parametrize("shape", [(64, 48), (33,)], ids=str)
@pytest.mark.parametrize("agreement", [True, False])
def test_task_arithmetic_fft2_matches_jax_and_the_oracle(shape, agreement):
    """FFT, sign-agreement arithmetic with the imaginary recursion, inverse:
    within relL2 1e-6 of JAX (another FFT library) and of the torch oracle."""
    rng = np.random.default_rng(61)
    v0 = rng.standard_normal(shape).astype(np.float32)
    v1 = rng.standard_normal(shape).astype(np.float32)
    got = tblend.task_arithmetic_fft2(torch.from_numpy(v0), torch.from_numpy(v1), 1.0, agreement=agreement).numpy()
    want = np.asarray(jblend.task_arithmetic_fft2(jnp.asarray(v0), jnp.asarray(v1), jnp.float32(1.0),
                                                  agreement=agreement))
    ref = oracle.task_arithmetic_fft2(torch.from_numpy(v0), torch.from_numpy(v1), 1.0, agreement).numpy()
    assert _rel_l2(got, want) <= 1e-6
    assert _rel_l2(got, ref) <= 1e-6


@pytest.mark.parametrize("shape", [(64, 48), (128, 128), (33,)], ids=str)
@pytest.mark.parametrize("regime,scale", [("slerp", 1.0), ("lowratio", 0.05), ("early", 1e-6)])
def test_merge_tensors_fft2_slerp_matches_jax_and_the_oracle(shape, regime, scale):
    """The full pair merge in each of its host branches (masked SLERP-FFT at
    cutoff 8% and cull 20%, the additive low-ratio path, the normalized
    early return): norms within 1e-6 of JAX's, the merged tensor within
    relL2 1e-6 of JAX's and of the torch oracle's."""
    rng = np.random.default_rng(62)
    v0 = rng.standard_normal(shape).astype(np.float32)
    v1 = (scale * rng.standard_normal(shape)).astype(np.float32)
    kw = dict(cutoff_pct=0.08, cull_pct=0.2)
    got, n0, n1 = tblend.merge_tensors_fft2_slerp(torch.from_numpy(v0), torch.from_numpy(v1), 0.6, **kw)
    want, m0, m1 = jblend.merge_tensors_fft2_slerp(jnp.asarray(v0), jnp.asarray(v1), 0.6, **kw)
    ref, _, _ = oracle.merge_tensors_fft2_slerp(torch.from_numpy(v0), torch.from_numpy(v1), 0.6, **kw)
    assert n0 == pytest.approx(m0, rel=1e-6) and n1 == pytest.approx(m1, rel=1e-6)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-6
    assert _rel_l2(got.numpy(), ref.numpy()) <= 1e-6
    # known norms skip the read-back and give the same result
    again, _, _ = tblend.merge_tensors_fft2_slerp(torch.from_numpy(v0), torch.from_numpy(v1), 0.6, norms=(n0, n1), **kw)
    assert torch.equal(again, got)
