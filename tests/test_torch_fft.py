"""The port's spectral transforms against the JAX modules, on the CPU.

shardmerge_tpu_torch/ops/pallas_fft.py and ops/fft_vpu.py take the plain
path on CPU tensors (the four-step arithmetic and the flat Stockham in f32
torch); the JAX functions run their Pallas kernels in interpret mode, as
tests/test_pallas_fft.py and tests/test_fft_vpu.py run them. The same numpy
inputs from a seed go through both. Tolerances are the JAX tests' own:
2e-6 * max|ref| for the four-step DFT (f32 sums of 64-128 terms), 4e-6 *
max|ref| for the Stockham path (its chained twiddles), 1e-5 absolute for
round trips. Each JAX result is computed once per module (the interpret
mode costs seconds per call).
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.ops import fft_vpu as jfv
from shardmerge_tpu.ops import pallas_fft as jpf
from shardmerge_tpu_torch.ops import fft_vpu as tfv
from shardmerge_tpu_torch.ops import pallas_fft as tpf

# (shape, complex input): the JAX tests' real inputs and their complex one
DFT_CASES = [((64, 96), False), ((32, 128), False), ((32, 64), True)]
RFFT_SHAPES = [(64, 128), (128, 448), (56, 112), (96, 160)]
# the shapes of test_fft_vpu.py::test_supported_gate plus the 8B ones
GATE_SHAPES = [(4096, 8192), (2048, 3584), (4096, 14336), (4096, 8191), (4, 128), (4096, 22), (4096,),
               (4096, 4096), (1024, 4096), (14336, 4096), (64, 128), (128, 448)]


def _planes(shape, seed, complex_input=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32) if complex_input else np.zeros(shape, np.float32)
    return x, y


@lru_cache(maxsize=None)
def _jax_dft(axis, shape, complex_input, inverse):
    x, y = _planes(shape, 3, complex_input)
    fn = jpf.dft_rows if axis == "rows" else jpf.dft_cols
    r, i = fn(jnp.asarray(x), jnp.asarray(y), inverse=inverse)
    return np.asarray(r) + 1j * np.asarray(i)


@lru_cache(maxsize=None)
def _jax_rfft2(shape):
    x, _ = _planes(shape, 5, False)
    return np.array(jfv.rfft2_vpu(jnp.asarray(x)))


def _c(pair):
    return pair[0].numpy() + 1j * pair[1].numpy()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("shape,complex_input", DFT_CASES)
def test_dft_matches_jax_and_numpy(axis, shape, complex_input, inverse):
    x, y = _planes(shape, 3, complex_input)
    fn = tpf.dft_rows if axis == "rows" else tpf.dft_cols
    got = _c(fn(torch.from_numpy(x), torch.from_numpy(y), inverse=inverse))
    want = _jax_dft(axis, shape, complex_input, inverse)
    npfn = np.fft.ifft if inverse else np.fft.fft
    exact = npfn(x + 1j * y, axis=1 if axis == "rows" else 0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-6 * scale)
    np.testing.assert_allclose(got, exact, atol=2e-6 * scale)


def test_fft2_mxu_round_trip_matches_jax():
    x, _ = _planes((64, 96), 3, False)
    fr, fi = tpf.fft2_mxu(torch.from_numpy(x))
    jr, ji = jpf.fft2_mxu(jnp.asarray(x))
    want = np.asarray(jr) + 1j * np.asarray(ji)
    scale = np.abs(want).max()
    np.testing.assert_allclose(_c((fr, fi)), want, atol=2e-6 * scale)
    np.testing.assert_allclose(_c((fr, fi)), np.fft.fft2(x), atol=2e-6 * scale)
    back_r, back_i = tpf.ifft2_mxu(fr, fi)
    np.testing.assert_allclose(back_r.numpy(), x, atol=1e-5)
    np.testing.assert_allclose(back_i.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("n", [96, 128, 64, 97, 8192, 4096, 14336])
@pytest.mark.parametrize("inverse", [False, True])
def test_factor_tables_bit_equal(n, inverse):
    got = tpf._factors(n, inverse, "cpu")
    want = jpf._factors(n, inverse)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [8192, 4096, 14336, 48, 7, 97, 1, 2, 96, 128, 1024, 4128])
def test_good_split_equal(n):
    assert tpf.good_split(n) == jpf.good_split(n)


@pytest.mark.parametrize(
    "n,want",
    [(8192, (8, 8, 8, 8, 2)), (14336, (8, 8, 8, 4, 7)), (4096, (8, 8, 8, 8)), (128, (8, 8, 2)), (112, (8, 2, 7)),
     (384, (8, 8, 2, 3)), (334, (2, 167)), (128256, (8, 8, 4, 3, 167)), (97, (97,)), (96, (8, 4, 3)),
     (48, (8, 2, 3)), (40, (8, 5)), (1, ()), (2, (2,)), (121, (11, 11)), (2 * 16411, (2, 16411))],
)
def test_radix_factorization(n, want):
    assert tpf._radices(n) == want
    assert np.prod(want, dtype=np.int64) == n


# (kernel, shape) -> each pass's (length, adjacent lines per block, threads;
# 0 = the direct sum)
PLAN_CASES = [
    ("dft_rows", (4096, 8192), [(8192, 1, 512)]),  # one line per block, two blocks per SM
    ("dft_rows", (4096, 14336), [(14336, 1, 1024)]),
    ("dft_rows", (4096, 4096), [(4096, 2, 512)]),
    ("dft_rows", (64, 97), [(97, 64, 512)]),
    ("dft_rows", (8, 32768), [(256, 32, 512), (128, 64, 512)]),  # split (128, 512)
    ("dft_rows", (3, 2 * 16411), [(16411, 1, 0), (2, 4096, 512)]),
    ("dft_cols", (4096, 8192), [(4096, 4, 1024)]),  # a strip of 4 columns, 128 KB
    ("dft_cols", (4096, 14336), [(4096, 4, 1024)]),
    ("dft_cols", (1024, 4096), [(1024, 16, 1024)]),
    ("dft_cols", (14336, 4096), [(128, 32, 512), (112, 32, 512)]),  # split (112, 128)
    ("dft_cols", (128256, 64), [(384, 32, 1024), (334, 32, 1024)]),  # split (334, 384)
    ("dft_cols", (97, 40), [(97, 32, 512)]),
    ("dft_cols", (24, 48), [(24, 32, 512)]),
]


@pytest.mark.parametrize("name,shape,want", PLAN_CASES)
def test_plan_route(name, shape, want):
    passes = tpf._plan(name, *shape)
    assert [(p.L, p.W, p.threads) for p in passes] == want
    length = shape[1] if name == "dft_rows" else shape[0]
    if len(passes) == 2:
        assert (passes[1].L, passes[0].L) == tpf.good_split(length)
        assert passes[0].twiddle and not passes[1].twiddle
    # only the last pass scales the inverse; a block holds what it is given
    assert [p.div for p in passes] == [0] * (len(passes) - 1) + [length]
    assert all(p.W * p.L <= tpf._capacity(p.L, small=p.threads == 512) for p in passes if p.threads)


@pytest.mark.parametrize("n", [8192, 14336, 97, 334, 128256, 1])
@pytest.mark.parametrize("inverse", [False, True])
def test_roots_table_bit_equal(n, inverse):
    """Every root and twiddle the kernel reads: e^(sign*2*pi*i*t/n) in
    float64, rounded once to f32."""
    tr, ti = tpf._roots(n, inverse, "cpu")
    w = np.exp((2j if inverse else -2j) * np.pi * np.arange(n) / n)
    assert tr.dtype == ti.dtype == torch.float32
    assert np.array_equal(tr.numpy(), w.real.astype(np.float32))
    assert np.array_equal(ti.numpy(), w.imag.astype(np.float32))


@pytest.mark.parametrize("length", [8192, 14336, 112, 334, 97, 1])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddles_bit_equal(length, inverse):
    """The stages' twiddles: w_m^(p*e) in float64, rounded once to f32, at
    (e - 1)*(m/r) + p after the earlier stages' entries."""
    radices = tpf._radices(length)
    w = tpf._stage_twiddles(length, radices, inverse, "cpu")
    tr, ti = w[:, 0].contiguous(), w[:, 1].contiguous()
    want, m = [], length
    for r in radices:
        for e in range(1, r):
            want.append(np.exp((2j if inverse else -2j) * np.pi * e * np.arange(m // r) / m))
        m //= r
    want = np.concatenate(want) if want else np.ones(1)
    assert tr.dtype == torch.float32 and tr.shape == want.shape
    assert np.array_equal(tr.numpy(), want.real.astype(np.float32))
    assert np.array_equal(ti.numpy(), want.imag.astype(np.float32))


def _run_schedule(name, shape, inverse, plan=None):
    m, n = shape
    length = n if name == "dft_rows" else m
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    tab = np.exp((2j if inverse else -2j) * np.pi * np.arange(length) / length)
    flat = x.ravel()
    for p in plan or tpf._plan(name, m, n):
        out = np.full(m * n, np.nan, complex)
        tpf._simulate(p, length, flat, tab, out, inverse)
        flat = out
    want = (np.fft.ifft if inverse else np.fft.fft)(x, axis=1 if name == "dft_rows" else 0)
    np.testing.assert_allclose(flat.reshape(shape), want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize(
    "name,shape",
    [("dft_rows", (8, 32768)), ("dft_cols", (14336, 3)), ("dft_cols", (128256, 2)), ("dft_rows", (24, 48)),
     ("dft_cols", (24, 48)), ("dft_rows", (5, 97)), ("dft_cols", (97, 5)), ("dft_rows", (3, 1)),
     ("dft_cols", (1, 5)), ("dft_rows", (6, 14336))],
)
def test_schedule_matches_numpy_fft(name, shape, inverse):
    """The kernel's stage order, index maps and table indices, run in
    float64 numpy, give the transform."""
    _run_schedule(name, shape, inverse)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize(
    "name,shape,want",
    [("dft_rows", (4, 96), [(12, 2, 1024), (8, 2, 512)]), ("dft_cols", (96, 4), [(12, 2, 1024), (8, 4, 1024)]),
     ("dft_rows", (3, 2 * 37), [(37, 1, 0), (2, 8, 512)]), ("dft_cols", (2 * 37, 3), [(37, 1, 0), (2, 3, 512)]),
     ("dft_cols", (37, 3), [(37, 1, 0), (1, 3, 512)]), ("dft_rows", (3, 37), [(37, 1, 0), (1, 16, 512)])],
)
def test_schedule_of_small_blocks(monkeypatch, name, shape, inverse, want):
    """Blocks shrunk to 32 values: short shapes take the two-pass route,
    a prime the direct sum (threads 0) and a pass of length 1, and the
    schedule still gives the transform."""
    monkeypatch.setattr(tpf, "_MAX_BLOCK", 32)
    monkeypatch.setattr(tpf, "_SMALL_BLOCK", 16)
    plan = tpf._plan.__wrapped__(name, *shape)
    assert [(p.L, p.W, p.threads) for p in plan] == want
    _run_schedule(name, shape, inverse, plan)


def test_pass_descriptor_layout():
    (p,) = tpf._plan("dft_rows", 4096, 14336)
    fwd = tpf._desc(p, 14336, False)
    inv = tpf._desc(p, 14336, True)
    assert fwd.dtype == np.int64
    # L, W, G1, lines, in strides, out strides, rs, n, twiddle, tw_g1, tw_c,
    # div, threads, inverse, nst, radices
    assert fwd.tolist() == [14336, 1, 1, 4096, 0, 14336, 1, 0, 14336, 1, 1, 14336, 0, 0, 0, 0, 1024, 0, 5,
                            8, 8, 8, 4, 7]
    assert inv[15] == 14336 and inv[17] == 1


def test_dft_wrapper_on_cpu_runs_the_plain_version():
    x, y = _planes((32, 64), 4)
    xr, xi = torch.from_numpy(x), torch.from_numpy(y)
    tpf.reset_launch_counts()
    for fn, plain in ((tpf.dft_rows, tpf.dft_rows_plain), (tpf.dft_cols, tpf.dft_cols_plain)):
        for inverse in (False, True):
            got = fn(xr, xi, inverse=inverse)
            want = plain(xr, xi, inverse=inverse)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sum(tpf.launch_counts.values()) == 0


@pytest.mark.parametrize("shape", RFFT_SHAPES)
def test_rfft2_matches_jax_and_numpy(shape):
    x, _ = _planes(shape, 5, False)
    got = tfv.rfft2_vpu(torch.from_numpy(x))
    want = _jax_rfft2(shape)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=4e-6 * scale)
    np.testing.assert_allclose(got.numpy(), np.fft.rfftn(x, axes=(-2, -1)), atol=4e-6 * scale)


@pytest.mark.parametrize("shape", [(64, 128), (128, 448)])
def test_irfft2_round_trip(shape):
    x, _ = _planes(shape, 5, False)
    spec = tfv.rfft2_vpu(torch.from_numpy(x))
    back = tfv.irfft2_vpu(spec, shape)
    assert back.dtype == torch.float32 and back.shape == shape
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    # the port's inverse of the JAX forward's spectrum
    from_jax = tfv.irfft2_vpu(torch.from_numpy(_jax_rfft2(shape)), shape)
    np.testing.assert_allclose(from_jax.numpy(), x, atol=1e-5)


def test_irfft2_from_numpy_spectrum_matches_jax():
    shape = (64, 128)
    x, _ = _planes(shape, 6, False)
    spec = np.fft.rfftn(x, axes=(-2, -1)).astype(np.complex64)
    got = tfv.irfft2_vpu(torch.from_numpy(spec), shape).numpy()
    want = np.asarray(jfv.irfft2_vpu(jnp.asarray(spec), shape))
    np.testing.assert_allclose(got, x, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


# radix 4 and 2 both ways and N = 8 (no stage); radices 7, 3 and 5 reach
# the JAX kernel through test_rfft2_matches_jax_and_numpy's shapes
@pytest.mark.parametrize("B,N,inverse", [(16, 64, False), (16, 64, True), (8, 8, False)])
def test_fft_batched_plain_matches_jax(B, N, inverse):
    zr, zi = _planes((B, N), N)
    got = _c(tfv.fft_batched_plain(torch.from_numpy(zr), torch.from_numpy(zi), inverse))
    jr, ji = jfv._fft_batched(jnp.asarray(zr), jnp.asarray(zi), inverse)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=4e-6 * scale)
    exact = (np.fft.ifft if inverse else np.fft.fft)(zr + 1j * zi, axis=-1)
    np.testing.assert_allclose(got, exact, atol=4e-6 * scale)


def test_fft_batched_wrapper_on_cpu_and_its_gate():
    zr, zi = _planes((16, 64), 9)
    tfv.reset_launch_counts()
    got = tfv.fft_batched(torch.from_numpy(zr), torch.from_numpy(zi), False)
    want = tfv.fft_batched_plain(torch.from_numpy(zr), torch.from_numpy(zi), False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tfv.launch_counts["fft_batched"] == 0
    for bad in ((12, 64), (16, 8192), (16, 88)):  # B % 8, N > 4096, 11 does not factor
        with pytest.raises(ValueError):
            tfv.fft_batched(torch.zeros(bad), torch.zeros(bad), False)


@pytest.mark.parametrize("n", [4096, 7168, 11, 1, 512, 448, 960, 3584, 120, 22])
def test_factorize_equal(n):
    assert tfv.factorize(n) == jfv.factorize(n)


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_plan_and_gate_equal(shape):
    assert tfv._plan(shape) == jfv._plan(shape)
    assert tfv.vpu_supported(shape) == jfv.vpu_supported(shape)


@pytest.mark.parametrize("n", [128, 8192, 448])
def test_untangle_table_bit_equal(n):
    got = tfv._untangle_w(n)
    want = jfv._untangle_w(n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), np.asarray(w))


# the Stockham kernel's length classes: every 2^k instance, and mixed
# lengths with radices 7 (448, 3584), 5 and 3 (960, 120), 3^2, 3^5 and 5^3
STOCKHAM_LENGTHS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 448, 960, 3584, 120, 24, 40, 56, 72, 840,
                    1944, 4000]


def _stockham_truth(n, inverse, lines=3):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((lines, n)) + 1j * rng.standard_normal((lines, n))
    tab = np.exp((2j if inverse else -2j) * np.pi * np.arange(n) / n)
    return x, tab, (np.fft.ifft if inverse else np.fft.fft)(x, axis=1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", STOCKHAM_LENGTHS)
def test_stockham_schedule_matches_numpy_fft(n, inverse):
    """The kernel's passes, index maps, table indices and exchange swizzle,
    run in float64 numpy, give the transform."""
    x, tab, want = _stockham_truth(n, inverse)
    got = tfv._simulate(n, x, tab, inverse)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_stockham_schedule_covers_every_admitted_length():
    lengths = [n for n in range(8, tfv._MAX_LEN + 1, 8) if tfv._supported_len(n)]
    assert len(lengths) == 106
    for n in lengths:
        radices = tfv._schedule(n)
        assert np.prod(radices) == n and set(radices) <= {16, 8, 4, 2, 7, 5, 3}
        x, tab, want = _stockham_truth(n, False, lines=1)
        np.testing.assert_allclose(tfv._simulate(n, x, tab, False), want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize(
    "n,want",
    [(4096, (16, 16, 16)), (2048, (16, 16, 8)), (1024, (16, 16, 4)), (512, (16, 16, 2)), (32, (16, 2)),
     (16, (16,)), (8, (8,)), (448, (16, 4, 7)), (960, (16, 4, 5, 3)), (3584, (16, 16, 2, 7)), (120, (8, 5, 3))],
)
def test_stockham_radices(n, want):
    assert tfv._schedule(n) == want


@pytest.mark.parametrize("n", [8, 4096, 448, 960])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_table_bit_equal(n, inverse):
    """Every root and twiddle the kernel reads: e^(sign*2*pi*i*t/n) in
    float64, the quarter turns exact, rounded once to f32, as (re, im)."""
    tab = tfv._table(n, inverse, "cpu")
    w = np.exp((2j if inverse else -2j) * np.pi * np.arange(n) / n)
    quarter = np.arange(n) % (n // 4) == 0
    w[quarter] = np.array([1, -1j, -1, 1j] if not inverse else [1, 1j, -1, -1j])[np.arange(n)[quarter] // (n // 4)]
    assert tab.dtype == torch.float32 and tab.shape == (n, 2)
    assert np.array_equal(tab[:, 0].numpy(), w.real.astype(np.float32))
    assert np.array_equal(tab[:, 1].numpy(), w.imag.astype(np.float32))


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
def test_stockham_exchanges_are_free_of_bank_conflicts(n):
    """In the 2^k instance (16 values a thread, n/16 threads a line) every
    warp's exchange writes, (j div Ns)*Ns*R + (j mod Ns) + r*Ns, and the next
    pass's reads, j + r*n/R', hit 32 distinct banks through the swizzle, which
    is a permutation of the line."""
    radices, threads = tfv._schedule(n), n // 16
    ns = 1
    for r, r_next in zip(radices, radices[1:]):
        assert np.array_equal(np.sort(tfv._swizzle(np.arange(n), ns, r)), np.arange(n))
        for warp in range(threads // 32):
            t = warp * 32 + np.arange(32)
            for b in range(16 // r):
                j = t + b * threads
                for e in range(r):
                    banks = tfv._swizzle((j // ns) * ns * r + j % ns + e * ns, ns, r) % 32
                    assert len(set(banks.tolist())) == 32, (n, ns, r, b, e)
            for b in range(16 // r_next):
                j = t + b * threads
                for e in range(r_next):
                    banks = tfv._swizzle(j + e * (n // r_next), ns, r) % 32
                    assert len(set(banks.tolist())) == 32, (n, ns, r_next, b, e)
        ns *= r
