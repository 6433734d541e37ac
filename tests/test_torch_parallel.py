"""Port vs JAX: the fourier merge across ranks (shardmerge_tpu_torch/parallel/
against shardmerge_tpu/parallel/, after tests/test_parallel.py).

The port's side runs as P gloo processes on localhost (P = 2 and 4, one
launch each): every rank runs every case on its share of inputs made from
seeds with numpy and saves its outputs; the parametrised tests then put the
ranks' blocks together and hold them to the JAX functions on a P-device
sub-mesh of the 8 virtual CPU devices, with the JAX suite's tolerance
(rtol 1e-3, atol 1e-4 max|x|), and the thresholds to the single-device
selects bit for bit.

A pair merge ranks its spectrum by exact order statistics, so an element
that two FFTs (two libraries, pocketfft here and XLA's for JAX, or two
decompositions, fftn and the distributed row/column passes) round to either
side of a threshold changes the mask, and with it every element of the
result by about 1e-3 at these sizes; the tiny exact path's NaN cascade is
FFT-library dependent too (ROADMAP section C). So a sharded pair merge is
held at the suite's tolerance to JAX's sharded merge or to the port's
single-device merge of the same inputs, except where the ranks' cutoff
threshold (each rank records the one its merge takes) is not the
single-device one bit for bit: the distributed FFT moved the order
statistic. Those cases are listed (``MOVED``: 7 of the 10 slerp cases),
and their threshold must stay within 1e-5 relative of the single-device
one. There, and in every case, it is held to JAX's sharded merge at
the repo's pair-merge class (relL2 <= 6e-3, max-abs <= 0.2 rms), its NaN
count and Inf flag JAX's, unless the single-device NaN counts of the two
packages differ (the library-dependent cascade), where they are the port's
single-device ones.

    python -m pytest tests/test_torch_parallel.py -q
"""

from __future__ import annotations

import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

SIZES = (2, 4)
FFT_CASES = [(fn, padded) for fn in ("fft2_rs", "ifft2_cs", "fft2_cs", "ifft2_rs", "rfft2_rs_half", "irfft2_half_rs")
             for padded in (False, True)] + [("half_col_weights", False)]
# (regime, path, padded rows): "exact" the full spectrum with the imaginary
# recursion, "rfft" the half spectrum, "fallback" fast-imag with N % 2P != 0
PAIR_CASES = [("slerp", "exact", False), ("slerp", "exact", True), ("slerp", "rfft", False), ("slerp", "rfft", True),
              ("slerp", "fallback", True), ("arith", "exact", True), ("arith", "rfft", False),
              ("lowratio", "exact", False), ("lowratio", "rfft", True)]
SELECT_CASES = ("nonneg", "nonneg2", "weighted")
STACK_CASES = ("exact", "rfft")
T, TARGET, CULL = 0.6, 2.5, 0.2
# the (P, path, padded rows) slerp cases whose ranks' cutoff threshold is not
# the single-device one bit for bit: the distributed FFT rounds an element
# near the order statistic to its other side (measured: at most 1.9e-6
# relative). Only these are held to the pair-merge class alone; a case that
# moves and is not listed, or moves further than MOVED_REL, fails.
MOVED = {(2, "exact", False), (4, "exact", False), (4, "exact", True), (2, "rfft", False), (4, "rfft", False),
         (2, "rfft", True), (2, "fallback", True)}
MOVED_REL = 1e-5


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _dims(p: int, padded: bool, cols: str = "even", scale: int = 8):
    """(true rows, padded rows, columns): N % 2P == 0 for "even" columns,
    N % P == 0 but N % 2P != 0 for "odd"."""
    m = scale * p - 1 if padded else scale * p
    return m, -(-m // p) * p, (2 * scale * p if cols == "even" else (scale + 1) * p)


def _pad(x: np.ndarray, rows: int) -> np.ndarray:
    return np.concatenate([x, np.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)])


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def fft_input(p: int, fn: str, padded: bool) -> np.ndarray:
    """The whole input of a distributed-FFT case, in its layout's global form
    (RS: rows padded with zeros; CS and the half layout: true rows)."""
    m, mp, n = _dims(p, padded)
    rng = _rng("fft", p, fn, padded)
    if fn in ("fft2_rs", "rfft2_rs_half"):
        return _pad(rng.standard_normal((m, n)).astype(np.float32), mp)
    if fn == "ifft2_cs":
        return _complex(rng, (m, n))
    if fn == "fft2_cs":
        return rng.standard_normal((m, n)).astype(np.float32)
    if fn == "ifft2_rs":
        return _pad(_complex(rng, (m, n)), mp)
    if fn == "irfft2_half_rs":
        return _complex(rng, (m, p * (n // 2 // p + 1)))
    return np.zeros((p,), np.float32)  # half_col_weights: no input


IN_ROWS = {"fft2_rs", "rfft2_rs_half", "ifft2_rs"}  # the rest take column blocks
OUT_ROWS = {"ifft2_cs", "fft2_cs", "irfft2_half_rs", "half_col_weights"}


def pair_inputs(p: int, regime: str, path: str, padded: bool):
    """(a, b padded to the ranks, true rows, scalars) of a pair case: 4-16K
    elements, so that one element across a threshold moves the result
    within the pair-merge class."""
    m, mp, n = _dims(p, padded, "odd" if path == "fallback" else "even", scale=32)
    rng = _rng("pair", p, regime, path, padded)
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = (rng.standard_normal((m, n)) * (0.05 if regime == "lowratio" else 1.0)).astype(np.float32)
    if regime == "arith":
        scalars = (1.3, 0.7)
    else:
        scalars = (float(np.linalg.norm(a)), float(np.linalg.norm(b)), T)
    return _pad(a, mp), _pad(b, mp), m, scalars


def pair_ranks(m: int, n: int):
    from shardmerge_tpu_torch.ops import blend

    numel = m * n
    return blend.cutoff_rank(numel, 0.08), blend.cull_rank(numel, CULL), blend.cull_limit(numel, CULL)


def select_inputs(p: int, kind: str):
    """(x, y or None, k) of a threshold case: non-negative spectra; for
    "weighted" an rfft half spectrum (M, N/2+1) of an N-column tensor."""
    m, _, n = _dims(p, False)
    rng = _rng("select", p, kind)
    cols = n // 2 + 1 if kind == "weighted" else n
    x = np.abs(rng.standard_normal((m, cols))).astype(np.float32)
    y = np.abs(rng.standard_normal((m, cols))).astype(np.float32) if kind != "nonneg" else None
    k = int((2 if y is not None else 1) * m * n * 0.37)
    return x, y, k, n


def half_block(h: np.ndarray, p: int, pos: int) -> np.ndarray:
    """Position ``pos``'s unified half-spectrum block: its body columns and
    the Nyquist column."""
    nb = (h.shape[1] - 1) // p
    return np.concatenate([h[:, pos * nb:(pos + 1) * nb], h[:, -1:]], axis=1)


def stack_inputs(p: int, path: str):
    """(a, b) fused expert stacks of ``p`` or ``2p`` slices; "rfft" ones of
    2^20 elements (the fast-imag size)."""
    shape = (2 * p, 8, 12) if path == "exact" else (p, (1 << 20) // (p * 512), 512)
    rng = _rng("stack", p, path)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


# -- the rank body (run as a script, one process a rank) -------------------------


def _rank_body(out_dir: Path) -> None:
    import torch

    from shardmerge_tpu_torch.config import MergeConfig, MergeModel
    from shardmerge_tpu_torch.merge.base import Placement
    from shardmerge_tpu_torch.merge.fourier import FourierMerge
    from shardmerge_tpu_torch.ops import select
    from shardmerge_tpu_torch.parallel import fft2d
    from shardmerge_tpu_torch.parallel import merge as pmerge
    from shardmerge_tpu_torch.parallel.comm import Comm
    from shardmerge_tpu_torch.parallel.multihost import initialize_distributed, merge_mesh

    assert initialize_distributed(device="cpu")
    comm = Comm("cpu")
    p, pos = comm.size, comm.position
    res = {}

    def rows(x, k=None):
        k = k or x.shape[0] // p
        return torch.from_numpy(np.ascontiguousarray(x[pos * k:(pos + 1) * k]))

    def cols(x):
        k = x.shape[1] // p
        return torch.from_numpy(np.ascontiguousarray(x[:, pos * k:(pos + 1) * k]))

    for fn, padded in FFT_CASES:
        m, mp, n = _dims(p, padded)
        x = fft_input(p, fn, padded)
        local = rows(x) if fn in IN_ROWS else cols(x) if x.ndim == 2 else None
        true_m, pad_m = (m, mp) if padded else (None, None)
        if fn in ("fft2_rs", "rfft2_rs_half", "ifft2_rs"):
            out = getattr(fft2d, fn)(local, comm, true_m=true_m)
        elif fn in ("ifft2_cs", "fft2_cs"):
            out = getattr(fft2d, fn)(local, comm, pad_m=pad_m)
        elif fn == "irfft2_half_rs":
            out = fft2d.irfft2_half_rs(local, comm, n, pad_m=pad_m)
        else:
            out = fft2d.half_col_weights(n, n // 2 // p, comm)
        res[f"fft/{fn}/{padded}"] = out.numpy()

    for regime, path, padded in PAIR_CASES:
        a, b, m, scalars = pair_inputs(p, regime, path, padded)
        kw = dict(fast_imag=path != "exact", true_m=m if padded else None)
        if regime == "arith":
            out = (pmerge.sharded_pair_arith(comm, rows(a), rows(b), *scalars, **kw),)
        elif regime == "lowratio":
            out = pmerge.sharded_pair_lowratio(comm, rows(a), rows(b), *scalars, TARGET, **kw)
        else:
            out = pmerge.sharded_pair_slerp(comm, rows(a), rows(b), *scalars, *pair_ranks(m, a.shape[1]), TARGET,
                                            use_cull=True, **kw)
        key = f"pair/{regime}/{path}/{padded}"
        res[key] = out[0].numpy()
        if len(out) == 3:
            res[key + "/flags"] = np.asarray([int(out[1]), int(out[2])])
        if regime == "slerp":
            true_m = kw["true_m"]
            fft = fft2d.rfft2_rs_half if path == "rfft" else fft2d.fft2_rs
            v0 = fft(rows(a) / torch.tensor(scalars[0]), comm, true_m)
            v1 = fft(rows(b) / torch.tensor(scalars[1]), comm, true_m)
            weights = fft2d.half_col_weights(a.shape[1], v0.shape[1] - 1, comm) if path == "rfft" else None
            res[key + "/cutoff"] = _cutoff(path, v0, v1, pair_ranks(m, a.shape[1]), comm, weights).reshape(1).numpy()

    for kind in SELECT_CASES:
        x, y, k, n = select_inputs(p, kind)
        if kind == "weighted":
            nb = n // 2 // p
            thr = select.kth_smallest_weighted(
                torch.from_numpy(half_block(x, p, pos)), k, fft2d.half_col_weights(n, nb, comm),
                y=torch.from_numpy(half_block(y, p, pos)), group=comm)
        elif kind == "nonneg2":
            thr = select.kth_smallest_nonneg2(rows(x), rows(y), k, group=comm)
        else:
            thr = select.kth_smallest_nonneg(rows(x), k, group=comm)
        res[f"select/{kind}"] = thr.reshape(1).numpy()

    engine = FourierMerge(MergeConfig(finetune_merge=[MergeModel(model="m", base="b")], output_base_model="b",
                                      output_dir=str(out_dir / "unused")),
                          device="cpu", comm=comm)
    for path in STACK_CASES:
        a, b = stack_inputs(p, path)
        e = a.shape[0] // p
        placement = Placement(comm, "lead", a.shape)
        job = ("slerp", "a", "b", "ab", (float(np.linalg.norm(a)), float(np.linalg.norm(b)), T))
        merged, (nan, inf) = engine.merge_pair(job, rows(a, e), rows(b, e), TARGET, CULL, placement)
        res[f"stack/{path}"] = merged.numpy()
        res[f"stack/{path}/flags"] = np.asarray([int(nan), int(inf)])

    # hosts interleaved a, b, a, b: merge_mesh puts each host's ranks together
    mesh = merge_mesh("cpu", host="ab"[comm.rank % 2])
    res["mesh/order"] = np.asarray(mesh.order)
    res["mesh/position"] = np.asarray([mesh.position])
    a, b, m, scalars = pair_inputs(p, "arith", "rfft", False)
    k = a.shape[0] // p
    res["mesh/arith"] = pmerge.sharded_pair_arith(
        mesh, torch.from_numpy(a[mesh.position * k:(mesh.position + 1) * k]),
        torch.from_numpy(b[mesh.position * k:(mesh.position + 1) * k]), *scalars).numpy()
    np.savez(out_dir / f"rank{comm.rank}.npz", **res)


# -- the tests ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Per P: each rank's saved outputs (one launch of P processes)."""
    from .torch_ranks import launch

    out = {}
    for p in SIZES:
        d = tmp_path_factory.mktemp(f"ranks{p}")
        results = launch([str(Path(__file__).resolve()), str(d)], p, d / "logs")
        for rank, (rc, _, err) in enumerate(results):
            assert rc == 0, f"P={p} rank {rank} exited {rc}:\n{err[-3000:]}"
        out[p] = [dict(np.load(d / f"rank{r}.npz")) for r in range(p)]
    return out


def _mesh(p):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:p]), ("x",))


def _put(mesh, x, spec):
    import jax
    import jax.numpy as jnp

    return jax.device_put(jnp.asarray(x), jax.NamedSharding(mesh, spec))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def _within(got, want) -> bool:
    return bool(np.allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max()))


def _hold(got, flags, jax_sharded, port_single, jax_single, moved=False):
    """Hold a sharded pair merge (its merged rows and [nan count, Inf flag]
    or None) as the module docstring says; ``moved``: the ranks' cutoff
    threshold is not the single-device one. Each reference is (merged,
    flags or None)."""
    if port_single[1] != jax_single[1]:  # the library-dependent NaN cascade
        assert flags == port_single[1]
        _close(got, port_single[0])
        return
    assert flags == jax_sharded[1]
    if not moved:
        assert _within(got, jax_sharded[0]) or _within(got, port_single[0]), \
            "the sharded merge leaves both references with the single-device threshold"
    want = jax_sharded[0].astype(np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 6e-3
    assert np.abs(got - want).max() <= 0.2 * rms


def _cutoff(path, v0, v1, ranks, group=None, weights=None):
    """The slerp's cutoff threshold on the spectra of v0 / |v0|, v1 / |v1|
    as the pair merge takes it (half or full spectrum)."""
    from shardmerge_tpu_torch.ops import select

    if path == "rfft":
        return select.kth_smallest_weighted(v0.real.abs(), ranks[0], weights, y=v1.real.abs(), group=group)
    return select.kth_smallest_nonneg2(v0.real.abs(), v1.real.abs(), ranks[0], group=group)


def _flags(out):
    return None if len(out) == 1 else [int(out[1]), int(bool(out[2]))]


def _port_single(regime, path, a, b, scalars, ranks):
    """The port's single-device pair merge of a case's true rows (the
    sharded path's counterpart: full spectrum, half spectrum, or full with
    the imaginary part passed through)."""
    import torch

    from shardmerge_tpu_torch.merge import fourier as tfourier
    from shardmerge_tpu_torch.ops import blend as tblend

    a, b = torch.from_numpy(a), torch.from_numpy(b)
    s = [torch.tensor(v, dtype=torch.float32) for v in scalars]
    target = torch.tensor(TARGET)
    if path == "fallback":
        f0, f1 = tblend.fft2(a / s[0]), tblend.fft2(b / s[1])
        res = tblend.interpolate_fft_components(f0, f1, s[2], 1.0, *ranks, use_cutoff=True, use_cull=True,
                                                interp_imag=False)
        out = tfourier._scrub(tblend.ifft2_real(res), target)
    else:
        out = tfourier._pair(regime, a, b, s, ranks, target, path == "rfft", use_cull=True)
        out = out[:1] if out[1] is None else out
    return out[0].numpy(), _flags(out)


def _jax_single(regime, path, a, b, scalars, ranks):
    import jax.numpy as jnp

    from shardmerge_tpu.merge import fourier as jfourier

    a, b = jnp.asarray(a), jnp.asarray(b)
    s = [jnp.float32(v) for v in scalars]
    if regime == "arith":
        out = (jfourier._pair_arith_rfft(a, b, *s) if path == "rfft"
               else jfourier._pair_arith(a, b, *s, fast_imag=False),)
    elif regime == "lowratio":
        fn = jfourier._pair_lowratio_rfft if path == "rfft" else jfourier._pair_lowratio
        out = fn(a, b, *s, jnp.float32(TARGET))
    else:
        args = (a, b, *s, *[jnp.int32(r) for r in ranks], jnp.float32(TARGET))
        out = (jfourier._pair_slerp_rfft(*args, use_cutoff=True, use_cull=True) if path == "rfft"
               else jfourier._pair_slerp(*args, use_cutoff=True, use_cull=True, fast_imag=path == "fallback"))
    return np.asarray(out[0]), _flags(out)


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("fn,padded", FFT_CASES, ids=[f"{f}-{'pad' if d else 'even'}" for f, d in FFT_CASES])
def test_fft2d_matches_jax(ranks, p, fn, padded):
    import jax
    from jax.sharding import PartitionSpec as P

    from shardmerge_tpu.parallel import fft2d as jfft

    m, mp, n = _dims(p, padded)
    true_m, pad_m = (m, mp) if padded else (None, None)
    mesh = _mesh(p)
    rs, cs = P("x", None), P(None, "x")
    body = {
        "fft2_rs": lambda x: jfft.fft2_rs(x, "x", true_m=true_m),
        "rfft2_rs_half": lambda x: jfft.rfft2_rs_half(x, "x", true_m=true_m),
        "ifft2_rs": lambda x: jfft.ifft2_rs(x, "x", true_m=true_m),
        "ifft2_cs": lambda x: jfft.ifft2_cs(x, "x", pad_m=pad_m),
        "fft2_cs": lambda x: jfft.fft2_cs(x, "x", pad_m=pad_m),
        "irfft2_half_rs": lambda x: jfft.irfft2_half_rs(x, "x", n, pad_m=pad_m),
        "half_col_weights": lambda x: jfft.half_col_weights(n, n // 2 // p, "x"),
    }[fn]
    in_spec = P("x") if fn == "half_col_weights" else (rs if fn in IN_ROWS else cs)
    out_spec = P("x") if fn == "half_col_weights" else (rs if fn in OUT_ROWS else cs)
    want = np.asarray(jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_spec, out_specs=out_spec))(
        _put(mesh, fft_input(p, fn, padded), in_spec)))
    got = np.concatenate([r[f"fft/{fn}/{padded}"] for r in ranks[p]], axis=0 if fn in OUT_ROWS else 1)
    assert got.shape == want.shape
    if fn == "half_col_weights":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("regime,path,padded", PAIR_CASES, ids=[f"{r}-{a}-{'pad' if d else 'even'}"
                                                                 for r, a, d in PAIR_CASES])
def test_sharded_pair_merge_matches_jax(ranks, p, regime, path, padded):
    from jax.sharding import PartitionSpec as P

    from shardmerge_tpu.parallel import merge as jmerge

    a, b, m, scalars = pair_inputs(p, regime, path, padded)
    mesh = _mesh(p)
    ja, jb = _put(mesh, a, P("x", None)), _put(mesh, b, P("x", None))
    kw = dict(fast_imag=path != "exact", true_m=m if padded else None)
    if regime == "arith":
        want = (jmerge.sharded_pair_arith(mesh, ja, jb, *scalars, **kw),)
    elif regime == "lowratio":
        want = jmerge.sharded_pair_lowratio(mesh, ja, jb, *scalars, TARGET, **kw)
    else:
        want = jmerge.sharded_pair_slerp(mesh, ja, jb, *scalars, *pair_ranks(m, a.shape[1]), TARGET,
                                         use_cull=True, **kw)
    key = f"pair/{regime}/{path}/{padded}"
    got = np.concatenate([r[key] for r in ranks[p]])
    want_rows = np.asarray(want[0])
    assert got.shape == want_rows.shape == a.shape
    np.testing.assert_array_equal(got[m:], 0.0)  # padded rows come back zero
    flags = [r[key + "/flags"].tolist() for r in ranks[p]] if len(want) == 3 else [None]
    assert all(f == flags[0] for f in flags)  # the count and the flag are global on every rank
    ranks_ = pair_ranks(m, a.shape[1]) if regime == "slerp" else ()
    moved = False
    if regime == "slerp":
        import torch

        from shardmerge_tpu_torch.ops import blend as tblend

        cut = [r[key + "/cutoff"].view(np.uint32).tolist() for r in ranks[p]]
        assert all(c == cut[0] for c in cut)
        v0, v1 = (torch.from_numpy(x[:m]) / torch.tensor(s) for x, s in ((a, scalars[0]), (b, scalars[1])))
        fft = (lambda x: torch.fft.rfftn(x, dim=(-2, -1))) if path == "rfft" else tblend.fft2
        single = _cutoff(path, fft(v0), fft(v1), ranks_, weights=tblend.hermitian_col_weights(a.shape[1]))
        moved = cut[0] != single.reshape(1).numpy().view(np.uint32).tolist()
        assert moved == ((p, path, padded) in MOVED), "the set of moved thresholds changed"
        ours = float(ranks[p][0][key + "/cutoff"].reshape(-1)[0])
        assert abs(ours / float(single.reshape(1)[0]) - 1) <= MOVED_REL
    _hold(got[:m], flags[0], (want_rows[:m], _flags(want)),
          _port_single(regime, path, a[:m], b[:m], scalars, ranks_),
          _jax_single(regime, path, a[:m], b[:m], scalars, ranks_), moved)


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("kind", SELECT_CASES)
def test_distributed_thresholds_bit_equal_single_device(ranks, p, kind):
    """Every rank's threshold is the single-device one (port and JAX) on the
    same elements, bit for bit."""
    import jax.numpy as jnp
    import torch

    from shardmerge_tpu.ops import blend as jblend
    from shardmerge_tpu.ops import select as jselect
    from shardmerge_tpu_torch.ops import blend as tblend
    from shardmerge_tpu_torch.ops import select as tselect

    x, y, k, n = select_inputs(p, kind)
    if kind == "weighted":
        theirs = jselect.kth_smallest_weighted(jnp.asarray(x), k, jnp.asarray(jblend.hermitian_col_weights(n)),
                                               y=jnp.asarray(y))
        ours = tselect.kth_smallest_weighted(torch.from_numpy(x), k, tblend.hermitian_col_weights(n),
                                             y=torch.from_numpy(y))
    elif kind == "nonneg2":
        theirs = jselect.kth_smallest_nonneg2(jnp.asarray(x), jnp.asarray(y), k)
        ours = tselect.kth_smallest_nonneg2(torch.from_numpy(x), torch.from_numpy(y), k)
    else:
        theirs = jselect.kth_smallest_nonneg(jnp.asarray(x), k)
        ours = tselect.kth_smallest_nonneg(torch.from_numpy(x), k)
    want = np.asarray(theirs).reshape(1).view(np.uint32)
    assert ours.reshape(1).numpy().view(np.uint32) == want
    for r in ranks[p]:
        assert r[f"select/{kind}"].view(np.uint32) == want


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("path", STACK_CASES)
def test_leading_dim_sharded_stack_matches_jax(ranks, p, path):
    """A fused expert stack split over the ranks by its leading dim (every
    FFT rank-local, the reductions all-reduced) gives the JAX single-device
    pair merge, as the JAX engine's leading-dim sharding does."""
    a, b = stack_inputs(p, path)
    scalars = (float(np.linalg.norm(a)), float(np.linalg.norm(b)), T)
    ranks_ = pair_ranks(a.size, 1)
    jax_single = _jax_single("slerp", path, a, b, scalars, ranks_)
    got = np.concatenate([r[f"stack/{path}"] for r in ranks[p]])
    flags = [r[f"stack/{path}/flags"].tolist() for r in ranks[p]]
    assert all(f == flags[0] for f in flags)
    # the JAX engine's leading-dim shards run its single-device kernels
    _hold(got, flags[0], jax_single, _port_single("slerp", path, a, b, scalars, ranks_), jax_single)


@pytest.mark.parametrize("p", SIZES)
def test_merge_mesh_orders_ranks_host_by_host(ranks, p):
    """Hosts a, b, a, b: merge_mesh gives each host consecutive positions,
    rank 0 first, and a pair merge over that order still gives the JAX
    result (blocks taken by position)."""
    from jax.sharding import PartitionSpec as P

    from shardmerge_tpu.parallel import merge as jmerge

    order = [r for r in range(p) if r % 2 == 0] + [r for r in range(p) if r % 2 == 1]
    for rank, r in enumerate(ranks[p]):
        assert r["mesh/order"].tolist() == order
        assert r["mesh/position"].tolist() == [order.index(rank)]
    a, b, _, scalars = pair_inputs(p, "arith", "rfft", False)
    mesh = _mesh(p)
    want = jmerge.sharded_pair_arith(mesh, _put(mesh, a, P("x", None)), _put(mesh, b, P("x", None)), *scalars)
    got = np.concatenate([ranks[p][rank]["mesh/arith"] for rank in order])
    _close(got, np.asarray(want))


def test_sharding_policy():
    """2-D tensors of shard_min_bytes or more (or of the huge element bound)
    split by rows when the columns divide the ranks; ndim >= 3 by the
    leading dim only when it divides them; 1-D never (JAX's
    ``_sharding_for``)."""
    import torch

    from shardmerge_tpu_torch.config import MergeConfig, MergeModel
    from shardmerge_tpu_torch.merge.fourier import FourierMerge

    class Ranks:
        size, position = 4, 1

    config = MergeConfig(finetune_merge=[MergeModel(model="m", base="b")], output_base_model="b",
                         output_dir="unused")
    policy = FourierMerge(config, device="cpu", comm=Ranks(), shard_min_bytes=1024)._sharding_for
    assert policy(torch.zeros(8, 16)) is None  # 512 bytes: below the trigger
    rows = policy(torch.zeros(18, 16))  # 1152 bytes
    assert (rows.kind, rows.shape, rows.pad, rows.true_m) == ("rows", (18, 16), 2, 18)
    huge = FourierMerge(config, device="cpu", comm=Ranks(), shard_min_bytes=1 << 30)
    huge.huge_tensor_numel = 1 << 12
    assert huge._sharding_for(torch.zeros(64, 64, dtype=torch.bfloat16)).kind == "rows"  # the huge bound
    assert huge._sharding_for(torch.zeros(32, 64)) is None
    assert policy(torch.zeros(18, 18)) is None  # columns do not divide the ranks
    assert policy(torch.zeros(8, 4, 16)).kind == "lead"
    assert policy(torch.zeros(7, 4, 16)) is None  # no zero slices in the global ranks
    assert policy(torch.zeros(16, 2, 4, 8)).kind == "lead"
    assert policy(torch.zeros(4096)) is None
    local = rows.local(torch.arange(18 * 16, dtype=torch.float32).reshape(18, 16))
    assert local.shape == (5, 16) and local[0, 0] == 5 * 16  # position 1: rows 5-9
    last = type("Last", (), {"size": 4, "position": 3})()
    tail = type(rows)(last, "rows", (18, 16)).local(torch.ones(18, 16))
    assert tail.shape == (5, 16) and tail[:3].eq(1).all() and tail[3:].eq(0).all()
    assert FourierMerge(config, device="cpu")._sharding_for(torch.zeros(1 << 12, 1 << 10)) is None


def test_initialize_distributed_env_detection(monkeypatch):
    """The launcher's env:// variables start a join attempt (here failing
    cleanly: single process); a bare environment never probes; ``force``
    probes; a malformed WORLD_SIZE degrades like a failed probe."""
    import torch.distributed as dist

    from shardmerge_tpu_torch.parallel import multihost

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    called = []

    def fake_init(backend, **kw):
        called.append((backend, kw))
        raise RuntimeError("no rendezvous")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    assert multihost.initialize_distributed(device="cpu") is False
    assert called == []  # bare env: never probed

    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(var, value)
    assert multihost.initialize_distributed(device="cpu") is False  # probe failed cleanly
    assert called[-1] == ("gloo", {"init_method": "env://"})
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var)
    assert multihost.initialize_distributed(force=True, device="cpu") is False
    assert len(called) == 2
    monkeypatch.setenv("WORLD_SIZE", "two")
    assert multihost.initialize_distributed(force=True, device="cpu") is False
    assert len(called) == 3


def test_ranks_on_a_card_need_the_launchers_local_variables(monkeypatch):
    """A single rank is local rank 0 of 1; several ranks take their GPU and
    transport from LOCAL_RANK and LOCAL_WORLD_SIZE, and refuse to guess them
    from WORLD_SIZE (which would take every host for one)."""
    from shardmerge_tpu_torch.backend import BackendError
    from shardmerge_tpu_torch.parallel import comm

    for var in ("WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert (comm.local_rank(), comm.local_world_size()) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "8")
    for var, fn in (("LOCAL_RANK", comm.local_rank), ("LOCAL_WORLD_SIZE", lambda: comm.transport_for("cuda"))):
        with pytest.raises(BackendError, match=var):
            fn()
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert (comm.local_rank(), comm.local_world_size()) == (3, 4)
    assert comm.transport_for("cuda", local_ranks=4)[0] in ("gloo", "nccl")
    assert comm.transport_for("cpu") == ("gloo", False)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _rank_body(Path(sys.argv[1]))
