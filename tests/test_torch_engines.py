"""Port vs JAX: the delta merge engines (shardmerge_tpu_torch/merge/{addition,
taskaddition, linear, ties, breadcrumbs, dare, della, slerp, modelstock}.py
against shardmerge_tpu/merge), through the port's CLI on the host against
the JAX engine run in process, on tiny models from tests/conftest.py.

Tolerances: every written bf16 tensor within one bf16 ulp of JAX's, but
model-stock's within relL2 1e-5 (its Gram product sums in another order);
the DARE/DELLA masks, DELLA's keep probabilities and the TIES/breadcrumbs
thresholds bit for bit. XLA on the CPU contracts multiply-adds into FMAs
and sums in its own order, which moves f32 results by an ulp or so: one
bf16 ulp covers that."""

import asyncio
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.config import MergeConfig as JaxConfig
from shardmerge_tpu.config import MergeModel as JaxModel
from shardmerge_tpu.io.index import OfflineMultiModelIndex as JaxIndex
from shardmerge_tpu.merge import MERGE_METHODS as JAX_METHODS
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.config import MergeConfig, MergeModel
from shardmerge_tpu_torch.io.safetensors_io import load_file
from shardmerge_tpu_torch.merge import MERGE_METHODS, base as tbase
from shardmerge_tpu_torch.merge import breadcrumbs as tcrumbs
from shardmerge_tpu_torch.merge import dare as tdare
from shardmerge_tpu_torch.merge import della as tdella
from shardmerge_tpu_torch.merge import ties as tties
from shardmerge_tpu_torch.ops import prng

from .conftest import TINY_SHARD_MAP, make_tiny_model

# ft1 covers every layer and is the input model; ft2 covers layer 1 on
# and is the output model; ft3 covers layer 0 only
GATES = [
    dict(alpha=0.8, is_input=True),
    dict(alpha=0.5, start_layer=1, is_output=True),
    dict(alpha=0.3, end_layer=0),
]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("engines")
    for name, seed in [("base", 1), ("ft1", 2), ("ft2", 3), ("ft3", 4)]:
        make_tiny_model(root / name, seed=seed)
    return root


def _entries(root, n):
    return [{"model": str(root / f"ft{i + 1}"), "base": str(root / "base"), **GATES[i]} for i in range(n)]


def _read(out_dir):
    tensors = {}
    for shard in sorted(set(TINY_SHARD_MAP.values())):
        tensors.update(load_file(out_dir / shard))
    return tensors


def _run_jax(root, method, options, entries, out):
    index = JaxIndex()
    for p in {root / "base", *(e["model"] for e in entries)}:
        index.add_model(p)
    cfg = JaxConfig(
        finetune_merge=[JaxModel(**e) for e in entries],
        output_base_model=str(root / "base"),
        output_dir=str(out),
        merge_method=method,
        method_options=dict(options),
        cache_dir=str(root / "cache"),
        storage_dir=str(root / "storage"),
    )
    merger = JAX_METHODS[method](config=cfg, index_manager=index, **options)
    asyncio.run(merger.merge())
    return _read(out)


def _config_file(path, root, entries, out, **extra):
    path.write_text(json.dumps({
        "output_base_model": str(root / "base"),
        "finetune_merge": entries,
        "output_dir": str(out),
        **extra,
    }))
    return path


def _run_cli(capsys, *args):
    capsys.readouterr()
    rc = torch_cli(["merge", *map(str, args), "--device", "cpu"])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ulps between two bf16 tensors (+0 and -0 are 0 apart)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


CASES = [
    ("addition", {}, 3),
    ("addition", {"add_base": True}, 2),
    ("task-addition", {}, 3),
    ("linear", {}, 3),
    ("linear", {"normalize": False}, 2),
    ("ties", {}, 3),
    ("ties", {"density": 0.5, "lam": 0.7, "add_base": False}, 3),
    ("breadcrumbs", {}, 3),
    ("breadcrumbs", {"combine": "ties", "beta": 0.3, "gamma": 0.1}, 3),
    ("dare", {}, 3),
    ("dare", {"combine": "ties", "drop_rate": 0.5, "seed": 3}, 3),
    ("della", {}, 3),
    ("della", {"combine": "sum", "density": 0.5, "epsilon": 0.3, "seed": 9}, 3),
    ("slerp", {"t": 0.3}, 2),
    ("slerp", {}, 1),
    ("model-stock", {}, 2),
]


@pytest.mark.parametrize("method,options,n", CASES, ids=lambda v: str(v) if not isinstance(v, dict) else
                         "-".join(f"{k}={x}" for k, x in v.items()) or "defaults")
def test_cli_output_matches_jax(models, tmp_path, capsys, method, options, n):
    """The port's CLI (``--method``) on the gated config against the JAX
    engine: index identical, passthrough tensors bit-equal, every tensor
    within one bf16 ulp (model-stock: relL2 1e-5); the JSON line counts
    the passthroughs (none for the addition engines, which merge the
    input/output layers; one more for model-stock's layer 0, which one
    model covers) and the bytes the writer stored."""
    entries = _entries(models, n)
    theirs = _run_jax(models, method, options, entries, tmp_path / "jax")
    cfg = _config_file(tmp_path / "cfg.json", models, entries, tmp_path / "port", method_options=options)
    rc, out, err = _run_cli(capsys, cfg, "--method", method)
    assert rc == 0, err
    stats = json.loads(out.strip().splitlines()[-1])
    ours = _read(tmp_path / "port")
    index = "model.safetensors.index.json"
    assert json.loads((tmp_path / "port" / index).read_text()) == json.loads((tmp_path / "jax" / index).read_text())
    assert ours.keys() == theirs.keys()
    passthrough = {"model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"}
    expect_pass = {"addition": 0, "task-addition": 0, "model-stock": 3 + 9}.get(method, 3)
    assert stats["tensors_merged"] == len(ours) and stats["tensors_passthrough"] == expect_pass
    assert stats["bytes_written"] == sum(t.nbytes for t in ours.values())
    for name in ours:
        assert ours[name].dtype == torch.bfloat16 == theirs[name].dtype
        if name in passthrough and method not in ("addition", "task-addition"):
            assert torch.equal(ours[name], theirs[name]), name
        elif method == "model-stock":
            a, b = ours[name].double(), theirs[name].double()
            assert float((a - b).norm() / b.norm()) <= 1e-5, name
        else:
            assert int(_ulps(ours[name], theirs[name]).max()) <= 1, name


# --- masks, probabilities and thresholds, bit for bit --------------------------


def _deltas(shape, n, seed=5, ties=True):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n, *shape)) * 1e-2).astype(np.float32)
    if ties:  # repeated magnitudes and exact zeros
        d[:, ..., 1] = -d[:, ..., 0]
        d[:, ..., 2] = 0.0
    return d


@pytest.mark.parametrize("combine_ties", [False, True], ids=["sum", "ties"])
def test_dare_masks_bit_equal(combine_ties):
    """The engine's per-model kept deltas ``where(mask, d / keep, 0)``
    against the JAX engine's recipe (the keys and vmapped Bernoulli draws of
    merge/dare.py, jitted with the same traced arguments), bit for bit; the
    combined result within 1e-6 (sum order)."""
    from shardmerge_tpu.merge import ties as jties

    d = _deltas((24, 16), 3)
    name, seed, keep = "model.layers.0.mlp.gate_proj.weight", 3, 1.0 - 0.6

    @jax.jit
    def jax_kept(deltas, seed, name_crc, keep_prob):
        named = jax.random.fold_in(jax.random.key(seed), name_crc)
        keys = jnp.stack([jax.random.fold_in(named, m) for m in range(deltas.shape[0])])
        masks = jax.vmap(lambda k: jax.random.bernoulli(k, p=keep_prob, shape=deltas.shape[1:]))(keys)
        return masks, jnp.where(masks, deltas / keep_prob, 0.0)

    masks, kept = jax_kept(jnp.asarray(d), jnp.uint32(seed), jnp.uint32(zlib.crc32(name.encode()) & 0x7FFFFFFF),
                           jnp.float32(keep))
    named = tdare.tensor_key(seed, name)
    ours = [tdare.drop_and_rescale_(torch.from_numpy(d[m].copy()), prng.fold_in(named, m), keep) for m in range(3)]
    for m in range(3):
        mask = prng.bernoulli(prng.fold_in(named, m), keep, d.shape[1:]).numpy()
        assert np.array_equal(mask, np.asarray(masks[m]))
        assert np.array_equal(ours[m].numpy().view(np.uint32), np.asarray(kept[m]).view(np.uint32))
    if combine_ties:
        got = tties.elect_disjoint_mean(ours).numpy()
        want = np.asarray(jties.elect_disjoint_mean(kept.reshape(3, -1))).reshape(got.shape)
    else:
        got = tties.sum_in_order(ours).numpy()
        want = np.asarray(jnp.sum(kept, axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(24, 16), (16,), (9, 1), (40, 777)], ids=str)
@pytest.mark.parametrize("density,epsilon", [(0.2, 0.1), (0.5, 0.3), (0.37, 0.13)])
def test_della_probabilities_and_masks_bit_equal(monkeypatch, shape, density, epsilon):
    """DELLA's keep probabilities (ranks with stable ties, then XLA's FMAs),
    masks and kept deltas against the JAX engine's recipe (its keep_probs
    and vmapped Bernoulli draws, jitted with traced density and epsilon),
    bit for bit; the (40, 777) case runs in blocks of 3 rows (prng.CHUNK
    cut to 3 rows' worth), so the row blocks meet the flat counters."""
    from shardmerge_tpu.merge import della as jdella

    d = _deltas(shape, 3, seed=7, ties=shape[-1] > 2)
    flat = d.reshape(3, -1, shape[-1])
    name, seed = "model.layers.1.mlp.up_proj.weight", 9

    @jax.jit
    def jax_kept(flat, seed, name_crc, density, epsilon):
        named = jax.random.fold_in(jax.random.key(seed), name_crc)
        probs = jdella.keep_probs(flat, density, epsilon)
        keys = jnp.stack([jax.random.fold_in(named, m) for m in range(flat.shape[0])])
        masks = jax.vmap(jax.random.bernoulli)(keys, probs)
        return probs, masks, jnp.where(masks, flat / probs, 0.0)

    probs, masks, kept = jax_kept(jnp.asarray(flat), jnp.uint32(seed),
                                  jnp.uint32(zlib.crc32(name.encode()) & 0x7FFFFFFF),
                                  jnp.float32(density), jnp.float32(epsilon))
    if shape == (40, 777):
        monkeypatch.setattr(prng, "CHUNK", 3 * 777 + 5)
    named = tdare.tensor_key(seed, name)
    for m in range(3):
        ours_p = tdella.keep_probs(torch.from_numpy(flat[m]), density, epsilon).numpy()
        assert np.array_equal(ours_p.view(np.uint32), np.asarray(probs[m]).view(np.uint32))
        mask = prng.bernoulli(prng.fold_in(named, m), torch.from_numpy(ours_p), ours_p.shape).numpy()
        assert np.array_equal(mask, np.asarray(masks[m]))
        ours = tdella.sample_(torch.from_numpy(d[m].copy()), prng.fold_in(named, m), density, epsilon)
        assert np.array_equal(ours.numpy().reshape(flat[m].shape).view(np.uint32),
                              np.asarray(kept[m]).view(np.uint32))


@pytest.mark.parametrize("a,b,c", [(3.0, 1 / 3, 0.1), (1e-8, 1e8, -1.0), (0.5, -2.0, 1.0)])
def test_fma_f32_is_the_fused_rounding(a, b, c):
    """fma_f32 against the exactly rounded a * b + c (Python fractions) on
    many f32 operands near the given ones, halfway cases included."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    xs = (np.float32(a) * (1 + rng.standard_normal(2000).astype(np.float32) * np.float32(1e-3))).astype(np.float32)
    b32, c32 = np.float32(b), np.float32(c)
    got = tdella.fma_f32(torch.from_numpy(xs), float(b32), float(c32)).numpy()
    for x, g in zip(xs, got):
        exact = Fraction(float(x)) * Fraction(float(b32)) + Fraction(float(c32))
        lo = np.float32(float(exact))  # a neighbour of the exact value
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.asarray(v).view(np.uint32)) & 1))
        assert g.view(np.uint32) == np.asarray(best).view(np.uint32)


@pytest.mark.parametrize("density", [0.2, 0.5, 1.0])
def test_ties_trim_bit_equal(density):
    """The trimmed deltas (so the exact, tie-inclusive thresholds) equal
    JAX's trim_stack bit for bit, model by model."""
    from shardmerge_tpu.merge import ties as jties

    d = _deltas((24, 16), 3)
    k = tties.keep_count(d[0].size, density)
    assert k == jties.keep_count(d[0].size, density)
    want = np.asarray(jties.trim_stack(jnp.asarray(d.reshape(3, -1)), k))
    for m in range(3):
        got = tties.trim_(torch.from_numpy(d[m].copy()), k).numpy().reshape(-1)
        assert np.array_equal(got.view(np.uint32), want[m].view(np.uint32))


@pytest.mark.parametrize("beta,gamma", [(0.85, 0.01), (0.3, 0.1), (0.0, 0.2), (0.5, 0.0), (0.99, 0.0)])
def test_breadcrumbs_tails_bit_equal(beta, gamma):
    """The banded deltas (exclusive-high, inclusive-low thresholds) equal
    JAX's mask_tails bit for bit, and tail_counts agree, tiny tensors
    included."""
    from shardmerge_tpu.merge import breadcrumbs as jcrumbs

    for n in (1, 2, 5, 384):
        assert tcrumbs.tail_counts(n, beta, gamma) == jcrumbs.tail_counts(n, beta, gamma)
    d = _deltas((24, 16), 3)
    k_low, k_top = tcrumbs.tail_counts(d[0].size, beta, gamma)
    want = np.asarray(jcrumbs.mask_tails(jnp.asarray(d.reshape(3, -1)), k_low, k_top))
    for m in range(3):
        got = tcrumbs.mask_tails_(torch.from_numpy(d[m].copy()), k_low, k_top).numpy().reshape(-1)
        assert np.array_equal(got.view(np.uint32), want[m].view(np.uint32))


def test_elect_disjoint_mean_matches_jax():
    """Sign election with exact cancellations and all-zero entries: the same
    elected entries, values within 1e-6 (sum order)."""
    from shardmerge_tpu.merge import ties as jties

    d = _deltas((24, 16), 4)
    d[1, 3] = -d[0, 3]  # two models cancel on row 3
    d[2:, 3] = 0.0
    got = tties.elect_disjoint_mean([torch.from_numpy(x.copy()) for x in d]).numpy()
    want = np.asarray(jties.elect_disjoint_mean(jnp.asarray(d.reshape(4, -1)))).reshape(got.shape)
    assert np.array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_elect_disjoint_mean_nonfinite_matches_jax():
    """NaN and Inf deltas elect as in JAX: a NaN entry agrees with nothing
    (torch.sign(NaN) is 0, jnp.sign(NaN) NaN), an Inf one with its sign."""
    from shardmerge_tpu.merge import ties as jties

    nan, inf = np.nan, np.inf
    d = np.array([[nan, 1.0, inf, -inf, nan, 0.0],
                  [1.0, 2.0, 1.0, 1.0, inf, -0.0],
                  [0.5, -1.0, -inf, 1.0, 1.0, 0.0]], np.float32)
    got = tties.elect_disjoint_mean([torch.from_numpy(x.copy()) for x in d]).numpy()
    want = np.asarray(jties.elect_disjoint_mean(jnp.asarray(d)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (got, want)


# --- validation, the CLI, resume ---------------------------------------------------


BAD_OPTIONS = [
    ("ties", {"density": 0.0}),
    ("dare", {"drop_rate": 1.0}),
    ("dare", {"combine": "mean"}),
    ("della", {"density": 0.05, "epsilon": 0.2}),
    ("della", {"epsilon": -0.1}),
    ("della", {"combine": "max"}),
    ("breadcrumbs", {"beta": 0.6, "gamma": 0.5}),
    ("breadcrumbs", {"gamma": 1.0}),
    ("slerp", {"t": 1.5}),
]


@pytest.mark.parametrize("method,options", BAD_OPTIONS, ids=lambda v: str(v))
def test_engine_refusals_match_jax(models, tmp_path, capsys, method, options):
    """An engine's refusal of its options: the JAX engine's message, exit 2
    from the CLI, nothing written."""
    entries = _entries(models, 2)
    jcfg = JaxConfig(finetune_merge=[JaxModel(**e) for e in entries], output_base_model=str(models / "base"),
                     output_dir=str(tmp_path / "jax"))
    with pytest.raises(ValueError) as jax_error:
        JAX_METHODS[method](config=jcfg, index_manager=JaxIndex(), **options)
    cfg = _config_file(tmp_path / "cfg.json", models, entries, tmp_path / "port",
                       merge_method=method, method_options=options)
    rc, _, err = _run_cli(capsys, cfg)
    assert rc == 2 and str(jax_error.value) in err
    assert not (tmp_path / "port").exists()


@pytest.mark.parametrize("case", ["unknown-method", "unknown-option", "model-stock-one", "slerp-three"])
def test_cli_config_refusals_match_jax(models, tmp_path, capsys, case):
    """Unknown methods and option keys, model-stock with one finetune and
    slerp with three: the JAX CLI's messages (run_merge), exit 2, nothing
    written."""
    from shardmerge_tpu import cli as jcli
    from shardmerge_tpu.config import ConfigError as JaxConfigError

    method, options, n = {
        "unknown-method": ("nope", {}, 2),
        "unknown-option": ("dare", {"drop_rate": 0.5, "density": 0.2}, 2),
        "model-stock-one": ("model-stock", {}, 1),
        "slerp-three": ("slerp", {}, 3),
    }[case]
    entries = _entries(models, n)
    jcfg = JaxConfig(finetune_merge=[JaxModel(**e) for e in entries], output_base_model=str(models / "base"),
                     output_dir=str(tmp_path / "jax"), merge_method=method, method_options=options,
                     cache_dir=str(tmp_path / "cache"), shard_tensors=False)
    with pytest.raises((JaxConfigError, ValueError)) as jax_error:
        asyncio.run(jcli.run_merge(jcfg, device="cpu"))
    cfg = _config_file(tmp_path / "cfg.json", models, entries, tmp_path / "port", method_options=options)
    rc, _, err = _run_cli(capsys, cfg, "--method", method)
    assert rc == 2 and str(jax_error.value) in err
    assert not (tmp_path / "port").exists() and not (tmp_path / "jax").exists()


def test_every_jax_method_and_option_is_accepted():
    """The port's MERGE_METHODS has the JAX package's names, each engine
    the same OPTIONS."""
    assert MERGE_METHODS.keys() == JAX_METHODS.keys()
    for name, cls in MERGE_METHODS.items():
        assert cls.OPTIONS == JAX_METHODS[name].OPTIONS, name


def test_resume_after_a_cut_gives_the_uncut_bits(models, tmp_path, capsys, monkeypatch):
    """DARE's masks are a pure function of (seed, tensor name, model
    index): a write-through merge cut part way and rerun writes the
    uncut run's bits; a third run merges nothing."""
    entries = _entries(models, 3)
    opts = {"merge_method": "dare", "method_options": {"drop_rate": 0.5, "seed": 4}, "write_through": True}
    uncut = _config_file(tmp_path / "uncut.json", models, entries, tmp_path / "uncut", **opts)
    assert _run_cli(capsys, uncut)[0] == 0
    cut = _config_file(tmp_path / "cut.json", models, entries, tmp_path / "cut", **opts)
    real = tdare.DareMerge._merge_layer

    def failing(self, shard_layer):
        if shard_layer.layer_name == "model.layers.1.mlp.up_proj.weight":
            raise RuntimeError("cut")
        return real(self, shard_layer)

    monkeypatch.setattr(tdare.DareMerge, "_merge_layer", failing)
    with pytest.raises(RuntimeError, match="cut"):
        torch_cli(["merge", str(cut), "--device", "cpu"])
    monkeypatch.setattr(tdare.DareMerge, "_merge_layer", real)
    rc, out, _ = _run_cli(capsys, cut)
    assert rc == 0 and 0 < json.loads(out.strip().splitlines()[-1])["tensors_merged"] < len(TINY_SHARD_MAP)
    want, got = _read(tmp_path / "uncut"), _read(tmp_path / "cut")
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name].view(torch.int16), got[name].view(torch.int16)), name
    rc, out, _ = _run_cli(capsys, cut)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["tensors_merged"] == 0


# --- the read-ahead follows the engine's fetches -------------------------------------


SOURCE_CASES = [
    ("fourier", {}, 3), ("fourier-legacy", {}, 3), ("addition", {}, 3), ("task-addition", {}, 3),
    ("linear", {}, 3), ("ties", {}, 3), ("breadcrumbs", {}, 3), ("dare", {}, 3), ("della", {}, 3),
    ("slerp", {}, 2), ("slerp", {}, 1), ("model-stock", {}, 2),
]


@pytest.mark.parametrize("method,options,n", SOURCE_CASES, ids=lambda v: str(v) if not isinstance(v, dict) else "")
def test_read_ahead_set_equals_the_fetched_set(models, tmp_path, monkeypatch, method, options, n):
    """On the gated config, with ft2's base set to ft3, per layer read
    ahead (every layer but the first): the tensors read ahead for the
    device are exactly those the engine fetches (``_fetch``), and a
    passthrough layer's one page-cache read is the tensor the engine passes
    through. fourier-legacy never reads a model's own base; slerp with two
    finetunes never the output base where both cover the layer."""
    entries = _entries(models, n)
    if n >= 2:
        entries[1]["base"] = str(models / "ft3")
    cfg = MergeConfig(finetune_merge=[MergeModel(**e) for e in entries], output_base_model=str(models / "base"),
                      output_dir=str(tmp_path / "out"), merge_method=method)
    fetched, passed, read_ahead, advised = {}, {}, {}, {}
    real_fetch, real_pass = tbase.MergeTensorsBase._fetch, tbase.MergeTensorsBase._passthrough

    def fetch(self, uri, name):
        fetched.setdefault(name, set()).add(uri)
        return real_fetch(self, uri, name)

    def passthrough(self, shard_layer, which, uri=None):
        passed[shard_layer.layer_name] = uri or self._passthrough_source(which)
        return real_pass(self, shard_layer, which, uri)

    class Pool(tbase.ThreadPoolExecutor):
        """Records the read-aheads the merge thread submits (a read still
        queued when the merge ends is cancelled, so not every one runs)."""

        def submit(self, fn, *args, **kwargs):
            if fn.__name__ == "_read_ahead":
                uri, name, pin = args
                (advised if pin is None else read_ahead).setdefault(name, set()).add(uri)
            return super().submit(fn, *args, **kwargs)

    monkeypatch.setattr(tbase.MergeTensorsBase, "_fetch", fetch)
    monkeypatch.setattr(tbase.MergeTensorsBase, "_passthrough", passthrough)
    monkeypatch.setattr(tbase, "ThreadPoolExecutor", Pool)
    MERGE_METHODS[method](cfg, device="cpu", **options).merge()
    names = set(fetched) | set(passed)
    ahead = set(read_ahead) | set(advised)
    assert len(names) == len(TINY_SHARD_MAP) and len(ahead & names) == len(names) - 1
    for name in ahead & names:
        assert read_ahead.get(name, set()) == fetched.get(name, set()), name
        assert advised.get(name, set()) == ({passed[name]} if name in passed else set()), name
    layer1 = [uris for name, uris in fetched.items() if name.startswith("model.layers.1.")]
    if method in ("addition", "task-addition"):
        assert not passed and not advised
    elif n == 3:  # ft2 covers layer 1 against its own base, ft3
        assert all((str(models / "ft3") in uris) == (method != "fourier-legacy") for uris in layer1)
    if method == "slerp" and n == 2:
        assert all(str(models / "base") not in uris for uris in layer1)
