"""Port vs JAX: the legacy Fourier merge engine
(shardmerge_tpu_torch/merge/fourier_legacy.py against
shardmerge_tpu/merge/fourier_legacy.py) on the host.

Both run the exact complex-FFT pair merge, on different FFT libraries. With
2 finetunes the output is held to the engines' class (>97% of elements
within 2e-2, docs/NUMERICS.md §4) and the plan (pairs, order, regimes) to
JAX's. With 3, a later round slerps a merged entry whose spectrum carries
round 1's culled zeros: FFT rounding then decides sign agreement, so the
plan is held to JAX's, the arguments of every pair merge to JAX's and to
the reference's recipe, each traced pair merge's blend to JAX's on
identical spectra, round 1's pair merges to JAX's on the same inputs, and
each later pair merge to JAX's own spread: JAX's pair merge against itself
on the transposed operands (the same transform, other roundings)."""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.config import MergeConfig as JaxConfig
from shardmerge_tpu.config import MergeModel as JaxModel
from shardmerge_tpu.io.index import OfflineMultiModelIndex as JaxIndex
from shardmerge_tpu.merge import fourier as jfourier
from shardmerge_tpu.merge import fourier_legacy as jlegacy
from shardmerge_tpu.ops import blend as jblend
from shardmerge_tpu.ops import select as jselect
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.cli import run_merge
from shardmerge_tpu_torch.config import MergeConfig, MergeModel
from shardmerge_tpu_torch.merge import fourier_legacy as tlegacy
from shardmerge_tpu_torch.ops import blend as tblend
from shardmerge_tpu_torch.ops import select as tselect

from . import oracle_torch as oracle
from .conftest import TINY_SHARD_MAP, make_tiny_model
from .test_torch_engines import _ulps
from .test_torch_stack import _Plan, _models, _read

WIDE = {"model.layers.0.mlp.up_proj.weight": (256, 256), "model.layers.0.self_attn.q_proj.weight": (16, 16)}
WIDE_MAP = {name: "model.safetensors" for name in WIDE}


def _scalar(v):
    """A pair merge's scalar argument as the host sees it: Python ints and
    flags as they are, device scalars (JAX or torch) as int or np.float32."""
    if isinstance(v, (bool, int)):
        return v
    a = np.asarray(v)
    return a.item() if a.dtype.kind in "iu" else np.float32(a)


class _Regimes:
    """Records each module's pairings (``correlated_pairs``, with the size
    of the matrix it was given), pair-merge regimes and the arguments of
    each slerp pair merge (numel, then every scalar), by wrapping the names
    the engine calls."""

    def __init__(self, monkeypatch, module, blend_module):
        self.pairs, self.sizes, self.regimes, self.slerps = [], [], [], []
        real_pairs = module.correlated_pairs

        def pairs(*args, **kwargs):
            out = list(real_pairs(*args, **kwargs))
            self.pairs.append([(x, y) for x, y, _ in out])
            self.sizes.append(len(args[0]))
            return out

        monkeypatch.setattr(module, "correlated_pairs", pairs)
        for name, regime in (("_pair_add", "add"), ("_pair_lowratio", "lowratio"), ("_pair_slerp", "slerp")):
            monkeypatch.setattr(module, name, self._wrap(getattr(module, name), regime))
        real_arith = blend_module.task_arithmetic_fft2

        def arith(v0, v1, t, *, agreement=True):
            self.regimes.append("arith" if agreement else "task-add")
            return real_arith(v0, v1, t, agreement=agreement)

        monkeypatch.setattr(blend_module, "task_arithmetic_fft2", arith)

    def _wrap(self, fn, regime):
        def wrapped(*args, **kwargs):
            self.regimes.append(regime)
            if regime == "slerp":
                self.slerps.append((int(np.prod(args[0].shape)), *map(_scalar, args[2:]),
                                    kwargs["use_cutoff"], kwargs["use_cull"]))
            return fn(*args, **kwargs)

        return wrapped


def _run_jax(root, entries, base, out, shard_map, **kw):
    index = JaxIndex()
    for p in {base, *(e["model"] for e in entries)}:
        index.add_model(p)
    cfg = JaxConfig(finetune_merge=[JaxModel(**e) for e in entries], output_base_model=str(base),
                    output_dir=str(root / out), merge_method="fourier-legacy",
                    cache_dir=str(root / "cache"), storage_dir=str(root / "storage"))
    with _Plan("shardmerge_tpu.merge.fourier_legacy") as plan:
        asyncio.run(jlegacy.LegacyFourierMerge(cfg, index_manager=index, **kw).merge())
    return _read(root / out, shard_map), plan.lines


def _run_port(root, entries, base, out, shard_map, **kw):
    cfg = MergeConfig(finetune_merge=[MergeModel(**e) for e in entries], output_base_model=str(base),
                      output_dir=str(root / out), merge_method="fourier-legacy")
    engine = tlegacy.LegacyFourierMerge(cfg, device="cpu", **kw)
    with _Plan("shardmerge_tpu_torch.merge.fourier_legacy") as plan:
        engine.merge()
    return _read(root / out, shard_map), plan.lines, engine


def _close(a, b):
    return np.isclose(a, b, rtol=2e-2, atol=1e-6)


def _oracle_legacy(base, layer, add, alphas, cull=0.20):
    """Torch oracle (tests/oracle_torch.py) of the reference's legacy layer
    merge for at most two layer-stack finetunes (one round) and a task-add
    side stack: deltas against the output base, target_norm the lower
    median (+1e-10), unscaled b in the arithmetic regime, alphas by stack
    position."""
    base = torch.from_numpy(base).float()
    deltas = [torch.from_numpy(x).float() - base for x in layer]
    merged = deltas[0]
    if len(deltas) == 2:
        a, b = deltas
        na, nb = a.norm().item(), b.norm().item()
        target = torch.tensor([na, nb]).median().item() + 1e-10
        if abs(na) < abs(nb):
            a, b, na, nb = b, a, nb, na
        cna, cnb = abs(na / target), abs(nb / target)
        if cna < 1e-6:
            merged = a + b
        elif cnb < 1e-6 or cnb / (cna + 1e-10) < 0.1:
            merged = oracle.task_arithmetic_fft2(a * (target / na), b, 1.0)
        else:
            t = alphas[0] / (alphas[0] + alphas[1])
            merged = oracle.merge_tensors_fft2_slerp(a, b, t=t, cutoff_pct=0.08, cull_pct=cull)[0] * target
    for x in add:
        merged = oracle.task_arithmetic_fft2(merged, torch.from_numpy(x).float() - base, 1.0, agreement=False)
    out = base + merged
    return torch.where(torch.isnan(out), torch.zeros_like(out), out).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    src = {name: make_tiny_model(root / name, seed=seed) for name, seed in [("base", 1), ("ft1", 2), ("ft2", 3),
                                                                             ("ft3", 4)]}
    return root, src


@pytest.mark.parametrize("variant", ["cli", "task-add"])
def test_two_finetunes_match_jax_and_the_oracle(tiny, tmp_path, capsys, monkeypatch, record_property, variant):
    """The CLI (ft1 is_input, ft2 is_output) and, in process, a gated run
    with ``task_add_models=[ft2]``: at layer 0 ft1 and ft3 pair and ft2
    joins the task-add stack; ft1 covers layer 0 only, so at layer 1 ft2
    and ft3 take ft1's and ft2's identities by gated position (REF-QUIRK)
    and ft3 joins the task-add stack. The plan equals JAX's
    (``Processing`` lines, pairings, regimes); every merged tensor is
    within one bf16 ulp of the torch oracle of the reference (whose norms
    sum in another order); and a tensor agrees
    with JAX's (>97% within 2e-2) exactly when the oracle does: the rest
    are tiny tensors whose exact-path imaginary recursion divides 0/0 in
    one FFT library and not the other (docs/NUMERICS.md §3-4; the fourier
    engine's CLI test holds the same way). Passthrough tensors bit-equal;
    the whole output's agreement goes to the JUnit report's properties."""
    root, src = tiny
    base = root / "base"
    names = ["ft1", "ft2", "ft3"]
    if variant == "cli":
        entries = [{"model": str(root / "ft1"), "base": str(base), "alpha": 0.8, "is_input": True},
                   {"model": str(root / "ft2"), "base": str(base), "alpha": 0.4, "is_output": True}]
        kw, layers = {}, {0: (["ft1", "ft2"], []), 1: (["ft1", "ft2"], [])}
    else:
        entries = [{"model": str(root / "ft1"), "base": str(base), "alpha": 0.8, "is_input": True, "end_layer": 0},
                   {"model": str(root / "ft2"), "base": str(base), "alpha": 0.4, "is_output": True},
                   {"model": str(root / "ft3"), "base": str(base), "alpha": 0.6}]
        kw, layers = {"task_add_models": [str(root / "ft2")]}, {0: (["ft1", "ft3"], ["ft2"]), 1: (["ft2"], ["ft3"])}
    jrec = _Regimes(monkeypatch, jlegacy, jlegacy.blend)
    theirs, jplan = _run_jax(tmp_path, entries, base, "jax", TINY_SHARD_MAP, **kw)
    trec = _Regimes(monkeypatch, tlegacy, tlegacy.blend)
    if variant == "cli":
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"output_base_model": str(base), "finetune_merge": entries,
                                   "output_dir": str(tmp_path / "port")}))
        with _Plan("shardmerge_tpu_torch.merge.fourier_legacy") as plan:
            assert torch_cli(["merge", str(cfg), "--method", "fourier-legacy", "--device", "cpu"]) == 0
        ours, plan = _read(tmp_path / "port", TINY_SHARD_MAP), plan.lines
    else:
        ours, plan, _ = _run_port(tmp_path, entries, base, "port", TINY_SHARD_MAP, **kw)
    assert plan == jplan and trec.pairs == jrec.pairs and trec.regimes == jrec.regimes
    assert ("task-add" in trec.regimes) == (variant == "task-add")
    alphas = [e["alpha"] for e in entries]
    agree = total = 0
    for name in ours:
        got, want = ours[name].float().numpy(), theirs[name].float().numpy()
        if not name.startswith("model.layers."):
            assert torch.equal(ours[name], theirs[name]), name
            continue
        layer, add = layers[int(name.split(".")[2])]
        ref = _oracle_legacy(src["base"][name], [src[m][name] for m in layer], [src[m][name] for m in add], alphas)
        assert int(_ulps(ours[name], torch.from_numpy(ref).to(torch.bfloat16)).max()) <= 1, name
        port_vs_jax = _close(got, want)
        assert (port_vs_jax.mean() > 0.97) == (_close(ref, want).mean() > 0.97), name
        agree, total = agree + port_vs_jax.sum(), total + port_vs_jax.size
    record_property("merged_elements_port_vs_jax", float(agree / total))


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b.astype(np.float64)))


def _recipe(rec, n_models, alphas):
    """The reference's (x, y, round) of each slerp pair merge, from the
    pairings a run recorded: a tensor's reduction starts where the matrix
    has one row a model."""
    out = []
    for pairs, size in zip(rec.pairs, rec.sizes):
        r = 0 if size == n_models else r + 1
        out += [(x, y, r) for x, y in pairs if y >= 0]
    return out


def test_three_finetunes_hold_to_jax_per_pair(tmp_path, monkeypatch, record_property):
    """3 finetunes (delta scales 0.01, 0.03, 0.08) on a (256, 256) and a
    (16, 16) tensor: the plan equals JAX's. Every slerp pair merge of both
    engines gets the reference's arguments: the weight
    alpha[x] / (alpha[x] + alpha[y]) by stack position (REF-QUIRK) and the
    ranks at cull 0.2 / 2^round, exactly; norms and target within 1e-5 of
    JAX's. On the port's own pair inputs (its trace), each operand is an
    input delta or an earlier traced result, each traced result is the
    engine's own pair merge bit for bit, and the written tensor is the base
    plus the last traced result; each pair's blend on identical spectra
    with the traced weight gives JAX's cutoff threshold bit for bit and its
    real plane within relL2 1e-5; each pair merge sits within twice JAX's
    own spread in relL2 (JAX's pair merge against itself on the transposed
    operands), within 0.1 of it in the share of elements within 2e-2, and
    round 1's >97% within 2e-2 where JAX's own are. The readings go to the
    JUnit report's properties."""
    base, paths, _, _ = _models(tmp_path, [1e-2, 3e-2, 8e-2], WIDE, WIDE_MAP)
    alphas = [1.0, 0.6, 0.3]
    entries = [{"model": str(p), "base": str(base), "alpha": a} for p, a in zip(paths, alphas)]
    jrec = _Regimes(monkeypatch, jlegacy, jlegacy.blend)
    theirs, jplan = _run_jax(tmp_path, entries, base, "jax", WIDE_MAP)
    trec = _Regimes(monkeypatch, tlegacy, tlegacy.blend)
    ours, plan, engine = _run_port(tmp_path, entries, base, "port", WIDE_MAP)
    assert plan == jplan and trec.pairs == jrec.pairs and trec.regimes == jrec.regimes
    assert trec.regimes == ["slerp"] * 4

    recipe = _recipe(jrec, len(entries), alphas)
    assert [r for _, _, r in recipe] == [0, 1, 0, 1]
    for port, jax_args, (x, y, r) in zip(trec.slerps, jrec.slerps, recipe, strict=True):
        n, cull = port[0], engine.cull_start_pct / 2**r
        want = (n, np.float32(alphas[x] / (alphas[x] + alphas[y])), jblend.cutoff_rank(n, 0.08),
                jblend.cull_rank(n, cull), jblend.cull_limit(n, cull), True, True)
        for got in (port, jax_args):
            (n_got, _, _, t, cutoff, cull_k, limit, _, use_cutoff, use_cull) = got
            assert (n_got, t, cutoff, cull_k, limit, use_cutoff, use_cull) == want, (got, want)
        for i in (1, 2, 7):  # norm_a, norm_b, target_norm
            assert abs(port[i] - jax_args[i]) <= 1e-5 * abs(jax_args[i]), (i, port, jax_args)

    base_all = _read(base, WIDE_MAP)
    for name, shape in WIDE.items():
        base_t = base_all[name].float()
        stack = [(str(p), _read(p, WIDE_MAP)[name].float() - base_t) for p in paths]
        trace = []
        final, _ = engine.reduce(stack, trace=trace)
        written = (base_t + final).nan_to_num(nan=0.0).to(torch.bfloat16)
        assert torch.equal(ours[name], written) and final is trace[-1][-1], name
        produced = [d for _, d in stack]
        for regime, x, y, na, nb, target, cull, a_prop, a, b, merged in trace:
            # each operand is an input delta or an earlier pair merge's result
            assert any(a is p for p in produced) and any(b is p for p in produced), (name, cull)
            produced.append(merged)
            n = a.numel()
            assert a_prop == alphas[x] / (alphas[x] + alphas[y])
            again = engine._merge_pair(a, b, x, y, na, nb, target, cull)[1]
            assert torch.equal(merged.view(torch.int32), again.view(torch.int32)), (name, cull)
            ranks = (jblend.cutoff_rank(n, 0.08), jblend.cull_rank(n, cull), jblend.cull_limit(n, cull))

            f0 = tblend.fft2(a / torch.tensor(na, dtype=torch.float32))
            f1 = tblend.fft2(b / torch.tensor(nb, dtype=torch.float32))
            j0, j1 = jnp.asarray(f0.numpy()), jnp.asarray(f1.numpy())
            thr = tselect.kth_smallest_nonneg2(f0.real.abs(), f1.real.abs(), ranks[0])
            jthr = jselect.kth_smallest_nonneg2(jnp.abs(j0.real), jnp.abs(j1.real), jnp.int32(ranks[0]))
            assert np.float32(thr).view(np.uint32) == np.float32(jthr).view(np.uint32), (name, cull)
            res = tblend.interpolate_fft_components(f0, f1, a_prop, 1.0, *ranks, use_cutoff=True,
                                                    use_cull=cull > 0, interp_imag=False).real.numpy()
            jres = np.asarray(jblend.interpolate_fft_components(
                j0, j1, jnp.float32(a_prop), jnp.float32(1.0), *map(jnp.int32, ranks), use_cutoff=True,
                use_cull=cull > 0, interp_imag=False).real)
            assert _rel(res, jres) <= 1e-5, (name, cull, _rel(res, jres))

            def jax_pair(a, b):
                return np.asarray(jfourier._pair_slerp(
                    jnp.asarray(a), jnp.asarray(b), jnp.float32(na), jnp.float32(nb), jnp.float32(a_prop),
                    *map(jnp.int32, ranks), jnp.float32(target), use_cutoff=True, use_cull=cull > 0)[0])

            want = jax_pair(a.numpy(), b.numpy())
            spread = jax_pair(a.numpy().T.copy(), b.numpy().T.copy()).T
            got = merged.numpy()
            port_vs_jax, jax_spread = _close(got, want).mean(), _close(spread, want).mean()
            rel, rel_spread = _rel(got, want), _rel(spread, want)
            record_property(f"{shape}_cull{cull}_port_vs_jax", float(port_vs_jax))
            record_property(f"{shape}_cull{cull}_jax_vs_jax_transposed", float(jax_spread))
            record_property(f"{shape}_cull{cull}_relL2_port_vs_jax", rel)
            record_property(f"{shape}_cull{cull}_relL2_jax_vs_jax_transposed", rel_spread)
            assert rel_spread < 0.25 and rel <= 2 * rel_spread + 1e-6, (name, cull, rel, rel_spread)
            assert abs(port_vs_jax - jax_spread) < 0.1, (name, cull, port_vs_jax, jax_spread)
            if cull == engine.cull_start_pct and jax_spread > 0.97:
                assert port_vs_jax > 0.97, (name, cull)
    for name in WIDE:
        record_property(f"{WIDE[name]}_output_port_vs_jax",
                        float(_close(ours[name].float().numpy(), theirs[name].float().numpy()).mean()))


@pytest.mark.parametrize("which", ["input", "output"])
def test_passthrough_without_a_flagged_model_raises_as_jax(tiny, tmp_path, which):
    """No model flagged is_input (is_output): both engines raise the same
    ValueError when they reach that layer."""
    root = tiny[0]
    base = root / "base"
    flag = "is_output" if which == "input" else "is_input"
    entries = [{"model": str(root / "ft1"), "base": str(base), "alpha": 0.8, flag: True},
               {"model": str(root / "ft2"), "base": str(base), "alpha": 0.4}]
    with pytest.raises(ValueError) as jax_error:
        _run_jax(tmp_path, entries, base, "jax", TINY_SHARD_MAP)
    assert str(jax_error.value) == f"No {which} model found"
    cfg = MergeConfig(finetune_merge=[MergeModel(**e) for e in entries], output_base_model=str(base),
                      output_dir=str(tmp_path / "port"), merge_method="fourier-legacy")
    with pytest.raises(ValueError, match=f"^No {which} model found$"):
        run_merge(cfg, "cpu")
