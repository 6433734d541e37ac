"""Port vs JAX: the fourier merge of 3 or more finetunes (the pairwise stack
reduction, shardmerge_tpu_torch/merge/fourier.py ``reduce_deltas``) and the
merge's host pipeline (merge/base.py, io/writer.py, io/index.py), on the
host.

Deltas get scales far apart so that no pairing, swap or regime decision
sits on a rounding edge. The reference algorithm is still sensitive to the
FFT library wherever a later round slerps an entry whose spectrum carries
an earlier round's culled zeros or arithmetic picks: their FFT round-trip
noise decides sign agreement, so even the torch oracle moves many such
outputs beyond 2e-2 when one input changes by one ulp. So outputs are held
to JAX's where that cannot happen, to the reference's own one-ulp spread
where it does, and plans (regime, pair, order, name per round)
everywhere."""

import asyncio
import json
import logging
import shutil
import threading

import numpy as np
import pytest
import torch

from shardmerge_tpu.config import MergeConfig as JaxConfig
from shardmerge_tpu.config import MergeModel as JaxModel
from shardmerge_tpu.io.index import OfflineMultiModelIndex as JaxIndex
from shardmerge_tpu.merge import FourierMerge as JaxFourierMerge
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.config import MergeConfig, MergeModel
from shardmerge_tpu_torch.io import writer as twriter
from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex
from shardmerge_tpu_torch.io.safetensors_io import load_file, save_file
from shardmerge_tpu_torch.merge import FourierMerge
from shardmerge_tpu_torch.merge import fourier as tfourier

from .conftest import TINY_SHAPES, TINY_SHARD_MAP
from .test_merge_engine import _mostly_close, _oracle_fourier_multi

# a wide tensor takes the rfft fast-imag path (>= 2^20 elements, 2-D)
WIDE_SHAPES = {"model.layers.0.mlp.up_proj.weight": (1024, 1024)}
WIDE_SHARD_MAP = {name: "model.safetensors" for name in WIDE_SHAPES}
MERGED = sorted(n for n in TINY_SHAPES if n.startswith("model.layers."))

# (delta scales, alphas): 3-way with the odd leftover in both rounds; the
# JAX four-way test's design (add, then slerp, then arith); 5-way with
# add, slerp, arith, slerp and a leftover in rounds 1 and 2
PLANS = {
    3: ([1e-2, 3e-2, 8e-2], [1.0, 0.6, 0.3]),
    4: ([1e-2, 3e-2, 1e-10, 2e-10], [1.0, 0.5, 0.8, 0.8]),
    5: ([1e-10, 2e-10, 1e-2, 3e-2, 8e-2], [1.0, 0.7, 0.5, 0.3, 0.9]),
}
ROUNDS = {2: 1, 3: 2, 4: 2, 5: 3, 8: 3}


def _write(path, tensors, shard_map):
    path.mkdir(parents=True, exist_ok=True)
    shards = {}
    for name, shard in shard_map.items():
        shards.setdefault(shard, {})[name] = torch.from_numpy(tensors[name])
    for shard, content in shards.items():
        save_file(content, path / shard, metadata={"format": "pt"})
    index = {"metadata": {}, "weight_map": dict(shard_map)}
    (path / "model.safetensors.index.json").write_text(json.dumps(index))


def _models(root, scales, shapes=TINY_SHAPES, shard_map=TINY_SHARD_MAP, seed=0):
    """base (1e-4 N(0,1)) and one finetune per delta scale, f32."""
    gen = np.random.default_rng(seed)
    base = {k: (1e-4 * gen.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    _write(root / "base", base, shard_map)
    fts = []
    for i, scale in enumerate(scales):
        g = np.random.default_rng(seed + 1 + i)
        ft = {k: (v + scale * g.standard_normal(v.shape)).astype(np.float32) for k, v in base.items()}
        _write(root / f"ft{i}", ft, shard_map)
        fts.append(ft)
    return root / "base", [root / f"ft{i}" for i in range(len(scales))], base, fts


def _config(cls, model_cls, root, base, paths, alphas, out, **kw):
    return cls(
        finetune_merge=[model_cls(model=str(p), base=str(base), alpha=a) for p, a in zip(paths, alphas)],
        output_base_model=str(base),
        output_dir=str(root / out),
        **kw,
    )


class _Plan(logging.Handler):
    """The reduction's log lines: 'Processing N layers : ...' per round and
    'REGIME merged A and B' per pair."""

    def __init__(self, logger_name):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(logger_name)

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Processing ") or " merged " in msg:
            self.lines.append(msg)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def _read(out_dir, shard_map):
    tensors = {}
    for shard in sorted(set(shard_map.values())):
        tensors.update(load_file(out_dir / shard))
    return tensors


def _run_jax(root, base, paths, alphas, shard_map=TINY_SHARD_MAP, **kw):
    index = JaxIndex()
    for p in [base, *paths]:
        index.add_model(p)
    merger = JaxFourierMerge(
        _config(JaxConfig, JaxModel, root, base, paths, alphas, "jax_out",
                cache_dir=str(root / "cache"), storage_dir=str(root / "storage")),
        index_manager=index,
        **kw,
    )
    with _Plan("shardmerge_tpu.merge.fourier") as plan:
        asyncio.run(merger.merge())
    return _read(root / "jax_out", shard_map), merger.stats, plan.lines


def _run_port(root, base, paths, alphas, out="port_out", shard_map=TINY_SHARD_MAP,
              config_kw=None, **kw):
    cfg = _config(MergeConfig, MergeModel, root, base, paths, alphas, out, device="cpu",
                  **(config_kw or {}))
    merger = FourierMerge(cfg, device="cpu", **kw)
    with _Plan("shardmerge_tpu_torch.merge.fourier") as plan:
        merger.merge()
    return _read(root / out, shard_map), merger, plan.lines


def _close(a, b):
    return np.isclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=1e-6).mean()


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name].view(torch.uint16), b[name].view(torch.uint16)), name


# --- plans and outputs against JAX ------------------------------------------


@pytest.mark.parametrize("name", ["/m/a_/m/b", "org/model-7b_org/other", "x::1f2e3d4c_y", ""])
def test_name_hash_and_clamp_match_jax(name):
    from shardmerge_tpu.merge import fourier as jfourier

    assert tfourier.name_hash(name) == jfourier.name_hash(name)
    for v in (-1.0, 0.5, 3.0):
        assert tfourier.clamp(v, 0.0, 1.0) == jfourier.clamp(v, 0.0, 1.0)


@pytest.mark.parametrize("n", sorted(PLANS))
def test_plan_matches_jax(tmp_path, capsys, n):
    """The port CLI's per-round plan (every 'Processing' and 'REGIME merged
    A and B' line, so pairs, order, names and regimes) equals the JAX
    engine's for 3, 4 and 5 finetunes; so do the regime counters. The host
    reads norms back exactly once per reduction round of each tensor."""
    scales, alphas = PLANS[n]
    base, paths, _, _ = _models(tmp_path, scales)
    _, jstats, jplan = _run_jax(tmp_path, base, paths, alphas)

    cfg = _config(MergeConfig, MergeModel, tmp_path, base, paths, alphas, "cli_out")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({
        "output_base_model": cfg.output_base_model,
        "output_dir": cfg.output_dir,
        "finetune_merge": [{"model": m.model, "base": m.base, "alpha": m.alpha} for m in cfg.finetune_merge],
    }))
    capsys.readouterr()
    with _Plan("shardmerge_tpu_torch.merge.fourier") as plan:
        assert torch_cli(["merge", str(cfg_file), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert plan.lines == jplan
    assert len(jplan) == len(MERGED) * (ROUNDS[n] + n - 1)
    assert stats["pair_merges"] == {k: v for k, v in jstats.pair_merges.items() if v}
    regimes = {line.split()[0] for line in jplan if " merged " in line}
    assert regimes == {3: {"SLERP"}, 4: {"ADD", "SLERP", "ARITH"}, 5: {"ADD", "SLERP", "ARITH"}}[n]
    assert stats["tensors_merged"] == len(TINY_SHAPES) and stats["tensors_passthrough"] == 3
    assert stats["host_syncs"] == len(MERGED) * ROUNDS[n]
    assert stats["hbm_spills"] == 0


def test_four_way_outputs_match_jax_and_the_oracle(tmp_path):
    """4-way (add, slerp, then arith: no later-round slerp): every merged
    tensor holds to the multi-round torch oracle under the bounds of
    tests/test_merge_engine.py's four-way test, and to the JAX engine's
    output (>97% within 2e-2) exactly where the oracle does; the tensors
    where neither does are the tiny exact-path ones whose NaN cascade
    depends on the FFT library (docs/NUMERICS.md §3-4)."""
    scales, alphas = PLANS[4]
    base, paths, base_t, fts = _models(tmp_path, scales)
    theirs, _, _ = _run_jax(tmp_path, base, paths, alphas)
    ours, merger, plan = _run_port(tmp_path, base, paths, alphas)
    agree = 0
    for name in MERGED:
        expect = _oracle_fourier_multi(base_t[name], [f[name] for f in fts], alphas)
        got = ours[name].float().numpy()
        scale = max(np.abs(expect).max(), 1.0)
        _mostly_close(got, expect, rtol=3e-2, atol=3e-2 * scale, max_flip_frac=0.05)
        port_vs_jax = _close(ours[name], theirs[name])
        oracle_vs_jax = np.isclose(expect, theirs[name].float().numpy(), rtol=2e-2, atol=1e-6).mean()
        assert (port_vs_jax > 0.97) == (oracle_vs_jax > 0.97), name
        agree += port_vs_jax > 0.97
    assert agree >= len(MERGED) - 4
    assert sum(line.startswith("Processing ") for line in plan) == 2 * len(MERGED)


@pytest.mark.parametrize(
    "n,cull",
    [(3, 0.0), (4, 0.2)],
    ids=["3-way-slerp-twice", "4-way-add-slerp-arith"],
)
def test_wide_outputs_match_jax(tmp_path, n, cull):
    """A (1024, 1024) tensor on the rfft fast-imag path holds to the JAX
    engine (>97% within 2e-2). The 3-way slerps a merged entry in round 2,
    which is held to JAX with the cull off: with it on, the culled zeros'
    FFT noise decides the next round's sign agreement (see the module
    docstring)."""
    scales, alphas = PLANS[n]
    base, paths, _, _ = _models(tmp_path, scales, WIDE_SHAPES, WIDE_SHARD_MAP)
    theirs, jstats, jplan = _run_jax(tmp_path, base, paths, alphas, WIDE_SHARD_MAP, cull_start_pct=cull)
    ours, merger, plan = _run_port(tmp_path, base, paths, alphas, shard_map=WIDE_SHARD_MAP, cull_start_pct=cull)
    assert plan == jplan
    assert tfourier._use_fast_imag(False, torch.zeros(WIDE_SHAPES["model.layers.0.mlp.up_proj.weight"]))
    for name in WIDE_SHAPES:
        assert _close(ours[name], theirs[name]) > 0.97, name
    assert merger.stats.pair_merges == jstats.pair_merges


def test_wide_three_way_with_the_cull_sits_in_the_references_own_spread(tmp_path, record_property):
    """The 3-way wide merge with the cull on (0.2, then 0.1 in round 2):
    the JAX engine, and apart from it the multi-round torch oracle, each
    fed finetune 0 one ulp up, leave their own output's >97% class; the
    port's output against JAX's reads within 0.1 of that spread. So the
    whole output's distance to JAX is the reference's conditioning (a
    later-round slerp of an entry that carries culled spectral zeros), not
    the port's. The three readings go to the JUnit report's properties."""
    scales, alphas = PLANS[3]
    base, paths, base_t, fts = _models(tmp_path, scales, WIDE_SHAPES, WIDE_SHARD_MAP)
    name = next(iter(WIDE_SHAPES))
    theirs, _, jplan = _run_jax(tmp_path, base, paths, alphas, WIDE_SHARD_MAP)
    ours, _, plan = _run_port(tmp_path, base, paths, alphas, shard_map=WIDE_SHARD_MAP)
    assert plan == jplan
    nudged = np.nextafter(fts[0][name], np.float32(np.inf)).astype(np.float32)
    _write(tmp_path / "ft0_ulp", {name: nudged}, WIDE_SHARD_MAP)
    (tmp_path / "jax_out").rename(tmp_path / "jax_ref")
    theirs_ulp, _, _ = _run_jax(tmp_path, base, [tmp_path / "ft0_ulp", *paths[1:]], alphas, WIDE_SHARD_MAP)
    jax_spread = _close(theirs_ulp[name], theirs[name])
    oracle = _oracle_fourier_multi(base_t[name], [f[name] for f in fts], alphas)
    oracle_ulp = _oracle_fourier_multi(base_t[name], [nudged, *(f[name] for f in fts[1:])], alphas)
    oracle_spread = np.isclose(oracle_ulp, oracle, rtol=2e-2, atol=1e-6).mean()
    port_vs_jax = _close(ours[name], theirs[name])
    for key, value in (("jax_vs_jax_one_ulp_up", jax_spread), ("oracle_vs_oracle_one_ulp_up", oracle_spread),
                       ("port_vs_jax", port_vs_jax)):
        record_property(key, float(value))
    assert jax_spread < 0.97 and oracle_spread < 0.97
    assert abs(port_vs_jax - jax_spread) < 0.1, (port_vs_jax, jax_spread)


# --- internal equalities ------------------------------------------------------

EIGHT = ([1e-10, 2e-10, 3e-10, 5e-10, 1e-2, 2e-2, 4e-2, 9e-2], [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3])


@pytest.mark.parametrize(
    "variant,kw",
    [
        ("spill", dict(hbm_budget_bytes=0)),
        ("batch_rounds", dict(batch_rounds=True)),
        ("prefetch_3", dict(prefetch_depth=3)),
        ("no_background_flush", dict(background_flush=False)),
    ],
)
def test_variants_are_bit_equal(tmp_path, variant, kw):
    """An 8-way merge (round 1: two add and two slerp pairs, so batches of
    both regimes; then add and slerp, then arith) over tiny and wide
    tensors: each variant's output equals the default run's bit for bit
    (the default reads ahead 2 layers, flushes in the background, keeps the
    stack resident and dispatches pair by pair; prefetch_depth 0 is held
    to depth 3 the same way)."""
    shapes = dict(TINY_SHAPES)
    shapes["model.layers.0.mlp.up_proj.weight"] = WIDE_SHAPES["model.layers.0.mlp.up_proj.weight"]
    scales, alphas = EIGHT
    base, paths, _, _ = _models(tmp_path, scales, shapes)
    default_kw = dict(prefetch_depth=0) if variant == "prefetch_3" else {}
    ref, ref_merger, ref_plan = _run_port(tmp_path, base, paths, alphas, "ref", **default_kw)
    got, merger, plan = _run_port(tmp_path, base, paths, alphas, "variant", **kw)
    _bits_equal(ref, got)
    assert plan == ref_plan
    assert merger.stats.pair_merges == ref_merger.stats.pair_merges == {
        "add": 3 * 18, "arith": 18, "slerp": 3 * 18, "lowratio": 0,
    }
    assert merger.stats.host_syncs == ref_merger.stats.host_syncs == 18 * ROUNDS[8]
    if variant == "spill":
        assert merger.stats.hbm_spills > 0 and ref_merger.stats.hbm_spills == 0
    if variant == "prefetch_3":
        assert ref_merger.stats.span_fetch_s > 0


@pytest.mark.parametrize("regime", ["add", "arith", "lowratio", "slerp"])
@pytest.mark.parametrize("shape", [(16,), (24, 16), (1024, 1024)], ids=["1-D", "exact", "fast"])
def test_batched_dispatch_equals_per_pair(regime, shape):
    """Three same-regime pairs through one batched dispatch give the bits
    and NaN counts of three per-pair merges (the batched FFTs over a
    leading axis, the blend per pair); lowratio is unreachable through the
    regime predicates at norms >= 1e-4, so the jobs are built directly."""
    rng = np.random.default_rng(11)
    merger = FourierMerge(MergeConfig(finetune_merge=[], output_base_model="b", output_dir="o"), device="cpu")
    tensors = {f"e{i}": torch.from_numpy((rng.standard_normal(shape) * (0.5 + i)).astype(np.float32))
               for i in range(6)}
    norms = {k: float(torch.linalg.vector_norm(v.reshape(-1))) for k, v in tensors.items()}
    target = float(np.mean(list(norms.values())))
    jobs = []
    for i in range(3):
        a, b = f"e{2 * i + 1}", f"e{2 * i}"
        params = {"add": (), "arith": (target / norms[a], 0.5 / (1.0 + 1e-10))}.get(
            regime, (norms[a], norms[b], 0.6))
        jobs.append((regime, a, b, f"m{i}", params))
    per_pair, checks = {}, []
    for job in jobs:
        merged, check = merger.merge_pair(job, tensors[job[1]], tensors[job[2]], target, 0.1)
        per_pair[job[3]] = merged
        checks.append(check)
    cache, batch_checks, trace = dict(tensors), [], []

    def put(name, value):
        cache[name] = value

    merger._dispatch_batch(jobs, cache, put, target, 0.1,
                           tfourier._use_fast_imag(False, tensors["e0"]), batch_checks, trace)
    for job in jobs:
        assert torch.equal(cache[job[3]], per_pair[job[3]]), job[3]
        assert job[1] not in cache and job[2] not in cache
    assert [t[0] for t in trace] == jobs
    if regime in ("add", "arith"):
        assert batch_checks == [] and checks == [None] * 3
    else:
        for (nan_a, inf_a), (nan_b, inf_b) in zip(batch_checks, checks):
            assert int(nan_a) == int(nan_b) and bool(inf_a) == bool(inf_b)


def test_fused_pair_matches_the_stack_path(tmp_path):
    """Two finetunes take the fused path; a huge hbm budget sends them
    through the stack path with no spill. The two agree up to the rounding
    of the host-vs-device target_norm, within the JAX test's bound."""
    base, paths, _, _ = _models(tmp_path, [1e-2, 3e-2])
    fused, fused_merger, fused_plan = _run_port(tmp_path, base, paths, [0.8, 0.4], "fused")
    stack, stack_merger, plan = _run_port(tmp_path, base, paths, [0.8, 0.4], "stack",
                                          hbm_budget_bytes=1 << 62)
    assert fused_plan == [] and fused_merger.stats.host_syncs == len(MERGED)
    assert stack_merger.stats.hbm_spills == 0 and len(plan) == 2 * len(MERGED)
    for name in fused:
        a, b = fused[name].float().numpy(), stack[name].float().numpy()
        close = np.isclose(a, b, rtol=1e-2, atol=1e-2 * max(np.abs(b).max(), 1e-3))
        assert close.mean() > 0.99, name


# --- writer, resume and failures ------------------------------------------------


def test_write_through_resumes_after_a_cut(tmp_path, monkeypatch):
    """write_through rewrites a tensor's shard as it arrives: a merge cut at
    the third tensor of the second shard leaves the first shard and the
    tensors written before the cut on disk (the one awaiting its write-back
    is lost); the rerun merges only the rest, and the result equals an
    uncut merge bit for bit. The CLI accepts write_through."""
    scales, alphas = PLANS[3]
    base, paths, _, _ = _models(tmp_path, scales)
    order = [sl.layer_name for shard in _shard_layers(base) for sl in shard]
    first = [n for n, s in TINY_SHARD_MAP.items() if s == "model-00001-of-00003.safetensors"]
    cut = order[len(first) + 2]
    real = FourierMerge._merge_layer

    def failing(self, shard_layer):
        if shard_layer.layer_name == cut:
            raise RuntimeError("cut")
        return real(self, shard_layer)

    monkeypatch.setattr(FourierMerge, "_merge_layer", failing)
    with pytest.raises(RuntimeError, match="cut"):
        _run_port(tmp_path, base, paths, alphas, "out", config_kw=dict(write_through=True))
    on_disk = _read_present(tmp_path / "out")
    assert set(first) <= set(on_disk)
    assert cut not in on_disk and len(on_disk) == len(first) + 1
    monkeypatch.setattr(FourierMerge, "_merge_layer", real)

    cfg = {
        "output_base_model": str(base), "output_dir": str(tmp_path / "out"), "write_through": True,
        "finetune_merge": [{"model": str(p), "base": str(base), "alpha": a} for p, a in zip(paths, alphas)],
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    assert torch_cli(["merge", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 0
    uncut, merger, _ = _run_port(tmp_path, base, paths, alphas, "uncut")
    _bits_equal(_read(tmp_path / "out", TINY_SHARD_MAP), uncut)


def _shard_layers(base):
    index = OfflineMultiModelIndex()
    index.add_model(base)
    w = twriter.ModelWriter(base_index=index.get_index(str(base)), output_path=base.parent / "plan",
                            layer_order=index.get_layer_order(str(base)))
    return list(w.shard_layers())


def _read_present(out_dir):
    tensors = {}
    for path in sorted(out_dir.glob("*.safetensors")):
        tensors.update(load_file(path))
    return tensors


@pytest.mark.parametrize("background", [True, False], ids=["background_flush", "inline_flush"])
def test_failed_save_leaves_finalize_raising(tmp_path, monkeypatch, background):
    """A shard save that raises drops the file, unmarks its tensors, and
    finalize reports the run incomplete."""
    scales, alphas = PLANS[3]
    base, paths, _, _ = _models(tmp_path, scales)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(twriter, "save_file", broken)
    with pytest.raises(RuntimeError, match="Incomplete model output"):
        _run_port(tmp_path, base, paths, alphas, background_flush=background)
    assert not list((tmp_path / "port_out").glob("*.safetensors"))


# --- deferred checks ---------------------------------------------------------------


def test_non_finite_delta_raises_before_its_tensor_is_written(tmp_path):
    """A difference that overflows float32 (finetune 3e38, base -3e38) gives
    a delta of infinite norm, which the pairing cannot rank (the JAX engine
    then pairs nothing and never ends). The port raises before the tensor
    is written; the tensors before it in write-through order are on disk."""
    scales, alphas = PLANS[3]
    base, paths, base_t, _ = _models(tmp_path, scales)
    name = "model.layers.1.self_attn.q_proj.weight"
    shard = TINY_SHARD_MAP[name]
    b = load_file(base / shard)
    b[name][0, 0] = -3e38
    save_file(b, base / shard, metadata={"format": "pt"})
    f = load_file(paths[1] / shard)
    f[name][0, 0] = 3e38
    save_file(f, paths[1] / shard, metadata={"format": "pt"})
    with pytest.raises(ValueError, match="non-finite norm"):
        _run_port(tmp_path, base, paths, alphas, config_kw=dict(write_through=True))
    on_disk = _read_present(tmp_path / "port_out")
    assert name not in on_disk and on_disk


def test_pair_inf_flag_aborts_at_write_back(tmp_path, monkeypatch):
    """Inf flags of a round's pair merges stay on the device and are read
    at the tensor's write-back, which then aborts before writing it."""
    scales, alphas = PLANS[3]
    base, paths, _, _ = _models(tmp_path, scales)
    real = tfourier._scrub
    seen = []

    def flagging(merged, target_norm):
        out, nan_count, has_inf = real(merged, target_norm)
        seen.append(1)
        return out, nan_count, has_inf | (len(seen) == 7)

    monkeypatch.setattr(tfourier, "_scrub", flagging)
    with pytest.raises(ValueError, match="Inf in ifft output"):
        _run_port(tmp_path, base, paths, alphas, config_kw=dict(write_through=True))
    # the 4th merged tensor's round 1 carried the flag: three were written
    assert len(_read_present(tmp_path / "port_out")) == 3


def test_nan_scrub_count_matches_jax(tmp_path):
    """Even-symmetric 1-D deltas have purely real spectra, so the exact
    path's imaginary recursion divides 0/0 in both FFT libraries alike and
    the scrubbed NaN counts agree with the JAX engine's."""
    shapes = {"model.layers.0.input_layernorm.weight": (16,), "model.layers.1.input_layernorm.weight": (16,)}
    shard_map = {n: "model.safetensors" for n in shapes}
    root = tmp_path
    _write(root / "base", {n: np.zeros(s, np.float32) for n, s in shapes.items()}, shard_map)
    paths = []
    for i in range(3):
        g = np.random.default_rng(3 + i)
        ft = {}
        for n, (length,) in shapes.items():
            x = np.zeros(length, np.float32)
            x[: length // 2 + 1] = (10.0 ** i) * g.standard_normal(length // 2 + 1)
            x[length // 2 + 1:] = x[1: length // 2][::-1]
            ft[n] = x
        _write(root / f"ft{i}", ft, shard_map)
        paths.append(root / f"ft{i}")
    alphas = [1.0, 0.6, 0.3]
    _, jstats, jplan = _run_jax(root, root / "base", paths, alphas, shard_map)
    _, merger, plan = _run_port(root, root / "base", paths, alphas, shard_map=shard_map)
    assert plan == jplan
    assert jstats.nans_scrubbed > 0
    assert merger.stats.nans_scrubbed == jstats.nans_scrubbed


# --- the pipeline --------------------------------------------------------------------


def test_spans_and_counters_populate(tmp_path):
    """On the host the spans fill, every written tensor has its per-tensor
    spans (wall, read, h2d, merge, flush), and the summary names the
    counters."""
    scales, alphas = PLANS[4]
    base, paths, _, _ = _models(tmp_path, scales)
    _, merger, _ = _run_port(tmp_path, base, paths, alphas)
    s = merger.stats
    assert s.span_fetch_s > 0 and s.span_merge_s > 0 and s.span_flush_s > 0
    assert set(merger.tensor_spans) == set(TINY_SHAPES)
    for spans in merger.tensor_spans.values():
        assert set(spans) == {"wall_s", "read_s", "h2d_s", "merge_s", "flush_s"}
        assert min(spans.values()) >= 0
    assert s.host_syncs == len(MERGED) * ROUNDS[4] and s.prefetch_failures == 0
    assert "host syncs" in s.summary()


def test_failed_read_ahead_falls_back_to_the_demand_read(tmp_path, monkeypatch):
    """Read-aheads that raise are counted and the merge reads on demand on
    the same device, with the same bits."""
    scales, alphas = PLANS[3]
    base, paths, _, _ = _models(tmp_path, scales)
    ref, _, _ = _run_port(tmp_path, base, paths, alphas, "ref")

    def broken(self, *args, **kwargs):
        raise OSError("read-ahead refused")

    monkeypatch.setattr(OfflineMultiModelIndex, "preload_tensor", broken)
    got, merger, _ = _run_port(tmp_path, base, paths, alphas, "got")
    _bits_equal(ref, got)
    assert merger.stats.prefetch_failures > 0


def test_index_preload_is_thread_safe(tmp_path):
    """Many threads preload, read and release the same tensors at once: each
    read returns the file's values."""
    import sys

    base, _, base_t, _ = _models(tmp_path, [])
    index = OfflineMultiModelIndex()
    index.add_model(base)
    names = sorted(TINY_SHAPES)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(k):
        try:
            for i in range(60):
                name = names[(k + i) % len(names)]
                t = index.preload_tensor(str(base), name) if i % 2 else index.get_tensor(str(base), name)
                assert np.array_equal(t.numpy(), base_t[name])
                if i % 7 == 0:
                    index.release_tensor(str(base), name)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        index.close()
    assert not errors, errors[:3]


def test_cli_accepts_hbm_budget(tmp_path, capsys):
    """hbm_budget_gb: 0 spills every stack entry (counted in the JSON line)
    and gives the resident run's bits. A 2-finetune config with a budget
    takes the stack path, which keys entries by model: the same model
    listed twice, against one base or two, is refused (a delta would be
    lost), where without a budget the fused path merges both."""
    scales, alphas = PLANS[4]
    base, paths, _, _ = _models(tmp_path, scales)
    outs = {}
    for tag, extra in (("resident", {}), ("spill", {"hbm_budget_gb": 0})):
        cfg = {
            "output_base_model": str(base), "output_dir": str(tmp_path / tag), **extra,
            "finetune_merge": [{"model": str(p), "base": str(base), "alpha": a} for p, a in zip(paths, alphas)],
        }
        (tmp_path / f"{tag}.json").write_text(json.dumps(cfg))
        capsys.readouterr()
        assert torch_cli(["merge", str(tmp_path / f"{tag}.json"), "--device", "cpu"]) == 0
        outs[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["spill"]["hbm_spills"] > 0 and outs["resident"]["hbm_spills"] == 0
    _bits_equal(_read(tmp_path / "resident", TINY_SHARD_MAP), _read(tmp_path / "spill", TINY_SHARD_MAP))

    for bases in ([base, base], [base, paths[1]]):
        twice = {
            "output_base_model": str(base), "output_dir": str(tmp_path / "twice"),
            "finetune_merge": [{"model": str(paths[0]), "base": str(b), "alpha": a}
                               for b, a in zip(bases, (0.8, 0.4))],
        }
        (tmp_path / "twice.json").write_text(json.dumps({**twice, "hbm_budget_gb": 1.0}))
        capsys.readouterr()
        assert torch_cli(["merge", str(tmp_path / "twice.json"), "--device", "cpu"]) == 2
        assert "more than once" in capsys.readouterr().err
        assert not (tmp_path / "twice").exists()
        (tmp_path / "fused.json").write_text(json.dumps(twice))
        assert torch_cli(["merge", str(tmp_path / "fused.json"), "--device", "cpu"]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["tensors_merged"] == len(TINY_SHAPES) and stats["host_syncs"] == len(MERGED)
        shutil.rmtree(tmp_path / "twice")
