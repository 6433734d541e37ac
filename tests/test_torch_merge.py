"""Port vs JAX: the fourier merge engine (shardmerge_tpu_torch/merge against
shardmerge_tpu/merge), per pair merge and through both CLIs end to end."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.merge import fourier as jfourier
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.io.safetensors_io import load_file
from shardmerge_tpu_torch.merge import fourier as tfourier
from shardmerge_tpu_torch.ops import blend as tblend

from .conftest import TINY_SHARD_MAP, make_tiny_model
from .test_merge_engine import _oracle_fourier_pair


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _inputs(shape, regime, rng):
    """(base, ft1, ft2) f32 arrays that drive _fused_pair into ``regime``."""
    base = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    d1 = rng.standard_normal(shape).astype(np.float32)
    d2 = rng.standard_normal(shape).astype(np.float32)
    scale1, scale2 = {
        "add": (0.0, 0.0),  # both deltas zero: cnorm_a < 1e-6
        "arith": (1e-2, 3e-4),  # norm ratio < 0.1
        "slerp-early": (3e-8, 2e-8),  # delta norms < 1e-4
        "slerp": (1e-2, 8e-3),
    }[regime]
    return base, base + scale1 * d1, base + scale2 * d2


def _even_symmetric(rng, n):
    x = np.zeros(n, np.float32)
    x[: n // 2 + 1] = rng.standard_normal(n // 2 + 1).astype(np.float32)
    for k in range(1, n // 2):
        x[n - k] = x[k]
    return x


@pytest.mark.parametrize(
    "shape,regime",
    [((1024, 1024), r) for r in ("add", "arith", "slerp-early", "slerp")]
    + [((16,), r) for r in ("add", "arith", "slerp-early", "slerp")],
)
def test_fused_pair_matches_jax(shape, regime):
    """relL2 <= 6e-3 and max abs <= 0.2 * rms on the merged delta (the
    ROADMAP pair-merge class); the (1024, 1024) cases run the fast-imag
    rfft path, the (16,) cases the exact double-FFT path."""
    rng = np.random.default_rng(31)
    if shape == (16,) and regime == "slerp":
        # the pinned quirk input (its NaN cascade is identical in both FFT
        # libraries; a random (16,) pair cascades library-dependently)
        r3 = np.random.default_rng(3)
        base = np.zeros(16, np.float32)
        ft1, ft2 = _even_symmetric(r3, 16), _even_symmetric(r3, 16)
    else:
        base, ft1, ft2 = _inputs(shape, regime, rng)
    n = base.size
    ranks = (tblend.cutoff_rank(n, 0.08), tblend.cull_rank(n, 0.2), tblend.cull_limit(n, 0.2))
    fast = tfourier._use_fast_imag(False, torch.from_numpy(base))
    assert fast == (len(shape) == 2)
    t = [torch.from_numpy(x) for x in (base, ft1, ft2)]
    out, nans, pair_inf, final_inf, code = tfourier._fused_pair(
        t[0], t[0], t[1], t[0], t[2], 0.8, 0.4, 1e-10, *ranks,
        use_cull=True, fast_imag=fast,
    )
    j = [jnp.asarray(x) for x in (base, ft1, ft2)]
    jout, jnans, jinf, jcode = jfourier._fused_pair(
        j[0], j[0], j[1], j[0], j[2], jnp.float32(0.8), jnp.float32(0.4),
        jnp.float32(1e-10), *[jnp.int32(r) for r in ranks],
        use_cull=True, fast_imag=fast,
    )
    assert tfourier.FUSED_REGIMES[code] == regime and int(jcode) == code
    assert int(nans) == int(jnans)
    assert not bool(pair_inf) and not bool(final_inf) and not bool(jinf)
    ours = out.float().numpy() - base
    theirs = np.asarray(jout).astype(np.float32) - base
    if not np.any(theirs):
        np.testing.assert_array_equal(ours, theirs)
        return
    rms = np.sqrt(np.mean(theirs.astype(np.float64) ** 2))
    assert _rel_l2(ours, theirs) <= 6e-3
    assert np.max(np.abs(ours - theirs)) <= 0.2 * rms


@pytest.mark.parametrize("fast", [False, True])
def test_lowratio_pair_matches_jax(fast):
    """Regime 3 (norm ratio < 0.1 after the regime-1 test) is unreachable
    through _fused_pair's predicates at f32 norms >= 1e-4, so its kernel
    is held to JAX's directly."""
    rng = np.random.default_rng(32)
    shape = (1024, 1024) if fast else (16, 12)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    tk = tfourier._pair_lowratio_rfft if fast else tfourier._pair_lowratio
    jk = jfourier._pair_lowratio_rfft if fast else jfourier._pair_lowratio
    ours, _, _ = tk(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(na),
                    torch.tensor(nb), torch.tensor(0.6), torch.tensor(2.0))
    theirs, _, _ = jk(jnp.asarray(a), jnp.asarray(b), jnp.float32(na), jnp.float32(nb),
                      jnp.float32(0.6), jnp.float32(2.0))
    assert _rel_l2(ours.numpy(), np.asarray(theirs)) <= 1e-5


def _write_config(path, base, ft1, ft2, out):
    cfg = {
        "output_base_model": str(base),
        "finetune_merge": [
            {"model": str(ft1), "base": str(base), "alpha": 0.8},
            {"model": str(ft2), "base": str(base), "alpha": 0.4},
        ],
        "output_dir": str(out),
        "cache_dir": str(path / "cache"),
        "storage_dir": str(path / "storage"),
    }
    cfg_file = path / f"{out.name}.json"
    cfg_file.write_text(json.dumps(cfg))
    return cfg_file


def _read(out_dir):
    tensors = {}
    for shard in sorted(set(TINY_SHARD_MAP.values())):
        tensors.update(load_file(out_dir / shard))
    return tensors


def test_cli_merge_matches_jax_cli_and_resumes(tmp_path, capsys):
    """SKILL.md's recipe (tiny base + 2 finetunes, 21 tensors) through both
    CLIs on the host.

    - index identical, passthrough tensors bit-equal;
    - every merged tensor bit-equal to the torch oracle of the layer
      algorithm (the port runs torch's FFT, as the oracle does);
    - against the JAX CLI: a merged tensor agrees to >97% of elements
      within 2e-2 exactly when the JAX output agrees with the oracle —
      the tiny tensors run the exact double-FFT path, whose NaN cascade
      and threshold flips depend on the FFT library (docs/NUMERICS.md §3-4);
    - a second run resumes and merges 0 tensors.
    """
    from click.testing import CliRunner

    from shardmerge_tpu.cli import cli as jax_cli

    paths = {}
    src = {}
    for name, seed in [("base", 1), ("ft1", 2), ("ft2", 3)]:
        paths[name] = tmp_path / name
        src[name] = make_tiny_model(paths[name], seed=seed)

    jcfg = _write_config(tmp_path, paths["base"], paths["ft1"], paths["ft2"], tmp_path / "jax_out")
    result = CliRunner().invoke(jax_cli, ["merge", str(jcfg), "--device", "cpu"])
    assert result.exit_code == 0, result.output

    tcfg = _write_config(tmp_path, paths["base"], paths["ft1"], paths["ft2"], tmp_path / "port_out")
    capsys.readouterr()
    assert torch_cli(["merge", str(tcfg), "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["tensors_merged"] == 21 and stats["tensors_passthrough"] == 3
    assert stats["pair_merges"] == {"slerp": 18}

    index = "model.safetensors.index.json"
    assert json.loads((tmp_path / "port_out" / index).read_text()) == json.loads(
        (tmp_path / "jax_out" / index).read_text()
    )
    ours, theirs = _read(tmp_path / "port_out"), _read(tmp_path / "jax_out")
    assert set(ours) == set(theirs) == set(TINY_SHARD_MAP)
    merged = [k for k in ours if k.startswith("model.layers.")]
    assert len(merged) == 18
    for k in set(ours) - set(merged):
        assert torch.equal(ours[k], theirs[k]), k
        assert ours[k].dtype == torch.bfloat16
    for k in merged:
        o = ours[k].float().numpy()
        j = theirs[k].float().numpy()
        ref = _oracle_fourier_pair(src["base"][k], src["ft1"][k], src["ft2"][k], 0.8, 0.4)
        np.testing.assert_array_equal(o, ref, err_msg=k)
        port_vs_jax = np.isclose(o, j, rtol=2e-2, atol=1e-6).mean()
        oracle_vs_jax = np.isclose(ref, j, rtol=2e-2, atol=1e-6).mean()
        assert (port_vs_jax > 0.97) == (oracle_vs_jax > 0.97), k

    assert torch_cli(["merge", str(tcfg), "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["tensors_merged"] == 0
    assert _read(tmp_path / "port_out").keys() == ours.keys()


def test_cli_rejects_unported_configs(tmp_path, capsys, caplog):
    """An unknown method is refused with the JAX CLI's message, before
    anything is written; a model listed twice in a stack of 3 or more is
    refused with a clear error (the JAX engine loses a stack entry there and
    raises KeyError on some tensors). The sharded merge's fields, once
    refused, are accepted: without a launcher's ranks ``shard_tensors``
    merges on one device and says so, and ``distributed: true`` degrades to
    a single process after a failed probe (as the JAX CLI does)."""
    base = tmp_path / "base"
    make_tiny_model(base, seed=1)
    cfg = json.loads(_write_config(tmp_path, base, base, base, tmp_path / "o").read_text())
    f = tmp_path / "merge_method.json"
    f.write_text(json.dumps({**cfg, "merge_method": "nope"}))
    assert torch_cli(["merge", str(f), "--device", "cpu"]) == 2
    assert "Unknown merge_method 'nope'; choose from [" in capsys.readouterr().err
    for field, message in [
        ("shard_tensors", "shard_tensors requested but only one rank is running"),
        ("distributed", "distributed runtime not started"),
    ]:
        f = tmp_path / f"{field}.json"
        f.write_text(json.dumps({**cfg, field: True}))
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert torch_cli(["merge", str(f), "--device", "cpu", "--dry-run"]) == 0
        assert "plan OK" in capsys.readouterr().out
        assert message in caplog.text, field
    assert not (tmp_path / "o").exists()
    three = dict(cfg, finetune_merge=cfg["finetune_merge"] * 2)
    f = tmp_path / "three.json"
    f.write_text(json.dumps(three))
    assert torch_cli(["merge", str(f), "--device", "cpu"]) == 2
    assert "more than once" in capsys.readouterr().err


def test_safetensors_files_interchange_with_jax_io(tmp_path):
    """Files written by either package read back bit-equal in the other;
    views handed out by the port's reader stay valid after close()."""
    import ml_dtypes

    from shardmerge_tpu.io import safetensors_io as jio
    from shardmerge_tpu_torch.io import safetensors_io as tio

    rng = np.random.default_rng(51)
    ours = {
        "bf16": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).to(torch.bfloat16),
        "f32": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32)),
        "u8": torch.arange(12, dtype=torch.uint8).reshape(3, 4),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    tio.save_file(ours, tmp_path / "port.safetensors", metadata={"format": "pt"})
    theirs = jio.load_file(tmp_path / "port.safetensors")
    for k, t in ours.items():
        want = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if k == "bf16" else t.numpy()
        np.testing.assert_array_equal(theirs[k], want)
    jio.save_file(
        {k: theirs[k] for k in ("bf16", "f32", "u8", "empty")},
        tmp_path / "jax.safetensors",
        metadata={"format": "pt"},
    )

    reader = tio.SafeTensorsReader(tmp_path / "jax.safetensors")
    views = {k: reader.get_tensor(k) for k in reader.keys()}
    reader.close()
    assert set(views) == {"bf16", "f32", "u8", "empty"}
    for k, t in views.items():
        assert torch.equal(t, ours[k]), k


def test_device_resolution_and_config_errors(tmp_path, capsys, monkeypatch):
    """No silent CPU fallback: without a card only --device cpu runs; bad
    configs fail with the JAX CLI's messages."""
    from shardmerge_tpu_torch.backend import BackendError, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for req in (None, "cuda", "tpu"):
        with pytest.raises(BackendError, match="--device cpu"):
            resolve_device(req)
    base = tmp_path / "base"
    make_tiny_model(base, seed=1)
    cfg = _write_config(tmp_path, base, base, base, tmp_path / "o")
    assert torch_cli(["merge", str(cfg)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"output_dir": "x"}))
    assert torch_cli(["merge", str(bad), "--device", "cpu"]) == 2
    assert "Missing required configuration fields" in capsys.readouterr().err
    bad.write_text("")
    assert torch_cli(["merge", str(bad), "--device", "cpu"]) == 2
    assert "must contain a YAML mapping" in capsys.readouterr().err


def test_index_reads_single_file_checkpoints_and_profiler_logs(tmp_path, caplog):
    import logging

    from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex
    from shardmerge_tpu_torch.io.safetensors_io import save_file
    from shardmerge_tpu_torch.ops.profiling import phase_profiler

    d = tmp_path / "single"
    d.mkdir()
    tensors = {"model.layers.0.mlp.up_proj.weight": torch.ones(4, 2), "lm_head.weight": torch.zeros(3, 2)}
    save_file(tensors, d / "model.safetensors")
    index = OfflineMultiModelIndex()
    index.add_model(d)
    doc = index.get_index(str(d))
    assert doc["weight_map"] == {k: "model.safetensors" for k in tensors}
    assert doc["metadata"]["total_size"] == 4 * 2 * 4 + 3 * 2 * 4
    assert index.get_layer_order("single") == ["model.layers.0.mlp.up_proj.weight", "lm_head.weight"]
    assert torch.equal(index.get_tensor(str(d), "lm_head.weight"), tensors["lm_head.weight"])
    index.close()

    with caplog.at_level(logging.INFO, logger="shardmerge_tpu_torch.ops.profiling"):
        with phase_profiler("probe", display=True, device="cpu"):
            pass
    assert any("[profile] probe:" in r.getMessage() for r in caplog.records)
