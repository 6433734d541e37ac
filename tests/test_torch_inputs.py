"""The port's new merge inputs against the JAX package on the host:
GPTQ/AWQ decoding (models/quant.py) bit for bit, the one LoRA fuse
(tools/fuse_lora.fuse_pair) against the JAX index's and loader's numpy
fuse and its jitted ``_fused``, and a tiny CLI merge whose inputs are a
PEFT adapter, a GPTQ artifact and a Hub repo: bit-equal to the port's merge
of the materialized inputs (fused, decoded and local), and within the
class tests/test_torch_merge.py holds the port's CLI merge to against the
JAX CLI's merge of the same inputs."""

from __future__ import annotations

import json
import os
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from shardmerge_tpu.models import quant as jquant
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, load_file, save_file
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.tools.fuse_lora import fuse_pair

from .conftest import TINY_SHARD_MAP, make_tiny_model
from .test_merge_engine import _oracle_fourier_pair
from .test_torch_download import LocalHub
from .test_torch_hub_index import bits


def _packed_parts(rng, in_dim, out_dim, bits_, groups):
    per = 32 // bits_
    word = lambda shape: rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)  # noqa: E731
    return (word((in_dim // per, out_dim)), word((groups, out_dim // per)),
            (rng.standard_normal((groups, out_dim)) * 0.05).astype(np.float16))


@pytest.mark.parametrize("bits_,v1,act_order", [(4, True, True), (4, False, False), (8, True, False), (8, False, True)])
def test_dequant_gptq_is_bit_equal_to_jax(bits_, v1, act_order):
    rng = np.random.default_rng(bits_ * 10 + v1)
    in_dim, out_dim, groups = 128, 96, 4
    qw, qz, sc = _packed_parts(rng, in_dim, out_dim, bits_, groups)
    g = np.arange(in_dim, dtype=np.int32) // (in_dim // groups)
    if act_order:
        g = rng.permutation(g).astype(np.int32)
    want = jquant.dequant_gptq(qw, qz, sc, g, bits_, v1_zero_offset=v1)
    got = tquant.dequant_gptq(torch.from_numpy(qw), torch.from_numpy(qz), torch.from_numpy(sc),
                              torch.from_numpy(g), bits_, v1_zero_offset=v1)
    assert got.shape == want.shape == (out_dim, in_dim) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("groups", [1, 8])
def test_dequant_awq_is_bit_equal_to_jax(groups):
    rng = np.random.default_rng(groups)
    in_dim, out_dim = 64, 48
    qw = rng.integers(-(2**31), 2**31, (in_dim, out_dim // 8), dtype=np.int64).astype(np.int32)
    qz = rng.integers(-(2**31), 2**31, (groups, out_dim // 8), dtype=np.int64).astype(np.int32)
    sc = (rng.standard_normal((groups, out_dim)) * 0.05).astype(np.float16)
    want = jquant.dequant_awq(qw, qz, sc)
    got = tquant.dequant_awq(torch.from_numpy(qw), torch.from_numpy(qz), torch.from_numpy(sc))
    np.testing.assert_array_equal(bits(got), bits(want))
    with pytest.raises(ValueError, match="4-bit"):
        tquant.dequant_awq(torch.from_numpy(qw), torch.from_numpy(qz), torch.from_numpy(sc), bits=8)


@pytest.mark.parametrize("shape,r", [((16, 16), 2), ((64, 48), 16), ((256, 256), 64), ((1024, 512), 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_fuse_matches_the_jax_fuses(shape, r, dtype, record_property):
    """Byte for byte against the JAX index's and loader's numpy fuse
    (``_apply_lora_pair``); against the jitted ``_fused`` of JAX's
    fuse-lora tool the share of differing elements and their largest ulp
    gap are recorded: XLA's dot sums the rank-r products in another order
    at some f32 shapes (the JAX package's own three fuses then disagree)."""
    from shardmerge_tpu.models.loader import _apply_lora_pair
    from shardmerge_tpu.tools.fuse_lora import _fused

    rng = np.random.default_rng(shape[0] + r)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    w = rng.standard_normal(shape).astype(np.float32).astype(np_dtype)
    a = rng.standard_normal((r, shape[1])).astype(np.float32)
    b = (rng.standard_normal((shape[0], r)) * 0.1).astype(np.float32)
    tw = torch.from_numpy(w.view(np.uint16)).view(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(w)
    got = bits(fuse_pair(tw, torch.from_numpy(a), torch.from_numpy(b), 2.0))
    np.testing.assert_array_equal(got, bits(_apply_lora_pair(w, {"A": a, "B": b}, 2.0)))
    jitted = _fused(w, a, b, 2.0)
    gap = np.abs(got.astype(np.int64) - bits(jitted).astype(np.int64))
    record_property("differs_from_jitted", float((gap > 0).mean()))
    record_property("max_ulp_gap", int(gap.max()))
    ours = fuse_pair(tw, torch.from_numpy(a), torch.from_numpy(b), 2.0).float().numpy()
    # rounding of a sum of r products: within a few f32 ulps of the largest value
    assert np.abs(ours - jitted.astype(np.float32)).max() <= 4e-7 * r * np.abs(ours).max()


def _decoded_checkpoint(src: Path, dst: Path):
    """A GPTQ/AWQ checkpoint's tensors as the index decodes them, written as
    a plain local checkpoint (f32 decoded weights, the rest raw)."""
    from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex

    index = OfflineMultiModelIndex()
    index.add_model(src)
    tensors = {k: index.preload_tensor(src, k) for k in index.get_layer_order(src)}
    index.close()
    dst.mkdir()
    save_file(tensors, dst / "model.safetensors")


def _read(out_dir: Path):
    tensors = {}
    for shard in sorted(set(TINY_SHARD_MAP.values())):
        tensors.update(load_file(out_dir / shard))
    return tensors


def _config(tmp_path: Path, name: str, models, base: Path, alphas=(0.8, 0.5, 0.3)) -> Path:
    cfg = {
        "output_base_model": str(base),
        "finetune_merge": [{"model": str(m), "base": str(base), "alpha": a}
                           for m, a in zip(models, alphas)],
        "output_dir": str(tmp_path / name),
        "storage_dir": str(tmp_path / "storage"),
        "cache_dir": str(tmp_path / "cache"),
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """base and ft1-ft3 (bf16); ft1 as a rank-16 adapter (extract-lora), ft2
    as a GPTQ-v2 int4 artifact (quantize), both made through the port CLI."""
    root = tmp_path_factory.mktemp("inputs")
    for name, seed in [("base", 1), ("ft1", 2), ("ft2", 3), ("ft3", 4)]:
        make_tiny_model(root / name, seed=seed, dtype="bfloat16")
    assert torch_cli(["extract-lora", str(root / "base"), str(root / "ft1"), str(root / "adapter"),
                      "--rank", "8", "--device", "cpu"]) == 0
    assert torch_cli(["quantize", str(root / "ft2"), str(root / "gptq")]) == 0
    return root


def test_cli_merge_of_adapter_gptq_and_hub_inputs_equals_the_materialized_merge(inputs, tmp_path, capsys,
                                                                                 monkeypatch):
    for name in ("base", "ft1", "ft2", "ft3", "adapter", "gptq"):
        os.symlink(inputs / name, tmp_path / name)
    with LocalHub() as hub:
        hub.serve_dir("org/ft3", inputs / "ft3")
        monkeypatch.setenv("HF_ENDPOINT", hub.base)
        cfg = _config(tmp_path, "out", [tmp_path / "adapter", tmp_path / "gptq", "org/ft3"], tmp_path / "base")
        assert torch_cli(["merge", str(cfg), "--device", "cpu", "--dry-run"]) == 0
        assert "plan OK" in capsys.readouterr().out
        assert not (tmp_path / "out").exists()
        assert torch_cli(["merge", str(cfg), "--device", "cpu", "--clean_cache", "--cache-dir",
                          str(tmp_path / "c2")]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        for shard in set(TINY_SHARD_MAP.values()):
            assert hub.hits_of(f"/org/ft3/resolve/main/{shard}") <= 1
    assert stats["tensors_merged"] == 21 and stats["host_work"]["fuse"]["tensors"] == 14
    assert stats["host_work"]["decode"]["tensors"] == 14 and stats["downloads"]["bytes"] > 0
    assert not list((tmp_path / "storage").rglob("*.safetensors"))  # clean_cache
    assert json.loads((tmp_path / "out/model.safetensors.index.json").read_text()) == json.loads(
        (inputs / "base/model.safetensors.index.json").read_text())

    # the materialized inputs through the local path
    assert torch_cli(["fuse-lora", str(inputs / "base"), str(inputs / "adapter"), str(tmp_path / "fused"),
                      "--device", "cpu"]) == 0
    _decoded_checkpoint(inputs / "gptq", tmp_path / "decoded")
    cfg = _config(tmp_path, "local", [tmp_path / "fused", tmp_path / "decoded", inputs / "ft3"], inputs / "base")
    assert torch_cli(["merge", str(cfg), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert torch_cli(["compare", str(tmp_path / "out"), str(tmp_path / "local"), "--max-rel", "0"]) == 0
    assert "21 bit-identical" in capsys.readouterr().out
    ours, local = _read(tmp_path / "out"), _read(tmp_path / "local")
    for name in ours:
        assert torch.equal(ours[name].view(torch.int16), local[name].view(torch.int16)), name


def test_adapter_and_gptq_merge_sits_in_the_jax_clis_class(inputs, tmp_path, capsys):
    """2 finetunes (the adapter, the GPTQ artifact) through both CLIs: the
    port within one bf16 ulp of the torch oracle on the materialized inputs
    (on at most 1% of elements; bit-equal elsewhere), and each
    merged tensor agreeing with the JAX CLI (>97% within 2e-2) exactly when
    the oracle does (the tiny tensors' exact double-FFT path depends on the
    FFT library, as in tests/test_torch_merge.py)."""
    from click.testing import CliRunner

    from shardmerge_tpu.cli import cli as jax_cli

    models = [inputs / "adapter", inputs / "gptq"]
    jcfg = _config(tmp_path, "jax_out", models, inputs / "base", alphas=(0.8, 0.4))
    result = CliRunner().invoke(jax_cli, ["merge", str(jcfg), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert torch_cli(["merge", str(_config(tmp_path, "port_out", models, inputs / "base", alphas=(0.8, 0.4))),
                      "--device", "cpu"]) == 0
    assert torch_cli(["fuse-lora", str(inputs / "base"), str(inputs / "adapter"), str(tmp_path / "fused"),
                      "--device", "cpu"]) == 0
    _decoded_checkpoint(inputs / "gptq", tmp_path / "decoded")
    src = {}
    for name, path in [("base", inputs / "base"), ("ft1", tmp_path / "fused"), ("ft2", tmp_path / "decoded")]:
        files = sorted(path.glob("*.safetensors"))
        src[name] = {k: v.float().numpy() for f in files for k, v in load_file(f).items()}
    ours, theirs = _read(tmp_path / "port_out"), _read(tmp_path / "jax_out")
    merged = [k for k in ours if k.startswith("model.layers.")]
    assert len(merged) == 18
    in_class = 0
    for k in merged:
        o, j = ours[k].float().numpy(), theirs[k].float().numpy()
        ref = _oracle_fourier_pair(src["base"][k], src["ft1"][k], src["ft2"][k], 0.8, 0.4)
        # the oracle's norms and target are Python floats, the port's f32:
        # a 1-ulp bf16 flip on a few elements (here the f32 decoded input)
        off = o != ref
        assert off.mean() <= 0.01, k
        np.testing.assert_array_less(np.abs(o - ref)[off], np.abs(ref)[off] * 2**-7 + 1e-30, err_msg=k)
        port_vs_jax = np.isclose(o, j, rtol=2e-2, atol=1e-6).mean()
        oracle_vs_jax = np.isclose(ref, j, rtol=2e-2, atol=1e-6).mean()
        assert (port_vs_jax > 0.97) == (oracle_vs_jax > 0.97), k
        in_class += port_vs_jax > 0.97
    assert in_class >= len(merged) - 4
    for k in set(ours) - set(merged):
        assert torch.equal(ours[k], theirs[k]), k


def test_a_packed_checkpoint_with_missing_parts_or_an_unknown_format_is_refused(tmp_path):
    from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex

    make_tiny_model(tmp_path / "base", seed=1)
    bad = tmp_path / "bad"
    bad.mkdir()
    save_file({"model.layers.0.mlp.up_proj.qweight": torch.zeros(2, 24, dtype=torch.int32)},
              bad / "model.safetensors")
    (bad / "config.json").write_text(json.dumps({"quantization_config": {"quant_method": "gptq", "bits": 4}}))
    with pytest.raises(ValueError, match="missing"):
        OfflineMultiModelIndex().add_model(bad)
    (bad / "config.json").write_text(json.dumps({"quantization_config": {"quant_method": "awq", "version": "gemv"}}))
    with pytest.raises(ValueError, match="gemm"):
        OfflineMultiModelIndex().add_model(bad)
    # an adapter whose base is neither registered nor a directory
    ad = tmp_path / "ad"
    ad.mkdir()
    save_file({"base_model.model.model.layers.0.mlp.up_proj.lora_A.weight": torch.zeros(1, 16),
               "base_model.model.model.layers.0.mlp.up_proj.lora_B.weight": torch.zeros(24, 1)},
              ad / "adapter_model.safetensors")
    (ad / "adapter_config.json").write_text(json.dumps({"r": 1, "base_model_name_or_path": str(tmp_path / "no")}))
    with pytest.raises(FileNotFoundError, match="base_model_name_or_path"):
        OfflineMultiModelIndex().add_model(ad)
    with SafeTensorsReader(ad / "adapter_model.safetensors") as r:
        assert len(list(r.keys())) == 2
