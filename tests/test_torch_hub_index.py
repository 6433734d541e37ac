"""The port's Hub index (shardmerge_tpu_torch/io/index.py HFMultiModelIndex,
on threads) against the JAX package's HFMultiModelIndex, both reading one
standard-library localhost "Hub": weight maps, orders and tensors, the
storage reused offline, single-file repos read from their header, GPTQ
(v1, v2, act-order) and AWQ repos decoded, a Hub adapter on an implicit
base, one download per shard under concurrent read-ahead, clean_cache,
and the token on every request type."""

from __future__ import annotations

import asyncio
import json
import random
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from shardmerge_tpu.io.download import DownloadManager as JaxDownloadManager
from shardmerge_tpu.io.index import HFMultiModelIndex as JaxHFIndex
from shardmerge_tpu.io.safetensors_io import save_file as jax_save_file
from shardmerge_tpu_torch.io.download import DownloadManager
from shardmerge_tpu_torch.io.index import HFMultiModelIndex

from .conftest import TINY_SHAPES, TINY_SHARD_MAP, make_tiny_model
from .test_torch_download import TIMEOUT, LocalHub, _no_ambient_hf_auth

UNREACHABLE = "http://127.0.0.1:1"


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a numpy array, as unsigned ints."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy().view(
            {2: np.uint16, 4: np.uint32}[x.element_size()])
    x = np.ascontiguousarray(x)
    return x.view({2: np.uint16, 4: np.uint32}[x.itemsize])


def port_index(storage: Path, endpoint: str, **kw) -> HFMultiModelIndex:
    manager = DownloadManager(storage_path=storage, http_timeout=TIMEOUT, sleep=lambda s: None,
                              clean_cache=kw.pop("clean_cache", False), token=kw.get("token"))
    return HFMultiModelIndex(manager, cache_path=storage.parent / "cache", endpoint=endpoint, timeout=TIMEOUT, **kw)


def jax_tensors(storage: Path, endpoint: str, repo: str, names):
    """The JAX Hub index's weight map, order and tensors of ``repo``."""

    async def main():
        index = JaxHFIndex(download_manager=JaxDownloadManager(storage_path=storage),
                           cache_path=storage.parent / "jcache", endpoint=endpoint)
        await index.add_model(repo)
        got = {n: np.asarray(await index.get_tensor(repo, n).get()) for n in names}
        return index.get_index(repo)["weight_map"], index.get_layer_order(repo), got

    return asyncio.run(main())


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "src"
    return path, make_tiny_model(path, seed=3, dtype="bfloat16")


def test_port_and_jax_index_agree_on_one_hub_and_storage_is_reused(tmp_path, tiny):
    src, _ = tiny
    with LocalHub() as hub:
        hub.serve_dir("org/model", src)
        index = port_index(tmp_path / "st", hub.base)
        index.add_model("org/model")
        wm, order, want = jax_tensors(tmp_path / "jst", hub.base, "org/model", TINY_SHAPES)
        assert index.get_index("org/model")["weight_map"] == wm == TINY_SHARD_MAP
        assert index.get_layer_order("org/model") == order
        assert (tmp_path / "st/org/model/model.safetensors.index.json").exists()
        for name in TINY_SHAPES:
            np.testing.assert_array_equal(bits(index.get_tensor("org/model", name)), bits(want[name]), name)
        index.close()
        # re-added from storage with the endpoint unreachable: no request
        before = dict(hub.hits)
        again = port_index(tmp_path / "st", UNREACHABLE)
        again.add_model("org/model")
        name = "model.layers.1.self_attn.q_proj.weight"
        np.testing.assert_array_equal(bits(again.preload_tensor("org/model", name)), bits(want[name]))
        assert hub.hits == before


def test_single_file_repo_reads_its_header_then_downloads_once(tmp_path, tiny):
    src, tensors = tiny
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, save_file

    single = tmp_path / "single"
    single.mkdir()
    flat = {}
    for shard in sorted(set(TINY_SHARD_MAP.values())):
        with SafeTensorsReader(src / shard) as r:
            flat.update({k: r.get_tensor(k, copy=True) for k in r.keys()})
    save_file(flat, single / "model.safetensors")
    with LocalHub() as hub:
        hub.serve_dir("org/single", single)
        index = port_index(tmp_path / "st", hub.base)
        index.add_model("org/single")
        assert hub.hits_of("model.safetensors") == 1  # the header read only
        wm, order, want = jax_tensors(tmp_path / "jst", hub.base, "org/single", list(flat))
        assert index.get_index("org/single")["weight_map"] == wm
        assert index.get_layer_order("org/single") == order
        for name in flat:
            np.testing.assert_array_equal(bits(index.get_tensor("org/single", name)), bits(want[name]))
        # the port: one header read and one transfer (then the JAX index's two)
        assert hub.hits_of("model.safetensors") == 4
        again = port_index(tmp_path / "st", UNREACHABLE)
        again.add_model("org/single")
        assert torch.equal(again.get_tensor("org/single", "lm_head.weight"), flat["lm_head.weight"])


AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _pack_gptq_rows(q: np.ndarray, bits_: int) -> np.ndarray:
    per = 32 // bits_
    v = q.astype(np.uint32).reshape(q.shape[0] // per, per, -1)
    out = np.zeros((v.shape[0], v.shape[2]), np.uint32)
    for k in range(per):
        out |= v[:, k, :] << np.uint32(bits_ * k)
    return out.view(np.int32)


def _pack_awq_cols(vals: np.ndarray) -> np.ndarray:
    packed = np.zeros((vals.shape[0], vals.shape[1] // 8), np.uint32)
    for k in range(8):
        packed |= vals[:, AWQ_ORDER[k]::8].astype(np.uint32) << np.uint32(4 * k)
    return packed.view(np.int32)


def packed_checkpoint(path: Path, tensors: dict, fmt: str, seed: int, bits_: int = 4, v2: bool = False,
                      group: int = 8, single: bool = False) -> dict:
    """A GPTQ (act-order g_idx) or AWQ checkpoint of the tiny model's
    projections, random packed parts from a seeded generator; the other
    tensors raw. Returns the qweight keys' roots."""
    rng = np.random.default_rng(seed)
    maxq = (1 << bits_) - 1
    out_tensors, roots = {}, []
    for name, t in tensors.items():
        if not name.endswith("proj.weight"):
            out_tensors[name] = np.asarray(t)
            continue
        root = name[: -len(".weight")]
        roots.append(root)
        out_dim, in_dim = t.shape
        groups = in_dim // group
        scales = (rng.standard_normal((groups, out_dim)) * 0.05).astype(np.float16)
        if fmt == "gptq":
            out_tensors[f"{root}.qweight"] = _pack_gptq_rows(rng.integers(0, maxq + 1, (in_dim, out_dim)), bits_)
            out_tensors[f"{root}.qzeros"] = _pack_gptq_rows(rng.integers(0, maxq, (out_dim, groups)), bits_).T.copy()
            out_tensors[f"{root}.scales"] = scales
            out_tensors[f"{root}.g_idx"] = rng.permutation(np.arange(in_dim) // group).astype(np.int32)
        else:
            out_tensors[f"{root}.qweight"] = _pack_awq_cols(rng.integers(0, 16, (in_dim, out_dim)))
            out_tensors[f"{root}.qzeros"] = _pack_awq_cols(rng.integers(0, 16, (groups, out_dim)))
            out_tensors[f"{root}.scales"] = scales
    path.mkdir(parents=True)
    if single:
        jax_save_file(out_tensors, path / "model.safetensors")
    else:
        names = sorted(out_tensors)
        wm = {n: f"model-0000{1 + i % 2}-of-00002.safetensors" for i, n in enumerate(names)}
        for shard in set(wm.values()):
            jax_save_file({n: out_tensors[n] for n in names if wm[n] == shard}, path / shard)
        (path / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": wm}))
    qc = {"quant_method": fmt, "bits": bits_, "group_size": group}
    qc.update({"checkpoint_format": "gptq_v2"} if v2 else {} if fmt == "gptq" else {"zero_point": True, "version": "gemm"})
    (path / "config.json").write_text(json.dumps({"model_type": "llama", "quantization_config": qc}))
    return roots


@pytest.mark.parametrize("fmt,bits_,v2,single", [
    ("gptq", 4, False, False), ("gptq", 8, True, False), ("gptq", 4, True, True), ("awq", 4, False, True),
])
def test_packed_repos_decode_bit_equal_to_jax_with_one_download_per_shard(tmp_path, tiny, fmt, bits_, v2, single):
    _, tensors = tiny
    repo = tmp_path / "repo"
    packed_checkpoint(repo, {k: np.asarray(v) for k, v in _f32(tensors).items()}, fmt, seed=7, bits_=bits_,
                      v2=v2, single=single)
    with LocalHub() as hub:
        hub.serve_dir("org/q", repo)
        index = port_index(tmp_path / "st", hub.base)
        index.add_model("org/q")
        assert index.get_model_keys("org/q") == set(TINY_SHAPES)
        names = sorted(TINY_SHAPES)
        with ThreadPoolExecutor(4) as pool:  # read-ahead workers
            got = dict(zip(names, pool.map(lambda n: index.preload_tensor("org/q", n), names)))
        shard_files = [p.name for p in repo.glob("*.safetensors")]
        # raw parts and passthrough tensors share one transfer per shard
        # (a single-file repo's header read comes first)
        for shard in shard_files:
            assert hub.hits_of(f"resolve/main/{shard}") == 1 + single, hub.hits
        assert index.host_work["decode"][0] == 14
        wm, order, want = jax_tensors(tmp_path / "jst", hub.base, "org/q", names)
        assert index.get_index("org/q")["weight_map"] == wm
        assert index.get_layer_order("org/q") == order
        for name in names:
            assert got[name].dtype == torch.float32
            np.testing.assert_array_equal(bits(got[name]), bits(want[name]), name)
        assert (tmp_path / "st/org/q/config.json").exists()
        again = port_index(tmp_path / "st", UNREACHABLE)
        again.add_model("org/q")
        name = "model.layers.0.mlp.down_proj.weight"
        np.testing.assert_array_equal(bits(again.get_tensor("org/q", name)), bits(want[name]))


def _f32(tensors):
    return {k: np.asarray(v).astype(np.float32) for k, v in tensors.items()}


def test_hub_adapter_on_an_implicit_base_fuses_like_jax(tmp_path, tiny):
    src, tensors = tiny
    target = "model.layers.0.self_attn.q_proj.weight"
    mod = target[: -len(".weight")]
    gen = np.random.default_rng(23)
    a = gen.standard_normal((2, 16)).astype(np.float32)
    b = gen.standard_normal((16, 2)).astype(np.float32)
    adir = tmp_path / "adapter"
    adir.mkdir()
    jax_save_file({f"base_model.model.{mod}.lora_A.weight": a, f"base_model.model.{mod}.lora_B.weight": b},
                  adir / "adapter_model.safetensors")
    (adir / "adapter_config.json").write_text(json.dumps(
        {"r": 2, "lora_alpha": 4, "peft_type": "LORA", "base_model_name_or_path": "org/hubbase"}))
    with LocalHub() as hub:
        hub.serve_dir("org/hubbase", src)
        hub.serve_dir("org/lora", adir)
        index = port_index(tmp_path / "st", hub.base)
        index.add_model("org/lora")
        assert index.get_model_keys("org/lora") == set(TINY_SHAPES)
        assert index._adapters["org/lora"]["evict_base"]
        other = "model.layers.1.mlp.down_proj.weight"
        _, _, want = jax_tensors(tmp_path / "jst", hub.base, "org/lora", [target, other])
        got = index.get_tensor("org/lora", target)
        np.testing.assert_array_equal(bits(got), bits(want[target]))
        assert ("org/hubbase", target) not in index._tensor_cache  # the implicit base is dropped
        np.testing.assert_array_equal(bits(index.get_tensor("org/lora", other)), bits(want[other]))
        assert index.host_work["fuse"][0] == 1
        assert (tmp_path / "st/org/lora/adapter_config.json").exists()
        again = port_index(tmp_path / "st", UNREACHABLE)
        again.add_model("org/lora")
        np.testing.assert_array_equal(bits(again.get_tensor("org/lora", target)), bits(want[target]))
        with pytest.raises(FileNotFoundError, match="neither"):
            index.add_model("org/empty")


def test_concurrent_read_ahead_downloads_each_shard_once_and_clean_cache_empties_it(tmp_path, tiny):
    src, tensors = tiny
    with LocalHub() as hub:
        hub.serve_dir("o/m", src)
        index = port_index(tmp_path / "st", hub.base, clean_cache=True)
        index.add_model("o/m")
        jobs = [n for n in TINY_SHAPES for _ in range(3)]
        random.Random(5).shuffle(jobs)
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda n: (n, index.preload_tensor("o/m", n, pin_memory=False)), jobs))
        for name, t in got:
            np.testing.assert_array_equal(bits(t), bits(tensors[name]))
        for shard in set(TINY_SHARD_MAP.values()):
            assert hub.hits_of(shard) == 1, hub.hits
        # every tensor was copied out: every shard is gone already
        assert not list((tmp_path / "st").rglob("*.safetensors"))
        assert index.download_manager.downloads == {}


def test_token_rides_every_request_type(tmp_path, tiny, monkeypatch):
    _no_ambient_hf_auth(monkeypatch, tmp_path)
    src, tensors = tiny
    with LocalHub() as hub:
        hub.serve_dir("org/gated", src)
        hub.require_token = "sekret"
        with pytest.raises(RuntimeError, match="HF_TOKEN"):
            port_index(tmp_path / "anon", hub.base).add_model("org/gated")
        index = port_index(tmp_path / "st", hub.base, token="sekret")
        index.add_model("org/gated")
        name = "model.layers.1.self_attn.q_proj.weight"
        np.testing.assert_array_equal(bits(index.get_tensor("org/gated", name)), bits(tensors[name]))
        asked = [p for p, n in hub.hits.items() if n and hub.auth[p] is not None]
        assert any("/raw/" in p for p in asked) and any("/resolve/" in p for p in asked)
        assert all(hub.auth[p] == "Bearer sekret" for p in asked)


def test_a_missing_local_path_is_not_taken_for_a_repo(tmp_path):
    index = port_index(tmp_path / "st", UNREACHABLE)
    with pytest.raises(FileNotFoundError, match="filesystem path"):
        index.add_model(str(tmp_path / "typo"))
    assert not (tmp_path / "st").exists() or not list((tmp_path / "st").iterdir())
