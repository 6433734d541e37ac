"""Port vs JAX: the port's ``merge`` CLI on four gloo ranks (after
tests/test_multihost.py).

One launch of four processes with torchrun's rendezvous variables; each rank
runs the port's CLI three times in process: the merge of base + 2 finetunes
of ``tests/conftest.make_tiny_model`` (plus an 18-row tensor, whose rows do
not divide 4) with every 2-D tensor split over the ranks and the write-back
gathered in blocks of 256 bytes; the same merge again (a resume); and a
merge onto an output base holding an Inf in rank 2's rows, which every rank
must refuse at that tensor. The first output is held to JAX's in-process
FourierMerge over a 4-device mesh, with JAX's own multi-process bound (more
than 94% of elements within 2e-2). The 1-D tensors never shard: every rank
merges them on the exact double-FFT path, whose NaN cascade is FFT-library
dependent (ROADMAP section C); a tensor where the port's single-device
merge also leaves JAX's bound is held to the port's single-device merge,
bit for bit when unsharded.

A second launch runs two ranks of one host on the same models served by a
Hub on localhost, from one storage directory: local rank 0 downloads each
shard once and the other rank waits for it; the output agrees with the
four ranks' local-input merge; and ``--clean_cache`` is refused by name on
every rank.

    python -m pytest tests/test_torch_multihost.py -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

RANKS = 4
ODD = "model.layers.0.self_attn.odd_proj.weight"  # 18 rows: padded to 20
PLANTED = "model.layers.1.self_attn.q_proj.weight"  # 16 rows: rank 2 holds rows 8-11
GATHER_BLOCK = 256  # bytes: 2 bf16 rows of 16 from each of the 4 ranks


def _models(root: Path):
    """base, ft1, ft2 and base_inf (the base with an Inf at row 9 of
    PLANTED), each the tiny model plus ODD in its first shard."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file, save_file

    from .conftest import TINY_SHARD_MAP, make_tiny_model

    shard = TINY_SHARD_MAP["model.layers.0.self_attn.q_proj.weight"]
    for name, seed in (("base", 1), ("ft1", 2), ("ft2", 3), ("base_inf", 1)):
        path = root / name
        make_tiny_model(path, seed=seed)
        tensors = load_file(path / shard)
        gen = np.random.default_rng(100 + seed)
        import torch

        tensors[ODD] = torch.from_numpy(gen.standard_normal((18, 16)).astype(np.float32))
        save_file(tensors, path / shard, metadata={"format": "pt"})
        index = json.loads((path / "model.safetensors.index.json").read_text())
        index["weight_map"][ODD] = shard
        index["metadata"]["total_size"] += 18 * 16 * 4
        (path / "model.safetensors.index.json").write_text(json.dumps(index))
        if name == "base_inf":
            planted_shard = path / TINY_SHARD_MAP[PLANTED]
            tensors = load_file(planted_shard)
            tensors[PLANTED][9, 3] = float("inf")
            save_file(tensors, planted_shard, metadata={"format": "pt"})


def _config(root: Path, out: str, base: str = "base") -> dict:
    return {
        "output_base_model": str(root / base),
        "finetune_merge": [
            {"model": str(root / "ft1"), "base": str(root / "base"), "alpha": 0.8},
            {"model": str(root / "ft2"), "base": str(root / "base"), "alpha": 0.4},
        ],
        "output_dir": str(root / out),
        "cache_dir": str(root / "cache"),
        "storage_dir": str(root / "storage"),
        "shard_min_bytes": 256,  # every 2-D tensor (the smallest: 8 x 16 f32, 512 bytes)
    }


def _rank_body(root: Path) -> int:
    """merge, resume, then the planted Inf; exits with the last's code."""
    from shardmerge_tpu_torch.cli import main

    for name in ("merge.json", "merge.json"):
        if main(["merge", str(root / name), "--device", "cpu"]) != 0:
            return 99
        sys.stdout.flush()
    return main(["merge", str(root / "inf.json"), "--device", "cpu"])


def _hub_rank_body(root: Path) -> int:
    """The Hub merge, then the same with --clean_cache (refused); exits
    with the last's code."""
    from shardmerge_tpu_torch.cli import main

    if main(["merge", str(root / "hub.json"), "--device", "cpu"]) != 0:
        return 99
    sys.stdout.flush()
    return main(["merge", str(root / "hub.json"), "--device", "cpu", "--clean_cache"])


def _read(path: Path) -> dict:
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    out = {}
    for f in sorted(path.glob("*.safetensors")):
        out.update({k: v.float().numpy() for k, v in load_file(f).items()})
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from .torch_ranks import launch

    root = tmp_path_factory.mktemp("ranks")
    _models(root)
    (root / "merge.json").write_text(json.dumps(_config(root, "merged")))
    (root / "inf.json").write_text(json.dumps(_config(root, "merged_inf", base="base_inf")))
    results = launch([str(Path(__file__).resolve()), str(root)], RANKS, root / "logs",
                     env={"SHARDMERGE_GATHER_BLOCK_BYTES": str(GATHER_BLOCK)})
    return root, results


@pytest.fixture(scope="module")
def hub_ranks(cluster):
    """Two ranks merge base + 2 finetunes served as Hub repos org/<name>;
    returns (root, each rank's results, the Hub's requests per path)."""
    from .test_torch_download import LocalHub
    from .torch_ranks import launch

    root, _ = cluster
    cfg = _config(root, "merged_hub")
    cfg.update(output_base_model="org/base", storage_dir=str(root / "hub_storage"),
               cache_dir=str(root / "hub_cache"),
               finetune_merge=[{**m, "model": f"org/{Path(m['model']).name}", "base": "org/base"}
                               for m in cfg["finetune_merge"]])
    (root / "hub.json").write_text(json.dumps(cfg))
    with LocalHub() as hub:
        for name in ("base", "ft1", "ft2"):
            hub.serve_dir(f"org/{name}", root / name)
        results = launch([str(Path(__file__).resolve()), str(root), "hub"], 2, root / "hub_logs",
                         env={"HF_ENDPOINT": hub.base, "HF_TOKEN": "", "HUGGING_FACE_HUB_TOKEN": "",
                              "HF_HOME": str(root / "hf_home")})
        hits = dict(hub.hits)
    return root, results, hits


def _jax_merge(root: Path, out: Path) -> dict:
    """JAX's FourierMerge over a 4-device mesh on the same config."""
    import asyncio

    import jax

    from shardmerge_tpu.config import MergeConfig, MergeModel
    from shardmerge_tpu.io.index import OfflineMultiModelIndex
    from shardmerge_tpu.merge import FourierMerge
    from shardmerge_tpu.parallel.mesh import make_mesh

    cfg = _config(root, "unused")
    config = MergeConfig(finetune_merge=[MergeModel(**m) for m in cfg["finetune_merge"]],
                         output_base_model=cfg["output_base_model"], output_dir=str(out),
                         cache_dir=cfg["cache_dir"], storage_dir=cfg["storage_dir"])
    index = OfflineMultiModelIndex()
    for name in ("base", "ft1", "ft2"):
        index.add_model(root / name)
    merger = FourierMerge(config, index_manager=index, mesh=make_mesh(("x",), devices=jax.devices()[:RANKS]),
                          shard_min_bytes=cfg["shard_min_bytes"])
    asyncio.run(merger.merge())
    return _read(out)


def _json_lines(stdout: str):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_every_rank_merges_and_resumes(cluster):
    """Each rank joined the group, split every 2-D tensor, printed its
    counters, and merged 0 tensors on the resume."""
    root, results = cluster
    for rank, (rc, out, err) in enumerate(results):
        assert rc is not None, f"rank {rank} hung:\n{err[-3000:]}"
        assert rc != 99, f"rank {rank} failed a merge:\n{err[-3000:]}"
        assert f"distributed runtime up: rank {rank}/{RANKS} over gloo" in err
        first, again = _json_lines(out)
        assert first["tensors_merged"] == 22 and again["tensors_merged"] == 0
        assert first["tensors_passthrough"] == 3
        # 15 2-D merged tensors (7 projections a layer and ODD), each
        # fetched from base, ft1 and ft2 (ft1's and ft2's base is the base)
        assert first["tensors_sharded"] == 15 * 3, first


def test_only_rank_0_writes_and_the_index_mirrors_the_base(cluster):
    root, results = cluster
    out = root / "merged"
    for rank, (_, _, err) in enumerate(results):
        assert ("Wrote shard" in err) == (rank == 0), rank
    assert (out / "README.md").exists()
    index = json.loads((out / "model.safetensors.index.json").read_text())
    base = json.loads((root / "base" / "model.safetensors.index.json").read_text())
    assert index == base
    merged = _read(out)
    assert set(merged) == set(index["weight_map"])
    assert merged[ODD].shape == (18, 16)
    assert all(np.isfinite(v).all() for v in merged.values())


def _agree(got, want) -> float:
    scale = max(np.abs(want).max(), 1e-6)
    return float(np.isclose(got, want, rtol=2e-2, atol=2e-2 * scale).mean())


def test_output_matches_jax_4_device_mesh(cluster, tmp_path):
    from shardmerge_tpu_torch.cli import main

    root, _ = cluster
    ours, theirs = _read(root / "merged"), _jax_merge(root, tmp_path / "jax")
    single_cfg = tmp_path / "single.json"
    single_cfg.write_text(json.dumps({**_config(root, "unused"), "output_dir": str(tmp_path / "single")}))
    assert main(["merge", str(single_cfg), "--device", "cpu"]) == 0
    single = _read(tmp_path / "single")
    assert set(ours) == set(theirs) == set(single)
    cascades = []
    for name, want in theirs.items():
        got = ours[name]
        assert got.shape == want.shape, name
        if _agree(got, want) > 0.94:
            continue
        # the library-dependent cascade: the port's own single device shows it
        assert _agree(single[name], want) <= 0.94 and got.ndim == 1, name
        np.testing.assert_array_equal(got, single[name], err_msg=name)
        cascades.append(name)
    assert len(cascades) < len(theirs) // 4, cascades


def test_planted_inf_stops_every_rank_at_that_tensor(cluster):
    """The Inf lives in rank 2's rows only; the all-reduced flag makes every
    rank raise at that tensor (none hangs), and its shard is never written."""
    from .conftest import TINY_SHARD_MAP

    root, results = cluster
    for rank, (rc, _, err) in enumerate(results):
        assert rc == 2, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        assert f"error: Inf in merged tensor for {PLANTED}" in err, rank
    assert not (root / "merged_inf" / TINY_SHARD_MAP[PLANTED]).exists()


def test_two_ranks_of_a_host_download_each_hub_shard_once(hub_ranks):
    """Local rank 0 fetched every shard (one request each) and rank 1 none;
    both merged every tensor, rank 0 alone wrote, the output agrees with
    the four ranks' local-input merge, and --clean_cache was refused by
    name on both ranks (no rank deletes a shard another still reads)."""
    from .conftest import TINY_SHARD_MAP

    root, results, hits = hub_ranks
    for rank, (rc, out, err) in enumerate(results):
        assert rc is not None, f"rank {rank} hung:\n{err[-3000:]}"
        assert rc != 99, f"rank {rank} failed the Hub merge:\n{err[-3000:]}"
        assert rc == 2 and "clean_cache is not supported with several merge ranks" in err, err[-3000:]
        stats = _json_lines(out)[0]
        assert stats["tensors_merged"] == 22
        assert (stats["downloads"]["bytes"] > 0) == (rank == 0), stats["downloads"]
        assert ("Wrote shard" in err) == (rank == 0), rank
    shards = {path: n for path, n in hits.items() if path.endswith(".safetensors")}
    assert all(n == 1 for n in shards.values()), shards
    # every shard of the base; a finetune's shard of passthrough tensors only is never read
    assert {f"/org/base/resolve/main/{shard}" for shard in TINY_SHARD_MAP.values()} <= set(shards)
    ours, local = _read(root / "merged_hub"), _read(root / "merged")
    assert set(ours) == set(local)
    for name, want in local.items():
        assert _agree(ours[name], want) > 0.94, name


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    body = _hub_rank_body if sys.argv[2:] == ["hub"] else _rank_body
    sys.exit(body(Path(sys.argv[1])))
