"""The port's checkpoint tools and CLI commands (shardmerge_tpu_torch/tools/,
cli.py) against the JAX package's: the counterparts of tests/test_tools.py.
Each tool's files, index JSON and printed report equal the JAX tool's on
the same seeded inputs (extract-lora: its rank-r product B@A, since SVD
factors differ in sign and rotation between libraries), and the port's CLI
has every command of the JAX CLI with its option names."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from shardmerge_tpu.cli import cli as jax_cli
from shardmerge_tpu.tools import convert_pytorch_to_hf as jconvert
from shardmerge_tpu.tools import extract_lora as jextract
from shardmerge_tpu.tools import fuse_lora as jfuse
from shardmerge_tpu.tools import inspect_model as jinspect
from shardmerge_tpu.tools import quantize_checkpoint as jquantize
from shardmerge_tpu.tools import rewrite_reorder as jreorder
from shardmerge_tpu.tools import verify_safetensors as jverify
from shardmerge_tpu_torch.cli import build_parser
from shardmerge_tpu_torch.cli import main as torch_cli
from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, load_file, save_file
from shardmerge_tpu_torch.tools import convert_pytorch_to_hf as tconvert
from shardmerge_tpu_torch.tools import extract_lora as textract
from shardmerge_tpu_torch.tools import fuse_lora as tfuse
from shardmerge_tpu_torch.tools import inspect_model as tinspect
from shardmerge_tpu_torch.tools import quantize_checkpoint as tquantize
from shardmerge_tpu_torch.tools import rewrite_reorder as treorder
from shardmerge_tpu_torch.tools import verify_safetensors as tverify

from .conftest import TINY_SHAPES, TINY_SHARD_MAP, make_tiny_model


def same_tree(a: Path, b: Path, skip=()):
    """Both directories hold the same file names with the same bytes."""
    names_a = sorted(p.name for p in a.iterdir() if p.name not in skip)
    names_b = sorted(p.name for p in b.iterdir() if p.name not in skip)
    assert names_a == names_b
    for name in names_a:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _cfg(tmp_path, base, fts, out, **extra):
    cfg = {
        "output_base_model": str(base),
        "finetune_merge": [{"model": str(f), "base": str(base)} for f in fts],
        "output_dir": str(out),
        "cache_dir": str(tmp_path / "cache"),
        "storage_dir": str(tmp_path / "storage"),
        **extra,
    }
    path = tmp_path / f"{Path(out).name}.json"
    path.write_text(json.dumps(cfg))
    return path


# -- the command set ----------------------------------------------------------

# JAX options the port once refused by name, with the queue item of
# ROADMAP.md section A that ported them: tensor parallelism over launched
# ranks, which with one rank only logs
REFUSED = {
    ("generate", "--shard"): "A.10b",
    ("serve", "--shard"): "A.10b",
}
# options once refused that now reach the engine: speculative decoding and
# the prefix cache (generate --decode-chunk: its own test below)
ACCEPTED = {
    ("generate", "--draft-model"), ("generate", "--speculation-k"), ("serve", "--draft-model"),
    ("serve", "--speculation-k"), ("serve", "--prefix-cache"),
}
# the port's own options: logging on the serving commands, and the card for
# extract-lora's SVDs (the JAX tool runs them in numpy on the host)
EXTRA = {("generate", "--verbose"), ("serve", "--verbose"), ("extract-lora", "--device")}


def _port_commands():
    sub = next(a for a in build_parser()._actions if a.dest == "command")
    out = {}
    for name, p in sub.choices.items():
        opts = {s for a in p._actions for s in a.option_strings if s not in ("-h", "--help")}
        args = [a.dest for a in p._actions if not a.option_strings]
        out[name] = (opts, args)
    return out


def test_the_port_cli_has_every_jax_command_and_option():
    ours = _port_commands()
    assert set(ours) == set(jax_cli.commands) and len(ours) == 12
    for name, cmd in jax_cli.commands.items():
        opts = {s for p in cmd.params if p.param_type_name == "option" for s in p.opts + p.secondary_opts}
        args = [p.name for p in cmd.params if p.param_type_name == "argument"]
        assert ours[name][1] == args, name
        assert opts - ours[name][0] == set(), name
        assert {(name, o) for o in ours[name][0] - opts} <= EXTRA, name
    assert {k for k in REFUSED} | ACCEPTED <= {(n, o) for n, (opts, _) in ours.items() for o in opts}


@pytest.mark.parametrize("command,option", sorted(REFUSED), ids=lambda v: str(v))
def test_unported_options_are_refused_by_name(tmp_path, capsys, monkeypatch, caplog, command, option):
    """``--shard`` (once refused, exit 2) with one rank only logs: generate
    prints the unsharded greedy text; serve answers until interrupted and
    exits 0."""
    import logging

    _hf_llama(tmp_path / "m", seed=31, layers=1)
    if command == "generate":
        argv = ["generate", str(tmp_path / "m"), "hello there", "--max-tokens", "5", "--greedy", "--device", "cpu"]
        assert torch_cli(argv) == 0
        plain = capsys.readouterr().out
        with caplog.at_level(logging.INFO, logger="shardmerge_tpu_torch.parallel.tp"):
            assert torch_cli(argv + [option]) == 0
        assert capsys.readouterr().out == plain and "one rank, nothing to shard" in caplog.text
        return
    from shardmerge_tpu_torch import cli as tcli

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli.time, "sleep", interrupt)
    with caplog.at_level(logging.INFO, logger="shardmerge_tpu_torch.parallel.tp"):
        assert torch_cli(["serve", str(tmp_path / "m"), option, "--device", "cpu", "--port", "0"]) == 0
    assert "Serving" in capsys.readouterr().out and "one rank, nothing to shard" in caplog.text


@pytest.mark.parametrize("command,option", sorted(ACCEPTED), ids=lambda v: str(v))
def test_speculation_and_prefix_cache_options_reach_the_engine(tmp_path, capsys, monkeypatch, command, option):
    """``generate`` and ``serve`` take the options on the CPU: the engine
    the command builds holds the draft, k and prefix-cache slots asked for,
    and its greedy output (self-draft) equals the plain command's."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    from shardmerge_tpu_torch import cli as tcli
    from shardmerge_tpu_torch.inference import InferenceEngine

    from .test_torch_engine import _save_tiny_checkpoint

    model = tmp_path / "m"
    _save_tiny_checkpoint(model)
    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(128)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(model / "tokenizer.json"))
    # the tokenizer's class (else transformers takes config.json's llama)
    (model / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "PreTrainedTokenizerFast"}))
    built = []
    real = InferenceEngine.from_pretrained.__func__

    def recording(cls, *a, **kw):
        built.append(real(cls, *a, **kw))
        return built[-1]

    monkeypatch.setattr(InferenceEngine, "from_pretrained", classmethod(recording))
    value = {"--draft-model": [str(model)], "--speculation-k": ["3"], "--prefix-cache": ["2"]}[option]
    if option == "--speculation-k":
        value += ["--draft-model", str(model)]
    if command == "generate":
        base = ["generate", str(model), "w3 w5 w7", "--max-tokens", "6", "--greedy", "--device", "cpu"]
        assert torch_cli(base) == 0
        plain = capsys.readouterr().out
        assert torch_cli(base + [option, *value]) == 0
        assert capsys.readouterr().out == plain
    else:
        def stop_serving(_):
            raise KeyboardInterrupt

        monkeypatch.setattr(tcli.time, "sleep", stop_serving)
        assert torch_cli(["serve", str(model), "--port", "0", "--device", "cpu", option, *value]) == 0
    engine = built[-1]
    if option == "--prefix-cache":
        assert engine.prefix_cache_slots == 2 and engine.draft_model is None
    else:
        assert engine.draft_model is not None and engine.draft_cfg.vocab_size == engine.cfg.vocab_size
        assert engine.speculation_k == (3 if option == "--speculation-k" else 4)


# -- verify-safetensors ---------------------------------------------------------


def test_verify_clean_model(tiny_model_factory):
    path, _ = tiny_model_factory("m", seed=1)
    index = json.loads((path / "model.safetensors.index.json").read_text())
    report = tverify.audit_alignment(index["weight_map"], tverify.scan_shard_keys(path))
    assert report.clean and report.keys_checked == len(index["weight_map"])
    want = jverify.audit_alignment(index["weight_map"], jverify.scan_shard_keys(path))
    assert report.render() == want.render() and "agree" in report.render()


def test_verify_detects_and_repairs_like_jax(tiny_model_factory, tmp_path):
    path, _ = tiny_model_factory("m", seed=2)
    index_path = path / "model.safetensors.index.json"
    index = json.loads(index_path.read_text())
    index["weight_map"]["model.norm.weight"] = "model-00009-of-00009.safetensors"
    index_path.write_text(json.dumps(index))
    shard_keys = tverify.scan_shard_keys(path)
    report = tverify.audit_alignment(index["weight_map"], shard_keys)
    assert not report.clean and "model-00009-of-00009.safetensors" in report.phantom_shards
    assert any("model.norm.weight" in d.unlisted for d in report.drift)
    assert report.render() == jverify.audit_alignment(index["weight_map"], jverify.scan_shard_keys(path)).render()
    jpath = tmp_path / "jindex.json"
    jpath.write_text(index_path.read_text())
    backup = tverify.rebuild_index(shard_keys, index_path, index.get("metadata"))
    jverify.rebuild_index(jverify.scan_shard_keys(path), jpath, index.get("metadata"))
    assert backup.exists() and index_path.read_bytes() == jpath.read_bytes()
    assert tverify.audit_alignment(json.loads(index_path.read_text())["weight_map"], shard_keys).clean


def test_cli_verify_command(tiny_model_factory, capsys):
    path, _ = tiny_model_factory("m", seed=5)
    assert torch_cli(["verify-safetensors", "--model_dir", str(path)]) == 0
    assert "agree" in capsys.readouterr().out
    (path / "model-00001-of-00003.safetensors").unlink()
    assert torch_cli(["verify-safetensors", "--model_dir", str(path)]) == 1
    assert torch_cli(["verify-safetensors", "--model_dir", str(path), "--repair"]) == 0
    assert "rebuilt" in capsys.readouterr().out


# -- rewrite-reorder, convert-pytorch -------------------------------------------


def test_transformer_sort_key_equals_jax():
    names = list(TINY_SHAPES) + [
        "model.layers.10.mlp.down_proj.weight", "model.layers.2.self_attn.k_proj.weight",
        "layers.3.attention.wq.weight", "tok_embeddings.weight", "output.weight", "norm.weight",
        "model.layers.1.block_sparse_moe.experts.0.w1.weight", "encoder.layer.4.attn.weight", "x",
    ]
    for name in names:
        assert treorder.transformer_sort_key(name) == jreorder.transformer_sort_key(name), name
    ordered = sorted(names, key=treorder.transformer_sort_key)
    assert ordered[0] == "model.embed_tokens.weight"


@pytest.mark.parametrize("num_shards", [None, 2, 5])
def test_reshard_and_reorder_writes_the_jax_files(tmp_path, tiny_model_factory, capsys, num_shards):
    src, tensors = tiny_model_factory("src", seed=3, dtype="bfloat16")
    (src / "config.json").write_text('{"model_type": "llama"}')
    treorder.reshard_and_reorder(src, tmp_path / "ours", num_shards=num_shards)
    ours_out = capsys.readouterr().out
    jreorder.reshard_and_reorder(src, tmp_path / "theirs", num_shards=num_shards)
    assert ours_out == capsys.readouterr().out.replace(str(tmp_path / "theirs"), str(tmp_path / "ours"))
    same_tree(tmp_path / "ours", tmp_path / "theirs")
    keys = list(json.loads((tmp_path / "ours/model.safetensors.index.json").read_text())["weight_map"])
    assert keys == sorted(keys, key=treorder.transformer_sort_key) and set(keys) == set(tensors)


def test_convert_single_bin_writes_the_jax_files(tmp_path):
    torch.manual_seed(0)
    sd = {
        "model.embed_tokens.weight": torch.randn(8, 4),
        "model.layers.0.self_attn.q_proj.weight": torch.randn(4, 4).to(torch.bfloat16),
        "lm_head.weight": torch.randn(8, 4),
    }
    (tmp_path / "bin").mkdir()
    torch.save(sd, tmp_path / "bin" / "pytorch_model.bin")
    tconvert.convert(tmp_path / "bin", tmp_path / "ours", num_shards=2)
    jconvert.convert(tmp_path / "bin", tmp_path / "theirs", num_shards=2)
    same_tree(tmp_path / "ours", tmp_path / "theirs")
    got = {}
    for f in (tmp_path / "ours").glob("*.safetensors"):
        got.update(load_file(f))
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_convert_sharded_bin_writes_the_jax_files(tmp_path):
    torch.manual_seed(1)
    (tmp_path / "bin").mkdir()
    torch.save({"model.embed_tokens.weight": torch.randn(8, 4)}, tmp_path / "bin/pytorch_model-00001-of-00002.bin")
    torch.save({"lm_head.weight": torch.randn(8, 4).bfloat16()}, tmp_path / "bin/pytorch_model-00002-of-00002.bin")
    (tmp_path / "bin/pytorch_model.bin.index.json").write_text(json.dumps({
        "metadata": {"total_size": 256},
        "weight_map": {"model.embed_tokens.weight": "pytorch_model-00001-of-00002.bin",
                       "lm_head.weight": "pytorch_model-00002-of-00002.bin"},
    }))
    assert torch_cli(["convert-pytorch", str(tmp_path / "bin"), str(tmp_path / "ours")]) == 0
    jconvert.convert(tmp_path / "bin", tmp_path / "theirs")
    same_tree(tmp_path / "ours", tmp_path / "theirs")
    index = json.loads((tmp_path / "ours/model.safetensors.index.json").read_text())
    assert index["weight_map"]["model.embed_tokens.weight"] == "model-00001-of-00002.safetensors"


# -- inspect, compare --------------------------------------------------------------


def test_inspect_and_compare_equal_jax(tmp_path, tiny_model_factory, capsys):
    path_a, _ = tiny_model_factory("a", seed=30)
    path_b, _ = tiny_model_factory("bm", seed=31, dtype="bfloat16")
    summary = tinspect.inspect_model(path_b)
    printed = capsys.readouterr().out
    assert summary == jinspect.inspect_model(path_b) and printed == capsys.readouterr().out
    assert summary["tensors"] == len(TINY_SHARD_MAP) and summary["num_layers"] == 2
    assert "bfloat16" in summary["dtypes"]
    for a, b in [(path_a, path_a), (path_a, path_b)]:
        ours = tinspect.compare_models(a, b, top=30)
        printed = capsys.readouterr().out
        assert ours == jinspect.compare_models(a, b, top=30)
        assert printed == capsys.readouterr().out
    stats, _, _ = ours
    assert any(not s["identical"] for s in stats) and stats[0]["max_rel"] >= stats[-1]["max_rel"]


def test_cli_compare_gate_and_inspect(tmp_path, tiny_model_factory, capsys):
    path_a, _ = tiny_model_factory("a2", seed=32)
    path_b, _ = tiny_model_factory("b2", seed=33)
    assert torch_cli(["compare", str(path_a), str(path_a), "--max-rel", "0"]) == 0
    assert torch_cli(["compare", str(path_a), str(path_b), "--max-rel", "1e-6"]) == 1
    assert torch_cli(["inspect", str(path_a)]) == 0 and "tensors:" in capsys.readouterr().out


# -- merge and copy-model commands ---------------------------------------------------


def test_cli_merge_offline_and_write_through(tmp_path, tiny_model_factory, capsys):
    base, _ = tiny_model_factory("base", seed=6)
    ft, _ = tiny_model_factory("ft", seed=7)
    for extra in ([], ["--write-through"]):
        out = tmp_path / f"merged{len(extra)}"
        assert torch_cli(["merge", str(_cfg(tmp_path, base, [ft], out)), "--device", "cpu", *extra]) == 0
        assert (out / "model.safetensors.index.json").exists() and (out / "README.md").exists()
        for shard in set(TINY_SHARD_MAP.values()):
            assert (out / shard).exists()
    capsys.readouterr()
    same = tmp_path / "merged0"
    assert torch_cli(["compare", str(same), str(tmp_path / "merged1"), "--max-rel", "0"]) == 0


def test_cli_merge_bad_config_and_unknown_method(tmp_path, tiny_model_factory, capsys):
    (tmp_path / "bad.json").write_text('{"output_dir": "out"}')
    assert torch_cli(["merge", str(tmp_path / "bad.json"), "--device", "cpu"]) == 2
    base, _ = tiny_model_factory("base", seed=8)
    cfg = _cfg(tmp_path, base, [base], tmp_path / "m")
    assert torch_cli(["merge", str(cfg), "--method", "bogus", "--device", "cpu"]) == 2
    assert "Unknown merge_method 'bogus'" in capsys.readouterr().err


def test_merge_dry_run_prints_the_jax_plan(tmp_path, tiny_model_factory, capsys):
    base, _ = tiny_model_factory("base", seed=400)
    ft, _ = tiny_model_factory("ft", seed=401)
    out = tmp_path / "merged"
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "output_base_model": str(base), "output_dir": str(out),
        "finetune_merge": [{"model": str(ft), "base": str(base), "alpha": 0.9, "start_layer": 1}],
        "cache_dir": str(tmp_path / "cache"), "storage_dir": str(tmp_path / "storage"),
    }))
    assert torch_cli(["merge", str(cfg), "--dry-run", "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    result = CliRunner().invoke(jax_cli, ["merge", str(cfg), "--dry-run", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert "merge plan: fourier of 1 finetunes" in ours and "gates: " in ours
    # the JAX plan's mesh line (8 virtual CPU devices here) has no port
    # counterpart until the mesh merge is ported
    theirs = [line for line in result.output.splitlines() if not line.startswith(("20", "  mesh:"))]
    assert ours.splitlines() == theirs
    assert not out.exists()


def test_cli_merge_profile_and_trace_dir(tmp_path, tiny_model_factory, monkeypatch, caplog):
    import logging

    base, _ = tiny_model_factory("base", seed=9)
    ft, _ = tiny_model_factory("ft", seed=10)
    monkeypatch.delenv("SHARDMERGE_PROFILE", raising=False)
    with caplog.at_level(logging.INFO, logger="shardmerge_tpu_torch.ops.profiling"):
        assert torch_cli(["merge", str(_cfg(tmp_path, base, [ft], tmp_path / "o")), "--device", "cpu",
                          "--profile", "--trace-dir", str(tmp_path / "trace")]) == 0
    assert any("[profile] merge model.layers.0" in r.getMessage() for r in caplog.records)
    assert json.loads((tmp_path / "trace/trace.json").read_text())["traceEvents"]


def test_cli_copy_model(monkeypatch, tmp_path, tiny_model_factory):
    import huggingface_hub

    src, _ = tiny_model_factory("donor", seed=11)
    seen = {}

    def fake_snapshot_download(repo_id, revision, ignore_patterns, local_dir, token=None):
        assert "*.safetensors" in ignore_patterns
        seen.update(repo_id=repo_id, revision=revision)
        (Path(local_dir) / "model.safetensors.index.json").write_bytes(
            (src / "model.safetensors.index.json").read_bytes())

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake_snapshot_download)
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"output_base_model": "org/base", "output_dir": str(tmp_path / "copied"),
                               "finetune_merge": [{"model": "org/ft", "base": "org/base"}]}))
    assert torch_cli(["copy-model", str(cfg), "--revision", "v2"]) == 0
    assert seen == {"repo_id": "org/base", "revision": "v2"}
    assert (tmp_path / "copied/model.safetensors.index.json").exists()


# -- generate ---------------------------------------------------------------------------


def test_cli_generate_wires_its_options(monkeypatch, tmp_path, capsys):
    import shardmerge_tpu_torch.inference as inf

    calls = {}

    class FakeEngine:
        follower = False  # rank 0 (or the only rank) of a tensor-parallel engine

        @classmethod
        def from_pretrained(cls, path, load_in_4bit=False, load_in_8bit=False, device=None, draft_model=None,
                            speculation_k=4, shard=False):
            calls["init"] = (str(path), load_in_4bit, load_in_8bit, str(device))
            calls["draft"] = (draft_model, speculation_k)
            calls["shard"] = shard
            return cls()

        def stream_generation(self, **kw):
            calls["gen"] = kw
            yield "hello"
            yield " world"

        def stop(self):
            calls["stopped"] = True

    monkeypatch.setattr(inf, "InferenceEngine", FakeEngine)
    (tmp_path / "model").mkdir()
    assert torch_cli(["generate", str(tmp_path / "model"), "hi there", "--max-tokens", "7", "--temperature",
                      "0.5", "-4", "--greedy", "--decode-chunk", "1", "--device", "cpu"]) == 0
    assert "hello world" in capsys.readouterr().out
    assert calls["init"] == (str(tmp_path / "model"), True, False, "cpu")
    assert calls["draft"] == (None, 4)
    assert calls["shard"] is False and calls["stopped"] is True
    assert calls["gen"]["max_new_tokens"] == 7 and calls["gen"]["temperature"] == 0.5
    assert calls["gen"]["greedy"] is True
    assert torch_cli(["generate", str(tmp_path / "model"), "x", "--no-greedy", "--device", "cpu"]) == 0
    assert calls["gen"]["greedy"] is False


def _hf_llama(model_dir: Path, seed: int, layers: int):
    """A tiny Llama checkpoint in the HF layout (config.json, seeded random
    weights in model.safetensors) with a word-level tokenizer.json, as the
    JAX tests fabricate one."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers

    cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128, "hidden_size": 32,
           "intermediate_size": 64, "num_hidden_layers": layers, "num_attention_heads": 2,
           "num_key_value_heads": 2, "max_position_embeddings": 512, "rms_norm_eps": 1e-6,
           "rope_theta": 10000.0, "tie_word_embeddings": False}
    gen = torch.Generator().manual_seed(seed)
    shapes = {"model.embed_tokens.weight": (128, 32), "model.norm.weight": (32,), "lm_head.weight": (128, 32)}
    for i in range(layers):
        for name, shape in [("self_attn.q_proj", (32, 32)), ("self_attn.k_proj", (32, 32)),
                            ("self_attn.v_proj", (32, 32)), ("self_attn.o_proj", (32, 32)),
                            ("mlp.gate_proj", (64, 32)), ("mlp.up_proj", (64, 32)), ("mlp.down_proj", (32, 64)),
                            ("input_layernorm", (32,)), ("post_attention_layernorm", (32,))]:
            shapes[f"model.layers.{i}.{name}.weight"] = shape
    tensors = {k: (torch.randn(s, generator=gen) * (0.02 if len(s) == 2 else 0.0) + (len(s) == 1)).float()
               for k, s in shapes.items()}
    model_dir.mkdir(parents=True)
    save_file(tensors, model_dir / "model.safetensors")
    (model_dir / "config.json").write_text(json.dumps(cfg))
    vocab = {f"tok{i}": i for i in range(120)}
    vocab.update({"<unk>": 120, "hello": 121, "there": 122})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(model_dir / "tokenizer.json"))
    (model_dir / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>", "eos_token": "tok0"}))


def test_cli_generate_end_to_end_real_tokenizer(tmp_path, capsys):
    _hf_llama(tmp_path / "m", seed=13, layers=1)
    assert torch_cli(["generate", str(tmp_path / "m"), "hello there", "--max-tokens", "6", "--greedy",
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip()


@pytest.mark.parametrize("chunk", ["4", "5"])
def test_generate_decode_chunk_gives_the_tokens_of_single_steps(tmp_path, capsys, chunk):
    """generate --decode-chunk S (once refused) runs S decode steps a call
    and prints the tokens of S = 1, a budget that S does not divide too."""
    _hf_llama(tmp_path / "m", seed=17, layers=1)
    (tmp_path / "m/tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>"}))  # no EOS: the whole budget
    argv = ["generate", str(tmp_path / "m"), "hello there", "--max-tokens", "9", "--greedy", "--device", "cpu"]
    assert torch_cli(argv) == 0
    single = capsys.readouterr().out
    assert torch_cli(argv + ["--decode-chunk", chunk]) == 0
    assert capsys.readouterr().out == single and len(single.split()) == 9


def test_generate_serves_the_quantized_artifact(tmp_path):
    """generate on the GPTQ-v2 artifact gives the greedy text of the bf16
    checkpoint quantized at load (the same int grid; only the fp16 scales
    differ)."""
    from shardmerge_tpu_torch.inference import InferenceEngine

    _hf_llama(tmp_path / "m", seed=23, layers=2)
    tquantize.quantize_checkpoint(tmp_path / "m", tmp_path / "m-int4", bits=4)
    assert (tmp_path / "m-int4/tokenizer.json").exists()

    def gen(path, **kw):
        eng = InferenceEngine.from_pretrained(path, device="cpu", **kw)
        return "".join(eng.stream_generation("hello there tok3", max_new_tokens=6, greedy=True, use_template=False))

    assert gen(tmp_path / "m-int4") == gen(tmp_path / "m", load_in_4bit=True)


# -- fuse-lora, extract-lora -------------------------------------------------------------


def _adapter(path: Path, tensors, targets, r, alpha, seed, base_ref=None):
    gen = np.random.default_rng(seed)
    aw = {}
    for t in targets:
        out_dim, in_dim = tensors[t].shape
        mod = t[: -len(".weight")]
        aw[f"base_model.model.{mod}.lora_A.weight"] = torch.from_numpy(gen.standard_normal((r, in_dim)).astype(np.float32))
        aw[f"base_model.model.{mod}.lora_B.weight"] = torch.from_numpy(gen.standard_normal((out_dim, r)).astype(np.float32))
    path.mkdir()
    save_file(aw, path / "adapter_model.safetensors")
    cfg = {"r": r, "lora_alpha": alpha, "peft_type": "LORA"}
    if base_ref is not None:
        cfg["base_model_name_or_path"] = str(base_ref)
    (path / "adapter_config.json").write_text(json.dumps(cfg))
    return aw


def test_fuse_lora_writes_the_jax_files(tmp_path):
    base = tmp_path / "base"
    tensors = make_tiny_model(base, seed=5)
    targets = ["model.layers.0.self_attn.q_proj.weight", "model.layers.1.self_attn.q_proj.weight",
               "model.layers.0.mlp.down_proj.weight"]
    _adapter(tmp_path / "adapter", tensors, targets, r=2, alpha=8, seed=9)
    summary = tfuse.fuse_lora(base, tmp_path / "adapter", tmp_path / "ours")
    assert summary == jfuse.fuse_lora(base, tmp_path / "adapter", tmp_path / "theirs") == {
        "fused_tensors": 3, "scale": 4.0, "shards": 3}
    same_tree(tmp_path / "ours", tmp_path / "theirs")
    assert tfuse.fuse_lora(base, tmp_path / "adapter", tmp_path / "zero", scale=0.0)["scale"] == 0.0
    with SafeTensorsReader(tmp_path / "zero" / TINY_SHARD_MAP[targets[0]]) as r:
        np.testing.assert_array_equal(r.get_tensor(targets[0]).numpy(), tensors[targets[0]])

    bad = tmp_path / "bad"
    bad.mkdir()
    save_file({"base_model.model.model.layers.9.self_attn.q_proj.lora_A.weight": torch.zeros(2, 16),
               "base_model.model.model.layers.9.self_attn.q_proj.lora_B.weight": torch.zeros(16, 2)},
              bad / "adapter_model.safetensors")
    (bad / "adapter_config.json").write_text(json.dumps({"r": 2, "lora_alpha": 4}))
    with pytest.raises(tfuse.LoraFormatError, match="absent from the base"):
        tfuse.fuse_lora(base, bad, tmp_path / "nope")
    half = tmp_path / "half"
    half.mkdir()
    save_file({"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": torch.zeros(2, 16)},
              half / "adapter_model.safetensors")
    (half / "adapter_config.json").write_text(json.dumps({"r": 2, "lora_alpha": 4}))
    with pytest.raises(tfuse.LoraFormatError, match="incomplete"):
        tfuse.fuse_lora(base, half, tmp_path / "nope2")
    (half / "adapter_config.json").write_text(json.dumps({"r": 4, "lora_alpha": 4, "use_rslora": True}))
    assert jfuse.load_adapter(bad)[1] == tfuse.load_adapter(bad)[1] == 2.0


def test_cli_fuse_lora_command(tmp_path, capsys):
    base = tmp_path / "b"
    tensors = make_tiny_model(base, seed=6)
    _adapter(tmp_path / "a", tensors, ["model.layers.0.self_attn.q_proj.weight"], r=1, alpha=1, seed=1)
    assert torch_cli(["fuse-lora", str(base), str(tmp_path / "a"), str(tmp_path / "o"), "--device", "cpu"]) == 0
    assert "Fused 1 tensors at scale 1 across 3 shard(s)" in capsys.readouterr().out


def _products(adapter: Path):
    """module -> B@A of an adapter directory, in float64."""
    out = {}
    with SafeTensorsReader(adapter / "adapter_model.safetensors") as r:
        for key in r.keys():
            if ".lora_A." in key:
                mod = key.split(".lora_A.")[0]
                a = r.get_tensor(key).double()
                b = r.get_tensor(key.replace(".lora_A.", ".lora_B.")).double()
                out[mod] = (b @ a).numpy()
    return out


@pytest.mark.parametrize("rank,targets", [(16, None), (2, ("q_proj", "down_proj"))])
def test_extract_lora_product_and_capture_match_jax(tmp_path, rank, targets):
    """The rank-r product B@A of every targeted delta (relL2 1e-5) and its
    captured energy (1e-5) equal the JAX tool's; the adapter config is the
    JAX tool's byte for byte; at full rank fusing it back reproduces the
    finetune."""
    base, ft = tmp_path / "base", tmp_path / "ft"
    base_t = make_tiny_model(base, seed=40 + rank)
    ft_t = make_tiny_model(ft, seed=41 + rank)
    ours = textract.extract_lora(base, ft, tmp_path / "ours", rank=rank, target_modules=targets)
    theirs = jextract.extract_lora(base, ft, tmp_path / "theirs", rank=rank, target_modules=targets)
    assert ours["tensors"] == theirs["tensors"] == (14 if targets is None else 4)
    assert ours["capture"].keys() == theirs["capture"].keys()
    for k in ours["capture"]:
        assert ours["capture"][k] == pytest.approx(theirs["capture"][k], rel=1e-5)
    assert (tmp_path / "ours/adapter_config.json").read_bytes() == (tmp_path / "theirs/adapter_config.json").read_bytes()
    po, pt = _products(tmp_path / "ours"), _products(tmp_path / "theirs")
    assert po.keys() == pt.keys()
    for mod in po:
        assert np.linalg.norm(po[mod] - pt[mod]) <= 1e-5 * np.linalg.norm(pt[mod]), mod
    if targets is None:
        assert ours["capture_min"] > 0.999999
        tfuse.fuse_lora(base, tmp_path / "ours", tmp_path / "fused")
        for shard in set(TINY_SHARD_MAP.values()):
            for key, got in load_file(tmp_path / "fused" / shard).items():
                want = ft_t[key] if key.endswith("proj.weight") else base_t[key]
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=key)


def test_extract_lora_suffix_matching_is_component_anchored():
    from shardmerge_tpu_torch.constants import LORA_TARGET_PROJECTIONS
    from shardmerge_tpu.constants import LORA_TARGET_PROJECTIONS as JAX_TARGETS

    t = LORA_TARGET_PROJECTIONS
    assert t == JAX_TARGETS
    for module, suffixes in [("model.layers.0.self_attn.q_proj", t), ("model.layers.3.mlp.down_proj", t),
                             ("model.layers.0.self_attn.qkv_proj", t), ("model.layers.0.mlp.gate_up_proj", t),
                             ("model.layers.0.self_attn.qkv_proj", ("qkv_proj",))]:
        assert textract._matches_target(module, suffixes) == jextract._matches_target(module, suffixes)
    assert not textract._matches_target("model.layers.0.self_attn.qkv_proj", t)


def test_extract_lora_validation_and_cli(tmp_path, capsys):
    base, ft = tmp_path / "base", tmp_path / "ft"
    make_tiny_model(base, seed=44)
    make_tiny_model(ft, seed=45)
    with pytest.raises(textract.LoraExtractError, match="matched"):
        textract.extract_lora(base, ft, tmp_path / "x", target_modules=("nope",))
    with pytest.raises(textract.LoraExtractError, match="rank"):
        textract.extract_lora(base, ft, tmp_path / "x", rank=0)
    assert torch_cli(["extract-lora", str(base), str(ft), str(tmp_path / "ad"), "--rank", "4",
                      "--target", "q_proj", "--device", "cpu"]) == 0
    assert "rank-4 adapter: 2 tensor pairs" in capsys.readouterr().out
    assert (tmp_path / "ad/adapter_model.safetensors").is_file()


# -- quantize, merge --output-quant -----------------------------------------------------


@pytest.mark.parametrize("bits_", [4, 8])
def test_quantize_checkpoint_writes_the_jax_artifact(tmp_path, tiny_model_factory, bits_):
    src, tensors = tiny_model_factory("qsrc", seed=31, dtype="bfloat16")
    (src / "tokenizer.json").write_text("{}")
    ours = tquantize.quantize_checkpoint(src, tmp_path / "ours", bits=bits_)
    theirs = jquantize.quantize_checkpoint(src, tmp_path / "theirs", bits=bits_)
    assert ours == theirs and ours["tensors_quantized"] == 14
    assert ours["worst_roundtrip_relL2_vs_serving_quant"] < 2e-3
    same_tree(tmp_path / "ours", tmp_path / "theirs")
    qc = json.loads((tmp_path / "ours/config.json").read_text())["quantization_config"]
    assert qc["checkpoint_format"] == "gptq_v2" and qc["bits"] == bits_


def test_cli_quantize_command_prints_the_report(tmp_path, tiny_model_factory, capsys):
    src, _ = tiny_model_factory("q", seed=3)
    assert torch_cli(["quantize", str(src), str(tmp_path / "out"), "--bits", "8", "--no-check"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["bits"] == 8 and "worst_roundtrip_relL2_vs_serving_quant" not in report


def test_cli_merge_output_quant_artifact_registers_as_a_merge_input(tmp_path, tiny_model_factory, capsys):
    from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex
    from shardmerge_tpu_torch.models.quant import dequant, quantize

    base, _ = tiny_model_factory("base", seed=33)
    ft, _ = tiny_model_factory("ft", seed=34)
    assert torch_cli(["merge", str(_cfg(tmp_path, base, [ft], tmp_path / "merged")), "--device", "cpu",
                      "--output-quant", "int4"]) == 0
    out = capsys.readouterr().out
    art = tmp_path / "merged-int4"
    assert "quantized artifact" in out and json.loads(out.strip().splitlines()[-1])["output_quant"] == str(art)
    index = OfflineMultiModelIndex()
    index.add_model(art)
    index.add_model(tmp_path / "merged")
    name = "model.layers.1.self_attn.q_proj.weight"
    assert name in index.get_model_keys(str(art))
    got = index.get_tensor(str(art), name)
    want = dequant(quantize(index.get_tensor(str(tmp_path / "merged"), name), 4), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2, atol=2e-3)


def test_get_device_names_the_device_torch_sees(monkeypatch):
    from shardmerge_tpu_torch.backend import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert get_device() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert get_device() == "gpu"
