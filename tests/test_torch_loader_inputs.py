"""generate from the new checkpoint inputs (shardmerge_tpu_torch/models/
loader.py): a PEFT adapter directory, a GPTQ (v1, act-order) and an AWQ
checkpoint load into the same weights as the JAX loader's and give the JAX
engine's greedy tokens on a tiny Llama; an adapter directory generates
what its fuse-lora'd directory generates."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.io.safetensors_io import save_file as jax_save_file
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models.loader import load_params, resolve_checkpoint_dir
from shardmerge_tpu_torch.tools.fuse_lora import fuse_lora

from .test_torch_engine import HF_CONFIG, PROJ, StubTokenizer, _save_tiny_checkpoint
from .test_torch_hub_index import _pack_awq_cols, _pack_gptq_rows

PROMPTS = ["hello there", "a", "the quick brown fox jumps"]


def _adapter(path, base, seed, r=4):
    gen = np.random.default_rng(seed)
    tensors = {}
    for i in range(HF_CONFIG["num_hidden_layers"]):
        for name, (out_dim, in_dim) in [("self_attn.q_proj", (64, 64)), ("mlp.down_proj", (64, 128))]:
            mod = f"base_model.model.model.layers.{i}.{name}"
            tensors[f"{mod}.lora_A.weight"] = (gen.standard_normal((r, in_dim)) * 0.1).astype(np.float32)
            tensors[f"{mod}.lora_B.weight"] = (gen.standard_normal((out_dim, r)) * 0.1).astype(np.float32)
    path.mkdir()
    jax_save_file(tensors, path / "adapter_model.safetensors")
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": 2 * r, "peft_type": "LORA", "base_model_name_or_path": str(base)}))


def _packed(path, base_params, fmt, seed, group=16):
    """The tiny model's projections as random GPTQ (v1, act-order g_idx) or
    AWQ parts with scales near the weights' size; the rest raw."""
    rng = np.random.default_rng(seed)
    tensors = {
        "model.embed_tokens.weight": np.asarray(base_params["embed_tokens"]),
        "model.norm.weight": np.asarray(base_params["norm"]),
        "lm_head.weight": np.asarray(base_params["lm_head"]),
    }
    for i, layer in enumerate(base_params["layers"]):
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"model.layers.{i}.{name}.weight"] = np.asarray(layer[name])
        for name in PROJ:
            group_name = "mlp" if name in ("gate_proj", "up_proj", "down_proj") else "self_attn"
            root = f"model.layers.{i}.{group_name}.{name}"
            out_dim, in_dim = np.asarray(layer[name]).shape
            groups = in_dim // group
            scales = (np.abs(rng.standard_normal((groups, out_dim))) * 0.01 + 0.005).astype(np.float16)
            if fmt == "gptq":
                tensors[f"{root}.qweight"] = _pack_gptq_rows(rng.integers(0, 16, (in_dim, out_dim)), 4)
                tensors[f"{root}.qzeros"] = _pack_gptq_rows(rng.integers(6, 9, (out_dim, groups)), 4).T.copy()
                tensors[f"{root}.scales"] = scales
                tensors[f"{root}.g_idx"] = rng.permutation(np.arange(in_dim) // group).astype(np.int32)
            else:
                tensors[f"{root}.qweight"] = _pack_awq_cols(rng.integers(0, 16, (in_dim, out_dim)))
                tensors[f"{root}.qzeros"] = _pack_awq_cols(rng.integers(7, 10, (groups, out_dim)))
                tensors[f"{root}.scales"] = scales
    path.mkdir()
    jax_save_file(tensors, path / "model.safetensors")
    qc = ({"quant_method": "gptq", "bits": 4, "group_size": group, "desc_act": True} if fmt == "gptq"
          else {"quant_method": "awq", "bits": 4, "group_size": group, "zero_point": True, "version": "gemm"})
    (path / "config.json").write_text(json.dumps({**HF_CONFIG, "quantization_config": qc}))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    params = _save_tiny_checkpoint(root / "base")
    _adapter(root / "adapter", root / "base", seed=3)
    _packed(root / "gptq", params, "gptq", seed=4)
    _packed(root / "awq", params, "awq", seed=5)
    return root


def _jax_params(path, bits):
    from shardmerge_tpu.models.llama import ModelConfig
    from shardmerge_tpu.models.loader import load_params as jax_load

    weights, adapter = resolve_checkpoint_dir(path)
    return jax_load(path, ModelConfig.from_pretrained(weights), quant_bits=bits)


@pytest.mark.parametrize("kind", ["adapter", "gptq", "awq"])
@pytest.mark.parametrize("bits", [None, 4])
def test_loaded_weights_equal_the_jax_loaders(checkpoints, kind, bits):
    ours = load_params(checkpoints / kind, quant_bits=bits)
    theirs = _jax_params(checkpoints / kind, bits)
    for i, layer in enumerate(ours["layers"]):
        for name in PROJ:
            got, want = layer[name], theirs["layers"][i][name]
            if bits:
                np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]), f"{i}.{name}")
                np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]), f"{i}.{name}")
            else:
                np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32),
                                              f"{i}.{name}")


@pytest.mark.parametrize("kind", ["adapter", "gptq", "awq"])
@pytest.mark.parametrize("four_bit", [False, True])
def test_generate_gives_the_jax_engines_greedy_tokens(checkpoints, kind, four_bit):
    kw = dict(load_in_4bit=four_bit, tokenizer=StubTokenizer())
    ours = InferenceEngine.from_pretrained(checkpoints / kind, device="cpu", **kw)
    theirs = JaxEngine.from_pretrained(str(checkpoints / kind), **kw)
    gen = dict(max_new_tokens=6, greedy=True)
    assert ours.generate_batch(PROMPTS, **gen) == theirs.generate_batch(PROMPTS, use_template=False, **gen)


def test_an_adapter_generates_what_its_fused_checkpoint_generates(checkpoints, tmp_path):
    fuse_lora(checkpoints / "base", checkpoints / "adapter", tmp_path / "fused")
    tok = StubTokenizer()
    for four_bit in (False, True):
        a = InferenceEngine.from_pretrained(checkpoints / "adapter", load_in_4bit=four_bit, tokenizer=tok,
                                            device="cpu")
        f = InferenceEngine.from_pretrained(tmp_path / "fused", load_in_4bit=four_bit, tokenizer=tok, device="cpu")
        for name, p in a.model.named_parameters():
            assert torch.equal(p, dict(f.model.named_parameters())[name]), name
        assert a.generate_batch(PROMPTS, max_new_tokens=6, greedy=True) == f.generate_batch(
            PROMPTS, max_new_tokens=6, greedy=True)


def test_an_adapter_with_no_local_base_is_refused(tmp_path):
    (tmp_path / "ad").mkdir()
    (tmp_path / "ad" / "adapter_config.json").write_text(json.dumps(
        {"r": 1, "base_model_name_or_path": "org/not-here"}))
    jax_save_file({"base_model.model.x.lora_A.weight": np.zeros((1, 2), np.float32),
                   "base_model.model.x.lora_B.weight": np.zeros((2, 1), np.float32)},
                  tmp_path / "ad" / "adapter_model.safetensors")
    with pytest.raises(FileNotFoundError, match="not a local checkpoint directory"):
        resolve_checkpoint_dir(tmp_path / "ad")
