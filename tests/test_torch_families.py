"""Port vs JAX: the dense model families (shardmerge_tpu_torch/models/
llama.py, loader.py, convert.py against shardmerge_tpu/models/llama.py,
loader.py) on tiny configs of each family, after tests/test_models.py.

Weights come from the JAX ``init_params`` with every bias and norm moved off
its init value by seeded noise (so each one is exercised), carried across
with ``params_from_jax``. Logits are held at relL2 1e-5 (f32), greedy tokens
exactly, rope tables at 1e-6, loaded leaves bit for bit."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.batching import ContinuousEngine as JaxPool
from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu.models import loader as jloader
from shardmerge_tpu.models import quant as jquant
from shardmerge_tpu_torch.batching import ContinuousEngine
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.io.safetensors_io import save_file
from shardmerge_tpu_torch.models import attn_kernels
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import loader as tloader
from shardmerge_tpu_torch.models.convert import params_from_jax

BASE = {
    "vocab_size": 128,
    "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "max_position_embeddings": 256,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
}
LONGROPE = {"type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(8)],
            "long_factor": [2.0 + 0.1 * i for i in range(8)]}
# one tiny config per family, each with the features that set it apart
FAMILIES = {
    "qwen2": {"model_type": "qwen2", "tie_word_embeddings": False},
    "qwen3": {"model_type": "qwen3", "head_dim": 16, "tie_word_embeddings": False},
    "mistral": {"model_type": "mistral", "sliding_window": 4},
    "gemma": {"model_type": "gemma", "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh"},
    "gemma2": {"model_type": "gemma2", "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh",
               "query_pre_attn_scalar": 24, "attn_logit_softcapping": 5.0, "final_logit_softcapping": 3.0,
               "sliding_window": 4},
    "gemma3": {"model_type": "gemma3", "text_config": {
        "model_type": "gemma3_text", **BASE, "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh",
        "query_pre_attn_scalar": 16, "sliding_window": 4, "sliding_window_pattern": 2,
        "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0}}},
    "phi3": {"model_type": "phi3", "num_key_value_heads": 4, "max_position_embeddings": 64,
             "original_max_position_embeddings": 32, "rope_scaling": LONGROPE, "tie_word_embeddings": False},
    "olmo2": {"model_type": "olmo2", "tie_word_embeddings": False},
    "smollm3": {"model_type": "smollm3", "num_hidden_layers": 4, "no_rope_layer_interval": 2},
    "glm4": {"model_type": "glm4", "head_dim": 16, "tie_word_embeddings": False},
}


def hf_config(family):
    return {**BASE, **FAMILIES[family]}


class StubTokenizer:
    """One token per character; eos 1."""

    chat_template = None
    eos_token_id = 1

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


def jax_params(cfg, seed=0):
    """JAX init_params (f32, numpy leaves) with biases and norms noised."""
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for layer in params["layers"]:
        for key, value in layer.items():
            if key.endswith(("_bias", "norm", "layernorm")):
                layer[key] = (value + rng.normal(0, 0.2, value.shape)).astype(np.float32)
    params["norm"] = (params["norm"] + rng.normal(0, 0.2, params["norm"].shape)).astype(np.float32)
    return params


def models(family, seed=0):
    hf = hf_config(family)
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    tcfg = tllama.ModelConfig.from_hf_config(hf)
    params = jax_params(jcfg, seed)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), tcfg, tllama.LlamaModel(tcfg, params_from_jax(params))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax(family):
    """A left-padded batch's prefill over 9 slots (windows of 4 mask on
    both rows) and two decode steps: logits within relL2 1e-5 of the JAX
    forward, and the caches too (pad rows aside)."""
    jcfg, jparams, tcfg, model = models(family)
    S, T = 32, 9
    ids = np.random.default_rng(3).integers(2, 128, size=(2, T))
    pad = np.array([0, 3])
    slot = np.broadcast_to(np.arange(T), (2, T))
    pos = np.maximum(slot - pad[:, None], 0)
    valid = np.arange(S)[None, :] >= pad[:, None]
    jrope, trope = jllama.rope_tables(jcfg, S), tllama.rope_tables(tcfg, S)
    jkv = jllama.init_kv_cache(jcfg, 2, S, jnp.float32)
    tkv = tllama.init_kv_cache(tcfg, 2, S, torch.float32)
    j_logits, jkv = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv, 0, jrope, T,
                                   mask_positions=jnp.asarray(slot), token_valid=jnp.asarray(valid))
    with torch.inference_mode():
        t_logits, tkv = model(torch.from_numpy(ids), torch.from_numpy(pos), tkv, 0, trope, T,
                              mask_positions=torch.from_numpy(slot.copy()), token_valid=torch.from_numpy(valid))
    # a pad query attends to no slot: its garbage row depends on the mask's
    # length, which differs by design (the port masks attn_len slots)
    real = valid[:, :T]
    assert rel_l2(t_logits.numpy()[real], np.asarray(j_logits)[real]) <= 1e-5
    keys = [np.moveaxis(np.asarray(k), 3, 2)[:, :, :T][:, real] for k in (tkv["k"].numpy(), jkv["k"])]
    assert rel_l2(*keys) <= 1e-5
    for step in range(2):
        tok = np.array([[5 + step], [60 + step]])
        t = T + step
        kw = dict(mask_positions=np.full((2, 1), t), token_valid=valid)
        j_logits, jkv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(t - pad[:, None]), jkv, t,
                                       jrope, t + 1, **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.inference_mode():
            t_logits, tkv = model(torch.from_numpy(tok), torch.from_numpy(t - pad[:, None]), tkv, t, trope,
                                  t + 1, **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()})
        assert rel_l2(t_logits.numpy(), j_logits) <= 1e-5, (family, step)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_greedy_tokens_match_jax_engine(family):
    """The engines' greedy streams (past the window) and ragged lockstep
    batches give the JAX engine's tokens."""
    jcfg, jparams, tcfg, model = models(family, seed=1)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer())
    teng = InferenceEngine(tcfg, model, StubTokenizer())
    kw = dict(max_new_tokens=6, greedy=True, use_template=False)
    assert "".join(teng.stream_generation("the window slides", **kw)) == "".join(
        jeng.stream_generation("the window slides", **kw))
    prompts = ["hello there", "a", "the quick brown fox"]
    assert teng.generate_batch(prompts, **kw) == jeng.generate_batch(prompts, **kw)


def test_sliding_window_pool_matches_jax_pool():
    """Mistral's window in the continuous pool: a row joining behind a
    frontier jump compares true positions across its gap (key_positions),
    and the completions equal the JAX pool's and the solo stream's."""
    jcfg, jparams, tcfg, model = models("mistral", seed=2)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer())
    teng = InferenceEngine(tcfg, model, StubTokenizer())
    prompts = [("short", 12), ("a much longer prompt than the first", 8), ("mid length", 10)]
    outs = []
    for eng, pool_cls in ((teng, ContinuousEngine), (jeng, JaxPool)):
        pool = pool_cls(eng, slots=2, cache_len=256, greedy=True, use_template=False)
        handles = [pool.submit(p, max_new_tokens=n) for p, n in prompts]
        pool.run_until_idle()
        outs.append([h.result() for h in handles])
        assert pool.stats["frontier_jumps"] >= 1
    assert outs[0] == outs[1]
    solo = ["".join(teng.stream_generation(p, max_new_tokens=n, greedy=True)) for p, n in prompts]
    assert outs[0] == solo


def _rope_cfgs():
    yarn = {**BASE, "rope_scaling": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 8,
                                     "beta_fast": 16, "beta_slow": 2}}
    return {
        "yarn": yarn,
        "yarn-mscale": {**BASE, "rope_scaling": {"type": "yarn", "factor": 8.0, "mscale": 0.7,
                                                 "mscale_all_dim": 1.0, "truncate": False}},
        "longrope": hf_config("phi3"),
        "glm4-partial-interleaved": hf_config("glm4"),
        "gemma3-dual": hf_config("gemma3"),
        "llama3": {**BASE, "rope_theta": 500000.0, "rope_scaling": {
            "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
            "original_max_position_embeddings": 32}},
    }


@pytest.mark.parametrize("name,length", [(n, s) for n in sorted(_rope_cfgs()) for s in (16, 32, 33, 256)])
def test_rope_tables_match_jax(name, length):
    """Every rope table at lengths on both sides of longrope's boundary (the
    tiny Phi-3's pretraining context is 32: short factors up to 32 slots,
    long factors from 33)."""
    hf = _rope_cfgs()[name]
    jt = jllama.rope_tables(jllama.ModelConfig.from_hf_config(hf), length)
    tt = tllama.rope_tables(tllama.ModelConfig.from_hf_config(hf), length)
    assert len(tt) == len(jt) == (4 if name == "gemma3-dual" else 2)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_longrope_switches_factors_at_the_boundary():
    cfg = tllama.ModelConfig.from_hf_config(hf_config("phi3"))
    short, f_short = tllama._rope_inv_freq(cfg, 32)
    long, f_long = tllama._rope_inv_freq(cfg, 33)
    assert f_short == f_long == pytest.approx(np.sqrt(1 + np.log(2) / np.log(32)))
    np.testing.assert_allclose(short * np.asarray(LONGROPE["short_factor"]),
                               long * np.asarray(LONGROPE["long_factor"]), rtol=1e-6)


def _hf_tensors(family, params):
    """The params under the HF checkpoint names (phi3: fused qkv and
    gate_up; glm4: its sandwich-norm names and fused gate_up)."""
    out = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"]
    names = {"q_bias": "self_attn.q_proj.bias", "k_bias": "self_attn.k_proj.bias",
             "v_bias": "self_attn.v_proj.bias", "q_norm": "self_attn.q_norm.weight",
             "k_norm": "self_attn.k_norm.weight"}
    glm4 = {"post_attention_layernorm": "post_self_attn_layernorm",
            "pre_feedforward_layernorm": "post_attention_layernorm",
            "post_feedforward_layernorm": "post_mlp_layernorm"}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        for key, value in layer.items():
            if family == "phi3" and key in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
                continue
            if family == "glm4" and key in ("gate_proj", "up_proj"):
                continue
            if key in names:
                out[p + names[key]] = value
            elif key.endswith("_proj"):
                group = "mlp" if key in ("gate_proj", "up_proj", "down_proj") else "self_attn"
                out[f"{p}{group}.{key}.weight"] = value
            else:
                out[f"{p}{glm4.get(key, key) if family == 'glm4' else key}.weight"] = value
        if family == "phi3":
            out[p + "self_attn.qkv_proj.weight"] = np.concatenate([layer["q_proj"], layer["k_proj"],
                                                                   layer["v_proj"]])
        if family in ("phi3", "glm4"):
            out[p + "mlp.gate_up_proj.weight"] = np.concatenate([layer["gate_proj"], layer["up_proj"]])
    return out


@pytest.mark.parametrize("family,bits", [(f, b) for f in ("phi3", "glm4", "gemma2", "gemma3", "qwen2", "olmo2")
                                         for b in (None, 4)])
def test_loader_maps_family_names_as_jax(tmp_path, family, bits):
    """A checkpoint in HF naming loads to the JAX loader's leaves, bit for
    bit: fused projections split (each part quantized on its own), GLM-4's
    sandwich norms remapped, biases and norms kept in the dtype."""
    hf = hf_config(family)
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    params = jax_params(jcfg, seed=4)
    save_file({k: torch.from_numpy(np.array(v)) for k, v in _hf_tensors(family, params).items()},
              tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps(hf))
    theirs = jax.tree_util.tree_map(np.asarray, jloader.load_params(tmp_path, jcfg, dtype=jnp.float32,
                                                                     quant_bits=bits))
    ours = tloader.load_params(tmp_path, tllama.ModelConfig.from_hf_config(hf), dtype=torch.float32,
                               quant_bits=bits)
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_o = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0])
    assert len(flat_t) == len(flat_o)
    for path, value in flat_t:
        np.testing.assert_array_equal(flat_o[path], value, err_msg=str(path))


def test_params_from_jax_carries_every_leaf_bit_for_bit():
    cfg = jllama.ModelConfig.from_hf_config(hf_config("gemma3"))
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(2), jnp.bfloat16))
    params["layers"][0]["q_norm"] = (params["layers"][0]["q_norm"] + np.float32(0.3)).astype(
        params["layers"][0]["q_norm"].dtype)
    ported = params_from_jax(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.view(torch.uint16).numpy(), ported))[0])
    for path, value in leaves:
        np.testing.assert_array_equal(got[path], value.view(np.uint16), err_msg=str(path))
    assert set(ported["layers"][0]) == tllama.layer_keys(tllama.ModelConfig.from_hf_config(hf_config("gemma3")))


# the sink and chunked families this test refused before they were
# ported: each config (Llama-4 as its multimodal wrapper) now builds a
# model that decodes
SINK_AND_CHUNKED = {
    "gpt_oss": {**BASE, "model_type": "gpt_oss", "num_local_experts": 4, "num_experts_per_tok": 2,
                "head_dim": 16, "attention_bias": True, "sliding_window": 3,
                "layer_types": ["sliding_attention", "full_attention"]},
    "llama4": {"model_type": "llama4", "text_config": {
        **BASE, "model_type": "llama4_text", "num_local_experts": 4, "num_experts_per_tok": 1, "head_dim": 16,
        "intermediate_size": 32, "no_rope_layers": [1, 0], "attention_chunk_size": 4, "floor_scale": 2.0}},
}


@pytest.mark.parametrize("model_type", ["gpt_oss", "llama4"])
def test_expert_latent_sink_and_chunked_families_are_refused_by_name(model_type):
    cfg = tllama.ModelConfig.from_hf_config(SINK_AND_CHUNKED[model_type])
    assert cfg.has_sinks == (model_type == "gpt_oss") and cfg.layer_is_chunked(0) == (model_type == "llama4")
    engine = InferenceEngine(cfg, tllama.LlamaModel(cfg, tllama.init_params(cfg, seed=1, dtype=torch.float32)),
                             StubTokenizer())
    assert len("".join(engine.stream_generation("sinks and chunks", max_new_tokens=6, greedy=True))) > 0


# the expert and latent-attention families this test refused before they
# were ported: each config now builds a model that decodes
ONCE_REFUSED_FAMILIES = {
    "mixtral": {"num_local_experts": 4},
    "qwen3_moe": {"num_experts": 4, "head_dim": 16, "moe_intermediate_size": 32},
    "deepseek_v2": {"n_routed_experts": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
                    "v_head_dim": 8, "moe_intermediate_size": 32, "n_shared_experts": 1, "first_k_dense_replace": 1},
    "deepseek_v3": {"n_routed_experts": 4, "q_lora_rank": 16, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
                    "qk_rope_head_dim": 8, "v_head_dim": 8, "moe_intermediate_size": 32, "n_group": 2,
                    "topk_group": 1},
}


@pytest.mark.parametrize("model_type", sorted(ONCE_REFUSED_FAMILIES))
def test_expert_and_latent_families_build_and_decode(model_type):
    cfg = tllama.ModelConfig.from_hf_config({**BASE, "model_type": model_type, **ONCE_REFUSED_FAMILIES[model_type]})
    assert cfg.num_local_experts == 4 and cfg.is_mla == model_type.startswith("deepseek")
    engine = InferenceEngine(cfg, tllama.LlamaModel(cfg, tllama.init_params(cfg, seed=1, dtype=torch.float32)),
                             StubTokenizer())
    assert len("".join(engine.stream_generation("route me", max_new_tokens=4, greedy=True))) > 0


def test_softcap_and_wide_heads_take_the_counted_einsum_path():
    """On a CUDA tensor the route sends Gemma-2's softcapped attention and
    head dims the kernel does not take to the einsum path, counted."""
    card_q = SimpleNamespace(is_cuda=True)
    attn_kernels.reset_launch_counts()
    for family, flash in (("gemma2", False), ("gemma", True), ("phi3", True), ("qwen3", True)):
        cfg = tllama.ModelConfig.from_hf_config({**hf_config(family), "head_dim": 64})
        assert attn_kernels.use_flash_decode(cfg, 1, card_q) is flash, family
        assert attn_kernels.use_flash_decode(cfg, 2, card_q) is False
    assert attn_kernels.launch_counts["decode_einsum"] == 1
    wide = tllama.ModelConfig.from_hf_config({**hf_config("gemma"), "head_dim": 256})
    assert attn_kernels.use_flash_decode(wide, 1, card_q) is False
