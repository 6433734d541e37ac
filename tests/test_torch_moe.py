"""Port vs JAX: the expert families Mixtral, Qwen3-MoE and DeepSeek V2/V3
(shardmerge_tpu_torch/models/llama.py, loader.py, convert.py, inference.py
against shardmerge_tpu/models/llama.py, loader.py, inference.py) on the
tiny configs of tests/test_models.py and tests/test_moe.py.

Weights come from the JAX ``init_params`` with every norm and V3's
selection bias moved off its init value by seeded noise, carried across
with ``params_from_jax``. Routing indices are held bit for bit on the same
f32 router inputs (exact ties planted), logits at relL2 1e-5, greedy
tokens, speculative rounds and prefix-cache hits exactly, loaded leaves bit
for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu.models import loader as jloader
from shardmerge_tpu.models import quant as jquant
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import loader as tloader
from shardmerge_tpu_torch.models.convert import params_from_jax

BASE = {
    "vocab_size": 128,
    "hidden_size": 64,
    "intermediate_size": 96,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "max_position_embeddings": 256,
    "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
    "tie_word_embeddings": False,
}
MLA = {"num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
       "v_head_dim": 16, "moe_intermediate_size": 32, "n_shared_experts": 1, "first_k_dense_replace": 1}
# one tiny config per family (tests/test_models.py :1531, :1586, :1641;
# tests/test_moe.py :14)
FAMILIES = {
    "mixtral": {"model_type": "mixtral", "num_local_experts": 4, "num_experts_per_tok": 2},
    "qwen3_moe": {"model_type": "qwen3_moe", "head_dim": 16, "num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 48, "norm_topk_prob": False},
    "deepseek_v2": {"model_type": "deepseek_v2", **MLA, "num_hidden_layers": 3, "q_lora_rank": None,
                    "n_routed_experts": 8, "num_experts_per_tok": 2, "topk_method": "group_limited_greedy",
                    "n_group": 4, "topk_group": 2, "routed_scaling_factor": 1.5},
    "deepseek_v3": {"model_type": "deepseek_v3", **MLA, "num_hidden_layers": 3, "q_lora_rank": 24,
                    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_group": 4, "topk_group": 2,
                    "norm_topk_prob": True, "routed_scaling_factor": 2.5,
                    "rope_scaling": {"type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
                                     "mscale": 1.0, "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1}},
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


def jax_params(cfg, seed=0, dtype=jnp.float32):
    """JAX init_params (numpy leaves) with norms and V3's selection bias
    noised; ``dtype`` casts every leaf but the selection bias."""
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for layer in params["layers"]:
        for key, value in layer.items():
            if key.endswith(("norm", "layernorm")):
                layer[key] = (value + rng.normal(0, 0.2, value.shape)).astype(np.float32)
            elif key == "gate_bias":
                layer[key] = rng.normal(0, 0.05, value.shape).astype(np.float32)
    params["norm"] = (params["norm"] + rng.normal(0, 0.2, params["norm"].shape)).astype(np.float32)
    if dtype != jnp.float32:
        bias = [layer.get("gate_bias") for layer in params["layers"]]
        params = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)), params)
        for layer, b in zip(params["layers"], bias):
            if b is not None:
                layer["gate_bias"] = b
    return params


def quantize_params(params, bits):
    """The JAX quantizer over every projection and expert matrix."""
    for layer in params["layers"]:
        for key in list(layer):
            if key in tllama.QUANTIZABLE:
                layer[key] = jax.tree_util.tree_map(np.asarray, jquant.quantize(layer[key], bits=bits))
        for e in layer.get("experts", []):
            for w in ("w1", "w3", "w2"):
                e[w] = jax.tree_util.tree_map(np.asarray, jquant.quantize(e[w], bits=bits))
    return params


def models(family, seed=0, dtype=jnp.float32, bits=None, **overrides):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    hf = hf_config(family)
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    tcfg = tllama.ModelConfig.from_hf_config(hf)
    for k, v in overrides.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    params = jax_params(jcfg, seed, dtype)
    if bits:
        params = quantize_params(params, bits)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), tcfg, tllama.LlamaModel(tcfg, params_from_jax(params))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def as_np(t):
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


FIELDS = ("num_local_experts", "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
          "qk_rope_head_dim", "v_head_dim", "n_shared_experts", "first_k_dense_replace", "routed_scaling_factor",
          "n_group", "topk_group", "topk_method", "rope_interleave", "qk_norm", "sliding_window", "is_mla",
          "qk_head_dim", "rope_dims")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_fields_match_jax(family):
    """from_hf_config reads every MoE/MLA field, DeepSeek's interleave and
    V3's mscale^2 score scale as the JAX config does."""
    jcfg = jllama.ModelConfig.from_hf_config(hf_config(family))
    tcfg = tllama.ModelConfig.from_hf_config(hf_config(family))
    for name in FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for i in range(tcfg.num_hidden_layers):
        assert tcfg.layer_is_moe(i) == jcfg.layer_is_moe(i)
        assert tcfg.layer_has_experts(i) == (i >= jcfg.first_k_dense_replace)
    if jcfg.is_mla:
        assert tcfg.mla_softmax_scale == jcfg.mla_softmax_scale
        assert (tcfg.mla_softmax_scale != tcfg.qk_head_dim**-0.5) == (family == "deepseek_v3")


# A.8b's second half, refused here until it was ported: each config now
# builds its fused-expert model, whose decode step runs the stacks
SECOND_HALF = {
    "gpt_oss": {**BASE, "model_type": "gpt_oss", "num_local_experts": 4, "num_experts_per_tok": 2,
                "head_dim": 16, "attention_bias": True},
    "llama4": {"model_type": "llama4", "text_config": {**BASE, "model_type": "llama4_text", "num_local_experts": 4,
                                                       "num_experts_per_tok": 1, "head_dim": 16}},
}


@pytest.mark.parametrize("model_type", ["gpt_oss", "llama4"])
def test_second_half_families_stay_refused(model_type):
    cfg = tllama.ModelConfig.from_hf_config(SECOND_HALF[model_type])
    model = tllama.LlamaModel(cfg, tllama.init_params(cfg, seed=2, dtype=torch.float32))
    block = {"gpt_oss": tllama.GptOssMoE, "llama4": tllama.Llama4MoE}[model_type]
    assert all(isinstance(layer.mlp, block) for layer in model.layers)
    engine = InferenceEngine(cfg, model, StubTokenizer())
    assert len("".join(engine.stream_generation("fused experts", max_new_tokens=4, greedy=True))) > 0


def test_topk_breaks_exact_ties_toward_the_lower_index():
    """Rows of all-equal and repeated values: the same indices as
    jax.lax.top_k."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (64, 32)).astype(np.float32)
    x[:4] = 1.0
    for k in (1, 2, 5, 32):
        _, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tllama.topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.take_along_axis(x, ti.numpy(), -1))


def _router_inputs(n, seed=0):
    """(S, n) f32 logits with planted exact ties, and an identity router:
    ``x @ eye.T`` is x exactly, so both sides see the same logits."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (96, n)).astype(np.float32)
    logits[:8, 3] = logits[:8, 5]
    logits[8:16] = 0.5  # every expert tied
    logits[16:24, :2] = logits[16:24, 2:4]
    return logits, np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_softmax_routing_and_block_match_jax_on_planted_ties(norm_topk):
    """Mixtral / Qwen3-MoE routing through an identity router (x's first
    n_exp columns are the logits, exactly): top-k indices bit for bit
    against jax.lax.top_k over the same softmax (exact ties planted at the
    k-th place), weights within 4 f32 ulps, and the MoE block's output
    within relL2 1e-5 of the JAX dispatcher's, where a tie broken the other
    way would swap an expert."""
    n, E = 8, 64
    logits, eye = _router_inputs(n)
    x = np.random.default_rng(4).normal(0, 1, (1, logits.shape[0], E)).astype(np.float32)
    x[0, :, :n] = logits
    cfg_kw = {**BASE, "model_type": "mixtral", "num_local_experts": n, "num_experts_per_tok": 2}
    jcfg = jllama.ModelConfig.from_hf_config(cfg_kw)
    jcfg.norm_topk_prob = norm_topk
    tcfg = tllama.ModelConfig.from_hf_config(cfg_kw)
    tcfg.norm_topk_prob = norm_topk
    layer = jax_params(jcfg, seed=6)["layers"][0]
    layer["moe_gate"] = np.pad(eye, ((0, 0), (0, E - n)))
    block = tllama.MoE(tcfg, params_from_jax(layer))
    tidx, tw = block.route(torch.from_numpy(x))
    jprobs, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), 2)
    if norm_topk:
        jprobs = jprobs / jnp.sum(jprobs, axis=-1, keepdims=True)
    np.testing.assert_array_equal(tidx[0].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw[0].numpy(), np.asarray(jprobs), rtol=4.8e-7, atol=0)
    theirs = jllama._ffn(jcfg, jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x))
    with torch.inference_mode():
        assert rel_l2(as_np(block(torch.from_numpy(x))), theirs) <= 1e-5


ROUTES = {
    "v2-greedy": ("deepseek_v2", "greedy", None, None),
    "v2-group-limited": ("deepseek_v2", "group_limited_greedy", 4, 2),
    "v3-noaux-tc-4-groups": ("deepseek_v3", "noaux_tc", 4, 2),
    "v3-noaux-tc-8-groups": ("deepseek_v3", "noaux_tc", 8, 3),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_deepseek_routing_matches_jax(route):
    """deepseek_topk on the same f32 logits: indices bit for bit (V3's
    biased selection, group top-2 sums and 0.0 mask, V2's group max), the
    weights (V2's unnormalized scores, V3's normalized unbiased sigmoids
    with + 1e-20, both scaled) within 4 f32 ulps: XLA's and torch's exp
    round apart."""
    model_type, method, n_group, topk_group = ROUTES[route]
    n = 16
    logits, eye = _router_inputs(n, seed=1)
    bias = np.random.default_rng(2).normal(0, 0.3, n).astype(np.float32)
    bias[[4, 6]] = bias[2]  # tied selection biases
    bias[9] = -3.0  # biased scores below the 0.0 mask
    kw = dict(model_type=model_type, num_local_experts=n, num_experts_per_tok=4, topk_method=method,
              n_group=n_group, topk_group=topk_group, routed_scaling_factor=2.5, norm_topk_prob=True)
    ji, jw = jllama.deepseek_topk(jllama.ModelConfig(**kw), jnp.asarray(eye), jnp.asarray(bias), jnp.asarray(logits))
    ti, tw = tllama.deepseek_topk(tllama.ModelConfig(**kw), torch.from_numpy(eye), torch.from_numpy(bias),
                                  torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=4.8e-7, atol=0)


def _forward_pair(jcfg, jparams, tcfg, model, dtype, pad=(0, 3)):
    """A 2-row prefill over 9 slots (row 1 left-padded by ``pad[1]``) and
    two decode steps through both forwards; returns the pairs of real-row
    logits."""
    S, T = 32, 9
    ids = np.random.default_rng(3).integers(2, 128, size=(2, T))
    pad = np.array(pad)
    slot = np.broadcast_to(np.arange(T), (2, T))
    pos = np.maximum(slot - pad[:, None], 0)
    valid = np.arange(S)[None, :] >= pad[:, None]
    jrope, trope = jllama.rope_tables(jcfg, S), tllama.rope_tables(tcfg, S)
    jkv = jllama.init_kv_cache(jcfg, 2, S, dtype[0])
    tkv = tllama.init_kv_cache(tcfg, 2, S, dtype[1])
    jl, jkv = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv, 0, jrope, T,
                             mask_positions=jnp.asarray(slot), token_valid=jnp.asarray(valid))
    with torch.inference_mode():
        tl, tkv = model(torch.from_numpy(ids), torch.from_numpy(pos), tkv, 0, trope, T,
                        mask_positions=torch.from_numpy(slot.copy()), token_valid=torch.from_numpy(valid))
    real = valid[:, :T]
    out = [(as_np(tl)[real], as_np(jl)[real])]
    for step in range(2):
        tok = np.array([[5 + step], [60 + step]])
        t = T + step
        kw = dict(mask_positions=np.full((2, 1), t), token_valid=valid)
        jl, jkv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(t - pad[:, None]), jkv, t, jrope,
                                 t + 1, **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.inference_mode():
            tl, tkv = model(torch.from_numpy(tok), torch.from_numpy(t - pad[:, None]), tkv, t, trope, t + 1,
                            **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()})
        out.append((as_np(tl), as_np(jl)))
    return out


# bf16 bounds: 1e-5 where the family holds it; the tiny V3 reads
# 1.45-2.40e-3 (14 of 1152 bf16 roundings of layer 0's MLA output flip),
# bounded at twice its worst
BF16_BOUND = {"mixtral": 1e-5, "qwen3_moe": 1e-5, "deepseek_v2": 1e-5, "deepseek_v3": 5e-3}


@pytest.mark.parametrize("family,kind", [(f, k) for f in sorted(FAMILIES) for k in ("f32", "bf16", "int4", "int8")])
def test_family_logits_match_jax(family, kind):
    """Prefill (left pads masked) and two decode steps: logits within relL2
    1e-5 of the JAX forward in f32 and with int4 or int8 projections and
    experts (f32 activations). In bf16 the f32 einsums of XLA and torch sum
    in different orders, and a one-ulp f32 difference can flip a bf16
    rounding (NUMERICS.md section 4, reduction order): the tiny V3's MLA
    output flips 14 of 1152 roundings in layer 0, which moves its logits by
    1.45-2.40e-3 relL2, so V3 is held to 5e-3 in bf16 (``BF16_BOUND``) and
    the other three to 1e-5."""
    dtype = {"bf16": (jnp.bfloat16, torch.bfloat16)}.get(kind, (jnp.float32, torch.float32))
    bits = {"int4": 4, "int8": 8}.get(kind)
    jcfg, jparams, tcfg, model = models(family, dtype=dtype[0], bits=bits)
    bound = BF16_BOUND[family] if kind == "bf16" else 1e-5
    for ours, theirs in _forward_pair(jcfg, jparams, tcfg, model, dtype):
        assert rel_l2(ours, theirs) <= bound, (family, kind)


def test_params_from_jax_keeps_expert_lists():
    jcfg = jllama.ModelConfig.from_hf_config(hf_config("deepseek_v3"))
    params = jax_params(jcfg, seed=4)
    ported = params_from_jax(params)
    assert isinstance(ported["layers"][1]["experts"], list) and len(ported["layers"][1]["experts"]) == 8
    assert set(ported["layers"][1]) == tllama.layer_keys(tllama.ModelConfig.from_hf_config(hf_config("deepseek_v3")), 1)
    assert set(ported["layers"][0]) == tllama.layer_keys(tllama.ModelConfig.from_hf_config(hf_config("deepseek_v3")), 0)


def test_init_params_has_the_jax_layout():
    """The port's own random params: the JAX init's leaves and shapes, the
    projection hook applied to every quantizable matrix."""
    for family in FAMILIES:
        hf = hf_config(family)
        theirs = jax.tree_util.tree_map(np.shape, jllama.init_params(jllama.ModelConfig.from_hf_config(hf),
                                                                     jax.random.PRNGKey(0), jnp.float32))
        ours = tllama.init_params(tllama.ModelConfig.from_hf_config(hf), seed=0, dtype=torch.float32)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == theirs, family
        seen = []
        tllama.init_params(tllama.ModelConfig.from_hf_config(hf), seed=0, project=lambda w: seen.append(w) or w)
        cfg = tllama.ModelConfig.from_hf_config(hf)
        want = sum(len(tllama.layer_keys(cfg, i) & tllama.QUANTIZABLE) + 3 * cfg.num_local_experts * cfg.layer_has_experts(i)
                   for i in range(cfg.num_hidden_layers))
        assert len(seen) == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_greedy_tokens_match_jax_engine(family):
    """The engines' greedy stream and a ragged lockstep batch give the JAX
    engine's tokens."""
    jcfg, jparams, tcfg, model = models(family, seed=1)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer())
    teng = InferenceEngine(tcfg, model, StubTokenizer())
    kw = dict(max_new_tokens=6, greedy=True, use_template=False)
    assert "".join(teng.stream_generation("experts route tokens", **kw)) == "".join(
        jeng.stream_generation("experts route tokens", **kw))
    prompts = ["hello there", "a", "the quick brown fox"]
    assert teng.generate_batch(prompts, **kw) == jeng.generate_batch(prompts, **kw)


SYSTEM = "You are a helpful assistant. " * 4  # 116 tokens


def test_prefix_hit_and_speculative_rounds_on_a_mixtral_target():
    """A tiny Mixtral target with a dense draft of its vocab and the prefix
    cache: tokens, speculative rounds and hit lengths equal the JAX
    engine's, and the plain stream's."""
    jcfg, jparams, tcfg, model = models("mixtral", seed=5)
    draft_hf = {**BASE, "model_type": "llama", "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
                "num_attention_heads": 2, "num_key_value_heads": 1}
    dcfg = jllama.ModelConfig.from_hf_config(draft_hf)
    dparams = jax.tree_util.tree_map(np.asarray, jllama.init_params(dcfg, jax.random.PRNGKey(9), jnp.float32))
    tdraft = tllama.LlamaModel(tllama.ModelConfig.from_hf_config(draft_hf), params_from_jax(dparams))
    port = InferenceEngine(tcfg, model, StubTokenizer(), draft=tdraft, speculation_k=3, prefix_cache_slots=4)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer(), draft=(dcfg, jax.tree_util.tree_map(jnp.asarray, dparams)),
                     speculation_k=3, prefix_cache_slots=4)
    plain = InferenceEngine(tcfg, model, StubTokenizer())
    for eng in (port, jeng, plain):
        eng.prompt_chunk = 64
    rounds = []
    for eng in (port, jeng):
        calls = {"n": 0}
        orig = eng._spec_round

        def counting(*a, _orig=orig, _calls=calls, **kw):
            _calls["n"] += 1
            return _orig(*a, **kw)

        eng._spec_round = counting
        rounds.append(calls)
    kw = dict(max_new_tokens=8, greedy=True, use_template=False)
    for prompt in (SYSTEM + "first question", SYSTEM + "second question?"):
        tmeta, jmeta = {}, {}
        ours = "".join(port.stream_generation(prompt, meta=tmeta, **kw))
        assert ours == "".join(jeng.stream_generation(prompt, meta=jmeta, **kw))
        assert ours == "".join(plain.stream_generation(prompt, **kw))
        assert tmeta["prefix_cache_hit_tokens"] == jmeta["prefix_cache_hit_tokens"]
    assert tmeta["prefix_cache_hit_tokens"] == 64
    assert rounds[0]["n"] == rounds[1]["n"] > 0
    assert [k for k in port._prefix_cache] == [k for k in jeng._prefix_cache]


def _hf_model(family, path, seed):
    """A tiny transformers model of ``family`` saved in HF naming."""
    import transformers

    torch.manual_seed(seed)
    hf = {k: v for k, v in hf_config(family).items() if k != "model_type"}
    if family == "deepseek_v3":
        hf["rope_scaling"] = None
    cls = {"mixtral": ("MixtralConfig", "MixtralForCausalLM"), "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM"),
           "deepseek_v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM"),
           "deepseek_v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM")}[family]
    config = getattr(transformers, cls[0])(**hf)
    model = getattr(transformers, cls[1])(config).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "e_score_correction_bias" in name or name.endswith("norm.weight") or "layernorm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
        for name, b in model.named_buffers():
            if "e_score_correction_bias" in name:
                b.add_(torch.randn(b.shape) * 0.1)
    model.save_pretrained(str(path), safe_serialization=True)


@pytest.mark.parametrize("family,bits", [(f, b) for f in sorted(FAMILIES) for b in (None, 4, 8)])
def test_loader_maps_expert_and_mla_names_as_jax(tmp_path, family, bits):
    """transformers checkpoints in HF naming (Mixtral's block_sparse_moe
    w1/w2/w3, the mlp.experts and gate names, DeepSeek's MLA, shared
    experts and e_score_correction_bias) load to the JAX loader's leaves
    bit for bit, each expert quantized on its own."""
    _hf_model(family, tmp_path, seed=7)
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    jcfg = jllama.ModelConfig.from_hf_config(cfg_json)
    tcfg = tllama.ModelConfig.from_hf_config(cfg_json)
    theirs = jax.tree_util.tree_map(np.asarray, jloader.load_params(tmp_path, jcfg, dtype=jnp.float32,
                                                                     quant_bits=bits))
    ours = tloader.load_params(tmp_path, tcfg, dtype=torch.float32, quant_bits=bits)
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_o = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0])
    assert len(flat_t) == len(flat_o)
    for path, value in flat_t:
        np.testing.assert_array_equal(flat_o[path], value, err_msg=str(path))
    assert any("experts" in layer for layer in ours["layers"])
