"""Port vs JAX: GPT-OSS (shardmerge_tpu_torch/models/llama.py, quant.py,
loader.py, convert.py, inference.py, batching.py against the JAX
package's) on the tiny config of tests/test_models.py:1723 and :1825.

Weights come from the JAX ``init_params`` with the sinks, every bias and
the norms moved off their init values by seeded noise, carried across with
``params_from_jax``. Sink attention is held at f32 1e-6, router indices
bit for bit on planted ties, router weights within 4 f32 ulps, the expert
block and the logits at relL2 1e-5 (f32, int4, int8), stacked
quantization and the MXFP4 decode bit for bit, loaded leaves bit for bit,
greedy tokens, pools and prefix-cache hits exactly."""

import json

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
from shardmerge_tpu_torch.models import attn_kernels
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import loader as tloader
from shardmerge_tpu_torch.models import quant as tquant
from shardmerge_tpu_torch.models.convert import params_from_jax
from tests.test_torch_mla import NoEosTokenizer
from tests.test_torch_moe import StubTokenizer, _forward_pair, _router_inputs, rel_l2

# tests/test_models.py:1723's GptOssConfig as its config.json carries it
GPTOSS_HF = {
    "model_type": "gpt_oss", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 48,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_local_experts": 4, "num_experts_per_tok": 2, "sliding_window": 3, "max_position_embeddings": 256,
    "tie_word_embeddings": False, "attention_bias": True, "rms_norm_eps": 1e-5, "rope_theta": 150000.0,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0, "truncate": False,
                     "original_max_position_embeddings": 4096},
    "layer_types": ["sliding_attention", "full_attention"], "hidden_act": "silu",
}


def jax_params(cfg, seed=0, dtype=jnp.float32, bits=None):
    """JAX init_params (numpy leaves) with sinks, biases and norms noised;
    ``bits`` quantizes the projections (``quantize``) and the fused stacks
    (``quantize_stacked``, as the JAX loader does on the host)."""
    params = jax.tree_util.tree_map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for layer in params["layers"]:
        for key, value in list(layer.items()):
            if key.endswith(("norm", "layernorm")) or key in ("sinks", "o_bias", "moe_gate_bias") or key.endswith(
                    "_bias"):
                layer[key] = (value + rng.normal(0, 0.3, value.shape)).astype(np.float32)
        e = layer["gptoss_experts"]
        for key in ("gate_up_bias", "down_bias"):
            e[key] = rng.normal(0, 0.3, e[key].shape).astype(np.float32)
        # a few gate/up columns past the 7.0 clamps
        e["gate_up"] = (e["gate_up"] * 60.0).astype(np.float32)
    params["norm"] = (params["norm"] + rng.normal(0, 0.2, params["norm"].shape)).astype(np.float32)
    if dtype != jnp.float32:
        params = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)), params)
    if bits:
        for layer in params["layers"]:
            for key in ("q_proj", "k_proj", "v_proj", "o_proj"):
                layer[key] = jquant.quantize(layer[key], bits=bits)
            for key in ("gate_up", "down"):
                layer["gptoss_experts"][key] = jquant.quantize_stacked(layer["gptoss_experts"][key], bits=bits)
    return params


def models(seed=0, dtype=jnp.float32, bits=None):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    jcfg = jllama.ModelConfig.from_hf_config(GPTOSS_HF)
    tcfg = tllama.ModelConfig.from_hf_config(GPTOSS_HF)
    params = jax_params(jcfg, seed, dtype, bits)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), tcfg, tllama.LlamaModel(tcfg, params_from_jax(params))


FIELDS = ("model_type", "sliding_window", "layer_types", "attention_bias", "num_local_experts",
          "num_experts_per_tok", "rope_scaling", "rope_theta", "head_dim", "rope_interleave", "moe_layers",
          "attention_chunk_size", "qk_norm_l2", "attn_temperature_tuning", "tie_word_embeddings")


def test_config_fields_and_tables_match_jax():
    """from_hf_config reads GPT-OSS's windows, biases, experts and yarn rope
    as the JAX config does; its layer tables alternate sliding and full."""
    jcfg = jllama.ModelConfig.from_hf_config(GPTOSS_HF)
    tcfg = tllama.ModelConfig.from_hf_config(GPTOSS_HF)
    for name in FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for i in range(2):
        for table in ("layer_is_sliding", "layer_is_moe", "layer_uses_rope", "layer_is_chunked"):
            assert getattr(tcfg, table)(i) == getattr(jcfg, table)(i), (table, i)
    assert tcfg.has_sinks and tcfg.layer_is_sliding(0) and not tcfg.layer_is_sliding(1)
    for ours, theirs in zip(tllama.rope_tables(tcfg, 64), jllama.rope_tables(jcfg, 64)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_sink_attention_matches_jax():
    """One attention call with sinks, q/k/v/o biases and the sliding mask:
    the sink column joins the normalization without being materialized;
    the port's output and cache within f32 1e-6 of JAX ``_attention``."""
    jcfg, jparams, tcfg, model = models(seed=3)
    layer = jax.tree_util.tree_map(np.asarray, jparams["layers"][0])
    B, T, S = 2, 5, 8
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, T, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    mask = np.where((np.arange(S)[None, None, :] <= pos[:, :, None]) & (np.arange(S) > pos[:, :, None] - 3),
                    0.0, -1e9).astype(np.float32)
    cos, sin = jllama.rope_tables(jcfg, S)
    kv = jllama.init_kv_cache(jcfg, B, S, jnp.float32)
    want, kb, _ = jllama._attention(jcfg, jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x), cos, sin,
                                    jnp.asarray(pos), (kv["k"], kv["v"]), 0, 0, jnp.asarray(mask))
    tkv = tllama.init_kv_cache(tcfg, B, S, torch.float32)
    tcos, tsin = tllama.rope_tables(tcfg, S)
    with torch.inference_mode():
        got = model.layers[0].self_attn(torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos), tkv, 0, 0,
                                        torch.from_numpy(mask[:, :, :T]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(kb), rtol=1e-6, atol=1e-6)
    assert model.layers[0].self_attn.sinks is not None and model.layers[0].self_attn.o_bias is not None


def test_router_indices_and_weights_match_jax_on_planted_ties():
    """The biased router through an identity gate (x's first n_exp columns
    are the logits, the bias zero): top-k of the raw logits bit for bit
    against jax.lax.top_k, exact ties planted at the k-th place; the
    softmax weights within 4 f32 ulps."""
    n = 8
    logits, eye = _router_inputs(n, seed=2)
    cfg = tllama.ModelConfig(model_type="gpt_oss", num_local_experts=n, num_experts_per_tok=2)
    jcfg = jllama.ModelConfig(model_type="gpt_oss", num_local_experts=n, num_experts_per_tok=2)
    zero = np.zeros(n, np.float32)
    ours = tllama.gptoss_router_scores(cfg, torch.from_numpy(eye), torch.from_numpy(zero),
                                       torch.from_numpy(logits[None])).numpy()[0]
    theirs = np.asarray(jllama.gptoss_router_scores(jcfg, {"moe_gate": jnp.asarray(eye),
                                                           "moe_gate_bias": jnp.asarray(zero)},
                                                    jnp.asarray(logits[None])))[0]
    np.testing.assert_array_equal(ours != 0, theirs != 0)
    _, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(np.sort(np.argsort(-ours, kind="stable")[:, :2], -1), np.sort(np.asarray(jidx), -1))
    np.testing.assert_allclose(ours, theirs, rtol=4.8e-7, atol=0)


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_expert_block_matches_jax(bits):
    """The clamped-SwiGLU block on f32 tokens: interleaved gate/up columns,
    asymmetric clamps (gate values past 7 planted), biases, the f32
    score-weighted sum; raw and quantized stacks, relL2 1e-5."""
    jcfg, jparams, tcfg, model = models(seed=5, bits=bits)
    x = np.random.default_rng(6).normal(0, 1, (2, 7, 64)).astype(np.float32)
    theirs = jllama._ffn(jcfg, jparams["layers"][1], jnp.asarray(x))
    with torch.inference_mode():
        ours = model.layers[1].mlp(torch.from_numpy(x))
    assert rel_l2(ours.numpy(), theirs) <= 1e-5
    gu = np.asarray(jquant.dequant_stacked(jparams["layers"][1]["gptoss_experts"]["gate_up"], jnp.float32)
                    if bits else jparams["layers"][1]["gptoss_experts"]["gate_up"])
    assert (np.einsum("btd,edi->btei", x, gu)[..., ::2] > 7).any()  # the clamp bites


# the bf16 logits' worst reading on these inputs is 0 (prefill and both decode steps bit-equal to
# JAX's): held at 1e-5, the f32 class, as
# tests/test_torch_moe.py holds the families that read below it
@pytest.mark.parametrize("kind", ["f32", "bf16", "int4", "int8"])
def test_logits_match_jax(kind):
    """A left-padded prefill and two decode steps (the sliding layer's
    window masking slots): logits within relL2 1e-5 of the JAX forward in
    f32, bf16 and with int4 / int8 projections and stacks (f32 tokens)."""
    dtype = {"bf16": (jnp.bfloat16, torch.bfloat16)}.get(kind, (jnp.float32, torch.float32))
    bits = {"int4": 4, "int8": 8}.get(kind)
    jcfg, jparams, tcfg, model = models(seed=1, dtype=dtype[0], bits=bits)
    for ours, theirs in _forward_pair(jcfg, jparams, tcfg, model, dtype):
        assert rel_l2(ours, theirs) <= 1e-5, kind


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_stacked_matches_jax_bit_for_bit(bits):
    """q3 (split-half packed on the middle axis at 4 bits) and scale equal
    the JAX host quantizer's and its device one's; dequant_stacked equals
    JAX's."""
    w = np.random.default_rng(bits).normal(0, 0.5, (4, 64, 96)).astype(np.float32)
    w[1, :, 3] = 0.0  # an all-zero channel: the 1e-12 scale floor
    ours = tquant.quantize_stacked(torch.from_numpy(w), bits)
    for theirs in (jquant.quantize_stacked(w, bits), jquant.quantize_stacked(jnp.asarray(w), bits)):
        np.testing.assert_array_equal(ours["q3"].numpy(), np.asarray(theirs["q3"]))
        np.testing.assert_array_equal(ours["scale"].numpy(), np.asarray(theirs["scale"]))
    assert ours["q3"].shape == ((4, 32, 96) if bits == 4 else (4, 64, 96))
    np.testing.assert_array_equal(tquant.dequant_stacked(ours, torch.float32).numpy(),
                                  np.asarray(jquant.dequant_stacked(theirs, jnp.float32)))


def test_dequant_mxfp4_matches_jax_bit_for_bit():
    """Seeded blocks under every one of the 256 scale bytes (0: subnormal
    results, 255: overflow to inf): the f32 decode equals JAX's numpy
    decode bit for bit, signed zeros and infinities included."""
    rng = np.random.default_rng(8)
    blocks = rng.integers(0, 256, (2, 128, 4, 16), dtype=np.uint8)
    scales = np.arange(256, dtype=np.uint8).reshape(2, 128)[:, :, None].repeat(4, axis=2)
    scales[1, :, 1::2] = rng.integers(0, 256, (128, 2), dtype=np.uint8)
    with np.errstate(over="ignore"):
        theirs = jquant.dequant_mxfp4(blocks, scales)
    ours = tquant.dequant_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales)).numpy()
    assert ours.shape == theirs.shape == (2, 128, 128)
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    assert np.isinf(ours).any() and (np.abs(ours[ours != 0]) < np.finfo(np.float32).tiny).any()
    with pytest.raises(ValueError, match="MXFP4 shape"):
        tquant.dequant_mxfp4(torch.from_numpy(blocks[..., :8]), torch.from_numpy(scales))


def test_params_from_jax_carries_sinks_biases_and_stacks():
    """sinks, o_bias, moe_gate_bias and the gptoss_experts dict come across
    bit for bit, raw and as int4 ``q3`` leaves, with the port's layer
    keys."""
    for bits in (None, 4):
        jcfg = jllama.ModelConfig.from_hf_config(GPTOSS_HF)
        params = jax_params(jcfg, seed=2, dtype=jnp.bfloat16, bits=bits)
        ported = params_from_jax(params)
        for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
            got = ported
            for p in path:
                got = got[p.key if hasattr(p, "key") else p.idx]
            if value.dtype.name == "bfloat16":
                got, value = got.view(torch.uint16), value.view(np.uint16)
            np.testing.assert_array_equal(got.numpy(), value, err_msg=str(path))
        tcfg = tllama.ModelConfig.from_hf_config(GPTOSS_HF)
        assert set(ported["layers"][0]) == tllama.layer_keys(tcfg, 0)
        assert set(ported["layers"][0]["gptoss_experts"]) == tllama.STACK_KEYS["gptoss_experts"]
        assert isinstance(ported["layers"][0]["gptoss_experts"]["gate_up"], dict) == bool(bits)


def test_init_params_has_the_jax_layout():
    """The port's own random GPT-OSS params: the JAX init's leaves and
    shapes; ``project`` takes the four attention projections, and
    ``project_stacked`` the two stacks, of each layer."""
    theirs = jax.tree_util.tree_map(np.shape, jllama.init_params(jllama.ModelConfig.from_hf_config(GPTOSS_HF),
                                                                 jax.random.PRNGKey(0), jnp.float32))
    cfg = tllama.ModelConfig.from_hf_config(GPTOSS_HF)
    seen, stacks = [], []
    ours = tllama.init_params(cfg, seed=0, dtype=torch.float32, project=lambda w: seen.append(w) or w,
                              project_stacked=lambda w: stacks.append(w.shape) or w)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == theirs
    assert len(seen) == 8 and stacks == [(4, 64, 96), (4, 48, 64)] * 2


def test_decode_routes_sinks_to_the_counted_einsum_path():
    """On a CUDA tensor a GPT-OSS T=1 attention takes the einsum path,
    counted under decode_einsum, as the JAX route refuses sinks; the same
    geometry without sinks takes the kernel."""
    class Cuda:
        is_cuda = True

    cfg = tllama.ModelConfig.from_hf_config({**GPTOSS_HF, "head_dim": 64})  # a kernel head dim
    plain = tllama.ModelConfig.from_hf_config({**GPTOSS_HF, "head_dim": 64, "model_type": "mistral"})
    attn_kernels.reset_launch_counts()
    assert attn_kernels.use_flash_decode(cfg, 1, Cuda()) is False
    assert attn_kernels.use_flash_decode(plain, 1, Cuda()) is True
    assert attn_kernels.launch_counts["decode_einsum"] == 1


def _hf_checkpoint(path, seed=14):
    """tests/test_models.py:1723's transformers GPT-OSS, every bias, the
    sinks and the norms randomized, saved in HF naming."""
    from transformers import GptOssConfig, GptOssForCausalLM

    torch.manual_seed(seed)
    hf = {k: v for k, v in GPTOSS_HF.items() if k not in ("model_type", "layer_types", "rope_scaling", "rope_theta")}
    model = GptOssForCausalLM(GptOssConfig(**hf)).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "sinks")) or "norm" in name:
                p.add_(torch.rand(p.shape) * 0.6 - 0.3)
    model.save_pretrained(str(path), safe_serialization=True)
    return model


def _compare_loaders(path, bits):
    cfg_json = json.loads((path / "config.json").read_text())
    jcfg = jllama.ModelConfig.from_hf_config(cfg_json)
    theirs = jax.tree_util.tree_map(np.asarray, jloader.load_params(path, jcfg, dtype=jnp.float32, quant_bits=bits))
    ours = tloader.load_params(path, tllama.ModelConfig.from_hf_config(cfg_json), dtype=torch.float32,
                               quant_bits=bits)
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_o = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0])
    assert len(flat_t) == len(flat_o)
    for p, value in flat_t:
        np.testing.assert_array_equal(flat_o[p], value, err_msg=str(p))
    return ours


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_loader_maps_gptoss_names_as_jax(tmp_path, bits):
    """A transformers checkpoint (router and its bias, sinks, o_proj bias,
    the fused stacks and their biases) loads to the JAX loader's leaves bit
    for bit, the stacks quantized per (expert, output channel) at 4 and 8
    bits."""
    _hf_checkpoint(tmp_path)
    ours = _compare_loaders(tmp_path, bits)
    assert isinstance(ours["layers"][1]["gptoss_experts"]["down"], dict) == bool(bits)


def _mxfp4_checkpoint(src, dst, split: bool):
    """``src``'s stacks replaced by seeded MXFP4 blocks and scales; with
    ``split`` layer 0's gate_up halves land in two shards."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, save_file

    with SafeTensorsReader(src / "model.safetensors") as r:
        tensors = {k: r.get_tensor(k).clone() for k in r.keys()}
    rng = np.random.default_rng(34)
    shapes = {"gate_up_proj": (4, 128, 2, 16), "down_proj": (4, 64, 2, 16)}
    out = {}
    for k, v in tensors.items():
        stem = k.rsplit(".", 1)[-1]
        if stem in shapes and ".experts." in k:
            out[k + "_blocks"] = torch.from_numpy(rng.integers(0, 256, shapes[stem], dtype=np.uint8))
            out[k + "_scales"] = torch.from_numpy(rng.integers(121, 131, shapes[stem][:-1], dtype=np.uint8))
        else:
            out[k] = v
    dst.mkdir()
    cfg = json.loads((src / "config.json").read_text())
    cfg["quantization_config"] = {"quant_method": "mxfp4"}
    (dst / "config.json").write_text(json.dumps(cfg))
    lone = "model.layers.0.mlp.experts.gate_up_proj_scales"
    shards = {"model-1.safetensors": {k: v for k, v in out.items() if not (split and k == lone)}}
    if split:
        shards["model-2.safetensors"] = {lone: out[lone]}
    for name, part in shards.items():
        save_file(part, dst / name)
    (dst / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, part in shards.items() for k in part}}))
    return out


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_mxfp4_checkpoint_with_split_halves_loads_as_jax(tmp_path, bits):
    """An MXFP4 GPT-OSS checkpoint (``quant_method: mxfp4``, intermediate
    64 so both contraction dims are multiples of 32) whose layer-0 gate_up
    blocks and scales sit in different shards: the leaves equal the JAX
    loader's bit for bit at 0, 4 and 8 bits."""
    from transformers import GptOssConfig, GptOssForCausalLM

    torch.manual_seed(33)
    hf = {k: v for k, v in GPTOSS_HF.items() if k not in ("model_type", "layer_types", "rope_scaling", "rope_theta")}
    GptOssForCausalLM(GptOssConfig(**{**hf, "intermediate_size": 64})).eval().save_pretrained(
        str(tmp_path / "src"), safe_serialization=True)
    _mxfp4_checkpoint(tmp_path / "src", tmp_path / "mx", split=True)
    ours = _compare_loaders(tmp_path / "mx", bits)
    gate_up = ours["layers"][0]["gptoss_experts"]["gate_up"]
    assert tuple((gate_up["q3"] if bits else gate_up).shape) == {None: (4, 64, 128), 4: (4, 32, 128),
                                                                  8: (4, 64, 128)}[bits]


def test_lone_mxfp4_half_is_refused_by_name(tmp_path):
    """Blocks without their scales: ValueError naming MXFP4, as JAX."""
    from transformers import GptOssConfig, GptOssForCausalLM

    torch.manual_seed(35)
    hf = {k: v for k, v in GPTOSS_HF.items() if k not in ("model_type", "layer_types", "rope_scaling", "rope_theta")}
    GptOssForCausalLM(GptOssConfig(**{**hf, "intermediate_size": 64})).eval().save_pretrained(
        str(tmp_path / "src"), safe_serialization=True)
    _mxfp4_checkpoint(tmp_path / "src", tmp_path / "mx", split=True)
    (tmp_path / "mx" / "model-2.safetensors").unlink()
    index = json.loads((tmp_path / "mx" / "model.safetensors.index.json").read_text())
    index["weight_map"] = {k: v for k, v in index["weight_map"].items() if v == "model-1.safetensors"}
    (tmp_path / "mx" / "model.safetensors.index.json").write_text(json.dumps(index))
    cfg = tllama.ModelConfig.from_pretrained(tmp_path / "mx")
    with pytest.raises(ValueError, match="MXFP4"):
        tloader.load_params(tmp_path / "mx", cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="MXFP4"):
        jloader.load_params(tmp_path / "mx", jllama.ModelConfig.from_pretrained(tmp_path / "mx"), dtype=jnp.float32)


def test_decode_matches_the_full_forward():
    """Prefill of 4 tokens and T=1 decodes of 5 more (past the 3-slot
    window) give the logits of one full forward, within 1e-5."""
    _, _, tcfg, model = models(seed=9)
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, 128, (1, 9)))
    S = 16
    rope = tllama.rope_tables(tcfg, S)
    pos = torch.arange(9)[None]
    with torch.inference_mode():
        full, _ = model(ids, pos, tllama.init_kv_cache(tcfg, 1, S, torch.float32), 0, rope, 9)
        kv = tllama.init_kv_cache(tcfg, 1, S, torch.float32)
        logits, kv = model(ids[:, :4], pos[:, :4], kv, 0, rope, 4)
        steps = [logits[:, -1]]
        for t in range(4, 9):
            logits, kv = model(ids[:, t:t + 1], pos[:, t:t + 1], kv, t, rope, t + 1)
            steps.append(logits[:, 0])
    for i, got in enumerate(steps):
        assert rel_l2(got.numpy(), full[:, 3 + i].numpy()) <= 1e-5


def test_greedy_stream_batch_pool_and_decode_chunk_match_jax():
    """The greedy stream, a ragged lockstep batch and a staggered 2-slot
    pool (a frontier jump, so rows carry gaps) give the JAX engine's and
    pool's tokens; --decode-chunk 3 gives the stream's."""
    jcfg, jparams, tcfg, model = models(seed=11)
    jeng = JaxEngine(jcfg, jparams, NoEosTokenizer())
    teng = InferenceEngine(tcfg, model, NoEosTokenizer())
    kw = dict(max_new_tokens=6, greedy=True, use_template=False)
    stream = "".join(teng.stream_generation("sinks route tokens", **kw))
    assert stream == "".join(jeng.stream_generation("sinks route tokens", **kw))
    assert stream == "".join(teng.stream_generation("sinks route tokens", decode_chunk=3, **kw))
    prompts = ["hello there", "a", "the quick brown fox"]
    assert teng.generate_batch(prompts, **kw) == jeng.generate_batch(prompts, **kw)
    requests = [("gpt-oss pool row", 10), ("a late and longer joiner", 8), ("third", 9)]
    outs = []
    for eng, pool_cls in ((teng, ContinuousEngine), (jeng, JaxPool)):
        pool = pool_cls(eng, slots=2, cache_len=256, greedy=True, use_template=False)
        handles = [pool.submit(requests[0][0], max_new_tokens=requests[0][1])]
        pool._admit_pending()
        for _ in range(4):
            pool._step()
            pool._admit_pending()
        handles += [pool.submit(p, max_new_tokens=n) for p, n in requests[1:]]
        pool.run_until_idle()
        outs.append(([h.result(0) for h in handles], pool.stats["frontier_jumps"]))
    assert outs[0] == outs[1] and outs[0][1] >= 1
    assert outs[0][0] == ["".join(teng.stream_generation(p, max_new_tokens=n, greedy=True, use_template=False))
                          for p, n in requests]


SYSTEM = "You are a helpful assistant. " * 4  # 116 tokens


def test_prefix_hit_and_speculative_rounds_match_jax():
    """GPT-OSS as the target of a dense draft with the prefix cache on:
    tokens, hit lengths and speculative rounds equal the JAX engine's, and
    the plain stream's."""
    jcfg, jparams, tcfg, model = models(seed=12)
    draft_hf = {"model_type": "llama", "vocab_size": 128, "hidden_size": 32, "intermediate_size": 64,
                "num_hidden_layers": 1, "num_attention_heads": 2, "num_key_value_heads": 1,
                "max_position_embeddings": 256}
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


def test_pool_compaction_matches_jax():
    """Five 100-token requests through a 2-slot, 256-slot pool, each joining
    30 steps after the last (tests/test_batching.py's compaction schedule):
    the rows compact, and the tokens and pool counters equal the JAX
    pool's, every completion its solo stream's."""
    jcfg, jparams, tcfg, model = models(seed=13)
    jeng = JaxEngine(jcfg, jparams, NoEosTokenizer())
    teng = InferenceEngine(tcfg, model, NoEosTokenizer())
    prompts = [f"prompt number {i}" for i in range(5)]
    pools = []
    for eng, pool_cls in ((teng, ContinuousEngine), (jeng, JaxPool)):
        pool = pool_cls(eng, slots=2, cache_len=256, greedy=True, use_template=False)
        handles = []
        for prompt in prompts:
            handles.append(pool.submit(prompt, max_new_tokens=100))
            pool._admit_pending()
            for _ in range(30):
                pool._step()
                pool._admit_pending()
        pool.run_until_idle()
        pools.append((pool, handles))
    (ours, got), (theirs, want) = pools
    assert [h.token_ids for h in got] == [h.token_ids for h in want]
    for key in ("joins", "frontier_jumps", "compactions"):
        assert ours.stats[key] == theirs.stats[key], key
    assert ours.stats["compactions"] >= 1
    for prompt, h in zip(prompts, got):
        assert h.result(0) == "".join(teng.stream_generation(prompt, max_new_tokens=100, greedy=True,
                                                             use_template=False))
