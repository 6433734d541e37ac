"""Port vs JAX: Llama-4 (shardmerge_tpu_torch/models/llama.py, quant.py,
loader.py, convert.py, inference.py, batching.py against the JAX
package's) on ``_tiny_llama4`` of tests/test_models.py:2531: 4 layers,
MoE on layers 1 and 3, NoPE on layer 3, chunks of 4 positions.

JAX's ``init_params`` builds no Llama-4 stacks, so the weights are a
seeded transformers checkpoint (norms noised) read by the JAX loader, then
carried across with ``params_from_jax``; the port's own loader is held to
the JAX loader's leaves bit for bit. The L2 q/k norm, the NoPE temperature
and the masks are held at f32 1e-6 (masks equal), router indices bit for
bit on planted ties, router weights within 4 f32 ulps, the expert block
and the logits at relL2 1e-5, greedy tokens, pools and prefix-cache hits
exactly."""

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
from shardmerge_tpu_torch.batching import ContinuousEngine
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import attn_kernels as ak
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models import loader as tloader
from shardmerge_tpu_torch.models.convert import params_from_jax
from tests.test_torch_mla import NoEosTokenizer
from tests.test_torch_moe import StubTokenizer, _forward_pair, _router_inputs, rel_l2

# tests/test_models.py:2531's Llama4TextConfig
LLAMA4_TEXT = {
    "vocab_size": 128, "hidden_size": 64, "intermediate_size": 48, "intermediate_size_mlp": 96,
    "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_local_experts": 4, "num_experts_per_tok": 2, "interleave_moe_layer_step": 2, "no_rope_layers": [1, 1, 1, 0],
    "attention_chunk_size": 4, "attn_temperature_tuning": True, "floor_scale": 2.0, "attn_scale": 0.1,
    "use_qk_norm": True, "max_position_embeddings": 256, "tie_word_embeddings": False, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0,
}


def _save(model, path, wrapped: bool):
    """Save ``model`` in HF naming; ``wrapped`` writes the multimodal form:
    every decoder tensor under ``language_model.`` and the geometry in
    ``text_config``."""
    from shardmerge_tpu_torch.io.safetensors_io import save_file

    model.save_pretrained(str(path), safe_serialization=True)
    if wrapped:
        from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader

        with SafeTensorsReader(path / "model.safetensors") as r:
            tensors = {"language_model." + k: r.get_tensor(k).clone() for k in r.keys()}
        save_file(tensors, path / "model.safetensors")
        text = json.loads((path / "config.json").read_text())
        (path / "config.json").write_text(json.dumps({"model_type": "llama4", "text_config": text}))
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{"text": dir, "wrapped": dir}: the tiny transformers Llama-4 (seed
    21, norms noised), plain and in the multimodal layout."""
    from transformers import Llama4ForCausalLM, Llama4TextConfig

    torch.manual_seed(21)
    model = Llama4ForCausalLM(Llama4TextConfig(**LLAMA4_TEXT)).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn(p.shape) * 0.2)
    root = tmp_path_factory.mktemp("llama4")
    return {kind: _save(model, root / kind, kind == "wrapped") for kind in ("text", "wrapped")}


def models(path, dtype=jnp.float32, bits=None):
    """(JAX cfg, JAX params, port cfg, port model) on the JAX loader's
    weights of ``path``."""
    cfg_json = json.loads((path / "config.json").read_text())
    jcfg = jllama.ModelConfig.from_hf_config(cfg_json)
    tcfg = tllama.ModelConfig.from_hf_config(cfg_json)
    params = jax.tree_util.tree_map(np.asarray, jloader.load_params(path, jcfg, dtype=dtype, quant_bits=bits))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), tcfg, tllama.LlamaModel(tcfg, params_from_jax(params))


FIELDS = ("model_type", "moe_layers", "attention_chunk_size", "attn_temperature_tuning", "floor_scale",
          "attn_scale", "qk_norm_l2", "layer_types", "no_rope_layers", "rope_interleave", "num_local_experts",
          "num_experts_per_tok", "sliding_window", "head_dim", "rope_scaling", "tie_word_embeddings")
TABLES = ("layer_is_moe", "layer_is_chunked", "layer_uses_rope", "layer_is_sliding")


@pytest.mark.parametrize("form", ["text", "wrapped", "derived"])
def test_config_fields_and_derived_tables_match_jax(form):
    """llama4_text, the multimodal ``llama4`` wrapper, and a config.json
    without the per-layer tables (HF derives NoPE every 4th layer, MoE
    every interleave_moe_layer_step-th, chunked attention on the rope
    layers): the same fields and tables as the JAX config."""
    text = {**LLAMA4_TEXT, "model_type": "llama4_text"}
    if form == "derived":
        text = {k: v for k, v in text.items() if k not in ("no_rope_layers",)}
        text["num_hidden_layers"] = 8
    hf = {"model_type": "llama4", "text_config": text} if form == "wrapped" else text
    jcfg, tcfg = jllama.ModelConfig.from_hf_config(hf), tllama.ModelConfig.from_hf_config(hf)
    for name in FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for i in range(tcfg.num_hidden_layers):
        for table in TABLES:
            assert getattr(tcfg, table)(i) == getattr(jcfg, table)(i), (table, i)
    assert tcfg.model_type == "llama4_text" and tcfg.intermediate_size_mlp == 96
    assert tcfg.moe_layers == ((1, 3) if form != "derived" else (1, 3, 5, 7))
    assert [tcfg.layer_is_chunked(i) for i in range(4)] == [True, True, True, False]


def test_l2_qk_and_nope_temperature_match_jax():
    """The weightless L2 q/k norm and the NoPE query temperature (positions
    past several floor_scale multiples, so log1p's argument grows) within
    f32 1e-6 of JAX's, bf16 inputs rounded as JAX rounds them."""
    cfg = tllama.ModelConfig.from_hf_config({**LLAMA4_TEXT, "model_type": "llama4_text"})
    jcfg = jllama.ModelConfig.from_hf_config({**LLAMA4_TEXT, "model_type": "llama4_text"})
    rng = np.random.default_rng(0)
    q = rng.normal(0, 3, (2, 4, 9, 16)).astype(np.float32)
    k = rng.normal(0, 3, (2, 2, 9, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(1000, 1009)]).astype(np.int64)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tq, tk = torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype)
        jq, jk = jnp.asarray(q, jdtype), jnp.asarray(k, jdtype)
        for ours, theirs in zip(tllama.l2_qk(cfg, tq, tk), jllama._l2_qk(jcfg, jq, jk)):
            np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), rtol=1e-6, atol=1e-6)
        ours = tllama.nope_temp_q(cfg, tq, torch.from_numpy(pos))
        theirs = jllama._nope_temp_q(jcfg, jq, jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), rtol=1e-6, atol=1e-6)
    assert not torch.equal(tllama.nope_temp_q(cfg, torch.ones(1, 1, 2, 1), torch.tensor([[0, 1000]]))[0, 0, 1],
                           torch.ones(1))


def _masks_of(monkeypatch, run_port, run_jax):
    """Each layer's mask as the port's Attention and JAX's _attention
    receive it."""
    seen = {"port": {}, "jax": {}}
    orig_t, orig_j = tllama.Attention.forward, jllama._attention

    def port_attn(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots=None):
        seen["port"][layer_idx] = mask.numpy().copy()
        return orig_t(self, x, cos, sin, positions, kv_cache, layer_idx, cache_pos, mask, slots)

    def jax_attn(cfg, layer, x, cos, sin, positions, kv_bufs, layer_idx, cache_pos, mask, **kw):
        seen["jax"][layer_idx] = np.asarray(mask)
        return orig_j(cfg, layer, x, cos, sin, positions, kv_bufs, layer_idx, cache_pos, mask, **kw)

    monkeypatch.setattr(tllama.Attention, "forward", port_attn)
    monkeypatch.setattr(jllama, "_attention", jax_attn)
    with torch.inference_mode():
        run_port()
    run_jax()
    return seen


@pytest.mark.parametrize("case", ["left-padded", "pooled"])
def test_chunked_masks_match_jax(monkeypatch, checkpoints, case):
    """The chunked layers' and the NoPE layer's masks equal JAX's over the
    first attn_len slots (JAX's later slots all masked): a left-padded
    prefill (keys at slot minus the row's pad) and a pool decode step whose
    rows carry join gaps (``key_positions``), a row past a chunk boundary."""
    jcfg, jparams, tcfg, model = models(checkpoints["text"])
    S = 32
    if case == "left-padded":
        T, attn_len = 11, 11
        ids = np.random.default_rng(3).integers(2, 128, (2, T))
        pad = np.array([0, 3])
        slot = np.broadcast_to(np.arange(T), (2, T))
        pos = np.maximum(slot - pad[:, None], 0)
        valid = np.arange(S)[None, :] >= pad[:, None]
        kw = dict(mask_positions=slot, token_valid=valid)
    else:
        T, attn_len = 1, 20
        ids = np.array([[5], [60]])
        # row 0: a 7-token prompt, a gap over slots 7-14, decoded slots 15-19
        # at positions 7-11; row 1: contiguous 0-19
        kp = np.zeros((2, S), np.int64)
        kp[0, :7] = np.arange(7)
        kp[0, 15:20] = np.arange(7, 12)
        kp[1, :20] = np.arange(20)
        valid = np.ones((2, S), bool)
        valid[0, 7:15] = False
        pos = np.array([[11], [19]])
        kw = dict(mask_positions=np.array([[19], [19]]), token_valid=valid, key_positions=kp)
    cache_pos = 0 if T > 1 else attn_len - 1
    tkv = tllama.init_kv_cache(tcfg, 2, S, torch.float32)
    jkv = jllama.init_kv_cache(jcfg, 2, S, jnp.float32)
    seen = _masks_of(
        monkeypatch,
        lambda: model(torch.from_numpy(ids), torch.from_numpy(pos), tkv, cache_pos, tllama.rope_tables(tcfg, S),
                      attn_len, **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()}),
        lambda: jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv, cache_pos,
                               jllama.rope_tables(jcfg, S), attn_len, **{k: jnp.asarray(v) for k, v in kw.items()}))
    for i in range(4):
        ours, theirs = seen["port"][i], seen["jax"][i]
        np.testing.assert_array_equal(ours, theirs[..., :attn_len], err_msg=str(i))
        assert (theirs[..., attn_len:] == np.float32(-1e9)).all()
    chunked, full = seen["port"][0], seen["port"][3]
    assert (chunked != full).any()  # the chunks bite
    if case == "pooled":
        # row 0 at position 11 sees only positions 8-11: slots 16-19
        assert list(np.flatnonzero(chunked[0, 0] == 0)) == [16, 17, 18, 19]


def test_router_indices_and_weights_match_jax_on_planted_ties():
    """The router through an identity gate: the top-k of the f32 logits bit
    for bit against jax.lax.top_k (exact ties planted at the k-th place),
    the sigmoid of the selected logits within 4 f32 ulps of JAX's."""
    n = 8
    logits, eye = _router_inputs(n, seed=3)
    cfg = tllama.ModelConfig(model_type="llama4_text", num_local_experts=n, num_experts_per_tok=2)
    ours = tllama.llama4_router_scores(cfg, torch.from_numpy(eye), torch.from_numpy(logits)).numpy()
    _, jidx = jax.lax.top_k(jnp.asarray(logits), 2)
    sel = np.asarray(jnp.sum(jax.nn.one_hot(jidx, n, dtype=jnp.float32), axis=1))
    theirs = np.asarray(jax.nn.sigmoid(jnp.asarray(logits))) * sel
    np.testing.assert_array_equal(ours != 0, sel != 0)
    np.testing.assert_allclose(ours, theirs, rtol=4.8e-7, atol=0)


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_expert_block_matches_jax(checkpoints, bits):
    """The input-scaled sigmoid top-k block (f32 experts over contiguous
    gate/up halves, stacks dequantized to f32) plus the shared expert:
    relL2 1e-5 of JAX ``_ffn``, raw and int4 / int8 stacks."""
    jcfg, jparams, tcfg, model = models(checkpoints["text"], bits=bits)
    x = np.random.default_rng(6).normal(0, 1, (2, 7, 64)).astype(np.float32)
    theirs = jllama._ffn(jcfg, jparams["layers"][1], jnp.asarray(x))
    with torch.inference_mode():
        ours = model.layers[1].mlp(torch.from_numpy(x))
    assert isinstance(model.layers[1].mlp, tllama.Llama4MoE) and isinstance(model.layers[0].mlp, tllama.MLP)
    assert rel_l2(ours.numpy(), theirs) <= 1e-5


# the bf16 logits' worst reading on these inputs is 1.32e-07 (the prefill; both decode steps
# bit-equal to JAX's): held at 1e-5, the f32 class, as
# tests/test_torch_moe.py holds the families that read below it
@pytest.mark.parametrize("kind", ["f32", "bf16", "int4", "int8"])
def test_logits_match_jax(checkpoints, kind):
    """A left-padded 9-token prefill (chunks of 4 cut it) and two decode
    steps: logits within relL2 1e-5 of the JAX forward in f32, bf16, and
    with int4 / int8 projections and stacks."""
    dtype = {"bf16": (jnp.bfloat16, torch.bfloat16)}.get(kind, (jnp.float32, torch.float32))
    bits = {"int4": 4, "int8": 8}.get(kind)
    jcfg, jparams, tcfg, model = models(checkpoints["text"], dtype=dtype[0], bits=bits)
    for ours, theirs in _forward_pair(jcfg, jparams, tcfg, model, dtype):
        assert rel_l2(ours, theirs) <= 1e-5, kind


@pytest.mark.parametrize("form,bits", [(f, b) for f in ("text", "wrapped") for b in (None, 4, 8)])
def test_loader_maps_llama4_names_as_jax(checkpoints, form, bits):
    """The router, fused stacks, shared expert and the dense layers'
    feed_forward MLP, with and without the multimodal ``language_model.``
    prefix: the JAX loader's leaves bit for bit at 0, 4 and 8 bits."""
    path = checkpoints[form]
    cfg_json = json.loads((path / "config.json").read_text())
    theirs = jax.tree_util.tree_map(np.asarray, jloader.load_params(
        path, jllama.ModelConfig.from_hf_config(cfg_json), dtype=jnp.float32, quant_bits=bits))
    ours = tloader.load_params(path, tllama.ModelConfig.from_hf_config(cfg_json), dtype=torch.float32,
                               quant_bits=bits)
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_o = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0])
    assert len(flat_t) == len(flat_o)
    for p, value in flat_t:
        np.testing.assert_array_equal(flat_o[p], value, err_msg=str(p))
    assert isinstance(ours["layers"][3]["llama4_experts"]["gate_up"], dict) == bool(bits)
    assert ours["layers"][0]["gate_proj"].shape[0] == 96 if not bits else True


def test_moe_layers_mismatch_is_refused(tmp_path, checkpoints):
    """A config whose moe_layers table disagrees with the expert stacks
    present is refused by both loaders, naming moe_layers."""
    import shutil

    shutil.copytree(checkpoints["text"], tmp_path / "m")
    cfg_json = json.loads((tmp_path / "m" / "config.json").read_text())
    cfg_json["moe_layers"] = [1, 2]
    (tmp_path / "m" / "config.json").write_text(json.dumps(cfg_json))
    with pytest.raises(ValueError, match="moe_layers"):
        tloader.load_params(tmp_path / "m", tllama.ModelConfig.from_hf_config(cfg_json), dtype=torch.float32)
    with pytest.raises(ValueError, match="moe_layers"):
        jloader.load_params(tmp_path / "m", jllama.ModelConfig.from_hf_config(cfg_json), dtype=jnp.float32)


def test_params_from_jax_and_init_params_keep_the_loader_layout(checkpoints):
    """llama4_experts (raw and int4 ``q3``) come across bit for bit with
    the port's layer keys; the port's own init_params builds the loader's
    leaves and shapes (dense feed_forward at intermediate_size_mlp)."""
    path = checkpoints["text"]
    cfg = tllama.ModelConfig.from_pretrained(path)
    for bits in (None, 4):
        theirs = jax.tree_util.tree_map(np.asarray, jloader.load_params(path, jllama.ModelConfig.from_pretrained(path),
                                                                        dtype=jnp.float32, quant_bits=bits))
        ported = params_from_jax(theirs)
        for p, value in jax.tree_util.tree_flatten_with_path(theirs)[0]:
            got = ported
            for key in p:
                got = got[key.key if hasattr(key, "key") else key.idx]
            np.testing.assert_array_equal(got.numpy(), value, err_msg=str(p))
        for i, layer in enumerate(ported["layers"]):
            assert set(layer) == tllama.layer_keys(cfg, i)
    stacks = []
    ours = tllama.init_params(cfg, seed=0, dtype=torch.float32, project_stacked=lambda w: stacks.append(w) or w)
    shapes = jax.tree_util.tree_map(np.shape, theirs)
    ours_raw = jax.tree_util.tree_map(lambda t: tuple(t.shape), ours)
    for i in range(4):
        for key, value in ours_raw["layers"][i].items():
            if key != "llama4_experts" and not isinstance(shapes["layers"][i][key], dict):
                assert value == shapes["layers"][i][key], (i, key)
    assert [tuple(w.shape) for w in stacks] == [(4, 64, 96), (4, 48, 64)] * 2


def test_decode_matches_the_full_forward(checkpoints):
    """A 3-token prefill and T=1 decodes of 5 more (across two chunk
    boundaries, the NoPE layer's temperature moving) give the logits of
    one full forward within 1e-5, as tests/test_models.py:2605 holds JAX."""
    _, _, tcfg, model = models(checkpoints["text"])
    ids = torch.tensor([[5, 99, 14, 73, 21, 8, 120, 44]])
    S = 16
    rope = tllama.rope_tables(tcfg, S)
    pos = torch.arange(8)[None]
    with torch.inference_mode():
        full, _ = model(ids, pos, tllama.init_kv_cache(tcfg, 1, S, torch.float32), 0, rope, 8)
        kv = tllama.init_kv_cache(tcfg, 1, S, torch.float32)
        logits, kv = model(ids[:, :3], pos[:, :3], kv, 0, rope, 3)
        steps = [logits[:, -1]]
        for t in range(3, 8):
            logits, kv = model(ids[:, t:t + 1], pos[:, t:t + 1], kv, t, rope, t + 1)
            steps.append(logits[:, 0])
    for i, got in enumerate(steps):
        assert rel_l2(got.numpy(), full[:, 2 + i].numpy()) <= 1e-5


def test_flash_route_builds_one_slot_list_per_mask_kind(monkeypatch, checkpoints):
    """With the flash route forced on (its plain version on the CPU), a
    decode step hands the three chunked layers one slot list and the NoPE
    layer another, each built from its own mask; the logits equal the
    einsum route's within 1e-5."""
    _, _, tcfg, model = models(checkpoints["text"])
    seen = []
    real = ak.flash_decode

    def recording(q, k, v, mask, slots=None):
        seen.append((mask, slots))
        return real(q, k, v, mask, slots=slots)

    rope = tllama.rope_tables(tcfg, 32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, 128, (2, 10)))
    pos = torch.arange(9)[None].expand(2, 9)
    with torch.inference_mode():
        kv = tllama.init_kv_cache(tcfg, 2, 32, torch.float32)
        _, kv = model(ids[:, :9], pos, kv, 0, rope, 9)
        kv_einsum = {n: t.clone() for n, t in kv.items()}
        want, _ = model(ids[:, 9:], torch.full((2, 1), 9), kv_einsum, 9, rope, 10)
        monkeypatch.setattr(ak, "use_flash_decode", lambda cfg, t, q: t == 1)
        monkeypatch.setattr(ak, "flash_decode", recording)
        got, _ = model(ids[:, 9:], torch.full((2, 1), 9), kv, 9, rope, 10)
    assert len(seen) == 4 and len({id(s) for _, s in seen}) == 2
    assert seen[0][1] is seen[1][1] is seen[2][1] and seen[3][1] is not seen[0][1]
    assert all(torch.equal(m, s.mask) for m, s in seen)
    assert int((seen[0][0] == 0).sum(-1)[0]) == 2 and int((seen[3][0] == 0).sum(-1)[0]) == 10
    assert rel_l2(got.numpy(), want.numpy()) <= 1e-5


def test_stream_batch_pool_decode_chunk_and_prefix_hit_match_jax(checkpoints):
    """A greedy stream across chunk boundaries (C = 4), a ragged lockstep
    batch and a staggered 2-slot pool (rows with join gaps, so
    key_positions decides the chunked mask) give the JAX engine's and
    pool's tokens, --decode-chunk 3 the stream's; a prefix-cache hit
    gives JAX's hit length and tokens and the cold stream's."""
    jcfg, jparams, tcfg, model = models(checkpoints["text"])
    jeng = JaxEngine(jcfg, jparams, NoEosTokenizer())
    teng = InferenceEngine(tcfg, model, NoEosTokenizer())
    kw = dict(max_new_tokens=9, greedy=True, use_template=False)
    stream = "".join(teng.stream_generation("chunks of four", **kw))
    assert stream == "".join(jeng.stream_generation("chunks of four", **kw))
    assert stream == "".join(teng.stream_generation("chunks of four", decode_chunk=3, **kw))
    prompts = ["hello there", "a", "the quick brown fox"]
    assert teng.generate_batch(prompts, **kw) == jeng.generate_batch(prompts, **kw)
    requests = [("llama4 pool row", 10), ("a late and longer joiner", 8), ("third", 9)]
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
    system = "You are a helpful assistant. " * 4  # 116 tokens
    port = InferenceEngine(tcfg, model, StubTokenizer(), prefix_cache_slots=4)
    jcached = JaxEngine(jcfg, jparams, StubTokenizer(), prefix_cache_slots=4)
    for eng in (port, jcached, teng):
        eng.prompt_chunk = 64
    for prompt in (system + "first question", system + "second question?"):
        tmeta, jmeta = {}, {}
        ours = "".join(port.stream_generation(prompt, meta=tmeta, **kw))
        assert ours == "".join(jcached.stream_generation(prompt, meta=jmeta, **kw))
        assert ours == "".join(teng.stream_generation(prompt, **kw))
        assert tmeta["prefix_cache_hit_tokens"] == jmeta["prefix_cache_hit_tokens"]
    assert tmeta["prefix_cache_hit_tokens"] == 64


def test_speculative_stream_matches_jax(checkpoints):
    """Llama-4 as its own draft (k = 3): tokens and rounds equal the JAX
    engine's and the plain stream's."""
    jcfg, jparams, tcfg, model = models(checkpoints["text"])
    port = InferenceEngine(tcfg, model, StubTokenizer(), draft=model, speculation_k=3)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer(), draft=(jcfg, jparams), speculation_k=3)
    kw = dict(max_new_tokens=10, greedy=True, use_template=False)
    ours = "".join(port.stream_generation("speculate across chunks", **kw))
    assert ours == "".join(jeng.stream_generation("speculate across chunks", **kw))
    assert ours == "".join(InferenceEngine(tcfg, model, StubTokenizer()).stream_generation(
        "speculate across chunks", **kw))


def test_pool_compaction_matches_jax(checkpoints):
    """Five 100-token requests through a 2-slot, 256-slot pool, each joining
    30 steps after the last (tests/test_batching.py's compaction schedule):
    the rows compact, and the tokens and pool counters equal the JAX
    pool's, every completion its solo stream's."""
    jcfg, jparams, tcfg, model = models(checkpoints["text"])
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
