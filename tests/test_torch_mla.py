"""Port vs JAX: DeepSeek's multi-head latent attention and its compressed
cache through the engines (shardmerge_tpu_torch/models/llama.py,
inference.py, batching.py against shardmerge_tpu/models/llama.py,
inference.py, batching.py), after tests/test_models.py:2091 and
tests/test_batching.py:532.

Weights come from the JAX ``init_params`` (see tests/test_torch_moe.py).
Caches and logits are held at relL2 1e-5 (f32), tokens, pool completions
and prefix-cache hits exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.batching import ContinuousEngine as JaxPool
from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu_torch import inference as tinference
from shardmerge_tpu_torch.batching import ContinuousEngine
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import llama as tllama
from tests.test_torch_moe import StubTokenizer, models, rel_l2


def test_compressed_cache_layout_matches_jax():
    """ckv (L, B, S, kv_lora_rank) and kpe (L, B, S, qk_rope_head_dim), as
    the JAX cache, and nothing per head."""
    jcfg, _, tcfg, _ = models("deepseek_v3")
    ours = tllama.init_kv_cache(tcfg, 3, 64, torch.float32)
    theirs = jllama.init_kv_cache(jcfg, 3, 64, jnp.float32)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    assert set(ours) == {"ckv", "kpe"}


def test_uninterleave_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(tllama._uninterleave(torch.from_numpy(x)).numpy(),
                                  np.asarray(jllama._uninterleave(jnp.asarray(x))))


@pytest.mark.parametrize("family", ["deepseek_v2", "deepseek_v3"])
def test_mla_decode_through_the_cache_matches_the_full_forward(family):
    """Prefill of 5 tokens and single-token decodes of 4 more through the
    compressed cache give the logits of one full-sequence forward (relL2
    1e-5), and the cache equals the JAX cache after the same calls."""
    jcfg, jparams, tcfg, model = models(family, seed=7)
    ids = np.random.default_rng(1).integers(2, 128, (2, 9))
    S = 16
    rope, jrope = tllama.rope_tables(tcfg, S), jllama.rope_tables(jcfg, S)
    pos = np.broadcast_to(np.arange(9), (2, 9)).copy()
    with torch.inference_mode():
        full, _ = model(torch.from_numpy(ids), torch.from_numpy(pos), tllama.init_kv_cache(tcfg, 2, S, torch.float32),
                        0, rope, 9)
        kv = tllama.init_kv_cache(tcfg, 2, S, torch.float32)
        steps = []
        logits, kv = model(torch.from_numpy(ids[:, :5]), torch.from_numpy(pos[:, :5]), kv, 0, rope, 5)
        steps.append(logits)
        for t in range(5, 9):
            logits, kv = model(torch.from_numpy(ids[:, t : t + 1]), torch.from_numpy(pos[:, t : t + 1]), kv, t, rope,
                               t + 1)
            steps.append(logits)
    assert rel_l2(torch.cat(steps, dim=1).numpy(), full.numpy()) <= 1e-5
    jkv = jllama.init_kv_cache(jcfg, 2, S, jnp.float32)
    _, jkv = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv, 0, jrope, 9)
    for key in ("ckv", "kpe"):
        assert rel_l2(kv[key][:, :, :9].numpy(), np.asarray(jkv[key])[:, :, :9]) <= 1e-5, key


def test_int8_mla_and_shared_experts_match_jax():
    """int8 MLA projections (kv_b_proj dequantized at use) and shared
    experts: a decode step's logits within relL2 1e-5 of JAX's."""
    jcfg, jparams, tcfg, model = models("deepseek_v3", seed=8, bits=8)
    assert isinstance(jparams["layers"][1]["kv_b_proj"], dict) and "shared_up_proj" in jparams["layers"][1]
    ids = np.random.default_rng(2).integers(2, 128, (1, 6))
    pos = np.arange(6)[None]
    S = 16
    jl, jkv = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                             jllama.init_kv_cache(jcfg, 1, S, jnp.float32), 0, jllama.rope_tables(jcfg, S), 6)
    jl2, _ = jllama.forward(jparams, jcfg, jnp.asarray([[9]]), jnp.asarray([[6]]), jkv, 6,
                            jllama.rope_tables(jcfg, S), 7)
    rope = tllama.rope_tables(tcfg, S)
    with torch.inference_mode():
        tl, kv = model(torch.from_numpy(ids), torch.from_numpy(pos), tllama.init_kv_cache(tcfg, 1, S, torch.float32),
                       0, rope, 6)
        tl2, _ = model(torch.tensor([[9]]), torch.tensor([[6]]), kv, 6, rope, 7)
    assert rel_l2(tl.numpy(), np.asarray(jl)) <= 1e-5
    assert rel_l2(tl2.numpy(), np.asarray(jl2)) <= 1e-5


def _drive(pool, steps):
    """Admit what is pending, then run ``steps`` pool steps, pumping
    admission slices between them (tests/test_batching.py's `_drive`)."""
    pool._admit_pending()
    for _ in range(steps):
        pool._step()
        pool._admit_pending()


@pytest.mark.parametrize("family", ["deepseek_v2", "deepseek_v3"])
def test_staggered_mla_pool_matches_solo_and_jax_pool(family):
    """Three MLA requests joining a 2-slot pool at different steps (a
    frontier jump, so rows carry gaps, then a compaction of the latent
    rows): every completion equals its solo stream and the JAX pool's."""
    jcfg, jparams, tcfg, model = models(family, seed=9)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer())
    teng = InferenceEngine(tcfg, model, StubTokenizer())
    requests = [("mla pool row", 12), ("a late and longer mla joiner", 9), ("third", 10)]
    outs, stats = [], []
    for eng, pool_cls in ((teng, ContinuousEngine), (jeng, JaxPool)):
        pool = pool_cls(eng, slots=2, cache_len=256, greedy=True, use_template=False)
        handles = [pool.submit(*requests[0][:1], max_new_tokens=requests[0][1])]
        _drive(pool, 4)
        handles += [pool.submit(p, max_new_tokens=n) for p, n in requests[1:]]
        pool.run_until_idle()
        outs.append([h.result(0) for h in handles])
        stats.append({k: pool.stats[k] for k in ("frontier_jumps", "compactions")})
    assert outs[0] == outs[1]
    assert stats[0] == stats[1] and stats[0]["frontier_jumps"] >= 1
    solo = ["".join(teng.stream_generation(p, max_new_tokens=n, greedy=True, use_template=False))
            for p, n in requests]
    assert outs[0] == solo


class NoEosTokenizer(StubTokenizer):
    eos_token_id = None


def test_mla_pool_compacts_latent_rows_as_jax():
    """Five 100-token requests through a 2-slot, 256-slot pool, each joining
    30 steps after the last (tests/test_batching.py's compaction
    schedule): the ckv/kpe rows compact, and the tokens and counters equal
    the JAX pool's, the completions the solo streams'."""
    jcfg, jparams, tcfg, model = models("deepseek_v2", seed=10)
    jeng = JaxEngine(jcfg, jparams, NoEosTokenizer())
    teng = InferenceEngine(tcfg, model, NoEosTokenizer())
    prompts = [f"prompt number {i}" for i in range(5)]
    pools = []
    for eng, pool_cls in ((teng, ContinuousEngine), (jeng, JaxPool)):
        pool = pool_cls(eng, slots=2, cache_len=256, greedy=True, use_template=False)
        handles = []
        for prompt in prompts:
            handles.append(pool.submit(prompt, max_new_tokens=100))
            _drive(pool, 30)
        pool.run_until_idle()
        pools.append((pool, handles))
    (ours, got), (theirs, want) = pools
    for h, w in zip(got, want):
        assert h.token_ids == w.token_ids
    for key in ("joins", "frontier_jumps", "compactions"):
        assert ours.stats[key] == theirs.stats[key], key
    assert ours.stats["compactions"] >= 1
    for prompt, h in zip(prompts, got):
        assert h.result(0) == "".join(teng.stream_generation(prompt, max_new_tokens=100, greedy=True,
                                                             use_template=False))


SYSTEM = "You are a helpful assistant. " * 4  # 116 tokens


def test_mla_prefix_cache_hit_matches_jax_and_the_plain_prefill():
    """A second request sharing a 116-token prefix implants 64 slots of the
    first one's ckv/kpe slab: hit lengths and tokens equal the JAX
    engine's, the slab equals the plain prefill's latents bit for bit."""
    jcfg, jparams, tcfg, model = models("deepseek_v2", seed=11)
    port = InferenceEngine(tcfg, model, StubTokenizer(), prefix_cache_slots=4)
    jeng = JaxEngine(jcfg, jparams, StubTokenizer(), prefix_cache_slots=4)
    cold = InferenceEngine(tcfg, model, StubTokenizer())
    for eng in (port, jeng, cold):
        eng.prompt_chunk = 64
    kw = dict(max_new_tokens=6, greedy=True, use_template=False)
    for prompt in (SYSTEM + "first question", SYSTEM + "second question?"):
        tmeta, jmeta = {}, {}
        ours = "".join(port.stream_generation(prompt, meta=tmeta, **kw))
        assert ours == "".join(jeng.stream_generation(prompt, meta=jmeta, **kw))
        assert ours == "".join(cold.stream_generation(prompt, **kw))
        assert tmeta["prefix_cache_hit_tokens"] == jmeta["prefix_cache_hit_tokens"]
    assert tmeta["prefix_cache_hit_tokens"] == 64
    slab, nbytes = next(iter(port._prefix_cache.values()))  # the first prompt's 128 slots
    assert set(slab) == {"ckv", "kpe"} and slab["ckv"].shape[2] == 128
    ids = StubTokenizer().encode(SYSTEM + "first question")
    kv = cold._init_kv(1, 256)
    pids, ppos = cold._pad_prompt(ids, 256)
    with torch.inference_mode():
        cold._chunked_prefill(pids, ppos, kv, tllama.rope_tables(tcfg, 256), len(ids))
    plain = tinference._slice_kv(kv, 128)
    for key in ("ckv", "kpe"):
        assert torch.equal(slab[key], plain[key]), key
    assert nbytes == sum(v.numel() * v.element_size() for v in plain.values())
