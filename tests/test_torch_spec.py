"""Port vs JAX: speculative decoding (solo and pooled) and the prefix cache
(shardmerge_tpu_torch/inference.py, batching.py against
shardmerge_tpu/inference.py, batching.py), after tests/test_models.py and
tests/test_batching.py.

Target and draft weights come from the JAX ``init_params`` (f32) and are
carried across with ``params_from_jax``. The bar is exact on the CPU:
tokens, speculative rounds, pool counters and prefix-cache hit lengths
equal the JAX engine's."""

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
from shardmerge_tpu_torch.models.convert import params_from_jax

TARGET_HF = {
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "max_position_embeddings": 2048,
    "tie_word_embeddings": False,
}
# a narrower one-layer draft of the same vocab
DRAFT_HF = {**TARGET_HF, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
            "num_attention_heads": 2, "num_key_value_heads": 1}


class StubTokenizer:
    """One token per character, decoded injectively; eos 1."""

    chat_template = None
    eos_token_id = 1

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


class NoEosTokenizer(StubTokenizer):
    eos_token_id = None


def _params(hf, seed):
    cfg = jllama.ModelConfig.from_hf_config(hf)
    return cfg, jax.tree_util.tree_map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))


def engines(draft="weak", k=4, tok=None, **kw):
    """(port, JAX) engines on the same target; ``draft``: "weak" (another
    model), "self" (the target itself) or None."""
    tok = tok or StubTokenizer()
    jcfg, params = _params(TARGET_HF, 5)
    tcfg = tllama.ModelConfig.from_hf_config(TARGET_HF)
    jdraft = tdraft = None
    if draft == "self":
        jdraft = (jcfg, jax.tree_util.tree_map(jnp.asarray, params))
        tdraft = tllama.LlamaModel(tcfg, params_from_jax(params))
    elif draft == "weak":
        dcfg, dparams = _params(DRAFT_HF, 9)
        jdraft = (dcfg, jax.tree_util.tree_map(jnp.asarray, dparams))
        d_tcfg = tllama.ModelConfig.from_hf_config(DRAFT_HF)
        tdraft = tllama.LlamaModel(d_tcfg, params_from_jax(dparams))
    port = InferenceEngine(tcfg, tllama.LlamaModel(tcfg, params_from_jax(params)), tok, draft=tdraft,
                           speculation_k=k, **kw)
    jeng = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params), tok, draft=jdraft, speculation_k=k, **kw)
    return port, jeng


def counted_rounds(engine):
    """Wrap the engine's round so each call is counted."""
    calls = {"n": 0}
    orig = engine._spec_round

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    engine._spec_round = counting
    return calls


def stream(engine, prompt, n, meta=None, **kw):
    return "".join(engine.stream_generation(prompt, max_new_tokens=n, greedy=True, use_template=False,
                                            meta=meta, **kw))


@pytest.mark.parametrize("draft,k,penalty", [("weak", 4, 1.0), ("self", 4, 1.0), ("weak", 4, 1.3),
                                             ("weak", 2, 1.1), ("self", 3, 1.3)])
def test_speculative_stream_matches_jax(draft, k, penalty):
    """Tokens, round count and meta equal the JAX speculative stream's,
    which equal the plain greedy stream's."""
    port, jeng = engines(draft, k)
    ours_rounds, theirs_rounds = counted_rounds(port), counted_rounds(jeng)
    prompts = ["hello there", "speculation at k tokens a round"]
    for prompt in prompts:
        tmeta, jmeta = {}, {}
        ours = stream(port, prompt, 17, tmeta, repetition_penalty=penalty)
        theirs = stream(jeng, prompt, 17, jmeta, repetition_penalty=penalty)
        assert ours == theirs and ours
        assert {k: tmeta[k] for k in jmeta} == jmeta
    assert ours_rounds["n"] == theirs_rounds["n"] > 0
    if draft == "self":  # every round accepts k tokens: ceil(17 / k) rounds a prompt, the first token aside
        assert ours_rounds["n"] == len(prompts) * -(-16 // k)
    plain, _ = engines(None)
    assert stream(plain, prompts[-1], 17, repetition_penalty=penalty) == ours


def test_speculative_stream_stop_eos_and_sampling_fall_back():
    """A stop sequence cuts the speculative stream as JAX's; a sampled
    request takes the plain path; max_new_tokens 0 emits nothing."""
    port, jeng = engines("weak", tok=NoEosTokenizer())
    full = stream(port, "stop here", 12)
    stop = [full[12:20]]
    tmeta, jmeta = {}, {}
    assert stream(port, "stop here", 12, tmeta, stop=stop) == stream(jeng, "stop here", 12, jmeta, stop=stop)
    assert tmeta["finish_reason"] == jmeta["finish_reason"] == "stop"
    rounds = counted_rounds(port)
    sampled = "".join(port.stream_generation("hi", max_new_tokens=3, greedy=False))
    assert sampled.count("<") == 3 and rounds["n"] == 0
    meta = {}
    assert stream(port, "hi", 0, meta) == "" and meta["finish_reason"] == "length"


def test_draft_vocab_mismatch_is_refused():
    _, params = _params(TARGET_HF, 5)
    tcfg = tllama.ModelConfig.from_hf_config(TARGET_HF)
    other = {**DRAFT_HF, "vocab_size": 96}
    _, dparams = _params(other, 9)
    dcfg = tllama.ModelConfig.from_hf_config(other)
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(tcfg, tllama.LlamaModel(tcfg, params_from_jax(params)), StubTokenizer(),
                        draft=tllama.LlamaModel(dcfg, params_from_jax(dparams)))
    port = InferenceEngine(tcfg, tllama.LlamaModel(tcfg, params_from_jax(params)), StubTokenizer(), speculation_k=1)
    assert port.speculation_k == 2


SYSTEM = "You are a helpful assistant. " * 4  # 116 tokens


@pytest.mark.parametrize("draft", [None, "weak"])
def test_prefix_cache_hits_and_tokens_match_jax(draft):
    """Two requests sharing a 116-token system prompt: the second implants
    the 64-token bucket-aligned slab (target and draft kinds on the
    speculative path), prefills the rest, and gives the cold engine's
    tokens; hit lengths, tokens and cache keys equal JAX's."""
    port, jeng = engines(draft, prefix_cache_slots=4)
    cold, _ = engines(draft)
    for eng in (port, jeng):
        eng.prompt_chunk = 64
    cold.prompt_chunk = 64
    prompts = [SYSTEM + "first question", SYSTEM + "second question?", "unrelated " * 14 + "x"]
    for prompt in prompts:
        tmeta, jmeta = {}, {}
        ours = stream(port, prompt, 6, tmeta)
        assert ours == stream(jeng, prompt, 6, jmeta) == stream(cold, prompt, 6)
        assert tmeta["prefix_cache_hit_tokens"] == jmeta["prefix_cache_hit_tokens"]
    assert [k for k in port._prefix_cache] == [k for k in jeng._prefix_cache]
    assert port._prefix_cache_used == sum(v[1] for v in port._prefix_cache.values()) > 0
    assert {kind for kind, _ in port._prefix_cache} == ({"t"} if draft is None else {"t", "d"})


def test_prefix_cache_hit_length_is_the_bucket_aligned_shared_prefix():
    port, jeng = engines(None, prefix_cache_slots=4)
    hits = []
    for prompt in (SYSTEM + "a", SYSTEM + "b", SYSTEM[:70] + "z" * 80, "x" * 40):
        tmeta, jmeta = {}, {}
        assert stream(port, prompt, 3, tmeta) == stream(jeng, prompt, 3, jmeta)
        hits.append(tmeta["prefix_cache_hit_tokens"])
        assert hits[-1] == jmeta["prefix_cache_hit_tokens"]
    assert hits == [0, 64, 64, 0]


@pytest.mark.parametrize("budget", ["slots", "bytes"])
def test_prefix_cache_lru_eviction_matches_jax(budget):
    """LRU over the slot count and over the byte budget: after a hit moves
    an old slab to the end, later stores evict the least recent first, in
    JAX's order, with JAX's byte accounting."""
    slab_bytes = 2 * 2 * 1 * 2 * 64 * 16 * 4  # k and v, 2 layers, 2 KV heads, 64 slots, head dim 16, f32
    kw = {"prefix_cache_slots": 2} if budget == "slots" else {"prefix_cache_slots": 8,
                                                              "prefix_cache_bytes": 2 * slab_bytes + 1}
    port, jeng = engines(None, **kw)
    prompts = ["a" * 70, "b" * 70, "a" * 70 + "again", "c" * 130, "d" * 70, "b" * 70 + "gone?"]
    hits, sizes = [], []
    for prompt in prompts:
        tmeta, jmeta = {}, {}
        assert stream(port, prompt, 2, tmeta) == stream(jeng, prompt, 2, jmeta)
        assert tmeta["prefix_cache_hit_tokens"] == jmeta["prefix_cache_hit_tokens"]
        assert list(port._prefix_cache) == list(jeng._prefix_cache)
        assert port._prefix_cache_used == jeng._prefix_cache_used
        hits.append(tmeta["prefix_cache_hit_tokens"])
        sizes.append(len(port._prefix_cache))
    # the hit moved "a" to the end, so "c" evicted "b" and "b" misses
    assert hits == [0, 0, 64, 0, 0, 0]
    assert sizes == ([1, 2, 2, 2, 2, 2] if budget == "slots" else [1, 2, 2, 1, 1, 2])


def test_prefix_cache_refuses_an_over_budget_slab():
    port, jeng = engines(None, prefix_cache_slots=4, prefix_cache_bytes=64)
    stream(port, SYSTEM + "q", 2)
    stream(jeng, SYSTEM + "q", 2)
    assert len(port._prefix_cache) == len(jeng._prefix_cache) == 0
    assert port._prefix_cache_used == 0


def test_greedy_verify_masks_each_position_by_the_fed_prefix():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 16)).astype(np.float32)
    base = rng.random(16) < 0.3
    fed = np.array([3, 7, 3, 11])
    ours = tinference._greedy_verify(torch.from_numpy(logits), torch.from_numpy(base), torch.from_numpy(fed), 1.7)
    from shardmerge_tpu.inference import _greedy_verify

    theirs = _greedy_verify(jnp.asarray(logits), jnp.asarray(base), jnp.asarray(fed), jnp.float32(1.7))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def drive(pool, steps):
    pool._admit_pending()
    for _ in range(steps):
        pool._step()
        pool._admit_pending()


def run_pool(engine, pool_cls, schedule, slots=3, cache_len=512, prefill_chunk=None):
    """Submit ``schedule``'s (prompt, max_tokens, steps to drive after)
    in turn, then run until idle; (texts, stats)."""
    pool = pool_cls(engine, slots=slots, cache_len=cache_len, greedy=True, use_template=False,
                    prefill_chunk=prefill_chunk)
    assert pool.spec
    handles = []
    for prompt, n, after in schedule:
        handles.append(pool.submit(prompt, max_new_tokens=n))
        drive(pool, after)
    pool.run_until_idle()
    stats = {k: v for k, v in pool.stats.items() if k != "admission_chunk_ms_max"}
    return [h.result(0) for h in handles], [h.finish_reason for h in handles], stats


STAGGERED = [("spec pool row", 24, 4), ("x", 12, 2), ("a much longer late joining prompt", 6, 0)]
COMPACTING = [(f"spec req {i}", 60, 0) for i in range(4)]


@pytest.mark.parametrize("case", ["staggered-weak", "staggered-self", "compacting", "prefix-cache"])
def test_spec_pool_matches_jax_pool(case):
    """Completions, finish reasons and every pool counter (spec_rounds,
    spec_accepted, compactions, frontier jumps, joins) equal the JAX spec
    pool's under staggered joins (a weak and a perfect draft) and under
    compaction of both caches; every completion equals the plain solo
    stream. With the prefix cache on, admissions implant shared slabs of
    both kinds."""
    draft = "self" if case == "staggered-self" else "weak"
    tok = NoEosTokenizer() if case == "compacting" else StubTokenizer()
    kw = {"prefix_cache_slots": 4} if case == "prefix-cache" else {}
    port, jeng = engines(draft, tok=tok, **kw)
    plain, _ = engines(None, tok=tok)
    if case == "compacting":
        schedule, pool_kw = COMPACTING, dict(slots=2, cache_len=256)
    elif case == "prefix-cache":
        schedule = [(SYSTEM + "one", 8, 3), (SYSTEM + "two!", 8, 1), (SYSTEM + "three", 5, 0)]
        pool_kw = dict(prefill_chunk=64)
    else:
        schedule, pool_kw = STAGGERED, {}
    ours = run_pool(port, ContinuousEngine, schedule, **pool_kw)
    theirs = run_pool(jeng, JaxPool, schedule, **pool_kw)
    assert ours == theirs
    texts, _, stats = ours
    assert texts == [stream(plain, p, n) for p, n, _ in schedule]
    assert stats["spec_rounds"] > 0
    if case == "compacting":
        assert stats["compactions"] >= 2  # both caches
    if case == "staggered-self":
        assert stats["spec_accepted"] >= 24 - 1 - stats["spec_rounds"]
    if case == "prefix-cache":
        assert {kind for kind, _ in port._prefix_cache} == {"t", "d"}
        assert list(port._prefix_cache) == list(jeng._prefix_cache)


def test_spec_pool_stop_and_eos_match_jax_pool():
    port, jeng = engines("weak", tok=NoEosTokenizer())
    full = stream(port, "stop in the pool", 16)
    stop = [full[16:24]]
    outs = []
    for eng, cls in ((port, ContinuousEngine), (jeng, JaxPool)):
        pool = cls(eng, slots=2, cache_len=512, greedy=True, use_template=False)
        h1 = pool.submit("stop in the pool", max_new_tokens=16, stop=stop)
        h2 = pool.submit("runs its budget", max_new_tokens=9)
        pool.run_until_idle()
        outs.append([(h.result(0), h.finish_reason, h.token_ids) for h in (h1, h2)])
    assert outs[0] == outs[1]
    assert outs[0][0][1] == "stop" and outs[0][1][1] == "length"


def test_spec_pool_refuses_sampling_and_decode_chunk():
    port, _ = engines("weak")
    with pytest.raises(ValueError, match="greedy"):
        ContinuousEngine(port, slots=2, greedy=False)
    with pytest.raises(ValueError, match="decode_chunk"):
        ContinuousEngine(port, slots=2, greedy=True, decode_chunk=4)
    pool = ContinuousEngine(port, slots=2, cache_len=256, greedy=True)
    # prompt + budget + k verify slots must fit the cache
    assert pool.fits("x" * 100, 152) and not pool.fits("x" * 100, 153)
