"""Port vs JAX: the continuous decode pool (shardmerge_tpu_torch/batching.py
against shardmerge_tpu/batching.py), after tests/test_batching.py.

Each scenario drives the port's pool and the JAX pool through the same
schedule of submits and steps on the same weights (carried across with
``params_from_jax``). The bar is exact: greedy token ids identical to the
JAX pool's, and every completion's text identical to the port's solo
``stream_generation`` of the same prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shardmerge_tpu.batching import ContinuousEngine as JaxPool
from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu_torch.batching import ContinuousEngine
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models.convert import params_from_jax

# tests/test_batching.py::_tiny_engine
TINY_HF = {
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 32,
    "intermediate_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 2,
    "num_key_value_heads": 2,
    "max_position_embeddings": 2048,
}


class StubTokenizer:
    """tests/test_models.py::StubTokenizer: one token per character."""

    chat_template = None
    eos_token_id = 0

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr((i - 2) % 96 + 32) for i in ids if i != 0)


class NoEosTokenizer(StubTokenizer):
    """Rows run their whole budget, so the frontier wraps and compacts."""

    eos_token_id = None


def engines(seed, tokenizer=None):
    """(port engine, JAX engine) on the same f32 weights."""
    tok = tokenizer or StubTokenizer()
    jcfg = jllama.ModelConfig.from_hf_config(TINY_HF)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    )
    tcfg = tllama.ModelConfig.from_hf_config(TINY_HF)
    port = InferenceEngine(tcfg, tllama.LlamaModel(tcfg, params_from_jax(params)), tok)
    return port, JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params), tok)


def solo(engine, prompt, n, stop=None):
    return "".join(engine.stream_generation(prompt, max_new_tokens=n, greedy=True, stop=stop))


def drive(pool, steps):
    """Admit anything pending, then run exactly ``steps`` pool steps,
    pumping admission slices between them as the serve loop does."""
    pool._admit_pending()
    for _ in range(steps):
        pool._step()
        pool._admit_pending()


# (name, seed, tokenizer, pool kwargs, schedule); a schedule item is
# (prompt, max_new_tokens, pool steps driven after the submit)
SCENARIOS = [
    ("staggered_join", 0, StubTokenizer, dict(slots=3, cache_len=512),
     [("hello there", 24, 5), ("x", 12, 3), ("a much longer prompt than the others", 6, 0)]),
    ("frontier_jump", 3, StubTokenizer, dict(slots=2, cache_len=512),
     [("ab", 16, 4), ("q" * 40, 8, 0)]),
    ("compaction", 5, NoEosTokenizer, dict(slots=2, cache_len=256),
     [(f"prompt number {i}", 100, 30) for i in range(5)]),
    ("slot_reuse", 11, StubTokenizer, dict(slots=2, cache_len=512),
     [(f"request {i}", 10, 0) for i in range(5)]),
    ("decode_chunk_2", 13, StubTokenizer, dict(slots=2, cache_len=512, decode_chunk=2),
     [("chunked rows", 9, 2), ("odd budget", 7, 1), ("third", 5, 0)]),
    ("chunked_admission", 47, NoEosTokenizer, dict(slots=2, cache_len=1024, prefill_chunk=64),
     [("busy stream", 40, 5), ("y" * 300, 8, 0)]),
]


def _run(pool, schedule, stop=None):
    handles = []
    for prompt, n, steps in schedule:
        handles.append(pool.submit(prompt, max_new_tokens=n, stop=stop))
        if steps:
            drive(pool, steps)
    pool.run_until_idle()
    return handles


@pytest.mark.parametrize("name,seed,tok,kw,schedule", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_pool_matches_jax_pool_and_solo(name, seed, tok, kw, schedule):
    port, jeng = engines(seed, tok())
    events = []
    if name == "chunked_admission":  # record prefill slices vs decode steps
        forward = port.model.forward

        def recording(input_ids, *a, **k):
            events.append("prefill" if input_ids.shape[1] > 1 else "decode")
            return forward(input_ids, *a, **k)

        port.model.forward = recording
    ours = ContinuousEngine(port, greedy=True, use_template=False, **kw)
    theirs = JaxPool(jeng, greedy=True, use_template=False, **kw)
    got = _run(ours, schedule)
    pool_events = list(events)
    want = _run(theirs, schedule)

    for h, w, (prompt, n, _) in zip(got, want, schedule):
        assert h.token_ids == w.token_ids, prompt
        assert h.finish_reason == w.finish_reason
        assert h.result(0) == w.result(0) == solo(port, prompt, n)
    for key in ("joins", "frontier_jumps", "compactions", "decode_dispatches", "admission_chunks"):
        assert ours.stats[key] == theirs.stats[key], key
    assert ours.stats["joins"] == len(schedule)
    if name == "frontier_jump":
        assert ours.stats["frontier_jumps"] >= 1
    if name == "compaction":
        assert ours.stats["compactions"] >= 1
    if name == "chunked_admission":
        # bounded stall: never two prefill slices between decode steps once
        # the first stream is decoding
        first = pool_events.index("decode")
        run = longest = 0
        for ev in pool_events[first:]:
            run = run + 1 if ev == "prefill" else 0
            longest = max(longest, run)
        assert longest <= 1 and ours.stats["admission_chunks"] >= 5


def test_pool_stop_sequence_matches_jax_and_solo():
    port, jeng = engines(59)
    full = solo(port, "pool stop", 24)
    stop = [full[5:8]]
    want_text = full[: full.find(stop[0])]
    ours = ContinuousEngine(port, slots=2, cache_len=256, greedy=True)
    theirs = JaxPool(jeng, slots=2, cache_len=256, greedy=True, use_template=False)
    got = _run(ours, [("pool stop", 24, 3), ("other row", 24, 0)], stop=stop)
    want = _run(theirs, [("pool stop", 24, 3), ("other row", 24, 0)], stop=stop)
    assert got[0].result(0) == want[0].result(0) == want_text == solo(port, "pool stop", 24, stop)
    assert got[0].finish_reason == "stop"
    assert [h.token_ids for h in got] == [h.token_ids for h in want]
    assert got[1].result(0) == solo(port, "other row", 24, stop)


def test_threaded_pool_resolves_and_stops():
    """The daemon loop (its own inference mode) serves submits from another
    thread, slot reuse included; stop() resolves what is left with an error
    and later submits raise."""
    port, _ = engines(29, NoEosTokenizer())
    pool = ContinuousEngine(port, slots=2, cache_len=512, greedy=True)
    pool.start()
    try:
        prompts = [f"threaded {i}" for i in range(3)]
        handles = [pool.submit(p, max_new_tokens=6) for p in prompts]
        for p, h in zip(prompts, handles):
            assert h.result(timeout=120) == solo(port, p, 6)
        busy = pool.submit("busy row", max_new_tokens=400)
    finally:
        pool.stop()
    assert busy.done()
    with pytest.raises(RuntimeError, match="stopped"):
        busy.result(0)
    with pytest.raises(RuntimeError, match="stopped"):
        pool.submit("after stop", max_new_tokens=4)
    assert set(pool.metrics()) >= {"ttft_ms", "tpot_ms", "queue_wait_ms", "admission_chunk_ms"}


def test_pool_rejects_oversized_requests():
    port, _ = engines(17)
    pool = ContinuousEngine(port, slots=1, cache_len=256, greedy=True)
    assert not pool.fits("p" * 200, 100)
    with pytest.raises(ValueError, match="exceeds the pool cache"):
        pool.submit("p" * 200, max_new_tokens=100)
    with pytest.raises(ValueError, match="at least one slot"):
        ContinuousEngine(port, slots=0)
