"""Port vs JAX: the HTTP server (shardmerge_tpu_torch/serve.py against
shardmerge_tpu/serve.py), after tests/test_models.py's server tests.

Both servers run on the same weights with the same stub tokenizer and a
continuous pool of 2 slots; every request goes to both, one at a time, and
the JSON bodies (status codes, texts, finish reasons, usage) must be equal.
The port's DynamicBatcher, warmup, ``serve()`` and CLI entry are tested on
their own. ``serve --shard`` runs as two gloo ranks (tests/torch_ranks.py)
of the CLI: its completions and SSE events are held to the JAX server's
JSON on the same checkpoint, the follower exits 0 when rank 0's server
stops, and a rank that raises ends both ranks with a nonzero exit.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu.serve import ModelServer as JaxServer
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models.convert import params_from_jax
from shardmerge_tpu_torch.serve import ModelServer

TINY_HF = {
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 32,
    "intermediate_size": 64,
    "num_hidden_layers": 2,
    "num_attention_heads": 2,
    "num_key_value_heads": 2,
    "max_position_embeddings": 1024,
}


class StubTokenizer:
    """tests/test_models.py::StubTokenizer: one token per character."""

    chat_template = None
    eos_token_id = 0

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr((i - 2) % 96 + 32) for i in ids if i != 0)


def _port_engine(params):
    cfg = tllama.ModelConfig.from_hf_config(TINY_HF)
    return InferenceEngine(cfg, tllama.LlamaModel(cfg, params_from_jax(params)), StubTokenizer())


@pytest.fixture(scope="module")
def servers():
    jcfg = jllama.ModelConfig.from_hf_config(TINY_HF)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    )
    jeng = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params), StubTokenizer())
    kw = dict(model_id="tiny", continuous_slots=2, continuous_cache_len=256)
    pair = [ModelServer(_port_engine(params), **kw), JaxServer(jeng, **kw)]
    ports = [s.start(port=0) for s in pair]
    yield pair, ports
    for s in pair:
        s.stop()


def _call(port, path, payload=None):
    """(status, parsed body); an SSE body parses to its list of events."""
    url = f"http://127.0.0.1:{port}{path}"
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
        )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read().decode()
            if resp.headers["Content-Type"] == "text/event-stream":
                lines = [l[len("data: "):] for l in body.splitlines() if l.startswith("data: ")]
                assert lines[-1] == "[DONE]"
                return resp.status, [json.loads(l) for l in lines[:-1]]
            return resp.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


CHAT = [
    {"role": "system", "content": "be brief"},
    {"role": "user", "content": "hello"},
    {"role": "assistant", "content": "hi"},
    {"role": "user", "content": "again"},
]
GREEDY = {"greedy": True, "max_tokens": 8}
CASES = [
    ("health", "/health", None),
    ("models", "/v1/models", None),
    ("single", "/v1/completions", {"prompt": "hi", **GREEDY}),
    ("list", "/v1/completions", {"prompt": ["hi", "longer prompt here", "x"], **GREEDY}),
    ("sse", "/v1/completions", {"prompt": "hi there", "stream": True, **GREEDY}),
    ("stop", "/v1/completions", {"prompt": "stop here", "stop": ["a", "e"], "greedy": True, "max_tokens": 24}),
    ("over_pool_capacity", "/v1/completions", {"prompt": ["long", "lockstep"], "greedy": True, "max_tokens": 300}),
    ("decode_chunk", "/v1/completions", {"prompt": ["hi", "chunk"], "greedy": True, "max_tokens": 300,
                                         "decode_chunk": 3}),
    ("chat", "/v1/chat/completions", {"messages": CHAT, **GREEDY}),
    ("chat_sse", "/v1/chat/completions", {"messages": CHAT, "stream": True, **GREEDY}),
    ("bad_empty", "/v1/completions", {}),
    ("bad_list", "/v1/completions", {"prompt": ["ok", ""]}),
    ("bad_max_tokens", "/v1/completions", {"prompt": "x", "max_tokens": 0}),
    ("bad_batch_cap", "/v1/completions", {"prompt": ["x"] * 65}),
    ("bad_temperature", "/v1/completions", {"prompt": "x", "temperature": "hot"}),
    ("bad_decode_chunk", "/v1/completions", {"prompt": "x", "decode_chunk": 65}),
    ("bad_stop", "/v1/completions", {"prompt": "x", "stop": ["a", "b", "c", "d", "e"]}),
    ("bad_stream_list", "/v1/completions", {"prompt": ["a", "b"], "stream": True}),
    ("bad_chat_role", "/v1/chat/completions", {"messages": [{"role": "robot", "content": "x"}]}),
    ("bad_chat_last", "/v1/chat/completions", {"messages": [{"role": "system", "content": "only"}]}),
    ("not_found", "/nope", None),
]


@pytest.mark.parametrize("name,path,payload", CASES, ids=[c[0] for c in CASES])
def test_endpoint_json_matches_jax_server(servers, name, path, payload):
    _, (p_ours, p_theirs) = servers
    got = _call(p_ours, path, payload)
    want = _call(p_theirs, path, payload)
    assert got == want
    status, body = got
    if name.startswith("bad_"):
        assert status == 400 and "error" in body
    elif name == "not_found":
        assert status == 404
    else:
        assert status == 200


def test_stats_match_jax_server(servers):
    """After the same requests, one at a time: the same request and token
    tallies and the same pool counters (latencies are wall clock)."""
    _, (p_ours, p_theirs) = servers
    got = _call(p_ours, "/v1/stats")[1]
    want = _call(p_theirs, "/v1/stats")[1]
    assert got["requests"] == want["requests"] and got["requests"]["completions"] >= 4
    assert got["tokens"] == want["tokens"]
    for key in ("slots", "cache_len", "joins", "tokens_out", "frontier_jumps", "decode_dispatches"):
        assert got["continuous_pool"][key] == want["continuous_pool"][key], key
    assert set(got["continuous_pool"]["latency"]) == set(want["continuous_pool"]["latency"])


def test_dynamic_batcher_coalesces_compatible_requests():
    """Concurrent greedy requests with matching parameters merge into ONE
    lockstep decode padded to a power of two; an incompatible one runs on
    its own; errors reach every waiter (tests/test_models.py's test, on the
    port's server)."""
    calls = []
    gate = threading.Event()

    class FakeEngine:
        cfg = type("C", (), {"vocab_size": 128})()

        def generate_batch(self, prompts, return_meta=False, **kw):
            gate.wait(timeout=5)
            calls.append((list(prompts), dict(kw)))
            if kw.get("seed") == 666:
                raise RuntimeError("device on fire")
            return [f"r:{p}" for p in prompts], ["stop"] * len(prompts)

    server = ModelServer(FakeEngine(), batch_window_ms=2000.0)
    kwargs = {"greedy": True, "max_new_tokens": 4, "seed": 0}
    results = {}

    def post(name, prompts, kw):
        results[name] = server._generate(prompts, kw)

    threads = [threading.Thread(target=post, args=(f"t{i}", [f"p{i}"], dict(kwargs))) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    hot = threading.Thread(target=post, args=("hot", ["ph"], {**kwargs, "max_new_tokens": 9}))
    hot.start()
    threads.append(hot)
    time.sleep(0.3)
    gate.set()
    for t in threads:
        t.join(timeout=20)
    assert all(not t.is_alive() for t in threads)
    for i in range(3):
        assert results[f"t{i}"]["choices"][0]["text"] == f"r:p{i}"
    assert results["hot"]["choices"][0]["text"] == "r:ph"
    assert sorted(len(p) for p, _ in calls) == [1, 4]
    merged = next(p for p, _ in calls if len(p) == 4)
    assert merged[3] == merged[2]
    assert server._generate(["solo"], {**kwargs, "greedy": False})["choices"][0]["text"] == "r:solo"
    with pytest.raises(RuntimeError, match="device on fire"):
        server._generate(["x"], {**kwargs, "seed": 666})
    server.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        server.batcher.submit(["late"], kwargs)


def test_serve_entry_loads_warms_up_and_answers(tmp_path):
    """``serve()`` on a checkpoint directory, on the CPU: loads, warms up
    the stream, batcher and pool paths, answers; a greedy request equals the
    solo stream."""
    from shardmerge_tpu_torch.serve import serve

    from .test_torch_engine import _save_tiny_checkpoint

    _save_tiny_checkpoint(tmp_path)
    server = serve(
        str(tmp_path), port=0, batch_window_ms=5.0, continuous=2, continuous_cache_len=256,
        warmup=True, device="cpu", tokenizer=StubTokenizer(),
    )
    try:
        assert server.pool.stats["joins"] == 1  # the warmup request
        status, body = _call(server.port, "/v1/completions", {"prompt": "served", **GREEDY})
        assert status == 200
        solo = "".join(server.engine.stream_generation("served", max_new_tokens=8, greedy=True))
        assert body["choices"][0]["text"] == solo
        assert _call(server.port, "/health")[1] == {"status": "ok", "model": str(tmp_path)}
    finally:
        server.stop()


def test_unported_serve_options_raise_by_name(tmp_path, caplog):
    """``serve(shard=True)`` (once refused) with one rank only logs, as the
    JAX server does on one device: the engine is the unsharded one and
    answers; the CLI's option checks still refuse a pool beyond 64 slots."""
    import logging

    from shardmerge_tpu_torch.cli import main
    from shardmerge_tpu_torch.serve import serve

    from .test_torch_engine import _save_tiny_checkpoint

    _save_tiny_checkpoint(tmp_path)
    with caplog.at_level(logging.INFO, logger="shardmerge_tpu_torch.parallel.tp"):
        server = serve(str(tmp_path), port=0, device="cpu", shard=True, tokenizer=StubTokenizer())
    try:
        assert server.engine.tp is None and "one rank, nothing to shard" in caplog.text
        status, body = _call(server.port, "/v1/completions", {"prompt": "one rank", **GREEDY})
        assert status == 200
        assert body["choices"][0]["text"] == "".join(
            server.engine.stream_generation("one rank", max_new_tokens=8, greedy=True))
    finally:
        server.stop()
    with pytest.raises(SystemExit):
        main(["serve", str(tmp_path), "--continuous", "65"])  # beyond the pool's 64 slots


@pytest.mark.parametrize("option", ["draft_model", "prefix_cache"])
def test_serve_entry_takes_speculation_and_the_prefix_cache(tmp_path, option):
    """``serve(draft_model=...)`` and ``serve(prefix_cache=...)`` on the CPU:
    the engine holds the draft (the target itself, k = 3) or the cache; a
    greedy single prompt rides the stream path and equals the plain solo
    stream; two requests sharing a 70-token prefix hit the cache, whose
    slab /v1/stats counts; the warmup request takes no cache slot."""
    from shardmerge_tpu_torch.serve import serve

    from .test_torch_engine import _save_tiny_checkpoint

    _save_tiny_checkpoint(tmp_path)
    kw = {"draft_model": str(tmp_path), "speculation_k": 3} if option == "draft_model" else {"prefix_cache": 2}
    server = serve(str(tmp_path), port=0, warmup=True, device="cpu", tokenizer=StubTokenizer(), **kw)
    try:
        engine = server.engine
        assert (engine.draft_model is not None and engine.speculation_k == 3) if option == "draft_model" \
            else (engine.prefix_cache_slots == 2 and len(engine._prefix_cache) == 0)
        plain = InferenceEngine(engine.cfg, engine.model, StubTokenizer())
        shared = "a shared system prompt, " * 3
        for prompt in (shared + "first", shared + "second"):
            status, body = _call(server.port, "/v1/completions", {"prompt": prompt, **GREEDY})
            assert status == 200
            want = "".join(plain.stream_generation(prompt, max_new_tokens=8, greedy=True))
            assert body["choices"][0]["text"] == want
        stats = _call(server.port, "/v1/stats")[1]
        if option == "prefix_cache":
            assert stats["prefix_cache"]["entries"] == 1 and stats["prefix_cache"]["bytes"] > 0
        else:
            assert "prefix_cache" not in stats
    finally:
        server.stop()


# -- serve --shard over two gloo ranks ----------------------------------------------

SHARD_REQUESTS = [
    ("/v1/completions", {"prompt": "hello there", "greedy": True, "max_tokens": 8}),
    ("/v1/completions", {"prompt": ["hello", "there hello tok3"], "greedy": True, "max_tokens": 6}),
    ("/v1/completions", {"prompt": "tok5 tok7 hello", "greedy": True, "max_tokens": 6, "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}], "greedy": True,
                              "max_tokens": 5}),
]


def _serve_ranks(tmp_path, model, argv_extra=(), script=None):
    """Start ``serve MODEL --shard`` as two gloo ranks of the CLI (or of
    ``script``); returns (processes, port, logs) once rank 0 answers."""
    from .torch_ranks import free_port, start

    port = free_port()
    argv = ["serve", str(model), "--shard", "--device", "cpu", "--port", str(port), "--continuous", "4",
            *argv_extra]
    logs = tmp_path / "logs"
    head = [str(script)] if script else ["-m", "shardmerge_tpu_torch"]
    procs = start(head + argv, 2, logs, env={"SHARDMERGE_HEARTBEAT_TIMEOUT_S": "20"})
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            break
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2).read()
            return procs, port, logs
        except OSError:
            time.sleep(0.2)
    for p in procs:
        p.kill()
    raise AssertionError("rank 0 never served: " + (logs / "rank0.err").read_text()[-3000:]
                         + (logs / "rank1.err").read_text()[-2000:])


def test_sharded_serve_on_two_ranks_answers_as_the_jax_server(tmp_path):
    """``serve --shard --continuous 4`` on 2 gloo ranks: pooled completions,
    a list prompt, SSE events and a chat completion carry the JAX server's
    JSON (the same checkpoint, unsharded there: greedy tokens do not depend
    on the split); after SIGINT to rank 0 both ranks exit 0, the follower
    having replayed every call."""
    import signal

    from shardmerge_tpu.inference import InferenceEngine as JaxEngine

    from .test_torch_tools import _hf_llama
    from .torch_ranks import wait

    model = tmp_path / "m"
    _hf_llama(model, seed=23, layers=2)
    procs, port, logs = _serve_ranks(tmp_path, model)
    try:
        got = [_call(port, path, payload) for path, payload in SHARD_REQUESTS]
    finally:
        procs[0].send_signal(signal.SIGINT)
        results = wait(procs, logs, timeout=30)
    assert [rc for rc, _, _ in results] == [0, 0], results[0][2][-2000:] + results[1][2][-2000:]
    assert "stopped by rank 0" in results[1][2]
    jax_server = JaxServer(JaxEngine.from_pretrained(str(model)), model_id=str(model), continuous_slots=4)
    jport = jax_server.start(port=0)
    try:
        want = [_call(jport, path, payload) for path, payload in SHARD_REQUESTS]
    finally:
        jax_server.stop()
    for (path, payload), a, b in zip(SHARD_REQUESTS, got, want):
        if path.endswith("chat/completions"):  # ids and timestamps are per server
            for body in (a[1], b[1]):
                for key in ("id", "created"):
                    body.pop(key, None)
        assert a == b, payload


def test_a_rank_that_raises_ends_every_rank(tmp_path):
    """A follower whose third forward raises exits 1 naming its rank and the
    call; rank 0's collective with it fails, the request answers 500 and
    rank 0 exits nonzero, both well within the group's timeout."""
    from .test_torch_tools import _hf_llama
    from .torch_ranks import wait

    model = tmp_path / "m"
    _hf_llama(model, seed=29, layers=1)
    procs, port, logs = _serve_ranks(tmp_path, model, script=Path(__file__).resolve())
    t0 = time.monotonic()
    status, body = _call(port, "/v1/completions", {"prompt": "hello there", "greedy": True, "max_tokens": 8})
    results = wait(procs, logs, timeout=40)
    assert status == 500 and "error" in body
    assert results[1][0] == 1 and "rank 1 failed in call forward#" in results[1][2]
    assert results[0][0] not in (0, None), results[0][2][-2000:]
    assert "rank 0 failed in call forward#" in results[0][2]
    assert time.monotonic() - t0 < 40


def _failing_follower():
    """Run the CLI with rank 1's model raising at its third forward."""
    import os
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from shardmerge_tpu_torch.cli import main
    from shardmerge_tpu_torch.models import llama

    if os.environ["RANK"] == "1":
        forward, calls = llama.LlamaModel.forward, []

        def failing(self, *args, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("planted failure")
            return forward(self, *args, **kwargs)

        llama.LlamaModel.forward = failing
    sys.exit(main(sys.argv[1:]))


if __name__ == "__main__":
    _failing_follower()
