"""Port vs JAX: tensor-parallel decoding (shardmerge_tpu_torch/parallel/
train.py, tp.py and the sharded modules of models/llama.py against the JAX
engine's mesh-sharded serving, shardmerge_tpu/parallel/train.py and
shardmerge_tpu/inference.py ``mesh=``).

The rules run in-process, in seconds: the port's spec table equals JAX's
``param_shardings`` for every family's tiny config, each rank's slices put
back together give the full params bit for bit (quantized ``q``/``scale``
too, an int4 row slice as JAX's ``_repack4_tp_blocked`` block), the loader's
per-rank slices equal the sliced full load, and the head-boundary rules.

The ranks run as gloo processes on localhost (tests/torch_ranks.py), one
launch at P = 2 and one at P = 4, each case's params made from a seed with
numpy here and pickled. Rank 0 drives the engine; the others replay its
calls. Against JAX's ``InferenceEngine(..., mesh=...)`` on a mesh of the same
size (the 8 virtual CPU devices of tests/conftest.py), f32: greedy stream
and ragged-batch tokens equal, and a left-padded prefill's and two decode
steps' logits within relL2 1e-5 of JAX's forward over ``shard_params``
(bf16 weights: tokens equal and logits within 1e-2, twice the 5.2e-3 measured).
A vocab that does not divide P has no JAX mesh counterpart (its
``shard_params`` refuses the uneven split): that case is held to the
unsharded JAX engine, whose numbers the sharded one must equal anyway.
Also on the ranks: the pool over a TP engine (staggered joins, a
compaction) equals the unsharded solo stream; speculation on a sharded
target equals sharded plain decoding; a prefix-cache hit equals the cold
prefill; and every all-reduce and gather leaves the same bits on every rank
(a CRC of each result, per rank). The JAX side jits the prefill and the
first decode step and runs the engine's stream for every case, its ragged
batch for three, to keep the file's run near a minute.

    python -m pytest tests/test_torch_tp.py -q
"""

from __future__ import annotations

import pickle
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

SIZES = (2, 4)
STREAM = "tensor parallel ranks"
BATCH = ["hello there", "a", "the quick brown fox"]
NEW = 6
SYSTEM = "You are a helpful assistant. " * 3  # 87 tokens: a 64-token prefix slab
# bf16 weights: the ranks round their o_proj and down_proj partials to bf16
# before the f32 sum, and XLA fuses its bf16 roundings differently from torch:
# measured 5.2e-3 relL2 against the jitted JAX sharded forward at P = 2
BF16_BOUND = 1e-2

BASE = {"vocab_size": 128, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 8, "num_key_value_heads": 4, "max_position_embeddings": 256,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False, "model_type": "llama"}
MLA = {"num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "moe_intermediate_size": 32, "n_shared_experts": 1,
       "first_k_dense_replace": 1, "num_hidden_layers": 3, "intermediate_size": 96}
GPTOSS = {"model_type": "gpt_oss", "intermediate_size": 48, "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 16, "num_local_experts": 4, "num_experts_per_tok": 2, "sliding_window": 3,
          "attention_bias": True, "layer_types": ["sliding_attention", "full_attention"], "hidden_act": "silu"}
LLAMA4 = {"model_type": "llama4_text", "intermediate_size": 48, "intermediate_size_mlp": 96, "num_hidden_layers": 4,
          "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "num_local_experts": 4,
          "num_experts_per_tok": 2, "interleave_moe_layer_step": 2, "no_rope_layers": [1, 1, 1, 0],
          "attention_chunk_size": 4, "attn_temperature_tuning": True, "floor_scale": 2.0, "attn_scale": 0.1,
          "use_qk_norm": True}
# name -> (hf config overrides, weight dtype, quant bits)
FAMILIES = {
    "llama": ({}, "f32", None),
    "llama_bf16": ({}, "bf16", None),
    "llama_int8": ({}, "f32", 8),
    "llama_int4": ({}, "f32", 4),
    "gqa_kvh2": ({"num_key_value_heads": 2}, "f32", None),
    "vocab_odd": ({"vocab_size": 127}, "f32", None),
    "qwen2": ({"model_type": "qwen2"}, "f32", None),
    "gemma": ({"model_type": "gemma", "head_dim": 16, "hidden_activation": "gelu_pytorch_tanh",
               "tie_word_embeddings": True}, "f32", None),
    "olmo2": ({"model_type": "olmo2"}, "f32", None),
    "mixtral": ({"model_type": "mixtral", "intermediate_size": 96, "num_local_experts": 4,
                 "num_experts_per_tok": 2}, "f32", None),
    "deepseek_v2": ({"model_type": "deepseek_v2", **MLA, "q_lora_rank": None, "n_routed_experts": 8,
                     "num_experts_per_tok": 2, "topk_method": "group_limited_greedy", "n_group": 4,
                     "topk_group": 2, "routed_scaling_factor": 1.5}, "f32", None),
    "gpt_oss": (GPTOSS, "f32", None),
    "gpt_oss_e6": ({**GPTOSS, "num_local_experts": 6}, "f32", None),
    "llama4": (LLAMA4, "f32", None),
}
# the cases each launch runs; the first also runs the pool, speculation and
# prefix-cache checks
CASES = {2: ["llama", "llama_bf16", "llama_int8", "llama_int4", "vocab_odd", "qwen2", "gemma", "olmo2", "mixtral",
             "deepseek_v2", "gpt_oss", "llama4"],
         4: ["gqa_kvh2", "llama_int4", "mixtral", "gpt_oss_e6"]}


class StubTokenizer:
    """One token per character; eos 1."""

    chat_template = None
    eos_token_id = 1

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


class NoEosTokenizer(StubTokenizer):
    """No EOS: the pool's rows and the solo streams run their whole budgets."""

    eos_token_id = None


def hf_config(name):
    return {**BASE, **FAMILIES[name][0]}


def np_params(name, seed=0):
    """Numpy params of ``name`` in the layout both packages share (the
    port's ``init_params`` gives the leaves), drawn from a seeded numpy
    generator: matrices N(0, 0.02), norms around their identity, biases,
    sinks and the routers' biases N(0, 0.3); quantized with the JAX
    quantizer when the case asks."""
    import torch

    from shardmerge_tpu.models import quant as jquant
    from shardmerge_tpu_torch.models import llama as tllama

    cfg = tllama.ModelConfig.from_hf_config(hf_config(name))
    _, dtype, bits = FAMILIES[name]
    rng = np.random.default_rng(seed)

    def draw(key, leaf):
        shape = tuple(leaf.shape)
        if key.endswith("norm"):  # Gemma's (1 + w) norms centre on 0
            return ((0.0 if cfg.is_gemma else 1.0) + rng.normal(0, 0.2, shape)).astype(np.float32)
        if key.endswith("bias") or key == "sinks":
            return rng.normal(0, 0.3, shape).astype(np.float32)
        # GPT-OSS's gate/up columns reach past its 7.0 clamps
        scale = 1.2 if key == "gate_up" and cfg.model_type == "gpt_oss" else 0.02
        return rng.normal(0, scale, shape).astype(np.float32)

    def walk(key, leaf):
        if isinstance(leaf, dict):
            return {k: walk(k, v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [walk(key, v) for v in leaf]
        return draw(key, leaf)

    params = walk("", tllama.init_params(cfg, seed=0, dtype=torch.float32))
    if dtype == "bf16":
        import ml_dtypes

        params = _tree_map(lambda a: a.astype(ml_dtypes.bfloat16), params)
    if bits:
        for layer in params["layers"]:
            for key in list(layer):
                if key in tllama.QUANTIZABLE:
                    layer[key] = _tree_map(np.asarray, jquant.quantize(layer[key], bits=bits))
            for e in layer.get("experts", []):
                for w in ("w1", "w3", "w2"):
                    e[w] = _tree_map(np.asarray, jquant.quantize(e[w], bits=bits))
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def forward_inputs(vocab):
    """A 2-row prefill over 9 slots (row 1 left-padded by 3) into a 32-slot
    cache, then two decode steps: (ids, rope positions, slots, valid, steps)."""
    S, T = 32, 9
    ids = np.random.default_rng(3).integers(2, vocab, size=(2, T))
    pad = np.array([0, 3])
    slot = np.broadcast_to(np.arange(T), (2, T)).copy()
    pos = np.maximum(slot - pad[:, None], 0)
    valid = np.arange(S)[None, :] >= pad[:, None]
    steps = [(np.array([[5 + s], [60 + s]]), T + s, (T + s) - pad[:, None]) for s in range(2)]
    return S, T, ids, pos, slot, valid, steps


# -- the rank body (run as a script, one process a rank) -------------------------------


def _rank_body(out_dir: Path) -> None:
    import torch

    from shardmerge_tpu_torch.batching import ContinuousEngine
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import llama as tllama
    from shardmerge_tpu_torch.models.convert import params_from_jax
    from shardmerge_tpu_torch.parallel import tp as tpmod
    from shardmerge_tpu_torch.parallel.train import plan, shard_params

    cases = pickle.loads((out_dir / "cases.pkl").read_bytes())
    comm, control, dev = tpmod.join("cpu")
    crcs: list = []
    reduce, gather = tpmod.TPGroup.all_reduce, tpmod.TPGroup.gather_vocab

    def record(fn):
        def wrapped(self, x):
            out = fn(self, x)
            crcs.append(zlib.crc32(out.detach().to(torch.float32).numpy().tobytes()))
            return out
        return wrapped

    tpmod.TPGroup.all_reduce, tpmod.TPGroup.gather_vocab = record(reduce), record(gather)
    res = {}
    for name, params_np in cases:
        crcs.clear()
        cfg = tllama.ModelConfig.from_hf_config(hf_config(name))
        full = params_from_jax(params_np)
        bits = FAMILIES[name][2]
        group = tpmod.TPGroup(comm, plan(cfg, comm.rank, comm.size, bits), control)
        model = tllama.LlamaModel(cfg, shard_params(full, cfg, group.plan), tp=group)
        if comm.rank:
            assert InferenceEngine(cfg, model, None, tp=tpmod.Follower(group, model)).follow() == 0
            res[name + "/crc"] = list(crcs)
            continue
        leader = tpmod.Leader(group, model)
        eng = InferenceEngine(cfg, model, StubTokenizer(), tp=leader)
        out = {}
        with torch.inference_mode():
            S, T, ids, pos, slot, valid, steps = forward_inputs(cfg.vocab_size)
            rope = tllama.rope_tables(cfg, S)
            kv = eng._init_kv(2, S)
            t = torch.from_numpy
            logits, _ = eng.model(t(ids), t(pos), kv, 0, rope, T, mask_positions=t(slot), token_valid=t(valid))
            out["logits"] = [logits.to(torch.float32).numpy()[valid[:, :T]]]
            for tok, at, p in steps:
                logits, _ = eng.model(t(tok), t(p), kv, at, rope, at + 1, mask_positions=t(np.full((2, 1), at)),
                                      token_valid=t(valid))
                out["logits"].append(logits.to(torch.float32).numpy())
        kw = dict(max_new_tokens=NEW, greedy=True, use_template=False)
        out["stream"] = "".join(eng.stream_generation(STREAM, **kw))
        out["batch"] = eng.generate_batch(BATCH, **kw)
        if name == cases[0][0]:
            plain = InferenceEngine(cfg, tllama.LlamaModel(cfg, full), NoEosTokenizer())
            solo = {p: "".join(plain.stream_generation(p, max_new_tokens=n, greedy=True, use_template=False))
                    for p, n in (("tensor parallel pool", 12), ("joiner", 6))}
            pool = ContinuousEngine(InferenceEngine(cfg, model, NoEosTokenizer(), tp=leader), slots=2, cache_len=256,
                                    greedy=True, use_template=False)
            ha = pool.submit("tensor parallel pool", max_new_tokens=12)
            pool._admit_pending()
            for _ in range(3):
                pool._step()
            hb = pool.submit("joiner", max_new_tokens=6)
            pool._admit_pending()
            pool._step()
            with pool._dev(), torch.inference_mode():  # the pool's buffers are inference tensors
                pool._compact()
            pool.run_until_idle()
            out["pool"] = [ha.result(0) == solo["tensor parallel pool"], hb.result(0) == solo["joiner"],
                           pool.stats["compactions"], pool.stats["frontier_jumps"]]
            spec = InferenceEngine(cfg, model, StubTokenizer(), draft=tllama.LlamaModel(cfg, full), speculation_k=4,
                                   tp=leader)
            weak = InferenceEngine(cfg, model, StubTokenizer(), tp=leader,
                                   draft=tllama.LlamaModel(cfg, params_from_jax(_tree_map(lambda a: a * 0.5,
                                                                                          params_np))))
            sharded = "".join(eng.stream_generation(STREAM, max_new_tokens=12, greedy=True, use_template=False))
            out["spec"] = [sharded, "".join(spec.stream_generation(STREAM, max_new_tokens=12, greedy=True,
                                                                   use_template=False)),
                           "".join(weak.stream_generation(STREAM, max_new_tokens=12, greedy=True, use_template=False))]
            cached = InferenceEngine(cfg, model, StubTokenizer(), prefix_cache_slots=2, tp=leader)
            meta = [{}, {}]
            texts = ["".join(cached.stream_generation(SYSTEM + q, meta=m, **kw)) for q, m in zip(("one", "two"), meta)]
            out["prefix"] = [texts[1] == "".join(eng.stream_generation(SYSTEM + "two", **kw)),
                             meta[1]["prefix_cache_hit_tokens"]]
        leader.stop()
        out["crc"] = list(crcs)
        res[name] = out
    (out_dir / f"rank{comm.rank}.pkl").write_bytes(pickle.dumps(res))


# -- the JAX side and the launches --------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The launches (P = 2 and 4 started together; they run while the JAX
    references are computed); :func:`_results` collects them."""
    from . import torch_ranks

    dirs, procs = {}, {}
    for p in SIZES:
        d = tmp_path_factory.mktemp(f"tp{p}")
        d.joinpath("cases.pkl").write_bytes(pickle.dumps([(name, np_params(name)) for name in CASES[p]]))
        dirs[p] = d
        procs[p] = torch_ranks.start([str(Path(__file__).resolve()), str(d)], p, d / "logs",
                                     env={"SHARDMERGE_HEARTBEAT_TIMEOUT_S": "60"})
    state = {"procs": procs, "dirs": dirs, "results": {}}
    yield state
    for p in SIZES:
        for proc in procs[p]:
            if proc.poll() is None:
                proc.kill()


def _results(ranks, p, timeout=60):
    """The P ranks' results, waiting at most ``timeout`` seconds for them."""
    from .torch_ranks import wait

    if p in ranks["results"]:
        return ranks["results"][p]
    d = ranks["dirs"][p]
    for rank, (rc, _, err) in enumerate(wait(ranks["procs"][p], d / "logs", timeout)):
        assert rc == 0, f"P={p} rank {rank} exited {rc}:\n{err[-3000:]}"
    ranks["results"][p] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(p)]
    return ranks["results"][p]


def _jax(name, p, batch=False):
    """JAX's numbers for ``name`` on a P-device mesh: the forward's logits
    (as the ranks compute them, each call jitted) over ``shard_params``, and
    the engine's greedy stream (and ``batch``: its ragged batch)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from shardmerge_tpu.inference import InferenceEngine as JaxEngine
    from shardmerge_tpu.models import llama as jllama
    from shardmerge_tpu.parallel.train import shard_params

    cfg = jllama.ModelConfig.from_hf_config(hf_config(name))
    params = _tree_map(jnp.asarray, np_params(name))
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("tp",)) if cfg.vocab_size % p == 0 else None
    placed = shard_params(mesh, params) if mesh is not None else params
    S, T, ids, pos, slot, valid, steps = forward_inputs(cfg.vocab_size)
    dtype = jnp.bfloat16 if FAMILIES[name][1] == "bf16" else jnp.float32
    kv = jllama.init_kv_cache(cfg, 2, S, dtype)
    rope = jllama.rope_tables(cfg, S)
    a = jnp.asarray

    def call(ids, pos, kv, at, length, mpos):
        fn = jax.jit(lambda pr, i, ps, c, m, v: jllama.forward(pr, cfg, i, ps, c, at, rope, length, mask_positions=m,
                                                                  token_valid=v))
        return fn(placed, a(ids), a(pos), kv, a(mpos), a(valid))

    logits, kv = call(ids, pos, kv, 0, T, slot)
    out = {"logits": [np.asarray(logits, np.float32)[valid[:, :T]]]}
    tok, at, pp = steps[0]
    logits, kv = call(tok, pp, kv, at, at + 1, np.full((2, 1), at))
    out["logits"].append(np.asarray(logits, np.float32))
    eng = JaxEngine(cfg, params, StubTokenizer(), mesh=mesh)
    kw = dict(max_new_tokens=NEW, greedy=True, use_template=False)
    out["stream"] = "".join(eng.stream_generation(STREAM, **kw))
    if batch:
        out["batch"] = eng.generate_batch(BATCH, **kw)
    return out


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


CASE_IDS = [(p, name) for p in SIZES for name in CASES[p]]


@pytest.mark.parametrize("p,name", CASE_IDS, ids=[f"P{p}-{n}" for p, n in CASE_IDS])
def test_ranks_match_jax_sharded_engine(ranks, p, name):
    """Greedy tokens equal JAX's sharded engine's; prefill and decode logits
    within relL2 1e-5 (f32 activations; bf16 weights: ``BF16_BOUND``); every
    rank saw the same bits after every all-reduce and gather."""
    got = _results(ranks, p)
    want = _jax(name, p, batch=name == CASES[p][0] or name == "vocab_odd")
    ours = got[0][name]
    bound = BF16_BOUND if FAMILIES[name][1] == "bf16" else 1e-5
    assert len(want["logits"]) == 2
    for a, b in zip(ours["logits"], want["logits"]):
        assert rel_l2(a, b) <= bound, (p, name, rel_l2(a, b))
    assert ours["stream"] == want["stream"]
    if "batch" in want:
        assert ours["batch"] == want["batch"]
    assert ours["crc"] and all(r[name + "/crc"] == ours["crc"] for r in got[1:]), "ranks disagree after a collective"


@pytest.mark.parametrize("p", SIZES)
def test_pool_speculation_and_prefix_cache_over_ranks(ranks, p):
    """The pool over a TP engine (a staggered join, a frontier jump, a forced
    compaction) gives the unsharded solo streams; speculation on the
    sharded target, a self-draft and a weak draft, gives sharded plain
    decoding's tokens; a prefix-cache hit (64 tokens) decodes as the cold
    prefill does."""
    ours = _results(ranks, p)[0][CASES[p][0]]
    assert ours["pool"][:2] == [True, True] and ours["pool"][2] >= 1
    assert ours["spec"][1] == ours["spec"][0] and ours["spec"][2] == ours["spec"][0]
    assert ours["prefix"] == [True, 64]


# -- the rules, in-process ------------------------------------------------------------


def _port_specs(name, p):
    from shardmerge_tpu_torch.models.convert import params_from_jax
    from shardmerge_tpu_torch.parallel.train import param_shardings

    return param_shardings(params_from_jax(np_params(name)), p)


@pytest.mark.parametrize("name", ["llama", "llama_int8", "llama_int4", "qwen2", "gemma", "mixtral", "deepseek_v2",
                                  "gpt_oss", "gpt_oss_e6", "llama4"])
@pytest.mark.parametrize("p", SIZES)
def test_spec_table_equals_jax_param_shardings(name, p):
    import jax
    from jax.sharding import Mesh

    from shardmerge_tpu.parallel.train import param_shardings

    mesh = Mesh(np.asarray(jax.devices()[:p]), ("tp",))
    theirs = _tree_map(lambda s: tuple(s.spec), param_shardings(mesh, np_params(name)))
    assert _port_specs(name, p) == theirs


def _join(slices, spec_axis):
    import torch

    return torch.cat(slices, dim=spec_axis)


@pytest.mark.parametrize("name", ["llama", "llama_int8", "llama_int4", "mixtral", "gpt_oss", "deepseek_v2", "llama4"])
@pytest.mark.parametrize("p", SIZES)
def test_rank_slices_put_back_together_give_the_full_params(name, p):
    """Every split leaf's P slices concatenated on its split axis equal the
    leaf bit for bit; a packed int4 row slice's concatenation equals JAX's
    ``_repack4_tp_blocked`` of the full bytes; replicated leaves and
    row-parallel scales are the full ones on every rank. Where KVH % P != 0
    each rank's k/v rows are those of the KV heads its queries read."""
    import torch

    from shardmerge_tpu.parallel.pipeline import _repack4_tp_blocked
    from shardmerge_tpu_torch.models import llama as tllama
    from shardmerge_tpu_torch.models.convert import params_from_jax
    from shardmerge_tpu_torch.parallel.train import plan, shard_params

    cfg = tllama.ModelConfig.from_hf_config(hf_config(name))
    full = params_from_jax(np_params(name))
    specs = _port_specs(name, p)
    plans = [plan(cfg, r, p, FAMILIES[name][2]) for r in range(p)]
    parts = [shard_params(full, cfg, pl) for pl in plans]
    seen = 0
    if not cfg.is_mla and cfg.num_key_value_heads % p:
        D = cfg.head_dim
        for i, layer in enumerate(full["layers"]):
            for key in ("k_proj", "v_proj", "k_bias", "v_bias"):
                if key in layer:
                    for pl, part in zip(plans, parts):
                        k0, k1 = pl.layers[i].kv_heads
                        assert torch.equal(part["layers"][i].pop(key), layer[key][k0 * D:k1 * D]), (i, key)
                        seen += 1
            for key in ("k_proj", "v_proj", "k_bias", "v_bias"):
                layer.pop(key, None)

    def check(spec, leaf, slices, where):
        nonlocal seen
        if isinstance(leaf, dict):
            for k in leaf:
                check(spec[k] if isinstance(spec, dict) else spec, leaf[k], [s[k] for s in slices], where + "/" + k)
            return
        if isinstance(leaf, list):
            for i, v in enumerate(leaf):
                check(spec[i], v, [s[i] for s in slices], f"{where}/{i}")
            return
        split = [s is not leaf and s.shape != leaf.shape for s in slices]
        if not any(split):
            for s in slices:
                assert torch.equal(s, leaf), where
            return
        seen += 1
        axis = list(spec).index("tp")
        whole = _join(slices, axis)
        if leaf.dtype == torch.uint8 and axis == 1:
            want = torch.from_numpy(np.asarray(_repack4_tp_blocked(leaf.numpy(), p)))
            assert torch.equal(whole, want), where
        else:
            assert torch.equal(whole, leaf), where

    for key in ("embed_tokens", "lm_head"):
        if key in full:
            check(specs[key], full[key], [s[key] for s in parts], key)
    for i, layer in enumerate(full["layers"]):
        check(specs["layers"][i], layer, [s["layers"][i] for s in parts], f"layers/{i}")
    assert seen > 0


def test_int4_repack_equals_jax():
    from shardmerge_tpu.parallel.pipeline import _repack4_tp_blocked
    from shardmerge_tpu_torch.parallel.train import repack4_tp_blocked

    import torch

    q = np.random.default_rng(7).integers(0, 256, size=(24, 64), dtype=np.uint8)
    for n in (2, 4, 8):
        assert np.array_equal(repack4_tp_blocked(torch.from_numpy(q), n).numpy(),
                              np.asarray(_repack4_tp_blocked(q, n)))
    with pytest.raises(ValueError, match="even"):
        repack4_tp_blocked(torch.from_numpy(q[:, :3]), 2)


def test_head_vocab_and_expert_rules():
    """Head-parallel where heads divide P and each rank's queries read whole
    KV heads of their own (ChatGLM's 2 KV heads at P = 4: each held by two
    ranks), replicated otherwise; the vocab, an expert count or an MLP width
    that does not divide P replicates (JAX's loader ``_fits``)."""
    from shardmerge_tpu.models.loader import _StreamShardings
    import jax
    from jax.sharding import Mesh

    from shardmerge_tpu_torch.models import llama as tllama
    from shardmerge_tpu_torch.parallel.train import fits, loader_rules, plan

    def cfg(**kw):
        return tllama.ModelConfig.from_hf_config({**BASE, **kw})

    pl = [plan(cfg(num_key_value_heads=2), r, 4) for r in range(4)]
    assert [x.layers[0].heads for x in pl] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [x.layers[0].kv_heads for x in pl] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert plan(cfg(num_attention_heads=6, num_key_value_heads=6), 0, 4).layers[0].heads is None
    assert plan(cfg(num_attention_heads=8, num_key_value_heads=8), 1, 4).layers[0].kv_heads == (2, 4)
    assert plan(cfg(vocab_size=126), 0, 4).vocab is None and plan(cfg(), 3, 4).vocab == (96, 128)
    assert plan(cfg(intermediate_size=126), 0, 4).layers[0].mlp is False
    assert plan(cfg(intermediate_size=12), 0, 4, quant_bits=4).layers[0].mlp is False  # odd int4 K/P
    assert plan(tllama.ModelConfig.from_hf_config(hf_config("gpt_oss_e6")), 0, 4).layers[0].stacks is None
    assert plan(tllama.ModelConfig.from_hf_config(hf_config("gpt_oss")), 1, 2).layers[0].stacks == (2, 4)
    # the divisibility rule is the JAX loader's
    ss = _StreamShardings(Mesh(np.asarray(jax.devices()[:4]), ("tp",)))
    layer_rules, top_rules, rep = loader_rules()
    for shape in ((128, 64), (126, 64), (64, 126)):
        for key, rule in list(layer_rules.items())[:8] + list(top_rules.items()):
            if len(rule) != len(shape):
                continue
            theirs = ss.top(key, shape) if key in top_rules else ss.layer(key, shape)
            assert (tuple(theirs.spec) == rule) == fits(rule, shape, 4), (key, shape)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_loader_slices_equal_the_sliced_full_load(tmp_path, bits):
    """``load_params(tp=plan)`` on each rank equals the full load cut by
    ``shard_params``: quantized whole on the host, then sliced (a row slice
    keeps the full row's scale; int4 rows re-packed)."""
    import torch

    from shardmerge_tpu_torch.models import llama as tllama
    from shardmerge_tpu_torch.models.loader import load_params
    from shardmerge_tpu_torch.parallel.train import plan, shard_params

    from .test_torch_engine import HF_CONFIG, _save_tiny_checkpoint

    _save_tiny_checkpoint(tmp_path)
    cfg = tllama.ModelConfig.from_hf_config(HF_CONFIG)
    full = load_params(tmp_path, cfg, dtype=torch.float32, quant_bits=bits)
    for r in range(2):
        pl = plan(cfg, r, 2, bits)
        mine = load_params(tmp_path, cfg, dtype=torch.float32, quant_bits=bits, tp=pl)
        want = shard_params(full, cfg, pl)
        flat_a, flat_b = _flatten(mine), _flatten(want)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_b[k]), k
        assert any(flat_a[k].shape != v.shape for k, v in _flatten(full).items())


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def test_collectives_per_forward_counts_the_models_calls():
    """The predicted collectives of one forward equal those a P = 1 stand-in
    group counts (every split module calls it once)."""
    import torch

    from shardmerge_tpu_torch.models import llama as tllama
    from shardmerge_tpu_torch.models.convert import params_from_jax
    from shardmerge_tpu_torch.parallel.train import Plan, collectives_per_forward, plan

    class Counting:
        def __init__(self, pl):
            self.plan, self.calls = pl, {"all_reduce": 0, "all_gather": 0}

        def all_reduce(self, x):
            self.calls["all_reduce"] += 1
            return x

        def gather_vocab(self, x):
            self.calls["all_gather"] += 1
            return x

    for name in ("llama", "olmo2", "mixtral", "deepseek_v2", "gpt_oss", "llama4"):
        cfg = tllama.ModelConfig.from_hf_config(hf_config(name))
        full = params_from_jax(np_params(name))
        split = plan(cfg, 0, 2)
        # the plan of rank 0 of 2 over the FULL params' geometry (P = 1 arithmetic)
        one = Plan(rank=0, size=1, vocab=(0, cfg.vocab_size), layers=tuple(
            type(lp)(heads=(0, cfg.num_attention_heads) if lp.heads else None,
                     kv_heads=(0, cfg.num_key_value_heads) if lp.kv_heads else None, mlp=lp.mlp,
                     experts=lp.experts, stacks=(0, cfg.num_local_experts) if lp.stacks else None)
            for lp in split.layers))
        group = Counting(one)
        model = tllama.LlamaModel(cfg, full, tp=group)
        S = 16
        with torch.inference_mode():
            model(torch.ones((1, 4), dtype=torch.int64), torch.arange(4)[None], tllama.init_kv_cache(
                cfg, 1, S, torch.float32, kv_heads=model.kv_heads), 0, tllama.rope_tables(cfg, S), 4)
        assert group.calls == collectives_per_forward(cfg, split), name


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _rank_body(Path(sys.argv[1]))
