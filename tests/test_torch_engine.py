"""Port vs JAX: the Llama forward and the inference engine
(shardmerge_tpu_torch/models/llama.py, inference.py against
shardmerge_tpu/models/llama.py, inference.py) on the same weights, carried
across by models/convert.params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.models import llama as jllama
from shardmerge_tpu.models import quant as jquant
from shardmerge_tpu_torch.inference import InferenceEngine
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.models.convert import params_from_jax
from shardmerge_tpu_torch.models.loader import load_params
from shardmerge_tpu_torch.models.sampling import sample_token

HF_CONFIG = {
    "model_type": "llama",
    "vocab_size": 128,
    "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2,
    "num_attention_heads": 4,
    "num_key_value_heads": 2,
    "max_position_embeddings": 256,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "rope_type": "llama3",
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32,
    },
    "tie_word_embeddings": False,
}
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


class StubTokenizer:
    """One token per character, decoded injectively."""

    chat_template = None
    eos_token_id = 1

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


def _params(quant: bool):
    """JAX params (numpy leaves), int4-quantized on the host if asked."""
    cfg = jllama.ModelConfig.from_hf_config(HF_CONFIG)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    )
    if quant:
        for layer in params["layers"]:
            for name in PROJ:
                layer[name] = jquant.quantize(layer[name], bits=4)
    return cfg, params


@pytest.fixture(scope="module", params=["f32", "int4"])
def engines(request):
    quant = request.param == "int4"
    jcfg, params = _params(quant)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tcfg = tllama.ModelConfig.from_hf_config(HF_CONFIG)
    model = tllama.LlamaModel(tcfg, params_from_jax(params, "cpu"))
    return (
        request.param,
        JaxEngine(jcfg, jparams, StubTokenizer()),
        InferenceEngine(tcfg, model, StubTokenizer()),
    )


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_forward_logits_match_jax(engines):
    """Prefill (T=9) then one decode step: relL2 <= 1e-5 in f32, <= 1e-3
    with int4 projections (both on the split-half matmul path here)."""
    kind, jeng, teng = engines
    tol = 1e-5 if kind == "f32" else 1e-3
    jcfg, tcfg = jeng.cfg, teng.cfg
    ids = np.random.default_rng(41).integers(2, 128, size=(2, 9))
    pos = np.broadcast_to(np.arange(9), (2, 9))
    S = 16
    jkv = jllama.init_kv_cache(jcfg, 2, S, jnp.float32)
    tkv = tllama.init_kv_cache(tcfg, 2, S, torch.float32)
    jrope = jllama.rope_tables(jcfg, S)
    trope = tllama.rope_tables(tcfg, S)
    jl, jkv = jllama.forward(jeng.params, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv, 0, jrope, 9)
    with torch.inference_mode():
        tl, tkv = teng.model(torch.from_numpy(ids), torch.from_numpy(pos.copy()), tkv, 0, trope, 9)
    assert _rel_l2(tl.numpy(), np.asarray(jl)) <= tol
    np.testing.assert_allclose(
        tkv["k"].numpy(), np.asarray(jkv["k"]), rtol=tol, atol=tol * float(np.abs(np.asarray(jkv["k"])).max())
    )
    step = np.asarray([[7], [9]])
    jl, _ = jllama.forward(jeng.params, jcfg, jnp.asarray(step), jnp.full((2, 1), 9), jkv, 9, jrope, 10)
    with torch.inference_mode():
        tl, _ = teng.model(torch.from_numpy(step), torch.full((2, 1), 9), tkv, 9, trope, 10)
    assert _rel_l2(tl.numpy(), np.asarray(jl)) <= tol


def test_generate_batch_greedy_tokens_match_jax(engines):
    _, jeng, teng = engines
    prompts = ["hello there", "a", "the quick brown fox jumps"]  # ragged
    kw = dict(max_new_tokens=6, greedy=True, return_meta=True)
    theirs = jeng.generate_batch(prompts, use_template=False, **kw)
    ours = teng.generate_batch(prompts, **kw)
    assert ours == theirs
    assert all(t for t in ours[0])


def test_stream_generation_greedy_matches_jax(engines):
    _, jeng, teng = engines
    kw = dict(max_new_tokens=5, greedy=True)
    jmeta, tmeta = {}, {}
    theirs = "".join(jeng.stream_generation("hi there", meta=jmeta, use_template=False, **kw))
    ours = "".join(teng.stream_generation("hi there", meta=tmeta, **kw))
    assert ours == theirs and ours
    assert tmeta["completion_tokens"] == jmeta["completion_tokens"]


def test_load_params_quantizes_projections_on_host(tmp_path):
    params = _save_tiny_checkpoint(tmp_path)
    loaded = load_params(tmp_path, quant_bits=4, dtype=torch.float32)
    assert loaded["embed_tokens"].dtype == torch.float32  # not quantized
    wq = jquant.quantize(params["layers"][1]["down_proj"], bits=4)
    got = loaded["layers"][1]["down_proj"]
    np.testing.assert_array_equal(got["q"].numpy(), wq["q"])
    np.testing.assert_array_equal(got["scale"].numpy(), wq["scale"])


def test_unported_families_raise():
    # gpt_oss, refused here until it was ported, now builds a model that decodes
    gpt_oss = tllama.ModelConfig.from_hf_config({**HF_CONFIG, "model_type": "gpt_oss", "num_local_experts": 4,
                                                 "num_experts_per_tok": 2, "attention_bias": True})
    engine = InferenceEngine(gpt_oss, tllama.LlamaModel(gpt_oss, tllama.init_params(gpt_oss, seed=3,
                                                                                    dtype=torch.float32)),
                             StubTokenizer())
    assert len("".join(engine.stream_generation("hi", max_new_tokens=3, greedy=True))) > 0
    with pytest.raises(NotImplementedError, match="model_type 'falcon'"):
        tllama.ModelConfig.from_hf_config({**HF_CONFIG, "model_type": "falcon"})
    dynamic = {**HF_CONFIG, "rope_scaling": {"rope_type": "dynamic", "factor": 4.0}}
    with pytest.raises(NotImplementedError, match="dynamic"):
        tllama.rope_tables(tllama.ModelConfig.from_hf_config(dynamic), 8)


# configs the port refused before the dense families were ported
ONCE_REFUSED = {
    "yarn": {"rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    "sliding_window": {"model_type": "mistral", "sliding_window": 3},
    "attn_logit_softcapping": {"model_type": "gemma2", "attn_logit_softcapping": 5.0, "head_dim": 16,
                               "sliding_window": 4},
    "attention_bias": {"model_type": "qwen2"},
    "hidden_act": {"model_type": "gemma", "hidden_act": "gelu_pytorch_tanh", "head_dim": 16},
}


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_once_refused_configs_reach_the_engine(name):
    """Each config the port used to refuse now builds, ropes as the JAX
    tables do, and decodes greedy tokens through the engine on the CPU."""
    hf = {**HF_CONFIG, **ONCE_REFUSED[name]}
    tcfg = tllama.ModelConfig.from_hf_config(hf)
    jcfg = jllama.ModelConfig.from_hf_config(hf)
    for ours, theirs in zip(tllama.rope_tables(tcfg, 64), jllama.rope_tables(jcfg, 64)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    model = tllama.LlamaModel(tcfg, tllama.init_params(tcfg, seed=3, dtype=torch.float32))
    text = "".join(InferenceEngine(tcfg, model, StubTokenizer()).stream_generation(
        "reaches the engine", max_new_tokens=4, greedy=True))
    assert text.count("<") == 4 or text.endswith("<1>")


def test_sampling_top_k_one_and_penalty_greedy():
    logits = torch.tensor([[2.0, 1.9, -1.0]])
    none = torch.zeros((1, 3), dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        assert int(sample_token(logits, none, 1.0, 1, 1.0, 1.0, generator=g)[0]) == 0
    seen = torch.tensor([[True, False, False]])
    assert int(sample_token(logits, seen, repetition_penalty=2.0, greedy=True)[0]) == 1


def test_sampling_distribution_matches_jax():
    """Penalty, temperature, top-k and top-p together: 20000 draws from the
    port (torch.Generator) and from JAX (jax.random) hit exactly the tokens
    the filters keep, each at its filtered softmax probability within 0.02
    (~6 sigma of a 20000-draw frequency)."""
    n, temperature, top_k, top_p, penalty = 20000, 0.8, 5, 0.9, 1.3
    row = np.array([3.0, 2.5, 2.2, 1.8, 0.5, -1.0, -2.0], np.float32)
    seen_row = np.array([False, True, False, False, False, True, False])
    # numpy reference of the filters
    pen = np.where(seen_row, np.where(row > 0, row / penalty, row * penalty), row)
    scaled = pen / temperature
    order = np.argsort(-scaled)[:top_k]
    p = np.exp(scaled[order] - scaled[order].max())
    p /= p.sum()
    kept = order[(np.cumsum(p) - p) < top_p]
    want = np.zeros(row.size)
    want[kept] = np.exp(scaled[kept] - scaled[kept].max())
    want /= want.sum()
    assert 2 <= kept.size < top_k and want[kept].min() > 0.05  # the case bites

    logits = np.broadcast_to(row, (n, row.size))
    seen = np.broadcast_to(seen_row, (n, row.size))
    ours = sample_token(
        torch.from_numpy(logits.copy()), torch.from_numpy(seen.copy()),
        temperature, top_k, top_p, penalty, generator=torch.Generator().manual_seed(3),
    ).numpy()
    from shardmerge_tpu.models.sampling import sample_token as jax_sample_token

    theirs = np.asarray(
        jax_sample_token(
            jnp.asarray(logits), jax.random.PRNGKey(3), jnp.asarray(seen),
            temperature, top_k, top_p, penalty,
        )
    )
    for draws in (ours, theirs):
        freq = np.bincount(draws, minlength=row.size) / n
        assert set(np.flatnonzero(freq)) == set(kept)
        np.testing.assert_allclose(freq, want, atol=0.02)


def _save_tiny_checkpoint(path):
    from shardmerge_tpu_torch.io.safetensors_io import save_file

    _, params = _params(quant=False)
    tensors = {
        "model.embed_tokens.weight": params["embed_tokens"],
        "model.norm.weight": params["norm"],
        "lm_head.weight": params["lm_head"],
    }
    for i, layer in enumerate(params["layers"]):
        for name in PROJ:
            group = "mlp" if name in ("gate_proj", "up_proj", "down_proj") else "self_attn"
            tensors[f"model.layers.{i}.{group}.{name}.weight"] = layer[name]
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"model.layers.{i}.{name}.weight"] = layer[name]
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: torch.from_numpy(np.array(v)) for k, v in tensors.items()}, path / "model.safetensors")
    import json

    (path / "config.json").write_text(json.dumps(HF_CONFIG))
    return params


def test_cli_generate_reads_tokenizer_json(tmp_path, capsys):
    """``generate`` on the host with int4 weights; the tokenizer comes from
    tokenizer.json (its class from tokenizer_config.json, as the JAX
    engine's AutoTokenizer reads it), and its absence is reported by
    name."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    from shardmerge_tpu_torch.cli import main

    _save_tiny_checkpoint(tmp_path / "m")
    argv = ["generate", str(tmp_path / "m"), "w3 w5", "--max-tokens", "4",
            "--greedy", "-4", "--device", "cpu"]
    assert main(argv) == 2
    assert "tokenizer.json" in capsys.readouterr().err
    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(128)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "m" / "tokenizer.json"))
    (tmp_path / "m" / "tokenizer_config.json").write_text('{"tokenizer_class": "PreTrainedTokenizerFast"}')
    assert main(argv) == 0
    out = capsys.readouterr().out.split()
    assert len(out) == 4 and all(w.startswith("w") for w in out)


def test_port_imports_without_jax_and_host_extras(tmp_path):
    """The port loads (serving modules and kernel wrappers included),
    parses a JSON config and builds a model with jax, ml_dtypes, yaml, click
    and transformers all unimportable."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ml_dtypes', 'yaml', 'click', 'transformers',"
        " 'shardmerge_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import shardmerge_tpu_torch.cli, shardmerge_tpu_torch.inference\n"
        "import shardmerge_tpu_torch.merge, shardmerge_tpu_torch.models.convert\n"
        "import shardmerge_tpu_torch.batching, shardmerge_tpu_torch.serve\n"
        "import shardmerge_tpu_torch.models.attn_kernels\n"
        "import shardmerge_tpu_torch.ops.pallas_fft, shardmerge_tpu_torch.ops.fft_vpu\n"
        "from shardmerge_tpu_torch.config import MergeConfig\n"
        "cfg = MergeConfig.from_file(sys.argv[1])\n"
        "assert cfg.finetune_merge[0].alpha == 0.5, cfg\n"
        "print('ok')\n"
    )
    cfg = tmp_path / "cfg.json"
    cfg.write_text(
        '{"output_base_model": "b", "output_dir": "o",'
        ' "finetune_merge": [{"model": "m", "base": "b", "alpha": 0.5}]}'
    )
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code, str(cfg)], cwd=repo, capture_output=True, text=True
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
