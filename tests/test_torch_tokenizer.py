"""Port vs JAX: the engine's tokenizer (shardmerge_tpu_torch/inference.py
``load_tokenizer`` and serve.py's chat path against
shardmerge_tpu/inference.py's ``AutoTokenizer`` and serve.py).

A word-level tokenizer built in the test sits beside a tiny Llama
checkpoint, with a ``tokenizer_config.json`` that carries a chat template
and an EOS token, and a ``generation_config.json`` whose ``eos_token_id``
list differs from it. Prompt ids, chat prompts and the EOS set must equal
the JAX engine's on the same directory."""

import json
import sys

import pytest
import torch
from tokenizers import Tokenizer, pre_tokenizers
from tokenizers import models as tok_models

from shardmerge_tpu.inference import InferenceEngine as JaxEngine
from shardmerge_tpu.serve import ModelServer as JaxServer
from shardmerge_tpu_torch.inference import InferenceEngine, load_tokenizer
from shardmerge_tpu_torch.io.safetensors_io import save_file
from shardmerge_tpu_torch.models import llama as tllama
from shardmerge_tpu_torch.serve import ModelServer

HF = {"model_type": "llama", "vocab_size": 128, "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
      "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 512,
      "tie_word_embeddings": False, "eos_token_id": 1}
SPECIAL = ["<unk>", "<s>", "</s>", "<|system|>", "<|user|>", "<|assistant|>"]
TEMPLATE = ("{% for m in messages %}<|{{ m['role'] }}|> {{ m['content'] }} {{ eos_token }}\n{% endfor %}"
            "{% if add_generation_prompt %}<|assistant|>{% endif %}")


def write_checkpoint(path, template=TEMPLATE, words=("hi", "there", "be", "brief", "hello", "again")):
    """A tiny Llama checkpoint in HF naming with a word-level tokenizer."""
    path.mkdir(parents=True)
    cfg = tllama.ModelConfig.from_hf_config(HF)
    params = tllama.init_params(cfg, seed=3, dtype=torch.float32)
    tensors = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"],
               "lm_head.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        for key, value in layer.items():
            group = "self_attn" if key in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            name = f"{group}.{key}" if key.endswith("_proj") else key
            tensors[f"model.layers.{i}.{name}.weight"] = value
    save_file(tensors, path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(HF))
    vocab = {w: i for i, w in enumerate(SPECIAL + list(words))}
    vocab.update({f"w{i}": i for i in range(len(vocab), HF["vocab_size"])})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.add_special_tokens(SPECIAL[:3])
    tok.save(str(path / "tokenizer.json"))
    config = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
              "unk_token": "<unk>"}
    if template is not None:
        config["chat_template"] = template
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": [1, 2]}))
    return path


CONVERSATIONS = [
    ("hi", None, None),
    ("hello there", "be brief", None),
    ("again", "be brief", [("user", "hi"), ("assistant", "hello there")]),
]


def _encodes(engine, message_cls, use_template=True):
    out = []
    for prompt, system, previous in CONVERSATIONS:
        prev = None if previous is None else [message_cls(r, c) for r, c in previous]
        out.append(engine._encode(prompt, use_template, system, prev))
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from shardmerge_tpu.inference import ChatMessage as JaxMessage
    from shardmerge_tpu_torch.inference import ChatMessage

    path = write_checkpoint(tmp_path_factory.mktemp("tok") / "m")
    return (InferenceEngine.from_pretrained(path, device="cpu"), ChatMessage,
            JaxEngine.from_pretrained(str(path)), JaxMessage)


def test_prompt_ids_and_eos_match_the_jax_engine(engines):
    """The chat template renders (system, history, generation prompt), the
    bare prompt encodes without it, and EOS is tokenizer_config.json's
    token, not generation_config.json's list."""
    port, msg, jeng, jmsg = engines
    assert _encodes(port, msg) == _encodes(jeng, jmsg)
    assert _encodes(port, msg, use_template=False) == _encodes(jeng, jmsg, use_template=False)
    assert _encodes(port, msg)[0] == [4, 6, 2, 5]  # <|user|> hi </s> <|assistant|>
    assert port._eos_ids() == jeng._eos_ids() == {2}
    ids = _encodes(port, msg)[2]
    assert port.tokenizer.decode(ids, skip_special_tokens=True) == jeng.tokenizer.decode(ids, skip_special_tokens=True)


def test_chat_completions_prompt_matches_the_jax_server(engines):
    """/v1/chat/completions: the server renders the conversation through
    the same template path, to the JAX server's ids."""
    port, _, jeng, _ = engines
    payload = {"messages": [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
                            {"role": "assistant", "content": "hello"}, {"role": "user", "content": "again"}],
               "max_tokens": 4}
    ids = []
    for server in (ModelServer(port), JaxServer(jeng)):
        prompt, kwargs, system, previous = server._validate_chat(payload)
        assert kwargs["use_template"] is True
        ids.append(server.engine._encode(prompt, True, system, previous))
    assert ids[0] == ids[1] and ids[0][0] == 3  # <|system|> first


def test_a_directory_without_a_chat_template_matches_the_jax_engine(tmp_path):
    """No chat_template: the prompt encodes bare with the template asked
    for, and EOS is still tokenizer_config.json's, as in the JAX engine."""
    from shardmerge_tpu.inference import ChatMessage as JaxMessage
    from shardmerge_tpu_torch.inference import ChatMessage

    path = write_checkpoint(tmp_path / "m", template=None)
    port, jeng = InferenceEngine.from_pretrained(path, device="cpu"), JaxEngine.from_pretrained(str(path))
    assert _encodes(port, ChatMessage) == _encodes(jeng, JaxMessage)
    assert port._encode("hi there", True, None, None) == [6, 7]
    assert port._eos_ids() == jeng._eos_ids() == {2}


def test_without_transformers_the_tokenizer_load_names_the_extra(tmp_path, monkeypatch):
    path = write_checkpoint(tmp_path / "m")
    monkeypatch.setitem(sys.modules, "transformers", None)  # import fails
    with pytest.raises(RuntimeError, match="'inference' extra"):
        load_tokenizer(path, path)


def test_a_directory_without_tokenizer_files_is_refused(tmp_path):
    path = write_checkpoint(tmp_path / "m")
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (path / name).unlink()
    with pytest.raises(FileNotFoundError, match="generate needs the tokenizer"):
        load_tokenizer(path, path)


def test_tokenizer_directory_follows_the_jax_rule(tmp_path):
    """An adapter directory's own tokenizer serves when it holds
    tokenizer_config.json (a tokenizer.json alone is not enough), else the
    weights directory's (shardmerge_tpu/inference.py's from_pretrained)."""
    base = write_checkpoint(tmp_path / "base")
    own = write_checkpoint(tmp_path / "own", words=("hello", "hi"))
    assert load_tokenizer(own, base).encode("hi") == [7]
    (own / "tokenizer_config.json").unlink()
    assert load_tokenizer(own, base).encode("hi") == [6]


def test_encode_takes_the_ids_of_a_batch_encoding():
    """Newer transformers return a BatchEncoding from
    apply_chat_template(tokenize=True); the engine reads its input_ids."""

    class DictTemplate:
        chat_template = "x"
        eos_token_id = None

        def apply_chat_template(self, messages, tokenize, add_generation_prompt):
            return {"input_ids": [7, 8, len(messages)], "attention_mask": [1, 1, 1]}

    cfg = tllama.ModelConfig.from_hf_config(HF)
    engine = InferenceEngine(cfg, tllama.LlamaModel(cfg, tllama.init_params(cfg, seed=0, dtype=torch.float32)),
                             DictTemplate())
    assert engine._encode("hi", True, "sys", None) == [7, 8, 2]
