"""Inference engine: streaming and batched generation (counterpart of
shardmerge_tpu/inference.py).

The JAX engine jits one forward for chunked prefill and fuses sampling with
the next forward; PyTorch runs eagerly, so here each decode step is
sample -> penalty-mask update -> forward, with the token read back on the
host. The numbers follow the JAX engine: the same prompt and cache
bucketing, the same masks, greedy tokens identical on the same weights.

Prompts are encoded as given (no chat template). Not ported yet: chat
templates, speculative decoding, the prefix cache, ``decode_chunk > 1``, stop
sequences and the mesh-sharded engine.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from .models.llama import LlamaModel, ModelConfig, init_kv_cache, rope_tables
from .models.loader import load_params
from .models.sampling import sample_token

__all__ = ["InferenceEngine", "JsonTokenizer"]

_CACHE_BUCKET = 256  # KV cache length granularity
_PROMPT_BUCKET = 64  # prompts pad to a multiple of this
_PROMPT_CHUNK = 512  # prefill chunk cap


class JsonTokenizer:
    """A ``tokenizer.json`` (HF ``tokenizers`` format) behind the small
    interface the engine uses: ``encode``, ``decode``, ``eos_token_id``."""

    def __init__(self, model_dir):
        model_dir = Path(model_dir)
        path = model_dir / "tokenizer.json"
        if not path.is_file():
            raise FileNotFoundError(
                f"generate needs a tokenizer.json next to the model ({path})"
            )
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise RuntimeError(
                "reading tokenizer.json needs the 'tokenizers' package"
            ) from e
        self._tok = Tokenizer.from_file(str(path))
        self.eos_token_id = None
        for name in ("generation_config.json", "config.json"):
            f = model_dir / name
            if f.is_file():
                eos = json.loads(f.read_text()).get("eos_token_id")
                if eos is not None:
                    self.eos_token_id = eos
                    break

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, model: LlamaModel, tokenizer):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.device = model.device

    @classmethod
    def from_pretrained(
        cls,
        model_path,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        tokenizer=None,
        device="cuda:0",
    ) -> "InferenceEngine":
        if load_in_4bit and load_in_8bit:
            raise ValueError("Cannot load model in both 4-bit and 8-bit precision")
        quant_bits = 4 if load_in_4bit else 8 if load_in_8bit else None
        cfg = ModelConfig.from_pretrained(model_path)
        params = load_params(model_path, cfg, quant_bits=quant_bits, device=device)
        if tokenizer is None:
            tokenizer = JsonTokenizer(model_path)
        return cls(cfg, LlamaModel(cfg, params), tokenizer)

    # -- helpers -------------------------------------------------------------

    def _eos_ids(self) -> set:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            return set()
        return set(eos) if isinstance(eos, (list, tuple)) else {eos}

    def _long(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.array(arr), dtype=torch.int64, device=self.device)

    def _chunked_prefill(
        self, ids, positions, kv, rope, final_attn_len, keep_pos=None,
        mask_positions=None, token_valid=None,
    ):
        """Prefill in chunks of at most ``_PROMPT_CHUNK`` tokens; returns the
        (B, V) logits at ``keep_pos`` (default: the last row) and the cache.
        Causality makes chunking exact: a chunk's queries only attend slots
        already written."""
        B, L = ids.shape
        if keep_pos is None:
            keep_pos = L - 1
        kept = None
        for c0 in range(0, L, _PROMPT_CHUNK):
            c1 = min(c0 + _PROMPT_CHUNK, L)
            logits, kv = self.model(
                ids[:, c0:c1],
                positions[:, c0:c1],
                kv,
                c0,
                rope,
                min(c1, final_attn_len),
                mask_positions=None if mask_positions is None else mask_positions[:, c0:c1],
                token_valid=token_valid,
            )
            if c0 <= keep_pos < c1:
                kept = logits[:, keep_pos - c0, :]
        return kept, kv

    def _step(self, last, mask, kv, rope, pos, pad, sampling, generator, token_valid=None):
        """Sample from ``last``, record the token in the penalty mask and run
        its forward at cache slot ``pos``; returns (tokens, logits, kv)."""
        B = last.shape[0]
        tok = sample_token(last, mask, generator=generator, **sampling)
        mask[torch.arange(B, device=self.device), tok] = True
        logits, kv = self.model(
            tok[:, None],
            pos - pad,
            kv,
            pos,
            rope,
            pos + 1,
            mask_positions=None
            if token_valid is None
            else torch.full((B, 1), pos, dtype=torch.int64, device=self.device),
            token_valid=token_valid,
        )
        return tok, logits[:, -1, :], kv

    # -- generation ----------------------------------------------------------

    @torch.inference_mode()
    def stream_generation(
        self,
        prompt: str,
        max_new_tokens: int = 512,
        temperature: float = 0.7,
        top_p: float = 0.95,
        top_k: int = 40,
        repetition_penalty: float = 1.1,
        greedy: bool = False,
        seed: int = 0,
        meta: Optional[dict] = None,
    ) -> Iterator[str]:
        """Yield generated text chunks token by token; ``meta`` receives
        finish_reason ("stop" at EOS, else "length") and token counts."""
        cfg = self.cfg
        if meta is None:
            meta = {}
        meta.setdefault("finish_reason", "length")
        input_ids = list(self.tokenizer.encode(prompt))
        prompt_len = len(input_ids)
        if prompt_len == 0 or max_new_tokens <= 0:
            return

        cache_len = -(-(prompt_len + max_new_tokens) // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        kv = init_kv_cache(cfg, 1, cache_len, self.model.dtype, self.device)
        padded_len = min(-(-prompt_len // _PROMPT_BUCKET) * _PROMPT_BUCKET, cache_len)
        ids = self._long([input_ids + [0] * (padded_len - prompt_len)])
        positions = torch.arange(padded_len, device=self.device)[None, :]
        last, kv = self._chunked_prefill(
            ids, positions, kv, rope, prompt_len, keep_pos=prompt_len - 1
        )

        generator = torch.Generator(device=self.device).manual_seed(seed)
        sampling = dict(
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, greedy=greedy,
        )
        eos_ids = self._eos_ids()
        mask = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=self.device)
        no_pad = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        generated: List[int] = []
        emitted_text = ""
        for step in range(max_new_tokens):
            tok, last, kv = self._step(
                last, mask, kv, rope, prompt_len + step, no_pad, sampling, generator
            )
            token_id = int(tok[0])
            generated.append(token_id)
            # incremental decode: emit the new text suffix (BPE joins),
            # holding back a trailing partial character
            text = self.tokenizer.decode(generated, skip_special_tokens=True)
            if len(text) > len(emitted_text) and not text.endswith("\ufffd"):
                yield text[len(emitted_text) :]
                emitted_text = text
            if token_id in eos_ids:
                meta["finish_reason"] = "stop"
                break

        meta["prompt_tokens"] = prompt_len
        # the EOS token is not a completion token
        meta["completion_tokens"] = len(generated) - (meta["finish_reason"] == "stop")
        text = self.tokenizer.decode(generated, skip_special_tokens=True)
        if len(text) > len(emitted_text):
            yield text[len(emitted_text) :]

    @torch.inference_mode()
    def generate_batch(
        self,
        prompts: List[str],
        max_new_tokens: int = 128,
        temperature: float = 0.7,
        top_p: float = 0.95,
        top_k: int = 40,
        repetition_penalty: float = 1.1,
        greedy: bool = False,
        seed: int = 0,
        return_meta: bool = False,
        meta: Optional[dict] = None,
    ):
        """Generate completions for a batch in lockstep.

        Ragged prompts are LEFT-padded to one bucketed length, so every
        row's last prompt token sits at slot L-1 and decode advances one
        shared cache slot per step; pad slots are masked out through
        ``token_valid`` and RoPE positions start at 0 on each row's first
        real token. Rows that hit EOS keep decoding (tokens discarded)
        until all rows finish. Returns texts, or ``(texts, finish_reasons)``
        with ``return_meta``."""
        cfg = self.cfg
        seqs = [list(self.tokenizer.encode(p)) for p in prompts]
        if not seqs:
            return ([], []) if return_meta else []
        if any(len(s) == 0 for s in seqs):
            raise ValueError("generate_batch: empty prompt after encoding")
        B = len(seqs)
        L = -(-max(len(s) for s in seqs) // _PROMPT_BUCKET) * _PROMPT_BUCKET
        cache_len = -(-(L + max_new_tokens) // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        kv = init_kv_cache(cfg, B, cache_len, self.model.dtype, self.device)

        pad = np.asarray([L - len(s) for s in seqs], np.int64)
        ids = np.zeros((B, L), np.int64)
        for b, s in enumerate(seqs):
            ids[b, pad[b] :] = s
        slot_idx = np.broadcast_to(np.arange(L, dtype=np.int64), (B, L))
        rope_pos = np.maximum(slot_idx - pad[:, None], 0)
        token_valid = torch.as_tensor(
            np.arange(cache_len)[None, :] >= pad[:, None], device=self.device
        )
        last, kv = self._chunked_prefill(
            self._long(ids), self._long(rope_pos), kv, rope, L,
            mask_positions=self._long(slot_idx), token_valid=token_valid,
        )

        generator = torch.Generator(device=self.device).manual_seed(seed)
        sampling = dict(
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, greedy=greedy,
        )
        eos_ids = self._eos_ids()
        mask = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=self.device)
        pad_col = self._long(pad[:, None])
        tokens: List[List[int]] = [[] for _ in range(B)]
        finished = [False] * B
        for step in range(max_new_tokens):
            if all(finished):
                break
            tok, last, kv = self._step(
                last, mask, kv, rope, L + step, pad_col, sampling, generator,
                token_valid=token_valid,
            )
            for b, tid in enumerate(tok.tolist()):
                if finished[b]:
                    continue
                if tid in eos_ids:
                    finished[b] = True
                else:
                    tokens[b].append(tid)

        texts = [self.tokenizer.decode(t, skip_special_tokens=True) for t in tokens]
        if meta is not None:
            meta["usage"] = [
                {"prompt_tokens": len(s), "completion_tokens": len(t)}
                for s, t in zip(seqs, tokens)
            ]
        if return_meta:
            return texts, ["stop" if f else "length" for f in finished]
        return texts
