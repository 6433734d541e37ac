"""Inference engine: streaming, batched and pooled generation (counterpart
of shardmerge_tpu/inference.py).

The JAX engine jits one forward for chunked prefill and fuses sampling with
the next forward, S steps per dispatch (``decode_chunk``). PyTorch runs
eagerly, so here a decode step is sample -> penalty-mask update -> forward,
and ``decode_chunk=S`` runs S such steps per call of :meth:`_chunk_decode`,
which gives the same tokens. The numbers follow the JAX engine: the same
prompt and cache bucketing, the same masks, greedy tokens identical on the
same weights. The continuous pool (batching.py) and the HTTP server
(serve.py) drive the same methods.

Not ported yet: speculative decoding, the prefix cache and the mesh-sharded
engine.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from .models.llama import LlamaModel, ModelConfig, init_kv_cache, rope_tables
from .models.loader import load_params, resolve_checkpoint_dir
from .models.sampling import sample_token

__all__ = ["ChatMessage", "InferenceEngine", "JsonTokenizer"]

_CACHE_BUCKET = 256  # KV cache length granularity
_PROMPT_BUCKET = 64  # prompts pad to a multiple of this
_PROMPT_CHUNK = 512  # prefill chunk cap


@dataclass
class ChatMessage:
    role: str
    content: str

    def to_dict(self):
        return {"role": self.role, "content": self.content}

    def __str__(self):
        return json.dumps(self.to_dict())


def _find_stop(text: str, stops) -> Optional[int]:
    """Char index of the EARLIEST occurrence of any stop string, or None.
    OpenAI semantics: generation halts at the stop sequence and the stop
    text itself is never returned."""
    best = None
    for s in stops:
        i = text.find(s)
        if i != -1 and (best is None or i < best):
            best = i
    return best


def _stop_holdback(text: str, stops) -> int:
    """Chars to withhold from streaming: the longest suffix of ``text``
    that is a proper prefix of some stop string, so a stop sequence split
    across chunks never leaks to the client."""
    hold = 0
    for s in stops:
        m = min(len(s) - 1, len(text))
        for k in range(m, 0, -1):
            if text.endswith(s[:k]):
                hold = max(hold, k)
                break
    return hold


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
        self.prompt_chunk = _PROMPT_CHUNK

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
        # an adapter directory loads its base with the pairs fused in; its
        # own tokenizer files win over the base's
        weights_dir, adapter = resolve_checkpoint_dir(model_path)
        cfg = ModelConfig.from_pretrained(weights_dir)
        params = load_params(weights_dir, cfg, quant_bits=quant_bits, device=device,
                             resolved=(weights_dir, adapter))
        if tokenizer is None:
            own = Path(model_path) / "tokenizer.json"
            tokenizer = JsonTokenizer(Path(model_path) if own.is_file() else weights_dir)
        return cls(cfg, LlamaModel(cfg, params), tokenizer)

    # -- helpers -------------------------------------------------------------

    def _encode(
        self,
        prompt: str,
        use_template: bool,
        system_prompt: Optional[str],
        previous_messages: Optional[List[ChatMessage]],
    ) -> List[int]:
        """Token ids of a prompt: through the tokenizer's chat template when
        asked and the tokenizer has one, else the prompt encoded as given."""
        if use_template and getattr(self.tokenizer, "chat_template", None):
            raw: List[ChatMessage] = []
            if system_prompt:
                raw.append(ChatMessage(role="system", content=system_prompt))
            if previous_messages:
                raw.extend(previous_messages)
            raw.append(ChatMessage(role="user", content=prompt))
            ids = self.tokenizer.apply_chat_template(
                [m.to_dict() for m in raw], tokenize=True, add_generation_prompt=True
            )
            return list(ids)
        return list(self.tokenizer.encode(prompt))

    def _init_kv(self, batch: int, cache_len: int):
        return init_kv_cache(self.cfg, batch, cache_len, self.model.dtype, self.device)

    def _eos_ids(self) -> set:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            return set()
        return set(eos) if isinstance(eos, (list, tuple)) else {eos}

    def _long(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.array(arr), dtype=torch.int64, device=self.device)

    def _pad_prompt(self, input_ids: List[int], cache_len: int):
        """(1, L) ids and positions of a prompt padded to a bucket multiple
        (capped at ``cache_len``). Causality keeps the tail inert: only the
        logits at prompt_len-1 are read, and decode overwrites the padded
        slots before attending to them."""
        prompt_len = len(input_ids)
        padded_len = min(-(-prompt_len // _PROMPT_BUCKET) * _PROMPT_BUCKET, cache_len)
        ids = self._long([input_ids + [0] * (padded_len - prompt_len)])
        return ids, torch.arange(padded_len, device=self.device)[None, :]

    def _chunked_prefill(
        self, ids, positions, kv, rope, final_attn_len, keep_pos=None,
        mask_positions=None, token_valid=None,
    ):
        """Prefill in chunks of at most ``prompt_chunk`` tokens; returns the
        (B, V) logits at ``keep_pos`` (default: the last row) and the cache.
        Causality makes chunking exact: a chunk's queries only attend slots
        already written."""
        B, L = ids.shape
        if keep_pos is None:
            keep_pos = L - 1
        kept = None
        for c0 in range(0, L, self.prompt_chunk):
            c1 = min(c0 + self.prompt_chunk, L)
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

    def _chunk_decode(
        self,
        steps: int,
        last,  # (B, V) logits the first token is sampled from
        generated_mask,  # (B, V) bool penalty history, updated in place
        generator,
        kv,
        rope,
        pos0: int,  # cache slot the first sampled token occupies
        pad,  # (B, 1) int64 left pads: RoPE position = slot - pad
        temperature,  # float or (B, 1) f32
        top_p,
        repetition_penalty,
        token_valid=None,  # None (single row) | (B, S) bool
        key_positions=None,  # None | (B, S) int64 slot -> position map
        *,
        top_k: int,
        greedy: bool,
    ):
        """``steps`` decode steps, shared by the stream, batch and pool
        loops (counterpart of the JAX engine's fused ``chunk_decode``).

        Each step samples from the previous step's logits, records the token
        in the repetition-penalty mask and runs its forward at slot pos.
        The budget-final token's forward is computed and discarded, as in
        the JAX engine. With ``key_positions`` each step stamps its slot's
        true position (slot - pad) into the map before the forward. Returns
        (tokens (steps, B), last logits, kv)."""
        B = last.shape[0]
        rows = torch.arange(B, device=self.device)
        toks = []
        for i in range(steps):
            pos = pos0 + i
            tok = sample_token(
                last, generated_mask, temperature, top_k, top_p, repetition_penalty,
                greedy=greedy, generator=generator,
            )
            generated_mask[rows, tok] = True
            if key_positions is not None:
                key_positions[:, pos] = pos - pad[:, 0]
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
                key_positions=key_positions,
            )
            last = logits[:, -1, :]
            toks.append(tok)
        return torch.stack(toks), last, kv

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
        use_template: bool = True,
        system_prompt: Optional[str] = None,
        previous_messages: Optional[List[ChatMessage]] = None,
        greedy: bool = False,
        seed: int = 0,
        meta: Optional[dict] = None,
        decode_chunk: int = 1,
        stop: Optional[List[str]] = None,
    ) -> Iterator[str]:
        """Yield generated text chunks token by token.

        ``decode_chunk=S`` runs S decode steps per :meth:`_chunk_decode`
        call (identical tokens). ``stop``: OpenAI stop sequences:
        generation halts at the earliest occurrence, the stop text is never
        emitted (chunks withhold partial stop prefixes until resolved), and
        finish_reason is "stop". ``meta`` receives finish_reason ("stop" at
        EOS or a stop sequence, else "length") and token counts."""
        cfg = self.cfg
        if meta is None:
            meta = {}
        meta.setdefault("finish_reason", "length")
        input_ids = self._encode(prompt, use_template, system_prompt, previous_messages)
        prompt_len = len(input_ids)
        if prompt_len == 0 or max_new_tokens <= 0:
            return

        # whole chunks, as the JAX engine dispatches them: the cache covers
        # the rounded-up budget and surplus tokens are dropped on the host
        chunk_size = max(1, decode_chunk)
        budget = -(-max_new_tokens // chunk_size) * chunk_size
        cache_len = -(-(prompt_len + budget) // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        kv = self._init_kv(1, cache_len)
        ids, positions = self._pad_prompt(input_ids, cache_len)
        last, kv = self._chunked_prefill(
            ids, positions, kv, rope, prompt_len, keep_pos=prompt_len - 1
        )

        generator = torch.Generator(device=self.device).manual_seed(seed)
        eos_ids = self._eos_ids()
        mask = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=self.device)
        no_pad = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        generated: List[int] = []
        emitted_text = ""
        done = 0
        stopped = False
        while done < max_new_tokens and not stopped:
            toks, last, kv = self._chunk_decode(
                chunk_size, last, mask, generator, kv, rope, prompt_len + done, no_pad,
                temperature, top_p, repetition_penalty, top_k=top_k, greedy=greedy,
            )
            done += chunk_size
            for token_id in toks[:, 0].tolist():
                if len(generated) >= max_new_tokens:
                    break  # surplus from the rounded-up final chunk
                generated.append(token_id)
                # incremental decode: emit the new text suffix (BPE joins);
                # ``emitted_text`` is what was yielded: a trailing partial
                # character or partial stop prefix is held back
                text = self.tokenizer.decode(generated, skip_special_tokens=True)
                if stop:
                    cut = _find_stop(text, stop)
                    if cut is not None:
                        if cut > len(emitted_text):
                            yield text[len(emitted_text) : cut]
                            emitted_text = text[:cut]
                        meta["finish_reason"] = "stop"
                        meta["stopped_at"] = cut
                        stopped = True
                        break
                if len(text) > len(emitted_text) and not text.endswith("\ufffd"):
                    safe = len(text) - (_stop_holdback(text, stop) if stop else 0)
                    if safe > len(emitted_text):
                        yield text[len(emitted_text) : safe]
                        emitted_text = text[:safe]
                if token_id in eos_ids:
                    meta["finish_reason"] = "stop"
                    stopped = True
                    break

        meta["prompt_tokens"] = prompt_len
        # the EOS token is not a completion token (a stop sequence's are)
        meta["completion_tokens"] = len(generated) - (
            1 if meta["finish_reason"] == "stop" and "stopped_at" not in meta else 0
        )
        # final flush: whatever was withheld, up to a stop cut
        text = self.tokenizer.decode(generated, skip_special_tokens=True)
        if "stopped_at" in meta:
            text = text[: meta["stopped_at"]]
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
        use_template: bool = True,
        system_prompt: Optional[str] = None,
        greedy: bool = False,
        seed: int = 0,
        return_meta: bool = False,
        decode_chunk: int = 1,
        meta: Optional[dict] = None,
        stop: Optional[List[str]] = None,
    ):
        """Generate completions for a batch in lockstep.

        Ragged prompts are LEFT-padded to one bucketed length, so every
        row's last prompt token sits at slot L-1 and decode advances one
        shared cache slot per step; pad slots are masked out through
        ``token_valid`` and RoPE positions start at 0 on each row's first
        real token. Rows that hit EOS or a stop sequence keep decoding
        (tokens discarded) until all rows finish. Returns texts, or
        ``(texts, finish_reasons)`` with ``return_meta``."""
        cfg = self.cfg
        seqs = [self._encode(p, use_template, system_prompt, None) for p in prompts]
        if not seqs:
            return ([], []) if return_meta else []
        if any(len(s) == 0 for s in seqs):
            raise ValueError("generate_batch: empty prompt after encoding")
        B = len(seqs)
        L = -(-max(len(s) for s in seqs) // _PROMPT_BUCKET) * _PROMPT_BUCKET
        chunk_size = max(1, decode_chunk)
        budget = -(-max_new_tokens // chunk_size) * chunk_size
        cache_len = -(-(L + budget) // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        kv = self._init_kv(B, cache_len)

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
        eos_ids = self._eos_ids()
        mask = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=self.device)
        pad_col = self._long(pad[:, None])
        tokens: List[List[int]] = [[] for _ in range(B)]
        finished = [False] * B
        stop_cuts: dict = {}  # row -> char index where a stop sequence began
        done = 0
        emitted = 0
        while done < max_new_tokens and not all(finished):
            toks, last, kv = self._chunk_decode(
                chunk_size, last, mask, generator, kv, rope, L + done, pad_col,
                temperature, top_p, repetition_penalty, token_valid,
                top_k=top_k, greedy=greedy,
            )
            done += chunk_size
            for row in toks.tolist():  # (S, B) step-major
                if emitted >= max_new_tokens:
                    break
                emitted += 1
                for b, tid in enumerate(row):
                    if finished[b]:
                        continue
                    if tid in eos_ids:
                        finished[b] = True
                        continue
                    tokens[b].append(tid)
                    if stop:
                        text = self.tokenizer.decode(tokens[b], skip_special_tokens=True)
                        cut = _find_stop(text, stop)
                        if cut is not None:
                            stop_cuts[b] = cut
                            finished[b] = True
                if all(finished):
                    break

        texts = [self.tokenizer.decode(t, skip_special_tokens=True) for t in tokens]
        for b, cut in stop_cuts.items():
            texts[b] = texts[b][:cut]
        if meta is not None:
            meta["usage"] = [
                {"prompt_tokens": len(s), "completion_tokens": len(t)}
                for s, t in zip(seqs, tokens)
            ]
        if return_meta:
            return texts, ["stop" if f else "length" for f in finished]
        return texts
