"""Inference engine: streaming, batched, pooled and speculative generation
(counterpart of shardmerge_tpu/inference.py).

The JAX engine jits one forward for chunked prefill and fuses sampling with
the next forward, S steps per dispatch (``decode_chunk``). PyTorch runs
eagerly, so here a decode step is sample -> penalty-mask update -> forward,
and ``decode_chunk=S`` runs S such steps per call of :meth:`_chunk_decode`,
which gives the same tokens. The numbers follow the JAX engine: the same
prompt and cache bucketing, the same masks, greedy tokens identical on the
same weights. The continuous pool (batching.py) and the HTTP server
(serve.py) drive the same methods.

With a draft model, greedy streams decode speculatively
(:meth:`InferenceEngine._stream_speculative`: one :func:`_spec_round` per
round of up to k tokens, one host sync per round). With
``prefix_cache_slots`` the KV slabs of bucket-aligned prompt prefixes stay
on the device (LRU over slots and bytes) and a request sharing one prefills
only the rest.

With ``cfg.moe_dispatch == "capacity"`` the engine stacks raw experts once
(``LlamaModel.stack_experts``) and the expert layers take the capacity
dispatch; quantized experts keep dense-and-mask, with a warning (the JAX
engine's rule).

With ``shard=True`` under a launcher's ranks (``torchrun --nproc-per-node
P``) the engine is tensor parallel (parallel/tp.py): every rank loads its
slices of the weights, rank 0 runs the engine and every other rank replays
its model and cache calls (:meth:`InferenceEngine.follow`). The cache helpers
below take a sharded cache (``tp.TPCache``) to every rank.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from .models.llama import LlamaModel, ModelConfig, init_kv_cache, rope_tables
from .models.loader import load_params, resolve_checkpoint_dir
from .models.sampling import sample_token

logger = logging.getLogger(__name__)

__all__ = ["ChatMessage", "InferenceEngine", "load_tokenizer"]

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


# the slot axis of each cache buffer: K/V (L, B, KVH, S, D), MLA's
# compressed latent and shared roped key (L, B, S, rank)
_KV_SEQ_AXIS = {"k": 3, "v": 3, "ckv": 2, "kpe": 2}


def _slice_kv(kv, length: int) -> dict:
    """A copy of the first ``length`` slots of every cache buffer."""
    if getattr(kv, "leader", None) is not None:
        return kv.leader.kv_op("slice", kv, length)
    return {k: v.narrow(_KV_SEQ_AXIS[k], 0, length).clone() for k, v in kv.items()}


def _implant_kv(fresh, slab) -> dict:
    """Write a cached prefix slab into the head of ``fresh``, in place.

    Valid for any cache at least as long as the slab: causality makes the
    prefix's KV the same whatever follows it."""
    if getattr(fresh, "leader", None) is not None:
        return fresh.leader.kv_op("implant", fresh, slab)
    for k, v in slab.items():
        axis = _KV_SEQ_AXIS[k]
        fresh[k].narrow(axis, 0, v.shape[axis]).copy_(v)
    return fresh


def _gather_kv_slots(kv, idx: torch.Tensor) -> dict:
    """Gather every row's slots in place: destination slot j of row b takes
    source slot ``idx[b, j]`` (the continuous pool's compaction)."""
    if getattr(kv, "leader", None) is not None:
        return kv.leader.kv_op("compact", kv, idx)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    for name, buf in kv.items():
        for layer in buf:
            if _KV_SEQ_AXIS[name] == 2:  # MLA: (B, S, rank)
                layer.copy_(layer[rows, idx])
            else:  # K/V: (B, KVH, S, D)
                moved = layer.transpose(1, 2)[rows, idx]  # (B, S, KVH, D)
                layer.copy_(moved.transpose(1, 2))
    return kv


def _implant_kv_row(kv, slab, b: int) -> dict:
    """Write a batch-1 cache ``slab`` into row ``b`` of ``kv`` at slots
    [0, slab length), in place."""
    if getattr(kv, "leader", None) is not None:
        return kv.leader.kv_op("implant_row", kv, slab, b)
    for name, buf in kv.items():
        axis = _KV_SEQ_AXIS[name]
        buf[:, b : b + 1].narrow(axis, 0, slab[name].shape[axis]).copy_(slab[name])
    return kv


def _penalized(logits: torch.Tensor, rp) -> torch.Tensor:
    """The repetition penalty of ``sample_token``: positive logits divided,
    the rest multiplied."""
    return torch.where(logits > 0, logits / rp, logits * rp)


def _greedy_verify(logits, base_mask, fed, repetition_penalty) -> torch.Tensor:
    """Target-greedy tokens for every speculative position at once.

    logits: (..., T, V) target logits for the fed tokens (..., T); position
    i's penalty mask is ``base_mask | {fed[0..i]}`` (base_mask (..., V)),
    valid because its result is read only when every earlier proposal was
    accepted, and then exactly those tokens were emitted. The penalty is a
    float or a tensor that broadcasts against the logits (the pool's
    (B, 1, 1)). Returns (..., T) argmax ids (sample_token's greedy
    penalty-then-argmax)."""
    onehot = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    onehot.scatter_(-1, fed[..., None], 1)
    mask = base_mask[..., None, :] | (torch.cumsum(onehot, dim=-2) > 0)
    return torch.argmax(torch.where(mask, _penalized(logits, repetition_penalty), logits), dim=-1)


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


class _StreamText:
    """One stream's text as its tokens arrive, shared by the plain and the
    speculative stream: incremental decode (BPE joins), stop sequences (the
    earliest occurrence ends the stream and its text is never yielded; a
    partial stop prefix or a trailing partial character is withheld until
    resolved), EOS, the ``max_new_tokens`` budget, and the final flush with
    ``meta``'s finish_reason and token counts."""

    def __init__(self, tokenizer, eos_ids: set, stop, max_new_tokens: int, meta: dict):
        self.tokenizer, self.eos_ids, self.stop = tokenizer, eos_ids, stop
        self.max_new_tokens, self.meta = max_new_tokens, meta
        self.generated: List[int] = []
        self.emitted = ""  # the text yielded so far

    def push(self, token_id: int):
        """Append one token; returns (chunks to yield, go on)."""
        self.generated.append(token_id)
        chunks = []
        text = self.tokenizer.decode(self.generated, skip_special_tokens=True)
        if self.stop:
            cut = _find_stop(text, self.stop)
            if cut is not None:
                if cut > len(self.emitted):
                    chunks.append(text[len(self.emitted) : cut])
                    self.emitted = text[:cut]
                self.meta["finish_reason"] = "stop"
                self.meta["stopped_at"] = cut
                return chunks, False
        if len(text) > len(self.emitted) and not text.endswith("�"):
            safe = len(text) - (_stop_holdback(text, self.stop) if self.stop else 0)
            if safe > len(self.emitted):
                chunks.append(text[len(self.emitted) : safe])
                self.emitted = text[:safe]
        if token_id in self.eos_ids:
            self.meta["finish_reason"] = "stop"
            return chunks, False
        return chunks, len(self.generated) < self.max_new_tokens

    def flush(self, prompt_len: int) -> str:
        """Record the counts in ``meta``; returns whatever was withheld, up
        to a stop cut ('' when nothing was)."""
        meta = self.meta
        meta["prompt_tokens"] = prompt_len
        # the EOS token is not a completion token (a stop sequence's are)
        meta["completion_tokens"] = len(self.generated) - (
            1 if meta["finish_reason"] == "stop" and "stopped_at" not in meta else 0
        )
        text = self.tokenizer.decode(self.generated, skip_special_tokens=True)
        if "stopped_at" in meta:
            text = text[: meta["stopped_at"]]
        return text[len(self.emitted) :]


def load_tokenizer(model_path, weights_dir):
    """The JAX engine's tokenizer for a checkpoint:
    ``transformers.AutoTokenizer`` over an adapter directory's own files
    when it holds ``tokenizer_config.json``, else the weights directory's."""
    model_path = Path(model_path)
    tok_dir = model_path if (model_path / "tokenizer_config.json").is_file() else Path(weights_dir)
    if not any((tok_dir / name).is_file() for name in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")):
        raise FileNotFoundError(
            f"generate needs the tokenizer next to the model (tokenizer.json and tokenizer_config.json in {tok_dir})"
        )
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            "generate reads the tokenizer with transformers: install the 'inference' extra "
            "(pip install 'shardmerge-tpu[inference]')"
        ) from e
    return AutoTokenizer.from_pretrained(str(tok_dir))


class _ShardedModel:
    """Rank 0's handle on a tensor-parallel model: a call is broadcast to
    the followers and then run on rank 0's slices (``tp.Leader.forward``);
    attributes are the local model's."""

    def __init__(self, leader):
        self._leader = leader

    def __call__(self, *args, **kwargs):
        return self._leader.forward(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._leader.model, name)


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        model: LlamaModel,
        tokenizer,
        draft: Optional[LlamaModel] = None,
        speculation_k: int = 4,
        prefix_cache_slots: int = 0,
        prefix_cache_bytes: int = 2**30,  # device budget for slabs
        tp=None,
    ):
        self.cfg = cfg
        # a tensor-parallel engine's model calls go through its leader (rank
        # 0) or are replayed by its follower (parallel/tp.py)
        self.tp = tp
        self.model = model if tp is None or not tp.leader else _ShardedModel(tp)
        self.tokenizer = tokenizer
        self.device = model.device
        if cfg.moe_dispatch == "capacity" and cfg.num_local_experts > 0 and not model.stack_experts():
            # stacked once here, not re-stacked in every forward
            logger.warning("moe_dispatch='capacity' needs raw expert matrices; "
                           "quantized experts serve via the dense-and-mask path")
        self.prompt_chunk = _PROMPT_CHUNK
        # exact prefix caching: the KV slabs of up to N bucket-aligned
        # prompt prefixes stay on the device, within a byte budget; the
        # pool admits from its own thread while the stream path serves
        # others, so lookups and stores hold one lock
        self.prefix_cache_slots = int(prefix_cache_slots)
        self.prefix_cache_bytes = int(prefix_cache_bytes)
        self._prefix_cache: "OrderedDict" = OrderedDict()
        self._prefix_cache_used = 0
        self._prefix_lock = threading.Lock()
        self.draft_model = draft
        self.draft_cfg = None if draft is None else draft.cfg
        self.speculation_k = max(int(speculation_k), 2)
        if draft is not None and draft.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({draft.cfg.vocab_size}) must match the target's ({cfg.vocab_size})"
            )

    @classmethod
    def from_pretrained(
        cls,
        model_path,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        tokenizer=None,
        device="cuda:0",
        draft_model=None,
        speculation_k: int = 4,
        prefix_cache_slots: int = 0,
        prefix_cache_bytes: int = 2**30,
        shard: bool = False,
    ) -> "InferenceEngine":
        """``draft_model``: a smaller same-vocab checkpoint for greedy
        speculative decoding, loaded in bf16 and never quantized.
        ``prefix_cache_slots=N`` keeps the KV of up to N bucket-aligned
        prompt prefixes on the device (LRU). ``shard=True``: tensor parallel
        over the ranks a launcher started (parallel/tp.py); each rank loads
        its slices onto its own device (NCCL: its GPU; ranks sharing a GPU
        or ``device="cpu"``: gloo), rank 0 returns the engine that decodes
        and every other rank an engine whose :meth:`follow` replays rank 0's
        calls (no tokenizer, no draft). With one rank it only logs."""
        if load_in_4bit and load_in_8bit:
            raise ValueError("Cannot load model in both 4-bit and 8-bit precision")
        quant_bits = 4 if load_in_4bit else 8 if load_in_8bit else None
        # an adapter directory loads its base with the pairs fused in; its
        # own tokenizer files win over the base's
        weights_dir, adapter = resolve_checkpoint_dir(model_path)
        cfg = ModelConfig.from_pretrained(weights_dir)
        joined = None
        if shard:
            from .parallel.tp import join

            joined = join(str(device))
        if joined is not None:
            from .parallel.tp import Follower, Leader, TPGroup
            from .parallel.train import plan

            comm, control, device = joined
            group = TPGroup(comm, plan(cfg, comm.rank, comm.size, quant_bits), control)
            params = load_params(weights_dir, cfg, quant_bits=quant_bits, device=device,
                                 resolved=(weights_dir, adapter), tp=group.plan)
            model = LlamaModel(cfg, params, tp=group)
            if comm.rank != 0:
                return cls(cfg, model, None, tp=Follower(group, model))
            tp = Leader(group, model)
        else:
            params = load_params(weights_dir, cfg, quant_bits=quant_bits, device=device,
                                 resolved=(weights_dir, adapter))
            model, tp = LlamaModel(cfg, params), None
        draft = None
        if draft_model is not None:
            d_dir, d_adapter = resolve_checkpoint_dir(draft_model)
            d_cfg = ModelConfig.from_pretrained(d_dir)
            draft = LlamaModel(d_cfg, load_params(d_dir, d_cfg, device=device, resolved=(d_dir, d_adapter)))
        if tokenizer is None:
            tokenizer = load_tokenizer(model_path, weights_dir)
        return cls(cfg, model, tokenizer, draft=draft, speculation_k=speculation_k,
                   prefix_cache_slots=prefix_cache_slots, prefix_cache_bytes=prefix_cache_bytes, tp=tp)

    @property
    def follower(self) -> bool:
        """True on a tensor-parallel rank above 0 (it only :meth:`follow`s)."""
        return self.tp is not None and not self.tp.leader

    def follow(self) -> int:
        """A follower rank: replay rank 0's calls until it stops (returns 0)."""
        return self.tp.follow()

    def stop(self) -> None:
        """Rank 0 of a tensor-parallel engine: release the followers."""
        if self.tp is not None and self.tp.leader:
            self.tp.stop()

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
            if hasattr(ids, "keys"):  # newer transformers return a BatchEncoding
                ids = ids["input_ids"]
            return list(ids)
        return list(self.tokenizer.encode(prompt))

    def _init_kv(self, batch: int, cache_len: int):
        if self.tp is not None:
            return self.tp.init_kv(batch, cache_len)
        return init_kv_cache(self.cfg, batch, cache_len, self.model.dtype, self.device)

    def _init_draft_kv(self, batch: int, cache_len: int):
        return init_kv_cache(self.draft_cfg, batch, cache_len, self.draft_model.dtype, self.device)

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
        mask_positions=None, token_valid=None, start: int = 0, model=None,
    ):
        """Prefill in chunks of at most ``prompt_chunk`` tokens from slot
        ``start`` (earlier slots come from the prefix cache) with ``model``
        (default: the target); returns the (B, V) logits at ``keep_pos``
        (default: the last row) and the cache. Causality makes chunking
        exact: a chunk's queries only attend slots already written."""
        B, L = ids.shape
        if keep_pos is None:
            keep_pos = L - 1
        assert keep_pos >= start, (keep_pos, start)
        model = self.model if model is None else model
        kept = None
        for c0 in range(start, L, self.prompt_chunk):
            c1 = min(c0 + self.prompt_chunk, L)
            logits, kv = model(
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

    def _prefix_lookup(self, input_ids: List[int], prompt_len: int, kv, kind: str = "t"):
        """Implant the longest bucket-aligned prefix this prompt shares with
        a cached slab of ``kind`` ("t" target, "d" draft: their cache
        geometries differ). Cached keys carry their own request's tail, so
        the match is the element-wise common prefix rounded down to the
        bucket; the slab is cut to it before the implant. At most
        ``prompt_len - 1`` tokens come from the cache: the last prompt token
        prefills live (its logits seed decoding). Returns (hit_len, kv)."""
        max_pfx = (prompt_len - 1) // _PROMPT_BUCKET * _PROMPT_BUCKET
        if max_pfx <= 0:
            return 0, kv
        target = tuple(input_ids[:max_pfx])
        with self._prefix_lock:
            best_key, best = None, 0
            for key in self._prefix_cache:
                k_kind, ktoks = key
                if k_kind != kind:
                    continue
                n = 0
                for a, b in zip(ktoks[:max_pfx], target):
                    if a != b:
                        break
                    n += 1
                n = n // _PROMPT_BUCKET * _PROMPT_BUCKET
                if n > best:
                    best, best_key = n, key
                    if best == max_pfx:
                        break  # cannot do better
            if best == 0:
                return 0, kv
            self._prefix_cache.move_to_end(best_key)
            slab, _ = self._prefix_cache[best_key]
        if len(best_key[1]) > best:
            slab = _slice_kv(slab, best)
        return best, _implant_kv(kv, slab)

    def _prefix_store(self, input_ids: List[int], prompt_len: int, kv, kind: str = "t"):
        """Cache this prompt's longest bucket-aligned prefix slab, after its
        prefill (causal writes never touch earlier slots, so the live cache
        holds exactly the prefix's KV). Slabs live on the device: eviction
        is LRU over both the slot count and the byte budget, and a slab over
        the whole budget is not stored."""
        plen = (prompt_len - 1) // _PROMPT_BUCKET * _PROMPT_BUCKET
        if plen < _PROMPT_BUCKET:
            return
        key = (kind, tuple(input_ids[:plen]))
        slab = _slice_kv(kv, plen)
        nbytes = sum(v.numel() * v.element_size() for v in slab.values())
        if nbytes > self.prefix_cache_bytes:
            return
        # the membership check and the insert share one critical section,
        # so two threads storing one key cannot count its bytes twice
        with self._prefix_lock:
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                return
            self._prefix_cache[key] = (slab, nbytes)
            self._prefix_cache_used += nbytes
            while (
                len(self._prefix_cache) > self.prefix_cache_slots
                or self._prefix_cache_used > self.prefix_cache_bytes
            ):
                _, (_, freed) = self._prefix_cache.popitem(last=False)
                self._prefix_cache_used -= freed

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

        With a draft model loaded and ``greedy=True`` decoding is
        speculative (:meth:`_stream_speculative`: the same tokens up to
        floating-point near-ties, fewer target forwards); ``decode_chunk``
        does not apply there. With the prefix cache on, a prompt sharing a
        cached bucket-aligned prefix prefills only the rest
        (``meta["prefix_cache_hit_tokens"]``).
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
        if greedy and self.draft_model is not None:
            yield from self._stream_speculative(input_ids, max_new_tokens, repetition_penalty, meta, stop)
            return

        # whole chunks, as the JAX engine dispatches them: the cache covers
        # the rounded-up budget and surplus tokens are dropped on the host
        chunk_size = max(1, decode_chunk)
        budget = -(-max_new_tokens // chunk_size) * chunk_size
        cache_len = -(-(prompt_len + budget) // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        kv = self._init_kv(1, cache_len)
        ids, positions = self._pad_prompt(input_ids, cache_len)
        hit_len = 0
        if self.prefix_cache_slots > 0:
            hit_len, kv = self._prefix_lookup(input_ids, prompt_len, kv)
        last, kv = self._chunked_prefill(
            ids, positions, kv, rope, prompt_len, keep_pos=prompt_len - 1, start=hit_len
        )
        if self.prefix_cache_slots > 0:
            self._prefix_store(input_ids, prompt_len, kv)
        meta["prefix_cache_hit_tokens"] = hit_len

        generator = torch.Generator(device=self.device).manual_seed(seed)
        out = _StreamText(self.tokenizer, self._eos_ids(), stop, max_new_tokens, meta)
        mask = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=self.device)
        no_pad = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
        done = 0
        go_on = True
        while done < max_new_tokens and go_on:
            toks, last, kv = self._chunk_decode(
                chunk_size, last, mask, generator, kv, rope, prompt_len + done, no_pad,
                temperature, top_p, repetition_penalty, top_k=top_k, greedy=greedy,
            )
            done += chunk_size
            # a rounded-up final chunk's surplus tokens are never pushed
            for token_id in toks[:, 0].tolist():
                chunks, go_on = out.push(token_id)
                yield from chunks
                if not go_on:
                    break
        tail = out.flush(prompt_len)
        if tail:
            yield tail

    def _spec_round(self, kv, d_kv, rope, d_rope, x1: int, t: int, mask_pre, rp: float,
                    catch_tok: Optional[int]):
        """One speculative round, queued on the device without a sync.

        (a) the draft's catch-up decode of the true token at slot t-1 when
        it lags by one (``catch_tok``; full acceptance leaves exactly that
        one unconsumed), (b) k-1 chained draft decodes proposing
        continuations of the pending token ``x1`` (at slot t), each with the
        penalized argmax, (c) the target's verify forward over all k
        positions with the per-position greedy re-derivation
        (:func:`_greedy_verify`). Returns the proposals and the verify
        argmaxes PACKED in one (2k-1,) tensor, so the host reads a round
        with one sync, and the caches."""
        k, draft, dev = self.speculation_k, self.draft_model, self.device
        if catch_tok is not None:
            _, d_kv = draft(
                torch.tensor([[catch_tok]], device=dev), torch.tensor([[t - 1]], device=dev), d_kv, t - 1,
                d_rope, t,
            )
        x1_t = torch.tensor([x1], device=dev)
        mask = mask_pre[0].clone()
        mask[x1_t] = True
        prev, props = x1_t, []
        for i in range(k - 1):
            pos = t + i
            logits, d_kv = draft(prev[None], torch.tensor([[pos]], device=dev), d_kv, pos, d_rope, pos + 1)
            lg = logits[0, -1]
            prev = torch.argmax(torch.where(mask, _penalized(lg, rp), lg))[None]
            mask[prev] = True
            props.append(prev)
        fed = torch.cat([x1_t] + props)  # (k,)
        v_logits, kv = self.model(fed[None], torch.arange(t, t + k, device=dev)[None], kv, t, rope, t + k)
        y = _greedy_verify(v_logits[0], mask_pre[0], fed, rp)
        return torch.cat([fed[1:], y]), kv, d_kv

    def _stream_speculative(
        self, input_ids: List[int], max_new_tokens: int, repetition_penalty: float, meta: dict,
        stop: Optional[List[str]] = None,
    ) -> Iterator[str]:
        """Greedy speculative decoding against the loaded draft model.

        Per round (:meth:`_spec_round`) the draft proposes k-1
        continuations of the known-correct pending token and the target
        scores them all; the longest target-greedy-matching prefix is
        accepted and the target's own argmax at the first mismatch becomes
        the next pending token. The verify applies the same
        repetition-penalty-then-argmax per position, each position's mask
        assuming the earlier drafts were accepted (the only case its result
        is read), so the output equals plain greedy decoding token for
        token, up to floating-point near-ties: the (1, k) verify forward
        may round logits differently from the (1, 1) decode, and an
        ulp-level tie between the top two tokens can resolve either way.
        One host sync per round for up to k tokens. Rejected tokens leave
        stale cache slots on both models, harmless because every slot is
        rewritten (cache_pos) before the attn_len mask exposes it."""
        cfg = self.cfg
        k = self.speculation_k
        rp = float(np.float32(repetition_penalty))
        prompt_len = len(input_ids)

        total = prompt_len + max_new_tokens + k  # the verify may write past the budget
        cache_len = -(-total // _CACHE_BUCKET) * _CACHE_BUCKET
        rope = rope_tables(cfg, cache_len, self.device)
        d_rope = rope_tables(self.draft_cfg, cache_len, self.device)
        kv = self._init_kv(1, cache_len)
        d_kv = self._init_draft_kv(1, cache_len)
        ids, positions = self._pad_prompt(input_ids, cache_len)
        t_hit = d_hit = 0
        if self.prefix_cache_slots > 0:
            # target and draft slabs cache under separate kinds
            t_hit, kv = self._prefix_lookup(input_ids, prompt_len, kv, "t")
            d_hit, d_kv = self._prefix_lookup(input_ids, prompt_len, d_kv, "d")
        prompt_last, kv = self._chunked_prefill(
            ids, positions, kv, rope, prompt_len, keep_pos=prompt_len - 1, start=t_hit
        )
        _, d_kv = self._chunked_prefill(
            ids, positions, d_kv, d_rope, prompt_len, start=d_hit, model=self.draft_model
        )
        if self.prefix_cache_slots > 0:
            self._prefix_store(input_ids, prompt_len, kv, "t")
            self._prefix_store(input_ids, prompt_len, d_kv, "d")
        meta["prefix_cache_hit_tokens"] = t_hit

        out = _StreamText(self.tokenizer, self._eos_ids(), stop, max_new_tokens, meta)
        # the emitted-token penalty mask lives on the host and rides into
        # each round (the JAX engine's choice: no device scatter per round)
        mask_pre = np.zeros((1, cfg.vocab_size), bool)
        x1 = int(sample_token(prompt_last, torch.as_tensor(mask_pre, device=self.device),
                              repetition_penalty=rp, greedy=True)[0])
        draft_pos = prompt_len  # next slot the draft cache will consume
        while True:
            chunks, go_on = out.push(x1)
            yield from chunks
            if not go_on:
                break
            t = prompt_len + len(out.generated) - 1  # x1's slot
            assert draft_pos in (t, t - 1), (draft_pos, t)
            # a lag follows a full acceptance, so the token at slot t-1 is
            # a generated one
            packed, kv, d_kv = self._spec_round(
                kv, d_kv, rope, d_rope, x1, t, torch.as_tensor(mask_pre, device=self.device), rp,
                out.generated[-2] if draft_pos < t else None,
            )
            arr = packed.tolist()  # the round's one sync
            fed = [x1] + arr[: k - 1]
            y = arr[k - 1 :]
            m = 0
            while m < k - 1 and y[m] == fed[m + 1]:
                m += 1
            for tok in fed[1 : m + 1]:
                chunks, go_on = out.push(tok)
                yield from chunks
                if not go_on:
                    break
            # fed[0..m] are emitted history for later penalty masks
            mask_pre[0, fed[: m + 1]] = True
            # the true context the draft has consumed (a rejected tail is stale)
            draft_pos = t + min(m, k - 2) + 1
            if not go_on:
                break
            x1 = y[m]
        tail = out.flush(prompt_len)
        if tail:
            yield tail

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
