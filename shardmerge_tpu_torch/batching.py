"""Continuous batching: requests join and leave a running decode pool
(counterpart of shardmerge_tpu/batching.py).

A FIXED pool of B cache rows advances every row by one token (or S with
``decode_chunk``) per step of the engine's batched decode; new requests join
between steps and finished rows free their slot at once. Unlike
:class:`serve.DynamicBatcher`, which windows compatible requests into
lockstep batches, a long completion never blocks the short ones batched with
it, and a new arrival never waits for the pool to drain.

Design (the JAX pool's, with its buffers updated in place):

- One global frontier ``t``: every step writes all B rows at cache slots
  [t, t+S). Rows are independent streams; per-row attention masks
  (``token_valid``) carve each row's live history out of the shared slot
  axis. Each decode attention is one T=1 call of the flash-decode kernel on
  the card, which reads only each row's valid slots.
- A request joining at frontier ``t`` prefills its prompt OFF-POOL in a
  batch-1 cache (from the engine's prefix cache where it holds a shared
  prefix), then IMPLANTS the slab at slots [0, Lp) of a free row. The dead
  span [Lp, t) is masked out; RoPE positions stay contiguous because decode
  positions are slot - pad with pad = t - Lp. The per-slot position map
  (``key_positions``) is kept on the device and stamped by each step, so
  sliding windows compare true positions across the gap.
- Admission is CHUNKED against active decode: while any row is decoding, at
  most ONE ``prefill_chunk``-token slice of the joining prompt runs between
  pool steps, so a long prompt stalls the running streams by one slice, not
  by its whole prefill. With the pool idle, admissions drain at full speed.
- When a prompt is longer than the current frontier, the frontier jumps to
  Lp; other rows absorb the jump as one more masked gap.
- When the frontier nears the cache end, the pool COMPACTS: one gather per
  cache buffer moves every row's live slots to the front, rebasing the
  frontier to the longest live row. A row's live length is bounded by its
  prompt + budget (enforced at submit), so compaction always makes progress.
- With a draft model loaded (``engine.draft_cfg``) the pool decodes
  SPECULATIVELY: each step is one pooled round (:meth:`ContinuousEngine.
  _pool_spec_round`: k-1 draft proposals per row and one target verify over
  all k positions of all B rows), one host sync for up to k tokens a row.
  Rows accept different prefix lengths; both caches burn k slots a round
  at shared frontiers and each row's rejected slots are masked invalid, the
  join gaps' machinery. Greedy output equals the solo stream paths'
  (speculative and plain), up to the (B, k)-vs-(1, 1) rounding near-ties.

Sampling is per request for temperature / top_p / repetition_penalty (they
ride as (B, 1) tensors into the sampler); ``top_k`` and ``greedy`` are pool
settings. Greedy decoding gives the solo stream path's tokens; sampled
decoding draws from the pool's own ``torch.Generator``, so a sampled
completion depends on scheduling.

Threading: ``submit`` is safe from any thread and never waits on device
work; the pool lock guards only the queue. Pool state (caches, masks, slots)
belongs to whichever single thread drives it: the daemon started by
:meth:`start` (serving) or the caller of :meth:`run_until_idle` (scripts,
tests). An optional ``device_lock`` (the server's) serializes the pool's
device work against other decode paths sharing the card.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .inference import (
    _CACHE_BUCKET, _KV_SEQ_AXIS, _PROMPT_BUCKET, InferenceEngine, _find_stop, _gather_kv_slots, _greedy_verify,
    _implant_kv_row, _penalized,
)
from .models.llama import rope_tables

logger = logging.getLogger(__name__)

__all__ = ["ContinuousEngine", "Completion"]


@dataclass
class Completion:
    """Handle for a submitted request; resolves when the request finishes."""

    prompt: str
    max_new_tokens: int
    temperature: float
    top_p: float
    repetition_penalty: float
    stop: Optional[List[str]] = None  # OpenAI stop sequences
    _stop_cut: Optional[int] = None  # char index a stop sequence began at
    _done: threading.Event = field(default_factory=threading.Event)
    token_ids: List[int] = field(default_factory=list)
    text: Optional[str] = None
    finish_reason: Optional[str] = None
    error: Optional[Exception] = None
    # serving metrics (time.monotonic): set at submit / join / first
    # emitted token / finish
    submitted_at: Optional[float] = None
    joined_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    def result(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TimeoutError("completion still decoding")
        if self.error is not None:
            raise self.error
        return self.text

    def done(self) -> bool:
        return self._done.is_set()


@dataclass
class _Admission:
    """An in-flight chunked admission: the off-pool batch-1 prefill state
    of the request currently joining the pool."""

    handle: Completion
    ids: List[int]
    Lp: int  # true prompt length
    budget: int
    pids: torch.Tensor  # (1, L) padded prompt ids
    ppos: torch.Tensor  # (1, L) positions
    kv1: dict  # batch-1 prefill cache (bucketed prompt length)
    next_c0: int = 0  # first unprefilled slot (prefix-cache hits skip ahead)
    row_logits: Optional[torch.Tensor] = None  # (1, V) logits at Lp-1
    complete: bool = False
    d_kv1: Optional[dict] = None  # spec mode: the draft's batch-1 cache
    d_next_c0: int = 0  # spec mode: the draft's prefill progress


def _compact_pool(kv, key_pos, idx):
    """Gather every row's live slots to the front of the slot axis, in
    place. idx: (B, S) int64, per row the source slot of each destination
    slot in temporal order; entries past a row's live length may point
    anywhere (the caller masks those destinations). ``key_pos`` rides the
    same gather (a tensor-parallel cache's on every rank; the map is rank
    0's)."""
    _gather_kv_slots(kv, idx)
    key_pos.copy_(torch.gather(key_pos, 1, idx))


def _implant_cache(kv, slab, key_pos, b: int):
    """Install a batch-1 prefill cache into pool row ``b`` at slots
    [0, slab_len), in place, with positions 0..slab_len in the slot ->
    position map (the target's and the draft's pools alike)."""
    _implant_kv_row(kv, slab, b)
    name, buf = next(iter(slab.items()))
    slab_len = buf.shape[_KV_SEQ_AXIS[name]]
    key_pos[b, :slab_len] = torch.arange(slab_len, device=key_pos.device)


def _implant_row(kv, slab, last, row_logits, gen_mask, key_pos, b: int):
    """Install a prefilled request into pool row ``b``, in place: its cache
    (:func:`_implant_cache`), the row's next-token logits and an empty
    repetition-penalty history."""
    _implant_cache(kv, slab, key_pos, b)
    last[b].copy_(row_logits[0])
    gen_mask[b] = False


class ContinuousEngine:
    """A continuously batched decode pool over an :class:`InferenceEngine`.

    Synchronous use (tests, scripts)::

        pool = ContinuousEngine(engine, slots=4, cache_len=1024)
        h1 = pool.submit("prompt A", max_new_tokens=32)
        h2 = pool.submit("prompt B", max_new_tokens=8)
        pool.run_until_idle()
        print(h1.result(), h2.result())

    Serving use: :meth:`start` runs the decode loop on a daemon thread;
    ``submit`` is then safe from any thread and handles resolve as rows
    finish. If the loop dies (device failure), every in-flight and queued
    handle resolves with the error and later submits raise.
    ``serve.ModelServer(..., continuous_slots=N)`` puts this behind the HTTP
    endpoint.
    """

    @torch.inference_mode()
    def __init__(
        self,
        engine: InferenceEngine,
        slots: int = 4,
        cache_len: int = 2048,
        top_k: int = 40,
        greedy: bool = False,
        decode_chunk: int = 1,
        use_template: bool = True,
        system_prompt: Optional[str] = None,
        seed: int = 0,
        device_lock: Optional[threading.Lock] = None,
        prefill_chunk: Optional[int] = None,
    ):
        if slots < 1:
            raise ValueError("continuous batching needs at least one slot")
        self.spec = engine.draft_cfg is not None
        if self.spec and not greedy:
            raise ValueError(
                "the speculative pool verifies against target-greedy tokens; construct the pool with "
                "greedy=True (sampled requests bypass the pool anyway)"
            )
        if self.spec and decode_chunk != 1:
            raise ValueError("speculative rounds take up to k tokens a step; decode_chunk must be 1")
        self.engine = engine
        # admission prefill slice (tokens): the bound on how long an
        # arriving prompt may stall active decode between two pool steps;
        # capped at the engine's prompt_chunk, floored at one prompt bucket
        pc = engine.prompt_chunk if prefill_chunk is None else int(prefill_chunk)
        pc = min(max(pc, _PROMPT_BUCKET), engine.prompt_chunk)
        self.prefill_chunk = -(-pc // _PROMPT_BUCKET) * _PROMPT_BUCKET
        self.cfg = engine.cfg
        self.B = int(slots)
        self.S = max(1, int(decode_chunk))
        self.cache_len = -(-int(cache_len) // _CACHE_BUCKET) * _CACHE_BUCKET
        self.top_k = int(top_k)
        self.greedy = bool(greedy)
        self.use_template = use_template
        self.system_prompt = system_prompt
        self._device_lock = device_lock

        dev = engine.device
        self._rope = rope_tables(self.cfg, self.cache_len, dev)
        self._kv = engine._init_kv(self.B, self.cache_len)
        V = self.cfg.vocab_size
        self._last = torch.zeros((self.B, V), dtype=torch.float32, device=dev)
        self._gen_mask = torch.zeros((self.B, V), dtype=torch.bool, device=dev)
        self._kp = torch.zeros((self.B, self.cache_len), dtype=torch.int64, device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        self._eos = engine._eos_ids()

        # host-side pool state; `_valid` uploads only when it changed
        # (admit / jump / compact / finish), not per step
        self._t = 0  # global frontier: next slot every row writes
        self._valid = np.zeros((self.B, self.cache_len), bool)
        self._valid_dev = torch.as_tensor(self._valid, device=dev)
        self._valid_dirty = False
        self._pad = np.zeros(self.B, np.int64)
        self._temp = np.full(self.B, 1.0, np.float32)
        self._top_p = np.ones(self.B, np.float32)
        self._rep = np.ones(self.B, np.float32)
        self._rows: List[Optional[Completion]] = [None] * self.B
        self._pos_next = np.zeros(self.B, np.int64)  # next sequence position
        self._budget_left = np.zeros(self.B, np.int64)

        # speculative pool state: a pooled draft cache with the target
        # pool's slot discipline (its own frontier, validity and slot ->
        # position map) and each row's pending-token bookkeeping
        if self.spec:
            self.k = engine.speculation_k
            self._d_kv = engine._init_draft_kv(self.B, self.cache_len)
            self._d_rope = rope_tables(engine.draft_cfg, self.cache_len, dev)
            self._kp_d = torch.zeros((self.B, self.cache_len), dtype=torch.int64, device=dev)
            self._valid_d = np.zeros((self.B, self.cache_len), bool)
            self._valid_d_dev = torch.as_tensor(self._valid_d, device=dev)
            self._valid_d_dirty = False
            self._t_d = 0  # draft frontier
            self._x1 = np.zeros(self.B, np.int64)  # pending tokens
            self._pos_x1 = np.ones(self.B, np.int64)  # their positions
            self._catch_tok = np.zeros(self.B, np.int64)
            self._lag = np.zeros(self.B, bool)
            self._prev_fed = np.zeros((self.B, self.k), np.int64)
            self._prev_m = np.full(self.B, -1, np.int64)

        # the lock guards ONLY the queue and lifecycle flags; pool/device
        # state belongs to the single driving thread
        self._queue: deque = deque()
        self._lock = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._dead: Optional[Exception] = None
        self._admitting: Optional[_Admission] = None
        self.stats = {
            "decode_dispatches": 0,
            "compactions": 0,
            "frontier_jumps": 0,
            "joins": 0,
            "tokens_out": 0,
            "admission_chunks": 0,  # prefill slices run between pool steps
            "admission_chunk_ms_max": 0.0,  # worst single-slice stall
        }
        if self.spec:
            self.stats["spec_rounds"] = 0
            self.stats["spec_accepted"] = 0  # draft tokens the target approved
        # latency windows (bounded): per-request TTFT (submit -> first
        # token), TPOT (mean inter-token time after the first), queue wait
        # (submit -> join), and per-admission-slice stalls
        self._ttft_ms: deque = deque(maxlen=1024)
        self._tpot_ms: deque = deque(maxlen=1024)
        self._wait_ms: deque = deque(maxlen=1024)
        self._admission_ms: deque = deque(maxlen=1024)

    def _dev(self):
        return self._device_lock or contextlib.nullcontext()

    def _col(self, arr, dtype) -> torch.Tensor:
        """A host (B,) array as a (B, 1) device tensor."""
        return torch.as_tensor(arr[:, None], dtype=dtype, device=self.engine.device)

    # -- submission ---------------------------------------------------------

    def _encode(self, prompt, use_template, system_prompt=None, previous_messages=None):
        return self.engine._encode(
            prompt,
            self.use_template if use_template is None else use_template,
            system_prompt if system_prompt is not None else self.system_prompt,
            previous_messages,
        )

    def _budget(self, max_new_tokens: int) -> int:
        return -(-max_new_tokens // self.S) * self.S

    def _capacity_need(self, n_ids: int, max_new_tokens: int) -> int:
        """Cache slots a request may take before compaction reclaims it:
        prompt + decode budget, or in the speculative pool prompt + budget +
        k (its rounds always write k slots past the live frontier)."""
        if self.spec:
            return n_ids + max_new_tokens + self.k
        return n_ids + self._budget(max_new_tokens)

    def fits(
        self,
        prompt: str,
        max_new_tokens: int,
        use_template: Optional[bool] = None,
        system_prompt=None,
        previous_messages=None,
    ) -> bool:
        """Host-side capacity precheck: would :meth:`submit` accept this?

        Callers batching several prompts should check ALL of them before
        submitting ANY: a mid-batch rejection would otherwise strand the
        already-submitted ones decoding results nobody reads."""
        ids = self._encode(prompt, use_template, system_prompt, previous_messages)
        return 0 < self._capacity_need(len(ids), max_new_tokens) <= self.cache_len

    def submit(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        temperature: float = 0.7,
        top_p: float = 0.95,
        repetition_penalty: float = 1.1,
        use_template: Optional[bool] = None,
        system_prompt=None,
        previous_messages=None,
        stop: Optional[List[str]] = None,
    ) -> Completion:
        ids = self._encode(prompt, use_template, system_prompt, previous_messages)
        if not ids:
            raise ValueError("empty prompt after encoding")
        if self._capacity_need(len(ids), max_new_tokens) > self.cache_len:
            raise ValueError(
                f"prompt ({len(ids)} tokens) + budget exceeds the pool "
                f"cache ({self.cache_len}); raise cache_len or shorten"
            )
        handle = Completion(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            stop=list(stop) if stop else None,
        )
        handle._input_ids = ids  # type: ignore[attr-defined]
        handle.submitted_at = time.monotonic()
        with self._lock:
            if self._dead is not None:
                raise RuntimeError("continuous pool is dead") from self._dead
            if self._stopping:
                raise RuntimeError("continuous pool is stopped")
            self._queue.append(handle)
            self._lock.notify()
        return handle

    # -- scheduling ---------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for b, row in enumerate(self._rows):
            if row is None:
                return b
        return None

    def _compact_buffers(self, kv, key_pos, valid: np.ndarray, t: int) -> int:
        """Gather every live row's valid slots below ``t`` to the front of
        ``kv`` and ``key_pos``; mark the moved slots and every slot from the
        new frontier on valid. Returns the new frontier (the longest live
        row)."""
        idx = np.zeros((self.B, self.cache_len), np.int64)
        live_len = np.zeros(self.B, np.int64)
        for b in range(self.B):
            if self._rows[b] is not None:
                live = np.nonzero(valid[b, :t])[0]
                idx[b, : len(live)] = live
                live_len[b] = len(live)
        new_t = int(live_len.max())
        _compact_pool(kv, key_pos, torch.as_tensor(idx, device=self.engine.device))
        valid[:] = False
        for b in range(self.B):
            if self._rows[b] is not None:
                valid[b, : live_len[b]] = True
                valid[b, new_t:] = True  # future decode slots
        self.stats["compactions"] += 1
        return new_t

    def _compact(self):
        """Drop dead slots from every row; rebase the frontier."""
        self._t = self._compact_buffers(self._kv, self._kp, self._valid, self._t)
        for b in range(self.B):
            if self._rows[b] is not None:
                # the row's next token continues its sequence at the new frontier
                self._pad[b] = self._t - self._pos_next[b]
        self._valid_dirty = True

    def _compact_draft(self):
        """Spec mode: compact the pooled draft cache (the same discipline)."""
        self._t_d = self._compact_buffers(self._d_kv, self._kp_d, self._valid_d, self._t_d)
        self._valid_d_dirty = True

    def _jump_frontier(self, to: int):
        """Advance the global frontier; other rows mask the skipped span."""
        jump = to - self._t
        assert jump > 0
        for b in range(self.B):
            if self._rows[b] is not None:
                self._valid[b, self._t : to] = False
                self._pad[b] += jump
        self._t = to
        self._valid_dirty = True
        self.stats["frontier_jumps"] += 1

    def _jump_frontier_d(self, to: int):
        """Spec mode: advance the draft frontier past a joining prompt."""
        assert to > self._t_d
        for b in range(self.B):
            if self._rows[b] is not None:
                self._valid_d[b, self._t_d : to] = False
        self._t_d = to
        self._valid_d_dirty = True
        self.stats["frontier_jumps"] += 1

    def _begin_admission(self, handle: Completion) -> None:
        """Open the off-pool batch-1 prefill for the next queued request,
        from the prefix cache's slab where one matches."""
        engine = self.engine
        ids = handle._input_ids  # type: ignore[attr-defined]
        Lp = len(ids)
        pcache = min(-(-Lp // _CACHE_BUCKET) * _CACHE_BUCKET, self.cache_len)
        pids, ppos = engine._pad_prompt(ids, pcache)
        d_kv1, hit, d_hit = None, 0, 0
        with self._dev():
            kv1 = engine._init_kv(1, pcache)
            if engine.prefix_cache_slots > 0:
                hit, kv1 = engine._prefix_lookup(ids, Lp, kv1)
            if self.spec:
                d_kv1 = engine._init_draft_kv(1, pcache)
                if engine.prefix_cache_slots > 0:
                    d_hit, d_kv1 = engine._prefix_lookup(ids, Lp, d_kv1, "d")
        self._admitting = _Admission(
            handle=handle,
            ids=ids,
            Lp=Lp,
            budget=self._budget(handle.max_new_tokens),
            pids=pids,
            ppos=ppos,
            kv1=kv1,
            next_c0=hit,
            d_kv1=d_kv1,
            d_next_c0=d_hit,
        )

    def _advance_admission(self) -> None:
        """Run ONE prefill slice of the in-flight admission: the target's
        slices, then (spec mode) the draft's, one model's slice per call.

        The loop body of engine._chunked_prefill, returning after a single
        slice: the pool interleaves slices with decode steps. A finished
        prefill stores its prefix slab when the prefix cache is on. Waits
        for the slice's device work so the recorded stall is the real one."""
        adm, engine = self._admitting, self.engine
        L = adm.pids.shape[1]
        target_done = adm.next_c0 >= L
        t0 = time.monotonic()
        with self._dev():
            if not target_done:
                c0 = adm.next_c0
                c1 = min(c0 + self.prefill_chunk, L)
                keep = adm.Lp - 1
                logits, adm.kv1 = engine.model(
                    adm.pids[:, c0:c1], adm.ppos[:, c0:c1], adm.kv1, c0, self._rope, min(c1, adm.Lp)
                )
                if c0 <= keep < c1:
                    adm.row_logits = logits[:, keep - c0, :]
                adm.next_c0 = c1
                target_done = c1 >= L
                if target_done and engine.prefix_cache_slots > 0:
                    engine._prefix_store(adm.ids, adm.Lp, adm.kv1)
            else:
                c0 = adm.d_next_c0
                c1 = min(c0 + self.prefill_chunk, L)
                logits, adm.d_kv1 = engine.draft_model(
                    adm.pids[:, c0:c1], adm.ppos[:, c0:c1], adm.d_kv1, c0, self._d_rope, min(c1, adm.Lp)
                )
                adm.d_next_c0 = c1
                if c1 >= L and engine.prefix_cache_slots > 0:
                    engine._prefix_store(adm.ids, adm.Lp, adm.d_kv1, "d")
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
        ms = (time.monotonic() - t0) * 1e3
        self.stats["admission_chunks"] += 1
        self._admission_ms.append(ms)
        if ms > self.stats["admission_chunk_ms_max"]:
            self.stats["admission_chunk_ms_max"] = round(ms, 3)
        adm.complete = target_done and (not self.spec or adm.d_next_c0 >= L)

    def _try_implant(self) -> bool:
        """Install the completed admission into a free row; False when the
        pool has no slot or no cache capacity yet (retried after steps)."""
        adm = self._admitting
        b = self._free_slot()
        if b is None:
            return False
        Lp, budget = adm.Lp, adm.budget
        # headroom this join must find now: the decode budget, or one verify
        # block in the speculative pool (which compacts as rounds fill it)
        head = self.k if self.spec else budget
        t_join = max(self._t, Lp)
        if t_join + head > self.cache_len:
            with self._dev():
                self._compact()
            t_join = max(self._t, Lp)
            if t_join + head > self.cache_len:
                return False  # genuinely full: wait for a row to finish
        if self.spec:
            td_join = max(self._t_d, Lp)
            if td_join + self.k > self.cache_len:
                with self._dev():
                    self._compact_draft()
                td_join = max(self._t_d, Lp)
                if td_join + self.k > self.cache_len:
                    return False
        if t_join > self._t:
            self._jump_frontier(t_join)
        if self.spec and td_join > self._t_d:
            self._jump_frontier_d(td_join)

        handle = adm.handle
        with self._dev():
            _implant_row(
                self._kv, adm.kv1, self._last, adm.row_logits, self._gen_mask, self._kp, b
            )
            if self.spec:
                _implant_cache(self._d_kv, adm.d_kv1, self._kp_d, b)
        self._rows[b] = handle
        self._valid[b, :] = True
        self._valid[b, Lp : self._t] = False  # the join gap
        self._valid_dirty = True
        self._pad[b] = self._t - Lp
        self._pos_next[b] = Lp
        self._budget_left[b] = budget
        self._temp[b] = handle.temperature
        self._top_p[b] = handle.top_p
        self._rep[b] = handle.repetition_penalty
        handle.token_ids = []
        handle.joined_at = time.monotonic()
        self.stats["joins"] += 1
        self._admitting = None
        if self.spec:
            self._valid_d[b, :] = True
            self._valid_d[b, Lp : self._t_d] = False
            self._valid_d_dirty = True
            self._prev_m[b] = -1
            self._lag[b] = False
            self._catch_tok[b] = 0
            self._pos_x1[b] = Lp
            # the first pending token: the plain argmax of the prompt's
            # logits (empty penalty history), the solo path's first token
            x1 = int(torch.argmax(adm.row_logits))
            self._x1[b] = x1
            handle.first_token_at = time.monotonic()
            self._emit(b, handle, x1)
        return True

    def _finish(self, b: int, reason: str):
        handle = self._rows[b]
        self._rows[b] = None
        self._valid[b, :] = False
        self._valid_dirty = True
        if self.spec:
            self._valid_d[b, :] = False
            self._valid_d_dirty = True
            self._prev_m[b] = -1
            self._x1[b] = 0
            self._catch_tok[b] = 0
            self._lag[b] = False
            self._pos_x1[b] = 1  # keeps the catch-up position non-negative
        handle.finish_reason = reason
        handle.text = self.engine.tokenizer.decode(handle.token_ids, skip_special_tokens=True)
        if handle._stop_cut is not None:
            handle.text = handle.text[: handle._stop_cut]
        self.stats["tokens_out"] += len(handle.token_ids)
        handle.finished_at = time.monotonic()
        if handle.submitted_at is not None:
            if handle.joined_at is not None:
                self._wait_ms.append((handle.joined_at - handle.submitted_at) * 1e3)
            ft = handle.first_token_at or handle.finished_at
            self._ttft_ms.append((ft - handle.submitted_at) * 1e3)
            n = len(handle.token_ids)
            if n > 1 and handle.first_token_at is not None:
                self._tpot_ms.append(
                    (handle.finished_at - handle.first_token_at) / (n - 1) * 1e3
                )
        handle._done.set()

    # -- decode -------------------------------------------------------------

    @torch.inference_mode()
    def _step(self):
        """One pool step: every row advances S slots (decode pool) or by one
        speculative round of up to k tokens (spec pool)."""
        if self.spec:
            return self._step_spec()
        t, S = self._t, self.S
        if t + S > self.cache_len:
            with self._dev():
                self._compact()
            t = self._t
            if t + S > self.cache_len:  # cannot happen within budgets
                raise RuntimeError("pool cache exhausted beyond compaction")
        dev = self.engine.device
        if self._valid_dirty:
            self._valid_dev = torch.as_tensor(self._valid, device=dev)
            self._valid_dirty = False

        with self._dev():
            toks, self._last, self._kv = self.engine._chunk_decode(
                S,
                self._last,
                self._gen_mask,
                self._generator,
                self._kv,
                self._rope,
                t,
                self._col(self._pad, torch.int64),
                self._col(self._temp, torch.float32),
                self._col(self._top_p, torch.float32),
                self._col(self._rep, torch.float32),
                self._valid_dev,
                self._kp,
                top_k=self.top_k,
                greedy=self.greedy,
            )
            toks = toks.tolist()  # (S, B): the per-step fetch
        self._t = t + S
        self.stats["decode_dispatches"] += 1
        now = time.monotonic()
        active = [b for b in range(self.B) if self._rows[b] is not None]
        self._pos_next[active] += S
        self._budget_left[active] -= S
        for b in active:
            handle = self._rows[b]
            if handle.first_token_at is None:
                handle.first_token_at = now
            for s in range(S):
                if self._emit(b, handle, toks[s][b]):
                    break
            if self._rows[b] is not None and self._budget_left[b] <= 0:
                self._finish(b, "length")

    def _pool_spec_round(self, t: int, t_d: int) -> torch.Tensor:
        """One pooled speculative round, queued on the device.

        The pooled form of the engine's ``_spec_round``: last round's
        emitted tokens fold into the penalty history (``_gen_mask``) from
        (prev_fed, prev_m); both slot -> position maps are stamped for the
        round's slots; the draft's catch-up runs for EVERY row at draft slot
        t_d (a row that does not lag has that slot masked invalid, so the
        write is inert); k-1 chained draft proposals continue each row's
        pending token; the target verifies all k positions of all rows in
        one forward, each position's penalty mask assuming the earlier
        proposals were emitted. Returns (B, 2k-1) [proposals | verify
        argmaxes] for the round's one host sync."""
        k, B, eng = self.k, self.B, self.engine
        dev = eng.device
        rows = torch.arange(B, device=dev)
        prev_fed = torch.as_tensor(self._prev_fed, device=dev)
        fold = torch.as_tensor(np.arange(k)[None, :] <= self._prev_m[:, None], device=dev)
        self._gen_mask[rows[:, None].expand(B, k)[fold], prev_fed[fold]] = True
        pos_x1 = torch.as_tensor(self._pos_x1[:, None], device=dev)
        x1 = torch.as_tensor(self._x1, device=dev)
        rp = torch.as_tensor(self._rep[:, None], device=dev)
        steps = torch.arange(k, device=dev)[None, :]
        self._kp[:, t : t + k] = pos_x1 + steps
        self._kp_d[:, t_d : t_d + k] = torch.cat([pos_x1 - 1, pos_x1 + steps[:, : k - 1]], dim=1)

        def draft_at(ids, pos, slot):
            return eng.draft_model(
                ids[:, None], pos, self._d_kv, slot, self._d_rope, t_d + k,
                mask_positions=torch.full((B, 1), slot, dtype=torch.int64, device=dev),
                token_valid=self._valid_d_dev, key_positions=self._kp_d,
            )[0]

        draft_at(torch.as_tensor(self._catch_tok, device=dev), pos_x1 - 1, t_d)
        mask = self._gen_mask.clone()
        mask[rows, x1] = True
        prev, props = x1, []
        for i in range(k - 1):
            lg = draft_at(prev, pos_x1 + i, t_d + 1 + i)[:, -1]
            prev = torch.argmax(torch.where(mask, _penalized(lg, rp), lg), dim=-1)
            mask[rows, prev] = True
            props.append(prev)
        props = torch.stack(props, dim=1)  # (B, k-1)
        fed = torch.cat([x1[:, None], props], dim=1)  # (B, k)
        v_logits, _ = eng.model(
            fed, pos_x1 + steps, self._kv, t, self._rope, t + k, mask_positions=(steps + t).expand(B, k),
            token_valid=self._valid_dev, key_positions=self._kp,
        )
        y = _greedy_verify(v_logits, self._gen_mask, fed, rp[:, :, None])
        return torch.cat([props, y], dim=1)

    def _step_spec(self):
        """One pooled speculative round: every live row advances by its own
        accepted prefix and pending token (1..k tokens); both caches burn k
        slots at the shared frontiers and rejected slots go invalid."""
        k = self.k
        if self._t + k > self.cache_len:
            with self._dev():
                self._compact()
        if self._t_d + k > self.cache_len:
            with self._dev():
                self._compact_draft()
        if self._t + k > self.cache_len or self._t_d + k > self.cache_len:
            raise RuntimeError("pool cache exhausted beyond compaction")
        t, t_d = self._t, self._t_d
        # the catch-up slot is live only for rows whose whole proposal block
        # was accepted last round
        for b in range(self.B):
            if self._rows[b] is not None:
                self._valid_d[b, t_d] = bool(self._lag[b])
        dev = self.engine.device
        if self._valid_dirty:
            self._valid_dev = torch.as_tensor(self._valid, device=dev)
            self._valid_dirty = False
        self._valid_d_dev = torch.as_tensor(self._valid_d, device=dev)
        self._valid_d_dirty = False
        with self._dev():
            arr = self._pool_spec_round(t, t_d).tolist()  # (B, 2k-1): the round's one sync
        self._t = t + k
        self._t_d = t_d + k
        self.stats["decode_dispatches"] += 1
        self.stats["spec_rounds"] += 1

        for b in range(self.B):
            row = self._rows[b]
            if row is None:
                self._prev_m[b] = -1
                continue
            props, y = arr[b][: k - 1], arr[b][k - 1 :]
            fed = [int(self._x1[b])] + props
            m = 0
            while m < k - 1 and y[m] == fed[m + 1]:
                m += 1
            self.stats["spec_accepted"] += m
            # target slots [t, t+m] hold x1 and the accepted proposals; the
            # rest of the block was rejected speculation
            self._valid[b, t + m + 1 : t + k] = False
            # draft slot t_d+1+i consumed [x1, d1..d_{k-2}][i]: live through
            # the accepted prefix; the catch-up slot keeps its validity
            self._valid_d[b, t_d + 2 + min(m, k - 2) : t_d + k] = False
            # emit the accepted proposals, then the new pending token (the
            # target's argmax at the first mismatch): the solo path's order
            if any(self._emit(b, row, tok) for tok in fed[1 : m + 1] + [y[m]]):
                continue
            self._x1[b] = y[m]
            self._pos_x1[b] += m + 1
            self._pos_next[b] = self._pos_x1[b]
            full = m == k - 1
            self._lag[b] = full
            self._catch_tok[b] = props[k - 2] if full else 0
            self._prev_fed[b] = fed
            self._prev_m[b] = m
        self._valid_dirty = True
        self._valid_d_dirty = True

    def _emit(self, b: int, handle: Completion, tok: int) -> bool:
        """Append one token to row ``b``, shared by both pools and the
        join; True when it finished the row: EOS (not appended), a stop
        sequence or the row's ``max_new_tokens``."""
        if tok in self._eos:
            self._finish(b, "stop")
            return True
        handle.token_ids.append(tok)
        if handle.stop and self._check_stop(b, handle):
            return True
        if len(handle.token_ids) >= handle.max_new_tokens:
            self._finish(b, "length")
            return True
        return False

    def _check_stop(self, b: int, handle: Completion) -> bool:
        """OpenAI stop sequences: finish the row at the earliest occurrence
        in its decoded text (_finish trims the stop text). Only called for
        rows that configured stops."""
        text = self.engine.tokenizer.decode(handle.token_ids, skip_special_tokens=True)
        cut = _find_stop(text, handle.stop)
        if cut is None:
            return False
        handle._stop_cut = cut
        self._finish(b, "stop")
        return True

    def metrics(self) -> dict:
        """Latency summaries (ms) over the recent-request window: TTFT,
        TPOT, queue wait, and per-admission-slice stall percentiles."""

        def summary(d):
            v = sorted(d)
            n = len(v)
            return {
                "n": n,
                "p50": round(v[n // 2], 2),
                "p95": round(v[min(n - 1, int(n * 0.95))], 2),
                "max": round(v[-1], 2),
            }

        return {
            name: summary(d)
            for name, d in (
                ("ttft_ms", self._ttft_ms),
                ("tpot_ms", self._tpot_ms),
                ("queue_wait_ms", self._wait_ms),
                ("admission_chunk_ms", self._admission_ms),
            )
            if d
        }

    # -- driving ------------------------------------------------------------

    def _active(self) -> bool:
        return any(r is not None for r in self._rows)

    @torch.inference_mode()
    def _admit_pending(self):
        """Advance admission work between pool steps.

        While any row is decoding, at most ONE prefill slice runs per call:
        an arriving prompt costs the running streams one slice between two
        pool steps, never its whole prefill. With the pool idle, admissions
        drain at full speed. Queue pops are the only locked operations."""
        sliced = False
        while True:
            if self._admitting is None:
                with self._lock:
                    if not self._queue:
                        return
                    handle = self._queue.popleft()
                try:
                    self._begin_admission(handle)
                except Exception as exc:  # surface encode/cache errors
                    handle.error = exc
                    handle._done.set()
                    continue
            adm = self._admitting
            try:
                while not adm.complete:
                    if sliced and self._active():
                        return  # bounded stall: resume after the next step
                    self._advance_admission()
                    sliced = True
                if not self._try_implant():
                    return  # no slot/capacity yet; retry after steps
            except Exception as exc:  # surface prefill errors to the caller
                self._admitting = None
                adm.handle.error = exc
                adm.handle._done.set()

    def run_until_idle(self):
        """Drive the pool synchronously until queue and rows are empty.

        For single-threaded use; do not mix with :meth:`start`."""
        while True:
            self._admit_pending()
            if not self._active():
                with self._lock:
                    if not self._queue and self._admitting is None:
                        return
                # a request that cannot finish admission with every slot
                # free would mean submit()'s capacity check is broken
                raise RuntimeError("queued request cannot be admitted")
            self._step()

    def _fail_all(self, exc: Exception):
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        adm, self._admitting = self._admitting, None
        if adm is not None:
            adm.handle.error = exc
            adm.handle._done.set()
        for b in range(self.B):
            if self._rows[b] is not None:
                handle = self._rows[b]
                self._rows[b] = None
                self._valid[b, :] = False
                handle.error = exc
                handle._done.set()
        self._valid_dirty = True
        for handle in pending:
            handle.error = exc
            handle._done.set()

    def _serve_loop(self):
        # inference mode is thread-local: the daemon enters it itself
        with torch.inference_mode():
            try:
                while True:
                    with self._lock:
                        if self._stopping:
                            break
                        if not self._queue and not self._active() and self._admitting is None:
                            self._lock.wait(timeout=0.1)
                            continue
                    self._admit_pending()
                    if self._active():
                        self._step()
            except Exception as exc:
                # a dying decode loop must not strand waiters on their
                # timeout: resolve every handle with the error and poison
                # future submits
                logger.exception("continuous pool decode loop died")
                with self._lock:
                    self._dead = exc
                self._fail_all(exc)

    def start(self):
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        with self._lock:
            self._stopping = True
            self._lock.notify()
        self._thread.join(timeout=120)
        self._thread = None
        # whatever the loop did not finish resolves as an error, matching
        # DynamicBatcher's drain semantics: never leave a waiter hanging
        self._fail_all(RuntimeError("continuous pool stopped"))
