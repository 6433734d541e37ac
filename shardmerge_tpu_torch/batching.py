"""Continuous batching: requests join and leave a running decode pool
(counterpart of shardmerge_tpu/batching.py, without its speculative pool).

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
  batch-1 cache, then IMPLANTS the slab at slots [0, Lp) of a free row. The
  dead span [Lp, t) is masked out; RoPE positions stay contiguous because
  decode positions are slot - pad with pad = t - Lp. The per-slot position
  map (``key_positions``) is kept on the device and stamped by each step
  for the windowed families; the Llama forward does not read it.
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

from .inference import _CACHE_BUCKET, _PROMPT_BUCKET, InferenceEngine, _find_stop
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
    Lp: int  # true prompt length
    budget: int
    pids: torch.Tensor  # (1, L) padded prompt ids
    ppos: torch.Tensor  # (1, L) positions
    kv1: dict  # batch-1 prefill cache (bucketed prompt length)
    next_c0: int = 0  # first unprefilled slot
    row_logits: Optional[torch.Tensor] = None  # (1, V) logits at Lp-1
    complete: bool = False


def _compact_pool(kv, key_pos, idx):
    """Gather every row's live slots to the front of the slot axis, in
    place. idx: (B, S) int64, per row the source slot of each destination
    slot in temporal order; entries past a row's live length may point
    anywhere (the caller masks those destinations). ``key_pos`` rides the
    same gather."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    for buf in kv.values():  # (L, B, KVH, S, D)
        for layer in buf:
            moved = layer.transpose(1, 2)[rows, idx]  # (B, S, KVH, D)
            layer.copy_(moved.transpose(1, 2))
    key_pos.copy_(torch.gather(key_pos, 1, idx))


def _implant_row(kv, slab, last, row_logits, gen_mask, key_pos, b: int):
    """Install a prefilled request into pool row ``b``, in place: the
    batch-1 cache at slots [0, slab_len), the row's next-token logits, an
    empty repetition-penalty history, and positions 0..slab_len in the
    slot -> position map."""
    slab_len = slab["k"].shape[3]
    for name, buf in kv.items():
        buf[:, b : b + 1, :, :slab_len].copy_(slab[name])
    last[b].copy_(row_logits[0])
    gen_mask[b] = False
    key_pos[b, :slab_len] = torch.arange(slab_len, device=key_pos.device)


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
        return 0 < len(ids) + self._budget(max_new_tokens) <= self.cache_len

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
        if len(ids) + self._budget(max_new_tokens) > self.cache_len:
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

    def _compact(self):
        """Drop dead slots from every row; rebase the frontier."""
        idx = np.zeros((self.B, self.cache_len), np.int64)
        live_len = np.zeros(self.B, np.int64)
        new_t = 0
        for b in range(self.B):
            if self._rows[b] is None:
                continue
            live = np.nonzero(self._valid[b, : self._t])[0]
            idx[b, : len(live)] = live
            live_len[b] = len(live)
            new_t = max(new_t, len(live))
        _compact_pool(self._kv, self._kp, torch.as_tensor(idx, device=self.engine.device))
        self._t = new_t
        self._valid[:] = False
        for b in range(self.B):
            if self._rows[b] is None:
                continue
            self._valid[b, : live_len[b]] = True
            self._valid[b, new_t:] = True  # future decode slots
            # the row's next token continues its sequence at the new frontier
            self._pad[b] = new_t - self._pos_next[b]
        self._valid_dirty = True
        self.stats["compactions"] += 1

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

    def _begin_admission(self, handle: Completion) -> None:
        """Open the off-pool batch-1 prefill for the next queued request."""
        ids = handle._input_ids  # type: ignore[attr-defined]
        Lp = len(ids)
        pcache = min(-(-Lp // _CACHE_BUCKET) * _CACHE_BUCKET, self.cache_len)
        pids, ppos = self.engine._pad_prompt(ids, pcache)
        with self._dev():
            kv1 = self.engine._init_kv(1, pcache)
        self._admitting = _Admission(
            handle=handle,
            Lp=Lp,
            budget=self._budget(handle.max_new_tokens),
            pids=pids,
            ppos=ppos,
            kv1=kv1,
        )

    def _advance_admission(self) -> None:
        """Run ONE prefill slice of the in-flight admission.

        The loop body of engine._chunked_prefill, returning after a single
        slice: the pool interleaves slices with decode steps. Waits for the
        slice's device work so the recorded stall is the real one."""
        adm = self._admitting
        L = adm.pids.shape[1]
        c0 = adm.next_c0
        c1 = min(c0 + self.prefill_chunk, L)
        keep = adm.Lp - 1
        t0 = time.monotonic()
        with self._dev():
            logits, adm.kv1 = self.engine.model(
                adm.pids[:, c0:c1],
                adm.ppos[:, c0:c1],
                adm.kv1,
                c0,
                self._rope,
                min(c1, adm.Lp),
            )
            if c0 <= keep < c1:
                adm.row_logits = logits[:, keep - c0, :]
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
        adm.next_c0 = c1
        ms = (time.monotonic() - t0) * 1e3
        self.stats["admission_chunks"] += 1
        self._admission_ms.append(ms)
        if ms > self.stats["admission_chunk_ms_max"]:
            self.stats["admission_chunk_ms_max"] = round(ms, 3)
        adm.complete = c1 >= L

    def _try_implant(self) -> bool:
        """Install the completed admission into a free row; False when the
        pool has no slot or no cache capacity yet (retried after steps)."""
        adm = self._admitting
        b = self._free_slot()
        if b is None:
            return False
        Lp, budget = adm.Lp, adm.budget
        t_join = max(self._t, Lp)
        if t_join + budget > self.cache_len:
            with self._dev():
                self._compact()
            t_join = max(self._t, Lp)
            if t_join + budget > self.cache_len:
                return False  # genuinely full: wait for a row to finish
        if t_join > self._t:
            self._jump_frontier(t_join)

        handle = adm.handle
        with self._dev():
            _implant_row(
                self._kv, adm.kv1, self._last, adm.row_logits, self._gen_mask, self._kp, b
            )
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
        return True

    def _finish(self, b: int, reason: str):
        handle = self._rows[b]
        self._rows[b] = None
        self._valid[b, :] = False
        self._valid_dirty = True
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
        """One pool step: every row advances S slots."""
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
                if len(handle.token_ids) >= handle.max_new_tokens:
                    break
                tid = toks[s][b]
                if tid in self._eos:
                    self._finish(b, "stop")
                    break
                handle.token_ids.append(tid)
                if handle.stop and self._check_stop(b, handle):
                    break
            if self._rows[b] is not None and (
                len(handle.token_ids) >= handle.max_new_tokens or self._budget_left[b] <= 0
            ):
                self._finish(b, "length")

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
