"""Local HTTP serving endpoint for merged models (counterpart of
shardmerge_tpu/serve.py, with the same JSON shapes and status codes).

- ``POST /v1/completions``: ``{"prompt": str | [str, ...], "max_tokens",
  "temperature", "top_p", "top_k", "repetition_penalty", "greedy", "seed",
  "decode_chunk", "stop", "stream"}`` -> ``{"choices": [{"index", "text",
  "finish_reason"}, ...], "usage"}`` with ``finish_reason`` "stop" (EOS or a
  stop sequence) or "length". A request runs the lockstep batched decode
  (``InferenceEngine.generate_batch``), unless a continuous pool is
  configured and the request is greedy: then each prompt joins the pool
  (speculative rounds when a draft model is loaded). A single prompt takes
  the engine's stream path when it is greedy and a draft model is loaded
  (speculative decoding) or when the prefix cache is on.
  ``stream: true`` (one prompt) answers with Server-Sent Events from the
  engine's stream path: one ``data:`` event per text delta, a final event
  carrying ``finish_reason`` and ``usage``, then ``data: [DONE]``.
- ``POST /v1/chat/completions``: ``{"messages": [{"role", "content"}, ...],
  ...}`` -> the chat-completion shape. The conversation renders through the
  tokenizer's chat template when it has one, otherwise as a plain
  role-tagged transcript (history is never silently dropped).
- ``GET /v1/models``, ``GET /health``, ``GET /v1/stats`` (with the prefix
  cache's slots, entries and bytes when it is on).

Device work is serialized by one lock (``ThreadingHTTPServer`` accepts
concurrently); the continuous pool's daemon takes the same lock for each of
its steps. On the card every T=1 decode attention of these paths runs the
flash-decode kernel and every int4 decode GEMV the int4 kernel.

``serve(shard=True)`` under a launcher's ranks (``torchrun
--nproc-per-node P``) serves tensor parallel (parallel/tp.py): rank 0 loads
its slices and runs the server, every other rank loads its slices and
replays rank 0's model and cache calls until rank 0's server stops.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["ModelServer", "serve"]

_MAX_BODY = 32 * 1024 * 1024
_MAX_BATCH = 64  # caps the rows (and the KV cache) a request can cost
_MAX_PROMPT_CHARS = 256 * 1024  # bounds prompt length and so the KV cache


def _meta_usage(meta: dict):
    """Per-request usage dict from a stream-path meta, if counted."""
    if "prompt_tokens" not in meta:
        return None
    return {
        "prompt_tokens": meta["prompt_tokens"],
        "completion_tokens": meta["completion_tokens"],
    }


def _totals(per_request):
    """Request-level usage totals (the OpenAI ``usage`` object), or None
    when any row went uncounted."""
    if not per_request or any(u is None for u in per_request):
        return None
    pt = sum(u["prompt_tokens"] for u in per_request)
    ct = sum(u["completion_tokens"] for u in per_request)
    return {
        "prompt_tokens": pt,
        "completion_tokens": ct,
        "total_tokens": pt + ct,
    }


class _Pending:
    __slots__ = ("prompts", "kwargs", "event", "result", "error")

    def __init__(self, prompts, kwargs):
        self.prompts = prompts
        self.kwargs = kwargs
        self.event = threading.Event()
        self.result = None
        self.error = None


class DynamicBatcher:
    """Coalesces concurrent requests into one lockstep decode.

    Requests arriving within ``window_s`` of each other whose sampling
    parameters MATCH (lockstep decode shares one sampler state per step)
    are concatenated into a single ``generate_batch`` call — N concurrent
    single-prompt requests cost one prefill + one decode loop instead of N.
    The merged batch is padded up to a power of two (repeating the last
    prompt; padding rows are dropped from the results), as the JAX server
    does to bound its compiled batch shapes, so both servers decode the
    same batches.
    Incompatible requests are never delayed behind a window: they simply
    form their own group on the next loop.
    """

    def __init__(self, run_batch, window_s: float, max_batch: int = _MAX_BATCH):
        self._run_batch = run_batch
        self.window_s = window_s
        self.max_batch = max_batch
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, prompts, kwargs):
        item = _Pending(prompts, kwargs)
        with self._cv:
            if self._stop:
                raise RuntimeError("server stopped")
            self._q.append(item)
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            # fresh exception per waiter: the same instance raised from N
            # handler threads would have its __traceback__ rewritten
            # concurrently while another thread formats it
            raise RuntimeError(
                f"batched generation failed: {item.error}"
            ) from item.error
        return item.result

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify()

    def _take_compatible(self, first, total):
        for it in self._q:
            if (
                it.kwargs == first.kwargs
                and total + len(it.prompts) <= self.max_batch
            ):
                self._q.remove(it)
                return it
        return None

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for it in self._q:
                        it.error = RuntimeError("server stopped")
                        it.event.set()
                    return
                group = [self._q.popleft()]
            first = group[0]
            total = len(first.prompts)
            deadline = time.monotonic() + self.window_s
            while total < self.max_batch:
                with self._cv:
                    item = self._take_compatible(first, total)
                    if item is None:
                        if self._q or self._stop:
                            break  # don't hold incompatible work hostage
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                        item = self._take_compatible(first, total)
                if item is None:
                    if time.monotonic() >= deadline:
                        break
                    continue
                group.append(item)
                total += len(item.prompts)

            prompts = [p for it in group for p in it.prompts]
            # pad to a power of two (the JAX server's batch shapes)
            bucket = 1
            while bucket < len(prompts):
                bucket *= 2
            bucket = min(bucket, self.max_batch)
            padded = prompts + [prompts[-1]] * (bucket - len(prompts))
            try:
                texts, reasons, usage = self._run_batch(padded, first.kwargs)
                n_real = len(prompts)
                texts, reasons, usage = (
                    texts[:n_real],
                    reasons[:n_real],
                    usage[:n_real],
                )
                i = 0
                for it in group:
                    n = len(it.prompts)
                    it.result = (
                        texts[i : i + n],
                        reasons[i : i + n],
                        usage[i : i + n],
                    )
                    i += n
            except Exception as e:  # engine failure: every caller sees it
                for it in group:
                    it.error = e
            finally:
                for it in group:
                    it.event.set()


class ModelServer:
    """Wraps an InferenceEngine behind a ThreadingHTTPServer."""

    def __init__(
        self,
        engine,
        model_id: str = "shardmerge-tpu-torch",
        batch_window_ms: float = 0.0,
        continuous_slots: int = 0,
        continuous_cache_len: int = 2048,
        continuous_decode_chunk: int = 1,
        continuous_prefill_chunk: Optional[int] = None,
    ):
        self.engine = engine
        self.model_id = model_id
        self.port: Optional[int] = None  # bound port once start()ed
        self._device_lock = threading.Lock()
        self._started = time.monotonic()
        self._stats_lock = threading.Lock()
        self._request_counts: dict = {}
        self._token_counts: dict = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        # batch_window_ms > 0: concurrent compatible requests coalesce into
        # one lockstep decode (DynamicBatcher)
        self.batcher: Optional[DynamicBatcher] = (
            DynamicBatcher(self._run_batch, batch_window_ms / 1e3)
            if batch_window_ms > 0
            else None
        )
        # continuous_slots > 0: GREEDY requests decode in a continuously
        # batched pool (batching.ContinuousEngine) — requests join a running
        # decode and leave as they finish, so a long completion never blocks
        # short ones and a new arrival never waits for the pool to drain.
        # Greedy-only because the pool's sampler state is shared: a sampled
        # request's tokens would depend on its co-tenants despite its seed.
        self.pool = None
        if continuous_slots > 0:
            from .batching import ContinuousEngine

            self.pool = ContinuousEngine(
                engine,
                slots=continuous_slots,
                cache_len=continuous_cache_len,
                greedy=True,
                decode_chunk=continuous_decode_chunk,
                prefill_chunk=continuous_prefill_chunk,
                # the pool's daemon thread runs device work; sharing the
                # server's lock serializes it against the lockstep and
                # stream paths
                device_lock=self._device_lock,
            )
            self.pool.start()

    def _run_batch(self, prompts, kwargs):
        meta: dict = {}
        with self._device_lock:
            texts, reasons = self.engine.generate_batch(
                prompts, return_meta=True, meta=meta, **kwargs
            )
        return texts, reasons, meta.get("usage", [None] * len(texts))

    # -- request handling ---------------------------------------------------

    def _validate(self, payload: dict):
        """Parse + validate a completions payload. Raises ValueError (HTTP
        400) on caller mistakes; generation itself runs in _generate so
        engine failures surface as 500s, not as 'bad request'."""
        prompt = payload.get("prompt")
        if prompt is None:
            raise ValueError("missing 'prompt'")
        prompts = prompt if isinstance(prompt, list) else [prompt]
        if not prompts:
            raise ValueError("'prompt' list is empty")
        if len(prompts) > _MAX_BATCH:
            raise ValueError(f"at most {_MAX_BATCH} prompts per request")
        if not all(isinstance(p, str) and p for p in prompts):
            raise ValueError("'prompt' entries must be non-empty strings")
        if any(len(p) > _MAX_PROMPT_CHARS for p in prompts):
            raise ValueError(f"prompts are capped at {_MAX_PROMPT_CHARS} chars")

        stream = bool(payload.get("stream", False))
        if stream and len(prompts) != 1:
            raise ValueError("'stream': true supports exactly one prompt")
        kwargs = self._sampling_kwargs(payload)
        kwargs["stream"] = stream
        return prompts, kwargs

    def _sampling_kwargs(self, payload: dict) -> dict:
        try:
            kwargs = dict(
                max_new_tokens=int(payload.get("max_tokens", 128)),
                temperature=float(payload.get("temperature", 0.7)),
                top_p=float(payload.get("top_p", 0.95)),
                top_k=int(payload.get("top_k", 40)),
                repetition_penalty=float(payload.get("repetition_penalty", 1.1)),
                greedy=bool(payload.get("greedy", False)),
                seed=int(payload.get("seed", 0)),
                use_template=bool(payload.get("use_template", False)),
                decode_chunk=int(payload.get("decode_chunk", 1)),
            )
        except (TypeError, ValueError):
            raise ValueError("sampling parameters must be numeric")
        stop = payload.get("stop")
        if stop is not None:
            stops = stop if isinstance(stop, list) else [stop]
            if (
                not stops
                or len(stops) > 4  # the OpenAI cap
                or not all(isinstance(s, str) and s for s in stops)
            ):
                raise ValueError(
                    "'stop' must be a non-empty string or a list of up "
                    "to 4 non-empty strings"
                )
            kwargs["stop"] = stops
        if kwargs["max_new_tokens"] < 1 or kwargs["max_new_tokens"] > 4096:
            raise ValueError("max_tokens must be in [1, 4096]")
        if not 1 <= kwargs["decode_chunk"] <= 64:
            # S decode steps per engine call (identical tokens); the cap is
            # the JAX server's
            raise ValueError("decode_chunk must be in [1, 64]")
        if kwargs["top_k"] < 0:
            raise ValueError("top_k must be >= 0")
        # torch.topk rejects k > vocab; clamping matches the 'consider
        # everything' intent of a huge top_k
        kwargs["top_k"] = min(kwargs["top_k"], self.engine.cfg.vocab_size)
        return kwargs

    def _validate_chat(self, payload: dict):
        """Parse + validate a chat-completions payload. Returns
        (prompt, kwargs, system_prompt, previous_messages) ready for the
        engine's stream path. Without a tokenizer chat template, the
        conversation renders as a plain role-tagged transcript so history
        is never silently dropped."""
        from .inference import ChatMessage

        messages = payload.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("missing 'messages'")
        for m in messages:
            if (
                not isinstance(m, dict)
                or m.get("role") not in ("system", "user", "assistant")
                or not isinstance(m.get("content"), str)
                or not m["content"]
            ):
                raise ValueError(
                    "each message needs a role in "
                    "(system/user/assistant) and non-empty string content"
                )
        if messages[-1]["role"] != "user":
            # a trailing system message would otherwise render as a USER
            # turn on the template path (engine._encode wraps the prompt
            # as the user message) — reject instead of misattributing
            raise ValueError("the final message must be from the user")
        if sum(len(m["content"]) for m in messages) > _MAX_PROMPT_CHARS:
            raise ValueError(
                f"conversation is capped at {_MAX_PROMPT_CHARS} chars"
            )
        kwargs = self._sampling_kwargs(payload)
        kwargs["stream"] = bool(payload.get("stream", False))

        system = None
        rest = messages
        if messages[0]["role"] == "system":
            system, rest = messages[0]["content"], messages[1:]
        if getattr(self.engine.tokenizer, "chat_template", None):
            kwargs["use_template"] = True
            prompt = rest[-1]["content"]
            previous = [
                ChatMessage(m["role"], m["content"]) for m in rest[:-1]
            ]
            return prompt, kwargs, system, previous
        # templateless tokenizer: render the whole conversation
        kwargs["use_template"] = False
        lines = [f"system: {system}"] if system else []
        lines += [f"{m['role']}: {m['content']}" for m in rest]
        lines.append("assistant:")
        return "\n".join(lines), kwargs, None, None

    def _generate(self, prompts, kwargs) -> dict:
        if self.pool is not None and kwargs.get("greedy"):
            # continuous batching: each prompt is its own pool request —
            # they join the running decode independently and finish
            # independently. The pool fixes decode_chunk at construction;
            # temperature/top_p/top_k/seed are inert under greedy.
            # Capacity is prechecked for EVERY prompt before ANY submits:
            # a mid-batch rejection would strand the already-submitted
            # ones decoding results nobody reads while the lockstep
            # fallback regenerates them.
            use_tpl = kwargs.get("use_template", False)
            if all(
                self.pool.fits(p, kwargs["max_new_tokens"], use_tpl)
                for p in prompts
            ):
                handles = [
                    self.pool.submit(
                        p,
                        max_new_tokens=kwargs["max_new_tokens"],
                        repetition_penalty=kwargs["repetition_penalty"],
                        use_template=use_tpl,
                        stop=kwargs.get("stop"),
                    )
                    for p in prompts
                ]
                texts = [h.result(timeout=600) for h in handles]
                return self._choices(
                    texts,
                    [h.finish_reason for h in handles],
                    [
                        {
                            "prompt_tokens": len(h._input_ids),
                            "completion_tokens": len(h.token_ids),
                        }
                        for h in handles
                    ],
                )
            # over pool capacity (prompt + budget vs cache_len): fall
            # through to the lockstep paths, which size their own cache
        if len(prompts) == 1 and (
            (kwargs.get("greedy") and getattr(self.engine, "draft_cfg", None) is not None)
            or getattr(self.engine, "prefix_cache_slots", 0) > 0
        ):
            # a single prompt on the stream path: speculative decoding
            # (greedy with a draft) and the prefix cache live there, not
            # on generate_batch
            text, meta = self._stream_to_text(prompts[0], kwargs)
            return self._choices([text], [meta["finish_reason"]], [_meta_usage(meta)])
        # only GREEDY requests coalesce: the lockstep sampler draws one key
        # per step over the whole (B, V) batch, so a sampled request's
        # output would depend on who it happened to share a batch with
        # (and on padding) despite its explicit seed
        if self.batcher is not None and kwargs.get("greedy"):
            texts, reasons, usage = self.batcher.submit(prompts, kwargs)
        else:
            texts, reasons, usage = self._run_batch(prompts, kwargs)
        return self._choices(texts, reasons, usage)

    def stream_events(
        self,
        prompt: str,
        kwargs,
        system_prompt=None,
        previous_messages=None,
        chat: bool = False,
    ):
        """Yield SSE payload dicts for one streamed completion: a text
        delta per emitted chunk, then a final empty-text event carrying
        the finish_reason. Rides the engine's stream path; the device lock
        is held for the generation.
        ``chat=True`` emits the chat-completion delta shape instead of
        the text-completion shape."""
        meta: dict = {}
        base = {
            "object": "chat.completion.chunk" if chat else "text_completion",
            "model": self.model_id,
        }

        def choice(text, reason):
            if chat:
                delta = {"content": text} if text else {}
                return {"index": 0, "delta": delta, "finish_reason": reason}
            return {"index": 0, "text": text, "finish_reason": reason}

        if chat:
            # OpenAI chat streams open with a role-only delta; clients
            # commonly seed the assembled message's role from it
            yield {
                **base,
                "choices": [
                    {
                        "index": 0,
                        "delta": {"role": "assistant"},
                        "finish_reason": None,
                    }
                ],
            }
        with self._device_lock:
            for chunk in self.engine.stream_generation(
                prompt,
                system_prompt=system_prompt,
                previous_messages=previous_messages,
                meta=meta,
                **kwargs,
            ):
                yield {**base, "choices": [choice(chunk, None)]}
        yield {
            **base,
            "choices": [
                choice("", meta.get("finish_reason", "length"))
            ],
            "usage": _totals([_meta_usage(meta)]),
        }

    def _stream_to_text(self, prompt, kwargs, system=None, previous=None):
        """One solo generation on the stream path; returns (text, meta)."""
        meta: dict = {}
        with self._device_lock:
            text = "".join(
                self.engine.stream_generation(
                    prompt,
                    system_prompt=system,
                    previous_messages=previous,
                    meta=meta,
                    **kwargs,
                )
            )
        return text, meta

    def _generate_chat(self, prompt, kwargs, system, previous) -> dict:
        # greedy chat rides the continuous pool exactly like greedy
        # completions (same capacity precheck and fallback) — the endpoint
        # must not silently lose the throughput machinery
        if (
            self.pool is not None
            and kwargs.get("greedy")
            and self.pool.fits(
                prompt,
                kwargs["max_new_tokens"],
                kwargs.get("use_template", False),
                system,
                previous,
            )
        ):
            h = self.pool.submit(
                prompt,
                max_new_tokens=kwargs["max_new_tokens"],
                repetition_penalty=kwargs["repetition_penalty"],
                use_template=kwargs.get("use_template", False),
                system_prompt=system,
                previous_messages=previous,
                stop=kwargs.get("stop"),
            )
            text = h.result(timeout=600)
            reason = h.finish_reason
            usage = [
                {
                    "prompt_tokens": len(h._input_ids),
                    "completion_tokens": len(h.token_ids),
                }
            ]
        else:
            text, meta = self._stream_to_text(prompt, kwargs, system, previous)
            reason = meta.get("finish_reason", "length")
            usage = [_meta_usage(meta)]
        return {
            "object": "chat.completion",
            "model": self.model_id,
            "choices": [
                {
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": reason,
                }
            ],
            **({"usage": _totals(usage)} if _totals(usage) else {}),
        }

    def _choices(self, texts, reasons, usage=None) -> dict:
        out = {
            "object": "text_completion",
            "model": self.model_id,
            "choices": [
                {"index": i, "text": t, "finish_reason": r}
                for i, (t, r) in enumerate(zip(texts, reasons))
            ],
        }
        totals = _totals(usage or [])
        if totals is not None:
            out["usage"] = totals
        return out

    def stats(self) -> dict:
        """Operational counters (GET /v1/stats): uptime, request tallies,
        tokens served, and, when continuous batching is on, the pool's
        join/dispatch/compaction counters and latency percentiles."""
        out = {
            "model": self.model_id,
            "uptime_s": round(time.monotonic() - self._started, 1),
            "requests": dict(self._request_counts),
            "tokens": dict(self._token_counts),
        }
        if self.pool is not None:
            out["continuous_pool"] = {
                "slots": self.pool.B,
                "cache_len": self.pool.cache_len,
                **self.pool.stats,
                "latency": self.pool.metrics(),
            }
        if getattr(self.engine, "prefix_cache_slots", 0) > 0:
            out["prefix_cache"] = {
                "slots": self.engine.prefix_cache_slots,
                "entries": len(self.engine._prefix_cache),
                "bytes": self.engine._prefix_cache_used,
            }
        return out

    def _count(self, kind: str, usage=None):
        with self._stats_lock:
            self._request_counts[kind] = self._request_counts.get(kind, 0) + 1
            if usage:
                for k in ("prompt_tokens", "completion_tokens"):
                    self._token_counts[k] = (
                        self._token_counts.get(k, 0) + usage[k]
                    )

    def warmup(self, decode_chunks=(1,)) -> float:
        """Run the serving hot path once before the port opens: one short
        greedy generation per configured decode_chunk (prefill and decode,
        which builds the CUDA kernels on first use), a 2-prompt lockstep
        batch when a batcher is configured, and one pool request. The prefix
        cache is held off meanwhile, so the junk prompt takes no slot.
        Returns seconds spent."""
        t0 = time.monotonic()
        saved_pfx = getattr(self.engine, "prefix_cache_slots", 0)
        self.engine.prefix_cache_slots = 0
        try:
            with self._device_lock:
                for s in decode_chunks:
                    for _ in self.engine.stream_generation(
                        "warmup", max_new_tokens=max(2, int(s)),
                        greedy=True, use_template=False, decode_chunk=int(s),
                    ):
                        pass
            if self.batcher is not None:
                self._run_batch(
                    ["warmup", "warmup"],
                    dict(max_new_tokens=2, greedy=True, use_template=False),
                )
            if self.pool is not None:
                self.pool.submit("warmup", max_new_tokens=2).result(timeout=600)
        finally:
            self.engine.prefix_cache_slots = saved_pfx
        return time.monotonic() - t0

    # -- server lifecycle ---------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start serving in background threads; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("http: " + fmt, *args)

            def _send(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/health", "/"):
                    self._send(200, {"status": "ok", "model": server.model_id})
                elif self.path == "/v1/models":
                    self._send(
                        200,
                        {
                            "object": "list",
                            "data": [
                                {"id": server.model_id, "object": "model"}
                            ],
                        },
                    )
                elif self.path == "/v1/stats":
                    self._send(200, server.stats())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                chat = self.path in (
                    "/v1/chat/completions",
                    "/chat/completions",
                )
                if not chat and self.path not in (
                    "/v1/completions",
                    "/completions",
                ):
                    self._send(404, {"error": "not found"})
                    return
                system = previous = None
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > _MAX_BODY:
                        self._send(413, {"error": "request body too large"})
                        return
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                    if chat:
                        prompt, kwargs, system, previous = (
                            server._validate_chat(payload)
                        )
                        prompts = [prompt]
                    else:
                        prompts, kwargs = server._validate(payload)
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                if kwargs.pop("stream"):
                    # Server-Sent Events: one `data:` line per text delta,
                    # a finish_reason event, then the [DONE] sentinel
                    # (OpenAI streaming shape). HTTP/1.0 close-delimited.
                    #
                    # The generation (which holds the device lock) runs on
                    # a producer thread feeding a queue; THIS thread only
                    # drains the queue into the socket. A client that
                    # stops reading therefore stalls only its own handler
                    # — the producer finishes its bounded max_tokens of
                    # work and releases the lock, never blocking the
                    # lockstep/batcher/pool paths behind a dead socket.
                    import queue as _queue

                    q: "_queue.Queue" = _queue.Queue()
                    done = object()

                    def produce():
                        try:
                            for ev in server.stream_events(
                                prompts[0],
                                kwargs,
                                system_prompt=system,
                                previous_messages=previous,
                                chat=chat,
                            ):
                                q.put(ev)
                            q.put(done)
                        except Exception as exc:
                            logger.exception("streamed completion failed")
                            q.put(exc)

                    threading.Thread(target=produce, daemon=True).start()
                    self.connection.settimeout(600)  # free dead clients
                    try:
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "text/event-stream"
                        )
                        self.send_header("Cache-Control", "no-cache")
                        self.end_headers()
                        last_usage = None
                        while True:
                            item = q.get()
                            if item is done:
                                self.wfile.write(b"data: [DONE]\n\n")
                                break
                            if isinstance(item, dict):
                                last_usage = item.get("usage", last_usage)
                            if isinstance(item, Exception):
                                self.wfile.write(
                                    b"data: "
                                    + json.dumps(
                                        {"error": str(item)}
                                    ).encode()
                                    + b"\n\n"
                                )
                                break
                            self.wfile.write(
                                b"data: " + json.dumps(item).encode() + b"\n\n"
                            )
                            self.wfile.flush()
                    except OSError:
                        pass  # client went away; producer drains on its own
                    finally:
                        # count even disconnected/failed streams — the
                        # device did the work whether or not the client
                        # read it (usage may be None mid-generation)
                        server._count(
                            "chat_stream" if chat else "stream", last_usage
                        )
                    return
                try:
                    if chat:
                        body = server._generate_chat(
                            prompts[0], kwargs, system, previous
                        )
                    else:
                        body = server._generate(prompts, kwargs)
                    server._count(
                        "chat" if chat else "completions",
                        body.get("usage"),
                    )
                    self._send(200, body)
                except Exception as e:  # device/engine failure: loud 500
                    logger.exception("completion failed")
                    self._send(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        thread.start()
        self.port = self._httpd.server_address[1]
        logger.info("Serving %s on http://%s:%d", self.model_id, host, self.port)
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self.batcher is not None:
            self.batcher.stop()
        if self.pool is not None:
            self.pool.stop()
        # a tensor-parallel engine's followers return once the server stops
        stop = getattr(self.engine, "stop", None)
        if stop is not None:
            stop()


def serve(
    model_path: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    load_in_4bit: bool = False,
    load_in_8bit: bool = False,
    draft_model: Optional[str] = None,
    speculation_k: int = 4,
    shard: bool = False,
    batch_window_ms: float = 0.0,
    prefix_cache: int = 0,
    continuous: int = 0,
    continuous_cache_len: int = 2048,
    continuous_decode_chunk: int = 1,
    continuous_prefill_chunk: Optional[int] = None,
    warmup: bool = False,
    device="cuda:0",
    tokenizer=None,
) -> Optional[ModelServer]:
    """Load a model and start the HTTP server (CLI entry). ``draft_model``
    enables speculative decoding (``speculation_k`` tokens a round) for
    greedy single-prompt requests and the greedy pool; ``batch_window_ms``
    > 0 coalesces concurrent compatible requests into one lockstep decode
    (DynamicBatcher); ``prefix_cache`` > 0 keeps that many prompt-prefix KV
    slabs on the device, so single-prompt requests sharing a system prompt
    skip its prefill; ``continuous`` > 0 serves greedy requests from a
    continuously batched pool of that many slots (requests join the running
    decode and free their slot the moment they finish; see
    batching.ContinuousEngine). ``shard`` serves tensor parallel over the
    ranks a launcher started: rank 0 returns the running server; every
    other rank replays rank 0's calls until that server stops and returns
    None (with one rank ``shard`` only logs)."""
    from .inference import InferenceEngine

    engine = InferenceEngine.from_pretrained(
        model_path,
        load_in_4bit=load_in_4bit,
        load_in_8bit=load_in_8bit,
        tokenizer=tokenizer,
        device=device,
        draft_model=draft_model,
        speculation_k=speculation_k,
        prefix_cache_slots=prefix_cache,
        shard=shard,
    )
    if engine.follower:
        engine.follow()
        return None
    server = ModelServer(
        engine,
        model_id=str(model_path),
        batch_window_ms=batch_window_ms,
        continuous_slots=continuous,
        continuous_cache_len=continuous_cache_len,
        continuous_decode_chunk=continuous_decode_chunk,
        continuous_prefill_chunk=continuous_prefill_chunk,
    )
    if warmup:
        chunks = sorted({1, max(1, int(continuous_decode_chunk))})
        spent = server.warmup(decode_chunks=chunks)
        logger.info("warmup ran the serving hot path in %.1f s", spent)
    server.start(host, port)
    return server
