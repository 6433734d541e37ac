"""Tensor-parallel decoding across launched ranks (counterpart of the JAX
engine's mesh-sharded serving, shardmerge_tpu/inference.py ``shard=True``).

One process per rank (``torchrun --nproc-per-node P``). Each rank holds its
slice of the params (parallel/train.py) and of every KV cache, and runs the
same forward on it; the model's modules run the collectives
(models/llama.py, through :class:`TPGroup`). Rank 0 owns everything else:
the tokenizer, sampling, a pool's schedule, the HTTP server. So rank 0 is
the :class:`Leader`, and every other rank runs :meth:`Follower.follow`, a
loop that replays, in order, each call of rank 0 that touches the model or
a target cache:

- ``init``: a new cache (batch, length) under a handle every rank shares;
- ``forward``: the model over a cache, with the call's host arguments;
- ``slice`` / ``implant``: a prefix slab cut from a cache, or written into
  one (the prefix cache);
- ``compact`` / ``implant_row``: the continuous pool's gather of every row's
  live slots, and its install of an admitted request's slab into a row;
- ``ping`` (rank 0 alive, nothing to do) and ``stop`` (the follower returns).

Rank 0 broadcasts each call record over a gloo control group before it runs
the call itself, under one lock, so the records and the collectives inside
them keep one order across threads (the pool's and the server's). A record
carries the handles whose caches rank 0 dropped since the last one, and the
followers free them. Speculative decoding's draft stays whole on rank 0 and
is not replayed.

Nothing waits forever. The control group has a timeout
(``SHARDMERGE_HEARTBEAT_TIMEOUT_S``, default 120 s) and an idle leader
pings at an eighth of it. A call that fails on a follower ends that
process at once with exit code 1, naming its rank and the call; rank 0's
next collective with it then fails, and a call that fails on rank 0 is
raised to its caller and recorded in :attr:`Leader.failed`, which the
command-line server watches to exit nonzero. When rank 0 stops, the
followers return 0.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch

from .comm import Comm
from .train import Plan

logger = logging.getLogger(__name__)

__all__ = ["TPGroup", "TPCache", "Leader", "Follower", "join"]

_DEFAULT_TIMEOUT_S = 120


def _timeout_s() -> float:
    try:
        return float(os.environ.get("SHARDMERGE_HEARTBEAT_TIMEOUT_S") or _DEFAULT_TIMEOUT_S)
    except ValueError:
        return float(_DEFAULT_TIMEOUT_S)


class TPGroup:
    """A rank's place in the tensor-parallel group, as the model's modules
    see it: its :class:`~.train.Plan`, the collectives (``comm``) and the
    dtype partial sums accumulate in (``reduce_dtype``; None sums in the
    activations' dtype). Every rank must take the same ``reduce_dtype``."""

    def __init__(self, comm: Comm, plan: Plan, control_group=None,
                 reduce_dtype: Optional[torch.dtype] = torch.float32):
        self.comm = comm
        self.plan = plan
        self.rank, self.size = plan.rank, plan.size
        self.control_group = control_group
        self.reduce_dtype = reduce_dtype

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial ``x`` (the same bits on every rank)."""
        return self.comm.all_reduce_sum(x, self.reduce_dtype)

    def gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel logits (..., V/P) -> the full (..., V)."""
        return self.comm.all_gather_last(x)


class TPCache(dict):
    """Rank 0's view of a sharded cache: its own slice of the buffers, and
    the ``handle`` under which every rank keeps its slice."""

    __slots__ = ("handle", "leader", "__weakref__")


def _encode(arg):
    """A call argument as it travels: a cache by its handle, a tensor as a
    host array."""
    if isinstance(arg, TPCache):
        return ("@kv", arg.handle)
    if isinstance(arg, torch.Tensor):
        return ("@t", arg.detach().cpu().numpy())
    return arg


class _Replica:
    """What leader and followers share: the model, the local caches' ops."""

    def __init__(self, group: TPGroup, model):
        self.group = group
        self.model = model
        self._ropes: dict = {}

    def _rope(self, length: int):
        from ..models.llama import rope_tables

        rope = self._ropes.get(length)
        if rope is None:
            rope = self._ropes[length] = rope_tables(self.model.cfg, length, self.model.device)
        return rope

    def _init_local(self, batch: int, cache_len: int) -> dict:
        from ..models.llama import init_kv_cache

        return init_kv_cache(self.model.cfg, batch, cache_len, self.model.dtype, self.model.device,
                             kv_heads=self.model.kv_heads)

    @staticmethod
    def _op(name: str):
        from .. import inference

        return {"slice": inference._slice_kv, "implant": inference._implant_kv,
                "compact": inference._gather_kv_slots, "implant_row": inference._implant_kv_row}[name]


class Leader(_Replica):
    """Rank 0: broadcasts each call record, then runs the call on its own
    slice. ``failed`` holds the first failure ("rank 0 failed in call
    NAME#SEQ: ..."), after which every call raises."""

    leader = True

    def __init__(self, group: TPGroup, model):
        super().__init__(group, model)
        self.lock = threading.RLock()
        self.seq = 0
        self.failed: Optional[str] = None
        self._handles = 0
        self._frees: deque = deque()
        self._stopped = False
        self._last = time.monotonic()
        self._interval = max(1.0, _timeout_s() / 8)
        self._beat = threading.Thread(target=self._heartbeat, name="tp-heartbeat", daemon=True)
        self._beat.start()

    # -- the record ------------------------------------------------------------

    def _handle(self) -> int:
        self._handles += 1
        return self._handles

    def _new(self, handle: int, local: dict) -> TPCache:
        kv = TPCache(local)
        kv.handle, kv.leader = handle, self
        weakref.finalize(kv, self._frees.append, handle)
        return kv

    def _send(self, name: str, args) -> None:
        frees = []
        while self._frees:
            frees.append(self._frees.popleft())
        self.group.comm.broadcast_object((self.seq, name, args, frees), group=self.group.control_group)
        self._last = time.monotonic()

    def _call(self, name: str, args, local):
        with self.lock:
            if self.failed is not None:
                raise RuntimeError(f"the tensor-parallel group is down: {self.failed}")
            if self._stopped:
                raise RuntimeError("the tensor-parallel group is stopped")
            self.seq += 1
            try:
                self._send(name, tuple(_encode(a) for a in args))
                return local()
            except Exception as e:
                self.failed = f"rank 0 failed in call {name}#{self.seq}: {type(e).__name__}: {e}"
                logger.error(self.failed)
                raise

    def _heartbeat(self):
        while not self._stopped and self.failed is None:
            time.sleep(self._interval / 4)
            if time.monotonic() - self._last < self._interval or not self.lock.acquire(timeout=0):
                continue
            try:
                if not self._stopped and self.failed is None:
                    self._call("ping", (), lambda: None)
            except Exception:  # _call recorded it in ``failed``
                return
            finally:
                self.lock.release()

    # -- the calls ---------------------------------------------------------------

    def init_kv(self, batch: int, cache_len: int) -> TPCache:
        with self.lock:
            handle = self._handle()
            return self._call("init", (handle, batch, cache_len),
                              lambda: self._new(handle, self._init_local(batch, cache_len)))

    def forward(self, input_ids, positions, kv_cache, cache_pos, rope, attn_len, mask_positions=None,
                token_valid=None, key_positions=None):
        if not isinstance(kv_cache, TPCache):
            raise TypeError("a sharded model runs over caches from its engine's _init_kv")
        args = (kv_cache, input_ids, positions, int(cache_pos), int(rope[0].shape[0]), int(attn_len), mask_positions,
                token_valid, key_positions)
        return self._call("forward", args, lambda: self.model(
            input_ids, positions, kv_cache, cache_pos, rope, attn_len, mask_positions=mask_positions,
            token_valid=token_valid, key_positions=key_positions))

    def kv_op(self, name: str, kv: TPCache, *args):
        """``slice`` (a new cache), ``implant``, ``compact`` or ``implant_row``
        on every rank's slice of ``kv``."""
        op = self._op(name)
        plain = [dict(a) if isinstance(a, TPCache) else a for a in args]
        with self.lock:
            if name == "slice":
                handle = self._handle()
                return self._call(name, (kv, handle) + args, lambda: self._new(handle, op(dict(kv), *plain)))
            self._call(name, (kv,) + args, lambda: op(dict(kv), *plain))
            return kv

    def stop(self) -> None:
        """Release the followers (they return 0); idempotent. After a
        failure nothing is sent: the group is down."""
        with self.lock:
            if self._stopped or self.failed is not None:
                self._stopped = True
                return
            self.seq += 1
            try:
                self._send("stop", ())
            except Exception as e:  # the followers are gone already
                logger.warning("stopping the tensor-parallel group: %s", e)
            self._stopped = True


class Follower(_Replica):
    """A rank above 0: replays rank 0's calls on its own slices."""

    leader = False

    def follow(self) -> int:
        """Replay calls until rank 0's ``stop`` (returns 0). A failure,
        waiting or in a call, ends the process with exit code 1."""
        caches: dict = {}
        rank, seq = self.group.rank, 0
        comm, control = self.group.comm, self.group.control_group
        dev = self.model.device

        def tensor(a):
            if isinstance(a, tuple) and len(a) == 2 and a[0] == "@t":
                return torch.from_numpy(np.ascontiguousarray(a[1])).to(dev)
            if isinstance(a, tuple) and len(a) == 2 and a[0] == "@kv":
                return caches[a[1]]
            return a

        with torch.inference_mode():
            while True:
                try:
                    seq, name, args, frees = comm.broadcast_object(None, group=control)
                except Exception as e:
                    _die(f"rank {rank} failed waiting for call #{seq + 1}: {type(e).__name__}: {e}")
                for handle in frees:
                    caches.pop(handle, None)
                if name == "stop":
                    logger.info("rank %d: stopped by rank 0 after %d calls", rank, seq)
                    return 0
                try:
                    if name == "init":
                        handle, batch, cache_len = args
                        caches[handle] = self._init_local(batch, cache_len)
                    elif name == "forward":
                        kv, ids, pos, cache_pos, rope_len, attn_len, mpos, valid, kpos = (tensor(a) for a in args)
                        self.model(ids, pos, kv, cache_pos, self._rope(rope_len), attn_len, mask_positions=mpos,
                                   token_valid=valid, key_positions=kpos)
                    elif name == "slice":
                        kv, handle, length = (tensor(a) for a in args)
                        caches[handle] = self._op(name)(kv, length)
                    elif name != "ping":
                        self._op(name)(*(tensor(a) for a in args))
                except Exception as e:
                    logger.exception("rank %d: call %s#%d failed", rank, name, seq)
                    _die(f"rank {rank} failed in call {name}#{seq}: {type(e).__name__}: {e}")


def _die(message: str) -> None:
    """End this rank at once: its peers' next collective with it fails."""
    logger.error(message)
    print(f"error: {message}", file=sys.stderr, flush=True)
    os._exit(1)


def join(device: str):
    """Join the ranks a launcher started as one tensor-parallel group.

    Returns ``(comm, control_group, device)``: the collectives (any thread
    may call them; the leader's lock orders them), the gloo group of the
    call records, and this rank's device (its own GPU under NCCL, the shared
    card under host-staged gloo, the host with ``cpu``). None when one rank
    runs: ``--shard`` then does nothing but log, as on one JAX device."""
    import torch.distributed as dist

    from .comm import local_rank
    from .multihost import _device_kind, initialize_distributed

    initialize_distributed(device=device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        logger.info("--shard: one rank, nothing to shard; decoding on %s", device)
        return None
    if _device_kind(device) == "cuda":
        device = f"cuda:{local_rank() % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    else:
        device = "cpu"
    comm = Comm(device, serialized=True)
    control = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=_timeout_s()))
    logger.info("tensor parallel: rank %d/%d on %s over %s", comm.rank, comm.size, device, comm.transport)
    return comm, control, device
