"""The merge ranks' process group: the port's counterpart of the JAX merge
mesh and its one axis ``"x"``.

One process per rank (a launcher such as ``torchrun`` starts them), each on
its own device. A :class:`Comm` holds the group, this rank's place in it and
its device, and offers the merge's collectives:

- ``a2a_rs_to_cs`` / ``a2a_cs_to_rs``: the two tiled all-to-alls of the
  distributed 2-D FFT (``jax.lax.all_to_all(..., tiled=True)`` in
  shardmerge_tpu/parallel/fft2d.py), between the row-sharded layout, a local
  block of (M/P, N), and the column-sharded one, (M, N/P);
- ``all_gather_rows``: the Nyquist column's tiled all-gather;
- ``all_reduce``: a sum (``psum``; a max of flags is a sum tested > 0);
- ``gather_rows``: a row-sharded result gathered to the first rank in row
  blocks of bounded bytes, for the write-back.

The tensor-parallel decoder (parallel/tp.py) adds:

- ``all_reduce_sum``: the sum of every rank's partial, accumulated in a
  chosen dtype in rank order from an all-gather, so that every rank holds
  the same bits whatever the transport's reduction order;
- ``all_gather_last``: the vocab-parallel logits joined along the last axis;
- ``broadcast_object``: the first rank's call records, over a control group.

The train step (parallel/train.py) runs a :class:`Comm` over each axis of
its (dp, tp) mesh (``group``: that axis's process group, parallel/mesh.py)
and adds ``reduce_scatter_sum`` (ZeRO-1's and fsdp's gradient shards,
summed in f32 on either transport: NCCL's reduce-scatter of the cast
gradients, or an all-to-all summed in rank order) and ``all_gather_flat``
(the updated shards back).

The pipeline (parallel/pipeline.py) adds point-to-point transfers along its
``"pp"`` line: ``send`` / ``recv`` (a stage's activations forward, their
gradients back) and ``sendrecv`` (the first and the last stage trade the
tied embedding's gradient), counted under the ``p2p`` kind (a receive as a
call of no bytes sent). Context parallelism's ring (parallel/ring.py) uses
``exchange``: every rank sends to the next position and receives from the
previous one, also a ``p2p`` call (``sendrecv`` is its one-peer case).

Ranks sit at positions 0..P-1 (``merge_mesh`` orders them host by host);
position p holds rows [p M/P, (p+1) M/P) and the p-th column block.

The transport follows from the topology, never from a failure
(``transport_for``): NCCL when every rank has a GPU of its own; gloo when
the ranks run on the CPU, or share a GPU (more local ranks than GPUs: NCCL
refuses two ranks on one device), in which case every collective stages its
tensors through host memory. A collective that fails raises.

Every rank must run every collective, in the same order. The merge runs
them from one thread (the merge loop's); a collective from another
thread raises instead of risking a deadlock against the ranks' order.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..backend import BackendError

__all__ = ["Comm", "transport_for", "local_rank", "local_world_size"]


def _world_size() -> int:
    try:
        return int(os.environ.get("WORLD_SIZE") or 1)
    except ValueError:
        return 1


def _launcher_var(var: str) -> int:
    """``var`` as the launcher set it; 0 for LOCAL_RANK and 1 for
    LOCAL_WORLD_SIZE when a single rank runs. With several ranks it must be
    set (torchrun sets both): the ranks' GPUs and transport follow from it,
    and a guess from WORLD_SIZE would take every host for one."""
    value = os.environ.get(var, "").strip()
    if not value:
        if _world_size() <= 1:
            return 0 if var == "LOCAL_RANK" else 1
        raise BackendError(
            f"{var} is unset: a launcher of merge ranks must set it (torchrun does), "
            "so that each rank's GPU and the ranks' transport follow from the host's ranks"
        )
    try:
        return int(value)
    except ValueError:
        raise BackendError(f"malformed {var}={value!r}") from None


def local_rank() -> int:
    """This rank's index on its host: ``LOCAL_RANK``."""
    return _launcher_var("LOCAL_RANK")


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE``."""
    return _launcher_var("LOCAL_WORLD_SIZE")


def transport_for(device_kind: str, local_ranks: Optional[int] = None) -> Tuple[str, bool]:
    """(backend, host-staged) for ranks on devices of ``device_kind``:
    ``("nccl", False)`` when each of the host's ranks has a GPU of its own,
    ``("gloo", True)`` when they share GPUs, ``("gloo", False)`` on the CPU."""
    if device_kind != "cuda":
        return "gloo", False
    local_ranks = local_world_size() if local_ranks is None else local_ranks
    if local_ranks > torch.cuda.device_count():
        return "gloo", True
    return "nccl", False


class Comm:
    """The merge ranks (the default process group), this rank's position
    and its device.

    ``order`` lists the ranks by position (default: rank order). ``stats``
    counts, per collective kind, [calls, bytes this rank sent, host seconds]
    (host-staged collectives are synchronous, so their seconds are their
    wall; an NCCL call's are its launch). ``group``: a subgroup to run over
    instead of the default group (ranks and positions are then the
    group's)."""

    def __init__(self, device, order: Optional[Sequence[int]] = None, serialized: bool = False, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.order: List[int] = list(order) if order is not None else list(range(self.size))
        if sorted(self.order) != list(range(self.size)):
            raise ValueError(f"order {self.order} is not a permutation of the group's {self.size} ranks")
        self.position = self.order.index(self.rank)
        self._pos_of = [self.order.index(r) for r in range(self.size)]
        self._identity = self.order == list(range(self.size))
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        # gloo moves no CUDA tensor: its collectives go through host memory
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats = {}
        self.hosts = 1  # hosts the ranks span (merge_mesh counts them)
        # serialized: the caller orders every collective under one lock
        # (the tensor-parallel leader's), from whichever thread holds it
        self._owner = None if serialized else threading.get_ident()

    @property
    def transport(self) -> str:
        return self.backend + (" (host-staged)" if self.staged else "")

    @property
    def primary(self) -> bool:
        """Position 0: the rank that receives ``gather_rows``."""
        return self.position == 0

    # -- plumbing -------------------------------------------------------------

    def _enter(self):
        if self._owner is not None and threading.get_ident() != self._owner:
            raise RuntimeError(
                "a merge collective ran off the thread that owns the rank's group: "
                "every rank must run its collectives in one order, from one thread"
            )

    def _count(self, kind: str, nbytes: int, t0: float):
        s = self.stats.setdefault(kind, [0, 0, 0.0])
        s[0] += 1
        s[1] += nbytes
        s[2] += time.perf_counter() - t0

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the collective runs: on the host when staged."""
        return x.cpu() if self.staged else x

    def _back(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(like.device) if self.staged else x

    @staticmethod
    def _real(x: torch.Tensor) -> torch.Tensor:
        return torch.view_as_real(x) if x.is_complex() else x

    def _by_rank(self, chunks: torch.Tensor) -> torch.Tensor:
        """Chunks indexed by position -> indexed by group rank."""
        return chunks if self._identity else chunks[self._pos_of]

    def _by_position(self, chunks: torch.Tensor) -> torch.Tensor:
        return chunks if self._identity else chunks[self.order]

    # -- collectives --------------------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor, on x's device)."""
        self._enter()
        t0 = time.perf_counter()
        buf = self._out(x).clone()
        self._dist.all_reduce(buf, group=self.group)
        out = self._back(buf, x)
        self._count("all_reduce", x.nbytes, t0)
        return out

    def _all_to_all(self, kind: str, chunks: torch.Tensor) -> torch.Tensor:
        """(P, ...) chunks by destination position -> (P, ...) by source."""
        self._enter()
        t0 = time.perf_counter()
        complex_ = chunks.is_complex()
        send = self._out(self._real(self._by_rank(chunks)).contiguous())
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        recv = self._by_position(self._back(recv, chunks))
        out = torch.view_as_complex(recv) if complex_ else recv
        self._count(kind, chunks.nbytes, t0)
        return out

    def a2a_rs_to_cs(self, x: torch.Tensor) -> torch.Tensor:
        """(M/P, N) -> (M, N/P): split the columns, concatenate the rows."""
        p = self.size
        m, n = x.shape
        chunks = x.reshape(m, p, n // p).transpose(0, 1)  # (P, M/P, N/P)
        return self._all_to_all("all_to_all", chunks).reshape(p * m, n // p)

    def a2a_cs_to_rs(self, x: torch.Tensor) -> torch.Tensor:
        """(M, N/P) -> (M/P, N): split the rows, concatenate the columns."""
        p = self.size
        rows, n = x.shape
        chunks = x.reshape(p, rows // p, n)  # (P, M/P, N/P)
        out = self._all_to_all("all_to_all", chunks)
        return out.transpose(0, 1).reshape(rows // p, p * n)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(m, ...) on every rank -> (P m, ...) in position order."""
        self._enter()
        t0 = time.perf_counter()
        complex_ = x.is_complex()
        send = self._out(self._real(x).contiguous())
        recv = torch.empty((self.size * send.shape[0],) + tuple(send.shape[1:]), dtype=send.dtype,
                           device=send.device)
        self._dist.all_gather_into_tensor(recv, send, group=self.group)
        recv = self._by_position(self._back(recv, x).reshape((self.size,) + tuple(send.shape)))
        out = torch.view_as_complex(recv) if complex_ else recv
        self._count("all_gather", x.nbytes, t0)
        return out.reshape((self.size * x.shape[0],) + tuple(x.shape[1:]))

    def gather_rows(self, x: torch.Tensor, limit_bytes: int) -> Optional[torch.Tensor]:
        """Gather the rank's (m, ...) rows to position 0 in blocks of at most
        ``limit_bytes`` (each block: the same local rows of every rank).

        Returns, on position 0, the host tensor of (P m, ...) rows in position
        order; None elsewhere (the other ranks keep no copy)."""
        self._enter()
        t0 = time.perf_counter()
        p, m = self.size, x.shape[0]
        row_bytes = max(x[:1].nbytes, 1)
        step = max(1, limit_bytes // (p * row_bytes))
        out = torch.empty((p, m) + tuple(x.shape[1:]), dtype=x.dtype) if self.primary else None
        for r0 in range(0, m, step):
            block = self._out(x[r0:r0 + step].contiguous())
            recv = [torch.empty_like(block) for _ in range(p)] if self.primary else None
            dst = self.order[0] if self.group is None else self._dist.get_global_rank(self.group, self.order[0])
            self._dist.gather(block, recv, dst=dst, group=self.group)
            if self.primary:
                for g, piece in enumerate(recv):
                    out[self._pos_of[g], r0:r0 + step].copy_(piece)
        self._count("gather", x.nbytes, t0)
        if out is None:
            return None
        return out.reshape((p * m,) + tuple(x.shape[1:]))

    def _gather_flat(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: (P,) + x.shape, on x's device."""
        send = self._out(x.contiguous().reshape(-1))
        recv = torch.empty((self.size * send.numel(),), dtype=send.dtype, device=send.device)
        self._dist.all_gather_into_tensor(recv, send, group=self.group)
        return self._back(recv, x).reshape((self.size,) + tuple(x.shape))

    def all_reduce_sum(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The sum over the ranks of ``x``, in x.dtype: every rank's partial
        is gathered and summed in rank order in ``dtype`` (default x.dtype),
        so every rank holds the same bits."""
        self._enter()
        t0 = time.perf_counter()
        recv = self._gather_flat(x)
        acc = recv[0].to(dtype or x.dtype)
        for r in range(1, self.size):
            acc = acc + recv[r].to(acc.dtype)
        self._count("all_reduce", x.nbytes, t0)
        return acc.to(x.dtype)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n) on every rank -> (..., P n), rank r's block at [r n, (r+1) n)."""
        self._enter()
        t0 = time.perf_counter()
        recv = self._gather_flat(x)
        out = recv.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (self.size * x.shape[-1],))
        self._count("all_gather", x.nbytes, t0)
        return out

    def reduce_scatter_sum(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A flat (P c,) tensor on every rank -> this rank's (c,) chunk of the
        sum over the ranks (chunk r at [r c, (r+1) c)), summed in ``dtype``
        (default x.dtype) and rounded once to x.dtype on either transport:
        NCCL's reduce-scatter runs on x cast to ``dtype`` (twice the bytes
        for a bf16 x summed in f32); elsewhere (gloo has none) an all-to-all
        brings every rank's chunk r to rank r, added in rank order one chunk
        at a time on x's device."""
        self._enter()
        t0 = time.perf_counter()
        chunks, nbytes = x.reshape(self.size, -1), x.nbytes
        if self.backend == "nccl":
            wide = x.to(dtype or x.dtype)
            nbytes = wide.nbytes
            out = torch.empty_like(wide.reshape(self.size, -1)[0])
            self._dist.reduce_scatter_tensor(out, wide, group=self.group)
            out = out.to(x.dtype)
        else:
            send = self._out(chunks.contiguous())
            recv = torch.empty_like(send)
            self._dist.all_to_all_single(recv, send, group=self.group)
            acc = recv[0].to(x.device, dtype or x.dtype)
            for r in range(1, self.size):
                acc = acc + recv[r].to(x.device, acc.dtype)
            out = acc.to(x.dtype)
        self._count("reduce_scatter", nbytes, t0)
        return out

    def all_gather_flat(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (c,) chunk joined in rank order: (P c,)."""
        self._enter()
        t0 = time.perf_counter()
        out = self._gather_flat(x).reshape(-1)
        self._count("all_gather", x.nbytes, t0)
        return out

    # -- point to point ----------------------------------------------------------

    def global_rank(self, position: int) -> int:
        """The global rank at ``position`` of this line."""
        rank = self.order[position]
        return rank if self.group is None else self._dist.get_global_rank(self.group, rank)

    def send(self, x: torch.Tensor, to_position: int) -> None:
        """Send ``x`` to the rank at ``to_position``; returns when the
        transport has taken it (the matching ``recv`` must come)."""
        self._enter()
        t0 = time.perf_counter()
        self._dist.send(self._out(x.contiguous()), dst=self.global_rank(to_position), group=self.group)
        self._count("p2p", x.nbytes, t0)

    def recv(self, like: torch.Tensor, from_position: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device, sent by the rank at
        ``from_position``."""
        self._enter()
        t0 = time.perf_counter()
        buf = self._out(torch.empty_like(like))
        self._dist.recv(buf, src=self.global_rank(from_position), group=self.group)
        out = self._back(buf, like)
        self._count("p2p", 0, t0)
        return out

    def exchange(self, x: torch.Tensor, to_position: int, from_position: int) -> torch.Tensor:
        """Send ``x`` to the rank at ``to_position`` and return what the rank
        at ``from_position`` sent (a tensor of x's shape and dtype). Both
        transfers are posted together (``batch_isend_irecv``) before either
        is waited for, so no rank waits on a send its peer posts only after
        its own; a wait ends at the group's timeout."""
        self._enter()
        t0 = time.perf_counter()
        send = self._out(x.contiguous())
        buf = torch.empty_like(send)
        works = self._dist.batch_isend_irecv([
            self._dist.P2POp(self._dist.isend, send, self.global_rank(to_position), self.group),
            self._dist.P2POp(self._dist.irecv, buf, self.global_rank(from_position), self.group)])
        for w in works:
            w.wait()
        out = self._back(buf, x)
        self._count("p2p", x.nbytes, t0)
        return out

    def sendrecv(self, x: torch.Tensor, position: int) -> torch.Tensor:
        """Trade ``x`` with the rank at ``position`` (which trades a tensor of
        x's shape and dtype): :meth:`exchange` with one peer."""
        return self.exchange(x, position, position)

    def broadcast_object(self, obj=None, group=None):
        """The first rank's picklable ``obj`` on every rank (over ``group``,
        a host-side control group)."""
        self._enter()
        t0 = time.perf_counter()
        box = [obj]
        self._dist.broadcast_object_list(box, src=self.order[0], group=group)
        self._count("broadcast", 0, t0)
        return box[0]
