"""The training mesh (counterpart of shardmerge_tpu/parallel/mesh.py).

JAX lays its devices on a named grid and GSPMD derives the collectives. The
port's grid is the ranks a launcher started (``torchrun``: one process a
rank, parallel/multihost.py ``initialize_distributed``), laid out row-major
over the axes, the last axis fastest: on a ("dp", "tp") mesh rank
``d * tp + t`` sits at (d, t), so a host's consecutive ranks share a tensor
parallel group; on ("dp", "pp", "tp") rank ``d * P * T + p * T + t`` sits at
(d, p, t), and the ``"pp"`` line of a (d, t) joins its stages in order. Each axis has one process group per line of the grid, and
:class:`Mesh` keeps this rank's :class:`~.comm.Comm` over each of its lines;
:meth:`Mesh.joint` joins several axes (the data axes dp and cp of context
parallelism's gradients).
The transport is the merge ranks' (parallel/comm.py ``transport_for``): gloo
on the CPU or when ranks share a GPU, NCCL with one GPU a rank.

A one-process run is a mesh of one rank, every axis 1, with no process
group at all.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .comm import Comm

__all__ = ["Mesh", "make_mesh", "mesh_shape_for"]


def mesh_shape_for(n: int, n_axes: int) -> Tuple[int, ...]:
    """Split ``n`` ranks into ``n_axes`` factors, largest last (the last axis
    is the tensor axis, which profits most from being wide): JAX's
    heuristic."""
    if n_axes == 1:
        return (n,)
    shape = [1] * n_axes
    remaining = n
    for i in range(n_axes - 1):
        for p in (2, 3, 5, 7):
            if remaining % p == 0 and remaining // p >= 1:
                shape[i] = p
                remaining //= p
                break
    shape[-1] = remaining
    if int(np.prod(shape)) != n:
        shape = [1] * (n_axes - 1) + [n]
    return tuple(shape)


class Mesh:
    """This rank's place on the grid: ``shape`` by ``axis_names``, its
    ``coords``, its ``device``, and ``comms[axis]``, the collectives over
    the ranks that differ from it only on that axis (None for an axis of
    one rank)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int, device,
                 comms: Optional[Dict[str, Comm]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, np.unravel_index(rank, tuple(shape))))
        self.coords = {k: int(v) for k, v in self.coords.items()}
        self.device = torch.device(device)
        self.comms = comms or {}
        self._joint: Dict[Tuple[str, ...], Optional[Comm]] = {}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def comm(self, axis: str) -> Optional[Comm]:
        return self.comms.get(axis)

    def joint(self, axes: Sequence[str]) -> Optional[Comm]:
        """The collectives over the ranks that differ from this one only on
        ``axes`` (one axis: :meth:`comm`), their group ranks in row-major
        order over those axes; None when they hold one rank. A joint line's
        groups are made at its first use: a collective, every rank calls
        it."""
        axes = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if len(axes) <= 1:
            return self.comm(axes[0]) if axes else None
        if axes not in self._joint:
            import torch.distributed as dist

            grid = np.arange(self.size).reshape(tuple(self.shape.values()))
            at = [self.axis_names.index(a) for a in axes]
            lines = np.moveaxis(grid, at, list(range(grid.ndim - len(at), grid.ndim)))
            mine = None
            for members in lines.reshape(-1, int(np.prod([self.shape[a] for a in axes]))):
                group = _new_group([int(r) for r in members])
                if self.rank in members:
                    mine = Comm(self.device, serialized=True, group=group)
            self._joint[axes] = mine
        return self._joint[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords} on {self.device})"


def _new_group(members):
    """A process group over ``members`` with the world's collective timeout
    (``SHARDMERGE_HEARTBEAT_TIMEOUT_S``, parallel/multihost.py), so that a
    rank that fails stops the others' collectives on every axis in that
    time, not in the backend's default. A collective: every rank calls it."""
    import datetime

    import torch.distributed as dist

    seconds = os.environ.get("SHARDMERGE_HEARTBEAT_TIMEOUT_S", "").strip()
    if seconds.isdigit() and int(seconds) > 0:
        return dist.new_group(members, timeout=datetime.timedelta(seconds=int(seconds)))
    return dist.new_group(members)


def make_mesh(axis_names: Sequence[str] = ("dp", "tp"), shape: Optional[Sequence[int]] = None,
              device: Optional[str] = None) -> Mesh:
    """The mesh over the launched ranks (one rank when none were launched).

    ``shape`` defaults to :func:`mesh_shape_for`; its product must be the
    world size. ``device``: "cpu" keeps every rank on the host; otherwise a
    rank takes its own GPU (NCCL) or the shared one (gloo, host-staged), and
    a single process takes ``cuda`` when the host has one. A collective
    when ranks were launched: every rank calls it."""
    import torch.distributed as dist

    from .comm import local_rank
    from .multihost import _device_kind, initialize_distributed

    initialize_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = mesh_shape_for(world, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"Mesh shape {shape} does not cover {world} ranks")
    if _device_kind(device) == "cuda":
        dev = f"cuda:{local_rank() % torch.cuda.device_count()}"
        torch.cuda.set_device(dev)
    else:
        dev = "cpu"
    comms: Dict[str, Comm] = {}
    if world > 1:
        grid = np.arange(world).reshape(shape)
        for a, name in enumerate(axis_names):
            # every line of the grid along axis a, in one order on every rank
            others = [range(s) for i, s in enumerate(shape) if i != a]
            for idx in itertools.product(*others):
                index = list(idx)
                index.insert(a, slice(None))
                members = [int(r) for r in grid[tuple(index)]]
                group = _new_group(members) if shape[a] > 1 else None
                if rank in members and group is not None:
                    comms[name] = Comm(dev, serialized=True, group=group)
    return Mesh(axis_names, shape, rank, dev, comms)
