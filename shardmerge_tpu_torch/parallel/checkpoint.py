"""Train-state checkpoints (counterpart of shardmerge_tpu/parallel/checkpoint.py).

One safetensors file, ``train_state.safetensors``, holds every leaf of the
state WHOLE (each tensor-parallel slice and ZeRO-1 / fsdp chunk put back
together), named by its place in the state (``params/layers/0/q_proj``,
``opt_state/0/mu/layers/0/q_proj``, ``master/...``), with the ``step`` and the
leaf count in the metadata. The structure is not stored: the caller passes a
template state (an ``init_state(params)`` of the train step it resumes in),
and each stored leaf is cut to the template's placement, so a state saved
on a (2, 1) ZeRO-1 mesh restores onto (1, 2), onto one device, or the other
way round. The write is atomic (``.tmp`` then rename): a checkpoint exists
whole or not at all. Across ranks every rank takes part in the gathers and
rank 0 writes; every rank reads the file to restore.

A pipeline's state (parallel/train.py ``make_pp_train_step``) is one stage
a rank, its leaves named as unpipelined (``params/layers/12/q_proj``): the
later stages send theirs to stage 0 over the pp line of rank 0, and a
restore takes each stage's own names from the file, so a pipeline's
checkpoint restores on one device or on (dp, tp), and the other way round.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from ..io.safetensors_io import SafeTensorsReader, save_file
from .train import TrainState, tree_flatten, tree_unflatten

__all__ = ["save_train_state", "restore_train_state", "place_state"]

logger = logging.getLogger(__name__)

_FILE = "train_state.safetensors"


def _name(path) -> str:
    return "/".join(str(p) for p in path)


def _map_state(state: TrainState, fn: Callable) -> TrainState:
    """``state`` with each leaf replaced by ``fn(name, kind, i, leaf)``:
    kind "trained" (leaf i of the trained tree: the params, or LoRA's
    adapters), "opt" (the moment or master of trained leaf i), "base"
    (LoRA's frozen leaf i) or "scalar" (a count)."""
    lay = state.layout
    paths = lay.paths
    out = TrainState()
    for key, value in state.items():
        if key == lay.trained:
            tp, leaves = tree_flatten(value)
            out[key] = tree_unflatten(value, [fn(f"{key}/{_name(p)}", "trained", i, v)
                                              for i, (p, v) in enumerate(zip(tp, leaves))])
        elif key == "params":  # LoRA's frozen base
            tp, leaves = tree_flatten(value)
            out[key] = tree_unflatten(value, [fn(f"{key}/{_name(p)}", "base", i, v)
                                              for i, (p, v) in enumerate(zip(tp, leaves))])
        elif key == "master":
            out[key] = [fn(f"master/{_name(p)}", "opt", i, v) for i, (p, v) in enumerate(zip(paths, value))]
        else:
            out[key] = _map_opt(value, key, fn, paths)
    out.layout = lay
    return out


def _map_opt(node, prefix: str, fn, paths):
    if isinstance(node, dict):
        return {k: ([fn(f"{prefix}/{k}/{_name(p)}", "opt", i, v) for i, (p, v) in enumerate(zip(paths, node[k]))]
                    if k in ("mu", "nu") else _map_opt(node[k], f"{prefix}/{k}", fn, paths)) for k in node}
    if isinstance(node, (list, tuple)):
        return [_map_opt(v, f"{prefix}/{j}", fn, paths) for j, v in enumerate(node)]
    return fn(prefix, "scalar", None, node)


def _first() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_train_state(path, state: TrainState, step: Optional[int] = None) -> Path:
    """Write ``state`` into ``path``/train_state.safetensors (every leaf
    whole, ``step`` in the metadata) and return the file. Across ranks:
    every rank calls it, rank 0 writes, and it returns when the file is
    there for every rank."""
    out_dir = Path(path)
    lay = state.layout
    tensors = {}

    def collect(name, kind, i, leaf):
        whole = leaf if kind == "scalar" else lay.gather(kind, i, leaf)
        tensors[name] = whole.detach().to("cpu").contiguous()
        return leaf

    _map_state(state, collect)
    if lay.pp_comm is not None and all(c == 0 for a, c in lay.mesh.coords.items() if a != "pp"):
        tensors = _gather_stages(lay.pp_comm, tensors)
    final = out_dir / _FILE
    if _first():
        out_dir.mkdir(parents=True, exist_ok=True)
        meta = {"leaves": str(len(tensors))}
        if step is not None:
            meta["step"] = str(int(step))
        tmp = out_dir / (_FILE + ".tmp")
        save_file(tensors, tmp, metadata=meta)
        tmp.replace(final)
        logger.info("Saved train state: %d leaves%s -> %s", len(tensors),
                    f" at step {step}" if step is not None else "", final)
    _barrier()
    return final


def _gather_stages(pp, tensors: dict) -> dict:
    """Every stage's whole leaves on stage 0 of the pp line (a name held by
    several stages, a tied embedding or a step count, is stage 0's); the
    other stages get their own back. Each stage sends its names, shapes and
    dtypes, then its tensors one by one."""
    import torch.distributed as dist

    dev = "cpu" if pp.backend == "gloo" else pp.device  # gloo sends host tensors; NCCL the device's
    if pp.position != 0:
        meta = [[(n, tuple(t.shape), str(t.dtype)) for n, t in tensors.items()]]
        dist.send_object_list(meta, dst=pp.global_rank(0), group=pp.group)
        for t in tensors.values():
            pp.send(t.to(dev), 0)
        return tensors
    out = dict(tensors)
    for r in range(1, pp.size):
        meta = [None]
        dist.recv_object_list(meta, src=pp.global_rank(r), group=pp.group)
        for name, shape, dtype in meta[0]:
            t = pp.recv(torch.empty(shape, dtype=getattr(torch, dtype.split(".")[-1]), device=dev), r).cpu()
            out.setdefault(name, t)
    return out


def place_state(template_state: TrainState, tensors, source: str = "checkpoint") -> TrainState:
    """``template_state`` with each leaf taken whole from ``tensors`` (a
    name -> tensor mapping: a checkpoint's reader, or a carried-over JAX
    state) and cut to the template's placement. Names, whole shapes and
    dtypes must match the template's."""
    lay = template_state.layout
    names = []
    _map_state(template_state, lambda name, kind, i, leaf: names.append(name) or leaf)
    missing = [n for n in names if n not in tensors]
    one_stage = lay.pp_comm is not None  # a pipeline stage takes its own leaves of the whole state
    if missing or (len(names) != len(tensors) and not one_stage):
        raise ValueError(f"{source} has {len(tensors)} leaves; template expects {len(names)} (missing e.g. "
                         f"{missing[:3]}) — saved with a different model/optimizer configuration")

    def place(name, kind, i, ref):
        arr = tensors[name]
        want = (tuple(ref.shape) if kind == "scalar" else lay.base_shapes[i] if kind == "base"
                else lay.full_shapes[i])
        if tuple(arr.shape) != want:
            raise ValueError(f"{source} leaf {name} has shape {tuple(arr.shape)}; template expects {want}")
        if arr.dtype != ref.dtype:
            raise ValueError(f"{source} leaf {name} has dtype {arr.dtype}; template expects {ref.dtype} — "
                             "trained/saved under a different precision configuration")
        local = arr if kind in ("scalar",) else lay.place(kind, i, arr)
        return local.to(ref.device)

    return _map_state(template_state, place)


class _Leaves:
    """A checkpoint file's leaves by name, each read (copied) at lookup."""

    def __init__(self, reader):
        self._reader = reader
        self._names = set(reader.keys())

    def __contains__(self, name):
        return name in self._names

    def __len__(self):
        return len(self._names)

    def __getitem__(self, name):
        return self._reader.get_tensor(name, copy=True)


def restore_train_state(path, template_state: TrainState) -> Tuple[TrainState, Optional[int]]:
    """Restore a checkpoint onto ``template_state``'s structure and
    placement; returns ``(state, step or None)``. Each leaf's whole shape
    and dtype must be the template's (a model or precision mismatch fails
    naming the leaf)."""
    file = Path(path)
    if file.is_dir():
        file = file / _FILE
    with SafeTensorsReader(file) as reader:
        meta = reader.metadata or {}
        restored = place_state(template_state, _Leaves(reader))
    step = int(meta["step"]) if "step" in meta else None
    return restored, step
