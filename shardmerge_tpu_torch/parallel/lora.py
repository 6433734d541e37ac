"""LoRA training over the (dp, tp) mesh: a frozen base, trained adapters
(counterpart of shardmerge_tpu/parallel/lora.py).

``make_lora_train_step`` freezes the base params, raw or int8 / packed-int4
(QLoRA), and trains rank-r factor pairs on the targeted projections. Each
step materializes ``W + (alpha / r) B @ A`` per target (quantized bases
dequantize to bf16 first, the QLoRA compute dtype) and runs the unchanged
``forward_train`` on that tree, so gradients reach only A and B; the
untargeted int4 projections go through ``quant_kernels.Int4Matmul`` (the
card's GEMV at up to 64 rows, with its backward), and their inputs'
gradients flow on to the adapters upstream.

Init: B = 0 (the merged model is the base at step 0) and A ~ U(-1/sqrt(in),
1/sqrt(in)), A's values those of the JAX package for the same seed (the
port's ``ops/prng.py``: ``key``, ``split``, ``uniform``).

Under tp the base keeps the serving placement (parallel/train.py
``train_plan``; int4 row slices re-packed; a checkpoint holds it whole, the
packing over the whole K restored) and each factor goes with its
weight's split dimension: a column-parallel weight (rows split) splits B's
rows and replicates A, a row-parallel weight (columns split) splits A's
columns and replicates B. The replicated factor enters the rank's slice
through Megatron's f, so it gets the same gradient on every rank. The
optimizer state exists only for the adapters. ``lora_to_peft`` writes the
adapters in the PEFT layout tools/fuse_lora.py reads.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..constants import LORA_TARGET_PROJECTIONS as DEFAULT_LORA_TARGETS
from ..ops import prng
from .train import (TrainState, TrainTP, _dp_mean, _Layout, _local_rows, _loss_fn, _OptimKit, base_cuts, shard_params,
                    split_of, tree_flatten, tree_unflatten)

__all__ = ["DEFAULT_LORA_TARGETS", "lora_init", "merge_lora", "make_lora_train_step", "lora_to_peft"]

# internal layer-dict key -> HF module path inside model.layers.{i}
_HF_MODULE = {
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}


def _weight_out_in(w):
    """(out, in) of a raw or quantized {'q', 'scale'} leaf (int4 packs two
    input values a byte)."""
    if isinstance(w, dict):
        q = w["q"]
        return q.shape[0], q.shape[1] * 2 if q.dtype == torch.uint8 else q.shape[1]
    return w.shape[0], w.shape[1]


def lora_init(mesh, params: dict, rank: int, targets: Sequence[str] = DEFAULT_LORA_TARGETS, seed: int = 0) -> dict:
    """Per-layer ``{target: {"A": (r, in), "B": (out, r)}}`` f32 adapters of
    the whole ``params`` on the mesh's device: B = 0, A fan-in uniform
    drawn as the JAX package draws it (one ``split`` a factor, in layer then
    target order)."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    key = prng.key(seed)
    layers = []
    found = set()
    for layer in params["layers"]:
        adapters: Dict[str, dict] = {}
        for name in targets:
            w = layer.get(name)
            if w is None:
                continue
            out_dim, in_dim = _weight_out_in(w)
            key, sub = prng.split(key)
            bound = 1.0 / float(np.sqrt(in_dim))
            adapters[name] = {"A": prng.uniform(sub, (rank, in_dim), -bound, bound, mesh.device),
                              "B": torch.zeros((out_dim, rank), dtype=torch.float32, device=mesh.device)}
            found.add(name)
        layers.append(adapters)
    missing = set(targets) - found
    if missing:
        raise ValueError(f"lora targets {sorted(missing)} matched no layer weights")
    return {"layers": layers}


def _merged(w, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``w + scale B @ A`` accumulated in f32, in w's dtype (bf16 for a
    quantized w)."""
    from ..models.quant import dequant

    delta = (b.to(torch.float32) @ a.to(torch.float32)) * scale
    if isinstance(w, dict):
        return (dequant(w, torch.bfloat16).to(torch.float32) + delta).to(torch.bfloat16)
    return (w.to(torch.float32) + delta).to(w.dtype)


def merge_lora(params: dict, lora: dict, scale: float, tp: Optional[TrainTP] = None) -> dict:
    """``params`` with every adapted leaf replaced by base + scale B @ A
    (f32 accumulate; the base's dtype, bf16 for quantized bases). ``tp``:
    the params and adapters are a rank's slices, and each replicated factor
    of a split weight enters through Megatron's f."""
    layers = []
    for i, (layer, adapters) in enumerate(zip(params["layers"], lora["layers"])):
        new = dict(layer)
        for name, ab in adapters.items():
            a, b = ab["A"], ab["B"]
            cut = _cut(tp, layer[name], name, i)
            if cut is not None:  # the other factor is whole: it enters the split
                a, b = (tp.splits[i].enter(a), b) if cut[0] == 0 else (a, tp.splits[i].enter(b))
            new[name] = _merged(layer[name], a, b, scale)
        layers.append(new)
    return {**params, "layers": layers}


def _cut(tp: Optional[TrainTP], w, name: str, layer_idx: int):
    """The tensor-parallel cut of adapted weight ``name`` (None: whole);
    only its dimension is read."""
    return None if tp is None else split_of(tp.cfg, tp.plan, name, w, layer_idx)


def _adapter_cuts(tp: Optional[TrainTP], whole_params: dict, lora: dict) -> list:
    """Each adapter leaf's cut (flatten order): B's rows with a
    column-parallel weight, A's columns with a row-parallel one."""
    cuts = []
    for path in tree_flatten(lora)[0]:
        _, i, name, side = path
        w = whole_params["layers"][i][name]
        cut = None if tp is None else split_of(tp.cfg, tp.plan, name, w, i)
        if cut is not None and (cut[0] == 0) != (side == "B"):
            cut = None
        cuts.append(cut)
    return cuts


def make_lora_train_step(mesh, cfg, rank: int, learning_rate: float = 1e-4,
                         targets: Sequence[str] = DEFAULT_LORA_TARGETS, alpha: Optional[float] = None,
                         seed: int = 0, remat: bool = False, tx=None):
    """``(init_state, train_step)`` training only the LoRA factors.

    ``alpha`` defaults to ``rank`` (scale alpha / r = 1); ``tx`` replaces
    adamw(learning_rate). The state holds ``{"params"`` (frozen, this rank's
    slices), ``"lora"``, ``"opt_state"}``; ``train_step(state, (B, T+1)
    global batch) -> (state, f32 loss)``."""
    scale = float(alpha if alpha is not None else rank) / float(rank)
    dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    tp = TrainTP(cfg, mesh.comm("tp")) if mesh.shape.get("tp", 1) > 1 else None
    kit = []

    def init_state(params: dict) -> TrainState:
        if tp is not None and _packed(params):  # int4 row slices need an even local K
            tp.replan(quant_bits=4)
        lora = lora_init(mesh, params, rank, targets=targets, seed=seed)
        shapes = [tuple(v.shape) for v in tree_flatten(params)[1]]
        layout = _Layout(mesh, lora, _adapter_cuts(tp, params, lora), trained="lora",
                         base=(shapes, base_cuts(cfg, tp.plan if tp is not None else None, params)))
        local = tree_unflatten(lora, [layout.slice_tp(i, v) for i, v in enumerate(tree_flatten(lora)[1])])
        base = shard_params(params, cfg, tp.plan) if tp is not None else params
        kit[:] = [_OptimKit(layout, learning_rate, False, tx)]
        state = kit[0].init(local)
        out = TrainState(params=_to(base, mesh.device), lora=state["lora"], opt_state=state["opt_state"])
        out.layout = layout
        return out

    def train_step(state: TrainState, batch):
        opt = kit[0]
        batch = torch.as_tensor(batch).to(mesh.device)
        _, leaves = tree_flatten(state["lora"])
        leaves = [v.detach().requires_grad_(True) for v in leaves]
        merged = merge_lora(state["params"], tree_unflatten(state["lora"], leaves), scale, tp)
        loss = _loss_fn(merged, cfg, _local_rows(batch, 0, 1, dp, d), remat, tp)
        grads = list(torch.autograd.grad(loss, leaves))
        grads = _dp_mean(opt.layout.dp_comm, grads, dp)
        loss = loss.detach()
        if dp > 1:
            loss = opt.layout.dp_comm.all_reduce(loss.to(torch.float32)) / dp
        del leaves, merged
        return opt.apply(state, grads), loss

    return init_state, train_step


def _packed(params: dict) -> bool:
    return any(v.dtype == torch.uint8 for v in tree_flatten(params)[1])


def _to(tree, device):
    return tree_unflatten(tree, [v.to(device) for v in tree_flatten(tree)[1]])


def lora_to_peft(lora: dict, output_dir, rank: int, alpha: float, base_model: str = "") -> dict:
    """Write whole adapters as a PEFT adapter directory (the layout
    tools/fuse_lora.py reads; keys ``base_model.model.model.layers.{i}.
    self_attn|mlp.<proj>.lora_A|B.weight``, f32).

    ``alpha`` is required and must be the training alpha (``rank`` when it
    was left defaulted): fuse_lora and PEFT scale by alpha / r at load, so
    another alpha would silently rescale the adapter."""
    from ..io.safetensors_io import save_file

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    tensors = {}
    modules = set()
    for i, adapters in enumerate(lora["layers"]):
        for name, ab in adapters.items():
            module = _HF_MODULE.get(name)
            if module is None:
                raise ValueError(f"no HF module mapping for adapted leaf {name!r}")
            stem = f"base_model.model.model.layers.{i}.{module}"
            tensors[f"{stem}.lora_A.weight"] = ab["A"].detach().to("cpu", torch.float32).contiguous()
            tensors[f"{stem}.lora_B.weight"] = ab["B"].detach().to("cpu", torch.float32).contiguous()
            modules.add(name)
    save_file(tensors, output_dir / "adapter_model.safetensors")
    config = {
        "peft_type": "LORA",
        "r": int(rank),
        "lora_alpha": float(alpha),
        "lora_dropout": 0.0,
        "target_modules": sorted(modules),
        "base_model_name_or_path": str(base_model),
        "bias": "none",
        "task_type": "CAUSAL_LM",
    }
    (output_dir / "adapter_config.json").write_text(json.dumps(config, indent=2))
    return {"tensors": len(tensors) // 2, "rank": int(rank)}
