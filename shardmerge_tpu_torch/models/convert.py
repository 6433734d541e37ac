"""Carry the JAX engine's weights, and a JAX train state, into the port.

``params_from_jax`` takes the JAX param pytree with every leaf already a
numpy array (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side:
raw arrays, and ``{"q", "scale"}`` dicts for quantized weights; a MoE
layer's ``experts`` list of ``{"w1", "w3", "w2"}`` dicts; GPT-OSS's
``sinks``, ``o_bias``, ``moe_gate_bias`` and ``gptoss_experts`` and
Llama-4's ``llama4_experts`` dicts, their stacks raw or ``{"q3", "scale"}``;
a layer's ``experts_stacked`` (W1, W3, W2) tuple of ``stack_expert_weights``,
kept a tuple) and returns the
port's params dict on ``device``, ready for ``LlamaModel``. bfloat16 arrays
(ml_dtypes) come across bit for bit.

Both also take the tree JAX's pipeline ``stack_stages`` returns (and a
pipeline train state, or its gradients, over it): the ``blocks`` leaves
(stages, layers per stage, ...) un-stacked into layers, ``experts_stacked``
back into per-expert ``{"w1", "w3", "w2"}`` lists, ``period_slots``
interleaved back into layer order, ``prefix_blocks`` put first. A tree
stacked with ``tp=True`` also has its placement undone given ``n_tp``: the
int4 row-parallel buffers' tp-blocked repack, GPT-OSS's ``down_bias``
pre-scaled by 1/n_tp and Llama-4's gate/up column permutation. The result
is the unpipelined tree, which the port's own ``stack_stages`` cuts.

``train_state_from_jax`` takes a JAX train state with numpy leaves (the
dict of ``make_train_step``'s ``init_state`` or a later step: ``params``,
the optax state with its NamedTuples kept, ``master``) and a port template
state (an ``init_state`` of the port's train step) and returns the port's
state holding the JAX values, each placed as the template's leaves are:
optax's Adam ``count``/``mu``/``nu`` and schedule counts map onto the port's
optimizer state (parallel/optim.py), which nests as optax's does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "train_state_from_jax", "unstack_stages"]


def _tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(params_np, device="cpu", n_tp: int = 1):
    """Convert a numpy-leaved JAX param pytree (dicts, lists, arrays); a
    pipeline-stacked one becomes the unpipelined tree (``n_tp``: the tp its
    stages were stacked for)."""
    if isinstance(params_np, dict) and "blocks" in params_np:
        params_np = unstack_stages(params_np, n_tp)
    if isinstance(params_np, dict):
        return {k: params_from_jax(v, device) for k, v in params_np.items()}
    if isinstance(params_np, tuple):  # experts_stacked (W1, W3, W2) of stack_expert_weights
        return tuple(params_from_jax(v, device) for v in params_np)
    if isinstance(params_np, list):
        return [params_from_jax(v, device) for v in params_np]
    return _tensor(params_np, device)


_TP_ROW = ("o_proj", "down_proj", "shared_down_proj")


def _unpack4_tp_blocked(q: np.ndarray, n_tp: int, axis: int) -> np.ndarray:
    """The inverse of JAX's ``_repack4_tp_blocked`` on ``axis``
    (parallel/train.py ``unpack4_tp_blocked``)."""
    from ..parallel.train import unpack4_tp_blocked

    last = torch.from_numpy(np.array(np.moveaxis(q, axis, -1), order="C"))
    return np.moveaxis(unpack4_tp_blocked(last, n_tp).numpy(), -1, axis)


def _untp(run: dict, n_tp: int) -> dict:
    """Undo the tp stacking's placement of one stacked run (leaves
    (S, per, ...)): row-parallel int4 repacks, GPT-OSS's scaled down_bias,
    Llama-4's gate/up permutation."""
    run = dict(run)
    for k in _TP_ROW:
        w = run.get(k)
        if isinstance(w, dict) and w["q"].dtype == np.uint8:
            run[k] = {**w, "q": _unpack4_tp_blocked(w["q"], n_tp, -1)}
    if "experts_stacked" in run:
        w1, w3, w2 = run["experts_stacked"]
        if isinstance(w2, dict) and w2["q"].dtype == np.uint8:
            w2 = {**w2, "q": _unpack4_tp_blocked(w2["q"], n_tp, -1)}
        run["experts_stacked"] = (w1, w3, w2)
    for k in ("gptoss_experts", "llama4_experts"):
        if k not in run:
            continue
        e = dict(run[k])
        down = e["down"]
        if isinstance(down, dict) and down["q3"].dtype == np.uint8:
            e["down"] = {**down, "q3": _unpack4_tp_blocked(down["q3"], n_tp, down["q3"].ndim - 2)}
        if k == "gptoss_experts":
            e["down_bias"] = np.asarray(e["down_bias"]) * np.asarray(n_tp, np.asarray(e["down_bias"]).dtype)
        else:
            gu = e["gate_up"]
            width = (gu["q3"] if isinstance(gu, dict) else gu).shape[-1]
            inter, blk = width // 2, width // 2 // n_tp
            perm = np.concatenate([np.concatenate([np.arange(r * blk, (r + 1) * blk),
                                                   inter + np.arange(r * blk, (r + 1) * blk)]) for r in range(n_tp)])
            inv = np.argsort(perm)
            e["gate_up"] = {f: v[..., inv] for f, v in gu.items()} if isinstance(gu, dict) else gu[..., inv]
        run[k] = e
    return run


def _unstack_run(run: dict, n_tp: int) -> list:
    """One stacked run's layers in order (stage-major)."""
    from ..parallel.train import tree_flatten

    if n_tp > 1:
        run = _untp(run, n_tp)
    S, per = tree_flatten(run)[1][0].shape[:2]

    def at(node, s, i):
        if isinstance(node, dict):
            return {k: at(v, s, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [at(v, s, i) for v in node]
        return np.asarray(node)[s, i]

    layers = []
    for s in range(S):
        for i in range(per):
            layer = {k: at(v, s, i) for k, v in run.items() if k != "experts_stacked"}
            if "experts_stacked" in run:
                w = [at(x, s, i) for x in run["experts_stacked"]]
                first = w[0]["q"] if isinstance(w[0], dict) else w[0]

                def pick(x, e):
                    return {f: v[e] for f, v in x.items()} if isinstance(x, dict) else x[e]

                layer["experts"] = [{"w1": pick(w[0], e), "w3": pick(w[1], e), "w2": pick(w[2], e)}
                                    for e in range(first.shape[0])]
            layers.append(layer)
    return layers


def unstack_stages(tree: dict, n_tp: int = 1) -> dict:
    """JAX's ``stack_stages`` tree (numpy leaves) -> the unpipelined params
    tree, still numpy (see the module docstring)."""
    blocks = tree["blocks"]
    if "period_slots" in blocks:
        slots = [_unstack_run(run, n_tp) for run in blocks["period_slots"]]
        p = len(slots)
        layers = [slots[i % p][i // p] for i in range(p * len(slots[0]))]
    else:
        layers = _unstack_run(blocks, n_tp)
    out = {k: v for k, v in tree.items() if k not in ("blocks", "prefix_blocks")}
    out["layers"] = list(tree.get("prefix_blocks", [])) + layers
    return out


def _named(node, prefix: str, out: dict, device) -> None:
    """Every leaf of a numpy-leaved JAX state under its checkpoint name
    (parallel/checkpoint.py): NamedTuples by field, dicts by key, sequences
    by index."""
    if hasattr(node, "_fields"):
        for f in node._fields:
            _named(getattr(node, f), f"{prefix}/{f}", out, device)
    elif isinstance(node, dict):
        for k, v in node.items():
            _named(v, f"{prefix}/{k}", out, device)
    elif isinstance(node, (list, tuple)):
        for j, v in enumerate(node):
            _named(v, f"{prefix}/{j}", out, device)
    else:
        out[prefix] = _tensor(node, device)


def _unpipelined(node, n_tp: int):
    """``node`` with every pipeline-stacked params tree in it un-stacked."""
    if isinstance(node, dict) and "blocks" in node:
        return unstack_stages(node, n_tp)
    if hasattr(node, "_fields"):
        return type(node)(*(_unpipelined(getattr(node, f), n_tp) for f in node._fields))
    if isinstance(node, dict):
        return {k: _unpipelined(v, n_tp) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_unpipelined(v, n_tp) for v in node)
    return node


def train_state_from_jax(state_np, template, n_tp: int = 1):
    """The port's train state with a JAX state's values (see the module
    docstring), placed as ``template``'s; a pipeline state's stacked trees
    are un-stacked first (``n_tp`` as for :func:`params_from_jax`)."""
    from ..parallel.checkpoint import place_state

    tensors: dict = {}
    for key, value in _unpipelined(state_np, n_tp).items():
        _named(value, key, tensors, "cpu")
    return place_state(template, tensors, source="JAX state")
