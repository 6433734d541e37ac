"""Carry the JAX engine's weights, and a JAX train state, into the port.

``params_from_jax`` takes the JAX param pytree with every leaf already a
numpy array (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side:
raw arrays, and ``{"q", "scale"}`` dicts for quantized weights; a MoE
layer's ``experts`` list of ``{"w1", "w3", "w2"}`` dicts; GPT-OSS's
``sinks``, ``o_bias``, ``moe_gate_bias`` and ``gptoss_experts`` and
Llama-4's ``llama4_experts`` dicts, their stacks raw or ``{"q3", "scale"}``)
and returns the
port's params dict on ``device``, ready for ``LlamaModel``. bfloat16 arrays
(ml_dtypes) come across bit for bit.

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

__all__ = ["params_from_jax", "train_state_from_jax"]


def _tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(params_np, device="cpu"):
    """Convert a numpy-leaved JAX param pytree (dicts, lists, arrays)."""
    if isinstance(params_np, dict):
        return {k: params_from_jax(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [params_from_jax(v, device) for v in params_np]
    return _tensor(params_np, device)


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


def train_state_from_jax(state_np, template):
    """The port's train state with a JAX state's values (see the module
    docstring), placed as ``template``'s."""
    from ..parallel.checkpoint import place_state

    tensors: dict = {}
    for key, value in state_np.items():
        _named(value, key, tensors, "cpu")
    return place_state(template, tensors, source="JAX state")
