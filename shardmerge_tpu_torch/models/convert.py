"""Carry the JAX engine's weights into the port.

``params_from_jax`` takes the JAX param pytree with every leaf already a
numpy array (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side:
raw arrays, and ``{"q", "scale"}`` dicts for quantized weights; a MoE
layer's ``experts`` list of ``{"w1", "w3", "w2"}`` dicts; GPT-OSS's
``sinks``, ``o_bias``, ``moe_gate_bias`` and ``gptoss_experts`` and
Llama-4's ``llama4_experts`` dicts, their stacks raw or ``{"q3", "scale"}``)
and returns the
port's params dict on ``device``, ready for ``LlamaModel``. bfloat16 arrays
(ml_dtypes) come across bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


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
