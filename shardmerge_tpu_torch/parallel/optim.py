"""The optax pieces the JAX package trains with, in torch (counterpart of
what shardmerge_tpu/parallel/train.py and lora.py ask of ``optax``).

A transformation is an (``init``, ``update``) pair over a LIST of tensors
(the train step's leaves in flatten order, or their ZeRO-1 shards), with
optax's semantics:

- ``scale_by_adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``
  in the leaves' dtype; the count is incremented first and the bias
  corrections ``1 - b**count`` are f32, cast to each moment's dtype before
  the division; ``mu_hat / (sqrt(nu_hat) + eps)``, eps outside the root;
- ``add_decayed_weights``: ``u + wd p``;
- ``scale_by_learning_rate``: ``-lr u``, or with a schedule ``-lr(count) u``
  at the count BEFORE its increment (the first step takes ``lr(0)``);
- ``adamw`` = chain of the three (b1 0.9, b2 0.999, eps 1e-8, weight decay
  1e-4: optax's default, not torch's 1e-2);
- ``clip_by_global_norm``: ``u / |g| * max_norm`` when the global norm
  reaches ``max_norm``;
- ``chain``, ``cosine_decay_schedule``, ``apply_updates``.

``torch.optim.AdamW`` is not used: its order of operations and its default
decay differ. The states mirror optax's nesting so a JAX state carries
across (models/convert.py ``train_state_from_jax``): a chain is a list of
its members' states, Adam's ``{"count", "mu", "nu"}``, a schedule's
``{"count"}``, a stateless member's ``{}``.

``update(updates, state, params, sumsq)``: ``sumsq(tensors)`` returns the
squared global norm of sharded updates (the train step's reduction across
ranks); None sums the tensors given. ``update`` consumes the ``updates``
list and the lists of the state it is given, as the JAX step donates its
state: it replaces their items as it goes (a tensor is never written in
place), so the step holds one copy of the moments and one of the updates,
not two.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Union

import torch

__all__ = ["GradientTransformation", "scale_by_adam", "add_decayed_weights", "scale_by_learning_rate", "adamw",
           "clip_by_global_norm", "chain", "cosine_decay_schedule", "apply_updates", "local_sumsq"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def local_sumsq(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The squared L2 norm of ``tensors`` together, in f32."""
    total = torch.zeros((), dtype=torch.float32, device=tensors[0].device if tensors else None)
    for t in tensors:
        total = total + t.to(torch.float32).square().sum()
    return total


def _count(device=None) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device(tensors):
    return tensors[0].device if tensors else None


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": _count(_device(params)), "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None, sumsq=None):
        mu, nu = state["mu"], state["nu"]
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=c.device) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=c.device) ** c
        for i, g in enumerate(updates):
            m = (1 - b1) * g + b1 * mu[i]
            v = (1 - b2) * (g * g) + b2 * nu[i]
            mu[i], nu[i] = m, v
            updates[i] = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None, sumsq=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        for i, p in enumerate(params):
            updates[i] = updates[i] + weight_decay * p
        return updates, state

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> GradientTransformation:
    if not callable(learning_rate):
        def update(updates, state, params=None, sumsq=None):
            for i, u in enumerate(updates):
                updates[i] = u * -learning_rate
            return updates, state

        return GradientTransformation(lambda params: {}, update)

    def init(params):
        return {"count": _count(_device(params))}

    def update_s(updates, state, params=None, sumsq=None):
        step = -learning_rate(state["count"])
        for i, u in enumerate(updates):
            updates[i] = step.to(u.dtype) * u
        return updates, {"count": state["count"] + 1}

    return GradientTransformation(init, update_s)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(updates, state, params=None, sumsq=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params, sumsq)
            new.append(s)
        return updates, new

    return GradientTransformation(init, update)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None, sumsq=None):
        norm = torch.sqrt((sumsq or local_sumsq)(updates))
        keep = norm < max_norm  # a select on the device, as optax's: no host sync
        for i, u in enumerate(updates):
            updates[i] = torch.where(keep, u, (u / norm.to(u.dtype)) * max_norm)
        return updates, state

    return GradientTransformation(lambda params: {}, update)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """optax's cosine decay of ``init_value`` to ``alpha * init_value`` over
    ``decay_steps``, evaluated in f32 at an int count tensor."""
    if decay_steps <= 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps!")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, max=decay_steps).to(torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def apply_updates(params: List[torch.Tensor], updates: List[torch.Tensor]) -> List[torch.Tensor]:
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]
