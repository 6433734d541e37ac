"""Token sampling (counterpart of shardmerge_tpu/models/sampling.py).

HF order: repetition penalty -> temperature -> top-k -> top-p, then a draw
from an explicit ``torch.Generator``. ``greedy=True`` takes the argmax of
the penalized logits. Sampled tokens cannot match ``jax.random``'s; greedy
tokens match the JAX engine's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["sample_token"]

Param = Union[float, torch.Tensor]


def sample_token(
    logits: torch.Tensor,  # (B, V) f32
    generated_mask: torch.Tensor,  # (B, V) bool: tokens already produced
    temperature: Param = 1.0,
    top_k: int = 0,
    top_p: Param = 1.0,
    repetition_penalty: Param = 1.0,
    *,
    greedy: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Next token ids (B,) as int64. ``temperature``, ``top_p`` and
    ``repetition_penalty`` are floats or f32 tensors that broadcast against
    (B, 1) (one value per row, as the continuous pool passes them);
    ``top_k`` is one int for the batch."""
    penalized = torch.where(
        logits > 0, logits / repetition_penalty, logits * repetition_penalty
    )
    logits = torch.where(generated_mask, penalized, logits)
    if greedy:
        return torch.argmax(logits, dim=-1)

    if isinstance(temperature, torch.Tensor):
        logits = logits / torch.clamp_min(temperature, 1e-6)
    else:
        logits = logits / max(temperature, 1e-6)
    neg_inf = torch.full((), float("-inf"), dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)

    # top-p: keep tokens until the cumulative probability exceeds top_p
    # (the most likely token is always kept)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = cumprobs - sorted_probs < top_p
    inf = torch.full((), float("inf"), dtype=logits.dtype, device=logits.device)
    threshold = torch.where(keep_sorted, sorted_logits, inf).min(dim=-1, keepdim=True).values
    logits = torch.where(logits < threshold, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
