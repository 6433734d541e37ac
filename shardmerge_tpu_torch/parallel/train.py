"""Tensor-parallel placement of the decoder params (counterpart of the
placement half of shardmerge_tpu/parallel/train.py: ``loader_shardings``,
``param_shardings``, ``shard_params``, with the divisibility rule of the
JAX loader's ``_StreamShardings._fits``).

Megatron-style over one axis ``"tp"`` of P ranks:

- column-parallel (split on the output rows): ``q_proj``, ``k_proj``,
  ``v_proj``, ``gate_proj``, ``up_proj``, the q/k/v biases and the experts'
  ``w1``/``w3``;
- row-parallel (split on the input columns): ``o_proj``, ``down_proj``,
  ``w2``;
- vocab-parallel: ``embed_tokens`` and ``lm_head``;
- the fused stacks (``gate_up``, ``down`` and their biases) split on the
  expert axis, and replicate when the expert count does not divide P;
- everything else replicates: routers, norms, sinks, MLA's ``q_a``/``kv_a``/
  ``kv_b``/``q_b`` projections, the shared experts.

A quantized ``{"q", "scale"}`` pair splits its ``scale`` with ``q`` when the
rule splits the output axis and replicates it otherwise: a row-parallel
slice keeps the full row's per-channel scale. The JAX package places
GSPMD shardings and lets XLA insert the collectives; the port hands each
rank explicit slices (:func:`shard_params`) and its model modules run the
collectives (models/llama.py). Where GSPMD would cut a tensor mid-head,
the port keeps head boundaries (:func:`plan`):

- attention is head-parallel when the query heads divide P and each rank's
  query heads read whole KV heads of their own: KVH % P == 0 (each rank its
  KVH/P KV heads), or a rank's H/P query heads all read one KV head (that
  head is then held by every rank whose queries read it: ChatGLM's 2 KV heads
  at P = 4). Otherwise attention replicates. OLMo-2's full-vector q/k norm
  needs KVH % P == 0 (its statistic is all-reduced over the split vector);
- DeepSeek's latent attention is head-parallel over the replicated latent
  cache when the heads divide P, else replicated;
- a dense MLP, an expert list, a fused stack or the vocab splits when its
  split dimension divides P (an int4 row slice also needs an even local
  reduction), else it replicates: JAX's ``_fits`` rule.

A packed-int4 row slice is re-packed split-half over its own K/P columns
(:func:`repack4_tp_blocked`, JAX's ``_repack4_tp_blocked``): a plain slice of
the packed bytes would hand the rank the low nibbles of one column block and
the high nibbles of another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

__all__ = ["COL", "ROW", "REP", "loader_rules", "param_shardings", "fits", "repack4_tp_blocked", "LayerPlan",
           "Plan", "plan", "shard_leaf", "shard_params", "collectives_per_forward"]

COL = ("tp", None)
ROW = (None, "tp")
REP = ()

# the per-layer rule table (JAX's loader_shardings): anything absent replicates
_LAYER_RULES = {
    "q_proj": COL, "k_proj": COL, "v_proj": COL, "gate_proj": COL, "up_proj": COL,
    "o_proj": ROW, "down_proj": ROW,
    "q_bias": ("tp",), "k_bias": ("tp",), "v_bias": ("tp",),
    "w1": COL, "w3": COL, "w2": ROW,
    "gate_up": ("tp", None, None), "down": ("tp", None, None),
    "gate_up_bias": ("tp", None), "down_bias": ("tp", None),
}
_TOP_RULES = {"embed_tokens": COL, "lm_head": COL}
_STACKS = ("gptoss_experts", "llama4_experts")


def loader_rules():
    """(layer key -> spec, top key -> spec, replicated spec): the rule table
    of JAX's ``loader_shardings``, a spec being the tuple of a
    ``PartitionSpec``'s entries."""
    return dict(_LAYER_RULES), dict(_TOP_RULES), REP


def fits(spec, shape, n_tp: int) -> bool:
    """JAX's ``_StreamShardings._fits``: every split dimension divides P."""
    for dim, name in zip(shape, spec):
        if name is not None and dim % n_tp != 0:
            return False
    return len(spec) <= len(shape)


def param_shardings(params: dict, n_tp: int) -> dict:
    """The spec of every leaf, in the params' structure: JAX's
    ``param_shardings`` (its rules as they stand, without ``_fits``; fused
    stacks whose expert count does not divide P replicate)."""

    def apply(rule, leaf):
        if isinstance(leaf, dict):
            return {"q": rule, "scale": rule if rule and rule[0] == "tp" else REP}
        return rule

    def rep(leaf):
        if isinstance(leaf, dict):
            return {k: rep(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [rep(v) for v in leaf]
        return REP

    def stack_rule(leaf):
        arr = leaf["q3"] if isinstance(leaf, dict) else leaf
        if arr.shape[0] % n_tp != 0:
            return rep(leaf)
        rule = ("tp",) + (None,) * (arr.dim() - 1)
        if isinstance(leaf, dict):
            return {"q3": rule, "scale": ("tp",) + (None,) * (leaf["scale"].dim() - 1)}
        return rule

    def layer_specs(layer):
        out = {}
        for k, v in layer.items():
            if k == "experts":
                out[k] = [{w: apply(_LAYER_RULES[w], e[w]) for w in ("w1", "w3", "w2")} for e in v]
            elif k in _STACKS:
                out[k] = {w: stack_rule(leaf) for w, leaf in v.items()}
            elif k in _LAYER_RULES:
                out[k] = apply(_LAYER_RULES[k], v)
            else:
                out[k] = rep(v)
        return out

    out = {"embed_tokens": apply(COL, params["embed_tokens"]), "norm": REP,
           "layers": [layer_specs(layer) for layer in params["layers"]]}
    if "lm_head" in params:
        out["lm_head"] = apply(COL, params["lm_head"])
    return out


def repack4_tp_blocked(q: torch.Tensor, n_tp: int) -> torch.Tensor:
    """Permute split-half int4 bytes packed over the full K (the last axis)
    into ``n_tp`` contiguous blocks, each split-half packed over its own
    K/n_tp columns (JAX's ``_repack4_tp_blocked``): a pure nibble
    permutation, values stay in [0, 15]."""
    k = 2 * q.shape[-1]
    if (k // n_tp) % 2:
        raise ValueError(f"int4 row-parallel reduction dim {k} must split into even per-device blocks under tp={n_tp}")
    nib = torch.cat([q & 0xF, q >> 4], dim=-1)  # full-K column order
    bh = k // n_tp // 2
    blocks = [nib[..., r * 2 * bh:(r + 1) * 2 * bh] for r in range(n_tp)]
    return torch.cat([b[..., :bh] | (b[..., bh:] << 4) for b in blocks], dim=-1).to(torch.uint8)


@dataclass(frozen=True)
class LayerPlan:
    """One layer's split on one rank: the query heads ``heads`` [h0, h1) and
    the KV heads ``kv_heads`` [k0, k1) it computes (None: attention
    replicated), whether its dense MLP and its expert lists split, and the
    fused stacks' local experts [e0, e1) (None: replicated)."""

    heads: Optional[Tuple[int, int]]
    kv_heads: Optional[Tuple[int, int]]
    mlp: bool
    experts: bool
    stacks: Optional[Tuple[int, int]]


@dataclass(frozen=True)
class Plan:
    """A rank's tensor-parallel placement: its rank and the group's size,
    the vocab rows [v0, v1) it holds (None: replicated) and each layer's
    :class:`LayerPlan`."""

    rank: int
    size: int
    vocab: Optional[Tuple[int, int]]
    layers: Tuple[LayerPlan, ...]


def _block(n: int, rank: int, size: int) -> Tuple[int, int]:
    return rank * n // size, (rank + 1) * n // size


def plan(cfg, rank: int, size: int, quant_bits: Optional[int] = None) -> Plan:
    """Rank ``rank``'s placement of ``cfg`` over ``size`` ranks (the rules of
    the module docstring): a leaf splits where its rule :func:`fits` its
    shape, with head boundaries kept. ``quant_bits=4`` asks of every row
    slice an even local reduction (the split-half packing)."""
    H, KVH, h = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hidden_size

    def fit(key: str, shape) -> bool:
        rule = _LAYER_RULES.get(key) or _TOP_RULES[key]
        if size == 1 or not fits(rule, shape, size):
            return False
        return not (rule == ROW and quant_bits == 4 and (shape[1] // size) % 2)

    heads = kv_heads = None
    if H % size == 0:
        h0, h1 = _block(H, rank, size)
        if cfg.is_mla:
            if fit("o_proj", (h, H * cfg.v_head_dim)):
                heads = (h0, h1)
        elif fit("q_proj", (H * cfg.head_dim, h)) and fit("o_proj", (h, H * cfg.head_dim)):
            group = H // KVH
            if KVH % size == 0:
                heads, kv_heads = (h0, h1), _block(KVH, rank, size)
            elif group % (H // size) == 0 and not cfg.qk_norm_full:
                heads, kv_heads = (h0, h1), (h0 // group, h0 // group + 1)
    inter = cfg.intermediate_size_mlp or cfg.intermediate_size  # Llama-4's dense layers are the wider
    inter_moe = cfg.moe_intermediate_size or cfg.intermediate_size
    lp = LayerPlan(
        heads=heads, kv_heads=kv_heads,
        mlp=fit("gate_proj", (inter, h)) and fit("down_proj", (h, inter)),
        experts=fit("w1", (inter_moe, h)) and fit("w2", (h, inter_moe)),
        stacks=_block(cfg.num_local_experts, rank, size)
        if cfg.num_local_experts and fit("gate_up", (cfg.num_local_experts, h, 2 * inter_moe)) else None)
    vocab = _block(cfg.vocab_size, rank, size) if fit("embed_tokens", (cfg.vocab_size, h)) else None
    return Plan(rank=rank, size=size, vocab=vocab, layers=(lp,) * cfg.num_hidden_layers)


def _rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return t[lo:hi].clone()


def _cols(q: torch.Tensor, c0: int, c1: int, packed: bool) -> torch.Tensor:
    """Columns [c0, c1) of a weight: of the split-half packed bytes, the
    nibbles of those columns re-packed split-half over the slice."""
    if not packed:
        return q[:, c0:c1].clone()
    nib = torch.cat([q & 0xF, q >> 4], dim=1)[:, c0:c1]
    h = (c1 - c0) // 2
    return (nib[:, :h] | (nib[:, h:] << 4)).to(torch.uint8)


def _out_rows(leaf, lo: int, hi: int):
    """Output rows [lo, hi) of a raw or quantized (out, in) weight; a
    quantized scale (out, 1) goes with them."""
    if isinstance(leaf, dict):
        return {"q": _rows(leaf["q"], lo, hi), "scale": _rows(leaf["scale"], lo, hi)}
    return _rows(leaf, lo, hi)


def _in_cols(leaf, lo: int, hi: int):
    """Input columns [lo, hi) of a raw or quantized (out, in) weight; the
    scale stays whole (the full row's)."""
    if isinstance(leaf, dict):
        q = leaf["q"]
        return {"q": _cols(q, lo, hi, q.dtype == torch.uint8), "scale": leaf["scale"]}
    return leaf[:, lo:hi].clone()


def _stack_experts(leaf, e0: int, e1: int):
    if isinstance(leaf, dict):
        return {k: v[e0:e1].clone() for k, v in leaf.items()}
    return leaf[e0:e1].clone()


def shard_leaf(cfg, pl: Plan, key: str, leaf, layer_idx: Optional[int] = None, stack: Optional[str] = None):
    """This rank's slice of one leaf (raw tensor or quantized dict): ``key``
    a top-level name (``layer_idx`` None), a layer's key, an expert's
    ``w1``/``w3``/``w2``, or with ``stack`` a fused stack's key. Leaves the
    rank holds whole come back as they are."""
    if layer_idx is None:
        if key in _TOP_RULES and pl.vocab is not None:
            return _out_rows(leaf, *pl.vocab)
        return leaf
    lp = pl.layers[layer_idx]
    if stack is not None:
        return leaf if lp.stacks is None else _stack_experts(leaf, *lp.stacks)
    D = cfg.head_dim
    if lp.heads is not None:
        h0, h1 = lp.heads
        if cfg.is_mla:
            if key == "q_proj":
                return _out_rows(leaf, h0 * cfg.qk_head_dim, h1 * cfg.qk_head_dim)
            if key == "o_proj":
                return _in_cols(leaf, h0 * cfg.v_head_dim, h1 * cfg.v_head_dim)
        else:
            k0, k1 = lp.kv_heads
            if key in ("q_proj", "q_bias"):
                return _out_rows(leaf, h0 * D, h1 * D)
            if key in ("k_proj", "v_proj", "k_bias", "v_bias"):
                return _out_rows(leaf, k0 * D, k1 * D)
            if key == "o_proj":
                return _in_cols(leaf, h0 * D, h1 * D)
    if (lp.mlp and key in ("gate_proj", "up_proj", "down_proj")) or (lp.experts and key in ("w1", "w3", "w2")):
        if key in ("down_proj", "w2"):
            return _in_cols(leaf, *_block(_in_dim(leaf), pl.rank, pl.size))
        return _out_rows(leaf, *_block(_out_dim(leaf), pl.rank, pl.size))
    return leaf


def _out_dim(leaf) -> int:
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[0]


def _in_dim(leaf) -> int:
    """The reduction dimension K of a raw or quantized weight (twice the
    packed bytes of an int4 row)."""
    if isinstance(leaf, dict):
        q = leaf["q"]
        return q.shape[1] * (2 if q.dtype == torch.uint8 else 1)
    return leaf.shape[1]


def shard_params(params: dict, cfg, pl: Plan) -> dict:
    """This rank's params: every leaf through :func:`shard_leaf`."""
    out = {k: shard_leaf(cfg, pl, k, v) for k, v in params.items() if k != "layers"}
    layers: List[dict] = []
    for i, layer in enumerate(params["layers"]):
        mine = {}
        for k, v in layer.items():
            if k == "experts":
                mine[k] = [{w: shard_leaf(cfg, pl, w, e[w], i) for w in e} for e in v]
            elif k in _STACKS:
                mine[k] = {w: shard_leaf(cfg, pl, w, leaf, i, stack=k) for w, leaf in v.items()}
            else:
                mine[k] = shard_leaf(cfg, pl, k, v, i)
        layers.append(mine)
    out["layers"] = layers
    return out


def collectives_per_forward(cfg, pl: Plan) -> dict:
    """The collectives one forward of the sharded model runs on every rank:
    ``all_reduce`` (the embedding's, one after each split attention and
    each split MLP / expert block, OLMo-2's two norm statistics a split
    attention) and ``all_gather`` (the vocab-parallel logits)."""
    reduces = 1 if pl.vocab is not None else 0
    for i, lp in enumerate(pl.layers):
        if lp.heads is not None:
            reduces += 3 if cfg.qk_norm_full else 1
        if cfg.model_type == "gpt_oss" or (cfg.model_type == "llama4_text" and cfg.layer_is_moe(i)):
            reduces += lp.stacks is not None
        elif cfg.layer_has_experts(i):
            reduces += lp.experts
        else:
            reduces += lp.mlp
    return {"all_reduce": reduces, "all_gather": 1 if pl.vocab is not None else 0}
