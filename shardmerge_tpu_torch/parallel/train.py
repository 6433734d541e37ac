"""Tensor-parallel placement of the decoder params, the (dp, tp) train step
and the (dp, cp, tp) one of context parallelism (counterpart of
shardmerge_tpu/parallel/train.py: ``loader_shardings``, ``param_shardings``,
``shard_params``, with the divisibility rule of the JAX loader's
``_StreamShardings._fits``; ``_loss_fn``, ``_OptimKit``,
``make_train_step``, ``make_cp_loss``, ``make_cp_train_step``).

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

import dataclasses
from collections.abc import Mapping
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["COL", "ROW", "REP", "loader_rules", "param_shardings", "fits", "repack4_tp_blocked", "LayerPlan",
           "Plan", "plan", "split_of", "shard_leaf", "shard_layer", "shard_params", "collectives_per_forward", "train_plan",
           "TrainTP", "TrainState", "tree_flatten", "tree_unflatten", "_loss_fn", "make_train_step",
           "make_pp_train_step", "base_cuts", "unpack4_tp_blocked", "make_cp_loss", "make_cp_train_step",
           "data_step"]

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


def split_of(cfg, pl: Plan, key: str, leaf, layer_idx: Optional[int] = None, stack: Optional[str] = None):
    """The part of one leaf this rank holds, as ``(dim, lo, hi)`` of the
    whole (unpacked) leaf: rows (dim 0) or input columns (dim 1), or the
    experts of a fused stack (dim 0); None when the rank holds it whole.
    ``key``, ``layer_idx`` and ``stack`` as for :func:`shard_leaf`."""
    if layer_idx is None:
        return (0, *pl.vocab) if key in _TOP_RULES and pl.vocab is not None else None
    lp = pl.layers[layer_idx]
    if stack is not None:
        return None if lp.stacks is None else (0, *lp.stacks)
    D = cfg.head_dim
    if lp.heads is not None:
        h0, h1 = lp.heads
        if cfg.is_mla:
            if key == "q_proj":
                return (0, h0 * cfg.qk_head_dim, h1 * cfg.qk_head_dim)
            if key == "o_proj":
                return (1, h0 * cfg.v_head_dim, h1 * cfg.v_head_dim)
        else:
            k0, k1 = lp.kv_heads
            if key in ("q_proj", "q_bias"):
                return (0, h0 * D, h1 * D)
            if key in ("k_proj", "v_proj", "k_bias", "v_bias"):
                return (0, k0 * D, k1 * D)
            if key == "o_proj":
                return (1, h0 * D, h1 * D)
    if (lp.mlp and key in ("gate_proj", "up_proj", "down_proj")) or (lp.experts and key in ("w1", "w3", "w2")):
        if key in ("down_proj", "w2"):
            return (1, *_block(_in_dim(leaf), pl.rank, pl.size))
        return (0, *_block(_out_dim(leaf), pl.rank, pl.size))
    return None


def shard_leaf(cfg, pl: Plan, key: str, leaf, layer_idx: Optional[int] = None, stack: Optional[str] = None):
    """This rank's slice of one leaf (raw tensor or quantized dict): ``key``
    a top-level name (``layer_idx`` None), a layer's key, an expert's
    ``w1``/``w3``/``w2``, or with ``stack`` a fused stack's key. Leaves the
    rank holds whole come back as they are."""
    cut = split_of(cfg, pl, key, leaf, layer_idx, stack)
    if cut is None:
        return leaf
    dim, lo, hi = cut
    if stack is not None:
        return _stack_experts(leaf, lo, hi)
    return _out_rows(leaf, lo, hi) if dim == 0 else _in_cols(leaf, lo, hi)


def _out_dim(leaf) -> int:
    return (leaf["q"] if isinstance(leaf, dict) else leaf).shape[0]


def _in_dim(leaf) -> int:
    """The reduction dimension K of a raw or quantized weight (twice the
    packed bytes of an int4 row)."""
    if isinstance(leaf, dict):
        q = leaf["q"]
        return q.shape[1] * (2 if q.dtype == torch.uint8 else 1)
    return leaf.shape[1]


def shard_layer(cfg, pl: Plan, layer: dict, i: int) -> dict:
    """This rank's slices of layer ``i``: every leaf through :func:`shard_leaf`."""
    mine = {}
    for k, v in layer.items():
        if k == "experts":
            mine[k] = [{w: shard_leaf(cfg, pl, w, e[w], i) for w in e} for e in v]
        elif k in _STACKS:
            mine[k] = {w: shard_leaf(cfg, pl, w, leaf, i, stack=k) for w, leaf in v.items()}
        else:
            mine[k] = shard_leaf(cfg, pl, k, v, i)
    return mine


def shard_params(params: dict, cfg, pl: Plan) -> dict:
    """This rank's params: every leaf through :func:`shard_leaf`."""
    out = {k: shard_leaf(cfg, pl, k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [shard_layer(cfg, pl, layer, i) for i, layer in enumerate(params["layers"])]
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


# ---------------------------------------------------------------------------
# Training over a (dp, tp) mesh
# ---------------------------------------------------------------------------
#
# JAX jits one step over the global batch and lets GSPMD place everything.
# The port runs one process a rank (parallel/mesh.py) and does by hand what
# GSPMD derives:
#
# - dp: each rank takes its rows of every (micro)batch; the gradients are
#   summed over the dp group in f32 and divided by dp (mean of the ranks'
#   means); the loss likewise;
# - tp: the serving placement (``plan``) with the embedding and the lm_head
#   replicated (``train_plan``: JAX's manual cp path replicates them too);
#   the model runs Megatron's f/g operators (models/llama.py ``split``):
#   :class:`_Enter` before each split product, :class:`_Reduce` after
#   o_proj and down_proj, :class:`_Share` for replicated terms of a partial
#   sum. Every replicated leaf then gets the same gradient on every tp rank
#   and the leaves stay equal without a gradient collective;
# - zero1: each dp rank keeps 1/dp of every moment (and of the f32 master):
#   the flattened gradients are reduce-scattered, each rank updates its
#   chunk, and the updated chunks are all-gathered;
# - fsdp: the parameters themselves are kept as those chunks and each is
#   all-gathered at its use (:class:`_Gather`, whose backward
#   reduce-scatters the gradient), again at a remat recompute.
#
# Every collective sums in rank order (parallel/comm.py), so replicated
# values are the same bits on every rank.


def train_plan(cfg, rank: int, size: int, quant_bits: Optional[int] = None) -> Plan:
    """The training placement: :func:`plan` with the vocab replicated, and
    attention replicated where a KV head would be held by several ranks
    (KVH % P != 0: its copies would get different gradients)."""
    pl = plan(cfg, rank, size, quant_bits)
    layers = pl.layers
    if not cfg.is_mla and cfg.num_key_value_heads % size:
        layers = tuple(dataclasses.replace(lp, heads=None, kv_heads=None) for lp in layers)
    return dataclasses.replace(pl, vocab=None, layers=layers)


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over tp."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_sum(g, torch.float32), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: the partial sums summed over tp, the gradient passed."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sum(x, torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    """A sum over tp consumed by split computations: summed both ways."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_sum(x, torch.float32)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_sum(g, torch.float32), None


class _Share(torch.autograd.Function):
    """A replicated term of a partial sum: rank 0's value, zeros elsewhere;
    the gradient passed on every rank."""

    @staticmethod
    def forward(ctx, x, first):
        return x.view_as(x) if first else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class LayerSplit:
    """One layer's tensor-parallel view for models/llama.py: the
    :class:`LayerPlan` fields and the f / share / psum operators."""

    def __init__(self, lp: LayerPlan, comm):
        self.heads, self.kv_heads = lp.heads, lp.kv_heads
        self.mlp, self.experts, self.stacks = lp.mlp, lp.experts, lp.stacks
        self._comm = comm

    def enter(self, x):
        return _Enter.apply(x, self._comm)

    def share(self, x):
        return _Share.apply(x, self._comm.rank == 0)

    def psum(self, x):
        return _Psum.apply(x, self._comm)


class TrainTP:
    """The tensor-parallel context ``forward_train`` takes: the rank's
    :func:`train_plan`, each layer's :class:`LayerSplit` and the
    row-parallel ``reduce``."""

    def __init__(self, cfg, comm):
        self.cfg, self.comm = cfg, comm
        self.replan()

    def replan(self, quant_bits: Optional[int] = None) -> None:
        """The plan for a base quantized to ``quant_bits``."""
        self.plan = train_plan(self.cfg, self.comm.rank, self.comm.size, quant_bits)
        self.splits = [LayerSplit(lp, self.comm) for lp in self.plan.layers]

    def reduce(self, x):
        return _Reduce.apply(x, self.comm)


# the train state's trees: dicts flatten in sorted key order (JAX's), lists
# in order; a leaf is a tensor


def tree_flatten(tree, prefix: Tuple = ()) -> Tuple[List[Tuple], List[torch.Tensor]]:
    """(paths, leaves) of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for k, v in items:
        p, lv = tree_flatten(v, prefix + (k,))
        paths += p
        leaves += lv
    return paths, leaves


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in flatten order) at its leaves."""
    return _unflatten(template, iter(leaves))


def _unflatten(node, it):
    # a module function, not a closure that calls itself: such a closure is a
    # reference cycle holding the leaves' iterator, so the leaves (a whole
    # model's old params or gradients) would wait for the cyclic collector
    if isinstance(node, dict):  # the leaves come in sorted key order; keep the dict's own
        built = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return [_unflatten(v, it) for v in node]
    return next(it)


def _key_of(path: Tuple) -> Tuple[str, Optional[int], Optional[str]]:
    """(leaf key, layer index, stack) of a param path, for :func:`split_of`."""
    if path[0] != "layers":
        return path[0], None, None
    i = int(path[1])  # a list index, or a pipeline stage's global layer key
    if path[2] == "experts":
        return path[4], i, None
    if path[2] in _STACKS:
        return path[3], i, path[2]
    return path[2], i, None


class _Layout:
    """Where a train state's leaves live: each param leaf's whole shape and
    its tensor-parallel cut (:func:`split_of`), and whether the params
    (fsdp) and the optimizer leaves (zero1 or fsdp) are dp chunks: the
    flattened leaf padded to a multiple of dp, chunk d on dp rank d.
    parallel/checkpoint.py moves leaves through ``gather`` (this rank's ->
    whole) and ``place`` (whole -> this rank's) by kind: "trained" (leaf i
    of the trained tree: the params, or LoRA's adapters), "opt" (a moment
    or the master of trained leaf i), "base" (LoRA's frozen leaf i: its
    whole shape in ``base_shapes``, its cut in ``base_cuts``, an entry of
    :func:`base_cuts`).

    On a pipeline (a ``"pp"`` axis) the trained tree is this rank's stage
    (parallel/pipeline.py): ``counted[i]`` is False for the one leaf the
    global norm must not count twice, the last stage's copy of a tied
    embedding, and the norm is summed over the pp line.

    ``data_axes``: the axes whose ranks hold the same weights and split the
    data (context parallelism's dp and cp), joined as one "dp" line;
    ``split_axis``: the axis the cuts split over (expert parallelism's
    "ep": its experts' stacks cut on the expert axis)."""

    def __init__(self, mesh, tree: dict, cuts: list, zero1: bool = False, fsdp: bool = False,
                 trained: str = "params", base: Optional[Tuple[list, list]] = None, counted: Optional[list] = None,
                 data_axes: Tuple[str, ...] = ("dp",), split_axis: str = "tp"):
        self.mesh = mesh
        self.trained = trained
        axes = tuple(a for a in data_axes if a in mesh.shape)
        self.dp = int(np.prod([mesh.shape[a] for a in axes]))
        self.dp_rank = int(np.ravel_multi_index([mesh.coords[a] for a in axes], [mesh.shape[a] for a in axes])) \
            if axes else 0
        self.dp_comm = mesh.joint(axes) if len(axes) > 1 else mesh.comm(axes[0]) if axes else None
        self.tp_comm = mesh.comm(split_axis)
        self.pp_comm = mesh.comm("pp")
        self.zero1, self.fsdp = zero1, fsdp
        self.paths, leaves = tree_flatten(tree)
        self.full_shapes = [tuple(v.shape) for v in leaves]
        self.cuts = cuts
        self.counted = counted if counted is not None else [True] * len(leaves)
        # LoRA's frozen base: each leaf's whole shape and :func:`base_cuts` entry
        self.base_shapes, self.base_cuts = base if base is not None else ([], [])
        self.local_shapes = []
        for shape, cut in zip(self.full_shapes, self.cuts):
            shape = list(shape)
            if cut is not None:
                shape[cut[0]] = cut[2] - cut[1]
            self.local_shapes.append(tuple(shape))
        self.numels = [int(np.prod(s)) for s in self.local_shapes]
        self.chunks = [-(-n // self.dp) for n in self.numels]

    # -- dp chunks --------------------------------------------------------

    def chunk(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf i's (tp-local) tensor -> this dp rank's flat chunk."""
        c = self.chunks[i]
        flat = t.reshape(-1)
        pad = c * self.dp - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat[self.dp_rank * c:(self.dp_rank + 1) * c].clone()

    def unchunk(self, i: int, chunk: torch.Tensor) -> torch.Tensor:
        """This rank's chunk -> leaf i's whole (tp-local) tensor."""
        flat = chunk if self.dp == 1 else self.dp_comm.all_gather_flat(chunk)
        return flat[:self.numels[i]].reshape(self.local_shapes[i])

    # -- tp slices --------------------------------------------------------

    def slice_tp(self, i: int, full: torch.Tensor) -> torch.Tensor:
        cut = self.cuts[i]
        if cut is None:
            return full
        dim, lo, hi = cut
        return full.narrow(dim, lo, hi - lo).contiguous()

    def gather_tp(self, i: int, local: torch.Tensor) -> torch.Tensor:
        cut = self.cuts[i]
        if cut is None:
            return local
        pieces = self.tp_comm.all_gather_flat(local.reshape(-1)).reshape((self.tp_comm.size,) + local.shape)
        return torch.cat(list(pieces), dim=cut[0])

    # -- by kind (checkpoints) --------------------------------------------

    def _chunked(self, kind: str) -> bool:
        return self.fsdp or (kind == "opt" and self.zero1)

    def _base_cut(self, i: int):
        return self.base_cuts[i] if i < len(self.base_cuts) else None

    def gather_base(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Base leaf i whole: its tp slices joined, a packed int4 row slice's
        split-half packing over the whole K restored."""
        cut = self._base_cut(i)
        if cut is None:
            return local
        dim, _, _, packed = cut
        pieces = self.tp_comm.all_gather_flat(local.reshape(-1)).reshape((self.tp_comm.size,) + local.shape)
        whole = torch.cat(list(pieces), dim=dim)
        return unpack4_tp_blocked(whole, self.tp_comm.size) if packed else whole

    def place_base(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        cut = self._base_cut(i)
        if cut is None:
            return whole
        dim, lo, hi, packed = cut
        if dim == 1:
            return _cols(whole, lo, hi, packed)
        return whole[lo:hi].clone()

    def gather(self, kind: str, i: int, t: torch.Tensor) -> torch.Tensor:
        if kind == "base":
            return self.gather_base(i, t)
        return self.gather_tp(i, self.unchunk(i, t) if self._chunked(kind) else t)

    def place(self, kind: str, i: int, whole: torch.Tensor) -> torch.Tensor:
        if kind == "base":
            return self.place_base(i, whole.to(self.mesh.device))
        local = self.slice_tp(i, whole.to(self.mesh.device))
        return self.chunk(i, local) if self._chunked(kind) else local


def param_cuts(cfg, pl: Optional[Plan], params: dict) -> list:
    """Each param leaf's tensor-parallel cut under ``pl`` (flatten order)."""
    cuts = []
    for p, v in zip(*tree_flatten(params)):
        key, i, stack = _key_of(p)
        cuts.append(None if pl is None else split_of(cfg, pl, key, v, i, stack))
    return cuts


def base_cuts(cfg, pl: Optional[Plan], params: dict) -> list:
    """Each leaf's cut under ``pl`` for a whole tree whose quantized weights
    are ``{"q", "scale"}`` (or fused ``{"q3", "scale"}``) dicts, in flatten
    order: None (held whole) or ``(dim, lo, hi, packed)``, the rows or
    unpacked input columns [lo, hi) of what :func:`shard_leaf` hands the
    rank; ``packed``: a packed int4 row slice (re-packed over its columns).
    A row slice's scale stays whole."""
    cuts = []
    for p, v in zip(*tree_flatten(params)):
        field = p[-1] if p[-1] in ("q", "q3", "scale") else None
        owner = p[:-1] if field is not None else p
        key, i, stack = _key_of(owner)
        whole = _at(params, owner)
        cut = None if pl is None else split_of(cfg, pl, key, whole, i, stack)
        if cut is not None and field == "scale" and cut[0] == 1 and stack is None:
            cut = None
        cuts.append(None if cut is None else (*cut, cut[0] == 1 and v.dtype == torch.uint8))
    return cuts


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def unpack4_tp_blocked(q: torch.Tensor, n_tp: int) -> torch.Tensor:
    """The inverse of :func:`repack4_tp_blocked`: ``n_tp`` blocks, each
    split-half packed over its own columns (the joined row slices), back to
    one split-half packing over the whole K."""
    bh = q.shape[-1] // n_tp
    nib = torch.cat([torch.cat([b & 0xF, b >> 4], dim=-1) for b in q.split(bh, dim=-1)], dim=-1)
    half = nib.shape[-1] // 2
    return (nib[..., :half] | (nib[..., half:] << 4)).to(torch.uint8)


def _loss_fn(params: dict, cfg, batch: torch.Tensor, remat: bool = False, tp: Optional[TrainTP] = None
             ) -> torch.Tensor:
    """Next-token cross entropy over a (B, T+1) token batch: f32
    log-softmax, the mean NLL over B x T."""
    from ..models.llama import forward_train

    inputs, targets = batch[:, :-1], batch[:, 1:]
    return _nll(forward_train(params, cfg, inputs, remat=remat, tp=tp), targets)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The mean NLL of ``targets`` under f32 log-softmax ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None].to(torch.int64))[..., 0].mean()


class TrainState(dict):
    """``{"params", "opt_state"[, "master"]}`` (LoRA: ``{"params", "lora",
    "opt_state"}``) of this rank, and ``layout``, where its leaves live
    (parallel/checkpoint.py gathers and re-places through it)."""

    layout = None


class _Gather(torch.autograd.Function):
    """fsdp: a leaf's dp chunks all-gathered at use; the gradient
    reduce-scattered back to this rank's chunk (summed over dp)."""

    @staticmethod
    def forward(ctx, chunk, layout, i):
        ctx.layout, ctx.i = layout, i
        return layout.unchunk(i, chunk)

    @staticmethod
    def backward(ctx, g):
        lay, i = ctx.layout, ctx.i
        flat = g.reshape(-1)
        pad = lay.chunks[i] * lay.dp - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return lay.dp_comm.reduce_scatter_sum(flat, torch.float32), None, None


class _Gathered(Mapping):
    """A params dict of fsdp chunks whose tensor leaves are gathered as they
    are read (``block_train`` reads each once; a remat recompute reads it
    again)."""

    def __init__(self, node: dict, index: dict, layout: _Layout):
        self._node, self._index, self._layout = node, index, layout

    def __getitem__(self, key):
        return _wrap(self._node[key], self._index[key], self._layout)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)


def _wrap(node, index, layout):
    if isinstance(node, dict):
        return _Gathered(node, index, layout)
    if isinstance(node, list):
        return [_wrap(v, j, layout) for v, j in zip(node, index)]
    return _Gather.apply(node, layout, index)


class _OptimKit:
    """The optimizer and the state placement every train step shares:
    ``tx`` (default adamw(learning_rate)), ``master_fp32`` (an f32 master
    and f32 moments, the params re-cast from it each step) and the dp
    placement of :class:`_Layout` (zero1 / fsdp). ``init`` builds the state
    of this rank's (tp-local) params; ``apply`` takes the step's gradients,
    already summed over dp and divided by dp, in the layout of the state."""

    def __init__(self, layout: _Layout, learning_rate: float, master_fp32: bool, tx=None):
        from .optim import adamw

        self.tx = tx if tx is not None else adamw(learning_rate)
        self.layout = layout
        self.master_fp32 = master_fp32
        self.sharded = layout.zero1 or layout.fsdp  # the optimizer's leaves are dp chunks

    def init(self, params: dict) -> TrainState:
        """The state of the (tp-local) trained tree ``params``, under the
        layout's key for it."""
        lay = self.layout
        _, leaves = tree_flatten(params)
        if lay.fsdp:
            leaves = [lay.chunk(i, v) for i, v in enumerate(leaves)]
            params = tree_unflatten(params, leaves)
        state = TrainState({lay.trained: params})
        ref = leaves if not lay.zero1 else [lay.chunk(i, v) for i, v in enumerate(leaves)]
        if self.master_fp32:
            ref = [r.to(torch.float32) for r in ref]
            state["master"] = ref
        state["opt_state"] = self.tx.init(ref)
        state.layout = lay
        return state

    def sumsq(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the step's (local) update leaves: tp
        slices summed over tp, replicated leaves counted once, dp chunks
        summed over dp, a pipeline's stages summed over pp (a tied
        embedding's second copy left out)."""
        lay = self.layout
        split = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        whole = torch.zeros_like(split)
        for t, cut, counted in zip(tensors, lay.cuts, lay.counted):
            if not counted:
                continue
            s = t.to(torch.float32).square().sum()
            if cut is None:
                whole = whole + s
            else:
                split = split + s
        both = torch.stack([split, whole])
        if self.sharded and lay.dp > 1:
            both = lay.dp_comm.all_reduce(both)
        split, whole = both[0], both[1]
        if lay.tp_comm is not None:
            split = lay.tp_comm.all_reduce_sum(split)
        total = split + whole
        return total if lay.pp_comm is None else lay.pp_comm.all_reduce_sum(total)

    def apply(self, state: TrainState, grads: List[torch.Tensor]) -> TrainState:
        """The next state. ``state`` and ``grads`` are consumed (JAX's
        donation): each old leaf goes as its new one is made, so a step
        holds one copy of the params, the master and the moments."""
        lay = self.layout
        tree = state[lay.trained]
        _, params = tree_flatten(tree)
        opt_state, master = state["opt_state"], state.get("master")
        out = TrainState({k: v for k, v in state.items() if k not in (lay.trained, "opt_state", "master")})
        state.clear()
        if self.master_fp32:
            for i, g in enumerate(grads):
                grads[i] = g.to(torch.float32)
            ref = master
        elif lay.zero1:
            ref = [lay.chunk(i, p) for i, p in enumerate(params)]
        else:
            ref = params
        updates, out["opt_state"] = self.tx.update(grads, opt_state, ref, self.sumsq)
        for i, u in enumerate(updates):  # optim.apply_updates, leaf by leaf
            ref[i] = (ref[i] + u).to(ref[i].dtype)
            updates[i] = None
        if lay.zero1:  # one all-gather a leaf: its result is the leaf, no second copy
            for i, r in enumerate(ref):
                params[i] = lay.unchunk(i, r.to(params[i].dtype))
        elif self.master_fp32:
            for i, r in enumerate(ref):
                params[i] = r.to(params[i].dtype)
        out[lay.trained] = tree_unflatten(tree, params)
        if self.master_fp32:
            out["master"] = ref
        out.layout = lay
        return out


def _local_rows(batch: torch.Tensor, k: int, grad_accum: int, dp: int, d: int) -> torch.Tensor:
    """Dp rank d's rows of microbatch k: the (B, T+1) batch cut into
    ``grad_accum`` microbatches, each cut over the dp ranks (JAX's
    ``micro`` sharded on 'dp')."""
    B = batch.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch dim {B} not divisible by grad_accum={grad_accum}")
    m = B // grad_accum
    if m % dp:
        raise ValueError(f"a microbatch of {m} rows does not split over dp={dp}")
    b = m // dp
    return batch[k * m + d * b:k * m + (d + 1) * b]


def _dp_mean(comm, tensors: List[torch.Tensor], dp: int) -> List[torch.Tensor]:
    """The mean over the dp ranks of each tensor (one flat f32 all-reduce)."""
    if dp == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = comm.all_reduce(flat) / dp
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out


def make_train_step(mesh, cfg, learning_rate: float = 1e-4, remat: bool = False, zero1: bool = False,
                    master_fp32: bool = False, grad_accum: int = 1, tx=None, fsdp: bool = False):
    """Build ``(init_state, train_step)`` over ``mesh`` (parallel/mesh.py):
    dp-sharded batches, tp-sliced params, the options of JAX's
    ``make_train_step``. ``train_step(state, batch) -> (state, loss)``
    takes the GLOBAL (B, T+1) batch on every rank and consumes ``state``
    (JAX donates it); the loss is the f32 global mean.

    ``grad_accum=K`` cuts the batch into K microbatches, each run forward
    and backward in turn (activation memory of one), the gradients summed in
    f32 and averaged, then cast to the params' dtype unless ``master_fp32``;
    with equal microbatches the step equals the unaccumulated one up to
    rounding. ``remat`` checkpoints each block. ``zero1`` keeps 1/dp of the
    moments (and master) a dp rank; ``fsdp`` also the params, gathered at
    use (it subsumes zero1). ``tx`` replaces adamw(learning_rate) by any
    parallel/optim.py transformation. ``master_fp32`` keeps an f32 master
    and f32 moments and re-casts the params from it each step, so updates
    under one ulp of a bf16 param accumulate."""
    if fsdp and zero1:
        raise ValueError("fsdp already shards the optimizer state over 'dp'; zero1 is subsumed")
    dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    tp = TrainTP(cfg, mesh.comm("tp")) if mesh.shape.get("tp", 1) > 1 else None
    kit: List[_OptimKit] = []

    def init_state(params: dict) -> TrainState:
        layout = _Layout(mesh, params, param_cuts(cfg, tp.plan if tp is not None else None, params), zero1, fsdp)
        params = shard_params(params, cfg, tp.plan) if tp is not None else params
        params = tree_unflatten(params, [v.detach().to(mesh.device) for v in tree_flatten(params)[1]])
        kit[:] = [_OptimKit(layout, learning_rate, master_fp32, tx)]
        return kit[0].init(params)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        opt = kit[0]
        lay = opt.layout
        batch = torch.as_tensor(batch).to(mesh.device)
        if grad_accum == 1 and not fsdp:
            return data_step(opt, state, lambda p: _loss_fn(p, cfg, _local_rows(batch, 0, 1, dp, d), remat, tp),
                             zero1)
        _, leaves = tree_flatten(state["params"])
        leaves = [v.detach().requires_grad_(True) for v in leaves]
        view = tree_unflatten(state["params"], leaves)
        if fsdp:
            view = _wrap(view, tree_unflatten(view, list(range(len(leaves)))), lay)
        loss_sum, grad_sum = None, None
        for k in range(grad_accum):
            loss = _loss_fn(view, cfg, _local_rows(batch, k, grad_accum, dp, d), remat, tp)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]
            if grad_accum == 1:
                loss_sum, grad_sum = loss.detach(), grads
                break
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            if grad_sum is None:  # an f32 copy of each (autograd may hand two leaves one tensor)
                grad_sum = [g.to(torch.float32, copy=True) for g in grads]
            else:  # in place: one f32 sum alive beside a microbatch's gradients
                for a, g in zip(grad_sum, grads):
                    a.add_(g.to(torch.float32))
            del grads
        loss = loss_sum / grad_accum
        grads, grad_sum = grad_sum, None
        if grad_accum > 1:
            for g in grads:
                g.div_(grad_accum)
            if not master_fp32:  # the unaccumulated path hands tx grads in the params' dtype
                grads = [g.to(v.dtype) for g, v in zip(grads, leaves)]
        if fsdp:  # the gathers' backward summed the chunks' gradients over dp
            grads = [g / dp for g in grads] if dp > 1 else grads
        elif zero1:
            grads = _zero1_scatter(lay, grads)
        else:
            grads = _dp_mean(lay.dp_comm, grads, dp)
        if dp > 1:
            loss = lay.dp_comm.all_reduce(loss.to(torch.float32)) / dp
        del leaves, view
        return opt.apply(state, grads), loss

    return init_state, train_step


def make_pp_train_step(mesh, cfg, n_microbatches: int, learning_rate: float = 1e-4, remat: bool = False,
                       zero1: bool = False, master_fp32: bool = False, tx=None):
    """Build ``(init_state, train_step)`` for pipeline-parallel training over
    ``mesh``'s ``"pp"`` axis (with ``"dp"`` and ``"tp"`` when it has them):
    JAX's ``make_pp_train_step`` and its options.

    ``init_state`` takes this rank's stage (parallel/pipeline.py
    ``stack_stages``); the optimizer state is the stage's own, Megatron-cut
    with its leaves, and with ``zero1`` cut over dp (which needs a ``"dp"``
    axis). ``train_step(state, batch) -> (state, loss)`` takes the global
    (B, T+1) batch on every rank, runs the GPipe schedule over
    ``n_microbatches`` and returns the f32 global mean loss on every rank.
    The gradients are averaged over dp; a tied embedding's two copies (first
    and last stage) each take the sum of both stages' gradients, and the
    global norm (``clip_by_global_norm``) is summed over the stages with that
    embedding counted once. ``remat``, ``master_fp32`` and ``tx`` as in
    :func:`make_train_step`."""
    from .pipeline import _pp_loss, stage_layout

    if zero1 and "dp" not in mesh.axis_names:
        raise ValueError("zero1 needs a 'dp' axis in the pipeline mesh")
    pp, r, n_pp = mesh.comm("pp"), mesh.coords.get("pp", 0), mesh.shape.get("pp", 1)
    kit: List[_OptimKit] = []
    tied: List[bool] = []

    def init_state(pp_params: dict) -> TrainState:
        layout = stage_layout(mesh, cfg, pp_params, zero1=zero1)
        params = tree_unflatten(pp_params, [v.detach().to(mesh.device) for v in tree_flatten(pp_params)[1]])
        head = torch.tensor([float("lm_head" in pp_params)], device=mesh.device)
        tied[:] = [n_pp > 1 and float(pp.all_reduce_sum(head)) == 0.0]  # no stage holds an lm_head
        kit[:] = [_OptimKit(layout, learning_rate, master_fp32, tx)]
        return kit[0].init(params)

    def tie(grads: List[torch.Tensor]) -> None:
        """The tied embedding's two parts, summed in stage order."""
        if tied[0] and r in (0, n_pp - 1):
            i = kit[0].layout.paths.index(("embed_tokens",))
            other = pp.sendrecv(grads[i], n_pp - 1 if r == 0 else 0)
            grads[i] = grads[i] + other if r == 0 else other + grads[i]

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        batch = torch.as_tensor(batch).to(mesh.device)
        return data_step(kit[0], state, lambda p: _pp_loss(mesh, cfg, n_microbatches, remat, p, batch,
                                                           tree_flatten(p)[1]), zero1, tie)

    return init_state, train_step


def _zero1_scatter(lay: _Layout, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """ZeRO-1: each dp rank's chunk of every gradient, summed over dp in f32
    and divided by dp, in one reduce-scatter of a chunk-major flat buffer:
    row r holds every leaf's chunk r, zero-padded (handed to the transport
    in the gradients' dtype when they share one; NCCL and gloo both sum it
    in f32, Comm.reduce_scatter_sum)."""
    if lay.dp == 1:  # one chunk: the whole flattened leaf
        return [g.reshape(-1) for g in grads]
    dtypes = [g.dtype for g in grads]
    wire = dtypes[0] if len(set(dtypes)) == 1 else torch.float32
    send = torch.zeros((lay.dp, sum(lay.chunks)), dtype=wire, device=grads[0].device)
    o = 0
    for i, g in enumerate(grads):
        c, flat = lay.chunks[i], g.reshape(-1)
        for r in range(lay.dp):
            part = flat[r * c:(r + 1) * c]
            send[r, o:o + part.numel()].copy_(part)
        o += c
    grads.clear()  # the caller's list: the whole gradients go before the reduction
    mine = lay.dp_comm.reduce_scatter_sum(send.reshape(-1), torch.float32)
    del send
    out, o = [], 0
    for c, dtype in zip(lay.chunks, dtypes):
        out.append((mine[o:o + c].to(torch.float32) / lay.dp).to(dtype))
        o += c
    return out


# ---------------------------------------------------------------------------
# Context parallelism: training over a ("dp",)? x "cp" x ("tp",)? mesh
# ---------------------------------------------------------------------------
#
# JAX's make_cp_loss runs one shard_map over (dp, cp, tp); the port's rank
# (d, c, t) takes rows d of the batch and sequence block c, and its blocks
# call the ring (parallel/ring.py) through block_train's ``attend`` hook. The
# tp slices are the dp x tp step's (``train_plan``: the embedding and the
# lm_head replicated, GPT-OSS's fused stacks split on the expert axis, as
# JAX's cp x tp splits them). dp and cp both hold whole copies of the
# replicated weights, so the gradients are averaged over both (one joint
# line, ``Mesh.joint``) and ZeRO-1 cuts the moments over both.


class _DataMean(torch.autograd.Function):
    """The mean over the data ranks of each rank's loss (summed in rank
    order); the gradient reaches each rank's loss divided by their number."""

    @staticmethod
    def forward(ctx, x, comm, n):
        ctx.n = n
        return x.clone() if comm is None else comm.all_reduce_sum(x, torch.float32) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _cp_check(mesh, cfg, params) -> None:
    """make_cp_loss's refusals, with JAX's messages."""
    if cfg.is_mla:
        raise NotImplementedError("MLA attention does not ring-decompose")
    n_tp = mesh.shape.get("tp", 1)
    if "tp" not in mesh.axis_names:
        return
    if cfg.model_type == "gpt_oss" and cfg.num_local_experts % n_tp != 0:
        raise ValueError(f"gpt-oss under cp x tp shards the expert dim: {cfg.num_local_experts} experts must "
                         f"divide tp={n_tp}")
    if cfg.num_attention_heads % n_tp or cfg.num_key_value_heads % n_tp or cfg.intermediate_size % n_tp:
        raise ValueError(f"tp={n_tp} must evenly divide heads/kv-heads/ffn")
    for layer in params["layers"]:
        if any(isinstance(w, dict) for w in layer.get("gptoss_experts", {}).values()):
            raise NotImplementedError("quantized gpt-oss expert stacks do not train under cp x tp (dequantize first)")


def _cp_local_loss(mesh, cfg, p: dict, batch: torch.Tensor, remat: bool, tp: Optional[TrainTP]) -> torch.Tensor:
    """This rank's mean NLL over its rows (dp) and sequence block (cp) of
    the (B, T+1) batch, every block's attention on the ring."""
    from torch.utils.checkpoint import checkpoint

    from ..models.llama import block_train, embed_train, head_train, layer_rope, rope_tables
    from .ring import ring_body

    n_cp, c = mesh.shape.get("cp", 1), mesh.coords.get("cp", 0)
    dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    B, T = batch.shape[0], batch.shape[1] - 1
    if T % n_cp:
        raise ValueError(f"sequence {T} does not divide cp={n_cp}")
    if B % dp:
        raise ValueError(f"batch {B} does not divide dp={dp}")
    Tl, b = T // n_cp, B // dp
    rows = batch[d * b:(d + 1) * b]
    inputs, targets = rows[:, c * Tl:(c + 1) * Tl], rows[:, c * Tl + 1:(c + 1) * Tl + 1]
    x = embed_train(p, cfg, inputs)
    positions = (c * Tl + torch.arange(Tl, device=x.device))[None, :].expand(b, Tl)
    rope = rope_tables(cfg, T, x.device)  # the whole sequence's tables (Gemma-3's dual ones too)
    comm = mesh.comm("cp")
    softcap = float(np.float32(cfg.attn_logit_softcapping)) if cfg.attn_logit_softcapping else None

    def blk(layer, x, cos, sin, i, split):
        window = cfg.sliding_window if cfg.sliding_window is not None and cfg.layer_is_sliding(i) else None
        chunk = cfg.attention_chunk_size if cfg.layer_is_chunked(i) else None

        def attend(q, k, v, scale, sinks):
            return ring_body(q, k, v, comm, scale, window=window, chunk=chunk, softcap=softcap, sinks=sinks)

        return block_train(cfg, layer, x, cos, sin, positions, None, None if tp is None else tp.reduce,
                           cfg.layer_uses_rope(i), split, attend=attend)

    for i, layer in enumerate(p["layers"]):
        cos, sin = layer_rope(cfg, rope, i)
        args = (layer, x, cos, sin, i, None if tp is None else tp.splits[i])
        x = checkpoint(blk, *args, use_reentrant=False) if remat else blk(*args)
    return _nll(head_train(p, cfg, x), targets)


def make_cp_loss(mesh, cfg, params: dict, remat: bool = False):
    """Next-token cross entropy with the sequence cut over ``mesh``'s
    ``"cp"`` axis and ring attention in every block (JAX's
    ``make_cp_loss``), with ``"dp"`` (rows) and ``"tp"`` (Megatron slices)
    when the mesh has them. ``params`` fixes the tree (its refusals:
    MLA, tp not dividing the heads, KV heads or ffn, GPT-OSS experts
    indivisible by tp or quantized under tp).

    Returns ``loss_fn(p, batch)``: ``p`` this rank's params (``loss_fn.place
    (params)``: its tp slices), ``batch`` the global (B, T+1) batch on every
    rank; the value is the global mean over every token on every rank, and
    its gradient on a rank is that rank's part: summed over dp and cp it is
    the whole gradient. Windows and chunks run a bounded ring, softcaps act
    in each hop, sinks join at the end (parallel/ring.py); Gemma-3's dual
    rope tables and Llama-4's NoPE layers use global positions. The final
    logit softcap is applied (JAX's cp loss leaves it out; its ``_loss_fn``
    applies it)."""
    _cp_check(mesh, cfg, params)
    tp = TrainTP(cfg, mesh.comm("tp")) if mesh.shape.get("tp", 1) > 1 else None
    data = mesh.joint(("dp", "cp"))
    n_data = mesh.shape.get("dp", 1) * mesh.shape.get("cp", 1)

    def loss_fn(p: dict, batch) -> torch.Tensor:
        batch = torch.as_tensor(batch).to(mesh.device)
        return _DataMean.apply(_cp_local_loss(mesh, cfg, p, batch, remat, tp), data, n_data)

    loss_fn.tp = tp
    loss_fn.place = lambda whole: shard_params(whole, cfg, tp.plan) if tp is not None else whole
    return loss_fn


def make_cp_train_step(mesh, cfg, params_template: dict, learning_rate: float = 1e-4, remat: bool = False,
                       zero1: bool = False, master_fp32: bool = False, tx=None):
    """Build ``(init_state, train_step)`` over a ("dp",)? x "cp" x ("tp",)?
    mesh (JAX's ``make_cp_train_step``): rows over dp, the sequence over cp
    with ring attention, tp slices as in :func:`make_train_step`.
    ``params_template`` fixes the tree (:func:`make_cp_loss`'s refusals);
    ``init_state`` takes the whole params. ``train_step(state, batch) ->
    (state, loss)`` takes the global (B, T+1) batch on every rank and
    returns the global mean loss; the replicated weights' gradients are
    averaged over dp and cp, and ``zero1`` cuts the moments (and master)
    over both. ``remat``, ``master_fp32`` and ``tx`` as in
    :func:`make_train_step`."""
    loss_fn = make_cp_loss(mesh, cfg, params_template, remat=remat)
    tp = loss_fn.tp
    kit: List[_OptimKit] = []

    def init_state(params: dict) -> TrainState:
        layout = _Layout(mesh, params, param_cuts(cfg, tp.plan if tp is not None else None, params), zero1,
                         data_axes=("dp", "cp"))
        params = loss_fn.place(params)
        params = tree_unflatten(params, [v.detach().to(mesh.device) for v in tree_flatten(params)[1]])
        kit[:] = [_OptimKit(layout, learning_rate, master_fp32, tx)]
        return kit[0].init(params)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        batch = torch.as_tensor(batch).to(mesh.device)
        return data_step(kit[0], state, lambda p: _cp_local_loss(mesh, cfg, p, batch, remat, tp), zero1)

    return init_state, train_step


def data_step(opt: _OptimKit, state: TrainState, local_loss, zero1: bool, tie=None
              ) -> Tuple[TrainState, torch.Tensor]:
    """One step of a layout whose data ranks (``opt.layout``'s dp line) each
    take a share of the batch: ``local_loss(params)`` is this rank's mean
    loss; ``tie(grads)``, when given, amends the gradients (flatten order)
    in place before they are averaged over the line (ZeRO-1:
    reduce-scattered) and applied; returns (the next state, the mean loss
    over the line)."""
    lay = opt.layout
    _, leaves = tree_flatten(state["params"])
    leaves = [v.detach().requires_grad_(True) for v in leaves]
    local = local_loss(tree_unflatten(state["params"], leaves))
    grads = torch.autograd.grad(local, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]
    del leaves
    if tie is not None:
        tie(grads)
    grads = _zero1_scatter(lay, grads) if zero1 else _dp_mean(lay.dp_comm, grads, lay.dp)
    loss = local.detach()
    if lay.dp > 1:
        loss = lay.dp_comm.all_reduce(loss.to(torch.float32)) / lay.dp
    return opt.apply(state, grads), loss
