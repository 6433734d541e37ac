"""Expert parallelism over an ``"ep"`` axis of launched ranks (counterpart
of shardmerge_tpu/parallel/moe.py).

Each rank of the ep line holds n_exp / P whole experts, stacked (W1, W3,
W2) (:func:`shard_experts`, models/llama.py ``stack_expert_weights``).
Activations are the same on every ep rank: each computes the same router
and the same capacity tables (models/llama.py
``capacity_tables_from_topk``), runs its own experts' blocks
(``capacity_experts_apply`` on its rows of the tables), and one sum over
the line (``Comm.all_reduce_sum``, rank order) assembles the routed output.
DeepSeek's shared experts run outside the sum, on every rank.

Training (:func:`make_ep_loss`, :func:`make_ep_train_step`) composes ep
with a ``"dp"`` axis (the batch split over dp only). The expert blocks are
Megatron's f/g pair over ep (parallel/train.py ``_Enter`` / ``_Reduce``):
the tokens and the routing weights entering the local experts have their
gradients summed over the line, so the router, the norms and attention,
held whole on every rank, get the gradient of every expert and stay equal
across the line without a gradient collective. With ``capacity_factor``
None every expert has a slot for every token: nothing is dropped and the
step equals one device's dense-and-mask step up to rounding.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models.llama import (
    _ffn_train,
    _mlp_fn,
    blocks_train,
    capacity_experts_apply,
    capacity_of,
    capacity_tables_from_topk,
    embed_train,
    expert_stacks,
    head_train,
    route_experts,
)
from .train import (
    TrainState,
    _DataMean,
    _Enter,
    _Layout,
    _nll,
    _OptimKit,
    _Reduce,
    data_step,
    tree_flatten,
    tree_unflatten,
)

__all__ = ["shard_experts", "expert_parallel_ffn", "ep_params", "make_ep_loss", "make_ep_train_step"]

_AXIS = "ep"


def _experts_of(mesh, n_exp: int) -> Tuple[int, int]:
    """This rank's experts [e0, e1) on the ep line."""
    n_ep, r = mesh.shape.get(_AXIS, 1), mesh.coords.get(_AXIS, 0)
    return r * n_exp // n_ep, (r + 1) * n_exp // n_ep


def shard_experts(mesh, layer: dict):
    """A layer's (gate_w, gate_bias, W1, W3, W2): the router matrix and
    DeepSeek-V3's selection bias (None when the layer has none) whole, the
    stacks' rows of this rank's experts."""
    W1, W3, W2 = expert_stacks(layer)
    e0, e1 = _experts_of(mesh, W1.shape[0])
    return (layer["moe_gate"], layer.get("gate_bias"), W1[e0:e1].clone(), W3[e0:e1].clone(), W2[e0:e1].clone())


def _dispatch(comm, cfg, gate_w, gate_bias, stacks, xf: torch.Tensor, capacity: int) -> torch.Tensor:
    """The routed output (S, hidden) f32 of tokens ``xf`` replicated over
    the ep line, ``stacks`` this rank's experts: the same tables on every
    rank, this rank's rows of them, one sum over the line."""
    n_exp = cfg.num_local_experts
    if gate_bias is None and cfg.topk_method == "noaux_tc":
        gate_bias = torch.zeros(n_exp, dtype=torch.float32, device=xf.device)
    idx, w = route_experts(cfg, gate_w, gate_bias, xf)
    xe = xf
    if comm is not None:  # the local experts' part of the tokens' and weights' gradients, summed over ep
        xe, w = _Enter.apply(xf, comm), _Enter.apply(w, comm)
    gather_idx, w_slot = capacity_tables_from_topk(idx, w, n_exp, capacity)
    n_local = stacks[0].shape[0]
    e0 = (0 if comm is None else comm.position) * n_local
    local = capacity_experts_apply(xe, gather_idx[e0:e0 + n_local], w_slot[e0:e0 + n_local], *stacks,
                                   cfg.hidden_act)
    return local if comm is None else _Reduce.apply(local, comm)


def expert_parallel_ffn(mesh, cfg, gate_w, gate_bias, W1, W3, W2, x: torch.Tensor,
                        capacity_factor: Optional[float] = 1.25, shared=None) -> torch.Tensor:
    """One MoE FFN with the experts cut over ``"ep"`` (JAX's
    ``expert_parallel_ffn``): ``x`` (B, T, hidden) the same on every rank,
    W1/W3/W2 this rank's experts (:func:`shard_experts`); routing by
    ``cfg`` (Mixtral / Qwen3-MoE softmax top-k, or DeepSeek's grouped
    router with ``gate_bias``); each expert's capacity
    ``min(ceil(S k / n_exp * capacity_factor), S)`` (None: S); ``shared``
    DeepSeek's (gate, up, down) shared experts, added on every rank. Returns
    (B, T, hidden) in x.dtype, the same on every rank."""
    n_exp, n_dev = cfg.num_local_experts, mesh.shape.get(_AXIS, 1)
    if n_exp % n_dev != 0:
        raise ValueError(f"{n_exp} experts do not divide {n_dev} devices")
    B, T, E = x.shape
    S = B * T
    out = _dispatch(mesh.comm(_AXIS), cfg, gate_w, gate_bias, (W1, W3, W2), x.reshape(S, E),
                    capacity_of(cfg, S, capacity_factor))
    if shared is not None:
        g, u, d = shared
        out = out + _mlp_fn({"gate_proj": g, "up_proj": u, "down_proj": d}, x, cfg.hidden_act).to(
            torch.float32).reshape(S, E)
    return out.reshape(B, T, E).to(x.dtype)


def _ep_check(mesh, cfg, params: dict) -> None:
    """make_ep_loss's refusals, with JAX's messages."""
    if _AXIS not in mesh.axis_names:
        raise ValueError("make_ep_loss needs an 'ep' axis in the mesh")
    n_ep, n_exp = mesh.shape[_AXIS], cfg.num_local_experts
    if n_exp % n_ep != 0:
        raise ValueError(f"{n_exp} experts do not divide ep={n_ep}")
    for layer in params["layers"]:
        if "gptoss_experts" in layer or "llama4_experts" in layer:
            raise NotImplementedError("fused expert stacks (gpt-oss/llama4) do not use the per-expert SwiGLU "
                                      "dispatch this ep body shards")
        if "experts" in layer:
            raise ValueError("make_ep_loss needs stacked expert leaves — run models/llama.stack_expert_weights"
                             "(params) first")
        if "experts_stacked" in layer and isinstance(layer["experts_stacked"][0], dict):
            raise NotImplementedError("quantized expert stacks do not train; dequantize first")


def ep_params(mesh, params: dict) -> dict:
    """This rank's params: every ``experts_stacked`` cut to its experts'
    rows, everything else as it is (the same objects)."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        if "experts_stacked" in layer:
            W = layer["experts_stacked"]
            e0, e1 = _experts_of(mesh, W[0].shape[0])
            layer = {**layer, "experts_stacked": tuple(w[e0:e1].clone() for w in W)}
        layers.append(layer)
    out["layers"] = layers
    return out


def _ep_local_loss(mesh, cfg, p: dict, batch: torch.Tensor, capacity_factor, remat: bool) -> torch.Tensor:
    """This dp rank's mean NLL over its rows; the experts' FFNs dispatched
    over the ep line, every other layer as one device runs it."""
    dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    B = batch.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} does not divide dp={dp}")
    rows = batch[d * (B // dp):(d + 1) * (B // dp)]
    inputs, targets = rows[:, :-1], rows[:, 1:]
    comm = mesh.comm(_AXIS)

    def ep_ffn(cfg_, layer, h):
        if "experts_stacked" not in layer:
            return _ffn_train(cfg_, layer, h, None)
        Bl, Tl, E = h.shape
        out = _dispatch(comm, cfg_, layer["moe_gate"], layer.get("gate_bias"), layer["experts_stacked"],
                        h.reshape(Bl * Tl, E), capacity_of(cfg_, Bl * Tl, capacity_factor)).reshape(Bl, Tl, E)
        if "shared_gate_proj" in layer:
            out = out + _mlp_fn(layer, h, cfg_.hidden_act, "shared_").to(torch.float32)
        return out.to(h.dtype)

    x = blocks_train(cfg, enumerate(p["layers"]), embed_train(p, cfg, inputs), remat, ffn=ep_ffn)
    return _nll(head_train(p, cfg, x), targets)


def make_ep_loss(mesh, cfg, params_template: dict, capacity_factor: Optional[float] = None, remat: bool = False):
    """Next-token cross entropy with the experts cut over ``mesh``'s
    ``"ep"`` axis (JAX's ``make_ep_loss``), with a ``"dp"`` axis (rows)
    when the mesh has one. ``params_template`` must hold stacked raw expert
    leaves (``stack_expert_weights``); fused stacks (GPT-OSS, Llama-4) are
    refused. ``capacity_factor`` None: no token is dropped.

    Returns ``loss_fn(p, batch)``: ``p`` this rank's params
    (:func:`ep_params`), ``batch`` the global (B, T+1) batch on every rank;
    the value is the global mean, and its gradient on a rank is that rank's
    part: the experts' its own, the replicated leaves' the same on every ep
    rank (summed over dp it is the whole gradient)."""
    _ep_check(mesh, cfg, params_template)
    data = mesh.comm("dp")
    n_data = mesh.shape.get("dp", 1)

    def loss_fn(p: dict, batch) -> torch.Tensor:
        batch = torch.as_tensor(batch).to(mesh.device)
        return _DataMean.apply(_ep_local_loss(mesh, cfg, p, batch, capacity_factor, remat), data, n_data)

    return loss_fn


def _ep_cuts(mesh, params: dict) -> list:
    """Each param leaf's cut over ep (flatten order): an expert stack's rows
    ``(0, e0, e1)``, None elsewhere."""
    cuts = []
    for path, v in zip(*tree_flatten(params)):
        cuts.append((0, *_experts_of(mesh, v.shape[0])) if "experts_stacked" in path else None)
    return cuts


def make_ep_train_step(mesh, cfg, params_template: dict, learning_rate: float = 1e-4,
                       capacity_factor: Optional[float] = None, remat: bool = False, zero1: bool = False,
                       master_fp32: bool = False, tx=None):
    """Build ``(init_state, train_step)`` over a ("dp",)? x "ep" mesh (JAX's
    ``make_ep_train_step``): experts, their moments and master cut over ep,
    rows over dp, everything else whole on every rank. ``init_state`` takes
    the whole params with stacked experts; ``train_step(state, batch) ->
    (state, loss)`` takes the global batch on every rank and returns the
    global mean loss. ``zero1`` cuts the moments over dp (it needs a
    ``"dp"`` axis); ``remat``, ``master_fp32`` and ``tx`` as in
    parallel/train.py ``make_train_step``."""
    if zero1 and "dp" not in mesh.axis_names:
        raise ValueError("zero1 needs a 'dp' axis in the ep mesh")
    _ep_check(mesh, cfg, params_template)
    kit: List[_OptimKit] = []

    def init_state(params: dict) -> TrainState:
        layout = _Layout(mesh, params, _ep_cuts(mesh, params), zero1, split_axis=_AXIS)
        params = ep_params(mesh, params)
        params = tree_unflatten(params, [v.detach().to(mesh.device) for v in tree_flatten(params)[1]])
        kit[:] = [_OptimKit(layout, learning_rate, master_fp32, tx)]
        return kit[0].init(params)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        batch = torch.as_tensor(batch).to(mesh.device)
        return data_step(kit[0], state, lambda p: _ep_local_loss(mesh, cfg, p, batch, capacity_factor, remat),
                         zero1)

    return init_state, train_step
