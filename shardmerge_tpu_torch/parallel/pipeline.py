"""Pipeline parallelism over a ``"pp"`` mesh axis: GPipe stages joined by
point-to-point sends (counterpart of shardmerge_tpu/parallel/pipeline.py:
``stack_stages``, ``pipeline_forward_train``, ``make_pp_loss``).

The decoder stack is cut into P stages of equal layer counts; stage r (the
rank at pp coordinate r) holds only its layers. With M microbatches,
microbatch m goes through stage r's layers and is sent to stage r + 1
(``Comm.send`` on the pp line); only real microbatches are computed (JAX
computes the bubble ticks and discards them: the same result). Every block
runs the one-device ``block_train`` (models/llama.py ``blocks_train``) with
its own global index's mask, rope table, rope gate and dual-rope pair, so a
stage needs no flag tables.

Placement (JAX replicates embed, the dense prefix, the final norm and the
lm_head on every device): stage 0 holds the embedding and any dense prefix,
the last stage the final norm and the lm_head, which saves exchanging their
gradients. A tied embedding (no ``lm_head``) lives on both: its gradient is
the sum of both stages' contributions (traded between them), and the global
norm counts it once, so both copies take the same update.

A stage's tree (:func:`stack_stages`) is ``{"layers": {global index:
layer}, ...}`` plus the embedding / norm / lm_head it holds: its leaves'
names are the unpipelined ones (``layers/12/q_proj``), which is how a
checkpoint stores them. Under ``tp`` each layer is this rank's Megatron
slice (parallel/train.py ``train_plan``, ``shard_layer``) and the blocks
run the dp x tp step's operators (``TrainTP``); unlike that step, the
pipeline refuses heads, KV heads or FFN widths that tp does not divide, as
JAX's does. With a ``"dp"`` axis each dp rank takes its rows of every
microbatch (JAX's microbatch dim sharded on 'dp').

The backward is GPipe's: every forward, then every backward. The last stage
backpropagates its loss and sends each microbatch's input gradient to stage
r - 1 in microbatch order; each earlier stage receives d(loss)/d(output) of
microbatch m, runs ``torch.autograd.backward(y_m, grad)`` and sends its own
input's gradient on, in the same order, so no send waits on a receive that
comes later. :func:`make_pp_loss` wraps the schedule as one autograd
function, so its loss differentiates like any other.

Deviations from JAX: the logits of :func:`pipeline_forward_train` come back
on the last stage only (None elsewhere; JAX replicates them), and
``stack_stages`` takes ``cfg=`` under ``tp`` (the Megatron plan needs the
head counts, which JAX reads from the mesh's shard shapes).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .train import (_STACKS, TrainTP, _key_of, _Layout, _local_rows, shard_layer, split_of, train_plan,
                    tree_flatten, tree_unflatten)

__all__ = ["stack_stages", "pipeline_forward_train", "make_pp_loss", "stage_layout"]

_AXIS = "pp"
# the rule dimension of a leaf the Megatron plan may cut: output rows, input
# columns, or a fused stack's experts
_ROW_SPLIT = {"o_proj", "down_proj", "w2"}
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def _struct(node):
    """Structural fingerprint of a layer (JAX's ``tree_structure``): dict
    keys and list lengths, a leaf as ``*``."""
    if isinstance(node, dict):
        return ("d", tuple((k, _struct(node[k])) for k in sorted(node)))
    if isinstance(node, (list, tuple)):
        return ("l", tuple(_struct(v) for v in node))
    return "*"


def _find_period(structs) -> Optional[int]:
    """The smallest proper period p of the layer structures (structs[i] ==
    structs[i % p] for all i), or None: JAX's ``_find_period``."""
    n = len(structs)
    if n <= 1:
        return 1
    for p in range(1, n):
        if n % p:
            continue
        if all(structs[i] == structs[i % p] for i in range(n)):
            return p
    return None


def _check_block(layer: dict) -> None:
    """JAX's ``_normalize_block`` refusal: a pipelined layer's leaves are
    tensors or quantized dicts of tensors."""
    for k, v in layer.items():
        if k in ("experts",) + _STACKS or isinstance(v, torch.Tensor):
            continue
        if isinstance(v, dict) and all(isinstance(w, torch.Tensor) for w in v.values()):
            continue
        raise NotImplementedError(
            f"pipeline stages require array (or quantized-dict) block weights; layer leaf {k!r} is "
            f"{type(v).__name__}")


def _assign(params: dict, n_stages: int, n_prefix_layers: Optional[int]):
    """(n_prefix, layers per stage, period) with JAX's refusals."""
    layers = params["layers"]
    structs = [_struct(layer) for layer in layers]
    if n_prefix_layers is None:
        period = _find_period(structs)
        if period is not None:
            n_prefix_layers = 0
        else:  # leading irregularity: everything before the longest uniform suffix
            auto = len(layers) - 1
            while auto > 0 and structs[auto - 1] == structs[-1]:
                auto -= 1
            n_prefix_layers = auto
            period = 1
    else:
        period = _find_period(structs[n_prefix_layers:])
        if period is None:
            raise ValueError(
                f"the {len(layers) - n_prefix_layers} layers after n_prefix_layers={n_prefix_layers} are "
                "heterogeneous (no uniform or periodic layer-kind pattern); replicate more leading layers via "
                "n_prefix_layers")
    n = len(layers) - n_prefix_layers
    if n % n_stages != 0:
        hint = " (replicate more leading layers via n_prefix_layers)" if n_prefix_layers or period > 1 else ""
        raise ValueError(f"{n_stages} pipeline stages do not evenly divide {n} pipelined layers{hint}")
    per = n // n_stages
    if per % period:
        raise ValueError(
            f"{n_stages} stages give {per} layers per stage, which does not divide the layer-kind period "
            f"{period} — stages would be structurally different (pick n_stages so layers_per_stage % {period} "
            "== 0)")
    for layer in layers[n_prefix_layers:]:
        _check_block(layer)
    return n_prefix_layers, per, period


def _packed(tree) -> bool:
    return any(v.dtype == torch.uint8 for v in tree_flatten(tree)[1])


def _tp_plan(mesh, cfg, tree):
    """This rank's Megatron plan under the mesh's tp axis (None without one)."""
    n_tp = mesh.shape.get("tp", 1)
    if n_tp == 1:
        return None
    return train_plan(cfg, mesh.coords["tp"], n_tp, 4 if _packed(tree) else None)


def stack_stages(mesh, params: dict, n_stages: int, tp: bool = False, qk_norm_full: bool = False,
                 n_prefix_layers: Optional[int] = None, *, cfg=None) -> dict:
    """This rank's stage of ``params`` (the whole tree, on every rank): its
    layers ``{global index: layer}`` and the embedding (stage 0, and the
    last stage when tied), the final norm and the lm_head (last stage), on
    the mesh's device. Nothing is stacked: a stage runs its layers in a loop.

    The layer assignment and refusals are JAX's: a leading structurally
    different run (DeepSeek's ``first_k_dense_replace`` dense prefix) goes
    to stage 0 (``n_prefix_layers`` moves more leading layers there); a
    periodic kind pattern (Llama-4 Maverick's interleave) keeps the
    contiguous layers [n_prefix + r per, n_prefix + (r + 1) per) on stage
    r, which must hold whole periods; the pipelined layers must divide
    ``n_stages``.

    ``tp=True``: each layer is this rank's Megatron slice under the mesh's
    ``"tp"`` axis (parallel/train.py ``train_plan``, int4 row slices
    re-packed); it needs ``cfg``. ``qk_norm_full`` is accepted for JAX's
    signature: OLMo-2's full-vector norm follows ``cfg``."""
    n_prefix, per, _ = _assign(params, n_stages, n_prefix_layers)
    n_pp = mesh.shape.get(_AXIS, 1)
    if n_pp != n_stages:
        raise ValueError(f"{n_stages} pipeline stages on a mesh whose {_AXIS!r} axis has {n_pp} ranks")
    if tp and cfg is None:
        raise ValueError("stack_stages(tp=True) needs cfg= for the Megatron plan")
    if tp and mesh.shape.get("tp", 1) == 1:
        raise ValueError("stack_stages(tp=True) needs a 'tp' axis in the mesh")
    pl = _tp_plan(mesh, cfg, {"layers": params["layers"]}) if tp else None
    r = mesh.coords.get(_AXIS, 0)
    mine = list(range(n_prefix + r * per, n_prefix + (r + 1) * per))
    if r == 0:
        mine = list(range(n_prefix)) + mine

    def put(v):
        return tree_unflatten(v, [t.to(mesh.device) for t in tree_flatten(v)[1]])

    out: dict = {"layers": {}}
    for g in mine:
        layer = params["layers"][g]
        out["layers"][g] = put(shard_layer(cfg, pl, layer, g) if pl is not None else layer)
    if r == 0:
        out["embed_tokens"] = put(params["embed_tokens"])
    if r == n_stages - 1:
        out["norm"] = put(params["norm"])
        if "lm_head" in params:
            out["lm_head"] = put(params["lm_head"])
        else:
            out["embed_tokens"] = put(params["embed_tokens"])
    return out


def stage_layout(mesh, cfg, stage: dict, zero1: bool = False) -> _Layout:
    """The :class:`~.train._Layout` of a stage tree: each leaf's whole shape
    and tensor-parallel cut (from ``cfg``'s plan), and ``counted`` False for
    a tied embedding's last-stage copy when there are several stages."""
    pl = _tp_plan(mesh, cfg, stage)
    n_tp = mesh.shape.get("tp", 1)
    r, n_pp = mesh.coords.get(_AXIS, 0), mesh.shape.get(_AXIS, 1)
    paths, leaves = tree_flatten(stage)
    shapes, cuts, counted = [], [], []
    for p, v in zip(paths, leaves):
        key, i, stack = _key_of(p)
        cut, shape = None, tuple(v.shape)
        if pl is not None:
            whole = list(shape)
            whole[1 if (key in _ROW_SPLIT and stack is None) else 0] *= n_tp
            cut = split_of(cfg, pl, key, torch.empty(whole, device="meta"), i, stack)
            shape = tuple(whole) if cut is not None else shape
        shapes.append(shape)
        cuts.append(cut)
        counted.append(not (p == ("embed_tokens",) and r == n_pp - 1 and r > 0))
    meta = tree_unflatten(stage, [torch.empty(s, device="meta") for s in shapes])
    return _Layout(mesh, meta, cuts, zero1=zero1, counted=counted)


def _check(mesh, cfg, B: int, n_microbatches: int) -> int:
    """JAX's refusals for a (B, T) batch; returns the microbatch size."""
    n_tp, n_dp = mesh.shape.get("tp", 1), mesh.shape.get("dp", 1)
    if n_tp > 1:
        moe_inter = (cfg.moe_intermediate_size or cfg.intermediate_size) if cfg.num_local_experts else 0
        H, KVH, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
        if H % n_tp or KVH % n_tp or inter % n_tp or moe_inter % n_tp:
            raise ValueError(f"tp={n_tp} must evenly divide heads/kv-heads/ffn ({H}/{KVH}/{inter}"
                             + (f"/experts {moe_inter}" if moe_inter else "") + ")")
    if B % n_microbatches != 0:
        raise ValueError(f"{n_microbatches} microbatches do not evenly divide batch {B}")
    mb = B // n_microbatches
    if mb % n_dp != 0:
        raise ValueError(f"dp={n_dp} must evenly divide the microbatch size {mb} (batch {B} / {n_microbatches} "
                         "microbatches)")
    return mb


class _Stage:
    """One rank's part of the schedule: its stage's layers in order, its
    place on the pp line and the tensor-parallel operators."""

    def __init__(self, mesh, cfg, stage: dict, remat: bool):
        self.mesh, self.cfg, self.stage, self.remat = mesh, cfg, stage, remat
        self.pp = mesh.comm(_AXIS)
        self.r, self.n = mesh.coords.get(_AXIS, 0), mesh.shape.get(_AXIS, 1)
        self.first, self.last = self.r == 0, self.r == self.n - 1
        self.layers = [(g, stage["layers"][g]) for g in sorted(stage["layers"])]
        self.tp = None
        if mesh.shape.get("tp", 1) > 1:
            self.tp = TrainTP(cfg, mesh.comm("tp"))
            if _packed(stage):
                self.tp.replan(quant_bits=4)
        self.dtype = None

    def act_dtype(self, x: Optional[torch.Tensor]) -> torch.dtype:
        """The activations' dtype, that of stage 0's embedded ``x`` (None on
        the other stages), learned by every stage over the pp line (one
        small all-reduce a schedule)."""
        if self.pp is None:
            return x.dtype
        code = torch.tensor([_DTYPES.index(x.dtype) + 1 if self.first else 0], dtype=torch.int64,
                            device=self.mesh.device)
        return _DTYPES[int(self.pp.all_reduce_sum(code)) - 1]

    def forward(self, ids: torch.Tensor, grad: bool):
        """Microbatch ``ids`` (b, T) through this stage: (the received input,
        or None on stage 0; the stage's output, sent on unless last)."""
        from ..models.llama import blocks_train, embed_train

        b, T = ids.shape
        x_in, x = None, (embed_train(self.stage, self.cfg, ids) if self.first else None)
        if self.dtype is None:
            self.dtype = self.act_dtype(x)
        if not self.first:
            buf = torch.empty((b, T, self.cfg.hidden_size), dtype=self.dtype, device=self.mesh.device)
            x_in = x = self.pp.recv(buf, self.r - 1)
            if grad:
                x_in.requires_grad_(True)
        y = blocks_train(self.cfg, self.layers, x, self.remat, self.tp)
        if not self.last:
            self.pp.send(y.detach(), self.r + 1)
        return x_in, y

    def backward(self, inputs: List, outputs: List) -> None:
        """An earlier stage's half of the backward: microbatch by microbatch
        in order, the output's gradient received from stage r + 1 and the
        input's sent to stage r - 1."""
        for x_in, y in zip(inputs, outputs):
            g = self.pp.recv(torch.empty_like(y), self.r + 1)
            torch.autograd.backward(y, g)
            self.send_back(x_in)

    def send_back(self, x_in) -> None:
        if x_in is not None:
            g = x_in.grad if x_in.grad is not None else torch.zeros_like(x_in)
            self.pp.send(g, self.r - 1)

    def reduce(self, value: torch.Tensor) -> torch.Tensor:
        """The last stage's f32 ``value`` on every stage (its sum with the
        others' zeros, exact)."""
        value = value.to(torch.float32)
        if self.pp is None:
            return value
        return self.pp.all_reduce_sum(value if self.last else torch.zeros_like(value))


def pipeline_forward_train(mesh, cfg, pp_params: dict, input_ids: torch.Tensor, n_microbatches: int,
                           remat: bool = False) -> Optional[torch.Tensor]:
    """The causal forward with the decoder stack pipelined over ``"pp"``:
    (B, T) ids (the whole batch, on every rank) -> f32 logits (B, T, V) on
    the last stage (gathered over dp), None on the others. ``pp_params`` is
    this rank's :func:`stack_stages` tree. Numerically the one-device
    ``forward_train``: the same blocks, microbatch by microbatch. Every rank
    of the mesh calls it. Gradients cross the stages through
    :func:`make_pp_loss` only."""
    input_ids = torch.as_tensor(input_ids).to(mesh.device)
    B = input_ids.shape[0]
    mb = _check(mesh, cfg, B, n_microbatches)
    from ..models.llama import head_train

    st = _Stage(mesh, cfg, pp_params, remat)
    dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    logits = []
    for m in range(n_microbatches):
        _, y = st.forward(_local_rows(input_ids, m, n_microbatches, dp, d), torch.is_grad_enabled())
        if st.last:
            out = head_train(pp_params, cfg, y)
            if dp > 1:  # JAX's rows of the microbatch, in dp order
                out = mesh.comm("dp").all_gather_flat(out.detach().reshape(-1)).reshape((mb,) + tuple(out.shape[1:]))
            logits.append(out)
    return torch.cat(logits) if st.last else None


class _PipelineLoss(torch.autograd.Function):
    """The schedule as one autograd function of the stage's leaves: forward
    runs every microbatch forward and returns this dp rank's mean NLL on
    every stage; backward runs GPipe's backward across the stages."""

    @staticmethod
    def forward(ctx, run, batch, *leaves):
        from ..models.llama import head_train

        mesh, cfg, template, M, remat = run
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            work = [v.detach().requires_grad_(bool(need) and v.is_floating_point()) for v, need in zip(leaves, needs)]
            stage = tree_unflatten(template, work)
            st = _Stage(mesh, cfg, stage, remat)
            dp, d = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
            inputs, outputs, nll = [], [], []
            for m in range(M):
                rows = _local_rows(batch, m, M, dp, d)
                x_in, y = st.forward(rows[:, :-1], True)
                inputs.append(x_in)
                outputs.append(y)
                if st.last:
                    logp = torch.log_softmax(head_train(stage, cfg, y), dim=-1)
                    nll.append(-torch.gather(logp, -1, rows[:, 1:, None].to(torch.int64))[..., 0].mean())
            local = torch.stack(nll).mean() if st.last else None
        ctx.saved = (st, work, inputs, outputs, local)
        return st.reduce(local.detach() if st.last else torch.zeros((), device=mesh.device))

    @staticmethod
    def backward(ctx, g):
        st, work, inputs, outputs, local = ctx.saved
        ctx.saved = None
        if st.last:
            torch.autograd.backward(local, g.to(local.dtype))
            for x_in in inputs:
                st.send_back(x_in)
        else:
            st.backward(inputs, outputs)
        # a leaf the loss does not reach (DeepSeek's selection bias) gets JAX's zero gradient
        return (None, None) + tuple((w.grad if w.grad is not None else torch.zeros_like(w)) if w.requires_grad
                                    else None for w in work)


def _pp_loss(mesh, cfg, n_microbatches: int, remat: bool, stage: dict, batch: torch.Tensor,
             leaves: List[torch.Tensor]) -> torch.Tensor:
    """This dp rank's mean next-token NLL over its rows of the (B, T+1)
    ``batch``, the same f32 value on every stage of its pp line,
    differentiable with respect to ``leaves`` (``stage``'s, in flatten
    order)."""
    batch = torch.as_tensor(batch).to(mesh.device)
    _check(mesh, cfg, batch.shape[0], n_microbatches)
    run = (mesh, cfg, stage, n_microbatches, remat)
    return _PipelineLoss.apply(run, batch, *leaves)


class _DpMean(torch.autograd.Function):
    """The mean over the dp ranks; its gradient is this rank's share."""

    @staticmethod
    def forward(ctx, x, comm, dp):
        ctx.dp = dp
        return comm.all_reduce(x) / dp

    @staticmethod
    def backward(ctx, g):
        return g / ctx.dp, None, None


def make_pp_loss(mesh, cfg, n_microbatches: int, remat: bool = False):
    """``loss_fn(pp_params, batch)``: the next-token mean NLL over the whole
    (B, T+1) ``batch`` through the pipeline, the same f32 value on every
    rank; differentiable with respect to the stage's leaves. A rank's
    gradient is its own part: over dp ranks (each its rows) and over a tied
    embedding's two copies the parts sum to the gradient (the train step
    sums them). ``remat`` checkpoints each block."""

    def loss_fn(pp_params: dict, batch) -> torch.Tensor:
        leaves = tree_flatten(pp_params)[1]
        local = _pp_loss(mesh, cfg, n_microbatches, remat, pp_params, batch, leaves)
        dp = mesh.shape.get("dp", 1)
        return _DpMean.apply(local, mesh.comm("dp"), dp) if dp > 1 else local

    return loss_fn
