"""Context parallelism: ring and Ulysses attention over a ``"cp"`` axis of
launched ranks (counterpart of shardmerge_tpu/parallel/ring.py).

The sequence is cut into P blocks of Tl tokens, block c on the rank at
position c of the cp line (parallel/mesh.py). Neither scheme ever holds the
full (T, T) scores on one rank; the ring does not hold the full K/V either.

- **Ring** (:func:`ring_body`): each rank scores its f32 queries against the
  K/V block it holds, folds the result into a running (acc, m, l) flash
  softmax, and passes the block on to position +1 (:class:`_Shift`, one
  ``Comm.exchange`` of K and V stacked). Causality, windows and Llama-4's
  chunks come from global positions ``position * Tl + arange(Tl)``, masked
  additively with -1e9; Gemma-2's softcap is applied to each hop's scores
  before the mask; GPT-OSS's sinks join once, in the final
  renormalization. Under a window (or chunk) of ``lookback`` tokens only
  ``min(P, ceil(lookback / Tl) + 1)`` blocks can reach a query, so only
  that many are scored and one fewer sent: blocks behind the window never
  move. JAX's scan also ships the block after the last hop; the port does
  not.
- **Ulysses** (:func:`ulysses_body`): two all-to-alls (:class:`_AllToAll`)
  trade the sequence split for a head split, each rank runs full causal
  attention over its H/P heads, and the output comes back the same way.

The backward is autograd's: :class:`_Shift`'s backward is the reverse
rotation (the gradient of a received block goes back to the rank that sent
it) and :class:`_AllToAll`'s is the same all-to-all. Every rank builds the
same graph, so every rank runs these transfers in one order, forward and
backward, and again when ``torch.utils.checkpoint`` recomputes a block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ring_body", "ring_attention", "ulysses_body", "ulysses_attention", "ring_hops", "stats"]

_NEG = -1e9

# blocks scored by ring_body since the process started (hops of every call)
stats = {"hops": 0}


class _Shift(torch.autograd.Function):
    """x to position +1, the block of position -1 back; the gradient the
    reverse way."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.exchange(x, (comm.position + 1) % comm.size, (comm.position - 1) % comm.size)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        return comm.exchange(g, (comm.position - 1) % comm.size, (comm.position + 1) % comm.size), None


class _AllToAll(torch.autograd.Function):
    """(P, ...) chunks by destination position -> (P, ...) by source; its
    own transpose, so the gradient takes the same all-to-all."""

    @staticmethod
    def forward(ctx, chunks, comm):
        ctx.comm = comm
        return comm._all_to_all("all_to_all", chunks)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_to_all("all_to_all", g.contiguous()), None


def ring_hops(n_dev: int, Tl: int, window: Optional[int] = None, chunk: Optional[int] = None) -> int:
    """Blocks a query block can see: P, or ``min(P, ceil(lookback / Tl) +
    1)`` under a window (or chunk, which wins) of ``lookback`` tokens."""
    lookback = chunk if chunk is not None else window
    return n_dev if lookback is None else min(n_dev, -(-int(lookback) // Tl) + 1)


def _line(comm) -> Tuple[int, int]:
    return (1, 0) if comm is None else (comm.size, comm.position)


def ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm, scale: float, *,
              window: Optional[int] = None, chunk: Optional[int] = None, softcap: Optional[float] = None,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention of this rank's block: q (B, H, Tl, D), k and v (B,
    KVH, Tl, D), the sequence block at ``comm``'s position (``comm`` None:
    one rank). ``scale`` multiplies the scores; ``window``, ``chunk``,
    ``softcap`` and ``sinks`` ((H,) logits) as in the module docstring.
    Returns (B, H, Tl, D) f32."""
    n_dev, rank = _line(comm)
    B, H, Tl, D = q.shape
    KVH = k.shape[1]
    group = H // KVH
    dev = q.device
    qg = q.to(torch.float32).reshape(B, KVH, group, Tl, D)
    q_pos = rank * Tl + torch.arange(Tl, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, group, Tl, D), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, group, Tl, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, group, Tl, 1), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    hops = ring_hops(n_dev, Tl, window, chunk)
    blk = rank
    for hop in range(hops):
        if hop:
            kv = _Shift.apply(kv, comm)
            blk = (blk - 1) % n_dev  # the block now held came from one position back
        k_pos = blk * Tl + torch.arange(Tl, device=dev)
        allowed = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            allowed = allowed & (k_pos[None, :] > q_pos[:, None] - window)
        if chunk is not None:
            allowed = allowed & (k_pos[None, :] >= torch.div(q_pos, chunk, rounding_mode="floor")[:, None] * chunk)
        s = torch.einsum("bkgtd,bksd->bkgts", qg, kv[0].to(torch.float32)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = s + torch.where(allowed, zero, neg)
        # the running max only shifts the exponents (the result does not
        # depend on it), so it carries no gradient: the scores are not kept
        # for amax's backward
        m_new = torch.maximum(m, s.detach().amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgts,bksd->bkgtd", p, kv[1].to(torch.float32))
        m = m_new
    stats["hops"] += hops
    if sinks is not None:
        s = sinks.to(torch.float32).reshape(1, KVH, group, 1, 1)
        mx = torch.maximum(m, s)
        out = acc * torch.exp(m - mx) / (l * torch.exp(m - mx) + torch.exp(s - mx))
    else:
        out = acc / l.clamp(min=1e-30)
    return out.reshape(B, H, Tl, D)


def _cp_comm(mesh):
    comm = mesh.comm("cp")
    n_dev = mesh.shape.get("cp", 1)
    return comm, n_dev


def _local(x: torch.Tensor, n_dev: int, c: int) -> torch.Tensor:
    Tl = x.shape[2] // n_dev
    return x[:, :, c * Tl:(c + 1) * Tl]


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention with the sequence cut over ``mesh``'s ``"cp"`` axis
    (JAX's ``ring_attention``): q (B, H, T, D), k and v (B, KVH, T, D), the
    whole sequence on every rank; returns this rank's block of the f32
    output, (B, H, T/P, D) at its cp position. P must divide T and KVH must
    divide H. Differentiable."""
    comm, n_dev = _cp_comm(mesh)
    B, H, T, D = q.shape
    if T % n_dev != 0:
        raise ValueError(f"sequence {T} does not divide cp={n_dev}")
    if H % k.shape[1] != 0:
        raise ValueError(f"{H} heads do not group over {k.shape[1]} kv heads")
    c = mesh.coords.get("cp", 0)
    return ring_body(_local(q, n_dev, c), _local(k, n_dev, c), _local(v, n_dev, c), comm, float(scale))


def ulysses_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm, scale: float) -> torch.Tensor:
    """Ulysses attention of this rank's sequence block: q (B, H, Tl, D), k
    and v (B, KVH, Tl, D) -> all-to-all to (B, H/P, T, D), full causal
    attention with an f32 softmax (-1e9 masked), all-to-all back. Returns
    (B, H, Tl, D) f32."""
    n_dev, _ = _line(comm)

    def seq_to_heads(x):
        B, Hx, Tl, D = x.shape
        chunks = x.reshape(B, n_dev, Hx // n_dev, Tl, D).transpose(0, 1)  # by destination: head blocks
        got = _AllToAll.apply(chunks.contiguous(), comm) if comm is not None else chunks
        return got.permute(1, 2, 0, 3, 4).reshape(B, Hx // n_dev, n_dev * Tl, D)  # by source: sequence blocks

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    B, Hl, T, D = qh.shape
    KVHl = kh.shape[1]
    qg = qh.to(torch.float32).reshape(B, KVHl, Hl // KVHl, T, D)
    scores = torch.einsum("bkgtd,bksd->bkgts", qg, kh.to(torch.float32)) * scale
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, torch.full((), _NEG, dtype=torch.float32, device=q.device))
    out = torch.einsum("bkgts,bksd->bkgtd", torch.softmax(scores, dim=-1), vh.to(torch.float32))
    Tl = T // n_dev
    chunks = out.reshape(B, Hl, n_dev, Tl, D).permute(2, 0, 1, 3, 4)  # by destination: sequence blocks
    got = _AllToAll.apply(chunks.contiguous(), comm) if comm is not None else chunks
    return got.transpose(0, 1).reshape(B, Hl * n_dev, Tl, D)  # by source: head blocks


def ulysses_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention, sequence cut over ``"cp"``, Ulysses style (JAX's
    ``ulysses_attention``): the whole q (B, H, T, D), k, v (B, KVH, T, D)
    on every rank; returns this rank's f32 output block (B, H, T/P, D). P
    must divide T, H and KVH (contiguous head blocks keep GQA groups
    whole). Differentiable."""
    comm, n_dev = _cp_comm(mesh)
    B, H, T, D = q.shape
    KVH = k.shape[1]
    if T % n_dev or H % n_dev or KVH % n_dev:
        raise ValueError(f"cp={n_dev} must evenly divide T={T}, H={H}, KVH={KVH}")
    c = mesh.coords.get("cp", 0)
    return ulysses_body(_local(q, n_dev, c), _local(k, n_dev, c), _local(v, n_dev, c), comm, float(scale))
