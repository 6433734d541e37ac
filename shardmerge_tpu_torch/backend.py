"""Device selection for the CLI entry points (counterpart of
shardmerge_tpu/backend.py).

A merge or a decode that silently fell back to the host CPU would "work" for
days, so the rule is the JAX package's: the CPU is used only when asked for
(``--device cpu``); with no GPU and no such request the entry point fails.
"""

from __future__ import annotations

from typing import Optional

import torch


class BackendError(RuntimeError):
    """No usable device for the requested placement."""


def resolve_device(requested: Optional[str] = None) -> torch.device:
    """``cpu``/``host`` -> the CPU; anything else (None, ``cuda``,
    ``cuda:N``, a config's legacy ``tpu``) -> a CUDA device, which must
    exist. Under a process group of merge ranks (parallel/multihost.py) a
    card request without an index takes ``cuda:LOCAL_RANK % count``, so the
    ranks of a host spread over its GPUs (and share them when there are
    more ranks than GPUs)."""
    req = (requested or "").strip().lower()
    if req in ("cpu", "host"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise BackendError(
            "no CUDA device is visible; pass --device cpu to run on the host"
        )
    if req.startswith("cuda:"):
        return torch.device(req)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from .parallel.comm import local_rank

        return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")
    return torch.device("cuda:0")


def get_device() -> str:
    """The best device kind torch sees: ``"gpu"`` or ``"cpu"`` (the JAX
    package's ``utils.get_device``)."""
    return "gpu" if torch.cuda.is_available() else "cpu"
