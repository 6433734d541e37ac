"""Starting the merge ranks (counterpart of shardmerge_tpu/parallel/multihost.py).

The merge math needs no rank-specific kernel: the distributed-FFT pair merge
(parallel/merge.py) shards a tensor's rows over one flat group of ranks. What
several ranks need is:

1. the process group: ``initialize_distributed`` joins the ranks a launcher
   started (``torchrun`` or any launcher that sets the ``env://`` variables
   MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and
   LOCAL_WORLD_SIZE), over the transport the topology asks for
   (parallel/comm.py ``transport_for``);
2. a flat merge group ordered host by host (``merge_mesh``): the all-to-all
   is all-pairs, but keeping each host's ranks contiguous keeps the most
   shard boundaries inside a host;
3. host-local IO: every rank reads the input shards and copies only its own
   rows to its device; a sharded result is gathered to rank 0 in bounded
   row blocks at write-back (merge/base.py ``_to_host``), and only rank 0
   writes output files (the other ranks' writers are read_only). For resume
   to stay consistent, ``output_dir`` must be readable by every rank (each
   derives the skip list from the existing output); only rank 0 writes it.
   Hub inputs land in the host's ``storage_dir``: its local rank 0
   downloads each shard once and the host's other ranks wait for it
   (io/download.py roles).

Unlike the JAX package, which builds a mesh over every device a process
sees, the port shards only across ranks a launcher started: a plain
``merge`` on a host with several GPUs merges on one GPU
(``torchrun --nproc-per-node N`` shards it).
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import socket
from typing import Optional

import torch

from .comm import Comm, local_rank, local_world_size, transport_for

logger = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "merge_mesh", "shutdown_distributed"]

# the env:// rendezvous a launcher sets (torchrun, or any launcher that
# exports them); their presence starts the process group without a flag
_LAUNCHER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    if value is None:
        return None
    try:
        return int(value)
    except ValueError:
        # malformed env must degrade like every other failed probe
        logger.warning("ignoring malformed %s=%r", name, value)
        return None


def _device_kind(device: Optional[str]) -> str:
    req = (device or "").strip().lower()
    if req in ("cpu", "host") or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def initialize_distributed(force: bool = False, device: Optional[str] = None) -> bool:
    """Join the merge ranks' process group over the ``env://`` rendezvous.

    Attempted when the launcher's rendezvous variables are set, or when
    ``force=True`` (the config's ``distributed: true``). ``device`` is the
    merge's device request: ``cpu`` joins over gloo, a card over the
    transport of ``comm.transport_for``, which needs the launcher's
    LOCAL_RANK and LOCAL_WORLD_SIZE (BackendError naming the one that is
    missing). A failed probe degrades to a single-process run and is
    logged. Returns True when the group has more than one rank. Idempotent:
    a group already up is kept. ``SHARDMERGE_HEARTBEAT_TIMEOUT_S`` sets the
    rendezvous and collective timeout (seconds)."""
    import torch.distributed as dist

    if not dist.is_available():
        logger.info("torch.distributed is not available; running single-process")
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not (force or all(k in os.environ for k in _LAUNCHER_ENV_VARS)):
        logger.debug("single-process run; distributed runtime not started")
        return False
    kind = _device_kind(device)
    backend, staged = transport_for(kind)
    kwargs = {"init_method": "env://"}
    timeout = _env_int("SHARDMERGE_HEARTBEAT_TIMEOUT_S")
    if timeout:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    try:
        if backend == "nccl":
            torch.cuda.set_device(local_rank() % torch.cuda.device_count())
        dist.init_process_group(backend, **kwargs)
    except Exception as e:
        logger.info("distributed runtime not started (%s); running single-process", e)
        return False
    atexit.register(shutdown_distributed)
    logger.info(
        "distributed runtime up: rank %d/%d over %s%s (%s)",
        dist.get_rank(), dist.get_world_size(), backend, " with host-staged collectives" if staged else "",
        f"{local_world_size()} local ranks, {torch.cuda.device_count()} visible GPUs" if kind == "cuda"
        else "on the CPU",
    )
    return dist.get_world_size() > 1


def merge_mesh(device, host: Optional[str] = None) -> Comm:
    """The flat merge group over every rank, ordered host by host.

    Ranks are sorted by (their host's first rank, rank): each host's ranks
    take consecutive positions, and rank 0 takes position 0 (the rank that
    gathers and writes). ``host`` names this rank's host (default: the
    hostname). A collective: every rank calls it."""
    import torch.distributed as dist

    host = host if host is not None else socket.gethostname()
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host)
    first = {}
    for rank, h in enumerate(hosts):
        first.setdefault(h, rank)
    order = sorted(range(len(hosts)), key=lambda r: (first[hosts[r]], r))
    comm = Comm(device, order=order)
    comm.hosts = len(first)
    return comm
