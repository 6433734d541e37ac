"""Merge counters and a phase profiler (counterpart of
shardmerge_tpu/ops/profiling.py).

:class:`phase_profiler` logs wall clock, host RSS and, on a CUDA device, the
allocator's live bytes from ``torch.cuda.memory_stats``. It is off unless
``display=True`` or ``SHARDMERGE_PROFILE=1``. :class:`MergeStats` holds the
per-run counters the merge engine logs at the end. :func:`trace` records a
``torch.profiler`` trace of a block (the CLI's ``--trace-dir``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["phase_profiler", "MergeStats", "device_memory_stats", "trace"]


def _rss_bytes() -> int:
    try:
        import psutil
    except ImportError:
        return 0
    return psutil.Process().memory_info().rss


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live and peak allocator bytes on a CUDA device ({} for the CPU)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
    }


@contextlib.contextmanager
def phase_profiler(title: str = "phase", display: Optional[bool] = None, device=None):
    enabled = (
        display
        if display is not None
        else os.environ.get("SHARDMERGE_PROFILE", "") == "1"
    )
    if not enabled:
        yield
        return
    rss_before = _rss_bytes()
    dev_before = device_memory_stats(device)
    start = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start
        parts = [
            f"{title}: {elapsed * 1000:.1f} ms",
            f"rss {(_rss_bytes() - rss_before) / 2**20:+.1f} MB",
        ]
        dev_after = device_memory_stats(device)
        if dev_after:
            delta = dev_after["bytes_in_use"] - dev_before.get("bytes_in_use", 0)
            parts.append(
                f"device {dev_after['bytes_in_use'] / 2**20:.1f} MB "
                f"(delta {delta / 2**20:+.1f} MB, peak "
                f"{dev_after['peak_bytes_in_use'] / 2**20:.1f} MB)"
            )
        logger.info("[profile] %s", " | ".join(parts))


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Record a torch.profiler trace of the block (host, and the card's
    kernels when CUDA is available) into ``trace_dir/trace.json``, which
    Perfetto and chrome://tracing open; nothing when no directory is given."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
    logger.info("wrote a torch.profiler trace to %s", os.path.join(str(trace_dir), "trace.json"))


@dataclass
class MergeStats:
    """Aggregate counters for one merge run."""

    tensors_merged: int = 0
    tensors_passthrough: int = 0
    pair_merges: Dict[str, int] = field(
        default_factory=lambda: {"add": 0, "arith": 0, "slerp": 0, "lowratio": 0}
    )
    bytes_written: int = 0
    nans_scrubbed: int = 0
    # blocking device->host reads the reduction makes: the stack's first
    # norms, each later round's merged-entry norms, the fused path's regime
    # (one per reduction round of a tensor)
    host_syncs: int = 0
    # delta-stack entries moved to pinned host memory under hbm_budget_bytes
    hbm_spills: int = 0
    # summed wall seconds on the merge thread: waits for host tensor reads
    # (demand reads and unfinished read-aheads), host->device copies issued
    # on demand, _merge_layer (through its last host sync), and the
    # write-back (device->host wait + shard staging or write)
    span_fetch_s: float = 0.0
    span_h2d_s: float = 0.0
    span_merge_s: float = 0.0
    span_flush_s: float = 0.0
    # host->device bytes (demand copies and device-staged read-aheads) and
    # copies saved by the per-layer placement dedupe
    h2d_bytes: int = 0
    h2d_dedup_hits: int = 0
    # Hub downloads: bytes, and the wall from the first transfer's start to
    # the last one's end
    download_bytes: int = 0
    download_wall_s: float = 0.0
    # read-ahead pipeline: input tensors taken already staged on the device,
    # and read-aheads that failed (the merge then read on demand)
    prefetch_device_hits: int = 0
    prefetch_failures: int = 0
    # input tensors split over the merge ranks (this rank's shares fetched)
    tensors_sharded: int = 0
    started_at: float = field(default_factory=time.time)

    def record_pair(self, regime: str):
        self.pair_merges[regime] = self.pair_merges.get(regime, 0) + 1

    def summary(self) -> str:
        elapsed = time.time() - self.started_at
        pairs = ", ".join(f"{k}={v}" for k, v in self.pair_merges.items() if v)
        text = (
            f"merged {self.tensors_merged} tensors "
            f"(+{self.tensors_passthrough} passthrough) in {elapsed:.1f}s; "
            f"pair regimes: {pairs or 'none'}; "
            f"wrote {self.bytes_written / 2**30:.2f} GiB"
        )
        if self.nans_scrubbed:
            text += f"; scrubbed {self.nans_scrubbed} NaNs"
        if self.span_merge_s:
            text += (
                f"; spans fetch={self.span_fetch_s:.1f}s h2d={self.span_h2d_s:.1f}s "
                f"merge={self.span_merge_s:.1f}s flush={self.span_flush_s:.1f}s"
            )
        if self.h2d_bytes:
            text += (
                f"; h2d {self.h2d_bytes / 2**30:.2f} GiB "
                f"({self.h2d_dedup_hits} deduped puts, "
                f"{self.prefetch_device_hits} staged ahead)"
            )
        if self.host_syncs:
            text += f"; {self.host_syncs} host syncs"
        if self.hbm_spills:
            text += f"; {self.hbm_spills} stack entries spilled to host"
        if self.tensors_sharded:
            text += f"; sharded {self.tensors_sharded} input tensors over the merge ranks"
        if self.prefetch_failures:
            text += f"; {self.prefetch_failures} read-aheads failed"
        return text
