"""Merge orchestration base (counterpart of shardmerge_tpu/merge/base.py).

Per tensor: host tensor -> the merge device -> f32 deltas -> the engine's
reduction -> ``base + delta`` -> bf16 -> host -> writer, run as a software
pipeline so that host work overlaps the device's:

- the host reads of the next ``prefetch_depth`` layers run in a worker pool,
  each into an owned host copy (page-locked when the engine runs on a card;
  ``OfflineMultiModelIndex.preload_tensor``);
- the next ``device_prefetch_depth`` of those layers are copied to the card
  as their reads land, from the page-locked copies on a separate copy
  stream; the merge stream waits on the copy's event before it reads the
  tensor, and ``record_stream`` ties the buffer's reuse to the merge stream;
- a merged tensor is copied to page-locked host memory without blocking
  and written one layer later, after the next layer's merge is issued;
- shards are written on the writer's own thread (``background_flush``).

A read-ahead that fails falls back to the demand read on the same device,
counted in ``MergeStats.prefetch_failures``. Late read-aheads of a layer
already merged are dropped (``_released_layers``). ``prefetch_depth=0``
turns read-ahead off: every tensor is read on demand, as a zero-copy view
of its shard file copied to the device where it is needed.

Every tensor merges on the one device the engine was given: the JAX
package's size routing to the host (``small_tensor_numel``,
``huge_tensor_numel``) answers a TPU's compile cost and a 16 GB chip and has
no counterpart on an 80 GB card. The arithmetic, for the largest merged
tensor (embed and lm_head are passthrough, never merged) and N finetunes:
the f32 delta stack holds N copies, one pair merge about 8 more (inputs,
two complex half spectra, masks, order-statistic keys, the inverse), and
the bf16 inputs of this layer and the staged next one 2 (N + 1) halves.

- Llama-3.1-70B, 28672 x 8192 = 2.35e8 elements, 0.94 GB in f32: N = 4
  needs 3.8 + 7.5 + 4.7 = 16 GB, N = 16 needs 15 + 7.5 + 16 = 39 GB. Fits.
- Llama-3.1-405B, 53248 x 16384 = 8.72e8 elements, 3.49 GB in f32: N = 4
  needs 14 + 28 + 17 = 59 GB and fits; N = 6 needs 21 + 28 + 24 = 73 GB;
  from N = 7 on (80 GB) the stack must spill. ``hbm_budget_gb`` does that:
  above the budget, stack entries wait in page-locked host memory between
  pair merges, so the working set stays near the pair's 28 GB plus the
  inputs.

So there is no size routing: a merge that does not fit sets
``hbm_budget_gb`` (or ``device_prefetch_depth=0``), or shards over several
GPUs (below).

Across merge ranks (an engine's ``_sharding_for`` returning a
:class:`Placement`), each rank copies only its own rows of a split tensor to
its device, zero-padded where the rows do not divide the ranks: the demand
fetch and the read-ahead staging alike (every rank reads the input shards
on its own host, as in the JAX package). A split result is gathered to rank
0 in row blocks of at most ``SHARDMERGE_GATHER_BLOCK_BYTES`` (default 256
MiB) at write-back, and the other ranks keep no copy. Only rank 0 writes:
the others' writers are read_only, and the README is rank 0's. Every
collective runs on the merge thread in layer order (the merge, then the
gather); the read-ahead workers and the writer's thread run none. Engines
that never shard run redundantly on every rank, and rank 0 writes.

A GPTQ or AWQ finetune reaches the merge decoded to f32 (``io/index.py``,
on a read-ahead worker), twice a bf16 input's bytes, so its inputs term is
1 unit, not a half: with P packed finetunes among N the inputs of this
layer and the staged next one take 2 (N + 1 + P) halves, the page-locked
host copies of the ``prefetch_depth`` (2) layers read ahead as many, and
``h2d_bytes`` grows by P halves a layer. (A LoRA adapter's tensor is fused
into the base's dtype: no change.) With every finetune packed:

- Llama-3.1-70B: N = 4 needs 3.8 + 7.5 + 8.5 = 20 GB on the card, N = 16
  15 + 7.5 + 31 = 54 GB. Fits.
- Llama-3.1-405B: N = 4 needs 14 + 28 + 31 = 73 GB and fits; from N = 5
  (84 GB) the merge sets ``hbm_budget_gb`` or ``device_prefetch_depth=0``
  (which drops the staged layer's 19 GB), two finetunes sooner than with
  bf16 inputs. The host holds 31 GB of page-locked read-ahead at N = 4.

The other engines keep their N f32 deltas (or N inputs) as the JAX engines
stack them, but take thresholds, ranks and masks one model at a time, so
that the temporaries of a select, an argsort or a mask exist for one model,
not for N. For the 405B tensor above with N = 4 finetunes (stack 14 GB,
bf16 inputs and the staged next layer 17 GB):

- ties, breadcrumbs: one model's |delta|, its int32 select keys and a bool
  mask, 3.5 + 3.5 + 0.9 = 7.9 GB; then the sign election
  (``ties.elect_disjoint_mean``): its running total and one f32 scratch,
  the elected sign (int8), the count (int16) and one bool mask, 3.5 + 3.5 +
  0.9 + 1.7 + 0.9 = 10.5 GB, with the division and ``lam * x + base`` in
  place (``ties.finish``): peak 14 + 17 + 10.5 = 42 GB;
- dare, della: each mask is drawn in chunks of 2^22 elements (int64
  threefry words, under 0.2 GB); della takes its ranks and probabilities by
  row chunks of at most 2^22 elements, so its argsort never holds a whole
  tensor's int64 indices (7 GB): peak as ties;
- model-stock: the stack copy of the N deltas, 14 GB, while the deltas
  live (the Gram then takes one product, 3.5 GB): 45 GB;
- linear, addition, task-addition: the sum and one delta, 7 GB: 38 GB;
- slerp: two f32 endpoints and their unit vectors, 14 GB: 31 GB;
- fourier-legacy: its exact pair merge keeps both full complex spectra
  (4 planes) while the imaginary recursion holds two more spectra and its
  blend's temporaries, about 15 planes, 52 GB; with the stack, the f32
  base and the staged next layer (its own bf16 inputs are dropped once
  its deltas exist), 14 + 3.5 + 8.7 + 52 = 78 GB. That is at the card's
  limit (a count, not a measurement): ``device_prefetch_depth=0`` frees
  the staged 8.7 GB.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..config import MergeConfig, MergeModel
from ..constants import INPUT_LAYER, OUTPUT_LAYER
from ..io.index import OfflineMultiModelIndex
from ..io.writer import ModelWriter, ShardLayer
from ..ops.profiling import MergeStats, phase_profiler

logger = logging.getLogger(__name__)

# worker threads for host read-ahead (each copies one tensor at a time)
_READ_WORKERS = 4


def _f32(value, device):
    """A host float (or list of floats) as f32 on ``device``; on a card the
    copy is issued from page-locked memory without blocking (a pageable
    copy would wait for the stream). A division by a Python float on a card
    multiplies by its reciprocal; by such a tensor it divides."""
    t = torch.tensor(value, dtype=torch.float32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclass(frozen=True)
class Placement:
    """A tensor split over the merge ranks of ``comm`` (parallel/comm.py):
    ``"rows"`` (2-D, by rows, zero-padded to a multiple of the ranks) or
    ``"lead"`` (ndim >= 3, by the leading dim, which divides the ranks).
    ``shape`` is the whole tensor's true shape."""

    comm: object
    kind: str
    shape: tuple

    @property
    def pad(self) -> int:
        """Zero rows appended to the whole tensor (rows only)."""
        return -self.shape[0] % self.comm.size if self.kind == "rows" else 0

    @property
    def true_m(self) -> Optional[int]:
        """The true row count when rows were padded, else None."""
        return self.shape[0] if self.pad else None

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def local(self, host: torch.Tensor) -> torch.Tensor:
        """This rank's share of the whole host tensor: a view of its rows,
        or a zero-padded copy for a rank whose block crosses the end."""
        m = (self.shape[0] + self.pad) // self.comm.size
        r0 = self.comm.position * m
        if r0 + m <= self.shape[0]:
            return host[r0:r0 + m]
        out = torch.zeros((m,) + tuple(host.shape[1:]), dtype=host.dtype, device=host.device,
                          pin_memory=host.is_pinned())
        if r0 < self.shape[0]:
            out[:self.shape[0] - r0].copy_(host[r0:])
        return out


def is_primary() -> bool:
    """Whether this process writes output: rank 0 of a process group, or
    the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MergeTensorsBase(ABC):
    """Merges finetuned models by computing and combining their deltas."""

    # ``method_options`` keys this engine accepts (the CLI refuses others)
    OPTIONS: frozenset = frozenset()

    def __init__(
        self,
        config: MergeConfig,
        index_manager: Optional[OfflineMultiModelIndex] = None,
        *,
        device,
        prefetch_depth: int = 2,
        device_prefetch_depth: int = 1,
        background_flush: bool = True,
    ):
        self.config = config
        self.index_manager = (
            index_manager if index_manager is not None else OfflineMultiModelIndex()
        )
        self.device = torch.device(device)
        self.stats = MergeStats()
        # layers read ahead on the host, and how many of those are also
        # staged on the device (<= prefetch_depth)
        self.prefetch_depth = prefetch_depth
        self.device_prefetch_depth = device_prefetch_depth
        self.background_flush = background_flush
        # per written tensor, seconds on the merge thread: read / h2d
        # (demand waits during its merge), merge (_merge_layer), flush
        # (device->host wait + staging), and wall (its own stages: merge,
        # the device->host issue and flush; over a run they sum to the
        # loop's wall but for the read-ahead issue)
        self.tensor_spans: Dict[str, Dict[str, float]] = {}
        # (model_uri, tensor_name) -> tensor already on the device for the
        # layer being merged: a shared base is copied once, not per delta
        self._placed: dict = {}
        # read-ahead state, on the merge thread: host reads and device
        # stagings in flight by (model_uri, tensor_name)
        self._reads: Dict[tuple, Future] = {}
        self._staged: Dict[tuple, Future] = {}
        # layers whose merge returned: a late read-ahead drops its result
        self._released_layers: set = set()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._copy_stream = None
        self._stats_lock = threading.Lock()
        # tensor name -> its Placement over the merge ranks, for the layer
        # being merged (set by its fetches, taken by the write-back)
        self._placements: Dict[str, Placement] = {}

    @abstractmethod
    def get_readme(self) -> str:
        """README text for the output model."""

    @abstractmethod
    def _merge_layer(self, shard_layer: ShardLayer) -> torch.Tensor:
        """The merged tensor for one layer (on the device or the host)."""

    def _sharding_for(self, host: torch.Tensor) -> Optional[Placement]:
        """How a host tensor is split over the merge ranks; None: whole on
        this rank's device. Engines that shard override it (a pure function
        of the tensor: read-ahead workers call it too)."""
        return None

    # -- tensors onto the device ---------------------------------------------

    def _fetch(self, model_uri: str, tensor_name: str) -> torch.Tensor:
        """The tensor on the merge device, copied once per layer: from a
        device-staged read-ahead when one was issued, else from the host
        copy of its read-ahead (waited for), else from the index's shard
        view."""
        key = (model_uri, tensor_name)
        cached = self._placed.get(key)
        if cached is not None:
            self.stats.h2d_dedup_hits += 1
            return cached
        t0 = time.perf_counter()
        staged = self._take_staged(key)
        if staged is None:
            read = self._reads.get(key)
            # a read-ahead in flight is waited for; one that failed or was
            # dropped gave None, and the demand read retries it
            host = read.result() if read is not None else None
            if host is None:
                host = self.index_manager.get_tensor(model_uri, tensor_name)
            t1 = time.perf_counter()
            self.stats.span_fetch_s += t1 - t0
            placement = self._sharding_for(host)
            if placement is not None:
                host = placement.local(host)
            placed = host.to(self.device, non_blocking=True)
            self.stats.span_h2d_s += time.perf_counter() - t1
            self.stats.h2d_bytes += host.nbytes
        else:
            placed, placement = staged
            self.stats.span_fetch_s += time.perf_counter() - t0
        if placement is not None:
            self._placements[tensor_name] = placement
            self.stats.tensors_sharded += 1
        self._placed[key] = placed
        return placed

    def _take_staged(self, key) -> Optional[Tuple[torch.Tensor, Optional[Placement]]]:
        """A device-staged read-ahead of ``key`` (with its placement), made
        safe for the merge stream, or None (none started, dropped, or
        failed)."""
        staged = self._staged.pop(key, None)
        if staged is None:
            return None
        try:
            got = staged.result()
        except Exception:
            logger.warning("staging %s of %s on the device failed; reading it on demand",
                           key[1], key[0], exc_info=True)
            with self._stats_lock:
                self.stats.prefetch_failures += 1
            return None
        if got is None:
            return None
        tensor, copied, placement = got
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(copied)
        tensor.record_stream(stream)
        self.stats.prefetch_device_hits += 1
        self.stats.h2d_bytes += tensor.nbytes
        return tensor, placement

    def get_base_output_tensor(self, shard_layer: ShardLayer) -> torch.Tensor:
        """Output-base tensor in f32."""
        t = self._fetch(self.config.output_base_model, shard_layer.layer_name)
        return t.to(torch.float32)

    def get_delta_for_models(
        self,
        models: List[MergeModel],
        shard_layer: ShardLayer,
        apply_alpha: bool = True,
    ) -> List[torch.Tensor]:
        """Per-model f32 deltas ``(ft - base) [* alpha]``, each against the
        model's own base."""
        name = shard_layer.layer_name
        results = []
        for model in models:
            base = self._fetch(model.base, name)
            finetune = self._fetch(model.model, name)
            delta = finetune.to(torch.float32) - base.to(torch.float32)
            if apply_alpha:
                delta = delta * model.alpha
            results.append(delta)
        # the inputs are consumed: dropping them lets the device reclaim
        # them during a multi-round reduction (the output base stays)
        for model in models:
            self._placed.pop((model.model, name), None)
            if model.base != self.config.output_base_model:
                self._placed.pop((model.base, name), None)
        return results

    def _covering(self, shard_layer: ShardLayer) -> List[MergeModel]:
        """The finetunes whose layer range takes this layer, in config order."""
        return [m for m in self.config.finetune_merge if m.use_layer_index(shard_layer.layer_number)]

    def _layer_sources(self, shard_layer: ShardLayer) -> Tuple[List[str], Optional[str]]:
        """(the models whose tensor of this layer the merge copies to the
        device, the model whose tensor it passes through or None). Both the
        read-ahead and the engine's fetches follow it.

        Default, the delta engines': an input/output layer passes through
        the first model flagged is_input/is_output (else the base); any
        other fetches the output base and each covering model with its own
        base (only the base when none covers the layer)."""
        number = shard_layer.layer_number
        if number in (INPUT_LAYER, OUTPUT_LAYER):
            return [], self._passthrough_source("input" if number == INPUT_LAYER else "output")
        uris = [self.config.output_base_model]
        for m in self._covering(shard_layer):
            uris += [m.model, m.base]
        return list(dict.fromkeys(uris)), None

    def _delta_engine_inputs(self, shard_layer: ShardLayer):
        """The shared prologue of the delta engines: the input/output
        passthrough, the layer gates (``use_layer_index``) and the output
        base in f32.

        Returns ``(models, base)`` for a real merge, or ``(None, tensor)``
        when the layer resolves without one (a passthrough view, or the base
        when no model covers the layer)."""
        _, passthrough = self._layer_sources(shard_layer)
        if passthrough is not None:
            which = "input" if shard_layer.layer_number == INPUT_LAYER else "output"
            return None, self._passthrough(shard_layer, which, passthrough)
        models = self._covering(shard_layer)
        base = self.get_base_output_tensor(shard_layer)
        if not models:
            logger.warning("No models cover layer %s; passing base through", shard_layer.layer_name)
            return None, base
        return models, base

    def _passthrough(self, shard_layer: ShardLayer, which: str, uri: Optional[str] = None) -> torch.Tensor:
        """Input/output layer passthrough, counted: the host view of
        ``uri``'s tensor (default: the first model flagged
        is_input/is_output, else the base), never merged."""
        if uri is None:
            uri = self._passthrough_source(which)
        self.stats.tensors_passthrough += 1
        logger.info("Passthrough - %s is an %s layer, using %s", shard_layer.layer_name, which, uri)
        return self.index_manager.get_tensor(uri, shard_layer.layer_name)

    def _passthrough_source(self, which: str) -> str:
        flag = "is_input" if which == "input" else "is_output"
        chosen = next(
            (m for m in self.config.finetune_merge if getattr(m, flag)), None
        )
        return chosen.model if chosen is not None else self.config.output_base_model

    # -- read-ahead ------------------------------------------------------------

    def _prefetch_layer(self, shard_layer: ShardLayer, to_device: bool):
        """Start host reads of every tensor this layer will fetch (page-locked
        copies when the engine runs on a card), and with ``to_device`` their
        copies to the card as the reads land. Idempotent: a layer is asked
        for on several iterations, first host-only."""
        name = shard_layer.layer_name
        pin = self.device.type == "cuda"
        uris, passthrough = self._layer_sources(shard_layer)
        if passthrough is not None:
            # a passthrough layer hands its one source's shard-file view to
            # the writer: read it into the page cache, copy nothing
            if (passthrough, name) not in self._reads:
                self._reads[(passthrough, name)] = self._pool.submit(self._read_ahead, passthrough, name, None)
        to_device = to_device and pin
        for uri in uris:
            key = (uri, name)
            read = self._reads.get(key)
            if read is None:
                read = self._reads[key] = self._pool.submit(self._read_ahead, uri, name, pin)
            if to_device and key not in self._staged and key not in self._placed:
                self._staged[key] = self._stage(key, read)

    def _read_ahead(self, uri: str, name: str, pin: Optional[bool]) -> Optional[torch.Tensor]:
        """Worker thread: the host copy of one tensor (page-locked with
        ``pin``; with ``pin=None`` only a page-cache read, no copy), or None
        when the layer is already merged or the read failed (the demand read
        then retries it and raises)."""
        if name in self._released_layers:
            return None
        try:
            if pin is None:
                self.index_manager.advise_tensor(uri, name)
                return None
            host = self.index_manager.preload_tensor(uri, name, pin_memory=pin)
        except Exception:
            logger.warning("read-ahead of %s from %s failed; reading it on demand",
                           name, uri, exc_info=True)
            with self._stats_lock:
                self.stats.prefetch_failures += 1
            return None
        if name in self._released_layers:
            # the merge thread released the layer while this read ran: do
            # not leave the copy cached (it marks the layer released before
            # evicting, so one of the two evictions sees the copy)
            self.index_manager.release_tensor(uri, name)
            return None
        return host

    def _stage(self, key, read: Future) -> Future:
        """A future of (device tensor, copy event, placement), started on the
        copy stream once the host read lands (in the reading thread, or here
        if it already has); a split tensor stages this rank's rows only."""
        staged: Future = Future()

        def on_read(done: Future):
            if done.cancelled():  # the pool shut down (the merge ended)
                staged.cancel()
                return
            host = done.result()  # _read_ahead never raises
            if host is None or key[1] in self._released_layers:
                staged.set_result(None)
                return
            try:
                placement = self._sharding_for(host)
                if placement is not None:
                    host = placement.local(host)
                with torch.cuda.stream(self._copy_stream):
                    tensor = host.to(self.device, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self._copy_stream)
            except Exception as e:  # e.g. out of device memory: demand read
                staged.set_exception(e)
                return
            staged.set_result((tensor, copied, placement))

        read.add_done_callback(on_read)
        return staged

    # -- the merge loop ----------------------------------------------------------

    def initialize(self):
        """Register every model and require identical key sets."""
        self.index_manager.add_model(self.config.output_base_model)
        self.index_doc = self.index_manager.get_index(self.config.output_base_model)
        for model in self.config.finetune_merge:
            for ref in (model.base, model.model):
                if ref not in self.index_manager:
                    self.index_manager.add_model(ref)
        base_keys = self.index_manager.get_model_keys(self.config.output_base_model)
        for model in self.config.finetune_merge:
            model_keys = self.index_manager.get_model_keys(model.model)
            if model_keys != base_keys:
                raise ValueError(
                    f"Model {model.model} architecture mismatch with base model "
                    f"{self.config.output_base_model}\n"
                    f"Missing keys: {base_keys - model_keys}\n"
                    f"Extra keys: {model_keys - base_keys}"
                )

    def merge(self) -> MergeStats:
        """Run the whole merge; tensors already in the output are skipped."""
        self.initialize()
        layer_order = self.index_manager.get_layer_order(self.config.output_base_model)
        writer = self._open_writer(layer_order)
        # one pipeline over every shard's pending tensors: read-ahead
        # crosses shard boundaries (the writer still completes shards in
        # order, as each one's last tensor arrives)
        layers = [sl for shard in writer.shard_layers() for sl in shard if not sl.written]
        if self.prefetch_depth > 0:
            self._pool = ThreadPoolExecutor(max_workers=_READ_WORKERS, thread_name_prefix="read-ahead")
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
        try:
            self._process_layers(writer, layers)
            writer.finalize()
        finally:
            writer.close()
            if self._pool is not None:
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None
            self._reads.clear()
            self._staged.clear()
        if is_primary():
            (self.config.output_path / "README.md").write_text(self.get_readme())
        logger.info("Merge complete. Output saved to %s", self.config.output_path)
        logger.info("Merge stats: %s", self.stats.summary())
        return self.stats

    def _open_writer(self, layer_order: List[str]) -> ModelWriter:
        """The output writer: rank 0's writes, every other rank's is
        read_only. Under a process group every rank derives its skip list
        (the tensors already written) before rank 0 writes anything: rank 0
        opens first (creating the directory and the index), then the others
        read the output, then the merge starts (two barriers)."""
        import torch.distributed as dist

        primary = is_primary()

        def open_():
            return ModelWriter(
                base_index=self.index_doc,
                output_path=self.config.output_path,
                layer_order=layer_order,
                output_astype=self.config.output_astype,
                write_through=self.config.write_through,
                background_flush=self.background_flush,
                read_only=not primary,
            )

        if primary and not (dist.is_available() and dist.is_initialized()):
            return open_()
        writer = open_() if primary else None
        dist.barrier()
        if not primary:
            writer = open_()
        dist.barrier()
        return writer

    def _process_layers(self, writer: ModelWriter, shard_layers: List[ShardLayer]):
        """Merge layer i while layers i+1..i+prefetch_depth are read (the
        first device_prefetch_depth of them staged on the card), and write
        layer i-1 back once layer i's merge is issued."""
        pending = None
        for i, shard_layer in enumerate(shard_layers):
            for j, ahead in enumerate(shard_layers[i + 1:i + 1 + self.prefetch_depth]):
                self._prefetch_layer(ahead, to_device=j < self.device_prefetch_depth)
            name = shard_layer.layer_name
            read0, h2d0 = self.stats.span_fetch_s, self.stats.span_h2d_s
            t0 = time.perf_counter()
            try:
                with phase_profiler(f"merge {name}", device=self.device):
                    out = self._merge_layer(shard_layer)
            except Exception as e:
                logger.error("Error processing %s: %s", name, e)
                raise
            merge_s = time.perf_counter() - t0
            self.stats.span_merge_s += merge_s
            self._release_placed(name)
            host, copied = self._to_host(out, self._placements.pop(name, None))
            spans = {
                "wall_s": time.perf_counter() - t0,
                "read_s": self.stats.span_fetch_s - read0,
                "h2d_s": self.stats.span_h2d_s - h2d0,
                "merge_s": merge_s,
            }
            if pending is not None:
                self._flush(writer, pending)
            pending = (name, host, copied, spans)
        if pending is not None:
            self._flush(writer, pending)

    def _to_host(self, out: torch.Tensor, placement: Optional[Placement] = None):
        """(host tensor, copy event): a device result is cast to the output
        dtype on the device (the writer's rounding, done before the copy) and
        copied to page-locked memory without blocking; a host one is passed
        on. A split result (``placement``) is gathered to rank 0 in row
        blocks (a collective, on the merge thread in layer order); the other
        ranks get a zero-stride stand-in of its shape (their writer is
        read_only) and keep no copy."""
        if placement is not None:
            out = out.to(self.config.output_astype)
            limit = int(os.environ.get("SHARDMERGE_GATHER_BLOCK_BYTES", 256 << 20))
            whole = placement.comm.gather_rows(out, limit)
            if whole is None:
                return torch.zeros((), dtype=out.dtype).expand(placement.shape), None
            return whole[:placement.shape[0]], None
        if out.device.type != "cuda":
            return out, None
        out = out.to(self.config.output_astype)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _flush(self, writer: ModelWriter, pending):
        """Check the layer's deferred flags, wait for its device->host copy
        and stage it with the writer."""
        name, host, copied, spans = pending
        try:
            self._check_deferred(name)
            t0 = time.perf_counter()
            if copied is not None:
                copied.synchronize()
            writer.add_tensor(name, host)
        except Exception as e:
            logger.error("Error processing %s: %s", name, e)
            raise
        flush_s = time.perf_counter() - t0
        self.stats.span_flush_s += flush_s
        self.stats.tensors_merged += 1
        # the bytes the writer stores, on either device
        self.stats.bytes_written += host.numel() * self.config.output_astype.itemsize
        spans["wall_s"] += flush_s
        self.tensor_spans[name] = {**spans, "flush_s": flush_s}
        self._evict_layer(name)

    def _check_deferred(self, layer_name: str):
        """Hook for engines that check device-side flags at write time."""

    def _release_placed(self, tensor_name: str):
        """The layer's merge returned: drop its device copies and any
        staging that was never taken (pending work keeps its buffers alive
        on its own)."""
        self._released_layers.add(tensor_name)
        for table in (self._placed, self._staged):
            for key in [k for k in table if k[1] == tensor_name]:
                del table[key]

    def _evict_layer(self, tensor_name: str):
        """Drop the layer's host copies and views."""
        for key in [k for k in self._reads if k[1] == tensor_name]:
            del self._reads[key]
        models = {self.config.output_base_model}
        for m in self.config.finetune_merge:
            models.update((m.model, m.base))
        for model in models:
            self.index_manager.release_tensor(model, tensor_name)
