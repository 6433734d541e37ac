"""Command-line interface (counterpart of shardmerge_tpu/cli.py), on argparse.

The twelve commands of the JAX CLI, with its option names::

    merge CONFIG [--method M] [--device cpu] [--dry-run] [--output-quant int4|int8]
          [--cache-dir D] [--clean_cache] [--write-through] [--token T]
          [--profile] [--trace-dir D]
    copy-model CONFIG [--revision R] [--token T]
    generate MODEL_DIR PROMPT [-4|-8] [--greedy] [--draft-model D] [--speculation-k K] ...
    serve MODEL_DIR [-4|-8] [--continuous N] [--port P] [--draft-model D] [--prefix-cache N] ...
    quantize SRC DST [--bits 4|8] [--no-check]
    verify-safetensors --model_dir D [--index_path P] [--repair]
    fuse-lora BASE ADAPTER OUT [--scale S] [--device cpu]
    extract-lora BASE FINETUNED OUT [--rank R] [--target SUFFIX ...] [--device cpu]
    rewrite-reorder IN OUT [--num-shards N]
    inspect MODEL_DIR
    compare DIR_A DIR_B [--top N] [--max-rel X]
    convert-pytorch IN OUT [--num-shards N]

A merge's model references are local directories or HuggingFace Hub repo
ids (downloaded into ``storage_dir``; ``HF_ENDPOINT`` overrides the Hub's
address), each a checkpoint, a PEFT LoRA adapter or a GPTQ/AWQ checkpoint.
``merge`` prints the run's counters as one JSON line on standard output
when it finishes. The device is a CUDA card unless ``--device cpu`` is
given (or the config's ``device`` is ``cpu``); with no card and no such
request the command fails instead of running on the host. Errors print
``error: ...`` and exit 2.

``merge`` shards across the ranks a launcher started::

    torchrun --nproc-per-node N -m shardmerge_tpu_torch merge cfg.yaml

(or any launcher that sets the ``env://`` variables; config ``distributed:
true`` forces the attempt). The fourier engine splits tensors of
``shard_min_bytes`` or more over the ranks; only rank 0 writes. A plain
``merge`` merges on one device, whatever the host's GPU count
(``shard_tensors: false`` keeps a launched merge unsharded).
Tensor-parallel decoding (``generate``/``serve --shard``) is not ported
(ROADMAP A.10b) and is refused by name.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

from .backend import BackendError, resolve_device
from .config import ConfigError, MergeConfig

logger = logging.getLogger(__name__)


def setup_logging(verbose: bool):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def progress_callback(stats):
    print(
        f"\rDownload Progress: {stats.progress_pct:.1f}% | Active: {stats.active_workers} | "
        f"Complete: {stats.completed_jobs} | Failed: {stats.failed_jobs} | "
        f"Downloaded: {stats.total_downloaded / 1024 / 1024:.1f}MB",
        end="", file=sys.stderr, flush=True,
    )


def _all_local(config: MergeConfig) -> bool:
    """Whether every model reference is a local directory; warns when only
    some are (a mistyped path would be taken for a Hub repo id)."""
    refs = {config.output_base_model}
    for m in config.finetune_merge:
        refs.update((m.model, m.base))
    local = {r for r in refs if Path(r).is_dir()}
    if local and local != refs:
        logger.warning(
            "Mixed model references: %s resolve to local directories but %s do not and will be "
            "fetched from HuggingFace Hub", sorted(local), sorted(refs - local),
        )
    return local == refs


def merge_class(config: MergeConfig):
    """The engine class of ``config.merge_method``, its ``method_options``
    checked against the engine's OPTIONS (ConfigError otherwise)."""
    from .merge import MERGE_METHODS

    merge_cls = MERGE_METHODS.get(config.merge_method)
    if merge_cls is None:
        raise ConfigError(
            f"Unknown merge_method {config.merge_method!r}; "
            f"choose from {sorted(MERGE_METHODS)}"
        )
    unknown_opts = set(config.method_options) - set(merge_cls.OPTIONS)
    if unknown_opts:
        raise ConfigError(
            f"method_options keys {sorted(unknown_opts)} are not accepted by "
            f"merge_method {config.merge_method!r} "
            f"(accepted: {sorted(merge_cls.OPTIONS) or 'none'})"
        )
    return merge_cls


def _index_for(config: MergeConfig, clean_cache: bool, token: Optional[str], ranks: bool = False):
    """(index, download manager or None): the offline index when every
    reference is a local directory, else the Hub index (which takes local
    directories too). Under merge ranks (``ranks``) the storage directory
    is the host's: its local rank 0 downloads each file and the host's
    other ranks wait for it, and ``clean_cache`` is refused (a rank must
    not delete a shard another rank has yet to read)."""
    from .io.index import HFMultiModelIndex, OfflineMultiModelIndex

    if _all_local(config):
        logger.info("All model references are local directories; running offline")
        return OfflineMultiModelIndex(), None
    from .io.download import DownloadManager

    role = "alone"
    if ranks:
        from .parallel.comm import local_rank

        if clean_cache:
            raise ConfigError(
                "clean_cache is not supported with several merge ranks: the ranks of a host read every "
                "downloaded shard from one storage_dir, and none may delete a shard another has yet to "
                "read; drop --clean_cache/clean_cache and delete storage_dir after the merge"
            )
        role = "follow" if local_rank() != 0 else "lead"
    manager = DownloadManager(storage_path=config.storage_path, clean_cache=clean_cache,
                              max_retries=3, token=token, role=role)
    if ranks:
        import torch.distributed as dist

        if role == "lead":
            manager.clear_failure_notes()
        dist.barrier()  # no rank waits on a download before its host's notes are cleared
    manager.add_progress_callback(progress_callback)
    return HFMultiModelIndex(download_manager=manager, cache_path=config.cache_path, token=token), manager


def _print_plan(merger, config: MergeConfig, comm=None):
    """Resolve the indexes and print the merge plan; the planning writer is
    read-only, so nothing is created in the output location."""
    from .io.writer import ModelWriter

    merger.initialize()
    layer_order = merger.index_manager.get_layer_order(config.output_base_model)
    writer = ModelWriter(base_index=merger.index_doc, output_path=config.output_path,
                         layer_order=layer_order, output_astype=config.output_astype, read_only=True)
    layers = [sl for shard in writer.shard_layers() for sl in shard]
    shards = len(writer.shard_to_tensors)
    done = sum(sl.written for sl in layers)
    print(f"merge plan: {config.merge_method} of {len(config.finetune_merge)} finetunes onto "
          f"{config.output_base_model}")
    print(f"  output: {config.output_path} ({shards} shards, {len(layers)} tensors, dtype {config.output_dtype})")
    if done:
        print(f"  resume: {done}/{len(layers)} tensors already written (will be skipped)")
    if comm is not None:
        print(f"  mesh: {comm.size} ranks over {comm.transport}; tensors >= {config.shard_min_bytes} bytes "
              "row-shard (pad if needed)")
    print("  models: " + ", ".join(f"{m.model} (base {m.base}, alpha {m.alpha})" for m in config.finetune_merge))
    print("  gates: " + (", ".join(
        f"{m.model}[{m.start_layer}:{m.end_layer}]"
        for m in config.finetune_merge
        if m.start_layer != 0 or m.end_layer != -1
    ) or "none"))
    print("plan OK — nothing was fetched or computed")


def run_merge(config: MergeConfig, device: Optional[str] = None, clean_cache: bool = False,
              dry_run: bool = False, token: Optional[str] = None, **engine_options):
    """Build the index and the engine of ``config.merge_method`` (with its
    ``method_options``) and run the merge (or, with ``dry_run``, print its
    plan); returns the engine. An engine's refusal of its options or of the
    config is raised as ConfigError before anything is written.
    ``engine_options`` go to the engine (the pipeline's prefetch_depth,
    device_prefetch_depth, background_flush; fourier's batch_rounds). With
    ``clean_cache`` the downloaded shards are deleted as they are read out,
    and every download at the end."""
    from .merge import FourierMerge

    merge_cls = merge_class(config)
    request = device or config.device
    ranks = False
    if config.shard_tensors is not False:
        from .parallel.multihost import initialize_distributed

        # ranks a launcher started join here (a no-op for a plain run), so
        # the device below is this rank's
        ranks = initialize_distributed(force=config.distributed, device=request)
    dev = resolve_device(request)
    logger.info("merge device: %s", dev)
    comm = None
    if merge_cls is FourierMerge:
        if ranks:
            from .parallel.multihost import merge_mesh

            comm = merge_mesh(dev)
            logger.info("Sharding tensors >= %d bytes over %d ranks on %d host(s) over %s",
                        config.shard_min_bytes, comm.size, comm.hosts, comm.transport)
        elif config.shard_tensors:
            logger.info("shard_tensors requested but only one rank is running; every tensor merges on %s "
                        "(launch with torchrun --nproc-per-node N to shard)", dev)
        engine_options.update(
            exact_imag=config.exact_imag,
            hbm_budget_bytes=(
                int(config.hbm_budget_gb * 2**30) if config.hbm_budget_gb is not None else None
            ),
            comm=comm,
            shard_min_bytes=config.shard_min_bytes,
        )
    elif ranks:
        logger.info("merge_method %r does not shard: every rank merges every tensor, rank 0 writes",
                    config.merge_method)
    elif config.exact_imag or config.hbm_budget_gb is not None:
        logger.warning("exact_imag and hbm_budget_gb apply to merge_method 'fourier' only")
    index, manager = _index_for(config, clean_cache, token, ranks)
    try:
        try:
            merger = merge_cls(config, index_manager=index, device=dev,
                               **config.method_options, **engine_options)
        except ValueError as e:  # ConfigError included
            raise ConfigError(str(e)) from e
        if dry_run:
            _print_plan(merger, config, comm)
        else:
            merger.merge()
    finally:
        index.close()
    if manager is not None:
        merger.stats.download_bytes = manager.bytes_downloaded
        if manager.last_end is not None:
            merger.stats.download_wall_s = manager.last_end - manager.first_start
        if clean_cache:
            manager.cleanup()
    return merger


def _merge(args) -> int:
    from .ops.profiling import trace

    config = MergeConfig.from_file(args.config_file)
    if args.cache_dir:
        config.cache_dir = str(args.cache_dir)
    if args.method:
        config.merge_method = args.method
    if args.write_through:
        config.write_through = True
    if args.clean_cache:
        config.clean_cache = True
    if args.profile:
        os.environ["SHARDMERGE_PROFILE"] = "1"
    with trace(args.trace_dir):
        merger = run_merge(config, args.device, clean_cache=config.clean_cache, dry_run=args.dry_run,
                           token=args.token)
    if args.dry_run:
        return 0
    quantized = None
    from .merge.base import is_primary

    # under merge ranks only rank 0 writes, the quantized artifact too
    if args.output_quant and is_primary():
        from .tools.quantize_checkpoint import quantize_checkpoint

        bits = int(args.output_quant.removeprefix("int"))
        quantized = f"{config.output_path}-{args.output_quant}"
        report = quantize_checkpoint(config.output_path, quantized, bits=bits)
        print(f"quantized artifact: {quantized} ({report['tensors_quantized']} tensors, "
              f"{report['compression']}x smaller)")
    s = merger.stats
    index = merger.index_manager
    print(
        json.dumps(
            {
                "device": str(merger.device),
                "tensors_merged": s.tensors_merged,
                "tensors_passthrough": s.tensors_passthrough,
                "pair_merges": {k: v for k, v in s.pair_merges.items() if v},
                "nans_scrubbed": s.nans_scrubbed,
                "bytes_written": s.bytes_written,
                "host_syncs": s.host_syncs,
                "hbm_spills": s.hbm_spills,
                "h2d_bytes": s.h2d_bytes,
                "prefetch_device_hits": s.prefetch_device_hits,
                "prefetch_failures": s.prefetch_failures,
                "tensors_sharded": s.tensors_sharded,
                "span_fetch_s": s.span_fetch_s,
                "span_h2d_s": s.span_h2d_s,
                "span_merge_s": s.span_merge_s,
                "span_flush_s": s.span_flush_s,
                "host_work": {k: {"tensors": n, "seconds": t} for k, (n, t) in index.host_work.items()},
                "downloads": {"bytes": s.download_bytes, "wall_s": s.download_wall_s},
                "output_quant": quantized,
                "ranks": _ranks_summary(getattr(merger, "comm", None)),
                "tensor_spans": merger.tensor_spans,
            }
        )
    )
    return 0


def _ranks_summary(comm):
    """The merge ranks of a sharded run: their count, position, transport
    and per-collective [calls, bytes this rank sent, host seconds]; None
    for a run on one rank."""
    if comm is None:
        return None
    return {"size": comm.size, "position": comm.position, "hosts": comm.hosts, "transport": comm.transport,
            "collectives": {k: {"calls": c, "bytes": b, "seconds": t} for k, (c, b, t) in comm.stats.items()}}


def _copy_model(args) -> int:
    from .io.writer import ModelWriter

    config = MergeConfig.from_file(args.config_file)
    source = config.input_model.model if config.input_model else config.output_base_model
    logger.info("Copying model configuration from %s to %s", source, config.output_path)
    ModelWriter.from_huggingface(model_id=source, output_path=config.output_path, layer_order=[],
                                 revision=args.revision, token=args.token)
    logger.info("Successfully copied model configuration files")
    return 0


def _generate(args) -> int:
    from .inference import InferenceEngine

    dev = resolve_device(args.device)
    engine = InferenceEngine.from_pretrained(
        args.model_path,
        load_in_4bit=args.load_in_4bit,
        load_in_8bit=args.load_in_8bit,
        device=dev,
        draft_model=args.draft_model,
        speculation_k=args.speculation_k,
        shard=args.shard,
    )
    if engine.follower:  # a tensor-parallel rank above 0: rank 0 prints
        return engine.follow()
    try:
        for chunk in engine.stream_generation(
            prompt=args.prompt,
            max_new_tokens=args.max_tokens,
            temperature=args.temperature,
            top_p=args.top_p,
            top_k=args.top_k,
            repetition_penalty=args.repetition_penalty,
            greedy=args.greedy,
            seed=args.seed,
            decode_chunk=args.decode_chunk,
        ):
            print(chunk, end="", flush=True)
        print()
    finally:
        engine.stop()
    return 0


def _serve(args) -> int:
    from .serve import serve

    server = serve(
        args.model_path,
        host=args.host,
        port=args.port,
        load_in_4bit=args.load_in_4bit,
        load_in_8bit=args.load_in_8bit,
        draft_model=args.draft_model,
        speculation_k=args.speculation_k,
        shard=args.shard,
        batch_window_ms=args.batch_window_ms,
        prefix_cache=args.prefix_cache,
        continuous=args.continuous,
        continuous_cache_len=args.continuous_cache_len,
        continuous_prefill_chunk=args.continuous_prefill_chunk,
        warmup=args.warmup,
        device=resolve_device(args.device),
    )
    if server is None:  # a tensor-parallel rank above 0, released by rank 0
        return 0
    print(f"Serving {args.model_path} on http://{args.host}:{server.port} (Ctrl-C to stop)", flush=True)
    tp = server.engine.tp
    try:
        while tp is None or tp.failed is None:
            time.sleep(3600 if tp is None else 0.5)
    except KeyboardInterrupt:
        server.stop()
        return 0
    # a failed tensor-parallel call leaves the ranks out of step: end now
    # (the pool's and the server's threads would wait on the group)
    print(f"error: {tp.failed}", file=sys.stderr, flush=True)
    os._exit(1)


def _quantize(args) -> int:
    from .tools.quantize_checkpoint import quantize_checkpoint

    report = quantize_checkpoint(args.src, args.dst, bits=int(args.bits), check=not args.no_check)
    print(json.dumps(report))
    return 0


def _verify(args) -> int:
    from .tools.verify_safetensors import main as verify_main

    return 0 if verify_main(args.model_dir, args.index_path, args.repair) else 1


def _fuse_lora(args) -> int:
    from .tools.fuse_lora import fuse_lora

    dev = resolve_device(args.device)
    summary = fuse_lora(args.base_dir, args.adapter_dir, args.output_dir, scale=args.scale, device=dev)
    print(f"Fused {summary['fused_tensors']} tensors at scale {summary['scale']:g} across "
          f"{summary['shards']} shard(s) -> {args.output_dir}")
    return 0


def _extract_lora(args) -> int:
    from .tools.extract_lora import extract_lora

    dev = resolve_device(args.device)
    summary = extract_lora(args.base_dir, args.finetuned_dir, args.output_dir, rank=args.rank,
                           target_modules=args.targets or None, device=dev)
    print(f"Extracted rank-{summary['rank']} adapter: {summary['tensors']} tensor pairs, worst "
          f"Frobenius capture {summary['capture_min']:.4f} -> {args.output_dir}")
    return 0


def _rewrite_reorder(args) -> int:
    from .tools.rewrite_reorder import reshard_and_reorder

    reshard_and_reorder(args.input_dir, args.output_dir, args.num_shards)
    return 0


def _inspect(args) -> int:
    from .tools.inspect_model import inspect_model

    inspect_model(args.model_dir)
    return 0


def _compare(args) -> int:
    from .tools.inspect_model import compare_models

    stats, only_a, only_b = compare_models(args.dir_a, args.dir_b, top=args.top)
    if args.max_rel is not None:
        worst = max((s.get("max_rel", float("inf")) for s in stats), default=0.0)
        if worst > args.max_rel or only_a or only_b:
            return 1
    return 0


def _convert_pytorch(args) -> int:
    from .tools.convert_pytorch_to_hf import convert

    convert(args.input_path, args.output_dir, args.num_shards)
    return 0


def _int_range(lo: int, hi: int):
    def parse(text: str) -> int:
        v = int(text)
        if not lo <= v <= hi:
            raise argparse.ArgumentTypeError(f"{v} is not in [{lo}, {hi}]")
        return v

    return parse


def _existing(text: str) -> Path:
    path = Path(text)
    if not path.exists():
        raise argparse.ArgumentTypeError(f"path {text!r} does not exist")
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="shardmerge_tpu_torch",
        description="Model merging and generation on PyTorch / CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    m = sub.add_parser("merge", help="merge finetunes into the base model")
    m.add_argument("config_file", type=_existing, help="YAML or JSON merge configuration")
    m.add_argument("--cache-dir", type=Path, default=None, help="directory for caching downloaded files")
    m.add_argument("--clean_cache", action="store_true",
                   help="delete downloaded shards once read out, and every download at the end")
    m.add_argument("--device", default=None, help="'cpu' merges on the host")
    m.add_argument(
        "--method", default=None,
        help="merge method (overrides the config's merge_method): fourier | fourier-legacy | "
        "addition | task-addition | ties | dare | della | breadcrumbs | linear | slerp | model-stock",
    )
    m.add_argument("--write-through", action="store_true",
                   help="rewrite a tensor's output shard as soon as it is merged")
    m.add_argument("--verbose", action="store_true")
    m.add_argument("--trace-dir", type=Path, default=None,
                   help="record a torch.profiler trace of the merge into this directory")
    m.add_argument("--profile", action="store_true",
                   help="log per-phase wall clock / RSS / device memory (SHARDMERGE_PROFILE=1)")
    m.add_argument("--dry-run", action="store_true",
                   help="resolve indexes and print the merge plan without fetching weights or computing")
    m.add_argument("--token", default=None,
                   help="HuggingFace access token (defaults to HF_TOKEN or the huggingface-cli login)")
    m.add_argument("--output-quant", choices=["int8", "int4"], default=None,
                   help="also write a GPTQ-v2 artifact of the merged model into <output_dir>-<int8|int4>")
    m.set_defaults(func=_merge)

    c = sub.add_parser("copy-model", help="copy a Hub model's configuration files to the output directory")
    c.add_argument("config_file", type=_existing)
    c.add_argument("--revision", default="main", help="model revision/tag")
    c.add_argument("--token", default=None, help="HuggingFace access token")
    c.add_argument("--verbose", action="store_true")
    c.set_defaults(func=_copy_model)

    g = sub.add_parser("generate", help="generate text from a model, adapter or GPTQ/AWQ directory")
    g.add_argument("model_path", type=_existing)
    g.add_argument("prompt")
    g.add_argument("--max-tokens", type=int, default=512)
    g.add_argument("--temperature", type=float, default=0.7)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--top-k", type=int, default=40)
    g.add_argument("--repetition-penalty", type=float, default=1.1)
    g.add_argument("--greedy", action=argparse.BooleanOptionalAction, default=False, help="argmax decoding")
    g.add_argument("-4", "--load-in-4bit", action="store_true")
    g.add_argument("-8", "--load-in-8bit", action="store_true")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default=None, help="'cpu' runs on the host")
    g.add_argument("--draft-model", type=_existing, default=None,
                   help="smaller same-vocab checkpoint for speculative decoding (greedy only; same tokens)")
    g.add_argument("--speculation-k", type=int, default=4, help="speculative tokens per round")
    g.add_argument("--shard", action="store_true",
                   help="tensor-parallel decoding over the ranks a launcher started (torchrun --nproc-per-node P)")
    g.add_argument("--decode-chunk", type=_int_range(1, 64), default=1,
                   help="decode steps per engine call (the same tokens; S-token emission)")
    g.add_argument("--verbose", action="store_true")
    g.set_defaults(func=_generate)

    s = sub.add_parser("serve", help="serve a model over HTTP (OpenAI-style API)")
    s.add_argument("model_path", type=_existing)
    s.add_argument("--host", default="127.0.0.1", help="bind address")
    s.add_argument("--port", type=int, default=8000, help="bind port (0: any free port)")
    s.add_argument("-4", "--load-in-4bit", action="store_true")
    s.add_argument("-8", "--load-in-8bit", action="store_true")
    s.add_argument(
        "--batch-window-ms", type=float, default=0.0,
        help="coalesce concurrent compatible greedy requests arriving within this "
        "window into one lockstep decode (0 = off)",
    )
    s.add_argument(
        "--continuous", type=_int_range(0, 64), default=0,
        help="serve greedy requests from a continuously batched pool of N slots (0 = off)",
    )
    s.add_argument(
        "--continuous-cache-len", type=_int_range(256, 131072), default=2048,
        help="KV cache length of the continuous pool (prompt + budget of a request must fit)",
    )
    s.add_argument(
        "--continuous-prefill-chunk", type=_int_range(64, 4096), default=None,
        help="admission prefill slice (tokens): an arriving prompt stalls active "
        "decode by at most one slice between pool steps (default 512)",
    )
    s.add_argument(
        "--warmup", action="store_true",
        help="run the serving hot path once (and build the kernels) before the port opens",
    )
    s.add_argument("--device", default=None, help="'cpu' runs on the host")
    s.add_argument("--draft-model", type=_existing, default=None,
                   help="speculative-decoding draft checkpoint (greedy requests)")
    s.add_argument("--speculation-k", type=int, default=4, help="speculative tokens per round")
    s.add_argument("--shard", action="store_true",
                   help="tensor-parallel serving over the ranks a launcher started (torchrun --nproc-per-node P)")
    s.add_argument(
        "--prefix-cache", type=_int_range(0, 64), default=0,
        help="keep N prompt-prefix KV slabs on the device: single-prompt requests sharing "
        "a system prompt skip its prefill (0 = off)",
    )
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(func=_serve)

    q = sub.add_parser("quantize", help="write a quantized GPTQ-v2 artifact of a checkpoint directory")
    q.add_argument("src", type=_existing)
    q.add_argument("dst", type=Path)
    q.add_argument("--bits", choices=["4", "8"], default="4", help="quantization width")
    q.add_argument("--no-check", action="store_true", help="skip the per-tensor round-trip check")
    q.add_argument("--verbose", action="store_true")
    q.set_defaults(func=_quantize)

    v = sub.add_parser("verify-safetensors", help="verify (and optionally repair) index <-> shard alignment")
    v.add_argument("--model_dir", type=_existing, required=True)
    v.add_argument("--index_path", type=Path, default=None)
    v.add_argument("--repair", action="store_true", help="rebuild the index from the shard files")
    v.set_defaults(func=_verify)

    f = sub.add_parser("fuse-lora", help="fuse a PEFT LoRA adapter into a full checkpoint (W + s*B@A)")
    f.add_argument("base_dir", type=_existing)
    f.add_argument("adapter_dir", type=_existing)
    f.add_argument("output_dir", type=Path)
    f.add_argument("--scale", type=float, default=None, help="override the adapter's lora_alpha/r scaling")
    f.add_argument("--device", default=None, help="'cpu' fuses on the host")
    f.set_defaults(func=_fuse_lora)

    e = sub.add_parser("extract-lora", help="extract a PEFT LoRA adapter approximating finetuned - base")
    e.add_argument("base_dir", type=_existing)
    e.add_argument("finetuned_dir", type=_existing)
    e.add_argument("output_dir", type=Path)
    e.add_argument("--rank", type=_int_range(1, 4096), default=16, help="adapter rank")
    e.add_argument("--target", dest="targets", action="append", default=[],
                   help="module-name suffix to extract (repeatable; default: q/k/v/o/gate/up/down projections)")
    e.add_argument("--device", default=None, help="'cpu' runs the SVDs on the host")
    e.set_defaults(func=_extract_lora)

    r = sub.add_parser("rewrite-reorder", help="reorder tensors into canonical transformer order and reshard")
    r.add_argument("input_dir", type=_existing)
    r.add_argument("output_dir", type=Path)
    r.add_argument("--num-shards", type=int, default=None, help="target shard count")
    r.set_defaults(func=_rewrite_reorder)

    i = sub.add_parser("inspect", help="summarize a safetensors model directory")
    i.add_argument("model_dir", type=_existing)
    i.set_defaults(func=_inspect)

    d = sub.add_parser("compare", help="tensor-wise diff of two models")
    d.add_argument("dir_a", type=_existing)
    d.add_argument("dir_b", type=_existing)
    d.add_argument("--top", type=int, default=10, help="show the N worst tensors")
    d.add_argument("--max-rel", type=float, default=None,
                   help="exit 1 if any tensor exceeds this max relative error")
    d.set_defaults(func=_compare)

    p = sub.add_parser("convert-pytorch", help="convert PyTorch .bin checkpoints to sharded safetensors")
    p.add_argument("input_path", type=_existing)
    p.add_argument("output_dir", type=Path)
    p.add_argument("--num-shards", type=int, default=None, help="target shard count")
    p.set_defaults(func=_convert_pytorch)
    return parser


# failures of the user's input: ``error: ...`` and exit 2
_USER_ERRORS = (ConfigError, BackendError, NotImplementedError, FileNotFoundError, NotADirectoryError,
                ValueError, KeyError, AssertionError)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(getattr(args, "verbose", False))
    try:
        return args.func(args)
    except _USER_ERRORS as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
