"""Command-line interface (counterpart of shardmerge_tpu/cli.py), on argparse.

    python -m shardmerge_tpu_torch merge CONFIG [--method M] [--device cpu]
    python -m shardmerge_tpu_torch generate MODEL_DIR PROMPT [-4] [--greedy]
    python -m shardmerge_tpu_torch serve MODEL_DIR [-4] [--continuous N] [--port P]

``merge`` prints the run's counters as one JSON line on standard output when
it finishes; ``serve`` answers OpenAI-style HTTP requests until interrupted
(serve.py). The device is a CUDA card unless ``--device cpu`` is given (or
the config's ``device`` is ``cpu``); with no card and no such request the
command fails instead of running on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional, Sequence

from .backend import BackendError, resolve_device
from .config import ConfigError, MergeConfig

logger = logging.getLogger(__name__)


def setup_logging(verbose: bool):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def _check_ported(config: MergeConfig) -> None:
    """Raise, by name, for configuration features this port does not carry
    yet (the mesh-sharded merge)."""
    unported = [
        name
        for name, on in (
            ("shard_tensors", config.shard_tensors),
            ("distributed", config.distributed),
        )
        if on
    ]
    if unported:
        raise NotImplementedError(f"config fields not ported yet: {unported}")


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


def run_merge(config: MergeConfig, device: Optional[str] = None, **engine_options):
    """Build the index and the engine of ``config.merge_method`` (with its
    ``method_options``) and run the merge; returns the engine. An engine's
    refusal of its options or of the config is raised as ConfigError before
    anything is written. ``engine_options`` go to the engine (the pipeline's
    prefetch_depth, device_prefetch_depth, background_flush; fourier's
    batch_rounds)."""
    from .io.index import OfflineMultiModelIndex, require_local
    from .merge import FourierMerge

    _check_ported(config)
    merge_cls = merge_class(config)
    refs = [config.output_base_model]
    for m in config.finetune_merge:
        refs += [m.model, m.base]
    require_local(refs)
    dev = resolve_device(device or config.device)
    logger.info("merge device: %s", dev)
    if merge_cls is FourierMerge:
        engine_options.update(
            exact_imag=config.exact_imag,
            hbm_budget_bytes=(
                int(config.hbm_budget_gb * 2**30) if config.hbm_budget_gb is not None else None
            ),
        )
    elif config.exact_imag or config.hbm_budget_gb is not None:
        logger.warning("exact_imag and hbm_budget_gb apply to merge_method 'fourier' only")
    index = OfflineMultiModelIndex()
    try:
        try:
            merger = merge_cls(config, index_manager=index, device=dev,
                               **config.method_options, **engine_options)
        except ValueError as e:  # ConfigError included
            raise ConfigError(str(e)) from e
        merger.merge()
    finally:
        index.close()
    return merger


def _merge(args) -> int:
    config = MergeConfig.from_file(args.config_file)
    if args.method:
        config.merge_method = args.method
    merger = run_merge(config, args.device)
    s = merger.stats
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
                "span_fetch_s": s.span_fetch_s,
                "span_h2d_s": s.span_h2d_s,
                "span_merge_s": s.span_merge_s,
                "span_flush_s": s.span_flush_s,
                "tensor_spans": merger.tensor_spans,
            }
        )
    )
    return 0


def _generate(args) -> int:
    from .inference import InferenceEngine

    dev = resolve_device(args.device)
    engine = InferenceEngine.from_pretrained(
        args.model_path,
        load_in_4bit=args.load_in_4bit,
        load_in_8bit=args.load_in_8bit,
        device=dev,
    )
    for chunk in engine.stream_generation(
        prompt=args.prompt,
        max_new_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        greedy=args.greedy,
        seed=args.seed,
    ):
        print(chunk, end="", flush=True)
    print()
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
        shard=args.shard,
        batch_window_ms=args.batch_window_ms,
        prefix_cache=args.prefix_cache,
        continuous=args.continuous,
        continuous_cache_len=args.continuous_cache_len,
        continuous_prefill_chunk=args.continuous_prefill_chunk,
        warmup=args.warmup,
        device=resolve_device(args.device),
    )
    print(f"Serving {args.model_path} on http://{args.host}:{server.port} (Ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def _int_range(lo: int, hi: int):
    def parse(text: str) -> int:
        v = int(text)
        if not lo <= v <= hi:
            raise argparse.ArgumentTypeError(f"{v} is not in [{lo}, {hi}]")
        return v

    return parse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="shardmerge_tpu_torch",
        description="Model merging and generation on PyTorch / CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    m = sub.add_parser("merge", help="merge finetunes into the base model")
    m.add_argument("config_file", help="YAML or JSON merge configuration")
    m.add_argument("--device", default=None, help="'cpu' merges on the host")
    m.add_argument(
        "--method", default=None,
        help="merge method (overrides the config's merge_method): fourier | fourier-legacy | "
        "addition | task-addition | ties | dare | della | breadcrumbs | linear | slerp | model-stock",
    )
    m.add_argument("--verbose", action="store_true")
    m.set_defaults(func=_merge)

    g = sub.add_parser("generate", help="generate text from a model directory")
    g.add_argument("model_path")
    g.add_argument("prompt")
    g.add_argument("--max-tokens", type=int, default=512)
    g.add_argument("--temperature", type=float, default=0.7)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--top-k", type=int, default=40)
    g.add_argument("--repetition-penalty", type=float, default=1.1)
    g.add_argument("--greedy", action="store_true", help="argmax decoding")
    g.add_argument("-4", "--load-in-4bit", action="store_true")
    g.add_argument("-8", "--load-in-8bit", action="store_true")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default=None, help="'cpu' runs on the host")
    g.add_argument("--verbose", action="store_true")
    g.set_defaults(func=_generate)

    s = sub.add_parser("serve", help="serve a model over HTTP (OpenAI-style API)")
    s.add_argument("model_path")
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
    s.add_argument("--draft-model", default=None, help="not ported yet")
    s.add_argument("--shard", action="store_true", help="not ported yet")
    s.add_argument("--prefix-cache", type=_int_range(0, 64), default=0, help="not ported yet")
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(func=_serve)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    try:
        return args.func(args)
    except (ConfigError, BackendError, NotImplementedError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
