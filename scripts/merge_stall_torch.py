#!/usr/bin/env python3
"""Which pipeline options make the merge thread stall, on one NVIDIA card.

    python3 scripts/merge_stall_torch.py

Writes chip_smoke.py's checkpoints (base + 2 finetunes at Llama-3.1-8B
widths cut to 2 layers, bf16, 2 shards, seeded), then merges them in
process with each combination of host read-ahead (``prefetch_depth``,
``device_prefetch_depth``) and the background shard flush, twice each in
turn after one warm-up merge. Each merge runs under chip_smoke's
``StackSampler`` and prints its wall, the longest gap between two stack
samples (a stretch in which no Python thread ran), the two largest
per-tensor walls, the threads whose stack moved across that gap and the
merge thread's top sites. Prints the card's name and power limit first.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

VARIANTS = (
    ("read-ahead, background flush (defaults)", {}),
    ("read-ahead, inline flush", dict(background_flush=False)),
    ("no read-ahead, background flush", dict(prefetch_depth=0, device_prefetch_depth=0)),
    ("host read-ahead only, background flush", dict(device_prefetch_depth=0)),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("merge_stall_torch: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.cli import run_merge
    from shardmerge_tpu_torch.config import MergeConfig

    card = cs.card_line()
    cs.say(f"[card] {card}")
    root = Path(tempfile.mkdtemp(prefix="merge_stall_"))
    try:
        dirs, _ = cs.write_checkpoints(torch, root)
        cfg_file = cs.merge_config(root, "merged", dirs[0], [(dirs[1], 0.8), (dirs[2], 0.4)])
        runs = [("warm-up", {})] + [v for _ in range(2) for v in VARIANTS]
        for i, (tag, options) in enumerate(runs):
            cfg = MergeConfig.from_file(cfg_file)
            cfg.output_dir = str(root / f"out{i}")
            torch.cuda.synchronize()
            with cs.StackSampler(threading.get_ident()) as sampler:
                t0 = time.perf_counter()
                merger = run_merge(cfg, "cuda:0", **options)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            shutil.rmtree(cfg.output_dir)
            top = sorted(merger.tensor_spans.items(), key=lambda kv: -kv[1]["wall_s"])[:2]
            cs.say(
                f"[{tag}] ({card}) whole merge {wall:.3f} s; longest gap between stack samples "
                f"{sampler.max_gap * 1e3:.1f} ms; largest walls "
                + ", ".join(f"{n} {v['wall_s'] * 1e3:.1f} ms" for n, v in top)
                + "; moved across the gap: "
                + ("; ".join(f"{k}: {a} => {b}" for k, (a, b) in sampler.across_gap.items()) or "none")
                + "; merge thread: " + "; ".join(f"{ms:.0f} ms {site}" for ms, site in sampler.top(3))
            )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
