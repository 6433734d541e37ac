#!/usr/bin/env python3
"""The fourier merge across GPUs, one rank a GPU (NCCL), against one GPU.

    python3 scripts/merge_ranks_torch.py

Writes chip_smoke.py's checkpoints (base + 2 finetunes at Llama-3.1-8B
widths cut to 2 layers, bf16, 2 shards, seeded), merges them with the
port's CLI on one GPU, then with ``torchrun --nproc-per-node G`` over the G
visible GPUs (each rank on its own GPU, so the transport is NCCL) with
every projection split over the ranks, and holds the ranks' output to the
single GPU's: the index mirrors the base, every tensor finite bf16 and
more than 97% of its elements within 2e-2. Prints the card's name and
power limit, each rank's transport and collectives (calls, bytes, host
seconds) and both merges' walls and per-tensor walls. Needs two or more
GPUs; exits 1 with fewer.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def per_tensor_ms(stats: dict) -> str:
    spans = [v["wall_s"] * 1e3 for k, v in stats["tensor_spans"].items() if k.startswith("model.layers.")]
    return f"mean {sum(spans) / len(spans):.1f} ms, max {max(spans):.1f} ms"


def main() -> int:
    import torch

    from shardmerge_tpu_torch.io.safetensors_io import load_file

    gpus = torch.cuda.device_count()
    if gpus < 2:
        print(f"merge_ranks_torch: {gpus} GPU(s) visible; the merge across GPUs needs 2 or more", file=sys.stderr)
        return 1
    card = cs.card_line()
    cs.say(f"[card] {card} x {gpus}; torch {torch.__version__} cuda {torch.version.cuda}")
    root = Path(tempfile.mkdtemp(prefix="merge_ranks_"))
    try:
        dirs, _ = cs.write_checkpoints(torch, root)
        finetunes = [(dirs[1], 0.8), (dirs[2], 0.4)]
        single, wall = cs.cli_merge(cs.merge_config(root, "single", dirs[0], finetunes))
        cs.say(f"[one GPU] CLI wall {wall:.1f} s (process, incl. startup); per merged tensor "
               f"{per_tensor_ms(single)}")
        cfg = cs.merge_config(root, "ranks", dirs[0], finetunes, shard_min_bytes=cs.SHARD_MIN_BYTES)
        logs = root / "logs"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(gpus), "--log-dir", str(logs),
             "--redirects", "3", "-m", "shardmerge_tpu_torch", "merge", str(cfg)],
            cwd=cs.REPO, capture_output=True, text=True,
        )
        wall = time.perf_counter() - t0
        outs = {int(p.parent.name): p.read_text() for p in logs.rglob("stdout.log")}
        if proc.returncode != 0 or len(outs) != gpus:
            for p in sorted(logs.rglob("stderr.log")):
                cs.say(p.read_text()[-3000:])
            cs.say(proc.stderr[-3000:])
            raise SystemExit(f"torchrun exited {proc.returncode} with {len(outs)} rank logs")
        for rank in sorted(outs):
            stats = json.loads(next(line for line in outs[rank].splitlines() if line.startswith("{")))
            r = stats["ranks"]
            cs.say(f"[ranks] rank {rank} on {stats['device']}: position {r['position']} of {r['size']}, transport "
                   f"{r['transport']} ({card}); inputs split {stats['tensors_sharded']}; collectives "
                   + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB {v['seconds']:.2f} s"
                               for k, v in r["collectives"].items())
                   + (f"; per merged tensor {per_tensor_ms(stats)}" if rank == 0 else ""))
            if r["transport"] != "nccl" or r["size"] != gpus:
                raise SystemExit(f"rank {rank} took {r['transport']} over {r['size']} ranks")
            if stats["device"] != f"cuda:{rank}":
                raise SystemExit(f"rank {rank} ran on {stats['device']}")
        out = root / "ranks"
        weight_map = cs.check_output(torch, out, dirs[0], "[ranks]")
        agree = []
        for shard in sorted(set(weight_map.values())):
            ours, theirs = load_file(out / shard), load_file(root / "single" / shard)
            for name, t in ours.items():
                close = torch.isclose(t.cuda().float(), theirs[name].cuda().float(), rtol=2e-2, atol=1e-6)
                agree.append((close.double().mean().item(), name))
        worst = min(agree)
        cs.say(f"[ranks] torchrun over {gpus} GPUs: wall {wall:.1f} s (incl. startup); index mirrors the base, all "
               f"finite bf16; every tensor within 2e-2 of the one-GPU merge at >= {worst[0]:.4%} (gate 97%, lowest "
               f"{worst[1]})")
        if worst[0] <= 0.97:
            raise SystemExit("the ranks' merge leaves the one-GPU merge")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.say(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
