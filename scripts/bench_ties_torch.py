#!/usr/bin/env python3
"""Time the TIES merge's steps (shardmerge_tpu_torch/merge/ties.py) on one
CUDA card at a Llama-3.1-8B MLP tensor, (14336, 4096), with 4 finetune
deltas (seeded N(0, 0.01^2)):

    python3 scripts/bench_ties_torch.py [--reps 10] [--previous OLD_ties.py]

For one model's trim (an exact select), the sign election with ``finish``
over the 4 deltas, and the whole per-tensor core (4 trims, election,
finish), it prints three times: the host's wall of the call with its
device work (synchronized), the CUDA-event time around the call (host
launch included, as chip_smoke.py's ``[engines]`` masks line takes it),
and the device time of the same call captured in a CUDA graph and replayed
(no host launch counts). Inputs are copied afresh before each timed call,
outside the timing. ``--previous`` loads an earlier ties.py from a file and
times its election and finish, alone and in the core, the same way, in
turn with the current ones.
The last line is the card's name and power limit. It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPE = (14336, 4096)
DENSITY = 0.2


def load_previous(path: str):
    """An earlier ties.py as a module of the port's merge package, so that
    its relative imports resolve."""
    import shardmerge_tpu_torch.merge  # noqa: F401  (the parent package)

    spec = importlib.util.spec_from_file_location("shardmerge_tpu_torch.merge._previous_ties", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def times(torch, call, reset, reps: int) -> dict:
    """Median host wall, event time and graph replay time of ``call`` (ms);
    ``reset`` restores its inputs before each run."""
    for _ in range(2):
        reset()
        call()
    torch.cuda.synchronize()
    wall, event = [], []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        event.append(start.elapsed_time(end))
    reset()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    replay = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        replay.append(start.elapsed_time(end))
    del graph
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {"wall_ms": med(wall), "event_ms": med(event), "graph_ms": med(replay)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--previous", help="an earlier ties.py whose election and finish are timed beside")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_ties_torch: no CUDA card", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.merge import ties

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    src = [torch.randn(SHAPE, device=dev, generator=gen) * 0.01 for _ in range(4)]
    base = torch.randn(SHAPE, device=dev, generator=gen) * 0.01
    work = [torch.empty_like(d) for d in src]
    keep = ties.keep_count(base.numel(), DENSITY)

    def reset():
        for w, d in zip(work, src):
            w.copy_(d)

    versions = {"current": ties}
    if args.previous:
        versions = {"previous": load_previous(args.previous), **versions}
    rows = {"trim, one model": lambda: ties.trim_(work[0], keep)}
    for label, m in versions.items():
        rows[f"election and finish, 4 models ({label})"] = (
            lambda m=m: m.finish(m.elect_disjoint_mean(work), base, 1.0, True))
        rows[f"whole core: 4 trims, election, finish ({label})"] = (
            lambda m=m: m.finish(m.elect_disjoint_mean([ties.trim_(w, keep) for w in work]), base, 1.0, True))
    # each step twice, in turn forwards and backwards
    results: dict = {}
    for name in list(rows) + list(rows)[::-1]:
        results.setdefault(name, []).append(times(torch, rows[name], reset, args.reps))
    for name, runs in results.items():
        print(json.dumps({"step": name, "shape": list(SHAPE), "runs": runs}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
