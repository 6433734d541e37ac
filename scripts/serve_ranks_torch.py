#!/usr/bin/env python3
"""Tensor-parallel decoding across GPUs, one rank a GPU (NCCL), against one GPU.

    python3 scripts/serve_ranks_torch.py

Builds a model at Llama-3.1-70B widths (meta-llama/Llama-3.1-70B
config.json: hidden 8192, 64 heads, 8 KV heads, FFN 28672, vocab 128256)
cut to 2 layers, seeded random weights, in bf16 and with int4 projections.
On one GPU: 16 greedy tokens after a 100-token prompt, and a greedy batch
of 8 prompts, with the logits each token was chosen from; decode ms per
step at B = 1 (the stream) and B = 8 (the batch), medians of 3. Then
``torchrun --nproc-per-node G`` over the G visible GPUs (each rank builds
the same weights on its own GPU and keeps its slices; NCCL) runs the same
decodes sharded: its tokens must be one GPU's, or first differ at a
near-tie of one GPU's logits (chip_smoke.py's rule, the gap the measured
max-abs difference of the prompt's logits). Prints the card's name and
power limit, each rank's transport and weight bytes, a decode step's
collectives (calls and bytes against the count the model predicts) and
both routes' decode ms. A second launch with the partial sums accumulated
in the activations' dtype (``TPGroup(reduce_dtype=None)``; f32 is the
default) gives the prompt's logits only: both sums' relL2 from one GPU's
are printed. Needs two or more GPUs; exits 1 with fewer.
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

HF = {"model_type": "llama", "hidden_size": 8192, "intermediate_size": 28672, "num_attention_heads": 64,
      "num_key_value_heads": 8, "vocab_size": 128256, "num_hidden_layers": 2, "max_position_embeddings": 131072,
      "rms_norm_eps": 1e-05, "rope_theta": 500000.0, "tie_word_embeddings": False,
      "rope_scaling": {"factor": 8.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                       "original_max_position_embeddings": 8192, "rope_type": "llama3"}}
KINDS = ("bf16", "int4")
NEW = 16
PROMPT = 100
BATCH = 8


def build(torch, kind: str, dev):
    """(cfg, params) of ``kind`` on ``dev`` from a fixed seed: the same bits
    on every GPU."""
    from shardmerge_tpu_torch.models import llama

    cfg = llama.ModelConfig.from_hf_config(HF)
    project = (lambda w: cs.card_quantize(torch, w)) if kind == "int4" else None
    return cfg, llama.init_params(cfg, seed=70, dtype=torch.bfloat16, device=dev, project=project)


def prompts():
    return cs.text_of(PROMPT, 5), [cs.text_of(40 + 9 * i, 6 + i) for i in range(BATCH)]


def decodes(torch, engine):
    """The stream's and the batch's tokens and decode ms per step (medians of 3)."""
    one, batch = prompts()
    stream = cs.token_ids("".join(engine.stream_generation(one, max_new_tokens=NEW, greedy=True)))
    texts = engine.generate_batch(batch, max_new_tokens=NEW, greedy=True)

    def wall(fn, n):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    def run_stream(n):
        for _ in engine.stream_generation(one, max_new_tokens=n, greedy=True):
            pass

    def run_batch(n):
        engine.generate_batch(batch, max_new_tokens=n, greedy=True)

    ms = {b: (wall(fn, NEW) - wall(fn, 1)) / (NEW - 1) * 1e3 for b, fn in ((1, run_stream), (BATCH, run_batch))}
    return {"stream": stream, "batch": [cs.token_ids(t) for t in texts], "decode_ms": ms}


def prompt_logits(torch, engine):
    from shardmerge_tpu_torch.models import llama

    one, _ = prompts()
    ids = engine._encode(one, True, None, None)
    with torch.inference_mode():
        pids, ppos = engine._pad_prompt(ids, 256)
        last, _ = engine._chunked_prefill(pids, ppos, engine._init_kv(1, 256),
                                          llama.rope_tables(engine.cfg, 256, engine.device), len(ids),
                                          keep_pos=len(ids) - 1)
    return last.float().cpu()


def rank_main(root: Path, reduce: str) -> int:
    """One rank (under torchrun): every kind sharded with the partials
    summed in ``reduce`` ("f32" or "activation"); rank 0 decodes and
    measures (only the prompt's logits with "activation"), the others
    follow. Writes ROOT/rank{R}.json."""
    import torch
    import torch.distributed as dist

    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel import tp as tpmod
    from shardmerge_tpu_torch.parallel.train import collectives_per_forward, plan, shard_params

    comm, control, dev = tpmod.join("cuda")
    found = {"rank": comm.rank, "device": dev, "transport": comm.transport}
    for kind in KINDS:
        cfg, params = build(torch, kind, torch.device(dev))
        group = tpmod.TPGroup(comm, plan(cfg, comm.rank, comm.size, 4 if kind == "int4" else None), control,
                              reduce_dtype=torch.float32 if reduce == "f32" else None)
        model = llama.LlamaModel(cfg, shard_params(params, cfg, group.plan), tp=group)
        del params
        torch.cuda.empty_cache()
        out = {"weight_bytes": sum(b.nbytes for b in model.buffers())}
        if comm.rank:
            InferenceEngine(cfg, model, None, tp=tpmod.Follower(group, model)).follow()
        elif reduce != "f32":
            engine = InferenceEngine(cfg, model, cs.IdTokenizer(), tp=tpmod.Leader(group, model))
            torch.save(prompt_logits(torch, engine), root / f"ranks_{kind}_{reduce}.pt")
            engine.stop()
        else:
            engine = InferenceEngine(cfg, model, cs.IdTokenizer(), tp=tpmod.Leader(group, model))
            out.update(decodes(torch, engine))
            torch.save(prompt_logits(torch, engine), root / f"ranks_{kind}_f32.pt")
            with torch.inference_mode():
                kv = engine._init_kv(1, 256)
                rope = llama.rope_tables(cfg, 256, engine.device)
                engine.model(torch.ones((1, 8), dtype=torch.int64, device=dev), torch.arange(8, device=dev)[None],
                             kv, 0, rope, 8)
                torch.cuda.synchronize()
                before = {k: list(v) for k, v in comm.stats.items()}
                engine.model(torch.ones((1, 1), dtype=torch.int64, device=dev), torch.tensor([[8]], device=dev),
                             kv, 8, rope, 9)
                torch.cuda.synchronize()
            out["step"] = {k: [v[0] - before.get(k, [0, 0])[0], v[1] - before.get(k, [0, 0])[1]]
                           for k, v in comm.stats.items()}
            out["predicted"] = collectives_per_forward(cfg, group.plan)
            engine.stop()
        found[kind] = out
        del model
        torch.cuda.empty_cache()
    if reduce == "f32":
        (root / f"rank{comm.rank}.json").write_text(json.dumps(found))
    dist.barrier()
    return 0


def main() -> int:
    import torch

    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk

    gpus = torch.cuda.device_count()
    if gpus < 2:
        print(f"serve_ranks_torch: {gpus} GPU(s) visible; decoding across GPUs needs 2 or more", file=sys.stderr)
        return 1
    card = cs.card_line()
    cs.say(f"[card] {card} x {gpus}; torch {torch.__version__} cuda {torch.version.cuda}")
    cs.phase_build([qk, ak])
    root = Path(tempfile.mkdtemp(prefix="serve_ranks_"))
    try:
        one = {}
        for kind in KINDS:
            cfg, params = build(torch, kind, torch.device("cuda:0"))
            model = llama.LlamaModel(cfg, params)
            engine = InferenceEngine(cfg, model, cs.IdTokenizer())
            got = decodes(torch, engine)
            stream, steps, _ = cs.tp_reference(torch, engine, cs.IdTokenizer(), prompts()[0], NEW)
            got["plain"] = steps
            got["prompt_logits"] = prompt_logits(torch, engine)
            got["weight_bytes"] = sum(b.nbytes for b in model.buffers())
            one[kind] = got
            cs.say(f"[one GPU] Llama-3.1-70B widths, 2 layers, {kind}: decode ms/step B=1 "
                   f"{got['decode_ms'][1]:.3f}, B={BATCH} {got['decode_ms'][BATCH]:.3f} (medians of 3); weight bytes "
                   f"{got['weight_bytes']}")
            del engine, model, params
            torch.cuda.empty_cache()
        walls = {}
        for reduce in ("f32", "activation"):
            logs = root / f"logs_{reduce}"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(gpus), "--log-dir",
                 str(logs), "--redirects", "3", str(Path(__file__).resolve()), "--rank", str(root), reduce],
                cwd=cs.REPO, capture_output=True, text=True, timeout=1500)
            walls[reduce] = time.perf_counter() - t0
            if proc.returncode != 0:
                tails = "".join(f"\n--- {p.relative_to(logs)}:\n{p.read_text()[-3000:]}"
                                for p in sorted(logs.rglob("*.log")))
                raise SystemExit(f"torchrun ({reduce} sums) exited {proc.returncode}:\n{proc.stderr[-3000:]}{tails}")
        wall = walls["f32"]
        ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(gpus)]
        r0 = ranks[0]
        cs.say(f"[ranks] {gpus} ranks: {[(r['device'], r['transport']) for r in ranks]}; torchrun wall {wall:.1f} s "
               f"(the bf16-sum launch {walls['activation']:.1f} s)")
        for kind in KINDS:
            ref, mine = one[kind], r0[kind]
            mine_logits = torch.load(root / f"ranks_{kind}_f32.pt")
            gap = float((mine_logits - ref["prompt_logits"]).abs().max())
            rels = {r: cs.rel_l2(torch.load(root / f"ranks_{kind}_{r}.pt"), ref["prompt_logits"])
                    for r in ("f32", "activation")}
            _, note = cs.near_tie_check(f"[ranks] {kind} stream", mine["stream"], ref["stream"], ref["plain"], [], gap)
            same_batch = sum(a == b for a, b in zip(mine["batch"], ref["batch"]))
            step, want = mine["step"], mine["predicted"]
            if step["all_reduce"][0] != want["all_reduce"] or step["all_gather"][0] != want["all_gather"]:
                raise SystemExit(f"[ranks] {kind}: a decode step ran {step}, the model predicts {want}")
            cs.say(f"[ranks] {kind}: stream of {NEW} vs one GPU: {note} (prompt logits max-abs gap {gap:.3e}); "
                   f"batch of {BATCH}: {same_batch} rows equal one GPU's; decode ms/step B=1 "
                   f"{mine['decode_ms']['1']:.3f} (one GPU {ref['decode_ms'][1]:.3f}), B={BATCH} "
                   f"{mine['decode_ms'][str(BATCH)]:.3f} (one GPU {ref['decode_ms'][BATCH]:.3f}); a decode step's "
                   f"collectives {step} (predicted {want}); prompt logits relL2 from one GPU's with f32 sums "
                   f"{rels['f32']:.3e}, bf16 sums {rels['activation']:.3e}; weight bytes per rank "
                   f"{[r[kind]['weight_bytes'] for r in ranks]} of one GPU's {ref['weight_bytes']} ({card} x {gpus})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.say(card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(Path(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
