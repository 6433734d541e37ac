#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. kernel: build the int4 GEMV from csrc/ (nvcc, sm_90a) and hold it to
   ``int4_matmul_plain`` at the Llama-3.1-8B decode shapes, B = 1, 4, 64,
   f32 and bf16 x (relL2 <= 1e-5 f32, <= 4e-3 bf16), timing both;
3. checkpoints: base + 2 finetunes at Llama-3.1-8B widths cut to 2 layers,
   bf16, 2 shards each, random weights from seeded generators;
4. merge: ``python -m shardmerge_tpu_torch merge cfg.json`` (alphas 0.8 and
   0.4); the output must mirror the base index, be finite, take the slerp
   regime, and agree with the port's host path on one q_proj;
5. generate: load the merge with int4 weights, ``generate_batch`` on 4
   prompts and one ``stream_generation``; the kernel's launch count must
   show the decode went through it, and one decode step's logits must
   agree with the same step on the plain int4 product;
6. the kernel summary line, the card line, and the result line.

It imports nothing of JAX. With no CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
LAYERS = 2
# meta-llama/Llama-3.1-8B config.json, num_hidden_layers cut from 32 to 2
LLAMA_31_8B = {
    "architectures": ["LlamaForCausalLM"],
    "attention_bias": False,
    "bos_token_id": 128000,
    "eos_token_id": 128001,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 131072,
    "mlp_bias": False,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": LAYERS,
    "num_key_value_heads": 8,
    "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "rope_theta": 500000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "vocab_size": 128256,
}
# (N, K) of the 8B decode GEMVs: q/o, k/v, gate/up, down
GEMV_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]
LAYER_GEMVS = [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096),
               (14336, 4096), (14336, 4096), (4096, 14336)]


def say(*parts):
    print(*parts, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, L2 flushed
    before each (a decode step meets every weight cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_kernel(torch, qk):
    t0 = time.perf_counter()
    qk.build(verbose=True)
    say(f"[kernel] built {qk._SOURCE.relative_to(REPO)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    weights = {}
    for n, k in GEMV_SHAPES:
        q = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=dev, generator=gen)
        s = torch.rand((n, 1), dtype=torch.float32, device=dev, generator=gen) * 0.02 + 1e-3
        weights[(n, k)] = (q, s)
    results = {}
    ok = True
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-3)):
        for n, k in GEMV_SHAPES:
            q, s = weights[(n, k)]
            for b in (1, 4, 64):
                x = torch.randn((b, k), device=dev, generator=gen).to(dtype)
                got = qk.int4_matmul(x, q, s)
                want = qk.int4_matmul_plain(x, q, s)
                torch.cuda.synchronize()
                rel = rel_l2(got.float(), want.float())
                err = float((got.float() - want.float()).abs().max())
                ms = time_ms(torch, lambda: qk.int4_matmul(x, q, s), flush)
                plain = time_ms(torch, lambda: qk.int4_matmul_plain(x, q, s), flush)
                gbs = q.numel() / (ms * 1e-3) / 1e9
                passed = rel <= tol and got.dtype == dtype and got.shape == (b, n)
                ok &= passed
                results[(str(dtype), n, k, b)] = (err, ms, plain)
                say(
                    f"[kernel] {str(dtype)[6:]:8s} N={n:5d} K={k:5d} B={b:2d} "
                    f"relL2={rel:.2e} (tol {tol:.0e}) max_abs={err:.3e} "
                    f"kernel={ms:.4f} ms ({gbs:.0f} GB/s of q) plain={plain:.4f} ms "
                    f"{'ok' if passed else 'FAIL'}"
                )
    if not ok:
        raise SystemExit("kernel disagrees with its plain version")
    # one decode layer's seven GEMVs at the generate batch (B=4, bf16)
    layer = [results[("torch.bfloat16", n, k, 4)] for n, k in LAYER_GEMVS]
    summary = {
        "max_abs_err": max(r[0] for r in layer),
        "ms": sum(r[1] for r in layer),
        "plain_ms": sum(r[2] for r in layer),
    }
    say(
        f"[kernel] one layer's 7 decode GEMVs, B=4 bf16: kernel "
        f"{summary['ms']:.4f} ms, plain {summary['plain_ms']:.4f} ms"
    )
    del flush, weights
    return summary


def write_checkpoints(torch, root: Path):
    """base, ft1, ft2: bf16, 2 shards each; finetune = base + 0.01 N(0, 1)."""
    from shardmerge_tpu_torch.io.safetensors_io import save_file

    cfg = LLAMA_31_8B
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    kv = cfg["num_key_value_heads"] * h // cfg["num_attention_heads"]
    shapes = {"model.embed_tokens.weight": (v, h)}
    for l in range(LAYERS):
        p = f"model.layers.{l}."
        shapes.update({
            p + "self_attn.q_proj.weight": (h, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, h),
            p + "mlp.gate_proj.weight": (i, h),
            p + "mlp.up_proj.weight": (i, h),
            p + "mlp.down_proj.weight": (h, i),
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
        })
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (v, h)
    shard_of = {
        name: "model-00001-of-00002.safetensors"
        if name.startswith(("model.embed_tokens", "model.layers.0."))
        else "model-00002-of-00002.safetensors"
        for name in shapes
    }
    dev = torch.device("cuda:0")
    gens = [torch.Generator(device=dev).manual_seed(s) for s in (0, 1, 2)]
    dirs = [root / m for m in ("base", "ft1", "ft2")]
    for d in dirs:
        d.mkdir(parents=True)
    total = 0
    for shard in sorted(set(shard_of.values())):
        staged = [{}, {}, {}]
        for name, shape in shapes.items():
            if shard_of[name] != shard:
                continue
            if len(shape) == 1:
                base = torch.ones(shape, device=dev)
            else:
                base = torch.randn(shape, device=dev, generator=gens[0]) * 0.02
            tensors = [base] + [base + 0.01 * torch.randn(shape, device=dev, generator=g) for g in gens[1:]]
            for m, t in enumerate(tensors):
                staged[m][name] = t.to(torch.bfloat16).cpu()
            total += 2 * base.numel()
        for m, d in enumerate(dirs):
            save_file(staged[m], d / shard, metadata={"format": "pt"})
    index = {"metadata": {"total_size": total}, "weight_map": shard_of}
    for d in dirs:
        (d / "model.safetensors.index.json").write_text(json.dumps(index, indent=2))
        (d / "config.json").write_text(json.dumps(LLAMA_31_8B, indent=2))
    return dirs, shapes


def phase_merge(torch, root: Path, dirs):
    from shardmerge_tpu_torch.io.safetensors_io import load_file
    from shardmerge_tpu_torch.merge import fourier
    from shardmerge_tpu_torch.ops import blend

    base, ft1, ft2 = dirs
    out = root / "merged"
    cfg = {
        "output_base_model": str(base),
        "finetune_merge": [
            {"model": str(ft1), "base": str(base), "alpha": 0.8},
            {"model": str(ft2), "base": str(base), "alpha": 0.4},
        ],
        "output_dir": str(out),
        "cache_dir": str(root / "cache"),
        "storage_dir": str(root / "storage"),
    }
    cfg_file = root / "merge.json"
    cfg_file.write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shardmerge_tpu_torch", "merge", str(cfg_file)],
        cwd=REPO, capture_output=True, text=True,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stderr[-4000:])
        raise SystemExit(f"merge exited {proc.returncode}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    per_tensor = stats["tensor_seconds"]
    merged = {k: v for k, v in per_tensor.items() if k.startswith("model.layers.")}
    say(
        f"[merge] wall {wall:.1f} s (process, incl. startup) on {stats['device']}; "
        f"{stats['tensors_merged']} tensors ({stats['tensors_passthrough']} passthrough); "
        f"regimes {stats['pair_merges']}; NaNs scrubbed {stats['nans_scrubbed']}; "
        f"per merged tensor mean {sum(merged.values()) / len(merged) * 1e3:.1f} ms, "
        f"max {max(merged.values()) * 1e3:.1f} ms; spans merge {stats['span_merge_s']:.2f} s "
        f"write {stats['span_flush_s']:.2f} s"
    )
    say(
        f"[merge] spans: read {stats['span_fetch_s']:.2f} s, host->device {stats['span_h2d_s']:.2f} s, "
        f"merge {stats['span_merge_s']:.2f} s (incl. the two above), device->host + shard "
        f"writes {stats['span_flush_s']:.2f} s"
    )
    for name, sec in per_tensor.items():
        say(f"[merge]   {sec * 1e3:8.1f} ms  {name}")
    if stats["pair_merges"].get("slerp") != 9 * LAYERS:
        raise SystemExit(f"expected {9 * LAYERS} slerp pair merges, got {stats['pair_merges']}")

    index_name = "model.safetensors.index.json"
    if json.loads((out / index_name).read_text()) != json.loads((base / index_name).read_text()):
        raise SystemExit("merged index does not mirror the base index")
    weight_map = json.loads((out / index_name).read_text())["weight_map"]
    for shard in sorted(set(weight_map.values())):
        for name, t in load_file(out / shard).items():
            if t.dtype != torch.bfloat16 or not bool(torch.isfinite(t.cuda()).all()):
                raise SystemExit(f"{name}: not finite bf16")
    say(f"[merge] index mirrors the base ({len(weight_map)} tensors, 2 shards); all finite bf16")

    # spot check: the port's host path on the same inputs
    name = "model.layers.0.self_attn.q_proj.weight"
    shard = weight_map[name]
    b, f1, f2 = (load_file(d / shard)[name] for d in dirs)
    n = b.numel()
    host, *_ , code = fourier._fused_pair(
        b, b, f1, b, f2, 0.8, 0.4, 1e-10,
        blend.cutoff_rank(n, 0.08), blend.cull_rank(n, 0.2), blend.cull_limit(n, 0.2),
        use_cull=True, fast_imag=fourier._use_fast_imag(False, b),
    )
    card = load_file(out / shard)[name].float()
    close = torch.isclose(card, host.float(), rtol=2e-2, atol=1e-6).double().mean().item()
    delta_rel = rel_l2(card - b.float(), host.float() - b.float())
    say(
        f"[merge] {name} vs host path ({fourier.FUSED_REGIMES[code]}): {close * 100:.3f}% "
        f"within 2e-2 (gate 97%); merged delta relL2 {delta_rel:.2e}"
    )
    if close < 0.97:
        raise SystemExit("card merge disagrees with the host path")
    shutil.copy(base / "config.json", out / "config.json")
    return out, sum(merged.values()) / len(merged)


class StubTokenizer:
    """One token per character; no EOS, so every row decodes every step."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr((i - 2) % 96 + 32) for i in ids)


def phase_generate(torch, merged: Path):
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk

    t0 = time.perf_counter()
    engine = InferenceEngine.from_pretrained(
        merged, load_in_4bit=True, tokenizer=StubTokenizer(), device="cuda:0"
    )
    torch.cuda.synchronize()
    say(f"[generate] loaded {merged.name} with int4 projections in {time.perf_counter() - t0:.1f} s")
    prompts = [
        "The merged model answers a question.",  # 36
        "Spectral blends of deltas",  # 25
        "int4 decode on the H100 card, step by step",  # 42 -> trimmed below
        "seventeen chars!!",  # 17
    ]
    prompts[2] = prompts[2][:40]
    kw = dict(greedy=True)
    new = 16
    engine.generate_batch(prompts, max_new_tokens=2, **kw)  # warm-up
    torch.cuda.synchronize()

    qk.reset_launch_counts()
    t0 = time.perf_counter()
    texts = engine.generate_batch(prompts, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    batch_launches = qk.launch_counts["int4_gemv"]
    streamed = "".join(engine.stream_generation(prompts[0], max_new_tokens=new, **kw))
    torch.cuda.synchronize()
    launches = qk.launch_counts["int4_gemv"]

    def wall(tokens):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.generate_batch(prompts, max_new_tokens=tokens, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    step_ms = (wall(new) - wall(1)) / (new - 1) * 1e3  # medians of 3
    decode_tps = len(prompts) * 1e3 / step_ms
    say(
        f"[generate] generate_batch: {len(prompts)} prompts x {new} greedy tokens in "
        f"{t_batch:.3f} s; decode {step_ms:.3f} ms/step = {decode_tps:.1f} tokens/s "
        f"(B=4, prefill excluded, medians of 3); kernel launches {batch_launches}"
    )
    say(f"[generate] stream_generation: {len(streamed)} chars; kernel launches in both runs {launches}")
    need = LAYERS * 7 * new
    if batch_launches < need:
        raise SystemExit(f"int4 kernel launched {batch_launches} times, need >= {need}")
    if not all(len(t) == new for t in texts) or len(streamed) != new:
        raise SystemExit(f"unexpected outputs: {texts!r} / {streamed!r}")

    # one decode step, kernel vs the plain int4 product
    model, cfg = engine.model, engine.cfg
    ids = torch.tensor([StubTokenizer().encode(prompts[0])], device="cuda:0")
    T = ids.shape[1]
    rope = llama.rope_tables(cfg, 256, "cuda:0")
    kv = llama.init_kv_cache(cfg, 1, 256, model.dtype, "cuda:0")
    pos = torch.arange(T, device="cuda:0")[None]
    with torch.inference_mode():
        logits, kv = model(ids, pos, kv, 0, rope, T)
        tok = logits[:, -1].argmax(-1)[:, None]
        step_pos = torch.full((1, 1), T, device="cuda:0")
        kv_plain = {k: v.clone() for k, v in kv.items()}
        before = qk.launch_counts["int4_gemv"]
        with_kernel, _ = model(tok, step_pos, kv, T, rope, T + 1)
        if qk.launch_counts["int4_gemv"] - before != LAYERS * 7:
            raise SystemExit("decode step did not run the kernel for every projection")

        def plain(x, wq):
            return qk.int4_matmul_plain(x, wq["q"], wq["scale"])

        with mock.patch.object(llama, "dequant_matmul", plain):
            with_plain, _ = model(tok, step_pos, kv_plain, T, rope, T + 1)
    rel = rel_l2(with_kernel.float(), with_plain.float())
    say(f"[generate] decode-step logits, kernel vs plain int4 product: relL2 {rel:.2e} (tol 2e-2)")
    if rel > 2e-2 or not bool(torch.isfinite(with_kernel).all()):
        raise SystemExit("decode logits disagree")
    return launches, decode_tps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.models import quant_kernels as qk

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: {torch.cuda.get_device_name(0)}")

    summary = phase_kernel(torch, qk)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        dirs, shapes = write_checkpoints(torch, root)
        say(f"[checkpoints] base + 2 finetunes, {len(shapes)} tensors each, Llama-3.1-8B widths, "
            f"{LAYERS} layers, bf16, written in {time.perf_counter() - t0:.1f} s")
        merged, _ = phase_merge(torch, root, dirs)
        launches, _ = phase_generate(torch, merged)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    say(json.dumps({"kernels": [{
        "name": "int4_gemv",
        "route": "cuda",
        "source": "shardmerge_tpu_torch/csrc/int4_gemv.cu",
        "replaces": "shardmerge_tpu/models/quant_kernels.py:148",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
    }]}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
