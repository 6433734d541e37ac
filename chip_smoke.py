#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the four kernel sources of csrc/ (nvcc, sm_90a), one nvcc each,
   all started together;
3. kernel int4_gemv: hold it to ``int4_matmul_plain`` at the Llama-3.1-8B
   decode shapes, B = 1, 4, 8, 32, 64, f32 and bf16 x (relL2 <= 1e-5 f32,
   <= 4e-3 bf16), and row 0's bits at B = 1 to those at every other B;
   bf16 device times (CUDA graphs, L2 flushed by a read) beside the first
   design's, the plain version, the bound, the bf16 dense matmul (4x the
   bytes) and ``torch._weight_int4pack_mm`` (bf16 scales; a yardstick);
   one decode layer's seven GEMVs summed at B = 1, 4, 8, 64;
4. kernel flash_decode: hold it to ``flash_decode_plain`` at the 8B decode
   geometry (KVH 8, G 4, D 128), B = 1, 4, 16 x S = 2048, 8192, 32768 plus
   the generate (B 4, S 256) and serve (B 8, S 4096) shapes, and at
   Llama-3.1-405B's (KVH 8, G 16: four head chunks) at B 4, S 8192, each
   with a masked tail, random holes, and only the last 7 slots valid
   (relL2 <= 1e-5, finite; the call over a slot list compacted
   beforehand, as the forward makes it, must give the same bits); time it
   over the step's slot list (the per-layer call) and compacting itself,
   beside the previous design's times, the plain version, SDPA and the
   bound; then a G = 16 model and a head-dim-96 model built and decoded on
   the card: the first through the kernel, the second through the counted
   einsum path, their logits held to the einsum attention's (2e-2);
5. fft: the spectral transforms. ``dft_rows``/``dft_cols`` (radix FFTs
   in shared memory) at the Llama-3.1-8B shapes (4096, 8192), (4096, 4096),
   (1024, 4096), (14336, 4096), (4096, 14336), (128256, 64) (split (334,
   384), a radix-167 stage), the prime (64, 97) and (8, 32768) (rows no
   block holds: two passes), and ``fft_batched`` (register-resident
   Stockham passes) at the rfft2/irfft2 passes of the three supported 8B
   shapes and at N = 448, 960, 3584, forward and inverse, each held to its
   plain version and to a complex128 torch.fft truth (relL2 <= 1e-5,
   finite); the rfft2 -> irfft2 round trip of scripts/bench_fft_vpu.py and
   the fft2_mxu -> ifft2_mxu one at (4096, 8192) must return the input
   (relL2 <= 1e-5) with every transform kernel launched on the way, and
   the first is profiled once for its device-time split between
   ``fft_batched`` and the PyTorch passes around it; per-kernel times
   beside the plain version, torch.fft and the bound (``fft_batched``
   beside the previous design's time), for the DFTs also at (4096, 14336) rows
   and (14336, 4096) columns, with each route's device launches;
6. checkpoints: base + 2 finetunes at Llama-3.1-8B widths cut to 2 layers,
   bf16, 2 shards each, random weights from seeded generators;
7. merge: ``python -m shardmerge_tpu_torch merge cfg.json`` (alphas 0.8 and
   0.4); the output must mirror the base index, be finite, take the slerp
   regime, and agree with the port's host path on one q_proj; then the same
   merge in process sequentially (this code with read-ahead, device staging
   and the background flush off), pipelined (the defaults), and pipelined
   again on a warm page-locked host pool, each under torch.profiler: the
   device's busy share and each (14336, 4096) tensor's wall and spans; the
   merge thread's Python stack is sampled every 5 ms: where its time went,
   by site, and which threads moved across the longest gap in the samples;
8. stack: three more finetunes of the same base (delta scales 0.02, 0.05,
   0.13 beside ft1's 0.01: first-round norms 1 : 2 : 5 : 13), a 3-finetune
   and a 4-finetune merge through the CLI: index mirrored, finite bf16,
   2 (3) pair merges and 2 host syncs a merged tensor. On one q_proj and
   one down_proj the card's in-process reduction must give the CLI's bits,
   every round-1 pair merge must agree with the host on the same inputs
   (97% within 2e-2), and every later pair's blend must agree with the
   host's on identical spectra (cutoff threshold bit for bit, relL2 1e-5;
   the host's side runs on a worker thread beside the variants below and
   [shard], and is gated after [shard]);
   batch_rounds' batched pair merges must hold to the per-pair path on the
   same inputs (relL2 1e-6), and the two reductions are timed in turn. On
   a 3-tensor subset: hbm_budget_gb 0 (with spills) and prefetch_depth 0
   must give the default run's bits, and the default the CLI's bits
   (batch_rounds' whole outputs are printed beside them);
9. shard: the fourier merge across ranks. Two ranks share the card
   (``torchrun``'s env:// variables, started by this script; gloo with
   collectives staged through host memory) and run the port's merge CLI on
   7's base + 2 finetunes with every projection split over them: the index
   mirrors the base, every tensor finite bf16 and more than 97% within 2e-2
   of 7's single-device output. In process, each (14336, 4096) and (4096,
   14336) projection's round-1 pair merges of 8's 4-finetune inputs split
   over the ranks must lie within relL2 6e-3 and max-abs 0.2 rms of the
   single-device pair merge, each rank's collectives must send the bytes
   the shapes give, and the cutoff and cull thresholds of every slerp pair
   on identical spectra must be the single device's bit for bit; the
   all-to-all is timed alone. A world-1 NCCL group then runs
   ``sharded_pair_slerp`` on CUDA tensors with nothing staged, held to the
   same pair class. Printed: each rank's transport and collectives (calls,
   bytes, host seconds), the wall per tensor against 7's;
10. engines: the ten other merge methods, each merged in process on a
   3-tensor subset of [stack]'s models (4 finetunes, slerp 2; dare, della
   and breadcrumbs with both combine values), timed per tensor, then
   through the CLI (four at a time): index mirrored, finite bf16, the
   in-process bits. Meanwhile each is held to the host on q_proj: its f32
   merge within relL2 1e-6, thresholds, keep probabilities and masks bit
   for bit (dare and della on q_proj's first 1024 rows, the card's whole
   q_proj giving the cut's bits there; fourier-legacy per pair: each
   traced result the engine's own pair merge bit for bit, its weight the
   alphas by stack position, round 1 at 97% within 2e-2, later rounds on
   identical spectra with the traced weight). addition also merges the
   whole model (the 128256 x 4096 input/output layers), in the same pool.
   Then the masks alone at (14336, 4096): DARE's Bernoulli draw, DELLA's
   keep probabilities and drop-and-rescale, device ms;
11. inputs: every checkpoint input through the port's CLI on the card. A
   localhost "Hub" (a standard-library HTTP server) serves [stack]'s ft3;
   ``extract-lora`` makes a rank-16 adapter of ft1 on the attention
   projections (the card's B@A on layer 0's k_proj held to the host's
   within relL2 1e-5) and ``quantize --bits 4`` a GPTQ-v2 artifact of ft2.
   ``merge --dry-run`` of base + adapter + GPTQ + Hub creates nothing; the
   merge with ``--cache-dir``, ``--clean_cache`` and ``--output-quant
   int4`` must mirror the base index in finite bf16, download each shard
   once (the server's counts) and leave the storage empty, and give the
   bits of the merge of the materialized inputs (``fuse-lora --device
   cpu``, the GPTQ decoded to f32, ft3 local; the port's ``compare``). The
   card's ``fuse-lora`` against the host's, in differing bf16 elements.
   ``generate -4 --greedy`` (the engine the command builds) from the -int4
   artifact and from the adapter directory launches both decode kernels,
   one decode step's logits within 2e-2 of the plain route, and the
   adapter's greedy tokens equal its fuse-lora'd directory's. Times: the
   loopback download rate, host ms a tensor of the adapter fuse and the
   GPTQ decode, each (14336, 4096) tensor's wall beside [stack]'s
   3-finetune merge, and io/native.py's copy and cast against torch's;
12. generate: load the merge with int4 weights, ``generate_batch`` on 4
   prompts and one ``stream_generation``; both kernels' launch counts must
   show the decode went through them, and one decode step's logits must
   agree with the same step on the plain int4 product; an A/B of the decode
   step against the einsum attention path;
13. serve: the HTTP server on that engine with a continuous pool of 8 slots
   and a 4096-slot cache; staggered greedy requests (prompts of 30-3000
   tokens, one with a stop string), one SSE stream and one 4-prompt
   lockstep request; every pool completion must equal the solo stream, both
   kernels must have launched (flash at least once per layer per pool
   step). Then a pool over a 2048-slot cache, driven step by step until a
   join compacts it: one step on its compacted, gapped rows must agree
   with the same step on the plain attention (its attention outputs at
   relL2 1e-5, its logits at 2e-2), its four completions must equal the
   solo stream, and its slot list must be compacted once per decode step
   (flash launches = layers x compactions); an A/B of that pool step
   against the einsum path, and, over profiled pool steps, the device's
   busy share, its launches per step and the flash kernels' share;
14. spec: speculative decoding and the prefix cache on the int4 merge of
   12 (the target) with a Llama-3.2-1B-width draft (2 layers, bf16, random
   weights built on the card), k = 4. Solo streams with the draft, with the
   target as its own draft, with the target proposing its runner-up at a
   seeded 20% of positions (the planted-miss draft) and without one: each
   speculative stream equals the plain stream token for token or first
   differs at a near-tie (each of the two tokens within 4x the measured
   max-abs gap between the verify's T=4 logits and the T=1 decode's of the
   plain route's best logit there, a gap held to the 2e-2 class); the
   self-draft accepts all k tokens in every round, and the planted-miss
   draft all but at its planted misses, save at such a near-tie; the planted-miss rounds accept all and some proposals; with
   the 1B draft every GEMV launch is the verify's and the draft's decodes
   run the flash kernel. A speculative pool of 8 slots with 10 staggered
   greedy requests, with the 1B draft over a 2048-slot cache and with the
   planted-miss draft over a 512-slot one (10 requests of 60-400 prompt and
   64-100 new tokens): every completion equals its
   solo speculative stream under the same rule; spec_rounds,
   spec_accepted, row-rounds by accepted proposals and the verify's route
   (GEMV at 32 rows); the planted-miss pool accepts all and some
   proposals and compacts its draft cache while rows lag. The server with
   the prefix cache on: two requests sharing a 2000-token system prompt,
   the second hitting the bucket-aligned shared length; the cache's KV
   and the hit's prompt logits within 2e-2 of the plain prefill's, the
   hit's tokens a miss's (near-tie rule, its gap from the plain route
   alone: the prefill split at the hit without the cache, or the verify's);
   /v1/stats showing the slab's bytes. Reports: B=1 decode tokens/s plain
   and with each draft, and TTFT of a hit against a miss;
15. families: one model per dense family (Qwen2.5-7B, Qwen3-8B,
   Mistral-7B-v0.1, Gemma-2-9B, Gemma-3-1B, Phi-3-mini-128k, OLMo-2-7B,
   SmolLM3-3B, GLM-4-9B-0414) from its public config at its published
   widths, 2 layers, random weights built on the card, int4: 8 greedy
   tokens (Mistral after a 4200-token prompt, so its window masks slots),
   the GEMV launched for every projection of every step, the decode
   attention on the flash kernel (one slot list a step per mask kind) or,
   for head dim 96/256 and the softcap, on the counted einsum path; one
   decode step's logits within 2e-2 of the plain route and the kernel's
   attention within 1e-5 of its plain version on the step's inputs; the
   GEMV at every new (N, K) within 4e-3 of ``int4_matmul_plain``;
   Qwen2.5-7B's layer of seven GEMVs timed at B = 1 and 8 beside the plain
   version, the library call and the bound; Phi-3 also through ``generate
   -4 --greedy`` from a checkpoint with fused qkv_proj/gate_up_proj, its
   tokens equal to the in-memory model's (the process started first and
   waited for at the end of [experts]);
16. experts: Mixtral-8x7B, Qwen3-30B-A3B, DeepSeek-V2-Lite and DeepSeek-V3
   at published widths, 2 layers, int4 made on the card: the launches of a
   decode step, one step held to the plain route, pools of Mixtral and
   V2-Lite, V2-Lite's prefix cache and its generate CLI. The capacity
   route: Mixtral-8x7B, 2 layers, bf16, served with
   ``moe_dispatch="capacity"`` (experts stacked once) at full capacity and
   at 1.25 against the dense route: flash decode launched on every step,
   nothing dropped at full capacity, logits within 2e-2 where no router
   near-tie flips, tokens the dense route's up to a near-tie;
17. sinks-chunked: GPT-OSS-20B and Llama-4-Scout at published widths, 2
   layers. GPT-OSS written as a shipped-format MXFP4 checkpoint (layer 0's
   blocks and scales in two shards) and loaded at 4 bits (the card's MXFP4
   decode and int4 stack bit for bit the host's on layer 0's first 64
   channels); 8 greedy tokens after 300 (past the 128-token window), its
   sink attention on the counted einsum path (2 a step). Scout built on the
   card with int4 stacks; 8 greedy tokens after 8190, so decode crosses the
   8192 chunk boundary on flash (2 launches and one chunked and one full
   slot list a step; every flash call within 1e-5 of its plain version);
   GEMVs a step 8 and 14; one decode step each against the plain route
   (2e-2), the GEMV at every new (N, K) (4e-3), card memory and peak,
   prefill and decode-step walls; Scout's pool of 4 slots whose second long
   request joins with a gap and decodes across 8192: every completion its
   solo stream's or a near-tie;
18. tp: tensor-parallel decoding. Two ranks share the card (``torchrun``'s
   env:// variables, started by this script as ``--tp-rank``; gloo,
   host-staged). ``generate -4 --greedy --shard`` through the CLI on 7's
   merge (a word-level tokenizer written beside it): its tokens one
   device's (12's engine), or first differing at a near-tie of one
   device's logits against the measured decode gap; prefill and decode
   logits within relL2 2e-2 of one device's; on each rank the int4 GEMV and
   flash decode launched on its slice and its projection bytes at most
   0.55 of one device's; a decode step's all-reduces and gathers the
   count ``collectives_per_forward`` predicts, with their bytes, and its
   ms at B = 1 on 2 ranks beside one device. Each rank's row-parallel
   slices ((4096, 2048) and (4096, 7168)) through the GEMV against the
   plain product (4e-3). ``serve -4 --shard --continuous 4``: five
   concurrent greedy requests, each its one-device solo stream under the
   near-tie rule; after SIGINT to rank 0 every rank's serve returns 0.
   Mixtral-8x7B (expert lists), GPT-OSS-20B (stacks over experts) and
   DeepSeek-V2-Lite (latent attention) at published widths, 2 layers,
   int4: 8 greedy tokens sharded against one device's (near-tie rule),
   every rank launching the GEMV. A world-1 NCCL ``generate --shard`` logs
   one rank and gives one device's tokens;
18b. pp: pipeline-parallel training. Two ranks sharing the card
   (``--pp-rank``; gloo, host-staged) as the two stages of Llama-3.1-8B
   widths, 2 layers, seeded random weights, started after [inputs] and
   running beside [generate], [serve], [spec] and [tp], gated after [tp]. The int4 forward (bf16, int4
   projections made on the card, 4 microbatches of 1 x 64 under no_grad):
   the GEMV launched exactly 7 x layers x microbatches on each rank, the
   last stage's logits within relL2 1e-5 of the one-device forward_train
   of each microbatch and 2e-2 of the whole batch's (its 256 rows on the
   dense route). Two f32 make_pp_train_step steps of adamw + clip, 4 x 128
   in 4 microbatches, held to the one-device make_train_step with
   grad_accum 4 (losses 1e-4 relative, updates relL2 1e-2), each step's
   p2p record the predicted 2 M calls and M activations (or gradients) of
   1 x 128 x 4096 x 4 bytes; the state after step 1 saved (stage 1's
   leaves to rank 0 over the pp line), restored on one device, step 2
   there within 1e-4 of the pipeline's. Step ms on the ranks beside one
   device's, save and restore seconds, each rank's peak and the card's
   (nvidia-smi) over the window, the ranks' work and [pp]'s own wait;
18c. cp, ep: context and expert parallelism on two ranks sharing the card
   (``--cpep-rank``; gloo, host-staged, f32), started when [train]'s ranks
   exit, beside [experts] and [sinks-chunked], gated before [train]'s own
   steps. [cp]: Llama-3.1-8B widths, 1 layer, one sequence of 8192 tokens,
   4096 a rank: the ring's loss within 1e-4 relative and every gradient
   within relL2 1e-3 of one device's ``_loss_fn``, 2 hops and the
   predicted p2p bytes, one make_cp_train_step step (ZeRO-1). [ep]:
   Mixtral-8x7B widths, 1 MoE layer, 4 experts a rank, 4 x 512 tokens:
   make_ep_loss's loss and gradients against the dense-and-mask one
   device, one make_ep_train_step step, expert_parallel_ffn at 8 decode
   rows against the dense FFN and ``_moe_capacity`` (1e-5). Rank 0 and
   this process take turns at the card's largest allocations
   (``CardLease``); the card's memory.used peak over the ranks' window;
19. train: training at Llama-3.1-8B widths, 2 layers, seeded random
   weights. The full fine-tune (bf16 params with an f32 master, remat, two
   microbatches, clip + cosine, B x T = 4 x 512, a repeated batch): losses
   finite and falling over 4 steps; a checkpoint after 2 steps restored onto
   a fresh template resumes with the uninterrupted run's bits (or, when
   not, within twice the gap of two uninterrupted runs); step ms, tokens/s,
   peak memory, save and restore seconds. QLoRA (an int4 base made on the card, rank 16 on
   q_proj / v_proj, 1 x 64 tokens): the GEMV launched 10 times a step (the
   untargeted k/o/gate/up/down of 2 layers), the adapters' gradients on the
   kernel route within relL2 5e-2 of the plain route's, the loss falling,
   lora_to_peft then fuse_lora equal to merge_lora within one bf16 ulp. Two
   ranks sharing the card (``--train-rank``; gloo, host-staged), 1 layer,
   f32, 2 steps on dp = 2 with ZeRO-1 and on tp = 2, held to the one-device
   step (losses 1e-4 relative, updates relL2 1e-2), with the collectives'
   calls, bytes and seconds: started before [families], they run beside
   [families] and [experts], and [train] waits for them before its own
   steps;
20. the kernel summary line (all five kernels; the GEMV's ``launches``
   those of [serve], its ``train_launches`` those of [train]'s QLoRA
   steps, its ``pp_launches`` those of [pp]'s int4 forward on both ranks),
   the card line, and the result line.

It imports nothing of JAX. With no CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
GEMV_ROWS = (1, 4, 8, 32, 64)
# the PR 1 design of csrc/int4_gemv.cu at GEMV_SHAPES x GEMV_ROWS: device ms
# per call as graph_ms times it (scripts/bench_int4_torch.py --previous,
# NVIDIA H100 80GB HBM3, 700.00 W)
GEMV_PREVIOUS_MS = {
    "bfloat16": {(4096, 4096): (0.0105, 0.0148, 0.0239, 0.0788, 0.1527),
                 (1024, 4096): (0.0091, 0.0115, 0.0186, 0.0237, 0.0434),
                 (14336, 4096): (0.0234, 0.0402, 0.0709, 0.2629, 0.5085),
                 (4096, 14336): (0.0287, 0.0451, 0.0762, 0.2640, 0.5141)},
}
# decode attention at 8B geometry: KV heads, query heads per KV head, head dim
KVH, GROUP, HEAD_DIM = 8, 4, 128
# Llama-3.1-405B's (KV heads, query heads per KV head) at head dim 128, and
# a (B, S) for it: four head chunks of 4 on the card
GEOMETRY_405B = (8, 16)
ATTN_405B = (4, 8192)
FLASH_SHAPES = [(b, s) for b in (1, 4, 16) for s in (2048, 8192, 32768)]
GENERATE_ATTN = (4, 256)  # generate_batch: 4 prompts, one 256-slot bucket
SERVE_SLOTS, SERVE_CACHE = 8, 4096
SERVE_ATTN = (SERVE_SLOTS, SERVE_CACHE)
# the previous designs' times (PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W):
# flash decode with three launches a call at these shapes, and the in-place
# shared-memory Stockham kernel on the (4096, 4096) rows pass
FLASH_PREVIOUS_MS = {SERVE_ATTN: 0.0748, GENERATE_ATTN: 0.0377}
STOCKHAM_PREVIOUS_MS = 0.2416
STOCKHAM_KERNELS = ("pow2_kernel", "mixed_kernel")  # csrc/stockham_fft.cu's instances
# the spectral-transform path: the merge's bench shape, which
# scripts/bench_fft_vpu.py round-trips through rfft2/irfft2
FFT_SHAPE = (4096, 8192)
# DFT cases: Llama-3.1-8B tensor shapes, one prime length, and rows longer
# than a block holds
DFT_SHAPES = [(4096, 8192), (4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256, 64), (64, 97),
              (8, 32768)]
# Stockham (B, N): the rows and (padded) columns passes of rfft2 at
# (4096, 8192), (4096, 4096) and (1024, 4096), then radices 7, 3 and 5
STOCKHAM_SHAPES = [(4096, 4096), (4128, 4096), (4096, 2048), (2080, 4096), (1024, 2048), (2080, 1024),
                   (256, 448), (256, 960), (256, 3584)]
# [stack]: three more finetunes of the [merge] base; with ft1 (delta scale
# 0.01) the first-round delta norms stand 1 : 2 : 5 : 13 (no two products tie)
STACK_SCALES = {"ft3": 0.02, "ft4": 0.05, "ft5": 0.13}
STACK_FOUR = ("ft1", "ft3", "ft4", "ft5")
STACK_ALPHAS = {"ft1": 0.8, "ft3": 0.6, "ft4": 0.5, "ft5": 0.3}
# the tensors held to the host, and the subset the variants merge
STACK_CHECKED = ("model.layers.0.self_attn.q_proj.weight", "model.layers.0.mlp.down_proj.weight")
STACK_SUBSET = STACK_CHECKED + ("model.layers.0.mlp.gate_proj.weight",)
# [engines]: the ten other merge methods, each through the CLI on the
# [stack] subset with its four finetunes (slerp: ft1 and ft3), dare, della
# and breadcrumbs with both combine values; addition also over the whole
# model (the 128256 x 4096 input/output layers)
ENGINE_RUNS = (("addition", {}), ("task-addition", {}), ("linear", {}), ("ties", {}),
               ("breadcrumbs", {}), ("breadcrumbs", {"combine": "ties"}), ("dare", {}),
               ("dare", {"combine": "ties"}), ("della", {}), ("della", {"combine": "sum"}),
               ("slerp", {}), ("model-stock", {}), ("fourier-legacy", {}))
ENGINE_WHOLE = ("addition",)
# dare and della are held to the host on the first rows of q_proj: the
# host's threefry is slow, and a mask depends only on the flat index, so the
# cut's rows are the whole tensor's first rows
ENGINE_CUT_ROWS = 1024
# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth; dense bf16 (tensor
# cores) and f32 (CUDA cores) rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


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


def bound(nbytes: float, flops: float, peak: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` at the ``peak`` rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build(modules):
    """One nvcc per kernel source, all started together."""

    def timed(m):
        t0 = time.perf_counter()
        m.build(verbose=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(modules)) as ex:
        seconds = list(ex.map(timed, modules))
    for m, sec in zip(modules, seconds):
        say(f"[build] {m._SOURCE.relative_to(REPO)} for sm_90a in {sec:.1f} s (built in parallel)")


def gemv_bound(rows: int, shapes=LAYER_GEMVS, x_bytes: int = 2):
    """Bound of the GEMVs ``shapes`` (default: one decode layer's 7) at
    ``rows`` rows of x: packed weights + scales + x + y bytes; 2 flops per
    weight per row at the rate of x's type (int4 weights are exact in bf16:
    the bf16 tensor-core rate for bf16 x, the f32 rate for f32 x)."""
    nbytes = sum(n * k // 2 + 4 * n + x_bytes * rows * (k + n) for n, k in shapes)
    peak = BF16_FLOPS if x_bytes == 2 else F32_FLOPS
    return bound(nbytes, sum(2 * rows * n * k for n, k in shapes), peak)


def phase_kernel(torch, qk):
    """int4_gemv at the 8B decode shapes x GEMV_ROWS, f32 and bf16 x: held
    to the plain version, row 0's bits at B = 1 held to every other B,
    bf16 device times (graph_ms: CUDA graphs, the L2 flushed by a read) beside
    the PR 1 design's, the plain version, the bound, the bf16 dense matmul
    and the library int4 call (``torch._weight_int4pack_mm``, bf16 scales, a
    yardstick that the port never calls)."""
    from scripts.bench_int4_torch import graph_ms, library_int4

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)  # read: over twice the 50 MB L2
    results = {}
    ok = True
    for n, k in GEMV_SHAPES:
        q = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=dev, generator=gen)
        s = torch.rand((n, 1), dtype=torch.float32, device=dev, generator=gen) * 0.02 + 1e-3
        dense = (torch.randn((n, k), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        lib, why = library_int4(torch, q, s)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-3)):
            name = str(dtype)[6:]
            x_all = torch.randn((max(GEMV_ROWS), k), device=dev, generator=gen).to(dtype)
            row0 = qk.int4_matmul(x_all[:1], q, s)[0]
            for i, b in enumerate(GEMV_ROWS):
                x = x_all[:b]
                got = qk.int4_matmul(x, q, s)
                want = qk.int4_matmul_plain(x, q, s)
                torch.cuda.synchronize()
                rel = rel_l2(got.float(), want.float())
                err = float((got.float() - want.float()).abs().max())
                same_bits = bool(torch.equal(got[0], row0))
                passed = rel <= tol and got.dtype == dtype and got.shape == (b, n) and same_bits
                passed &= bool(torch.isfinite(got).all())
                ok &= passed
                if dtype == torch.float32:  # held to its plain version; timed at bf16, the decode path's dtype
                    say(f"[kernel] {name:8s} N={n:5d} K={k:5d} B={b:2d} plan {qk.plan(n, k, dtype)[:2]} "
                        f"relL2={rel:.2e} (tol {tol:.0e}) max_abs={err:.3e} row 0 {'=' if same_bits else '!='} "
                        f"B=1's bits {'ok' if passed else 'FAIL'}")
                    continue
                bound_ms, bound_by = gemv_bound(b, [(n, k)], x.element_size())
                ms = graph_ms(torch, lambda: qk.int4_matmul(x, q, s), flush)
                plain = graph_ms(torch, lambda: qk.int4_matmul_plain(x, q, s), flush)
                row = dict(err=err, ms=ms, plain=plain, previous=GEMV_PREVIOUS_MS[name][(n, k)][i], library=None)
                row["dense"] = graph_ms(torch, lambda: torch.matmul(x, dense.T), flush)
                if lib is not None:
                    try:
                        row["library"] = graph_ms(torch, lambda: lib(x), flush)
                    except Exception as exc:  # a yardstick only: say why it does not run
                        lib, why = None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
                extra = (f" bf16 dense (4x the bytes) {row['dense']:.4f} ms; library int4 "
                         + (f"_weight_int4pack_mm (bf16 scales) {row['library']:.4f} ms" if lib is not None
                            else f"not run ({why})"))
                results[(name, n, k, b)] = dict(row, bound=bound_ms)
                say(
                    f"[kernel] {name:8s} N={n:5d} K={k:5d} B={b:2d} plan {qk.plan(n, k, dtype)[:2]} relL2={rel:.2e} "
                    f"(tol {tol:.0e}) max_abs={err:.3e} row 0 {'=' if same_bits else '!='} B=1's bits | kernel "
                    f"{ms:.4f} ms ({q.numel() / (ms * 1e-3) / 1e9:.0f} GB/s of packed bytes; PR 1 design "
                    f"{row['previous']:.4f} ms) plain {plain:.4f} ms bound {bound_ms:.4f} ms ({bound_by});{extra} "
                    f"{'ok' if passed else 'FAIL'}"
                )
            del x_all, row0
        del q, s, dense, lib
    if not ok:
        raise SystemExit("kernel disagrees with its plain version, or row 0's bits depend on B")
    # one decode layer's seven bf16 GEMVs at B = 1, 4 (generate), 8 (the
    # serve pool's slots, the summary) and 64
    for b in (1, 4, 64, SERVE_SLOTS):
        layer = [results[("bfloat16", n, k, b)] for n, k in LAYER_GEMVS]
        bound_ms, bound_by = gemv_bound(b)
        total = {key: sum(r[key] for r in layer) for key in ("ms", "previous", "plain", "dense")}
        lib_ms = None if any(r["library"] is None for r in layer) else sum(r["library"] for r in layer)
        summary = {
            "max_abs_err": max(r["err"] for r in layer),
            "ms": total["ms"],
            "plain_ms": total["plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,  # torch._weight_int4pack_mm: the nearest library int4 product
        }
        say(
            f"[kernel] one layer's 7 decode GEMVs, B={b} bf16: kernel {total['ms']:.4f} ms (PR 1 design "
            f"{total['previous']:.4f} ms), plain {total['plain']:.4f} ms, bf16 dense {total['dense']:.4f} ms, "
            f"library int4 {'not run' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bound_ms:.4f} ms "
            f"({bound_by})"
        )
    del flush
    return summary


def attn_masks(torch, b, s, gen, dev):
    """The phase's three masks over (b, s): a masked tail, random interior
    holes with a masked tail, and only the last 7 slots valid."""
    slot = torch.arange(s, device=dev)[None, :]
    tail = (slot < (3 * s) // 4).expand(b, s)
    holes = (torch.rand((b, s), device=dev, generator=gen) > 0.25) & (slot < (7 * s) // 8)
    holes[:, 0] = True
    last7 = (slot >= s - 7).expand(b, s)
    neg = torch.full((), -1e9, device=dev)
    zero = torch.zeros((), device=dev)
    return {name: torch.where(ok, zero, neg).contiguous()
            for name, ok in (("tail", tail), ("holes", holes), ("last7", last7))}


def phase_flash(torch, ak):
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = True
    worst = 0.0
    rows = {}
    cases = [(b, s, KVH, GROUP) for b, s in FLASH_SHAPES + [GENERATE_ATTN, SERVE_ATTN]]
    cases.append((*ATTN_405B, *GEOMETRY_405B))
    for b, s, kvh, group in cases:
        q = torch.randn((b, kvh, group, HEAD_DIM), device=dev, generator=gen) / HEAD_DIM**0.5
        k = torch.randn((b, kvh, s, HEAD_DIM), device=dev, generator=gen).to(torch.bfloat16)
        v = torch.randn((b, kvh, s, HEAD_DIM), device=dev, generator=gen).to(torch.bfloat16)
        masks = attn_masks(torch, b, s, gen, dev)
        errs = []
        for name, mask in masks.items():
            got = ak.flash_decode(q, k, v, mask)
            want = ak.flash_decode_plain(q, k, v, mask)
            # the forward's route: the step's slot list, compacted once
            again = ak.flash_decode(q, k, v, mask, slots=ak.compact(mask))
            torch.cuda.synchronize()
            rel = rel_l2(got, want)
            finite = bool(torch.isfinite(got).all())
            passed = rel <= 1e-5 and finite and got.shape == q.shape and torch.equal(again, got)
            ok &= passed
            err = float((got - want).abs().max())
            worst = max(worst, err)
            errs.append(f"{name} {rel:.2e}{'' if passed else ' FAIL'}")
        mask = masks["holes"]
        # the library call: SDPA over (B, H, 1, D) bf16 queries, GQA, same mask
        q_lib = q.reshape(b, kvh * group, 1, HEAD_DIM).to(torch.bfloat16)
        m_lib = mask[:, None, None, :].to(torch.bfloat16)

        def lib():
            return sdpa(q_lib, k, v, attn_mask=m_lib, scale=1.0, enable_gqa=True)

        lib_rel = rel_l2(lib().float().reshape(q.shape), ak.flash_decode_plain(q, k, v, mask))
        slots = ak.compact(mask)
        # per layer the path runs one launch over the step's slot list; a
        # call without one also compacts the mask (two launches)
        ms = time_ms(torch, lambda: ak.flash_decode(q, k, v, mask, slots=slots), flush)
        alone_ms = time_ms(torch, lambda: ak.flash_decode(q, k, v, mask), flush)
        plain = time_ms(torch, lambda: ak.flash_decode_plain(q, k, v, mask), flush)
        lib_ms = time_ms(torch, lib, flush)
        # the kernel reads the K and V rows of valid slots only: the bound
        # counts those, the mask, q and the output
        valid = int((mask > -1e8).sum())
        kv_bytes = 2 * valid * kvh * HEAD_DIM * 2
        nbytes = kv_bytes + 2 * q.numel() * 4 + mask.numel() * 4
        # operations at the f32 rate (q and the softmax are f32); the bytes
        # bound it at any rate the card has
        bound_ms, bound_by = bound(nbytes, 4 * valid * kvh * group * HEAD_DIM, F32_FLOPS)
        every_slot_ms, _ = bound(nbytes + 2 * (b * s - valid) * kvh * HEAD_DIM * 2, 0, F32_FLOPS)
        rows[(b, s, group)] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        old = FLASH_PREVIOUS_MS.get((b, s)) if group == GROUP else None
        chunks = f", {ak.head_chunks(group)[0]} head chunks" if group > ak.CHUNK_GROUP else ""
        say(
            f"[flash] B={b:2d} S={s:5d} KVH={kvh} G={group}{chunks} relL2 {', '.join(errs)} (tol 1e-5) | kernel "
            f"{ms:.4f} ms over the step's slot list ({kv_bytes / (ms * 1e-3) / 1e9:.0f} GB/s of valid K+V, {valid / (b * s):.0%} of slots), "
            f"{alone_ms:.4f} ms compacting itself"
            f"{f' (previous design, compacting: {old} ms)' if old else ''}; plain {plain:.4f} ms "
            f"SDPA {lib_ms:.4f} ms (bf16 q, relL2 {lib_rel:.1e}) bound {bound_ms:.4f} ms ({bound_by}; "
            f"{every_slot_ms:.4f} ms were every slot valid)"
        )
        del q, k, v, masks
    if not ok:
        raise SystemExit("flash_decode disagrees with its plain version")
    summary = {"max_abs_err": worst, **rows[(*SERVE_ATTN, GROUP)]}
    for name, shape in (("serve-pool", SERVE_ATTN), ("generate", GENERATE_ATTN)):
        r = rows[(*shape, GROUP)]
        say(f"[flash] {name} shape B={shape[0]} S={shape[1]}: kernel {r['ms']:.4f} ms (previous design "
            f"{FLASH_PREVIOUS_MS[shape]} ms), SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms")
    r = rows[(*ATTN_405B, GEOMETRY_405B[1])]
    say(f"[flash] Llama-3.1-405B geometry (KVH {GEOMETRY_405B[0]}, G {GEOMETRY_405B[1]}, D {HEAD_DIM}) "
        f"B={ATTN_405B[0]} S={ATTN_405B[1]}: kernel {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms")
    say(f"[flash] max abs err vs plain {worst:.3e}")
    del flush
    return summary


def phase_geometries(torch, ak):
    """Two Llama geometries beside the 8B's, built and decoded on the card
    (2 layers, random bf16 weights): Llama-3.1-405B's group of 16 query
    heads per KV head at head dim 128 (hidden cut from 16384 to 2048: 16
    heads over 1 KV head) runs the flash kernel; head dim 96 runs the
    counted einsum path. Each decode step's logits are held to the same
    step on the einsum attention."""
    from shardmerge_tpu_torch.models import llama

    dev = torch.device("cuda:0")
    for label, heads, kv_heads, hidden, route in (("G=16 D=128", 16, 1, 2048, "flash_decode"),
                                                   ("D=96", 2, 1, 192, "decode_einsum")):
        cfg = llama.ModelConfig(vocab_size=1024, hidden_size=hidden, intermediate_size=512, num_hidden_layers=2,
                                num_attention_heads=heads, num_key_value_heads=kv_heads)
        gen = torch.Generator(device=dev).manual_seed(heads)
        d, kv = cfg.head_dim, kv_heads * cfg.head_dim

        def w(*shape):
            return (torch.randn(shape, device=dev, generator=gen) * 0.05).to(torch.bfloat16)

        def layer():
            ones = torch.ones(hidden, device=dev).bfloat16()
            return {"q_proj": w(hidden, hidden), "k_proj": w(kv, hidden), "v_proj": w(kv, hidden),
                    "o_proj": w(hidden, hidden), "gate_proj": w(512, hidden), "up_proj": w(512, hidden),
                    "down_proj": w(hidden, 512), "input_layernorm": ones, "post_attention_layernorm": ones}

        model = llama.LlamaModel(cfg, {"embed_tokens": w(1024, hidden), "lm_head": w(1024, hidden),
                                       "norm": torch.ones(hidden, device=dev).bfloat16(), "layers": [layer(), layer()]})
        rope = llama.rope_tables(cfg, 512, dev)
        cache = llama.init_kv_cache(cfg, 2, 512, torch.bfloat16, dev)
        ids = torch.randint(0, 1024, (2, 300), device=dev, generator=gen)
        with torch.inference_mode():
            logits, cache = model(ids, torch.arange(300, device=dev)[None].expand(2, 300), cache, 0, rope, 300)
            tok = logits[:, -1].argmax(-1)[:, None]
            step = torch.full((2, 1), 300, device=dev)
            plain_cache = {n: t.clone() for n, t in cache.items()}
            ak.reset_launch_counts()
            got, _ = model(tok, step, cache, 300, rope, 301)
            counts = dict(ak.launch_counts)
            with mock.patch.object(ak, "use_flash_decode", lambda *a: False):
                want, _ = model(tok, step, plain_cache, 300, rope, 301)
        rel = rel_l2(got, want)
        ok = counts.get(route) == cfg.num_hidden_layers and rel <= 2e-2 and bool(torch.isfinite(got).all())
        say(f"[geometry] {label} (head dim {d}, {heads // kv_heads} query heads per KV head): decode step routes "
            f"{counts}; logits vs the einsum attention relL2 {rel:.2e} (tol 2e-2) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[geometry] {label} did not decode through {route}")
        del model, cache, plain_cache


def fft_bound(lines: int, length: int):
    """Bound of one complex FFT pass over ``lines`` lines of ``length``
    f32 re/im values, whatever implements it: both planes read once and
    written once; 5 * L * log2(L) flops per line at the f32 CUDA-core
    rate."""
    return bound(16 * lines * length, 5 * length * math.log2(length) * lines, F32_FLOPS)


def dft_route(pf, name: str, shape) -> str:
    """The DFT kernel's route at ``shape``: its passes (length, radices,
    lines per block, threads) and device launches."""
    passes = pf._plan(name, *shape)
    desc = "; ".join(f"L={p.L} radices {list(p.radices)} {p.W} lines x {p.threads or 'direct'} threads"
                     for p in passes)
    return f"{len(passes)} device launch{'es' if len(passes) > 1 else ''} ({desc})"


def fft_check(torch, label, got, want, truth):
    """relL2 of the (re, im) pair ``got`` against the plain version's pair
    and the complex128 truth; max abs error against the plain version."""
    z = torch.complex(got[0].double(), got[1].double())
    w = torch.complex(want[0].double(), want[1].double())
    rel_plain = float((z - w).abs().norm() / w.abs().norm())
    rel_truth = float((z - truth).abs().norm() / truth.abs().norm())
    err = float((z - w).abs().max())
    finite = bool(torch.isfinite(z).all())
    passed = rel_plain <= 1e-5 and rel_truth <= 1e-5 and finite
    say(f"[fft] {label}: relL2 vs plain {rel_plain:.2e}, vs complex128 truth {rel_truth:.2e} (tol 1e-5), "
        f"max abs err vs plain {err:.3e}{'' if finite else ' NOT FINITE'} {'ok' if passed else 'FAIL'}")
    return passed, err


def phase_fft(torch, pf, fv):
    """The spectral-transform path: each kernel against its plain version
    and a complex128 truth; the rfft2 -> irfft2 round trip of
    scripts/bench_fft_vpu.py and its four-step counterpart at the bench
    shape, with the launch counters read around it; per-kernel timings."""
    import numpy as np

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)
    ok = True
    errs = {}
    for m, n in DFT_SHAPES:
        xr = torch.randn((m, n), device=dev, generator=gen)
        xi = torch.randn((m, n), device=dev, generator=gen)
        z = torch.complex(xr.double(), xi.double())
        for name, kernel, plain, dim in (("dft_rows", pf.dft_rows, pf.dft_rows_plain, 1),
                                         ("dft_cols", pf.dft_cols, pf.dft_cols_plain, 0)):
            length = (m, n)[dim]
            for inverse in (False, True):
                got = kernel(xr, xi, inverse=inverse)
                want = plain(xr, xi, inverse=inverse)
                truth = torch.fft.ifft(z, dim=dim) if inverse else torch.fft.fft(z, dim=dim)
                torch.cuda.synchronize()
                passed, err = fft_check(
                    torch, f"{name} ({m}, {n}) length {length}, {dft_route(pf, name, (m, n))} "
                    f"{'inverse' if inverse else 'forward'}", got, want, truth)
                ok &= passed
                errs[(name, m, n, inverse)] = err
                del got, want, truth
        del xr, xi, z
    for b, n in STOCKHAM_SHAPES:
        zr = torch.randn((b, n), device=dev, generator=gen)
        zi = torch.randn((b, n), device=dev, generator=gen)
        z = torch.complex(zr.double(), zi.double())
        for inverse in (False, True):
            got = fv.fft_batched(zr, zi, inverse)
            want = fv.fft_batched_plain(zr, zi, inverse)
            truth = torch.fft.ifft(z, dim=1) if inverse else torch.fft.fft(z, dim=1)
            torch.cuda.synchronize()
            passed, err = fft_check(
                torch, f"fft_batched B={b} N={n} radices {list(fv._schedule(n))} "
                f"{'inverse' if inverse else 'forward'}", got, want, truth)
            ok &= passed
            errs[("fft_batched", b, n, inverse)] = err
            del got, want, truth
        del zr, zi, z
    if not ok:
        raise SystemExit("[fft] a kernel disagrees with its plain version or the truth")

    # the entry point's round trip (scripts/bench_fft_vpu.py), the four-step
    # one beside it, and the library's
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(FFT_SHAPE).astype(np.float32)).to(dev)

    def vpu_round():
        return fv.irfft2_vpu(fv.rfft2_vpu(x), FFT_SHAPE)

    def mxu_round():
        return pf.ifft2_mxu(*pf.fft2_mxu(x))[0]

    def lib_round():
        return torch.fft.irfftn(torch.fft.rfftn(x), s=FFT_SHAPE)

    reset_counts(pf, fv)
    out_vpu = vpu_round()
    out_mxu = mxu_round()
    torch.cuda.synchronize()
    launches = {"dft_rows": pf.launch_counts["dft_rows"], "dft_cols": pf.launch_counts["dft_cols"],
                "fft_batched": fv.launch_counts["fft_batched"]}
    lib = lib_round()
    rel = {k: (rel_l2(v, x), rel_l2(v, lib)) for k, v in (("vpu", out_vpu), ("mxu", out_mxu))}
    finite = all(bool(torch.isfinite(v).all()) for v in (out_vpu, out_mxu))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = {k: time_ms(torch, fn, flush, reps=10) for k, fn in
          (("vpu", vpu_round), ("mxu", mxu_round), ("lib", lib_round))}
    say(f"[fft] round trip at {FFT_SHAPE} (rng 7): irfft2_vpu(rfft2_vpu(x)) relL2 to x {rel['vpu'][0]:.2e}, "
        f"to cuFFT's irfftn(rfftn(x)) {rel['vpu'][1]:.2e}, {ms['vpu']:.4f} ms; ifft2_mxu(fft2_mxu(x)) relL2 to x "
        f"{rel['mxu'][0]:.2e}, to cuFFT's {rel['mxu'][1]:.2e}, {ms['mxu']:.4f} ms; cuFFT round trip "
        f"{ms['lib']:.4f} ms (tol 1e-5 to x); launches {launches}")
    if not finite or max(rel["vpu"][0], rel["mxu"][0]) > 1e-5:
        raise SystemExit("[fft] a round trip does not return its input")
    if min(launches.values()) < 1:
        raise SystemExit(f"[fft] kernels not on the path: {launches}")
    del out_vpu, out_mxu, lib
    round_trip_split(torch, fv, vpu_round)

    # per-kernel times at the round trip's shapes, then the DFTs at the
    # 14336-long axes (radix 7 in one pass for rows, two passes for columns)
    m, n = FFT_SHAPE
    xr = torch.randn(FFT_SHAPE, device=dev, generator=gen)
    xi = torch.randn(FFT_SHAPE, device=dev, generator=gen)
    summaries = {}
    cases = [("dft_rows", pf.dft_rows, pf.dft_rows_plain, xr, xi, 1, m, n),
             ("dft_cols", pf.dft_cols, pf.dft_cols_plain, xr, xi, 0, n, m)]
    for name, kernel, plain, shape, dim in (("dft_rows", pf.dft_rows, pf.dft_rows_plain, (4096, 14336), 1),
                                            ("dft_cols", pf.dft_cols, pf.dft_cols_plain, (14336, 4096), 0)):
        cases.append((f"{name} long axis", kernel, plain, torch.randn(shape, device=dev, generator=gen),
                      torch.randn(shape, device=dev, generator=gen), dim, shape[1 - dim], shape[dim]))
    for b in (m, fv._plan(FFT_SHAPE)["p"]):  # rows pass (4096, 4096), padded columns pass (4128, 4096)
        zr = torch.randn((b, n // 2), device=dev, generator=gen)
        zi = torch.randn((b, n // 2), device=dev, generator=gen)
        cases.append((f"fft_batched B={b}", lambda r, i: fv.fft_batched(r, i, False),
                      lambda r, i: fv.fft_batched_plain(r, i, False), zr, zi, 1, b, n // 2))
    for name, kernel, plain, r, i, dim, lines, length in cases:
        zlib = torch.complex(r, i)
        k_ms = time_ms(torch, lambda: kernel(r, i), flush)
        p_ms = time_ms(torch, lambda: plain(r, i), flush)
        l_ms = time_ms(torch, lambda: torch.fft.fft(zlib, dim=dim), flush)
        del zlib
        bound_ms, bound_by = fft_bound(lines, length)
        key = name.split()[0]
        note = f"; {dft_route(pf, key, tuple(r.shape))}" if key.startswith("dft") else ""
        err = errs.get((key, m, n, False)) if key != "fft_batched" else errs.get((key, lines, length, False))
        summaries.setdefault(key, dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, library_ms=l_ms))
        if key == "fft_batched" and lines == m:
            note = f"; the previous design took {STOCKHAM_PREVIOUS_MS} ms"
        say(f"[fft] {name} at ({r.shape[0]}, {r.shape[1]}) forward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"torch.fft.fft {l_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {16 * lines * length / 1e6:.0f} MB, "
            f"{5 * length * math.log2(length) * lines / 1e9:.2f} GFLOP){note}")
    del flush
    return summaries, launches


def device_kernels(torch, prof):
    """(device microseconds, launches) by kernel name from a profile."""
    return {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def round_trip_split(torch, fv, fn, calls: int = 5):
    """Device time of the rfft2 -> irfft2 round trip under torch.profiler,
    split between the fft_batched kernel and the PyTorch passes around it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(torch, prof)
    if not kernels:
        say("[fft] round trip device-time split: not measured (the profiler saw no device time)")
        return
    ours = {k: v for k, v in kernels.items() if any(n in k for n in STOCKHAM_KERNELS)}
    rest = {k: v for k, v in kernels.items() if k not in ours}
    fft_us = sum(t for t, _ in ours.values()) / calls
    rest_us = sum(t for t, _ in rest.values()) / calls
    top = ", ".join(f"{k[:36]} {t / calls / 1e3:.4f} ms x{n // calls}"
                    for k, (t, n) in sorted(rest.items(), key=lambda kv: -kv[1][0])[:6])
    say(f"[fft] round trip device time (profiler, mean of {calls}): {(fft_us + rest_us) / 1e3:.4f} ms = "
        f"fft_batched {fft_us / 1e3:.4f} ms ({sum(n for _, n in ours.values()) // calls} launches) + PyTorch "
        f"passes {rest_us / 1e3:.4f} ms ({sum(n for _, n in rest.values()) // calls} launches: {top})")


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


def merge_config(root: Path, name: str, base: Path, finetunes, **extra) -> Path:
    """A merge config file: ``finetunes`` are (model dir, alpha) pairs."""
    cfg = {
        "output_base_model": str(base),
        "finetune_merge": [{"model": str(m), "base": str(base), "alpha": a} for m, a in finetunes],
        "output_dir": str(root / name),
        "cache_dir": str(root / "cache"),
        "storage_dir": str(root / "storage"),
        **extra,
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def cli_merge(cfg_file: Path):
    """``python -m shardmerge_tpu_torch merge``: (its JSON stats, process wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shardmerge_tpu_torch", "merge", str(cfg_file)],
        cwd=REPO, capture_output=True, text=True,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stderr[-4000:])
        raise SystemExit(f"merge of {cfg_file.name} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def check_output(torch, out: Path, base: Path, tag: str):
    """The output index mirrors the base's and every tensor is finite bf16."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    index_name = "model.safetensors.index.json"
    if json.loads((out / index_name).read_text()) != json.loads((base / index_name).read_text()):
        raise SystemExit(f"{tag}: merged index does not mirror the base index")
    weight_map = json.loads((out / index_name).read_text())["weight_map"]
    for shard in sorted(set(weight_map.values())):
        for name, t in load_file(out / shard).items():
            if t.dtype != torch.bfloat16 or not bool(torch.isfinite(t.cuda()).all()):
                raise SystemExit(f"{tag}: {name} is not finite bf16")
    return weight_map


def phase_merge(torch, root: Path, dirs):
    from shardmerge_tpu_torch.io.safetensors_io import load_file
    from shardmerge_tpu_torch.merge import fourier
    from shardmerge_tpu_torch.ops import blend

    base, ft1, ft2 = dirs
    out = root / "merged"
    cfg_file = merge_config(root, "merged", base, [(ft1, 0.8), (ft2, 0.4)])
    stats, wall = cli_merge(cfg_file)
    per_tensor = {k: v["wall_s"] for k, v in stats["tensor_spans"].items()}
    merged = {k: v for k, v in per_tensor.items() if k.startswith("model.layers.")}
    say(
        f"[merge] wall {wall:.1f} s (process, incl. startup) on {stats['device']}; "
        f"{stats['tensors_merged']} tensors ({stats['tensors_passthrough']} passthrough); "
        f"regimes {stats['pair_merges']}; NaNs scrubbed {stats['nans_scrubbed']}; "
        f"per merged tensor mean {sum(merged.values()) / len(merged) * 1e3:.1f} ms, "
        f"max {max(merged.values()) * 1e3:.1f} ms; host syncs {stats['host_syncs']}"
    )
    say(
        f"[merge] spans: read {stats['span_fetch_s']:.2f} s, host->device {stats['span_h2d_s']:.2f} s, "
        f"merge {stats['span_merge_s']:.2f} s (incl. the two above), device->host wait + shard "
        f"staging {stats['span_flush_s']:.2f} s; {stats['prefetch_device_hits']} inputs staged ahead on the card"
    )
    for name, sec in per_tensor.items():
        say(f"[merge]   {sec * 1e3:8.1f} ms  {name}")
    if stats["pair_merges"].get("slerp") != 9 * LAYERS:
        raise SystemExit(f"expected {9 * LAYERS} slerp pair merges, got {stats['pair_merges']}")
    weight_map = check_output(torch, out, base, "[merge]")
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


def write_finetunes(torch, root: Path, base: Path, scales, seed: int = 3):
    """More finetunes of ``base``: its bf16 tensors + scale * N(0, 1) from a
    seeded generator on the card, bf16, in the base's shards and index."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file, save_file

    dev = torch.device("cuda:0")
    index = (base / "model.safetensors.index.json").read_text()
    shards = sorted(set(json.loads(index)["weight_map"].values()))
    dirs = []
    for i, (name, scale) in enumerate(scales.items()):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        d = root / name
        d.mkdir()
        for shard in shards:
            staged = {}
            for key, t in load_file(base / shard).items():
                x = t.to(dev).float()
                staged[key] = (x + scale * torch.randn(x.shape, device=dev, generator=gen)).to(torch.bfloat16).cpu()
            save_file(staged, d / shard, metadata={"format": "pt"})
        (d / "model.safetensors.index.json").write_text(index)
        shutil.copy(base / "config.json", d / "config.json")
        dirs.append(d)
    return dirs


def device_busy(torch, prof):
    """Union of the profiled device intervals (kernels, copies), in s. Read
    from the profiler's raw Kineto events: building ``prof.events()`` for a
    whole merge's launches took seconds of Python a call."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda and e.duration_ns() > 0
    )
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9


class StackSampler:
    """Samples the Python stacks of a process's threads every ``period`` s
    from a daemon thread: one thread's time by site (its innermost frame,
    and the nearest frame of the port around it), and the longest gap
    between two samples (a stretch in which the sampler could not take the
    GIL) with the sites of the other threads that moved across it."""

    def __init__(self, thread_id: int, period: float = 0.005):
        self.thread_id, self.period = thread_id, period
        self.counts: dict = {}
        self.max_gap = 0.0
        self.across_gap: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _site(frame) -> str:
        inner = f"{Path(frame.f_code.co_filename).name}:{frame.f_lineno} {frame.f_code.co_name}"
        own = frame
        while own is not None and "shardmerge_tpu_torch" not in own.f_code.co_filename:
            own = own.f_back
        if own is None or own is frame:
            return inner
        return f"{Path(own.f_code.co_filename).name}:{own.f_lineno} {own.f_code.co_name} -> {inner}"

    def _run(self):
        last, before = time.perf_counter(), {}
        while not self._stop.wait(self.period):
            now = time.perf_counter()
            frames = sys._current_frames()
            frames.pop(threading.get_ident(), None)
            sites = {tid: self._site(f) for tid, f in frames.items()}
            if now - last > self.max_gap:
                self.max_gap = now - last
                names = {t.ident: t.name for t in threading.enumerate()}
                self.across_gap = {names.get(tid, tid): (before.get(tid), site) for tid, site in sites.items()
                                   if before.get(tid) != site}
            last, before = now, sites
            if self.thread_id in sites:
                site = sites[self.thread_id]
                self.counts[site] = self.counts.get(site, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def top(self, n: int):
        """The n sites that took the most samples, as (ms, site)."""
        ranked = sorted(self.counts.items(), key=lambda kv: -kv[1])[:n]
        return [(count * self.period * 1e3, site) for site, count in ranked]


def pipeline_profile(torch, label: str, cfg_file: Path, card: str):
    """The merge of ``cfg_file`` in process, sequential (this code with
    read-ahead, device staging and the background flush off), pipelined
    (the defaults) and pipelined again (PyTorch's page-locked host pool now
    holds the blocks the first pipelined run allocated), each under
    torch.profiler with its merge thread stack-sampled (``StackSampler``):
    the device's busy share over the merge and, for each merged (14336,
    4096) tensor, its wall and spans."""
    from torch.profiler import ProfilerActivity, profile

    from shardmerge_tpu_torch.cli import run_merge
    from shardmerge_tpu_torch.config import MergeConfig

    wide = (LLAMA_31_8B["intermediate_size"], LLAMA_31_8B["hidden_size"])
    names = [f"model.layers.{l}.mlp.{p}.weight" for l in range(LAYERS) for p in ("gate_proj", "up_proj")]
    runs = {}
    sides = (("sequential", dict(prefetch_depth=0, device_prefetch_depth=0, background_flush=False)),
             ("pipelined", {}), ("pipelined again", {}))
    for side, options in sides:
        cfg = MergeConfig.from_file(cfg_file)
        cfg.output_dir = str(Path(cfg.output_dir).with_name(f"{Path(cfg.output_dir).name}_{side.replace(' ', '_')}"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                StackSampler(threading.get_ident()) as sampler:
            t0 = time.perf_counter()
            merger = run_merge(cfg, "cuda:0", **options)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        shutil.rmtree(cfg.output_dir)
        busy = device_busy(torch, prof)
        runs[side] = merger.tensor_spans
        s = merger.stats
        top = sorted(merger.tensor_spans.items(), key=lambda kv: -kv[1]["wall_s"])[:3]
        say(f"[{label}] pipeline {side} ({card}): whole merge in process {wall:.2f} s, device busy "
            f"{busy:.2f} s = {busy / wall:.1%} (torch.profiler, union of kernels and copies); spans read "
            f"{s.span_fetch_s:.2f} s, h2d {s.span_h2d_s:.2f} s, merge {s.span_merge_s:.2f} s, flush "
            f"{s.span_flush_s:.2f} s; {s.prefetch_device_hits} inputs staged ahead; largest walls "
            + ", ".join(f"{n} {v['wall_s'] * 1e3:.1f} ms (merge {v['merge_s'] * 1e3:.1f}, flush "
                        f"{v['flush_s'] * 1e3:.1f})" for n, v in top))
        say(f"[{label}] {side} merge thread by site (stack samples every {sampler.period * 1e3:.0f} ms; "
            f"longest gap between samples {sampler.max_gap * 1e3:.1f} ms): "
            + "; ".join(f"{ms:.0f} ms {site}" for ms, site in sampler.top(6)))
        say(f"[{label}] {side} threads whose stack moved across that gap: "
            + "; ".join(f"{name}: {a} => {b}" for name, (a, b) in sampler.across_gap.items()))
    for name in names:
        if name not in runs["pipelined"]:
            continue
        cells = [f"{key[:-2]} " + " / ".join(f"{runs[side][name][key] * 1e3:.1f}" for side, _ in sides)
                 for key in ("wall_s", "read_s", "h2d_s", "merge_s", "flush_s")]
        say(f"[{label}]   {wide} {name} {' / '.join(side for side, _ in sides)}, ms ({card}): "
            + ", ".join(cells))


def hold_to_host(torch, dirs, names, alphas, weight_map, out: Path, card: str):
    """One tensor's 4-finetune reduction on the card, held to the host.

    The card's in-process reduction must give the CLI's bits. Every pair
    merge of the card's plan is then run on the host on the card's own
    inputs: round 1 (raw deltas) must agree to 97% within 2e-2; a later
    round's operands carry round 1's culled spectral zeros, whose FFT
    round-trip noise picks sign agreement, so there the blend is held on
    identical spectra (cutoff threshold bit for bit, blended half spectrum
    within relL2 1e-5). batch_rounds' pair merges are held to the per-pair
    path on the same inputs, and both reductions are timed in turn.

    The card's side runs here, timings included. The host's side (a minute
    of CPU at these shapes) is handed to a worker thread; the returned
    ``finish()`` waits for it, prints its lines and applies its gates, so
    the host works beside what the caller runs in between."""
    from shardmerge_tpu_torch.config import MergeConfig, MergeModel
    from shardmerge_tpu_torch.io.safetensors_io import load_file
    from shardmerge_tpu_torch.merge import fourier
    from shardmerge_tpu_torch.ops import blend, select

    base_dir = dirs["base"]
    cfg = MergeConfig(
        finetune_merge=[MergeModel(model=str(dirs[m]), base=str(base_dir), alpha=alphas[m]) for m in names],
        output_base_model=str(base_dir),
        output_dir=str(out),
    )
    card_eng = fourier.FourierMerge(cfg, device="cuda:0")
    batch_eng = fourier.FourierMerge(cfg, device="cuda:0", batch_rounds=True)
    host_eng = fourier.FourierMerge(cfg, device="cpu")

    def blend_on(dev, h0, h1, a_prop, ranks, cols):
        x0, x1 = h0.to(dev), h1.to(dev)
        w = blend.hermitian_col_weights(cols, device=dev)
        thr = select.kth_smallest_weighted(x0.real.abs(), ranks[0], w, y=x1.real.abs())
        res = blend.interpolate_half_spectrum(x0, x1, torch.tensor(a_prop, device=dev), 1.0, *ranks, w,
                                              use_cutoff=True, use_cull=True)
        return thr.cpu(), res.cpu()

    host_work = []  # (name, tag, kind, the card's result, the host's call)
    for name in STACK_CHECKED:
        shard = weight_map[name]
        base = load_file(base_dir / shard)[name]
        fts = [load_file(dirs[m] / shard)[name] for m in names]

        def entries(dev):
            return [(str(dirs[m]), ft.to(dev).float() - base.to(dev).float(), alphas[m])
                    for m, ft in zip(names, fts)]

        trace = []
        card_delta, _ = card_eng.reduce_deltas(entries("cuda:0"), trace=trace)
        card_out = fourier._finalize(base.cuda().float(), card_delta)[0].cpu()
        cli_out = load_file(out / shard)[name]
        if not torch.equal(card_out.view(torch.int16), cli_out.view(torch.int16)):
            raise SystemExit(f"[stack] {name}: the in-process reduction does not give the CLI's bits")
        for job, target, cull, a, b, merged in trace:
            regime, a_name, b_name, _, params = job
            ha, hb = a.cpu(), b.cpu()
            tag = f"[stack] {name} ({card}) {regime} {Path(a_name).name[:24]} + {Path(b_name).name[:24]}, cull {cull}"
            if cull == card_eng.cull_start_pct:
                host_work.append((name, tag, "round 1", merged.cpu(),
                                  (lambda job=job, ha=ha, hb=hb, target=target, cull=cull:
                                   host_eng.merge_pair(job, ha, hb, target, cull)[0])))
                continue
            if regime != "slerp" or not fourier._use_fast_imag(False, ha):
                raise SystemExit(f"[stack] {name}: expected fast-path slerp pairs after round 1, got {regime}")
            norm_a, norm_b, a_prop = params
            n = ha.numel()
            h0 = fourier._rfft2(ha) * (1.0 / torch.tensor(norm_a))
            h1 = fourier._rfft2(hb) * (1.0 / torch.tensor(norm_b))
            ranks = (blend.cutoff_rank(n, 0.08), blend.cull_rank(n, cull), blend.cull_limit(n, cull))
            args = (h0, h1, a_prop, ranks, ha.shape[-1])
            host_work.append((name, tag, "spectra", blend_on("cuda:0", *args),
                              (lambda args=args: blend_on("cpu", *args))))
        # batch_rounds: each batched pair merge against the per-pair path
        # on the same inputs (round 1's two slerp pairs form one batch)
        batched = []
        batch_eng.reduce_deltas(entries("cuda:0"), trace=batched)
        errs = [rel_l2(merged, card_eng.merge_pair(job, a, b, target, cull)[0])
                for job, target, cull, a, b, merged in batched if cull == card_eng.cull_start_pct]
        say(f"[stack] {name} ({card}) batch_rounds: round 1's {len(errs)} pairs in one batch against the "
            f"per-pair path on the same inputs: relL2 {', '.join(f'{e:.2e}' for e in errs)} (gate 1e-6; "
            f"{'bit-equal' if max(errs) == 0 else 'the batched cuFFT plans change bits'})")
        if len(errs) < 2 or max(errs) > 1e-6:
            raise SystemExit(f"[stack] {name}: batched pair merges disagree with the per-pair path")
        times = {"per pair": [], "batched": []}
        for _ in range(3):
            for tag, eng in (("per pair", card_eng), ("batched", batch_eng)):
                stack = entries("cuda:0")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.reduce_deltas(stack)
                torch.cuda.synchronize()
                times[tag].append((time.perf_counter() - t0) * 1e3)
        say(f"[stack] {name} ({card}) reduction of the 4 deltas, ms (3 runs in turn, medians): per pair "
            f"{sorted(times['per pair'])[1]:.2f}, batch_rounds {sorted(times['batched'])[1]:.2f} (all: "
            + "; ".join(f"{k} {', '.join(f'{v:.2f}' for v in vs)}" for k, vs in times.items()) + ")")

    # the host's side, one pair at a time on a worker thread (torch's CPU
    # ops release the GIL), after every card measurement above
    pool = ThreadPoolExecutor(1)
    futures = [pool.submit(call) for *_, call in host_work]
    pool.shutdown(wait=False)
    t_submit = time.perf_counter()

    def finish():
        for (name, tag, kind, card_side, _), future in zip(host_work, futures):
            host = future.result()
            if kind == "round 1":
                close = torch.isclose(card_side, host, rtol=2e-2, atol=1e-6).double().mean().item()
                say(f"{tag}: card vs host on the same inputs {close * 100:.3f}% within 2e-2 (gate 97%), "
                    f"relL2 {rel_l2(card_side, host):.2e}")
                if close < 0.97:
                    raise SystemExit(f"[stack] {name}: a round-1 pair merge disagrees with the host")
                continue
            same_thr = torch.equal(host[0].view(torch.int32), card_side[0].view(torch.int32))
            res_rel = rel_l2(torch.view_as_real(card_side[1]), torch.view_as_real(host[1]))
            # the whole pair merge is not held here (nor run on the host, to
            # keep the script inside its time): FFT round-trip noise of the
            # culled zeros picks sign agreement
            say(f"{tag}: on identical spectra the cutoff threshold is {'bit-equal' if same_thr else 'DIFFERENT'} "
                f"and the blended half spectrum within relL2 {res_rel:.2e} (gate 1e-5)")
            if not same_thr or res_rel > 1e-5:
                raise SystemExit(f"[stack] {name}: the card's blend disagrees with the host's on identical spectra")
        say(f"[stack] the host's side of {len(host_work)} pair merges of {len(STACK_CHECKED)} tensors came in "
            f"{time.perf_counter() - t_submit:.1f} s after it was handed over")

    return finish


def subset_model(torch, dirs, root: Path, names, tensors=STACK_SUBSET, rows=None) -> dict:
    """Copies of the models holding only ``tensors`` (their first ``rows``
    rows with ``rows``), one shard each, under ``root``/subset."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, save_file

    weight_map = json.loads((dirs["base"] / "model.safetensors.index.json").read_text())["weight_map"]
    out = {}
    for m in ["base", *names]:
        d = root / "subset" / m
        d.mkdir(parents=True)
        staged = {}
        for name in tensors:
            with SafeTensorsReader(dirs[m] / weight_map[name]) as r:
                t = r.get_tensor(name, copy=True)
            staged[name] = t if rows is None else t[:rows].clone()
        save_file(staged, d / "model.safetensors", metadata={"format": "pt"})
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": {n: "model.safetensors" for n in tensors}}))
        out[m] = d
    return out


def phase_stack(torch, root: Path, dirs, card: str):
    """Base + 3 and + 4 finetunes through the CLI, held to the host and to
    the engine's own variants, with the pipeline's spans. Returns the
    finetunes' directories, the 3-finetune merge's spans and
    ``hold_to_host``'s ``finish`` (its host side runs on while the
    variants and [shard] run)."""
    from shardmerge_tpu_torch.cli import run_merge
    from shardmerge_tpu_torch.config import MergeConfig
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    t0 = time.perf_counter()
    dirs = {"base": dirs[0], "ft1": dirs[1], **dict(zip(STACK_SCALES, write_finetunes(torch, root, dirs[0], STACK_SCALES)))}
    say(f"[stack] finetunes {', '.join(STACK_SCALES)} of the [merge] base (delta scales "
        f"{', '.join(str(v) for v in STACK_SCALES.values())} against ft1's 0.01) written in "
        f"{time.perf_counter() - t0:.1f} s")
    merged_per_layer = 9
    for names in (STACK_FOUR[:3], STACK_FOUR):  # the CLI's walls before the host checks start
        n = len(names)
        label = f"{n}-ft"
        cfg_file = merge_config(root, f"stack{n}", dirs["base"], [(dirs[m], STACK_ALPHAS[m]) for m in names])
        stats, wall = cli_merge(cfg_file)
        pairs = sum(stats["pair_merges"].values())
        merged = [v["wall_s"] for k, v in stats["tensor_spans"].items() if k.startswith("model.layers.")]
        say(f"[stack] {label} CLI merge ({card}): wall {wall:.1f} s (process, incl. startup); regimes "
            f"{stats['pair_merges']}; host syncs {stats['host_syncs']}; NaNs scrubbed {stats['nans_scrubbed']}; "
            f"per merged tensor mean {sum(merged) / len(merged) * 1e3:.1f} ms, max {max(merged) * 1e3:.1f} ms; "
            f"spans read {stats['span_fetch_s']:.2f} s, h2d {stats['span_h2d_s']:.2f} s, merge "
            f"{stats['span_merge_s']:.2f} s, flush {stats['span_flush_s']:.2f} s")
        if pairs != (n - 1) * merged_per_layer * LAYERS:
            raise SystemExit(f"[stack] {label}: {pairs} pair merges, expected {(n - 1) * merged_per_layer * LAYERS}")
        if stats["host_syncs"] != 2 * merged_per_layer * LAYERS:
            raise SystemExit(f"[stack] {label}: {stats['host_syncs']} host syncs, expected one per round")
        out = root / f"stack{n}"
        weight_map = check_output(torch, out, dirs["base"], f"[stack] {label}")
        say(f"[stack] {label}: index mirrors the base; all finite bf16; {pairs} pair merges = "
            f"{n - 1} a merged tensor")
        if n == 3:
            stack3 = {k: v for k, v in stats["tensor_spans"].items()
                      if k.endswith(("gate_proj.weight", "up_proj.weight"))}
        if n == 4:
            finish = hold_to_host(torch, dirs, names, STACK_ALPHAS, weight_map, out, card)
            cli_subset = {k: load_file(out / weight_map[k])[k] for k in STACK_SUBSET}
        shutil.rmtree(out)

    # the variants, in process on a subset of the tensors
    sub = subset_model(torch, dirs, root, STACK_FOUR)
    outs = {}
    for tag, extra, options in (("default", {}, {}), ("hbm_budget_gb 0", {"hbm_budget_gb": 0}, {}),
                                ("prefetch_depth 0", {}, {"prefetch_depth": 0}),
                                ("batch_rounds", {}, {"batch_rounds": True})):
        cfg = MergeConfig.from_file(merge_config(
            root, f"variant{len(outs)}", sub["base"], [(sub[m], STACK_ALPHAS[m]) for m in STACK_FOUR], **extra))
        merger = run_merge(cfg, "cuda:0", **options)
        outs[tag] = load_file(Path(cfg.output_dir) / "model.safetensors")
        shutil.rmtree(cfg.output_dir)
        if tag == "default":
            for k in STACK_SUBSET:
                if not torch.equal(outs[tag][k].view(torch.int16), cli_subset[k].view(torch.int16)):
                    raise SystemExit(f"[stack] the subset merge of {k} does not give the full CLI run's bits")
            continue
        diffs = {k: rel_l2(outs[tag][k].float(), outs["default"][k].float()) for k in STACK_SUBSET}
        same = all(torch.equal(outs[tag][k].view(torch.int16), outs["default"][k].view(torch.int16))
                   for k in STACK_SUBSET)
        say(f"[stack] variant {tag} ({card}): {'bit-equal to' if same else 'differs from'} the default run"
            f"{'' if same else ' (relL2 ' + ', '.join(f'{v:.2e}' for v in diffs.values()) + ')'}; "
            f"hbm spills {merger.stats.hbm_spills}, host syncs {merger.stats.host_syncs}")
        if tag == "hbm_budget_gb 0" and merger.stats.hbm_spills == 0:
            raise SystemExit("[stack] hbm_budget_gb 0 spilled nothing")
        # batch_rounds is held per pair above: its batched forward FFTs may
        # change round 1's bits, which round 2 amplifies (see hold_to_host)
        if not same and tag != "batch_rounds":
            raise SystemExit(f"[stack] variant {tag} disagrees with the default run")
    shutil.rmtree(root / "subset")
    return dirs, stack3, finish


# --- [shard]: the fourier merge across ranks -----------------------------------

SHARD_RANKS = 2  # two ranks share the one card over gloo, collectives staged through the host
SHARD_MIN_BYTES = 1 << 20  # below every projection's bytes (k_proj: 8 MiB in bf16)
SHARD_PROJECTIONS = [f"model.layers.{l}.mlp.{p}_proj.weight" for l in range(LAYERS) for p in ("gate", "up", "down")]
SHARD_TIMEOUT_S = 600


def pair_bytes(regime: str, m: int, n: int, ranks: int) -> int:
    """Bytes one rank sends in the collectives of one sharded pair merge of
    an (m, n) tensor on the half-spectrum path (N % 2P == 0), from the
    shapes: two forward all-to-alls of its (m/P, n/2) complex64 rows and one
    inverse of its (m, n/2/P) columns, two all-gathers of its (m/P, 1)
    Nyquist rows; for a slerp also the all-reduces: 16 bisection rounds of
    3 int64 counts for each of the cutoff and the cull, the SLERP's 3 + 1 f32
    sums, the cull's int64 count and the scrub's 2 int64 flags."""
    a2a = 3 * (m // ranks) * (n // 2) * 8
    nyquist = 2 * (m // ranks) * 8
    reduces = 2 * 16 * 3 * 8 + 4 * 4 + 8 + 2 * 8 if regime == "slerp" else 0
    return a2a + nyquist + reduces


def _sent(comm) -> int:
    return sum(b for _, b, _ in comm.stats.values())


def shard_rank(root: Path) -> int:
    """One rank of [shard] (``python3 chip_smoke.py --shard-rank ROOT``, with
    torchrun's rendezvous variables): the port's merge CLI in process, then,
    on the card, every (14336, 4096) and (4096, 14336) projection's round-1
    pair merges of the [stack] 4-finetune inputs sharded over the ranks
    (gathered to rank 0 and held there to the single-device pair merge),
    the thresholds on identical spectra, and the all-to-all's time. Writes
    its findings to ROOT/shard_rank{R}.json."""
    import numpy as np
    import torch

    from shardmerge_tpu_torch.cli import main as cli_main
    from shardmerge_tpu_torch.config import MergeConfig, MergeModel
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader
    from shardmerge_tpu_torch.merge import fourier
    from shardmerge_tpu_torch.merge.base import Placement
    from shardmerge_tpu_torch.ops import blend, select
    from shardmerge_tpu_torch.parallel import fft2d
    from shardmerge_tpu_torch.parallel.multihost import merge_mesh

    code = cli_main(["merge", str(root / "shard.json")])
    sys.stdout.flush()
    if code:
        return code
    dev = torch.device("cuda:0")
    comm = merge_mesh(dev)
    dirs = json.loads((root / "shard_dirs.json").read_text())
    names = list(STACK_FOUR)
    cfg = MergeConfig(finetune_merge=[MergeModel(model=dirs[m], base=dirs["base"], alpha=STACK_ALPHAS[m])
                                      for m in names],
                      output_base_model=dirs["base"], output_dir=str(root / "unused"))
    sharded = fourier.FourierMerge(cfg, device=dev, comm=comm)
    single = fourier.FourierMerge(cfg, device=dev)
    weight_map = json.loads((Path(dirs["base"]) / "model.safetensors.index.json").read_text())["weight_map"]
    found = {"rank": comm.rank, "position": comm.position, "transport": comm.transport, "pairs": [],
             "thresholds": [], "a2a_ms": []}

    def read(m, name):
        with SafeTensorsReader(Path(dirs[m]) / weight_map[name]) as r:
            return r.get_tensor(name).to(dev).float()

    for name in SHARD_PROJECTIONS:
        base = read("base", name)
        deltas = {m: read(m, name) - base for m in names}
        norms = fourier._batched_norms(list(deltas.values()))
        target = float(np.mean(np.asarray(norms, dtype=np.float32))) + 1e-10
        jobs, _, _ = fourier._plan_round(names, [STACK_ALPHAS[m] for m in names], norms, norms, target)
        placement = Placement(comm, "rows", tuple(base.shape))
        for job in jobs:
            a, b = deltas[job[1]], deltas[job[2]]
            before = _sent(comm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            merged, _ = sharded.merge_pair(job, placement.local(a), placement.local(b), target, 0.2, placement)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sent = _sent(comm) - before
            whole = comm.gather_rows(merged, 256 << 20)
            row = {"tensor": name, "regime": job[0], "shape": list(base.shape), "ms": wall * 1e3,
                   "sent": sent, "expected": pair_bytes(job[0], *base.shape, comm.size)}
            if whole is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref, _ = single.merge_pair(job, a, b, target, 0.2)
                torch.cuda.synchronize()
                row["single_ms"] = (time.perf_counter() - t0) * 1e3
                got = whole.to(dev)
                rms = float(ref.double().square().mean().sqrt())
                row["rel_l2"] = rel_l2(got, ref)
                row["max_abs_over_rms"] = float((got - ref).abs().max()) / rms
            found["pairs"].append(row)
            if job[0] != "slerp":
                continue
            # thresholds on identical spectra: this rank's unified block of
            # the single device's half spectra against the whole
            na, nb = fourier._batched_norms([a, b])
            h0, h1 = torch.fft.rfftn(a / na, dim=(-2, -1)), torch.fft.rfftn(b / nb, dim=(-2, -1))
            n = base.shape[-1]
            nbody = n // 2 // comm.size
            mine = [torch.cat([h[:, comm.position * nbody:(comm.position + 1) * nbody], h[:, -1:]], 1)
                    for h in (h0, h1)]
            w_all = blend.hermitian_col_weights(n, device=dev)
            w_mine = fft2d.half_col_weights(n, nbody, comm)
            numel = a.numel()
            for label, k, pair in (("cutoff", blend.cutoff_rank(numel, 0.08), True),
                                   ("cull", blend.cull_rank(numel, 0.2), False)):
                whole_thr = select.kth_smallest_weighted(h0.real.abs(), k, w_all, y=h1.real.abs() if pair else None)
                dist_thr = select.kth_smallest_weighted(mine[0].real.abs(), k, w_mine,
                                                        y=mine[1].real.abs() if pair else None, group=comm)
                found["thresholds"].append({
                    "tensor": name, "which": label,
                    "bits": [int(whole_thr.view(torch.int32)), int(dist_thr.view(torch.int32))]})
            del h0, h1, mine
            if name not in SHARD_PROJECTIONS[:2]:
                continue
            # the all-to-all of rfft2_rs_half's body rows, alone (layer 0's
            # gate and up projections)
            body = torch.fft.rfft(placement.local(a), dim=-1)[:, :-1].contiguous()
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                comm.a2a_rs_to_cs(body)
                torch.cuda.synchronize()
                found["a2a_ms"].append(((time.perf_counter() - t0) * 1e3, list(body.shape)))
            del body
        del base, deltas
        torch.cuda.empty_cache()
    (root / f"shard_rank{comm.rank}.json").write_text(json.dumps(found))
    return 0


def launch_shard_ranks(root: Path):
    """Start the [shard] ranks as ``torchrun --nproc-per-node 2`` would
    (the env:// variables), wait for them: each rank's (code, stdout,
    stderr). A rank still running at SHARD_TIMEOUT_S is killed."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(SHARD_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(SHARD_RANKS), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(SHARD_RANKS)}
        out, err = open(root / f"shard{rank}.out", "w+"), open(root / f"shard{rank}.err", "w+")
        procs.append((subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--shard-rank", str(root)],
                                       cwd=REPO, env=env, stdout=out, stderr=err), out, err))
    deadline = time.perf_counter() + SHARD_TIMEOUT_S
    results = []
    try:
        for proc, out, err in procs:
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                code = None
            out.seek(0)
            err.seek(0)
            results.append((code, out.read(), err.read()))
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    return results


def shard_nccl_world1(torch, dirs: dict, card: str) -> str:
    """A world-1 NCCL group in this process: ``sharded_pair_slerp`` on CUDA
    tensors with nothing staged, held to the single-device pair merge."""
    import socket

    import torch.distributed as dist

    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader
    from shardmerge_tpu_torch.merge import fourier
    from shardmerge_tpu_torch.ops import blend
    from shardmerge_tpu_torch.parallel.comm import Comm, transport_for
    from shardmerge_tpu_torch.parallel.merge import sharded_pair_slerp

    dev = torch.device("cuda:0")
    name = SHARD_PROJECTIONS[0]
    weight_map = json.loads((dirs["base"] / "model.safetensors.index.json").read_text())["weight_map"]

    def read(m):
        with SafeTensorsReader(dirs[m] / weight_map[name]) as r:
            return r.get_tensor(name).to(dev).float()

    base = read("base")
    a, b = read("ft4") - base, read("ft3") - base  # a slerp pair of [stack]: norms 5 : 2
    na, nb = fourier._batched_norms([a, b])
    target = (na + nb) / 2 + 1e-10
    numel = a.numel()
    ranks = (blend.cutoff_rank(numel, 0.08), blend.cull_rank(numel, 0.2), blend.cull_limit(numel, 0.2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backend, staged = transport_for("cuda", 1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        comm = Comm(dev)
        if comm.backend != "nccl" or comm.staged:
            raise SystemExit(f"[shard] world-1 group took {comm.transport}, not NCCL unstaged")
        args = (na, nb, 0.6, *ranks, target)
        sharded_pair_slerp(comm, a, b, *args, use_cull=True)  # NCCL sets its communicator up at the first call
        comm.stats.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, nan, inf = sharded_pair_slerp(comm, a, b, *args, use_cull=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        dist.destroy_process_group()
    scalars = [torch.tensor(v, dtype=torch.float32, device=dev) for v in (na, nb, 0.6)]
    ref, rnan, rinf = fourier._pair("slerp", a, b, scalars, ranks, torch.tensor(target, device=dev), True,
                                    use_cull=True)
    rel = rel_l2(got, ref)
    worst = float((got - ref).abs().max()) / float(ref.double().square().mean().sqrt())
    if rel > 6e-3 or worst > 0.2 or int(nan) != int(rnan) or bool(inf) != bool(rinf):
        raise SystemExit(f"[shard] world-1 NCCL pair merge leaves the single-device one: relL2 {rel:.2e}, "
                         f"max-abs/rms {worst:.3f}, NaNs {int(nan)} vs {int(rnan)}")
    sent = {k: v[:2] for k, v in comm.stats.items()}
    return (f"[shard] world-1 NCCL group ({comm.transport}, nothing staged; {card}): sharded_pair_slerp of "
            f"{name} {tuple(a.shape)} on CUDA tensors in {wall:.1f} ms (host wall, synchronized; the second "
            f"call, after the communicator's set-up); vs the "
            f"single-device pair merge relL2 {rel:.2e} (tol 6e-3), max-abs {worst:.3f} rms (tol 0.2); "
            f"collectives [calls, bytes] {sent}")


def phase_shard(torch, root: Path, dirs: dict, merged: Path, merge_tensor_s: float, card: str):
    """Two ranks share the card over gloo (host-staged), launched with
    torchrun's variables: the port's merge CLI on [merge]'s base + 2
    finetunes with every projection split, held to [merge]'s output; the
    ranks' in-process pair merges and thresholds; a world-1 NCCL group."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    t_phase = time.perf_counter()
    cfg_file = merge_config(root, "shard", dirs["base"], [(dirs["ft1"], 0.8), (dirs["ft2"], 0.4)],
                            shard_min_bytes=SHARD_MIN_BYTES)
    (root / "shard_dirs.json").write_text(json.dumps({k: str(v) for k, v in dirs.items()}))
    results = launch_shard_ranks(root)
    wall = time.perf_counter() - t_phase
    for rank, (code, _, err) in enumerate(results):
        if code != 0:
            say(err[-4000:])
            raise SystemExit(f"[shard] rank {rank} exited {code}" + (" (killed: a hang)" if code is None else ""))
    stats = [json.loads(next(line for line in out.splitlines() if line.startswith("{"))) for _, out, _ in results]
    found = [json.loads((root / f"shard_rank{r}.json").read_text()) for r in range(SHARD_RANKS)]
    for rank, s in enumerate(stats):
        r = s["ranks"]
        say(f"[shard] rank {rank}: position {r['position']} of {r['size']}, transport {r['transport']} "
            f"({card}); tensors split {s['tensors_sharded']}; merged {s['tensors_merged']} "
            f"({s['tensors_passthrough']} passthrough); regimes {s['pair_merges']}; collectives "
            + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2**20:.1f} MiB {v['seconds']:.2f} s"
                        for k, v in r["collectives"].items()))
        if r["transport"] != "gloo (host-staged)" or r["size"] != SHARD_RANKS:
            raise SystemExit(f"[shard] rank {rank} took {r['transport']} over {r['size']} ranks")
        if s["tensors_sharded"] != 7 * LAYERS * 3:
            raise SystemExit(f"[shard] rank {rank} split {s['tensors_sharded']} inputs, expected every projection's")
    out = root / "shard"
    weight_map = check_output(torch, out, dirs["base"], "[shard]")
    agree = []
    for shard in sorted(set(weight_map.values())):
        ours, theirs = load_file(out / shard), load_file(merged / shard)
        for name, t in ours.items():
            close = torch.isclose(t.cuda().float(), theirs[name].cuda().float(), rtol=2e-2, atol=1e-6)
            agree.append((close.double().mean().item(), name))
    worst = min(agree)
    if worst[0] <= 0.97:
        raise SystemExit(f"[shard] {worst[1]}: {worst[0]:.2%} within 2e-2 of the single-device merge (gate 97%)")
    spans = {k: v["wall_s"] for k, v in stats[0]["tensor_spans"].items() if k.startswith("model.layers.")}
    big = [v for k, v in spans.items() if k.endswith(("gate_proj.weight", "up_proj.weight", "down_proj.weight"))]
    say(f"[shard] the CLI on {SHARD_RANKS} ranks sharing the card ({card}): index mirrors the base, all finite "
        f"bf16, every tensor within 2e-2 of [merge]'s single-device output at >= {worst[0]:.4%} (gate 97%, "
        f"lowest {worst[1]}); ranks' phase wall {wall:.1f} s (two processes, incl. startup); per merged tensor "
        f"mean {sum(spans.values()) / len(spans) * 1e3:.1f} ms (the 14336-wide projections "
        f"{min(big) * 1e3:.1f}-{max(big) * 1e3:.1f} ms) against [merge]'s {merge_tensor_s * 1e3:.1f} ms on one rank")
    for row in found[0]["pairs"]:
        if row["rel_l2"] > 6e-3 or row["max_abs_over_rms"] > 0.2:
            raise SystemExit(f"[shard] {row['tensor']} {row['regime']}: sharded round-1 pair merge leaves the "
                             f"single-device one (relL2 {row['rel_l2']:.2e}, max-abs {row['max_abs_over_rms']:.3f} rms)")
        sent = [f["pairs"][found[0]["pairs"].index(row)]["sent"] for f in found]
        if any(s != row["expected"] for s in sent):
            raise SystemExit(f"[shard] {row['tensor']} {row['regime']}: collectives sent {sent} bytes, "
                             f"the shapes give {row['expected']}")
        say(f"[shard] {row['tensor']} {tuple(row['shape'])} round-1 {row['regime']} across {SHARD_RANKS} ranks "
            f"({card}): {row['ms']:.1f} ms (single device {row['single_ms']:.1f} ms); vs the single-device pair "
            f"merge relL2 {row['rel_l2']:.2e} (tol 6e-3), max-abs {row['max_abs_over_rms']:.3f} rms (tol 0.2); "
            f"collectives sent {row['sent'] / 2**20:.2f} MiB a rank = {row['expected'] / 2**20:.2f} MiB from "
            f"the shapes")
    thresholds = [t for f in found for t in f["thresholds"]]
    unequal = [t for t in thresholds if t["bits"][0] != t["bits"][1]]
    if unequal or not thresholds:
        raise SystemExit(f"[shard] distributed thresholds differ from the single device's: {unequal}")
    a2a = sorted(ms for f in found for ms, _ in f["a2a_ms"])
    shape = found[0]["a2a_ms"][0][1]
    say(f"[shard] {len(thresholds)} thresholds (cutoff and cull, every slerp pair, both ranks) bit-equal to the "
        f"single device's on identical spectra; all-to-all of a rank's {shape} complex64 rows "
        f"({shape[0] * shape[1] * 8 / 2**20:.0f} MiB, {found[0]['transport']}): median {a2a[len(a2a) // 2]:.1f} ms "
        f"({a2a[0]:.1f}-{a2a[-1]:.1f}) over {len(a2a)} calls")
    say(shard_nccl_world1(torch, dirs, card))
    shutil.rmtree(out)
    say(f"[shard] phase wall {time.perf_counter() - t_phase:.1f} s")


def engine_tag(method: str, options: dict) -> str:
    return method + "".join(f" {k}={v}" for k, v in options.items())


def engine_models(method: str):
    return STACK_FOUR[:2] if method == "slerp" else STACK_FOUR


def engine_config(src: dict, method: str, out: Path):
    from shardmerge_tpu_torch.config import MergeConfig, MergeModel

    return MergeConfig(
        finetune_merge=[MergeModel(model=str(src[m]), base=str(src["base"]), alpha=STACK_ALPHAS[m])
                        for m in engine_models(method)],
        output_base_model=str(src["base"]),
        output_dir=str(out),
        merge_method=method,
    )


def f32_merge(method: str, options: dict, cfg, dev: str, name: str):
    """One tensor's merge by the engine in process (its ``_merge_layer``,
    deferred checks included) on ``dev``, as f32 on the host."""
    from shardmerge_tpu_torch.io.writer import ShardLayer
    from shardmerge_tpu_torch.merge import MERGE_METHODS

    eng = MERGE_METHODS[method](cfg, device=dev, **options)
    try:
        eng.initialize()
        out = eng._merge_layer(ShardLayer(0, "model.safetensors", name, False))
        eng._check_deferred(name)
        return out.float().cpu()
    finally:
        eng.index_manager.close()


def engine_deltas(torch, src: dict, method: str, name: str, dev: str):
    """The engine's f32 deltas of ``name`` on ``dev`` (alpha applied, each
    against the shared base)."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    base = load_file(src["base"] / "model.safetensors")[name].to(dev).float()
    return [(load_file(src[m] / "model.safetensors")[name].to(dev).float() - base) * STACK_ALPHAS[m]
            for m in engine_models(method)]


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.cpu().contiguous().view(torch.int32),
                                              b.cpu().contiguous().view(torch.int32))


def hold_masks(torch, method: str, options: dict, src: dict, name: str, dev: str) -> str:
    """The engine's thresholds (ties, breadcrumbs), keep probabilities and
    masks (della, dare) of every model on ``name``, card against host, bit
    for bit; returns what was compared."""
    from shardmerge_tpu_torch.merge import breadcrumbs, dare, della, ties
    from shardmerge_tpu_torch.ops import prng, select

    if method not in ("ties", "breadcrumbs", "dare", "della"):
        return "no masks or thresholds"
    sides = {d: engine_deltas(torch, src, method, name, d) for d in (dev, "cpu")}
    n = sides["cpu"][0].numel()
    named = dare.tensor_key(options.get("seed", 0), name)
    for m in range(len(sides["cpu"])):
        got = {}
        for d, deltas in sides.items():
            delta = deltas[m]
            if method == "ties":
                k = n - ties.keep_count(n, options.get("density", 0.2))
                got[d] = [select.kth_smallest_nonneg(delta.abs(), k).reshape(1)]
            elif method == "breadcrumbs":
                k_low, k_top = breadcrumbs.tail_counts(n, options.get("beta", 0.85), options.get("gamma", 0.01))
                got[d] = [select.kth_smallest_nonneg(delta.abs(), k).reshape(1) for k in (k_low, n - k_top)]
            elif method == "dare":
                keep = 1.0 - options.get("drop_rate", 0.9)
                got[d] = [prng.bernoulli(prng.fold_in(named, m), keep, delta.shape, device=d).to(torch.int32)]
            else:
                probs = della.keep_probs(delta.reshape(-1, delta.shape[-1]), options.get("density", 0.2),
                                         options.get("epsilon", 0.1))
                mask = prng.bernoulli(prng.fold_in(named, m), probs, probs.shape)
                got[d] = [probs, mask.to(torch.int32)]
        if not all(same_bits(torch, a, b) for a, b in zip(got[dev], got["cpu"])):
            raise SystemExit(f"[engines] {method}: model {m}'s masks or thresholds differ between card and host")
    what = {"ties": "trim thresholds", "breadcrumbs": "both tail thresholds", "dare": "masks",
            "della": "keep probabilities and masks"}[method]
    return f"{what} of all {len(sides['cpu'])} models bit-equal"


def hold_legacy(torch, src: dict, name: str, dev: str, card: str):
    """fourier-legacy on ``name``, per pair: the card's reduction traced;
    each traced result equal, bit for bit, to the engine's own pair merge
    on the traced operands, and its blend weight to the alphas looked up by
    stack position (REF-QUIRK); each round-1 pair merge against the host's
    on the same inputs (97% within 2e-2); a later round's operands carry
    round 1's culled spectral zeros, whose FFT round-trip noise picks sign
    agreement, so there the blend is held on identical spectra with the
    traced weight (cutoff threshold bit for bit, real plane within relL2
    1e-5)."""
    from shardmerge_tpu_torch.io.safetensors_io import load_file
    from shardmerge_tpu_torch.merge import fourier_legacy
    from shardmerge_tpu_torch.ops import blend, select

    cfg = engine_config(src, "fourier-legacy", src["base"].parent / "unused")
    card_eng = fourier_legacy.LegacyFourierMerge(cfg, device=dev)
    host_eng = fourier_legacy.LegacyFourierMerge(cfg, device="cpu")
    base = load_file(src["base"] / "model.safetensors")[name].to(dev).float()
    names = engine_models("fourier-legacy")
    stack = [(str(src[m]), load_file(src[m] / "model.safetensors")[name].to(dev).float() - base) for m in names]
    trace = []
    card_eng.reduce(stack, trace=trace)
    for regime, x, y, norm_a, norm_b, target, cull, a_prop, a, b, merged in trace:
        tag = f"[engines] fourier-legacy {name} ({card}) round pair ({x}, {y}) {regime}, cull {cull}"
        want_prop = STACK_ALPHAS[names[x]] / (STACK_ALPHAS[names[x]] + STACK_ALPHAS[names[y]])
        again = card_eng._merge_pair(a, b, x, y, norm_a, norm_b, target, cull)[1]
        same = same_bits(torch, merged, again)
        say(f"{tag}: weight {a_prop!r} (alphas by stack position {want_prop!r}), the traced result "
            f"{'bit-equal' if same else 'DIFFERENT'} to the engine's pair merge on the traced operands")
        if a_prop != want_prop or not same:
            raise SystemExit("[engines] fourier-legacy: the traced pair merge is not the engine's")
        ha, hb = a.cpu(), b.cpu()
        if cull == card_eng.cull_start_pct:
            _, host, _ = host_eng._merge_pair(ha, hb, x, y, norm_a, norm_b, target, cull)
            close = torch.isclose(merged.cpu(), host, rtol=2e-2, atol=1e-6).double().mean().item()
            say(f"{tag}: card vs host on the same inputs {close * 100:.3f}% within 2e-2 (gate 97%), "
                f"relL2 {rel_l2(merged.cpu(), host):.2e}")
            if close < 0.97:
                raise SystemExit("[engines] a fourier-legacy round-1 pair merge disagrees with the host")
            continue
        if regime != "slerp":
            raise SystemExit(f"[engines] fourier-legacy: expected slerp pairs after round 1, got {regime}")
        n = ha.numel()
        f0 = blend.fft2(ha / torch.tensor(norm_a, dtype=torch.float32))
        f1 = blend.fft2(hb / torch.tensor(norm_b, dtype=torch.float32))
        ranks = (blend.cutoff_rank(n, 0.08), blend.cull_rank(n, cull), blend.cull_limit(n, cull))
        got = {}
        for d in ("cpu", dev):
            x0, x1 = f0.to(d), f1.to(d)
            thr = select.kth_smallest_nonneg2(x0.real.abs(), x1.real.abs(), ranks[0])
            res = blend.interpolate_fft_components(x0, x1, a_prop, 1.0, *ranks, use_cutoff=True, use_cull=True,
                                                   interp_imag=False)
            got[d] = (thr.cpu(), res.real.cpu())
        same_thr = same_bits(torch, got["cpu"][0].reshape(1), got[dev][0].reshape(1))
        res_rel = rel_l2(got[dev][1], got["cpu"][1])
        say(f"{tag}: on identical spectra the cutoff threshold is {'bit-equal' if same_thr else 'DIFFERENT'} "
            f"and the blended real plane within relL2 {res_rel:.2e} (gate 1e-5)")
        if not same_thr or res_rel > 1e-5:
            raise SystemExit("[engines] fourier-legacy: the card's blend disagrees with the host's on identical spectra")


def mask_times(torch, card: str):
    """Device ms of the masks alone at (14336, 4096): DARE's Bernoulli draw
    (threefry2x32 in int64 torch ops), DELLA's keep probabilities, and its
    whole drop and rescale of one delta (probabilities, draw, divide); and
    of TIES's two steps there: one model's trim (an exact select) and the
    sign election with ``finish`` over 4 models."""
    from shardmerge_tpu_torch.merge import dare, della, ties
    from shardmerge_tpu_torch.ops import prng

    shape = (LLAMA_31_8B["intermediate_size"], LLAMA_31_8B["hidden_size"])
    dev = torch.device("cuda:0")
    key = prng.fold_in(dare.tensor_key(0, "model.layers.0.mlp.gate_proj.weight"), 0)
    delta = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(5)) * 0.01
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    work = torch.empty_like(delta)
    times = {
        "dare mask": time_ms(torch, lambda: prng.bernoulli(key, 0.1, shape, device=dev), flush, reps=5),
        "dare drop and rescale": time_ms(torch, lambda: dare.drop_and_rescale_(work.copy_(delta), key, 0.1),
                                         flush, reps=5),
        "della keep probabilities": time_ms(torch, lambda: della.keep_probs(delta, 0.2, 0.1), flush, reps=5),
        "della drop and rescale": time_ms(torch, lambda: della.sample_(work.copy_(delta), key, 0.2, 0.1),
                                          flush, reps=5),
    }
    four = [torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(6 + i)) * 0.01
            for i in range(4)]
    keep = ties.keep_count(delta.numel(), 0.2)
    times["ties trim"] = time_ms(torch, lambda: ties.trim_(work.copy_(delta), keep), flush, reps=5)
    times["ties election and finish"] = time_ms(
        torch, lambda: ties.finish(ties.elect_disjoint_mean(four), delta, 1.0, True), flush, reps=5)
    del four
    n = shape[0] * shape[1]
    # a fused threefry + Bernoulli + rescale kernel would read the delta and
    # write the kept delta once: 8 bytes an element
    floor, by = bound(8 * n, 0, F32_FLOPS)
    say(f"[engines] masks at {shape} ({card}), device ms (median of 5, L2 flushed): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; a fused drop-and-rescale kernel's byte bound {floor:.4f} ms ({by}: delta read, kept written)")
    return times


def hold_engine(torch, method: str, options: dict, srcs: dict, dev: str, card: str, masks: bool):
    """One run's card-vs-host gate on q_proj: the engine's f32 merge in
    process on the card against the host's on the same inputs (relL2
    1e-6), with its masks or thresholds bit for bit (``masks``); dare and
    della on q_proj's first rows (and the card's whole-q_proj merge must
    give the cut's bits there), fourier-legacy per pair."""
    q_proj = STACK_CHECKED[0]
    sub, cut, scratch = srcs["sub"], srcs["cut"], srcs["sub"]["base"].parent / "unused"
    tag = engine_tag(method, options)
    if method == "fourier-legacy":
        hold_legacy(torch, sub, q_proj, dev, card)
        return
    src = cut if method in ("dare", "della") else sub
    what = hold_masks(torch, method, options, src, q_proj, dev) if masks else "masks held above"
    cfg_q = engine_config(src, method, scratch)
    card_q = f32_merge(method, options, cfg_q, dev, q_proj)
    rel = rel_l2(card_q, f32_merge(method, options, cfg_q, "cpu", q_proj))
    note = ""
    if src is cut:
        whole = f32_merge(method, options, engine_config(sub, method, scratch), dev, q_proj)
        if not same_bits(torch, whole[:ENGINE_CUT_ROWS], card_q):
            raise SystemExit(f"[engines] {tag}: the whole q_proj's first rows differ from the cut's merge")
        note = f" (its first {ENGINE_CUT_ROWS} rows; the card's whole-q_proj merge gives the cut's bits there)"
    say(f"[engines] {tag} q_proj{note} ({card}): card vs host in f32 relL2 {rel:.2e} (gate 1e-6); {what}")
    if rel > 1e-6:
        raise SystemExit(f"[engines] {tag}: the card's merge disagrees with the host's")


def phase_engines(torch, root: Path, dirs: dict, card: str, dev: str = "cuda:0"):
    """The ten other merge methods through the CLI on the [stack] subset
    (and addition over the whole model): index mirrored, finite
    bf16, the CLI's bits equal to the same merge in process; each method's
    wall per tensor in process; then each held to the host on q_proj
    (``hold_engine``) while the CLI runs, four at a time."""
    from shardmerge_tpu_torch.cli import run_merge
    from shardmerge_tpu_torch.io.safetensors_io import load_file

    eroot = root / "engines"
    srcs = {"sub": subset_model(torch, dirs, eroot, STACK_FOUR),
            "cut": subset_model(torch, dirs, eroot / "cut", STACK_FOUR, tensors=STACK_CHECKED[:1],
                                rows=ENGINE_CUT_ROWS)}
    sub = srcs["sub"]
    inproc, configs = {}, {}
    for i, (method, options) in enumerate(ENGINE_RUNS):
        tag = engine_tag(method, options)
        finetunes = [(sub[m], STACK_ALPHAS[m]) for m in engine_models(method)]
        configs[tag] = merge_config(eroot, f"cli{i}", sub["base"], finetunes, merge_method=method,
                                    method_options=options, device=dev)
        cfg = engine_config(sub, method, eroot / f"inproc{i}")
        cfg.method_options, cfg.device = dict(options), dev
        t0 = time.perf_counter()
        merger = run_merge(cfg, dev)
        wall = time.perf_counter() - t0
        inproc[tag] = load_file(Path(cfg.output_dir) / "model.safetensors")
        shutil.rmtree(cfg.output_dir)
        spans = merger.tensor_spans
        first = next(iter(spans))
        say(f"[engines] {tag} ({len(engine_models(method))} finetunes, {card}): in process {wall:.2f} s for "
            f"{len(spans)} tensors; " + "; ".join(
                f"{n.split('.')[-2]} {tuple(inproc[tag][n].shape)} wall {spans[n]['wall_s'] * 1e3:.1f} ms "
                f"(merge {spans[n]['merge_s'] * 1e3:.1f}{', read on demand: the first' if n == first else ''})"
                for n in spans))
        for n, t in inproc[tag].items():
            if t.dtype != torch.bfloat16 or not bool(torch.isfinite(t.float()).all()):
                raise SystemExit(f"[engines] {tag}: {n} is not finite bf16")

    # the CLI runs, four at a time (the whole-model ones first), while the
    # card is held to the host
    whole_cfgs = {method: merge_config(root, f"whole_{method}", dirs["base"],
                                       [(dirs[f], STACK_ALPHAS[f]) for f in STACK_FOUR], merge_method=method,
                                       device=dev) for method in ENGINE_WHOLE}
    ex = ThreadPoolExecutor(4)
    try:
        whole_runs = {method: ex.submit(cli_merge, cfg_file) for method, cfg_file in whole_cfgs.items()}
        futures = {tag: ex.submit(cli_merge, cfg_file) for tag, cfg_file in configs.items()}
        held = set()
        for method, options in ENGINE_RUNS:
            # each method once; dare and della (on the cut) with both combines
            if method not in held or method in ("dare", "della"):
                hold_engine(torch, method, options, srcs, dev, card, masks=method not in held)
                held.add(method)
        cli = {tag: f.result() for tag, f in futures.items()}
        whole_cli = {method: f.result() for method, f in whole_runs.items()}
    finally:
        ex.shutdown(wait=True)
    for tag, (stats, wall) in cli.items():
        out = Path(json.loads(configs[tag].read_text())["output_dir"])
        check_output(torch, out, sub["base"], f"[engines] {tag}")
        got = load_file(out / "model.safetensors")
        if not all(torch.equal(got[n].view(torch.int16), inproc[tag][n].view(torch.int16)) for n in STACK_SUBSET):
            raise SystemExit(f"[engines] {tag}: the CLI's output differs from the in-process merge")
        shutil.rmtree(out)
    say(f"[engines] CLI ({card}): {len(cli)} runs (four at a time beside the host checks, "
        f"{max(w for _, w in cli.values()):.1f} s the longest) each mirror the base index, finite bf16, the "
        f"in-process merge's bits")

    for method, (stats, wall) in whole_cli.items():
        out = root / f"whole_{method}"
        weight_map = check_output(torch, out, dirs["base"], f"[engines] whole {method}")
        tag = engine_tag(method, {})
        for n in STACK_SUBSET:
            got = load_file(out / weight_map[n])[n]
            if not torch.equal(got.view(torch.int16), inproc[tag][n].view(torch.int16)):
                raise SystemExit(f"[engines] whole {method}: {n} differs from the subset merge")
        passthrough = 0  # addition merges the input/output layers too
        if stats["tensors_passthrough"] != passthrough:
            raise SystemExit(f"[engines] whole {method}: {stats['tensors_passthrough']} passthroughs, "
                             f"expected {passthrough}")
        spans = stats["tensor_spans"]
        say(f"[engines] whole-model {method} CLI ({card}): wall {wall:.1f} s (process, in the pool above); "
            f"{stats['tensors_merged']} "
            f"tensors, {passthrough} passthrough; index mirrors the base, finite bf16, layer 0's subset has the "
            f"subset merge's bits; walls, ms: " + ", ".join(
                f"{n} {spans[n]['wall_s'] * 1e3:.1f}" for n in spans
                if n.startswith(("model.embed_tokens", "lm_head")) or ".gate_proj" in n or ".up_proj" in n))
        shutil.rmtree(out)
    shutil.rmtree(eroot)


class LocalHub:
    """A standard-library HTTP server on 127.0.0.1 in the Hub's URL layout
    (``/{repo}/resolve/main/{file}`` and ``/{repo}/raw/main/{file}``),
    streaming files from disk and counting requests per path."""

    def __init__(self):
        self.files = {}
        self.hits = {}
        self._lock = threading.Lock()

    def serve_dir(self, repo: str, directory: Path):
        for f in directory.iterdir():
            if f.is_file():
                for kind in ("resolve", "raw"):
                    self.files[f"/{repo}/{kind}/main/{f.name}"] = f

    def __enter__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlparse

        hub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                path = urlparse(self.path).path
                with hub._lock:
                    hub.hits[path] = hub.hits.get(path, 0) + 1
                f = hub.files.get(path)
                if f is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(f.stat().st_size))
                self.end_headers()
                try:
                    with open(f, "rb") as src:
                        self.connection.sendfile(src)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # a header read drops the connection early

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def port_cli(args, env=None):
    """``python -m shardmerge_tpu_torch ARGS``: (standard output, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "shardmerge_tpu_torch", *map(str, args)], cwd=REPO,
                          capture_output=True, text=True, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        say(proc.stderr[-4000:])
        raise SystemExit(f"{args[0]} exited {proc.returncode}")
    return proc.stdout, wall


def lora_product(torch, adapter: Path, module: str):
    """B@A of one module of an adapter directory, in f64."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader

    with SafeTensorsReader(adapter / "adapter_model.safetensors") as r:
        a = r.get_tensor(f"base_model.model.{module}.lora_A.weight").double()
        b = r.get_tensor(f"base_model.model.{module}.lora_B.weight").double()
    return b @ a


def write_decoded(src: Path, dst: Path):
    """A GPTQ artifact's tensors as the index decodes them (f32 projections,
    the rest raw), written as a plain local checkpoint in one file."""
    from shardmerge_tpu_torch.io.index import OfflineMultiModelIndex
    from shardmerge_tpu_torch.io.safetensors_io import save_file

    index = OfflineMultiModelIndex()
    index.add_model(src)
    tensors = {k: index.preload_tensor(src, k) for k in index.get_layer_order(src)}
    index.close()
    dst.mkdir()
    save_file(tensors, dst / "model.safetensors")
    shutil.copy(src / "config.json", dst / "config.json")


def host_rates(torch):
    """GB/s of the port's owned read copy and f32 -> bf16 narrowing through
    io/native.py against torch's ``copy_`` and ``.to``, at (14336, 4096)
    f32 on the card machine's host: the four interleaved, 11 rounds,
    medians."""
    from shardmerge_tpu_torch.io import native

    src = torch.randn(14336, 4096)
    dst = torch.empty_like(src)
    narrow = torch.empty(src.shape, dtype=torch.bfloat16)
    runs = {
        "copy torch": lambda: dst.copy_(src),
        "copy native": lambda: native.parallel_copy(src, out=dst),
        "bf16 torch": lambda: narrow.copy_(src),
        "bf16 native": lambda: native.f32_to_bf16(src, out=narrow),
    }
    times = {k: [] for k in runs}
    for _ in range(11):
        for k, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
    moved = {"copy": src.numel() * 8, "bf16": src.numel() * 6}  # bytes read + written
    same = torch.equal(native.f32_to_bf16(src).view(torch.int16), src.to(torch.bfloat16).view(torch.int16))
    if not same:
        raise SystemExit("[inputs] the native f32 -> bf16 cast disagrees with torch's")
    return {k: moved[k.split()[0]] / sorted(v)[5] / 1e9 for k, v in times.items()}


def phase_inputs(torch, root: Path, dirs: dict, ft2: Path, stack3_spans: dict, card: str):
    """Every checkpoint input through the port's CLI on the card: ft1 as a
    rank-16 adapter (extract-lora), ft2 as a GPTQ int4 artifact (quantize),
    ft3 from a localhost Hub; their 3-finetune merge held bit for bit to the
    merge of the materialized inputs, and generate on the -int4 artifact and
    on the adapter directory through both decode kernels."""
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.io.safetensors_io import load_file
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.tools.extract_lora import factor

    base, ft1, ft3 = dirs["base"], dirs["ft1"], dirs["ft3"]
    adapter, gptq = root / "adapter", root / "ft2-gptq"
    t_phase = time.perf_counter()
    fused = root / "fused_host"

    def adapter_then_fused():
        made = port_cli(["extract-lora", base, ft1, adapter, "--rank", 16,
                         *[x for t in ("q_proj", "k_proj", "v_proj", "o_proj") for x in ("--target", t)]])
        # the materialized adapter for the local merge below
        return made, port_cli(["fuse-lora", base, adapter, fused, "--device", "cpu"])[1]

    # the adapter (SVDs on the card, then its host fuse) beside the GPTQ
    # artifact (the host)
    with ThreadPoolExecutor(2) as ex:
        extracted = ex.submit(adapter_then_fused)
        quantized = ex.submit(port_cli, ["quantize", ft2, gptq, "--bits", 4])
        ((out_s, wall), fuse_wall), (q_out, q_wall) = extracted.result(), quantized.result()
    say(f"[inputs] extract-lora on the card in {wall:.1f} s (process, beside quantize): {out_s.strip()}; "
        f"then fuse-lora --device cpu in {fuse_wall:.1f} s")
    module = "model.layers.0.self_attn.k_proj"
    name = module + ".weight"
    shard = json.loads((base / "model.safetensors.index.json").read_text())["weight_map"][name]
    delta = load_file(ft1 / shard)[name].float() - load_file(base / shard)[name].float()
    t0 = time.perf_counter()
    b, a, _ = factor(delta, 16)
    host_s = time.perf_counter() - t0
    rel = rel_l2(lora_product(torch, adapter, module), b.double() @ a.double())
    say(f"[inputs] {name} (1024, 4096) rank-16 B@A, card vs host (f64 SVD, {host_s:.1f} s on the host): "
        f"relL2 {rel:.2e} (tol 1e-5)")
    if rel > 1e-5:
        raise SystemExit("[inputs] the card's extract-lora disagrees with the host's")
    report = json.loads(q_out.strip().splitlines()[-1])
    say(f"[inputs] quantize --bits 4 of ft2 in {q_wall:.1f} s (process, beside extract-lora): "
        f"{report['tensors_quantized']} tensors, "
        f"{report['compression']}x smaller, worst round trip relL2 {report['worst_roundtrip_relL2_vs_serving_quant']:.2e}")

    alphas = [0.8, 0.6, 0.5]
    storage = root / "hub_storage"
    with LocalHub() as hub:
        hub.serve_dir("org/ft3", ft3)
        env = {**os.environ, "HF_ENDPOINT": hub.base}
        cfg_file = root / "inputs.json"
        out = root / "inputs_out"
        cfg_file.write_text(json.dumps({
            "output_base_model": str(base), "output_dir": str(out), "storage_dir": str(storage),
            "cache_dir": str(root / "hub_cache"),
            "finetune_merge": [{"model": str(m), "base": str(base), "alpha": al}
                               for m, al in zip([adapter, gptq, "org/ft3"], alphas)],
        }))
        plan, _ = port_cli(["merge", cfg_file, "--dry-run"], env=env)
        if out.exists() or "plan OK" not in plan:
            raise SystemExit("[inputs] the dry run created the output or printed no plan")
        say(f"[inputs] --dry-run: {plan.strip().splitlines()[0]}; nothing created")
        # the model's config beside the merged weights (copy-model's job for
        # a Hub base), so that the -int4 artifact carries it too
        out.mkdir()
        shutil.copy(base / "config.json", out / "config.json")
        out_s, wall = port_cli(["merge", cfg_file, "--cache-dir", root / "hub_cache2", "--clean_cache",
                                "--output-quant", "int4"], env=env)
        stats = json.loads(out_s.strip().splitlines()[-1])
        hits = dict(hub.hits)
    shards = [p for p in hits if "/resolve/" in p]
    if not shards or any(hits[p] != 1 for p in shards):
        raise SystemExit(f"[inputs] a shard was not downloaded exactly once: {hits}")
    left = list(storage.rglob("*.safetensors"))
    if left:
        raise SystemExit(f"[inputs] clean_cache left {left}")
    check_output(torch, out, base, "[inputs]")
    dl = stats["downloads"]
    fuse, dec = stats["host_work"]["fuse"], stats["host_work"]["decode"]
    say(f"[inputs] merge of adapter + GPTQ + Hub ({card}): wall {wall:.1f} s (process, incl. --output-quant); "
        f"regimes {stats['pair_merges']}; index mirrors the base; all finite bf16; each of {len(shards)} shards "
        f"downloaded once; storage empty after --clean_cache")
    say(f"[inputs] download over loopback: {dl['bytes'] / 1e9:.2f} GB in {dl['wall_s']:.2f} s = "
        f"{dl['bytes'] / 1e9 / max(dl['wall_s'], 1e-9):.2f} GB/s; host adapter fuse {fuse['seconds'] / fuse['tensors'] * 1e3:.1f} "
        f"ms/tensor ({fuse['tensors']} tensors), GPTQ decode {dec['seconds'] / dec['tensors'] * 1e3:.1f} ms/tensor "
        f"({dec['tensors']} tensors), both on the read-ahead workers")
    for key in sorted(stack3_spans):
        ours = stats["tensor_spans"][key]
        say(f"[inputs]   {key} (14336, 4096): wall {ours['wall_s'] * 1e3:.1f} ms (read wait "
            f"{ours['read_s'] * 1e3:.1f}, h2d {ours['h2d_s'] * 1e3:.1f}) vs [stack] 3-ft "
            f"{stack3_spans[key]['wall_s'] * 1e3:.1f} ms (read wait {stack3_spans[key]['read_s'] * 1e3:.1f})")

    # the materialized inputs through the local path (the merge and compare
    # commands' own functions, in process): bit for bit
    from shardmerge_tpu_torch.cli import run_merge
    from shardmerge_tpu_torch.config import MergeConfig
    from shardmerge_tpu_torch.tools.fuse_lora import fuse_pair, load_adapter
    from shardmerge_tpu_torch.tools.inspect_model import compare_models

    t0 = time.perf_counter()
    write_decoded(gptq, root / "decoded")
    local_cfg = root / "local.json"
    local_cfg.write_text(json.dumps({
        "output_base_model": str(base), "output_dir": str(root / "local_out"),
        "finetune_merge": [{"model": str(m), "base": str(base), "alpha": al}
                           for m, al in zip([fused, root / "decoded", ft3], alphas)],
    }))
    run_merge(MergeConfig.from_file(local_cfg), "cuda:0")
    stats_c, only_a, only_b = compare_models(out, root / "local_out", top=3)
    identical = sum(1 for st in stats_c if st.get("identical"))
    n_tensors = len(json.loads((base / "model.safetensors.index.json").read_text())["weight_map"])
    if identical != n_tensors or only_a or only_b:
        raise SystemExit(f"[inputs] the new inputs changed the merge: {identical} of {n_tensors} bit-identical")
    say(f"[inputs] materialized inputs (the fuse-lora --device cpu above, GPTQ decoded to f32, ft3 local) merged in "
        f"{time.perf_counter() - t0:.1f} s: compare reports {identical} of {n_tensors} tensors bit-identical")
    # fuse-lora's fuse on the card against the host's file, tensor by tensor
    pairs, scale = load_adapter(adapter)
    weight_map = json.loads((base / "model.safetensors.index.json").read_text())["weight_map"]
    differ, ulps, total = 0, 0, 0
    for key, pair in pairs.items():
        card_t = fuse_pair(load_file(base / weight_map[key])[key].cuda(), pair["A"], pair["B"], scale).cpu()
        gap = (load_file(fused / weight_map[key])[key].view(torch.int16).int() - card_t.view(torch.int16).int()).abs()
        differ += int((gap > 0).sum())
        ulps = max(ulps, int(gap.max()))
        total += gap.numel()
    say(f"[inputs] fuse-lora card vs host ({card}): {differ} of {total} fused bf16 elements differ "
        f"({differ / total * 100:.4f}%), largest gap {ulps} ulp")
    shutil.rmtree(root / "decoded")
    shutil.rmtree(root / "local_out")

    # generate on the card from the -int4 artifact and from the adapter directory
    art = Path(f"{out}-int4")
    prompt = "The merged model answers a question."
    texts = {}
    for tag, path in (("-int4 artifact", art), ("adapter", adapter), ("fused adapter", fused)):
        reset_counts(qk, ak)
        engine = InferenceEngine.from_pretrained(path, load_in_4bit=True, tokenizer=IdTokenizer(), device="cuda:0")
        texts[tag] = "".join(engine.stream_generation(prompt, max_new_tokens=12, greedy=True))
        torch.cuda.synchronize()
        gemv, flash = qk.launch_counts["int4_gemv"], ak.launch_counts["flash_decode"]
        say(f"[inputs] generate -4 --greedy from the {tag}: {len(texts[tag].split('><'))} tokens; launches "
            f"int4_gemv {gemv}, flash_decode {flash}")
        if gemv == 0 or flash == 0:
            raise SystemExit(f"[inputs] generate from the {tag} did not run both decode kernels")
        if tag != "fused adapter":
            decode_step_check(torch, qk, engine, prompt, f"[inputs] {tag}:")
        del engine
        torch.cuda.empty_cache()
    if texts["adapter"] != texts["fused adapter"]:
        raise SystemExit("[inputs] the adapter directory's greedy tokens differ from its fuse-lora'd directory's")
    say("[inputs] the adapter directory's greedy tokens equal its fuse-lora'd directory's")
    rates = host_rates(torch)
    say(f"[inputs] host (14336, 4096) f32 ({card}, {torch.get_num_threads()} torch threads, interleaved, "
        f"medians of 11): owned copy torch {rates['copy torch']:.2f} GB/s, "
        f"native {rates['copy native']:.2f} GB/s; f32 -> bf16 torch {rates['bf16 torch']:.2f} GB/s, native "
        f"{rates['bf16 native']:.2f} GB/s (bit-equal)")
    for d in (adapter, gptq, out, art, fused):
        shutil.rmtree(d)
    say(f"[inputs] phase wall {time.perf_counter() - t_phase:.1f} s")


class StubTokenizer:
    """One token per character; no EOS, so every row decodes every step."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr((i - 2) % 96 + 32) for i in ids)


def reset_counts(*modules):
    for m in modules:
        m.reset_launch_counts()


def decode_step_check(torch, qk, engine, prompt: str, tag: str) -> float:
    """One decode step of ``engine`` (int4 projections) after ``prompt``'s
    prefill, through the kernels and again on the plain int4 product: every
    projection must launch the GEMV, and the logits agree within 2e-2."""
    from shardmerge_tpu_torch.models import llama

    model, cfg = engine.model, engine.cfg
    ids = torch.tensor([StubTokenizer().encode(prompt)], device="cuda:0")
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
            raise SystemExit(f"{tag} decode step did not run the kernel for every projection")

        def plain(x, wq):
            return qk.int4_matmul_plain(x, wq["q"], wq["scale"])

        with mock.patch.object(llama, "dequant_matmul", plain):
            with_plain, _ = model(tok, step_pos, kv_plain, T, rope, T + 1)
    rel = rel_l2(with_kernel.float(), with_plain.float())
    say(f"{tag} decode-step logits, kernel vs plain int4 product: relL2 {rel:.2e} (tol 2e-2)")
    if rel > 2e-2 or not bool(torch.isfinite(with_kernel).all()):
        raise SystemExit(f"{tag} decode logits disagree")
    return rel


def phase_generate(torch, merged: Path):
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
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

    reset_counts(qk, ak)
    t0 = time.perf_counter()
    texts = engine.generate_batch(prompts, max_new_tokens=new, **kw)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    batch_launches = qk.launch_counts["int4_gemv"]
    batch_flash = ak.launch_counts["flash_decode"]
    streamed = "".join(engine.stream_generation(prompts[0], max_new_tokens=new, **kw))
    torch.cuda.synchronize()
    launches = {"int4_gemv": qk.launch_counts["int4_gemv"], "flash_decode": ak.launch_counts["flash_decode"]}

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
        f"(B=4, prefill excluded, medians of 3); launches int4_gemv {batch_launches}, "
        f"flash_decode {batch_flash}"
    )
    say(f"[generate] stream_generation: {len(streamed)} chars; launches in both runs {launches}")
    # A/B: the same decode with every attention on the einsum path
    with mock.patch.object(ak, "use_flash_decode", lambda *a: False):
        einsum_ms = (wall(new) - wall(1)) / (new - 1) * 1e3
    again_ms = (wall(new) - wall(1)) / (new - 1) * 1e3
    say(f"[generate] A/B decode ms/step at B=4 (medians of 3, in turn): flash kernel {step_ms:.3f}, "
        f"einsum path {einsum_ms:.3f}, flash kernel {again_ms:.3f}")
    if batch_launches < LAYERS * 7 * new:
        raise SystemExit(f"int4 kernel launched {batch_launches} times, need >= {LAYERS * 7 * new}")
    if batch_flash < LAYERS * new:
        raise SystemExit(f"flash kernel launched {batch_flash} times, need >= {LAYERS * new}")
    if not all(len(t) == new for t in texts) or len(streamed) != new:
        raise SystemExit(f"unexpected outputs: {texts!r} / {streamed!r}")

    decode_step_check(torch, qk, engine, prompts[0], "[generate]")
    return engine, launches


class IdTokenizer:
    """One token per character in, ``<id>`` per token out: equal texts are
    equal token ids. No EOS, so a row runs its whole budget or to its stop."""

    eos_token_id = None
    chat_template = None

    def encode(self, text):
        return [ord(c) % 96 + 2 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f"<{i}>" for i in ids)


def text_of(chars: int, seed: int) -> str:
    rnd = random.Random(seed)
    return "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(chars))


# greedy pool requests: (start delay s, prompt chars = tokens, max_tokens);
# 10 requests for 8 slots, five prompts longer than the 512-token
# admission chunk, index STOP_REQUEST carries a stop string
SERVE_REQUESTS = [
    (0.00, 30, 64), (0.05, 3000, 32), (0.10, 120, 48), (0.20, 700, 16), (0.30, 64, 64),
    (0.40, 1500, 40), (0.50, 45, 24), (0.60, 300, 56), (0.80, 2000, 20), (1.00, 90, 64),
]
STOP_REQUEST = 4
# the compaction pool: (prompt tokens, max_tokens); the first two join
# together (the second in a join gap), the last two after the first
# finishes near the cache end, so the third's join compacts the pool and
# jumps its frontier, and the fourth joins in a gap
COMPACT_CACHE = 2048
COMPACT_REQUESTS = [(1960, 16), (40, 64), (1500, 128), (600, 32)]


def post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = resp.read().decode()
        if resp.headers["Content-Type"] == "text/event-stream":
            events = [l[6:] for l in body.splitlines() if l.startswith("data: ")]
            if events[-1] != "[DONE]":
                raise SystemExit("SSE stream did not end with [DONE]")
            return [json.loads(e) for e in events[:-1]]
        return json.loads(body)


def phase_serve(torch, engine):
    """The port's HTTP server over the merged 8B-width int4 engine, with a
    continuous pool of 8 slots over a 4096-slot cache."""
    from shardmerge_tpu_torch.batching import ContinuousEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.serve import ModelServer

    engine.tokenizer = IdTokenizer()
    prompts = [text_of(chars, 100 + i) for i, (_, chars, _) in enumerate(SERVE_REQUESTS)]
    greedy = dict(greedy=True, use_template=False)
    # the stop string: the first token from the 11th on of the stop
    # request's solo text that did not occur before it
    ids = "".join(engine.stream_generation(prompts[STOP_REQUEST], max_new_tokens=64, **greedy))[1:-1].split("><")
    stop = [f"<{next((t for j, t in enumerate(ids) if j >= 10 and t not in ids[:j]), ids[10])}>"]

    server = ModelServer(engine, model_id="llama-3.1-8b-width", continuous_slots=SERVE_SLOTS,
                         continuous_cache_len=SERVE_CACHE)
    port = server.start("127.0.0.1", 0)
    try:
        warm = server.warmup()
        say(f"[serve] server on 127.0.0.1:{port}, pool {SERVE_SLOTS} slots x {SERVE_CACHE} cache slots; "
            f"warmup {warm:.2f} s")
        results = {}

        def send(key, delay, payload):
            time.sleep(delay)
            try:
                results[key] = post(port, payload)
            except Exception as exc:  # reported below as a failed request
                results[key] = exc

        jobs = []
        for i, ((delay, _, n), prompt) in enumerate(zip(SERVE_REQUESTS, prompts)):
            payload = {"prompt": prompt, "max_tokens": n, "greedy": True}
            if i == STOP_REQUEST:
                payload["stop"] = stop
            jobs.append((i, delay, payload))
        sse_prompt, batch_prompts = text_of(200, 7), [text_of(c, 8 + c) for c in (40, 90, 260, 33)]
        jobs.append(("sse", 0.25, {"prompt": sse_prompt, "max_tokens": 32, "greedy": True, "stream": True}))
        jobs.append(("lockstep", 0.45, {"prompt": batch_prompts, "max_tokens": 24, "temperature": 0.7,
                                        "seed": 3}))
        dispatches0 = server.pool.stats["decode_dispatches"]
        tokens0 = server.pool.stats["tokens_out"]
        reset_counts(qk, ak)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"int4_gemv": qk.launch_counts["int4_gemv"], "flash_decode": ak.launch_counts["flash_decode"],
                    "flash_compact": ak.launch_counts["flash_compact"]}
        stats = dict(server.pool.stats)
        metrics = server.pool.metrics()
    finally:
        server.stop()
    failed = {k: v for k, v in results.items() if isinstance(v, Exception)}
    if failed or len(results) != len(jobs):
        raise SystemExit(f"[serve] requests failed: {failed or 'timed out'}")
    dispatches = stats["decode_dispatches"] - dispatches0
    tokens = stats["tokens_out"] - tokens0
    lat = {k: (v["p50"], v["p95"]) for k, v in metrics.items()}
    say(
        f"[serve] {len(SERVE_REQUESTS)} pool requests + 1 SSE + 1 lockstep x4 in {wall:.2f} s wall; pool: "
        f"{tokens} tokens, {dispatches} decode steps, {tokens / wall:.1f} tokens/s over the wall, joins "
        f"{stats['joins']}, frontier jumps {stats['frontier_jumps']}, compactions {stats['compactions']}, "
        f"admission slices {stats['admission_chunks']} (worst {stats['admission_chunk_ms_max']} ms)"
    )
    say(f"[serve] pool latency ms (p50, p95), warmup request included: {lat}")
    say(f"[serve] launches during the requests: {launches}")

    # every pool completion equals the solo stream of the same prompt
    mismatched = []
    for i, ((_, _, n), prompt) in enumerate(zip(SERVE_REQUESTS, prompts)):
        want = "".join(engine.stream_generation(prompt, max_new_tokens=n, stop=stop if i == STOP_REQUEST
                                                else None, **greedy))
        choice = results[i]["choices"][0]
        if choice["text"] != want:
            mismatched.append(i)
        if i == STOP_REQUEST and (choice["finish_reason"] != "stop" or stop[0] in choice["text"]):
            raise SystemExit(f"[serve] the stop request did not stop: {choice}")
    events = results["sse"]
    sse_text = "".join(e["choices"][0]["text"] for e in events)
    if sse_text != "".join(engine.stream_generation(sse_prompt, max_new_tokens=32, **greedy)):
        mismatched.append("sse")
    batch = results["lockstep"]["choices"]
    if len(batch) != 4 or not all(c["text"] and c["finish_reason"] == "length" for c in batch):
        raise SystemExit(f"[serve] lockstep request: {batch}")
    say(f"[serve] pool completions vs solo stream_generation: {len(SERVE_REQUESTS) - len(mismatched)} of "
        f"{len(SERVE_REQUESTS)} equal token for token; SSE {len(events)} events; lockstep 4 choices")
    if mismatched:
        raise SystemExit(f"[serve] completions differ from the solo stream: {mismatched}")
    if launches["flash_decode"] < LAYERS * dispatches or launches["int4_gemv"] == 0:
        raise SystemExit(f"[serve] kernels not on the path: {launches}, {dispatches} pool steps")

    # a pool that compacts, driven step by step: the compared step below
    # runs on its compacted, gapped rows, and its completions are held to
    # the solo stream
    pool = ContinuousEngine(engine, slots=SERVE_SLOTS, cache_len=COMPACT_CACHE, greedy=True, use_template=False)
    prompts = [(text_of(chars, 200 + chars), n) for chars, n in COMPACT_REQUESTS]
    driven = {"launches": 0, "dispatches": 0, "compactions": 0}

    def drive(until):
        launches0, dispatches0 = ak.launch_counts["flash_decode"], pool.stats["decode_dispatches"]
        compacts0 = ak.launch_counts["flash_compact"]
        for _ in range(1000):
            if until():
                break
            pool._admit_pending()
            pool._step()
        else:
            raise SystemExit(f"[serve] the compaction pool is stuck: {pool.stats}")
        driven["launches"] += ak.launch_counts["flash_decode"] - launches0
        driven["dispatches"] += pool.stats["decode_dispatches"] - dispatches0
        driven["compactions"] += ak.launch_counts["flash_compact"] - compacts0

    handles = [pool.submit(p, max_new_tokens=n) for p, n in prompts[:2]]
    drive(handles[0].done)
    handles += [pool.submit(p, max_new_tokens=n) for p, n in prompts[2:]]
    drive(lambda: all(h.joined_at is not None for h in handles))
    if pool.stats["compactions"] < 1:
        raise SystemExit(f"[serve] the compaction pool did not compact: {pool.stats}")
    dev = engine.device
    with torch.inference_mode():
        valid = torch.as_tensor(pool._valid, device=dev)

        def step(kv):
            _, last, _ = engine._chunk_decode(
                1, pool._last.clone(), pool._gen_mask.clone(), torch.Generator(device=dev), kv,
                pool._rope, pool._t, pool._col(pool._pad, torch.int64),
                pool._col(pool._temp, torch.float32), pool._col(pool._top_p, torch.float32),
                pool._col(pool._rep, torch.float32), valid, pool._kp.clone(), top_k=pool.top_k, greedy=True,
            )
            return last

        seen = []  # the pool step's attention inputs, layer by layer

        def recording(*args, **kw):
            seen.append((args, kw))
            return kernel(*args, **kw)

        def plain(q, k, v, m, slots=None):
            return ak.flash_decode_plain(q, k, v, m)

        kernel = ak.flash_decode
        before = ak.launch_counts["flash_decode"]
        with mock.patch.object(ak, "flash_decode", recording):
            with_kernel = step({k: v.clone() for k, v in pool._kv.items()})
        if ak.launch_counts["flash_decode"] - before != LAYERS:
            raise SystemExit("[serve] the pool step did not run the flash kernel in every layer")
        with mock.patch.object(ak, "flash_decode", plain):
            with_plain = step({k: v.clone() for k, v in pool._kv.items()})
        # the kernel on the pool's own tensors (gapped masks, free rows)
        live = [b for b, row in enumerate(pool._rows) if row is not None]
        attn = max(rel_l2(kernel(*a, **kw)[live], ak.flash_decode_plain(*a)[live]) for a, kw in seen)
    # the live rows: a free row is all masked and its logits are never read
    # (the kernel gives it zeros, the plain softmax a mean of V). The logits
    # gate is the bf16 class of the generate phase: the attention output is
    # rounded to bf16 before o_proj, and the few roundings that its last-bit
    # differences flip carry through both layers to the logits.
    rel = rel_l2(with_kernel[live], with_plain[live])
    say(f"[serve] pool step after compaction ({len(live)} live rows of {SERVE_SLOTS}, frontier {pool._t}, "
        f"{COMPACT_CACHE}-slot cache, joins {pool.stats['joins']}, jumps {pool.stats['frontier_jumps']}, "
        f"compactions {pool.stats['compactions']}): attention on the pool's tensors, kernel vs plain, relL2 "
        f"{attn:.2e} (tol 1e-5); logits, kernel vs plain attention, relL2 {rel:.2e} (tol 2e-2)")
    if attn > 1e-5 or rel > 2e-2 or not bool(torch.isfinite(with_kernel).all()):
        raise SystemExit("[serve] pool step disagrees")
    pool_step_profile(torch, ak, step, pool)

    drive(lambda: all(h.done() for h in handles))
    solo = ["".join(engine.stream_generation(p, max_new_tokens=n, **greedy)) for p, n in prompts]
    equal = sum(h.result() == want for h, want in zip(handles, solo))
    say(f"[serve] compaction pool: {equal} of {len(handles)} completions equal the solo stream token for "
        f"token; {driven['dispatches']} pool steps, flash launches {driven['launches']}, slot-list compactions "
        f"{driven['compactions']} (one per decode forward step: {LAYERS} flash launches each)")
    if equal != len(handles):
        raise SystemExit("[serve] compaction pool completions differ from the solo stream")
    if driven["launches"] < LAYERS * driven["dispatches"]:
        raise SystemExit(f"[serve] compaction pool: flash kernel not on the path: {driven}")
    if driven["launches"] != LAYERS * driven["compactions"]:
        raise SystemExit(f"[serve] compaction pool: the slot list was not compacted once per step: {driven}")
    return launches


def pool_step_profile(torch, ak, step, pool):
    """One pool step (B=8, the pool's gapped rows) timed with the flash
    kernel and with the einsum path, in turn; then the device's busy share
    and its top kernels over 10 steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        kv = {k: v.clone() for k, v in pool._kv.items()}  # each step rewrites one slot

        def per_step(n=50):
            step(kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(kv)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        einsum = mock.patch.object(ak, "use_flash_decode", lambda *a: False)
        flash_a = per_step()
        with einsum:
            einsum_a = per_step()
            einsum_b = per_step()
        flash_b = per_step()
        say(f"[serve] A/B one pool step (B={SERVE_SLOTS}, frontier {pool._t}, means of 50, in turn): flash "
            f"kernel {flash_a:.3f} / {flash_b:.3f} ms, einsum path {einsum_a:.3f} / {einsum_b:.3f} ms")
        counts0 = dict(ak.launch_counts)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                step(kv)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        flash_per_step = {k: (v - counts0.get(k, 0)) / 10 for k, v in ak.launch_counts.items()}
    # device-side events only (a CPU op's row repeats its kernels' time)
    rows = [
        (e.self_device_time_total, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(t for t, _ in rows)
    if device_us <= 0:
        say("[serve] device busy share: not measured (the profiler saw no device time)")
        return
    top = ", ".join(f"{k[:40]} {t / 10 / 1e3:.3f} ms" for t, k in sorted(rows, reverse=True)[:6])
    kernels = device_kernels(torch, prof)
    flash_us = sum(t for k, (t, _) in kernels.items() if "flash_" in k) / 10
    say(f"[serve] profiled pool steps: device busy {device_us / wall_us:.1%} of {wall_us / 10 / 1e3:.3f} ms "
        f"per step (profiler on); per step: {top}")
    say(f"[serve] device launches per pool step: {sum(n for _, n in kernels.values()) / 10:.1f} in all; flash "
        f"{flash_per_step} ({LAYERS} layers); flash kernels' device time {flash_us / 1e3:.4f} ms per step, "
        f"{flash_us * 10 / device_us:.1%} of the step's device time")


# [spec]: the draft, meta-llama/Llama-3.2-1B's config.json with
# num_hidden_layers cut from 16 to 2 (bf16, random weights built on the card)
LLAMA_32_1B = {
    "architectures": ["LlamaForCausalLM"],
    "hidden_act": "silu",
    "hidden_size": 2048,
    "head_dim": 64,
    "intermediate_size": 8192,
    "max_position_embeddings": 131072,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": LAYERS,
    "num_key_value_heads": 8,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {
        "factor": 32.0,
        "high_freq_factor": 4.0,
        "low_freq_factor": 1.0,
        "original_max_position_embeddings": 8192,
        "rope_type": "llama3",
    },
    "rope_theta": 500000.0,
    "tie_word_embeddings": True,
    "vocab_size": 128256,
}
CARD = "cuda:0"  # the device the [spec] and [families] phases run on
SPEC_K = 4
SPEC_NEW = 1 + 16 * SPEC_K  # the first token, then 16 full rounds
SPEC_PROMPT = 300  # prompt tokens of the solo streams
# the speculative pool: (prompt tokens, max_tokens, pool steps driven before
# the next submit); 10 requests for 8 slots
SPEC_POOL_SLOTS, SPEC_POOL_CACHE = 8, 2048
# the planted-miss pool: long-lived rows in a cache just over the largest
# need (prompt + budget + k <= 512), so both caches compact again and again
# while most rows are live and some lag
SPEC_POOL_SHORT_CACHE = 512
SPEC_POOL_LAG_REQUESTS = [(380, 96, 1), (120, 100, 2), (250, 80, 0), (300, 90, 1), (60, 100, 2), (400, 72, 0),
                          (200, 96, 1), (330, 88, 0), (90, 64, 1), (150, 80, 0)]
SPEC_POOL_REQUESTS = [(40, 48, 2), (300, 32, 1), (90, 40, 3), (700, 24, 0), (25, 56, 2), (160, 32, 1),
                      (520, 40, 2), (64, 24, 0), (1200, 32, 1), (33, 40, 0)]
PREFIX_SYSTEM = 2000  # tokens of the shared system prompt
# a first difference is a near-tie where the plain route's top-2 margin is
# at most NEAR_TIE x the verify's max-abs gap from the T=1 decode there
NEAR_TIE = 4.0
PLANTED_MISS = 0.2  # share of positions where the planted-miss draft proposes its runner-up


def token_ids(text: str):
    """IdTokenizer's text back to its token ids."""
    return [int(t) for t in text[1:-1].split("><")] if text else []


def first_difference(got, want):
    """Index of the first token where two streams differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def replay(torch, engine, ids, tokens, k: int = SPEC_K):
    """The plain route's logits before each of ``tokens`` (the prompt's
    prefill, then one T=1 decode step a token: the kernels' route) and
    their gaps from the T=k verify's logits over the same context: verify
    forwards over k-token blocks of ``tokens`` at their slots, as a
    speculative round feeds them. Returns (logits (n, V) f32, the max-abs
    gap at each token (None where no verify row predicts it: the first, and
    the tail past the last whole block), the largest gap, the relL2 gap)."""
    from shardmerge_tpu_torch.models import llama

    model, dev = engine.model, engine.device
    L, n = len(ids), len(tokens)
    cache = -(-(L + n + k) // 256) * 256
    rope = llama.rope_tables(engine.cfg, cache, dev)
    kv = engine._init_kv(1, cache)
    with torch.inference_mode():
        pids, ppos = engine._pad_prompt(ids, cache)
        last, kv = engine._chunked_prefill(pids, ppos, kv, rope, L, keep_pos=L - 1)
        steps = [last[0]]
        for i, tok in enumerate(tokens[:-1]):
            pos = L + i
            logits, kv = model(torch.tensor([[tok]], device=dev), torch.tensor([[pos]], device=dev), kv, pos,
                               rope, pos + 1)
            steps.append(logits[0, -1])
        steps = torch.stack(steps)
        got, want = [], []
        for j in range(0, n - k, k):
            logits, kv = model(torch.tensor([tokens[j : j + k]], device=dev),
                               torch.arange(L + j, L + j + k, device=dev)[None], kv, L + j, rope, L + j + k)
            got.append(logits[0])  # row r predicts tokens[j + r + 1]
            want.append(steps[j + 1 : j + 1 + k])
        got, want = torch.cat(got), torch.cat(want)
        per = (got - want).abs().amax(dim=-1).tolist()
    gaps = [None] + per + [None] * (n - 1 - len(per))
    return steps, gaps, max(per), rel_l2(got, want)


def margins(torch, logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def tie_at(logits, a: int, b: int, gap: float):
    """Whether tokens ``a`` and ``b`` are a near-tie of one row of the plain
    route's logits: each lies within NEAR_TIE x ``gap`` of the row's best
    logit. Where the plain route's top two are distinct this is its top-2
    margin rule with both tokens among the top two; a token outside that
    window (a wrong token at a low-margin position) never passes, and a
    bf16 tie of three tokens within an ulp does. Returns (ok, the farther
    token's distance from the best, both tokens' ranks)."""
    row = logits.float()
    best = float(row.max())
    dist = max(best - float(row[a]), best - float(row[b]))
    ranks = tuple(int((row > row[t]).sum()) for t in (a, b))
    return dist <= NEAR_TIE * gap, dist, ranks


def near_tie_check(tag: str, got, want, plain_logits, gaps, fallback: float):
    """``got`` equals ``want`` token for token, or first differs at a token
    p where the two tokens are a near-tie (:func:`tie_at`) of the plain
    route's logits there, against the gap measured at p (``gaps[p]``;
    ``fallback`` where no verify row predicts p); (equal, note)."""
    p = first_difference(got, want)
    if p is None:
        return True, "equal"
    if p >= min(len(got), len(want), len(plain_logits)):
        raise SystemExit(f"{tag}: {len(got)} tokens against {len(want)}")
    gap = gaps[p] if p < len(gaps) and gaps[p] is not None else fallback
    ok, dist, ranks = tie_at(plain_logits[p], got[p], want[p], gap)
    if not ok:
        raise SystemExit(f"{tag}: first differs at token {p} ({got[p]} for {want[p]}, ranked {ranks} by the plain "
                         f"route), not a near-tie ({dist:.3e} from its best > {NEAR_TIE} x gap {gap:.3e})")
    return False, (f"first differs at token {p}, a near-tie (ranks {ranks}, {dist:.3e} from the best <= {NEAR_TIE} "
                   f"x gap {gap:.3e})")


def spec_engine(engine, draft, k: int = SPEC_K, **kw):
    from shardmerge_tpu_torch.inference import InferenceEngine

    return InferenceEngine(engine.cfg, engine.model, IdTokenizer(), draft=draft, speculation_k=k, **kw)


def recorded_rounds(eng):
    """Wrap an engine's round: each call's (t, packed) is kept."""
    rounds = []
    real = eng._spec_round

    def recording(*args):
        packed, kv, d_kv = real(*args)
        rounds.append((args[5], packed))
        return packed, kv, d_kv

    eng._spec_round = recording
    return rounds


def accepted(packed, k: int = SPEC_K) -> int:
    props, y = packed[: k - 1], packed[k - 1 :]
    m = 0
    while m < k - 1 and y[m] == props[m]:
        m += 1
    return m


def planted_miss_draft(torch, model, seed: int = 13):
    """The target as its own draft whose forward at a seeded random
    PLANTED_MISS of positions ranks its best next token last, so that it
    proposes the runner-up there and its rounds accept all, some or none of
    their proposals. Returns (draft, the by-position list of misses)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    table = torch.rand(1 << 16, generator=gen, device=model.device) < PLANTED_MISS

    class PlantedMiss(type(model)):
        def forward(self, input_ids, positions, *args, **kw):
            logits, kv = super().forward(input_ids, positions, *args, **kw)
            missed = logits.scatter(-1, logits.argmax(-1, keepdim=True), float("-inf"))
            return torch.where(table[positions][..., None], missed, logits), kv

    draft = copy.copy(model)
    draft.__class__ = PlantedMiss
    return draft, table.tolist()


def spec_pool(torch, qk, ak, eng, plain, cache_len: int, requests, name: str, int4_draft: bool, planted=None):
    """The speculative pool of ``eng`` over ``requests`` ((prompt tokens,
    max_tokens, pool steps before the next submit)), staggered: every
    completion equals its solo speculative stream under the near-tie rule;
    the verify's route read from the GEMV launches (a round's k T=1 draft
    forwards take the GEMV too when the draft is int4). With ``planted``
    (the planted-miss draft's misses by position) every rejected proposal
    must be a planted miss or a near-tie of the plain route along the
    row's completion: a draft cache out of step with its row (a wrong
    catch-up, a bad compaction) proposes other tokens, which the tokens
    alone never show. Returns (stats, launches, live row-rounds by
    accepted proposals 0..k-1, the rows lagging at each draft
    compaction)."""
    from shardmerge_tpu_torch.batching import ContinuousEngine

    pool = ContinuousEngine(eng, slots=SPEC_POOL_SLOTS, cache_len=cache_len, greedy=True, use_template=False)
    rounds, lagging = [], []
    real_round, real_compact = pool._pool_spec_round, pool._compact_draft

    def spec_round(t, t_d):
        live = [(b, pool._rows[b], int(pool._pos_x1[b])) for b in range(pool.B) if pool._rows[b] is not None]
        out = real_round(t, t_d)
        rounds.append((live, out))
        return out

    def compact_draft():
        lagging.append(sum(bool(pool._lag[b]) for b in range(pool.B) if pool._rows[b] is not None))
        real_compact()

    pool._pool_spec_round, pool._compact_draft = spec_round, compact_draft
    reqs = [(text_of(n, 300 + i), m) for i, (n, m, _) in enumerate(requests)]
    reset_counts(qk, ak)
    t0 = time.perf_counter()
    handles = []
    for (p, m), (_, _, after) in zip(reqs, requests):
        handles.append(pool.submit(p, max_new_tokens=m, repetition_penalty=1.0))
        pool._admit_pending()
        for _ in range(after):
            if pool._active():
                pool._step()
            pool._admit_pending()
    pool.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"int4_gemv": qk.launch_counts["int4_gemv"], "flash_decode": ak.launch_counts["flash_decode"]}
    stats = pool.stats
    acc = [accepted(out[b].tolist()) for live, out in rounds for b, _, _ in live]
    hist = [acc.count(m) for m in range(SPEC_K)]
    per_round = 7 * LAYERS * (1 + (SPEC_K if int4_draft else 0))
    route = "GEMV" if counts["int4_gemv"] >= per_round * stats["spec_rounds"] else "dense"
    notes = []
    for (p, m), h in zip(reqs, handles):
        solo = token_ids("".join(eng.stream_generation(p, max_new_tokens=m, greedy=True, repetition_penalty=1.0)))
        got = token_ids(h.result())
        if got != solo:
            # the pool and the solo stream round apart in their batched
            # products and their attention over other slot layouts, not in
            # the verify-vs-T=1 gap at one token: the rule takes the
            # largest gap measured over the solo stream's tokens
            solo_steps, _, solo_gap, _ = replay(torch, plain, IdTokenizer().encode(p), solo)
            notes.append(near_tie_check(f"[spec] {name} pool completion", got, solo, solo_steps, [], solo_gap)[1])
    ties = 0
    if planted is not None:
        index = {id(h): i for i, h in enumerate(handles)}
        replays = {}
        for live, out in rounds:
            packed = out.tolist()
            for b, handle, px in live:
                m = accepted(packed[b])
                # proposal m, for position px+m+1, comes from the draft's forward at px+m
                if m == SPEC_K - 1 or planted[px + m]:
                    continue
                i = index[id(handle)]
                ids = IdTokenizer().encode(reqs[i][0])
                tokens = token_ids(handle.result())
                gi = px + m + 1 - len(ids)
                if gi >= len(tokens):
                    continue  # past the row's end: never emitted
                if i not in replays:
                    replays[i] = replay(torch, plain, ids, tokens)
                steps, _, gap, _ = replays[i]
                ok, dist, ranks = tie_at(steps[gi], packed[b][m], packed[b][SPEC_K - 1 + m], gap)
                if not ok:
                    raise SystemExit(f"[spec] {name} pool: request {i} rejected a proposal at token {gi} that is "
                                     f"neither a planted miss nor a near-tie (ranks {ranks}, {dist:.3e} from the "
                                     f"best, gap {gap:.3e})")
                ties += 1
    say(f"[spec] {name} pool, {SPEC_POOL_SLOTS} slots x {cache_len} cache slots, {len(reqs)} staggered greedy "
        f"requests in {wall:.2f} s: spec_rounds {stats['spec_rounds']}, spec_accepted {stats['spec_accepted']}, "
        f"live row-rounds accepting 0..{SPEC_K - 1} proposals {hist}"
        + (f" (every rejection a planted miss or one of {ties} near-ties)" if planted is not None else "")
        + f", joins {stats['joins']}, frontier jumps "
        f"{stats['frontier_jumps']}, compactions {stats['compactions']} (draft {len(lagging)}, lagging rows at "
        f"each {lagging}); verify {SPEC_POOL_SLOTS * SPEC_K} rows a round on the {route} route; launches {counts}; "
        f"completions vs their solo speculative streams: {len(reqs) - len(notes)} of {len(reqs)} equal"
        + (f" ({'; '.join(notes)})" if notes else ""))
    return stats, counts, hist, lagging


def decode_rate(torch, fn, n: int) -> float:
    """Decode tokens/s of ``fn(tokens)`` (a whole stream): (wall(n) -
    wall(1)) over n - 1 tokens, medians of 3, so the prefill is excluded."""

    def wall(tokens):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    return (n - 1) / (wall(n) - wall(1))


def phase_spec(torch, engine, card: str):
    """Speculative decoding and the prefix cache on the [generate] phase's
    int4 merge: solo streams with a Llama-3.2-1B-width draft, with the
    target as its own draft, with the planted-miss draft and without, the
    speculative pool with the 1B and the planted-miss draft, and the server
    with the prefix cache."""
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.serve import ModelServer

    t_phase = time.perf_counter()
    dev = torch.device(CARD)
    engine.tokenizer = IdTokenizer()
    d_cfg = llama.ModelConfig.from_hf_config(LLAMA_32_1B)
    draft = llama.LlamaModel(d_cfg, llama.init_params(d_cfg, seed=11, dtype=torch.bfloat16, device=dev))
    plain = InferenceEngine(engine.cfg, engine.model, IdTokenizer())
    planted_miss, planted = planted_miss_draft(torch, engine.model)
    engines = {"1B draft": spec_engine(engine, draft), "self-draft": spec_engine(engine, engine.model),
               "planted-miss draft": spec_engine(engine, planted_miss)}
    greedy = dict(greedy=True, repetition_penalty=1.0)
    prompt = text_of(SPEC_PROMPT, 31)
    ids = IdTokenizer().encode(prompt)

    def run(eng, n=SPEC_NEW):
        return "".join(eng.stream_generation(prompt, max_new_tokens=n, **greedy))

    want = token_ids(run(plain))
    steps, gaps, gap, gap_rel = replay(torch, plain, ids, want)
    plain_margins = margins(torch, steps)
    say(f"[spec] target: the [generate] merge (Llama-3.1-8B widths, {LAYERS} layers, int4); drafts: Llama-3.2-1B "
        f"widths, {LAYERS} layers, bf16, random weights; the target itself; the target proposing its runner-up at "
        f"{PLANTED_MISS:.0%} of positions (planted misses); k = {SPEC_K}; {SPEC_PROMPT}-token prompt, {SPEC_NEW} "
        f"greedy tokens, repetition penalty 1.0")
    say(f"[spec] verify (T={SPEC_K}) logits vs the T=1 decode's on the plain stream's tokens: max-abs "
        f"{gap:.3e}, relL2 {gap_rel:.2e} (class 2e-2); plain route's smallest top-2 margin "
        f"{min(plain_margins):.3e}")
    if gap_rel > 2e-2:
        raise SystemExit("[spec] the verify's logits leave the 2e-2 class of the T=1 decode's")
    for name, eng in engines.items():
        rounds = recorded_rounds(eng)
        reset_counts(qk, ak)
        got = token_ids(run(eng))
        torch.cuda.synchronize()
        counts = {"int4_gemv": qk.launch_counts["int4_gemv"], "flash_decode": ak.launch_counts["flash_decode"]}
        acc = [accepted(packed.tolist()) for _, packed in rounds]
        _, note = near_tie_check(f"[spec] {name} stream", got, want, steps, gaps, gap)
        say(f"[spec] {name}: {len(rounds)} rounds, accepted proposals a round {acc}; stream vs plain: {note}; "
            f"launches {counts}")
        if name == "1B draft":
            # the 1B draft is bf16: every GEMV is the target's verify, every
            # flash launch a draft decode
            if counts["int4_gemv"] != 7 * LAYERS * len(rounds):
                raise SystemExit(f"[spec] the verify did not run the GEMV for every projection: {counts}")
            if counts["flash_decode"] < LAYERS * (SPEC_K - 1) * len(rounds):
                raise SystemExit(f"[spec] the draft's decodes did not run the flash kernel: {counts}")
            continue
        # the target drafts: a proposal is rejected only at a planted miss
        # or at a near-tie of the stream's own T=1 route
        if min(acc) < SPEC_K - 1:
            own_steps, own_gaps, own_gap, _ = replay(torch, plain, ids, got)
        ties = 0
        for (t, packed), m in zip(rounds, acc):
            # proposal m, for slot t+m+1, comes from the draft's forward at
            # position t+m
            if m == SPEC_K - 1 or (name == "planted-miss draft" and planted[t + m]):
                continue
            # the rejected proposal and the verify's token there
            gi = t + m + 1 - len(ids)
            g = own_gaps[gi] if gi < len(own_gaps) and own_gaps[gi] is not None else own_gap
            prop, y = int(packed[m]), int(packed[SPEC_K - 1 + m])
            ok, dist, ranks = tie_at(own_steps[gi], prop, y, g) if gi < len(own_steps) else (False, math.nan, ())
            if not ok:
                raise SystemExit(f"[spec] the {name} rejected a proposal at token {gi}, not a near-tie")
            ties += 1
            say(f"[spec] {name}: a rejection at token {gi}, a near-tie (ranks {ranks}, {dist:.3e} from the best <= "
                f"{NEAR_TIE} x gap {g:.3e})")
        hist = [acc.count(m) for m in range(SPEC_K)]
        say(f"[spec] {name}: rounds accepting 0..{SPEC_K - 1} proposals {hist}; rejections at near-ties {ties}")
        if name == "planted-miss draft" and not (hist[-1] and sum(hist[1:-1])):
            raise SystemExit(f"[spec] the planted-miss draft's rounds are not mixed: {hist}")
    rates = {"plain": decode_rate(torch, lambda n: run(plain, n), SPEC_NEW)}
    for name, eng in engines.items():
        rates[name] = decode_rate(torch, lambda n: run(eng, n), SPEC_NEW)
    say(f"[spec] B=1 decode tokens/s ({card}; {SPEC_NEW} tokens, prefill excluded, medians of 3): "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))

    # the speculative pool: every completion equals its solo speculative
    # stream; with the 1B draft (no proposal accepted), then with the
    # planted-miss draft over a short cache (rounds accept all, some or
    # none, rows lag, both caches compact)
    for name, cache_len, requests in (("1B draft", SPEC_POOL_CACHE, SPEC_POOL_REQUESTS),
                                      ("planted-miss draft", SPEC_POOL_SHORT_CACHE, SPEC_POOL_LAG_REQUESTS)):
        stats, counts, hist, lagging = spec_pool(torch, qk, ak, engines[name], plain, cache_len, requests, name,
                                                 int4_draft=name != "1B draft",
                                                 planted=planted if name == "planted-miss draft" else None)
        if counts["flash_decode"] == 0 or counts["int4_gemv"] == 0:
            raise SystemExit(f"[spec] the {name} pool did not run both kernels: {counts}")
        if name == "planted-miss draft" and not (stats["spec_accepted"] and hist[-1] and sum(hist[1:-1])
                                                 and any(lagging)):
            raise SystemExit(f"[spec] the planted-miss pool accepted no mix of prefixes or compacted no draft "
                             f"cache while a row lagged: spec_accepted {stats['spec_accepted']}, row-rounds by "
                             f"accepted {hist}, draft compactions {lagging}")
    del engines
    torch.cuda.empty_cache()

    # the server with the prefix cache: two requests sharing a system prompt
    cached = InferenceEngine(engine.cfg, engine.model, IdTokenizer(), prefix_cache_slots=4)
    hits, returned = [], []
    real_lookup = cached._prefix_lookup

    def lookup(*args, **kw):
        # each request's hit, and a copy of the slots the cache implanted
        hit, kv = real_lookup(*args, **kw)
        hits.append(hit)
        returned.append({key: v[:, :, :, :hit].clone() for key, v in kv.items()})
        return hit, kv

    cached._prefix_lookup = lookup
    system = text_of(PREFIX_SYSTEM, 41)
    questions = [system + " first " + text_of(20, 42), system + " other " + text_of(20, 43)]
    server = ModelServer(cached, model_id="llama-3.1-8b-width")
    port = server.start("127.0.0.1", 0)
    try:
        server.warmup()
        texts = []
        for q in questions:
            texts.append(post(port, {"prompt": q, "max_tokens": 24, "greedy": True, "repetition_penalty": 1.0})
                         ["choices"][0]["text"])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        server.stop()
    shared = PREFIX_SYSTEM + 1  # the system prompt and the space after it
    want_hit = (len(IdTokenizer().encode(questions[1])) - 1) // 64 * 64
    want_hit = min(want_hit, shared // 64 * 64)
    # each request stores its own bucket-aligned prefix (one slab when the
    # two prefixes are the same tokens): k and v, bf16
    per_token = 2 * LAYERS * engine.cfg.num_key_value_heads * engine.cfg.head_dim * 2
    stored = {tuple(ids[: (len(ids) - 1) // 64 * 64]) for ids in map(IdTokenizer().encode, questions)}
    slab = sum(len(key) * per_token for key in stored)
    if hits != [0, want_hit] or stats.get("prefix_cache", {}).get("bytes") != slab:
        raise SystemExit(f"[spec] the prefix cache did not hit the bucket-aligned shared prefix: hits {hits} (want "
                         f"[0, {want_hit}]), /v1/stats prefix_cache {stats.get('prefix_cache')} (want {slab} bytes)")
    miss = token_ids("".join(plain.stream_generation(questions[1], max_new_tokens=24, **greedy)))
    q_ids = IdTokenizer().encode(questions[1])
    n = len(q_ids)
    miss_steps, _, miss_gap, _ = replay(torch, plain, q_ids, miss)
    with torch.inference_mode():
        cache = -(-(n + 24) // 256) * 256
        rope = llama.rope_tables(engine.cfg, cache, dev)
        pids, ppos = plain._pad_prompt(q_ids, cache)
        cold, cold_kv = plain._chunked_prefill(pids, ppos, plain._init_kv(1, cache), rope, n, keep_pos=n - 1)
        # what the cache returned to the second request, against the plain
        # prefill's KV at its slots; then the hit's prefill of the rest on it
        hit_len, kv = want_hit, plain._init_kv(1, cache)
        for key, v in returned[1].items():
            kv[key][:, :, :, :hit_len].copy_(v)
        kv_rel = max(rel_l2(kv[key][:, :, :, :hit_len].float(), cold_kv[key][:, :, :, :hit_len].float())
                     for key in ("k", "v"))
        warm, _ = plain._chunked_prefill(pids, ppos, kv, rope, n, keep_pos=n - 1, start=hit_len)
        # the plain route split at the hit without the cache: the rounding
        # that prefilling the rest alone opens, measured apart from the cache
        _, split_kv = plain._chunked_prefill(pids[:, :hit_len], ppos[:, :hit_len], plain._init_kv(1, cache), rope,
                                             hit_len)
        split, _ = plain._chunked_prefill(pids, ppos, split_kv, rope, n, keep_pos=n - 1, start=hit_len)
        split_gap = float((cold - split).abs().max())
        hm_rel = rel_l2(warm.float(), cold.float())
        hs_gap = float((warm - split).abs().max())
    # the near-tie rule takes its gap from the plain route alone: the split
    # prefill's, or the verify's against the T=1 decode's on the miss's tokens
    _, note = near_tie_check("[spec] prefix-cache hit", token_ids(texts[1]), miss, miss_steps, [],
                                 max(split_gap, miss_gap))
    say(f"[spec] server --prefix-cache 4, two requests sharing a {PREFIX_SYSTEM}-token system prompt: "
        f"prefix_cache_hit_tokens {hits} (want [0, {want_hit}]); /v1/stats prefix_cache {stats.get('prefix_cache')} "
        f"(want {slab} bytes in {len(stored)} slab(s)); the cached KV vs the plain prefill's at its {hit_len} slots "
        f"relL2 {kv_rel:.2e} (tol 2e-2); the hit's prompt logits vs a miss's relL2 {hm_rel:.2e} (tol 2e-2), vs "
        f"the plain prefill split at the hit max-abs {hs_gap:.3e}; split vs whole prefill max-abs {split_gap:.3e}; "
        f"the hit's tokens vs a miss's: {note}")
    if not (kv_rel <= 2e-2 and hm_rel <= 2e-2):
        raise SystemExit("[spec] the prefix cache's KV or the hit's prompt logits leave the 2e-2 class of the "
                         "plain prefill's")

    def ttft(eng, prompt):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            next(iter(eng.stream_generation(prompt, max_new_tokens=2, **greedy)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1] * 1e3

    say(f"[spec] TTFT of a {len(q_ids)}-token prompt ({card}; medians of 3): prefix-cache hit "
        f"{ttft(cached, questions[1]):.2f} ms, miss {ttft(plain, questions[1]):.2f} ms")
    del cached, plain, draft
    torch.cuda.empty_cache()
    say(f"[spec] phase wall {time.perf_counter() - t_phase:.1f} s")


# [families]: one model per dense family from its public config.json, at
# its published widths, num_hidden_layers cut to 2, random weights built on
# the card, int4 projections. Each entry: (repository, config, the decode
# attention's route on the card).
PHI3_FACTORS = 48  # rotary dims / 2 of head dim 96
FAMILY_MODELS = {
    "qwen2.5-7b": ("Qwen/Qwen2.5-7B", {
        "model_type": "qwen2", "hidden_act": "silu", "hidden_size": 3584, "intermediate_size": 18944,
        "max_position_embeddings": 131072, "num_attention_heads": 28, "num_key_value_heads": 4,
        "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "sliding_window": 131072, "use_sliding_window": False,
        "tie_word_embeddings": False, "vocab_size": 152064}, "flash"),
    "qwen3-8b": ("Qwen/Qwen3-8B", {
        "model_type": "qwen3", "attention_bias": False, "head_dim": 128, "hidden_act": "silu", "hidden_size": 4096,
        "intermediate_size": 12288, "max_position_embeddings": 40960, "num_attention_heads": 32,
        "num_key_value_heads": 8, "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000,
        "sliding_window": None, "use_sliding_window": False, "tie_word_embeddings": False, "vocab_size": 151936},
        "flash"),
    "mistral-7b-v0.1": ("mistralai/Mistral-7B-v0.1", {
        "model_type": "mistral", "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
        "max_position_embeddings": 32768, "num_attention_heads": 32, "num_key_value_heads": 8,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 4096, "tie_word_embeddings": False,
        "vocab_size": 32000}, "flash"),
    "gemma-2-9b": ("google/gemma-2-9b", {
        "model_type": "gemma2", "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "head_dim": 256,
        "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
        "intermediate_size": 14336, "max_position_embeddings": 8192, "num_attention_heads": 16,
        "num_key_value_heads": 8, "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
        "sliding_window": 4096, "vocab_size": 256000}, "einsum"),
    # the cut keeps the published 5:1 pattern's layers 6 and 7 (a local and
    # the global one), so both rope tables and both masks are used
    "gemma-3-1b": ("google/gemma-3-1b-pt", {
        "model_type": "gemma3_text", "attn_logit_softcapping": None, "final_logit_softcapping": None,
        "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 1152, "intermediate_size": 6912,
        "max_position_embeddings": 32768, "num_attention_heads": 4, "num_key_value_heads": 1,
        "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06, "rope_local_base_freq": 10000, "rope_scaling": None,
        "rope_theta": 1000000, "sliding_window": 512, "sliding_window_pattern": 6,
        "layer_types": ["sliding_attention", "full_attention"], "vocab_size": 262144}, "einsum"),
    # the published long/short factor lists are not in the repo: 48-entry
    # ramps of their shape stand in (short about 1, long rising to 64)
    "phi-3-mini-128k": ("microsoft/Phi-3-mini-128k-instruct", {
        "model_type": "phi3", "hidden_act": "silu", "hidden_size": 3072, "intermediate_size": 8192,
        "max_position_embeddings": 131072, "original_max_position_embeddings": 4096, "num_attention_heads": 32,
        "num_key_value_heads": 32, "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 262144,
        "rope_scaling": {"type": "longrope",
                         "short_factor": [1.0 + 0.2 * i / (PHI3_FACTORS - 1) for i in range(PHI3_FACTORS)],
                         "long_factor": [1.08 * (64.84 / 1.08) ** (i / (PHI3_FACTORS - 1)) for i in
                                         range(PHI3_FACTORS)]},
        "tie_word_embeddings": False, "eos_token_id": 32000, "vocab_size": 32064}, "einsum"),
    "olmo-2-7b": ("allenai/OLMo-2-1124-7B", {
        "model_type": "olmo2", "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 11008,
        "max_position_embeddings": 4096, "num_attention_heads": 32, "num_key_value_heads": 32,
        "rms_norm_eps": 1e-06, "rope_theta": 500000, "tie_word_embeddings": False, "vocab_size": 100352}, "flash"),
    # the cut keeps the published pattern's layers 3 and 4 (NoPE every 4th)
    "smollm3-3b": ("HuggingFaceTB/SmolLM3-3B", {
        "model_type": "smollm3", "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 11008,
        "max_position_embeddings": 65536, "no_rope_layer_interval": 4, "no_rope_layers": [1, 0],
        "num_attention_heads": 16, "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_theta": 5000000.0,
        "sliding_window": None, "use_sliding_window": False, "tie_word_embeddings": True, "vocab_size": 128256},
        "flash"),
    "glm-4-9b-0414": ("THUDM/GLM-4-9B-0414", {
        "model_type": "glm4", "attention_bias": True, "head_dim": 128, "hidden_act": "silu", "hidden_size": 4096,
        "intermediate_size": 13696, "max_position_embeddings": 32768, "num_attention_heads": 32,
        "num_key_value_heads": 2, "partial_rotary_factor": 0.5, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "vocab_size": 151552}, "flash"),
}
FAMILY_NEW = 8  # greedy tokens a model
MISTRAL_PROMPT = 4200  # past the 4096-token window
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def card_quantize(torch, w):
    """The loader's int4 arithmetic (models/quant.quantize) on the card:
    per-channel absmax / 7 scales, split-half nibbles."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=1, keepdim=True) / 7.0).clamp_min_(1e-12)
    q = torch.round(w32 / scale).clamp_(-7, 7).to(torch.int8)
    u = (q + 8).to(torch.uint8)
    h = u.shape[1] // 2
    return {"q": u[:, :h] | (u[:, h:] << 4), "scale": scale}


def phi3_checkpoint_tensors(torch, params):
    """The params under Phi-3's HF checkpoint names: q/k/v fused row-wise
    into qkv_proj, gate/up into gate_up_proj."""
    out = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"],
           "lm_head.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        out[p + "self_attn.qkv_proj.weight"] = torch.cat([layer["q_proj"], layer["k_proj"], layer["v_proj"]])
        out[p + "self_attn.o_proj.weight"] = layer["o_proj"]
        out[p + "mlp.gate_up_proj.weight"] = torch.cat([layer["gate_proj"], layer["up_proj"]])
        out[p + "mlp.down_proj.weight"] = layer["down_proj"]
        for key in ("input_layernorm", "post_attention_layernorm"):
            out[f"{p}{key}.weight"] = layer[key]
    return {k: v.contiguous().cpu() for k, v in out.items()}


def projections(layer):
    """A decoder layer's seven Projection modules, in PROJECTIONS order."""
    return [getattr(layer.self_attn if key in PROJECTIONS[:4] else layer.mlp, key) for key in PROJECTIONS]


def family_step_check(torch, qk, ak, engine, prompt: str, tag: str, route: str, gemvs: int = 7 * LAYERS):
    """One decode step after ``prompt``'s prefill through the kernels and
    again with both on their plain versions: every projection launches the
    GEMV (``gemvs`` launches), the attention takes ``route``, the logits
    agree within 2e-2; the kernel's attention is also held to the plain
    version on the step's own inputs. Returns (logits relL2, attention
    relL2 or None, the step's masks' valid slots, the logits' max-abs
    gap)."""
    from shardmerge_tpu_torch.models import llama

    model, cfg, dev = engine.model, engine.cfg, engine.device
    ids = torch.tensor([StubTokenizer().encode(prompt)], device=dev)
    T = ids.shape[1]
    cache = -(-(T + 1) // 256) * 256
    rope = llama.rope_tables(cfg, cache, dev)
    kv = llama.init_kv_cache(cfg, 1, cache, model.dtype, dev)
    seen = []
    kernel = ak.flash_decode

    def recording(*args, **kw):
        seen.append((args, kw))
        return kernel(*args, **kw)

    with torch.inference_mode():
        pids, ppos = engine._pad_prompt(StubTokenizer().encode(prompt), cache)
        last, kv = engine._chunked_prefill(pids, ppos, kv, rope, T, keep_pos=T - 1)
        tok = last.argmax(-1)[:, None]
        step_pos = torch.full((1, 1), T, device=dev)
        kv_plain = {k: v.clone() for k, v in kv.items()}
        reset_counts(qk, ak)
        with mock.patch.object(ak, "flash_decode", recording):
            with_kernel, _ = model(tok, step_pos, kv, T, rope, T + 1)
        counts = dict(qk.launch_counts) | dict(ak.launch_counts)
        with mock.patch.object(llama, "dequant_matmul", lambda x, wq: qk.int4_matmul_plain(x, wq["q"], wq["scale"])), \
                mock.patch.object(ak, "flash_decode", lambda q, k, v, m, slots=None: ak.flash_decode_plain(q, k, v, m)):
            with_plain, _ = model(tok, step_pos, kv_plain, T, rope, T + 1)
        attn = max((rel_l2(kernel(*a, **kw), ak.flash_decode_plain(*a)) for a, kw in seen), default=None)
        valid = sorted({int((a[3] > -1e8).sum()) for a, _ in seen})
    if counts.get("int4_gemv", 0) != gemvs:
        raise SystemExit(f"{tag} decode step did not run the GEMV for every projection ({gemvs}): {counts}")
    if route == "flash" and counts.get("flash_decode", 0) != LAYERS:
        raise SystemExit(f"{tag} decode step did not run the flash kernel in every layer: {counts}")
    if route == "einsum" and (counts.get("decode_einsum", 0) != LAYERS or counts.get("flash_decode", 0)):
        raise SystemExit(f"{tag} decode step did not take the counted einsum path: {counts}")
    rel = rel_l2(with_kernel.float(), with_plain.float())
    if rel > 2e-2 or not bool(torch.isfinite(with_kernel).all()) or (attn is not None and attn > 1e-5):
        raise SystemExit(f"{tag} decode step disagrees with the plain route: logits {rel:.2e}, attention {attn}")
    return rel, attn, valid, float((with_kernel.float() - with_plain.float()).abs().max())


def phi3_cli(torch, root: Path, ex):
    """Phi-3 through the generate CLI: [families]' seeded bf16 weights written
    as a fused qkv_proj/gate_up_proj checkpoint in HF naming, ``generate -4
    --greedy`` submitted to ``ex`` and left running, the in-memory model's
    tokens (host int4 of the same weights) taken meanwhile. Returns
    ``finish()``: waits for the process and fails unless it printed those
    tokens."""
    from shardmerge_tpu_torch.inference import InferenceEngine, load_tokenizer
    from shardmerge_tpu_torch.io.safetensors_io import save_file
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models.quant import quantize

    name = next(n for n in FAMILY_MODELS if n.startswith("phi-3"))
    hf = FAMILY_MODELS[name][1]
    dev = torch.device(CARD)
    cfg = llama.ModelConfig.from_hf_config({**hf, "num_hidden_layers": LAYERS})
    bf16 = llama.init_params(cfg, seed=20 + list(FAMILY_MODELS).index(name), dtype=torch.bfloat16, device=dev)
    phi = root / "phi3"
    phi.mkdir()
    save_file(phi3_checkpoint_tensors(torch, bf16), phi / "model.safetensors")
    (phi / "config.json").write_text(json.dumps({**hf, "num_hidden_layers": LAYERS,
                                                 "architectures": ["Phi3ForCausalLM"]}))
    write_word_tokenizer(phi, cfg.vocab_size)
    words = " ".join(f"w{7 + 13 * i}" for i in range(24))
    run = ex.submit(port_cli, ["generate", phi, words, "-4", "--greedy", "--max-tokens", FAMILY_NEW])
    host_q = {**bf16, "layers": [{**layer, **{k: {t: v.to(dev) for t, v in quantize(layer[k], 4).items()}
                                             for k in PROJECTIONS}} for layer in bf16["layers"]]}
    mem = InferenceEngine(cfg, llama.LlamaModel(cfg, host_q), load_tokenizer(phi, phi))
    want = "".join(mem.stream_generation(words, max_new_tokens=FAMILY_NEW, greedy=True))
    del mem, host_q, bf16
    torch.cuda.empty_cache()

    def finish():
        out, wall = run.result()
        say(f"[families] phi-3 through the CLI: generate -4 --greedy from a fused qkv_proj/gate_up_proj "
            f"checkpoint in {wall:.1f} s (process, beside [families] and [experts]): {out.strip()!r}; the "
            f"in-memory model (host int4 of the same weights): {want!r}")
        if out.rstrip("\n") != want:
            raise SystemExit("[families] phi-3: the CLI's tokens differ from the in-memory model's")
        shutil.rmtree(phi)

    return finish


def phase_families(torch, root: Path, card: str, ex):
    """Every dense family at its published widths on the card: 8 greedy
    int4 tokens, one decode step against the plain route, the GEMV at each
    new (N, K), the decode attention's route; Qwen2.5-7B's layer of GEMVs
    timed; Phi-3 also through the generate CLI from a fused checkpoint
    (:func:`phi3_cli`, started first on ``ex``). Returns the CLI's
    ``finish``."""
    from scripts.bench_int4_torch import graph_ms, library_int4
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk

    t_phase = time.perf_counter()
    phi3_done = phi3_cli(torch, root, ex)
    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)
    launches = {"int4_gemv": 0, "flash_decode": 0, "decode_einsum": 0}
    gemv_checked = set()
    for seed, (name, (repo, hf, route)) in enumerate(FAMILY_MODELS.items()):
        t0 = time.perf_counter()
        cfg = llama.ModelConfig.from_hf_config({**hf, "num_hidden_layers": LAYERS})
        params = llama.init_params(cfg, seed=20 + seed, dtype=torch.bfloat16, device=dev)
        for layer in params["layers"]:
            for key in PROJECTIONS:
                layer[key] = card_quantize(torch, layer[key])
        engine = InferenceEngine(cfg, llama.LlamaModel(cfg, params), StubTokenizer())
        prompt = text_of(MISTRAL_PROMPT if name.startswith("mistral") else 100, 60 + seed)
        reset_counts(qk, ak)
        text = "".join(engine.stream_generation(prompt, max_new_tokens=FAMILY_NEW, greedy=True))
        torch.cuda.synchronize()
        counts = {k: ak.launch_counts.get(k, 0) for k in ("flash_decode", "flash_compact", "decode_einsum")}
        counts["int4_gemv"] = qk.launch_counts["int4_gemv"]
        for k in launches:
            launches[k] += counts[k]
        steps = FAMILY_NEW  # decode forwards of the stream (the last one's logits unread)
        want_attn = {"flash": {"flash_decode": LAYERS * steps, "decode_einsum": 0},
                     "einsum": {"flash_decode": 0, "decode_einsum": LAYERS * steps}}[route]
        if len(text) != FAMILY_NEW or counts["int4_gemv"] != 7 * LAYERS * steps or any(
                counts[k] != v for k, v in want_attn.items()):
            raise SystemExit(f"[families] {name}: {len(text)} tokens, launches {counts} (want {want_attn}, "
                             f"int4_gemv {7 * LAYERS * steps})")
        if route == "flash" and counts["flash_decode"] != LAYERS * counts["flash_compact"]:
            # one slot list a step for the one mask kind its layers use
            raise SystemExit(f"[families] {name}: slot lists not compacted once a step per mask kind: {counts}")
        rel, attn, valid, _ = family_step_check(torch, qk, ak, engine, prompt, f"[families] {name}", route)
        # the GEMV at each (N, K) not held yet, B = 1 and 8
        worst = 0.0
        for proj in projections(engine.model.layers[0]):
            n, kh = proj.q.shape
            if (n, 2 * kh) in gemv_checked:
                continue
            gemv_checked.add((n, 2 * kh))
            for b in (1, 8):
                x = torch.randn((b, 2 * kh), device=dev, generator=gen).to(torch.bfloat16)
                worst = max(worst, rel_l2(qk.int4_matmul(x, proj.q, proj.scale).float(),
                                          qk.int4_matmul_plain(x, proj.q, proj.scale).float()))
        if worst > 4e-3:
            raise SystemExit(f"[families] {name}: the GEMV leaves 4e-3 of its plain version ({worst:.2e})")
        say(f"[families] {name} ({repo}, {LAYERS} layers, int4): {FAMILY_NEW} greedy tokens after a "
            f"{len(prompt)}-token prompt; launches {counts}; decode step vs plain route: logits relL2 {rel:.2e} "
            f"(tol 2e-2), attention " + (f"relL2 {attn:.2e} (tol 1e-5), valid slots a row {valid}" if attn is not None
                                         else f"on the counted einsum path") + f"; GEMV at its new (N, K) relL2 <= "
            f"{worst:.2e} (tol 4e-3); {time.perf_counter() - t0:.1f} s")
        if name.startswith("mistral") and not (valid and max(valid) < len(prompt) + 1):
            raise SystemExit(f"[families] mistral: the sliding window masked no slot ({valid})")
        if name.startswith("qwen2.5"):
            # one layer's seven GEMVs at B = 1 and 8: device time, plain, library, bound
            projs = projections(engine.model.layers[0])
            shapes = [(p.q.shape[0], 2 * p.q.shape[1]) for p in projs]
            for b in (1, 8):
                xs = [torch.randn((b, k), device=dev, generator=gen).to(torch.bfloat16) for _, k in shapes]
                ms = sum(graph_ms(torch, lambda x=x, p=p: qk.int4_matmul(x, p.q, p.scale), flush)
                         for x, p in zip(xs, projs))
                plain = sum(graph_ms(torch, lambda x=x, p=p: qk.int4_matmul_plain(x, p.q, p.scale), flush)
                            for x, p in zip(xs, projs))
                libs = [library_int4(torch, p.q, p.scale)[0] for p in projs]
                lib = None if any(f is None for f in libs) else sum(
                    graph_ms(torch, lambda x=x, f=f: f(x), flush) for x, f in zip(xs, libs))
                bound_ms, bound_by = gemv_bound(b, shapes)
                say(f"[families] Qwen2.5-7B one layer's 7 int4 GEMVs at B={b} ({card}; CUDA-graph device time, L2 "
                    f"flushed): kernel {ms:.4f} ms, plain {plain:.4f} ms, library int4 "
                    f"{'not run' if lib is None else f'{lib:.4f} ms'}, bound {bound_ms:.4f} ms ({bound_by})")
        del engine, params
        torch.cuda.empty_cache()
    del flush
    say(f"[families] launches over the nine models' decodes: {launches}")
    return phi3_done
    say(f"[families] phase wall {time.perf_counter() - t_phase:.1f} s")


# [experts]: the expert and latent-attention families from their public
# config.json values at published widths, num_hidden_layers cut to 2 (and
# DeepSeek-V3's first_k_dense_replace from 3 to 1, so that one dense and
# one MoE layer remain; its fp8 quantization_config is left out: the weights
# are seeded random), random weights made and int4-quantized matrix by
# matrix on the card. Each entry: (repository, config, the decode
# attention's route, int4 GEMVs a decode step: the attention projections,
# every expert's three (the dense-and-mask loop runs all of them), the
# shared or dense MLP's three; kv_b_proj is dequantized at use).
MIXTRAL_HF = {
    "model_type": "mixtral", "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "num_attention_heads": 32, "num_experts_per_tok": 2,
    "num_key_value_heads": 8, "num_local_experts": 8, "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
    "sliding_window": None, "tie_word_embeddings": False, "vocab_size": 32000}
DSV2_LITE_HF = {
    "model_type": "deepseek_v2", "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 10944, "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "moe_intermediate_size": 1408, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "norm_topk_prob": False, "num_attention_heads": 16, "num_experts_per_tok": 6, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096, "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1.0, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "v_head_dim": 128, "eos_token_id": 100001, "vocab_size": 102400}
EXPERT_MODELS = {
    "mixtral-8x7b": ("mistralai/Mixtral-8x7B-v0.1", MIXTRAL_HF, "flash", LAYERS * (4 + 8 * 3)),
    "qwen3-30b-a3b": ("Qwen/Qwen3-30B-A3B", {
        "model_type": "qwen3_moe", "attention_bias": False, "head_dim": 128, "hidden_act": "silu",
        "hidden_size": 2048, "intermediate_size": 6144, "max_position_embeddings": 40960, "mlp_only_layers": [],
        "moe_intermediate_size": 768, "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
        "num_experts_per_tok": 8, "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_scaling": None,
        "rope_theta": 1000000.0, "sliding_window": None, "use_sliding_window": False, "tie_word_embeddings": False,
        "vocab_size": 151936}, "flash", LAYERS * (4 + 128 * 3)),
    "deepseek-v2-lite": ("deepseek-ai/DeepSeek-V2-Lite", DSV2_LITE_HF, "einsum", (3 + 3) + (3 + 64 * 3 + 3)),
    "deepseek-v3": ("deepseek-ai/DeepSeek-V3", {
        "model_type": "deepseek_v3", "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 7168,
        "intermediate_size": 18432, "kv_lora_rank": 512, "max_position_embeddings": 163840,
        "moe_intermediate_size": 2048, "n_group": 8, "n_routed_experts": 256, "n_shared_experts": 1,
        "norm_topk_prob": True, "num_attention_heads": 128, "num_experts_per_tok": 8, "num_key_value_heads": 128,
        "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0,
                         "original_max_position_embeddings": 4096, "type": "yarn"},
        "rope_theta": 10000, "routed_scaling_factor": 2.5, "tie_word_embeddings": False, "topk_group": 4,
        "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 129280}, "einsum", (4 + 3) + (4 + 256 * 3 + 3)),
}
EXPERT_PROMPT = 100  # prompt tokens before the 8 greedy ones
# the pools: (cache slots, 6 staggered greedy requests (prompt tokens,
# max_tokens, pool steps driven before the next submit)) over 4 slots;
# V2-Lite's long-lived rows fill a cache just over the largest need
# (472 <= 512), so its latent rows compact
EXPERT_POOL_SLOTS = 4
EXPERT_POOLS = {
    "mixtral-8x7b": (1024, [(300, 24, 6), (120, 32, 3), (250, 16, 0), (60, 40, 4), (200, 24, 2), (90, 32, 0)]),
    "deepseek-v2-lite": (512, [(380, 64, 2), (120, 100, 2), (250, 80, 0), (300, 90, 1), (60, 100, 2), (400, 72, 0)]),
}
# V2-Lite's chat template in its word-level vocabulary
DSV2_TEMPLATE = ("{% for m in messages %}w5 {{ m['content'] }} w6 {% endfor %}"
                 "{% if add_generation_prompt %}w7{% endif %}")


def hf_tensors(params):
    """Port params of a DeepSeek-V2 model under the HF checkpoint names
    (MLA, the dense first layer, routed and shared experts)."""
    names = {"q_proj": "self_attn.q_proj", "kv_a_proj": "self_attn.kv_a_proj_with_mqa",
             "kv_a_layernorm": "self_attn.kv_a_layernorm", "kv_b_proj": "self_attn.kv_b_proj",
             "o_proj": "self_attn.o_proj", "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj", "moe_gate": "mlp.gate", "shared_gate_proj": "mlp.shared_experts.gate_proj",
             "shared_up_proj": "mlp.shared_experts.up_proj", "shared_down_proj": "mlp.shared_experts.down_proj",
             "input_layernorm": "input_layernorm", "post_attention_layernorm": "post_attention_layernorm"}
    out = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"],
           "lm_head.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        for key, value in layer.items():
            if key == "experts":
                for e, ex in enumerate(value):
                    for w, hf in (("w1", "gate_proj"), ("w3", "up_proj"), ("w2", "down_proj")):
                        out[f"{p}mlp.experts.{e}.{hf}.weight"] = ex[w]
            else:
                out[f"{p}{names[key]}.weight"] = value
    return {k: v.contiguous().cpu() for k, v in out.items()}


def path_projections(model):
    """The quantized Projection modules whose products run at decode (every
    one but MLA's kv_b_proj, which is dequantized at use)."""
    from shardmerge_tpu_torch.models import llama

    return [m for name, m in model.named_modules()
            if isinstance(m, llama.Projection) and m.q is not None and not name.endswith("kv_b_proj")]


def expert_pool(torch, engine, name: str):
    """A pool of EXPERT_POOL_SLOTS rows over EXPERT_POOLS[name], staggered:
    every completion equals its solo stream, or first differs at a near-tie
    of the plain route (the largest verify-vs-T=1 gap over the solo
    stream's tokens, as the speculative pools' rule)."""
    from shardmerge_tpu_torch.batching import ContinuousEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import quant_kernels as qk

    cache_len, requests = EXPERT_POOLS[name]
    pool = ContinuousEngine(engine, slots=EXPERT_POOL_SLOTS, cache_len=cache_len, greedy=True, use_template=False)
    reqs = [(text_of(n, 500 + i), m) for i, (n, m, _) in enumerate(requests)]
    reset_counts(qk, ak)
    t0 = time.perf_counter()
    handles = []
    for (p, m), (_, _, after) in zip(reqs, requests):
        handles.append(pool.submit(p, max_new_tokens=m, repetition_penalty=1.0))
        pool._admit_pending()
        for _ in range(after):
            if pool._active():
                pool._step()
            pool._admit_pending()
    pool.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ak.launch_counts.get(k, 0) for k in ("flash_decode", "flash_compact", "decode_einsum")}
    counts["int4_gemv"] = qk.launch_counts["int4_gemv"]
    notes = []
    for (p, m), h in zip(reqs, handles):
        solo = token_ids("".join(engine.stream_generation(p, max_new_tokens=m, greedy=True, repetition_penalty=1.0)))
        got = token_ids(h.result())
        if got != solo:
            steps, _, gap, _ = replay(torch, engine, IdTokenizer().encode(p), solo)
            notes.append(near_tie_check(f"[experts] {name} pool completion", got, solo, steps, [], gap)[1])
    say(f"[experts] {name} pool, {EXPERT_POOL_SLOTS} slots x {cache_len} cache slots, {len(reqs)} staggered greedy "
        f"requests in {wall:.2f} s: joins {pool.stats['joins']}, frontier jumps {pool.stats['frontier_jumps']}, "
        f"compactions {pool.stats['compactions']}, decode dispatches {pool.stats['decode_dispatches']}; launches "
        f"{counts}; completions vs their solo streams: {len(reqs) - len(notes)} of {len(reqs)} equal"
        + (f" ({'; '.join(notes)})" if notes else ""))
    if engine.cfg.is_mla and not pool.stats["compactions"]:
        raise SystemExit(f"[experts] {name} pool: the latent rows never compacted")


def expert_cli(torch, root: Path, params, cfg, hf: dict, dev):
    """DeepSeek-V2-Lite through the CLI: the bf16 params written as an HF
    checkpoint with a word-level tokenizer whose tokenizer_config.json
    carries a chat template and an EOS token; ``generate -4 --greedy`` and
    ``--decode-chunk 4`` must print the in-memory engine's tokens (the same
    weights int4-quantized on the host as the loader does, the tokenizer
    through the CLI's loader, the template on)."""
    from shardmerge_tpu_torch.inference import InferenceEngine, load_tokenizer
    from shardmerge_tpu_torch.io.safetensors_io import save_file
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models.quant import quantize

    path = root / "dsv2lite"
    path.mkdir()
    t0 = time.perf_counter()
    save_file(hf_tensors(params), path / "model.safetensors")
    (path / "config.json").write_text(json.dumps({**hf, "num_hidden_layers": LAYERS,
                                                  "architectures": ["DeepseekV2ForCausalLM"]}))
    write_word_tokenizer(path, cfg.vocab_size, chat_template=DSV2_TEMPLATE, eos_token=f"w{hf['eos_token_id']}")
    written = time.perf_counter() - t0
    words = " ".join(f"w{11 + 37 * i}" for i in range(24))
    with ThreadPoolExecutor(2) as ex:  # the two processes side by side
        outs = dict(zip((1, 4), ex.map(lambda chunk: port_cli(
            ["generate", path, words, "-4", "--greedy", "--max-tokens", FAMILY_NEW, "--decode-chunk", chunk]),
            (1, 4))))

    def host_int4(w):
        return {t: v.to(dev) for t, v in quantize(w, 4).items()}

    host_q = {**params, "layers": [
        {k: ([{w: host_int4(m) for w, m in e.items()} for e in v] if k == "experts"
             else host_int4(v) if k in llama.QUANTIZABLE else v) for k, v in layer.items()}
        for layer in params["layers"]]}
    mem = InferenceEngine(cfg, llama.LlamaModel(cfg, host_q), load_tokenizer(path, path))
    ids = mem._encode(words, True, None, None)
    want = "".join(mem.stream_generation(words, max_new_tokens=FAMILY_NEW, greedy=True))
    say(f"[experts] deepseek-v2-lite through the CLI ({written:.1f} s to write the checkpoint): generate -4 --greedy "
        f"{outs[1][1]:.1f} s, --decode-chunk 4 {outs[4][1]:.1f} s (side by side): {outs[1][0].strip()!r} / "
        f"{outs[4][0].strip()!r}; "
        f"the in-memory engine (host int4 of the same weights, the chat template rendered to {len(ids)} ids, EOS "
        f"{sorted(mem._eos_ids())}): {want!r}")
    if len(ids) != 24 + 3 or mem._eos_ids() != {hf["eos_token_id"]}:
        raise SystemExit(f"[experts] deepseek-v2-lite: the template or EOS did not come through ({ids}, "
                         f"{mem._eos_ids()})")
    if any(out.rstrip("\n") != want for out, _ in outs.values()):
        raise SystemExit("[experts] deepseek-v2-lite: the CLI's tokens differ from the in-memory engine's")
    shutil.rmtree(path)


def expert_prefix_hit(torch, engine, name: str):
    """V2-Lite's prefix cache: two requests sharing a 300-token prefix; the
    second implants 256 slots of the first's ckv/kpe slab, which must be
    bit-equal to the plain prefill's latents; its tokens are held to a cold
    engine's under the near-tie rule."""
    from shardmerge_tpu_torch.inference import InferenceEngine, _slice_kv
    from shardmerge_tpu_torch.models import llama

    cached = InferenceEngine(engine.cfg, engine.model, IdTokenizer(), prefix_cache_slots=4)
    shared = text_of(300, 77)
    prompts = [shared + text_of(40, 78), shared + text_of(60, 79)]
    metas = [{}, {}]
    outs = [token_ids("".join(cached.stream_generation(p, max_new_tokens=FAMILY_NEW, greedy=True, meta=meta,
                                                       repetition_penalty=1.0)))
            for p, meta in zip(prompts, metas)]
    hits = [m["prefix_cache_hit_tokens"] for m in metas]
    ids = IdTokenizer().encode(prompts[0])
    key = ("t", tuple(ids[: (len(ids) - 1) // 64 * 64]))  # the first prompt's stored slab
    slab, nbytes = cached._prefix_cache[key]
    cache = -(-(len(ids) + FAMILY_NEW) // 256) * 256
    kv = engine._init_kv(1, cache)
    with torch.inference_mode():
        pids, ppos = engine._pad_prompt(ids, cache)
        engine._chunked_prefill(pids, ppos, kv, llama.rope_tables(engine.cfg, cache, engine.device), len(ids))
    plain = _slice_kv(kv, len(key[1]))
    equal = {k: bool(torch.equal(slab[k], plain[k])) for k in ("ckv", "kpe")}
    cold = token_ids("".join(engine.stream_generation(prompts[1], max_new_tokens=FAMILY_NEW, greedy=True,
                                                      repetition_penalty=1.0)))
    note = "equal"
    if outs[1] != cold:
        steps, _, gap, _ = replay(torch, engine, IdTokenizer().encode(prompts[1]), cold)
        note = near_tie_check(f"[experts] {name} prefix hit", outs[1], cold, steps, [], gap)[1]
    say(f"[experts] {name} prefix cache: hits {hits}, a {len(key[1])}-slot slab of {nbytes} bytes; its ckv/kpe "
        f"bit-equal to the plain prefill's: {equal}; the hit's tokens vs a cold engine's: {note}")
    if hits != [0, 256] or not all(equal.values()):
        raise SystemExit(f"[experts] {name}: prefix cache hits {hits}, slab equal to the plain prefill {equal}")


def phase_experts(torch, root: Path, card: str, lease: CardLease, waits=()):
    """The expert and latent-attention families at published widths on the
    card: 8 greedy int4 tokens a model, one decode step against the plain
    route, the launches against EXPERT_MODELS' counts, the GEMV at each new
    (N, K); pools of Mixtral (flash slot lists) and V2-Lite (latent rows
    compacting), V2-Lite's prefix cache and its CLI; then the capacity
    route. DeepSeek-V3 and the capacity route hold ``lease``. The
    ``finish`` callables in ``waits`` (CLI runs started before the phase)
    are called at the end. Returns the capacity route's flash-decode
    launches."""
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk

    t_phase = time.perf_counter()
    dev = torch.device(CARD)
    torch.empty(0, device=dev)  # the allocator's memory statistics need it started
    gen = torch.Generator(device=dev).manual_seed(6)
    launches = {"int4_gemv": 0, "flash_decode": 0, "decode_einsum": 0}
    gemv_checked = set()
    for seed, (name, (repo, hf, route, gemvs)) in enumerate(EXPERT_MODELS.items()):
        if name == "deepseek-v3":
            lease.take()
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = llama.ModelConfig.from_hf_config({**hf, "num_hidden_layers": LAYERS})
        cli = name == "deepseek-v2-lite"
        # V2-Lite keeps its bf16 weights for the checkpoint the CLI reads
        params = llama.init_params(cfg, seed=40 + seed, dtype=torch.bfloat16, device=dev,
                                   project=None if cli else (lambda w: card_quantize(torch, w)))
        if cli:
            bf16 = params
            params = {**bf16, "layers": [
                {k: ([{w: card_quantize(torch, m) for w, m in e.items()} for e in v] if k == "experts"
                     else card_quantize(torch, v) if k in llama.QUANTIZABLE else v) for k, v in layer.items()}
                for layer in bf16["layers"]]}
        engine = InferenceEngine(cfg, llama.LlamaModel(cfg, params), StubTokenizer())
        built = time.perf_counter() - t0
        memory = torch.cuda.memory_allocated(dev)
        prompt = text_of(EXPERT_PROMPT, 80 + seed)
        reset_counts(qk, ak)
        t1 = time.perf_counter()
        text = "".join(engine.stream_generation(prompt, max_new_tokens=FAMILY_NEW, greedy=True))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t1
        counts = {k: ak.launch_counts.get(k, 0) for k in ("flash_decode", "flash_compact", "decode_einsum")}
        counts["int4_gemv"] = qk.launch_counts["int4_gemv"]
        for k in launches:
            launches[k] += counts[k]
        steps = FAMILY_NEW
        want_attn = {"flash": {"flash_decode": LAYERS * steps, "decode_einsum": 0},
                     "einsum": {"flash_decode": 0, "decode_einsum": LAYERS * steps}}[route]
        if len(text) != FAMILY_NEW or counts["int4_gemv"] != gemvs * steps or any(
                counts[k] != v for k, v in want_attn.items()):
            raise SystemExit(f"[experts] {name}: {len(text)} tokens, launches {counts} (want {want_attn}, "
                             f"int4_gemv {gemvs * steps})")
        if route == "flash" and counts["flash_decode"] != LAYERS * counts["flash_compact"]:
            raise SystemExit(f"[experts] {name}: slot lists not compacted once a step: {counts}")
        if route == "einsum" and counts["flash_compact"]:
            raise SystemExit(f"[experts] {name}: a slot list was built for latent attention: {counts}")
        rel, attn, _, gap = family_step_check(torch, qk, ak, engine, prompt, f"[experts] {name}", route, gemvs)
        worst, new = 0.0, []
        for proj in path_projections(engine.model):
            n, kh = proj.q.shape
            if (n, 2 * kh) in gemv_checked:
                continue
            gemv_checked.add((n, 2 * kh))
            new.append((n, 2 * kh))
            for b in (1, 8):
                x = torch.randn((b, 2 * kh), device=dev, generator=gen).to(torch.bfloat16)
                worst = max(worst, rel_l2(qk.int4_matmul(x, proj.q, proj.scale).float(),
                                          qk.int4_matmul_plain(x, proj.q, proj.scale).float()))
        if worst > 4e-3:
            raise SystemExit(f"[experts] {name}: the GEMV leaves 4e-3 of its plain version ({worst:.2e})")
        say(f"[experts] {name} ({repo}, {LAYERS} layers, int4): {FAMILY_NEW} greedy tokens after a "
            f"{len(prompt)}-token prompt in {stream_s:.2f} s; launches {counts} ({gemvs} GEMVs a decode step); "
            f"decode step vs plain route: logits relL2 {rel:.2e} (tol 2e-2, max-abs {gap:.3e}), attention "
            + (f"relL2 {attn:.2e} (tol 1e-5)" if attn is not None else "on the counted einsum path")
            + f"; GEMV at {len(new)} new (N, K) {new} relL2 <= {worst:.2e} (tol 4e-3); card memory "
            f"{memory / 2**30:.2f} GiB (peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}), built in "
            f"{built:.1f} s; {time.perf_counter() - t0:.1f} s")
        if name in EXPERT_POOLS:
            engine.tokenizer = IdTokenizer()
            expert_pool(torch, engine, name)
        if cli:
            expert_prefix_hit(torch, engine, name)
            expert_cli(torch, root, bf16, cfg, hf, dev)
            del bf16
        del engine, params
        torch.cuda.empty_cache()
        lease.drop()
    say(f"[experts] launches over the four models' streams: {launches}")
    lease.take()
    capacity_launches = experts_capacity(torch, ak, card)
    lease.drop()
    t_wait = time.perf_counter()
    for finish in waits:
        finish()
    waited = time.perf_counter() - t_wait
    say(f"[experts] phase wall {time.perf_counter() - t_phase:.1f} s (Phi-3's CLI waited for {waited:.1f} s at its "
        f"end)")
    return capacity_launches


def experts_capacity(torch, ak, card: str) -> int:
    """[experts]' capacity route: Mixtral-8x7B at published widths, 2
    layers, bf16 (the capacity dispatch takes raw experts), one set of
    weights served by the dense-and-mask engine and by engines with
    ``moe_dispatch="capacity"`` (which stack the experts once) at the full
    capacity (factor n_exp / k: no token dropped) and at the default 1.25.
    The routes round their bf16 products apart, so a token whose router
    top-k is nearly tied can pick other experts in a later layer: such a
    flip is found by routing both routes' layer inputs, and its margin (the
    dense router's k-th minus (k+1)-th probability) reported. Gates: the
    engines stacked; every decode step's attention on the flash kernel
    (layers x tokens launches, counted on the capacity route); at full
    capacity nothing dropped, the teacher-forced logits within relL2 2e-2
    of the dense route's at every position without a flip, every flip a
    near-tie (margin <= 1e-2), and the greedy tokens the dense route's up to
    a near-tie (a first differing token within the routes' logit gap of the
    dense best); at 1.25 finite logits and the drops of layer 0's prefill
    counted. (In f32 the full capacity equals dense-and-mask within relL2
    1e-5: tests/test_torch_cp_ep.py, and [ep]'s decode FFN.) Returns the
    flash launches of the capacity streams."""
    import dataclasses

    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import llama

    t0 = time.perf_counter()
    dev = torch.device(CARD)
    cfg = llama.ModelConfig.from_hf_config({**MIXTRAL_HF, "num_hidden_layers": LAYERS})
    k = cfg.num_experts_per_tok
    params = llama.init_params(cfg, seed=47, dtype=torch.bfloat16, device=dev)
    prompt = text_of(EXPERT_PROMPT, 90)
    ids = IdTokenizer().encode(prompt)

    def stream(engine):
        torch.cuda.synchronize()
        t = time.perf_counter()
        text = "".join(engine.stream_generation(prompt, max_new_tokens=FAMILY_NEW, greedy=True))
        torch.cuda.synchronize()
        return token_ids(text), (time.perf_counter() - t) * 1e3 / FAMILY_NEW

    def forced(model, seq):
        """Logits (T, V) of the whole sequence in one prefill-shaped call,
        and each MoE layer's input (T, hidden)."""
        inputs = []
        hooks = [layer.mlp.register_forward_pre_hook(lambda mod, args: inputs.append(args[0][0].detach()))
                 for layer in model.layers]
        x = torch.tensor([seq], device=dev)
        T = x.shape[1]
        kv = llama.init_kv_cache(cfg, 1, T, model.dtype, dev)
        with torch.inference_mode():
            logits, _ = model(x, torch.arange(T, device=dev)[None], kv, 0, llama.rope_tables(cfg, T, dev), T)
        for h in hooks:
            h.remove()
        return logits[0].float(), inputs

    dense_model = llama.LlamaModel(cfg, params)
    dense_tokens, dense_ms = stream(InferenceEngine(cfg, dense_model, IdTokenizer()))
    seq = ids + dense_tokens[:-1]
    dense_logits, dense_inputs = forced(dense_model, seq)
    gates = [layer.mlp.moe_gate for layer in dense_model.layers]
    del dense_model
    flash, lines, ok = 0, [], True
    for cf in (cfg.num_local_experts / k, 1.25):
        ccfg = dataclasses.replace(cfg, moe_dispatch="capacity", moe_capacity_factor=cf)
        model = llama.LlamaModel(ccfg, params)
        engine = InferenceEngine(ccfg, model, IdTokenizer())
        moes = [layer.mlp for layer in model.layers]
        stacked = all(m.stacks is not None and not len(m.experts) for m in moes)
        reset_counts(ak)
        tokens, ms = stream(engine)
        counts = {key: ak.launch_counts.get(key, 0) for key in ("flash_decode", "flash_compact")}
        flash += counts["flash_decode"]
        logits, inputs = forced(model, seq)
        T = len(seq)
        C = llama.capacity_of(ccfg, T, cf)
        idx, w = moes[0].route(inputs[0])
        kept = int((llama.capacity_tables_from_topk(idx, w, cfg.num_local_experts, C)[1] != 0).sum())
        flips, margin = set(), 0.0
        for gate, a, b in zip(gates, dense_inputs, inputs):  # the routes' top-k sets, layer by layer
            probs = torch.softmax(llama.matmul(a, gate).float(), dim=-1)
            top = llama.topk(probs, k + 1)[0]
            sel_a = llama.topk(probs, k)[1].sort(dim=-1)[0]
            sel_b = llama.topk(torch.softmax(llama.matmul(b, gate).float(), dim=-1), k)[1].sort(dim=-1)[0]
            for pos in (sel_a != sel_b).any(dim=-1).nonzero().flatten().tolist():
                flips.add(pos)
                margin = max(margin, float(top[pos, k - 1] - top[pos, k]))
        per = (logits - dense_logits).norm(dim=-1) / dense_logits.norm(dim=-1)
        steady = [pos for pos in range(T) if pos not in flips]
        rel = float((logits[steady] - dense_logits[steady]).norm() / dense_logits[steady].norm())
        worst = float(per[steady].max())
        gap = float((logits - dense_logits).abs().max())
        first = next((i for i, (a, b) in enumerate(zip(tokens, dense_tokens)) if a != b), None)
        tie = None
        if first is not None:  # the dense best's lead over the capacity route's token at that step
            row = dense_logits[len(ids) - 1 + first]
            tie = float(row[dense_tokens[first]] - row[tokens[first]])
        good = stacked and counts["flash_decode"] == LAYERS * FAMILY_NEW and bool(torch.isfinite(logits).all())
        if cf > 1.25:
            good &= kept == T * k and worst <= 2e-2 and margin <= 1e-2 and (tie is None or tie <= gap)
        ok &= good
        lines.append(f"factor {cf:g} (C = {C} of {T} teacher-forced tokens): experts stacked {stacked}; layer 0 kept "
                     f"{kept} of {T * k} assignments; launches {counts}; router top-k flips against the dense "
                     f"route at {len(flips)} positions {sorted(flips)[:8]} (largest dense margin {margin:.2e}); "
                     f"logits vs dense at the other positions relL2 {rel:.3e}, worst position {worst:.3e}; tokens "
                     + ("equal to the dense route's" if first is None else
                        f"first differ at step {first} (dense lead {tie:.3e}, logit gap {gap:.3e})")
                     + f"; stream {ms:.2f} ms a token {'ok' if good else 'FAIL'}")
        del engine, model, moes
        torch.cuda.empty_cache()
    say(f"[experts] capacity route, mixtral-8x7b (2 layers, bf16) against the dense route (stream {dense_ms:.2f} ms "
        f"a token, the process's first Mixtral products included): " + "; ".join(lines)
        + f"; {time.perf_counter() - t0:.1f} s on {card}")
    if not ok:
        raise SystemExit("[experts] the capacity route failed a gate: stacking, flash launches, drops at full "
                         "capacity, logits, routing near-ties or tokens against the dense route")
    del params, gates
    torch.cuda.empty_cache()
    return flash


# [sinks-chunked]: GPT-OSS and Llama-4 from their public configs at
# published widths, num_hidden_layers cut to 2.
# openai/gpt-oss-20b config.json (24 layers; layer_types kept for the two
# left: one sliding, one full). transformers' GptOssConfig() defaults are
# the 120B's: the same widths with 36 layers and 128 experts.
GPTOSS_20B_HF = {
    "model_type": "gpt_oss", "architectures": ["GptOssForCausalLM"], "attention_bias": True, "head_dim": 64,
    "hidden_act": "silu", "hidden_size": 2880, "intermediate_size": 2880, "max_position_embeddings": 131072,
    "num_attention_heads": 64, "num_experts_per_tok": 4, "num_key_value_heads": 8, "num_local_experts": 32,
    "rms_norm_eps": 1e-05, "rope_theta": 150000, "rope_scaling": {
        "beta_fast": 32.0, "beta_slow": 1.0, "factor": 32.0, "original_max_position_embeddings": 4096,
        "rope_type": "yarn", "truncate": False},
    "sliding_window": 128, "swiglu_limit": 7.0, "tie_word_embeddings": False, "vocab_size": 201088,
    "layer_types": ["sliding_attention", "full_attention"], "quantization_config": {"quant_method": "mxfp4"}}
# the text_config of meta-llama/Llama-4-Scout-17B-16E as transformers'
# Llama4TextConfig() defaults carry it (48 layers; rope_theta 500000, no
# rope_scaling: the repo holds no copy of the published file's), cut to one
# chunked rope layer and one NoPE full-attention layer (no_rope_layers
# [1, 0]); interleave_moe_layer_step 1 keeps both layers MoE
SCOUT_HF = {
    "model_type": "llama4_text", "attention_bias": False, "attention_chunk_size": 8192, "attn_scale": 0.1,
    "attn_temperature_tuning": True, "floor_scale": 8192, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 5120, "intermediate_size": 8192, "intermediate_size_mlp": 16384, "interleave_moe_layer_step": 1,
    "max_position_embeddings": 131072, "no_rope_layers": [1, 0], "num_attention_heads": 40,
    "num_experts_per_tok": 1, "num_key_value_heads": 8, "num_local_experts": 16, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000, "tie_word_embeddings": False, "use_qk_norm": True,
    "vocab_size": 202048}
GPTOSS_PROMPT = 300  # past the 128-token window
SCOUT_PROMPT = 8190  # decode crosses the 8192-token chunk boundary at its third step
# int4 GEMVs a decode step: the four attention projections a layer, and
# Llama-4's shared expert's three (the fused stacks are dequantized at use)
SINK_CHUNK_GEMVS = {"gpt-oss-20b": LAYERS * 4, "llama-4-scout": LAYERS * (4 + 3)}
# Scout's pool: 4 slots over 8704 cache slots, (prompt tokens, max_tokens,
# pool steps before the next submit): the second long prompt joins while
# the frontier is past its end, so it carries a join gap, and decodes across
# position 8192, where key_positions decides its chunked mask
SCOUT_POOL_CACHE = 8704
SCOUT_POOL = [(8150, 48, 4), (8120, 90, 3), (200, 40, 2), (100, 50, 0)]


def gptoss_checkpoint(torch, root: Path, cfg, seed: int) -> Path:
    """GPT-OSS-20B's two layers written in the shipped MXFP4 format: seeded
    random bf16 attention, router, norms, biases and sinks (the sinks
    N(0, 1)), and per layer ``gate_up_proj_blocks`` (32, 5760, 90, 16) /
    ``down_proj_blocks`` (32, 2880, 90, 16) with their e8m0 ``_scales``
    (bytes 119-122: fp4 values times 2^-8 to 2^-5); layer 0's gate_up
    blocks and scales sit in different shards."""
    from shardmerge_tpu_torch.io.safetensors_io import save_file
    from shardmerge_tpu_torch.models import llama

    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=dev, project_stacked=lambda w: None)
    names = {"q_proj": "self_attn.q_proj.weight", "k_proj": "self_attn.k_proj.weight",
             "v_proj": "self_attn.v_proj.weight", "o_proj": "self_attn.o_proj.weight",
             "q_bias": "self_attn.q_proj.bias", "k_bias": "self_attn.k_proj.bias", "v_bias": "self_attn.v_proj.bias",
             "o_bias": "self_attn.o_proj.bias", "sinks": "self_attn.sinks", "moe_gate": "mlp.router.weight",
             "moe_gate_bias": "mlp.router.bias", "input_layernorm": "input_layernorm.weight",
             "post_attention_layernorm": "post_attention_layernorm.weight"}
    shards = [{"model.embed_tokens.weight": params["embed_tokens"]},
              {"model.norm.weight": params["norm"], "lm_head.weight": params["lm_head"]}]
    h, inter, n_exp = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    for i, layer in enumerate(params["layers"]):
        p, out = f"model.layers.{i}.", shards[i]
        layer["sinks"] = torch.randn(layer["sinks"].shape, generator=gen, device=dev).to(torch.bfloat16)
        for key, name in names.items():
            out[p + name] = layer[key]
        e = layer["gptoss_experts"]
        out[p + "mlp.experts.gate_up_proj_bias"] = e["gate_up_bias"]
        out[p + "mlp.experts.down_proj_bias"] = e["down_bias"]
        for stem, rows, cols in (("gate_up_proj", 2 * inter, h), ("down_proj", h, inter)):
            out[p + f"mlp.experts.{stem}_blocks"] = torch.randint(
                0, 256, (n_exp, rows, cols // 32, 16), generator=gen, device=dev, dtype=torch.uint8)
            scales = torch.randint(119, 123, (n_exp, rows, cols // 32), generator=gen, device=dev, dtype=torch.uint8)
            # layer 0's gate_up scales in the other shard than its blocks
            (shards[1] if (i, stem) == (0, "gate_up_proj") else out)[p + f"mlp.experts.{stem}_scales"] = scales
    path = root / "gpt-oss-20b"
    path.mkdir()
    weight_map = {}
    for n, part in enumerate(shards):
        name = f"model-{n + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file({k: v.contiguous().cpu() for k, v in part.items()}, path / name)
        weight_map.update({k: name for k in part})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps({**GPTOSS_20B_HF, "num_hidden_layers": LAYERS}))
    return path


def mxfp4_card_check(torch, path: Path, loaded) -> str:
    """Layer 0's gate_up: the card's MXFP4 decode of its first 64 output
    rows bit for bit the host's, and the loaded int4 stack's q3 / scale on
    those channels the host quantizer's of the host decode."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader
    from shardmerge_tpu_torch.models.quant import dequant_mxfp4, quantize_stacked

    part = {}
    for f in sorted(path.glob("*.safetensors")):
        with SafeTensorsReader(f) as r:
            for k in r.keys():
                if k.startswith("model.layers.0.mlp.experts.gate_up_proj_"):
                    part[k.rsplit("_", 1)[-1]] = r.get_tensor(k)[:, :64].clone()
    host = dequant_mxfp4(part["blocks"], part["scales"])
    card = dequant_mxfp4(part["blocks"].to(CARD), part["scales"].to(CARD)).cpu()
    decode_equal = torch.equal(host.view(torch.int32), card.view(torch.int32))
    want = quantize_stacked(host, 4)
    stack = loaded.gate_up
    quant_equal = (torch.equal(stack.q3[:, :, :64].cpu(), want["q3"])
                   and torch.equal(stack.scale[:, :, :64].cpu(), want["scale"]))
    if not (decode_equal and quant_equal):
        raise SystemExit(f"[sinks-chunked] gpt-oss MXFP4: card decode equal to the host's {decode_equal}, "
                         f"the loaded int4 stack the host quantizer's {quant_equal}")
    return f"{host.numel()} decoded values bit-equal card vs host, the int4 q3/scale on them equal"


def sink_chunk_stream(torch, qk, ak, engine, name: str, prompt: str, route: str):
    """FAMILY_NEW greedy tokens after ``prompt``: the launches of a decode
    step checked against the route (GPT-OSS: every attention on the counted
    einsum path; Llama-4: both layers on flash, one chunked and one full
    slot list compacted a step), every flash call held to its plain version
    on its own inputs; returns (text, counts, (the prefill's seconds, the
    decode steps' seconds sorted), flash relL2, valid slots of the chunked
    and full masks at each step)."""
    steps = FAMILY_NEW
    gemvs = SINK_CHUNK_GEMVS[name]
    seen = []
    kernel = ak.flash_decode

    def recording(*args, **kw):
        out = kernel(*args, **kw)
        seen.append((args, kw))
        return out

    reset_counts(qk, ak)
    t0 = time.perf_counter()
    stamps = []  # each token reaches the host after its forward's argmax: a sync a token
    with mock.patch.object(ak, "flash_decode", recording):
        text = "".join(stamps.append(time.perf_counter()) or piece
                       for piece in engine.stream_generation(prompt, max_new_tokens=FAMILY_NEW, greedy=True))
    torch.cuda.synchronize()
    seconds = (stamps[0] - t0, sorted(b - a for a, b in zip(stamps, stamps[1:])))
    counts = {k: ak.launch_counts.get(k, 0) for k in ("flash_decode", "flash_compact", "decode_einsum")}
    counts["int4_gemv"] = qk.launch_counts["int4_gemv"]
    want = ({"flash_decode": 0, "flash_compact": 0, "decode_einsum": LAYERS * steps} if route == "einsum"
            else {"flash_decode": LAYERS * steps, "flash_compact": 2 * steps, "decode_einsum": 0})
    if len(text) != FAMILY_NEW or counts["int4_gemv"] != gemvs * steps or any(counts[k] != v for k, v in want.items()):
        raise SystemExit(f"[sinks-chunked] {name}: {len(text)} tokens, launches {counts} (want {want}, "
                         f"int4_gemv {gemvs * steps})")
    with torch.inference_mode():
        flash = max((rel_l2(kernel(*a, **kw), ak.flash_decode_plain(*a)) for a, kw in seen), default=None)
    valid = [int((a[3] > -1e8).sum()) for a, _ in seen]
    if flash is not None and flash > 1e-5:
        raise SystemExit(f"[sinks-chunked] {name}: flash leaves 1e-5 of its plain version ({flash:.2e})")
    return text, counts, seconds, flash, valid


def scout_pool(torch, engine):
    """SCOUT_POOL through a 4-slot pool: every completion equals its solo
    stream, or first differs at a near-tie of the plain route; the second
    long request joins with a gap and decodes across position 8192; the
    flash kernel runs in both layers each decode step with one chunked and
    one full slot list."""
    from shardmerge_tpu_torch.batching import ContinuousEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import quant_kernels as qk

    pool = ContinuousEngine(engine, slots=4, cache_len=SCOUT_POOL_CACHE, greedy=True, use_template=False)
    reqs = [(text_of(n, 900 + i), m) for i, (n, m, _) in enumerate(SCOUT_POOL)]
    reset_counts(qk, ak)
    t0 = time.perf_counter()
    handles, gaps = [], []

    def admit():  # noting the long second request's join gap
        pool._admit_pending()
        row = next((b for b, h in enumerate(pool._rows) if len(handles) > 1 and h is handles[1]), None)
        if row is not None and not gaps:
            gaps.append(int(pool._pad[row]))

    for (p, m), (_, _, after) in zip(reqs, SCOUT_POOL):
        handles.append(pool.submit(p, max_new_tokens=m, repetition_penalty=1.0))
        admit()
        for _ in range(after):
            if pool._active():
                pool._step()
            admit()
    while True:  # run_until_idle
        admit()
        if not pool._active():
            if not pool._queue and pool._admitting is None:
                break
            raise SystemExit("[sinks-chunked] llama-4-scout pool: a queued request cannot be admitted")
        pool._step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ak.launch_counts.get(k, 0) for k in ("flash_decode", "flash_compact", "decode_einsum")}
    counts["int4_gemv"] = qk.launch_counts["int4_gemv"]
    steps = pool.stats["decode_dispatches"]
    if counts["flash_decode"] != LAYERS * steps or counts["flash_compact"] != 2 * steps or counts["decode_einsum"]:
        raise SystemExit(f"[sinks-chunked] llama-4-scout pool: launches {counts} over {steps} steps")
    gap, (start, new) = (gaps or [0])[0], SCOUT_POOL[1][:2]
    if not gap or start + new <= SCOUT_HF["attention_chunk_size"]:
        raise SystemExit(f"[sinks-chunked] llama-4-scout pool: the long joiner's gap {gap}")
    notes = []
    for (p, m), h in zip(reqs, handles):
        solo = token_ids("".join(engine.stream_generation(p, max_new_tokens=m, greedy=True, repetition_penalty=1.0)))
        got = token_ids(h.result())
        if got != solo:
            steps_logits, _, gap_v, _ = replay(torch, engine, IdTokenizer().encode(p), solo)
            notes.append(near_tie_check("[sinks-chunked] llama-4-scout pool completion", got, solo, steps_logits, [],
                                        gap_v)[1])
    return (f"pool, 4 slots x {SCOUT_POOL_CACHE} cache slots, {len(reqs)} staggered greedy requests in {wall:.2f} s: "
            f"joins {pool.stats['joins']}, frontier jumps {pool.stats['frontier_jumps']}, compactions "
            f"{pool.stats['compactions']}, decode dispatches {steps}; the second request joined with a "
            f"{gap}-slot gap at position {start} and decoded to position {start + new - 1}; launches "
            f"{counts}; completions vs their solo streams: {len(reqs) - len(notes)} of {len(reqs)} equal"
            + (f" ({'; '.join(notes)})" if notes else ""))


def phase_sinks_chunked(torch, root: Path, card: str, lease: CardLease):
    """GPT-OSS-20B (attention sinks on the counted einsum path, the
    clamped-SwiGLU stacks from a shipped-format MXFP4 checkpoint loaded at
    4 bits) and Llama-4-Scout (chunked attention across the 8192 boundary
    on flash, the L2 q/k norm, the NoPE temperature, input-scaled f32
    experts) at published widths, 2 layers: the stream's launches, one
    decode step against the plain route, flash against its plain version,
    the GEMV at each new (N, K), card memory; Scout's pool. Scout holds
    ``lease``."""
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.models.loader import load_params
    from shardmerge_tpu_torch.models.quant import quantize_stacked

    t_phase = time.perf_counter()
    dev = torch.device(CARD)
    torch.empty(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    gemv_checked = set()
    for seed, name in enumerate(("gpt-oss-20b", "llama-4-scout")):
        if name == "llama-4-scout":
            lease.take()
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        note = ""
        if name == "gpt-oss-20b":
            cfg = llama.ModelConfig.from_hf_config({**GPTOSS_20B_HF, "num_hidden_layers": LAYERS})
            path = gptoss_checkpoint(torch, root, cfg, 60 + seed)
            written = time.perf_counter() - t0
            params = load_params(path, cfg, quant_bits=4, device=dev)
            model = llama.LlamaModel(cfg, params)
            note = (f"checkpoint written in {written:.1f} s, loaded at 4 bits in "
                    f"{time.perf_counter() - t0 - written:.1f} s; " + mxfp4_card_check(torch, path, model.layers[0].mlp)
                    + "; ")
            shutil.rmtree(path)
            prompt, route = text_of(GPTOSS_PROMPT, 70), "einsum"
        else:
            cfg = llama.ModelConfig.from_hf_config({**SCOUT_HF, "num_hidden_layers": LAYERS})
            params = llama.init_params(cfg, seed=60 + seed, dtype=torch.bfloat16, device=dev,
                                       project=lambda w: card_quantize(torch, w),
                                       project_stacked=lambda w: quantize_stacked(w, 4))
            model = llama.LlamaModel(cfg, params)
            prompt, route = text_of(SCOUT_PROMPT, 71), "flash"
        engine = InferenceEngine(cfg, model, StubTokenizer())
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        memory = torch.cuda.memory_allocated(dev)
        text, counts, (prefill_s, step_s), flash, valid = sink_chunk_stream(torch, qk, ak, engine, name, prompt,
                                                                            route)
        # one decode step against the plain route; Scout's after the boundary
        step_prompt = prompt if route == "einsum" else text_of(SCOUT_PROMPT + 4, 72)
        rel, attn, _, gap = family_step_check(torch, qk, ak, engine, step_prompt, f"[sinks-chunked] {name}", route,
                                              SINK_CHUNK_GEMVS[name])
        worst, new = 0.0, []
        for proj in path_projections(engine.model):
            n, kh = proj.q.shape
            if (n, 2 * kh) in gemv_checked:
                continue
            gemv_checked.add((n, 2 * kh))
            new.append((n, 2 * kh))
            for b in (1, 4):
                x = torch.randn((b, 2 * kh), device=dev, generator=gen).to(torch.bfloat16)
                worst = max(worst, rel_l2(qk.int4_matmul(x, proj.q, proj.scale).float(),
                                          qk.int4_matmul_plain(x, proj.q, proj.scale).float()))
        if worst > 4e-3:
            raise SystemExit(f"[sinks-chunked] {name}: the GEMV leaves 4e-3 of its plain version ({worst:.2e})")
        say(f"[sinks-chunked] {name} ({LAYERS} layers, int4): {FAMILY_NEW} greedy tokens after a {len(prompt)}-token "
            f"prompt: prefill to the first token {prefill_s:.3f} s, decode steps (host wall, a sync a token) "
            f"{step_s[0] * 1e3:.2f}-{step_s[-1] * 1e3:.2f} ms, median {step_s[len(step_s) // 2] * 1e3:.2f} ms; "
            f"launches {counts} ({SINK_CHUNK_GEMVS[name]} GEMVs a decode step)"
            + (f"; flash vs plain over the stream's calls relL2 <= {flash:.2e} (tol 1e-5), valid slots a call "
               f"{valid}" if flash is not None else "; attention on the counted einsum path (sinks)")
            + f"; decode step vs plain route (at position {len(step_prompt)}): logits relL2 {rel:.2e} (tol 2e-2, "
            f"max-abs {gap:.3e})" + (f", attention relL2 {attn:.2e} (tol 1e-5)" if attn is not None else "")
            + f"; GEMV at {len(new)} new (N, K) {new} relL2 <= {worst:.2e} (tol 4e-3); card memory "
            f"{memory / 2**30:.2f} GiB (peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}), built in "
            f"{built:.1f} s; {note}{time.perf_counter() - t0:.1f} s ({card})")
        if route == "flash":
            chunked = valid[0::2]  # layer 0's calls: its chunked mask, a step
            if not (chunked and min(chunked) <= FAMILY_NEW and max(chunked) >= SCOUT_HF["attention_chunk_size"] - 8):
                raise SystemExit(f"[sinks-chunked] {name}: the stream's chunked mask did not cross a chunk boundary "
                                 f"({chunked})")
            engine.tokenizer = IdTokenizer()
            say(f"[sinks-chunked] {name} " + scout_pool(torch, engine))
        del engine, model, params
        torch.cuda.empty_cache()
        lease.drop()
    say(f"[sinks-chunked] phase wall {time.perf_counter() - t_phase:.1f} s")


# [tp]: tensor-parallel generate and serve over two ranks sharing the card
# (gloo, host-staged), as ``torchrun --nproc-per-node 2`` starts them
TP_RANKS = 2
TP_TIMEOUT_S = 420
TP_NEW = 16  # greedy tokens of the generate CLI and of the timed streams
TP_PROMPT_WORDS = 48
TP_SERVE = [(24, 12), (90, 10), (7, 12), (300, 8), (40, 12)]  # (prompt words, max_tokens)
TP_EXPERTS = ("mixtral-8x7b", "gpt-oss-20b", "deepseek-v2-lite")
TP_EXPERT_NEW = 8
TP_GEMV_ROWS = (1, 4, 8)


def tp_words(n: int, seed: int, vocab: int) -> str:
    rnd = random.Random(seed)
    return " ".join(f"w{rnd.randrange(1, vocab)}" for _ in range(n))


def word_ids(text: str):
    """The word-level tokenizer's text (``w{i}`` words) back to ids."""
    return [int(w[1:]) for w in text.split()]


def tp_expert_cfg(name: str):
    from shardmerge_tpu_torch.models import llama

    hf = {"mixtral-8x7b": MIXTRAL_HF, "gpt-oss-20b": GPTOSS_20B_HF, "deepseek-v2-lite": DSV2_LITE_HF}[name]
    return llama.ModelConfig.from_hf_config({**hf, "num_hidden_layers": LAYERS})


def tp_expert_params(torch, name: str, seed: int):
    """The expert model's int4 params built on the card from ``seed`` (the
    same bits in every process)."""
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models.quant import quantize_stacked

    cfg = tp_expert_cfg(name)
    return cfg, llama.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=torch.device(CARD),
                                  project=lambda w: card_quantize(torch, w),
                                  project_stacked=lambda w: quantize_stacked(w, 4))


def projection_bytes(model) -> int:
    """Bytes of every Projection's weight (q and scale, or the dense weight)
    in the decoder layers."""
    from shardmerge_tpu_torch.models import llama

    total = 0
    for m in model.layers.modules():
        if isinstance(m, llama.Projection):
            total += sum(t.nbytes for t in (m.q, m.scale, m.weight) if t is not None)
    return total


def tp_rank(root: Path) -> int:
    """One rank of [tp] (``python3 chip_smoke.py --tp-rank ROOT``, with
    torchrun's rendezvous variables). Runs ``generate -4 --greedy --shard``
    through the CLI on [merge]'s output (rank 0 keeps the engine the command
    built for a prefill and a decode step's logits, the decode step's wall
    and collectives, before it releases the others), holds each rank's
    row-parallel GEMV slices to the plain product, serves ``serve -4 --shard
    --continuous 4`` until rank 0 is interrupted, then decodes each of
    TP_EXPERTS sharded. Writes ROOT/tp_rank{R}.json (and rank 0's logits
    to ROOT/tp_logits.pt)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from shardmerge_tpu_torch.cli import main as cli_main
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.parallel import tp as tpmod
    from shardmerge_tpu_torch.parallel.train import collectives_per_forward, plan, shard_params

    spec = json.loads((root / "tp.json").read_text())
    rank = int(os.environ["RANK"])
    found = {"rank": rank}
    captured = {}
    original = InferenceEngine.from_pretrained.__func__

    def capture(cls, *args, **kwargs):
        captured["engine"] = original(cls, *args, **kwargs)
        return captured["engine"]

    # generate through the CLI; rank 0 defers its release of the others
    # until its own measurements on the same engine are done
    reset_counts(qk, ak)
    out = io.StringIO()
    with mock.patch.object(InferenceEngine, "from_pretrained", classmethod(capture)), \
            mock.patch.object(tpmod.Leader, "stop", lambda self: None), contextlib.redirect_stdout(out):
        code = cli_main(["generate", spec["merged"], spec["prompt"], "-4", "--greedy", "--shard",
                         "--max-tokens", str(TP_NEW)])
    if code:
        return code
    engine = captured["engine"]
    group = engine.tp.group
    found["generate"] = {"text": out.getvalue().strip(), "transport": group.comm.transport,
                         "launches": {"int4_gemv": qk.launch_counts["int4_gemv"],
                                      "flash_decode": ak.launch_counts["flash_decode"]}}
    if rank == 0:
        dev, cfg = engine.device, engine.cfg
        ids = engine._encode(spec["prompt"], True, None, None)
        L = len(ids)
        rope = llama.rope_tables(cfg, 256, dev)
        with torch.inference_mode():
            kv = engine._init_kv(1, 256)
            pids, ppos = engine._pad_prompt(ids, 256)
            prefill, kv = engine._chunked_prefill(pids, ppos, kv, rope, L, keep_pos=L - 1)
            tok = prefill.argmax(-1)[:, None]
            torch.cuda.synchronize()
            before = {k: list(v) for k, v in group.comm.stats.items()}
            step, kv = engine.model(tok, torch.tensor([[L]], device=dev), kv, L, rope, L + 1)
            torch.cuda.synchronize()
            after = group.comm.stats
            found["step_collectives"] = {k: [after[k][0] - before.get(k, [0, 0])[0], after[k][1] - before.get(
                k, [0, 0])[1]] for k in after}
            found["predicted"] = collectives_per_forward(cfg, group.plan)
        torch.save({"prefill": prefill.float().cpu(), "step": step[:, -1].float().cpu()}, root / "tp_logits.pt")

        def wall(n):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in engine.stream_generation(spec["prompt"], max_new_tokens=n, greedy=True):
                    pass
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return sorted(times)[1]

        found["decode_ms"] = (wall(TP_NEW) - wall(1)) / (TP_NEW - 1) * 1e3
    # every rank: its row-parallel slices through the GEMV against the plain product
    gen = torch.Generator(device=engine.device).manual_seed(11 + rank)
    worst, shapes = 0.0, set()
    for proj in (engine.model.layers[0].self_attn.o_proj, engine.model.layers[0].mlp.down_proj):
        n, kh = proj.q.shape
        shapes.add((n, 2 * kh))
        for b in TP_GEMV_ROWS:
            x = torch.randn((b, 2 * kh), device=engine.device, generator=gen).to(torch.bfloat16)
            worst = max(worst, rel_l2(qk.int4_matmul(x, proj.q, proj.scale).float(),
                                      qk.int4_matmul_plain(x, proj.q, proj.scale).float()))
    found["gemv"] = {"shapes": sorted(shapes), "rel_l2": worst}
    found["projection_bytes"] = projection_bytes(engine.model)
    if rank == 0:
        engine.tp.stop()

    # serve through the CLI until rank 0 is interrupted; the command's load
    # returns a fresh engine (a new leader or follower) over the slices the
    # generate command loaded, which its load path has already exercised
    model = engine.tp.model

    def reload(cls, *args, **kwargs):
        if rank:
            return InferenceEngine(model.cfg, model, None, tp=tpmod.Follower(group, model))
        return InferenceEngine(model.cfg, model, engine.tokenizer, tp=tpmod.Leader(group, model))

    with mock.patch.object(InferenceEngine, "from_pretrained", classmethod(reload)):
        found["serve_code"] = cli_main(["serve", spec["merged"], "-4", "--shard", "--continuous", "4", "--port",
                                        str(spec["port"])])
    del engine, captured["engine"], model
    torch.cuda.empty_cache()

    # the expert families, sharded
    comm, control, dev = tpmod.join("cuda")
    found["experts"] = {}
    for seed, name in enumerate(TP_EXPERTS):
        cfg, params = tp_expert_params(torch, name, 90 + seed)
        g = tpmod.TPGroup(comm, plan(cfg, comm.rank, comm.size, 4), control)
        model = llama.LlamaModel(cfg, shard_params(params, cfg, g.plan), tp=g)
        del params
        torch.cuda.empty_cache()
        reset_counts(qk, ak)
        if rank:
            InferenceEngine(cfg, model, None, tp=tpmod.Follower(g, model)).follow()
            got = {}
        else:
            eng = InferenceEngine(cfg, model, IdTokenizer(), tp=tpmod.Leader(g, model))
            prompt = text_of(EXPERT_PROMPT, 95 + seed)
            with torch.inference_mode():
                L = len(prompt)
                cache = 256
                pids, ppos = eng._pad_prompt(IdTokenizer().encode(prompt), cache)
                last, _ = eng._chunked_prefill(pids, ppos, eng._init_kv(1, cache), llama.rope_tables(cfg, cache, dev),
                                               L, keep_pos=L - 1)
            text = "".join(eng.stream_generation(prompt, max_new_tokens=TP_EXPERT_NEW, greedy=True))
            torch.save(last.float().cpu(), root / f"tp_{name}.pt")
            got = {"tokens": token_ids(text)}
            eng.tp.stop()
        got.update({"launches": {"int4_gemv": qk.launch_counts["int4_gemv"],
                                 "flash_decode": ak.launch_counts["flash_decode"],
                                 "decode_einsum": ak.launch_counts["decode_einsum"]},
                    "projection_bytes": projection_bytes(model)})
        found["experts"][name] = got
        del model
        torch.cuda.empty_cache()
    found["collectives"] = {k: {"calls": c, "bytes": b, "seconds": s} for k, (c, b, s) in comm.stats.items()}
    (root / f"tp_rank{rank}.json").write_text(json.dumps(found))
    dist.barrier()
    return 0


def launch_tp_ranks(root: Path):
    """Start the [tp] ranks as ``torchrun --nproc-per-node 2`` would: the
    processes, their stdout and stderr in ROOT/tp{R}.out|err."""
    port = free_port()
    procs = []
    for rank in range(TP_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(TP_RANKS), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(TP_RANKS)}
        with open(root / f"tp{rank}.out", "w") as out, open(root / f"tp{rank}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--tp-rank", str(root)],
                                          cwd=REPO, env=env, stdout=out, stderr=err))
    return procs


def tp_fail(root: Path, procs, why: str):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    tails = "".join(f"\n--- rank {r} stderr:\n" + (root / f"tp{r}.err").read_text()[-3000:] for r in range(TP_RANKS))
    raise SystemExit(f"[tp] {why}{tails}")


def tp_reference(torch, engine, tok, prompt: str, n: int):
    """The one-device route on ``prompt``: its ``n`` greedy tokens and the
    logits each was chosen from (the prefill's last row, then one T=1 decode
    step a token: the kernels' route), (n, V)."""
    from shardmerge_tpu_torch.inference import InferenceEngine
    from shardmerge_tpu_torch.models import llama

    ref = InferenceEngine(engine.cfg, engine.model, tok)
    text = "".join(ref.stream_generation(prompt, max_new_tokens=n, greedy=True))
    tokens = token_ids(text) if isinstance(tok, IdTokenizer) else word_ids(text)
    ids = ref._encode(prompt, True, None, None)
    L, dev = len(ids), ref.device
    cache = -(-(L + n + 1) // 256) * 256
    rope = llama.rope_tables(ref.cfg, cache, dev)
    with torch.inference_mode():
        pids, ppos = ref._pad_prompt(ids, cache)
        last, kv = ref._chunked_prefill(pids, ppos, ref._init_kv(1, cache), rope, L, keep_pos=L - 1)
        rows = [last[0]]
        for i, t in enumerate(tokens[:-1]):
            logits, kv = ref.model(torch.tensor([[t]], device=dev), torch.tensor([[L + i]], device=dev), kv, L + i,
                                   rope, L + i + 1)
            rows.append(logits[0, -1])
    return tokens, torch.stack(rows).float().cpu(), text


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_tp(torch, root: Path, merged: Path, engine, card: str):
    """[tp]: ``generate --shard`` and ``serve --shard`` on two ranks sharing
    the card (host-staged gloo), the row-parallel GEMV slices, three expert
    families sharded, and a world-1 NCCL ``generate --shard``."""
    import signal

    from shardmerge_tpu_torch.inference import InferenceEngine, load_tokenizer
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.train import collectives_per_forward, plan

    t_phase = time.perf_counter()
    cfg = engine.cfg
    write_word_tokenizer(merged, cfg.vocab_size)
    tok = load_tokenizer(merged, merged)
    prompt = tp_words(TP_PROMPT_WORDS, 101, cfg.vocab_size)
    serve = [(tp_words(n, 120 + i, cfg.vocab_size), m) for i, (n, m) in enumerate(TP_SERVE)]
    # one device's decode time, before the ranks share the card
    one = InferenceEngine(cfg, engine.model, tok)

    def wall(n):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in one.stream_generation(prompt, max_new_tokens=n, greedy=True):
                pass
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    one_ms = (wall(TP_NEW) - wall(1)) / (TP_NEW - 1) * 1e3
    port = free_port()
    (root / "tp.json").write_text(json.dumps({"merged": str(merged), "prompt": prompt, "port": port}))
    t_ranks = time.perf_counter()
    procs = launch_tp_ranks(root)
    # the one-device references while the ranks start and load
    want_tokens, want_logits, want_text = tp_reference(torch, engine, tok, prompt, TP_NEW)
    solos = [tp_reference(torch, engine, tok, p, m) for p, m in serve]
    ids = one._encode(prompt, True, None, None)
    with torch.inference_mode():
        rope = llama.rope_tables(cfg, 256, engine.device)
        kv = one._init_kv(1, 256)
        pids, ppos = one._pad_prompt(ids, 256)
        one_prefill, kv = one._chunked_prefill(pids, ppos, kv, rope, len(ids), keep_pos=len(ids) - 1)
        one_step, _ = one.model(one_prefill.argmax(-1)[:, None], torch.tensor([[len(ids)]], device=engine.device),
                                kv, len(ids), rope, len(ids) + 1)
    one_bytes = projection_bytes(engine.model)
    # serve: wait for rank 0's server, send the requests, interrupt it
    base = f"http://127.0.0.1:{port}"
    deadline = time.perf_counter() + TP_TIMEOUT_S / 2
    while True:
        if any(p.poll() is not None for p in procs):
            tp_fail(root, procs, "a rank exited before serving")
        try:
            urllib.request.urlopen(base + "/health", timeout=5).read()
            break
        except OSError:
            if time.perf_counter() > deadline:
                tp_fail(root, procs, "rank 0 never served")
            time.sleep(0.5)
    t_serve = time.perf_counter()
    with ThreadPoolExecutor(len(serve)) as pool:
        bodies = list(pool.map(lambda pm: post(port, {"prompt": pm[0], "max_tokens": pm[1], "greedy": True}), serve))
    serve_s = time.perf_counter() - t_serve
    procs[0].send_signal(signal.SIGINT)
    # the world-1 NCCL generate --shard, meanwhile
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1",
           "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    with open(root / "world1.out", "w") as out, open(root / "world1.err", "w") as err:
        world1 = subprocess.Popen([sys.executable, "-m", "shardmerge_tpu_torch", "generate", str(merged), prompt,
                                   "-4", "--greedy", "--shard", "--max-tokens", str(TP_NEW)], cwd=REPO, env=env,
                                  stdout=out, stderr=err)
    # the expert references while the ranks decode theirs
    experts = {}
    for seed, name in enumerate(TP_EXPERTS):
        ecfg, params = tp_expert_params(torch, name, 90 + seed)
        eng = InferenceEngine(ecfg, llama.LlamaModel(ecfg, params), IdTokenizer())
        del params
        prompt_e = text_of(EXPERT_PROMPT, 95 + seed)
        tokens, logits, _ = tp_reference(torch, eng, IdTokenizer(), prompt_e, TP_EXPERT_NEW)
        with torch.inference_mode():
            L = len(prompt_e)
            pids, ppos = eng._pad_prompt(IdTokenizer().encode(prompt_e), 256)
            last, _ = eng._chunked_prefill(pids, ppos, eng._init_kv(1, 256), llama.rope_tables(ecfg, 256, CARD), L,
                                           keep_pos=L - 1)
        experts[name] = (tokens, logits, last.float().cpu(), projection_bytes(eng.model))
        del eng
        torch.cuda.empty_cache()
    try:
        world1.wait(timeout=300)
    except subprocess.TimeoutExpired:
        world1.kill()
        tp_fail(root, procs, "the world-1 NCCL generate --shard ran past 300 s")
    world1_out, world1_err = (root / "world1.out").read_text(), (root / "world1.err").read_text()
    for rank, proc in enumerate(procs):
        try:
            code = proc.wait(timeout=max(1.0, TP_TIMEOUT_S - (time.perf_counter() - t_ranks)))
        except subprocess.TimeoutExpired:
            tp_fail(root, procs, f"rank {rank} still running after {TP_TIMEOUT_S} s")
        if code != 0:
            tp_fail(root, procs, f"rank {rank} exited {code}")
    ranks_s = time.perf_counter() - t_ranks
    found = [json.loads((root / f"tp_rank{r}.json").read_text()) for r in range(TP_RANKS)]
    saved = torch.load(root / "tp_logits.pt")
    r0 = found[0]

    # 1. generate --shard through the CLI
    got_tokens = word_ids(r0["generate"]["text"])
    gap = float((saved["step"][0] - one_step[0, -1].float().cpu()).abs().max())
    same, note = near_tie_check("[tp] generate --shard", got_tokens, want_tokens, want_logits, [], gap)
    rel_prefill = rel_l2(saved["prefill"], one_prefill.float().cpu())
    rel_step = rel_l2(saved["step"], one_step[:, -1].float().cpu())
    if rel_prefill > 2e-2 or rel_step > 2e-2:
        raise SystemExit(f"[tp] sharded logits leave 2e-2 of one device's: prefill {rel_prefill:.2e}, "
                         f"decode {rel_step:.2e}")
    for r in found:
        launches = r["generate"]["launches"]
        if launches["int4_gemv"] <= 0 or launches["flash_decode"] <= 0:
            raise SystemExit(f"[tp] rank {r['rank']} did not run both decode kernels on its slice: {launches}")
        if r["projection_bytes"] > 0.55 * one_bytes:
            raise SystemExit(f"[tp] rank {r['rank']} holds {r['projection_bytes']} projection bytes of one "
                             f"device's {one_bytes}")
    predicted = plan(cfg, 0, TP_RANKS, 4)
    want_coll = collectives_per_forward(cfg, predicted)
    step_coll = r0["step_collectives"]
    if step_coll.get("all_reduce", [0])[0] != want_coll["all_reduce"] or \
            step_coll.get("all_gather", [0])[0] != want_coll["all_gather"]:
        raise SystemExit(f"[tp] a decode step ran {step_coll}, the model predicts {want_coll}")
    say(f"[tp] generate -4 --greedy --shard on {TP_RANKS} ranks ({r0['generate']['transport']}, {card}): "
        f"{len(got_tokens)} tokens vs one device: {note}; logits vs one device relL2 prefill {rel_prefill:.2e}, "
        f"decode {rel_step:.2e} (tol 2e-2, decode max-abs {gap:.3e}); per rank launches "
        f"{[r['generate']['launches'] for r in found]}; projection bytes per rank "
        f"{[r['projection_bytes'] for r in found]} of one device's {one_bytes} "
        f"({found[0]['projection_bytes'] / one_bytes:.3f})")
    say(f"[tp] a decode step's collectives (rank 0): all_reduce {step_coll['all_reduce'][0]} "
        f"({step_coll['all_reduce'][1]} bytes sent), all_gather {step_coll['all_gather'][0]} "
        f"({step_coll['all_gather'][1]} bytes), call records {step_coll.get('broadcast', [0])[0]}; the model "
        f"predicts {want_coll}; decode ms/step at B=1 (medians of 3, {TP_NEW} tokens): {TP_RANKS} ranks "
        f"{r0['decode_ms']:.3f}, one device {one_ms:.3f} ({card})")
    # 2. the row-parallel slices through the GEMV
    for r in found:
        if r["gemv"]["rel_l2"] > 4e-3:
            raise SystemExit(f"[tp] rank {r['rank']}: its GEMV slices leave 4e-3 of the plain product: {r['gemv']}")
    say(f"[tp] row-parallel GEMV slices {found[0]['gemv']['shapes']} at B = {list(TP_GEMV_ROWS)}, kernel vs "
        f"plain: relL2 <= {max(r['gemv']['rel_l2'] for r in found):.2e} (tol 4e-3) on every rank")
    # 3. serve --shard --continuous 4
    notes = []
    for (p, m), body, (tokens, logits, _) in zip(serve, bodies, solos):
        got = word_ids(body["choices"][0]["text"])
        _, n = near_tie_check("[tp] serve --shard", got, tokens, logits, [], gap)
        notes.append(n)
    codes = [r["serve_code"] for r in found]
    if codes != [0] * TP_RANKS:
        raise SystemExit(f"[tp] serve --shard exit codes {codes}")
    say(f"[tp] serve -4 --shard --continuous 4: {len(serve)} concurrent greedy requests in {serve_s:.2f} s, "
        f"each vs its one-device solo stream: {notes}; every rank's serve returned 0 after rank 0's SIGINT")
    # 4. the expert families
    for name in TP_EXPERTS:
        tokens, logits, last, nbytes = experts[name]
        got = r0["experts"][name]["tokens"]
        ranked = torch.load(root / f"tp_{name}.pt")
        egap = float((ranked - last).abs().max())
        _, n = near_tie_check(f"[tp] {name}", got, tokens, logits, [], egap)
        launches = [r["experts"][name]["launches"] for r in found]
        if any(l["int4_gemv"] <= 0 for l in launches):
            raise SystemExit(f"[tp] {name}: a rank ran no GEMV: {launches}")
        say(f"[tp] {name} ({LAYERS} layers, int4) on {TP_RANKS} ranks: {TP_EXPERT_NEW} greedy tokens vs one "
            f"device: {n} (prefill logits max-abs gap {egap:.3e}); per rank launches {launches}; projection bytes "
            f"per rank {[r['experts'][name]['projection_bytes'] for r in found]} of one device's {nbytes}")
    # 5. world-1 NCCL
    if world1.returncode != 0 or word_ids(world1_out.strip()) != want_tokens or \
            "one rank, nothing to shard" not in world1_err or "over nccl" not in world1_err:
        raise SystemExit(f"[tp] world-1 NCCL generate --shard: exit {world1.returncode}, "
                         f"{world1_out[-500:]!r}, {world1_err[-2000:]}")
    say(f"[tp] world-1 NCCL generate --shard: logs one rank and gives one device's {len(want_tokens)} tokens")
    coll = found[0]["collectives"]
    say(f"[tp] rank 0's expert collectives {coll}; ranks ran {ranks_s:.1f} s; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


# [train]: training on the card at Llama-3.1-8B widths, seeded random weights
TRAIN_SEED = 31
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 4, 512, 2
TRAIN_STEPS, TRAIN_SAVE_AT = 4, 2
TRAIN_LR, QLORA_LR = 1e-4, 1e-3
QLORA_RANK, QLORA_TARGETS, QLORA_SEQ, QLORA_STEPS = 16, ("q_proj", "v_proj"), 64, 4
# the untargeted int4 projections a layer (k, o, gate, up, down): the GEMV's
# forward launches a QLoRA step at B x T = 64 rows
QLORA_GEMVS = 5 * LAYERS
TRAIN_RANKS, RANKS_LAYERS, RANKS_BATCH, RANKS_SEQ, RANKS_STEPS = 2, 1, 2, 128, 2
# [pp]: two ranks sharing the card as two pipeline stages of the 8B widths
PP_RANKS, PP_LAYERS, PP_SEED = 2, 2, 41
PP_BATCH, PP_SEQ, PP_MICRO, PP_STEPS = 4, 128, 4, 2  # the f32 steps
PP_INT4_SEQ = 64  # the int4 forward: PP_MICRO microbatches of 1 x 64 tokens, each on the GEMV


def train_cfg(layers: int = LAYERS):
    from shardmerge_tpu_torch.models import llama

    return llama.ModelConfig.from_hf_config({**LLAMA_31_8B, "num_hidden_layers": layers})


def train_tx():
    """The clip + cosine chain of examples/train_recipe_torch.py."""
    from shardmerge_tpu_torch.parallel import optim

    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(optim.cosine_decay_schedule(TRAIN_LR, 100)))


def leaves_of(state, key: str = "params"):
    from shardmerge_tpu_torch.parallel.train import tree_flatten

    return tree_flatten(state[key])[1]


def run_gap(torch, a, b) -> float:
    """Max-abs difference over two lists of tensors."""
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def full_finetune(torch, root: Path, card: str) -> dict:
    """The full fine-tune: bf16 params with an f32 master, remat, two
    microbatches, the clip + cosine chain, B x T = 4 x 512 on a repeated
    batch. Run A saves after TRAIN_SAVE_AT steps; run R restores A's
    snapshot onto a fresh template and resumes: its losses and params are
    A's bits, or, when they are not, within twice the gap between A and a
    run B that repeats A (the atomics of a backward may differ run to
    run)."""
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.train import make_train_step

    cfg = train_cfg()
    dev = torch.device("cuda:0")
    mesh = make_mesh(("dp", "tp"), shape=(1, 1), device="cuda")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    batch = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device=dev, generator=gen)
    ckpt = root / "train_ckpt"
    out = {}

    def run(tag, restore=False):
        init, step = make_train_step(mesh, cfg, remat=True, master_fp32=True, grad_accum=TRAIN_ACCUM, tx=train_tx())
        torch.cuda.reset_peak_memory_stats()
        state = init(llama.init_params(cfg, seed=TRAIN_SEED + (1 if restore else 0), dtype=torch.bfloat16,
                                       device=dev))
        first = 0
        if restore:
            t0 = time.perf_counter()
            state, first = restore_train_state(ckpt, state)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
        losses, walls = [], []
        for i in range(first, TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(float(loss))  # the step's one host sync
            walls.append(time.perf_counter() - t0)
            if tag == "A" and i + 1 == TRAIN_SAVE_AT:
                t0 = time.perf_counter()
                save_train_state(ckpt, state, step=TRAIN_SAVE_AT)
                out["save_s"] = time.perf_counter() - t0
                out["ckpt_bytes"] = (ckpt / "train_state.safetensors").stat().st_size
        params = [v.detach().clone() for v in leaves_of(state)]
        peak = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        return losses, params, walls, peak

    la, pa, walls, peak = run("A")
    lr_, pr, _, _ = run("R", restore=True)
    n = sum(p.numel() for p in pa)
    res_loss = max(abs(x - y) for x, y in zip(la[TRAIN_SAVE_AT:], lr_))
    res_params = run_gap(torch, pa, pr)
    gap_loss = gap_params = 0.0
    if res_loss or res_params:  # not A's bits: the run-to-run gap decides
        lb, pb, _, _ = run("B")
        gap_loss = max(abs(x - y) for x, y in zip(la, lb))
        gap_params = run_gap(torch, pa, pb)
    ok = all(math.isfinite(x) for x in la) and la[-1] < la[0]
    ok &= res_loss <= 2 * gap_loss and res_params <= 2 * gap_params
    step_s = sorted(walls[1:])[len(walls[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    say(f"[train] full fine-tune, Llama-3.1-8B widths x {LAYERS} layers ({n / 1e9:.3f} B params), bf16 + f32 master, "
        f"remat, grad_accum {TRAIN_ACCUM}, clip + cosine, B x T = {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{[round(x, 4) for x in la]} (finite, falling: {la[-1] < la[0]})")
    say(f"[train] step {step_s * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first {walls[0] * 1e3:.1f} ms), "
        f"{tokens / step_s:.0f} tokens/s, peak {peak / 2**30:.2f} GiB on {card}")
    say(f"[train] checkpoint after {TRAIN_SAVE_AT} steps: {out['ckpt_bytes'] / 2**30:.2f} GiB saved in "
        f"{out['save_s']:.1f} s, restored in {out['restore_s']:.1f} s; resumed vs uninterrupted: losses max-abs "
        f"{res_loss:.3e}, params max-abs {res_params:.3e}"
        + ("" if not (res_loss or res_params) else f"; two uninterrupted runs: {gap_loss:.3e} / {gap_params:.3e}")
        + f" (gate: A's bits, or at most twice the run-to-run gap) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] the full fine-tune's losses do not fall, or the resumed run left the run-to-run gap")
    return {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s, "peak_gib": peak / 2**30}


def qlora(torch, qk, root: Path, card: str) -> int:
    """QLoRA: an int4 base (quantized on the card) with rank-16 adapters on
    q_proj / v_proj, B x T = 1 x 64: every step's forward launches the GEMV
    QLORA_GEMVS times (the untargeted projections; their backward is
    Int4Matmul's dequant product). After two steps the adapters' gradients
    on the kernel route are held to the plain route's (5e-2); the loss
    falls; lora_to_peft then fuse_lora of the dequantized base's targets on
    the card equals merge_lora within one bf16 ulp. Returns the GEMV
    launches of the steps."""
    from shardmerge_tpu_torch.io.safetensors_io import SafeTensorsReader, save_file
    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models.quant import dequant
    from shardmerge_tpu_torch.parallel.lora import lora_to_peft, make_lora_train_step, merge_lora
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.train import _loss_fn, tree_flatten, tree_unflatten
    from shardmerge_tpu_torch.tools.fuse_lora import fuse_lora

    cfg = train_cfg()
    dev = torch.device("cuda:0")
    base = llama.init_params(cfg, seed=TRAIN_SEED + 7, dtype=torch.bfloat16, device=dev,
                             project=lambda w: card_quantize(torch, w))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 8)
    batch = torch.randint(0, cfg.vocab_size, (1, QLORA_SEQ + 1), device=dev, generator=gen)
    init, step = make_lora_train_step(make_mesh(("dp", "tp"), shape=(1, 1), device="cuda"), cfg, rank=QLORA_RANK,
                                      learning_rate=QLORA_LR, targets=QLORA_TARGETS, seed=TRAIN_SEED)
    state = init(base)
    losses, per_step, walls = [], [], []
    total = 0
    for i in range(QLORA_STEPS):
        qk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        per_step.append(qk.launch_counts["int4_gemv"])
        total += per_step[-1]
        if i == 1:  # the adapters' gradients on both routes, B != 0 by now
            def grads():
                leaves = [v.detach().requires_grad_(True) for v in tree_flatten(state["lora"])[1]]
                merged = merge_lora(state["params"], tree_unflatten(state["lora"], leaves), 1.0)
                return torch.autograd.grad(_loss_fn(merged, cfg, batch), leaves)

            qk.reset_launch_counts()
            kernel = grads()
            kernel_launches = qk.launch_counts["int4_gemv"]
            with mock.patch.object(qk, "supported", lambda *a: False):
                plain = grads()
            rel = rel_l2(torch.cat([g.reshape(-1) for g in kernel]), torch.cat([g.reshape(-1) for g in plain]))
    ok = per_step == [QLORA_GEMVS] * QLORA_STEPS and kernel_launches == QLORA_GEMVS and rel <= 5e-2
    ok &= all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    say(f"[train] QLoRA: int4 base, rank {QLORA_RANK} on {'/'.join(QLORA_TARGETS)}, B x T = 1 x {QLORA_SEQ}: losses "
        f"{[round(x, 4) for x in losses]}; int4 GEMV launches a step {per_step} (predicted {QLORA_GEMVS}); adapter "
        f"gradients kernel route vs plain relL2 {rel:.3e} (gate 5e-2); step {sorted(walls[1:])[1] * 1e3:.1f} ms "
        f"on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] QLoRA: the GEMV launches, the gradient routes or the loss left their gates")
    # export, fuse the targets of the dequantized base on the card, hold to merge_lora
    adapter, base_dir, fused_dir = root / "qlora_adapter", root / "qlora_base", root / "qlora_fused"
    lora_to_peft(state["lora"], adapter, rank=QLORA_RANK, alpha=float(QLORA_RANK))
    base_dir.mkdir()
    names = {f"model.layers.{i}.self_attn.{t}.weight": (i, t) for i in range(LAYERS) for t in QLORA_TARGETS}
    save_file({k: dequant(state["params"]["layers"][i][t], torch.bfloat16).cpu() for k, (i, t) in names.items()},
              base_dir / "model.safetensors")
    fuse_lora(base_dir, adapter, fused_dir, device="cuda")
    merged = merge_lora(state["params"], state["lora"], 1.0)
    worst = 0.0
    with SafeTensorsReader(fused_dir / "model.safetensors") as r:
        for k, (i, t) in names.items():
            a, b = r.get_tensor(k).to(dev).float(), merged["layers"][i][t].float()
            ulps = (a - b).abs() / (torch.maximum(a.abs(), b.abs()) * 2.0**-7).clamp_min(1e-30)
            worst = max(worst, float(ulps.max()))
    ok = worst <= 1.0
    say(f"[train] QLoRA export: lora_to_peft -> fuse_lora (card) of {len(names)} targets vs merge_lora: at most "
        f"{worst:.2f} bf16 ulp {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] the fused adapter is not merge_lora's within one bf16 ulp")
    return total


def train_rank(root: Path) -> int:
    """One rank of [train]'s two ranks sharing the card (``python3
    chip_smoke.py --train-rank ROOT`` with torchrun's variables; gloo,
    host-staged). One layer at 8B widths, f32 (bf16's rounding would hide
    a fault under its own noise): both ranks run RANKS_STEPS steps on dp =
    2 with ZeRO-1 and on tp = 2, rank 0 keeping each run's whole params on
    the card; when rank 1 has left the card, rank 0 runs the one-device
    step, holds each run to its losses (1e-4 relative) and updates (relL2
    1e-2), and writes ROOT/train_ranks.json with the collectives' calls,
    bytes and seconds and its own seconds of work."""
    import torch
    import torch.distributed as dist

    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel.mesh import Mesh, make_mesh
    from shardmerge_tpu_torch.parallel.train import make_train_step

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products, as the main process has them
    cfg = train_cfg(RANKS_LAYERS)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 3)
    batch = torch.randint(0, cfg.vocab_size, (RANKS_BATCH, RANKS_SEQ + 1), device=dev, generator=gen)

    def params():
        return llama.init_params(cfg, seed=TRAIN_SEED + 4, dtype=torch.float32, device=dev)

    def run(mesh, **opts):
        init, step = make_train_step(mesh, cfg, learning_rate=TRAIN_LR, **opts)
        state = init(params())
        losses, walls = [], []
        for _ in range(RANKS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
        lay, keep = state.layout, mesh.rank == 0  # every rank takes part in the gathers; rank 0 keeps them
        whole = []
        for i, v in enumerate(leaves_of(state)):
            w = lay.gather("trained", i, v)
            whole.append(w.detach().cpu() if keep else None)  # on the host: the card holds the next run
            del w
        del state
        torch.cuda.empty_cache()
        return losses, whole, walls

    runs = {}
    for tag, shape, opts in (("dp=2 zero1", (TRAIN_RANKS, 1), {"zero1": True}), ("tp=2", (1, TRAIN_RANKS), {})):
        m = make_mesh(("dp", "tp"), shape=shape)
        losses, whole, walls = run(m, **opts)
        stats = {axis: {k: [v[0], v[1], round(v[2], 3)] for k, v in c.stats.items()} for axis, c in m.comms.items()}
        runs[tag] = (losses, whole, walls, stats, next(iter(m.comms.values())).transport)
    dist.barrier()
    if dist.get_rank():
        return 0
    torch.cuda.synchronize()
    time.sleep(2.0)  # rank 1's process leaves the card
    ref_losses, ref, ref_walls = run(Mesh(("dp", "tp"), (1, 1), 0, "cuda:0"))  # the one-device step
    p0 = leaves_of({"params": params()})
    out = {"ref_step_ms": [w * 1e3 for w in ref_walls], "ref": ref_losses}
    for tag, (losses, whole, walls, stats, transport) in runs.items():
        upd = 0.0
        for w, r, p in zip(whole, ref, p0):  # on the card, a leaf at a time
            w, d = w.to(dev), r.to(dev) - p
            if bool((d != 0).any()):
                upd = max(upd, float(((w - p) - d).norm() / d.norm()))
        out[tag] = {"losses": losses, "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                    "update_rel": upd, "step_ms": [w * 1e3 for w in walls], "collectives": stats,
                    "transport": transport}
    out["wall_s"] = time.perf_counter() - t_start
    (root / "train_ranks.json").write_text(json.dumps(out))
    return 0


def start_train_ranks(root: Path) -> list:
    """Start [train]'s two ranks sharing the card (the allocator's
    expandable segments). They are host-bound (5 GB of f32 gradients and
    updates a ZeRO-1 step over loopback TCP) and hold up to about 35 GB of
    the card each, so main() starts them before [families] and they run
    beside [families]; [cp]/[ep]'s ranks start when they exit; [train]
    waits for them before its own steps take the card's memory."""
    port = free_port()
    procs = []
    for rank in range(TRAIN_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(TRAIN_RANKS),
               "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(TRAIN_RANKS),
               "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        with open(root / f"train{rank}.out", "w") as o, open(root / f"train{rank}.err", "w") as e:
            procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--train-rank", str(root)],
                                          cwd=REPO, env=env, stdout=o, stderr=e))
    return procs


def stop_procs(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def train_ranks(torch, root: Path, card: str, procs: list) -> float:
    """Wait for [train]'s two ranks (``start_train_ranks``) and gate their
    report; returns the seconds rank 0 worked."""
    try:
        codes = [p.wait(timeout=400) for p in procs]
    except subprocess.TimeoutExpired:
        codes = [None] * len(procs)
    finally:
        stop_procs(procs)
    if codes != [0] * TRAIN_RANKS:
        tails = "".join(f"\n--- rank {r} stderr:\n" + (root / f"train{r}.err").read_text()[-3000:]
                        for r in range(TRAIN_RANKS))
        raise SystemExit(f"[train] ranks exited {codes}{tails}")
    res = json.loads((root / "train_ranks.json").read_text())
    ok = True
    for tag in ("dp=2 zero1", "tp=2"):
        r = res[tag]
        passed = r["loss_rel"] <= 1e-4 and r["update_rel"] <= 1e-2
        ok &= passed
        say(f"[train] two ranks sharing the card ({r['transport']}), {tag}, Llama-3.1-8B widths x {RANKS_LAYERS} "
            f"layer, f32, {RANKS_STEPS} steps of B x T = {RANKS_BATCH} x {RANKS_SEQ}: losses {r['losses']} vs one "
            f"device {res['ref']} (rel {r['loss_rel']:.2e}, gate 1e-4), updates relL2 {r['update_rel']:.2e} (gate "
            f"1e-2); step ms (beside [families] / [experts]) {[round(x, 1) for x in r['step_ms']]} vs one device "
            f"{[round(x, 1) for x in res['ref_step_ms']]}; collectives [calls, bytes, seconds] by axis "
            f"{r['collectives']} {'ok' if passed else 'FAIL'}")
    if not ok:
        raise SystemExit("[train] a two-rank step left the one-device step's class")
    return res["wall_s"]


def phase_train(torch, qk, root: Path, card: str, ranks: list) -> int:
    """[train]: two ranks sharing the card (started by main() before
    [families]: waited for and gated here), the full fine-tune with its
    checkpoint, QLoRA through the int4 GEMV. Returns the GEMV launches of
    the QLoRA steps (the main path's count for the kernels line)."""
    t0 = time.perf_counter()
    worked = train_ranks(torch, root, card, ranks)
    t1 = time.perf_counter()
    full_finetune(torch, root, card)
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = qlora(torch, qk, root, card)
    say(f"[train] parts: ranks {worked:.1f} s of rank 0's work beside [families] and [experts], then "
        f"{t1 - t0:.1f} s waited for; full fine-tune {t2 - t1:.1f} s, QLoRA {time.perf_counter() - t2:.1f} s")
    return launches



def pp_tx():
    """adamw with clip_by_global_norm: the global norm sums over the stages."""
    from shardmerge_tpu_torch.parallel import optim

    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(TRAIN_LR))


def pp_rank(root: Path) -> int:
    """One rank of [pp]'s two ranks sharing the card (``python3 chip_smoke.py
    --pp-rank ROOT`` with torchrun's variables; gloo, host-staged), stage r
    of a pp = 2 pipeline of the 8B widths (2 layers, one a stage).

    (b) the int4 forward: bf16 with int4 projections quantized on the card,
    PP_MICRO microbatches of 1 x PP_INT4_SEQ under no_grad, the GEMV's
    launches counted on each rank; the last stage holds its logits to the
    one-device forward_train of each microbatch alone (the same routes) and
    of the whole batch (its 256 rows on the dense route). (a) the f32 steps:
    PP_STEPS make_pp_train_step steps of adamw with clip, B x T = PP_BATCH x
    PP_SEQ in PP_MICRO microbatches, each step's p2p record and wall; (c)
    the state after step 1 saved (the stages' leaves reach rank 0 over the
    pp line). Then stage 1 hands rank 0 its params and leaves; rank 0 runs
    the one-device make_train_step with grad_accum = PP_MICRO on the same
    batch, compares losses and updates, restores the checkpoint on one
    device and runs step 2 there, and writes ROOT/pp_ranks.json."""
    import torch
    import torch.distributed as dist

    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from shardmerge_tpu_torch.parallel.mesh import Mesh, make_mesh
    from shardmerge_tpu_torch.parallel.pipeline import pipeline_forward_train, stack_stages
    from shardmerge_tpu_torch.parallel.train import make_pp_train_step, make_train_step, tree_flatten

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_cfg(PP_LAYERS)
    dev = torch.device("cuda:0")
    mesh = make_mesh(("pp",), shape=(PP_RANKS,))
    r = mesh.coords["pp"]
    last = r == PP_RANKS - 1
    pp = mesh.comm("pp")
    out = {"transport": pp.transport}

    # (b) the int4 forward
    gen = torch.Generator(device=dev).manual_seed(PP_SEED + 2)
    ids = torch.randint(0, cfg.vocab_size, (PP_MICRO, PP_INT4_SEQ), device=dev, generator=gen)
    qparams = llama.init_params(cfg, seed=PP_SEED + 1, dtype=torch.bfloat16, device=dev,
                                project=lambda w: card_quantize(torch, w))
    stage = stack_stages(mesh, qparams, PP_RANKS)
    if not last:
        del qparams
    torch.cuda.synchronize()
    qk.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = pipeline_forward_train(mesh, cfg, stage, ids, PP_MICRO)
    torch.cuda.synchronize()
    out["int4_ms"] = (time.perf_counter() - t0) * 1e3
    out["gemv_launches"] = qk.launch_counts["int4_gemv"]
    out["int4_layers"] = len(stage["layers"])
    del stage
    if last:
        with torch.no_grad():
            each = torch.cat([llama.forward_train(qparams, cfg, ids[m:m + 1]) for m in range(PP_MICRO)])
            whole = llama.forward_train(qparams, cfg, ids)
        out["int4_vs_each"] = [rel_l2(logits, each), float((logits - each).abs().max())]
        out["int4_vs_whole"] = [rel_l2(logits, whole), float((logits - whole).abs().max())]
        out["int4_finite"] = bool(torch.isfinite(logits).all())
        del qparams, each, whole, logits
    torch.cuda.empty_cache()

    # (a) the f32 steps, (c) the checkpoint after step 1
    gen = torch.Generator(device=dev).manual_seed(PP_SEED + 3)
    batch = torch.randint(0, cfg.vocab_size, (PP_BATCH, PP_SEQ + 1), device=dev, generator=gen)

    def params():
        return llama.init_params(cfg, seed=PP_SEED, dtype=torch.float32, device=dev)

    init, step = make_pp_train_step(mesh, cfg, PP_MICRO, learning_rate=TRAIN_LR, tx=pp_tx())
    state = init(stack_stages(mesh, params(), PP_RANKS))
    torch.cuda.empty_cache()
    losses, walls, p2p = [], [], []
    for i in range(PP_STEPS):
        before = list(pp.stats.get("p2p", [0, 0, 0.0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
        after = pp.stats["p2p"]
        p2p.append([after[0] - before[0], after[1] - before[1], after[2] - before[2]])
        if i == 0:
            t0 = time.perf_counter()
            save_train_state(root / "pp_ckpt", state, step=1)
            out["save_s"] = time.perf_counter() - t0
    out.update(losses=losses, step_ms=[w * 1e3 for w in walls], p2p=p2p)
    mine = {"/".join(map(str, p)): v.detach().cpu() for p, v in zip(*tree_flatten(state["params"]))}
    del state
    torch.cuda.empty_cache()
    if last:  # stage 1's params after the steps, for rank 0's comparison
        torch.save(mine, root / "pp_stage1.pt")
    out["peak_gib"] = torch.cuda.max_memory_reserved() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    (root / f"pp_rank{r}.json").write_text(json.dumps(out))
    dist.barrier()
    if r:
        return 0
    time.sleep(2.0)  # stage 1's process leaves the card

    # rank 0: the one-device step on the same batch, then the restore
    mine.update(torch.load(root / "pp_stage1.pt"))
    (root / "pp_stage1.pt").unlink()
    one = Mesh(("dp", "tp"), (1, 1), 0, "cuda:0")
    init1, step1 = make_train_step(one, cfg, learning_rate=TRAIN_LR, grad_accum=PP_MICRO, tx=pp_tx())
    state = init1(params())
    ref, ref_walls = [], []
    for _ in range(PP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step1(state, batch)
        ref.append(float(loss))
        ref_walls.append(time.perf_counter() - t0)
    ref_params = {"/".join(map(str, p)): v.detach() for p, v in zip(*tree_flatten(state["params"]))}
    del state
    torch.cuda.empty_cache()
    p0 = {"/".join(map(str, p)): v for p, v in zip(*tree_flatten(params()))}
    upd = 0.0
    for k, w in ref_params.items():
        d = w - p0[k]
        if bool((d != 0).any()):
            upd = max(upd, float(((mine[k].to(dev) - p0[k]) - d).norm() / d.norm()))
    del ref_params, p0, mine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored, at = restore_train_state(root / "pp_ckpt", init1(params()))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored, loss = step1(restored, batch)
    resumed = float(loss)
    del restored
    torch.cuda.empty_cache()
    res = {"ranks": [json.loads((root / f"pp_rank{q}.json").read_text()) for q in range(PP_RANKS)],
           "ref": ref, "ref_step_ms": [w * 1e3 for w in ref_walls], "update_rel": upd,
           "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, ref)), "restored_at": at,
           "restore_s": restore_s, "resumed": resumed, "ckpt_bytes": (root / "pp_ckpt" / "train_state.safetensors")
           .stat().st_size, "rank0_peak_gib": torch.cuda.max_memory_reserved() / 2**30,
           "rank0_wall_s": time.perf_counter() - t_start}
    shutil.rmtree(root / "pp_ckpt", ignore_errors=True)
    (root / "pp_ranks.json").write_text(json.dumps(res))
    return 0


def start_pp_ranks(root: Path) -> list:
    """Start [pp]'s two ranks sharing the card (the allocator's expandable
    segments: little reserved beyond what they hold). About 20 GiB a rank
    in the steps and 35 GiB for rank 0's one-device runs: main() starts
    them after [inputs], whose CLI merges fill the card, and they run
    beside [generate], [serve], [spec] and [tp], whose decode holds a few
    GiB; [pp] gates them before [train]'s ranks start."""
    port = free_port()
    procs = []
    for rank in range(PP_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(PP_RANKS),
               "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(PP_RANKS),
               "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
        with open(root / f"pp{rank}.out", "w") as o, open(root / f"pp{rank}.err", "w") as e:
            procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--pp-rank", str(root)],
                                          cwd=REPO, env=env, stdout=o, stderr=e))
    return procs


class CardMemory:
    """The card's used memory (``nvidia-smi``'s memory.used, every ranks'
    and this process's) sampled every ``period`` seconds on a thread: its
    peak over the window between ``start`` and ``stop``."""

    def __init__(self, period: float = 0.5):
        self.period, self.peak_mib, self.samples = period, 0, 0
        self._stop = threading.Event()
        self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                                      capture_output=True, text=True, timeout=10).stdout.split()
                self.peak_mib = max(self.peak_mib, int(used[0]))
                self.samples += 1
            except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
                pass
            self._stop.wait(self.period)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> float:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return self.peak_mib / 1024


class CardLease:
    """Turns at the card's largest allocations, between this process and
    [cp]/[ep]'s rank 0: an flock on ROOT/card.lease. Rank 0 holds it over
    each of the two ranks' stages (up to 57 GiB reserved over both) and
    gives it up between them, where both ranks are at a barrier with their
    cache emptied; this process holds it over its models of more than 10
    GiB (DeepSeek-V3, the capacity route's Mixtral engines, Scout's
    dequantized stacks), so the card's 80 GB never carries both. The main
    process marks ROOT/card.want while it waits, and rank 0 takes no new
    stage until that is gone; a wait longer than ``timeout`` raises."""

    def __init__(self, root: Path, timeout: float = 600.0):
        self.path, self.want, self.timeout = root / "card.lease", root / "card.want", timeout
        self.waited, self._fd = 0.0, None

    def take(self, yield_to_want: bool = False):
        import fcntl

        t0 = time.perf_counter()
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT)
        if not yield_to_want:
            self.want.touch()
        try:
            while True:
                if not (yield_to_want and self.want.exists()):
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except BlockingIOError:
                        pass
                if time.perf_counter() - t0 > self.timeout:
                    os.close(fd)
                    raise SystemExit(f"card lease: not taken in {self.timeout:.0f} s")
                time.sleep(0.05)
        finally:
            if not yield_to_want:
                self.want.unlink(missing_ok=True)
        self._fd = fd
        self.waited += time.perf_counter() - t0

    def drop(self):
        if self._fd is not None:
            os.close(self._fd)  # closing the descriptor releases the flock
            self._fd = None


def phase_pp(torch, root: Path, card: str, procs: list, memory: CardMemory) -> int:
    """[pp]: wait for the pipeline's two ranks (``start_pp_ranks``) and gate
    their report: the GEMV launched 7 x layers x microbatches on each rank
    and the int4 logits the per-microbatch one-device forward's (relL2 1e-5)
    and within 2e-2 of the whole batch's; the f32 steps within 1e-4 (losses)
    and relL2 1e-2 (updates) of the one-device step with grad_accum; each
    step's p2p record the predicted 2 M calls of M mb x T x 4096 x 4 bytes
    sent; the checkpoint restored on one device giving step 2's loss within
    1e-4. Returns the GEMV launches of both ranks' int4 forwards."""
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        codes = [None] * len(procs)
    finally:
        stop_procs(procs)
    waited = time.perf_counter() - t0
    peak = memory.stop()
    if codes != [0] * PP_RANKS:
        tails = "".join(f"\n--- rank {r} stderr:\n" + (root / f"pp{r}.err").read_text()[-3000:]
                        for r in range(PP_RANKS))
        raise SystemExit(f"[pp] ranks exited {codes}{tails}")
    res = json.loads((root / "pp_ranks.json").read_text())
    ranks = res["ranks"]
    want_gemv = [7 * rk["int4_layers"] * PP_MICRO for rk in ranks]
    got_gemv = [rk["gemv_launches"] for rk in ranks]
    each, whole = ranks[-1]["int4_vs_each"], ranks[-1]["int4_vs_whole"]
    ok_b = got_gemv == want_gemv and each[0] <= 1e-5 and whole[0] <= 2e-2 and ranks[-1]["int4_finite"]
    say(f"[pp] int4 forward, Llama-3.1-8B widths x {PP_LAYERS} layers on 2 stages ({ranks[0]['transport']}), bf16 "
        f"with int4 projections, {PP_MICRO} microbatches of 1 x {PP_INT4_SEQ} under no_grad: int4 GEMV launches "
        f"{got_gemv} by rank (predicted 7 x layers x microbatches = {want_gemv}); last stage's logits vs one "
        f"device's forward_train of each microbatch: relL2 {each[0]:.3e} (gate 1e-5), max-abs {each[1]:.3e}; vs the "
        f"whole batch's (256 rows, dense route): relL2 {whole[0]:.3e} (gate 2e-2), max-abs {whole[1]:.3e}; "
        f"{[round(rk['int4_ms'], 1) for rk in ranks]} ms by rank {'ok' if ok_b else 'FAIL'}")
    mb_bytes = PP_BATCH // PP_MICRO * PP_SEQ * LLAMA_31_8B["hidden_size"] * 4
    want_p2p = [2 * PP_MICRO, PP_MICRO * mb_bytes]
    p2p_ok = all([s[0], s[1]] == want_p2p for rk in ranks for s in rk["p2p"])
    ok_a = res["loss_rel"] <= 1e-4 and res["update_rel"] <= 1e-2 and p2p_ok
    ok_a &= all(math.isfinite(x) for rk in ranks for x in rk["losses"])
    say(f"[pp] f32 pp = 2 steps, Llama-3.1-8B widths x {PP_LAYERS} layers, adamw + clip, B x T = {PP_BATCH} x "
        f"{PP_SEQ} in {PP_MICRO} microbatches: losses {ranks[0]['losses']} vs one device (grad_accum {PP_MICRO}) "
        f"{res['ref']} (rel {res['loss_rel']:.2e}, gate 1e-4), updates relL2 {res['update_rel']:.2e} (gate 1e-2); "
        f"p2p [calls, bytes sent, seconds] a step by rank {[[[s[0], s[1], round(s[2], 3)] for s in rk['p2p']] for rk in ranks]} "
        f"(predicted [{want_p2p[0]}, {want_p2p[1]}]: {PP_MICRO} sends of {mb_bytes} bytes and {PP_MICRO} receives "
        f"a step a rank, 2 x {PP_MICRO} sends per stage boundary); step ms by rank "
        f"{[[round(x, 1) for x in rk['step_ms']] for rk in ranks]} vs one device "
        f"{[round(x, 1) for x in res['ref_step_ms']]} on {card} {'ok' if ok_a else 'FAIL'}")
    ok_c = res["restored_at"] == 1 and abs(res["resumed"] - ranks[0]["losses"][1]) <= 1e-4 * abs(ranks[0]["losses"][1])
    say(f"[pp] checkpoint of the pp = 2 state after step 1: {res['ckpt_bytes'] / 2**30:.2f} GiB saved in "
        f"{ranks[0]['save_s']:.1f} s (stage 1's leaves to rank 0 over the pp line), restored on one device in "
        f"{res['restore_s']:.1f} s (warm page cache); step 2 there {res['resumed']:.6f} vs the pipeline's "
        f"{ranks[0]['losses'][1]:.6f} (gate 1e-4 relative) {'ok' if ok_c else 'FAIL'}")
    say(f"[pp] ranks' work {[round(rk['wall_s'], 1) for rk in ranks]} s (rank 0 with its one-device runs "
        f"{res['rank0_wall_s']:.1f} s) beside [generate], [serve], [spec] and [tp]; [pp]'s own wall {waited:.1f} s waited; "
        f"peak reserved by rank {[round(rk['peak_gib'], 2) for rk in ranks]} GiB (rank 0 with its one-device runs "
        f"{res['rank0_peak_gib']:.2f}); the card's memory.used peak {peak:.2f} GiB over the window "
        f"({memory.samples} samples) on {card}")
    if not (ok_a and ok_b and ok_c):
        raise SystemExit("[pp] a pipeline gate failed: GEMV launches, int4 logits, f32 steps, p2p record or the "
                         "checkpoint's resume")
    if peak >= 80:
        raise SystemExit(f"[pp] the card's memory peak {peak:.2f} GiB reached 80")
    return sum(got_gemv)


# [cp] and [ep]: context and expert parallelism on two ranks sharing the card
# (one launch, gloo host-staged, f32). [cp]: Llama-3.1-8B widths, CP_LAYERS
# layers, one sequence of 2 x CP_TOKENS tokens, CP_TOKENS a rank. [ep]:
# Mixtral-8x7B widths, EP_LAYERS MoE layer, 8 experts top-2 cut 4 a rank,
# EP_BATCH x EP_SEQ tokens, the FFN also at EP_DECODE decode rows.
CPEP_RANKS = 2
CP_LAYERS, CP_TOKENS = 1, 4096
EP_LAYERS, EP_BATCH, EP_SEQ, EP_DECODE = 1, 4, 512, 8
CPEP_SEED = 61


def _whole_grads(lay, grads, on_rank0: bool) -> list:
    """Gradients joined over the split axis and summed over the data line,
    on the host of rank 0 (None elsewhere): collectives every rank runs."""
    out = []
    for i, g in enumerate(grads):
        g = lay.gather_tp(i, g)
        if lay.dp > 1:
            g = lay.dp_comm.all_reduce(g)
        out.append(g.cpu() if on_rank0 else None)
    return out


def _grad_gap(torch, got: list, want: list) -> float:
    """The largest per-leaf relL2 over the leaves with a nonzero reference."""
    worst = 0.0
    for a, b in zip(got, want):
        n = float(b.norm())
        if n > 0:
            worst = max(worst, float((a - b).norm()) / n)
    return worst


def cpep_rank(root: Path) -> int:
    """One rank of [cp] and [ep] (``python3 chip_smoke.py --cpep-rank ROOT``
    with torchrun's variables; gloo, host-staged, f32).

    [cp] on a ("cp",) = (2,) mesh: rank 0 first runs one device's _loss_fn
    and its gradients over the whole sequence and keeps them on the host;
    then both ranks run make_cp_loss (the ring, one K/V transfer each way a
    layer) and its gradients, summed over the line on rank 0, and one
    make_cp_train_step step (adamw, ZeRO-1 over cp), its p2p record, ring
    hops and wall.
    [ep] on an ("ep",) = (2,) mesh: rank 0 runs the dense-and-mask
    one-device loss and gradients on the expert lists; both ranks run
    make_ep_loss (full capacity) and its gradients (the experts joined over
    the line on rank 0) and one make_ep_train_step step; then
    expert_parallel_ffn at EP_DECODE rows against the one-device dense FFN
    (full capacity) and _moe_capacity (factor 1.25). Rank 0 takes each
    stage's turn at the card (:class:`CardLease`). Each rank writes
    ROOT/cpep_rank{r}.json."""
    import torch
    import torch.distributed as dist

    from shardmerge_tpu_torch.models import llama
    from shardmerge_tpu_torch.parallel import moe as pmoe
    from shardmerge_tpu_torch.parallel import ring as pring
    from shardmerge_tpu_torch.parallel.mesh import make_mesh
    from shardmerge_tpu_torch.parallel.optim import adamw
    from shardmerge_tpu_torch.parallel.train import (_Layout, _loss_fn, make_cp_loss, make_cp_train_step,
                                                     tree_flatten, tree_unflatten)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = {}

    def leaves_of_(p):
        leaves = [v.detach().requires_grad_(True) for v in tree_flatten(p)[1]]
        return leaves, tree_unflatten(p, leaves)

    def grads_of(loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(v) if g is None else g for g, v in zip(grads, leaves)]

    lease = CardLease(root) if int(os.environ["RANK"]) == 0 else None

    def mark(stage: str, last: bool = False):
        """Close a stage: the cache emptied, its peak GiB allocated and
        reserved noted, a fresh window; then, with both ranks at a barrier,
        rank 0 gives the card lease up and takes it for the next stage
        (none after the last)."""
        torch.cuda.empty_cache()
        out.setdefault("memory", []).append([stage, round(torch.cuda.max_memory_allocated() / 2**30, 2),
                                             round(torch.cuda.max_memory_reserved() / 2**30, 2)])
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        if lease is not None:
            lease.drop()
            if not last:
                lease.take(yield_to_want=True)
        dist.barrier()

    # [cp]
    mesh = make_mesh(("cp",), shape=(CPEP_RANKS,))
    r, comm = mesh.coords["cp"], mesh.comm("cp")
    if lease is not None:
        lease.take(yield_to_want=True)
    dist.barrier()
    out["transport"] = comm.transport
    cfg = train_cfg(CP_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(CPEP_SEED)
    batch = torch.randint(0, cfg.vocab_size, (1, CPEP_RANKS * CP_TOKENS + 1), device=dev, generator=gen)
    params = llama.init_params(cfg, seed=CPEP_SEED, dtype=torch.float32, device=dev)
    ref = None
    if r == 0:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves, p = leaves_of_(params)
        loss = _loss_fn(p, cfg, batch)
        ref = (float(loss.detach()), [g.cpu() for g in grads_of(loss, leaves)])
        del loss, leaves, p
        torch.cuda.synchronize()
        out["cp_one_device_s"] = time.perf_counter() - t0
        out["cp_one_device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    mark("cp one device")
    loss_fn = make_cp_loss(mesh, cfg, params)
    leaves, p = leaves_of_(loss_fn.place(params))
    before, hops = list(comm.stats.get("p2p", [0, 0, 0.0])), pring.stats["hops"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(p, batch)
    grads = grads_of(loss, leaves)
    torch.cuda.synchronize()
    out["cp_loss_ms"] = (time.perf_counter() - t0) * 1e3
    after = comm.stats["p2p"]
    out["cp_p2p"] = [after[0] - before[0], after[1] - before[1], after[2] - before[2]]
    out["cp_hops"] = pring.stats["hops"] - hops
    out["cp_loss"] = float(loss.detach())
    lay = _Layout(mesh, params, [None] * len(leaves), data_axes=("cp",))
    whole = _whole_grads(lay, grads, r == 0)
    del loss, grads, leaves, p
    if r == 0:
        out["cp_ref_loss"], out["cp_grad_rel"] = ref[0], _grad_gap(torch, whole, ref[1])
        out["cp_finite"] = all(bool(torch.isfinite(g).all()) for g in whole)
    del whole, ref
    torch.cuda.empty_cache()
    out["cp_ring_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    mark("cp ring")
    init, step = make_cp_train_step(mesh, cfg, params, zero1=True, tx=adamw(TRAIN_LR))
    state = init(params)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    out["cp_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["cp_step_loss"] = float(loss)
    out["cp_step_finite"] = all(bool(torch.isfinite(v).all()) for v in tree_flatten(state["params"])[1])
    out["cp_collectives"] = {k: v[:2] for k, v in comm.stats.items()}
    out["cp_peak_gib"] = torch.cuda.max_memory_reserved() / 2**30
    del state
    torch.cuda.empty_cache()
    mark("cp step")

    # [ep]
    mesh = make_mesh(("ep",), shape=(CPEP_RANKS,))
    r, comm = mesh.coords["ep"], mesh.comm("ep")
    ecfg = llama.ModelConfig.from_hf_config({**MIXTRAL_HF, "num_hidden_layers": EP_LAYERS})
    batch = torch.randint(0, ecfg.vocab_size, (EP_BATCH, EP_SEQ + 1), device=dev, generator=gen)
    params = llama.init_params(ecfg, seed=CPEP_SEED + 1, dtype=torch.float32, device=dev)
    names = ["/".join(map(str, q)) for q in tree_flatten(params)[0]]  # the expert lists' leaves
    ref = None
    if r == 0:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves, p = leaves_of_(params)
        loss = _loss_fn(p, ecfg, batch)
        ref = (float(loss.detach()), dict(zip(names, (g.cpu() for g in grads_of(loss, leaves)))))
        del loss, leaves, p
        torch.cuda.synchronize()
        out["ep_one_device_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    mark("ep one device")
    llama.stack_expert_weights(params)
    x = torch.randn((EP_DECODE, 1, ecfg.hidden_size), device=dev, generator=gen)
    layer = params["layers"][0]
    dense_ffn = llama._experts_train(ecfg, layer, x, None)  # stacked, dense dispatch: every expert
    cap_ffn = llama._moe_capacity(ecfg, layer, x, 1.25)
    gate_w, gate_bias, W1, W3, W2 = pmoe.shard_experts(mesh, layer)
    ffn = {}
    for label, cf in (("full", None), ("1.25", 1.25)):
        pmoe.expert_parallel_ffn(mesh, ecfg, gate_w, gate_bias, W1, W3, W2, x, capacity_factor=cf)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pmoe.expert_parallel_ffn(mesh, ecfg, gate_w, gate_bias, W1, W3, W2, x, capacity_factor=cf)
        torch.cuda.synchronize()
        ffn[label] = [rel_l2(y, dense_ffn if cf is None else cap_ffn), (time.perf_counter() - t0) * 1e3]
    idx, w = llama.route_experts(ecfg, gate_w, None, x.reshape(EP_DECODE, -1))
    C = llama.capacity_of(ecfg, EP_DECODE, 1.25)
    out["ep_decode"] = ffn
    out["ep_decode_kept"] = [int((llama.capacity_tables_from_topk(idx, w, 8, C)[1] != 0).sum()), EP_DECODE * 2, C]
    del W1, W3, W2, layer, dense_ffn, cap_ffn
    mark("ep stacks, decode FFN")
    # the loss and gradients on this rank's experts, then the train state (the
    # whole stacks go once it holds its own copy)
    torch.cuda.empty_cache()
    loss_fn = pmoe.make_ep_loss(mesh, ecfg, params)
    local = pmoe.ep_params(mesh, params)
    lay = _Layout(mesh, params, pmoe._ep_cuts(mesh, params), split_axis="ep")
    leaves, p = leaves_of_(local)
    before = {k: list(v) for k, v in comm.stats.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(p, batch)
    grads = grads_of(loss, leaves)
    torch.cuda.synchronize()
    out["ep_loss_ms"] = (time.perf_counter() - t0) * 1e3
    out["ep_collectives"] = {k: [v[0] - before.get(k, [0, 0])[0], v[1] - before.get(k, [0, 0])[1]]
                             for k, v in comm.stats.items()}
    out["ep_loss"] = float(loss.detach())
    del loss, leaves, p, local
    whole = _whole_grads(lay, grads, r == 0)
    del grads
    if r == 0:  # the stacked gradients under the expert lists' names
        got = {}
        for path, g in zip(lay.paths, whole):
            if "experts_stacked" in path:
                for e in range(g.shape[0]):
                    got[f"layers/{path[1]}/experts/{e}/{('w1', 'w3', 'w2')[path[3]]}"] = g[e]
            else:
                got["/".join(map(str, path))] = g
        out["ep_ref_loss"] = ref[0]
        out["ep_grad_rel"] = _grad_gap(torch, [got[k] for k in ref[1]], list(ref[1].values()))
    del whole, ref
    torch.cuda.empty_cache()
    mark("ep loss")
    init, step = pmoe.make_ep_train_step(mesh, ecfg, params, tx=adamw(TRAIN_LR))
    state = init(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    out["ep_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["ep_step_loss"] = float(loss)
    out["ep_step_finite"] = all(bool(torch.isfinite(v).all()) for v in tree_flatten(state["params"])[1])
    out["ep_local_experts"] = int(state["params"]["layers"][0]["experts_stacked"][0].shape[0])
    out["ep_peak_gib"] = torch.cuda.max_memory_reserved() / 2**30
    del state
    mark("ep step", last=True)
    out["wall_s"] = time.perf_counter() - t_start
    out["lease_wait_s"] = lease.waited if lease is not None else 0.0
    (root / f"cpep_rank{r}.json").write_text(json.dumps(out))
    return 0


def start_cpep_ranks(root: Path) -> list:
    """Start [cp]/[ep]'s two ranks sharing the card (expandable segments)."""
    port = free_port()
    procs = []
    for rank in range(CPEP_RANKS):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(CPEP_RANKS),
               "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(CPEP_RANKS),
               "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", "SHARDMERGE_HEARTBEAT_TIMEOUT_S": "600"}
        with open(root / f"cpep{rank}.out", "w") as o, open(root / f"cpep{rank}.err", "w") as e:
            procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--cpep-rank", str(root)],
                                          cwd=REPO, env=env, stdout=o, stderr=e))
    return procs


def start_after(first: list, root: Path) -> dict:
    """Start [cp]/[ep]'s ranks (:func:`start_cpep_ranks`) on a thread once
    the processes ``first`` (the [train] ranks) have exited, so the two
    launches never hold the card together. Returns the holder
    :func:`phase_cp_ep` waits on."""
    holder = {"procs": [], "started": None, "stop": threading.Event(), "memory": None}

    def run():
        for p in first:
            p.wait()
        if holder["stop"].is_set():
            return
        holder["started"] = time.perf_counter()
        holder["memory"] = CardMemory().start()
        holder["procs"] = start_cpep_ranks(root)

    holder["thread"] = threading.Thread(target=run, daemon=True)
    holder["thread"].start()
    return holder


def phase_cp_ep(torch, root: Path, card: str, holder: dict, lease: CardLease):
    """[cp] and [ep]: wait for the two ranks (:func:`start_after`) and gate
    their report: the ring's loss within 1e-4 relative and every gradient
    within relL2 1e-3 of one device's _loss_fn; the ring's p2p record the
    predicted one transfer each way a layer of the stacked K/V block (2 x
    B x KVH x CP_TOKENS x head_dim x 4 bytes), its hops 2 a layer; the
    train step's loss the ring's, its params finite; the ep loss and
    gradients within 1e-4 / 1e-3 of the dense-and-mask one-device step's;
    the ep decode FFN within relL2 1e-5 of the one-device dense FFN (full
    capacity) and of _moe_capacity (factor 1.25); each rank 4 of 8
    experts."""
    t0 = time.perf_counter()
    holder["thread"].join(timeout=600)
    procs = holder["procs"]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        codes = [None] * len(procs)
    finally:
        stop_procs(procs)
    waited = time.perf_counter() - t0
    memory = holder["memory"]
    peak = memory.stop() if memory is not None else float("nan")
    if not procs or codes != [0] * CPEP_RANKS:
        tails = "".join(f"\n--- rank {r} stderr:\n" + (root / f"cpep{r}.err").read_text()[-3000:]
                        for r in range(CPEP_RANKS) if (root / f"cpep{r}.err").exists())
        raise SystemExit(f"[cp]/[ep] ranks exited {codes}{tails}")
    ranks = [json.loads((root / f"cpep_rank{r}.json").read_text()) for r in range(CPEP_RANKS)]
    r0 = ranks[0]
    h, kvh, hd = LLAMA_31_8B["hidden_size"], LLAMA_31_8B["num_key_value_heads"], 128
    kv_bytes = 2 * 1 * kvh * CP_TOKENS * hd * 4
    want_p2p = [2 * CP_LAYERS, 2 * CP_LAYERS * kv_bytes]
    loss_rel = abs(r0["cp_loss"] - r0["cp_ref_loss"]) / abs(r0["cp_ref_loss"])
    ok_cp = loss_rel <= 1e-4 and r0["cp_grad_rel"] <= 1e-3 and r0["cp_finite"] and r0["cp_step_finite"]
    ok_cp &= all(rk["cp_p2p"][:2] == want_p2p and rk["cp_hops"] == 2 * CP_LAYERS for rk in ranks)
    ok_cp &= all(abs(rk["cp_step_loss"] - r0["cp_loss"]) <= 1e-6 * abs(r0["cp_loss"]) for rk in ranks)
    say(f"[cp] ring attention on 2 ranks sharing the card ({r0['transport']}), Llama-3.1-8B widths (hidden {h}, "
        f"32/8 heads, head_dim 128, ffn 14336, vocab 128256) x {CP_LAYERS} layer, f32, one sequence of "
        f"{CPEP_RANKS * CP_TOKENS} tokens, {CP_TOKENS} a rank: loss {r0['cp_loss']:.6f} vs one device's _loss_fn "
        f"{r0['cp_ref_loss']:.6f} (rel {loss_rel:.2e}, gate 1e-4), gradients summed over the ring's ranks vs one "
        f"device's: worst leaf relL2 {r0['cp_grad_rel']:.2e} (gate 1e-3); ring hops a loss and backward "
        f"{[rk['cp_hops'] for rk in ranks]} by rank; p2p [calls, bytes sent, seconds] by rank "
        f"{[[x if i < 2 else round(x, 3) for i, x in enumerate(rk['cp_p2p'])] for rk in ranks]} (predicted "
        f"{want_p2p}: the stacked K/V block of {kv_bytes} bytes once forward, its gradient once back); loss and "
        f"backward {[round(rk['cp_loss_ms'], 1) for rk in ranks]} ms by rank vs one device "
        f"{r0['cp_one_device_s'] * 1e3:.1f} ms "
        f"(its peak {r0['cp_one_device_peak_gib']:.2f} GiB allocated, the ring's "
        f"{[round(rk['cp_ring_peak_gib'], 2) for rk in ranks]} GiB by rank); make_cp_train_step (adamw, ZeRO-1) step "
        f"{[round(rk['cp_step_ms'], 1) for rk in ranks]} ms by rank, loss {r0['cp_step_loss']:.6f}; collectives "
        f"[calls, bytes] {r0['cp_collectives']}; peak reserved {[round(rk['cp_peak_gib'], 2) for rk in ranks]} GiB "
        f"on {card} {'ok' if ok_cp else 'FAIL'}")
    ep_rel = abs(r0["ep_loss"] - r0["ep_ref_loss"]) / abs(r0["ep_ref_loss"])
    dec = r0["ep_decode"]
    ok_ep = ep_rel <= 1e-4 and r0["ep_grad_rel"] <= 1e-3 and all(rk["ep_step_finite"] for rk in ranks)
    ok_ep &= all(rk["ep_local_experts"] == 4 for rk in ranks) and all(rk["ep_decode"]["full"][0] <= 1e-5 and
                                                                    rk["ep_decode"]["1.25"][0] <= 1e-5 for rk in ranks)
    ok_ep &= all(abs(rk["ep_step_loss"] - r0["ep_loss"]) <= 1e-6 * abs(r0["ep_loss"]) for rk in ranks)
    say(f"[ep] expert parallelism on 2 ranks sharing the card, Mixtral-8x7B widths (8 experts top-2, moe ffn "
        f"14336, hidden 4096, vocab 32000) x {EP_LAYERS} MoE layer, f32, 4 experts a rank, B x T = {EP_BATCH} x "
        f"{EP_SEQ} at full capacity: loss {r0['ep_loss']:.6f} vs the dense-and-mask one device "
        f"{r0['ep_ref_loss']:.6f} (rel {ep_rel:.2e}, gate 1e-4), gradients (experts joined over ep) worst leaf "
        f"relL2 {r0['ep_grad_rel']:.2e} (gate 1e-3); loss and backward "
        f"{[round(rk['ep_loss_ms'], 1) for rk in ranks]} ms "
        f"by rank vs one device {r0['ep_one_device_s'] * 1e3:.1f} ms; collectives a loss and backward [calls, bytes] "
        f"{r0['ep_collectives']}; make_ep_train_step (adamw) step {[round(rk['ep_step_ms'], 1) for rk in ranks]} ms; "
        f"expert_parallel_ffn at {EP_DECODE} decode rows: full capacity vs the one-device dense FFN relL2 "
        f"{dec['full'][0]:.2e} ({dec['full'][1]:.2f} ms), factor 1.25 (C = {r0['ep_decode_kept'][2]}, "
        f"{r0['ep_decode_kept'][0]} of {r0['ep_decode_kept'][1]} assignments kept) vs _moe_capacity relL2 "
        f"{dec['1.25'][0]:.2e} ({dec['1.25'][1]:.2f} ms) (gate 1e-5); peak reserved "
        f"{[round(rk['ep_peak_gib'], 2) for rk in ranks]} GiB on {card} {'ok' if ok_ep else 'FAIL'}")
    say(f"[cp]/[ep] peak GiB [allocated, reserved] by stage and rank: "
        f"{[{st: [a, b] for st, a, b in rk['memory']} for rk in ranks]}")
    say(f"[cp]/[ep] ranks' work {[round(rk['wall_s'], 1) for rk in ranks]} s, started "
        f"{t0 - holder['started']:.1f} s before this wait, which took {waited:.1f} s; turns at the card "
        f"(CardLease) waited for: rank 0 {r0['lease_wait_s']:.1f} s, this process {lease.waited:.1f} s (DeepSeek-V3, "
        f"the capacity route, Scout); the card's memory.used peak "
        f"{peak:.2f} GiB over the ranks' window ({memory.samples if memory else 0} samples) on {card}")
    if not (ok_cp and ok_ep):
        raise SystemExit("[cp]/[ep] a gate failed: loss, gradients, p2p record, hops, step, or the decode FFN")
    if peak >= 80:
        raise SystemExit(f"[cp]/[ep] the card's memory peak {peak:.2f} GiB reached 80")


def write_word_tokenizer(path: Path, vocab: int, **config):
    """A word-level tokenizer.json (word ``w{i}`` is token i) and its
    tokenizer_config.json, which fixes the class (without it transformers
    takes config.json's model type's, which may add a BOS) and carries
    ``config`` (a chat_template, an eos_token)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({f"w{i}": i for i in range(vocab)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "w0", **config}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.models import attn_kernels as ak
    from shardmerge_tpu_torch.models import quant_kernels as qk
    from shardmerge_tpu_torch.ops import fft_vpu as fv
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: {torch.cuda.get_device_name(0)}")

    clock = [time.perf_counter()]

    def lap(label: str):
        now = time.perf_counter()
        say(f"[time] {label} {now - clock[0]:.1f} s")
        clock[0] = now

    phase_build([qk, ak, pf, fv])
    lap("build")
    int4 = phase_kernel(torch, qk)
    flash = phase_flash(torch, ak)
    phase_geometries(torch, ak)
    lap("kernel, flash, geometry")
    fft, fft_launches = phase_fft(torch, pf, fv)
    lap("fft")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    ranks, pp_ranks, cpep = [], [], {"procs": []}
    lease = CardLease(root)  # [cp]/[ep]'s rank 0 and this process's largest models take turns
    try:
        t0 = time.perf_counter()
        dirs, shapes = write_checkpoints(torch, root)
        say(f"[checkpoints] base + 2 finetunes, {len(shapes)} tensors each, Llama-3.1-8B widths, "
            f"{LAYERS} layers, bf16, written in {time.perf_counter() - t0:.1f} s")
        merged, merge_tensor_s = phase_merge(torch, root, dirs)
        pipeline_profile(torch, "merge 2-ft", root / "merged.json", card)
        lap("checkpoints, merge")
        stack_dirs, stack3_spans, stack_host = phase_stack(torch, root, dirs, card)
        lap("stack")
        phase_shard(torch, root, {**stack_dirs, "ft2": dirs[2]}, merged, merge_tensor_s, card)
        lap("shard")
        stack_host()  # [stack]'s host checks, run beside the variants and [shard]
        lap("stack's host checks, after [shard]")
        phase_engines(torch, root, stack_dirs, card)
        mask_times(torch, card)
        lap("engines")
        phase_inputs(torch, root, stack_dirs, dirs[2], stack3_spans, card)
        lap("inputs")
        torch.cuda.empty_cache()
        memory = CardMemory().start()
        pp_ranks = start_pp_ranks(root)  # [pp]'s two stages, beside [generate], [serve], [spec] and [tp]
        engine, _ = phase_generate(torch, merged)
        lap("generate")
        launches = phase_serve(torch, engine)
        lap("serve")
        phase_spec(torch, engine, card)
        lap("spec")
        phase_tp(torch, root, merged, engine, card)
        lap("tp")
        pp_launches = phase_pp(torch, root, card, pp_ranks, memory)  # before [train]'s ranks take the card
        lap("pp")
        del engine
        torch.cuda.empty_cache()
        ranks = start_train_ranks(root)  # [train]'s two ranks, beside [families] and [experts]
        cpep = start_after(ranks, root)  # then [cp]/[ep]'s two, beside [experts] and [sinks-chunked]
        with ThreadPoolExecutor(1) as cli:  # Phi-3's generate process, beside [families] and [experts]
            phi3_done = phase_families(torch, root, card, cli)
            lap("families")
            capacity_launches = phase_experts(torch, root, card, lease, waits=(phi3_done,))
        lap("experts")
        phase_sinks_chunked(torch, root, card, lease)
        lap("sinks-chunked")
        phase_cp_ep(torch, root, card, cpep, lease)  # before [train]'s one-device step takes the card
        lap("cp, ep")
        reset_counts(qk)
        train_launches = phase_train(torch, qk, root, card, ranks)
        lap("train")
    finally:
        stop_procs(ranks)
        stop_procs(pp_ranks)
        if "thread" in cpep:
            cpep["stop"].set()
            cpep["thread"].join(timeout=600)
        stop_procs(cpep["procs"])
        shutil.rmtree(root, ignore_errors=True)

    # launches: the serve path's run for the decode kernels, the [fft]
    # round trip for the transforms; the GEMV's [train] QLoRA steps apart
    # (train_launches); times at those paths' shapes (B=8
    # GEMVs, the pool's B=8 x 4096-slot attention, the (4096, 8192) round
    # trip: both DFT axes, the Stockham rows pass (4096, 4096))
    say(json.dumps({"kernels": [
        {
            "name": "int4_gemv",
            "route": "cuda",
            "source": "shardmerge_tpu_torch/csrc/int4_gemv.cu",
            "replaces": "shardmerge_tpu/models/quant_kernels.py:148",
            "launches": launches["int4_gemv"],
            "train_launches": train_launches,
            "pp_launches": pp_launches,
            **int4,
        },
        {
            "name": "flash_decode",
            "route": "cuda",
            "source": "shardmerge_tpu_torch/csrc/flash_decode.cu",
            "replaces": "shardmerge_tpu/models/attn_kernels.py:152",
            "launches": launches["flash_decode"],
            "capacity_launches": capacity_launches,
            **flash,
        },
        {
            "name": "dft_rows",
            "route": "cuda",
            "source": "shardmerge_tpu_torch/csrc/four_step_dft.cu",
            "replaces": "shardmerge_tpu/ops/pallas_fft.py:157",
            "launches": fft_launches["dft_rows"],
            **fft["dft_rows"],
        },
        {
            "name": "dft_cols",
            "route": "cuda",
            "source": "shardmerge_tpu_torch/csrc/four_step_dft.cu",
            "replaces": "shardmerge_tpu/ops/pallas_fft.py:222",
            "launches": fft_launches["dft_cols"],
            **fft["dft_cols"],
        },
        {
            "name": "fft_batched",
            "route": "cuda",
            "source": "shardmerge_tpu_torch/csrc/stockham_fft.cu",
            "replaces": "shardmerge_tpu/ops/fft_vpu.py:185",
            "launches": fft_launches["fft_batched"],
            **fft["fft_batched"],
        },
    ]}))
    say(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(train_rank(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--pp-rank"]:
        sys.exit(pp_rank(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--cpep-rank"]:
        sys.exit(cpep_rank(Path(sys.argv[2])))
    sys.exit(main())
