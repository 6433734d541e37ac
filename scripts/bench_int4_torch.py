#!/usr/bin/env python3
"""Time the port's int4 GEMV kernel (``int4_matmul`` of
shardmerge_tpu_torch/models/quant_kernels.py) on one CUDA card at the
Llama-3.1-8B and Llama-3.1-70B decode shapes, B = 1, 4, 8, 32, 64.

    python3 scripts/bench_int4_torch.py [--reps 25] [--previous OLD_int4_gemv.cu] [--f32]

Builds csrc/int4_gemv.cu with ptxas's register report, then for each (N, K)
and B: relL2 against ``int4_matmul_plain`` (gates: 4e-3 for bf16 x, 1e-5
for f32 x), the kernel's device time per call (CUDA graphs of a reading L2 flush
+ call against graphs of the flushes alone, so the weights are cold and no
host launch time counts), its CUDA-event time around one call (host launch included,
as chip_smoke.py's earlier tables were taken), GB/s
of packed weight bytes, the bound (packed weights, scales, x and y bytes
at 3.35 TB/s, or the flops at the bf16 tensor-core rate, whichever is
larger) and the bf16 dense ``torch.matmul`` over the same (N, K) (4x the
weight bytes). ``--previous`` builds another source of the kernel with the
earlier C entry point (x, q, scale, y, B, N, K/2, dtype, stream) and times
it the same way, in turn with the current one. Then one decode layer's
seven GEMVs summed per model and B, and the nearest library int4 call
(``torch._weight_int4pack_mm``) where the card's torch runs it. The last
line is the card's name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
ROWS = (1, 4, 8, 32, 64)
# (N, K) of one decode layer's seven GEMVs: q, k, v, o, gate, up, down
LAYERS = {
    "8B": [(4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096), (14336, 4096), (14336, 4096), (4096, 14336)],
    "70B": [(8192, 8192), (1024, 8192), (1024, 8192), (8192, 8192), (28672, 8192), (28672, 8192), (8192, 28672)],
}


def event_ms(torch, fn, flush, reps):
    """Median CUDA-event time of one call, L2 flushed before each; the
    events enclose the host's launch of the call too."""
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
    return sorted(times)[len(times) // 2]


def graph_ms(torch, fn, flush, reps=20, trials=7):
    """Time of one call on the device alone: a CUDA graph of ``reps`` x
    (flush the L2, call) against a graph of the flushes alone, replayed in
    turn ``trials`` times; the median difference over ``reps``. No host
    launch time is in it (the calls are replayed from the graph). The flush
    reads a buffer twice the L2's size, so the call finds the L2 full of
    clean lines, as a decode step finds it after the previous layer's
    weights; a flush that writes would leave dirty lines whose write-back
    the call would pay for."""
    fn()
    flush.sum()
    torch.cuda.synchronize()
    with_fn, alone = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(with_fn):
        for _ in range(reps):
            flush.sum()
            fn()
    with torch.cuda.graph(alone):
        for _ in range(reps):
            flush.sum()

    def replay(g):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    replay(with_fn), replay(alone)
    diffs = sorted(replay(with_fn) - replay(alone) for _ in range(trials))
    del with_fn, alone
    return diffs[trials // 2] / reps


def bound_ms(n, k, rows, x_bytes):
    nbytes = n * k // 2 + 4 * n + x_bytes * rows * (k + n)
    flops = 2 * rows * n * k
    return max(nbytes / HBM_BYTES_PER_S, flops / (BF16_FLOPS if x_bytes == 2 else F32_FLOPS)) * 1e3


def previous_kernel(torch, source: Path):
    """A callable (x, q, scale) -> y over the earlier design's entry point."""
    from shardmerge_tpu_torch import kernel_build

    def bind(lib):
        lib.int4_gemv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.int4_gemv.restype = ctypes.c_int

    lib = kernel_build.load(source.resolve(), bind)

    def call(x, q, s):
        y = torch.empty((x.shape[0], q.shape[0]), dtype=x.dtype, device=x.device)
        err = lib.int4_gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), x.shape[0], q.shape[0],
                            q.shape[1], 0 if x.dtype == torch.float32 else 1,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous int4_gemv: cudaError {err}")
        return y

    return call


def library_int4(torch, q, s):
    """``torch._weight_int4pack_mm`` over the same weights, or the reason it
    does not run: the packed values u = W + 8 in natural column order (the
    split halves joined), zero point 0, the channel scale in bf16 repeated
    over 256-column groups (so not bit-equal to the kernel)."""
    n, kh = q.shape
    try:
        u = torch.cat([q & 0xF, q >> 4], dim=1).to(torch.int32)  # (N, K), natural column order
        packed_u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
        packed = torch._convert_weight_to_int4pack(packed_u8, 8)
        groups = 2 * kh // 256
        sz = torch.zeros((groups, n, 2), dtype=torch.bfloat16, device=q.device)
        sz[..., 0] = s.reshape(1, n).to(torch.bfloat16)
        return lambda x: torch._weight_int4pack_mm(x, packed, 256, sz), None
    except Exception as exc:  # a yardstick only: report why it does not run
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--previous", type=Path, help="an earlier int4_gemv.cu to time beside the current one")
    ap.add_argument("--f32", action="store_true", help="also time f32 x at the 8B shapes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_int4_torch: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.models import quant_kernels as qk

    qk.build(verbose=True)
    old = previous_kernel(torch, args.previous) if args.previous else None
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)  # over twice the 50 MB L2
    ok = True
    layer = {}  # (model, B) -> summed ms per column
    cases = [(m, dtype, nk) for m in LAYERS for dtype in (torch.bfloat16,) for nk in dict.fromkeys(LAYERS[m])]
    if args.f32:
        cases += [("8B", torch.float32, nk) for nk in dict.fromkeys(LAYERS["8B"])]
    for model, dtype, (n, k) in cases:
        q = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=dev, generator=gen)
        s = torch.rand((n, 1), dtype=torch.float32, device=dev, generator=gen) * 0.02 + 1e-3
        w_dense = (torch.randn((n, k), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        lib, why = library_int4(torch, q, s) if dtype == torch.bfloat16 else (None, "bf16 x only")
        tol = 4e-3 if dtype == torch.bfloat16 else 1e-5
        for b in ROWS:
            x = torch.randn((b, k), device=dev, generator=gen).to(dtype)
            got = qk.int4_matmul(x, q, s)
            want = qk.int4_matmul_plain(x, q, s)
            rel = float((got.float() - want.float()).norm() / want.float().norm())
            ok &= rel <= tol and bool(torch.isfinite(got).all())
            p = qk.plan(n, k)
            row = {
                "kernel": graph_ms(torch, lambda: qk.int4_matmul(x, q, s), flush, args.reps),
                "kernel_event": event_ms(torch, lambda: qk.int4_matmul(x, q, s), flush, args.reps),
            }
            if old is not None:
                old_rel = float((old(x, q, s).float() - want.float()).norm() / want.float().norm())
                row["previous"] = graph_ms(torch, lambda: old(x, q, s), flush, args.reps)
                row["previous_event"] = event_ms(torch, lambda: old(x, q, s), flush, args.reps)
                row["kernel_again"] = graph_ms(torch, lambda: qk.int4_matmul(x, q, s), flush, args.reps)
            xd = x.to(torch.bfloat16)
            row["dense_bf16"] = graph_ms(torch, lambda: torch.matmul(xd, w_dense.T), flush, args.reps)
            lib_note = f"not run ({why})"
            if lib is not None:
                try:
                    lib_rel = float((lib(xd).float() - want.float()).norm() / want.float().norm())
                    row["library_int4"] = graph_ms(torch, lambda: lib(xd), flush, args.reps)
                    lib_note = f"{row['library_int4']:.4f} ms (relL2 {lib_rel:.1e}, bf16 scales)"
                except Exception as exc:
                    lib_note = f"not run ({type(exc).__name__}: {str(exc).splitlines()[0][:160]})"
            bnd = bound_ms(n, k, b, x.element_size())
            gbs = q.numel() / (row["kernel"] * 1e-3) / 1e9
            prev = (f" | previous design {row['previous']:.4f} ms device, {row['previous_event']:.4f} ms event "
                    f"(relL2 {old_rel:.1e}); kernel again {row['kernel_again']:.4f} ms" if old else "")
            print(f"{model} {str(dtype)[6:]:8s} N={n:5d} K={k:5d} B={b:2d} plan {p.splits}x{p.chunks_per_split} "
                  f"relL2 {rel:.2e} (tol {tol:.0e}) | kernel {row['kernel']:.4f} ms device ({gbs:.0f} GB/s of "
                  f"packed bytes, {bnd / row['kernel']:.0%} of bound), {row['kernel_event']:.4f} ms event | bound "
                  f"{bnd:.4f} ms | bf16 dense torch.matmul (4x the bytes) {row['dense_bf16']:.4f} ms | library "
                  f"int4 _weight_int4pack_mm {lib_note}{prev}", flush=True)
            if dtype == torch.bfloat16:
                mult = LAYERS[model].count((n, k))
                acc = layer.setdefault((model, b), {})
                for key, v in row.items():
                    acc[key] = acc.get(key, 0.0) + mult * v
                acc["bound"] = acc.get("bound", 0.0) + mult * bnd
            del x, got, want
        del q, s, w_dense, lib
    for (model, b), acc in layer.items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
        print(f"one {model} decode layer's 7 bf16 GEMVs, B={b}: {parts} (ms)", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
