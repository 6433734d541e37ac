#!/usr/bin/env python3
"""Time the port's DFT kernels (``dft_rows``, ``dft_cols`` of
shardmerge_tpu_torch/ops/pallas_fft.py) on one CUDA card, beside
``torch.fft.fft`` (cuFFT) along the same axis and the byte bound.

    python3 scripts/bench_dft_torch.py [--reps 25]

Builds csrc/four_step_dft.cu with ptxas's register report, then for each
Llama-3.1-8B shape and axis: the kernel's route, its relL2 against a
complex128 ``torch.fft`` truth (gate 1e-5), and median CUDA-event times
with the L2 flushed before each launch, and the device time per call under
torch.profiler (host time excluded). The last line is the card's name and
power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 data sheet
CASES = [("dft_rows", (4096, 8192)), ("dft_cols", (4096, 8192)), ("dft_rows", (4096, 14336)),
         ("dft_cols", (14336, 4096)), ("dft_cols", (4096, 14336)), ("dft_rows", (14336, 4096))]


def time_ms(torch, fn, flush, reps):
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


def device_ms(torch, fn, calls: int = 10) -> float:
    """Device time of ``fn``'s kernels per call under torch.profiler (no
    host time: CUDA events around one call also count the wrapper's
    Python); nan where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_dft_torch: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.ops import pallas_fft as pf

    pf.build(verbose=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for name, shape in CASES:
        dim = 1 if name == "dft_rows" else 0
        xr = torch.randn(shape, device=dev, generator=gen)
        xi = torch.randn(shape, device=dev, generator=gen)
        kernel = getattr(pf, name)
        got = kernel(xr, xi)
        truth = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=dim)
        z = torch.complex(got[0].double(), got[1].double())
        rel = float((z - truth).abs().norm() / truth.abs().norm())
        ok &= rel <= 1e-5 and bool(torch.isfinite(z).all())
        del got, truth, z
        zc = torch.complex(xr, xi)
        k_ms = time_ms(torch, lambda: kernel(xr, xi), flush, args.reps)
        l_ms = time_ms(torch, lambda: torch.fft.fft(zc, dim=dim), flush, args.reps)
        dev_ms = device_ms(torch, lambda: kernel(xr, xi))
        bound_ms = 16 * xr.numel() / HBM_BYTES_PER_S * 1e3
        passes = pf._plan(name, *shape)
        route = "; ".join(f"L={p.L} {list(p.radices)} W={p.W} T={p.threads}" for p in passes)
        print(f"{name} {shape}: kernel {k_ms:.4f} ms (device time {dev_ms:.4f} ms), cuFFT {l_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms (bytes), "
              f"{bound_ms / k_ms:.0%} of HBM; relL2 to truth {rel:.2e}; {len(passes)} launch(es): {route}",
              flush=True)
        del xr, xi, zc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
