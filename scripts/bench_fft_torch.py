#!/usr/bin/env python3
"""Time the port's Stockham FFT kernel (``fft_batched`` of
shardmerge_tpu_torch/ops/fft_vpu.py) on one CUDA card, beside
``torch.fft.fft`` (cuFFT) along the same axis and the byte bound.

    python3 scripts/bench_fft_torch.py [--reps 25]

Builds csrc/stockham_fft.cu with ptxas's register report, then for each
(B, N) pass that rfft2/irfft2 run at the Llama-3.1-8B shapes ((4096, 8192)
rows and padded columns, (4096, 4096) rows and padded columns): the
kernel's radices, its relL2 against a complex128 ``torch.fft`` truth (gate
1e-5), median CUDA-event times with the L2 flushed before each launch, and
the device time per call under torch.profiler (host time excluded). The
last line is the card's name and power limit. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts.bench_dft_torch import HBM_BYTES_PER_S, device_ms, time_ms  # noqa: E402

# (B, N): rows (4096, 4096) and padded columns (4128, 4096) of rfft2 at
# (4096, 8192); rows (4096, 2048) and padded columns (2080, 4096) at (4096, 4096)
CASES = [(4096, 4096), (4128, 4096), (4096, 2048), (2080, 4096)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_fft_torch: no CUDA device", file=sys.stderr)
        return 1
    from shardmerge_tpu_torch.ops import fft_vpu as fv

    fv.build(verbose=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ok = True
    for b, n in CASES:
        zr = torch.randn((b, n), device=dev, generator=gen)
        zi = torch.randn((b, n), device=dev, generator=gen)
        rels = []
        for inverse in (False, True):
            got = fv.fft_batched(zr, zi, inverse)
            z = torch.complex(zr.double(), zi.double())
            truth = torch.fft.ifft(z, dim=1) if inverse else torch.fft.fft(z, dim=1)
            g = torch.complex(got[0].double(), got[1].double())
            rels.append(float((g - truth).abs().norm() / truth.abs().norm()))
            ok &= rels[-1] <= 1e-5 and bool(torch.isfinite(g).all())
            del got, z, truth, g
        zc = torch.complex(zr, zi)
        k_ms = time_ms(torch, lambda: fv.fft_batched(zr, zi, False), flush, args.reps)
        l_ms = time_ms(torch, lambda: torch.fft.fft(zc, dim=1), flush, args.reps)
        dev_ms = device_ms(torch, lambda: fv.fft_batched(zr, zi, False))
        lib_dev_ms = device_ms(torch, lambda: torch.fft.fft(zc, dim=1))
        bound_ms = 16 * zr.numel() / HBM_BYTES_PER_S * 1e3
        print(f"fft_batched ({b}, {n}) radices {list(fv._schedule(n))}: kernel {k_ms:.4f} ms (device time "
              f"{dev_ms:.4f} ms), cuFFT {l_ms:.4f} ms (device time {lib_dev_ms:.4f} ms), bound {bound_ms:.4f} ms "
              f"(bytes), {bound_ms / k_ms:.0%} of HBM; relL2 to truth forward {rels[0]:.2e}, inverse {rels[1]:.2e}",
              flush=True)
        del zr, zi, zc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
