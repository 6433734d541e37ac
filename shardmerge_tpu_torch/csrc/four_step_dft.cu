// Four-step DFT along either axis of (M, N) f32 re/im planes, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernels of shardmerge_tpu/ops/pallas_fft.py:
//   dft_rows  <- `_rows_kernel` :103 (pallas_call at :157), DFT along N
//   dft_cols  <- `_cols_kernel` :186 (pallas_call at :222), DFT along M
// An axis of length n = n1*n2 (n2 >= n1, good_split) is transformed as
//
//   X[k1*N2 + k2] = sum_n1 W1[k1,n1] * tw[n1,k2] * sum_n2 W2[k2,n2] * x[n2*N1 + n1]
//
// with W1, W2 and tw the f32 tables the host builds in float64.
//
// What bounds it on this card: the function itself moves 16 bytes per
// element (both planes read once and written once: 537 MB, 0.16 ms at
// 3.35 TB/s for (4096, 8192)), but the four-step formulation does
// 8*(n1 + n2) flops per element, 51.5 GFLOP for dft_rows at (4096, 8192):
// 0.77 ms at the 67 TFLOP/s f32 CUDA-core peak. So it is bound by
// operations, and the TPU's answer (matmuls on the MXU) has no f32
// counterpart here: TF32 tensor cores would leave the 2e-6 error class.
//
// Design (simple first): the TPU kernel keeps whole (tm, n2, n1) blocks in
// VMEM; on Hopper a (4096, 8192) column block alone would outgrow the
// 227 KB of shared memory. So each axis runs as two launches of one tiled
// complex matrix-product kernel,
//
//   pass 1: T = (W2 @ x) * tw      (contract n2, twiddle fused in the epilogue)
//   pass 2: X = W1 @ T, reordered  (contract n1, output index k1*N2 + k2,
//                                   1/n scale of the inverse in the epilogue)
//
// with T in a scratch pair of planes. Each block computes a 64x64 output
// tile of one batch entry from 16-deep slices of W and the operand staged in
// shared memory; each thread keeps a 4x4 complex register tile and does 64
// f32 FMAs per 16 floats read from shared memory. Every operand walks its
// contiguous axis with neighbouring threads; outputs are written along the
// contiguous axis. The tables are small and stay L2-resident. No
// --use_fast_math: f32 FMAs throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;  // output rows (transform index k) per block
constexpr int kTileJ = 64;  // output columns (the batched vectors) per block
constexpr int kDepth = 16;  // contraction slice staged per step
constexpr int kThreads = 256;
constexpr int kPadJ = kTileJ + 4;  // keeps float4 rows aligned, spreads banks

struct Pass {
  const float* wr;  // W (L, L), symmetric: W[k][i] == W[i][k]
  const float* wi;
  int L;            // transform length of this pass (contraction and k range)
  const float* ar;  // operand A[b][i][j] at b*a_sb + i*a_si + j*a_sj
  const float* ai;
  long long a_sb, a_si, a_sj;
  float* yr;        // Y[b][k][j] at b*y_sb + k*y_sk + j
  float* yi;
  long long y_sb, y_sk;
  int J;            // columns
  int batch;
  const float* twr;  // optional twiddle tw[(j / tw_div) * L + k]
  const float* twi;
  long long tw_div;
  float div;  // the epilogue divides by this (1 = no scale)
};

// Y[b][k][j] = tw(k, j) * sum_i W[k][i] * A[b][i][j] / div
__global__ void __launch_bounds__(kThreads) cmatmul_kernel(Pass p) {
  __shared__ __align__(16) float ws_r[kDepth][kTileK];
  __shared__ __align__(16) float ws_i[kDepth][kTileK];
  __shared__ __align__(16) float as_r[kDepth][kPadJ];
  __shared__ __align__(16) float as_i[kDepth][kPadJ];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: j = j0 + 4*tx + c
  const int ty = tid / 16;  // row group: k = k0 + 4*ty + a
  const int j0 = blockIdx.x * kTileJ;
  const int k0 = blockIdx.y * kTileK;
  const int L = p.L;

  for (int b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const float* __restrict__ ar = p.ar + b * p.a_sb;
    const float* __restrict__ ai = p.ai + b * p.a_sb;
    float acc_r[4][4], acc_i[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_r[a][c] = acc_i[a][c] = 0.f;

    for (int i0 = 0; i0 < L; i0 += kDepth) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int q = 0; q < kDepth * kTileK / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        const int i = idx / kTileK, k = idx % kTileK;
        float vr = 0.f, vi = 0.f;
        if (i0 + i < L && k0 + k < L) {
          const long long off = (long long)(i0 + i) * L + k0 + k;  // W[i][k] = W[k][i]
          vr = __ldg(p.wr + off);
          vi = __ldg(p.wi + off);
        }
        ws_r[i][k] = vr;
        ws_i[i][k] = vi;
      }
#pragma unroll
      for (int q = 0; q < kDepth * kTileJ / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        int i, j;
        if (p.a_sj == 1) {  // neighbouring threads along j
          i = idx / kTileJ;
          j = idx % kTileJ;
        } else {  // the contraction axis is the contiguous one
          j = idx / kDepth;
          i = idx % kDepth;
        }
        float vr = 0.f, vi = 0.f;
        if (i0 + i < L && j0 + j < p.J) {
          const long long off = (long long)(i0 + i) * p.a_si + (long long)(j0 + j) * p.a_sj;
          vr = ar[off];
          vi = ai[off];
        }
        as_r[i][j] = vr;
        as_i[i][j] = vi;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        const float4 wr4 = *reinterpret_cast<const float4*>(&ws_r[i][4 * ty]);
        const float4 wi4 = *reinterpret_cast<const float4*>(&ws_i[i][4 * ty]);
        const float4 xr4 = *reinterpret_cast<const float4*>(&as_r[i][4 * tx]);
        const float4 xi4 = *reinterpret_cast<const float4*>(&as_i[i][4 * tx]);
        const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
        const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
        const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
        const float xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_r[a][c] = fmaf(wr[a], xr[c], acc_r[a][c]);
            acc_r[a][c] = fmaf(-wi[a], xi[c], acc_r[a][c]);
            acc_i[a][c] = fmaf(wr[a], xi[c], acc_i[a][c]);
            acc_i[a][c] = fmaf(wi[a], xr[c], acc_i[a][c]);
          }
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int k = k0 + 4 * ty + a;
      if (k >= L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        if (j >= p.J) continue;
        float r = acc_r[a][c], im = acc_i[a][c];
        if (p.twr != nullptr) {
          const long long t = (j / p.tw_div) * L + k;
          const float tr = __ldg(p.twr + t), ti = __ldg(p.twi + t);
          const float rr = r * tr - im * ti;
          im = r * ti + im * tr;
          r = rr;
        }
        const long long off = b * p.y_sb + (long long)k * p.y_sk + j;
        p.yr[off] = r / p.div;
        p.yi[off] = im / p.div;
      }
    }
  }
}

cudaError_t run(const Pass& p, cudaStream_t stream) {
  dim3 grid((p.J + kTileJ - 1) / kTileJ, (p.L + kTileK - 1) / kTileK, p.batch < 65535 ? p.batch : 65535);
  cmatmul_kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. Planes are contiguous row-major
// (M, N) f32; (n1, n2) = good_split of the transformed length; the tables
// are W1 (n1, n1), W2 (n2, n2) and tw (n1, n2) as re/im planes; tr/ti is
// an (M, N) scratch pair. Each returns the cudaError_t of its launches
// (0 = success).

extern "C" int dft_rows(const float* xr, const float* xi, const float* w1r, const float* w1i,
                        const float* w2r, const float* w2i, const float* twr, const float* twi,
                        float* tr, float* ti, float* outr, float* outi, int M, int N, int n1,
                        int n2, int inverse, void* stream) {
  if (M < 1 || N < 1 || n1 < 1 || n2 < 1 || (long long)n1 * n2 != N) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // row m is x[m][n2][n1]; pass 1: T[m][k2][n1] = tw[n1][k2] * sum_n2 W2[k2][n2] x[m][n2][n1]
  Pass p1{w2r, w2i, n2, xr, xi, N, n1, 1, tr, ti, N, n1, n1, M, twr, twi, 1, 1.f};
  cudaError_t err = run(p1, s);
  if (err != cudaSuccess) return int(err);
  // pass 2: out[m][k1][k2] = sum_n1 W1[k1][n1] T[m][k2][n1]
  Pass p2{w1r, w1i, n1, tr, ti, N, 1, n1, outr, outi, N, n2, n2, M, nullptr, nullptr, 1,
          inverse ? float(N) : 1.f};
  return int(run(p2, s));
}

extern "C" int dft_cols(const float* xr, const float* xi, const float* w1r, const float* w1i,
                        const float* w2r, const float* w2i, const float* twr, const float* twi,
                        float* tr, float* ti, float* outr, float* outi, int M, int N, int m1,
                        int m2, int inverse, void* stream) {
  if (M < 1 || N < 1 || m1 < 1 || m2 < 1 || (long long)m1 * m2 != M) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row = (long long)m1 * N;  // one r2 slab: (m1, N)
  if (row > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  // x is x[r2][r1][c]; pass 1: T[k2][r1][c] = tw[r1][k2] * sum_r2 W2[k2][r2] x[r2][r1][c],
  // one product over the m1*N columns (r1 = column / N picks the twiddle)
  Pass p1{w2r, w2i, m2, xr, xi, 0, row, 1, tr, ti, 0, row, int(row), 1, twr, twi, N, 1.f};
  cudaError_t err = run(p1, s);
  if (err != cudaSuccess) return int(err);
  // pass 2, batched over k2: out[k1][k2][c] = sum_r1 W1[k1][r1] T[k2][r1][c]
  Pass p2{w1r, w1i, m1, tr, ti, row, N, 1, outr, outi, N, (long long)m2 * N, N, m2, nullptr, nullptr, 1,
          inverse ? float(M) : 1.f};
  return int(run(p2, s));
}
