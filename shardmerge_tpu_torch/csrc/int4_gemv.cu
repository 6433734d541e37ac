// int4 split-half GEMV for Hopper (sm_90a): y = x @ dequant(W).T
//
// Replaces the TPU Pallas kernel `_gemv4_kernel` / `_int4_matmul_2d`
// (shardmerge_tpu/models/quant_kernels.py:101, pallas_call at :148). It
// computes what that kernel computes, not its block structure:
//
//   x     (B, K)    f32 or bf16, B <= 64, row-major
//   q     (N, K/2)  uint8; byte j of row n holds W[n, j] + 8 in its low
//                   nibble and W[n, j + K/2] + 8 in its high nibble
//   scale (N,)      f32, one per output channel
//   y     (B, N)    x's dtype; y[b, n] = scale[n] * sum_j
//                   (x[b, j] * (lo - 8) + x[b, j + K/2] * (hi - 8))
//
// Accumulation is f32; the scale multiplies once at the end; the output is
// rounded once to x's dtype.
//
// What bounds it: a decode GEMV reads every weight byte once and does 4
// flops per byte per row of x, far below the card's ~295 flop/byte balance
// point, so it is bound by the bytes of q streamed from device memory.
// Design (simple first):
//   - a block of 8 warps owns 16 output rows (2 per warp); each lane streams
//     16 packed bytes of a row per 16-byte load, the warp covering a
//     512-byte K tile per row;
//   - the block stages the matching x columns (j and j + K/2) of up to BB
//     rows of x as f32 in shared memory, one K tile at a time, in a
//     permuted layout so that the warp's float4 reads hit distinct banks;
//   - rows of x beyond BB go to further blocks (grid.y);
//   - each lane keeps 2 x BB f32 partial sums; a warp shuffle reduction
//     finishes each output.
// No wgmma, TMA or cp.async yet: those are for the PRs that make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileBytes = 32 * 16;  // one warp's 16-byte loads over a K tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Shared-memory slot of tile element e (0..511): lane l = e / 16 reads its
// 16 values as float4 chunks c = (e / 4) % 4; chunk c of every lane sits in
// one contiguous run of 32 float4, so each warp-wide read is conflict-free.
__device__ __forceinline__ int slot(int e) {
  return ((((e >> 2) & 3) * 32) + (e >> 4)) * 4 + (e & 3);
}

__device__ __forceinline__ void fma_byte(float& acc, uint32_t byte, float xl, float xh) {
  acc = fmaf(xl, float(int(byte & 0xFu) - 8), acc);
  acc = fmaf(xh, float(int(byte >> 4) - 8), acc);
}

template <typename T, int BB>
__global__ void __launch_bounds__(kThreads)
int4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                 const float* __restrict__ scale, T* __restrict__ y,
                 int B, int N, int Kh) {
  __shared__ __align__(16) float xs_lo[BB][kTileBytes];
  __shared__ __align__(16) float xs_hi[BB][kTileBytes];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int K = 2 * Kh;

  float acc[kRowsPerWarp][BB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[r][b] = 0.f;

  for (int k0 = 0; k0 < Kh; k0 += kTileBytes) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BB * kTileBytes; i += kThreads) {
      const int b = i / kTileBytes;
      const int e = i % kTileBytes;
      const int j = k0 + e;
      float lo = 0.f, hi = 0.f;
      if (b < nb && j < Kh) {
        const T* xr = x + (size_t)(b0 + b) * K;
        lo = to_f32(xr[j]);
        hi = to_f32(xr[j + Kh]);
      }
      xs_lo[b][slot(e)] = lo;
      xs_hi[b][slot(e)] = hi;
    }
    __syncthreads();

    const int j = k0 + lane * 16;
    if (j < Kh) {  // Kh is a multiple of 16: a lane's vector is all in or out
      uint4 w[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int n = row0 + r;
        w[r] = n < N ? __ldg(reinterpret_cast<const uint4*>(q + (size_t)n * Kh + j))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          const float4 xl = reinterpret_cast<const float4*>(xs_lo[b])[c * 32 + lane];
          const float4 xh = reinterpret_cast<const float4*>(xs_hi[b])[c * 32 + lane];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const uint32_t word = c == 0 ? w[r].x : c == 1 ? w[r].y : c == 2 ? w[r].z : w[r].w;
            fma_byte(acc[r][b], word & 0xFFu, xl.x, xh.x);
            fma_byte(acc[r][b], (word >> 8) & 0xFFu, xl.y, xh.y);
            fma_byte(acc[r][b], (word >> 16) & 0xFFu, xl.z, xh.z);
            fma_byte(acc[r][b], word >> 24, xl.w, xh.w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][b] = v;
    }
    const int n = row0 + r;
    if (n < N && lane < nb) {
      float v = 0.f;
#pragma unroll
      for (int b = 0; b < BB; ++b)
        if (b == lane) v = acc[r][b];
      store(y + (size_t)(b0 + lane) * N + n, v * scale[n]);
    }
  }
}

template <typename T, int BB>
cudaError_t launch(const void* x, const uint8_t* q, const float* scale, void* y,
                   int B, int N, int Kh, cudaStream_t stream) {
  dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, (B + BB - 1) / BB);
  int4_gemv_kernel<T, BB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, scale, static_cast<T*>(y), B, N, Kh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const uint8_t* q, const float* scale, void* y,
                     int B, int N, int Kh, cudaStream_t stream) {
  if (B == 1) return launch<T, 1>(x, q, scale, y, B, N, Kh, stream);
  if (B <= 4) return launch<T, 4>(x, q, scale, y, B, N, Kh, stream);
  return launch<T, 8>(x, q, scale, y, B, N, Kh, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = f32, 1 = bf16 (x and y).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int int4_gemv(const void* x, const uint8_t* q, const float* scale, void* y,
                         int B, int N, int Kh, int dtype, void* stream) {
  if (B < 1 || B > 64 || N < 1 || Kh < 16 || Kh % 16 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch<float>(x, q, scale, y, B, N, Kh, s));
  if (dtype == 1) return int(dispatch<__nv_bfloat16>(x, q, scale, y, B, N, Kh, s));
  return int(cudaErrorInvalidValue);
}
