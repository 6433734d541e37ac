// Batched complex Stockham FFT along the last axis of (B, N) f32 re/im
// planes, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fft_kernel` / `_fft_batched` of
// shardmerge_tpu/ops/fft_vpu.py (:167, pallas_call at :185): N = 8*m with m
// a product of the radices {4, 2, 7, 3, 5}, N <= 4096. The same DIF
// Stockham algorithm: for each radix r, largest first, data seen as
// (m, s) per line (index p*s + s_idx) becomes (m/r, r*s):
//
//   out[p*(r*s) + e*s + s_idx] = w_m^(p*e) * sum_j w_r^(j*e) * in[(j*(m/r) + p)*s + s_idx]
//
// and a DFT-8 over the last 8 rows writes frequency k*(N/8) + s_idx, which
// is natural order: the TPU's flat (8, nblk*s*b) output and the XLA reorder
// after it are Mosaic layout artefacts, not part of the function. The
// inverse multiplies by f32(1/N), as the TPU kernel does. Every twiddle
// and root is read from a table of e^(sign*2*pi*i*t/N), t in [0, N), that
// the host computes in float64 and rounds once to f32 (quarter turns exact),
// so each twiddle carries one rounding where the TPU kernel's chain of
// repeated multiplies carries up to six.
//
// What bounds it on this card: a line of 4096 complex values is 32 KB, so
// a block keeps whole lines in shared memory and the kernel reads each
// input once and writes each output once: 16 bytes per element (268 MB,
// 0.080 ms at 3.35 TB/s for B = N = 4096), against 5*N*log2(N) flops per
// line (0.015 ms at the 67 TFLOP/s f32 peak). It is bound by bytes.
//
// Design (simple first): a block of 256 threads loads up to 4096 complex
// values (one or more whole lines) into one 32 KB shared buffer, runs every
// stage there in place (each thread reads its butterflies' inputs into
// registers, the block synchronises, then each writes its outputs), and the
// DFT-8 tail writes straight to the output planes along the contiguous
// axis. Radix 2 and 4 butterflies are multiplier-free; 3, 5, 7 and the
// DFT-8 are direct sums over the table's roots. Two instances: one for
// lengths of 2^k, one that also has the radix 3, 5 and 7 stages. No
// --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxElems = 4096;  // complex values per block (32 KB)
constexpr int kMaxStages = 16;

struct Plan {
  int n;
  int lpb;  // lines per block
  int nst;
  int radix[kMaxStages];
  float sg;     // -1 forward, +1 inverse: e^(sg*2*pi*i/4) = sg*i
  float scale;  // 1 forward, f32(1/N) inverse
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * (sg * i)
__device__ __forceinline__ float2 cmul_i(float2 a, float sg) { return make_float2(-sg * a.y, sg * a.x); }

// out[e] = sum_j a[j] * root[(j*e) % R], root[q] = e^(sg*2*pi*i*q/R)
template <int R>
__device__ __forceinline__ void dft(const float2 (&a)[R], float2 (&out)[R], const float2 (&root)[R], float) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    float2 acc = a[0];
#pragma unroll
    for (int j = 1; j < R; ++j) acc = cadd(acc, (j * e) % R == 0 ? a[j] : cmul(a[j], root[(j * e) % R]));
    out[e] = acc;
  }
}

template <>
__device__ __forceinline__ void dft<2>(const float2 (&a)[2], float2 (&out)[2], const float2 (&)[2], float) {
  out[0] = cadd(a[0], a[1]);
  out[1] = csub(a[0], a[1]);
}

template <>
__device__ __forceinline__ void dft<4>(const float2 (&a)[4], float2 (&out)[4], const float2 (&)[4], float sg) {
  const float2 s02 = cadd(a[0], a[2]), d02 = csub(a[0], a[2]);
  const float2 s13 = cadd(a[1], a[3]), d13 = cmul_i(csub(a[1], a[3]), sg);
  out[0] = cadd(s02, s13);
  out[1] = cadd(d02, d13);
  out[2] = csub(s02, s13);
  out[3] = csub(d02, d13);
}

// One radix-R stage over `lines` lines of n values in buf, in place.
template <int R>
__device__ __forceinline__ void stage(float2* buf, const float* __restrict__ wr, const float* __restrict__ wi,
                                      int n, int m, int s, int lines, float sg) {
  constexpr int kMaxB = (kMaxElems / kThreads + R - 1) / R;  // butterflies per thread
  const int mn = m / R;
  const int per_line = n / R;
  const int total = lines * per_line;
  const int step = n / m;  // table index of e^(sg*2*pi*i/m)
  float2 root[R];
#pragma unroll
  for (int q = 0; q < R; ++q) root[q] = make_float2(__ldg(wr + q * (n / R)), __ldg(wi + q * (n / R)));

  float2 v[kMaxB][R];
  int dst[kMaxB];
#pragma unroll
  for (int q = 0; q < kMaxB; ++q) {
    const int t = threadIdx.x + q * kThreads;
    if (t < total) {
      const int line = t / per_line, u = t - line * per_line;
      const int p = u / s, so = u - p * s;
      const float2* in = buf + line * n + p * s + so;
      float2 a[R];
#pragma unroll
      for (int j = 0; j < R; ++j) a[j] = in[j * mn * s];
      dft<R>(a, v[q], root, sg);
#pragma unroll
      for (int e = 1; e < R; ++e) {
        const int k = p * e * step;
        if (k != 0) v[q][e] = cmul(v[q][e], make_float2(__ldg(wr + k), __ldg(wi + k)));
      }
      dst[q] = line * n + p * R * s + so;
    }
  }
  __syncthreads();  // every input is in registers
#pragma unroll
  for (int q = 0; q < kMaxB; ++q) {
    if (threadIdx.x + q * kThreads < total) {
#pragma unroll
      for (int e = 0; e < R; ++e) buf[dst[q] + e * s] = v[q][e];
    }
  }
  __syncthreads();
}

// kMixed: the plan has a radix 3, 5 or 7. Lengths of 2^k (every length on
// the Llama-3.1-8B path) take the kernel without those stages, whose
// registers would otherwise set the whole kernel's count (the register
// file, not shared memory, limits the blocks per SM).
template <bool kMixed>
__global__ void __launch_bounds__(kThreads, kMixed ? 2 : 3)
stockham_kernel(const float* __restrict__ zr, const float* __restrict__ zi, const float* __restrict__ wr,
                const float* __restrict__ wi, float* __restrict__ outr, float* __restrict__ outi, int B,
                Plan plan) {
  __shared__ float2 buf[kMaxElems];
  const int n = plan.n;
  const int line0 = blockIdx.x * plan.lpb;
  const int lines = min(plan.lpb, B - line0);
  const long long base = (long long)line0 * n;
  for (int t = threadIdx.x; t < lines * n; t += kThreads) buf[t] = make_float2(zr[base + t], zi[base + t]);
  __syncthreads();

  int m = n, s = 1;
  for (int st = 0; st < plan.nst; ++st) {
    const int r = plan.radix[st];
    if (r == 4) {
      stage<4>(buf, wr, wi, n, m, s, lines, plan.sg);
    } else if (r == 2) {
      stage<2>(buf, wr, wi, n, m, s, lines, plan.sg);
    } else if constexpr (kMixed) {
      if (r == 7) stage<7>(buf, wr, wi, n, m, s, lines, plan.sg);
      else if (r == 3) stage<3>(buf, wr, wi, n, m, s, lines, plan.sg);
      else stage<5>(buf, wr, wi, n, m, s, lines, plan.sg);
    }
    m /= r;
    s *= r;
  }

  // DFT-8 over the remaining rows: out[k*s + s_idx] = sum_p W8[k][p] y[p*s + s_idx]
  float2 root[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) root[q] = make_float2(__ldg(wr + q * s), __ldg(wi + q * s));
  for (int t = threadIdx.x; t < lines * s; t += kThreads) {
    const int line = t / s, so = t - line * s;
    float2 a[8], o[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) a[p] = buf[line * n + p * s + so];
    dft<8>(a, o, root, plan.sg);
    const long long g = base + (long long)line * n + so;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      outr[g + k * s] = o[k].x * plan.scale;
      outi[g + k * s] = o[k].y * plan.scale;
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. zr/zi and outr/outi are contiguous
// (B, N) f32 planes; wr/wi the N-entry root table of the direction.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int stockham_fft(const float* zr, const float* zi, const float* wr, const float* wi, float* outr,
                            float* outi, int B, int N, int inverse, void* stream) {
  if (B < 1 || N < 8 || N % 8 != 0 || N > kMaxElems) return int(cudaErrorInvalidValue);
  Plan plan{};
  plan.n = N;
  int m = N / 8;
  bool mixed = false;
  const int radices[5] = {4, 2, 7, 3, 5};
  for (int r : radices) {
    while (m % r == 0) {
      if (plan.nst == kMaxStages) return int(cudaErrorInvalidValue);
      plan.radix[plan.nst++] = r;
      mixed |= (r != 4 && r != 2);
      m /= r;
    }
  }
  if (m != 1) return int(cudaErrorInvalidValue);
  plan.sg = inverse ? 1.f : -1.f;
  plan.scale = inverse ? float(1.0 / N) : 1.f;
  // whole lines per block, but enough blocks for two per SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int lpb = kMaxElems / N;
  const int spread = B / (2 * sms);
  if (spread < lpb) lpb = spread > 1 ? spread : 1;
  plan.lpb = lpb;
  const int blocks = (B + lpb - 1) / lpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mixed)
    stockham_kernel<true><<<blocks, kThreads, 0, s>>>(zr, zi, wr, wi, outr, outi, B, plan);
  else
    stockham_kernel<false><<<blocks, kThreads, 0, s>>>(zr, zi, wr, wi, outr, outi, B, plan);
  return int(cudaGetLastError());
}
