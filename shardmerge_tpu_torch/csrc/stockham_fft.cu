// Batched complex FFT along the last axis of (B, N) f32 re/im planes, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_fft_kernel` / `_fft_batched` of
// shardmerge_tpu/ops/fft_vpu.py (:167, pallas_call at :185): N = 8*m with m
// a product of {4, 2, 7, 3, 5}, N <= 4096, output in natural order, the
// inverse scaled by f32(1/N). It computes that function, not the TPU
// kernel's flat (8, s*b) layout (a Mosaic artefact).
//
// What bounds it on this card: each line is read once and written once, 16
// bytes per element (268 MB, 0.080 ms at 3.35 TB/s for B = N = 4096),
// against 5*N*log2(N) flops per line (0.015 ms at the 67 TFLOP/s f32 rate).
// It is bound by bytes, so the design keeps the arithmetic and the shared
// memory traffic out of the loads' way.
//
// Algorithm: the decimation-in-time Stockham FFT with large radices,
// passes p = 0, 1, ... of radix R_p with Ns = R_0 * ... * R_(p-1):
//
//   butterfly j in [0, N/R): v[r] = x[j + r*N/R] * w_(Ns*R)^((j mod Ns)*r)
//                            y = DFT_R(v)
//                            out[(j div Ns)*Ns*R + (j mod Ns) + r*Ns] = y[r]
//
// Its reads are always at j + r*N/R, and in the last pass (Ns*R = N) so are
// its writes. So the first pass reads the input planes straight into
// registers, coalesced (thread j takes x[j + r*N/R]), and the last pass
// writes natural order straight to the output planes. Only the passes in
// between go through shared memory. The host picks the radices
// (ops/fft_vpu.py::_schedule, run in float64 numpy by `_simulate` in the
// CPU tests) and this file checks them against its own.
//
// Two instances:
//   - pow2_kernel<log2 N> for N = 2^k (every length on the Llama-3.1-8B
//     path): radix 16 passes and one of 8/4/2 last (4096 = 16*16*16, three
//     passes and two shared exchanges where the TPU-shaped design had six
//     in-place stages). Each thread owns 16 values of one line (N/16
//     threads a line, 4096/N lines a 256-thread block), every index is a
//     shift or a mask of compile-time constants, and the DFT-16 (4 x 4) and
//     DFT-8 (2 x 4) run in registers with literal roots. The exchanges keep
//     re and im in separate float planes with an XOR swizzle of the low
//     five index bits chosen per exchange (`swz`), so that both the strided
//     writes and the contiguous reads are free of bank conflicts.
//   - mixed_kernel for lengths with a factor 7, 5 or 3: the same passes
//     with the radix list from the host, 256 threads over up to 4096 values
//     (whole lines), each thread's butterflies in registers, host-computed
//     multiply-shift division for the runtime positions, and direct sums
//     for the odd radices. Its registers do not set the 2^k instance's.
//
// Twiddles and odd-radix roots come from one N-entry table of
// e^(sign*2*pi*i*t/N), computed on the host in float64, quarter turns
// snapped exact, and rounded once to f32 (float2, one 8-byte load each), so
// every twiddle carries one rounding. No --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockElems = 4096;  // complex values a block holds: 32 KB as re/im planes
constexpr int kMaxPasses = 12;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * (sg * i)
__device__ __forceinline__ float2 cmul_i(float2 a, float sg) { return make_float2(-sg * a.y, sg * a.x); }

// a * w16^e, w16 = e^(sg*2*pi*i/16); e is a constant once unrolled, and
// the quarter turns take no multiply
__device__ __forceinline__ float2 mul_w16(float2 a, int e, float sg) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508978f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752f;   // cos(pi/4)
  float c = 0.f, s = 0.f;
  switch (e & 15) {
    case 0: return a;
    case 4: return cmul_i(a, sg);
    case 8: return make_float2(-a.x, -a.y);
    case 12: return cmul_i(a, -sg);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 7: c = -c1; s = s1; break;
    case 9: c = -c1; s = -s1; break;
    case 10: c = -h; s = -h; break;
    case 11: c = -s1; s = -c1; break;
    case 13: c = s1; s = -c1; break;
    case 14: c = h; s = -h; break;
    default: c = c1; s = -s1; break;  // 15
  }
  return cmul(a, make_float2(c, sg * s));
}

// In-place DFT of R = 2, 4, 8, 16 values, natural order in and out.
template <int R>
__device__ __forceinline__ void dft_pow2(float2 (&a)[R], float sg);

template <>
__device__ __forceinline__ void dft_pow2<2>(float2 (&a)[2], float) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

template <>
__device__ __forceinline__ void dft_pow2<4>(float2 (&a)[4], float sg) {
  const float2 s02 = cadd(a[0], a[2]), d02 = csub(a[0], a[2]);
  const float2 s13 = cadd(a[1], a[3]), d13 = cmul_i(csub(a[1], a[3]), sg);
  a[0] = cadd(s02, s13);
  a[1] = cadd(d02, d13);
  a[2] = csub(s02, s13);
  a[3] = csub(d02, d13);
}

// R = P*Q: input n = Q*n1 + n2, output k = k1 + P*k2; DFT_P over n1, the
// twiddle w_R^(n2*k1), DFT_Q over n2
template <int P, int Q>
__device__ __forceinline__ void dft_split(float2 (&a)[P * Q], float sg) {
  float2 y[Q][P];
#pragma unroll
  for (int n2 = 0; n2 < Q; ++n2) {
    float2 t[P];
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) t[n1] = a[Q * n1 + n2];
    dft_pow2<P>(t, sg);
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) y[n2][k1] = mul_w16(t[k1], (16 / (P * Q)) * n2 * k1, sg);
  }
#pragma unroll
  for (int k1 = 0; k1 < P; ++k1) {
    float2 t[Q];
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) t[n2] = y[n2][k1];
    dft_pow2<Q>(t, sg);
#pragma unroll
    for (int k2 = 0; k2 < Q; ++k2) a[k1 + P * k2] = t[k2];
  }
}

template <>
__device__ __forceinline__ void dft_pow2<8>(float2 (&a)[8], float sg) { dft_split<2, 4>(a, sg); }
template <>
__device__ __forceinline__ void dft_pow2<16>(float2 (&a)[16], float sg) { dft_split<4, 4>(a, sg); }

// In-place DFT of an odd radix R as a direct sum over the table's roots
// root[q] = e^(sg*2*pi*i*q/R)
template <int R>
__device__ __forceinline__ void dft_odd(float2 (&a)[R], const float2 (&root)[R]) {
  float2 out[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    float2 acc = a[0];
#pragma unroll
    for (int j = 1; j < R; ++j) acc = cadd(acc, (j * e) % R == 0 ? a[j] : cmul(a[j], root[(j * e) % R]));
    out[e] = acc;
  }
#pragma unroll
  for (int e = 0; e < R; ++e) a[e] = out[e];
}

template <int R>
__device__ __forceinline__ float2 (&slice(float2* v))[R] {
  return *reinterpret_cast<float2(*)[R]>(v);
}

// ---------------------------------------------------------------------------
// 2^k instance
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
__host__ __device__ constexpr int p2_passes(int lg) { return (lg + 3) / 4; }
__host__ __device__ constexpr int p2_radix(int lg, int p) { return p < p2_passes(lg) - 1 ? 16 : 1 << (lg - 4 * (p2_passes(lg) - 1)); }
__host__ __device__ constexpr int p2_ns(int lg, int p) { return p == 0 ? 1 : p2_ns(lg, p - 1) * p2_radix(lg, p - 1); }

// The exchange written by a pass of (Ns, R): block-local index f goes to
// f ^ h(f), h a function of the bits from max(5, log2(Ns*R)) up, times Ns,
// in the low five bits. For a warp in one line that makes the writes at
// (j div Ns)*Ns*R + (j mod Ns) + r*Ns hit 32 banks, and keeps each aligned
// run of 32 (the next pass's reads) a permutation of the banks.
template <int NS, int R>
__device__ __forceinline__ int swz(int f) {
  constexpr int kShift = ilog2(NS * R) > 5 ? ilog2(NS * R) : 5;
  return f ^ (((f >> kShift) * NS) & 31);
}

template <int LG>
struct Pow2 {
  static constexpr int N = 1 << LG;
  static constexpr int V = N >= 16 ? 16 : 8;  // values a thread owns
  static constexpr int TL = N / V;             // threads a line
  static constexpr int LINES = kThreads / TL;  // lines a block
  static constexpr int NP = p2_passes(LG);
};

// Pass P >= 1: write pass P-1's outputs to the exchange, read pass P's
// inputs, twiddle, DFT; then the next pass, or the output planes.
template <int LG, int P>
__device__ __forceinline__ void pow2_rest(float2 (&v)[Pow2<LG>::V], float* sre, float* sim, int line, int t,
                                          const float2* __restrict__ tab, float sg, float scale, bool live,
                                          float* __restrict__ outr, float* __restrict__ outi, long long g) {
  using K = Pow2<LG>;
  constexpr int N = K::N, V = K::V, TL = K::TL;
  constexpr int R0 = p2_radix(LG, P - 1), NS0 = p2_ns(LG, P - 1);  // the pass that wrote
  constexpr int R = p2_radix(LG, P), NS = p2_ns(LG, P), NR = N / R;
  if constexpr (P > 1) __syncthreads();  // every thread has read the previous exchange
#pragma unroll
  for (int b = 0; b < V / R0; ++b) {
    const int j = t + b * TL;
#pragma unroll
    for (int r = 0; r < R0; ++r) {
      const int f = swz<NS0, R0>(line * N + (j / NS0) * NS0 * R0 + (j % NS0) + r * NS0);
      sre[f] = v[b * R0 + r].x;
      sim[f] = v[b * R0 + r].y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < V / R; ++b) {
    const int j = t + b * TL;
    const int k = j % NS;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int f = swz<NS0, R0>(line * N + j + r * NR);
      float2 x = make_float2(sre[f], sim[f]);
      if (r > 0) x = cmul(x, __ldg(tab + k * r * (N / (NS * R))));
      v[b * R + r] = x;
    }
    dft_pow2<R>(slice<R>(v + b * R), sg);
  }
  if constexpr (P + 1 < K::NP) {
    pow2_rest<LG, P + 1>(v, sre, sim, line, t, tab, sg, scale, live, outr, outi, g);
  } else if (live) {
#pragma unroll
    for (int b = 0; b < V / R; ++b) {
      const int j = t + b * TL;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        outr[g + j + r * NR] = v[b * R + r].x * scale;
        outi[g + j + r * NR] = v[b * R + r].y * scale;
      }
    }
  }
}

// Four blocks per SM (64 registers, no spill): more blocks keep more lines'
// loads in flight, which the kernel needs more than registers
template <int LG>
__global__ void __launch_bounds__(kThreads, 4)
pow2_kernel(const float* __restrict__ zr, const float* __restrict__ zi, const float2* __restrict__ tab,
            float* __restrict__ outr, float* __restrict__ outi, int B, float sg, float scale) {
  using K = Pow2<LG>;
  constexpr int N = K::N, V = K::V, TL = K::TL;
  constexpr int R = p2_radix(LG, 0), NR = N / R;
  __shared__ float sre[K::NP > 1 ? K::LINES * N : 1];
  __shared__ float sim[K::NP > 1 ? K::LINES * N : 1];
  const int line = threadIdx.x / TL, t = threadIdx.x % TL;
  const int row = blockIdx.x * K::LINES + line;
  const bool live = row < B;
  const long long g = (long long)row * N;
  float2 v[V];
  // pass 0 (Ns = 1, no twiddle): straight from the input planes
#pragma unroll
  for (int b = 0; b < V / R; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = t + b * TL + r * NR;
      v[b * R + r] = live ? make_float2(__ldg(zr + g + i), __ldg(zi + g + i)) : make_float2(0.f, 0.f);
    }
    dft_pow2<R>(slice<R>(v + b * R), sg);
  }
  if constexpr (K::NP > 1) {
    pow2_rest<LG, 1>(v, sre, sim, line, t, tab, sg, scale, live, outr, outi, g);
  } else if (live) {  // one pass: its writes are natural order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      outr[g + t + r * NR] = v[r].x * scale;
      outi[g + t + r * NR] = v[r].y * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// mixed-radix instance
// ---------------------------------------------------------------------------

// n div d = (umulhi(n, m) + n) >> l for 0 <= n < 2^31 (magic from the host)
struct FastDiv {
  unsigned m;
  int l;
  __device__ __forceinline__ int div(int n) const { return int((__umulhi(unsigned(n), m) + unsigned(n)) >> l); }
};

FastDiv make_div(unsigned d) {
  int l = 0;
  while ((1u << l) < d) ++l;
  return FastDiv{unsigned(((1ull << 32) * ((1ull << l) - d)) / d + 1), l};
}

struct MixedPlan {
  int n, lpb, np;
  int radix[kMaxPasses];
  int ns[kMaxPasses];
  FastDiv by_nr[kMaxPasses];  // n / radix
  FastDiv by_ns[kMaxPasses];
  float sg, scale;
};

template <int R>
__device__ __forceinline__ void mixed_pass(const MixedPlan& pl, int p, int lines, float* sre, float* sim,
                                           const float* __restrict__ zr, const float* __restrict__ zi,
                                           const float2* __restrict__ tab, float* __restrict__ outr,
                                           float* __restrict__ outi, long long base) {
  constexpr int kMaxB = (kBlockElems / R + kThreads - 1) / kThreads;  // butterflies a thread
  const int n = pl.n, nr = n / R, ns = pl.ns[p], tw = n / (ns * R);
  const bool first = p == 0, last = p + 1 == pl.np;
  const int total = lines * nr;
  float2 root[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) root[q] = __ldg(tab + q * nr);
  }
  float2 v[kMaxB][R];
  int dst[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    const int jt = threadIdx.x + b * kThreads;
    if (jt < total) {
      const int line = pl.by_nr[p].div(jt);
      const int j = jt - line * nr;
      const int q = pl.by_ns[p].div(j);
      const int k = j - q * ns;
      const int src = line * n + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = src + r * nr;
        float2 x = first ? make_float2(__ldg(zr + base + i), __ldg(zi + base + i)) : make_float2(sre[i], sim[i]);
        if (r > 0 && !first) x = cmul(x, __ldg(tab + k * r * tw));
        v[b][r] = x;
      }
      if constexpr (R % 2 == 1) {
        dft_odd<R>(v[b], root);
      } else {
        dft_pow2<R>(v[b], pl.sg);
      }
      dst[b] = line * n + q * ns * R + k;
    }
  }
  if (!first && !last) __syncthreads();  // every input of this pass is in registers
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (threadIdx.x + b * kThreads < total) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = dst[b] + r * ns;
        if (last) {
          outr[base + i] = v[b][r].x * pl.scale;
          outi[base + i] = v[b][r].y * pl.scale;
        } else {
          sre[i] = v[b][r].x;
          sim[i] = v[b][r].y;
        }
      }
    }
  }
  if (!last) __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
mixed_kernel(const float* __restrict__ zr, const float* __restrict__ zi, const float2* __restrict__ tab,
             float* __restrict__ outr, float* __restrict__ outi, int B, MixedPlan plan) {
  __shared__ float sre[kBlockElems];
  __shared__ float sim[kBlockElems];
  __shared__ MixedPlan pl;  // indexed by pass at run time: kept out of local memory
  if (threadIdx.x == 0) pl = plan;
  __syncthreads();
  const int line0 = blockIdx.x * pl.lpb;
  const int lines = min(pl.lpb, B - line0);
  const long long base = (long long)line0 * pl.n;
  for (int p = 0; p < pl.np; ++p) {
    switch (pl.radix[p]) {
      case 16: mixed_pass<16>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      case 8: mixed_pass<8>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      case 4: mixed_pass<4>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      case 2: mixed_pass<2>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      case 7: mixed_pass<7>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      case 5: mixed_pass<5>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
      default: mixed_pass<3>(pl, p, lines, sre, sim, zr, zi, tab, outr, outi, base); break;
    }
  }
}

// The radix list of a length: 16s over the power of two, its remainder
// (8, 4 or 2) after them, then the odd factors 7, 5, 3. Returns the
// number of passes, 0 if N is not 8 * a product of {2, 3, 5, 7}.
int schedule(int N, int* radix) {
  int two = N & -N, lg = 0, odd = N / two, np = 0;
  while ((1 << lg) < two) ++lg;
  if (lg < 3) return 0;
  for (int i = 0; i < lg / 4; ++i) radix[np++] = 16;
  if (lg % 4) radix[np++] = 1 << (lg % 4);
  for (int r : {7, 5, 3}) {
    while (odd % r == 0) {
      if (np == kMaxPasses) return 0;
      radix[np++] = r;
      odd /= r;
    }
  }
  return odd == 1 ? np : 0;
}

template <int LG>
cudaError_t launch_pow2(const float* zr, const float* zi, const float2* tab, float* outr, float* outi, int B,
                        float sg, float scale, cudaStream_t s) {
  constexpr int kLines = Pow2<LG>::LINES;
  pow2_kernel<LG><<<(B + kLines - 1) / kLines, kThreads, 0, s>>>(zr, zi, tab, outr, outi, B, sg, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. zr/zi and outr/outi are contiguous
// (B, N) f32 planes; tab the N-entry float2 root table of the direction;
// radices/npass the host's schedule, which must equal this file's.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int stockham_fft(const float* zr, const float* zi, const void* tab, float* outr, float* outi, int B,
                            int N, int inverse, const int* radices, int npass, void* stream) {
  int radix[kMaxPasses];
  const int np = (B >= 1 && N >= 8 && N <= kBlockElems) ? schedule(N, radix) : 0;
  if (np == 0 || np != npass) return int(cudaErrorInvalidValue);
  for (int p = 0; p < np; ++p)
    if (radices[p] != radix[p]) return int(cudaErrorInvalidValue);
  const float sg = inverse ? 1.f : -1.f;
  const float scale = inverse ? float(1.0 / N) : 1.f;
  const float2* t = static_cast<const float2*>(tab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((N & (N - 1)) == 0) {
    switch (N) {
      case 8: return int(launch_pow2<3>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 16: return int(launch_pow2<4>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 32: return int(launch_pow2<5>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 64: return int(launch_pow2<6>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 128: return int(launch_pow2<7>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 256: return int(launch_pow2<8>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 512: return int(launch_pow2<9>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 1024: return int(launch_pow2<10>(zr, zi, t, outr, outi, B, sg, scale, s));
      case 2048: return int(launch_pow2<11>(zr, zi, t, outr, outi, B, sg, scale, s));
      default: return int(launch_pow2<12>(zr, zi, t, outr, outi, B, sg, scale, s));
    }
  }
  MixedPlan plan{};
  plan.n = N;
  plan.lpb = kBlockElems / N;
  plan.np = np;
  int ns = 1;
  for (int p = 0; p < np; ++p) {
    plan.radix[p] = radix[p];
    plan.ns[p] = ns;
    plan.by_nr[p] = make_div(unsigned(N / radix[p]));
    plan.by_ns[p] = make_div(unsigned(ns));
    ns *= radix[p];
  }
  plan.sg = sg;
  plan.scale = scale;
  mixed_kernel<<<(B + plan.lpb - 1) / plan.lpb, kThreads, 0, s>>>(zr, zi, t, outr, outi, B, plan);
  return int(cudaGetLastError());
}
