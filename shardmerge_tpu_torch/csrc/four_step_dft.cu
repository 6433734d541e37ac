// Complex DFT along either axis of (M, N) f32 re/im planes, as radix FFTs
// in shared memory, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of shardmerge_tpu/ops/pallas_fft.py:
//   dft_rows  <- `_rows_kernel` :103 (pallas_call at :157), DFT along N
//   dft_cols  <- `_cols_kernel` :186 (pallas_call at :222), DFT along M
// The TPU kernels run each axis as the four-step split n = n1*n2 with dense
// W1 (n1, n1) and W2 (n2, n2) products, cheap on the MXU. In f32 on this
// card those products cost 8*(n1 + n2) flops per element (51.5 GFLOP for
// dft_rows at (4096, 8192), 0.77 ms at the 67 TFLOP/s CUDA-core peak), 24x
// an FFT's 5*log2(n). This kernel does an FFT's arithmetic instead.
//
// What bounds it on this card: bytes. Where a block holds whole lines (a
// row of up to 16384 values, or a strip of >= 4 adjacent columns of up to
// 4096 rows) the transform is one launch that reads each input once and
// writes each output once: 16 bytes per element (537 MB, 0.16 ms at 3.35
// TB/s for (4096, 8192)). Longer lines take two launches of the four-step
// split through an (M, N) scratch pair: 32 bytes per element.
//
// Design (simple first). The host (ops/pallas_fft.py `_plan`) describes
// each launch as a pass: FFTs of length L along lines (g1, cg), element i
// of a line at g1*s1 + cg*sc + i*si. A block of 512 or 1024 threads takes W
// adjacent lines of one g1 (at most 16 complex values per thread, 14 where a
// radix-7 stage holds 2 butterflies of 7), and runs
// self-sorting (Stockham, decimation in frequency) stages, radix 8 first,
// then 4 or 2, 7, 5, 3 and a direct-sum stage for any other prime:
//
//   out[p*(R*s) + e*s + so] = w_m^(p*e) * sum_j w_R^(j*e) * in[(j*(m/R) + p)*s + so]
//
// The first stage reads the input planes, the middle ones run in place in
// shared memory (each thread reads its butterflies into registers, the
// block synchronises, then each writes), the last writes natural order to
// the output planes, multiplied by the pass's twiddle w_n^(f*k) (four-step
// pass 1) and divided by n (inverse, last pass). Neighbouring threads take
// neighbouring addresses: along a line where the line is contiguous (rows),
// across the strip where it is strided (columns). Shared memory holds the
// block's lines as complex values with one pad slot per 16, which spreads
// the stride-R writes of the early stages over the banks. The roots and the
// pass twiddle come from one table of e^(sign*2*pi*i*t/n), t < n (a pass of
// length L reads it at stride n/L), the stages' twiddles w_m^(p*e) from a
// table laid out per stage contiguously in p (so the first stage's loads
// coalesce); the host computes both in float64 and rounds once to f32, and
// the +-i of radices 4 and 8 are exact. A pass longer
// than a block holds (a prime factor above 16384) runs a direct O(L^2) sum
// per output from global memory. No --use_fast_math, no tensor cores.
//
// Device launches per call: one (single pass) or two (four-step route).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPer = 16;  // complex values a thread holds in a stage (at most)
constexpr int kMaxStages = 32;
constexpr int kDirectThreads = 256;

struct Pass {
  int L;       // transform length
  int W;       // adjacent lines per block
  int G1;      // outer line index count
  int lines;   // cg < lines
  int strips;  // ceil(lines / W): blockIdx.x = g1 * strips + strip
  int cfast;   // the strip index c is the fastest (the lines' elements are strided)
  // 32-bit offsets: the entry point checks that the largest one fits
  int in_s1, in_sc, in_si, out_s1, out_sc, out_si;
  int rs;       // table index of e^(sg*2*pi*i/L)
  int n;        // table length
  int twiddle;  // multiply output k by tab[(f*k) % n], f = g1*tw_g1 + cg*tw_c
  int tw_g1, tw_c;
  float div;  // != 0: divide every output by it (the inverse's n)
  float sg;   // -1 forward, +1 inverse: e^(sg*2*pi*i/4) = sg*i
  int nst;
};

// The stages' radices, a kernel parameter of their own: the kernel copies
// them to shared memory with constant indices, so that no thread indexes a
// parameter at run time (which would copy the parameters to local memory).
struct Radices {
  int r[kMaxStages];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * (sg * i)
__device__ __forceinline__ float2 cmul_i(float2 a, float sg) { return make_float2(-sg * a.y, sg * a.x); }
// one pad slot per 16 complex values: spreads the stride-R writes over the banks
__device__ __forceinline__ int pad2(int x) { return x + (x >> 4); }
__device__ __forceinline__ float2 tab(const float* __restrict__ tr, const float* __restrict__ ti, int k) {
  return make_float2(__ldg(tr + k), __ldg(ti + k));
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3, float sg) {
  const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
  const float2 s13 = cadd(a1, a3), d13 = cmul_i(csub(a1, a3), sg);
  a0 = cadd(s02, s13);
  a1 = cadd(d02, d13);
  a2 = csub(s02, s13);
  a3 = csub(d02, d13);
}

// In place: a[e] = sum_j a[j] * w_R^(j*e). root[q] = w_R^q for q <= R/2
// (odd R: w_R^(R-q) = conj(w_R^q); R = 8: root[1] only).
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R], const float2 (&root)[R / 2 + 1], float sg) {
  if constexpr (R == 2) {
    const float2 t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  } else if constexpr (R == 4) {
    dft4(a[0], a[1], a[2], a[3], sg);
  } else if constexpr (R == 8) {
    dft4(a[0], a[2], a[4], a[6], sg);
    dft4(a[1], a[3], a[5], a[7], sg);
    const float2 w1 = root[1], w3 = make_float2(-root[1].x, root[1].y);
    const float2 o[4] = {a[1], cmul(a[3], w1), cmul_i(a[5], sg), cmul(a[7], w3)};
    const float2 e[4] = {a[0], a[2], a[4], a[6]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = cadd(e[k], o[k]);
      a[k + 4] = csub(e[k], o[k]);
    }
  } else {  // odd R: pairs j, R-j share a root
    constexpr int h = R / 2;
    float2 s[h + 1], d[h + 1];
#pragma unroll
    for (int j = 1; j <= h; ++j) {
      s[j] = cadd(a[j], a[R - j]);
      d[j] = csub(a[j], a[R - j]);
    }
    float2 out[R];
    out[0] = a[0];
#pragma unroll
    for (int j = 1; j <= h; ++j) out[0] = cadd(out[0], s[j]);
#pragma unroll
    for (int e = 1; e < R; ++e) {
      float2 acc = a[0];
#pragma unroll
      for (int j = 1; j <= h; ++j) {
        const int q = (j * e) % R, qq = q <= h ? q : R - q;
        const float c = root[qq].x;
        const float sn = q <= h ? root[qq].y : -root[qq].y;
        // s*Re(w) + i*d*Im(w)
        acc.x = fmaf(s[j].x, c, fmaf(-d[j].y, sn, acc.x));
        acc.y = fmaf(s[j].y, c, fmaf(d[j].x, sn, acc.y));
      }
      out[e] = acc;
    }
#pragma unroll
    for (int e = 0; e < R; ++e) a[e] = out[e];
  }
}

// the last stage's store: the pass twiddle, the inverse's scale
__device__ __forceinline__ void store(const Pass& p, float* __restrict__ yr, float* __restrict__ yi,
                                      const float* __restrict__ tr, const float* __restrict__ ti, int g1,
                                      int cg, int k, float2 v) {
  if (p.twiddle) {
    const int f = g1 * p.tw_g1 + cg * p.tw_c;
    v = cmul(v, tab(tr, ti, (f * k) % p.n));
  }
  if (p.div != 0.f) {
    v.x = v.x / p.div;
    v.y = v.y / p.div;
  }
  const int off = g1 * p.out_s1 + cg * p.out_sc + k * p.out_si;
  yr[off] = v.x;
  yi[off] = v.y;
}

struct Ctx {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  const float* tr;  // the n-entry root table
  const float* ti;
  const float2* w;  // the stages' twiddle table
  float2* buf;      // the block's lines in shared memory, padded (pad2)
  int g1;
  int strip;
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): a stage's divisors are the same for every item, so each
// thread builds them once per stage instead of dividing per item.
struct FastDiv {
  unsigned m;
  int l;
  __device__ __forceinline__ explicit FastDiv(unsigned d) {
    l = 0;
    while ((1u << l) < d) ++l;
    m = unsigned(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const { return int((__umulhi(unsigned(n), m) + unsigned(n)) >> l); }
};

// The block's items of a stage: item t -> (line c, item u of `per` per
// line), c fastest when the lines are strided (cfast). Element i of line c
// sits at shared index i*iscale + c*cscale, then padded.
struct Items {
  FastDiv by;
  int per, W, cfast, iscale, cscale;
  __device__ __forceinline__ Items(const Pass& p, int per_)
      : by(unsigned(p.cfast ? p.W : per_)), per(per_), W(p.W), cfast(p.cfast), iscale(p.cfast ? p.W : 1),
        cscale(p.cfast ? 1 : p.L) {}
  __device__ __forceinline__ void at(int t, int& c, int& u) const {
    const int q = by.div(t);
    if (cfast) {
      c = t - q * W;
      u = q;
    } else {
      c = q;
      u = t - q * per;
    }
  }
};

// One radix-R stage over the block's W lines: (m, s) -> (m/R, R*s). A
// thread holds kPer / R butterflies (the host sizes blocks to that).
template <int R>
__device__ __forceinline__ void stage(const Pass& p, const Ctx& x, int m, int s, int toff, bool first, bool last) {
  constexpr int kB = kPer / R;
  const int T = blockDim.x;
  const int mn = m / R, per = p.L / R, total = p.W * per;
  const Items it{p, per};
  const FastDiv by_s{unsigned(s)};
  float2 root[R / 2 + 1] = {};  // the roots dft<R> reads (none for radices 2 and 4)
  if constexpr (R == 8) {
    root[1] = tab(x.tr, x.ti, per * p.rs);
  } else if constexpr (R % 2 == 1) {
#pragma unroll
    for (int q = 1; q <= R / 2; ++q) root[q] = tab(x.tr, x.ti, q * per * p.rs);
  }

  float2 v[kB][R];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int t = threadIdx.x + b * T;
    if (t < total) {
      int c, u;
      it.at(t, c, u);
      const int pp = by_s.div(u), so = u - pp * s;
      if (first) {  // s == 1
        const int cg = x.strip * p.W + c;
        const int base = x.g1 * p.in_s1 + cg * p.in_sc + pp * p.in_si, step = mn * p.in_si;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int off = base + j * step;
          v[b][j] = cg < p.lines ? make_float2(x.xr[off], x.xi[off]) : make_float2(0.f, 0.f);
        }
      } else {
        const int x0 = (pp * s + so) * it.iscale + c * it.cscale, step = mn * s * it.iscale;
#pragma unroll
        for (int j = 0; j < R; ++j) v[b][j] = x.buf[pad2(x0 + j * step)];
      }
      dft<R>(v[b], root, p.sg);
      if (pp != 0) {
#pragma unroll
        for (int e = 1; e < R; ++e) v[b][e] = cmul(v[b][e], __ldg(x.w + toff + (e - 1) * mn + pp));
      }
    }
  }
  if (!first) __syncthreads();  // every input of the stage is in registers
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int t = threadIdx.x + b * T;
    if (t < total) {
      int c, u;
      it.at(t, c, u);
      const int pp = by_s.div(u), so = u - pp * s;
      if (last) {  // m == R: pp == 0, output k = e*s + so
        const int cg = x.strip * p.W + c;
        if (cg < p.lines) {
#pragma unroll
          for (int e = 0; e < R; ++e) store(p, x.yr, x.yi, x.tr, x.ti, x.g1, cg, e * s + so, v[b][e]);
        }
      } else {
        const int x0 = (pp * R * s + so) * it.iscale + c * it.cscale, step = s * it.iscale;
#pragma unroll
        for (int e = 0; e < R; ++e) x.buf[pad2(x0 + e * step)] = v[b][e];
      }
    }
  }
  if (!last) __syncthreads();
}

// A stage of any radix R (a prime above 7): each thread computes up to
// kPer outputs, each a direct sum of R inputs.
__device__ __forceinline__ void stage_generic(const Pass& p, const Ctx& x, int R, int m, int s, int toff,
                                              bool first, bool last) {
  const int T = blockDim.x;
  const int L = p.L, mn = m / R, total = p.W * L;
  const int rstep = (L / R) * p.rs;
  const Items it{p, L};
  const FastDiv by_s{unsigned(s)}, by_r{unsigned(R)};
  float2 v[kPer];
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int t = threadIdx.x + b * T;
    if (t < total) {
      int c, o;
      it.at(t, c, o);
      const int q = by_s.div(o), so = o - q * s, pp = by_r.div(q), e = q - pp * R;
      const int cg = x.strip * p.W + c;
      const int base = x.g1 * p.in_s1 + cg * p.in_sc;
      float2 acc = make_float2(0.f, 0.f);
      int w = 0;  // (j*e) % R
      for (int j = 0; j < R; ++j) {
        const int i = (j * mn + pp) * s + so;
        float2 a;
        if (first) {
          const int off = base + i * p.in_si;
          a = cg < p.lines ? make_float2(x.xr[off], x.xi[off]) : make_float2(0.f, 0.f);
        } else {
          a = x.buf[pad2(i * it.iscale + c * it.cscale)];
        }
        const float2 r = tab(x.tr, x.ti, w * rstep);
        acc.x = fmaf(a.x, r.x, fmaf(-a.y, r.y, acc.x));
        acc.y = fmaf(a.x, r.y, fmaf(a.y, r.x, acc.y));
        w += e;
        if (w >= R) w -= R;
      }
      if (pp != 0 && e != 0) acc = cmul(acc, __ldg(x.w + toff + (e - 1) * mn + pp));
      v[b] = acc;
    }
  }
  if (!first) __syncthreads();
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    const int t = threadIdx.x + b * T;
    if (t < total) {
      int c, o;
      it.at(t, c, o);
      if (last) {
        const int cg = x.strip * p.W + c;
        if (cg < p.lines) store(p, x.yr, x.yi, x.tr, x.ti, x.g1, cg, o, v[b]);
      } else {
        x.buf[pad2(o * it.iscale + c * it.cscale)] = v[b];
      }
    }
  }
  if (!last) __syncthreads();
}

// 512 or 1024 threads a block, up to 64 registers a thread: two blocks of
// 512 or one of 1024 per SM. Three instances by the plan's radices, since
// the stages that an instance holds set its registers and spills for every
// stage: kSet 0 has radices 8, 4, 2 (every length on the Llama-3.1-8B path
// but 14336 and its splits), 1 adds 7, 5, 3, 2 adds the direct-sum stage of
// any other prime.
template <int kSet>
__global__ void __launch_bounds__(1024, 1)
pass_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
            float* __restrict__ yi, const float* __restrict__ tr, const float* __restrict__ ti,
            const float2* __restrict__ w, Pass p, Radices rad) {
  extern __shared__ float2 smem[];
  __shared__ int radix[kMaxStages];
#pragma unroll
  for (int q = 0; q < kMaxStages; ++q)
    if (threadIdx.x == q) radix[q] = rad.r[q];
  __syncthreads();
  Ctx x{xr, xi, yr, yi, tr, ti, w, smem, int(blockIdx.x / p.strips), int(blockIdx.x % p.strips)};
  if (p.nst == 0) {  // L == 1: a copy (the twiddle of k = 0 is 1)
    for (int c = threadIdx.x; c < p.W; c += blockDim.x) {
      const int cg = x.strip * p.W + c;
      if (cg < p.lines) {
        const int off = x.g1 * p.in_s1 + cg * p.in_sc;
        store(p, yr, yi, tr, ti, x.g1, cg, 0, make_float2(xr[off], xi[off]));
      }
    }
    return;
  }
  int m = p.L, s = 1, toff = 0;  // toff: the stage's first entry in w
  for (int st = 0; st < p.nst; ++st) {
    const int r = radix[st];
    const bool first = st == 0, last = st == p.nst - 1;
    if (r == 8) {
      stage<8>(p, x, m, s, toff, first, last);
    } else if (r == 4) {
      stage<4>(p, x, m, s, toff, first, last);
    } else if (r == 2) {
      stage<2>(p, x, m, s, toff, first, last);
    } else if constexpr (kSet >= 1) {
      if (r == 7) {
        stage<7>(p, x, m, s, toff, first, last);
      } else if (r == 5) {
        stage<5>(p, x, m, s, toff, first, last);
      } else if (r == 3) {
        stage<3>(p, x, m, s, toff, first, last);
      } else if constexpr (kSet == 2) {
        stage_generic(p, x, r, m, s, toff, first, last);
      }
    }
    toff += (r - 1) * (m / r);
    m /= r;
    s *= r;
  }
}

// A pass longer than a block holds: one thread per output, a direct sum
// over the line from global memory.
__global__ void __launch_bounds__(kDirectThreads)
direct_kernel(const float* __restrict__ xr, const float* __restrict__ xi, float* __restrict__ yr,
              float* __restrict__ yi, const float* __restrict__ tr, const float* __restrict__ ti, Pass p) {
  const long long total = (long long)p.G1 * p.lines * p.L;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int k = int(t % p.L);
    const long long line = t / p.L;
    const int cg = int(line % p.lines);
    const int g1 = int(line / p.lines);
    const int base = g1 * p.in_s1 + cg * p.in_sc;
    // partial sums of kChunk terms, then their sum: the rounding error
    // grows with sqrt(kChunk) + sqrt(L / kChunk), not sqrt(L)
    constexpr int kChunk = 128;
    float2 acc = make_float2(0.f, 0.f);
    int w = 0;  // (i*k) % L
    for (int i0 = 0; i0 < p.L; i0 += kChunk) {
      float2 part = make_float2(0.f, 0.f);
      for (int i = i0; i < min(i0 + kChunk, p.L); ++i) {
        const int off = base + i * p.in_si;
        const float2 a = make_float2(xr[off], xi[off]);
        const float2 r = tab(tr, ti, w * p.rs);
        part.x = fmaf(a.x, r.x, fmaf(-a.y, r.y, part.x));
        part.y = fmaf(a.x, r.y, fmaf(a.y, r.x, part.y));
        w += k;
        if (w >= p.L) w -= p.L;
      }
      acc = cadd(acc, part);
    }
    store(p, yr, yi, tr, ti, g1, cg, k, acc);
  }
}

template <int kSet>
cudaError_t launch(const Pass& p, const Radices& rad, long long blocks, int threads, const float* xr,
                   const float* xi, float* yr, float* yi, const float* tr, const float* ti, const float2* w,
                   cudaStream_t stream) {
  const int E = p.W * p.L;
  const size_t smem = sizeof(float2) * size_t(E + ((E - 1) >> 4) + 1);  // pad2(E - 1) + 1
  static bool opted = false;  // dynamic shared memory above 48 KB, once per instance
  if (!opted) {
    constexpr int most = kPer * 1024;
    const cudaError_t err = cudaFuncSetAttribute(pass_kernel<kSet>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 int(sizeof(float2) * (most + ((most - 1) >> 4) + 1)));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  pass_kernel<kSet><<<unsigned(blocks), threads, smem, stream>>>(xr, xi, yr, yi, tr, ti, w, p, rad);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes: one pass of ops/pallas_fft.py's plan.
// x and y are f32 re/im planes (distinct), tr/ti the n-entry root table of
// the direction, w the pass's stage twiddles (re, im pairs), d the pass descriptor
// (int64): L, W, G1, lines, in_s1, in_sc, in_si, out_s1, out_sc, out_si,
// rs, n, twiddle, tw_g1, tw_c, div, threads (512, 1024, or 0 for the direct
// sum), inverse, nst, radix[nst].
// Returns the cudaError_t of the launch (0 = success).
extern "C" int dft_pass(const float* xr, const float* xi, float* yr, float* yi, const float* tr, const float* ti,
                        const float2* w, const long long* d, void* stream) {
  Pass p{};
  Radices rad{};
  p.L = int(d[0]);
  p.W = int(d[1]);
  p.G1 = int(d[2]);
  p.lines = int(d[3]);
  // the largest input and output offsets, and the largest twiddle product
  // f*k, must fit the kernel's 32-bit index arithmetic
  for (int side = 0; side < 2; ++side) {
    const long long* st = d + 4 + 3 * side;
    if (st[0] < 0 || st[1] < 0 || st[2] < 0 ||
        (d[2] - 1) * st[0] + (d[3] - 1) * st[1] + (d[0] - 1) * st[2] > 0x7fffffffLL)
      return int(cudaErrorInvalidValue);
  }
  if (d[11] > 0x7fffffffLL || ((d[2] - 1) * d[13] + (d[3] - 1) * d[14]) * (d[0] - 1) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  p.in_s1 = int(d[4]);
  p.in_sc = int(d[5]);
  p.in_si = int(d[6]);
  p.out_s1 = int(d[7]);
  p.out_sc = int(d[8]);
  p.out_si = int(d[9]);
  p.rs = int(d[10]);
  p.n = int(d[11]);
  p.twiddle = int(d[12]);
  p.tw_g1 = int(d[13]);
  p.tw_c = int(d[14]);
  p.div = float(d[15]);
  const long long threads = d[16];
  p.sg = d[17] ? 1.f : -1.f;
  p.nst = int(d[18]);
  if (p.L < 1 || p.W < 1 || p.G1 < 1 || p.lines < 1 || p.nst < 0 || p.nst > kMaxStages || p.rs < 1 ||
      (long long)p.rs * p.L != p.n)
    return int(cudaErrorInvalidValue);
  long long prod = 1, fit = kPer;  // complex values a thread can hold in every stage
  int set = 0;  // the instance: 0 radices 8, 4, 2; 1 also 7, 5, 3; 2 any
  for (int st = 0; st < p.nst; ++st) {
    const int r = rad.r[st] = int(d[19 + st]);
    if (r < 2) return int(cudaErrorInvalidValue);
    prod *= r;
    if (r > 8) set = 2;
    else if (r != 8 && r != 4 && r != 2 && set == 0) set = 1;
    if (r <= 8 && r * (kPer / r) < fit) fit = r * (kPer / r);
  }
  if (prod != p.L) return int(cudaErrorInvalidValue);
  p.cfast = p.in_sc == 1 || p.in_si != 1;
  p.strips = (p.lines + p.W - 1) / p.W;
  const long long blocks = (long long)p.G1 * p.strips;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 0) {
    const long long total = (long long)p.G1 * p.lines * p.L;
    long long grid = (total + kDirectThreads - 1) / kDirectThreads;
    if (grid > (1 << 20)) grid = 1 << 20;
    direct_kernel<<<unsigned(grid), kDirectThreads, 0, s>>>(xr, xi, yr, yi, tr, ti, p);
    return int(cudaGetLastError());
  }
  if ((threads != 512 && threads != 1024) || (long long)p.W * p.L > fit * threads) return int(cudaErrorInvalidValue);
  const int t = int(threads);
  if (set == 0) return int(launch<0>(p, rad, blocks, t, xr, xi, yr, yi, tr, ti, w, s));
  if (set == 1) return int(launch<1>(p, rad, blocks, t, xr, xi, yr, yi, tr, ti, w, s));
  return int(launch<2>(p, rad, blocks, t, xr, xi, yr, yi, tr, ti, w, s));
}
