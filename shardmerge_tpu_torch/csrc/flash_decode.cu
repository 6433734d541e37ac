// Flash-decode attention for Hopper (sm_90a): one query token per row
// against a long, masked bf16 KV cache.
//
// Replaces the TPU Pallas kernel `_flash_kernel` / `flash_decode`
// (shardmerge_tpu/models/attn_kernels.py:100, pallas_call at :152). It
// computes what that kernel computes, not its block structure:
//
//   q     (B, KVH, G, D)  f32, already scaled by 1/sqrt(D)
//   k, v  (B, KVH, S, D)  bf16, contiguous (a layer of the stacked cache)
//   mask  (B, Sm)         f32 additive, Sm <= S: 0 for a valid slot, -1e9
//                         for a masked one; slots from Sm on are masked
//   out   (B, KVH, G, D)  f32; out[b, h, g] = softmax_s(q[b, h, g] . k[b, h, s]
//                         + mask[b, s]) @ v[b, h]
//
// D = 64 or 128 (the Llama family's head dims), 1 <= G <= 8. Scores,
// softmax and the weighted sum are f32. A masked slot (mask <= -1e8) is
// skipped: its weight exp(-1e9 + score - m) is exactly 0 in f32 once any
// slot is valid, and a decode row always has one (the token just written).
// A row with no valid slot returns zeros.
//
// What bounds it: every K and V element (2 bytes) is read once and used by
// G query heads, 2 G flops, so 4 flops per byte at G = 4, far below the
// card's balance point: it is bound by the K + V bytes streamed from device
// memory (only the valid slots' bytes, see below).
//
// Design (simple first). The TPU kernel walks S in order on one core and
// carries (m, l, acc) across grid steps; on a GPU the (b, kvh) pairs alone
// give 8-512 blocks for 132 SMs, so S is split across blocks instead, and
// the splits are cut over each row's VALID slots:
//   - flash_compact_kernel: block b lists row b's valid slots in slot order
//     (a block-wide prefix count of mask > -1e8, 2048 slots per pass) and
//     their number.
//   - flash_split_kernel: block (split, kvh, b) owns valid slots
//     [split * kSplit, (split + 1) * kSplit) of row b, and exits at once if
//     the row has fewer. A group of D / 8 lanes takes one slot (a half-warp
//     at D = 128, a quarter-warp at D = 64): each lane loads 16 bytes
//     (8 dims) of K with q's matching 8 dims for all G heads in registers,
//     and a shuffle tree within the group finishes the G dot products.
//     Scores plus mask go to shared memory; warp g then takes head g's max
//     (seeded at -1e30), exponentials and sum; the lane groups stream V with
//     16-byte loads and accumulate p * v; the 8 warps' partial outputs meet
//     in shared memory. Each block writes its split's (m, l, acc) to scratch.
//   - flash_combine_kernel: per (b, kvh, g), rescales each of the row's
//     splits by exp(m_i - M), sums (4 groups of splits in parallel, added in
//     a fixed order), divides by the summed l.
// Why valid slots: the continuous pool carves a row's history out of a
// shared slot axis, with join gaps and finished rows masked. Reading only
// valid slots skips those bytes, and it makes a row's result depend only on
// its own valid K/V rows, in order: not on the batch, the cache length or
// where the gaps fall. So a request decoded in the pool gets the same bits
// as decoded alone. No TMA, cp.async or tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 64;  // valid slots per block: fixed, so rows split alike
constexpr int kMaxG = 8;
constexpr float kNegInit = -1e30f;  // running-max seed, as in the TPU kernel
constexpr float kMaskedAt = -1e8f;  // mask values at or below: a masked slot

// block b: row b's valid slots in slot order, and their number. Each
// thread tests kPerThread consecutive slots; a warp shuffle scan and the
// warps' totals give every thread its first output position.
constexpr int kPerThread = 8;

__global__ void __launch_bounds__(kThreads)
flash_compact_kernel(const float* __restrict__ mask, int* __restrict__ idx,
                     int* __restrict__ count, int Sm) {
  __shared__ int warp_total[kWarps];
  __shared__ int base;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* mr = mask + (size_t)b * Sm;
  int* ir = idx + (size_t)b * Sm;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int s0 = 0; s0 < Sm; s0 += kThreads * kPerThread) {
    const int first = s0 + threadIdx.x * kPerThread;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int s = first + j;
      if (s < Sm && mr[s] > kMaskedAt) bits |= 1u << j;
    }
    const int mine = __popc(bits);
    int incl = mine;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int offset = base + incl - mine;
    for (int w = 0; w < warp; ++w) offset += warp_total[w];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if ((bits >> j) & 1u) ir[offset++] = first + j;
    __syncthreads();  // every thread has read base and warp_total
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += warp_total[w];
      base += total;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) count[b] = base;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                   const int* __restrict__ idx, const int* __restrict__ count,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int KVH, int Sm, int S, int nsplit) {
  constexpr int kLanes = D / 8;                  // lanes per slot, 8 dims each
  constexpr int kPerWarp = 32 / kLanes;          // slots a warp takes at once
  constexpr int kPerPass = kWarps * kPerWarp;    // slots the block takes at once
  // one buffer, two uses: probabilities [G][kSplit], then the warps'
  // partial outputs [kWarps][G][D]
  constexpr int kSmem = kWarps * G * D > G * kSplit ? kWarps * G * D : G * kSplit;
  __shared__ __align__(16) float smem[kSmem];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = split * kSplit;
  const int nb = count[b];
  if (s0 >= nb) return;  // the row has no valid slot this far
  const int n = min(kSplit, nb - s0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = lane / kLanes;  // the warp's slot this lane works on
  const int li = lane % kLanes;   // the lane's 8 dims: [8 li, 8 li + 8)
  const size_t bh = (size_t)b * KVH + h;
  // K / V row of slot s: D / 8 uint4 of 8 bf16 each
  const uint4* kr = reinterpret_cast<const uint4*>(k + bh * S * D);
  const uint4* vr = reinterpret_cast<const uint4*>(v + bh * S * D);
  const float* mr = mask + (size_t)b * Sm;
  const int* ir = idx + (size_t)b * Sm + s0;  // this split's slots

  // 1. scores: a lane group per slot, lane li holds dims [8 li, 8 li + 8)
  {
    float qr[G][8];
    const float* qb = q + bh * G * D + li * 8;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(qb + g * D);
      const float4 c = *reinterpret_cast<const float4*>(qb + g * D + 4);
      qr[g][0] = a.x; qr[g][1] = a.y; qr[g][2] = a.z; qr[g][3] = a.w;
      qr[g][4] = c.x; qr[g][5] = c.y; qr[g][6] = c.z; qr[g][7] = c.w;
    }
    for (int base = warp * kPerWarp; base < n; base += kPerPass) {  // uniform per warp
      const int s = base + sub;
      const bool live = s < n;
      float kf[8];
      const int slot = live ? ir[s] : 0;
      if (live) {
        unpack8(__ldg(kr + (size_t)slot * kLanes + li), kf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = 0.f;
      }
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qr[g][j], kf[j], d);
        dot[g] = d;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (live && li < G) {
        float d = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g == li) d = dot[g];
        smem[li * kSplit + s] = d + mr[slot];
      }
    }
  }
  __syncthreads();

  // 2. softmax statistics of this split: warp g takes head g
  if (warp < G) {
    float* row = smem + warp * kSplit;
    float m = kNegInit;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(row[i] - m);
      row[i] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      const size_t o = (bh * nsplit + split) * G + warp;
      part_m[o] = m;
      part_l[o] = l;
    }
  }
  __syncthreads();

  // 3. p @ V: lane group (warp, sub) takes slots warp * kPerWarp + sub,
  // then every kPerPass-th after it
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  for (int s = warp * kPerWarp + sub; s < n; s += kPerPass) {
    float vf[8];
    unpack8(__ldg(vr + (size_t)ir[s] * kLanes + li), vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = smem[g * kSplit + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[j], acc[g][j]);
    }
  }
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
  __syncthreads();  // probabilities consumed: smem becomes [kWarps][G][D]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(smem + (warp * G + g) * D + li * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  float* out = part_acc + (bh * nsplit + split) * G * D;
  for (int o = tid; o < G * D; o += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += smem[w * G * D + o];
    out[o] = a;
  }
}

constexpr int kGroups = 4;  // split groups of a combine block

// a max or a sum over the block's kNumWarps warps, the same bits for every
// thread: a shuffle tree per warp, then the warps' values in order
template <bool kMax, int kNumWarps>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kNumWarps; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  __syncthreads();  // red is reused by the next call
  return t;
}

// block bhg = (b * KVH + h) * G + g over the row's splits only; thread
// (group, d) sums every kGroups-th split's acc[d], the groups then add in
// order, so the result depends only on the row's number of splits
template <int D>
__global__ void __launch_bounds__(kGroups * D)
flash_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, const int* __restrict__ count,
                     float* __restrict__ out, int KVH, int G, int nsplit) {
  constexpr int kCombineThreads = kGroups * D;
  constexpr int kNumWarps = kCombineThreads / 32;
  __shared__ float red[kNumWarps];
  __shared__ float acc_by_group[kGroups][D];
  const int bhg = blockIdx.x;
  const int tid = threadIdx.x;
  const int d = tid % D;
  const int group = tid / D;
  const size_t bh = bhg / G;
  const int g = bhg % G;
  const int used = (count[bh / KVH] + kSplit - 1) / kSplit;
  const float* pm = part_m + bh * nsplit * G + g;  // split i at pm[i * G]
  const float* pl = part_l + bh * nsplit * G + g;
  const float* pa = part_acc + (bh * nsplit * G + g) * D + d;  // split i at pa[i * G * D]

  float m = kNegInit;
  for (int i = tid; i < used; i += kCombineThreads) m = fmaxf(m, pm[i * G]);
  const float m_all = block_reduce<true, kNumWarps>(m, red);
  float l = 0.f;
  for (int i = tid; i < used; i += kCombineThreads) l = fmaf(expf(pm[i * G] - m_all), pl[i * G], l);
  const float l_all = block_reduce<false, kNumWarps>(l, red);
  float a = 0.f;
#pragma unroll 4
  for (int i = group; i < used; i += kGroups)
    a = fmaf(expf(pm[i * G] - m_all), pa[(size_t)i * G * D], a);
  acc_by_group[group][d] = a;
  __syncthreads();
  if (group == 0) {
    float t = acc_by_group[0][d];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) t += acc_by_group[j][d];
    out[(size_t)bhg * D + d] = t / fmaxf(l_all, 1e-30f);
  }
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* mask;
  const int* idx;
  const int* count;
  float* part_m;
  float* part_l;
  float* part_acc;
  float* out;
  int B, KVH, G, Sm, S, nsplit;
};

template <int D, int G>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  dim3 grid(a.nsplit, a.KVH, a.B);
  flash_split_kernel<D, G><<<grid, kThreads, 0, stream>>>(
      a.q, static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v),
      a.mask, a.idx, a.count, a.part_m, a.part_l, a.part_acc, a.KVH, a.Sm, a.S, a.nsplit);
  return cudaGetLastError();
}

// the split and combine passes for head dim D
template <int D>
cudaError_t launch_head_dim(const Args& a, cudaStream_t s) {
  cudaError_t err;
  switch (a.G) {
    case 1: err = launch_split<D, 1>(a, s); break;
    case 2: err = launch_split<D, 2>(a, s); break;
    case 3: err = launch_split<D, 3>(a, s); break;
    case 4: err = launch_split<D, 4>(a, s); break;
    case 5: err = launch_split<D, 5>(a, s); break;
    case 6: err = launch_split<D, 6>(a, s); break;
    case 7: err = launch_split<D, 7>(a, s); break;
    default: err = launch_split<D, 8>(a, s); break;
  }
  if (err != cudaSuccess) return err;
  flash_combine_kernel<D><<<a.B * a.KVH * a.G, kGroups * D, 0, s>>>(
      a.part_m, a.part_l, a.part_acc, a.count, a.out, a.KVH, a.G, a.nsplit);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Scratch: idx B*Sm and count B ints;
// part_m / part_l B*KVH*nsplit*G and part_acc B*KVH*nsplit*G*D floats, with
// nsplit = ceil(Sm / 64). Returns the cudaError_t of the launches (0 =
// success).
extern "C" int flash_decode(const float* q, const void* k, const void* v, const float* mask,
                            int* idx, int* count, float* part_m, float* part_l,
                            float* part_acc, float* out, int B, int KVH, int G, int D, int Sm,
                            int S, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxG || (D != 64 && D != 128) || Sm < 1 || Sm > S ||
      KVH > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, mask, idx, count, part_m, part_l, part_acc, out,
               B, KVH, G, Sm, S, (Sm + kSplit - 1) / kSplit};
  flash_compact_kernel<<<B, kThreads, 0, s>>>(mask, idx, count, Sm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(D == 64 ? launch_head_dim<64>(a, s) : launch_head_dim<128>(a, s));
}
