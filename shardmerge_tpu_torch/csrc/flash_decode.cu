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
// D = 64 or 128 (the Llama family's head dims), 1 <= G <= 64. Scores,
// softmax and the weighted sum are f32. A masked slot (mask <= -1e8) is
// skipped: its weight exp(-1e9 + score - m) is exactly 0 in f32 once any
// slot is valid, and a decode row always has one (the token just written).
// A row with no valid slot returns zeros.
//
// What bounds it: every K and V element (2 bytes) is read once and used by
// G query heads, 2 G flops, so 4 flops per byte at G = 4, far below the
// card's balance point: it is bound by the K + V bytes of the valid slots.
// That is also why it runs on the CUDA cores in f32 and not on the tensor
// cores: at 4 flops a byte the f32 pipes are idle most of the time, and q
// is f32 by contract.
//
// Two kernels:
//   - flash_compact_kernel, once per decode step (the mask is the same for
//     every layer): block b lists row b's valid slots in slot order (a
//     block-wide prefix count of mask > -1e8) and their number.
//   - flash_kernel, once per layer: block (split, kvh * chunks + chunk, b)
//     owns valid slots [256 split, 256 split + 256) of row b for one chunk
//     of at most 4 of the KV head's G query heads, and exits at once if
//     the row has fewer slots. G > 4 splits into ceil(G / 4) balanced
//     chunks, each reading the K/V rows again: a block of 5 to 8 heads
//     spills registers under the 128-register cap of two blocks an SM and
//     costs far more than the second pass over K/V that a chunk of 4
//     costs (PERF.md, PR 6). It streams their K and V rows through a ring
//     of 4 shared-memory stages of 32 slots (cp.async 16-byte copies
//     gathered through the slot list, zero-filled past the block's slots),
//     three chunks in flight while one is computed; the mask values are gathered while the first
//     chunks fly. A group of D / 8 lanes takes a slot (a half-warp at
//     D = 128), each lane 8 dims, with q's matching 8 dims for all G heads
//     in registers, and carries an online softmax (m, l, acc) over its slots
//     in slot order, as the TPU kernel carries them over its grid steps.
//     The groups of a warp, then the 8 warps, then the row's splits merge
//     their (m, l, acc) in a fixed order. A row with one split writes its
//     output at once; otherwise each split writes its partial, and the last
//     block of the row to finish (an atomic counter per (b, kvh, chunk),
//     which that block resets for the next call) merges the partials in
//     split order.
// The split size is one constant, so a row's bits depend only on its valid
// K/V rows in slot order: not on the batch, the cache length, or where the
// continuous pool's join gaps fall, and a request decoded in the pool gets
// the same bits as decoded alone. A head's arithmetic never mixes with
// another head's, so its bits do not depend on its chunk or on G either.
// Each slot's K and V rows are contiguous and could each be one TMA bulk
// copy, but a bulk copy per row measured slower than the 16-byte cp.async
// gather, and tensor-map TMA copies boxes, not a list of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 2;  // resident blocks per SM: 128 registers a thread
constexpr int kSplit = 256;  // valid slots per block: fixed, so rows split alike
constexpr int kMaxG = 4;       // query heads a block takes (a chunk of the G heads)
constexpr int kMaxGroup = 64;  // query heads per KV head
constexpr float kNegInit = -1e30f;  // running-max seed, as in the TPU kernel
constexpr float kMaskedAt = -1e8f;  // mask values at or below: a masked slot
#define kNegInf __int_as_float(0xff800000)  // a dead slot's score

// block b: row b's valid slots in slot order, and their number. Each
// thread tests kPerThread consecutive slots; a warp shuffle scan and the
// warps' totals give every thread its first output position.
constexpr int kPerThread = 8;
constexpr int kCompactWarps = 8;
constexpr int kCompactThreads = kCompactWarps * 32;

__global__ void __launch_bounds__(kCompactThreads)
flash_compact_kernel(const float* __restrict__ mask, int* __restrict__ idx, int* __restrict__ count, int Sm) {
  __shared__ int warp_total[kCompactWarps];
  __shared__ int base;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* mr = mask + (size_t)b * Sm;
  int* ir = idx + (size_t)b * Sm;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int s0 = 0; s0 < Sm; s0 += kCompactThreads * kPerThread) {
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
      for (int w = 0; w < kCompactWarps; ++w) total += warp_total[w];
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kChunk = 32;  // slots a pipeline stage holds
constexpr int kStages = 4;  // stages in the ring: three chunks in flight while one is computed
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a block may ask for

// dynamic shared memory: the block's slot indices and mask values, then one
// region used in turn by the K/V stages, the warps' (m, l, acc) and the last
// block's split weights; G is the heads a block takes (a chunk)
template <int D, int G>
struct Smem {
  static constexpr int kStageBytes = 2 * kChunk * D * 2;  // K and V rows of a chunk, bf16
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kWarpState = (kWarps * G * D + 2 * kWarps * G) * 4;
  static constexpr int kHead = 2 * kSplit * 4;
  static int bytes(int nsplit) {
    int region = kRing > kWarpState ? kRing : kWarpState;
    if (2 * nsplit * G * 4 > region) region = 2 * nsplit * G * 4;
    return kHead + region;
  }
};

template <int D, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
             const float* __restrict__ mask, const int* __restrict__ idx, const int* __restrict__ count,
             float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
             int* __restrict__ counter, float* __restrict__ out, int KVH, int Sm, int S, int nsplit, int Gt,
             int nchunk) {
  constexpr int kLanes = D / 8;                           // lanes per slot, 8 dims each
  constexpr int kGroups = 32 / kLanes;                    // slot groups per warp
  constexpr int U = kChunk / (kWarps * kGroups);          // slots a group takes from a chunk
  constexpr int kCopies = 2 * kChunk * kLanes / kThreads;  // 16-byte copies a thread issues per chunk
  static_assert(U >= 1 && kCopies >= 1, "a chunk feeds every group and thread");
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_mask = reinterpret_cast<float*>(smem) + kSplit;
  unsigned char* region = smem + Smem<D, G>::kHead;
  uint4* ring = reinterpret_cast<uint4*>(region);  // [kStages][2][kChunk][kLanes]
  float* sm_acc = reinterpret_cast<float*>(region);  // [kWarps][G][D]
  float* sm_m = sm_acc + kWarps * G * D;               // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;
  __shared__ int last_block;

  // the block's chunk: heads [g0, g0 + gn) of the KV head's Gt, gn <= G
  const int split = blockIdx.x;
  const int h = blockIdx.y / nchunk;
  const int g0 = (blockIdx.y % nchunk) * G;
  const int gn = min(G, Gt - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * KVH + h;
  float* const out_c = out + (bh * Gt + g0) * D;  // the chunk's heads, (gn, D)
  const int nb = count[b];
  const int used = (nb + kSplit - 1) / kSplit;
  if (split >= used) {
    if (split == 0)  // the row has no valid slot: zeros
      for (int o = tid; o < gn * D; o += kThreads) out_c[o] = 0.f;
    return;
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / kLanes;  // the lane's slot group in the warp
  const int li = lane % kLanes;   // the lane's 8 dims: [8 li, 8 li + 8)
  const int s0 = split * kSplit;
  const int n = min(kSplit, nb - s0);  // valid slots of this block
  const int nchunks = (n + kChunk - 1) / kChunk;
  const uint4* kr = reinterpret_cast<const uint4*>(k + bh * S * D);
  const uint4* vr = reinterpret_cast<const uint4*>(v + bh * S * D);

  for (int i = tid; i < n; i += kThreads) s_idx[i] = idx[(size_t)b * Sm + s0 + i];
  __syncthreads();

  // chunk c's K and V rows into stage c % kStages; past the block's slots
  // the copies zero-fill (a dead slot's V is then 0, not stale bits)
  auto issue = [&](int c) {
    if (c < nchunks) {
      uint4* stage = ring + (c % kStages) * 2 * kChunk * kLanes;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int p = tid + i * kThreads;
        const int kv = p / (kChunk * kLanes);
        const int rem = p % (kChunk * kLanes);
        const int si = c * kChunk + rem / kLanes;
        const bool live = si < n;
        const uint4* src = (kv ? vr : kr) + (size_t)(live ? s_idx[si] : 0) * kLanes + rem % kLanes;
        cp_async16(stage + p, src, live ? 16 : 0);
      }
    }
    cp_async_commit();  // one group per chunk, empty past the last, so the waits count alike
  };

  float qr[G][8];  // a head past the chunk's gn gets q = 0 and is never written
  {
    const float* qb = q + (bh * Gt + g0) * D + li * 8;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 a = g < gn ? *reinterpret_cast<const float4*>(qb + g * D) : zero;
      const float4 c = g < gn ? *reinterpret_cast<const float4*>(qb + g * D + 4) : zero;
      qr[g][0] = a.x; qr[g][1] = a.y; qr[g][2] = a.z; qr[g][3] = a.w;
      qr[g][4] = c.x; qr[g][5] = c.y; qr[g][6] = c.z; qr[g][7] = c.w;
    }
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInit;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  // the mask values arrive while the first chunks are in flight (the
  // loop's first barrier publishes them)
  for (int i = tid; i < n; i += kThreads) s_mask[i] = mask[(size_t)b * Sm + s_idx[i]];
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();               // everyone's have, and chunk c - 1's stage is free
    issue(c + kStages - 1);
    const uint4* stage = ring + (c % kStages) * 2 * kChunk * kLanes;
    // the group's U slots of the chunk, in order
    const int sb = (warp * kGroups + grp) * U;
    float sc[U][G];
    float vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(stage[(sb + u) * kLanes + li], kf);
      unpack8(stage[(kChunk + sb + u) * kLanes + li], vf[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qr[g][j], kf[j], d);
        sc[u][g] = d;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float cm = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int si = c * kChunk + sb + u;
        sc[u][g] = si < n ? sc[u][g] + s_mask[si] : kNegInf;
        cm = fmaxf(cm, sc[u][g]);
      }
      const float scale = expf(m[g] - cm);
      m[g] = cm;
      l[g] *= scale;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= scale;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(sc[u][g] - cm);
        l[g] += p;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(p, vf[u][j], acc[g][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the warps' state

  // the warp's groups, merged by a shuffle tree
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float om = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], om);
      const float a = expf(m[g] - mm), c = expf(om - mm);
      m[g] = mm;
      l[g] = l[g] * a + ol * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + oa * c;
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(sm_acc + (warp * G + g) * D + li * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (li == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the 8 warps, in order: this split's (m, l, acc) per output (g, d)
  const size_t row_part = bh * nsplit * Gt + g0;  // split i, head g0 + g at row_part + i * Gt + g
  for (int o = tid; o < gn * D; o += kThreads) {
    const int g = o / D, d = o % D;
    float mm = kNegInit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * G + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * G + g] - mm);
      ll = fmaf(sm_l[w * G + g], e, ll);
      aa = fmaf(sm_acc[(w * G + g) * D + d], e, aa);
    }
    if (used == 1) {
      out_c[o] = aa / ll;
    } else {
      part_acc[(row_part + (size_t)split * Gt) * D + o] = aa;
      if (d == 0) {
        part_m[row_part + (size_t)split * Gt + g] = mm;
        part_l[row_part + (size_t)split * Gt + g] = ll;
      }
    }
  }
  if (used == 1) return;

  // the last split of the row to finish merges the partials in split order
  __threadfence();
  __syncthreads();
  int* const cnt = counter + (size_t)blockIdx.z * gridDim.y + blockIdx.y;  // per (b, kvh, chunk)
  if (tid == 0) last_block = atomicAdd(cnt, 1) == used - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  float* w_m = reinterpret_cast<float*>(region);  // [used][G], the region is free again
  float* w_l = w_m + used * G;
  for (int i = tid; i < used * G; i += kThreads) {
    const int sp = i / G, g = i % G;
    if (g < gn) {
      w_m[i] = __ldcg(part_m + row_part + (size_t)sp * Gt + g);
      w_l[i] = __ldcg(part_l + row_part + (size_t)sp * Gt + g);
    }
  }
  __syncthreads();
  for (int o = tid; o < gn * D; o += kThreads) {
    const int g = o / D;
    float mm = kNegInit;
    for (int i = 0; i < used; ++i) mm = fmaxf(mm, w_m[i * G + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll 8
    for (int i = 0; i < used; ++i) {
      const float e = expf(w_m[i * G + g] - mm);
      ll = fmaf(w_l[i * G + g], e, ll);
      aa = fmaf(__ldcg(part_acc + (row_part + (size_t)i * Gt) * D + o), e, aa);
    }
    out_c[o] = aa / ll;
  }
  if (tid == 0) *cnt = 0;  // ready for the next call
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
  int* counter;
  float* out;
  int B, KVH, Sm, S, nsplit, G, nchunk;
};

template <int D, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(flash_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int bytes = Smem<D, G>::bytes(a.nsplit);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid(a.nsplit, a.KVH * a.nchunk, a.B);
  flash_kernel<D, G><<<grid, kThreads, bytes, stream>>>(
      a.q, static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v), a.mask, a.idx, a.count,
      a.part_m, a.part_l, a.part_acc, a.counter, a.out, a.KVH, a.Sm, a.S, a.nsplit, a.G, a.nchunk);
  return cudaGetLastError();
}

// G: the heads a block takes, ceil(Gt / chunks) for chunks = ceil(Gt / kMaxG)
template <int D>
cudaError_t launch_head_dim(const Args& a, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(a, s);
    case 2: return launch<D, 2>(a, s);
    case 3: return launch<D, 3>(a, s);
    default: return launch<D, 4>(a, s);
  }
}

}  // namespace

// C entry points, bound with ctypes; each returns the cudaError_t of its
// launch (0 = success).
//
// flash_compact: idx (B, Sm) and count (B) ints from the (B, Sm) mask.
extern "C" int flash_compact(const float* mask, int* idx, int* count, int B, int Sm, void* stream) {
  if (B < 1 || Sm < 1 || B > 2147483647 / Sm) return int(cudaErrorInvalidValue);
  flash_compact_kernel<<<B, kCompactThreads, 0, static_cast<cudaStream_t>(stream)>>>(mask, idx, count, Sm);
  return int(cudaGetLastError());
}

// flash_decode: one launch over the slot list of flash_compact. Scratch:
// part_m / part_l B*KVH*nsplit*G and part_acc B*KVH*nsplit*G*D floats with
// nsplit = ceil(Sm / 256); counter B*KVH*ceil(G / 4) ints, zero before the
// first call (the kernel leaves them zero).
extern "C" int flash_decode(const float* q, const void* k, const void* v, const float* mask, const int* idx,
                            const int* count, float* part_m, float* part_l, float* part_acc, int* counter,
                            float* out, int B, int KVH, int G, int D, int Sm, int S, void* stream) {
  if (B < 1 || KVH < 1 || G < 1 || G > kMaxGroup || (D != 64 && D != 128) || Sm < 1 || Sm > S || B > 65535)
    return int(cudaErrorInvalidValue);
  const int nchunk = (G + kMaxG - 1) / kMaxG;
  if (KVH > 65535 / nchunk) return int(cudaErrorInvalidValue);
  const Args a{q, k, v, mask, idx, count, part_m, part_l, part_acc, counter, out,
               B, KVH, Sm, S, (Sm + kSplit - 1) / kSplit, G, nchunk};
  const int per_block = (G + nchunk - 1) / nchunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(D == 64 ? launch_head_dim<64>(a, per_block, s) : launch_head_dim<128>(a, per_block, s));
}
