// int4 split-half GEMV for Hopper (sm_90a): y = x @ dequant(W).T
//
// Replaces the TPU Pallas kernel `_gemv4_kernel` / `_int4_matmul_2d`
// (shardmerge_tpu/models/quant_kernels.py:101, pallas_call at :148). It
// computes what that kernel computes, not its block structure:
//
//   x     (B, K)    f32 or bf16, B <= 64, row-major, 16-byte aligned
//   q     (N, K/2)  uint8; byte j of row n holds W[n, j] + 8 in its low
//                   nibble and W[n, j + K/2] + 8 in its high nibble
//   scale (N,)      f32, one per output channel
//   y     (B, N)    x's dtype; y[b, n] = scale[n] * sum_j
//                   (x[b, j] * (lo - 8) + x[b, j + K/2] * (hi - 8))
//
// Accumulation is f32; the scale multiplies once at the end; the output is
// rounded once to x's dtype.
//
// What bounds it: a decode GEMV reads every weight byte once and does 4 B
// flops per byte, so up to B = 64 it sits at or below the card's ~295
// flop/byte balance point: it is bound by the bytes of q streamed from
// device memory. The design reads them once, whatever B is:
//   - the host plan (quant_kernels.plan, a function of (N, K) alone) cuts
//     K/2 into at most 8 splits of whole 256-byte chunks. A block owns one
//     split of a tile of 32 rows (64 at B > 16); the splits of a tile are
//     one thread block cluster, and the cluster's first block adds their
//     partial sums in split order through distributed shared memory. No
//     global scratch, no atomics;
//   - bf16 x runs on the tensor cores. A producer warp keeps a ring of 4
//     shared-memory stages full with TMA copies: per chunk the weights' (32
//     rows x 256 bytes) box and x's (8 NT rows x 2 halves x 256 columns)
//     bf16 box, columns past K/2 and rows past N or B arriving as zeros, so
//     x is staged once per block in its own type. Eight consumer warps wait
//     on a stage's full barrier and release it on its empty barrier, never
//     on each other. Consumer warp w takes the 16-row m tile w % 2 and the
//     64-byte K segment w / 2 of every chunk, and feeds mma.sync.m16n8k16
//     (bf16 in, f32 accumulate) with the weights as the M = 16 operand and x
//     as the N = 8 operand (output rows on M, batch rows on N). A nibble u
//     becomes the bf16 value u - 8 exactly: prmt packs it under the exponent
//     byte of 128.0 (0x43 0x0u = 128 + u) and one bf16x2 fma subtracts 136.
//     The low nibbles multiply x[:, j], the high nibbles x[:, K/2 + j]: two
//     products per 16 bytes of a row. Up to 8 n8 tiles of x (B <= 64) go
//     through the same dequantized fragment (and at B > 16 each x fragment
//     through two m tiles), so W is read once. Inside a 16-byte K step a
//     lane's 4 bytes are fragment columns (2t, 2t+1, 2t+8, 2t+9): a fixed
//     order of k that x's fragments follow. The 4 segments' sums are added
//     in segment order at the end;
//   - f32 x stays on the CUDA cores (an exact f32 product would not survive
//     tf32), with its own plan unit and tile: 32 rows, 64-byte stages
//     copied by cp.async through an 8-stage ring; a thread owns 8 bytes of
//     a row of each stage (the 8 parts' sums added in part order at the
//     end; above 16 rows of x, more warps take them 16 at a time), a nibble
//     becomes a float by the same exponent trick (0x4B000000 | u is
//     2^23 + u), and each byte does 2 f32 fmas per row of x.
// A row's bits depend on its values alone: the K order of each output is
// fixed by the plan (splits in order; in a split, chunks in order; in a
// chunk, segments, then K steps in order, low then high), never by B or by
// the other rows, so row 0 of a batch of 64 gets the bits it gets alone,
// and a pool completion equals the solo one.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSegs = 4;            // 64-byte K segments of a row a stage holds (bf16 x)
constexpr int kChunk = 64 * kSegs;  // packed bytes of each row a stage holds: the plan's unit of K/2
constexpr int kRows = 128 / kSegs;  // output rows of a block (twice that above B = 16): 8 KiB a stage
constexpr int kStages = 4;          // ring stages: three chunks in flight while one is computed
constexpr int kMaxSmem = 200 * 1024;
constexpr int kMaxSplits = 8;  // splits of K/2 per row tile: a cluster holds at most 8 blocks

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}
// TMA: the box of map at the given coordinates into dst, its bytes counted
// on bar; coordinates past the tensor's edge arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* x;
  const uint8_t* q;
  const float* scale;
  void* y;
  int B, N, Kh, cps;  // cps: the kernel's chunks of K/2 per split
};

// The split's bytes [k0, k1) of each packed row: blockIdx.y's run of the
// plan, in the kernel's chunks of ``chunk`` bytes
struct Span {
  int k0, k1;
  __device__ int chunks(int chunk) const { return (k1 - k0 + chunk - 1) / chunk; }
};
__device__ __forceinline__ Span split_span(const Args& a, int chunk) {
  const int k0 = blockIdx.y * a.cps * chunk;
  return {k0, min(a.Kh, k0 + a.cps * chunk)};
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at p in the shared memory of the cluster's block ``rank``
__device__ __forceinline__ float cluster_load(const float* p, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The splits of a row tile are one thread block cluster (1 x splits; its
// rank r is split r). Each block has left its partial sums, (B, tile) f32,
// at ``mine`` in its shared memory; the cluster's first block adds them in
// split order through distributed shared memory, scales, rounds and stores
// y. No global scratch and no atomics.
template <typename T>
__device__ void merge_splits(const Args& a, int n0, int tile, const float* mine) {
  cluster_sync();
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  if (rank == 0) {
    const int rows = min(tile, a.N - n0);
    for (int o = threadIdx.x; o < a.B * tile; o += blockDim.x) {
      const int b = o / tile, r = o % tile;
      if (r >= rows) continue;
      float v = mine[o];
      for (int s = 1; s < (int)gridDim.y; ++s) v += cluster_load(mine + o, s);
      store(static_cast<T*>(a.y) + (size_t)b * a.N + n0 + r, v * a.scale[n0 + r]);
    }
  }
  cluster_sync();  // the other blocks keep their shared memory until the first has read it
}

// Output (row r of the tile, batch row b) of this block: y when the block
// is the tile's only split, else its partial at mine[b * tile + r].
template <typename T>
__device__ __forceinline__ void put(const Args& a, int n0, int r, int b, float v, float* mine, int tile) {
  const int n = n0 + r;
  if (n >= a.N || b >= a.B) return;
  if (gridDim.y == 1)
    store(static_cast<T*>(a.y) + (size_t)b * a.N + n, v * a.scale[n]);
  else
    mine[b * tile + r] = v;
}

// ---- bf16 x: tensor cores ----

// bf16x2 {128 + u0, 128 + u1} -> {u0 - 8, u1 - 8}, exact
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The A fragments of one 16-byte K step from a lane's word of row g (wa)
// and of row g + 8 (wb): bytes 0, 1 -> columns 2t, 2t+1 and bytes 2, 3 ->
// columns 2t+8, 2t+9; lo from the low nibbles, hi from the high ones.
__device__ __forceinline__ void dequant(uint32_t wa, uint32_t wb, uint32_t lo[4], uint32_t hi[4]) {
  const uint32_t la = wa & 0x0F0F0F0Fu, lb = wb & 0x0F0F0F0Fu;
  const uint32_t ha = (wa >> 4) & 0x0F0F0F0Fu, hb = (wb >> 4) & 0x0F0F0F0Fu;
  const uint32_t e = 0x43434343u;
  lo[0] = minus136(__byte_perm(la, e, 0x4140));
  lo[1] = minus136(__byte_perm(lb, e, 0x4140));
  lo[2] = minus136(__byte_perm(la, e, 0x4342));
  lo[3] = minus136(__byte_perm(lb, e, 0x4342));
  hi[0] = minus136(__byte_perm(ha, e, 0x4140));
  hi[1] = minus136(__byte_perm(hb, e, 0x4140));
  hi[2] = minus136(__byte_perm(ha, e, 0x4342));
  hi[3] = minus136(__byte_perm(hb, e, 0x4342));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMTiles = kRows / 16;  // m16 tiles of a kRows group: consumer warp w takes tile w % kMTiles
                                     // (of each group), K segment w / kMTiles of each chunk
constexpr int kTcThreads = kThreads + 32;  // the 8 consumer warps and one producer warp

// One ring stage: the weights' (MT kRows x kChunk bytes) box, then x's
// (8 NT rows x 2 halves x kChunk) bf16 box: row b holds its kChunk low
// columns, then its kChunk high columns.
template <int NT, int MT>
struct TcSmem {
  static constexpr int kWBytes = MT * kRows * kChunk;
  static constexpr int kXBytes = 8 * NT * 2 * kChunk * 2;
  static constexpr int kStage = kWBytes + kXBytes;
  static constexpr int kRing = kStages * kStage <= kMaxSmem ? kStages : kMaxSmem / kStage;  // x grows with NT
  static constexpr int kBytes = kRing * kStage;
  static_assert(kRing >= 2, "two stages fit in shared memory");
  static_assert(kStage % 128 == 0 && kWBytes % 128 == 0, "every TMA box starts 128-byte aligned");
  static constexpr int kRedFloats = (kSegs - 1) * MT * kRows * 8 * NT;  // the segments' reduction
  static_assert((kRedFloats + MT * kRows * 8 * NT) * 4 <= kBytes, "the reduction and the partials fit in the ring");
};

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// NT n8 tiles of x (B <= 8 NT) over MT groups of 64 rows (a consumer warp
// runs MT m16 tiles through each x fragment it reads). Warp 8 is the
// producer: one lane keeps the ring full with TMA copies (weights and x),
// each stage reused once the 8 consumer warps have released it. The
// consumers never wait for each other inside the K loop.
template <int NT, int MT>
__global__ void __launch_bounds__(kTcThreads) gemv_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                                                               const __grid_constant__ CUtensorMap xmap, Args a) {
  using Smem = TcSmem<NT, MT>;
  constexpr int R = Smem::kRing;
  constexpr int kTile = MT * kRows;  // the block's output rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  __shared__ __align__(8) uint64_t full[R];   // a stage's boxes have landed
  __shared__ __align__(8) uint64_t empty[R];  // the consumer warps are done with a stage
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kTile;
  const Span span = split_span(a, kChunk);
  const int count = span.chunks(kChunk);

  float acc[MT][NT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % kMTiles, seg = warp / kMTiles;
  const int odd = g & 1;

  if (warp == kWarps) {  // the producer
    if (lane == 0)
      for (int i = 0; i < count; ++i) {
        const int st = i % R;
        if (i >= R) bar_wait(&empty[st], (i / R - 1) & 1);
        unsigned char* dst = smem + st * Smem::kStage;
        const int col0 = span.k0 + i * kChunk;
        bar_expect(&full[st], Smem::kStage);
        tma_load_2d(dst, &wmap, &full[st], col0, n0);
        tma_load_3d(dst + Smem::kWBytes, &xmap, &full[st], col0, 0, 0);
      }
  } else {
    for (int i = 0; i < count; ++i) {
      const int st = i % R;
      bar_wait(&full[st], (i / R) & 1);
      const unsigned char* w = smem + st * Smem::kStage;
      // the A fragments of the segment's 4 K steps for each of the warp's m16 tiles
      uint32_t lo[MT][4][4], hi[MT][4][4];
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const int row = (u * kMTiles + mt) * 16 + g;
        const uint4 wa = *reinterpret_cast<const uint4*>(w + row * kChunk + 16 * (4 * seg + t));
        const uint4 wb = *reinterpret_cast<const uint4*>(w + (row + 8) * kChunk + 16 * (4 * seg + t));
        dequant(wa.x, wb.x, lo[u][0], hi[u][0]);
        dequant(wa.y, wb.y, lo[u][1], hi[u][1]);
        dequant(wa.z, wb.z, lo[u][2], hi[u][2]);
        dequant(wa.w, wb.w, lo[u][3], hi[u][3]);
      }
      // x row 8j + g, the lane's 16 columns [16t, 16t + 16) of the segment as
      // two 16-byte chunks: an odd row reads its second chunk first, so that
      // a quarter-warp's rows g, g + 1 (1 KiB apart) hit distinct banks
      const unsigned char* xs = w + Smem::kWBytes + 128 * seg + 32 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* xr = xs + (8 * j + g) * (4 * kChunk);
        const uint4 l_a = *reinterpret_cast<const uint4*>(xr + 16 * odd);
        const uint4 l_b = *reinterpret_cast<const uint4*>(xr + 16 * (1 - odd));
        const uint4 h_a = *reinterpret_cast<const uint4*>(xr + 2 * kChunk + 16 * odd);
        const uint4 h_b = *reinterpret_cast<const uint4*>(xr + 2 * kChunk + 16 * (1 - odd));
        const uint4 xl0 = odd ? l_b : l_a, xl1 = odd ? l_a : l_b;  // steps 0, 1 | steps 2, 3
        const uint4 xh0 = odd ? h_b : h_a, xh1 = odd ? h_a : h_b;
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          mma(acc[u][j], lo[u][0], xl0.x, xl0.y);
          mma(acc[u][j], hi[u][0], xh0.x, xh0.y);
          mma(acc[u][j], lo[u][1], xl0.z, xl0.w);
          mma(acc[u][j], hi[u][1], xh0.z, xh0.w);
          mma(acc[u][j], lo[u][2], xl1.x, xl1.y);
          mma(acc[u][j], hi[u][2], xh1.x, xh1.y);
          mma(acc[u][j], lo[u][3], xl1.z, xl1.w);
          mma(acc[u][j], hi[u][3], xh1.z, xh1.w);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }
  }

  __syncthreads();  // every stage is consumed: the ring becomes the reduction buffers
  float* red = reinterpret_cast<float*>(smem);  // [kSegs - 1][kMTiles][MT][NT][4][32]
  float* mine = red + Smem::kRedFloats;         // this split's partial sums, (B, kTile)
  // the segments' sums, added in segment order by segment 0's warps
  if (warp < kWarps && seg > 0)
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(((((seg - 1) * kMTiles + mt) * MT + u) * NT + j) * 4 + e) * 32 + lane] = acc[u][j][e];
  __syncthreads();
  if (warp < kWarps && seg == 0)
    for (int s = 1; s < kSegs; ++s)
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[u][j][e] += red[(((((s - 1) * kMTiles + mt) * MT + u) * NT + j) * 4 + e) * 32 + lane];
  // c0, c1: row g, batch 2t, 2t+1; c2, c3: row g + 8
  if (warp < kWarps && seg == 0)
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put<__nv_bfloat16>(a, n0, (u * kMTiles + mt) * 16 + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1),
                             acc[u][j][e], mine, kTile);
  if (gridDim.y > 1) merge_splits<__nv_bfloat16>(a, n0, kTile, mine);
}

// ---- f32 x: CUDA cores ----

// The f32 kernel's own tile and plan (quant_kernels.plan for f32 x): 32
// rows, stages of 64 bytes a row; warp p takes bytes [8 p, 8 p + 8) of
// every row of a stage, one row a lane, and the 8 warps' sums are added in
// warp order at the end
constexpr int kFmaRows = 32;
constexpr int kFmaChunk = 64;
constexpr int kFmaParts = kFmaChunk / 8;
constexpr int kFmaWStride = kFmaChunk + 16;
constexpr int kFmaXStride = 2 * kFmaChunk * 4;  // lo | hi f32: every lane of a warp reads one address
constexpr int kFmaStages = 8;  // the stages are small: more of them in flight
static_assert(kFmaRows * kFmaParts == kThreads, "a thread per (row, 8 bytes)");

template <int BB>
struct FmaSmem {
  // above 16 rows of x, warps split them in groups of 16 (more warps, fewer
  // accumulators each): warp w takes part w % 8 and x rows [16 (w / 8), ...)
  static constexpr int kGroups = BB > 16 ? BB / 16 : 1;
  static constexpr int kAcc = BB / kGroups;
  static constexpr int kBlock = kThreads * kGroups;
  static constexpr int kStage = kFmaRows * kFmaWStride + BB * kFmaXStride;
  static constexpr int kRing = kFmaStages * kStage <= kMaxSmem ? kFmaStages : kMaxSmem / kStage;  // x grows with BB
  static constexpr int kBytes = kRing * kStage;
  static_assert(kRing >= 2, "two stages fit in shared memory");
  static constexpr int kRedFloats = (kFmaParts - 1) * BB * kFmaRows;  // parts 1.. of each row
  static_assert((kRedFloats + BB * kFmaRows) * 4 <= kBytes, "the reduction and the partials fit in the ring");
};

// One stage: the tile's weight rows, then x's rows b < BB: 64 low columns,
// 64 high columns. Copies past N, the split's end or B zero-fill.
template <int BB>
__device__ __forceinline__ void issue_stage(unsigned char* st, const Args& a, const float* x, int n0, int col0,
                                            int k1) {
  constexpr int kBlock = FmaSmem<BB>::kBlock;
  constexpr int kPieces = kFmaChunk / 16;  // 16-byte pieces of a row's chunk
  static_assert(kFmaRows * kPieces <= kBlock, "a copy per thread at most");
  if (threadIdx.x < kFmaRows * kPieces) {
    const int r = threadIdx.x / kPieces, c = threadIdx.x % kPieces;
    const int n = n0 + r, j = col0 + 16 * c;
    const bool live = n < a.N && j < k1;
    cp_async16(st + r * kFmaWStride + 16 * c, live ? a.q + (size_t)n * a.Kh + j : a.q, live ? 16 : 0);
  }
  constexpr int kHalf = kFmaChunk / 4;  // 4-value copies per half of a row
  float* xs = reinterpret_cast<float*>(st + kFmaRows * kFmaWStride);
  const int K = 2 * a.Kh;
  for (int p = threadIdx.x; p < BB * 2 * kHalf; p += kBlock) {
    const int b = p / (2 * kHalf), hi = (p / kHalf) & 1, c = p % kHalf;
    const int j = col0 + 4 * c;
    const bool live = b < a.B && j < k1;
    cp_async16(xs + (b * 2 + hi) * kFmaChunk + 4 * c, live ? x + (size_t)b * K + hi * a.Kh + j : x, live ? 16 : 0);
  }
}

__device__ __forceinline__ float nibble(uint32_t u) {  // u in [0, 16) -> u - 8, exact
  return __int_as_float(0x4B000000 | u) - 8388616.f;
}

// BB rows of x per block: B <= BB
template <int BB>
__global__ void __launch_bounds__(FmaSmem<BB>::kBlock) gemv_f32_kernel(Args a) {
  using Smem = FmaSmem<BB>;
  constexpr int R = Smem::kRing;
  constexpr int kAcc = Smem::kAcc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = threadIdx.x % kFmaRows;                 // the thread's row of the tile
  const int part = (threadIdx.x / kFmaRows) % kFmaParts;  // its 8 bytes of each chunk (the warp's)
  const int b0 = threadIdx.x / kThreads * kAcc;         // its rows of x, [b0, b0 + kAcc)
  const int n0 = blockIdx.x * kFmaRows;
  const Span span = split_span(a, kFmaChunk);
  const int count = span.chunks(kFmaChunk);
  const float* x = static_cast<const float*>(a.x);

  auto issue = [&](int i) {
    if (i < count) issue_stage<BB>(smem + (i % R) * Smem::kStage, a, x, n0, span.k0 + i * kFmaChunk, span.k1);
    cp_async_commit();  // one group per chunk, empty past the last, so the waits count alike
  };

  float acc[kAcc];
#pragma unroll
  for (int b = 0; b < kAcc; ++b) acc[b] = 0.f;

#pragma unroll
  for (int i = 0; i < R - 1; ++i) issue(i);
  for (int i = 0; i < count; ++i) {
    cp_async_wait<R - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();         // everyone's have, and chunk i - 1's stage is free
    issue(i + R - 1);
    const unsigned char* st = smem + (i % R) * Smem::kStage;
    const uint2 w = *reinterpret_cast<const uint2*>(st + r * kFmaWStride + 8 * part);
    const uint32_t words[2] = {w.x, w.y};
    const float* xs = reinterpret_cast<const float*>(st + kFmaRows * kFmaWStride) + b0 * 2 * kFmaChunk + 8 * part;
#pragma unroll
    for (int q4 = 0; q4 < 2; ++q4) {
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo[e] = nibble((words[q4] >> (8 * e)) & 0xFu);
        hi[e] = nibble((words[q4] >> (8 * e + 4)) & 0xFu);
      }
#pragma unroll
      for (int b = 0; b < kAcc; ++b) {
        const float4 xl = reinterpret_cast<const float4*>(xs + b * 2 * kFmaChunk)[q4];
        const float4 xh = reinterpret_cast<const float4*>(xs + b * 2 * kFmaChunk + kFmaChunk)[q4];
        acc[b] = fmaf(xl.x, lo[0], acc[b]);
        acc[b] = fmaf(xh.x, hi[0], acc[b]);
        acc[b] = fmaf(xl.y, lo[1], acc[b]);
        acc[b] = fmaf(xh.y, hi[1], acc[b]);
        acc[b] = fmaf(xl.z, lo[2], acc[b]);
        acc[b] = fmaf(xh.z, hi[2], acc[b]);
        acc[b] = fmaf(xl.w, lo[3], acc[b]);
        acc[b] = fmaf(xh.w, hi[3], acc[b]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the reduction buffers
  float* red = reinterpret_cast<float*>(smem);  // [kFmaParts - 1][BB][kFmaRows]
  float* mine = red + Smem::kRedFloats;         // this split's partial sums, (B, kFmaRows)
  if (part > 0)
#pragma unroll
    for (int b = 0; b < kAcc; ++b) red[((part - 1) * BB + b0 + b) * kFmaRows + r] = acc[b];
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < kFmaParts; ++p)
#pragma unroll
      for (int b = 0; b < kAcc; ++b) acc[b] += red[((p - 1) * BB + b0 + b) * kFmaRows + r];
#pragma unroll
    for (int b = 0; b < kAcc; ++b) put<float>(a, n0, r, b0 + b, acc[b], mine, kFmaRows);
  }
  if (gridDim.y > 1) merge_splits<float>(a, n0, kFmaRows, mine);
}

// grid (row tiles of ``tile`` rows, splits); the splits of a tile form a
// cluster, so that they merge through distributed shared memory
template <typename... Params, typename... Values>
cudaError_t launch(void (*kernel)(Params...), const Args& a, int tile, int chunk, int threads, int smem_bytes,
                   cudaStream_t s, Values... values) {
  const int nch = (a.Kh + chunk - 1) / chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + tile - 1) / tile, (nch + a.cps - 1) / a.cps);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = cfg.gridDim.y;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = cfg.gridDim.y > 1 ? 1 : 0;  // one split: no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, values...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// q (N, K/2) bytes as a 2-D tensor read in (kRows x kChunk) boxes; x (B, K)
// bf16 as a 3-D tensor (K/2 columns, 2 halves, B rows) read in (8 NT rows x 2
// halves x kChunk columns) boxes, so a box's columns past K/2 are zeros
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NT, int MT>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  constexpr int bytes = TcSmem<NT, MT>::kBytes + 128;  // room to align the ring to 128 bytes
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemv_bf16_kernel<NT, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[2] = {(cuuint64_t)a.Kh, (cuuint64_t)a.N};
  const cuuint64_t wstrides[1] = {(cuuint64_t)a.Kh};
  const cuuint32_t wbox[2] = {kChunk, MT * kRows};
  const cuuint64_t xdims[3] = {(cuuint64_t)a.Kh, 2, (cuuint64_t)a.B};
  const cuuint64_t xstrides[2] = {(cuuint64_t)a.Kh * 2, (cuuint64_t)a.Kh * 4};
  const cuuint32_t xbox[3] = {kChunk, 2, 8 * NT};
  cudaError_t err = tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.q, 2, wdims, wstrides, wbox);
  if (err == cudaSuccess) err = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, 3, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  return launch(gemv_bf16_kernel<NT, MT>, a, MT * kRows, kChunk, kTcThreads, bytes, s, wmap, xmap, a);
}

template <int BB>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  static_assert(FmaSmem<BB>::kBytes <= kMaxSmem, "the ring fits in shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_f32_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize, FmaSmem<BB>::kBytes);
  if (attr != cudaSuccess) return attr;
  return launch(gemv_f32_kernel<BB>, a, kFmaRows, kFmaChunk, FmaSmem<BB>::kBlock, FmaSmem<BB>::kBytes, s, a);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = f32, 1 = bf16 (x and y).
// cps: chunks of K/2 per split (quant_kernels.plan for x's dtype: kChunk
// bytes for bf16, kFmaChunk for f32), at most kMaxSplits splits (a
// cluster's blocks). Returns the cudaError_t of the launch (0 = success).
extern "C" int int4_gemv(const void* x, const uint8_t* q, const float* scale, void* y, int B, int N, int Kh, int cps,
                         int dtype, void* stream) {
  if (B < 1 || B > 64 || N < 1 || Kh < 16 || Kh % 16 != 0 || cps < 1) return int(cudaErrorInvalidValue);
  const int chunk = dtype == 1 ? kChunk : kFmaChunk;
  if ((Kh + chunk * cps - 1) / (chunk * cps) > kMaxSplits) return int(cudaErrorInvalidValue);
  const Args a{x, q, scale, y, B, N, Kh, cps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (B <= 8) return int(launch_bf16<1, 1>(a, s));
    if (B <= 16) return int(launch_bf16<2, 1>(a, s));
    if (B <= 32) return int(launch_bf16<4, 2>(a, s));
    return int(launch_bf16<8, 2>(a, s));
  }
  if (dtype == 0) {
    if (B == 1) return int(launch_f32<1>(a, s));
    if (B <= 4) return int(launch_f32<4>(a, s));
    if (B <= 8) return int(launch_f32<8>(a, s));
    if (B <= 16) return int(launch_f32<16>(a, s));
    if (B <= 32) return int(launch_f32<32>(a, s));
    return int(launch_f32<64>(a, s));
  }
  return int(cudaErrorInvalidValue);
}
