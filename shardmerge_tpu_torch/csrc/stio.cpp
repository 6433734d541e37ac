// stio.cpp — native host-IO accelerator for shardmerge_tpu_torch (a copy of
// the JAX package's native/stio.cpp).
//
// The host side of the merge pipeline moves multi-GB safetensors shards:
// mmap page-in, buffer copies, and bf16<->f32 conversions are all
// single-threaded in numpy/ml_dtypes. This library parallelizes them:
//
//   - stio_read_blocks:   parallel pread of tensor byte ranges into caller
//                         buffers (readahead for the streaming pipeline)
//   - stio_bf16_to_f32:   parallel widening conversion
//   - stio_f32_to_bf16:   parallel round-to-nearest-even narrowing
//                         (bit-exact with torch's cast on every non-NaN value)
//   - stio_memcpy:        parallel memcpy for large detach-copies
//   - stio_prefault:      fadvise(WILLNEED) + parallel page touch
//
// Exposed as plain C symbols for ctypes (no pybind11 dependency); built at
// first use by shardmerge_tpu_torch/io/native.py with the system C++
// compiler (`c++ -O3 -shared -fPIC -pthread`).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

int clamp_threads(int nthreads, size_t work_items) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  if (nthreads <= 0) nthreads = static_cast<int>(hw);
  if (static_cast<size_t>(nthreads) > work_items) {
    nthreads = static_cast<int>(work_items);
  }
  return nthreads < 1 ? 1 : nthreads;
}

template <typename Fn>
void parallel_for_chunks(size_t n, int nthreads, size_t min_chunk, Fn fn) {
  nthreads = clamp_threads(nthreads, (n + min_chunk - 1) / min_chunk);
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  size_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    size_t begin = static_cast<size_t>(t) * chunk;
    size_t end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

// Widening loop body kept in pure integer form (uint32 shift store) so the
// compiler auto-vectorizes it; a float memcpy per element defeats SLP.

inline uint16_t f32_to_bf16_rne_bits(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  // NaN: keep the sign and the payload's top bits, quieted (torch's own
  // cast gives 0x7fc0 or 0xffff by code path, ml_dtypes 0x7fc0 | sign)
  if ((bits & 0x7fffffffu) > 0x7f800000u) {
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  // round to nearest even on the truncated 16 bits
  uint32_t rounding_bias = 0x7fffu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>((bits + rounding_bias) >> 16);
}

}  // namespace

extern "C" {

// Parallel pread of n byte ranges from fd into caller-provided buffers.
// Returns 0 on success, -1 if any read failed or came up short.
int stio_read_blocks(int fd, const uint64_t* offsets, const uint64_t* sizes,
                     char** dests, int64_t n, int nthreads) {
  std::atomic<int> status{0};
  parallel_for_chunks(static_cast<size_t>(n), nthreads, 1,
                      [&](size_t begin, size_t end) {
    for (size_t i = begin; i < end; ++i) {
      uint64_t remaining = sizes[i];
      uint64_t off = offsets[i];
      char* dst = dests[i];
      while (remaining > 0) {
        ssize_t got = pread(fd, dst, remaining, static_cast<off_t>(off));
        if (got <= 0) {
          status.store(-1);
          return;
        }
        remaining -= static_cast<uint64_t>(got);
        off += static_cast<uint64_t>(got);
        dst += got;
      }
    }
  });
  return status.load();
}

void stio_bf16_to_f32(const uint16_t* src, float* dst, int64_t n,
                      int nthreads) {
  uint32_t* out = reinterpret_cast<uint32_t*>(dst);
  parallel_for_chunks(static_cast<size_t>(n), nthreads, 1 << 20,
                      [&](size_t begin, size_t end) {
    for (size_t i = begin; i < end; ++i) {
      out[i] = static_cast<uint32_t>(src[i]) << 16;
    }
  });
}

void stio_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                      int nthreads) {
  parallel_for_chunks(static_cast<size_t>(n), nthreads, 1 << 20,
                      [&](size_t begin, size_t end) {
    for (size_t i = begin; i < end; ++i) dst[i] = f32_to_bf16_rne_bits(src[i]);
  });
}

void stio_memcpy(char* dst, const char* src, int64_t n, int nthreads) {
  parallel_for_chunks(static_cast<size_t>(n), nthreads, 4 << 20,
                      [&](size_t begin, size_t end) {
    std::memcpy(dst + begin, src + begin, end - begin);
  });
}

// Hint the kernel and fault pages in (for mmap'd shard readahead).
void stio_prefault(int fd, uint64_t offset, uint64_t length,
                   const char* mapped, int nthreads) {
#ifdef POSIX_FADV_WILLNEED
  posix_fadvise(fd, static_cast<off_t>(offset), static_cast<off_t>(length),
                POSIX_FADV_WILLNEED);
#endif
  if (mapped == nullptr) return;
  const size_t page = 4096;
  std::atomic<uint64_t> sink{0};
  parallel_for_chunks(static_cast<size_t>(length), nthreads, 16 << 20,
                      [&](size_t begin, size_t end) {
    uint64_t acc = 0;
    for (size_t i = begin; i < end; i += page) {
      acc += static_cast<unsigned char>(mapped[i]);
    }
    sink.fetch_add(acc);
  });
}

}  // extern "C"
