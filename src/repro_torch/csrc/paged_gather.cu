// Paged KV gather: copy the whole (bs, H, hd) blocks pool[slot], listed by
// slot, into a contiguous (n, bs, H, hd) buffer.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py (_gather_kernel,
// called by gather_pallas).  Semantics are those of the plain version,
// repro_torch/kernels/paged_gather.py:gather_plain, which spells out the
// reference's index rule: a negative slot is first raised by N (in 64-bit
// arithmetic), then the result is clamped to [0, N-1].  The output is a fresh
// buffer, never a view of the pool, because later appends write the pool in
// place.
//
// Bound on the H100: device-memory traffic.  Bytes needed: the n slots
// (4 B each), each listed block read once and its copy written once
// (2 * n * block_bytes).  No arithmetic worth counting.
//
// Design: the kernel moves bytes, so one kernel serves every pool dtype.  One
// CTA per listed slot resolves the slot once and copies the block with its
// threads striding over the block's words, four loads in flight per thread
// before the four stores.  The word is 16 bytes (uint4) when the block's byte
// count and both base pointers are 16-byte aligned, else the widest of 8, 4,
// 2 and 1 bytes that they allow; the host entry picks it and the kernel
// branches on it once per CTA.  TMA / cp.async.bulk copies are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename W>
__device__ __forceinline__ void copy_words(const W* __restrict__ src, W* __restrict__ dst,
                                           long long n_words) {
  constexpr int U = 4;
  const long long step = blockDim.x;
  long long j = threadIdx.x;
  for (; j + (U - 1) * step < n_words; j += U * step) {
    W r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = src[j + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u) dst[j + u * step] = r[u];
  }
  for (; j < n_words; j += step) dst[j] = src[j];
}

__global__ void paged_gather_kernel(const unsigned char* __restrict__ pool,
                                    const int* __restrict__ slots,
                                    unsigned char* __restrict__ out, long long n_pool,
                                    long long block_bytes, int width) {
  long long s = slots[blockIdx.x];
  if (s < 0) s += n_pool;
  s = s < 0 ? 0 : (s >= n_pool ? n_pool - 1 : s);
  const unsigned char* src = pool + s * block_bytes;
  unsigned char* dst = out + static_cast<long long>(blockIdx.x) * block_bytes;
  const long long n_words = block_bytes / width;
  switch (width) {
    case 16:
      copy_words(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), n_words);
      break;
    case 8:
      copy_words(reinterpret_cast<const uint2*>(src), reinterpret_cast<uint2*>(dst), n_words);
      break;
    case 4:
      copy_words(reinterpret_cast<const uint32_t*>(src), reinterpret_cast<uint32_t*>(dst),
                 n_words);
      break;
    case 2:
      copy_words(reinterpret_cast<const uint16_t*>(src), reinterpret_cast<uint16_t*>(dst),
                 n_words);
      break;
    default:
      copy_words(src, dst, n_words);
  }
}

// Widest word (16, 8, 4, 2 or 1 bytes) that divides the block's byte count
// and both base addresses.
int word_width(const void* pool, const void* out, int block_bytes) {
  int w = 16;
  const uintptr_t a = reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(block_bytes);
  while (w > 1 && (a % w) != 0) w >>= 1;
  return w;
}

}  // namespace

extern "C" int dpa_paged_gather(const void* pool, const void* slots, void* out, int n_pool,
                                int block_bytes, int n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    paged_gather_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(pool), static_cast<const int*>(slots),
        static_cast<unsigned char*>(out), n_pool, block_bytes,
        word_width(pool, out, block_bytes));
  }
  return static_cast<int>(cudaGetLastError());
}
