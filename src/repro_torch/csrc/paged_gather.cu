// Paged KV gather: copy the whole (bs, H, hd) blocks pool[slot], listed by
// slot, into a contiguous (n, bs, H, hd) buffer, for one pool or for a pair
// of pools (K and V) that share the slot list, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_gather.py (_gather_kernel,
// called by gather_pallas).  Semantics are those of the plain versions,
// repro_torch/kernels/paged_gather.py:gather_plain / gather_kv_plain, which
// spell out the reference's index rule: a negative slot is first raised by N
// (in 64-bit arithmetic), then the result is clamped to [0, N-1].  Each
// output is a fresh buffer, never a view of a pool, because later appends
// write the pools in place.
//
// Bound on the H100: device-memory traffic.  Bytes needed: the n slots
// (4 B each), each listed block of each pool read once and its copy written
// once (2 * pools * n * block_bytes).  No arithmetic worth counting.
//
// Design.  The work is cut into items, (pool, listed slot, chunk of at most
// 16 KiB of the block), so that a short slot list still spreads over the
// SMs: the attend's 59 slots of 32 KiB blocks are 236 items for K and V,
// where one CTA per slot and pool used 59 of the 132 SMs and two launches.
// The host wrapper derives the items, the path and the grid from
// block_bytes, n and the SM count (kernels/paged_gather.py:launch_plan).
// Item i belongs to CTA i % gridDim.x.
//
//   * Bulk path, when every address and the block size are 16-byte aligned
//     and the whole list is in flight at once (each CTA of a grid that the
//     SMs hold streams at most STAGES items): one thread per CTA moves the
//     bytes with Hopper's bulk asynchronous copies, no registers spent on
//     them.  A ring of STAGES chunk buffers in shared memory: cp.async.bulk
//     global -> shared completes on the stage's mbarrier, then
//     cp.async.bulk shared -> global is committed as one bulk group; a stage
//     is refilled once cp.async.bulk.wait_group.read says the store out of it
//     has read it.  STAGES - 1 loads stay in flight behind each store.
//   * Word path, for longer lists (one CTA per item, scheduled by the
//     hardware: at 16384 slots 0.372 ms against 0.381 through a persistent
//     bulk grid on an NVIDIA H100 80GB HBM3 at 700 W, chip_designs.py) and
//     for any other alignment (e.g. a 210-byte bf16 block): 256 threads
//     copy an item with the widest word (16, 8, 4, 2 or 1 bytes) that
//     divides the block size and every base address, four loads in flight
//     each; a 16 KiB item is one batch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STAGES = 4;      // chunk buffers per CTA on the bulk path
constexpr int THREADS = 256;   // the widest CTA (the bulk path's is one warp)

struct Gather {
  const unsigned char* pool[2];
  unsigned char* out[2];
  const int* slots;
  long long n_pool;
  long long block_bytes;
  long long chunk;      // bytes per item (a multiple of 16)
  int chunks;           // items per block: ceil(block_bytes / chunk)
  int n;                // listed slots
  int n_items;          // pools * n * chunks
  int width;            // the word path's word in bytes: 16, 8, 4, 2 or 1
};

// Item i = ((pool * n) + listed slot) * chunks + chunk.
struct Item {
  int p, j;
  long long off;  // the chunk's byte offset in the block
  int bytes;
};

__device__ __forceinline__ Item item_at(const Gather& g, int i) {
  const int c = i % g.chunks;
  const long long off = static_cast<long long>(c) * g.chunk;
  const long long left = g.block_bytes - off;
  return {i / (g.chunks * g.n), (i / g.chunks) % g.n, off,
          static_cast<int>(left < g.chunk ? left : g.chunk)};
}

__device__ __forceinline__ const unsigned char* item_src(const Gather& g, const Item& it) {
  long long s = g.slots[it.j];
  if (s < 0) s += g.n_pool;
  s = s < 0 ? 0 : (s >= g.n_pool ? g.n_pool - 1 : s);
  return g.pool[it.p] + s * g.block_bytes + it.off;
}

__device__ __forceinline__ unsigned char* item_dst(const Gather& g, const Item& it) {
  return g.out[it.p] + static_cast<long long>(it.j) * g.block_bytes + it.off;
}

// ---- bulk path --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ void bulk_items(const Gather& g, unsigned char* ring, uint64_t* bars) {
  const int grid = static_cast<int>(gridDim.x);
  const int first = static_cast<int>(blockIdx.x);
  const int mine = (g.n_items - first + grid - 1) / grid;  // the items of this CTA
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t bar0 = smem_addr(bars);
  auto stage = [&](int k) { return ring0 + static_cast<uint32_t>((k % STAGES) * g.chunk); };
  auto bar = [&](int k) { return bar0 + static_cast<uint32_t>((k % STAGES) * 8); };
  auto load = [&](int k) {
    const Item it = item_at(g, first + k * grid);
    bulk_load(stage(k), item_src(g, it), it.bytes, bar(k));
  };
  for (int s = 0; s < STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int k = 0; k < STAGES && k < mine; ++k) load(k);
  for (int k = 0; k < mine; ++k) {
    wait_phase(bar(k), (k / STAGES) & 1);
    const Item it = item_at(g, first + k * grid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(item_dst(g, it), stage(k), it.bytes);
    // refill the previous item's stage once its store has read it; the
    // store just issued stays in flight
    if (k >= 1 && k - 1 + STAGES < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(k - 1 + STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- word path --------------------------------------------------------

template <typename W>
__device__ __forceinline__ void copy_words(const W* __restrict__ src, W* __restrict__ dst,
                                           int n_words) {
  constexpr int U = 4;
  const int step = blockDim.x;
  int j = threadIdx.x;
  for (; j + (U - 1) * step < n_words; j += U * step) {
    W r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = src[j + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u) dst[j + u * step] = r[u];
  }
  for (; j < n_words; j += step) dst[j] = src[j];
}

__device__ void word_items(const Gather& g) {
  for (int i = blockIdx.x; i < g.n_items; i += gridDim.x) {
    const Item it = item_at(g, i);
    const unsigned char* src = item_src(g, it);
    unsigned char* dst = item_dst(g, it);
    const int n_words = it.bytes / g.width;
    switch (g.width) {
      case 16:
        copy_words(reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), n_words);
        break;
      case 8:
        copy_words(reinterpret_cast<const uint2*>(src), reinterpret_cast<uint2*>(dst), n_words);
        break;
      case 4:
        copy_words(reinterpret_cast<const uint32_t*>(src), reinterpret_cast<uint32_t*>(dst), n_words);
        break;
      case 2:
        copy_words(reinterpret_cast<const uint16_t*>(src), reinterpret_cast<uint16_t*>(dst), n_words);
        break;
      default:
        copy_words(src, dst, n_words);
    }
  }
}

// One kernel, its two paths instantiated apart so that each gets its own
// registers: the word path at most 32 (8 CTAs of 256 threads fill an SM).
template <bool BULK>
__global__ void __launch_bounds__(THREADS, BULK ? 1 : 8)
    paged_gather_kernel(const __grid_constant__ Gather g) {
  if constexpr (BULK) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t bars[STAGES];
    if (threadIdx.x == 0) bulk_items(g, ring, bars);
  } else {
    word_items(g);
  }
}

}  // namespace

// pools / outs: 1 or 2 byte pointers of the same block shape.  chunk, grid,
// threads, smem and bulk (the host checked 16-byte alignment) come from the
// host's launch plan; width is the word path's word.
extern "C" int dpa_paged_gather(const void* pool0, const void* pool1, const void* slots, void* out0,
                                void* out1, int n_pools, int n_pool, int block_bytes, int n,
                                int chunk, int grid, int threads, int smem, int bulk, int width,
                                void* stream) {
  if (n > 0) {
    Gather g;
    g.pool[0] = static_cast<const unsigned char*>(pool0);
    g.pool[1] = static_cast<const unsigned char*>(n_pools == 2 ? pool1 : pool0);
    g.out[0] = static_cast<unsigned char*>(out0);
    g.out[1] = static_cast<unsigned char*>(n_pools == 2 ? out1 : out0);
    g.slots = static_cast<const int*>(slots);
    g.n_pool = n_pool;
    g.block_bytes = block_bytes;
    g.chunk = chunk;
    g.chunks = (block_bytes + chunk - 1) / chunk;
    g.n = n;
    g.n_items = n_pools * n * g.chunks;
    g.width = width;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bulk) {
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            paged_gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      paged_gather_kernel<true><<<grid, threads, smem, s>>>(g);
    } else {
      paged_gather_kernel<false><<<grid, threads, 0, s>>>(g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
