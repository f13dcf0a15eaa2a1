// Scan-wave pack: a RANGE wave's results laid out on the device as the host
// hands them to the client, so that the drain is one copy.
//
// Replaces no TPU kernel.  The reference leaves the wave's limbs to its host
// epilogue (src/repro/core/store.py range_finalize: join_u64 and np.where
// over (n, limit) rows); the port ran the same numpy there, at 4-5 us a scan,
// most of a YCSB-E wave.  This kernel computes what that epilogue computed,
// bit for bit (the plain version is repro_torch/kernels/range_pack.py:
// pack_plain), into one buffer at the offsets of range_pack.layout:
//   keys, vals  u64 (n, L): hi << 32 | lo where valid, 0 elsewhere
//   counts      int64 (n):  the row's valid slots
//   cursor_key  u64 (n):    the cursor's limbs where count > 0, else the
//                           start key's
//   cursor_leaf int32 (n)
//   truncated   bool (n):   trunc && count < L
//
// Bound on the H100: device-memory traffic.  Bytes per slot: 16 in (the key
// and value limb pairs), 1 for the mask (read again, from the L2, by the row
// count), 16 out; per row 21 in and 21 out.  A YCSB-E wave (62,259 x 100) is
// ~206 MB, ~0.062 ms at 3.35 TB/s.
//
// Design: two parts in one grid.  The slot part gives each thread a pair of
// neighbouring slots: one 16-byte load of the key limbs (hi0, lo0, hi1, lo1)
// and one of the value limbs, each stored back as one 16-byte word with the
// limbs swapped (lo0, hi0, lo1, hi1), which is the little-endian u64 pair,
// or zero where the mask is off; neighbouring threads touch neighbouring
// 16-byte words.  An odd slot count leaves one thread a single slot.  The
// row part gives each row one warp: it counts the row's mask bytes
// (lane-strided, then __reduce_add_sync) and lane 0 writes the row's five
// fields.  The wrapper guarantees 16-byte aligned limb and output bases.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint4 swap_or_zero(uint4 a, bool m0, bool m1) {
  return make_uint4(m0 ? a.y : 0u, m0 ? a.x : 0u, m1 ? a.w : 0u, m1 ? a.z : 0u);
}

__global__ void range_pack_kernel(const uint4* __restrict__ rk,
                                  const uint4* __restrict__ rv,
                                  const uint8_t* __restrict__ valid,
                                  const uint8_t* __restrict__ trunc,
                                  const int* __restrict__ cur_leaf,
                                  const uint32_t* __restrict__ cur_khi,
                                  const uint32_t* __restrict__ cur_klo,
                                  const uint32_t* __restrict__ khi,
                                  const uint32_t* __restrict__ klo,
                                  uint4* __restrict__ out_keys,
                                  uint4* __restrict__ out_vals,
                                  long long* __restrict__ out_counts,
                                  unsigned long long* __restrict__ out_ckey,
                                  int* __restrict__ out_leaf,
                                  uint8_t* __restrict__ out_trunc,
                                  int n, int L, int slot_blocks) {
  if (static_cast<int>(blockIdx.x) < slot_blocks) {
    const long long total = static_cast<long long>(n) * L;
    const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long s = 2 * p;
    if (s + 1 < total) {
      const bool m0 = valid[s] != 0, m1 = valid[s + 1] != 0;
      out_keys[p] = swap_or_zero(rk[p], m0, m1);
      out_vals[p] = swap_or_zero(rv[p], m0, m1);
    } else if (s < total) {  // the odd slot at the end
      const bool m = valid[s] != 0;
      const uint2 k = reinterpret_cast<const uint2*>(rk)[s];
      const uint2 v = reinterpret_cast<const uint2*>(rv)[s];
      reinterpret_cast<uint2*>(out_keys)[s] = make_uint2(m ? k.y : 0u, m ? k.x : 0u);
      reinterpret_cast<uint2*>(out_vals)[s] = make_uint2(m ? v.y : 0u, m ? v.x : 0u);
    }
    return;
  }
  const long long tid =
      static_cast<long long>(blockIdx.x - slot_blocks) * blockDim.x + threadIdx.x;
  const long long row = tid >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const uint8_t* m = valid + row * L;
  unsigned c = 0;
  for (int j = lane; j < L; j += 32) c += m[j] != 0;
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) {
    const bool emitted = c > 0;
    const uint32_t hi = emitted ? cur_khi[row] : khi[row];
    const uint32_t lo = emitted ? cur_klo[row] : klo[row];
    out_counts[row] = static_cast<long long>(c);
    out_ckey[row] = (static_cast<unsigned long long>(hi) << 32) | lo;
    out_leaf[row] = cur_leaf[row];
    out_trunc[row] = (trunc[row] != 0 && static_cast<int>(c) < L) ? 1 : 0;
  }
}

}  // namespace

extern "C" int dpa_range_pack(const void* rk, const void* rv, const void* valid,
                              const void* trunc, const void* cur_leaf, const void* cur_khi,
                              const void* cur_klo, const void* khi, const void* klo,
                              void* out_keys, void* out_vals, void* out_counts, void* out_ckey,
                              void* out_leaf, void* out_trunc, int n, int L, void* stream) {
  if (n > 0 && L > 0) {
    const int threads = 256;
    const long long pairs = (static_cast<long long>(n) * L + 1) / 2;
    const int slot_blocks = static_cast<int>((pairs + threads - 1) / threads);
    const int row_blocks = static_cast<int>((static_cast<long long>(n) * 32 + threads - 1) / threads);
    range_pack_kernel<<<slot_blocks + row_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(rk), static_cast<const uint4*>(rv),
        static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(trunc),
        static_cast<const int*>(cur_leaf), static_cast<const uint32_t*>(cur_khi),
        static_cast<const uint32_t*>(cur_klo), static_cast<const uint32_t*>(khi),
        static_cast<const uint32_t*>(klo), static_cast<uint4*>(out_keys),
        static_cast<uint4*>(out_vals), static_cast<long long*>(out_counts),
        static_cast<unsigned long long*>(out_ckey), static_cast<int*>(out_leaf),
        static_cast<uint8_t*>(out_trunc), n, L, slot_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
