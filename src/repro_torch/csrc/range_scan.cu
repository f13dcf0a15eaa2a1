// RANGE leaf-chain walk: per lane, the stitched entries >= k_min of up to
// max_leaves leaves along leaf_next, compacted in key order.
//
// Replaces the TPU kernel src/repro/kernels/range_scan.py (_range_kernel,
// called by range_pallas).  Semantics are those of the plain version,
// repro_torch/kernels/range_scan.py:walk_plain: for each lane, walk exactly
// max_leaves steps from its start leaf (-1 = dead lane), append the leaf
// entries >= k_min in order up to L columns (zero-filled past the count),
// and emit the count, the visited leaf ids (-1 once the chain ended) and the
// first unwalked leaf (-1 = chain exhausted) — the continuation cursor.  The
// insert-buffer merge is the plain-torch epilogue in kernels/ops.py.
//
// Bound on the H100: device-memory traffic.  Bytes needed per lane: start
// and k_min (12 B); per walked leaf its next, count and slot (12 B) and its
// count live keys and values (16 B each); out the four (L,) u32 columns,
// count, visited and next (16 L + 8 + 4 max_leaves B).
//
// Design: one warp per lane.  Each step reads the leaf's 128-entry key row as
// four coalesced 256-byte warp loads (one uint2 per thread), tests key >=
// k_min, and compacts the survivors with __ballot_sync / __popc prefix
// counts; a survivor's value is read only when it lands inside L.  The walk
// always takes max_leaves steps, as the TPU kernel does, so that visited and
// next match it; dead steps read nothing.
#include "common.cuh"

using namespace dpa;

__global__ void range_kernel(const int* __restrict__ leaf_next,
                             const int* __restrict__ leaf_count,
                             const int* __restrict__ leaf_slot,
                             const uint2* __restrict__ hbm_keys,
                             const uint2* __restrict__ hbm_vals,
                             const int* __restrict__ start,
                             const uint32_t* __restrict__ khi,
                             const uint32_t* __restrict__ klo,
                             uint32_t* __restrict__ out_kh,
                             uint32_t* __restrict__ out_kl,
                             uint32_t* __restrict__ out_vh,
                             uint32_t* __restrict__ out_vl,
                             int* __restrict__ out_n,
                             int* __restrict__ visited,
                             int* __restrict__ next_leaf,
                             int B, int L, int max_leaves) {
  const int lane_id = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (lane_id >= B) return;  // uniform across the warp
  const uint32_t kh = khi[lane_id];
  const uint32_t kl = klo[lane_id];
  const size_t obase = static_cast<size_t>(lane_id) * L;
  const unsigned below_me = (1u << t) - 1u;
  int leaf = start[lane_id];
  int cnt = 0;
  for (int step = 0; step < max_leaves; ++step) {
    const bool alive = leaf >= 0;
    if (t == 0) visited[static_cast<size_t>(lane_id) * max_leaves + step] = alive ? leaf : -1;
    if (!alive) continue;  // leaf stays -1: the chain ended
    const int lcount = leaf_count[leaf];
    const size_t rbase = static_cast<size_t>(leaf_slot[leaf]) * SEG_CAP;
#pragma unroll
    for (int chunk = 0; chunk < SEG_CAP / 32; ++chunk) {
      const int pos = chunk * 32 + t;
      bool m = false;
      uint2 k = make_uint2(0u, 0u);
      if (pos < lcount) {
        k = hbm_keys[rbase + pos];
        m = limb_le(kh, kl, k.x, k.y);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, m);
      const int tgt = cnt + __popc(ballot & below_me);
      if (m && tgt < L) {
        const uint2 v = hbm_vals[rbase + pos];
        out_kh[obase + tgt] = k.x;
        out_kl[obase + tgt] = k.y;
        out_vh[obase + tgt] = v.x;
        out_vl[obase + tgt] = v.y;
      }
      cnt += __popc(ballot);
    }
    cnt = min(cnt, L);
    leaf = leaf_next[leaf];
  }
  for (int j = cnt + t; j < L; j += 32) {
    out_kh[obase + j] = 0u;
    out_kl[obase + j] = 0u;
    out_vh[obase + j] = 0u;
    out_vl[obase + j] = 0u;
  }
  if (t == 0) {
    out_n[lane_id] = cnt;
    next_leaf[lane_id] = leaf;
  }
}

extern "C" int dpa_range_walk(const void* leaf_next, const void* leaf_count,
                              const void* leaf_slot, const void* hbm_keys, const void* hbm_vals,
                              const void* start, const void* khi, const void* klo, void* out_kh,
                              void* out_kl, void* out_vh, void* out_vl, void* out_n,
                              void* visited, void* next_leaf, int B, int L, int max_leaves,
                              void* stream) {
  if (B > 0) {
    const int threads = 256;  // 8 lanes (warps) per block
    const long long total = static_cast<long long>(B) * 32;
    const int blocks = static_cast<int>((total + threads - 1) / threads);
    range_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(leaf_next), static_cast<const int*>(leaf_count),
        static_cast<const int*>(leaf_slot), static_cast<const uint2*>(hbm_keys),
        static_cast<const uint2*>(hbm_vals), static_cast<const int*>(start),
        static_cast<const uint32_t*>(khi), static_cast<const uint32_t*>(klo),
        static_cast<uint32_t*>(out_kh), static_cast<uint32_t*>(out_kl),
        static_cast<uint32_t*>(out_vh), static_cast<uint32_t*>(out_vl),
        static_cast<int*>(out_n), static_cast<int*>(visited), static_cast<int*>(next_leaf), B,
        L, max_leaves);
  }
  return static_cast<int>(cudaGetLastError());
}
