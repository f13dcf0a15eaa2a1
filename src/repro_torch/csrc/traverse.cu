// Batched GET: learned-index descent, leaf probe and insert-buffer merge.
//
// Replaces the TPU kernel src/repro/kernels/traverse.py (_get_kernel, called
// by get_pallas).  Semantics are those of the plain version,
// repro_torch/kernels/traverse.py:get_plain: found rows carry the value of the
// newest insert-buffer PUT or of the leaf entry; not-found rows carry 0.
//
// Bound on the H100: device-memory traffic.  A request is a chain of
// dependent gathers and does a few dozen integer compares per gathered line,
// far below the compute roof.  The bytes it needs, each read once, at the
// main path's shapes (eps_inner 4, eps_leaf 8, ib_cap 16):
//   per inner level: 7 segment first keys (56 B), the chosen segment's slope,
//     count and slot (12 B), the 2*eps_inner+2 = 10 pivot keys (80 B) and one
//     child id (4 B): 152 B;
//   leaf: anchor, slope, count, slot (20 B) and the 2*eps_leaf+2 = 18 keys of
//     the window (144 B; the matched key lies inside it) plus the value (8 B);
//   insert buffer: count (4 B) and, for each of its n live entries, the op
//     and the key (12 B), one value when the newest match is a PUT (8 B);
//   request key in (8 B), value and flag out (9 B), the root id (4 B once).
// So 152 * (depth - 1) + 193 + 12 n bytes a request (+8 for a buffered hit).
//
// What the card fetches is 32-byte sectors, not those bytes.  At the 50M-key
// store's depth 3 a request reads the root (shared by every request), one of
// 470 inner nodes (5 MB in all, L2-resident) and, at the leaf, one sector in
// each of the 4 metadata pools and the buffer counts, 5-6 sectors of keys
// and the value: ~12 sectors from device memory, whatever the thread layout.
// PERF.md has the sector counts of each layout and the measurements
// that show those leaf sectors, not the load count, set a large wave's time.
//
// Design.  Two ways to serve a request, chosen by the host (the launch plan
// in kernels/traverse.py, from the wave size and the card's occupancy):
//   * one thread per request, for waves larger than the card holds at a warp
//     a request (the store's 65536-request waves): a plain loop, few
//     registers, every request of the wave resident at once;
//   * one warp per request, for smaller waves (the page table's 1-request
//     waves), which wait on the chain of dependent loads, so each step's
//     loads are issued together by neighbouring lanes:
//       - inner level: lanes 0..6 read the 7 segments' first key, slope,
//         count and slot in one step; the segment is __popc of a ballot of
//         first <= key; then the window's keys and the children around it
//         are read in one coalesced step, the rank is __popc of a ballot and
//         the child is shuffled from the lane that read it: two dependent
//         steps per level (four in the thread loop);
//       - leaf: the metadata and the buffer's count, then the window's keys
//         and the live buffer entries together, then the one value; the
//         newest buffer match is the highest set bit of a ballot.
//     Windows of more than 32 keys take up to MAXP passes of the warp.
#include "common.cuh"

using namespace dpa;

namespace {

constexpr int MAXP = 4;        // passes of the warp over a window: w + 1 <= 128
constexpr int THREADS = 256;   // the widest CTA the host plans
constexpr unsigned ALL = 0xFFFFFFFFu;

struct Get {
  const int* root;
  const uint2* node_seg_first;
  const float* node_seg_slope;
  const int* node_seg_count;
  const int* node_seg_slot;
  const uint2* pivot_keys;
  const int* pivot_child;
  const uint2* leaf_anchor;
  const float* leaf_slope;
  const int* leaf_count;
  const int* leaf_slot;
  const uint2* hbm_keys;
  const uint2* hbm_vals;
  const uint2* ib_keys;
  const uint2* ib_vals;
  const int* ib_op;
  const int* ib_count;
  const uint32_t* khi;
  const uint32_t* klo;
  uint32_t* vhi;
  uint32_t* vlo;
  bool* found;
  int B, depth, eps_inner, eps_leaf, ib_cap;
};

// The outputs of request i from its leaf probe and its buffer's newest match.
__device__ __forceinline__ void finish(const Get& a, int i, int leaf, size_t rbase, int rank,
                                       bool hit_tree, int newest, int newest_op) {
  const bool is_put = newest >= 0 && newest_op == 1;
  const bool is_del = newest >= 0 && newest_op == 2;
  const bool ok = is_put || (hit_tree && !is_del);
  uint2 v = make_uint2(0u, 0u);
  if (is_put) {
    v = a.ib_vals[static_cast<size_t>(leaf) * a.ib_cap + newest];
  } else if (ok) {
    v = a.hbm_vals[rbase + max(rank, 0)];
  }
  a.vhi[i] = v.x;
  a.vlo[i] = v.y;
  a.found[i] = ok;
}

// ---- one thread per request --------------------------------------------

__device__ __forceinline__ void get_thread(const Get& a, int i) {
  const uint32_t kh = a.khi[i];
  const uint32_t kl = a.klo[i];

  int node = *a.root;
  const int w_in = 2 * a.eps_inner + 2;
  for (int level = 0; level < a.depth - 1; ++level) {
    const size_t nbase = static_cast<size_t>(node) * NODE_SEGS;
    // padded segments hold KEY_MAX and never compare <= a real key;
    // segment 0 is the floor for keys below the node's range
    int seg = 0;
#pragma unroll
    for (int s = 1; s < NODE_SEGS; ++s) {
      const uint2 f = a.node_seg_first[nbase + s];
      seg += limb_le(f.x, f.y, kh, kl) ? 1 : 0;
    }
    const float pred =
        predict(a.node_seg_slope[nbase + seg], a.node_seg_first[nbase + seg], kh, kl);
    const int count = a.node_seg_count[nbase + seg];
    const int slot = a.node_seg_slot[nbase + seg];
    const int lo = window_lo(pred, a.eps_inner, count, w_in);
    const uint2* row = a.pivot_keys + static_cast<size_t>(slot) * SEG_CAP;
    int c = 0;
    for (int j = 0; j < w_in; ++j) {
      const int idx = lo + j;
      if (idx < count) {
        const uint2 k = row[idx];
        c += limb_le(k.x, k.y, kh, kl) ? 1 : 0;
      }
    }
    node = a.pivot_child[static_cast<size_t>(slot) * SEG_CAP + max(lo + c - 1, 0)];
  }
  const int leaf = node;

  const int lcount = a.leaf_count[leaf];
  const int lslot = a.leaf_slot[leaf];
  const float pred = predict(a.leaf_slope[leaf], a.leaf_anchor[leaf], kh, kl);
  const int w_lf = 2 * a.eps_leaf + 2;
  const int lo = window_lo(pred, a.eps_leaf, lcount, w_lf);
  const size_t rbase = static_cast<size_t>(lslot) * SEG_CAP;
  int c = 0;
  for (int j = 0; j < w_lf; ++j) {
    const int idx = lo + j;
    if (idx < lcount) {
      const uint2 k = a.hbm_keys[rbase + idx];
      c += limb_le(k.x, k.y, kh, kl) ? 1 : 0;
    }
  }
  const int rank = lo + c - 1;
  const bool hit_tree = rank >= 0 && limb_eq(a.hbm_keys[rbase + rank], kh, kl);

  // insert buffer: the newest matching entry wins
  const size_t bbase = static_cast<size_t>(leaf) * a.ib_cap;
  const int bcount = min(a.ib_count[leaf], a.ib_cap);
  int newest = -1;
  int newest_op = 0;
  for (int j = 0; j < bcount; ++j) {
    const int op = a.ib_op[bbase + j];
    if (op != 0 && limb_eq(a.ib_keys[bbase + j], kh, kl)) {
      newest = j;
      newest_op = op;
    }
  }
  finish(a, i, leaf, rbase, rank, hit_tree, newest, newest_op);
}

// ---- one warp per request ----------------------------------------------

// a[p] for a p that is the same on every lane (a select chain, no local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[MAXP], int p) {
  T v = a[0];
#pragma unroll
  for (int q = 1; q < MAXP; ++q)
    if (p == q) v = a[q];
  return v;
}

__device__ __forceinline__ int route_warp(const Get& a, int lane, int node, uint32_t kh,
                                          uint32_t kl) {
  // step 1: lane s < 7 reads segment s
  uint2 f = make_uint2(0u, 0u);
  float slope = 0.0f;
  int count = 0, slot = 0;
  if (lane < NODE_SEGS) {
    const size_t s = static_cast<size_t>(node) * NODE_SEGS + lane;
    f = a.node_seg_first[s];
    slope = a.node_seg_slope[s];
    count = a.node_seg_count[s];
    slot = a.node_seg_slot[s];
  }
  const int seg =
      __popc(__ballot_sync(ALL, lane >= 1 && lane < NODE_SEGS && limb_le(f.x, f.y, kh, kl)));
  const uint2 anchor = make_uint2(__shfl_sync(ALL, f.x, seg), __shfl_sync(ALL, f.y, seg));
  slope = __shfl_sync(ALL, slope, seg);
  count = __shfl_sync(ALL, count, seg);
  slot = __shfl_sync(ALL, slot, seg);
  const int w = 2 * a.eps_inner + 2;
  const int lo = window_lo(predict(slope, anchor, kh, kl), a.eps_inner, count, w);
  // step 2: element t = 32 p + lane holds child lo - 1 + t (t = 0..w) and,
  // for t >= 1, window key lo - 1 + t; every load before any compare
  const uint2* keys = a.pivot_keys + static_cast<size_t>(slot) * SEG_CAP;
  const int* child = a.pivot_child + static_cast<size_t>(slot) * SEG_CAP;
  int ch[MAXP];
  uint2 kk[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int t = 32 * p + lane;
    const int idx = lo - 1 + t;
    ch[p] = 0;
    kk[p] = make_uint2(0u, 0u);
    if (t <= w && idx >= 0) {
      ch[p] = child[idx];
      if (t >= 1 && idx < count) kk[p] = keys[idx];
    }
  }
  int c = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int t = 32 * p + lane;
    c += __popc(__ballot_sync(
        ALL, t >= 1 && t <= w && lo - 1 + t < count && limb_le(kk[p].x, kk[p].y, kh, kl)));
  }
  const int ts = max(lo + c - 1, 0) - lo + 1;  // the element that read the child at the rank
  return __shfl_sync(ALL, pick(ch, ts / 32), ts % 32);
}

__device__ __forceinline__ void get_warp(const Get& a, int lane, int i) {
  const uint32_t kh = a.khi[i];
  const uint32_t kl = a.klo[i];
  int node = *a.root;
  for (int level = 0; level < a.depth - 1; ++level) node = route_warp(a, lane, node, kh, kl);
  const int leaf = node;

  // step 1: the leaf's metadata and its insert buffer's count
  const uint2 anchor = a.leaf_anchor[leaf];
  const float lslope = a.leaf_slope[leaf];
  const int lcount = a.leaf_count[leaf];
  const int lslot = a.leaf_slot[leaf];
  const int bcount = min(a.ib_count[leaf], a.ib_cap);

  // step 2: the window's keys (element t = key lo - 1 + t, t = 0..w: the
  // one before the window gives the exact rank when no key of it is <= the
  // request key) and the live buffer entries, every load before any compare
  const int w = 2 * a.eps_leaf + 2;
  const int lo = window_lo(predict(lslope, anchor, kh, kl), a.eps_leaf, lcount, w);
  const size_t rbase = static_cast<size_t>(lslot) * SEG_CAP;
  uint2 kk[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int t = 32 * p + lane;
    const int idx = lo - 1 + t;
    kk[p] = make_uint2(0u, 0u);
    if (t <= w && idx >= 0 && idx < lcount) kk[p] = a.hbm_keys[rbase + idx];
  }
  // the newest matching buffer entry wins: the highest set bit of a ballot,
  // 32 entries a pass (one pass at ib_cap 16 or 32)
  const size_t bbase = static_cast<size_t>(leaf) * a.ib_cap;
  int newest = -1;
  int newest_op = 0;
  for (int base = 0; base < bcount; base += 32) {
    const int j = base + lane;
    int op = 0;
    uint2 bk = make_uint2(0u, 0u);
    if (j < bcount) {
      op = a.ib_op[bbase + j];
      bk = a.ib_keys[bbase + j];
    }
    const unsigned m = __ballot_sync(ALL, op != 0 && bk.x == kh && bk.y == kl);
    if (m) {
      const int src = 31 - __clz(static_cast<int>(m));
      newest = base + src;
      newest_op = __shfl_sync(ALL, op, src);
    }
  }
  int c = 0;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int t = 32 * p + lane;
    c += __popc(__ballot_sync(
        ALL, t >= 1 && t <= w && lo - 1 + t < lcount && limb_le(kk[p].x, kk[p].y, kh, kl)));
  }
  const int rank = lo + c - 1;  // <= lcount - 1, so its key was read
  bool hit_tree = false;
  if (rank >= 0) {
    const int ts = rank - lo + 1;
    const uint2 k = pick(kk, ts / 32);
    hit_tree = __shfl_sync(ALL, k.x, ts % 32) == kh && __shfl_sync(ALL, k.y, ts % 32) == kl;
  }
  if (lane == 0) finish(a, i, leaf, rbase, rank, hit_tree, newest, newest_op);
}

template <bool WARP>
__global__ void __launch_bounds__(THREADS) get_kernel(const __grid_constant__ Get a) {
  if constexpr (WARP) {
    const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    if (i < a.B) get_warp(a, threadIdx.x % 32, i);
  } else {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.B) get_thread(a, i);
  }
}

}  // namespace

// CTAs of `threads` threads that one SM holds at once, for the warp-per-
// request kernel (warp = 1) or the thread-per-request one; a negative value
// is a cudaError_t.
extern "C" int dpa_get_ctas_per_sm(int warp, int threads) {
  int n = 0;
  const cudaError_t e =
      warp ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, get_kernel<true>, threads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, get_kernel<false>, threads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int dpa_get(const void* root, const void* node_seg_first, const void* node_seg_slope,
                       const void* node_seg_count, const void* node_seg_slot, const void* pivot_keys,
                       const void* pivot_child, const void* leaf_anchor, const void* leaf_slope,
                       const void* leaf_count, const void* leaf_slot, const void* hbm_keys,
                       const void* hbm_vals, const void* ib_keys, const void* ib_vals,
                       const void* ib_op, const void* ib_count, const void* khi, const void* klo,
                       void* vhi, void* vlo, void* found, int B, int depth, int eps_inner,
                       int eps_leaf, int ib_cap, int warp, int threads, int grid, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Get a{static_cast<const int*>(root),
              static_cast<const uint2*>(node_seg_first),
              static_cast<const float*>(node_seg_slope),
              static_cast<const int*>(node_seg_count),
              static_cast<const int*>(node_seg_slot),
              static_cast<const uint2*>(pivot_keys),
              static_cast<const int*>(pivot_child),
              static_cast<const uint2*>(leaf_anchor),
              static_cast<const float*>(leaf_slope),
              static_cast<const int*>(leaf_count),
              static_cast<const int*>(leaf_slot),
              static_cast<const uint2*>(hbm_keys),
              static_cast<const uint2*>(hbm_vals),
              static_cast<const uint2*>(ib_keys),
              static_cast<const uint2*>(ib_vals),
              static_cast<const int*>(ib_op),
              static_cast<const int*>(ib_count),
              static_cast<const uint32_t*>(khi),
              static_cast<const uint32_t*>(klo),
              static_cast<uint32_t*>(vhi),
              static_cast<uint32_t*>(vlo),
              static_cast<bool*>(found),
              B,
              depth,
              eps_inner,
              eps_leaf,
              ib_cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp) {
    get_kernel<true><<<grid, threads, 0, s>>>(a);
  } else {
    get_kernel<false><<<grid, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
