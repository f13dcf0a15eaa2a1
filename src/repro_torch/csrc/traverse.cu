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
// So 152 * (depth - 1) + 193 + 12 n bytes a request (+8 for a buffered hit):
// 649 B at depth 4 with empty buffers, 841 B with full ones.
//
// Design: one thread per request, as simple as the reference.  Nothing is
// staged in shared memory because no two requests share a line predictably;
// the windows are read as uint2 limb pairs straight from the pools, and the
// insert-buffer keys are read only for live, non-empty entries.  Making the
// descent warp-cooperative (coalesced window reads) is later work.
#include "common.cuh"

using namespace dpa;

__global__ void get_kernel(const int* __restrict__ root,
                           const uint2* __restrict__ node_seg_first,
                           const float* __restrict__ node_seg_slope,
                           const int* __restrict__ node_seg_count,
                           const int* __restrict__ node_seg_slot,
                           const uint2* __restrict__ pivot_keys,
                           const int* __restrict__ pivot_child,
                           const uint2* __restrict__ leaf_anchor,
                           const float* __restrict__ leaf_slope,
                           const int* __restrict__ leaf_count,
                           const int* __restrict__ leaf_slot,
                           const uint2* __restrict__ hbm_keys,
                           const uint2* __restrict__ hbm_vals,
                           const uint2* __restrict__ ib_keys,
                           const uint2* __restrict__ ib_vals,
                           const int* __restrict__ ib_op,
                           const int* __restrict__ ib_count,
                           const uint32_t* __restrict__ khi,
                           const uint32_t* __restrict__ klo,
                           uint32_t* __restrict__ vhi,
                           uint32_t* __restrict__ vlo,
                           bool* __restrict__ found,
                           int B, int depth, int eps_inner, int eps_leaf, int ib_cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t kh = khi[i];
  const uint32_t kl = klo[i];

  // ---- inner descent --------------------------------------------------
  int node = *root;
  const int w_in = 2 * eps_inner + 2;
  for (int level = 0; level < depth - 1; ++level) {
    const size_t nbase = static_cast<size_t>(node) * NODE_SEGS;
    // padded segments hold KEY_MAX and never compare <= a real key;
    // segment 0 is the floor for keys below the node's range
    int seg = 0;
#pragma unroll
    for (int s = 1; s < NODE_SEGS; ++s) {
      const uint2 f = node_seg_first[nbase + s];
      seg += limb_le(f.x, f.y, kh, kl) ? 1 : 0;
    }
    const float pred = predict(node_seg_slope[nbase + seg], node_seg_first[nbase + seg], kh, kl);
    const int count = node_seg_count[nbase + seg];
    const int slot = node_seg_slot[nbase + seg];
    const int lo = window_lo(pred, eps_inner, count, w_in);
    const uint2* row = pivot_keys + static_cast<size_t>(slot) * SEG_CAP;
    int c = 0;
    for (int j = 0; j < w_in; ++j) {
      const int idx = lo + j;
      if (idx < count) {
        const uint2 k = row[idx];
        c += limb_le(k.x, k.y, kh, kl) ? 1 : 0;
      }
    }
    const int rank = max(lo + c - 1, 0);
    node = pivot_child[static_cast<size_t>(slot) * SEG_CAP + rank];
  }
  const int leaf = node;

  // ---- leaf window ----------------------------------------------------
  const int lcount = leaf_count[leaf];
  const int lslot = leaf_slot[leaf];
  const float pred = predict(leaf_slope[leaf], leaf_anchor[leaf], kh, kl);
  const int w_lf = 2 * eps_leaf + 2;
  const int lo = window_lo(pred, eps_leaf, lcount, w_lf);
  const size_t rbase = static_cast<size_t>(lslot) * SEG_CAP;
  int c = 0;
  for (int j = 0; j < w_lf; ++j) {
    const int idx = lo + j;
    if (idx < lcount) {
      const uint2 k = hbm_keys[rbase + idx];
      c += limb_le(k.x, k.y, kh, kl) ? 1 : 0;
    }
  }
  const int rank = lo + c - 1;
  const int safe = max(rank, 0);
  const bool hit_tree = rank >= 0 && limb_eq(hbm_keys[rbase + safe], kh, kl);

  // ---- insert buffer: the newest matching entry wins ------------------
  const size_t bbase = static_cast<size_t>(leaf) * ib_cap;
  const int bcount = ib_count[leaf];
  int newest = -1;
  int newest_op = 0;
  for (int j = 0; j < ib_cap && j < bcount; ++j) {
    const int op = ib_op[bbase + j];
    if (op != 0 && limb_eq(ib_keys[bbase + j], kh, kl)) {
      newest = j;
      newest_op = op;
    }
  }
  const bool is_put = newest >= 0 && newest_op == 1;
  const bool is_del = newest >= 0 && newest_op == 2;
  const bool ok = is_put || (hit_tree && !is_del);
  uint2 v = make_uint2(0u, 0u);
  if (is_put) {
    v = ib_vals[bbase + newest];
  } else if (ok) {
    v = hbm_vals[rbase + safe];
  }
  vhi[i] = v.x;
  vlo[i] = v.y;
  found[i] = ok;
}

extern "C" int dpa_get(const void* root, const void* node_seg_first, const void* node_seg_slope,
                       const void* node_seg_count, const void* node_seg_slot, const void* pivot_keys,
                       const void* pivot_child, const void* leaf_anchor, const void* leaf_slope,
                       const void* leaf_count, const void* leaf_slot, const void* hbm_keys,
                       const void* hbm_vals, const void* ib_keys, const void* ib_vals,
                       const void* ib_op, const void* ib_count, const void* khi, const void* klo,
                       void* vhi, void* vlo, void* found, int B, int depth, int eps_inner,
                       int eps_leaf, int ib_cap, void* stream) {
  if (B > 0) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    get_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(root), static_cast<const uint2*>(node_seg_first),
        static_cast<const float*>(node_seg_slope), static_cast<const int*>(node_seg_count),
        static_cast<const int*>(node_seg_slot), static_cast<const uint2*>(pivot_keys),
        static_cast<const int*>(pivot_child), static_cast<const uint2*>(leaf_anchor),
        static_cast<const float*>(leaf_slope), static_cast<const int*>(leaf_count),
        static_cast<const int*>(leaf_slot), static_cast<const uint2*>(hbm_keys),
        static_cast<const uint2*>(hbm_vals), static_cast<const uint2*>(ib_keys),
        static_cast<const uint2*>(ib_vals), static_cast<const int*>(ib_op),
        static_cast<const int*>(ib_count), static_cast<const uint32_t*>(khi),
        static_cast<const uint32_t*>(klo), static_cast<uint32_t*>(vhi),
        static_cast<uint32_t*>(vlo), static_cast<bool*>(found), B, depth, eps_inner, eps_leaf,
        ib_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
