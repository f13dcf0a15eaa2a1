// Payload-generic cache probe: Bloom test, bucket select, W-way compare.
//
// Replaces the TPU kernel src/repro/kernels/cache_probe.py
// (_generic_probe_kernel, called by generic_probe_pallas and its two
// instantiations probe_pallas (P=2 value words, the GET hot-entry cache) and
// anchor_probe_pallas (P=1 leaf id, the RANGE scan-anchor cache)).  Semantics
// are those of the plain version, repro_torch/kernels/cache_probe.py:
// probe_plain: hit = Bloom-positive AND a valid way holds the exact key; the
// payload is the first matching way's, zeros on a miss.
//
// Bound on the H100: device-memory traffic (a few hashes and compares per
// request).  Bytes needed per request: thread id and key (12 B), three Bloom
// words (12 B), hit flag and payload out (1 + 4P B); a Bloom-positive request
// also reads its bucket's W keys and valid flags (W * 9 B) and, on a hit, one
// payload (4P B).  The caches are small (176 threads x 96 entries: ~290 KB
// for P=2), so after the first touches they sit in the L2, and a wave's time
// is the launch and its loads' latencies, not bytes.
//
// Design.  The first port (LOOP below) read the bucket one way at a time,
// each key only after its valid flag, stopping at the first match: a miss in
// a full bucket waited on 8 dependent loads.  Here the Bloom word indices and
// the bucket both follow from the key's hashes, so every load can be issued
// as soon as the key is in; the compare and the payload select happen in
// registers, with no early-exit way loop.  Two costs pull apart: a small wave
// waits on its chain of dependent L2 round trips, a large one on the number
// of loads its threads issue, each to a scattered line.  So the host's plan
// (kernels/cache_probe.py:probe_plan) picks among these shapes:
//
//   * VECTOR (W = 4, P = 1 or 2, 16-byte aligned caches): a thread per
//     request reads, in one round, its Bloom words, its bucket's keys as two
//     16-byte words, its valid flags as one 4-byte word and its payloads as
//     one or two 16-byte words, whether or not the Bloom test passes.  Three
//     dependent rounds: key, everything, stores.
//   * GATED: the bucket's loads wait for the Bloom test (the paper's
//     "Bloom-gated" load: a Bloom-negative request reads no bucket).
//   * LATE: the keys are read with the Bloom words; the valid flags and the
//     matching way's payload only once a key matches (one 4-byte and one
//     4- or 8-byte load, for the few requests that match).
//   * LEAN: GATED and LATE together: the fewest loads, the longest chain.
//   * GENERIC (any W, P and alignment): a thread per request reads 32-bit
//     words; each round reads up to 8 ways' keys and flags before comparing,
//     then the matching way's P payload words.
//   * LOOP: the first port's kernel, kept as the baseline that
//     chip_designs.py times the others against.

#include "common.cuh"

using namespace dpa;

namespace {

enum Design : int { LOOP = 0, VECTOR = 1, GATED = 2, LATE = 3, LEAN = 4, GENERIC = 5 };
constexpr int THREADS = 256;   // the widest CTA the plan asks for
constexpr int CHUNK = 8;       // ways the generic shape reads per round

struct Probe {
  const uint32_t* bloom;   // (T, n_words)
  const uint32_t* bkey;    // (T, NB, W, 2) limb words
  const uint32_t* bpay;    // (T, NB, W, P) payload words
  const uint8_t* bvalid;   // (T, NB, W) bool
  const int* tid;
  const uint32_t* khi;
  const uint32_t* klo;
  bool* hit;
  uint32_t* pay;           // (B, P)
  int B, n_words, n_buckets, ways, P;
  uint32_t bloom_bits, salt[3], salt_bucket;
};

// The three Bloom words' bit indices of a key (u32 hash, runtime modulus).
__device__ __forceinline__ uint32_t bloom_bit(const Probe& q, uint32_t kh, uint32_t kl, int s) {
  return limb_hash(kh, kl, q.salt[s]) % q.bloom_bits;
}

// Bloom test of thread t's filter: the three words are loaded together.
__device__ __forceinline__ bool bloom_test(const Probe& q, size_t t, uint32_t kh, uint32_t kl) {
  const uint32_t* r = q.bloom + t * q.n_words;
  uint32_t h[3], w[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) h[s] = bloom_bit(q, kh, kl, s);
#pragma unroll
  for (int s = 0; s < 3; ++s) w[s] = __ldg(r + h[s] / 32);
  return ((w[0] >> (h[0] % 32)) & (w[1] >> (h[1] % 32)) & (w[2] >> (h[2] % 32)) & 1u) != 0;
}

// Entry index of way 0 of the key's bucket in thread t's table.
__device__ __forceinline__ size_t bucket_entry(const Probe& q, size_t t, uint32_t kh, uint32_t kl) {
  const uint32_t b = limb_hash(kh, kl, q.salt_bucket) % static_cast<uint32_t>(q.n_buckets);
  return (t * q.n_buckets + b) * q.ways;
}

// ---- LOOP: the first port's kernel ------------------------------------

__device__ void probe_loop(const Probe& q, int i) {
  const uint32_t kh = __ldg(q.khi + i);
  const uint32_t kl = __ldg(q.klo + i);
  const size_t t = static_cast<size_t>(__ldg(q.tid + i));
  const uint2* bkey = reinterpret_cast<const uint2*>(q.bkey);
  int way = -1;
  size_t base = 0;
  if (bloom_test(q, t, kh, kl)) {
    base = bucket_entry(q, t, kh, kl);
    for (int w = 0; w < q.ways; ++w) {
      if (__ldg(q.bvalid + base + w) && limb_eq(__ldg(bkey + base + w), kh, kl)) {
        way = w;
        break;
      }
    }
  }
  q.hit[i] = way >= 0;
  for (int p = 0; p < q.P; ++p) {
    q.pay[static_cast<size_t>(i) * q.P + p] = way >= 0 ? __ldg(q.bpay + (base + way) * q.P + p) : 0u;
  }
}

// ---- VECTOR, GATED, LATE, LEAN: W = 4, 16-byte words -------------------

// The first of four flags that is set, -1 if none.
__device__ __forceinline__ int first_of(bool a, bool b, bool c, bool d) {
  return a ? 0 : b ? 1 : c ? 2 : d ? 3 : -1;
}

// Entry x's P payload words (P = 1 or 2), in .x (and .y).
template <int P>
__device__ __forceinline__ uint2 way_payload(const Probe& q, size_t x) {
  if constexpr (P == 1) {
    return make_uint2(__ldg(q.bpay + x), 0u);
  } else {
    return __ldg(reinterpret_cast<const uint2*>(q.bpay) + x);
  }
}

template <int P, bool GATE, bool LATE>
__device__ void probe_vector(const Probe& q, int i) {
  const uint32_t kh = __ldg(q.khi + i);
  const uint32_t kl = __ldg(q.klo + i);
  const size_t t = static_cast<size_t>(__ldg(q.tid + i));
  const size_t e = bucket_entry(q, t, kh, kl);
  const uint4* kp = reinterpret_cast<const uint4*>(q.bkey + 2 * e);
  const uint32_t* vp = reinterpret_cast<const uint32_t*>(q.bvalid + e);
  const bool may = bloom_test(q, t, kh, kl);
  uint4 k01 = make_uint4(0, 0, 0, 0), k23 = k01, pw[P];
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) pw[j] = k01;
  if (!GATE || may) {
    k01 = __ldg(kp);
    k23 = __ldg(kp + 1);
    if constexpr (!LATE) {
      valid = __ldg(vp);
#pragma unroll
      for (int j = 0; j < P; ++j) pw[j] = __ldg(reinterpret_cast<const uint4*>(q.bpay + P * e) + j);
    }
  }
  const bool km[4] = {k01.x == kh && k01.y == kl, k01.z == kh && k01.w == kl,
                      k23.x == kh && k23.y == kl, k23.z == kh && k23.w == kl};
  uint2 v = make_uint2(0, 0);
  int w = -1;
  if constexpr (LATE) {
    const int f = first_of(km[0], km[1], km[2], km[3]);  // the first way holding the key
    if (may && f >= 0) {
      valid = __ldg(vp);
      v = way_payload<P>(q, e + f);
      w = first_of(km[0] && (valid & 0xffu), km[1] && (valid & 0xff00u),
                   km[2] && (valid & 0xff0000u), km[3] && (valid & 0xff000000u));
      if (w > f) v = way_payload<P>(q, e + w);  // an invalid copy came first
    }
  } else {
    w = first_of(km[0] && (valid & 0xffu), km[1] && (valid & 0xff00u),
                 km[2] && (valid & 0xff0000u), km[3] && (valid & 0xff000000u));
    if constexpr (P == 1) {
      v.x = w == 0 ? pw[0].x : w == 1 ? pw[0].y : w == 2 ? pw[0].z : pw[0].w;
    } else {
      v = w == 0   ? make_uint2(pw[0].x, pw[0].y)
          : w == 1 ? make_uint2(pw[0].z, pw[0].w)
          : w == 2 ? make_uint2(pw[1].x, pw[1].y)
                   : make_uint2(pw[1].z, pw[1].w);
    }
  }
  const bool h = may && w >= 0;
  q.hit[i] = h;
  if constexpr (P == 1) {
    q.pay[i] = h ? v.x : 0u;
  } else {
    reinterpret_cast<uint2*>(q.pay)[i] = h ? v : make_uint2(0, 0);
  }
}

// ---- GENERIC: any W, P and alignment, 32-bit words ---------------------

__device__ void probe_generic(const Probe& q, int i) {
  const uint32_t kh = __ldg(q.khi + i);
  const uint32_t kl = __ldg(q.klo + i);
  const size_t t = static_cast<size_t>(__ldg(q.tid + i));
  const size_t e = bucket_entry(q, t, kh, kl);
  const bool may = bloom_test(q, t, kh, kl);
  int way = -1;
  for (int w0 = 0; w0 < q.ways && way < 0; w0 += CHUNK) {
    uint32_t hi[CHUNK], lo[CHUNK];
    bool valid[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const bool in = w0 + j < q.ways;
      const size_t x = e + w0 + j;
      hi[j] = in ? __ldg(q.bkey + 2 * x) : 0u;
      lo[j] = in ? __ldg(q.bkey + 2 * x + 1) : 0u;
      valid[j] = in && __ldg(q.bvalid + x);
    }
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      if (valid[j] && hi[j] == kh && lo[j] == kl) way = w0 + j;
    }
  }
  const bool h = may && way >= 0;
  q.hit[i] = h;
  const uint32_t* src = q.bpay + (e + (h ? way : 0)) * q.P;
  for (int p = 0; p < q.P; ++p) q.pay[static_cast<size_t>(i) * q.P + p] = h ? __ldg(src + p) : 0u;
}

template <int D, int P>
__global__ void __launch_bounds__(THREADS) probe_kernel(const __grid_constant__ Probe q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.B) return;
  if constexpr (D == LOOP) {
    probe_loop(q, i);
  } else if constexpr (D == GENERIC) {
    probe_generic(q, i);
  } else {
    probe_vector<P, D == GATED || D == LEAN, D == LATE || D == LEAN>(q, i);
  }
}

template <int D, int P>
void launch(const Probe& q, int grid, int threads, cudaStream_t s) {
  probe_kernel<D, P><<<grid, threads, 0, s>>>(q);
}

}  // namespace

// design, threads and grid come from the host's plan, which also checked
// the shape and alignment the design needs (cudaErrorInvalidValue if the
// design does not serve this P).
extern "C" int dpa_cache_probe(const void* bloom, const void* bkey, const void* bpay,
                               const void* bvalid, const void* tid, const void* khi,
                               const void* klo, void* hit, void* pay, int B, int n_words,
                               int n_buckets, int ways, int P, int bloom_bits, int salt0,
                               int salt1, int salt2, int salt_bucket, int design, int threads,
                               int grid, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  Probe q;
  q.bloom = static_cast<const uint32_t*>(bloom);
  q.bkey = static_cast<const uint32_t*>(bkey);
  q.bpay = static_cast<const uint32_t*>(bpay);
  q.bvalid = static_cast<const uint8_t*>(bvalid);
  q.tid = static_cast<const int*>(tid);
  q.khi = static_cast<const uint32_t*>(khi);
  q.klo = static_cast<const uint32_t*>(klo);
  q.hit = static_cast<bool*>(hit);
  q.pay = static_cast<uint32_t*>(pay);
  q.B = B;
  q.n_words = n_words;
  q.n_buckets = n_buckets;
  q.ways = ways;
  q.P = P;
  q.bloom_bits = static_cast<uint32_t>(bloom_bits);
  q.salt[0] = static_cast<uint32_t>(salt0);
  q.salt[1] = static_cast<uint32_t>(salt1);
  q.salt[2] = static_cast<uint32_t>(salt2);
  q.salt_bucket = static_cast<uint32_t>(salt_bucket);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool p1 = P == 1;
  if (design != LOOP && design != GENERIC && P != 1 && P != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (design) {
    case LOOP: launch<LOOP, 0>(q, grid, threads, s); break;
    case GENERIC: launch<GENERIC, 0>(q, grid, threads, s); break;
    case VECTOR: p1 ? launch<VECTOR, 1>(q, grid, threads, s) : launch<VECTOR, 2>(q, grid, threads, s); break;
    case GATED: p1 ? launch<GATED, 1>(q, grid, threads, s) : launch<GATED, 2>(q, grid, threads, s); break;
    case LATE: p1 ? launch<LATE, 1>(q, grid, threads, s) : launch<LATE, 2>(q, grid, threads, s); break;
    case LEAN: p1 ? launch<LEAN, 1>(q, grid, threads, s) : launch<LEAN, 2>(q, grid, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
