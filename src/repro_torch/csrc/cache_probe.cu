// Payload-generic cache probe: Bloom test, bucket select, W-way compare.
//
// Replaces the TPU kernel src/repro/kernels/cache_probe.py
// (_generic_probe_kernel, called by generic_probe_pallas and its two
// instantiations probe_pallas (P=2 value words, the GET hot-entry cache) and
// anchor_probe_pallas (P=1 leaf id, the RANGE scan-anchor cache)).  The
// payload width P is a runtime argument over 32-bit words, so one kernel
// serves both families.  Semantics are those of the plain version,
// repro_torch/kernels/cache_probe.py:probe_plain: hit = Bloom-positive AND a
// valid way holds the exact key; the payload is the first matching way's,
// zeros on a miss.
//
// Bound on the H100: device-memory traffic (a few hashes and compares per
// request).  Bytes needed per request: thread id and key (12 B), three Bloom
// words (12 B), hit flag and payload out (1 + 4P B); a Bloom-positive request
// also reads its bucket's W keys and valid flags (W * 9 B) and, on a hit, one
// payload (4P B).  At W = 4 that is 29 + 4P B for a Bloom-negative request and
// 65 + 8P B for a hit.
//
// Design: one thread per request.  The caches are small (176 threads x 96
// entries: 68 KB of keys), so after the first touches they sit in L2; a
// Bloom-negative request stops before touching the bucket, as the paper's
// predicated load does.
#include "common.cuh"

using namespace dpa;

__global__ void probe_kernel(const uint32_t* __restrict__ bloom,
                             const uint2* __restrict__ bkey,
                             const uint32_t* __restrict__ bpay,
                             const uint8_t* __restrict__ bvalid,
                             const int* __restrict__ tid,
                             const uint32_t* __restrict__ khi,
                             const uint32_t* __restrict__ klo,
                             bool* __restrict__ hit,
                             uint32_t* __restrict__ pay,
                             int B, int n_words, int n_buckets, int ways, int P, int bloom_bits,
                             int salt0, int salt1, int salt2, int salt_bucket) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t kh = khi[i];
  const uint32_t kl = klo[i];
  const size_t t = static_cast<size_t>(tid[i]);
  const uint32_t salts[3] = {static_cast<uint32_t>(salt0), static_cast<uint32_t>(salt1),
                             static_cast<uint32_t>(salt2)};
  bool may = true;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const uint32_t h = limb_hash(kh, kl, salts[s]) % static_cast<uint32_t>(bloom_bits);
    const uint32_t word = bloom[t * n_words + h / 32];
    may = may && ((word >> (h % 32)) & 1u);
  }
  int way = -1;
  size_t base = 0;
  if (may) {
    const uint32_t b = limb_hash(kh, kl, static_cast<uint32_t>(salt_bucket)) %
                       static_cast<uint32_t>(n_buckets);
    base = (t * n_buckets + b) * ways;
    for (int w = 0; w < ways; ++w) {
      if (bvalid[base + w] && limb_eq(bkey[base + w], kh, kl)) {
        way = w;
        break;
      }
    }
  }
  hit[i] = way >= 0;
  for (int p = 0; p < P; ++p) {
    pay[static_cast<size_t>(i) * P + p] = way >= 0 ? bpay[(base + way) * P + p] : 0u;
  }
}

extern "C" int dpa_cache_probe(const void* bloom, const void* bkey, const void* bpay,
                               const void* bvalid, const void* tid, const void* khi,
                               const void* klo, void* hit, void* pay, int B, int n_words,
                               int n_buckets, int ways, int P, int bloom_bits, int salt0,
                               int salt1, int salt2, int salt_bucket, void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bloom), static_cast<const uint2*>(bkey),
        static_cast<const uint32_t*>(bpay), static_cast<const uint8_t*>(bvalid),
        static_cast<const int*>(tid), static_cast<const uint32_t*>(khi),
        static_cast<const uint32_t*>(klo), static_cast<bool*>(hit),
        static_cast<uint32_t*>(pay), B, n_words, n_buckets, ways, P, bloom_bits, salt0, salt1,
        salt2, salt_bucket);
  }
  return static_cast<int>(cudaGetLastError());
}
