// Shared device helpers for the DPA-Store kernels.
//
// Keys are u64 held as two u32 limbs (hi, lo).  The torch pools hold them as
// int32 bit patterns in a trailing axis of 2; the kernels read a limb pair as
// one uint2 (x = hi, y = lo), 8-byte aligned since every row starts at a
// multiple of 8 bytes.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace dpa {

constexpr int SEG_CAP = 128;   // pivots per segment / keys per leaf
constexpr int NODE_SEGS = 7;   // segments per inner node

__device__ __forceinline__ bool limb_le(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  return (ah < bh) || (ah == bh && al <= bl);
}

__device__ __forceinline__ bool limb_eq(uint2 a, uint32_t bh, uint32_t bl) {
  return a.x == bh && a.y == bl;
}

// Exact u64 (a - b) by borrow-propagated limb subtraction, then hi * 2^32 + lo
// in f32 with the reference's roundings: each limb converts to nearest, the
// scale by 2^32 is exact (a power of two), and the add rounds once.  Since the
// product is exact, a contraction of mul+add into an FMA could not change the
// result either; the intrinsics just make the order explicit.
__device__ __forceinline__ float delta_f32(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  const uint32_t borrow = al < bl ? 1u : 0u;
  const uint32_t lo = al - bl;
  const uint32_t hi = ah - bh - borrow;
  return __fadd_rn(__fmul_rn(__uint2float_rn(hi), 4294967296.0f), __uint2float_rn(lo));
}

// Clamped-below PLA prediction of a local rank (0 for keys below the anchor).
__device__ __forceinline__ float predict(float slope, uint2 anchor, uint32_t kh, uint32_t kl) {
  if (!limb_le(anchor.x, anchor.y, kh, kl)) return 0.0f;
  return __fmul_rn(slope, delta_f32(kh, kl, anchor.x, anchor.y));
}

// floor(p) converted to int32 the way the reference converts it: saturating
// (>= 2^31 -> INT_MAX, < -2^31 -> INT_MIN) and NaN -> 0.  Spelled out rather
// than left to the conversion instruction: far queries on sparse key sets
// predict ranks beyond 2^31.
__device__ __forceinline__ int sat_floor_i32(float p) {
  const float f = floorf(p);
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f < -2147483648.0f) return INT_MIN;
  return static_cast<int>(f);
}

// Base of the w-wide search window around the prediction:
// clip(floor(pred) - eps, 0, max(count - w, 0)).
__device__ __forceinline__ int window_lo(float pred, int eps, int count, int w) {
  long long lo = static_cast<long long>(sat_floor_i32(pred)) - eps;
  const int hi = count - w > 0 ? count - w : 0;
  if (lo < 0) lo = 0;
  if (lo > hi) lo = hi;
  return static_cast<int>(lo);
}

// 32-bit multiply-xor-shift hash of a 64-bit key; u32 wraparound throughout.
__device__ __forceinline__ uint32_t limb_hash(uint32_t hi, uint32_t lo, uint32_t salt) {
  uint32_t h = hi ^ (lo * 0x9E3779B9u) ^ (salt * 0x85EBCA6Bu + 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

}  // namespace dpa
