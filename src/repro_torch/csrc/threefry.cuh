// The threefry2x32 block cipher (20 rounds), bit for bit JAX's
// (jax/_src/prng.py, threefry2x32), as a device function shared by the
// sources that draw bits: the bits helper (threefry.cu) and the in-kernel
// generators of quantize_pack.cu and nat_pack.cu.
//
// Counter mode, as jax.random.bits(key, shape, uint32) under
// jax_threefry_partitionable=True: word j of a draw is x0 ^ x1 of
// threefry2x32(key, (j >> 32, j & 0xFFFFFFFF)) over the flat index j.
#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                                       int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// Word j (a 64-bit counter) of the draw jax.random.bits(key, shape, uint32).
__device__ __forceinline__ uint32_t bits_word(uint32_t k0, uint32_t k1, unsigned long long j) {
  uint32_t x0 = (uint32_t)(j >> 32);
  uint32_t x1 = (uint32_t)j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// The key table of an encode whose buffer is cut into segments, segment i
// drawing from its own key: words k[2i], k[2i+1]; segment i covers units
// [start[i], start[i + 1]) of the buffer (block rows for the ternary encode,
// coordinates for natural), and its counter restarts at 0.  Passed to the
// kernel by value as a __grid_constant__ parameter (no device allocation, no
// copy per thread); a wrapper raises above kMaxSegments.
constexpr int kMaxSegments = 128;

struct KeyTable {
  uint32_t k[2 * kMaxSegments];
  long long start[kMaxSegments + 1];
  int nseg;
};

// The segment that holds unit u (start[0] <= u < start[nseg]): the last i
// with start[i] <= u.  Empty segments (start[i] == start[i + 1]) are skipped.
__device__ __forceinline__ int segment_of(const KeyTable& t, long long u) {
  int lo = 0, hi = t.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Fill a KeyTable from host arrays (the C entry points' arguments).
// Returns false when the table does not fit.
inline bool fill_table(KeyTable& t, const uint32_t* words, const long long* starts, int nseg) {
  if (nseg < 1 || nseg > kMaxSegments) return false;
  t.nseg = nseg;
  for (int i = 0; i < 2 * nseg; ++i) t.k[i] = words[i];
  for (int i = 0; i <= nseg; ++i) t.start[i] = starts[i];
  return true;
}

}  // namespace threefry
