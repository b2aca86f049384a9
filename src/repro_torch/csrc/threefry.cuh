// The threefry2x32 block cipher (20 rounds), bit for bit JAX's
// (jax/_src/prng.py, threefry2x32), as device functions shared by the
// sources that draw bits: the bits helper (threefry.cu) and the in-kernel
// generators of quantize_pack.cu and nat_pack.cu.
//
// Counter mode, as jax.random.bits(key, shape, uint32) under
// jax_threefry_partitionable=True: word j of a draw is x0 ^ x1 of
// threefry2x32(key, (j >> 32, j & 0xFFFFFFFF)) over the flat index j.
//
// Work per word, counted from the specification: 20 rounds of add, rotate
// and xor (60 instructions), the counter's low word plus the key (1), x1's
// five injections (5), x0's five injections, of which the first four fold
// into the next round's three-input add (1), and the final x0 ^ x1 (1): 68
// 32-bit integer instructions, where the high word of the counter is the
// same for a run of words (x0's start hi + k0 is then computed once).  So
// the key schedule (k2 and the injection constants k? + i) is computed once
// per key (Schedule), not per word, and words() takes N independent
// counters, fully unrolled, so the compiler interleaves N dependency chains
// of rounds.
//
// Pipes: the rotates (funnel shifts) and xors issue only on the SM's 64-lane
// integer pipe, and an add there too unless it is an IMAD (a * b + c) on the
// FMA pipe.  Every add is written as x * one + y, with one a value the
// compiler cannot see (1 at run time, from the launch's parameters), so the
// 31 adds of a word go to the FMA pipe and the integer pipe keeps the 41
// rotates and xors (left to itself, nvcc folds injections into three-input
// integer adds, IADD3, on the integer pipe, which then saturates).
#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// x + y as an IMAD (one == 1 at run time).
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  return x * one + y;
}

// One key's schedule: the words x0's injections add, x1's injections with
// their round number folded in, and the run-time 1 of add().
struct Schedule {
  uint32_t k0, k1, k2;
  uint32_t j1, j2, j3, j4, j5;  // k2 + 1, k0 + 2, k1 + 3, k2 + 4, k0 + 5
  uint32_t one;
};

__device__ __forceinline__ Schedule schedule(uint32_t k0, uint32_t k1, uint32_t one) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return {k0, k1, k2, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u, one};
}

template <int N>
__device__ __forceinline__ void rounds4(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t one,
                                        int r0, int r1, int r2, int r3) {
  const int r[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int w = 0; w < N; ++w) {
      x0[w] = add(x1[w], x0[w], one);
      x1[w] = rotl(x1[w], r[q]) ^ x0[w];
    }
  }
}

template <int N>
__device__ __forceinline__ void inject(uint32_t (&x0)[N], uint32_t (&x1)[N], uint32_t one,
                                       uint32_t a, uint32_t b) {
#pragma unroll
  for (int w = 0; w < N; ++w) {
    x0[w] = add(x0[w], a, one);
    x1[w] = add(x1[w], b, one);
  }
}

// N words of one key: counter (hi, lo[w]) -> lo[w] = x0 ^ x1.  hi is shared
// by the N counters (the caller splits a run where the high word changes).
template <int N>
__device__ __forceinline__ void words(const Schedule& s, uint32_t hi, uint32_t (&lo)[N]) {
  uint32_t x0[N], x1[N];
  const uint32_t h = hi + s.k0;
  const uint32_t one = s.one;
#pragma unroll
  for (int w = 0; w < N; ++w) {
    x0[w] = h;
    x1[w] = add(lo[w], s.k1, one);
  }
  rounds4(x0, x1, one, 13, 15, 26, 6);  inject(x0, x1, one, s.k1, s.j1);
  rounds4(x0, x1, one, 17, 29, 16, 24); inject(x0, x1, one, s.k2, s.j2);
  rounds4(x0, x1, one, 13, 15, 26, 6);  inject(x0, x1, one, s.k0, s.j3);
  rounds4(x0, x1, one, 17, 29, 16, 24); inject(x0, x1, one, s.k1, s.j4);
  rounds4(x0, x1, one, 13, 15, 26, 6);  inject(x0, x1, one, s.k2, s.j5);
#pragma unroll
  for (int w = 0; w < N; ++w) lo[w] = x0[w] ^ x1[w];
}

// Word j (a 64-bit counter) of the draw jax.random.bits(key, shape, uint32).
__device__ __forceinline__ uint32_t bits_word(const Schedule& s, unsigned long long j) {
  uint32_t lo[1] = {(uint32_t)j};
  words<1>(s, (uint32_t)(j >> 32), lo);
  return lo[0];
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
  uint32_t one;  // 1: add()'s multiplier
};

__device__ __forceinline__ Schedule schedule_of(const KeyTable& t, int seg) {
  return schedule(t.k[2 * seg], t.k[2 * seg + 1], t.one);
}

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
  t.one = 1u;
  for (int i = 0; i < 2 * nseg; ++i) t.k[i] = words[i];
  for (int i = 0; i <= nseg; ++i) t.start[i] = starts[i];
  return true;
}

}  // namespace threefry
