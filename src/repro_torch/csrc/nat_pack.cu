// Natural-compression encode: each f32 coordinate becomes a signed power-of-two
// exponent code, rounded up with the probability that keeps it unbiased.  The
// bits come from a pre-drawn operand (nat_pack) or from a generator in the
// kernel (nat_pack_prng).
//
// Replaces: src/repro/kernels/nat_pack.py:nat_pack (Pallas TPU, pallas_call
// :119) and :nat_pack_prng (pallas_call :154).  Plain versions:
// repro_torch/kernels/ref.py::ref_nat_pack (frexp), ref_nat_pack_prng.
//
// Per coordinate, from the float's bits (no frexp):
//   u      = (bits >> 8) * 2^-24                    (bits read as uint32)
//   p_up   = (|x| & 0x7FFFFF) * 2^-23               (exactly 2|mant| - 1)
//   chosen = (|x| >> 23) - 127 + (u < p_up)
//   code   = sign(x) * (chosen + 160)               (int16)
// and code 0 for a zero or subnormal x: the reference reads subnormal inputs
// as zero.  An x near FLT_MAX rounds up to code 288, which decodes to inf, as
// in the reference.
//
// Bound: bytes, 10 B per coordinate (4 B x + 4 B bits read, 2 B written).
// Design: one thread per 4 coordinates, one float4 load of x, one uint4 load of
// bits and one 8-byte store of the codes; the start is peeled (up to 3
// coordinates) so the vector loads are 16-byte aligned, and the codes go out
// as 4 two-byte stores where the output is not 8-byte aligned there (a
// worker's row of an (n, d) buffer with odd d).  x and bits with different
// alignments take the scalar kernel.  Built with -fmad=false, no fast math:
// nothing here rounds (every product is by a power of two of an integer
// below 2^24), so the codes are bitwise the plain version's.
//
// nat_pack_prng draws coordinate j's word in registers with counter-mode
// threefry2x32 (threefry.cuh) from the key table: j in segment i (coordinates
// [start[i], start[i+1])) takes word j - start[i] of jax.random.bits(keys[i],
// (s_i,)), so it equals nat_pack fed those draws bit for bit (the TPU kernel's
// hardware stream is equal only in distribution).  Segments have alignment 1:
// a boundary can fall inside a group of 4 or inside the peeled head, so each
// coordinate finds its own segment (one binary search per group, then a step
// forward per coordinate).  Bound: 6 B per coordinate (4 B x read, 2 B codes
// written) and ~78 integer operations per coordinate for the cipher.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBias = 160;

__device__ __forceinline__ int16_t nat_code(float x, uint32_t r) {
  const uint32_t b = __float_as_uint(x) & 0x7FFFFFFFu;
  const uint32_t e = b >> 23;
  if (e == 0u) return 0;  // zero or subnormal
  const float u = (float)(r >> 8) * (1.0f / 16777216.0f);
  const float p_up = (float)(b & 0x7FFFFFu) * (1.0f / 8388608.0f);
  const int c = (int)e - 127 + (u < p_up ? 1 : 0) + kBias;
  return (int16_t)(x < 0.0f ? -c : c);
}

template <bool kVecStore>
__global__ void nat_pack_vec_kernel(const float* __restrict__ x,
                                    const uint32_t* __restrict__ bits,
                                    int16_t* __restrict__ out, long long d, long long head,
                                    long long groups) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    const long long i = head + 4 * g;
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    const uint4 r = *reinterpret_cast<const uint4*>(bits + i);
    const int16_t c0 = nat_code(v.x, r.x), c1 = nat_code(v.y, r.y);
    const int16_t c2 = nat_code(v.z, r.z), c3 = nat_code(v.w, r.w);
    if (kVecStore) {
      *reinterpret_cast<short4*>(out + i) = make_short4(c0, c1, c2, c3);
    } else {
      out[i] = c0; out[i + 1] = c1; out[i + 2] = c2; out[i + 3] = c3;
    }
  }
  // The peeled head [0, head) and the tail [head + 4 * groups, d): <= 3 each.
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long j = threadIdx.x < 4 ? threadIdx.x : head + 4 * groups + threadIdx.x - 4;
    if (threadIdx.x < 4 ? j < head : j < d) out[j] = nat_code(x[j], bits[j]);
  }
}

__global__ void nat_pack_scalar_kernel(const float* __restrict__ x,
                                       const uint32_t* __restrict__ bits,
                                       int16_t* __restrict__ out, long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < d; i += stride) {
    out[i] = nat_code(x[i], bits[i]);
  }
}

// Coordinate j's word from the key table; seg (the segment of a coordinate
// <= j) steps forward to j's segment, over any empty ones.
__device__ __forceinline__ uint32_t table_word(const threefry::KeyTable& t, int& seg,
                                               long long j) {
  while (seg + 1 < t.nseg && t.start[seg + 1] <= j) ++seg;
  return threefry::bits_word(t.k[2 * seg], t.k[2 * seg + 1],
                             (unsigned long long)(j - t.start[seg]));
}

template <bool kVecStore>
__global__ void nat_pack_prng_kernel(const float* __restrict__ x, int16_t* __restrict__ out,
                                     long long d, long long head, long long groups,
                                     const __grid_constant__ threefry::KeyTable table) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    const long long i = head + 4 * g;
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    int seg = threefry::segment_of(table, i);
    const int16_t c0 = nat_code(v.x, table_word(table, seg, i));
    const int16_t c1 = nat_code(v.y, table_word(table, seg, i + 1));
    const int16_t c2 = nat_code(v.z, table_word(table, seg, i + 2));
    const int16_t c3 = nat_code(v.w, table_word(table, seg, i + 3));
    if (kVecStore) {
      *reinterpret_cast<short4*>(out + i) = make_short4(c0, c1, c2, c3);
    } else {
      out[i] = c0; out[i + 1] = c1; out[i + 2] = c2; out[i + 3] = c3;
    }
  }
  // The peeled head [0, head) and the tail [head + 4 * groups, d): <= 3 each.
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long j = threadIdx.x < 4 ? threadIdx.x : head + 4 * groups + threadIdx.x - 4;
    if (threadIdx.x < 4 ? j < head : j < d) {
      int seg = threefry::segment_of(table, j);
      out[j] = nat_code(x[j], table_word(table, seg, j));
    }
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

// x (d,) f32, bits (d,) uint32 -> out (d,) int16.
extern "C" int nat_pack(const void* x, const void* bits, void* out, long long d,
                        void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t xa = (uintptr_t)x, ba = (uintptr_t)bits, oa = (uintptr_t)out;
  const float* xp = (const float*)x;
  const uint32_t* bp = (const uint32_t*)bits;
  int16_t* op = (int16_t*)out;
  if (xa % 16 != ba % 16 || xa % 4 != 0) {
    long long b = (d + kThreads - 1) / kThreads;
    if (b > 132LL * 64) b = 132LL * 64;
    nat_pack_scalar_kernel<<<(unsigned)b, kThreads, 0, st>>>(xp, bp, op, d);
    return (int)cudaGetLastError();
  }
  long long head = (long long)((16 - xa % 16) % 16) / 4;
  if (head > d) head = d;
  const long long groups = (d - head) / 4;
  if ((oa + 2 * (uintptr_t)head) % 8 == 0) {
    nat_pack_vec_kernel<true><<<blocks_for(groups), kThreads, 0, st>>>(xp, bp, op, d, head,
                                                                        groups);
  } else {
    nat_pack_vec_kernel<false><<<blocks_for(groups), kThreads, 0, st>>>(xp, bp, op, d, head,
                                                                         groups);
  }
  return (int)cudaGetLastError();
}

// x (d,) f32 -> out (d,) int16, the bits drawn in the kernel from the key
// table (key_words (nseg, 2) uint32, starts (nseg + 1,) int64 with
// starts[0] = 0 and starts[nseg] = d; host arrays, copied into the launch's
// parameters).
extern "C" int nat_pack_prng(const void* x, void* out, long long d, const void* key_words,
                             const void* starts, int nseg, void* stream) {
  if (d <= 0) return 0;
  threefry::KeyTable table;
  if (!threefry::fill_table(table, (const uint32_t*)key_words, (const long long*)starts, nseg)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
  if (xa % 4 != 0) return (int)cudaErrorMisalignedAddress;
  long long head = (long long)((16 - xa % 16) % 16) / 4;
  if (head > d) head = d;
  const long long groups = (d - head) / 4;
  const float* xp = (const float*)x;
  int16_t* op = (int16_t*)out;
  if ((oa + 2 * (uintptr_t)head) % 8 == 0) {
    nat_pack_prng_kernel<true><<<blocks_for(groups), kThreads, 0, st>>>(xp, op, d, head,
                                                                         groups, table);
  } else {
    nat_pack_prng_kernel<false><<<blocks_for(groups), kThreads, 0, st>>>(xp, op, d, head,
                                                                          groups, table);
  }
  return (int)cudaGetLastError();
}
