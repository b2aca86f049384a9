// Natural-compression encode: each f32 coordinate becomes a signed power-of-two
// exponent code, rounded up with the probability that keeps it unbiased.  The
// bits come from a pre-drawn operand (nat_pack) or from a generator in the
// kernel (nat_pack_prng).
//
// Replaces: src/repro/kernels/nat_pack.py:nat_pack (Pallas TPU, pallas_call
// :119) and :nat_pack_prng (pallas_call :154).  Plain versions:
// repro_torch/kernels/ref.py::ref_nat_pack (frexp), ref_nat_pack_prng.
//
// Per coordinate, from the float's bits (no frexp; b = the bits of |x|):
//   u      = (bits >> 8) * 2^-24                    (bits read as uint32)
//   p_up   = (b & 0x7FFFFF) * 2^-23                 (exactly 2|mant| - 1)
//   chosen = (b >> 23) - 127 + (u < p_up)
//   code   = sign(x) * (chosen + 160)               (int16)
// and code 0 for a zero or subnormal x: the reference reads subnormal inputs
// as zero.  An x near FLT_MAX rounds up to code 288, which decodes to inf, as
// in the reference.  u < p_up is tested in integers: both sides are integers
// below 2^24 scaled by powers of two, so it is exactly
// (bits >> 8) < 2 (b & 0x7FFFFF), that is bits < (b & 0x7FFFFF) << 9, and
// that is the float's bits shifted left by 9 (sign and exponent fall off the
// top): one shift and one compare, no conversion
// (tests/test_torch_encode_rules.py holds the two forms equal over every
// mantissa).
//
// Bound: bytes, 10 B per coordinate (4 B x + 4 B bits read, 2 B written).
// Design: one thread per 4 coordinates, one float4 load of x, one uint4 load of
// bits and one 8-byte store of the codes; the start is peeled (up to 3
// coordinates) so the vector loads are 16-byte aligned, and the codes go out
// as 4 two-byte stores where the output is not 8-byte aligned there (a
// worker's row of an (n, d) buffer with odd d).  x and bits with different
// alignments take the scalar kernel.  Built with -fmad=false, no fast math:
// nothing here rounds, so the codes are bitwise the plain version's.
//
// nat_pack_prng draws coordinate j's word in registers with counter-mode
// threefry2x32 (threefry.cuh) from the key table: j in segment i (coordinates
// [start[i], start[i+1])) takes word j - start[i] of jax.random.bits(keys[i],
// (s_i,)), so it equals nat_pack fed those draws bit for bit (the TPU kernel's
// hardware stream is equal only in distribution).  Bound: 6 B per coordinate
// (4 B x read, 2 B codes written) and the cipher's 68 integer instructions
// per coordinate (threefry.cuh), which take longer at the SM's dispatch rate:
// the kernel is bound by the cipher.  Design: one warp per chunk of 512
// coordinates, lane l holding float4 groups i*32 + l (i < 4: coalesced loads
// and stores) and their 16 words, drawn as 16 independent cipher chains while
// the loads are in flight.  The warp finds its chunk's segment once; where
// the chunk lies inside one segment and its counters share their high word
// (every chunk but at most one per segment boundary and one per 2^32 words
// of a segment), the counters are 32-bit adds off the chunk's base.
// Otherwise (segments have alignment 1: a boundary can fall anywhere, also
// inside a group of 4) each coordinate finds its own segment and draws with
// a 64-bit counter.  The peeled head and the tail after the last whole chunk
// (fewer than 4 + 512 coordinates) are one more warp's, coordinate by
// coordinate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBias = 160;
constexpr int kChunk = 512;                  // coordinates of a warp's chunk (PRNG kernel)
constexpr int kChunkGroups = kChunk / 128;   // float4 per lane of a chunk

__device__ __forceinline__ int16_t nat_code(float x, uint32_t r) {
  const uint32_t xb = __float_as_uint(x);
  const uint32_t e = (xb >> 23) & 0xFFu;
  if (e == 0u) return 0;  // zero or subnormal
  const int c = (int)e - 127 + (r < (xb << 9) ? 1 : 0) + kBias;  // u < p_up
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

// Coordinate j's word from the key table: its own segment, a 64-bit counter.
__device__ __forceinline__ uint32_t table_word(const threefry::KeyTable& t, long long j) {
  const int seg = threefry::segment_of(t, j);
  return threefry::bits_word(threefry::schedule_of(t, seg),
                             (unsigned long long)(j - t.start[seg]));
}

template <bool kVecStore>
__global__ void __launch_bounds__(kThreads)
    nat_pack_prng_kernel(const float* __restrict__ x, int16_t* __restrict__ out, long long d,
                         long long head, long long chunks,
                         const __grid_constant__ threefry::KeyTable table) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp < chunks) {
    const long long base = head + warp * kChunk;
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4 v[kChunkGroups];
#pragma unroll
    for (int i = 0; i < kChunkGroups; ++i) v[i] = __ldcs(x4 + i * 32 + lane);
    uint32_t w[4 * kChunkGroups];  // word of coordinate base + 128 (q / 4) + 4 lane + q % 4
    const int seg = threefry::segment_of(table, base);
    const long long j0 = base - table.start[seg];
    if (base + kChunk <= table.start[seg + 1] && (uint32_t)j0 <= 0xFFFFFFFFu - (kChunk - 1)) {
      const uint32_t lo = (uint32_t)j0 + 4u * (uint32_t)lane;
#pragma unroll
      for (int q = 0; q < 4 * kChunkGroups; ++q) {
        w[q] = lo + 128u * (uint32_t)(q >> 2) + (uint32_t)(q & 3);
      }
      threefry::words<4 * kChunkGroups>(threefry::schedule_of(table, seg),
                                        (uint32_t)((unsigned long long)j0 >> 32), w);
    } else {
#pragma unroll
      for (int q = 0; q < 4 * kChunkGroups; ++q) {
        w[q] = table_word(table, base + 128 * (q >> 2) + 4 * lane + (q & 3));
      }
    }
#pragma unroll
    for (int i = 0; i < kChunkGroups; ++i) {
      const int16_t c0 = nat_code(v[i].x, w[4 * i]), c1 = nat_code(v[i].y, w[4 * i + 1]);
      const int16_t c2 = nat_code(v[i].z, w[4 * i + 2]), c3 = nat_code(v[i].w, w[4 * i + 3]);
      int16_t* o = out + base + 4 * (i * 32 + lane);
      if (kVecStore) {
        *reinterpret_cast<short4*>(o) = make_short4(c0, c1, c2, c3);
      } else {
        o[0] = c0; o[1] = c1; o[2] = c2; o[3] = c3;
      }
    }
  } else if (warp == chunks) {
    // The peeled head [0, head) and the tail [head + chunks * kChunk, d).
    for (long long j = lane; j < head; j += 32) out[j] = nat_code(x[j], table_word(table, j));
    for (long long j = head + chunks * kChunk + lane; j < d; j += 32) {
      out[j] = nat_code(x[j], table_word(table, j));
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
  const long long chunks = (d - head) / kChunk;
  const float* xp = (const float*)x;
  int16_t* op = (int16_t*)out;
  const unsigned blocks = blocks_for(32 * (chunks + 1));  // a warp per chunk, one more
  if ((oa + 2 * (uintptr_t)head) % 8 == 0) {
    nat_pack_prng_kernel<true><<<blocks, kThreads, 0, st>>>(xp, op, d, head, chunks, table);
  } else {
    nat_pack_prng_kernel<false><<<blocks, kThreads, 0, st>>>(xp, op, d, head, chunks, table);
  }
  return (int)cudaGetLastError();
}
