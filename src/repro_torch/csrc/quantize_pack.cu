// Fused block p-quantization + 2-bit pack, with the Bernoulli bits read from a
// pre-drawn operand (quantize_pack) or generated in the kernel
// (quantize_pack_prng).
//
// Replaces: src/repro/kernels/quantize_pack.py:quantize_pack (Pallas TPU,
// pallas_call :126) and :quantize_pack_prng (pallas_call :177).  Plain
// versions: repro_torch/kernels/ref.py::ref_quantize_pack,
// ref_quantize_pack_prng.
//
// Per block row of B coordinates: scale = ||row||_p (p = inf: max |x|;
// p = 1: sum |x|; p = 2: sqrt(sum x*x); else (sum |x|^p)^(1/p)), then each
// coordinate keeps sign(x) where u = (bits >> 8) * 2^-24 < |x| / scale, and
// the codes sign+1 are packed four per byte, little-endian.
//
// The TPU's in-kernel variant seeds the TPU's hardware generator per tile,
// a stream no other chip reproduces; its contract is equality in
// distribution with the bits variant.  Here the generator is counter-mode
// threefry2x32 (threefry.cuh): a row of segment i (rows [start[i],
// start[i+1]) of the key table) draws word j = (row - start[i]) * B + col of
// jax.random.bits(keys[i], (m_i, B)), computed in registers.  So the PRNG
// variant equals the bits variant fed those draws, bit for bit, and the
// trainer's payloads stay the JAX package's CPU route's.
//
// Bound: bytes, ~8.25 B per coordinate with pre-drawn bits (4 B delta + 4 B
// bits read once, 0.25 B of codes written), 4.25 B with the generator, which
// then does ~78 integer operations per coordinate (the cipher).  Design: one
// thread block per row; each thread reads 4 consecutive coordinates as one
// float4 (16 B) and their bits as one uint4 (or draws 4 words), and writes
// one byte.  The row norm reduces in registers, then warp shuffles, then
// shared memory, in a fixed order (deterministic; p = inf is a max, so it
// equals the plain version bitwise).  The second pass re-reads the row,
// which the first pass left in L1/L2 (8 KB per row at B = 2048), so device
// memory sees each input about once.
//
// Numerics: built with -fmad=false and IEEE division / sqrt (no fast math),
// so |x| / scale and the sums round as the plain version's do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

enum NormKind { kInf = 0, kOne = 1, kTwo = 2, kGeneral = 3 };

__device__ __forceinline__ float combine(float a, float b, int kind) {
  return kind == kInf ? fmaxf(a, b) : a + b;
}

__device__ __forceinline__ float term(float x, int kind, float p) {
  const float a = fabsf(x);
  if (kind == kInf || kind == kOne) return a;
  if (kind == kTwo) return x * x;
  return powf(a, p);
}

__device__ float block_reduce(float v, int kind, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = combine(v, __shfl_down_sync(0xffffffffu, v, o), kind);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? smem[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = combine(v, __shfl_down_sync(0xffffffffu, v, o), kind);
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

__device__ __forceinline__ uint32_t code(float x, uint32_t r, float safe) {
  const float u = (float)(r >> 8) * (1.0f / 16777216.0f);
  const bool keep = u < fabsf(x) / safe;
  const int s = (x > 0.0f) - (x < 0.0f);
  return (uint32_t)(keep ? s + 1 : 1);
}

// The bits of 4 consecutive coordinates: a pre-drawn uint4, or 4 threefry words.
struct PredrawnBits {
  const uint4* r4;
  __device__ __forceinline__ uint4 operator()(int g) const { return r4[g]; }
};

struct ThreefryBits {
  uint32_t k0, k1;
  unsigned long long base;  // the row's first counter within its segment
  __device__ __forceinline__ uint4 operator()(int g) const {
    const unsigned long long j = base + 4ull * (unsigned)g;
    return make_uint4(threefry::bits_word(k0, k1, j), threefry::bits_word(k0, k1, j + 1),
                      threefry::bits_word(k0, k1, j + 2), threefry::bits_word(k0, k1, j + 3));
  }
};

template <class Bits>
__device__ __forceinline__ void quantize_row(const float* __restrict__ delta, Bits bits,
                                             uint8_t* __restrict__ packed,
                                             float* __restrict__ scales, long long row, int B,
                                             int kind, float p, float inv_p, float* smem) {
  const int groups = B / 4;
  const float4* x4 = reinterpret_cast<const float4*>(delta + row * B);
  uint8_t* out = packed + row * groups;

  float acc = 0.0f;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float4 v = x4[g];
    acc = combine(acc, term(v.x, kind, p), kind);
    acc = combine(acc, term(v.y, kind, p), kind);
    acc = combine(acc, term(v.z, kind, p), kind);
    acc = combine(acc, term(v.w, kind, p), kind);
  }
  const float red = block_reduce(acc, kind, smem);
  const float scale = kind == kTwo ? sqrtf(red) : (kind == kGeneral ? powf(red, inv_p) : red);
  const float safe = scale > 0.0f ? scale : 1.0f;

  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float4 v = x4[g];
    const uint4 r = bits(g);
    out[g] = (uint8_t)(code(v.x, r.x, safe) | (code(v.y, r.y, safe) << 2) |
                       (code(v.z, r.z, safe) << 4) | (code(v.w, r.w, safe) << 6));
  }
  if (threadIdx.x == 0) scales[row] = scale;
}

__global__ void quantize_pack_kernel(const float* __restrict__ delta,
                                     const uint32_t* __restrict__ bits,
                                     uint8_t* __restrict__ packed,
                                     float* __restrict__ scales, int B, int kind,
                                     float p, float inv_p) {
  __shared__ float smem[32];
  const long long row = blockIdx.x;
  const PredrawnBits src{reinterpret_cast<const uint4*>(bits + row * B)};
  quantize_row(delta, src, packed, scales, row, B, kind, p, inv_p, smem);
}

__global__ void quantize_pack_prng_kernel(const float* __restrict__ delta,
                                          uint8_t* __restrict__ packed,
                                          float* __restrict__ scales, int B, int kind,
                                          float p, float inv_p,
                                          const __grid_constant__ threefry::KeyTable table) {
  __shared__ float smem[32];
  const long long row = blockIdx.x;
  const int seg = threefry::segment_of(table, row);
  const ThreefryBits src{table.k[2 * seg], table.k[2 * seg + 1],
                         (unsigned long long)(row - table.start[seg]) * (unsigned)B};
  quantize_row(delta, src, packed, scales, row, B, kind, p, inv_p, smem);
}

}  // namespace

// delta (m, B) f32, bits (m, B) uint32 -> packed (m, B/4) u8, scales (m,) f32.
extern "C" int quantize_pack(const void* delta, const void* bits, void* packed, void* scales,
                             long long m, int B, int kind, float p, float inv_p,
                             void* stream) {
  if (m <= 0) return 0;
  quantize_pack_kernel<<<(unsigned)m, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)delta, (const uint32_t*)bits, (uint8_t*)packed, (float*)scales, B, kind,
      p, inv_p);
  return (int)cudaGetLastError();
}

// delta (m, B) f32 -> packed (m, B/4) u8, scales (m,) f32; the bits drawn in
// the kernel from the key table (key_words (nseg, 2) uint32, row_starts
// (nseg + 1,) int64 with row_starts[0] = 0 and row_starts[nseg] = m; host
// arrays, copied into the launch's parameters).
extern "C" int quantize_pack_prng(const void* delta, void* packed, void* scales, long long m,
                                  int B, int kind, float p, float inv_p,
                                  const void* key_words, const void* row_starts, int nseg,
                                  void* stream) {
  if (m <= 0) return 0;
  threefry::KeyTable table;
  if (!threefry::fill_table(table, (const uint32_t*)key_words, (const long long*)row_starts,
                            nseg)) {
    return (int)cudaErrorInvalidValue;
  }
  quantize_pack_prng_kernel<<<(unsigned)m, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)delta, (uint8_t*)packed, (float*)scales, B, kind, p, inv_p, table);
  return (int)cudaGetLastError();
}
