// Fused block p-quantization + 2-bit pack.
//
// Replaces: src/repro/kernels/quantize_pack.py:quantize_pack (Pallas TPU).
// Plain version: repro_torch/kernels/ref.py::ref_quantize_pack.
//
// Per block row of B coordinates: scale = ||row||_p (p = inf: max |x|;
// p = 1: sum |x|; p = 2: sqrt(sum x*x); else (sum |x|^p)^(1/p)), then each
// coordinate keeps sign(x) where u = (bits >> 8) * 2^-24 < |x| / scale, and
// the codes sign+1 are packed four per byte, little-endian.
//
// Bound: bytes, ~8.25 B per coordinate (4 B delta + 4 B bits read once,
// 0.25 B of codes written).  Design: one thread block per row; each thread
// reads 4 consecutive coordinates as one float4 (16 B) and their bits as one
// uint4, and writes one byte.  The row norm reduces in registers, then warp
// shuffles, then shared memory, in a fixed order (deterministic; p = inf is a
// max, so it equals the plain version bitwise).  The second pass re-reads the
// row, which the first pass left in L1/L2 (8 KB per row at B = 2048), so
// device memory sees each input about once.
//
// Numerics: built with -fmad=false and IEEE division / sqrt (no fast math),
// so |x| / scale and the sums round as the plain version's do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__global__ void quantize_pack_kernel(const float* __restrict__ delta,
                                     const uint32_t* __restrict__ bits,
                                     uint8_t* __restrict__ packed,
                                     float* __restrict__ scales, int B, int kind,
                                     float p, float inv_p) {
  __shared__ float smem[32];
  const long long row = blockIdx.x;
  const int groups = B / 4;
  const float4* x4 = reinterpret_cast<const float4*>(delta + row * B);
  const uint4* r4 = reinterpret_cast<const uint4*>(bits + row * B);
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
    const uint4 r = r4[g];
    out[g] = (uint8_t)(code(v.x, r.x, safe) | (code(v.y, r.y, safe) << 2) |
                       (code(v.z, r.z, safe) << 4) | (code(v.w, r.w, safe) << 6));
  }
  if (threadIdx.x == 0) scales[row] = scale;
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
