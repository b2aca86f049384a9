// Counter-mode threefry2x32 bits, bit for bit jax.random.bits(key, shape,
// uint32) under jax_threefry_partitionable=True (jax/_src/prng.py):
//   word i = x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)).
//
// Replaces: the XLA threefry that ternary.py draws its Bernoulli bits with
// (src/repro/core/compressors/ternary.py:167, TernaryCompressor._batched_bits);
// it is no Pallas kernel.  Plain version: repro_torch/core/prng.py::bits.
//
// Bound: the output, 4 B/word written once (the counters are computed, not
// read), and ~110 32-bit integer ops per word (20 rounds of add/rotate/xor
// plus 5 key injections).  Design: one thread per output word, native
// uint32 arithmetic, grid-stride loop; consecutive threads write consecutive
// words, so the stores coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0, int r1,
                                       int r2, int r3) {
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

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t* __restrict__ out,
                                     long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
    uint32_t x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    out[i] = x0 ^ x1;
  }
}

}  // namespace

extern "C" int threefry_bits(uint32_t k0, uint32_t k1, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  threefry_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      k0, k1, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
