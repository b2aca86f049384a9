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
// uint32 arithmetic (the cipher is threefry.cuh's, shared with the in-kernel
// generators), grid-stride loop; consecutive threads write consecutive words,
// so the stores coalesce.  On the trainer's path it draws only rand-k's tags:
// the ternary and natural encodes generate their bits in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t* __restrict__ out,
                                     long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = threefry::bits_word(k0, k1, (unsigned long long)i);
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
