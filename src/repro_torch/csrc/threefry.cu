// Counter-mode threefry2x32 bits, bit for bit jax.random.bits(key, shape,
// uint32) under jax_threefry_partitionable=True (jax/_src/prng.py):
//   word i = x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)).
//
// Replaces: the XLA threefry that ternary.py draws its Bernoulli bits with
// (src/repro/core/compressors/ternary.py:167, TernaryCompressor._batched_bits);
// it is no Pallas kernel.  Plain version: repro_torch/core/prng.py::bits.
//
// Bound: the output, 4 B/word written once (the counters are computed, not
// read), or the cipher's 68 32-bit integer instructions per word
// (threefry.cuh), whichever takes longer: the instructions, at the SM's
// dispatch rate.  Design: one thread per output word, native uint32
// arithmetic (the cipher is threefry.cuh's, shared with the in-kernel
// generators, its key schedule computed once per thread), grid-stride loop;
// consecutive threads write consecutive words, so the stores coalesce.  On
// the trainer's path it draws only rand-k's tags: the ternary and natural
// encodes generate their bits in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

// one == 1 (threefry.cuh: the cipher's adds as IMADs).
__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, uint32_t one,
                                     uint32_t* __restrict__ out, long long n) {
  const threefry::Schedule s = threefry::schedule(k0, k1, one);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = threefry::bits_word(s, (unsigned long long)i);
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
      k0, k1, 1u, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
