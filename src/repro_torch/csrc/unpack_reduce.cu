// Server-side decode of n 2-bit ternary payloads: the worker sum, with three
// epilogues (one source, one template).
//
// Replaces: src/repro/kernels/unpack_reduce.py:unpack_reduce (SUM),
// :unpack_reduce_mean (MEAN) and :unpack_reduce_apply (APPLY) (Pallas TPU).
// Plain versions: repro_torch/kernels/ref.py::ref_unpack_reduce,
// ref_unpack_reduce_mean, ref_unpack_reduce_apply.
//
//   s     = sum_i unpack(packed_i) * scale_i   (from 0.0f, in worker order)
//   SUM   -> out0 = s
//   MEAN  -> out0 = s / n
//   APPLY -> dm = s / n; out0 = ghat = h + dm; out1 = h' = fmaf(alpha, dm, h)
//
// The TPU kernel walks the workers in its sequential grid and revisits each
// output tile once per worker.  Here one thread block owns one block row;
// each thread owns the 4 coordinates of one code byte and loops the n
// workers in registers, so the sum is taken in worker order with no atomics:
// it is deterministic and bitwise the plain version.  The JAX reference
// contracts h + alpha * dm into an FMA under jit; the epilogue writes that
// FMA as fmaf and the file is built with -fmad=false, so nothing else
// contracts.
//
// Bound: bytes.  Per coordinate 0.25 B of codes per worker read, then
// SUM/MEAN write 4 B, APPLY reads 4 B of h and writes 8 B: (0.25 n + 12) B.
// Neighbouring threads own neighbouring bytes, so a warp reads 32 contiguous
// code bytes per worker and moves h and the outputs as 512 contiguous bytes
// (one float4 per thread).  h and out1 may alias (in-place memory update):
// each thread reads its h before it writes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

enum Epilogue { kSum = 0, kMean = 1, kApply = 2 };

template <int EPI>
__global__ void unpack_reduce_kernel(const uint8_t* __restrict__ packed,
                                     const float* __restrict__ scales, const float* h,
                                     float* out0, float* out1, int n, int bytes_per_row,
                                     float alpha) {
  const long long row = blockIdx.x;
  const long long m = gridDim.x;                       // one block per row
  const long long bytes = m * bytes_per_row;           // code bytes per worker
  for (int col = threadIdx.x; col < bytes_per_row; col += blockDim.x) {
    const long long j = row * bytes_per_row + col;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int i = 0; i < n; ++i) {
      const uint32_t c = packed[(long long)i * bytes + j];
      const float s = scales[(long long)i * m + row];
      a0 = a0 + (float)((int)(c & 3u) - 1) * s;
      a1 = a1 + (float)((int)((c >> 2) & 3u) - 1) * s;
      a2 = a2 + (float)((int)((c >> 4) & 3u) - 1) * s;
      a3 = a3 + (float)((int)((c >> 6) & 3u) - 1) * s;
    }
    float4* o0 = reinterpret_cast<float4*>(out0) + j;
    if (EPI == kSum) {
      *o0 = make_float4(a0, a1, a2, a3);
    } else {
      const float fn = (float)n;
      const float d0 = a0 / fn, d1 = a1 / fn, d2 = a2 / fn, d3 = a3 / fn;
      if (EPI == kMean) {
        *o0 = make_float4(d0, d1, d2, d3);
      } else {
        const float4 hv = reinterpret_cast<const float4*>(h)[j];
        *o0 = make_float4(hv.x + d0, hv.y + d1, hv.z + d2, hv.w + d3);
        reinterpret_cast<float4*>(out1)[j] =
            make_float4(fmaf(alpha, d0, hv.x), fmaf(alpha, d1, hv.y),
                        fmaf(alpha, d2, hv.z), fmaf(alpha, d3, hv.w));
      }
    }
  }
}

}  // namespace

// packed (n, m, B/4) u8, scales (n, m) f32, h/out0/out1 (m * B,) f32.
extern "C" int unpack_reduce(int epilogue, const void* packed, const void* scales,
                             const void* h, void* out0, void* out1, int n, long long m,
                             int B, float alpha, void* stream) {
  if (m <= 0) return 0;
  const int bytes_per_row = B / 4;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* p = (const uint8_t*)packed;
  const float* sc = (const float*)scales;
  const unsigned grid = (unsigned)m;
  if (epilogue == kSum) {
    unpack_reduce_kernel<kSum><<<grid, kThreads, 0, st>>>(
        p, sc, nullptr, (float*)out0, nullptr, n, bytes_per_row, alpha);
  } else if (epilogue == kMean) {
    unpack_reduce_kernel<kMean><<<grid, kThreads, 0, st>>>(
        p, sc, nullptr, (float*)out0, nullptr, n, bytes_per_row, alpha);
  } else if (epilogue == kApply) {
    unpack_reduce_kernel<kApply><<<grid, kThreads, 0, st>>>(
        p, sc, (const float*)h, (float*)out0, (float*)out1, n, bytes_per_row, alpha);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
