// Sparse (rand-k / top-k) payload kernels: the compress-side value gather and
// the server-side scatter-add decode over n workers, with the plain sum or the
// mean as the result.
//
// Replaces: src/repro/kernels/sparse.py:sparse_gather (pallas_call :65),
// :sparse_decode_sum (:131) and :sparse_decode_sum_mean (:157) (Pallas TPU).
// Plain versions: repro_torch/kernels/ref.py::ref_sparse_gather,
// ref_sparse_decode_sum, ref_sparse_decode_sum_mean.
//
//   GATHER  out[j] = x[idx[j]]                                  j < k
//   DECODE  out = 0;  for i in 0..n-1 (in order):  out[idx_i[j]] += v_i[j] * s[j]
//   MEAN    DECODE, then out[j] = out[j] / n                    j < d
//
// Indices are the payload's unsigned wire words (uint8 / uint16 / uint32, by
// the vector length, as the JAX package carries them), read as they are.
// They are unique within a worker (a k-subset), so one scatter launch has no
// write conflict and needs no atomics; the workers go one launch each, in
// worker order, so each coordinate sums in the reference's order.  (atomicAdd
// across workers in one launch would sum in an order that changes from run
// to run.)  Indices must be < d: the gather clamps and the scatter drops
// anything else so no launch touches memory outside its tensors.
//
// Why zero-fill + in-order scatter is bitwise the reference's
// row_0 + row_1 + ... + row_{n-1}, with row_i = zeros(d).at[idx_i].add(v_i*s):
//   * a row holds 0.0 + v*s at a kept coordinate, which turns a -0.0 product
//     into +0.0; so no row, and no sum of rows, ever holds -0.0 (under
//     round-to-nearest x + y is -0.0 only if both are -0.0);
//   * adding the +0.0 of a coordinate a worker did not keep is therefore the
//     identity, and adding v*s instead of 0.0 + v*s differs only when v*s is
//     -0.0, where acc + -0.0 == acc + +0.0 == acc for every acc != -0.0;
//   * so the scatter chain from a zero-filled vector gives the reference's
//     bits at every coordinate: signed zeros, +-inf, NaN and subnormals
//     included (no fast math: -fmad=false keeps v*s and the add two IEEE
//     roundings, and subnormals are not flushed).
// The JAX kernel starts each worker's row from zeros inside its body, so the
// zero-fill is part of this kernel's work, not a library memset.
//
// The TPU kernel keeps the (d,) accumulator in VMEM across its sequential
// worker grid.  Here d is ~1e9 and blocks run in parallel, so the accumulator
// lives in device memory: one fill launch, n scatter launches (one thread per
// kept entry, grid-stride) and, for the mean, one divide launch.
//
// Bound: bytes.  GATHER reads 4 B of index and 4 B of x per entry and writes
// 4 B (a random x read fetches a 32-byte sector).  DECODE writes 4 B per
// coordinate for the fill and per entry reads index, value and scale (12 B),
// with a random read-modify-write of the output; MEAN adds a read and write
// of the (d,) output.  All offsets are 64-bit: (n, Dp) is ~4e9 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename I>
__global__ void gather_kernel(const float* __restrict__ x, long long d,
                              const I* __restrict__ idx, long long k,
                              float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < k; j += stride) {
    long long i = (long long)idx[j];
    if (i >= d) i = d - 1;
    out[j] = x[i];
  }
}

// out[j] = +0.0f (the fill) or out[j] / fn (the mean's IEEE divide) for
// j < d: float4 accesses over the 16-byte aligned body, scalar head and tail.
template <bool kDivide>
__global__ void elementwise_kernel(float* __restrict__ out, long long d, float fn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long head = (long long)(((16 - (uintptr_t)out % 16) % 16) / 4);
  const long long h = head < d ? head : d;
  const long long q = (d - h) / 4;
  float4* o4 = reinterpret_cast<float4*>(out + h);
  for (long long t = t0; t < q; t += stride) {
    if (kDivide) {
      const float4 v = o4[t];
      o4[t] = make_float4(v.x / fn, v.y / fn, v.z / fn, v.w / fn);
    } else {
      o4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (long long t = t0; t < h; t += stride) out[t] = kDivide ? out[t] / fn : 0.f;
  for (long long t = h + 4 * q + t0; t < d; t += stride) out[t] = kDivide ? out[t] / fn : 0.f;
}

template <typename I>
__global__ void scatter_add_kernel(const I* __restrict__ idx, const float* __restrict__ v,
                                   const float* __restrict__ s, long long k, long long d,
                                   float* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < k; j += stride) {
    const long long i = (long long)idx[j];
    if (i < d) out[i] = out[i] + v[j] * s[j];
  }
}

template <typename I>
int gather(const float* x, long long d, const void* idx, long long k, float* out,
           cudaStream_t st) {
  gather_kernel<I><<<blocks_for(k), kThreads, 0, st>>>(x, d, (const I*)idx, k, out);
  return (int)cudaGetLastError();
}

template <typename I>
int decode(int mean, int n, const void* idx, long long idx_ld, const float* values,
           long long val_ld, const float* scale, long long k, long long d, float* out,
           cudaStream_t st) {
  elementwise_kernel<false><<<blocks_for(d / 4 + 4), kThreads, 0, st>>>(out, d, 1.f);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  for (int i = 0; i < n && k > 0; ++i) {
    scatter_add_kernel<I><<<blocks_for(k), kThreads, 0, st>>>(
        (const I*)idx + (long long)i * idx_ld, values + (long long)i * val_ld, scale, k, d,
        out);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if (mean) {
    elementwise_kernel<true><<<blocks_for(d / 4 + 4), kThreads, 0, st>>>(out, d, (float)n);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

}  // namespace

// x (d,) f32; idx (k,) unsigned words of idx_bytes each; out (k,) f32.
extern "C" int sparse_gather(const void* x, long long d, const void* idx, int idx_bytes,
                             long long k, void* out, void* stream) {
  if (k <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (idx_bytes) {
    case 1: return gather<uint8_t>(xf, d, idx, k, o, st);
    case 2: return gather<uint16_t>(xf, d, idx, k, o, st);
    case 4: return gather<uint32_t>(xf, d, idx, k, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

// idx / values (n, k) with rows idx_ld / val_ld elements apart; scale (k,)
// f32; out (d,) f32.  mean != 0 divides the sum by n.
extern "C" int sparse_decode(int mean, int n, const void* idx, long long idx_ld, int idx_bytes,
                             const void* values, long long val_ld, const void* scale,
                             long long k, long long d, void* out, void* stream) {
  if (d <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const float* v = (const float*)values;
  const float* s = (const float*)scale;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (idx_bytes) {
    case 1: return decode<uint8_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, st);
    case 2: return decode<uint16_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, st);
    case 4: return decode<uint32_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, st);
  }
  return (int)cudaErrorInvalidValue;
}
