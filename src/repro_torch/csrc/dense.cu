// Dense (identity-operator) payload kernels: the compress-side copy of the f32
// values and the server-side worker sum, with the plain sum or the mean as the
// result (one template).
//
// Replaces: src/repro/kernels/dense.py:dense_copy (pallas_call :41),
// :dense_decode_sum (:79) and :dense_decode_sum_mean (:95) (Pallas TPU).
// Plain versions: repro_torch/kernels/ref.py::ref_dense_copy,
// ref_dense_decode_sum, ref_dense_decode_sum_mean.
//
//   COPY  out[j] = x[j]                                            j < d
//   SUM   out[j] = v_0[j] + v_1[j] + ... + v_{n-1}[j]               (in f32)
//   MEAN  out[j] = SUM[j] / n                                       (IEEE divide)
//
// The sum starts from worker 0's value, not from 0.0f, as the TPU kernel's
// accumulator does (dense.py:51-60): 0.0f + -0.0f would turn a -0.0 into
// +0.0.  The TPU kernel walks the workers in its sequential grid and
// revisits the (d,) accumulator once per worker; here each thread owns 4
// consecutive coordinates (one float4 per worker) and loops the n workers in
// registers, in worker order: deterministic, no atomics, bitwise the plain
// versions.  The mean divides once by n (true IEEE division: the same bits as
// s * (1/n) for n a power of two, within 1 ulp otherwise).
//
// Layout: rows of the (n, d) values sit ld elements apart (a gathered
// buffer's rows are padded to a multiple of 4 floats, so each starts 16-byte
// aligned).  The vector paths need 16-byte aligned rows and output; the copy
// peels up to 3 leading coordinates when x and out share their offset within
// 16 bytes.  Anything else takes the scalar path (one coordinate per thread).
// Built with -fmad=false, no fast math: subnormals are kept.
//
// Bound: bytes.  COPY reads 4 B and writes 4 B per coordinate; SUM / MEAN
// read 4 B per worker and write 4 B: (4 n + 4) B per coordinate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

unsigned blocks_for(long long work, bool capped) {
  long long b = (work + kThreads - 1) / kThreads;
  if (capped && b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned)(b < 1 ? 1 : b);
}

__global__ void copy_vec_kernel(const float* __restrict__ x, float* __restrict__ out,
                                long long d, long long head, long long groups) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    reinterpret_cast<float4*>(out + head)[g] = reinterpret_cast<const float4*>(x + head)[g];
  }
  // The peeled head [0, head) and the tail [head + 4 * groups, d): <= 3 each.
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long j = threadIdx.x < 4 ? threadIdx.x : head + 4 * groups + threadIdx.x - 4;
    if (threadIdx.x < 4 ? j < head : j < d) out[j] = x[j];
  }
}

__global__ void copy_scalar_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   long long d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    out[j] = x[j];
  }
}

template <bool kMean>
__device__ __forceinline__ float finish(float s, float fn) {
  return kMean ? s / fn : s;
}

template <bool kMean>
__global__ void sum_vec_kernel(const float* __restrict__ v, long long ld, int n, long long d,
                               float* __restrict__ out) {
  const long long groups = d / 4;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float fn = (float)n;
  if (g < groups) {
    const long long j = 4 * g;
    float4 s = *reinterpret_cast<const float4*>(v + j);
#pragma unroll 4
    for (int i = 1; i < n; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(v + (long long)i * ld + j);
      s.x = s.x + w.x; s.y = s.y + w.y; s.z = s.z + w.z; s.w = s.w + w.w;
    }
    *reinterpret_cast<float4*>(out + j) = make_float4(
        finish<kMean>(s.x, fn), finish<kMean>(s.y, fn), finish<kMean>(s.z, fn),
        finish<kMean>(s.w, fn));
  }
  // The tail [4 * groups, d): at most 3 coordinates.
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const long long j = 4 * groups + threadIdx.x;
    if (j < d) {
      float s = v[j];
      for (int i = 1; i < n; ++i) s = s + v[(long long)i * ld + j];
      out[j] = finish<kMean>(s, fn);
    }
  }
}

template <bool kMean>
__global__ void sum_scalar_kernel(const float* __restrict__ v, long long ld, int n, long long d,
                                  float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    float s = v[j];
    for (int i = 1; i < n; ++i) s = s + v[(long long)i * ld + j];
    out[j] = finish<kMean>(s, fn);
  }
}

template <bool kMean>
int launch_sum(const float* v, long long ld, int n, long long d, float* out, cudaStream_t st) {
  const bool vec = (uintptr_t)v % 16 == 0 && (n == 1 || ld % 4 == 0) && (uintptr_t)out % 16 == 0;
  if (vec) {
    sum_vec_kernel<kMean><<<blocks_for(d / 4, false), kThreads, 0, st>>>(v, ld, n, d, out);
  } else {
    sum_scalar_kernel<kMean><<<blocks_for(d, true), kThreads, 0, st>>>(v, ld, n, d, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (d,) f32 -> out (d,) f32.
extern "C" int dense_copy(const void* x, void* out, long long d, void* stream) {
  if (d <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t xa = (uintptr_t)x, oa = (uintptr_t)out;
  if (xa % 16 == oa % 16 && xa % 4 == 0) {
    long long head = (long long)((16 - xa % 16) % 16) / 4;
    if (head > d) head = d;
    const long long groups = (d - head) / 4;
    copy_vec_kernel<<<blocks_for(groups, false), kThreads, 0, st>>>(
        (const float*)x, (float*)out, d, head, groups);
  } else {
    copy_scalar_kernel<<<blocks_for(d, true), kThreads, 0, st>>>((const float*)x, (float*)out,
                                                                  d);
  }
  return (int)cudaGetLastError();
}

// values (n, d) f32 with rows ld elements apart -> out (d,) f32: the worker
// sum (mean = 0) or the mean (mean = 1).
extern "C" int dense_decode(int mean, const void* values, long long ld, int n, long long d,
                            void* out, void* stream) {
  if (d <= 0 || n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mean == 0) return launch_sum<false>((const float*)values, ld, n, d, (float*)out, st);
  if (mean == 1) return launch_sum<true>((const float*)values, ld, n, d, (float*)out, st);
  return (int)cudaErrorInvalidValue;
}
