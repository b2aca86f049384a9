// Server-side decode of n natural-compression payloads: the worker sum, with
// three epilogues (one source, one template), as unpack_reduce.cu does for the
// ternary family.
//
// Replaces: src/repro/kernels/nat_pack.py:nat_decode_sum (SUM, pallas_call
// :228), :nat_decode_sum_mean (MEAN, :250) and :nat_decode_sum_apply (APPLY,
// :283) (Pallas TPU).  Plain versions: repro_torch/kernels/ref.py::
// ref_nat_decode_sum, ref_nat_decode_sum_mean, ref_nat_decode_sum_apply.
//
//   s     = dec(codes_0) + dec(codes_1) + ... + dec(codes_{n-1})   (in f32)
//   SUM   -> out0 = s
//   MEAN  -> out0 = s / n
//   APPLY -> dm = s / n; out0 = ghat = h + dm; out1 = h' = fmaf(alpha, dm, h)
//
// dec(c) = sign(c) * 2^(|c| - 160) is built from its bits, not with exp2f:
// k >= -126 gives the normal (k + 127) << 23, -149 <= k < -126 the subnormal
// 1 << (k + 149), smaller k zero and k >= 128 infinity; the code's sign goes
// on the result, so a negative code below 2^-149 decodes to -0.0.  That is why
// the sum starts from worker 0's decode and not from 0.0f (0.0f + -0.0f would
// lose the sign), the reverse of the ternary kernels.
//
// The TPU kernel walks the workers in its sequential grid and revisits each
// output tile once per worker.  Here each thread owns 8 consecutive
// coordinates (one 16-byte load of codes per worker, two float4 stores) and
// loops the n workers in registers, in worker order: deterministic, no
// atomics, bitwise the plain version.  Rows of the (n, d) codes sit ld
// elements apart; the vector path needs 16-byte aligned rows (ld % 8 == 0)
// and 16-byte aligned h and outputs, and anything else takes the scalar path
// (one coordinate per thread).  h and out1 may alias: each thread reads its h
// before it writes.  Built with -fmad=false; the one FMA is written as fmaf.
//
// Bound: bytes.  Per coordinate 2 B of codes per worker read, then SUM/MEAN
// write 4 B; APPLY reads 4 B of h and writes 8 B: (2 n + 4) or (2 n + 12) B.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBias = 160;

enum Epilogue { kSum = 0, kMean = 1, kApply = 2 };

__device__ __forceinline__ float nat_dec(int c) {
  const int k = (c < 0 ? -c : c) - kBias;
  uint32_t b;
  if (k >= 128) {
    b = 0x7F800000u;
  } else if (k >= -126) {
    b = (uint32_t)(k + 127) << 23;
  } else if (k >= -149) {
    b = 1u << (k + 149);
  } else {
    b = 0u;
  }
  return __uint_as_float(c < 0 ? (b | 0x80000000u) : b);
}

// The 8 int16 codes of one 16-byte load, in memory order (little-endian).
__device__ __forceinline__ void codes8(const int16_t* p, int c[8]) {
  const int4 w = *reinterpret_cast<const int4*>(p);
  const int v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c[2 * q] = (int)(int16_t)(v[q] & 0xFFFF);
    c[2 * q + 1] = v[q] >> 16;  // arithmetic shift: the high code's sign
  }
}

template <int EPI>
__device__ __forceinline__ void epilogue(float s, float fn, float alpha, const float* h,
                                         float* out0, float* out1, long long j) {
  if (EPI == kSum) {
    out0[j] = s;
  } else {
    const float dm = s / fn;
    if (EPI == kMean) {
      out0[j] = dm;
    } else {
      const float hv = h[j];
      out0[j] = hv + dm;
      out1[j] = fmaf(alpha, dm, hv);
    }
  }
}

template <int EPI>
__device__ void one_coordinate(const int16_t* codes, long long ld, int n, const float* h,
                               float* out0, float* out1, float alpha, long long j) {
  float s = nat_dec(codes[j]);
  for (int i = 1; i < n; ++i) s = s + nat_dec(codes[(long long)i * ld + j]);
  epilogue<EPI>(s, (float)n, alpha, h, out0, out1, j);
}

template <int EPI>
__global__ void nat_decode_vec_kernel(const int16_t* __restrict__ codes, long long ld, int n,
                                      long long d, const float* h, float* out0, float* out1,
                                      float alpha) {
  const long long groups = d / 8;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    const long long j = 8 * g;
    float s[8];
    int c[8];
    codes8(codes + j, c);
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = nat_dec(c[e]);
    for (int i = 1; i < n; ++i) {
      codes8(codes + (long long)i * ld + j, c);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = s[e] + nat_dec(c[e]);
    }
    float4* o0 = reinterpret_cast<float4*>(out0 + j);
    if (EPI == kSum) {
      o0[0] = make_float4(s[0], s[1], s[2], s[3]);
      o0[1] = make_float4(s[4], s[5], s[6], s[7]);
    } else {
      const float fn = (float)n;
      float dm[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) dm[e] = s[e] / fn;
      if (EPI == kMean) {
        o0[0] = make_float4(dm[0], dm[1], dm[2], dm[3]);
        o0[1] = make_float4(dm[4], dm[5], dm[6], dm[7]);
      } else {
        const float4 h0 = reinterpret_cast<const float4*>(h + j)[0];
        const float4 h1 = reinterpret_cast<const float4*>(h + j)[1];
        float4* o1 = reinterpret_cast<float4*>(out1 + j);
        o0[0] = make_float4(h0.x + dm[0], h0.y + dm[1], h0.z + dm[2], h0.w + dm[3]);
        o0[1] = make_float4(h1.x + dm[4], h1.y + dm[5], h1.z + dm[6], h1.w + dm[7]);
        o1[0] = make_float4(fmaf(alpha, dm[0], h0.x), fmaf(alpha, dm[1], h0.y),
                            fmaf(alpha, dm[2], h0.z), fmaf(alpha, dm[3], h0.w));
        o1[1] = make_float4(fmaf(alpha, dm[4], h1.x), fmaf(alpha, dm[5], h1.y),
                            fmaf(alpha, dm[6], h1.z), fmaf(alpha, dm[7], h1.w));
      }
    }
  }
  // The tail [8 * groups, d): at most 7 coordinates.
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long j = 8 * groups + threadIdx.x;
    if (j < d) one_coordinate<EPI>(codes, ld, n, h, out0, out1, alpha, j);
  }
}

template <int EPI>
__global__ void nat_decode_scalar_kernel(const int16_t* __restrict__ codes, long long ld,
                                         int n, long long d, const float* h, float* out0,
                                         float* out1, float alpha) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d; j += stride) {
    one_coordinate<EPI>(codes, ld, n, h, out0, out1, alpha, j);
  }
}

template <int EPI>
int launch(const int16_t* codes, long long ld, int n, long long d, const float* h,
           float* out0, float* out1, float alpha, cudaStream_t st) {
  const bool vec = (uintptr_t)codes % 16 == 0 && ld % 8 == 0 && (uintptr_t)out0 % 16 == 0 &&
                   (EPI != kApply || ((uintptr_t)h % 16 == 0 && (uintptr_t)out1 % 16 == 0));
  if (vec) {
    long long b = (d / 8 + kThreads - 1) / kThreads;
    nat_decode_vec_kernel<EPI><<<(unsigned)(b < 1 ? 1 : b), kThreads, 0, st>>>(
        codes, ld, n, d, h, out0, out1, alpha);
  } else {
    long long b = (d + kThreads - 1) / kThreads;
    if (b > 132LL * 64) b = 132LL * 64;
    nat_decode_scalar_kernel<EPI><<<(unsigned)b, kThreads, 0, st>>>(codes, ld, n, d, h, out0,
                                                                     out1, alpha);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// codes (n, d) int16 with rows ld elements apart; h / out0 / out1 (d,) f32.
extern "C" int nat_decode(int epilogue, const void* codes, long long ld, int n, long long d,
                          const void* h, void* out0, void* out1, float alpha, void* stream) {
  if (d <= 0 || n <= 0) return 0;
  const int16_t* c = (const int16_t*)codes;
  cudaStream_t st = (cudaStream_t)stream;
  if (epilogue == kSum) {
    return launch<kSum>(c, ld, n, d, nullptr, (float*)out0, nullptr, alpha, st);
  } else if (epilogue == kMean) {
    return launch<kMean>(c, ld, n, d, nullptr, (float*)out0, nullptr, alpha, st);
  } else if (epilogue == kApply) {
    return launch<kApply>(c, ld, n, d, (const float*)h, (float*)out0, (float*)out1, alpha,
                          st);
  }
  return (int)cudaErrorInvalidValue;
}
