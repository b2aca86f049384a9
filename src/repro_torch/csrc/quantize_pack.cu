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
// Bound: with pre-drawn bits, bytes: ~8.25 B per coordinate (4 B delta +
// 4 B bits read once, 0.25 B of codes written).  With the generator, 4.25 B
// per coordinate and the cipher's 68 integer instructions per coordinate
// (threefry.cuh), which take longer at the SM's dispatch rate than the bytes
// at the HBM rate: the kernel is bound by the cipher, and its memory pass
// has to hide under it.
//
// Design: one warp per row, a grid of 512-thread blocks sized to the SMs'
// resident warps walking the rows, no block-wide barrier; lane l owns the
// row's float4 groups i*32 + l (the warp's loads and stores coalesce).  B is
// any multiple of 4: where B/4 is not a multiple of 32 (the kTail kernels)
// the lanes below (B/4) % 32 own one group more, the row's tail, last in
// their order (for B < 128 only those lanes own a group; the others hold 0,
// which changes no sum or max).  The convex harness's blocks of 8-64 take
// that path: a row of 2-16 groups on 32 lanes, where the launch is the
// cost; a B that is a multiple of 128 runs the kernels without the tail.
// Pass 1 loads the lane's groups, 8 float4 in flight, and reduces the norm:
// the lane's values in order, then a butterfly of shuffles, whose result
// every lane holds bitwise (p = inf is a max, equal to the plain version
// bitwise; the pre-drawn and PRNG variants share the row body, so they
// agree bitwise at every p).  Pass 2 walks the groups, kGroups at a time,
// and codes them.  The PRNG variant re-reads each pair of groups (from L1,
// where pass 1 left them), draws their 8 words as 8 independent cipher
// chains and codes; where the row's counters share their high word (always
// for a power-of-two B, which divides 2^32) the counters are 32-bit adds
// off the row's base, else each word takes a 64-bit counter (a loop of its
// own, so the common one carries no branch).  Both loops are rolled, so the
// hot code fits the instruction cache (a row of 64 words per lane held in
// registers, fully unrolled, does not) and few registers leave room for 16
// warps per SM: while some wait on their rows' loads, the others' ciphers
// run, and the memory pass hides under the cipher.  The pre-drawn variant,
// whose pass 2 waits on its bits, stages the row in shared memory in pass
// 1, turns it into the signed ratios copysign(|x| / scale, x) in a pass of
// its own and then streams the bits 8 groups at a time against them (where
// the stage fits: B <= 3584).  The blocks are of 512 threads: on an H100
// they ran the PRNG variant faster than 128-thread blocks with as many warps
// per SM (the rows one SM walks then lie together).
//
// Numerics: built with -fmad=false and IEEE division / sqrt (no fast math),
// so |x| / scale and the sums round as the plain version's do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;           // 16 warps, one row each
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;               // float4 per lane in flight in pass 1
constexpr int kMaxStage = 232448;       // shared memory a block can have (227 KB)

enum NormKind { kInf = 0, kOne = 1, kTwo = 2, kGeneral = 3 };

__device__ __forceinline__ float combine(float a, float b, int kind) {
  return kind == kInf ? fmaxf(a, b) : a + b;
}

template <int kKind>
__device__ __forceinline__ float term(float x, float p) {
  const float a = fabsf(x);
  if (kKind == kInf || kKind == kOne) return a;
  if (kKind == kTwo) return x * x;
  return powf(a, p);
}

template <int kKind>
__device__ __forceinline__ float accumulate(float acc, float4 v, float p) {
  acc = combine(acc, term<kKind>(v.x, p), kKind);
  acc = combine(acc, term<kKind>(v.y, p), kKind);
  acc = combine(acc, term<kKind>(v.z, p), kKind);
  return combine(acc, term<kKind>(v.w, p), kKind);
}

// The lane's part of the norm over its G groups x4[32 i], in order, kLoads
// loads in flight at a time; each group also copied to stage where given.
template <int kKind>
__device__ __forceinline__ float lane_partial(const float4* x4, float4* stage, int G,
                                              float p) {
  float acc = 0.0f;
  for (int i0 = 0; i0 < G; i0 += kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (i0 + k < G) v[k] = x4[32 * (i0 + k)];
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (i0 + k < G) {
        acc = accumulate<kKind>(acc, v[k], p);
        if (stage) stage[32 * (i0 + k)] = v[k];
      }
    }
  }
  return acc;
}

// The warp's norm from each lane's partial: a butterfly (every lane ends with
// the same bits: each step combines the same two values, in either order),
// then the root for p = 2 and general p.
__device__ __forceinline__ float row_scale(float acc, int kind, float inv_p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc = combine(acc, __shfl_xor_sync(0xffffffffu, acc, o), kind);
  }
  return kind == kTwo ? sqrtf(acc) : (kind == kGeneral ? powf(acc, inv_p) : acc);
}

// The code of x: sign(x) + 1 where u = (r >> 8) 2^-24 < |x| / safe, else 1.
// A kept x has |x| / safe > u >= 0, so it is neither zero nor NaN and its
// sign bit is sign(x): 0 for a negative x, 2 for a positive one.
__device__ __forceinline__ uint32_t code(float x, uint32_t r, float safe) {
  const float u = (float)(r >> 8) * (1.0f / 16777216.0f);
  return u < fabsf(x) / safe ? ((__float_as_uint(x) >> 30) & 2u) ^ 2u : 1u;
}

// The same rule from the signed ratio q = copysign(|x| / safe, x).
__device__ __forceinline__ uint32_t ratio_code(float q, uint32_t r) {
  const float u = (float)(r >> 8) * (1.0f / 16777216.0f);
  return u < fabsf(q) ? ((__float_as_uint(q) >> 30) & 2u) ^ 2u : 1u;
}

__device__ __forceinline__ uint8_t pack4(float4 v, uint4 r, float safe) {
  return (uint8_t)(code(v.x, r.x, safe) | (code(v.y, r.y, safe) << 2) |
                   (code(v.z, r.z, safe) << 4) | (code(v.w, r.w, safe) << 6));
}

__device__ __forceinline__ uint8_t pack_ratios(float4 q, uint4 r) {
  return (uint8_t)(ratio_code(q.x, r.x) | (ratio_code(q.y, r.y) << 2) |
                   (ratio_code(q.z, r.z) << 4) | (ratio_code(q.w, r.w) << 6));
}

// The bits of a row's groups i*32 + lane (4 consecutive coordinates each):
// a pre-drawn (m, B) operand, or threefry words of the row's segment.
struct PredrawnBits {
  static constexpr int kGroups = 8;     // groups per step of pass 2
  static constexpr bool kCounters = false;
  const uint32_t* bits;
  struct Row {
    const uint4* r4;  // the lane's first group
    template <int N, bool kSameHi>
    __device__ __forceinline__ void draw(int i, uint4 (&r)[N]) const {
#pragma unroll
      for (int k = 0; k < N; ++k) r[k] = __ldcs(r4 + 32 * (i + k));
    }
  };
  __device__ __forceinline__ Row row(long long row, int B, int lane) const {
    return {reinterpret_cast<const uint4*>(bits + row * B) + lane};
  }
};

struct ThreefryBits {
  static constexpr int kGroups = 2;
  static constexpr bool kCounters = true;
  const threefry::KeyTable* table;
  struct Row {
    threefry::Schedule s;
    unsigned long long base;  // the lane's first counter within its segment
    bool same_hi;             // the row's counters share their high word
    // Words of groups i .. i + N - 1: counters base + 128 (i + k) + q.
    template <int N, bool kSameHi>
    __device__ __forceinline__ void draw(int i, uint4 (&r)[N]) const {
      const unsigned long long j = base + 128ull * (unsigned)i;
      uint32_t w[4 * N];
      if constexpr (kSameHi) {
#pragma unroll
        for (int q = 0; q < 4 * N; ++q) w[q] = (uint32_t)j + 128u * (q / 4) + q % 4;
        threefry::words<4 * N>(s, (uint32_t)(j >> 32), w);
      } else {
#pragma unroll
        for (int q = 0; q < 4 * N; ++q) w[q] = threefry::bits_word(s, j + 128u * (q / 4) + q % 4);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        r[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      }
    }
  };
  __device__ __forceinline__ Row row(long long row, int B, int lane) const {
    const int seg = threefry::segment_of(*table, row);
    const unsigned long long first = (unsigned long long)(row - table->start[seg]) * (unsigned)B;
    return {threefry::schedule_of(*table, seg), first + 4u * (unsigned)lane,
            (uint32_t)first <= 0xFFFFFFFFu - (uint32_t)(B - 1)};
  }
};

// N groups from i: the values (or signed ratios, kStaged) from src, their
// bits, their codes.
template <int N, bool kSameHi, bool kStaged, class Row>
__device__ __forceinline__ void code_step(const float4* src, const Row& rb, uint8_t* out, int i,
                                          float safe) {
  float4 v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = src[32 * (i + k)];
  uint4 r[N];
  rb.template draw<N, kSameHi>(i, r);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    out[32 * (i + k)] = kStaged ? pack_ratios(v[k], r[k]) : pack4(v[k], r[k], safe);
  }
}

template <int N, bool kSameHi, bool kStaged, class Row>
__device__ __forceinline__ void code_groups(const float4* src, const Row& rb, uint8_t* out,
                                            int G, float safe) {
  int i = 0;
#pragma unroll 1
  for (; i + N <= G; i += N) code_step<N, kSameHi, kStaged>(src, rb, out, i, safe);
#pragma unroll 1
  for (; i < G; ++i) code_step<1, kSameHi, kStaged>(src, rb, out, i, safe);
}

// One row: pass 1 the norm (and the stage), pass 2 the bits and the codes.
template <class Bits, bool kStaged, bool kTail>
__device__ __forceinline__ void quantize_row(const float* __restrict__ delta, const Bits& bits,
                                             uint8_t* __restrict__ packed,
                                             float* __restrict__ scales, long long row, int B,
                                             int kind, float p, float inv_p, int lane,
                                             float4* stage) {
  const int G = B / 128 + (kTail && lane < (B / 4) % 32);  // this lane's groups
  const float4* x4 = reinterpret_cast<const float4*>(delta + row * B) + lane;
  float acc;
  switch (kind) {
    case kInf: acc = lane_partial<kInf>(x4, stage, G, p); break;
    case kOne: acc = lane_partial<kOne>(x4, stage, G, p); break;
    case kTwo: acc = lane_partial<kTwo>(x4, stage, G, p); break;
    default: acc = lane_partial<kGeneral>(x4, stage, G, p); break;
  }
  const float scale = row_scale(acc, kind, inv_p);
  const float safe = scale > 0.0f ? scale : 1.0f;
  if (kStaged) {
#pragma unroll 4
    for (int i = 0; i < G; ++i) {
      const float4 v = stage[32 * i];
      stage[32 * i] = make_float4(copysignf(fabsf(v.x) / safe, v.x),
                                  copysignf(fabsf(v.y) / safe, v.y),
                                  copysignf(fabsf(v.z) / safe, v.z),
                                  copysignf(fabsf(v.w) / safe, v.w));
    }
  }
  const float4* src = kStaged ? stage : x4;
  const typename Bits::Row rb = bits.row(row, B, lane);
  uint8_t* out = packed + row * (B / 4) + lane;
  if constexpr (Bits::kCounters) {
    if (!rb.same_hi) {
      code_groups<Bits::kGroups, false, kStaged>(src, rb, out, G, safe);
      if (lane == 0) scales[row] = scale;
      return;
    }
  }
  code_groups<Bits::kGroups, true, kStaged>(src, rb, out, G, safe);
  if (lane == 0) scales[row] = scale;
}

template <class Bits, bool kStaged, bool kTail>
__device__ __forceinline__ void quantize_rows(const float* __restrict__ delta, const Bits& bits,
                                              uint8_t* __restrict__ packed,
                                              float* __restrict__ scales, long long m, int B,
                                              int kind, float p, float inv_p) {
  extern __shared__ float4 stage_rows[];  // kWarps rows of B floats (kStaged)
  const int lane = threadIdx.x & 31;
  float4* stage = kStaged ? stage_rows + (threadIdx.x >> 5) * (B / 4) + lane : nullptr;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += warps) {
    quantize_row<Bits, kStaged, kTail>(delta, bits, packed, scales, row, B, kind, p, inv_p,
                                       lane, stage);
  }
}

template <bool kStaged, bool kTail>
__global__ void __launch_bounds__(kThreads)
    quantize_pack_kernel(const float* __restrict__ delta, const uint32_t* __restrict__ bits,
                         uint8_t* __restrict__ packed, float* __restrict__ scales, long long m,
                         int B, int kind, float p, float inv_p) {
  quantize_rows<PredrawnBits, kStaged, kTail>(delta, PredrawnBits{bits}, packed, scales, m, B,
                                              kind, p, inv_p);
}

template <bool kTail>
__global__ void __launch_bounds__(kThreads)
    quantize_pack_prng_kernel(const float* __restrict__ delta, uint8_t* __restrict__ packed,
                              float* __restrict__ scales, long long m, int B, int kind,
                              float p, float inv_p,
                              const __grid_constant__ threefry::KeyTable table) {
  quantize_rows<ThreefryBits, false, kTail>(delta, ThreefryBits{&table}, packed, scales, m, B,
                                            kind, p, inv_p);
}

// The grid: one warp per row, at most as many warps as the SMs hold at once
// with smem bytes of dynamic shared memory per block.
template <class Kernel>
int grid_for(Kernel kernel, long long m, int smem, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (rc != cudaSuccess) return (int)rc;
  const long long need = (m + kWarps - 1) / kWarps;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (unsigned)(need < most ? need : most);
  return 0;
}

}  // namespace

// delta (m, B) f32, bits (m, B) uint32 -> packed (m, B/4) u8, scales (m,) f32.
extern "C" int quantize_pack(const void* delta, const void* bits, void* packed, void* scales,
                             long long m, int B, int kind, float p, float inv_p,
                             void* stream) {
  if (m <= 0) return 0;
  // Stage the rows in shared memory where they fit.
  const long long stage = (long long)kWarps * B * sizeof(float);
  const bool staged = stage <= kMaxStage;
  const int smem = staged ? (int)stage : 0;
  auto* kernel = B % 128 ? (staged ? quantize_pack_kernel<true, true>
                                   : quantize_pack_kernel<false, true>)
                         : (staged ? quantize_pack_kernel<true, false>
                                   : quantize_pack_kernel<false, false>);
  unsigned blocks = 0;
  if (int rc = grid_for(kernel, m, smem, &blocks)) return rc;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)delta, (const uint32_t*)bits, (uint8_t*)packed, (float*)scales, m, B, kind,
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
  auto* kernel = B % 128 ? quantize_pack_prng_kernel<true> : quantize_pack_prng_kernel<false>;
  unsigned blocks = 0;
  if (int rc = grid_for(kernel, m, 0, &blocks)) return rc;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)delta, (uint8_t*)packed, (float*)scales, m, B, kind, p, inv_p, table);
  return (int)cudaGetLastError();
}
