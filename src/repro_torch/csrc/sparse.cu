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
// They are unique within a worker (a k-subset).  Indices must be < d: the
// gather clamps and the decode drops anything else so no launch touches
// memory outside its tensors.
//
// GATHER.  A random 4-byte read of x fetches a 32-byte sector somewhere in a
// vector of up to 4 GB, so the gather runs at the card's rate of random
// reads, not at its byte rate.  Each thread takes 8 consecutive entries:
// its indices in one or two vector loads (after a scalar head that aligns
// the index row; rows of a gathered payload start w * k elements apart),
// then all 8 x loads issued before any store, read-only and not allocated
// in L1, then the 8 values as two float4 streaming stores where the output
// is 16-byte aligned (scalar stores otherwise).  One thread per 8 entries:
// no grid-stride cap, every SM at full occupancy.
//
// DECODE.  The TPU kernel keeps the (d,) accumulator in VMEM across its
// sequential worker grid.  Here the accumulator lives in shared memory, one
// tile of T = 16384 floats per block (64 KB), and each kept
// entry is first sorted into the run of its (tile, worker), in two levels so
// that no global counter takes more than one atomic per block (one global
// counter per (tile, worker), hit once per entry, serialises: rand-k's small
// leaves send thousands of concurrent entries to a few tiles; PERF.md).
// Coarse bins are S = 2^19 floats, ceil(d / S) of them (at most 8192:
// d <= 2^32, the widest index word):
//   a. count:  each block counts the entries of its chunk per coarse bin in
//              shared memory, then adds each non-zero count to the bin's
//              global counter (integer atomics: order does not matter);
//   b. scan:   cursors = exclusive prefix sum of the bins' counts; each bin's
//              run is cut into chunks of kChunk records, and the chunks are
//              numbered across the bins (a chunk's bin in a table);
//   c. bin:    each block ranks its entries per bin with shared-memory
//              atomics, reserves one range per bin with one atomic on the
//              bin's cursor, sorts its records (w << log2 S | i mod S, v * s)
//              by bin in shared memory and writes each bin's piece
//              contiguously (after this pass a bin's cursor holds its run's
//              end; the start is end - count);
//   d. sort, in three launches, one block per chunk or per bin, so that a
//      bin that holds many entries (top-k follows the gradient: one bin of
//      the llama3.2-1b bucket held 87x the mean; PERF.md) is spread over
//      as many blocks as it has chunks:
//      d1. each chunk counts its records per (tile, worker) in shared
//          memory and adds each non-zero count to the fine run's global
//          count (integer atomics);
//      d2. one block per bin scans its fine runs' counts in tile-major
//          worker-minor order from the bin's start: each fine run's start,
//          also its cursor;
//      d3. each chunk ranks its records per fine run in shared memory,
//          reserves one range per run with one atomic on the run's cursor,
//          sorts its records (i mod T, v * s) by run in shared memory and
//          writes each run's piece contiguously;
//   e. tile:   one block per tile zeroes T floats of shared memory, applies
//              fine run (tile, 0), then (tile, 1), ..., with __syncthreads()
//              between workers, and writes the tile out once with float4
//              stores (for the mean, each value divided by n on the way).
// Inside one fine run the order of the records is whatever the atomics of
// passes c and d3 gave, but a worker's indices are unique, so no two records of a run touch
// the same coordinate: the result does not depend on that order.  The
// worker order of every coordinate's sum is enforced by pass e's
// __syncthreads() between runs.  Each output coordinate is written once;
// every entry costs two 8-byte records written and read, sequential in a
// run, instead of a random read-modify-write of a sector in device memory.
//
// Why +0.0 start + in-order accumulation is bitwise the reference's
// row_0 + row_1 + ... + row_{n-1}, with row_i = zeros(d).at[idx_i].add(v_i*s):
//   * a row holds 0.0 + v*s at a kept coordinate, which turns a -0.0 product
//     into +0.0; so no row, and no sum of rows, ever holds -0.0 (under
//     round-to-nearest x + y is -0.0 only if both are -0.0);
//   * adding the +0.0 of a coordinate a worker did not keep is therefore the
//     identity, and adding v*s instead of 0.0 + v*s differs only when v*s is
//     -0.0, where acc + -0.0 == acc + +0.0 == acc for every acc != -0.0;
//   * so the chain acc = +0.0; acc = acc + v_i*s for the workers that kept
//     the coordinate, in worker order (pass e), gives the reference's bits at
//     every coordinate: signed zeros, +-inf, NaN and subnormals included (no
//     fast math: -fmad=false keeps v*s (pass c) and the add (pass e) two IEEE
//     roundings, and subnormals are not flushed).  The mean's / n is one IEEE
//     division of the finished sum, as in the plain version (for n a power of
//     two written as s * (1/n), the same correctly rounded value).
// The JAX kernel starts each worker's row from zeros inside its body, so the
// zeroing is part of this kernel's work, not a library memset.
//
// Scratch (allocated by the wrapper, kernels/sparse.py::decode_scratch, whose
// sizes these launches assume): per coarse bin a uint32 count, a uint64
// cursor and a uint32 first chunk (one more for the total); per chunk a
// uint32 bin; per (tile, worker) a uint32 count, a uint64 start and a uint64
// cursor; two record buffers of n * k 8-byte records.  All offsets are
// 64-bit: (n, Dp) is ~4e9 elements and the (n, k) inputs are views with rows
// idx_ld / val_ld apart.
//
// Bound: bytes.  GATHER reads 4 B of index and 4 B of x per entry and writes
// 4 B (a random x read fetches a 32-byte sector).  DECODE writes 4 B per
// coordinate and per entry reads index, value and scale; the binned order
// adds the index reads of passes a and c and two 8-byte records, each
// written once and read once or twice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPassThreads = 512;
constexpr int kPer = 8;                // entries (records) per thread in flight: gather, a, c, d
constexpr long long kChunk = (long long)kPassThreads * kPer;   // entries (records) of a block
                                                               // of passes a, c, d1 and d3
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;            // bins per scan thread
constexpr int kLogTile = 14;           // T: output floats of a tile block (64 KB of shared
constexpr int kTile = 1 << kLogTile;   // memory)
constexpr int kLogCoarse = 19;         // S: floats of a coarse bin
constexpr int kCoarse = 1 << kLogCoarse;
constexpr int kTilesPerBin = kCoarse / kTile;
constexpr long long kMaxD = 1LL << 32;                      // the widest index word
constexpr int kMaxBins = (int)(kMaxD >> kLogCoarse);        // 8192; pass c: 40 KB + 12 B
                                                            // per bin of shared memory
constexpr int kGroup = 512;            // workers per launch group: pass d3 holds 40 KB + 8 B
                                       // per (tile, worker) key of a bin, kTilesPerBin * n
                                       // keys, of shared memory
constexpr int kTileThreads = 512;
constexpr int kTilePer = 4;            // records per thread in flight in the tile pass

// In the order of the wrapper's pointer array.
struct Scratch {
  unsigned long long* cursors;         // (bins,) run starts, then ends
  unsigned long long* fine_starts;     // (tiles * n,) where each fine run starts
  unsigned long long* fine_cursors;    // (tiles * n,) pass d3's reservations
  uint2* coarse;                       // (n * k,) coarse records
  uint2* records;                      // (n * k,) fine records
  unsigned* counts;                    // (bins,) entries per coarse bin
  unsigned* fine_counts;               // (tiles * n,) entries per (tile, worker); follows
                                       // counts (one memset clears both)
  unsigned* chunk_start;               // (bins + 1,) first chunk of each bin, then the total
  unsigned* chunk_bin;                 // (chunks,) the bin of each chunk
};

unsigned blocks_for(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return (unsigned)(b < 1 ? 1 : b);
}

// ------------------------------------------------------------------ gather

// A read-only load that does not allocate in L1: each x sector is used once.
__device__ __forceinline__ float load_nc(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// 8 consecutive indices from an aligned address (8 bytes for uint8, 16 for
// the wider words), as streaming loads.
__device__ __forceinline__ void load8(const uint8_t* p, unsigned (&i)[kPer]) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    i[e] = (v.x >> (8 * e)) & 0xffu;
    i[e + 4] = (v.y >> (8 * e)) & 0xffu;
  }
}

__device__ __forceinline__ void load8(const uint16_t* p, unsigned (&i)[kPer]) {
  const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    i[2 * e] = w[e] & 0xffffu;
    i[2 * e + 1] = w[e] >> 16;
  }
}

__device__ __forceinline__ void load8(const uint32_t* p, unsigned (&i)[kPer]) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldcs(reinterpret_cast<const uint4*>(p) + 1);
  i[0] = a.x; i[1] = a.y; i[2] = a.z; i[3] = a.w;
  i[4] = b.x; i[5] = b.y; i[6] = b.z; i[7] = b.w;
}

template <typename I>
constexpr int index_align() {
  return sizeof(I) == 1 ? 8 : 16;
}

// Entries [head, head + 8 * groups) 8 per thread; the head [0, head) and the
// tail [head + 8 * groups, k) (fewer than 8 each) one per thread of the
// first 16.
template <typename I, bool kVecOut>
__global__ void gather_kernel(const float* __restrict__ x, long long d,
                              const I* __restrict__ idx, long long k, long long head,
                              long long groups, float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    const long long j = head + kPer * g;
    unsigned i[kPer];
    load8(idx + j, i);
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = load_nc(x + ((long long)i[e] < d ? (long long)i[e] : d - 1));
    }
    if (kVecOut) {
      float4* o4 = reinterpret_cast<float4*>(out + j);
      __stcs(o4, make_float4(v[0], v[1], v[2], v[3]));
      __stcs(o4 + 1, make_float4(v[4], v[5], v[6], v[7]));
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) __stcs(out + j + e, v[e]);
    }
  }
  if (g < 2 * kPer) {
    const long long j = g < kPer ? g : head + kPer * groups + (g - kPer);
    if (g < kPer ? g < head : j < k) {
      long long i = (long long)idx[j];
      if (i >= d) i = d - 1;
      out[j] = x[i];
    }
  }
}

template <typename I>
int gather(const float* x, long long d, const void* idx, long long k, float* out,
           cudaStream_t st) {
  const uintptr_t a = (uintptr_t)idx;
  long long head = (long long)((index_align<I>() - a % index_align<I>()) % index_align<I>()) /
                   (long long)sizeof(I);
  if (head > k) head = k;
  const long long groups = (k - head) / kPer;
  const unsigned blocks =
      blocks_for(groups > 2 * kPer ? groups : 2 * kPer, kThreads);
  if ((uintptr_t)(out + head) % 16 == 0) {
    gather_kernel<I, true><<<blocks, kThreads, 0, st>>>(x, d, (const I*)idx, k, head, groups,
                                                          out);
  } else {
    gather_kernel<I, false><<<blocks, kThreads, 0, st>>>(x, d, (const I*)idx, k, head, groups,
                                                           out);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ decode

// Exclusive prefix of v over the block (blockDim.x a multiple of 32, at most
// 1024) and, in *total, the block's sum.  Ends with __syncthreads().
__device__ long long block_scan(long long v, long long* total) {
  __shared__ long long warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    long long s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < nw) warp_sums[lane] = s;     // inclusive over the warps
  }
  __syncthreads();
  const long long before = (warp > 0 ? warp_sums[warp - 1] : 0) + inc - v;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before;
}

// a. counts[bin] = kept entries with i >> log2 S == bin, counted per
// block (kChunk entries of worker blockIdx.y) in shared memory, then one
// atomic per bin the block hit.  Each thread issues its kPer index loads
// before its first atomic.
template <typename I>
__global__ void coarse_count_kernel(const I* __restrict__ idx, long long idx_ld, long long k,
                                    long long d, int bins, unsigned* __restrict__ counts) {
  extern __shared__ unsigned hist[];
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  const I* row = idx + (long long)blockIdx.y * idx_ld;
  const long long j0 = (long long)blockIdx.x * kChunk + threadIdx.x;
  long long i[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long j = j0 + (long long)e * kPassThreads;
    i[e] = j < k ? (long long)__ldcs(row + j) : d;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (i[e] < d) atomicAdd(hist + (i[e] >> kLogCoarse), 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    if (hist[b]) atomicAdd(counts + b, hist[b]);
  }
}

// b. cursors[b] = counts[0] + ... + counts[b - 1]; chunk_start[b] = the
// chunks of kChunk records of bins 0 .. b - 1, chunk_start[bins] = all of
// them; chunk_bin[chunk] = its bin.  One block (bins <= kMaxBins <=
// kScanThreads * kScanPer).
__global__ void bin_scan_kernel(const unsigned* __restrict__ counts, int bins,
                            unsigned long long* __restrict__ cursors,
                            unsigned* __restrict__ chunk_start, unsigned* __restrict__ chunk_bin) {
  const int base = threadIdx.x * kScanPer;
  unsigned c[kScanPer];
  long long own = 0, own_chunks = 0;
#pragma unroll
  for (int e = 0; e < kScanPer; ++e) {
    c[e] = base + e < bins ? counts[base + e] : 0u;
    own += c[e];
    own_chunks += (c[e] + kChunk - 1) / kChunk;
  }
  long long total, total_chunks;
  long long run = block_scan(own, &total);
  long long chunk = block_scan(own_chunks, &total_chunks);
#pragma unroll
  for (int e = 0; e < kScanPer; ++e) {
    if (base + e < bins) {
      cursors[base + e] = (unsigned long long)run;
      chunk_start[base + e] = (unsigned)chunk;
      const long long next = chunk + (c[e] + kChunk - 1) / kChunk;
      for (; chunk < next; ++chunk) chunk_bin[chunk] = (unsigned)(base + e);
    }
    run += c[e];
  }
  if (threadIdx.x == 0) chunk_start[bins] = (unsigned)total_chunks;
}

// c. Each kept entry appends (w << log2 S | i mod S, v * s) to its coarse
// bin's run: the block (kChunk entries of worker blockIdx.y) ranks its
// entries per bin with shared-memory atomics, reserves one range per bin
// with one atomic on the bin's cursor, sorts its records by bin in shared
// memory and writes each bin's records as one contiguous piece (scattered
// 8-byte writes cost more than the pass's reads).
template <typename I>
__global__ void coarse_bin_kernel(const I* __restrict__ idx, long long idx_ld,
                                  const float* __restrict__ values, long long val_ld,
                                  const float* __restrict__ scale, long long k, long long d,
                                  int bins,
                                  unsigned long long* __restrict__ cursors,
                                  uint2* __restrict__ records) {
  extern __shared__ uint2 stage[];                                  // (kChunk,)
  long long* delta = reinterpret_cast<long long*>(stage + kChunk);  // global - local start
  unsigned* hist = reinterpret_cast<unsigned*>(delta + bins);       // counts, then local starts
  unsigned short* stage_bin = reinterpret_cast<unsigned short*>(hist + bins);
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  const unsigned w = blockIdx.y;
  const I* row = idx + (long long)w * idx_ld;
  const float* vrow = values + (long long)w * val_ld;
  const long long j0 = (long long)blockIdx.x * kChunk + threadIdx.x;
  long long i[kPer];
  float p[kPer];
  unsigned rank[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long j = j0 + (long long)e * kPassThreads;
    i[e] = d;
    if (j < k) {
      i[e] = (long long)__ldcs(row + j);
      p[e] = __ldcs(vrow + j) * __ldg(scale + j);
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (i[e] < d) rank[e] = atomicAdd(hist + (i[e] >> kLogCoarse), 1u);
  }
  __syncthreads();
  const int per = (bins + blockDim.x - 1) / blockDim.x;
  const int b0 = threadIdx.x * per, b1 = b0 + per < bins ? b0 + per : bins;
  long long own = 0;
  for (int b = b0; b < b1; ++b) own += hist[b];
  long long total;
  long long local = block_scan(own, &total);
  for (int b = b0; b < b1; ++b) {
    const unsigned c = hist[b];
    hist[b] = (unsigned)local;
    if (c) delta[b] = (long long)atomicAdd(cursors + b, (unsigned long long)c) - local;
    local += c;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (i[e] < d) {
      const int b = (int)(i[e] >> kLogCoarse);
      const unsigned slot = hist[b] + rank[e];
      stage[slot] = make_uint2((w << kLogCoarse) | ((unsigned)i[e] & (kCoarse - 1)),
                               __float_as_uint(p[e]));
      stage_bin[slot] = (unsigned short)b;
    }
  }
  __syncthreads();
  for (int slot = threadIdx.x; slot < (int)total; slot += blockDim.x) {
    records[delta[stage_bin[slot]] + slot] = stage[slot];
  }
}

// The records [from, to) of chunk blockIdx.x of bin *bin (false for the
// blocks beyond the last chunk: the grid is sized for the most chunks there
// can be).
__device__ __forceinline__ bool chunk_of(const unsigned* __restrict__ counts,
                                         const unsigned long long* __restrict__ cursors,
                                         const unsigned* __restrict__ chunk_start,
                                         const unsigned* __restrict__ chunk_bin, int bins,
                                         int* bin, unsigned long long* from,
                                         unsigned long long* to) {
  const unsigned g = blockIdx.x;
  if (g >= chunk_start[bins]) return false;
  const int b = (int)chunk_bin[g];
  const unsigned long long end = cursors[b];    // after pass c: the end of the bin's run
  *bin = b;
  *from = end - counts[b] + (unsigned long long)(g - chunk_start[b]) * kChunk;
  *to = *from + kChunk < end ? *from + kChunk : end;
  return true;
}

// The (tile in bin, worker) key of a coarse record (w << log2 S | i mod S).
__device__ __forceinline__ unsigned key_of(unsigned x, int n) {
  return ((x & (kCoarse - 1)) >> kLogTile) * n + (x >> kLogCoarse);
}

// d1. fine_counts[(tile, w)] += the chunk's records of that run: counted in
// shared memory, then one atomic per run the chunk hit.
__global__ void chunk_count_kernel(int n, int bins, long long runs,
                                   const unsigned* __restrict__ counts,
                                   const unsigned long long* __restrict__ cursors,
                                   const unsigned* __restrict__ chunk_start,
                                   const unsigned* __restrict__ chunk_bin,
                                   const uint2* __restrict__ coarse,
                                   unsigned* __restrict__ fine_counts) {
  extern __shared__ unsigned hist[];            // (keys,)
  int bin;
  unsigned long long from, to;
  if (!chunk_of(counts, cursors, chunk_start, chunk_bin, bins, &bin, &from, &to)) return;
  const int keys = kTilesPerBin * n;            // (tile in bin) * n + w
  for (int q = threadIdx.x; q < keys; q += blockDim.x) hist[q] = 0u;
  __syncthreads();
  unsigned x[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const unsigned long long at = from + threadIdx.x + (unsigned long long)e * kPassThreads;
    if (at < to) x[e] = __ldcs(&coarse[at].x);
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (from + threadIdx.x + (unsigned long long)e * kPassThreads < to) {
      atomicAdd(hist + key_of(x[e], n), 1u);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < keys; q += blockDim.x) {
    const long long g = (long long)bin * keys + q;              // (tile, w) overall
    if (hist[q] && g < runs) atomicAdd(fine_counts + g, hist[q]);
  }
}

// d2. One block per bin: fine_starts (and fine_cursors) of its runs, the
// exclusive prefix of their counts in tile-major worker-minor order from the
// bin's start.  Runs past the last tile (a partial last bin) hold nothing.
__global__ void run_scan_kernel(int n, long long runs, const unsigned* __restrict__ counts,
                                const unsigned long long* __restrict__ cursors,
                                const unsigned* __restrict__ fine_counts,
                                unsigned long long* __restrict__ fine_starts,
                                unsigned long long* __restrict__ fine_cursors) {
  const long long bin = blockIdx.x;
  const int keys = kTilesPerBin * n;
  const long long g0 = bin * keys;
  const int per = (keys + blockDim.x - 1) / blockDim.x;
  const int q0 = threadIdx.x * per, q1 = q0 + per < keys ? q0 + per : keys;
  long long own = 0;
  for (int q = q0; q < q1; ++q) own += g0 + q < runs ? fine_counts[g0 + q] : 0u;
  long long total;
  unsigned long long run = cursors[bin] - counts[bin] + (unsigned long long)block_scan(own, &total);
  for (int q = q0; q < q1 && g0 + q < runs; ++q) {
    fine_starts[g0 + q] = run;
    fine_cursors[g0 + q] = run;
    run += fine_counts[g0 + q];
  }
}

// d3. Each chunk places its records (i mod T, v * s) in their fine runs:
// ranks per run in shared memory, one atomic per run on the run's cursor
// for the chunk's range, the records sorted by run in shared memory, each
// run's piece written contiguously.  A reservation lies within the bin's
// run (at most 2^28 records), so it is kept as an offset from the bin's
// start, next to the chunk's local start, in 32 bits each.
__global__ void chunk_place_kernel(int n, int bins, const unsigned* __restrict__ counts,
                                   const unsigned long long* __restrict__ cursors,
                                   const unsigned* __restrict__ chunk_start,
                                   const unsigned* __restrict__ chunk_bin,
                                   const uint2* __restrict__ coarse,
                                   unsigned long long* __restrict__ fine_cursors,
                                   uint2* __restrict__ records) {
  extern __shared__ uint2 stage[];                                  // (kChunk,)
  const int keys = kTilesPerBin * n;
  unsigned* local = reinterpret_cast<unsigned*>(stage + kChunk);    // counts, then local starts
  int* delta = reinterpret_cast<int*>(local + keys);                // reservation - local start
  unsigned short* stage_key = reinterpret_cast<unsigned short*>(delta + keys);
  int bin;
  unsigned long long from, to;
  if (!chunk_of(counts, cursors, chunk_start, chunk_bin, bins, &bin, &from, &to)) return;
  for (int q = threadIdx.x; q < keys; q += blockDim.x) local[q] = 0u;
  __syncthreads();
  uint2 r[kPer];
  unsigned key[kPer], rank[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const unsigned long long at = from + threadIdx.x + (unsigned long long)e * kPassThreads;
    if (at < to) {
      r[e] = __ldcs(coarse + at);
      key[e] = key_of(r[e].x, n);
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (from + threadIdx.x + (unsigned long long)e * kPassThreads < to) {
      rank[e] = atomicAdd(local + key[e], 1u);
    }
  }
  __syncthreads();
  const int per = (keys + blockDim.x - 1) / blockDim.x;
  const int q0 = threadIdx.x * per, q1 = q0 + per < keys ? q0 + per : keys;
  long long mine = 0;
  for (int q = q0; q < q1; ++q) mine += local[q];
  long long in_chunk;
  long long at = block_scan(mine, &in_chunk);
  const unsigned long long bin_start = cursors[bin] - counts[bin];
  for (int q = q0; q < q1; ++q) {
    const unsigned c = local[q];
    local[q] = (unsigned)at;
    if (c) {
      const unsigned long long got =
          atomicAdd(fine_cursors + (long long)bin * keys + q, (unsigned long long)c);
      delta[q] = (int)(got - bin_start) - (int)at;
    }
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (from + threadIdx.x + (unsigned long long)e * kPassThreads < to) {
      const unsigned slot = local[key[e]] + rank[e];
      stage[slot] = make_uint2(r[e].x & (kTile - 1), r[e].y);
      stage_key[slot] = (unsigned short)key[e];
    }
  }
  __syncthreads();
  for (int slot = threadIdx.x; slot < (int)in_chunk; slot += blockDim.x) {
    records[bin_start + (long long)(delta[stage_key[slot]] + slot)] = stage[slot];
  }
}

// e. One block per tile: +0.0 (or, for a later group of workers, the tile
// the earlier groups left in out), then the fine runs of the group's
// workers 0..n-1 in order, then one write of the tile (for the mean's last
// group, divided by n_all, the count of all the groups' workers).  Each
// thread holds kTilePer records of a run in flight, and the loads of worker
// w + 1's first records are issued before the barrier that ends worker w.
template <bool kMean>
__global__ void tile_kernel(int n, const unsigned* __restrict__ fine_counts,
                            const unsigned long long* __restrict__ fine_starts,
                            const uint2* __restrict__ records, long long d, int from_out,
                            int n_all, float* __restrict__ out) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const long long t = blockIdx.x;
  const long long base = t * kTile;
  const int len = (int)(d - base < kTile ? d - base : kTile);
  const unsigned long long step = (unsigned long long)blockDim.x * kTilePer;
  uint2 r[kTilePer];
  unsigned long long end = fine_starts[t * n] + fine_counts[t * n];
  unsigned long long from = fine_starts[t * n] + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kTilePer; ++e) {
    if (from + (unsigned long long)e * blockDim.x < end) {
      r[e] = __ldcs(records + from + (unsigned long long)e * blockDim.x);
    }
  }
  if (from_out) {
    const float4* i4 = reinterpret_cast<const float4*>(out + base);
    for (int q = threadIdx.x; q < len / 4; q += blockDim.x) acc4[q] = i4[q];
    const int q = (len & ~3) + threadIdx.x;
    if (q < len) acc[q] = out[base + q];
  } else {
    for (int q = threadIdx.x; q < kTile / 4; q += blockDim.x) {
      acc4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  for (int w = 0; w < n; ++w) {
    while (from < end) {
#pragma unroll
      for (int e = 0; e < kTilePer; ++e) {
        if (from + (unsigned long long)e * blockDim.x < end) {
          acc[r[e].x] = acc[r[e].x] + __uint_as_float(r[e].y);
        }
      }
      from += step;
#pragma unroll
      for (int e = 0; e < kTilePer; ++e) {
        if (from + (unsigned long long)e * blockDim.x < end) {
          r[e] = __ldcs(records + from + (unsigned long long)e * blockDim.x);
        }
      }
    }
    if (w + 1 < n) {
      from = fine_starts[t * n + w + 1] + threadIdx.x;
      end = fine_starts[t * n + w + 1] + fine_counts[t * n + w + 1];
#pragma unroll
      for (int e = 0; e < kTilePer; ++e) {
        if (from + (unsigned long long)e * blockDim.x < end) {
          r[e] = __ldcs(records + from + (unsigned long long)e * blockDim.x);
        }
      }
    }
    __syncthreads();
  }
  // For n a power of two, s * (1/n) is the same correctly rounded value as
  // s / n (1/n is exact), and costs one multiply instead of a division.
  const bool pow2 = (n_all & (n_all - 1)) == 0;
  const float fn = (float)n_all;
  const float inv = 1.0f / fn;
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int q = threadIdx.x; q < len / 4; q += blockDim.x) {
    float4 v = acc4[q];
    if (kMean) {
      v = pow2 ? make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv)
               : make_float4(v.x / fn, v.y / fn, v.z / fn, v.w / fn);
    }
    o4[q] = v;
  }
  const int q = (len & ~3) + threadIdx.x;
  if (q < len) out[base + q] = !kMean ? acc[q] : pow2 ? acc[q] * inv : acc[q] / fn;
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
int allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Workers w0 .. w0 + n - 1 (n <= kGroup) of n_all: passes a-e, the tile
// pass starting from out where w0 > 0; mean != 0 divides by n_all.
template <typename I>
int decode_group(int mean, int n, int w0, int n_all, const I* ix, long long idx_ld,
                 const float* values, long long val_ld, const float* scale, long long k,
                 long long d, float* out, const Scratch& sc, cudaStream_t st) {
  const long long tiles = (d + kTile - 1) / kTile;
  const int bins = (int)((d + kCoarse - 1) / kCoarse);
  const int keys = kTilesPerBin * n;
  int rc = (int)cudaMemsetAsync(sc.counts, 0, (size_t)(bins + tiles * n) * sizeof(unsigned),
                                st);
  if (rc) return rc;
  const dim3 entry_blocks((unsigned)((k + kChunk - 1) / kChunk), (unsigned)n);
  const int count_smem = bins * (int)sizeof(unsigned);
  const int stage_smem = (int)kChunk * (int)(sizeof(uint2) + sizeof(unsigned short));
  const int bin_smem = stage_smem + bins * (int)(sizeof(long long) + sizeof(unsigned));
  if (k > 0) {
    auto* count = coarse_count_kernel<I>;
    if ((rc = allow_smem((const void*)count, count_smem))) return rc;
    count<<<entry_blocks, kPassThreads, count_smem, st>>>(ix, idx_ld, k, d, bins, sc.counts);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  bin_scan_kernel<<<1, kScanThreads, 0, st>>>(sc.counts, bins, sc.cursors, sc.chunk_start,
                                              sc.chunk_bin);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (k > 0) {
    auto* bin = coarse_bin_kernel<I>;
    if ((rc = allow_smem((const void*)bin, bin_smem))) return rc;
    bin<<<entry_blocks, kPassThreads, bin_smem, st>>>(ix, idx_ld, values, val_ld, scale, k, d,
                                                      bins, sc.cursors, sc.coarse);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  // The most chunks there can be: every record in a chunk of its own bin's,
  // plus one partial chunk per bin.
  const unsigned chunks = (unsigned)((n * k + kChunk - 1) / kChunk + bins);
  const long long runs = tiles * n;
  const int hist_smem = keys * (int)sizeof(unsigned);
  if ((rc = allow_smem((const void*)chunk_count_kernel, hist_smem))) return rc;
  chunk_count_kernel<<<chunks, kPassThreads, hist_smem, st>>>(
      n, bins, runs, sc.counts, sc.cursors, sc.chunk_start, sc.chunk_bin, sc.coarse,
      sc.fine_counts);
  if ((rc = (int)cudaGetLastError())) return rc;
  run_scan_kernel<<<bins, kPassThreads, 0, st>>>(n, runs, sc.counts, sc.cursors, sc.fine_counts,
                                                 sc.fine_starts, sc.fine_cursors);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int place_smem = stage_smem + keys * (int)(sizeof(unsigned) + sizeof(int));
  if ((rc = allow_smem((const void*)chunk_place_kernel, place_smem))) return rc;
  chunk_place_kernel<<<chunks, kPassThreads, place_smem, st>>>(
      n, bins, sc.counts, sc.cursors, sc.chunk_start, sc.chunk_bin, sc.coarse, sc.fine_cursors,
      sc.records);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int smem = kTile * (int)sizeof(float);
  auto* kernel = mean ? tile_kernel<true> : tile_kernel<false>;
  if ((rc = allow_smem((const void*)kernel, smem))) return rc;
  kernel<<<(unsigned)tiles, kTileThreads, smem, st>>>(n, sc.fine_counts, sc.fine_starts,
                                                      sc.records, d, w0 > 0, n_all, out);
  return (int)cudaGetLastError();
}

// All n workers, kGroup at a time in worker order: each group's tile pass
// continues the sum the earlier groups left in out, so every coordinate's
// sum still runs from +0.0 through the workers in order (the bits of one
// launch over all of them), and only the last group divides for the mean.
template <typename I>
int decode(int mean, int n, const void* idx, long long idx_ld, const float* values,
           long long val_ld, const float* scale, long long k, long long d, float* out,
           const Scratch& sc, cudaStream_t st) {
  for (int w0 = 0; w0 < n; w0 += kGroup) {
    const int g = n - w0 < kGroup ? n - w0 : kGroup;
    const int rc = decode_group<I>(mean && w0 + g == n, g, w0, n, (const I*)idx + w0 * idx_ld,
                                   idx_ld, values + w0 * val_ld, val_ld, scale, k, d, out, sc,
                                   st);
    if (rc) return rc;
  }
  return 0;
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
// f32; out (d,) f32, 16-byte aligned; d <= 2^32 (the widest index word) and
// n >= 1, else cudaErrorInvalidValue.  mean != 0 divides the sum by n.
// scratch holds the nine pointers of struct Scratch, in its order, into
// arrays sized by kernels/sparse.py::decode_scratch for (min(n, 512), k, d):
// the workers go through passes a-e 512 at a time.
extern "C" int sparse_decode(int mean, int n, const void* idx, long long idx_ld, int idx_bytes,
                             const void* values, long long val_ld, const void* scale,
                             long long k, long long d, void* out, void* const* scratch,
                             void* stream) {
  if (d <= 0) return 0;
  if (n <= 0 || d > kMaxD || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Scratch sc{(unsigned long long*)scratch[0], (unsigned long long*)scratch[1],
                   (unsigned long long*)scratch[2], (uint2*)scratch[3], (uint2*)scratch[4],
                   (unsigned*)scratch[5], (unsigned*)scratch[6], (unsigned*)scratch[7],
                   (unsigned*)scratch[8]};
  const float* v = (const float*)values;
  const float* s = (const float*)scale;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (idx_bytes) {
    case 1:
      return decode<uint8_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, sc, st);
    case 2:
      return decode<uint16_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, sc, st);
    case 4:
      return decode<uint32_t>(mean, n, idx, idx_ld, v, val_ld, s, k, d, o, sc, st);
  }
  return (int)cudaErrorInvalidValue;
}
