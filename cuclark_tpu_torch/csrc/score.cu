// Score kernel: per-window labels -> per-read [total, best label, best
// count, second label, second count].
//
// Replaces cuclark_tpu/score.py:score_labels (score.py:28), which XLA
// compiled on the TPU as a per-row sort, run-length counts and two arg-max
// passes.  The plain PyTorch version is
// cuclark_tpu_torch/score.py:score_labels_plain.
//
// What bounds it on the card: reading the labels once, 4 B per window (32
// MB for a 65,536 x 122 batch, 10 us at 3.35 TB/s); the [R, 5] output is
// small.  Everything else is the work per row, and the design keeps it off
// barriers and out of device memory.  The best run is the maximum of the
// 64-bit key (count << 32 | ~label): highest count first, then the smallest
// label on ties, exactly the tie-break of score.py:37-66.  The second is
// the same maximum with the best label left out.  total counts the labels
// > 0.  Three paths:
//
//   - Rows of up to kWarpMax windows (every short-read length bin, and
//     paired reads; the code is in warp_score.cuh, which query.cu's fused
//     kernel shares): one warp per read, the row in registers, E = Pp / 32
//     labels a lane, Pp the power of two >= max(P, 32), padded with 0 (a
//     miss, which never counts).  A short read from one genome holds one
//     label or a few, so the warp first counts them in up to kRounds
//     rounds: the first positive label left, its count a popcount of
//     ballots over the E registers, then zeroed.  A row with labels left
//     after the rounds (many distinct labels) is sorted: a bitonic network,
//     lane l holding sorted positions l*E .. l*E + E - 1, compare-exchanges
//     at a stride below E in the lane's registers and wider ones through
//     __shfl_xor_sync.  Each run's start comes from a warp max-scan of the
//     run starts; each lane keeps the top two keys of the run ends it holds
//     (a label has one run end, so they are of two labels).  The counted
//     and the sorted labels are disjoint, so their keys merge, and warp
//     max-reductions give the best and the second.  No shared memory and
//     no __syncthreads().
//   - Longer rows whose labels have a bound of at most kBoundBins - 1 (a
//     table's largest label, TableSpec.label_bound; 76 in the benchmark's
//     full DB), in the `score_bounded` entry: the bounded histogram, one
//     block of kBoundThreads a read and bound + 1 counters, rounded up to
//     32, in shared memory.  The row is read once, 16 B a load (a scalar
//     head up to the first 16-byte boundary, since a row starts at
//     r * P * 4 bytes, and a scalar tail), kUnroll loads a thread in
//     flight.  A long read's windows hit one target or miss, so a thread
//     counts a run of equal labels (misses skipped) in a register, adds it
//     where the label changes, and at the end the lanes of a warp that
//     hold one label add together (__match_any_sync, __reduce_add_sync).
//     The counters are then scanned for the top two as below.
//   - Other rows over kWarpMax windows, in the `score` entry and in the
//     `score_long` entry (rows over 32,768 windows: reads over 32,798
//     bases at k=31, as nanopore and PacBio give): the wide histogram, one
//     block of kHistThreads a read, kBins u32 counters (128 KB) for the
//     labels [0, 32,768), then for [32,768, 65,536) only when the row
//     holds such a label.  Labels are at most 65,535 (config.MTRGTS; the
//     plain version's sentinel is 65,536); a label above counts in total
//     only.  Each warp groups equal labels with __match_any_sync and adds
//     once per distinct label.  Each thread keeps the top two keys of the
//     counters it scans, across both ranges, and two block max-reductions
//     give the best and the second.  No scratch in device memory: the row
//     is read once (twice when it holds labels of both ranges).
//
// Why the bounded path (NVIDIA H100 80GB HBM3, 700 W; the labels of the
// full_ont_long pool, 26 batches over 1,024 windows, 0.768 G windows,
// whose least bytes take 0.918 ms a pass): the wide histogram took 4.75-
// 4.82 ms a pass (19%).  Its 128 KB of counters leave one 1,024-thread
// block an SM; each read clears and scans 32,768 counters to count at most
// 76 labels, and its loads, 4 B a thread a step, keep about 4 KB in flight
// an SM, far from what 3.35 TB/s needs.  Designs tried (ms a pass, two
// label sets): 1,024 threads, 4 loads a thread, 2 blocks an SM 1.38-1.56;
// the same with 2 loads 1.47, 8 loads 1.87, __match_any_sync counting
// instead of runs 1.49; 512 threads, 8 loads 1.35; 256 threads, 8 loads
// 1.28-1.29, with __match_any_sync 1.40; 128 threads, 8 loads 1.30;
// 256 threads, 4 loads, at least 4 blocks an SM (the kernel) 1.25-1.31
// (70-73%).  kBoundBins is the most counters at which two blocks still
// share an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 2 at 28,832,
// 1 at 28,864); a larger bound takes the wide histogram.  Up to that cap
// the bounded histogram wins at every bound measured (the pool's labels
// spread over [1, bound]; ms a pass, bounded against wide): 76 1.35 /
// 4.92, 4,096 1.39 / 4.77, 16,384 1.67 / 4.78, 28,831 2.22 / 4.84, and in
// each group of rows (the 2,048-4,096, 16,384 and larger bins), where the
// counters it clears and scans grow with the bound.  512 threads would
// take 1.85 ms at 28,831 but 1.37 at 76.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cuclark_tpu_torch/kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxScore = 32768;    // longest row of the `score` entry
constexpr int kWarpMax = 1024;      // longest row of the warp path
constexpr int kWarpsPerBlock = 8;   // warp path: reads per block
constexpr int kBins = 32768;        // histogram counters per label range
constexpr int kHistThreads = 1024;
// Bounded instance: blocks of kBoundThreads, kUnroll 16-byte loads a
// thread in flight, and at most kBoundBins counters (bound + 1 rounded up
// to 32): the most at which two blocks still share an SM's shared memory.
constexpr int kBoundThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBoundBins = 28832;

#include "warp_score.cuh"

// One warp per read, E labels a lane (Pp = 32 * E).
template <int E>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    score_warp_kernel(const int32_t* __restrict__ labels,
                      int32_t* __restrict__ results, int64_t R, int P) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp
  const int32_t* row = labels + r * P;

  // coalesced load: neither the rounds nor the sort care where a label is
  int32_t a[E];
  int total = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    a[e] = i < P ? __ldg(row + i) : 0;
    total += a[e] > 0;
  }
  warp_score<E>(a, total, lane, results + r * 5);
}

// Maximum and sum of v over the block (blockDim.x a multiple of 32); every
// thread gets the result.  red is reused by the next call.
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long v, unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0ull);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0);
  __syncthreads();
  return v;
}

// The wide instance's counting: kBins counters a range, the labels
// [0, kBins), then [kBins, 2 * kBins) only when the row holds such a
// label; each warp groups equal labels with __match_any_sync.  Leaves the
// thread's top two keys in b1, b2 and its share of total.
__device__ __forceinline__ void count_wide(const int32_t* __restrict__ row,
                                           int P, uint32_t* hist,
                                           unsigned long long& b1,
                                           unsigned long long& b2,
                                           int& total) {
  const int lane = threadIdx.x & 31;
  bool upper = false;
  for (int lo = 0;; lo += kBins) {
    for (int c = threadIdx.x; c < kBins; c += blockDim.x) hist[c] = 0;
    __syncthreads();
    // whole warps step together, so every lane takes part in the match
    for (int i0 = 0; i0 < P; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const int32_t v = i < P ? __ldg(row + i) : 0;
      if (lo == 0) {
        total += v > 0;
        upper |= v >= kBins;
      }
      const bool mine = v > 0 && v >= lo && v - lo < kBins;
      const unsigned peers = __match_any_sync(kFull, mine ? v : -1);
      if (mine && lane == __ffs(peers) - 1)
        atomicAdd(&hist[v - lo], static_cast<uint32_t>(__popc(peers)));
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kBins; c += blockDim.x) {
      const uint32_t n = hist[c];
      if (n) keep_top2(run_key(n, lo + c), b1, b2);
    }
    // the upper range only when some label needs it; the barrier also
    // orders this scan before the counters are zeroed again
    if (lo != 0 || !__syncthreads_or(upper)) break;
  }
}

// The bounded instance's counting: `bins` counters, the labels [0, bins).
// The row is read once, 16 bytes a load (a scalar head up to the first
// 16-byte boundary and a scalar tail), kUnroll loads a thread in flight.
// A thread counts a run of equal labels (misses between them skipped) in
// a register and adds it to its counter where the label changes and once
// at the end, when each warp's lanes of one label add together.  A label
// of `bins` or more counts in total only.
__device__ __forceinline__ void count_bounded(const int32_t* __restrict__ row,
                                              int P, int bins, uint32_t* hist,
                                              unsigned long long& b1,
                                              unsigned long long& b2,
                                              int& total) {
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x;
  for (int c = t; c < bins; c += kBoundThreads) hist[c] = 0;
  __syncthreads();
  int32_t cur = 0;
  uint32_t run = 0;
  auto add = [&](int32_t v) {
    total += v > 0;
    if (v <= 0 || v >= bins) return;
    if (v != cur) {
      if (run) atomicAdd(&hist[cur], run);
      cur = v;
      run = 0;
    }
    ++run;
  };
  const int head = min(
      P, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                          15) >> 2);
  const int nvec = (P - head) >> 2;
  const int tail = head + 4 * nvec;
  if (t < head) add(__ldg(row + t));
  const int4* vec = reinterpret_cast<const int4*>(row + head);
  for (int i = t; i < nvec; i += kUnroll * kBoundThreads) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kBoundThreads;
      q[u] = j < nvec ? __ldg(vec + j) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(q[u].x);
      add(q[u].y);
      add(q[u].z);
      add(q[u].w);
    }
  }
  if (tail + t < P) add(__ldg(row + tail + t));
  const unsigned peers = __match_any_sync(kFull, run ? cur : -1);
  const uint32_t sum = __reduce_add_sync(peers, run);
  if (run && lane == __ffs(peers) - 1) atomicAdd(&hist[cur], sum);
  __syncthreads();
  for (int c = t; c < bins; c += kBoundThreads) {
    const uint32_t n = hist[c];
    if (n) keep_top2(run_key(n, c), b1, b2);
  }
}

// One block per read, of kHistThreads (wide) or kBoundThreads (Bounded):
// the label histogram in shared memory, kBins counters a range (wide) or
// `bins`.
template <bool Bounded>
__global__ void __launch_bounds__(Bounded ? kBoundThreads : kHistThreads,
                                  Bounded ? 4 : 1)
    score_hist_kernel(const int32_t* __restrict__ labels,
                      int32_t* __restrict__ results, int P, int bins) {
  extern __shared__ uint32_t hist[];
  __shared__ unsigned long long red[kHistThreads / 32];
  __shared__ int red_sum[kHistThreads / 32];
  const int32_t* row = labels + static_cast<int64_t>(blockIdx.x) * P;
  unsigned long long b1 = 0, b2 = 0;
  int total = 0;
  if constexpr (Bounded)
    count_bounded(row, P, bins, hist, b1, b2, total);
  else
    count_wide(row, P, hist, b1, b2, total);
  const unsigned long long best = block_max(b1, red);
  const unsigned long long second =
      block_max(best_other(b1, b2, key_label(best)), red);
  total = block_sum(total, red_sum);
  if (threadIdx.x == 0)
    write_result(results + static_cast<int64_t>(blockIdx.x) * 5, total, best,
                 second);
}

template <int E>
int launch_warp(const int32_t* labels, int32_t* results, int64_t R, int P,
                cudaStream_t st) {
  const int64_t blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  score_warp_kernel<E><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock,
                         0, st>>>(labels, results, R, P);
  return static_cast<int>(cudaGetLastError());
}

// The histogram path over `bins` counters: the wide instance at kBins,
// the bounded one at most kBoundBins.
template <bool Bounded>
int launch_hist(const int32_t* labels, int32_t* results, int64_t R, int P,
                int bins, cudaStream_t st) {
  if (R > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      score_hist_kernel<Bounded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (Bounded ? kBoundBins : kBins) * static_cast<int>(sizeof(uint32_t)));
  if (e != cudaSuccess) return static_cast<int>(e);
  score_hist_kernel<Bounded><<<static_cast<unsigned>(R),
                               Bounded ? kBoundThreads : kHistThreads,
                               bins * sizeof(uint32_t), st>>>(labels, results,
                                                              P, bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// results int32 [R, 5] from labels int32 [R, P], 1 <= P <= kMaxScore: the
// warp path up to kWarpMax windows, the histogram above.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int cuclark_score(const void* labels, void* results, int64_t R,
                             int P, void* stream) {
  if (P < 1 || P > kMaxScore) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int32_t* in = static_cast<const int32_t*>(labels);
  int32_t* out = static_cast<int32_t*>(results);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > kWarpMax) return launch_hist<false>(in, out, R, P, kBins, st);
  if (P <= 32) return launch_warp<1>(in, out, R, P, st);
  if (P <= 64) return launch_warp<2>(in, out, R, P, st);
  if (P <= 128) return launch_warp<4>(in, out, R, P, st);
  if (P <= 256) return launch_warp<8>(in, out, R, P, st);
  if (P <= 512) return launch_warp<16>(in, out, R, P, st);
  return launch_warp<32>(in, out, R, P, st);
}

// results int32 [R, 5] from labels int32 [R, P] with P > kMaxScore: the
// histogram path.  Launches on `stream` and returns cudaGetLastError().
extern "C" int cuclark_score_long(const void* labels, void* results,
                                  int64_t R, int P, void* stream) {
  if (P <= kMaxScore) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  return launch_hist<false>(static_cast<const int32_t*>(labels),
                            static_cast<int32_t*>(results), R, P, kBins,
                            static_cast<cudaStream_t>(stream));
}

// results int32 [R, 5] from labels int32 [R, P] with P > kWarpMax whose
// labels are at most `bound`, 0 <= bound < kBoundBins: the bounded
// histogram of bound + 1 counters, rounded up to 32.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int cuclark_score_bounded(const void* labels, void* results,
                                     int64_t R, int P, int bound,
                                     void* stream) {
  if (P <= kWarpMax || bound < 0 || bound >= kBoundBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  return launch_hist<true>(static_cast<const int32_t*>(labels),
                           static_cast<int32_t*>(results), R, P,
                           (bound + 32) & ~31,
                           static_cast<cudaStream_t>(stream));
}
