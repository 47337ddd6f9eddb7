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
// > 0.  Two paths:
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
//   - Longer rows, in the `score` entry above kWarpMax and in the
//     `score_long` entry (rows over 32,768 windows: reads over 32,798
//     bases at k=31, as nanopore and PacBio give): one block per read and
//     a label histogram in shared memory, kBins u32 counters (128 KB) for
//     the labels [0, 32,768), then for [32,768, 65,536) only when the row
//     holds such a label.  Labels are at most 65,535 (config.MTRGTS; the
//     plain version's sentinel is 65,536); a label above counts in total
//     only.  A long read's windows mostly hit one target, so each warp
//     groups equal labels with __match_any_sync and adds once per distinct
//     label.  Each thread keeps the top two keys of the counters it scans,
//     across both ranges, and two block max-reductions give the best and
//     the second.  No scratch in device memory: the row is read once (twice
//     when it holds labels of both ranges).
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

// One block of kHistThreads per read: the label histogram in shared
// memory, kBins counters a range.
__global__ void __launch_bounds__(kHistThreads)
    score_hist_kernel(const int32_t* __restrict__ labels,
                      int32_t* __restrict__ results, int P) {
  extern __shared__ uint32_t hist[];
  __shared__ unsigned long long red[kHistThreads / 32];
  __shared__ int red_sum[kHistThreads / 32];
  const int lane = threadIdx.x & 31;
  const int32_t* row = labels + static_cast<int64_t>(blockIdx.x) * P;
  unsigned long long b1 = 0, b2 = 0;
  int total = 0;
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

int launch_hist(const int32_t* labels, int32_t* results, int64_t R, int P,
                cudaStream_t st) {
  if (R > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kBins * static_cast<int>(sizeof(uint32_t));
  const cudaError_t e = cudaFuncSetAttribute(
      score_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  score_hist_kernel<<<static_cast<unsigned>(R), kHistThreads, smem, st>>>(
      labels, results, P);
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
  if (P > kWarpMax) return launch_hist(in, out, R, P, st);
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
  return launch_hist(static_cast<const int32_t*>(labels),
                     static_cast<int32_t*>(results), R, P,
                     static_cast<cudaStream_t>(stream));
}
