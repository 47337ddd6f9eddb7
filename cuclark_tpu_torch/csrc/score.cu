// Score kernel: per-window labels -> per-read [total, best label, best
// count, second label, second count].
//
// Replaces cuclark_tpu/score.py:score_labels (score.py:28), which XLA
// compiled on the TPU as a per-row sort, run-length counts and two arg-max
// passes.  The plain PyTorch version is
// cuclark_tpu_torch/score.py:score_labels_plain.
//
// What bounds it on the card: reading the labels, 4 B per window (32 MB
// for a 65,536 x 122 batch), and the compare-exchanges of the per-row sort,
// O(P log^2 P) in shared memory.  The [R, 5] output is negligible.
//
// Simple design: one block per read.  The row is copied into dynamic shared
// memory, padded with 0 (a miss, which never counts) to the next power of
// two Pp, and bitonic-sorted ascending.  Each run end of a positive label
// finds its run start by binary search, so the run length needs no scan.
// The best run is the maximum of the 64-bit key (count << 32 | ~label):
// highest count first, then the smallest label on ties, exactly the
// tie-break of score.py:37-66.  A second pass excludes the best label.
// Pp is at most 32,768 (128 KB of shared memory); above 48 KB the launch
// raises the kernel's dynamic shared-memory limit first.
//
// Rows of more than 32,768 windows (reads over 32,798 bases at k=31, as
// nanopore and PacBio give) take a second kernel, score_long_kernel: the
// same sort and the same two passes, one block per read, on the row copied
// into a device scratch buffer [R, Pp] that the caller allocates, with
// __syncthreads() between the sort's stages.  Its compare-exchanges go to
// L2 and device memory instead of shared memory: O(P log^2 P) 8 B accesses
// per read, which a few long reads per batch can afford.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cuclark_tpu_torch/kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPp = 32768;

// First index in s[0, n) whose value is >= v (s ascending).
__device__ __forceinline__ int lower_bound(const int32_t* s, int n,
                                           int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Maximum of v over the block; blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long v, unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_down_sync(0xFFFFFFFFu, v, o);
    v = w > v ? w : v;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      m = red[w] > m ? red[w] : m;
    }
    red[32] = m;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is reused by the next call
  return v;
}

// Best run key over the run ends of positive labels other than `skip`.
__device__ __forceinline__ unsigned long long best_run(
    const int32_t* s, int Pp, int32_t skip, unsigned long long* red) {
  unsigned long long best = 0;
  for (int i = threadIdx.x; i < Pp; i += blockDim.x) {
    const int32_t v = s[i];
    if (v > 0 && v != skip && (i == Pp - 1 || s[i + 1] != v)) {
      const unsigned long long count = i - lower_bound(s, i, v) + 1;
      const unsigned long long key =
          (count << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(v));
      best = key > best ? key : best;
    }
  }
  return block_max(best, red);
}

// The block's row s[0, Pp), already copied and padded: bitonic sort,
// ascending, then the two best_run passes into out[0, 5).  `s` is shared
// memory (score_kernel) or the block's own slice of device scratch
// (score_long_kernel); either way only this block touches it, and
// __syncthreads() makes each stage's writes visible to the next.
__device__ __forceinline__ void sort_and_score(int32_t* s, int Pp,
                                               int32_t* out,
                                               unsigned long long* red) {
  for (int size = 2; size <= Pp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (Pp >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const int32_t a = s[i];
        const int32_t b = s[j];
        if ((a > b) == ((i & size) == 0)) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }

  const unsigned long long b1 = best_run(s, Pp, 0, red);
  const int32_t best = static_cast<int32_t>(b1 >> 32);
  const int32_t ibest =
      best ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(b1))
           : 0;
  const unsigned long long b2 = best_run(s, Pp, ibest, red);
  const int32_t second = static_cast<int32_t>(b2 >> 32);
  const int32_t isecond =
      second ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(b2))
             : 0;
  if (threadIdx.x == 0) {
    out[0] = Pp - lower_bound(s, Pp, 1);  // windows with a label > 0
    out[1] = ibest;
    out[2] = best;
    out[3] = isecond;
    out[4] = second;
  }
}

__global__ void score_kernel(const int32_t* __restrict__ labels,
                             int32_t* __restrict__ results, int P, int Pp) {
  extern __shared__ int32_t s[];
  __shared__ unsigned long long red[33];
  const int64_t r = blockIdx.x;
  const int32_t* row = labels + r * P;
  for (int i = threadIdx.x; i < Pp; i += blockDim.x) {
    s[i] = i < P ? row[i] : 0;
  }
  __syncthreads();
  sort_and_score(s, Pp, results + r * 5, red);
}

// score_kernel for rows longer than shared memory holds: the row is sorted
// in scratch[r, 0:Pp) in device memory.  Plain loads and stores (no __ldg:
// the read-only path is not coherent with this block's own writes).
__global__ void score_long_kernel(const int32_t* __restrict__ labels,
                                  int32_t* __restrict__ results,
                                  int32_t* scratch, int P, int Pp) {
  __shared__ unsigned long long red[33];
  const int64_t r = blockIdx.x;
  const int32_t* row = labels + r * P;
  int32_t* s = scratch + r * Pp;
  for (int i = threadIdx.x; i < Pp; i += blockDim.x) {
    s[i] = i < P ? row[i] : 0;
  }
  __syncthreads();
  sort_and_score(s, Pp, results + r * 5, red);
}

}  // namespace

// results int32 [R, 5] from labels int32 [R, P], 1 <= P <= 32768.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int cuclark_score(const void* labels, void* results, int64_t R,
                             int P, void* stream) {
  if (P < 1 || P > kMaxPp) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  int Pp = 1;
  while (Pp < P) Pp <<= 1;
  int threads = Pp >> 1;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(Pp) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  score_kernel<<<static_cast<unsigned>(R), threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<int32_t*>(results), P,
      Pp);
  return static_cast<int>(cudaGetLastError());
}

// results int32 [R, 5] from labels int32 [R, P] with P > 32768, through
// scratch int32 [R, Pp], Pp the power of two at or above P.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int cuclark_score_long(const void* labels, void* results,
                                  void* scratch, int64_t R, int P, int Pp,
                                  void* stream) {
  if (P <= kMaxPp || Pp < P || (Pp & (Pp - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  score_long_kernel<<<static_cast<unsigned>(R), 1024, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<int32_t*>(results),
      static_cast<int32_t*>(scratch), P, Pp);
  return static_cast<int>(cudaGetLastError());
}
