// Gather-only kernels that measure what the query's main-row gathers can
// reach on the card, for scripts/torch_gather_ceiling.py and chip_smoke.py.  Not part of the
// package: the script builds this file on its own, with the package's nvcc
// flags.
//
// Every gather reads a qs main row as the query kernel does
// (cuclark_tpu_torch/csrc/query.cu, load_row<true>: two 16 B loads with the
// streaming hint) and folds it into one xor per block, so nothing is elided:
//   - gc_gather: a thread per entry of a list of main buckets, 128 entries a
//     block in list order; `pair` reads the aligned 64 B row pair instead;
//   - gc_partition_radix: main buckets -> window indices grouped by bin
//     (bucket >> s): a count pass, one scan, a scatter, each with one global
//     atomic per job;
//   - gc_partition_fixed: the same into bins of fixed capacity with an
//     overflow list, one warp-aggregated atomic per job, optionally writing
//     each job's Feistel halves (h1, l2) beside its index;
//   - gc_gather_jobs: the gather pass over the fixed bins: per job the k-mer
//     recomputed from the wire bytes (keys 0) or (h1, l2) read from the bins
//     (keys 1), the main row loaded and compared, the label added;
//   - gc_gather_layout: a thread per entry of a list of q4 or s2 main rows,
//     each read as the query kernel reads it (load_row<false>: two 16 B
//     loads through the read-only path; s2_row_label: the S low key words,
//     8 B loads at even S, 4 B loads at odd S);
//   - gc_gather_qs: a thread per entry of a list of qs (main bucket, stash
//     bucket) pairs, in window order: the main row read as gc_gather reads
//     it and the stash row as the query kernel reads it (kmer_label: two
//     16 B loads through the read-only path), both loads issued before
//     either is folded; a stash bucket of 0xFFFFFFFF reads no stash row.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (cuclark_tpu_torch/kernels.py's NVCC_FLAGS).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 128;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fold(uint4 a) {
  return a.x ^ a.y ^ a.z ^ a.w;
}

// One xor per block into out[blockIdx.x].
__device__ __forceinline__ void block_xor(uint32_t x, uint32_t* out) {
  __shared__ uint32_t part[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t y = 0;
    for (int w = 0; w < kBlock / 32; ++w) y ^= part[w];
    out[blockIdx.x] = y;
  }
}

__global__ void __launch_bounds__(kBlock)
    gather_kernel(const uint4* __restrict__ rows,
                  const uint32_t* __restrict__ buckets, int64_t n, int pair,
                  uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  uint32_t x = 0;
  if (i < n) {
    uint64_t b = buckets[i];
    if (pair) {
      b &= ~1ull;
      const uint4 a0 = __ldcs(rows + 2 * b), a1 = __ldcs(rows + 2 * b + 1);
      const uint4 a2 = __ldcs(rows + 2 * b + 2);
      const uint4 a3 = __ldcs(rows + 2 * b + 3);
      x = fold(a0) ^ fold(a1) ^ fold(a2) ^ fold(a3);
    } else {
      const uint4 a0 = __ldcs(rows + 2 * b), a1 = __ldcs(rows + 2 * b + 1);
      x = fold(a0) ^ fold(a1);
    }
  }
  block_xor(x, out);
}

__global__ void clear_kernel(uint32_t* __restrict__ p, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    p[i] = 0;
}

__global__ void count_kernel(const uint32_t* __restrict__ buckets, int64_t n,
                             int s, uint32_t* __restrict__ counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) atomicAdd(counts + (buckets[i] >> s), 1u);
}

// Exclusive scan of counts[0, nbins) into starts, one block of 1024
// threads, each summing a run of consecutive bins.
__global__ void __launch_bounds__(1024)
    scan_kernel(const uint32_t* __restrict__ counts, int nbins,
                uint32_t* __restrict__ starts) {
  __shared__ uint32_t sums[1024];
  const int per = (nbins + 1023) / 1024;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nbins ? lo + per : nbins;
  uint32_t t = 0;
  for (int j = lo; j < hi; ++j) t += counts[j];
  sums[threadIdx.x] = t;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {
    const uint32_t v = threadIdx.x >= o ? sums[threadIdx.x - o] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  uint32_t run = sums[threadIdx.x] - t;
  for (int j = lo; j < hi; ++j) {
    starts[j] = run;
    run += counts[j];
  }
}

__global__ void scatter_kernel(const uint32_t* __restrict__ buckets,
                               const uint32_t* __restrict__ idx, int64_t n,
                               int s, uint32_t* __restrict__ cursor,
                               uint32_t* __restrict__ jobs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) jobs[atomicAdd(cursor + (buckets[i] >> s), 1u)] = idx[i];
}

// A warp's lanes with the same key share one atomicAdd: each gets the old
// value plus its rank among the lanes before it.
__device__ __forceinline__ uint32_t warp_add(uint32_t* ctr, uint32_t key,
                                             unsigned active) {
  const unsigned peers = __match_any_sync(active, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(ctr, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

__global__ void __launch_bounds__(kBlock)
    partition_fixed_kernel(const uint32_t* __restrict__ buckets,
                           const uint32_t* __restrict__ idx,
                           const uint32_t* __restrict__ h1in,
                           const uint32_t* __restrict__ l2in, int64_t n,
                           int s, uint32_t cap, uint32_t* __restrict__ counts,
                           uint32_t* __restrict__ jobs,
                           uint32_t* __restrict__ jh1,
                           uint32_t* __restrict__ jl2, uint32_t* ovf_count,
                           uint32_t* __restrict__ ovf,
                           uint32_t* __restrict__ oh1,
                           uint32_t* __restrict__ ol2, int keys) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const unsigned active = __ballot_sync(kFull, i < n);
  if (i >= n) return;
  const uint32_t bin = buckets[i] >> s;
  const uint32_t pos = warp_add(counts + bin, bin, active);
  const bool spill = pos >= cap;
  const unsigned spills = __ballot_sync(active, spill);
  uint64_t slot = static_cast<uint64_t>(bin) * cap + pos;
  uint32_t *dj = jobs, *dh = jh1, *dl = jl2;
  if (spills) {
    uint32_t o = 0;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(spills) - 1;
    if (lane == leader) o = atomicAdd(ovf_count, __popc(spills));
    o = __shfl_sync(active, o, leader);
    if (spill) {
      slot = o + __popc(spills & ((1u << lane) - 1));
      dj = ovf;
      dh = oh1;
      dl = ol2;
    }
  }
  dj[slot] = idx[i];
  if (keys) {
    dh[slot] = h1in[i];
    dl[slot] = l2in[i];
  }
}

// The canonical k-mer from the 2k bits x of a window (base p + j in field
// j, as cuclark_tpu_torch/csrc/query.cu:window_kmer takes them).
__device__ __forceinline__ uint64_t canonical_of(uint64_t x, int k) {
  const uint64_t mask = ~0ull >> (64 - 2 * k);
  x &= mask;
  uint64_t y = __brevll(x);
  y = ((y >> 1) & 0x5555555555555555ull) | ((y & 0x5555555555555555ull) << 1);
  const uint64_t fwd = y >> (64 - 2 * k);
  const uint64_t rc = ~x & mask;
  return rc < fwd ? rc : fwd;
}

struct Job {
  const uint8_t* packed2;
  const uint4* rows;
  int32_t* labels;
  int P, s2, k, nb_bits;
  uint32_t c1, c2, c3;
};

// One job: window idx's k-mer from the wire (keys 0) or its (h1, l2), the
// main row's label added into labels[idx].
__device__ __forceinline__ void run_job(const Job& J, uint32_t idx,
                                        bool keys, uint32_t h1, uint32_t l2,
                                        uint32_t* x) {
  if (!keys) {
    const uint32_t r = idx / static_cast<uint32_t>(J.P);
    const uint32_t p = idx - r * static_cast<uint32_t>(J.P);
    const uint64_t a = static_cast<uint64_t>(r) * J.s2 + p / 4;
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(J.packed2 + (a & ~3ull));
    const int sh = 8 * static_cast<int>(a & 3) + 2 * static_cast<int>(p & 3);
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2);
    const uint32_t lo = __funnelshift_r(w0, w1, sh);
    const uint32_t hi = __funnelshift_r(w1, w2, sh);
    const uint64_t c =
        canonical_of((static_cast<uint64_t>(hi) << 32) | lo, J.k);
    const uint32_t khi = static_cast<uint32_t>(c >> 32);
    const uint32_t klo = static_cast<uint32_t>(c);
    const uint32_t l1 = klo ^ fmix32(khi + J.c1);
    h1 = khi ^ fmix32(l1 + J.c2);
    l2 = l1 ^ fmix32(h1 + J.c3);
  }
  const uint32_t mask = static_cast<uint32_t>((1ull << J.nb_bits) - 1);
  const uint64_t b = l2 & mask;
  const uint4 o = __ldcs(J.rows + 2 * b), m = __ldcs(J.rows + 2 * b + 1);
  const uint32_t quot = l2 >> J.nb_bits;
  int32_t lab = 0;
  const uint32_t os[4] = {o.x, o.y, o.z, o.w}, ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (os[j] == h1 && (ms[j] >> 17) == quot && ((ms[j] >> 16) & 1u) == 0)
      lab += static_cast<int32_t>(ms[j] & 0xFFFFu);
  if (lab) J.labels[idx] += lab;
  *x ^= lab;
}

// Threads 0 .. nbins * cap - 1 take slot t of bin t / cap when it holds a
// job; the last ovf_blocks blocks walk the overflow list.
__global__ void __launch_bounds__(kBlock)
    gather_jobs_kernel(Job J, const uint32_t* __restrict__ jobs,
                       const uint32_t* __restrict__ jh1,
                       const uint32_t* __restrict__ jl2,
                       const uint32_t* __restrict__ counts, uint32_t cap,
                       uint64_t slots, const uint32_t* ovf_count,
                       const uint32_t* __restrict__ ovf,
                       const uint32_t* __restrict__ oh1,
                       const uint32_t* __restrict__ ol2, int keys,
                       unsigned slot_blocks, uint32_t* __restrict__ out) {
  uint32_t x = 0;
  if (blockIdx.x < slot_blocks) {
    const uint64_t t = static_cast<uint64_t>(blockIdx.x) * kBlock +
                       threadIdx.x;
    if (t < slots) {
      const uint64_t bin = t / cap;
      const uint32_t j = static_cast<uint32_t>(t - bin * cap);
      if (j < counts[bin])
        run_job(J, jobs[t], keys, keys ? jh1[t] : 0, keys ? jl2[t] : 0, &x);
    }
  } else {
    const uint32_t n = *ovf_count;
    const uint32_t stride = (gridDim.x - slot_blocks) * kBlock;
    for (uint32_t o = (blockIdx.x - slot_blocks) * kBlock + threadIdx.x;
         o < n; o += stride)
      run_job(J, ovf[o], keys, keys ? oh1[o] : 0, keys ? ol2[o] : 0, &x);
  }
  block_xor(x, out);
}

// q4 (layout 1) rows of 8 words, s2 (layout 2) rows of 3 * S words.
__global__ void __launch_bounds__(kBlock)
    gather_layout_kernel(const uint32_t* __restrict__ rows,
                         const uint32_t* __restrict__ list, int64_t n,
                         int layout, int S, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  uint32_t x = 0;
  if (i < n) {
    const uint64_t b = list[i];
    if (layout == 1) {
      const uint4* r = reinterpret_cast<const uint4*>(rows) + 2 * b;
      x = fold(__ldg(r)) ^ fold(__ldg(r + 1));
    } else if ((S & 1) == 0) {
      const uint2* r = reinterpret_cast<const uint2*>(
          rows + b * 3 * static_cast<uint64_t>(S));
      for (int j = 0; j < S / 2; ++j) {
        const uint2 v = __ldg(r + j);
        x ^= v.x ^ v.y;
      }
    } else {
      const uint32_t* r = rows + b * 3 * static_cast<uint64_t>(S);
      for (int j = 0; j < S; ++j) x ^= __ldg(r + j);
    }
  }
  block_xor(x, out);
}

__global__ void __launch_bounds__(kBlock)
    gather_qs_kernel(const uint4* __restrict__ rows,
                     const uint4* __restrict__ stash,
                     const uint2* __restrict__ pairs, int64_t n,
                     uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  uint32_t x = 0;
  if (i < n) {
    const uint2 p = pairs[i];
    const uint64_t b = p.x, s = p.y;
    const uint4 a0 = __ldcs(rows + 2 * b), a1 = __ldcs(rows + 2 * b + 1);
    uint4 s0{}, s1{};
    if (p.y != 0xFFFFFFFFu) {
      s0 = __ldg(stash + 2 * s);
      s1 = __ldg(stash + 2 * s + 1);
    }
    x = fold(a0) ^ fold(a1) ^ fold(s0) ^ fold(s1);
  }
  block_xor(x, out);
}

unsigned blocks_of(int64_t n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

// out uint32 [ceil(n / 128)]: per block the xor of its rows.
extern "C" int gc_gather(const void* rows, const void* buckets, int64_t n,
                         int pair, void* out, void* stream) {
  if (n <= 0) return 0;
  gather_kernel<<<blocks_of(n, kBlock), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const uint32_t*>(buckets),
      n, pair, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same over q4 (layout 1) or s2 (layout 2, S slots) main rows list[n].
extern "C" int gc_gather_layout(const void* rows, const void* list,
                                int64_t n, int layout, int S, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  if ((layout != 1 && layout != 2) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_layout_kernel<<<blocks_of(n, kBlock), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(list),
      n, layout, S, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same over qs main and stash rows: pairs uint32 [n, 2] of (main
// bucket, stash bucket or 0xFFFFFFFF).
extern "C" int gc_gather_qs(const void* rows, const void* stash,
                            const void* pairs, int64_t n, void* out,
                            void* stream) {
  if (n <= 0) return 0;
  gather_qs_kernel<<<blocks_of(n, kBlock), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(rows), static_cast<const uint4*>(stash),
      static_cast<const uint2*>(pairs), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Window indices idx[n] grouped by bin buckets[i] >> s into jobs[n]: counts
// and cursor are uint32 [nbins] scratch.
extern "C" int gc_partition_radix(const void* buckets, const void* idx,
                                  int64_t n, int s, int nbins, void* counts,
                                  void* cursor, void* jobs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* c = static_cast<uint32_t*>(counts);
  uint32_t* cur = static_cast<uint32_t*>(cursor);
  const uint32_t* b = static_cast<const uint32_t*>(buckets);
  clear_kernel<<<264, 256, 0, st>>>(c, nbins);
  count_kernel<<<blocks_of(n, 256), 256, 0, st>>>(b, n, s, c);
  scan_kernel<<<1, 1024, 0, st>>>(c, nbins, cur);
  scatter_kernel<<<blocks_of(n, 256), 256, 0, st>>>(
      b, static_cast<const uint32_t*>(idx), n, s, cur,
      static_cast<uint32_t*>(jobs));
  return static_cast<int>(cudaGetLastError());
}

// The same into nbins bins of cap slots (jobs[nbins * cap]) and an overflow
// list (ovf[n]); counts uint32 [nbins + 1], the last one the overflow's
// length.  keys != 0 also writes h1in/l2in beside each index.
extern "C" int gc_partition_fixed(const void* buckets, const void* idx,
                                  const void* h1in, const void* l2in,
                                  int64_t n, int s, int nbins, uint32_t cap,
                                  void* counts, void* jobs, void* jh1,
                                  void* jl2, void* ovf, void* oh1, void* ol2,
                                  int keys, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* c = static_cast<uint32_t*>(counts);
  clear_kernel<<<264, 256, 0, st>>>(c, static_cast<int64_t>(nbins) + 1);
  if (n > 0)
    partition_fixed_kernel<<<blocks_of(n, kBlock), kBlock, 0, st>>>(
        static_cast<const uint32_t*>(buckets),
        static_cast<const uint32_t*>(idx),
        static_cast<const uint32_t*>(h1in),
        static_cast<const uint32_t*>(l2in), n, s, cap, c,
        static_cast<uint32_t*>(jobs), static_cast<uint32_t*>(jh1),
        static_cast<uint32_t*>(jl2), c + nbins, static_cast<uint32_t*>(ovf),
        static_cast<uint32_t*>(oh1), static_cast<uint32_t*>(ol2), keys);
  return static_cast<int>(cudaGetLastError());
}

// The gather pass over gc_partition_fixed's bins; labels int32 [R, P] get
// each job's main-row label added.  out uint32 [slot blocks + ovf_blocks].
extern "C" int gc_gather_jobs(const void* packed2, int P, int s2, int k,
                              int nb_bits, uint32_t c1, uint32_t c2,
                              uint32_t c3, const void* rows, void* labels,
                              const void* counts, int nbins, uint32_t cap,
                              const void* jobs, const void* jh1,
                              const void* jl2, const void* ovf,
                              const void* oh1, const void* ol2, int keys,
                              int ovf_blocks, void* out, void* stream) {
  const Job J{static_cast<const uint8_t*>(packed2),
              static_cast<const uint4*>(rows), static_cast<int32_t*>(labels),
              P, s2, k, nb_bits, c1, c2, c3};
  const uint64_t slots = static_cast<uint64_t>(nbins) * cap;
  const unsigned sb = blocks_of(static_cast<int64_t>(slots), kBlock);
  const uint32_t* c = static_cast<const uint32_t*>(counts);
  gather_jobs_kernel<<<sb + ovf_blocks, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      J, static_cast<const uint32_t*>(jobs),
      static_cast<const uint32_t*>(jh1), static_cast<const uint32_t*>(jl2), c,
      cap, slots, c + nbins, static_cast<const uint32_t*>(ovf),
      static_cast<const uint32_t*>(oh1), static_cast<const uint32_t*>(ol2),
      keys, sb, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
