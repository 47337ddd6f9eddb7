// Query kernel: 2-bit wire batch -> per-window target labels.
//
// Replaces the device chain of cuclark_tpu/pipeline.py:classify_step_packed
// up to the labels, which XLA compiled on the TPU:
//   codec.unpack_codes      cuclark_tpu/codec.py:133
//   codec.extract_kmers     cuclark_tpu/codec.py:160
//   codec.revcomp/canonical cuclark_tpu/codec.py:88-101
//   hashdb.feistel_mix      cuclark_tpu/hashdb.py:75
//   probe._probe_qs_split   cuclark_tpu/probe.py:198 (+ _q_match_labels :73)
// and the mask by window validity.  The plain PyTorch version is
// cuclark_tpu_torch/probe.py:query_labels_plain.
//
// The same kernel replaces cuclark_tpu/pipeline.py:probe_part_step, one
// bucket-range part of a streamed table (plain version:
// probe.py:query_part_labels_plain).  Three arguments carry the part:
//   - (bucket_start, nb_local): main rows [bucket_start, bucket_start +
//     nb_local) are the part's rows 0..nb_local-1; a window whose main
//     bucket lies outside skips its main-row gather (the range mask of
//     cuclark_tpu/probe.py:_localize, :59-69; the TPU-only _spread_oob has
//     no counterpart);
//   - a null stash pointer: no stash probe (skip_stash, every part but 0);
//   - accumulate: add the labels into `labels` instead of writing them
//     (the acc + lab of cuclark_tpu/pipeline.py:811); an invalid window
//     leaves its accumulator as it is.
// bucket_start = 0, nb_local = NB, a stash and accumulate = 0 is the
// resident query.
//
// What bounds it on the card: two random 32 B row gathers per window, one
// into the main table (1.07 GB at the 64M-k-mer configuration, 22x the
// 50 MB L2, so nearly every main gather goes to device memory) and one into
// the stash (at most 2^20 rows = 33.6 MB, small enough to stay in L2).
// The arithmetic (k-mer assembly, revcomp, Feistel) is a few hundred integer
// operations per window and the wire bytes are read through L1.  A part call
// gathers main rows only for the windows whose bucket lies in its range, 1/P
// of them over P parts, so each part call costs the k-mer arithmetic and a
// P-th of the resident call's main gathers.
//
// Simple design: one thread per (read, window).  Each thread assembles its
// k-mer from the wire bytes, so no shared memory and no synchronisation; the
// many independent threads of a 65,536-read batch (8M windows) keep enough
// gathers in flight to cover the device-memory latency.  Each row is read as
// two 16 B loads through the read-only path.  Row offsets are 64-bit: at
// nb_bits 28 the main table is 8.6 GB.  Invalid windows (an N or padding
// inside) return before any gather, which also stands in for the TPU-only
// probe.spread_invalid.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cuclark_tpu_torch/kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Jellyfish reverse complement of a right-aligned 2k-bit k-mer
// (cuclark_tpu/codec.py:revcomp_np).
__device__ __forceinline__ uint64_t revcomp64(uint64_t x, int k) {
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) |
      ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return (~x) >> (64 - 2 * k);
}

// One slot of a qs row: [other x4 | meta x4], meta = quot15 << 17 |
// choice << 16 | label16.
__device__ __forceinline__ int32_t slot_label(uint32_t o, uint32_t meta,
                                              uint32_t other, uint32_t quot,
                                              uint32_t choice) {
  return (o == other && (meta >> 17) == quot && ((meta >> 16) & 1u) == choice)
             ? static_cast<int32_t>(meta & 0xFFFFu)
             : 0;
}

// Sum of the matching slots' labels in row `row` (0 on a miss), as
// cuclark_tpu/probe.py:_q_match_labels sums them.
__device__ __forceinline__ int32_t row_label(const uint4* __restrict__ rows,
                                             uint64_t row, uint32_t other,
                                             uint32_t quot, uint32_t choice) {
  const uint4 o = __ldg(rows + 2 * row);
  const uint4 m = __ldg(rows + 2 * row + 1);
  return slot_label(o.x, m.x, other, quot, choice) +
         slot_label(o.y, m.y, other, quot, choice) +
         slot_label(o.z, m.z, other, quot, choice) +
         slot_label(o.w, m.w, other, quot, choice);
}

__global__ void query_kernel(const uint8_t* __restrict__ packed2,
                             const uint8_t* __restrict__ vbits,
                             const uint4* __restrict__ main_rows,
                             const uint4* __restrict__ stash_rows,
                             int32_t* __restrict__ labels, int64_t n, int P,
                             int s2, int s8, int k, int nb_bits,
                             int stash_bits, uint64_t bucket_start,
                             uint64_t nb_local, int accumulate, uint32_t c1,
                             uint32_t c2, uint32_t c3) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t r = idx / P;
  const int p = static_cast<int>(idx - r * P);
  const uint8_t* pr = packed2 + r * s2;
  const uint8_t* vr = vbits + r * s8;

  // unpack + extract: code of position q is packed2[r, q>>2] >> 2*(q&3),
  // its valid bit vbits[r, q>>3] >> (q&7); first base most significant
  uint64_t km = 0;
  for (int j = 0; j < k; ++j) {
    const int q = p + j;
    if (!((__ldg(vr + (q >> 3)) >> (q & 7)) & 1)) {
      if (!accumulate) labels[idx] = 0;
      return;
    }
    km = (km << 2) | ((__ldg(pr + (q >> 2)) >> (2 * (q & 3))) & 3u);
  }

  // canonical: unsigned min of forward and reverse complement
  const uint64_t rc = revcomp64(km, k);
  const uint64_t c = rc < km ? rc : km;

  // 3-round Feistel on the u32 halves -> (h1, l2)
  const uint32_t hi = static_cast<uint32_t>(c >> 32);
  const uint32_t lo = static_cast<uint32_t>(c);
  const uint32_t l1 = lo ^ fmix32(hi + c1);
  const uint32_t h1 = hi ^ fmix32(l1 + c2);
  const uint32_t l2 = l1 ^ fmix32(h1 + c3);

  // main row l2 & (NB-1): other == h1, quotient l2 >> nb_bits, choice 0;
  // stash row h1 & (NBS-1): other == l2, quotient h1 >> stash_bits, choice 1.
  // The bucket and the range are compared in 64 bits, so the part row
  // b - bucket_start never wraps (bucket_start passes 2^31 at nb_bits 31).
  const uint64_t b = static_cast<uint64_t>(
      l2 & static_cast<uint32_t>((1ull << nb_bits) - 1));
  int32_t lab = 0;
  if (b >= bucket_start && b - bucket_start < nb_local)
    lab = row_label(main_rows, b - bucket_start, h1, l2 >> nb_bits, 0u);
  if (stash_rows != nullptr) {
    const uint32_t smask = static_cast<uint32_t>((1ull << stash_bits) - 1);
    lab += row_label(stash_rows, h1 & smask, l2, h1 >> stash_bits, 1u);
  }
  if (!accumulate)
    labels[idx] = lab;
  else if (lab != 0)
    labels[idx] += lab;
}

}  // namespace

// labels int32 [R, P] from packed2 uint8 [R, s2], vbits uint8 [R, s8],
// main int32 [nb_local, 8] (global main rows bucket_start.. of a table of
// 2^nb_bits), stash int32 [NBS, 8] or null; P = 4*s2 - k + 1.  With
// accumulate != 0 the labels are added into `labels`.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int cuclark_query(const void* packed2, const void* vbits,
                             const void* main_rows, const void* stash_rows,
                             void* labels, int64_t R, int P, int s2, int s8,
                             int k, int nb_bits, int stash_bits,
                             int64_t bucket_start, int64_t nb_local,
                             int accumulate, uint32_t c1, uint32_t c2,
                             uint32_t c3, void* stream) {
  const int64_t n = R * P;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  query_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed2), static_cast<const uint8_t*>(vbits),
      static_cast<const uint4*>(main_rows),
      static_cast<const uint4*>(stash_rows), static_cast<int32_t*>(labels), n,
      P, s2, s8, k, nb_bits, stash_bits, static_cast<uint64_t>(bucket_start),
      static_cast<uint64_t>(nb_local), accumulate, c1, c2, c3);
  return static_cast<int>(cudaGetLastError());
}
