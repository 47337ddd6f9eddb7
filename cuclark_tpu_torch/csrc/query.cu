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
// The stash carries a range of its own, (stash_start, nbs_local): the stash
// rows [stash_start, stash_start + nbs_local) of a qs table sharded over a
// mesh's db axis (cuclark_tpu/parallel/mesh.py:131-136, :199-205), checked
// in 64 bits like the main side; a stash bucket outside it skips its gather.
// stash_start = 0, nbs_local = NBS is the whole stash.  The db shards of one
// read batch are launches of this kernel with their ranges, their labels
// summed (the psum of build_sharded_classify and build_sharded_probe_part,
// mesh.py:96, :164): every key lives in one shard only.
//
// A second front half reads unpacked uint8 codes [R, L] instead of the wire
// format (cuclark_tpu/pipeline.py:classify_step, :48): the k-mer of window p
// is codes[r, p..p+k), and a byte >= 4 makes the window invalid.  The front
// half is a template parameter too, so the wire instances compile as they
// did.
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
// The q4 and s2 layouts (cuclark_tpu/probe.py:_probe_q4 :236 and the s2
// branch of probe.probe :131-155) share the front half (unpack, k-mer,
// canonical) and differ in the gathers; the layout is a template parameter,
// so each layout compiles to its own kernel and the qs code stays as it was:
//   - q4: the qs row format, both choices in the main rows: choice 0 row
//     l2 & (NB-1), other h1, quotient l2 >> nb_bits; choice 1 row
//     h1 & (NB-1), other l2, quotient h1 >> nb_bits.  Two cold 32 B gathers
//     into a 1 GB table instead of qs's one cold and one warm.
//   - s2: rows [klo x S | khi x S | label x S] of full keys, S = 1..255 at
//     run time, buckets mix1/mix2 of the canonical k-mer's u32 halves; the
//     labels of the slots whose two key words match are summed.  Choice 1
//     runs only with num_choices 2 and counts only when its global bucket
//     differs from choice 0's.  A row is 12*S bytes (24 B at S = 2), which
//     is not 16 B aligned, so it is read with 4 B loads: the S low key words
//     first, the high word and the label only on a match.
// In part mode each choice is range-checked on its own, so a key whose two
// buckets fall in different parts is found in exactly one of them.
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

enum Layout { kQs = 0, kQ4 = 1, kS2 = 2 };

// s2 bucket hashes (cuclark_tpu/hashdb.py:mix1/mix2, :55-62).
__device__ __forceinline__ uint32_t mix1(uint32_t hi, uint32_t lo) {
  return fmix32(lo ^ (hi * 0x9E3779B9u));
}
__device__ __forceinline__ uint32_t mix2(uint32_t hi, uint32_t lo) {
  return fmix32(hi ^ (lo * 0x85EBCA6Bu) ^ 0x5BD1E995u);
}

// Sum of the labels of the slots of s2 row `row` (S slots, 3*S words)
// whose key words equal (lo, hi), as the s2 branch of
// cuclark_tpu/probe.py:probe sums them.
__device__ __forceinline__ int32_t s2_row_label(
    const uint32_t* __restrict__ rows, uint64_t row, uint32_t lo, uint32_t hi,
    int S) {
  const uint32_t* r = rows + row * 3 * static_cast<uint64_t>(S);
  int32_t lab = 0;
  for (int j = 0; j < S; ++j) {
    if (__ldg(r + j) == lo && __ldg(r + S + j) == hi)
      lab += static_cast<int32_t>(__ldg(r + 2 * S + j));
  }
  return lab;
}

// One (read, window) per thread.  The canonical k-mer of the window, or
// false when the window holds an N or padding.
__device__ __forceinline__ bool window_kmer(const uint8_t* __restrict__ pr,
                                            const uint8_t* __restrict__ vr,
                                            int p, int k, uint64_t* out) {
  // unpack + extract: code of position q is packed2[r, q>>2] >> 2*(q&3),
  // its valid bit vbits[r, q>>3] >> (q&7); first base most significant
  uint64_t km = 0;
  for (int j = 0; j < k; ++j) {
    const int q = p + j;
    if (!((__ldg(vr + (q >> 3)) >> (q & 7)) & 1)) return false;
    km = (km << 2) | ((__ldg(pr + (q >> 2)) >> (2 * (q & 3))) & 3u);
  }
  // canonical: unsigned min of forward and reverse complement
  const uint64_t rc = revcomp64(km, k);
  *out = rc < km ? rc : km;
  return true;
}

// The same from unpacked codes: one byte per base, 0..3, >= 4 invalid.
__device__ __forceinline__ bool window_kmer_codes(
    const uint8_t* __restrict__ cr, int p, int k, uint64_t* out) {
  uint64_t km = 0;
  for (int j = 0; j < k; ++j) {
    const uint32_t c = __ldg(cr + p + j);
    if (c >= 4u) return false;
    km = (km << 2) | c;
  }
  const uint64_t rc = revcomp64(km, k);
  *out = rc < km ? rc : km;
  return true;
}

// CODES: packed2 is codes uint8 [R, s2] (s2 = L) and vbits is unused.
template <int LAYOUT, bool CODES>
__global__ void query_kernel(const uint8_t* __restrict__ packed2,
                             const uint8_t* __restrict__ vbits,
                             const void* __restrict__ main_rows,
                             const uint4* __restrict__ stash_rows,
                             int32_t* __restrict__ labels, int64_t n, int P,
                             int s2, int s8, int k, int nb_bits,
                             int stash_bits, uint64_t bucket_start,
                             uint64_t nb_local, uint64_t stash_start,
                             uint64_t nbs_local, int accumulate, uint32_t c1,
                             uint32_t c2, uint32_t c3, int slots,
                             int num_choices) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t r = idx / P;
  const int p = static_cast<int>(idx - r * P);
  uint64_t c;
  const bool valid =
      CODES ? window_kmer_codes(packed2 + r * s2, p, k, &c)
            : window_kmer(packed2 + r * s2, vbits + r * s8, p, k, &c);
  if (!valid) {
    if (!accumulate) labels[idx] = 0;
    return;
  }
  const uint32_t hi = static_cast<uint32_t>(c >> 32);
  const uint32_t lo = static_cast<uint32_t>(c);
  const uint32_t mask = static_cast<uint32_t>((1ull << nb_bits) - 1);
  // Buckets and the part's range are compared in 64 bits, so the part row
  // b - bucket_start never wraps (bucket_start passes 2^31 at nb_bits 31).
  int32_t lab = 0;
  if (LAYOUT == kS2) {
    const uint32_t* rows = static_cast<const uint32_t*>(main_rows);
    const uint64_t b1 = mix1(hi, lo) & mask;
    if (b1 >= bucket_start && b1 - bucket_start < nb_local)
      lab = s2_row_label(rows, b1 - bucket_start, lo, hi, slots);
    if (num_choices == 2) {
      const uint64_t b2 = mix2(hi, lo) & mask;
      if (b2 != b1 && b2 >= bucket_start && b2 - bucket_start < nb_local)
        lab += s2_row_label(rows, b2 - bucket_start, lo, hi, slots);
    }
  } else {
    // 3-round Feistel on the u32 halves -> (h1, l2)
    const uint32_t l1 = lo ^ fmix32(hi + c1);
    const uint32_t h1 = hi ^ fmix32(l1 + c2);
    const uint32_t l2 = l1 ^ fmix32(h1 + c3);
    const uint4* rows = static_cast<const uint4*>(main_rows);
    // main row l2 & (NB-1): other == h1, quotient l2 >> nb_bits, choice 0
    const uint64_t b = static_cast<uint64_t>(l2 & mask);
    if (b >= bucket_start && b - bucket_start < nb_local)
      lab = row_label(rows, b - bucket_start, h1, l2 >> nb_bits, 0u);
    if (LAYOUT == kQ4) {
      // q4: main row h1 & (NB-1): other == l2, quotient h1 >> nb_bits,
      // choice 1
      const uint64_t b1 = static_cast<uint64_t>(h1 & mask);
      if (b1 >= bucket_start && b1 - bucket_start < nb_local)
        lab += row_label(rows, b1 - bucket_start, l2, h1 >> nb_bits, 1u);
    } else if (stash_rows != nullptr) {
      // qs: stash row h1 & (NBS-1) of the range [stash_start, stash_start +
      // nbs_local): other == l2, quotient h1 >> stash_bits, choice 1
      const uint32_t smask = static_cast<uint32_t>((1ull << stash_bits) - 1);
      const uint64_t sb = static_cast<uint64_t>(h1 & smask);
      if (sb >= stash_start && sb - stash_start < nbs_local)
        lab += row_label(stash_rows, sb - stash_start, l2, h1 >> stash_bits,
                         1u);
    }
  }
  if (!accumulate)
    labels[idx] = lab;
  else if (lab != 0)
    labels[idx] += lab;
}

// One layout's kernel over one front half.
template <int LAYOUT>
void launch(bool codes, unsigned blocks, int threads, cudaStream_t st,
            const uint8_t* p2, const uint8_t* vb, const void* main_rows,
            const uint4* stash, int32_t* out, int64_t n, int P, int s2,
            int s8, int k, int nb_bits, int stash_bits, uint64_t start,
            uint64_t local, uint64_t sstart, uint64_t slocal, int accumulate,
            uint32_t c1, uint32_t c2, uint32_t c3, int slots,
            int num_choices) {
  if (codes)
    query_kernel<LAYOUT, true><<<blocks, threads, 0, st>>>(
        p2, vb, main_rows, stash, out, n, P, s2, s8, k, nb_bits, stash_bits,
        start, local, sstart, slocal, accumulate, c1, c2, c3, slots,
        num_choices);
  else
    query_kernel<LAYOUT, false><<<blocks, threads, 0, st>>>(
        p2, vb, main_rows, stash, out, n, P, s2, s8, k, nb_bits, stash_bits,
        start, local, sstart, slocal, accumulate, c1, c2, c3, slots,
        num_choices);
}

}  // namespace

// labels int32 [R, P] from packed2 uint8 [R, s2], vbits uint8 [R, s8] and
// the main rows (global rows bucket_start.. of a table of 2^nb_bits): layout
// 0 (qs) int32 [nb_local, 8] with stash int32 [nbs_local, 8] (global stash
// rows stash_start.. of 2^stash_bits) or null, layout 1 (q4) int32
// [nb_local, 8], layout 2 (s2) int32 [nb_local, 3*slots] with num_choices 1
// or 2; P = 4*s2 - k + 1.  With codes != 0, packed2 is codes uint8 [R, s2],
// vbits is unused and P = s2 - k + 1.  With accumulate != 0 the labels are
// added into `labels`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int cuclark_query(int layout, int codes, const void* packed2,
                             const void* vbits, const void* main_rows,
                             const void* stash_rows, void* labels, int64_t R,
                             int P, int s2, int s8, int k, int nb_bits,
                             int stash_bits, int64_t bucket_start,
                             int64_t nb_local, int64_t stash_start,
                             int64_t nbs_local, int accumulate, uint32_t c1,
                             uint32_t c2, uint32_t c3, int slots,
                             int num_choices, void* stream) {
  const int64_t n = R * P;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p2 = static_cast<const uint8_t*>(packed2);
  const uint8_t* vb = static_cast<const uint8_t*>(vbits);
  const uint4* stash = static_cast<const uint4*>(stash_rows);
  int32_t* out = static_cast<int32_t*>(labels);
  const uint64_t start = static_cast<uint64_t>(bucket_start);
  const uint64_t local = static_cast<uint64_t>(nb_local);
  const uint64_t sstart = static_cast<uint64_t>(stash_start);
  const uint64_t slocal = static_cast<uint64_t>(nbs_local);
  switch (layout) {
    case kQs:
      launch<kQs>(codes != 0, blocks, threads, st, p2, vb, main_rows, stash,
                  out, n, P, s2, s8, k, nb_bits, stash_bits, start, local,
                  sstart, slocal, accumulate, c1, c2, c3, slots, num_choices);
      break;
    case kQ4:
      launch<kQ4>(codes != 0, blocks, threads, st, p2, vb, main_rows,
                  nullptr, out, n, P, s2, s8, k, nb_bits, 0, start, local, 0,
                  0, accumulate, c1, c2, c3, slots, num_choices);
      break;
    case kS2:
      launch<kS2>(codes != 0, blocks, threads, st, p2, vb, main_rows,
                  nullptr, out, n, P, s2, s8, k, nb_bits, 0, start, local, 0,
                  0, accumulate, c1, c2, c3, slots, num_choices);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
