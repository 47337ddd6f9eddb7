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
// half is a template parameter: only the staging differs.
//
// What bounds it on the card: the random 32 B row gathers.  One per window
// goes into the main table (1.07 GB at the 64M-k-mer configuration, 22x
// the 50 MB L2, so nearly every one goes to device memory: 7.0M distinct
// rows, 225 MB, of a [65,536, 152] batch).  Random 32 B sectors reach a
// small share of the 3.35 TB/s that streaming does, so the resident call
// runs at about a fifth of its bytes bound.  scripts/torch_gather_ceiling.py
// measures the ceiling: on an H100 the same 7.86M main-row gathers alone, in
// window order, take 0.254 ms, 0.148 ms sorted by bucket and 0.153 ms in
// bins of 256 rows; but putting the windows in bucket order is itself a
// random 4 B scatter (0.26 ms at best), and the labels must then go back
// to window order, so the window-order gather is the practical ceiling and
// the kernel keeps the window order.
//
// The qs stash (2^20 rows = 33.6 MB at that configuration) does not stay
// in L2 beside the main rows' stream either.  On an H100 80GB HBM3 at
// 700 W (scripts/torch_stage_cut.py: copies of this file with a stage cut
// out, timed against it; PERF.md section 6), the fused step of a
// [65,536, 152] batch that read every window's stash row took 0.340 ms:
// 0.249 ms without the stash loads (under the main rows' gather-only
// ceiling, 0.254), 0.344 ms with them rotated over 8 copies of the stash
// (cold on purpose), and 0.262, 0.257 and 0.253 ms with the stash bucket
// masked to 19, 18 and 17 bits (16.8, 8.4 and 4.2 MB): a stash of 2^19
// rows stays in L2, one of 2^20 does not.  The score cut out saved
// nothing, and an evict_last L2 policy on the stash loads cost 4%.  So a
// qs call that holds every main row (the resident step, query_kernel's
// resident call, a 1 x 1 mesh's fused launch: the LATE instances, chosen
// by the C entries) reads a window's main row first and its stash row
// only where that row can hide the key (qs_label):
//   - every key of a table is stored once (cuclark_tpu/hashdb.py:493-495
//     rejects duplicates) with a 1-based label (:488-489), so an occupied
//     slot has a nonzero label field and an empty one is all zero;
//   - a key goes to the stash only when its main row is full, and no
//     placement ever empties a main slot: both builds only add to a row's
//     count (cuclark_tpu_torch/csrc/host_ops.cpp build_q4, occ[b]++;
//     cuclark_tpu_torch/hashdb.py _cuckoo_place, occ[cb] += 1; the same in
//     cuclark_tpu), so every stash key's main row is full;
//   - a load with a sample factor (cuclark_tpu_torch/hashdb.py
//     KmerDB.load, cuclark_tpu/hashdb.py:224-230) zeroes whole rows, main
//     and stash alike: a main row it keeps is as built, one it drops is
//     empty, and the table is marked `sampled` (TableSpec.sampled, the C
//     entries' `sampled` argument);
// so a main row that is not full holds every key of its bucket (in a
// sampled table, a main row that is neither full nor empty), and a window
// that misses it misses the stash too; a window that hits its main row
// gets 0 from the stash (its key is stored once).
// tests/test_torch_qs_stash.py holds both builds and both packages'
// sampled loads to this.  A window reads the stash only behind a full
// main row (or an empty one in a sampled table) that gives label 0 (the
// share of windows that do is torch_measure.fused_row's stash_share;
// PERF.md section 6).
// A range call (a part, a db shard) keeps both loads in flight: it holds
// both rows of few windows, and with the stash read late a warp's stash
// loads waited on its lanes' main rows (a pass of 4 parts ran 5% slower).
//
// A range call (a part of a streamed table, a db shard of a mesh) gathers
// only for the windows with a row in its range, about 1/parts of them, but
// runs the front half for all of them.  With a thread a window, as
// query_kernel, only that share of a warp's lanes gathered.  A range of at
// most half the table takes range_query_kernel instead: a block runs the
// front half for W = 2 or 4 tiles (the table's rows over the range's,
// capped at 4), queues the windows with a row in range in shared memory,
// and then every thread gathers from the queue.  On an H100 80GB HBM3 at
// 700 W (scripts/torch_kernel_ab.py, [65,536, 152] batches of the 64M-k-mer
// tables, per call; PERF.md section 6) that took a pass of 4 qs parts from
// 0.1280 to 0.1156 ms (0.1074 with the stash split over the parts, as a
// table is streamed), 4 q4 parts from 0.1522 to 0.1469 and 8 s2 parts from
// 0.1700 to 0.1089.
// The front half alone (the gathers cut out) takes 0.054 ms a call, bound
// by the instructions it issues, and the call takes about that plus the
// gathers' own time: the two did not overlap, with the block's barriers
// or without them (a block of warps that stage, queue and gather alone
// ran 1-3% slower), nor when a block issued one group's gathers before the
// next group's front half (the rows held across it took 48-96 registers a
// thread, and every layout ran slower).
//
// What the call without labels of reads of up to 1,024 windows (every
// short-read bin up to 1024: 150 bp reads at P = 122, joined 2 x 150 bp
// pairs at P = 290) does besides, for every layout:
// query_score_kernel<LAYOUT, T>, a block of T = ceil(P / kTile) tiles per
// read, scores the block's labels on chip and writes [R, 5] results, so the
// [R, P] labels (32 MB a batch at P = 122, 76 MB at P = 290) are neither
// written nor read again and the score kernel's launch goes away
// (pipeline.classify_step_packed without labels).  The same kernel ends a
// data block of a mesh step (cuclark_tpu/parallel/mesh.py:96) and the last
// part of a streamed step, on a mesh (:164) or on one device: it takes the
// ranges of the block's column-0 shard (or of the last part) and the other
// launches' label sum (acc_in), which it reads once and adds before the
// score, so neither that sum's write-back nor the score kernel's launch is
// paid (over a range that range_query_kernel queues, the last launch is
// range_query_score_kernel where it ran faster: its note below).  One
// tile is scored by warp 0 (warp_score.cuh) as before; wider
// reads count their labels into a distinct-label table in shared memory
// (count_label: a warp's lanes of one label add once; score_table: the top
// two of the table's exact counts), whose registers are the gathers':
// score.cu's warp path would hold the row in registers, 16 or 32 labels a
// lane.  On an H100 (nvcc 12.8, -Xptxas -v) the fused instances use qs 30,
// q4 28 (32-38 at five to eight tiles), s2 38-40 (32 past four tiles)
// registers a thread, no more than query_kernel's qs 30, q4 28, s2 40, so
// the gathers keep its occupancy (by the register count, 48 to 64 warps
// an SM).  A block takes the whole warps its P windows need (a paired
// block is 10 warps, not 12).
// On an H100 80GB HBM3 at 700 W a [65,536, 320] batch of pairs takes the
// fused step 0.674 ms (qs), 0.641 (q4) and 0.774 (s2) against 0.837,
// 0.770 and 0.920 as the query kernel then the score kernel, and the
// one-tile step kept its time (scripts/torch_kernel_ab.py).
// The front half (the k-mer of each window from the wire bytes, its
// reverse complement and the Feistel rounds), which every call runs for
// every window:
//   - a block per (read, tile of kTile windows): reads on gridDim.x (a
//     batch holds 65,536 of them, past gridDim.y's 65,535), tiles on
//     gridDim.y (65,535 tiles a launch), so no thread divides;
//   - the block stages the tile's bases [t0, t0 + kTile + 31) of its read
//     once into shared memory as two little-endian bitstrings of 32-bit
//     words, 2 bits a base and 1 validity bit a base, with byte loads (the
//     rows are 38 B and 19 B at bin 152, not 4 B aligned).  The codes
//     front half loads one byte a lane and packs the same two bitstrings
//     with a ballot and a 16-lane OR;
//   - window p's 2k bits are a funnel shift over three words, x.  Because
//     the wire format is little-endian, base p + j is field j of x, so the
//     reverse complement is ~x & (2^2k - 1) and the forward k-mer (first
//     base most significant) is pair-swap(bit-reverse(x)) >> (64 - 2k),
//     the pair swap exchanging the two bits of each 2-bit field.  The
//     window is valid when the k-bit slice of the validity bitstring from
//     bit p is all ones.
// A thread per window then gathers its rows and stores to labels[r * P +
// p] (coalesced).  Row offsets are 64-bit: at nb_bits 28 the main table is
// 8.6 GB.  A qs or q4 row is two 16 B loads: a qs main row with the
// streaming hint (evict first), so that the main rows, which a batch reads
// once, leave L2 before the stash rows do (on an H100 the resident qs
// query ran 12% faster so, when it read every stash row; q4 ran no
// faster), every other row through the read-only path.  qs reads its
// stash row after its main row, and only where qs_label needs it (above);
// q4 in a range call issues the loads of both its rows before it compares
// either.  Invalid windows (an N or padding inside) return before any
// gather, which also stands in for the TPU-only probe.spread_invalid.
//
// Lines between "// cut <tag> begin" and "// cut <tag> end" are the stages
// that scripts/torch_stage_cut.py replaces in timing-only copies of this
// file; no path of the package runs such a copy.
//
// The q4 and s2 layouts (cuclark_tpu/probe.py:_probe_q4 :236 and the s2
// branch of probe.probe :131-155) share the front half (staging, k-mer,
// canonical) and differ in the gathers; the layout is a template parameter,
// so each layout compiles to its own kernel:
//   - q4: the qs row format, both choices in the main rows: choice 0 row
//     l2 & (NB-1), other h1, quotient l2 >> nb_bits; choice 1 row
//     h1 & (NB-1), other l2, quotient h1 >> nb_bits.  Both are cold 32 B
//     gathers into a 1 GB table.
//   - s2: rows [klo x S | khi x S | label x S] of full keys, S = 1..255 at
//     run time, buckets mix1/mix2 of the canonical k-mer's u32 halves; the
//     labels of the slots whose two key words match are summed.  Choice 1
//     runs only with num_choices 2 and counts only when its global bucket
//     differs from choice 0's.  A row is 12*S bytes (24 B at S = 2), which
//     is not 16 B aligned, so it is read with 8 B loads when S is even (4 B
//     loads when it is odd): the S low key words first, the high words and
//     the labels only on a match, so a miss reads only the low key words.
//     On an H100 the 8 B loads ran faster than 4 B ones.
// Both gather choice 1 only when choice 0 gave label 0 (q4: in a resident
// call): the reference sums
// both choices (probe._probe_q4, the s2 loop), but once choice 0 gives a
// nonzero label choice 1 can only add 0, because
//   - every key of a table is unique, so a probe matches in at most one
//     slot of one choice (cuclark_tpu/hashdb.py:16-21; build_table rejects
//     duplicate k-mers, :493-495), and the Feistel mix is a bijection, so
//     a q4 slot that matches reconstructs the probed key itself;
//   - stored labels are 1-based (hashdb.py:23-24; build_table rejects
//     labels outside 1..MTRGTS, :488-489), so a matching slot gives a
//     nonzero label and its label alone is the row's sum;
//   - empty and sampled-out slots cannot make choice 0 look answered: q4's
//     are all zero (label 0; they match only a k-mer whose h1 and quotient
//     are 0, adding 0, hashdb.py:229-230), s2's hold EMPTY keys (label 0,
//     or EMPTY in every word when sampled out, :229-230, :730-732), and
//     no canonical k-mer has both halves 0xFFFFFFFF.
// So the branch is on a nonzero label, never on "a slot matched".  Both
// builds place every key they can at its first choice before any other
// (hashdb.py:_cuckoo_place :643-665, _try_build_np :722-745), and a
// window that hits, most of them in a read of the database's genomes,
// makes one cold gather instead of two.  A window that misses makes both,
// the second after the first.  On an H100, on a batch of 150 bp reads with
// 1% substitutions (29.5% of q4's and 35.2% of s2's windows take the
// second gather), the q4 query went from 0.534 to 0.353 ms and s2 from
// 0.588 to 0.420 ms; on a batch where every window misses both ran as
// fast as with both loads in flight (enough warps hide the wait).  Holding
// the kernel to 32 registers for 16 blocks an SM made s2 12% slower;
// loading an s2 slot pair's key and label words together gained 1% on the
// first batch and lost 13% on the all-miss one.
// In part mode each choice is range-checked on its own, so a key whose two
// buckets fall in different parts is found in exactly one of them; a
// window whose choice 0 lies outside the call's range probes choice 1 as
// before.  In query_kernel's range mode (a range of more than half the
// table, or a row of codes) a q4 call keeps both loads in flight (see
// kmer_label) and an s2 call skips as the resident one does;
// range_query_kernel gathers choice 1 after a choice-0 miss in a second
// round of its queue.
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

#include "warp_score.cuh"

// Windows per tile.  The windows of T tiles from a tile's start cover
// T * kTile + k - 1 <= T * kTile + 31 bases, staged rounded to 32 as
// w2_words(T) words of 2-bit codes and v_words(T) words of validity bits:
// window T * kTile - 1 reads 2-bit words up to w2_words(T) - 1 and
// validity words up to v_words(T) - 1.
constexpr int kTile = 128;
static_assert(kTile % 32 == 0, "tiles start on a validity word");
__host__ __device__ constexpr int w2_words(int tiles) {
  return (tiles * kTile + 32) / 16;
}
__host__ __device__ constexpr int v_words(int tiles) {
  return (tiles * kTile + 32) / 32;
}

// Stage the bases of T tiles from base t0 of one wire row (packed2 row pr
// of s2 bytes, vbits row vr of s8 bytes): a tile starts on a byte of both,
// so the words are the row's bytes from t0 / 4 and t0 / 8.  Bytes past the
// row stage as 0; only windows past P, which store nothing, or the bits
// above a window's 2k, which are masked off, read them.
template <int T>
__device__ __forceinline__ void stage_wire(const uint8_t* __restrict__ pr,
                                           const uint8_t* __restrict__ vr,
                                           int s2, int s8, int t0,
                                           uint32_t* w2, uint32_t* wv) {
  constexpr int kW2 = w2_words(T), kWv = v_words(T);
  uint8_t* b2 = reinterpret_cast<uint8_t*>(w2);
  uint8_t* bv = reinterpret_cast<uint8_t*>(wv);
  for (int i = threadIdx.x; i < 4 * (kW2 + kWv); i += blockDim.x) {
    if (i < 4 * kW2) {
      const int q = t0 / 4 + i;
      b2[i] = q < s2 ? __ldg(pr + q) : 0;
    } else {
      const int q = t0 / 8 + i - 4 * kW2;
      bv[i - 4 * kW2] = q < s8 ? __ldg(vr + q) : 0;
    }
  }
}

// The same from a row of L unpacked codes (0..3, >= 4 an N): warp w packs
// chunks of 32 bases, one byte a lane: its validity word by ballot, its two
// 2-bit words by an OR over each half-warp.  Positions past L stage as Ns.
// blockDim.x is kTile.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ cr,
                                            int L, int t0, uint32_t* w2,
                                            uint32_t* wv) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < v_words(1); c += kTile / 32) {
    const int q = t0 + 32 * c + lane;
    const uint32_t b = q < L ? __ldg(cr + q) : 4u;
    const uint32_t valid = __ballot_sync(kFull, b < 4u);
    uint32_t v2 = (b & 3u) << (2 * (lane & 15));
    v2 |= __shfl_xor_sync(kFull, v2, 8);
    v2 |= __shfl_xor_sync(kFull, v2, 4);
    v2 |= __shfl_xor_sync(kFull, v2, 2);
    v2 |= __shfl_xor_sync(kFull, v2, 1);
    if (lane == 0) {
      wv[c] = valid;
      w2[2 * c] = v2;
    } else if (lane == 16) {
      w2[2 * c + 1] = v2;
    }
  }
}

// The canonical k-mer of the block's window lp from the staged bitstrings,
// or false when the window holds an N or padding.
__device__ __forceinline__ bool window_kmer(const uint32_t* w2,
                                            const uint32_t* wv, int lp, int k,
                                            uint64_t* out) {
  // validity: the k bits from bit lp all ones (k <= 32: one funnel shift)
  const uint32_t v = __funnelshift_r(wv[lp >> 5], wv[(lp >> 5) + 1], lp & 31);
  const uint32_t vmask = kFull >> (32 - k);
  if ((v & vmask) != vmask) return false;
  // x: the 2k bits from bit 2 * lp; base lp + j is field j
  const int w = lp >> 4, s = (2 * lp) & 31;
  const uint32_t lo = __funnelshift_r(w2[w], w2[w + 1], s);
  const uint32_t hi = __funnelshift_r(w2[w + 1], w2[w + 2], s);
  const uint64_t mask = ~0ull >> (64 - 2 * k);
  const uint64_t x = ((static_cast<uint64_t>(hi) << 32) | lo) & mask;
  // forward k-mer, first base most significant: reverse the fields
  uint64_t y = __brevll(x);
  y = ((y >> 1) & 0x5555555555555555ull) | ((y & 0x5555555555555555ull) << 1);
  const uint64_t fwd = y >> (64 - 2 * k);
  // reverse complement (cuclark_tpu/codec.py:revcomp_np): complement each
  // base (3 - c = ~c) in place, the reversal undone by the little-endian x
  const uint64_t rc = ~x & mask;
  // canonical: unsigned min of forward and reverse complement
  *out = rc < fwd ? rc : fwd;
  return true;
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

// A qs row as two 16 B loads: others, metas.  STREAM: loaded with the
// streaming (evict-first) hint, for rows a batch reads once.
struct QRow {
  uint4 o, m;
};

template <bool STREAM>
__device__ __forceinline__ QRow load_row(const uint4* __restrict__ rows,
                                         uint64_t row) {
  if (STREAM) return {__ldcs(rows + 2 * row), __ldcs(rows + 2 * row + 1)};
  return {__ldg(rows + 2 * row), __ldg(rows + 2 * row + 1)};
}

// Sum of the matching slots' labels in a row (0 on a miss), as
// cuclark_tpu/probe.py:_q_match_labels sums them.
__device__ __forceinline__ int32_t row_label(const QRow& row, uint32_t other,
                                             uint32_t quot, uint32_t choice) {
  const uint4 o = row.o, m = row.m;
  return slot_label(o.x, m.x, other, quot, choice) +
         slot_label(o.y, m.y, other, quot, choice) +
         slot_label(o.z, m.z, other, quot, choice) +
         slot_label(o.w, m.w, other, quot, choice);
}

// Whether a key whose main bucket is a qs row's can lie in the stash: a
// key is stored in the stash only when its main row is full (an occupied
// slot has a nonzero label field; see the header), and in a table loaded
// with a sample factor (`sampled`) a zeroed main row may hide stash keys
// too.
__device__ __forceinline__ bool stash_may_hold(const QRow& row,
                                               bool sampled) {
  const uint4 m = row.m;
  const int used = ((m.x & 0xFFFFu) != 0) + ((m.y & 0xFFFFu) != 0) +
                   ((m.z & 0xFFFFu) != 0) + ((m.w & 0xFFFFu) != 0);
  return used == 4 || (sampled && used == 0);
}

// The label of a qs window from its main row (row r0 of `rows`, when in0)
// and its stash row (row r1 of `stash`, when in1), as
// cuclark_tpu/probe.py:_probe_qs_split sums them.  LATE (the instances of
// calls that hold every main row): the stash row after the main row, and
// only where the main row neither answers nor rules the stash out
// (stash_may_hold).  Otherwise (a range call, which holds both rows of
// few windows) both loads go out before either row is compared: with the
// stash read late a warp waits on its lanes' main rows before any stash
// load, and on an H100 a pass of 4 parts ran 5% slower so.
template <bool LATE>
__device__ __forceinline__ int32_t qs_label(const uint4* __restrict__ rows,
                                            uint64_t r0, bool in0,
                                            const uint4* __restrict__ stash,
                                            uint64_t r1, bool in1,
                                            uint32_t h1, uint32_t l2,
                                            int nb_bits, int stash_bits,
                                            bool sampled) {
  int32_t lab = 0;
  if (LATE) {
    if (in0) {
      const QRow row = load_row<true>(rows, r0);
      lab = row_label(row, h1, l2 >> nb_bits, 0u);
      in1 = in1 && lab == 0 && stash_may_hold(row, sampled);
    }
    if (in1)
      lab = row_label(load_row<false>(stash, r1), l2, h1 >> stash_bits, 1u);
    return lab;
  }
  QRow row0{}, row1{};
  if (in0) row0 = load_row<true>(rows, r0);
  if (in1) row1 = load_row<false>(stash, r1);
  if (in0) lab = row_label(row0, h1, l2 >> nb_bits, 0u);
  if (in1) lab += row_label(row1, l2, h1 >> stash_bits, 1u);
  return lab;
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
// cuclark_tpu/probe.py:probe sums them: the low key words first, the high
// words and the labels only on a match.  With S even a row is 8 B aligned
// and each pair of slots' words is one 8 B load.
__device__ __forceinline__ int32_t s2_row_label(
    const uint32_t* __restrict__ rows, uint64_t row, uint32_t lo, uint32_t hi,
    int S) {
  const uint32_t* r = rows + row * 3 * static_cast<uint64_t>(S);
  int32_t lab = 0;
  if ((S & 1) == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(r);
    const int H = S / 2;
    for (int j = 0; j < H; ++j) {
      const uint2 kl = __ldg(v + j);
      const bool m0 = kl.x == lo, m1 = kl.y == lo;
      if (m0 || m1) {
        // cut s2_high begin
        const uint2 kh = __ldg(v + H + j);
        const uint2 lb = __ldg(v + 2 * H + j);
        if (m0 && kh.x == hi) lab += static_cast<int32_t>(lb.x);
        if (m1 && kh.y == hi) lab += static_cast<int32_t>(lb.y);
        // cut s2_high end
      }
    }
    return lab;
  }
  for (int j = 0; j < S; ++j) {
    if (__ldg(r + j) == lo && __ldg(r + S + j) == hi)
      lab += static_cast<int32_t>(__ldg(r + 2 * S + j));
  }
  return lab;
}

// The label of canonical k-mer c: the sum of the matching slots' labels of
// its rows, main rows [bucket_start, bucket_start + nb_local) of `main_rows`
// and, for qs, stash rows [stash_start, stash_start + nbs_local) of
// `stash_rows` (null: no stash probe); 0 on a miss.  LATE: qs_label's.
template <int LAYOUT, bool LATE>
__device__ __forceinline__ int32_t kmer_label(
    uint64_t c, const void* __restrict__ main_rows,
    const uint4* __restrict__ stash_rows, int nb_bits, int stash_bits,
    uint64_t bucket_start, uint64_t nb_local, uint64_t stash_start,
    uint64_t nbs_local, uint32_t c1, uint32_t c2, uint32_t c3, int slots,
    int num_choices, bool sampled) {
  const uint32_t hi = static_cast<uint32_t>(c >> 32);
  const uint32_t lo = static_cast<uint32_t>(c);
  const uint32_t mask = static_cast<uint32_t>((1ull << nb_bits) - 1);
  // Buckets and the part's range are compared in 64 bits, so the part row
  // b - bucket_start never wraps (bucket_start passes 2^31 at nb_bits 31).
  int32_t lab = 0;
  if (LAYOUT == kS2) {
    // choice 1 only when choice 0 gave label 0, and only when its global
    // bucket differs from choice 0's
    const uint32_t* rows = static_cast<const uint32_t*>(main_rows);
    const uint64_t b1 = mix1(hi, lo) & mask;
    // cut s2_gathers begin
    if (b1 >= bucket_start && b1 - bucket_start < nb_local)
      lab = s2_row_label(rows, b1 - bucket_start, lo, hi, slots);
    if (lab == 0 && num_choices == 2) {
      const uint64_t b2 = mix2(hi, lo) & mask;
      if (b2 != b1 && b2 >= bucket_start && b2 - bucket_start < nb_local)
        lab = s2_row_label(rows, b2 - bucket_start, lo, hi, slots);
    }
    // cut s2_gathers end
  } else {
    // 3-round Feistel on the u32 halves -> (h1, l2)
    const uint32_t l1 = lo ^ fmix32(hi + c1);
    const uint32_t h1 = hi ^ fmix32(l1 + c2);
    const uint32_t l2 = l1 ^ fmix32(h1 + c3);
    const uint4* rows = static_cast<const uint4*>(main_rows);
    // choice 0: main row l2 & (NB-1), other h1, quotient l2 >> nb_bits
    const uint64_t b0 = static_cast<uint64_t>(l2 & mask);
    const bool in0 = b0 >= bucket_start && b0 - bucket_start < nb_local;
    // choice 1, other l2: q4's main row h1 & (NB-1), quotient h1 >>
    // nb_bits; qs's stash row h1 & (NBS-1) of the range [stash_start,
    // stash_start + nbs_local), quotient h1 >> stash_bits
    const uint4* rows1 = rows;
    uint64_t b1 = static_cast<uint64_t>(h1 & mask), start1 = bucket_start,
             local1 = nb_local;
    int bits1 = nb_bits;
    if (LAYOUT == kQs) {
      rows1 = stash_rows;
      // cut stash_bucket begin
      b1 = h1 & static_cast<uint32_t>((1ull << stash_bits) - 1);
      // cut stash_bucket end
      start1 = stash_start;
      local1 = nbs_local;
      bits1 = stash_bits;
    }
    const bool in1 = (LAYOUT == kQ4 || stash_rows != nullptr) &&
                     b1 >= start1 && b1 - start1 < local1;
    if (LAYOUT == kQ4 && nb_local == (1ull << nb_bits)) {
      // resident q4: choice 1 only when choice 0 gave label 0
      if (in0) lab = row_label(load_row<false>(rows, b0), h1, l2 >> nb_bits,
                               0u);
      if (lab == 0 && in1)
        lab = row_label(load_row<false>(rows, b1), l2, h1 >> nb_bits, 1u);
    } else if (LAYOUT == kQs) {
      // cut gathers begin
      lab = qs_label<LATE>(rows, b0 - bucket_start, in0, rows1, b1 - start1,
                           in1, h1, l2, nb_bits, bits1, sampled);
      // cut gathers end
    } else {
      // a q4 range call (a part or a db shard) finds both choices in its
      // range for few windows: both rows' loads are in flight before
      // either is compared (on an H100 it ran 4.5% slower with choice 1
      // waiting on choice 0's label)
      QRow row0{}, row1{};
      if (in0) row0 = load_row<false>(rows, b0 - bucket_start);
      if (in1) row1 = load_row<false>(rows1, b1 - start1);
      if (in0) lab = row_label(row0, h1, l2 >> nb_bits, 0u);
      if (in1) lab += row_label(row1, l2, h1 >> bits1, 1u);
    }
  }
  return lab;
}

// A block per (read r = blockIdx.x, tile of kTile windows from t0 =
// (tile_base + blockIdx.y) * kTile), a thread per window.  CODES: packed2
// is codes uint8 [R, s2] (s2 = L) and vbits is unused.  LATE: qs_label's.
template <int LAYOUT, bool CODES, bool LATE>
__global__ void __launch_bounds__(kTile) query_kernel(
    const uint8_t* __restrict__ packed2, const uint8_t* __restrict__ vbits,
    const void* __restrict__ main_rows, const uint4* __restrict__ stash_rows,
    int32_t* __restrict__ labels, int P, int s2, int s8, int k, int nb_bits,
    int stash_bits, uint64_t bucket_start, uint64_t nb_local,
    uint64_t stash_start, uint64_t nbs_local, int accumulate, uint32_t c1,
    uint32_t c2, uint32_t c3, int slots, int num_choices, int tile_base,
    int sampled) {
  __shared__ uint32_t w2[w2_words(1)];
  __shared__ uint32_t wv[v_words(1)];
  const int64_t r = blockIdx.x;
  const int t0 = (tile_base + static_cast<int>(blockIdx.y)) * kTile;
  if (CODES)
    stage_codes(packed2 + r * s2, s2, t0, w2, wv);
  else
    stage_wire<1>(packed2 + r * s2, vbits + r * s8, s2, s8, t0, w2, wv);
  __syncthreads();
  const int p = t0 + threadIdx.x;
  if (p >= P) return;
  const int64_t idx = r * P + p;
  uint64_t c;
  if (!window_kmer(w2, wv, threadIdx.x, k, &c)) {
    if (!accumulate) labels[idx] = 0;
    return;
  }
  const int32_t lab = kmer_label<LAYOUT, LATE>(
      c, main_rows, stash_rows, nb_bits, stash_bits, bucket_start, nb_local,
      stash_start, nbs_local, c1, c2, c3, slots, num_choices, sampled != 0);
  if (!accumulate)
    labels[idx] = lab;
  else if (lab != 0)
    labels[idx] += lab;
}

// Bytes of one staged tile: w2_words(1) words of 2-bit codes and v_words(1)
// of validity bits.
constexpr int kUnitBytes = 4 * (w2_words(1) + v_words(1));

// A window's entry in range_query_kernel's gather queue: its window in the
// block (bits 0-9), whether its choice-0 row (qs: main row) lies in the
// call's range (bit 10) and whether its choice-1 row (qs: stash row) does
// (bit 11); the two words a and b are qs's and q4's Feistel halves (h1,
// l2), s2's key halves (lo, hi).
constexpr uint32_t kIn0 = 1u << 10, kIn1 = 1u << 11;

// The range flags and queue words of canonical k-mer c (0: no row of the
// window lies in the call's ranges, and it gathers nothing).  A range is
// (first global row, rows) in 32 bits: buckets and both ends lie in
// [0, 2^31] (cuclark_query_range takes nb_bits and stash_bits up to 31), so
// b - start wraps past every row count when b < start.
template <int LAYOUT>
__device__ __forceinline__ uint32_t range_entry(
    uint64_t c, bool stash, uint32_t mask, uint32_t smask, uint32_t start,
    uint32_t local, uint32_t sstart, uint32_t slocal, uint32_t c1,
    uint32_t c2, uint32_t c3, int num_choices, uint32_t* a, uint32_t* b) {
  const uint32_t hi = static_cast<uint32_t>(c >> 32);
  const uint32_t lo = static_cast<uint32_t>(c);
  uint32_t b0, b1, start1 = start, local1 = local;
  bool has1 = true;
  if (LAYOUT == kS2) {
    *a = lo;
    *b = hi;
    b0 = mix1(hi, lo) & mask;
    b1 = mix2(hi, lo) & mask;
    has1 = num_choices == 2 && b1 != b0;
  } else {
    const uint32_t l1 = lo ^ fmix32(hi + c1);
    const uint32_t h1 = hi ^ fmix32(l1 + c2);
    const uint32_t l2 = l1 ^ fmix32(h1 + c3);
    *a = h1;
    *b = l2;
    b0 = l2 & mask;
    b1 = h1 & mask;
    if (LAYOUT == kQs) {
      b1 = h1 & smask;
      start1 = sstart;
      local1 = slocal;
      has1 = stash;
    }
  }
  const bool in0 = b0 - start < local;
  const bool in1 = has1 && b1 - start1 < local1;
  return (in0 ? kIn0 : 0u) | (in1 ? kIn1 : 0u);
}

// The calling lane's slot in a block's queue of *n entries when `push`
// (else any value): a ballot and one shared atomic a warp.  Every lane of
// the warp calls it.
__device__ __forceinline__ int queue_slot(bool push, int* n) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(kFull, push);
  if (m == 0) return 0;
  int slot = 0;
  if (lane == 0) slot = atomicAdd(n, __popc(m));
  return __shfl_sync(kFull, slot, 0) + __popc(m & ((1u << lane) - 1));
}

// The label of a queued window (range_entry's words a, b) over the
// call's ranges (first rows start, sstart): qs from its main and stash
// rows where in0 and in1, both loads in flight; q4 and s2 from its
// choice-0 row where choice0, else from its choice-1 row.
template <int LAYOUT>
__device__ __forceinline__ int32_t entry_label(
    bool choice0, bool in1, uint32_t a, uint32_t b,
    const void* __restrict__ main_rows, const uint4* __restrict__ stash_rows,
    uint32_t mask, uint32_t smask, uint32_t start, uint32_t sstart,
    int nb_bits, int stash_bits, int slots) {
  const uint4* rows4 = static_cast<const uint4*>(main_rows);
  if (LAYOUT == kQs)
    // main row l2 & (NB-1), stash row h1 & (NBS-1)
    return qs_label<false>(rows4, (b & mask) - start, choice0, stash_rows,
                           (a & smask) - sstart, in1, a, b, nb_bits,
                           stash_bits, true);
  if (LAYOUT == kQ4)
    return choice0 ? row_label(load_row<false>(rows4, (b & mask) - start), a,
                               b >> nb_bits, 0u)
                   : row_label(load_row<false>(rows4, (a & mask) - start), b,
                               a >> nb_bits, 1u);
  const uint32_t row = (choice0 ? mix1(b, a) : mix2(b, a)) & mask;
  return s2_row_label(static_cast<const uint32_t*>(main_rows), row - start,
                      a, b, slots);
}

// The range query for calls that read a small share of the table (a part
// of a streamed table, a db shard of a mesh): a block of kTile threads
// stages W tile-units, reads_per_block reads of tiles_per_block tiles from
// tile (tile_base + blockIdx.y) * tiles_per_block (reads_per_block *
// tiles_per_block <= W), runs the front half for every window of them
// (W a thread), and queues in shared memory the windows that have a row in
// the call's ranges, a warp's slots found by a ballot and one shared
// atomic.  Then every thread drains the queue, a stride of kTile apart, so
// every lane gathers, not the 1/parts of them whose window's row lies in
// the range as in query_kernel.  qs loads a window's main and stash rows
// before it compares either.  A q4 or s2 window gathers its choice-0 row
// when that lies in the range, else its choice-1 row; one whose choice-0
// row misses (label 0) while its choice-1 row lies in the range too goes
// into a second queue and gathers that row after a barrier.  Windows that
// queue nothing store label 0 (or leave their accumulator as it is); a
// queued one stores its label once, after its last gather.  The front half
// is bound by the instructions it issues, so a unit's read and tile are
// stepped without a division, its labels' offset is kept in shared memory
// for the drain, and ranges are compared in 32 bits.  s2 is held to 40
// registers a thread (12 blocks an SM; at 48 its pass of 8 parts ran 7%
// slower on an H100), qs and q4 to 32 (16 blocks, their count without the
// bound).
template <int LAYOUT, int W>
__global__ void __launch_bounds__(kTile, LAYOUT == kS2 ? 12 : 16)
    range_query_kernel(
        const uint8_t* __restrict__ packed2,
        const uint8_t* __restrict__ vbits, const void* __restrict__ main_rows,
        const uint4* __restrict__ stash_rows, int32_t* __restrict__ labels,
        int64_t R, int P, int s2, int s8, int k, int nb_bits, int stash_bits,
        uint64_t bucket_start, uint64_t nb_local, uint64_t stash_start,
        uint64_t nbs_local, int accumulate, uint32_t c1, uint32_t c2,
        uint32_t c3, int slots, int num_choices, int reads_per_block,
        int tiles_per_block, int tile_base) {
  __shared__ uint32_t w2[W][w2_words(1)];
  __shared__ uint32_t wv[W][v_words(1)];
  __shared__ int64_t ubase[W];
  __shared__ uint16_t q_id[W * kTile];
  __shared__ uint32_t q_a[W * kTile], q_b[W * kTile];
  __shared__ uint16_t q2[LAYOUT == kQs ? 1 : W * kTile];
  __shared__ int q_n, q2_n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int Tb = tiles_per_block;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * reads_per_block;
  const int tb0 = (tile_base + static_cast<int>(blockIdx.y)) * Tb;
  const int T = (P + kTile - 1) / kTile;
  const uint32_t mask = static_cast<uint32_t>((1ull << nb_bits) - 1);
  const uint32_t smask = static_cast<uint32_t>((1ull << stash_bits) - 1);
  const uint32_t start = static_cast<uint32_t>(bucket_start);
  const uint32_t local = static_cast<uint32_t>(nb_local);
  if (tid == 0) {
    q_n = 0;
    q2_n = 0;
  }
  // stage each unit's tile as stage_wire<1> does: unit u = g * Tb + tt is
  // tile tb0 + tt of read r0 + g, stepped without a division; a unit past
  // the batch stages zeros and stores nothing
  {
    int g = 0, tt = 0;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int64_t r = r0 + g;
      const int t = tb0 + tt;
      const bool live = g < reads_per_block && r < R && t < T;
      if (tid < 4 * w2_words(1)) {
        const int q = t * (kTile / 4) + tid;
        reinterpret_cast<uint8_t*>(w2[u])[tid] =
            live && q < s2 ? __ldg(packed2 + r * s2 + q) : 0;
      } else if (tid < kUnitBytes) {
        const int j = tid - 4 * w2_words(1), q = t * (kTile / 8) + j;
        reinterpret_cast<uint8_t*>(wv[u])[j] =
            live && q < s8 ? __ldg(vbits + r * s8 + q) : 0;
      }
      if (++tt == Tb) {
        tt = 0;
        ++g;
      }
    }
  }
  __syncthreads();
  {
    int g = 0, tt = 0;
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int64_t r = r0 + g;
      const int t0 = (tb0 + tt) * kTile;
      const int64_t base = r * P + t0;
      const bool here = g < reads_per_block && r < R && t0 + tid < P;
      if (tid == 0) ubase[u] = base;
      uint32_t flags = 0, a = 0, b = 0;
      uint64_t c;
      if (here && window_kmer(w2[u], wv[u], tid, k, &c))
        flags = range_entry<LAYOUT>(
            c, stash_rows != nullptr, mask, smask, start, local,
            static_cast<uint32_t>(stash_start),
            static_cast<uint32_t>(nbs_local), c1, c2, c3, num_choices, &a,
            &b);
      if (here && flags == 0 && !accumulate) labels[base + tid] = 0;
      const unsigned m = __ballot_sync(kFull, flags != 0);
      if (m != 0) {
        int slot = 0;
        if (lane == 0) slot = atomicAdd(&q_n, __popc(m));
        slot = __shfl_sync(kFull, slot, 0) + __popc(m & ((1u << lane) - 1));
        if (flags != 0) {
          q_id[slot] = static_cast<uint16_t>((u * kTile + tid) | flags);
          q_a[slot] = a;
          q_b[slot] = b;
        }
      }
      if (++tt == Tb) {
        tt = 0;
        ++g;
      }
    }
  }
  __syncthreads();
  // a queued window's label: written once, or added to its accumulator
  auto store = [&](uint32_t id, int32_t lab) {
    int32_t* out = labels + ubase[(id >> 7) & (W - 1)] + (id & 127u);
    if (!accumulate)
      *out = lab;
    else if (lab != 0)
      *out += lab;
  };
  const int n = q_n;
  const uint4* rows4 = static_cast<const uint4*>(main_rows);
  const uint32_t* rows_s2 = static_cast<const uint32_t*>(main_rows);
  for (int e0 = 0; e0 < n; e0 += kTile) {
    const int e = e0 + tid;
    bool again = false;
    if (e < n) {
      const uint32_t id = q_id[e], a = q_a[e], b = q_b[e];
      const bool in0 = id & kIn0, in1 = id & kIn1;
      int32_t lab = 0;
      if (LAYOUT == kQs) {
        // main row l2 & (NB-1), stash row h1 & (NBS-1)
        lab = qs_label<false>(
            rows4, (b & mask) - start, in0, stash_rows,
            (a & smask) - static_cast<uint32_t>(stash_start), in1, a, b,
            nb_bits, stash_bits, true);
      } else if (LAYOUT == kQ4) {
        if (in0)
          lab = row_label(load_row<false>(rows4, (b & mask) - start), a,
                          b >> nb_bits, 0u);
        else
          lab = row_label(load_row<false>(rows4, (a & mask) - start), b,
                          a >> nb_bits, 1u);
      } else {
        const uint32_t row = (in0 ? mix1(b, a) : mix2(b, a)) & mask;
        lab = s2_row_label(rows_s2, row - start, a, b, slots);
      }
      again = LAYOUT != kQs && in0 && in1 && lab == 0;
      if (!again) store(id, lab);
    }
    if (LAYOUT != kQs) {
      const unsigned m = __ballot_sync(kFull, again);
      if (m != 0) {
        int slot = 0;
        if (lane == 0) slot = atomicAdd(&q2_n, __popc(m));
        slot = __shfl_sync(kFull, slot, 0) + __popc(m & ((1u << lane) - 1));
        if (again) q2[slot] = static_cast<uint16_t>(e);
      }
    }
  }
  if (LAYOUT == kQs) return;
  __syncthreads();
  // the second round: choice 1 of the windows whose choice 0 missed
  const int n2 = q2_n;
  for (int i = tid; i < n2; i += kTile) {
    const int e = q2[i];
    const uint32_t id = q_id[e], a = q_a[e], b = q_b[e];
    int32_t lab;
    if (LAYOUT == kQ4)
      lab = row_label(load_row<false>(rows4, (a & mask) - start), b,
                      a >> nb_bits, 1u);
    else
      lab = s2_row_label(rows_s2, (mix2(b, a) & mask) - start, a, b, slots);
    store(id, lab);
  }
}

// The fused query and score takes reads of up to kMaxTiles tiles, the
// rows of score.cu's warp path (kWarpMax = 1,024 windows).
constexpr int kMaxTiles = 8;

// Slots of a block's distinct-label table for T tiles: a power of two of at
// least twice the block's windows, so linear probing finds a free slot in
// a step or two.
__host__ __device__ constexpr int table_slots(int tiles) {
  int n = 1;
  while (n < 2 * kTile * tiles) n <<= 1;
  return n;
}
__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n >> 1);
}

// Counts the label of the calling thread's window into the block's table
// of SLOTS slots (keys[i] a label, 0 a free slot; counts[i] its windows):
// the warp's lanes of one positive label are grouped by __match_any_sync
// and the lowest of them adds the group's size once.  Every lane of the
// warp calls it.
template <int SLOTS>
__device__ __forceinline__ void count_label(int32_t* keys, uint32_t* counts,
                                            int32_t lab) {
  const unsigned peers = __match_any_sync(kFull, lab > 0 ? lab : 0);
  if (lab <= 0 || static_cast<int>(threadIdx.x & 31) != __ffs(peers) - 1)
    return;
  uint32_t h =
      (static_cast<uint32_t>(lab) * 0x9E3779B1u) >> (32 - log2_of(SLOTS));
  for (;; h = (h + 1) & (SLOTS - 1)) {
    const int32_t prev = atomicCAS(keys + h, 0, lab);
    if (prev == 0 || prev == lab) {
      atomicAdd(counts + h, static_cast<uint32_t>(__popc(peers)));
      return;
    }
  }
}

// b1, b2 := the top two of {b1, b2, c1, c2}: two sets of keys of distinct
// labels, each given by its top two (b1 >= b2, c1 >= c2; 0 for none).
__device__ __forceinline__ void merge_top2(unsigned long long& b1,
                                           unsigned long long& b2,
                                           unsigned long long c1,
                                           unsigned long long c2) {
  if (c1 > b1) {
    b2 = b1 > c2 ? b1 : c2;
    b1 = c1;
  } else if (c1 > b2) {
    b2 = c1;
  }
}

// The warp's top two keys, in every lane (a butterfly: the lanes merged
// at each step hold disjoint sets).
__device__ __forceinline__ void warp_top2(unsigned long long& b1,
                                          unsigned long long& b2) {
  for (int o = 16; o > 0; o >>= 1)
    merge_top2(b1, b2, __shfl_xor_sync(kFull, b1, o),
               __shfl_xor_sync(kFull, b2, o));
}

// Scores the block's table into out[0..5): every label of the table has
// its exact count, so the best is the largest run_key (count, label) of its
// slots and the second the next largest, which is of another label; total
// is the sum of the counts.  Each thread keeps the top two of the slots it
// reads, each warp merges them, then warp 0 merges the warps' (red and
// red_total hold a slot a warp).
template <int SLOTS>
__device__ __forceinline__ void score_table(const int32_t* keys,
                                            const uint32_t* counts,
                                            unsigned long long* red,
                                            int* red_total, int32_t* out) {
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long b1 = 0, b2 = 0;
  int total = 0;
  for (int i = threadIdx.x; i < SLOTS; i += blockDim.x) {
    const int32_t v = keys[i];
    if (v > 0) {
      const uint32_t n = counts[i];
      total += static_cast<int>(n);
      keep_top2(run_key(n, v), b1, b2);
    }
  }
  warp_top2(b1, b2);
  total = warp_sum(total);
  if (lane == 0) {
    red[2 * warp] = b1;
    red[2 * warp + 1] = b2;
    red_total[warp] = total;
  }
  __syncthreads();
  if (warp != 0) return;
  b1 = lane < warps ? red[2 * lane] : 0ull;
  b2 = lane < warps ? red[2 * lane + 1] : 0ull;
  warp_top2(b1, b2);
  total = warp_sum(lane < warps ? red_total[lane] : 0);
  if (lane == 0) write_result(out, total, b1, b2);
}

// Windows a thread of the fused kernel takes for reads of T tiles of a
// layout: one for qs and q4; for s2 three at three tiles (the paired 320
// bin: a thread's three windows, their dependent gathers in flight
// together, ran 14% faster than a window a thread on an H100) and two
// past four tiles (a block of one thread a window, at 38 registers a
// thread, would take an SM's registers alone), else one.  fused_threads
// is a block's most threads; a launch takes whole warps enough for its P
// windows (fused_block), so the empty end of a read's last tile holds no
// warps, and one tile keeps its kTile threads.
__host__ __device__ constexpr int fused_windows(int layout, int tiles) {
  return layout != kS2 ? 1 : tiles == 3 ? 3 : tiles > 4 ? 2 : 1;
}
__host__ __device__ constexpr int fused_threads(int layout, int tiles) {
  return kTile * tiles / fused_windows(layout, tiles);
}
int fused_block(int layout, int tiles, int P) {
  if (tiles == 1) return kTile;
  const int per = fused_windows(layout, tiles);
  return 32 * ((P + 32 * per - 1) / (32 * per));
}

// Query and score of reads of T tiles (P <= T * kTile windows, T <=
// kMaxTiles): a block per read stages the read's bases [0, T * kTile + 32)
// once; each thread runs query_kernel's wire front half and gathers over
// the call's ranges for its windows p = threadIdx.x + i * blockDim.x
// (fused_windows of them), then the labels are scored into results row r.
// One tile (T = 1) is scored by warp 0 from shared memory (warp_score.cuh,
// score.cu's warp path); wider reads count each label into the block's
// distinct-label table in shared memory (count_label) and score the table
// (score_table).  The labels never reach device memory.  stash_rows and
// stash_bits are qs's (null: no stash probe, as in query_kernel's part
// mode); slots and num_choices s2's.  The ranges are query_kernel's: the
// whole table for the resident step, one db shard (of one part) for the
// last launch of a data block of a mesh step or of a streamed batch's last
// part.  acc_in, when not null, is the int32 [R, P] sum of the block's
// other launches (the other db shards, the earlier parts): window p's
// label is acc_in[r, p] plus its own, read once, coalesced, and never
// written back.  An invalid window adds nothing to acc_in's value (0
// there: no launch gives it a label).
template <int LAYOUT, int T, bool LATE>
__global__ void __launch_bounds__(fused_threads(LAYOUT, T))
    query_score_kernel(
        const uint8_t* __restrict__ packed2,
        const uint8_t* __restrict__ vbits, const void* __restrict__ main_rows,
        const uint4* __restrict__ stash_rows,
        const int32_t* __restrict__ acc_in, int32_t* __restrict__ results,
        int P, int s2, int s8, int k, int nb_bits, int stash_bits,
        uint64_t bucket_start, uint64_t nb_local, uint64_t stash_start,
        uint64_t nbs_local, uint32_t c1, uint32_t c2, uint32_t c3, int slots,
        int num_choices, int sampled) {
  constexpr int kWin = fused_windows(LAYOUT, T);
  constexpr int kSlots = table_slots(T);
  __shared__ uint32_t w2[w2_words(T)];
  __shared__ uint32_t wv[v_words(T)];
  __shared__ int32_t keys[kSlots];
  __shared__ uint32_t counts[kSlots];
  const int64_t r = blockIdx.x;
  // the incoming sum's loads go out before the staging and the gathers
  int32_t lab[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    lab[i] = acc_in != nullptr && p < P ? __ldg(acc_in + r * P + p) : 0;
  }
  if constexpr (T > 1) {
    for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
      keys[i] = 0;
      counts[i] = 0;
    }
  }
  stage_wire<T>(packed2 + r * s2, vbits + r * s8, s2, s8, 0, w2, wv);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWin; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    uint64_t c;
    if (p < P && window_kmer(w2, wv, p, k, &c))
      lab[i] += kmer_label<LAYOUT, LATE>(
          c, main_rows, stash_rows, nb_bits, stash_bits, bucket_start,
          nb_local, stash_start, nbs_local, c1, c2, c3, slots, num_choices,
          sampled != 0);
  }
  // cut score begin
  if constexpr (T == 1) {
    __shared__ int32_t lab_s[kTile];
    const int p = threadIdx.x;
    lab_s[p] = lab[0];
    __syncthreads();
    if (p >= 32) return;
    constexpr int E = kTile / 32;
    int32_t a[E];
    int total = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = lab_s[32 * e + p];
      total += a[e] > 0;
    }
    warp_score<E>(a, total, p, results + r * 5);
  } else {
    constexpr int kWarps = fused_threads(LAYOUT, T) / 32;
    __shared__ unsigned long long red[2 * kWarps];
    __shared__ int red_total[kWarps];
#pragma unroll
    for (int i = 0; i < kWin; ++i) count_label<kSlots>(keys, counts, lab[i]);
    __syncthreads();
    score_table<kSlots>(keys, counts, red, red_total, results + r * 5);
  }
  // cut score end
}

// The fused query and score over a range of at most half the table (a
// streamed batch's last part, a mesh block's shard-0 launch: the call
// with acc_in) through range_query_kernel's gather queue.  It replaces
// cuclark_tpu/pipeline.py:probe_part_step (:96) followed by
// cuclark_tpu/score.py:score_labels (:28) for the last part, and the last
// shard of cuclark_tpu/parallel/mesh.py:build_sharded_classify and
// build_sharded_probe_part (:96, :164).  What bounds it: the gathers of
// the rows in range (about 1/parts of the windows'), at the gather-only
// ceiling of those rows, plus one pass over the wire and acc_in.
// query_score_kernel gathers a thread a window, so over a part only the
// lanes whose row lies in the range gather (about one in eight for s2 in
// 8 parts) while the warp pays the whole latency chain; here a block of
// kTile threads runs the front half for all its windows, queues the
// windows with a row in range (a ballot and one shared atomic a warp, as
// range_query_kernel), and every thread drains the queue:
//   - reads of one tile (T = 1): G = W reads a block (W = 2 or 4,
//     kernels.range_windows), W windows a thread;
//   - reads of 2 to 8 tiles: one read a block, T windows a thread, since
//     the score needs all of a read's windows in one block.
// acc_in is loaded into lab_s, a slot a window, coalesced and before any
// gather; each queued window adds its label to its own slot, and in each
// round exactly one thread writes a slot, so no atomics.  q4 and s2 take
// choice 1 of a window whose choice 0 missed in a second round after a
// barrier; qs loads a window's main and stash rows before it compares
// either (qs_label<false>).  Then one tile is scored a warp a read
// (warp_score.cuh: warp w scores read w), wider reads through the
// block's distinct-label table (count_label, score_table), as in
// query_score_kernel.  A block's reads past R stage zeros, queue nothing
// and store nothing.  Ranges are compared in 32 bits (range_entry), so
// nb_bits and stash_bits are at most 31.  Reads of 2 to 8 tiles are held
// to 40 registers a thread (12 blocks an SM): at s2's 48-52 its paired
// last part ran 10% slower.
// On an H100 80GB HBM3 at 700 W (scripts/torch_kernel_ab.py, batches of
// 65,536 reads against the 64M-k-mer tables, 12 timings a side against
// query_score_kernel; PERF.md section 6) a streamed batch's last part of
// 150 bp reads took qs 0.1185 -> 0.1078 ms (4 parts), q4 0.1375 ->
// 0.1326 (4) and s2 0.1623 -> 0.1028 (8), of joined 2 x 150 bp pairs qs
// 0.4219 -> 0.3206, q4 0.4267 -> 0.3406 and s2 0.3411 -> 0.3222, and a q4
// mesh block's shard 0 of 2 0.2559 -> 0.2203; qs and q4 reads of two
// tiles, q4's and s2's of eight, s2's shards of 2 and q4's paired shards
// of 2 ran no faster, and keep query_score_kernel
// (cuclark_tpu_torch/kernels.py QUEUE_SCORE_TILES).  range_query_kernel
// keeps its own copy of the queue and the drain (queue_slot, entry_label):
// built on them, its part calls ran 0.2-0.4% slower (1 to 4 of 12
// timings faster than its own code).
template <int LAYOUT, int W, int T>
__global__ void __launch_bounds__(kTile,
                                  T == 1 ? (LAYOUT == kS2 ? 12 : 16) : 12)
    range_query_score_kernel(
        const uint8_t* __restrict__ packed2,
        const uint8_t* __restrict__ vbits, const void* __restrict__ main_rows,
        const uint4* __restrict__ stash_rows,
        const int32_t* __restrict__ acc_in, int32_t* __restrict__ results,
        int64_t R, int P, int s2, int s8, int k, int nb_bits, int stash_bits,
        uint64_t bucket_start, uint64_t nb_local, uint64_t stash_start,
        uint64_t nbs_local, uint32_t c1, uint32_t c2, uint32_t c3, int slots,
        int num_choices) {
  static_assert(T == 1 || W == 1, "reads of several tiles: one a block");
  constexpr int G = T == 1 ? W : 1;   // reads a block
  constexpr int U = G * T;            // tile-units a block
  constexpr int N = U * kTile;        // windows a block: 10 bits of an id
  static_assert(N <= 1024 && G <= kTile / 32, "a queue id holds a window");
  constexpr int kW2 = w2_words(T), kWv = v_words(T);
  constexpr int kBytes = 4 * (kW2 + kWv);
  constexpr int kSlots = T == 1 ? 1 : table_slots(T);
  __shared__ uint32_t w2[G][kW2];
  __shared__ uint32_t wv[G][kWv];
  __shared__ int32_t lab_s[N];
  __shared__ uint16_t q_id[N];
  __shared__ uint32_t q_a[N], q_b[N];
  __shared__ uint16_t q2[LAYOUT == kQs ? 1 : N];
  __shared__ int q_n, q2_n;
  __shared__ int32_t keys[kSlots];
  __shared__ uint32_t counts[kSlots];
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * G;
  const uint32_t mask = static_cast<uint32_t>((1ull << nb_bits) - 1);
  const uint32_t smask = static_cast<uint32_t>((1ull << stash_bits) - 1);
  const uint32_t start = static_cast<uint32_t>(bucket_start);
  const uint32_t local = static_cast<uint32_t>(nb_local);
  const uint32_t sstart = static_cast<uint32_t>(stash_start);
  if (tid == 0) {
    q_n = 0;
    q2_n = 0;
  }
  if constexpr (T > 1) {
    for (int i = tid; i < kSlots; i += kTile) {
      keys[i] = 0;
      counts[i] = 0;
    }
  }
  // acc_in first, coalesced: unit u is tile u % T of read r0 + u / T
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = r0 + u / T;
    const int p = (u % T) * kTile + tid;
    lab_s[u * kTile + tid] =
        acc_in != nullptr && r < R && p < P ? __ldg(acc_in + r * P + p) : 0;
  }
  // each read's T tiles as stage_wire<T> stages them
  for (int i = tid; i < G * kBytes; i += kTile) {
    const int g = i / kBytes, j = i - g * kBytes;
    const int64_t r = r0 + g;
    uint8_t v = 0;
    if (j < 4 * kW2) {
      if (r < R && j < s2) v = __ldg(packed2 + r * s2 + j);
      reinterpret_cast<uint8_t*>(w2[g])[j] = v;
    } else {
      const int q = j - 4 * kW2;
      if (r < R && q < s8) v = __ldg(vbits + r * s8 + q);
      reinterpret_cast<uint8_t*>(wv[g])[q] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int g = u / T, p = (u % T) * kTile + tid;
    uint32_t flags = 0, a = 0, b = 0;
    uint64_t c;
    if (r0 + g < R && p < P && window_kmer(w2[g], wv[g], p, k, &c))
      flags = range_entry<LAYOUT>(c, stash_rows != nullptr, mask, smask,
                                  start, local, sstart,
                                  static_cast<uint32_t>(nbs_local), c1, c2,
                                  c3, num_choices, &a, &b);
    const int slot = queue_slot(flags != 0, &q_n);
    if (flags != 0) {
      q_id[slot] = static_cast<uint16_t>((u * kTile + tid) | flags);
      q_a[slot] = a;
      q_b[slot] = b;
    }
  }
  __syncthreads();
  // each queued window adds its label to its own slot (ids bits 0-9)
  const int n = q_n;
  for (int e0 = 0; e0 < n; e0 += kTile) {
    const int e = e0 + tid;
    bool again = false;
    if (e < n) {
      const uint32_t id = q_id[e];
      const bool in0 = id & kIn0, in1 = id & kIn1;
      const int32_t lab = entry_label<LAYOUT>(
          in0, in1, q_a[e], q_b[e], main_rows, stash_rows, mask, smask,
          start, sstart, nb_bits, stash_bits, slots);
      again = LAYOUT != kQs && in0 && in1 && lab == 0;
      if (lab != 0) lab_s[id & (kIn0 - 1)] += lab;
    }
    if (LAYOUT != kQs) {
      const int slot = queue_slot(again, &q2_n);
      if (again) q2[slot] = static_cast<uint16_t>(e);
    }
  }
  if (LAYOUT != kQs) {
    __syncthreads();
    // the second round: choice 1 of the windows whose choice 0 missed
    const int n2 = q2_n;
    for (int i = tid; i < n2; i += kTile) {
      const int e = q2[i];
      const int32_t lab = entry_label<LAYOUT>(
          false, true, q_a[e], q_b[e], main_rows, stash_rows, mask, smask,
          start, sstart, nb_bits, stash_bits, slots);
      if (lab != 0) lab_s[q_id[e] & (kIn0 - 1)] += lab;
    }
  }
  __syncthreads();
  if constexpr (T == 1) {
    // warp w scores read r0 + w
    const int warp = tid >> 5;
    if (warp >= G || r0 + warp >= R) return;
    constexpr int E = kTile / 32;
    int32_t a[E];
    int total = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a[e] = lab_s[warp * kTile + 32 * e + lane];
      total += a[e] > 0;
    }
    warp_score<E>(a, total, lane, results + (r0 + warp) * 5);
  } else {
    __shared__ unsigned long long red[2 * (kTile / 32)];
    __shared__ int red_total[kTile / 32];
#pragma unroll
    for (int u = 0; u < T; ++u)
      count_label<kSlots>(keys, counts, lab_s[u * kTile + tid]);
    __syncthreads();
    score_table<kSlots>(keys, counts, red, red_total, results + r0 * 5);
  }
}

// The fused kernel of one layout for reads of T tiles, and of `tiles`,
// in blocks of `threads`.
template <int LAYOUT, int T, bool LATE, typename... Args>
void launch_tiles(unsigned grid, int threads, cudaStream_t st,
                  Args... args) {
  query_score_kernel<LAYOUT, T, LATE><<<grid, threads, 0, st>>>(args...);
}

template <int LAYOUT, bool LATE, typename... Args>
bool launch_fused(int tiles, int P, unsigned grid, cudaStream_t st,
                  Args... args) {
  const int b = fused_block(LAYOUT, tiles, P);
  switch (tiles) {
    case 1: launch_tiles<LAYOUT, 1, LATE>(grid, b, st, args...); break;
    case 2: launch_tiles<LAYOUT, 2, LATE>(grid, b, st, args...); break;
    case 3: launch_tiles<LAYOUT, 3, LATE>(grid, b, st, args...); break;
    case 4: launch_tiles<LAYOUT, 4, LATE>(grid, b, st, args...); break;
    case 5: launch_tiles<LAYOUT, 5, LATE>(grid, b, st, args...); break;
    case 6: launch_tiles<LAYOUT, 6, LATE>(grid, b, st, args...); break;
    case 7: launch_tiles<LAYOUT, 7, LATE>(grid, b, st, args...); break;
    case 8: launch_tiles<LAYOUT, 8, LATE>(grid, b, st, args...); break;
    default: return false;
  }
  return true;
}
static_assert(kMaxTiles == 8, "launch_fused has a case per tile count");

// One layout's kernel over one front half.
template <int LAYOUT, bool LATE>
void launch(bool codes, dim3 grid, cudaStream_t st, const uint8_t* p2,
            const uint8_t* vb, const void* main_rows, const uint4* stash,
            int32_t* out, int P, int s2, int s8, int k, int nb_bits,
            int stash_bits, uint64_t start, uint64_t local, uint64_t sstart,
            uint64_t slocal, int accumulate, uint32_t c1, uint32_t c2,
            uint32_t c3, int slots, int num_choices, int tile_base,
            int sampled) {
  if (codes)
    query_kernel<LAYOUT, true, LATE><<<grid, kTile, 0, st>>>(
        p2, vb, main_rows, stash, out, P, s2, s8, k, nb_bits, stash_bits,
        start, local, sstart, slocal, accumulate, c1, c2, c3, slots,
        num_choices, tile_base, sampled);
  else
    query_kernel<LAYOUT, false, LATE><<<grid, kTile, 0, st>>>(
        p2, vb, main_rows, stash, out, P, s2, s8, k, nb_bits, stash_bits,
        start, local, sstart, slocal, accumulate, c1, c2, c3, slots,
        num_choices, tile_base, sampled);
}

// range_query_kernel of one layout at W tile-units a block.
template <int LAYOUT, typename... Args>
bool launch_range(int W, dim3 grid, cudaStream_t st, Args... args) {
  switch (W) {
    case 2: range_query_kernel<LAYOUT, 2><<<grid, kTile, 0, st>>>(args...);
      return true;
    case 4: range_query_kernel<LAYOUT, 4><<<grid, kTile, 0, st>>>(args...);
      return true;
    default: return false;
  }
}

// range_query_score_kernel of one layout for reads of `tiles` tiles: W =
// 2 or 4 reads a block of one tile, one read a block of 2 to 8.
template <int LAYOUT, int W, int T, typename... Args>
void launch_queue_tiles(unsigned grid, cudaStream_t st, Args... args) {
  range_query_score_kernel<LAYOUT, W, T><<<grid, kTile, 0, st>>>(args...);
}

template <int LAYOUT, typename... Args>
bool launch_queue(int W, int tiles, unsigned grid, cudaStream_t st,
                  Args... args) {
  switch (tiles) {
    case 1:
      if (W == 2) launch_queue_tiles<LAYOUT, 2, 1>(grid, st, args...);
      else if (W == 4) launch_queue_tiles<LAYOUT, 4, 1>(grid, st, args...);
      else return false;
      break;
    case 2: launch_queue_tiles<LAYOUT, 1, 2>(grid, st, args...); break;
    case 3: launch_queue_tiles<LAYOUT, 1, 3>(grid, st, args...); break;
    case 4: launch_queue_tiles<LAYOUT, 1, 4>(grid, st, args...); break;
    case 5: launch_queue_tiles<LAYOUT, 1, 5>(grid, st, args...); break;
    case 6: launch_queue_tiles<LAYOUT, 1, 6>(grid, st, args...); break;
    case 7: launch_queue_tiles<LAYOUT, 1, 7>(grid, st, args...); break;
    case 8: launch_queue_tiles<LAYOUT, 1, 8>(grid, st, args...); break;
    default: return false;
  }
  return true;
}

}  // namespace

// labels int32 [R, P] from packed2 uint8 [R, s2], vbits uint8 [R, s8] and
// the main rows (global rows bucket_start.. of a table of 2^nb_bits): layout
// 0 (qs) int32 [nb_local, 8] with stash int32 [nbs_local, 8] (global stash
// rows stash_start.. of 2^stash_bits) or null, layout 1 (q4) int32
// [nb_local, 8], layout 2 (s2) int32 [nb_local, 3*slots] with num_choices 1
// or 2; P = 4*s2 - k + 1.  With codes != 0, packed2 is codes uint8 [R, s2],
// vbits is unused and P = s2 - k + 1.  With accumulate != 0 the labels are
// added into `labels`.  sampled != 0: a qs table loaded with a sample
// factor, whose zeroed main rows may hide stash keys (qs_label).  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int cuclark_query(int layout, int codes, const void* packed2,
                             const void* vbits, const void* main_rows,
                             const void* stash_rows, void* labels, int64_t R,
                             int P, int s2, int s8, int k, int nb_bits,
                             int stash_bits, int64_t bucket_start,
                             int64_t nb_local, int64_t stash_start,
                             int64_t nbs_local, int accumulate, uint32_t c1,
                             uint32_t c2, uint32_t c3, int slots,
                             int num_choices, int sampled,
                             void* stream) {
  if (R == 0 || P == 0) return static_cast<int>(cudaSuccess);
  if (R > 0x7FFFFFFF || k < 2 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p2 = static_cast<const uint8_t*>(packed2);
  const uint8_t* vb = static_cast<const uint8_t*>(vbits);
  const uint4* stash = static_cast<const uint4*>(stash_rows);
  int32_t* out = static_cast<int32_t*>(labels);
  const uint64_t start = static_cast<uint64_t>(bucket_start);
  const uint64_t local = static_cast<uint64_t>(nb_local);
  const uint64_t sstart = static_cast<uint64_t>(stash_start);
  const uint64_t slocal = static_cast<uint64_t>(nbs_local);
  // gridDim.y stops at 65,535 tiles (8.4M windows): a longer row, such as
  // an assembled genome classified as one record, takes several launches
  const int tiles = (P + kTile - 1) / kTile;
  // a qs call over every main row reads the stash late (qs_label)
  const bool late = local == (1ull << nb_bits);
  for (int base = 0; base < tiles; base += 65535) {
    const dim3 grid(static_cast<unsigned>(R),
                    static_cast<unsigned>(tiles - base < 65535 ? tiles - base
                                                               : 65535));
    switch (layout) {
      case kQs:
        if (late)
          launch<kQs, true>(codes != 0, grid, st, p2, vb, main_rows, stash,
                            out, P, s2, s8, k, nb_bits, stash_bits, start,
                            local, sstart, slocal, accumulate, c1, c2, c3,
                            slots, num_choices, base, sampled);
        else
          launch<kQs, false>(codes != 0, grid, st, p2, vb, main_rows, stash,
                             out, P, s2, s8, k, nb_bits, stash_bits, start,
                             local, sstart, slocal, accumulate, c1, c2, c3,
                             slots, num_choices, base, sampled);
        break;
      case kQ4:
        launch<kQ4, false>(codes != 0, grid, st, p2, vb, main_rows, nullptr,
                           out, P, s2, s8, k, nb_bits, 0, start, local, 0, 0,
                           accumulate, c1, c2, c3, slots, num_choices, base, 0);
        break;
      case kS2:
        launch<kS2, false>(codes != 0, grid, st, p2, vb, main_rows, nullptr,
                           out, P, s2, s8, k, nb_bits, 0, start, local, 0, 0,
                           accumulate, c1, c2, c3, slots, num_choices, base, 0);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// The range query (cuclark_query's operands, wire front half only) through
// range_query_kernel: one launch of grid (grid_x, grid_y) blocks, each of W
// = `windows` (2 or 4) tile-units, reads_per_block reads of
// tiles_per_block tiles (their product at most W) from tile (tile_base +
// blockIdx.y) * tiles_per_block.  The caller's geometry
// (cuclark_tpu_torch/kernels.py:range_geometry) covers every (read, tile)
// once over its launches.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cuclark_query_range(
    int layout, const void* packed2, const void* vbits, const void* main_rows,
    const void* stash_rows, void* labels, int64_t R, int P, int s2, int s8,
    int k, int nb_bits, int stash_bits, int64_t bucket_start,
    int64_t nb_local, int64_t stash_start, int64_t nbs_local, int accumulate,
    uint32_t c1, uint32_t c2, uint32_t c3, int slots, int num_choices,
    int windows, int reads_per_block, int tiles_per_block, int64_t grid_x,
    int grid_y, int tile_base, void* stream) {
  if (R == 0 || P == 0) return static_cast<int>(cudaSuccess);
  if (R > 0x7FFFFFFF || k < 2 || k > 32 || reads_per_block < 1 ||
      tiles_per_block < 1 || reads_per_block * tiles_per_block > windows ||
      grid_x < 1 || grid_x > 0x7FFFFFFF || grid_y < 1 || grid_y > 65535 ||
      tile_base < 0 || nb_bits > 31 || stash_bits > 31 ||
      (layout != kQs && stash_rows != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  const uint8_t* p2 = static_cast<const uint8_t*>(packed2);
  const uint8_t* vb = static_cast<const uint8_t*>(vbits);
  const uint4* stash = static_cast<const uint4*>(stash_rows);
  int32_t* out = static_cast<int32_t*>(labels);
  const uint64_t start = static_cast<uint64_t>(bucket_start);
  const uint64_t local = static_cast<uint64_t>(nb_local);
  const uint64_t sstart = static_cast<uint64_t>(stash_start);
  const uint64_t slocal = static_cast<uint64_t>(nbs_local);
  bool launched = false;
  switch (layout) {
    case kQs:
      launched = launch_range<kQs>(
          windows, grid, st, p2, vb, main_rows, stash, out, R, P, s2, s8, k,
          nb_bits, stash_bits, start, local, sstart, slocal, accumulate, c1,
          c2, c3, slots, num_choices, reads_per_block, tiles_per_block,
          tile_base);
      break;
    case kQ4:
      launched = launch_range<kQ4>(
          windows, grid, st, p2, vb, main_rows, stash, out, R, P, s2, s8, k,
          nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, accumulate, c1,
          c2, c3, slots, num_choices, reads_per_block, tiles_per_block,
          tile_base);
      break;
    case kS2:
      launched = launch_range<kS2>(
          windows, grid, st, p2, vb, main_rows, stash, out, R, P, s2, s8, k,
          nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, accumulate, c1,
          c2, c3, slots, num_choices, reads_per_block, tiles_per_block,
          tile_base);
      break;
    default:
      break;
  }
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// results int32 [R, 5] (as cuclark_score's) of the wire batch packed2 uint8
// [R, s2], vbits uint8 [R, s8], P = 4*s2 - k + 1 <= kMaxTiles * kTile =
// 1,024 windows a read (a block of ceil(P / kTile) tiles), against main
// rows [bucket_start, bucket_start + nb_local) of a table of 2^nb_bits rows
// of a layout (as cuclark_query's: qs and q4 int32 [nb_local, 8], s2 int32
// [nb_local, 3*slots]) and, for qs, stash rows [stash_start, stash_start +
// nbs_local) of 2^stash_bits, int32 [nbs_local, 8], or null (no stash
// probe; q4 and s2 pass null).  acc_in: int32 [R, P] added to the labels
// before they are scored, or null.  sampled: as cuclark_query's.  The
// resident step passes the whole table and a null acc_in.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int cuclark_query_score_range(
    int layout, const void* packed2, const void* vbits, const void* main_rows,
    const void* stash_rows, const void* acc_in, void* results, int64_t R,
    int P, int s2, int s8, int k, int nb_bits, int stash_bits,
    int64_t bucket_start, int64_t nb_local, int64_t stash_start,
    int64_t nbs_local, uint32_t c1, uint32_t c2, uint32_t c3, int slots,
    int num_choices, int sampled, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (R > 0x7FFFFFFF || P < 1 || P > kMaxTiles * kTile || k < 2 || k > 32 ||
      (layout != kQs && stash_rows != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p2 = static_cast<const uint8_t*>(packed2);
  const uint8_t* vb = static_cast<const uint8_t*>(vbits);
  const uint4* stash = static_cast<const uint4*>(stash_rows);
  const int32_t* acc = static_cast<const int32_t*>(acc_in);
  int32_t* out = static_cast<int32_t*>(results);
  const uint64_t start = static_cast<uint64_t>(bucket_start);
  const uint64_t local = static_cast<uint64_t>(nb_local);
  const uint64_t sstart = static_cast<uint64_t>(stash_start);
  const uint64_t slocal = static_cast<uint64_t>(nbs_local);
  const unsigned grid = static_cast<unsigned>(R);
  const int tiles = (P + kTile - 1) / kTile;
  bool launched = false;
  switch (layout) {
    case kQs:
      // every main row (the resident step, a 1 x 1 mesh): qs_label's LATE
      if (local == (1ull << nb_bits))
        launched = launch_fused<kQs, true>(
            tiles, P, grid, st, p2, vb, main_rows, stash, acc, out, P, s2,
            s8, k, nb_bits, stash_bits, start, local, sstart, slocal, c1, c2,
            c3, slots, num_choices, sampled);
      else
        launched = launch_fused<kQs, false>(
            tiles, P, grid, st, p2, vb, main_rows, stash, acc, out, P, s2,
            s8, k, nb_bits, stash_bits, start, local, sstart, slocal, c1, c2,
            c3, slots, num_choices, sampled);
      break;
    case kQ4:
      launched = launch_fused<kQ4, false>(
          tiles, P, grid, st, p2, vb, main_rows, nullptr, acc, out, P, s2,
          s8, k, nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, c1,
          c2, c3, slots, num_choices, 0);
      break;
    case kS2:
      launched = launch_fused<kS2, false>(
          tiles, P, grid, st, p2, vb, main_rows, nullptr, acc, out, P, s2,
          s8, k, nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, c1,
          c2, c3, slots, num_choices, 0);
      break;
    default:
      break;
  }
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The fused query and score of cuclark_query_score_range over a range of
// rows through range_query_score_kernel: its operands, and W = `windows`
// (2 or 4) reads a block of reads of one tile (P <= kTile), one read a
// block of reads of 2 to kMaxTiles tiles; grid_x blocks, ceil(R / W) or
// R (cuclark_tpu_torch/kernels.py:queue_geometry), so no read is split
// over blocks.  nb_bits and stash_bits are at most 31 (the ranges are
// compared in 32 bits).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cuclark_query_score_queue(
    int layout, const void* packed2, const void* vbits, const void* main_rows,
    const void* stash_rows, const void* acc_in, void* results, int64_t R,
    int P, int s2, int s8, int k, int nb_bits, int stash_bits,
    int64_t bucket_start, int64_t nb_local, int64_t stash_start,
    int64_t nbs_local, uint32_t c1, uint32_t c2, uint32_t c3, int slots,
    int num_choices, int windows, int64_t grid_x, void* stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (P + kTile - 1) / kTile;
  const int64_t reads = tiles == 1 ? windows : 1;
  if (R < 0 || R > 0x7FFFFFFF || P < 1 || P > kMaxTiles * kTile || k < 2 ||
      k > 32 || nb_bits > 31 || stash_bits > 31 ||
      (windows != 2 && windows != 4) || grid_x != (R + reads - 1) / reads ||
      (layout != kQs && stash_rows != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p2 = static_cast<const uint8_t*>(packed2);
  const uint8_t* vb = static_cast<const uint8_t*>(vbits);
  const uint4* stash = static_cast<const uint4*>(stash_rows);
  const int32_t* acc = static_cast<const int32_t*>(acc_in);
  int32_t* out = static_cast<int32_t*>(results);
  const uint64_t start = static_cast<uint64_t>(bucket_start);
  const uint64_t local = static_cast<uint64_t>(nb_local);
  const uint64_t sstart = static_cast<uint64_t>(stash_start);
  const uint64_t slocal = static_cast<uint64_t>(nbs_local);
  const unsigned grid = static_cast<unsigned>(grid_x);
  bool launched = false;
  switch (layout) {
    case kQs:
      launched = launch_queue<kQs>(
          windows, tiles, grid, st, p2, vb, main_rows, stash, acc, out, R, P,
          s2, s8, k, nb_bits, stash_bits, start, local, sstart, slocal, c1,
          c2, c3, slots, num_choices);
      break;
    case kQ4:
      launched = launch_queue<kQ4>(
          windows, tiles, grid, st, p2, vb, main_rows, stash, acc, out, R, P,
          s2, s8, k, nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, c1,
          c2, c3, slots, num_choices);
      break;
    case kS2:
      launched = launch_queue<kS2>(
          windows, tiles, grid, st, p2, vb, main_rows, stash, acc, out, R, P,
          s2, s8, k, nb_bits, 0, start, local, uint64_t{0}, uint64_t{0}, c1,
          c2, c3, slots, num_choices);
      break;
    default:
      break;
  }
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
