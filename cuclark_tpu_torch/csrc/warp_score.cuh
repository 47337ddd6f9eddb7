// One warp scores one read's labels: [total, best label, best count, second
// label, second count], as cuclark_tpu/score.py:score_labels does: the
// score kernel's warp path (score.cu, score_warp_kernel); score.cu's note
// says how it works.  The fused query-and-score kernel (query.cu,
// query_score_kernel) scores its distinct-label table with the run keys,
// top-two and reductions here.  Included inside each file's anonymous
// namespace.

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned long long run_key(uint32_t count,
                                                      int32_t label) {
  return (static_cast<unsigned long long>(count) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(label));
}

// The label of a key, 0 for no key.
__device__ __forceinline__ int32_t key_label(unsigned long long key) {
  return key ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(key))
             : 0;
}

__device__ __forceinline__ void keep_top2(unsigned long long key,
                                          unsigned long long& b1,
                                          unsigned long long& b2) {
  if (key > b1) {
    b2 = b1;
    b1 = key;
  } else if (key > b2) {
    b2 = key;
  }
}

// The key of the thread's best run whose label is not `skip` (the thread's
// top two keys are of two labels).
__device__ __forceinline__ unsigned long long best_other(
    unsigned long long b1, unsigned long long b2, int32_t skip) {
  return b1 && key_label(b1) == skip ? b2 : b1;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void write_result(int32_t* out, int total,
                                             unsigned long long best,
                                             unsigned long long second) {
  out[0] = total;
  out[1] = key_label(best);
  out[2] = static_cast<int32_t>(best >> 32);
  out[3] = key_label(second);
  out[4] = static_cast<int32_t>(second >> 32);
}

// The warp's row a (E labels a lane) sorted by a bitonic network, then the
// keys of the run ends of positive labels: each lane's top two in b1, b2.
template <int E>
__device__ __forceinline__ void sorted_top2(int32_t (&a)[E], int lane,
                                            unsigned long long& b1,
                                            unsigned long long& b2) {
  constexpr int kLogPp = 5 + (E >= 2) + (E >= 4) + (E >= 8) + (E >= 16) +
                         (E >= 32);
  static_assert((32 << (kLogPp - 5)) == 32 * E, "E is a power of two");
  // bitonic sort, ascending over positions i = lane * E + e.  A block of
  // `size` positions sorts ascending when bit `size` of i is 0: below E
  // that bit is e's (known at compile time), from E on it is the lane's.
  // Each compare-exchange is a min and a max.
#pragma unroll
  for (int ls = 1; ls <= kLogPp; ++ls) {
    const int size = 1 << ls;
    const bool lane_asc = size < E || (lane & (size / E)) == 0;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= E) {
        // partner: the same register of lane ^ (stride / E)
        const int lstride = stride / E;
        const bool keep_min = lane_asc == ((lane & lstride) == 0);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int32_t o = __shfl_xor_sync(kFull, a[e], lstride);
          a[e] = keep_min ? min(a[e], o) : max(a[e], o);
        }
      } else {
        // partner: register e ^ stride of the same lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int l = e ^ stride;
          if (l > e) {
            const bool asc = size < E ? (e & size) == 0 : lane_asc;
            const int32_t lo = min(a[e], a[l]), hi = max(a[e], a[l]);
            a[e] = asc ? lo : hi;
            a[l] = asc ? hi : lo;
          }
        }
      }
    }
  }

  // run starts: the last start at or before each position, carried in from
  // the lanes before by an inclusive max-scan
  const int32_t prev = __shfl_up_sync(kFull, a[E - 1], 1);
  const int32_t next = __shfl_down_sync(kFull, a[0], 1);
  const int base = lane * E;
  int last_start = -1;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool first =
        e == 0 ? (lane == 0 || prev != a[0]) : a[e > 0 ? e - 1 : 0] != a[e];
    if (first) last_start = base + e;
  }
  int scan = last_start;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, scan, o);
    if (lane >= o) scan = max(scan, t);
  }
  int start = __shfl_up_sync(kFull, scan, 1);  // lane 0 starts a run at 0

  // each run end of a positive label: its key
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool first =
        e == 0 ? (lane == 0 || prev != a[0]) : a[e > 0 ? e - 1 : 0] != a[e];
    if (first) start = base + e;
    const bool last =
        e == E - 1 ? (lane == 31 || next != a[E - 1])
                   : a[e] != a[e < E - 1 ? e + 1 : e];
    if (last && a[e] > 0)
      keep_top2(run_key(static_cast<uint32_t>(base + e - start + 1), a[e]),
                b1, b2);
  }
}

// Rows of few distinct labels (a read from one genome) skip the sort: up to
// kRounds rounds each take the first positive label left, count it over
// the row by ballot, and zero it.  Labels left after the rounds are sorted;
// they differ from every counted one, so the two sets of keys merge.
constexpr int kRounds = 8;

// The whole warp scores the row a (E labels a lane, padded with 0: a miss,
// which never counts); `total` is the lane's count of positive labels,
// taken as the caller loads them.  Lane 0 writes the five results to out.
// Where a label sits in the row does not matter.
template <int E>
__device__ __forceinline__ void warp_score(int32_t (&a)[E], int total,
                                           int lane, int32_t* out) {
  // the rounds: r1, r2 are the top two keys of the counted labels (the
  // same in every lane)
  unsigned long long r1 = 0, r2 = 0;
  bool left = true;
  for (int round = 0; round < kRounds && left; ++round) {
    int32_t mine = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) mine = mine > 0 ? mine : a[e];
    const unsigned any = __ballot_sync(kFull, mine > 0);
    left = any != 0;
    if (!left) break;
    const int32_t cand = __shfl_sync(kFull, mine, __ffs(any) - 1);
    int count = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool eq = a[e] == cand;
      count += __popc(__ballot_sync(kFull, eq));
      a[e] = eq ? 0 : a[e];
    }
    keep_top2(run_key(static_cast<uint32_t>(count), cand), r1, r2);
  }
  unsigned long long b1 = 0, b2 = 0;
  if (left) {
    bool pos = false;
#pragma unroll
    for (int e = 0; e < E; ++e) pos |= a[e] > 0;
    if (__any_sync(kFull, pos)) sorted_top2<E>(a, lane, b1, b2);
  }
  unsigned long long best = warp_max(b1);
  best = r1 > best ? r1 : best;
  const int32_t ibest = key_label(best);
  unsigned long long second = warp_max(best_other(b1, b2, ibest));
  const unsigned long long rsecond = best_other(r1, r2, ibest);
  second = rsecond > second ? rsecond : second;
  total = warp_sum(total);
  if (lane == 0) write_result(out, total, best, second);
}
