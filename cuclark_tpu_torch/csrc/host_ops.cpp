// Native host-side hot loops for cuclark_tpu.
//
// TPU-framework equivalents of the reference's native host components:
//  - record boundary scanning  (src/CuCLARK_hh.hh:1335-1551, OpenMP scanner)
//  - 2-bit read packing        (src/CuCLARK_hh.hh:1608-1763, container packer)
//  - rolling canonical k-mer extraction for DB build
//    (src/CuCLARK_hh.hh:1149-1163 rolling walk + Jellyfish revcomp,
//     src/kmersConversion.cc:39-47)
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in this
// environment).  Single pass over bytes, no large temporaries.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Base code table: A=3 C=2 G=1 T=0 (reference getKmers encoding,
// src/kmersConversion.cc:49-68); 4 = invalid.  Initialized via a
// function-local static (C++11 thread-safe static init): ctypes calls
// release the GIL, so two Python threads can race a first use.
struct BaseLut {
    uint8_t t[256];
    BaseLut() {
        memset(t, 4, sizeof(t));
        t[(int)'A'] = 3; t[(int)'a'] = 3;
        t[(int)'C'] = 2; t[(int)'c'] = 2;
        t[(int)'G'] = 1; t[(int)'g'] = 1;
        t[(int)'T'] = 0; t[(int)'t'] = 0;
        t[(int)'U'] = 0; t[(int)'u'] = 0;  // RNA: U == T (CuCLARK_hh.hh:287)
    }
};
static const uint8_t* base_lut() {
    static const BaseLut lut;
    return lut.t;
}
#define LUT (base_lut())
// hoist `const uint8_t* lut = LUT;` before hot loops: the macro
// re-executes the C++11 static-init acquire guard per expansion
#define init_lut() ((void)0)

// Scan a FASTQ buffer: fill per-record offsets.  Returns record count
// (capped at max_rec).  Name = token after '@' up to space/tab/CR/EOL.
// A trailing record is kept only if its quality line START exists
// (matching the numpy scanner's 4-newline rule); *consumed receives
// the byte offset where scanning stopped so the caller can detect
// malformed input (consumed < n with bytes remaining).
int64_t scan_fastq(const uint8_t* buf, int64_t n,
                   int64_t* name_s, int64_t* name_e,
                   int64_t* seq_s, int64_t* seq_e, int64_t max_rec,
                   int64_t* consumed) {
    int64_t i = 0, r = 0;
    while (i < n && r < max_rec) {
        if (buf[i] != '@') break;
        int64_t hs = ++i;
        while (i < n && buf[i] != '\n' && buf[i] != ' '
               && buf[i] != '\t' && buf[i] != '\r') i++;
        int64_t he = i;
        while (i < n && buf[i] != '\n') i++;
        i++;
        int64_t ss = i;
        while (i < n && buf[i] != '\n') i++;
        int64_t se = i;
        if (se > ss && buf[se - 1] == '\r') se--;  // CRLF sequences
        i++;
        while (i < n && buf[i] != '\n') i++;  // '+' line
        i++;
        if (i >= n) break;  // no quality line start: drop partial tail
        while (i < n && buf[i] != '\n') i++;  // quality line
        i++;
        name_s[r] = hs; name_e[r] = he; seq_s[r] = ss; seq_e[r] = se;
        r++;
    }
    if (consumed) *consumed = i < n ? i : n;
    return r;
}

// Scan a FASTA buffer (multi-line sequences).  seq range may contain
// newlines; the packer drops them.
int64_t scan_fasta(const uint8_t* buf, int64_t n,
                   int64_t* name_s, int64_t* name_e,
                   int64_t* seq_s, int64_t* seq_e, int64_t max_rec,
                   int64_t* consumed) {
    int64_t i = 0, r = 0;
    while (i < n && buf[i] != '>') i++;
    while (i < n && r < max_rec) {
        int64_t hs = ++i;
        while (i < n && buf[i] != '\n' && buf[i] != ' '
               && buf[i] != '\t' && buf[i] != '\r') i++;
        int64_t he = i;
        while (i < n && buf[i] != '\n') i++;
        i++;
        int64_t ss = i;
        while (i < n && !(buf[i] == '>' && buf[i - 1] == '\n')) i++;
        int64_t se = i;
        // trim trailing newline(s)
        while (se > ss && (buf[se - 1] == '\n' || buf[se - 1] == '\r')) se--;
        // final header-only record without its newline: i ran past n,
        // leaving ss (and se) > n; clamp to an empty in-bounds range
        // (matches the numpy scanner's seq_s = min(hdr_e + 1, seq_e))
        if (se > n) se = n;
        if (ss > se) ss = se;
        name_s[r] = hs; name_e[r] = he; seq_s[r] = ss; seq_e[r] = se;
        r++;
    }
    if (consumed) *consumed = i < n ? i : n;
    return r;
}

// ---- The record scan on the OpenMP team --------------------------------
//
// scan_fastq_par / scan_fasta_par give scan_fastq's / scan_fasta's
// offsets, count and *consumed exactly, for every input and team size.
// The buffer is cut into T byte ranges ("chunks"), one a thread.
// scan_plan (pass 1) counts each chunk's record-start markers; the fill
// (pass 2) then knows each chunk's first record index and writes its
// records, reading past the chunk's end for a record's last lines.
// Record starts follow from the serial loops' own rules, with no
// guessing from line contents (the reference's resync on a run of
// newlines, src/CuCLARK_hh.hh:1335-1551, can take an '@'-led quality
// line for a header):
//  - FASTQ: scan_fastq consumes exactly four lines a record, so record
//    r starts at line 4r: after newline 4r-1.  Record 0 starts at 0.
//  - FASTA: scan_fasta starts a record at the first '>' and at every
//    later '>' right after a '\n' (a header line holds no '\n', so none
//    lies between a record's '>' and its sequence start).
//
// plan: int64[plan_len], plan_len >= 3.  plan[0] = T, plan[1] = the
// first '>' (FASTA; n if none), plan[2 + t] = chunk t's marker count.

static const int64_t kScanParMinBytes = 1 << 20;  // below: one thread

// Chunks for a buffer of n bytes: nthreads when > 0 (tests pin it),
// else the OpenMP team (OMP_NUM_THREADS) from kScanParMinBytes up.
int64_t scan_team(int64_t n, int64_t nthreads) {
    int64_t t = nthreads;
    if (t <= 0) {
        t = 1;
#ifdef _OPENMP
        if (n >= kScanParMinBytes) t = omp_get_max_threads();
#endif
    }
    return t < 1 ? 1 : t;
}

static inline int64_t chunk_lo(int64_t n, int64_t T, int64_t t) {
    return (int64_t)((__int128)n * t / T);
}

// first '\n' at or after i, else n; i itself when i >= n (as the serial
// loops' `while (i < n && buf[i] != '\n') i++`)
static inline int64_t line_end(const uint8_t* buf, int64_t n, int64_t i) {
    if (i >= n) return i;
    const void* p = memchr(buf + i, '\n', (size_t)(n - i));
    return p ? (const uint8_t*)p - buf : n;
}

// Pass 1.  Returns the capacity the fill needs: FASTA's record count
// exactly; FASTQ's candidate records (one more than the records only
// when the input ends early or malformed).
int64_t scan_plan(const uint8_t* buf, int64_t n, int32_t fasta,
                  int64_t nthreads, int64_t* plan, int64_t plan_len) {
    int64_t T = scan_team(n, nthreads);
    if (T > plan_len - 2) T = plan_len - 2;
    plan[0] = T;
    int64_t first[T];
#pragma omp parallel for schedule(static, 1) num_threads(T) if (T > 1)
    for (int64_t t = 0; t < T; t++) {
        int64_t a = chunk_lo(n, T, t), b = chunk_lo(n, T, t + 1), c = 0;
        if (fasta) {
            const void* p = b > a ? memchr(buf + a, '>', (size_t)(b - a))
                                  : nullptr;
            first[t] = p ? (const uint8_t*)p - buf : n;
            for (int64_t i = a > 0 ? a : 1; i < b; i++)
                c += (buf[i] == '>') & (buf[i - 1] == '\n');
        } else {
            for (int64_t i = a; i < b; i++) c += buf[i] == '\n';
        }
        plan[2 + t] = c;
    }
    int64_t total = 0;
    for (int64_t t = 0; t < T; t++) total += plan[2 + t];
    if (fasta) {
        int64_t p0 = n;
        for (int64_t t = 0; t < T && p0 == n; t++) p0 = first[t];
        plan[1] = p0;
        // the first '>' is a record start even without a '\n' before it
        return total + (p0 < n && !(p0 > 0 && buf[p0 - 1] == '\n'));
    }
    plan[1] = n;
    if (n == 0) return 0;
    // record r follows newline 4r-1; one whose start would be n is none
    int64_t cand = 1 + total / 4;
    if (total > 0 && total % 4 == 0 && buf[n - 1] == '\n') cand--;
    return cand;
}

// One FASTQ record from line start s, by scan_fastq's steps: 0 = kept
// (offsets in o, *next = the next record's start, past n when its
// quality line has no '\n'), 1 = no '@' at s (the scan stops at s),
// 2 = the buffer ends first (the scan stops at n).
static inline int fastq_record(const uint8_t* buf, int64_t n, int64_t s,
                               int64_t* o, int64_t* next) {
    if (s >= n) return 2;
    if (buf[s] != '@') return 1;
    int64_t i = s + 1;
    o[0] = i;
    while (i < n && buf[i] != '\n' && buf[i] != ' '
           && buf[i] != '\t' && buf[i] != '\r') i++;
    o[1] = i;
    i = line_end(buf, n, i) + 1;
    int64_t ss = i, se = line_end(buf, n, i);
    o[2] = ss;
    o[3] = se > ss && buf[se - 1] == '\r' ? se - 1 : se;  // CRLF
    i = line_end(buf, n, se + 1) + 1;  // '+' line
    if (i >= n) return 2;  // no quality line start: drop partial tail
    *next = line_end(buf, n, i) + 1;
    return 0;
}

int64_t scan_fastq_par(const uint8_t* buf, int64_t n, const int64_t* plan,
                       int64_t* name_s, int64_t* name_e,
                       int64_t* seq_s, int64_t* seq_e, int64_t max_rec,
                       int64_t* consumed) {
    const int64_t T = plan[0];
    if (max_rec < 0) max_rec = 0;
    int64_t before[T + 1];  // newlines before chunk t
    before[0] = 0;
    for (int64_t t = 0; t < T; t++) before[t + 1] = before[t] + plan[2 + t];
    // per chunk: its first record the serial loop would not keep, where
    // that stop leaves *consumed, and the end of record max_rec - 1
    int64_t stop_r[T], stop_at[T], cap_at[T];
#pragma omp parallel for schedule(static, 1) num_threads(T) if (T > 1)
    for (int64_t t = 0; t < T; t++) {
        int64_t a = chunk_lo(n, T, t), b = chunk_lo(n, T, t + 1);
        stop_r[t] = INT64_MAX; stop_at[t] = n; cap_at[t] = -1;
        int64_t r, s;
        if (t == 0) {  // record 0 has no newline before it: chunk 0's
            r = 0; s = 0;
        } else {       // the chunk's first newline of index 4r - 1
            int64_t skip = (3 - before[t] % 4) % 4, p = a - 1;
            for (int64_t k = 0; k <= skip && p < b; k++)
                p = line_end(buf, b, p + 1);
            if (p >= b) continue;
            r = (before[t] + skip + 1) / 4; s = p + 1;
        }
        while (r < max_rec) {
            int64_t o[4], next;
            int st = fastq_record(buf, n, s, o, &next);
            if (st) { stop_r[t] = r; stop_at[t] = st == 1 ? s : n; break; }
            name_s[r] = o[0]; name_e[r] = o[1];
            seq_s[r] = o[2]; seq_e[r] = o[3];
            if (r + 1 == max_rec) cap_at[t] = next < n ? next : n;
            if (next - 1 >= b) break;  // the next record is a later chunk's
            s = next; r++;
        }
    }
    int64_t stop = INT64_MAX, at = n, cap = max_rec == 0 ? 0 : n;
    for (int64_t t = 0; t < T; t++) {
        if (stop_r[t] < stop) { stop = stop_r[t]; at = stop_at[t]; }
        if (cap_at[t] >= 0) cap = cap_at[t];
    }
    if (stop == INT64_MAX)  // every candidate kept: the last one ran to n
        stop = (n > 0) + before[T] / 4;
    int64_t r = stop < max_rec ? stop : max_rec;
    if (consumed) *consumed = max_rec <= stop ? cap : at;
    return r;
}

int64_t scan_fasta_par(const uint8_t* buf, int64_t n, const int64_t* plan,
                       int64_t* name_s, int64_t* name_e,
                       int64_t* seq_s, int64_t* seq_e, int64_t max_rec,
                       int64_t* consumed) {
    const int64_t T = plan[0], p0 = plan[1];
    if (max_rec < 0) max_rec = 0;
    // record 0 is the first '>' alone when no '\n' precedes it
    const int64_t lone = p0 < n && !(p0 > 0 && buf[p0 - 1] == '\n');
    int64_t total = lone;
    for (int64_t t = 0; t < T; t++) total += plan[2 + t];
    const int64_t cnt = total < max_rec ? total : max_rec;
    int64_t cap_at = cnt < total ? -1 : n;  // record cnt's '>', else n
    if (lone) {
        if (cnt > 0) name_s[0] = p0 + 1; else cap_at = p0;
    }
    int64_t first_r[T + 1];
    first_r[0] = lone;
    for (int64_t t = 0; t < T; t++) first_r[t + 1] = first_r[t] + plan[2 + t];
    // pass 2: each chunk's record starts ("\n>") into name_s
#pragma omp parallel for schedule(static, 1) num_threads(T) if (T > 1)
    for (int64_t t = 0; t < T; t++) {
        int64_t a = chunk_lo(n, T, t), b = chunk_lo(n, T, t + 1);
        int64_t r = first_r[t];
        for (int64_t i = a > 0 ? a : 1; i < b && r <= cnt; i++) {
            const void* p = memchr(buf + i, '>', (size_t)(b - i));
            if (!p) break;
            i = (const uint8_t*)p - buf;
            if (buf[i - 1] != '\n') continue;
            if (r < cnt) name_s[r] = i + 1;
            else cap_at = i;  // one chunk holds record cnt
            r++;
        }
    }
    // pass 3: each record's header and sequence by scan_fasta's steps
#pragma omp parallel for schedule(static) num_threads(T) if (T > 1)
    for (int64_t r = 0; r < cnt; r++) {
        int64_t i = name_s[r];
        while (i < n && buf[i] != '\n' && buf[i] != ' '
               && buf[i] != '\t' && buf[i] != '\r') i++;
        name_e[r] = i;
        int64_t ss = line_end(buf, n, i) + 1;
        int64_t se = ss >= n ? ss : r + 1 < cnt ? name_s[r + 1] - 1 : cap_at;
        while (se > ss && (buf[se - 1] == '\n' || buf[se - 1] == '\r')) se--;
        if (se > n) se = n;
        if (ss > se) ss = se;
        seq_s[r] = ss; seq_e[r] = se;
    }
    if (consumed) *consumed = total == 0 ? n : cap_at;
    return cnt;
}

// Read a whole file into out[0, n) with pread by byte range on the
// team (nthreads as scan_team).  Returns the bytes read, or -1.
int64_t read_file_par(const char* path, uint8_t* out, int64_t n,
                      int64_t nthreads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    const int64_t T = scan_team(n, nthreads);
    int64_t got = 0;
#pragma omp parallel for schedule(static, 1) num_threads(T) if (T > 1) \
    reduction(+ : got)
    for (int64_t t = 0; t < T; t++) {
        int64_t a = chunk_lo(n, T, t), b = chunk_lo(n, T, t + 1);
        while (a < b) {
            ssize_t k = pread(fd, out + a, (size_t)(b - a), (off_t)a);
            if (k <= 0) break;
            a += k; got += k;
        }
    }
    close(fd);
    return got;
}

// ---- The mate-id check on the OpenMP team ----
//
// first_mate_mismatch gives the numpy check's answer
// (fast_parse.first_mate_mismatch_plain): the first record i < n whose
// mate ids differ, else -1.  A name is buf[s, e) as the scan cut it (at
// a space or a tab); its id ends at the first '/' in it (the reference
// merger's separator, src/file.cc:210-214), else at e.  Two ids match
// when their lengths and their bytes are equal; a NUL is a byte like
// any other.  Each thread takes one contiguous range of records and
// stops at its first mismatch, or once a lower range has found one (it
// looks every kMateStep records); the smallest index found is the
// answer at every team size.  -2: a name lies outside its buffer.
//
// The check runs in classify's head, before the producer and writer
// threads start, so it takes the whole team, as the scan does.  Below
// kMateParMinRecs records (about 0.5 ms on one thread) the team's start
// would cost more than it saves: one thread.

static const int64_t kMateParMinRecs = 1 << 14;
static const int64_t kMateStep = 1024;

// Threads the check runs n records on: nthreads when > 0 (tests pin
// it), else one below kMateParMinRecs and the OpenMP team from there up.
int64_t mate_team(int64_t n, int64_t nthreads) {
    int64_t t = nthreads;
    if (t <= 0) {
        t = 1;
#ifdef _OPENMP
        if (n >= kMateParMinRecs) t = omp_get_max_threads();
#endif
    }
    if (t > n) t = n;
    return t < 1 ? 1 : t;
}

static inline int64_t mate_id_len(const uint8_t* buf, int64_t s,
                                  int64_t e) {
    const void* p = memchr(buf + s, '/', (size_t)(e - s));
    return p ? (const uint8_t*)p - (buf + s) : e - s;
}

int64_t first_mate_mismatch(const uint8_t* buf1, int64_t n1,
                            const int64_t* ns1, const int64_t* ne1,
                            const uint8_t* buf2, int64_t n2,
                            const int64_t* ns2, const int64_t* ne2,
                            int64_t n, int64_t nthreads) {
    if (n <= 0) return -1;
    const int64_t T = mate_team(n, nthreads);
    std::atomic<int64_t> first(INT64_MAX);
    std::atomic<bool> outside(false);
#pragma omp parallel for schedule(static, 1) num_threads(T) if (T > 1)
    for (int64_t t = 0; t < T; t++) {
        const int64_t lo = chunk_lo(n, T, t), hi = chunk_lo(n, T, t + 1);
        for (int64_t b = lo; b < hi; b += kMateStep) {
            if (first.load(std::memory_order_relaxed) < lo
                || outside.load(std::memory_order_relaxed)) break;
            const int64_t be = b + kMateStep < hi ? b + kMateStep : hi;
            int64_t i = b;
            for (; i < be; i++) {
                const int64_t s1 = ns1[i], e1 = ne1[i];
                const int64_t s2 = ns2[i], e2 = ne2[i];
                if (s1 < 0 || e1 < s1 || e1 > n1 || s2 < 0 || e2 < s2
                    || e2 > n2) {
                    outside.store(true, std::memory_order_relaxed);
                    break;
                }
                const int64_t l1 = mate_id_len(buf1, s1, e1);
                if (l1 != mate_id_len(buf2, s2, e2)
                    || memcmp(buf1 + s1, buf2 + s2, (size_t)l1) != 0) {
                    // the first mismatch of this range: fold it into
                    // the shared minimum
                    int64_t cur = first.load(std::memory_order_relaxed);
                    while (i < cur && !first.compare_exchange_weak(
                                          cur, i, std::memory_order_relaxed))
                        ;
                    break;
                }
            }
            if (i < be) break;
        }
    }
    if (outside.load()) return -2;
    const int64_t f = first.load();
    return f == INT64_MAX ? -1 : f;
}

// Pack records into a [nrec, L] code matrix (pre-filled by caller or
// filled here with 4).  Newlines/CR are skipped (multi-line FASTA);
// lengths receive true sequence char counts (may exceed L).
void pack_block(const uint8_t* buf,
                const int64_t* seq_s, const int64_t* seq_e, int64_t nrec,
                uint8_t* codes, int64_t L, int64_t* lengths) {
    const uint8_t* lut = LUT;
    // rows are disjoint -> embarrassingly parallel (the reference packs
    // with an OpenMP team too, src/CuCLARK_hh.hh:1609-1763)
#pragma omp parallel for schedule(static) if (nrec >= 256)
    for (int64_t r = 0; r < nrec; r++) {
        uint8_t* row = codes + r * L;
        memset(row, 4, L);
        int64_t w = 0, len = 0;
        for (int64_t i = seq_s[r]; i < seq_e[r]; i++) {
            uint8_t ch = buf[i];
            if (ch == '\n' || ch == '\r') continue;
            if (w < L) row[w++] = lut[ch];
            len++;
        }
        lengths[r] = len;
    }
}

// The plain version of pack_block2 (one base a step, OR-updates into a
// zeroed row), which pack_block2 is held to byte for byte.
//
// Pack records straight into the 2-bit wire format the device step
// consumes: packed2 [nrec, Lp/4] (4 bases/byte, little-endian 2-bit
// lanes) + vbits [nrec, Lp/8] (validity bitmask, little-endian),
// Lp a multiple of 8.  Fuses pack_block + the host bit-packing pass
// (codec.pack_codes) into one sweep with no [R, L] byte matrix —
// the same single-pass packing role as the reference's container
// encoder (src/CuCLARK_hh.hh:1608-1763).  Non-ACGT chars occupy a
// position with valid bit 0; newlines/CR are skipped.
void pack_block2_plain(const uint8_t* buf,
                       const int64_t* seq_s, const int64_t* seq_e,
                       int64_t nrec,
                       uint8_t* packed2, uint8_t* vbits, int64_t Lp,
                       int64_t maxw, int64_t* lengths) {
    const uint8_t* lut = LUT;
    const int64_t W2 = Lp / 4, WV = Lp / 8;
    if (maxw > Lp) maxw = Lp;
#pragma omp parallel for schedule(static) if (nrec >= 256)
    for (int64_t r = 0; r < nrec; r++) {
        uint8_t* p2 = packed2 + r * W2;
        uint8_t* vb = vbits + r * WV;
        memset(p2, 0, W2);
        memset(vb, 0, WV);
        int64_t w = 0, len = 0;
        for (int64_t i = seq_s[r]; i < seq_e[r]; i++) {
            uint8_t ch = buf[i];
            if (ch == '\n' || ch == '\r') continue;
            if (w < maxw) {
                uint8_t c = lut[ch];
                if (c != 4) {
                    p2[w >> 2] |= (uint8_t)(c << ((w & 3) * 2));
                    vb[w >> 3] |= (uint8_t)(1u << (w & 7));
                }
                w++;
            }
            len++;
        }
        lengths[r] = len;
    }
}

// The plain version of pack_block2_paired.
//
// Fused paired-end wire packing: mate 1, ONE joining invalid position
// (the 'N' of the reference's mergePairedFiles, src/file.cc:205-268),
// then mate 2 — straight into the 2-bit wire format, replacing the
// pack + numpy shift-merge + re-pack detour.  Same layout rules as
// pack_block2; lengths receive len1 + 1 + len2 (true char counts).
void pack_block2_paired_plain(const uint8_t* buf1,
                              const int64_t* s1, const int64_t* e1,
                              const uint8_t* buf2,
                              const int64_t* s2, const int64_t* e2,
                              int64_t nrec, uint8_t* packed2,
                              uint8_t* vbits, int64_t Lp, int64_t maxw,
                              int64_t* lengths) {
    const uint8_t* lut = LUT;
    const int64_t W2 = Lp / 4, WV = Lp / 8;
    if (maxw > Lp) maxw = Lp;
#pragma omp parallel for schedule(static) if (nrec >= 256)
    for (int64_t r = 0; r < nrec; r++) {
        uint8_t* p2 = packed2 + r * W2;
        uint8_t* vb = vbits + r * WV;
        memset(p2, 0, W2);
        memset(vb, 0, WV);
        int64_t w = 0, len = 0;
        for (int pass = 0; pass < 2; pass++) {
            const uint8_t* buf = pass ? buf2 : buf1;
            const int64_t lo = pass ? s2[r] : s1[r];
            const int64_t hi = pass ? e2[r] : e1[r];
            for (int64_t i = lo; i < hi; i++) {
                uint8_t ch = buf[i];
                if (ch == '\n' || ch == '\r') continue;
                if (w < maxw) {
                    uint8_t c = lut[ch];
                    if (c != 4) {
                        p2[w >> 2] |= (uint8_t)(c << ((w & 3) * 2));
                        vb[w >> 3] |= (uint8_t)(1u << (w & 7));
                    }
                }
                w++;
                len++;
            }
            if (pass == 0) { w++; len++; }  // joining 'N' (invalid)
        }
        lengths[r] = len;
    }
}

// ---- The 2-bit wire pack, eight bases a step ---------------------------
//
// pack_block2 / pack_block2_paired write the bytes of the plain versions
// above for every input: the LUT's codes (A=3 C=2 G=1 T/U=0, either
// case; any other byte an invalid position with valid bit 0), '\n' and
// '\r' skipped, positions past maxw dropped while lengths count every
// byte that is not a newline.  Bytes are loaded eight at a time as a
// uint64_t and classified with byte-wise compares (SWAR, no ISA flag):
// 32 bases a step (a whole word) or 16 while no byte is below 0x20,
// else 8, a newline ending the step early, so a multi-line record runs
// the same path segment by segment.  A row's words are built in registers
// (RowOut) and each byte of the row is stored once: every 32 bases a
// 64-bit word of packed2 and a 32-bit word of vbits, then the last
// partial word and the row's zero tail.  A pair's mate 2 starts at
// len1 + 1, at any offset in a word: RowOut carries it across.

static const uint64_t kOnes = 0x0101010101010101ULL;
static const uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;

// 0x80 in each byte of x equal to c, else 0 (exact: no carry crosses a
// byte, as (z & 0x7f) + 0x7f <= 0xfe)
static inline uint64_t eq_bytes(uint64_t x, uint8_t c) {
    const uint64_t z = x ^ (kOnes * c);
    return ~(((z & kLow7) + kLow7) | z) & ~kLow7;
}

static inline uint64_t newline_bytes(uint64_t x) {
    return eq_bytes(x, '\n') | eq_bytes(x, '\r');
}

// nonzero when a byte of x is below 0x20: a newline, or a control byte
// (never a base), which sends the step down the exact path
static inline uint64_t any_control(uint64_t x) {
    return (x - kOnes * 0x20) & ~x & ~kLow7;
}

// The 8 bytes of x as 16 bits of codes (base j at bits 2j) and 8 valid
// bits.  After folding case, (y >> 1) & 3 is A 0, C 1, G 3, T/U 2; the
// one byte a valid base with that h can be is 0x61 | h << 1, plus 0x10
// for T/U (whose bit 0 is either), so one exact compare a byte decides
// validity.  h ^ (h >> 1) ^ 3 maps h to the LUT's A 3, C 2, G 1, T/U 0.
static inline void codes8(uint64_t x, uint64_t* codes, uint64_t* valid) {
    const uint64_t y = x | (kOnes * 0x20);
    const uint64_t h = (y >> 1) & (kOnes * 3);
    const uint64_t hb = (h >> 1) & kOnes;       // h's high bit
    const uint64_t tu = hb & ~h;                // h == 2: T or U
    const uint64_t want = (kOnes * 0x61) | (tu << 4) | (h << 1);
    const uint64_t d = (y ^ want) & ~tu;
    const uint64_t v = (~(((d & kLow7) + kLow7) | d) & ~kLow7) >> 7;
    uint64_t c = (h ^ hb ^ (kOnes * 3)) & (v * 3);
    c = (c | (c >> 6)) & 0x000F000F000F000FULL;   // 2 codes a 16-bit lane
    c = (c | (c >> 12)) & 0x000000FF000000FFULL;  // 4 a 32-bit lane
    *codes = (c | (c >> 24)) & 0xFFFFULL;         // 8
    *valid = (v * 0x0102040810204080ULL) >> 56;   // bit j: byte j
}

// One output row under construction: w bases so far (w <= maxw), the
// codes and valid bits of the word of 32 bases that holds base w.
struct RowOut {
    uint8_t* p2;
    uint8_t* vb;
    int64_t W2, WV;
    int64_t w = 0;
    uint64_t c = 0, v = 0;

    // append k (1..16) bases; the caller keeps w + k <= maxw <= Lp, so a
    // word that fills lies inside the row
    inline void put(uint64_t codes, uint64_t valid, int k) {
        const int o = (int)(w & 31);
        c |= codes << (2 * o);
        v |= valid << o;
        if (o + k >= 32) {
            const int done = 32 - o;  // 1..16 bases of this step fit
            const uint32_t v32 = (uint32_t)v;
            memcpy(p2 + (w >> 5) * 8, &c, 8);
            memcpy(vb + (w >> 5) * 4, &v32, 4);
            c = codes >> (2 * done);
            v = valid >> done;
        }
        w += k;
    }

    // a whole word of 32 bases where w is a multiple of 32
    inline void word(uint64_t codes, uint32_t valid) {
        memcpy(p2 + (w >> 5) * 8, &codes, 8);
        memcpy(vb + (w >> 5) * 4, &valid, 4);
        w += 32;
    }

    // the partial word, then zeros to the end of the row
    inline void finish() {
        int64_t b2 = (w >> 5) * 8, bv = (w >> 5) * 4;
        if (w & 31) {
            if (b2 + 8 <= W2) {
                memcpy(p2 + b2, &c, 8);
                b2 += 8;
            } else {  // the row ends inside this word
                for (; b2 < W2; b2++, c >>= 8) p2[b2] = (uint8_t)c;
            }
            if (bv + 4 <= WV) {
                const uint32_t v32 = (uint32_t)v;
                memcpy(vb + bv, &v32, 4);
                bv += 4;
            } else {
                for (; bv < WV; bv++, v >>= 8) vb[bv] = (uint8_t)v;
            }
        }
        if (b2 < W2) memset(p2 + b2, 0, (size_t)(W2 - b2));
        if (bv < WV) memset(vb + bv, 0, (size_t)(WV - bv));
    }
};

// bytes of buf[i, hi) that are not newlines
static int64_t non_newline(const uint8_t* buf, int64_t i, int64_t hi) {
    int64_t n = hi - i;
    for (; i + 8 <= hi; i += 8) {
        uint64_t x;
        memcpy(&x, buf + i, 8);
        n -= __builtin_popcountll(newline_bytes(x));
    }
    for (; i < hi; i++) n -= (buf[i] == '\n' || buf[i] == '\r');
    return n;
}

// Append the bases of buf[lo, hi) to row, up to maxw of them; returns
// the bytes of the range that are not newlines.  While no byte is below
// 0x20 (a single-line record throughout): a whole word of 32 bases a
// step where the row is at a word's start, else 16; otherwise eight
// bytes, a newline ending the step, so the next step starts past it
// with the row's word carried.
static int64_t pack_range(const uint8_t* buf, const int64_t lo,
                          const int64_t hi, RowOut& row, int64_t maxw) {
    int64_t i = lo, len = 0;
    uint64_t c0, v0, c1, v1;
    while (i < hi && row.w < maxw) {
        uint64_t x, x1;
        if ((row.w & 31) == 0 && i + 32 <= hi && row.w + 32 <= maxw) {
            uint64_t x2, x3, c2, v2, c3, v3;
            memcpy(&x, buf + i, 8);
            memcpy(&x1, buf + i + 8, 8);
            memcpy(&x2, buf + i + 16, 8);
            memcpy(&x3, buf + i + 24, 8);
            if (!(any_control(x) | any_control(x1) | any_control(x2) |
                  any_control(x3))) {
                codes8(x, &c0, &v0);
                codes8(x1, &c1, &v1);
                codes8(x2, &c2, &v2);
                codes8(x3, &c3, &v3);
                row.word(c0 | c1 << 16 | c2 << 32 | c3 << 48,
                         (uint32_t)(v0 | v1 << 8 | v2 << 16 | v3 << 24));
                i += 32;
                len += 32;
                continue;
            }
        }
        if (i + 16 <= hi && row.w + 16 <= maxw) {
            memcpy(&x, buf + i, 8);
            memcpy(&x1, buf + i + 8, 8);
            if (!(any_control(x) | any_control(x1))) {
                codes8(x, &c0, &v0);
                codes8(x1, &c1, &v1);
                row.put(c0 | c1 << 16, v0 | v1 << 8, 16);
                i += 16;
                len += 16;
                continue;
            }
        }
        int k = 8;
        if (i + 8 <= hi) {
            memcpy(&x, buf + i, 8);
        } else {  // the range's last k bytes; the bytes past them are 0
            k = (int)(hi - i);
            if (hi - 8 >= lo) {  // the 8 bytes ending at hi, shifted down
                memcpy(&x, buf + hi - 8, 8);
                x >>= 8 * (8 - k);
            } else {
                x = 0;
                for (int j = 0; j < k; j++)
                    x |= (uint64_t)buf[i + j] << (8 * j);
            }
        }
        const uint64_t nl = newline_bytes(x);
        const int seg = nl ? __builtin_ctzll(nl) >> 3 : k;  // before it
        const int64_t room = maxw - row.w;
        const int put = seg < room ? seg : (int)room;
        if (put > 0) {
            codes8(x, &c0, &v0);
            if (put < 8) {
                c0 &= (1ULL << (2 * put)) - 1;
                v0 &= (1ULL << put) - 1;
            }
            row.put(c0, v0, put);
        }
        len += seg;
        i += seg + (nl ? 1 : 0);
    }
    return len + (i < hi ? non_newline(buf, i, hi) : 0);
}

// classify packs on its producer thread while it writes rows on its
// writer thread, so the two default teams split the OpenMP team
// (omp_get_max_threads(): OMP_NUM_THREADS, else every core): the pack
// takes half, rounded down, the rows the rest (at least one each).  On
// an H100's 8-core host 4 + 4 beat 8 + 8 in most file -> CSV passes
// (PERF.md, Findings; scripts/torch_teams_e2e.py).
static int64_t pack_share() {
    int64_t T = 1;
#ifdef _OPENMP
    T = omp_get_max_threads();
#endif
    return T / 2 > 0 ? T / 2 : 1;
}

static int64_t rows_share() {
    int64_t T = 1;
#ifdef _OPENMP
    T = omp_get_max_threads();
#endif
    return T - pack_share() > 0 ? T - pack_share() : 1;
}

// Threads the pack runs nrec rows on: nthreads when > 0 (tests pin it),
// else one below 256 rows and pack_share() from there up.
int64_t pack_team(int64_t nrec, int64_t nthreads) {
    if (nthreads > 0) return nthreads;
    return nrec >= 256 ? pack_share() : 1;
}

// pack_block2_plain's bytes (every byte of rows [0, nrec)), eight bases
// a step; nthreads as pack_team.
void pack_block2(const uint8_t* buf,
                 const int64_t* seq_s, const int64_t* seq_e, int64_t nrec,
                 uint8_t* packed2, uint8_t* vbits, int64_t Lp,
                 int64_t maxw, int64_t* lengths, int64_t nthreads) {
    const int64_t W2 = Lp / 4, WV = Lp / 8;
    if (maxw > Lp) maxw = Lp;
    const int T = (int)pack_team(nrec, nthreads);
#pragma omp parallel for schedule(static) num_threads(T) if (T > 1)
    for (int64_t r = 0; r < nrec; r++) {
        RowOut row{packed2 + r * W2, vbits + r * WV, W2, WV};
        lengths[r] = pack_range(buf, seq_s[r], seq_e[r], row, maxw);
        row.finish();
    }
}

// pack_block2_paired_plain's bytes: mate 1, the joining invalid
// position, mate 2 through the same row; nthreads as pack_team.
void pack_block2_paired(const uint8_t* buf1,
                        const int64_t* s1, const int64_t* e1,
                        const uint8_t* buf2,
                        const int64_t* s2, const int64_t* e2,
                        int64_t nrec, uint8_t* packed2, uint8_t* vbits,
                        int64_t Lp, int64_t maxw, int64_t* lengths,
                        int64_t nthreads) {
    const int64_t W2 = Lp / 4, WV = Lp / 8;
    if (maxw > Lp) maxw = Lp;
    const int T = (int)pack_team(nrec, nthreads);
#pragma omp parallel for schedule(static) num_threads(T) if (T > 1)
    for (int64_t r = 0; r < nrec; r++) {
        RowOut row{packed2 + r * W2, vbits + r * WV, W2, WV};
        int64_t len = pack_range(buf1, s1[r], e1[r], row, maxw);
        if (row.w < maxw) row.put(0, 0, 1);  // the joining 'N' (invalid)
        len += 1 + pack_range(buf2, s2[r], e2[r], row, maxw);
        lengths[r] = len;
        row.finish();
    }
}

// Rolling canonical k-mer extraction over one sequence (bytes may
// include newlines, skipped).  Non-ACGT resets the window (part
// semantics).  Every overlapping k-mer — the full-mode build walk
// (src/CuCLARK_hh.hh:1100-1163).  Returns number of k-mers written.
int64_t extract_canonical(const uint8_t* seq, int64_t n, int32_t k,
                          uint64_t* out) {
    const uint8_t* lut = LUT;
    const int shift = 2 * (k - 1);
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t fwd = 0, rev = 0;
    int64_t fill = 0, cnt = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t ch = seq[i];
        if (ch == '\n' || ch == '\r') continue;
        uint8_t c = lut[ch];
        if (c == 4) { fill = 0; fwd = 0; rev = 0; continue; }
        fwd = ((fwd << 2) | c) & mask;
        rev = (rev >> 2) | ((uint64_t)(3 - c) << shift);
        if (++fill >= k)
            out[cnt++] = fwd < rev ? fwd : rev;
    }
    return cnt;
}

// Light-mode build walk: NON-overlapping k-mer blocks, keeping every
// gap-th block; the block counter persists across parts/sequences of a
// genome file (src/CuCLARK_hh.hh:710-731: kmer resets after each emit;
// `iter` is per-file).  iter_io is read and updated.  Returns count.
int64_t extract_canonical_light(const uint8_t* seq, int64_t n, int32_t k,
                                int32_t gap, int64_t* iter_io,
                                uint64_t* out) {
    const uint8_t* lut = LUT;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t fwd = 0;
    int64_t fill = 0, cnt = 0, iter = *iter_io;
    for (int64_t i = 0; i < n; i++) {
        uint8_t ch = seq[i];
        if (ch == '\n' || ch == '\r') continue;
        uint8_t c = lut[ch];
        if (c == 4) { fill = 0; fwd = 0; continue; }
        fwd = ((fwd << 2) | c) & mask;
        if (++fill == k) {
            if (iter % gap == 0) {
                // canonicalize: Jellyfish revcomp (src/kmersConversion.cc:39-47)
                uint64_t r = fwd;
                r = ((r >> 2) & 0x3333333333333333ULL) | ((r & 0x3333333333333333ULL) << 2);
                r = ((r >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((r & 0x0F0F0F0F0F0F0F0FULL) << 4);
                r = ((r >> 8) & 0x00FF00FF00FF00FFULL) | ((r & 0x00FF00FF00FF00FFULL) << 8);
                r = ((r >> 16) & 0x0000FFFF0000FFFFULL) | ((r & 0x0000FFFF0000FFFFULL) << 16);
                r = (r >> 32) | (r << 32);
                r = (~r) >> (64 - 2 * k);
                out[cnt++] = fwd < r ? fwd : r;
            }
            iter++;
            fill = 0;
            fwd = 0;
        }
    }
    *iter_io = iter;
    return cnt;
}

// Count upper bound of k-mers for buffer allocation.
int64_t kmer_bound(int64_t n, int32_t k, int32_t gap) {
    if (n < k) return 0;
    return (n - k + 1) / gap + 1;
}

// ---- two-choice bucketed-cuckoo table construction ----
// Exact counterparts of hashdb.mix1/mix2 (murmur3 fmix32 math).

static inline uint32_t fmix(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}
static inline uint32_t mix1(uint32_t hi, uint32_t lo) {
    return fmix(lo ^ (hi * 0x9E3779B9u));
}
static inline uint32_t mix2(uint32_t hi, uint32_t lo) {
    return fmix(hi ^ (lo * 0x85EBCA6Bu) ^ 0x5BD1E995u);
}

// Build the [NB, S] planar key/label arrays (caller pre-fills keys with
// the EMPTY sentinel 0xFFFFFFFF and labels with 0).  Greedy two-choice
// insert with bounded random-walk eviction.  Returns 0 on success, -1
// if the table is effectively full (caller grows nb_bits and retries).
int64_t build_cuckoo(const uint64_t* kmers, const uint32_t* labels,
                     int64_t n, int32_t nb_bits, int32_t slots,
                     int32_t num_choices,
                     uint32_t* keys_lo, uint32_t* keys_hi, uint32_t* labs,
                     uint8_t* occ, int64_t max_kicks) {
    const uint32_t mask = (uint32_t)((1ull << nb_bits) - 1);
    const int S = slots;
    uint64_t rng = 0x5EEDC0FFEEull;
    for (int64_t i = 0; i < n; i++) {
        uint64_t km = kmers[i];
        uint32_t lb = labels[i];
        for (int64_t kick = 0; kick <= max_kicks; kick++) {
            uint32_t lo = (uint32_t)km, hi = (uint32_t)(km >> 32);
            uint32_t b1 = mix1(hi, lo) & mask;
            uint32_t b = b1;
            if (kick > 0 && num_choices == 2 && (kick & 1))
                b = mix2(hi, lo) & mask;
            if (occ[b] < S) {
                int64_t idx = (int64_t)b * S + occ[b];
                keys_lo[idx] = lo; keys_hi[idx] = hi; labs[idx] = lb;
                occ[b]++;
                goto placed;
            }
            if (num_choices == 2 && kick == 0) {
                uint32_t b2 = mix2(hi, lo) & mask;
                if (occ[b2] < S) {
                    int64_t idx = (int64_t)b2 * S + occ[b2];
                    keys_lo[idx] = lo; keys_hi[idx] = hi; labs[idx] = lb;
                    occ[b2]++;
                    goto placed;
                }
            }
            if (num_choices == 1) return -1;  // single-choice: no eviction
            // evict a random victim from bucket b and continue with it
            rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
            {
                int s = (int)(rng % (uint64_t)S);
                int64_t idx = (int64_t)b * S + s;
                uint64_t ev = ((uint64_t)keys_hi[idx] << 32) | keys_lo[idx];
                uint32_t evlb = labs[idx];
                keys_lo[idx] = (uint32_t)km;
                keys_hi[idx] = (uint32_t)(km >> 32);
                labs[idx] = lb;
                km = ev; lb = evlb;
            }
        }
        return -1;  // kick budget exhausted
      placed:;
    }
    return 0;
}

// ---- q4 / qs layout build ----
// Two-choice C=4 cuckoo over Feistel-mixed keys; entries are
// quotient-compressed [other u32 | (q15|choice1|label16) u32] pairs in
// 32 B rows (see cuclark_tpu/hashdb.py KmerDB docs).  Replaces the
// vectorized-numpy + Python-eviction build for large databases.
//
// stash_bits == 0: classic q4 — both choices hash over the same [NB]
// row range.  stash_bits > 0: qs — choice 1 hashes into a SMALL stash
// section of NBS = 1<<stash_bits rows appended at global rows
// [NB, NB+NBS), so the online probe pays one cold main-table gather
// plus one warm stash gather (BENCHNOTES.md round 3).  table/occ then
// cover NB+NBS rows; stash entries quotient against stash_bits.

int64_t build_q4(const uint64_t* kmers, const uint32_t* labels, int64_t n,
                 int32_t nb_bits, int32_t stash_bits,
                 uint32_t c1, uint32_t c2, uint32_t c3,
                 uint32_t* table /* [NB(+NBS), 8] zero-initialized */,
                 uint8_t* occ, int64_t max_kicks) {
    const uint32_t mask = (uint32_t)((1ull << nb_bits) - 1);
    const uint32_t nb = (uint32_t)(1ull << nb_bits);
    const uint32_t smask =
        stash_bits ? (uint32_t)((1ull << stash_bits) - 1) : mask;
    const uint32_t soff = stash_bits ? nb : 0;
    const int32_t sbits = stash_bits ? stash_bits : nb_bits;
    uint64_t rng = 0x5EEDC0FFEEull;
    for (int64_t i = 0; i < n; i++) {
        uint32_t lo = (uint32_t)kmers[i], hi = (uint32_t)(kmers[i] >> 32);
        uint32_t l1 = lo ^ fmix(hi + c1);
        uint32_t h1 = hi ^ fmix(l1 + c2);
        uint32_t l2 = l1 ^ fmix(h1 + c3);
        uint32_t lb = labels[i];
        uint32_t choice = 0;
        for (int64_t kick = 0; kick <= max_kicks; kick++) {
            // try both buckets when fresh, else only the current choice
            for (int c = (kick == 0 ? 0 : (int)choice);
                 c <= (kick == 0 ? 1 : (int)choice); c++) {
                uint32_t b = c == 0 ? (l2 & mask) : (soff + (h1 & smask));
                if (occ[b] < 4) {
                    int64_t row = (int64_t)b * 8;
                    int s = occ[b];
                    uint32_t own = c == 0 ? l2 : h1;
                    int32_t qsh = c == 0 ? nb_bits : sbits;
                    table[row + s] = c == 0 ? h1 : l2;
                    table[row + 4 + s] =
                        ((own >> qsh) << 17) | ((uint32_t)c << 16) | lb;
                    occ[b]++;
                    goto placed;
                }
            }
            {
                // evict a random slot of the current-choice bucket
                uint32_t b = choice == 0 ? (l2 & mask)
                                         : (soff + (h1 & smask));
                rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
                int s = (int)(rng & 3);
                int64_t row = (int64_t)b * 8;
                uint32_t v_other = table[row + s];
                uint32_t v_meta = table[row + 4 + s];
                uint32_t own = choice == 0 ? l2 : h1;
                int32_t qsh = choice == 0 ? nb_bits : sbits;
                table[row + s] = choice == 0 ? h1 : l2;
                table[row + 4 + s] =
                    ((own >> qsh) << 17) | (choice << 16) | lb;
                // reconstruct the victim and retry it at its other choice
                uint32_t v_c = (v_meta >> 16) & 1u;
                uint32_t v_local = v_c == 0 ? b : (b - soff);
                uint32_t v_own = v_c == 0
                    ? (((v_meta >> 17) << nb_bits) | v_local)
                    : (((v_meta >> 17) << sbits) | v_local);
                l2 = v_c == 0 ? v_own : v_other;
                h1 = v_c == 0 ? v_other : v_own;
                lb = v_meta & 0xFFFFu;
                choice = 1u - v_c;
            }
        }
        return -1;  // kick budget exhausted
      placed:;
    }
    return 0;
}

// ---- occurrence reduction (RemoveCommon analog) ----
// Sorts (kmer, label, count) occurrence records by k-mer, then a
// single run sweep keeping k-mers whose occurrences all carry one
// label (target-specific, multiplicity==1 semantics of
// src/HashTableStorage_hh.hh:242-292) with total count > min_count.
// Replaces numpy argsort + fancy-gather + reduceat for the hot
// non-centromere path; the centromere (label2) path stays in numpy.
//
// Sort strategy: a multi-pass LSD radix is memory-latency-bound here
// (measured no faster than argsort on this host) — instead do ONE
// MSD counting-partition on the top bits so each partition fits L2,
// then sort partitions in cache with std::sort, OpenMP across
// partitions.  Record order within equal k-mers is irrelevant: the
// sweep only needs "all labels equal?" + the count total, both
// order-independent.
//
// A and B are caller-allocated scratch of 2*n u64 each, holding
// interleaved records {km, (lb<<32)|ct}.  has_ct == 0 means every
// occurrence counts 1 (ct pointer ignored).  Returns the number of
// surviving k-mers written to out_km/out_lb/out_ct.

struct OccRec {
    uint64_t km, pay;
};

int64_t reduce_occurrences(const uint64_t* km, const uint32_t* lb,
                           const uint32_t* ct, int32_t has_ct, int64_t n,
                           int32_t key_bits, int32_t min_count,
                           uint64_t* A, uint64_t* B,
                           uint64_t* out_km, uint32_t* out_lb,
                           uint32_t* out_ct) {
    if (n == 0) return 0;
    OccRec* recs = (OccRec*)A;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        recs[i].km = km[i];
        recs[i].pay = ((uint64_t)lb[i] << 32) | (has_ct ? ct[i] : 1u);
    }
    // partition width: aim for ~32K records (512 KB) per partition
    int pbits = 0;
    while ((n >> pbits) > 32768 && pbits < 14) pbits++;
    if (pbits > key_bits) pbits = key_bits;
    const auto by_km = [](const OccRec& a, const OccRec& b) {
        return a.km < b.km;
    };
    OccRec* srt;
    if (pbits == 0) {
        std::sort(recs, recs + n, by_km);
        srt = recs;
    } else {
        OccRec* part = (OccRec*)B;
        const int D = 1 << pbits;
        const int sh = key_bits - pbits;
        int nt = 1;
#ifdef _OPENMP
        nt = omp_get_max_threads();
#endif
        int64_t* hist = new int64_t[(int64_t)nt * D]();
        int64_t* bounds = new int64_t[D + 1];
#pragma omp parallel num_threads(nt)
        {
            // Per-thread ranges derive from the ACTUAL team size (the
            // num_threads clause is a cap, not a guarantee: OMP_DYNAMIC
            // or nesting may deliver fewer threads; T <= nt always, so
            // the nt-row hist allocation stays sufficient).
            int t = 0, T = 1;
#ifdef _OPENMP
            t = omp_get_thread_num();
            T = omp_get_num_threads();
#endif
            const int64_t lo = n * t / T, hi = n * (t + 1) / T;
            int64_t* h = hist + (int64_t)t * D;
            for (int64_t i = lo; i < hi; i++)
                h[recs[i].km >> sh]++;
#pragma omp barrier
#pragma omp single
            {
                // digit-major exclusive prefix across threads
                int64_t acc = 0;
                for (int d = 0; d < D; d++) {
                    bounds[d] = acc;
                    for (int tt = 0; tt < T; tt++) {
                        int64_t c = hist[(int64_t)tt * D + d];
                        hist[(int64_t)tt * D + d] = acc;
                        acc += c;
                    }
                }
                bounds[D] = acc;
            }
            for (int64_t i = lo; i < hi; i++)
                part[h[recs[i].km >> sh]++] = recs[i];
#pragma omp barrier
#pragma omp for schedule(dynamic, 1)
            for (int d = 0; d < D; d++)
                std::sort(part + bounds[d], part + bounds[d + 1], by_km);
        }
        delete[] hist;
        delete[] bounds;
        srt = part;
    }
    // run sweep: keep single-label runs with count > min_count
    int64_t out = 0;
    int64_t i = 0;
    while (i < n) {
        const uint64_t key = srt[i].km;
        const uint32_t first = (uint32_t)(srt[i].pay >> 32);
        uint64_t total = srt[i].pay & 0xFFFFFFFFull;
        bool specific = true;
        int64_t j = i + 1;
        for (; j < n && srt[j].km == key; j++) {
            if ((uint32_t)(srt[j].pay >> 32) != first) specific = false;
            total += srt[j].pay & 0xFFFFFFFFull;
        }
        if (total > 0xFFFFFFFFull) total = 0xFFFFFFFFull;
        if (specific && (min_count <= 0 || total > (uint64_t)min_count)) {
            out_km[out] = key;
            out_lb[out] = first;
            out_ct[out] = (uint32_t)total;
            out++;
        }
        i = j;
    }
    return out;
}

// ---- spill-shard partition (out-of-core DB build) ----
// Orders (kmer, label, count) occurrence records by their k-mer-range
// shard (top bits) in one count + one scatter pass — replacing a
// numpy argsort in _SpillStore.add (the disk-shard stage of the
// external-sort answer to the reference's in-RAM mother table,
// src/hashTable_hh.hh / README.md:93-94).  out is [n] interleaved
// {km, (lb<<32)|ct} records; bounds[D+1] receives exclusive prefix
// offsets per shard.

void spill_partition(const uint64_t* km, const uint32_t* lb,
                     const uint32_t* ct, int32_t has_ct, int64_t n,
                     int32_t shift, int32_t nshards,
                     uint64_t* out, int64_t* bounds) {
    for (int s = 0; s <= nshards; s++) bounds[s] = 0;
    for (int64_t i = 0; i < n; i++)
        bounds[(km[i] >> shift) + 1]++;
    for (int s = 0; s < nshards; s++) bounds[s + 1] += bounds[s];
    int64_t* off = new int64_t[nshards];
    memcpy(off, bounds, nshards * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        int64_t p = off[km[i] >> shift]++;
        out[2 * p] = km[i];
        out[2 * p + 1] =
            ((uint64_t)lb[i] << 32) | (has_ct ? ct[i] : 1u);
    }
    delete[] off;
}

// ---- CLARK CSV row formatting ----
// Exact row format of printExtendedResultsSynced (normal mode),
// src/CuCLARK_hh.hh:2127-2135: "%s,%u,%g,%s,%u,%s,%u,%g\n" with the
// read name truncated to OBJECTNAMEMAX-1 = 39 chars.

#include <cstdio>
#include <cstdlib>
#include <locale.h>

// Numeric formatting/parsing must be locale-INDEPENDENT: an embedding
// application may set LC_NUMERIC (e.g. de_DE), which would turn %g
// decimal points into commas (corrupting the CSV column count) and
// make strtod reject '0.75'.  uselocale() is per-thread; each worker
// switches to a cached "C" locale for the duration of its work.
static locale_t c_locale() {
    static locale_t l = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return l;
}
struct CLocaleScope {
    locale_t old;
    CLocaleScope() : old(uselocale(c_locale())) {}
    ~CLocaleScope() { uselocale(old); }
};

static int64_t fmt_rows_range(int64_t lo_r, int64_t hi_r,
                              const int64_t* norm, const double* gamma,
                              const int32_t* ibest, const int32_t* best,
                              const int32_t* isecond, const int32_t* second,
                              const double* conf,
                              const uint8_t* buf,
                              const int64_t* name_s, const int64_t* name_e,
                              const uint8_t* tnames, const int64_t* tname_off,
                              char* out, int64_t cap) {
    CLocaleScope cls;
    int64_t w = 0;
    for (int64_t i = lo_r; i < hi_r; i++) {
        int64_t nl = name_e[i] - name_s[i];
        if (nl > 39) nl = 39;
        int64_t t1 = ibest[i], t2 = isecond[i];
        int tl1 = (int)(tname_off[t1 + 1] - tname_off[t1]);
        int tl2 = (int)(tname_off[t2 + 1] - tname_off[t2]);
        if (w + nl + tl1 + tl2 + 160 > cap) return -1;
        int m = snprintf(out + w, cap - w,
                         "%.*s,%lld,%g,%.*s,%d,%.*s,%d,%g\n",
                         (int)nl, (const char*)(buf + name_s[i]),
                         (long long)norm[i], gamma[i],
                         tl1, (const char*)(tnames + tname_off[t1]), best[i],
                         tl2, (const char*)(tnames + tname_off[t2]), second[i],
                         conf[i]);
        if (m < 0) return -1;
        w += m;
    }
    return w;
}

// OpenMP row formatting: per-thread contiguous record ranges format
// into private scratch, then concatenate in order — the parallel
// counterpart of the reference's threaded result writing
// (src/CuCLARK_hh.hh:1755-1761, printExtendedResultsSynced).
// format_rows_printf and format_rows_ext_printf are the plain versions
// the row writer below (format_rows, format_rows_ext) is held to.
#define FMT_MAX_THREADS 16

int64_t format_rows_printf(int64_t n,
                           const int64_t* norm, const double* gamma,
                           const int32_t* ibest, const int32_t* best,
                           const int32_t* isecond, const int32_t* second,
                           const double* conf,
                           const uint8_t* buf,
                           const int64_t* name_s, const int64_t* name_e,
                           const uint8_t* tnames, const int64_t* tname_off,
                           char* out, int64_t cap) {
    int nt = 1;
#ifdef _OPENMP
    if (n >= 4096) {
        nt = omp_get_max_threads();
        if (nt > FMT_MAX_THREADS) nt = FMT_MAX_THREADS;
    }
#endif
    if (nt <= 1)
        return fmt_rows_range(0, n, norm, gamma, ibest, best, isecond,
                              second, conf, buf, name_s, name_e, tnames,
                              tname_off, out, cap);
    char* bufs[FMT_MAX_THREADS] = {nullptr};
    int64_t lens[FMT_MAX_THREADS] = {0};
    int T_sh = 1;
#pragma omp parallel num_threads(nt)
    {
        int t = omp_get_thread_num(), T = omp_get_num_threads();
#pragma omp single
        T_sh = T;
        const int64_t rlo = n * t / T, rhi = n * (t + 1) / T;
        int64_t c = 64;
        for (int64_t i = rlo; i < rhi; i++) {
            int64_t nl = name_e[i] - name_s[i];
            if (nl > 39) nl = 39;
            c += nl + 160
                 + (tname_off[ibest[i] + 1] - tname_off[ibest[i]])
                 + (tname_off[isecond[i] + 1] - tname_off[isecond[i]]);
        }
        char* b = (char*)malloc((size_t)c);
        bufs[t] = b;
        lens[t] = b ? fmt_rows_range(rlo, rhi, norm, gamma, ibest, best,
                                     isecond, second, conf, buf, name_s,
                                     name_e, tnames, tname_off, b, c)
                    : -1;
    }
    int64_t w = 0;
    for (int t = 0; t < T_sh; t++) {
        if (w >= 0) {
            if (lens[t] < 0 || w + lens[t] > cap) w = -1;
            else { memcpy(out + w, bufs[t], (size_t)lens[t]); w += lens[t]; }
        }
        free(bufs[t]);
    }
    return w;
}

// Extended-mode rows: one dense per-target hit-count column between
// the name and Length (src/CuCLARK_hh.hh:2014-2031 reconstructs the
// dense columns from sparse rows; here the host hands us the dense
// [n, n_targets] counts matrix directly).
static int64_t fmt_rows_ext_range(int64_t lo_r, int64_t hi_r,
                                  int64_t n_targets, const uint32_t* counts,
                                  const int64_t* norm, const double* gamma,
                                  const int32_t* ibest, const int32_t* best,
                                  const int32_t* isecond,
                                  const int32_t* second, const double* conf,
                                  const uint8_t* buf,
                                  const int64_t* name_s,
                                  const int64_t* name_e,
                                  const uint8_t* tnames,
                                  const int64_t* tname_off,
                                  char* out, int64_t cap) {
    CLocaleScope cls;
    int64_t w = 0;
    for (int64_t i = lo_r; i < hi_r; i++) {
        int64_t nl = name_e[i] - name_s[i];
        if (nl > 39) nl = 39;
        int64_t t1 = ibest[i], t2 = isecond[i];
        int tl1 = (int)(tname_off[t1 + 1] - tname_off[t1]);
        int tl2 = (int)(tname_off[t2 + 1] - tname_off[t2]);
        if (w + nl + 12 * (n_targets + 1) + tl1 + tl2 + 160 > cap) return -1;
        int m = snprintf(out + w, cap - w, "%.*s",
                         (int)nl, (const char*)(buf + name_s[i]));
        if (m < 0) return -1;
        w += m;
        const uint32_t* row = counts + i * n_targets;
        for (int64_t t = 0; t < n_targets; t++) {
            m = snprintf(out + w, cap - w, ",%u", row[t]);
            if (m < 0) return -1;
            w += m;
        }
        m = snprintf(out + w, cap - w,
                     ",%lld,%g,%.*s,%d,%.*s,%d,%g\n",
                     (long long)norm[i], gamma[i],
                     tl1, (const char*)(tnames + tname_off[t1]), best[i],
                     tl2, (const char*)(tnames + tname_off[t2]), second[i],
                     conf[i]);
        if (m < 0) return -1;
        w += m;
    }
    return w;
}

int64_t format_rows_ext_printf(int64_t n, int64_t n_targets,
                               const uint32_t* counts,
                               const int64_t* norm, const double* gamma,
                               const int32_t* ibest, const int32_t* best,
                               const int32_t* isecond,
                               const int32_t* second, const double* conf,
                               const uint8_t* buf,
                               const int64_t* name_s,
                               const int64_t* name_e,
                               const uint8_t* tnames,
                               const int64_t* tname_off,
                               char* out, int64_t cap) {
    int nt = 1;
#ifdef _OPENMP
    if (n * (n_targets + 8) >= 65536) {
        nt = omp_get_max_threads();
        if (nt > FMT_MAX_THREADS) nt = FMT_MAX_THREADS;
    }
#endif
    if (nt <= 1)
        return fmt_rows_ext_range(0, n, n_targets, counts, norm, gamma,
                                  ibest, best, isecond, second, conf, buf,
                                  name_s, name_e, tnames, tname_off, out,
                                  cap);
    char* bufs[FMT_MAX_THREADS] = {nullptr};
    int64_t lens[FMT_MAX_THREADS] = {0};
    int T_sh = 1;
#pragma omp parallel num_threads(nt)
    {
        int t = omp_get_thread_num(), T = omp_get_num_threads();
#pragma omp single
        T_sh = T;
        const int64_t rlo = n * t / T, rhi = n * (t + 1) / T;
        int64_t c = 64;
        for (int64_t i = rlo; i < rhi; i++) {
            int64_t nl = name_e[i] - name_s[i];
            if (nl > 39) nl = 39;
            c += nl + 12 * (n_targets + 1) + 160
                 + (tname_off[ibest[i] + 1] - tname_off[ibest[i]])
                 + (tname_off[isecond[i] + 1] - tname_off[isecond[i]]);
        }
        char* b = (char*)malloc((size_t)c);
        bufs[t] = b;
        lens[t] = b ? fmt_rows_ext_range(rlo, rhi, n_targets, counts, norm,
                                         gamma, ibest, best, isecond,
                                         second, conf, buf, name_s, name_e,
                                         tnames, tname_off, b, c)
                    : -1;
    }
    int64_t w = 0;
    for (int t = 0; t < T_sh; t++) {
        if (w >= 0) {
            if (lens[t] < 0 || w + lens[t] > cap) w = -1;
            else { memcpy(out + w, bufs[t], (size_t)lens[t]); w += lens[t]; }
        }
        free(bufs[t]);
    }
    return w;
}

// ---- The CSV row writer without printf ----
//
// format_rows / format_rows_ext write the rows of format_rows_printf /
// format_rows_ext_printf byte for byte, each field directly: the name
// and the target names by memcpy (cut at a NUL byte, as "%.*s" is),
// the integers from a two-digit table, and gamma and confidence by
// put_g, glibc's "%g" at precision 6.  Each thread writes a contiguous
// range of rows: thread 0 straight into the output, the others into a
// scratch buffer of their own kept across calls; after a barrier the
// others copy their pieces to prefix-summed offsets, in parallel.
// format_results / format_results_ext write the same rows from the
// card's results rows and the reads' lengths, computing each row's
// norm, gamma and confidence on the same team (classify's writer).

typedef unsigned __int128 u128;

struct Pow10Table {
    u128 v[39];
    constexpr Pow10Table() : v() {
        v[0] = 1;
        for (int i = 1; i < 39; i++) v[i] = v[i - 1] * 10;
    }
};
static constexpr Pow10Table kPow10{};

struct Digits2 {
    char c[200];
    constexpr Digits2() : c() {
        for (int i = 0; i < 100; i++) {
            c[2 * i] = (char)('0' + i / 10);
            c[2 * i + 1] = (char)('0' + i % 10);
        }
    }
};
static constexpr Digits2 kDigits2{};

static inline char* put_u64(char* p, uint64_t v) {
    char tmp[20];
    char* s = tmp + 20;
    while (v >= 100) {
        const uint64_t r = v % 100;
        v /= 100;
        s -= 2;
        memcpy(s, kDigits2.c + 2 * r, 2);
    }
    if (v >= 10) {
        s -= 2;
        memcpy(s, kDigits2.c + 2 * v, 2);
    } else {
        *--s = (char)('0' + v);
    }
    const size_t len = (size_t)(tmp + 20 - s);
    memcpy(p, s, len);
    return p + len;
}

static inline char* put_i64(char* p, int64_t v) {
    if (v < 0) {
        *p++ = '-';
        return put_u64(p, 0 - (uint64_t)v);
    }
    return put_u64(p, (uint64_t)v);
}

// m * 2^q (2^52 <= m < 2^53) rounded to 6 significant digits on its
// exact binary value, ties to even: *N in [10^5, 10^6) and the decimal
// exponent *X after the rounding, value N * 10^(X-5).  Exact in 128-bit
// integers for q in [-105, 20] (about 1.1e-16 to 9.4e21); false
// outside.  E starts near log10 2^(q+52) (78913 / 2^18 ~ log10 2, off
// by at most one here) and moves until floor(m 2^q 10^(5-E)) has 6
// digits, so the exponent is decided on the integer, never on a
// rounded logarithm.
static inline bool round6(uint64_t m, int q, uint32_t* N, int* X) {
    if (q < -105 || q > 20) return false;
    int E = ((q + 52) * 78913) >> 18;
    for (;;) {
        const int p = 5 - E;
        u128 I;
        int cmp;  // the remainder against half a unit: -1, 0, 1
        if (p >= 0 && q < 0) {  // m 10^p / 2^-q: a shift
            const u128 num = p <= 19
                ? (u128)m * (uint64_t)kPow10.v[p]
                : (u128)m * kPow10.v[p];
            const int s = -q;
            I = num >> s;
            const u128 r = num & (((u128)1 << s) - 1);
            const u128 h = (u128)1 << (s - 1);
            cmp = r < h ? -1 : (r > h ? 1 : 0);
        } else {
            u128 num = m, den = 1;
            if (p >= 0) num *= kPow10.v[p]; else den = kPow10.v[-p];
            if (q >= 0) num <<= q; else den <<= -q;
            I = num / den;
            const u128 r2 = (num - I * den) * 2;
            cmp = r2 < den ? -1 : (r2 > den ? 1 : 0);
        }
        if (I >= 1000000) { E++; continue; }
        if (I < 100000) { E--; continue; }
        uint32_t n = (uint32_t)I;
        if (cmp > 0 || (cmp == 0 && (n & 1))) n++;
        if (n == 1000000) { n = 100000; E++; }
        *N = n;
        *X = E;
        return true;
    }
}

// x as glibc's printf("%g", x) prints it in the C locale: X the decimal
// exponent after rounding to 6 significant digits; for -4 <= X < 6
// fixed notation with 5 - X decimals, else d.ddddde+XX (two exponent
// digits at least); trailing zeros and a trailing point stripped.  The
// sign of -0 and of a NaN is printed (0/0 on x86 is a NaN with the sign
// bit set: "-nan").  Subnormals and the magnitudes round6 does not
// cover go to snprintf; *n_printf counts them.
static inline char* put_g(char* p, double x, int64_t* n_printf) {
    uint64_t bits;
    memcpy(&bits, &x, 8);
    const bool neg = bits >> 63;
    const int be = (int)((bits >> 52) & 0x7FF);
    const uint64_t frac = bits & ((1ull << 52) - 1);
    if (be == 0x7FF) {
        if (neg) *p++ = '-';
        memcpy(p, frac ? "nan" : "inf", 3);
        return p + 3;
    }
    if (be == 0 && frac == 0) {
        if (neg) *p++ = '-';
        *p++ = '0';
        return p;
    }
    uint32_t N;
    int X;
    if (be == 0 || !round6(frac | (1ull << 52), be - 1075, &N, &X)) {
        ++*n_printf;
        CLocaleScope cls;
        return p + snprintf(p, 16, "%g", x);
    }
    if (neg) *p++ = '-';
    char d[6];
    for (int i = 5; i >= 0; i--) {
        d[i] = (char)('0' + N % 10);
        N /= 10;
    }
    int last = 6;  // the digits left once trailing zeros go
    while (last > 1 && d[last - 1] == '0') last--;
    if (X >= -4 && X < 6) {
        if (X >= 0) {
            const int ip = X + 1;  // integer digits
            memcpy(p, d, ip);
            p += ip;
            if (last > ip) {
                *p++ = '.';
                memcpy(p, d + ip, last - ip);
                p += last - ip;
            }
        } else {
            *p++ = '0';
            *p++ = '.';
            for (int i = 0; i < -X - 1; i++) *p++ = '0';
            memcpy(p, d, last);
            p += last;
        }
        return p;
    }
    *p++ = d[0];
    if (last > 1) {
        *p++ = '.';
        memcpy(p, d + 1, last - 1);
        p += last - 1;
    }
    *p++ = 'e';
    *p++ = X < 0 ? '-' : '+';
    const int ax = X < 0 ? -X : X;
    if (ax < 10) *p++ = '0';
    return put_u64(p, (uint64_t)ax);
}

// "%.*s" of (s, len): stops at a NUL byte
static inline char* put_str(char* p, const uint8_t* s, int64_t len) {
    const void* z = memchr(s, 0, (size_t)len);
    if (z) len = (const uint8_t*)z - s;
    memcpy(p, s, (size_t)len);
    return p + len;
}

// A batch's rows: the field arrays (norm ... conf), or the card's
// results rows with the reads' lengths (results set: the fields are
// computed here, row by row).
struct RowFields {
    int64_t n_targets;  // count columns a row (counts null: none)
    const uint32_t* counts;
    const int64_t* norm;
    const double* gamma;
    const int32_t* ibest;
    const int32_t* best;
    const int32_t* isecond;
    const int32_t* second;
    const double* conf;
    const uint8_t* buf;
    const int64_t* name_s;
    const int64_t* name_e;
    const uint8_t* tnames;
    const int64_t* tname_off;
    const int32_t* results;  // [n, 5]: total, ibest, best, isecond, second
    const int64_t* lengths;
    int64_t k;
    int64_t paired;  // 1: a joined pair, whose joining N leaves the norm
};

struct RowVals {
    int64_t norm;
    double gamma;
    int32_t ibest, best, isecond, second;
    double conf;
};

// Row i's values.  From a results row they are score.gamma_confidence's,
// bit for bit: the same IEEE double operations in the same order (the
// build has no -ffast-math, and none of them is a multiply-add that
// contraction could fuse).  A read of k - 1 bases divides 0 by 0 (a NaN
// with the sign bit set on x86, as numpy's), a shorter one 0 by a
// negative number (-0).
static inline RowVals row_vals(const RowFields& a, int64_t i) {
    RowVals v;
    if (a.results) {
        const int32_t* r = a.results + 5 * i;
        v.norm = a.lengths[i] - a.paired;
        v.gamma = (double)r[0] / (((double)v.norm - (double)a.k) + 1.0);
        v.ibest = r[1];
        v.best = r[2];
        v.isecond = r[3];
        v.second = r[4];
        const double s = (double)v.best + (double)v.second;
        v.conf = s < 0.001 ? 0.0 : (double)v.best / s;
    } else {
        v.norm = a.norm[i];
        v.gamma = a.gamma[i];
        v.ibest = a.ibest[i];
        v.best = a.best[i];
        v.isecond = a.isecond[i];
        v.second = a.second[i];
        v.conf = a.conf[i];
    }
    return v;
}

// the printf versions' room check for row i
static inline int64_t row_bound(const RowFields& a, int64_t i) {
    int64_t nl = a.name_e[i] - a.name_s[i];
    if (nl > 39) nl = 39;
    const int64_t t1 = a.results ? a.results[5 * i + 1] : a.ibest[i];
    const int64_t t2 = a.results ? a.results[5 * i + 3] : a.isecond[i];
    return nl + (a.counts ? 12 * (a.n_targets + 1) : 0) + 160
           + (a.tname_off[t1 + 1] - a.tname_off[t1])
           + (a.tname_off[t2 + 1] - a.tname_off[t2]);
}

// rows [lo, hi) at out (cap bytes): the bytes written, or -1 when a
// row's bound passes cap
static int64_t write_rows(const RowFields& a, int64_t lo, int64_t hi,
                          char* out, int64_t cap, int64_t* n_printf) {
    char* p = out;
    for (int64_t i = lo; i < hi; i++) {
        if ((p - out) + row_bound(a, i) > cap) return -1;
        int64_t nl = a.name_e[i] - a.name_s[i];
        if (nl > 39) nl = 39;
        p = put_str(p, a.buf + a.name_s[i], nl);
        if (a.counts) {
            const uint32_t* row = a.counts + i * a.n_targets;
            for (int64_t t = 0; t < a.n_targets; t++) {
                *p++ = ',';
                p = put_u64(p, row[t]);
            }
        }
        const RowVals v = row_vals(a, i);
        *p++ = ',';
        p = put_i64(p, v.norm);
        *p++ = ',';
        p = put_g(p, v.gamma, n_printf);
        const int64_t t1 = v.ibest, t2 = v.isecond;
        *p++ = ',';
        p = put_str(p, a.tnames + a.tname_off[t1],
                    a.tname_off[t1 + 1] - a.tname_off[t1]);
        *p++ = ',';
        p = put_i64(p, v.best);
        *p++ = ',';
        p = put_str(p, a.tnames + a.tname_off[t2],
                    a.tname_off[t2 + 1] - a.tname_off[t2]);
        *p++ = ',';
        p = put_i64(p, v.second);
        *p++ = ',';
        p = put_g(p, v.conf, n_printf);
        *p++ = '\n';
    }
    return p - out;
}

// a thread's piece of the rows, kept across calls (grown, never shrunk)
struct RowScratch {
    char* p = nullptr;
    int64_t cap = 0;
    ~RowScratch() { free(p); }
    bool reserve(int64_t need) {
        if (need <= cap) return true;
        char* q = (char*)realloc(p, (size_t)need);
        if (!q) return false;
        p = q;
        cap = need;
        return true;
    }
};
static thread_local RowScratch tl_rows;

static const int kFmtMaxTeam = 256;

// rows [0, n) on a team of at most T threads (the team OpenMP gives
// may be smaller; the ranges follow the team's actual size)
static int64_t write_rows_team(const RowFields& a, int64_t n, int64_t T,
                               char* out, int64_t cap, int64_t* n_printf) {
    *n_printf = 0;
    if (T <= 1) return write_rows(a, 0, n, out, cap, n_printf);
    if (T > kFmtMaxTeam) T = kFmtMaxTeam;
    int64_t len[kFmtMaxTeam], off[kFmtMaxTeam], cnt[kFmtMaxTeam];
    int64_t total = 0;
#pragma omp parallel num_threads((int)T)
    {
        int t = 0, Tr = 1;
#ifdef _OPENMP
        t = omp_get_thread_num();
        Tr = omp_get_num_threads();
#endif
        const int64_t lo = n * t / Tr, hi = n * (t + 1) / Tr;
        int64_t c = 0, w;
        if (t == 0) {
            w = write_rows(a, lo, hi, out, cap, &c);
        } else {
            int64_t need = 0;
            for (int64_t i = lo; i < hi; i++) need += row_bound(a, i);
            w = tl_rows.reserve(need)
                    ? write_rows(a, lo, hi, tl_rows.p, need, &c) : -1;
        }
        len[t] = w;
        cnt[t] = c;
#pragma omp barrier
#pragma omp single
        {
            for (int u = 0; u < Tr && total >= 0; u++) {
                off[u] = total;
                total = len[u] < 0 ? -1 : total + len[u];
                *n_printf += cnt[u];
            }
            if (total > cap) total = -1;
        }
        if (t > 0 && total >= 0)
            memcpy(out + off[t], tl_rows.p, (size_t)len[t]);
    }
    return total;
}

// The team for n rows: nthreads when > 0 (tests pin it), else one
// thread below min_rows (as the printf versions choose) and
// rows_share() (at most FMT_MAX_THREADS) from there up.
static int64_t format_team(int64_t n, int64_t min_rows, int64_t nthreads) {
    if (nthreads > 0) return nthreads;
    if (n < min_rows) return 1;
    const int64_t nt = rows_share();
    return nt < FMT_MAX_THREADS ? nt : FMT_MAX_THREADS;
}

// The team format_rows runs n rows on (nthreads as format_team).
int64_t format_rows_team(int64_t n, int64_t nthreads) {
    return format_team(n, 4096, nthreads);
}

// The extended rows' one-thread floor: one thread while
// n * (n_targets + 8) < 65536, as the printf version.
static int64_t ext_min_rows(int64_t n_targets) {
    return (65536 + n_targets + 7) / (n_targets + 8);
}

// The rows of format_rows_printf; nthreads as format_team; *n_printf
// receives the count of values put_g handed to snprintf.  Returns the
// bytes written, or -1 when cap is too small.
int64_t format_rows(int64_t n,
                    const int64_t* norm, const double* gamma,
                    const int32_t* ibest, const int32_t* best,
                    const int32_t* isecond, const int32_t* second,
                    const double* conf,
                    const uint8_t* buf,
                    const int64_t* name_s, const int64_t* name_e,
                    const uint8_t* tnames, const int64_t* tname_off,
                    char* out, int64_t cap, int64_t nthreads,
                    int64_t* n_printf) {
    const RowFields a = {0, nullptr, norm, gamma, ibest, best, isecond,
                         second, conf, buf, name_s, name_e, tnames,
                         tname_off, nullptr, nullptr, 0, 0};
    return write_rows_team(a, n, format_team(n, 4096, nthreads), out, cap,
                           n_printf);
}

// The rows of format_rows_ext_printf (n_targets count columns a row).
int64_t format_rows_ext(int64_t n, int64_t n_targets,
                        const uint32_t* counts,
                        const int64_t* norm, const double* gamma,
                        const int32_t* ibest, const int32_t* best,
                        const int32_t* isecond, const int32_t* second,
                        const double* conf,
                        const uint8_t* buf,
                        const int64_t* name_s, const int64_t* name_e,
                        const uint8_t* tnames, const int64_t* tname_off,
                        char* out, int64_t cap, int64_t nthreads,
                        int64_t* n_printf) {
    const RowFields a = {n_targets, counts, norm, gamma, ibest, best,
                         isecond, second, conf, buf, name_s, name_e,
                         tnames, tname_off, nullptr, nullptr, 0, 0};
    return write_rows_team(a, n, format_team(n, ext_min_rows(n_targets),
                                             nthreads),
                           out, cap, n_printf);
}

// The rows of format_rows from the card's results rows ([n, 5] int32,
// row-major: total, best index, best, second index, second) and the
// reads' lengths: norm = length - paired, gamma and confidence computed
// on the writer's team (row_vals), as score.gamma_confidence computes
// them.  nthreads, *n_printf and the return as format_rows.
int64_t format_results(int64_t n, const int32_t* results,
                       const int64_t* lengths, int64_t k, int64_t paired,
                       const uint8_t* buf,
                       const int64_t* name_s, const int64_t* name_e,
                       const uint8_t* tnames, const int64_t* tname_off,
                       char* out, int64_t cap, int64_t nthreads,
                       int64_t* n_printf) {
    const RowFields a = {0, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, buf, name_s, name_e,
                         tnames, tname_off, results, lengths, k, paired};
    return write_rows_team(a, n, format_team(n, 4096, nthreads), out, cap,
                           n_printf);
}

// The rows of format_rows_ext from results rows, as format_results.
int64_t format_results_ext(int64_t n, int64_t n_targets,
                           const uint32_t* counts, const int32_t* results,
                           const int64_t* lengths, int64_t k, int64_t paired,
                           const uint8_t* buf,
                           const int64_t* name_s, const int64_t* name_e,
                           const uint8_t* tnames, const int64_t* tname_off,
                           char* out, int64_t cap, int64_t nthreads,
                           int64_t* n_printf) {
    const RowFields a = {n_targets, counts, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, buf, name_s,
                         name_e, tnames, tname_off, results, lengths, k,
                         paired};
    return write_rows_team(a, n, format_team(n, ext_min_rows(n_targets),
                                             nthreads),
                           out, cap, n_printf);
}

// ---- result-CSV ingestion (abundance / density summarization) ----
// The downstream of CLARK's estimate_abundance / density scripts
// (reference README.md:58-80 consumes the classify CSV).  A 100M-row
// ladder-4 result file must not be re-parsed row-by-row in Python;
// one native pass tallies per-target counts (interning assignment
// names on the fly) or extracts a float column for assigned rows.

// Parse one CSV line in [i, n): records up to ncols field (start,end)
// pairs, returns the byte offset just past the line's '\n' (or n).
// *nf receives the field count.  A '\r' immediately before the '\n'
// (CRLF file) is excluded from the final field.  No quoting: CLARK
// CSVs are never quoted (format_rows writes raw names).
static inline int64_t csv_line(const uint8_t* buf, int64_t n, int64_t i,
                               int64_t* fs, int64_t* fe, int32_t ncols,
                               int32_t* nf) {
    int32_t f = 0;
    int64_t s = i;
    while (i < n) {
        uint8_t c = buf[i];
        if (c == ',' || c == '\n') {
            int64_t e = (c == '\n' && i > s && buf[i - 1] == '\r')
                            ? i - 1 : i;
            if (f < ncols) { fs[f] = s; fe[f] = e; }
            f++;
            s = i + 1;
            if (c == '\n') { *nf = f; return i + 1; }
        }
        i++;
    }
    // final line without '\n' (crash-truncated tail): report its
    // fields; the caller decides whether a complete field set counts
    if (s < i || f) { if (f < ncols) { fs[f] = s; fe[f] = i; } f++; }
    *nf = f;
    return n;
}

// Locale-safe float field parse (field is NOT null-terminated and may
// abut a page boundary at EOF: copy to a stack buffer first).  *ok is
// cleared when the field is empty, oversized, or not fully numeric —
// a corrupt confidence/gamma value must surface as a malformed-row
// error, not silently compare as 0.0 (the csv-module fallback raises
// on float('garbage'); the native path must match).
static inline double csv_f64(const uint8_t* buf, int64_t s, int64_t e,
                             bool* ok) {
    char tmp[64];
    int64_t len = e - s;
    if (len <= 0 || len >= (int64_t)sizeof(tmp)) { *ok = false; return 0.0; }
    memcpy(tmp, buf + s, (size_t)len);
    tmp[len] = 0;
    char* end = tmp;
    double v = strtod(tmp, &end);
    if (end != tmp + len) *ok = false;
    return v;
}

// Open-addressing name interner over (offset,len) byte slices.
struct NameIntern {
    const uint8_t* buf;
    int64_t* slot_off;   // [cap_slots] offset into names blob, -1 empty
    int32_t* slot_id;
    int64_t cap_slots;   // power of two
    uint8_t* names;      // caller blob
    int64_t names_cap, names_w;
    int64_t* name_off;   // [max_names + 1]
    int32_t max_names, n_names;
};

static uint64_t ni_hash(const uint8_t* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (int64_t i = 0; i < len; i++) { h ^= p[i]; h *= 1099511628211ull; }
    return h;
}

// Returns the id for the name bytes, interning on first sight;
// -1 on capacity overflow (max_names or names blob).
static int32_t ni_get(NameIntern* ni, const uint8_t* p, int64_t len) {
    uint64_t h = ni_hash(p, len);
    int64_t m = ni->cap_slots - 1;
    for (int64_t j = h & m;; j = (j + 1) & m) {
        if (ni->slot_off[j] < 0) {
            if (ni->n_names >= ni->max_names
                || ni->names_w + len > ni->names_cap)
                return -1;
            memcpy(ni->names + ni->names_w, p, (size_t)len);
            ni->slot_off[j] = ni->names_w;
            ni->slot_id[j] = ni->n_names;
            ni->names_w += len;
            ni->name_off[ni->n_names + 1] = ni->names_w;
            return ni->n_names++;
        }
        int64_t off = ni->slot_off[j];
        int32_t id = ni->slot_id[j];
        if (ni->name_off[id + 1] - ni->name_off[id] == len
            && memcmp(ni->names + off, p, (size_t)len) == 0)
            return id;
    }
}

// One-pass abundance tally.  buf starts AFTER the header line.  Column
// indices are from the header (col_conf / col_gamma -1 when absent).
// Id 0 is pre-interned as "NA"; low-confidence / low-gamma assignments
// count as NA (CLARK estimate_abundance -c / --highconfidence filter).
// counts[max_names] int64 must be zeroed by the caller.  Returns the
// number of distinct names (>= 1), or -(byte_offset+1) of the first
// malformed line (wrong field count), or -(n+2) on interner overflow.
// *total_out receives the data row count.  A trailing line without
// '\n' is counted only when it has the full field set.
int64_t csv_tally(const uint8_t* buf, int64_t n,
                  int32_t ncols, int32_t col_assign,
                  int32_t col_conf, int32_t col_gamma,
                  double min_conf, double min_gamma,
                  int64_t* counts, int32_t max_names,
                  uint8_t* names, int64_t names_cap, int64_t* name_off,
                  int64_t* total_out) {
    CLocaleScope cls;
    if (ncols > 4096 || col_assign < 0 || col_assign >= ncols
        || col_conf >= ncols || col_gamma >= ncols)
        return -(n + 2);
    int64_t* fs = new int64_t[ncols];
    int64_t* fe = new int64_t[ncols];
    int64_t cap_slots = 64;
    while (cap_slots < (int64_t)max_names * 2) cap_slots <<= 1;
    int64_t* slot_off = new int64_t[cap_slots];
    int32_t* slot_id = new int32_t[cap_slots];
    for (int64_t j = 0; j < cap_slots; j++) slot_off[j] = -1;
    NameIntern ni = {buf, slot_off, slot_id, cap_slots,
                     names, names_cap, 0, name_off, max_names, 0};
    name_off[0] = 0;
    ni_get(&ni, (const uint8_t*)"NA", 2);  // id 0
    int64_t i = 0, total = 0, err = 0;
    while (i < n && !err) {
        int32_t nf = 0;
        int64_t line_s = i;
        i = csv_line(buf, n, i, fs, fe, ncols, &nf);
        if (nf == 1 && fe[0] == fs[0]) continue;  // blank line
        if (nf != ncols) {
            // only a final line WITHOUT its '\n' is a crash-truncated
            // tail; a newline-terminated last row was fully written
            // and a wrong field count there is real corruption
            if (i >= n && buf[n - 1] != '\n') break;
            err = -(line_s + 1);
            break;
        }
        int64_t as = fs[col_assign], ae = fe[col_assign];
        bool ok = true;
        int32_t id;
        if (ae - as == 2 && buf[as] == 'N' && buf[as + 1] == 'A') {
            id = 0;
        } else if (min_conf > 0 && col_conf >= 0
                   && csv_f64(buf, fs[col_conf], fe[col_conf], &ok)
                          < min_conf) {
            id = 0;
        } else if (min_gamma > 0 && col_gamma >= 0
                   && csv_f64(buf, fs[col_gamma], fe[col_gamma], &ok)
                          < min_gamma) {
            id = 0;
        } else {
            id = ni_get(&ni, buf + as, ae - as);
            if (id < 0) { err = -(n + 2); break; }
        }
        if (!ok) { err = -(line_s + 1); break; }
        counts[id]++;
        total++;
    }
    int32_t n_names = ni.n_names;
    delete[] fs; delete[] fe; delete[] slot_off; delete[] slot_id;
    *total_out = total;
    return err ? err : n_names;
}

// Number of '\n' bytes (row-count upper bound for csv_values).
int64_t count_lines(const uint8_t* buf, int64_t n) {
    int64_t c = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
        if (!q) break;
        c++;
        p = q + 1;
    }
    return c;
}

// Extract float column col_val for rows whose col_assign != "NA"
// (density histogram input).  Same conventions as csv_tally.  Returns
// values written, or -(byte_offset+1) on a malformed line.
int64_t csv_values(const uint8_t* buf, int64_t n,
                   int32_t ncols, int32_t col_val, int32_t col_assign,
                   double* out, int64_t cap) {
    CLocaleScope cls;
    if (ncols > 4096 || col_val < 0 || col_val >= ncols
        || col_assign < 0 || col_assign >= ncols)
        return -(n + 2);
    int64_t* fs = new int64_t[ncols];
    int64_t* fe = new int64_t[ncols];
    int64_t i = 0, w = 0, err = 0;
    while (i < n && !err) {
        int32_t nf = 0;
        int64_t line_s = i;
        i = csv_line(buf, n, i, fs, fe, ncols, &nf);
        if (nf == 1 && fe[0] == fs[0]) continue;
        if (nf != ncols) {
            if (i >= n && buf[n - 1] != '\n') break;  // truncated tail
            err = -(line_s + 1);
            break;
        }
        int64_t as = fs[col_assign], ae = fe[col_assign];
        if (ae - as == 2 && buf[as] == 'N' && buf[as + 1] == 'A') continue;
        if (w >= cap) { err = -(n + 2); break; }
        bool ok = true;
        out[w] = csv_f64(buf, fs[col_val], fe[col_val], &ok);
        if (!ok) { err = -(line_s + 1); break; }
        w++;
    }
    delete[] fs; delete[] fe;
    return err ? err : w;
}

}  // extern "C"
