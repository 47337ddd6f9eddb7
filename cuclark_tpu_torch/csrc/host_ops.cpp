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

// ---------------------------------------------------------------------
// gzip inflate on the OpenMP team (RFC 1951 / 1952).
//
// gz_inflate gives the bytes `gzip.GzipFile(...).read()` gives, and
// refuses (a negative return) every input that reader rejects: members
// one after another, zero bytes after a member's trailer skipped, each
// member's CRC32 and ISIZE (its length mod 2^32) checked, anything else
// after the last member refused.  It accepts exactly the deflate streams
// zlib accepts: block type 3, a stored block with LEN != ~NLEN, more
// than 286 length or 30 distance codes, an incomplete or oversubscribed
// code (a lone length-1 code excepted for the literal/length and the
// distance code, as zlib's inflate_table allows), a bad repeat, a
// missing end-of-block code, symbols 286-287 or distances 30-31, and a
// distance reaching before its member's first byte are refused.
//
// Work is cut two ways:
//  - a run of BGZF members (FEXTRA subfield "BC" with BSIZE, as htslib's
//    bgzip writes) states each member's bounds and, in its trailer, its
//    size: the members are inflated a member a thread into their places;
//  - anything else (one large member, concatenated members) is cut into
//    chunks of compressed bytes, as pugz (Kerbiriou & Chikhi 2019) and
//    rapidgzip (Knespel & Brunst 2023) do.  Each chunk after the first
//    searches forward from its first bit for a block start (a dynamic
//    header whose code lengths build complete codes, or a stored block
//    with LEN == ~NLEN behind three zero bits) and decodes from there
//    into 16-bit symbols: a back-reference before the chunk's start
//    copies a marker (256 + its index in the unknown 32 KiB window);
//    once the last 32 KiB written hold no marker the chunk goes on in
//    bytes.  Chunk i, decoded from its confirmed start, stops at the
//    first block boundary at or past chunk i+1's guess: reaching it
//    exactly confirms the guess; passing it means the guess was wrong,
//    and chunk i+1 is decoded again from chunk i's end.  A chunk with no
//    start found joins the one before it.  So the bytes are the
//    sequential decode's whatever the finder guesses.  The chunks run in
//    waves of one a thread; a wave's first chunk starts confirmed, with
//    the real window, and writes straight into the output.  Windows pass
//    forward a chunk at a time (each chunk's last 32 KiB, in order), then
//    every thread replaces its chunk's markers, copies it into place and
//    takes the CRC32 of each member's part of it; the parts are combined
//    (crc32_combine's GF(2) product) and checked against the trailers.
//
// The output is an anonymous mapping that grows by mremap; gz_free
// unmaps it.

#include <sys/mman.h>

#include <vector>

namespace gzi {

static const int64_t kWin = 32768;
static const int64_t kSlack = 258 + 16;   // a copy's overrun room

enum { R_EOB = 0, R_DATA = -2, R_TRUNC = -3, R_SPACE = 1, R_CAP = -8 };
// gz_inflate's codes (negative: refused)
enum { E_HEADER = -1, E_DATA = -2, E_TRUNC = -3, E_CRC = -4, E_SIZE = -5,
       E_NOMEM = -7 };

// --- CRC32 (slice-by-8) and its combination ---------------------------
struct CrcTables {
    uint32_t t[8][256];
    uint32_t x2n[32];   // x^(2^k) mod P
    CrcTables() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (int j = 1; j < 8; j++)
            for (int i = 0; i < 256; i++)
                t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
        uint32_t p = 1u << 30;  // x^1
        x2n[0] = p;
        for (int k = 1; k < 32; k++) x2n[k] = p = multmodp(p, p);
    }
    // a(x) b(x) mod P(x), bit-reflected as zlib's crc32 holds them
    static uint32_t multmodp(uint32_t a, uint32_t b) {
        uint32_t m = 1u << 31, p = 0;
        while (m) {
            if (a & m) p ^= b;
            m >>= 1;
            b = (b & 1) ? (b >> 1) ^ 0xEDB88320u : b >> 1;
        }
        return p;
    }
};
static const CrcTables& crc_tables() {
    static const CrcTables T;
    return T;
}

static uint32_t crc32_one(uint32_t crc, const uint8_t* p, int64_t n) {
    const auto& T = crc_tables().t;
    uint32_t c = ~crc;
    while (n > 0 && ((uintptr_t)p & 7)) {
        c = (c >> 8) ^ T[0][(c ^ *p++) & 0xFF];
        n--;
    }
    while (n >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        uint32_t lo = (uint32_t)w ^ c, hi = (uint32_t)(w >> 32);
        c = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF] ^ T[5][(lo >> 16) & 0xFF]
            ^ T[4][lo >> 24] ^ T[3][hi & 0xFF] ^ T[2][(hi >> 8) & 0xFF]
            ^ T[1][(hi >> 16) & 0xFF] ^ T[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n-- > 0) c = (c >> 8) ^ T[0][(c ^ *p++) & 0xFF];
    return ~c;
}

static uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2);

// Four quarters at once (the table lookups of one do not wait on the
// others'), then combined.
static uint32_t crc32_update(uint32_t crc, const uint8_t* p, int64_t n) {
    if (n < (1 << 16)) return crc32_one(crc, p, n);
    const auto& T = crc_tables().t;
    int64_t q = (n / 4) & ~(int64_t)7;
    uint32_t c[4] = {~crc, ~0u, ~0u, ~0u};
    for (int64_t o = 0; o < q; o += 8) {
        for (int s = 0; s < 4; s++) {
            uint64_t w;
            memcpy(&w, p + s * q + o, 8);
            uint32_t lo = (uint32_t)w ^ c[s], hi = (uint32_t)(w >> 32);
            c[s] = T[7][lo & 0xFF] ^ T[6][(lo >> 8) & 0xFF]
                   ^ T[5][(lo >> 16) & 0xFF] ^ T[4][lo >> 24] ^ T[3][hi & 0xFF]
                   ^ T[2][(hi >> 8) & 0xFF] ^ T[1][(hi >> 16) & 0xFF]
                   ^ T[0][hi >> 24];
        }
    }
    uint32_t r = ~c[0];
    for (int s = 1; s < 4; s++) r = crc32_combine(r, ~c[s], (uint64_t)q);
    return crc32_one(r, p + 4 * q, n - 4 * q);
}

// the CRC32 of A followed by B from crc(A), crc(B) and |B| (any size)
static uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
    const auto& C = crc_tables();
    uint32_t p = 1u << 31;  // x^0
    for (unsigned k = 3; len2; len2 >>= 1, k++)
        if (len2 & 1) p = CrcTables::multmodp(C.x2n[k & 31], p);
    return CrcTables::multmodp(p, crc1) ^ crc2;
}

// --- bits, LSB first ---------------------------------------------------
struct Bits {
    const uint8_t* in = nullptr;
    int64_t n = 0;
    int64_t pos = 0;     // next byte to load (may pass n: zeros fed)
    uint64_t buf = 0;    // bits above cnt are zero or the true next bits
    int cnt = 0;
    int64_t over = 0;    // zero bytes fed past the end
    inline void refill() {
        if (pos + 8 <= n) {
            uint64_t w;
            memcpy(&w, in + pos, 8);
            buf |= w << cnt;
            pos += (63 - cnt) >> 3;
            cnt |= 56;
        } else {
            while (cnt <= 56) {
                uint64_t b = 0;
                if (pos < n) b = in[pos];
                else over++;
                pos++;
                buf |= b << cnt;
                cnt += 8;
            }
        }
    }
    inline void drop(int k) { buf >>= k; cnt -= k; }
    inline uint32_t bits(int k) const {
        return (uint32_t)(buf & ((1ull << k) - 1));
    }
    int64_t bitpos() const { return pos * 8 - cnt; }
    void seek(int64_t bit) {
        pos = bit >> 3;
        buf = 0;
        cnt = 0;
        over = 0;
        refill();
        drop((int)(bit & 7));
    }
};

// --- Huffman tables ----------------------------------------------------
// entry: [0,4) bits this level, [4,8) extra bits (sub-table bits for a
// link), [8,11) kind, [16,32) value
enum { K_LIT = 0, K_LEN = 1, K_EOB = 2, K_SUB = 3, K_BAD = 4 };
static const int kLitRoot = 10, kDistRoot = 8, kClRoot = 7;
static const int kLitCap = 2048, kDistCap = 1024;

static inline uint32_t ent(uint32_t val, uint32_t kind, uint32_t extra,
                           uint32_t len) {
    return (val << 16) | (kind << 8) | (extra << 4) | len;
}
static inline uint32_t kind_of(uint32_t e) { return (e >> 8) & 7; }

static const uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
    59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 5, 5, 0};
static const uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
    513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
    24577};
static const uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
    10, 11, 11, 12, 12, 13, 13};
static const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11,
                                     4, 12, 3, 13, 2, 14, 1, 15};

enum { T_CL = 0, T_LIT = 1, T_DIST = 2 };

static inline uint32_t sym_entry(int type, int s, int len) {
    if (type == T_CL) return ent(s, K_LIT, 0, len);
    if (type == T_DIST)
        return s < 30 ? ent(kDistBase[s], K_LIT, kDistExtra[s], len)
                      : ent(0, K_BAD, 0, len);
    if (s < 256) return ent(s, K_LIT, 0, len);
    if (s == 256) return ent(0, K_EOB, 0, len);
    if (s < 286) return ent(kLenBase[s - 257], K_LEN, kLenExtra[s - 257], len);
    return ent(0, K_BAD, 0, len);
}

static inline uint32_t rev_bits(uint32_t c, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; i++) { r = (r << 1) | (c & 1); c >>= 1; }
    return r;
}

// zlib's acceptance of a set of code lengths: none oversubscribed, and
// complete unless (literal/length or distance) a lone length-1 code.
// max == 0 (no code) is accepted for the distance code only here: zlib
// accepts it for both, but a literal/length code without the
// end-of-block code (checked by the caller) is refused anyway.
static int lengths_ok(const uint8_t* lens, int n, int type, int* maxp,
                      int* count) {
    for (int l = 0; l < 16; l++) count[l] = 0;
    for (int s = 0; s < n; s++) count[lens[s]]++;
    int max = 15;
    while (max > 0 && count[max] == 0) max--;
    *maxp = max;
    if (max == 0) return type == T_DIST ? 0 : -1;
    int left = 1;
    for (int l = 1; l <= 15; l++) {
        left <<= 1;
        left -= count[l];
        if (left < 0) return -1;
    }
    if (left > 0 && (type == T_CL || max != 1)) return -1;
    return 0;
}

// Build a two-level table (root bits, then sub-tables).  Returns 0, or
// -1 for lengths zlib refuses.
static int build_table(const uint8_t* lens, int n, int type, int root,
                       uint32_t* table, int cap) {
    int count[16], max;
    if (lengths_ok(lens, n, type, &max, count)) return -1;
    int size = 1 << root;
    for (int i = 0; i < size; i++) table[i] = ent(0, K_BAD, 0, 0);
    if (max == 0) return 0;
    int offs[17];
    offs[1] = 0;
    for (int l = 1; l < 16; l++) offs[l + 1] = offs[l] + count[l];
    uint16_t sorted[320];
    for (int s = 0; s < n; s++)
        if (lens[s]) sorted[offs[lens[s]]++] = (uint16_t)s;
    int rem[16];
    for (int l = 0; l < 16; l++) rem[l] = count[l];
    uint32_t code = 0;
    int prev = 0, k = 0, next = size, cur_prefix = -1, sub_off = 0,
        sub_bits = 0;
    for (int l = 1; l <= max; l++) {
        for (int c = 0; c < count[l]; c++, k++) {
            code <<= (l - prev);
            prev = l;
            int s = sorted[k];
            uint32_t r = rev_bits(code, l);
            if (l <= root) {
                uint32_t e = sym_entry(type, s, l);
                for (uint32_t i = r; i < (uint32_t)size; i += 1u << l)
                    table[i] = e;
            } else {
                int prefix = (int)(r & (uint32_t)(size - 1));
                if (prefix != cur_prefix) {
                    int curr = l - root, left = 1 << curr;
                    while (curr + root < max) {
                        left -= rem[curr + root];
                        if (left <= 0) break;
                        curr++;
                        left <<= 1;
                    }
                    sub_off = next;
                    sub_bits = curr;
                    next += 1 << curr;
                    if (next > cap) return -1;
                    table[prefix] = ent(sub_off, K_SUB, sub_bits, root);
                    cur_prefix = prefix;
                }
                uint32_t e = sym_entry(type, s, l - root);
                for (uint32_t i = r >> root; i < (1u << sub_bits);
                     i += 1u << (l - root))
                    table[sub_off + i] = e;
            }
            rem[l]--;
            code++;
        }
    }
    return 0;
}

struct FixedTables {
    uint32_t lit[kLitCap], dist[kDistCap];
    FixedTables() {
        uint8_t l[288];
        for (int i = 0; i < 144; i++) l[i] = 8;
        for (int i = 144; i < 256; i++) l[i] = 9;
        for (int i = 256; i < 280; i++) l[i] = 7;
        for (int i = 280; i < 288; i++) l[i] = 8;
        build_table(l, 288, T_LIT, kLitRoot, lit, kLitCap);
        uint8_t d[32];
        for (int i = 0; i < 32; i++) d[i] = 5;
        build_table(d, 32, T_DIST, kDistRoot, dist, kDistCap);
    }
};
static const FixedTables& fixed_tables() {
    static const FixedTables F;
    return F;
}

// Read a dynamic block's header (after its 3 header bits) and build its
// tables.  Returns 0, R_DATA or R_TRUNC.
static int read_dynamic(Bits& br, uint32_t* lit, uint32_t* dist) {
    br.refill();
    int hlit = (int)br.bits(5) + 257;
    br.drop(5);
    int hdist = (int)br.bits(5) + 1;
    br.drop(5);
    int hclen = (int)br.bits(4) + 4;
    br.drop(4);
    if (hlit > 286 || hdist > 30) return R_DATA;
    uint8_t cl[19] = {0};
    for (int i = 0; i < hclen; i++) {
        if (br.cnt < 3) br.refill();
        cl[kClOrder[i]] = (uint8_t)br.bits(3);
        br.drop(3);
    }
    uint32_t clt[1 << kClRoot];
    if (build_table(cl, 19, T_CL, kClRoot, clt, 1 << kClRoot)) return R_DATA;
    uint8_t lens[320];
    int total = hlit + hdist, i = 0;
    while (i < total) {
        br.refill();
        if (br.over > 8) return R_TRUNC;
        uint32_t e = clt[br.bits(kClRoot)];
        br.drop(e & 15);
        int sym = (int)(e >> 16);
        if (sym < 16) { lens[i++] = (uint8_t)sym; continue; }
        int rep;
        uint8_t v = 0;
        if (sym == 16) {
            if (i == 0) return R_DATA;
            v = lens[i - 1];
            rep = 3 + (int)br.bits(2);
            br.drop(2);
        } else if (sym == 17) {
            rep = 3 + (int)br.bits(3);
            br.drop(3);
        } else {
            rep = 11 + (int)br.bits(7);
            br.drop(7);
        }
        if (i + rep > total) return R_DATA;
        while (rep--) lens[i++] = v;
    }
    if (br.over > 8) return R_TRUNC;
    if (lens[256] == 0) return R_DATA;
    if (build_table(lens, hlit, T_LIT, kLitRoot, lit, kLitCap)) return R_DATA;
    if (build_table(lens + hlit, hdist, T_DIST, kDistRoot, dist, kDistCap))
        return R_DATA;
    return 0;
}

// --- output buffers ----------------------------------------------------
// Anonymous mappings that grow by mremap (no copy).  A fresh page's
// fault is a large share of a byte's cost when every thread faults at
// once, so a first mapping of an expected size is populated whole
// (`populate`), and chunk buffers are reused from wave to wave.
static void* grow_map(void* p, int64_t old_bytes, int64_t bytes,
                      bool populate = false) {
    void* q = p ? mremap(p, (size_t)old_bytes, (size_t)bytes, MREMAP_MAYMOVE)
                : mmap(nullptr, (size_t)bytes, PROT_READ | PROT_WRITE,
                       MAP_PRIVATE | MAP_ANONYMOUS
                           | (populate ? MAP_POPULATE : 0), -1, 0);
    return q == MAP_FAILED ? nullptr : q;
}
static inline int64_t page_round(int64_t b) {
    return (b + 4095) & ~(int64_t)4095;
}

struct ByteBuf {          // bytes, with `pre` bytes of window before out()
    uint8_t* base = nullptr;
    int64_t pre = 0, len = 0, cap = 0;
    uint8_t* out() { return base + pre; }
    // room for `need` output bytes + slack; a first mapping populated
    // up to `populate` bytes' worth
    bool reserve(int64_t need, bool populate = false) {
        int64_t want = pre + need + kSlack;
        if (want <= cap) return true;
        int64_t nc = page_round(std::max(want, cap + cap / 2));
        void* p = grow_map(base, cap, nc, populate);
        if (!p) return false;
        base = (uint8_t*)p;
        cap = nc;
        return true;
    }
    void release() {
        if (base) munmap(base, (size_t)cap);
        base = nullptr;
        cap = len = pre = 0;
    }
};

struct WideBuf {          // 16-bit symbols after kWin markers
    uint16_t* base = nullptr;
    int64_t len = 0, cap = 0;  // cap counts symbols after the prefix
    uint16_t* out() { return base + kWin; }
    bool reserve(int64_t need, bool populate = false) {
        if (need + kSlack <= cap) return true;
        int64_t nb = page_round(
            (kWin + std::max(need + kSlack, cap + cap / 2)) * 2);
        bool fresh = base == nullptr;
        void* p = grow_map(base, cap ? (kWin + cap) * 2 : 0, nb, populate);
        if (!p) return false;
        base = (uint16_t*)p;
        if (fresh)
            for (int64_t i = 0; i < kWin; i++) base[i] = (uint16_t)(256 + i);
        cap = nb / 2 - kWin;
        return true;
    }
    void release() {
        if (base) munmap(base, (size_t)(kWin + cap) * 2);
        base = nullptr;
        len = cap = 0;
    }
};

template <typename T>
struct Out {
    T* o;
    int64_t pos, cap;      // output written; room (positions) before slack
    int64_t floor;         // smallest position a copy may read
    int64_t min_ref;       // smallest position read before 0 (wide)
};

// Do the last kWin symbols hold no marker?  Asked at a block's end; the
// tail is searched from its end, where a marker is likeliest.
static bool marker_free(const WideBuf& w) {
    if (w.len < kWin) return false;
    const uint16_t* o = w.base + kWin;
    for (int64_t e = w.len; e > w.len - kWin; e -= 256) {
        uint16_t m = 0;
        for (int k = 1; k <= 256; k++) m |= o[e - k];
        if (m >= 256) return false;
    }
    return true;
}

// Decode symbols of a Huffman block until its end-of-block code, an
// error, or the room runs out (R_SPACE: grow and call again).
template <typename T>
static int huff(Bits& brr, const uint32_t* lt, const uint32_t* dt,
                Out<T>& s) {
    constexpr bool W = sizeof(T) == 2;
    Bits br = brr;
    T* o = s.o;
    int64_t pos = s.pos;
    const int64_t lim = s.cap - 258;
    const int64_t floor = s.floor;
    int64_t min_ref = s.min_ref;
    int rc;
    for (;;) {
        if (pos > lim) { rc = R_SPACE; break; }
        br.refill();
        if (br.over > 8) { rc = R_TRUNC; break; }
        uint32_t e = lt[br.buf & ((1u << kLitRoot) - 1)];
        // a run of literals from the root table (codes of at most
        // kLitRoot bits) while that many bits are held
        while (kind_of(e) == K_LIT) {
            br.drop(e & 15);
            o[pos++] = (T)(e >> 16);
            if (br.cnt < kLitRoot || pos > lim) break;
            e = lt[br.buf & ((1u << kLitRoot) - 1)];
        }
        if (kind_of(e) == K_LIT) continue;
        br.refill();
        if (kind_of(e) == K_SUB) {
            br.drop(kLitRoot);
            e = lt[(e >> 16) + br.bits((e >> 4) & 15)];
            if (kind_of(e) == K_LIT) {
                br.drop(e & 15);
                o[pos++] = (T)(e >> 16);
                continue;
            }
        }
        br.drop(e & 15);
        uint32_t k = kind_of(e);
        if (k != K_LEN) { rc = k == K_EOB ? R_EOB : R_DATA; break; }
        uint32_t ex = (e >> 4) & 15;
        uint32_t len = (e >> 16) + br.bits(ex);
        br.drop(ex);
        uint32_t d = dt[br.buf & ((1u << kDistRoot) - 1)];
        if (kind_of(d) == K_SUB) {
            br.drop(kDistRoot);
            d = dt[(d >> 16) + br.bits((d >> 4) & 15)];
        }
        if (kind_of(d) != K_LIT) { rc = R_DATA; break; }
        br.drop(d & 15);
        uint32_t ex2 = (d >> 4) & 15;
        uint32_t dist = (d >> 16) + br.bits(ex2);
        br.drop(ex2);
        int64_t src = pos - (int64_t)dist;
        if (src < floor) { rc = R_DATA; break; }
        T* dp = o + pos;
        const T* sp = o + src;
        if (dist >= 8 / sizeof(T)) {
            T* end = dp + len;
            do {
                memcpy(dp, sp, 8);
                dp += 8 / sizeof(T);
                sp += 8 / sizeof(T);
            } while (dp < end);
        } else if (dist == 1) {
            std::fill(dp, dp + len, sp[0]);
        } else {
            for (uint32_t i = 0; i < len; i++) dp[i] = sp[i];
        }
        if (W && src < min_ref) min_ref = src;
        pos += len;
    }
    brr = br;
    s.pos = pos;
    s.min_ref = min_ref;
    return rc;
}

// --- chunks --------------------------------------------------------------
enum { S_BLOCK = 0, S_STORED = 1, S_HEADER = 2, S_NONE = 3 };
struct Start {
    int64_t bit = 0;   // S_BLOCK: the block header's bit; S_STORED: 8 x
    int kind = S_NONE; // the LEN field's byte (a non-final stored block);
};                     // S_HEADER: 8 x a member header's first byte

struct MemberEnd {
    int64_t out;        // chunk position where the member's bytes end
    uint32_t crc, isize;
};

enum { STOP_REACHED = 1, STOP_PASSED = 2, STOP_END = 3 };

struct Chunk {
    Start start, target, end;
    bool spec = false;    // window unknown: starts in 16-bit symbols
    bool direct = false;  // writes into the result (window known)
    int64_t floor0 = 0;   // direct: the member's start (chunk position)
    int64_t limit = 0;    // spec: most output before giving up (0: none)
    int64_t expect = 1 << 16;  // output expected (a first buffer's size)
    WideBuf w;
    ByteBuf nb;
    int64_t min_ref = 0;
    std::vector<MemberEnd> ends;
    int status = 0, stop = 0;
    Chunk() = default;
    Chunk(const Chunk&) = delete;
    Chunk& operator=(const Chunk&) = delete;
    ~Chunk() { release(); }
    int64_t len() const { return w.len + nb.len; }
    void release() { w.release(); nb.release(); }
    void reset() {        // for another start, keeping the buffers
        w.len = 0;
        nb.len = nb.pre = 0;
        ends.clear();
        min_ref = 0;
        status = stop = 0;
    }
};

// Parse a member header at byte b; the deflate stream's first byte, or
// -1.  *bsize: BGZF's BSIZE when the header carries it, else -1.
static int64_t parse_header(const uint8_t* in, int64_t n, int64_t b,
                            int64_t* bsize) {
    if (bsize) *bsize = -1;
    if (b + 10 > n || in[b] != 0x1f || in[b + 1] != 0x8b || in[b + 2] != 8)
        return -1;
    int flg = in[b + 3];
    int64_t p = b + 10;
    if (flg & 4) {
        if (p + 2 > n) return -1;
        int64_t xlen = in[p] | (in[p + 1] << 8);
        p += 2;
        if (p + xlen > n) return -1;
        for (int64_t q = p; bsize && q + 4 <= p + xlen;) {
            int64_t slen = in[q + 2] | (in[q + 3] << 8);
            if (in[q] == 'B' && in[q + 1] == 'C' && slen == 2
                && q + 6 <= p + xlen) {
                *bsize = in[q + 4] | (in[q + 5] << 8);
                break;
            }
            q += 4 + slen;
        }
        p += xlen;
    }
    for (int f = 8; f <= 16; f <<= 1) {
        if (!(flg & f)) continue;
        const void* z = p < n ? memchr(in + p, 0, (size_t)(n - p)) : nullptr;
        if (!z) return -1;
        p = (const uint8_t*)z - in + 1;
    }
    if (flg & 2) {
        if (p + 2 > n) return -1;
        p += 2;
    }
    return p;
}

static inline uint32_t le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
           | ((uint32_t)p[3] << 24);
}

// Decode a chunk from c.start until it reaches (or passes) c.target at a
// block boundary, the input ends after a member, or an error.
static void run_chunk(const uint8_t* in, int64_t n, Chunk& c) {
    Bits br;
    br.in = in;
    br.n = n;
    uint32_t lit[kLitCap], dist[kDistCap];
    const FixedTables& F = fixed_tables();
    bool wide = c.spec;
    Out<uint16_t> ws{};
    Out<uint8_t> ns{};
    int64_t member_at = c.spec ? INT64_MIN : c.floor0;  // chunk position
    if (wide) {
        if (!c.w.reserve(c.expect, true)) { c.status = E_NOMEM; return; }
    } else {
        if (!c.nb.reserve(c.expect, !c.direct)) {
            c.status = E_NOMEM;
            return;
        }
    }
    auto total = [&]() { return c.w.len + c.nb.len; };
    // leave 16-bit symbols: the window is the last kWin symbols, or
    // nothing when a member starts here
    auto go_narrow = [&](bool member_start) -> bool {
        int64_t keep = member_start ? 0 : kWin;
        c.nb.pre = keep;
        if (!c.nb.reserve(1 << 16)) return false;
        const uint16_t* src = c.w.out() + c.w.len - keep;
        for (int64_t i = 0; i < keep; i++) c.nb.base[i] = (uint8_t)src[i];
        wide = false;
        return true;
    };
    int st = c.start.kind;
    int64_t hb = c.start.bit >> 3;
    bool final_blk = false;
    if (st != S_HEADER) br.seek(c.start.bit);
    int type = -1;
    for (;;) {
        if (st == S_HEADER) {
            int64_t p = parse_header(in, n, hb, nullptr);
            if (p < 0) { c.status = E_HEADER; return; }
            member_at = total();
            if (wide && !go_narrow(true)) { c.status = E_NOMEM; return; }
            br.seek(p * 8);
            st = S_BLOCK;
        }
        if (st == S_BLOCK) {
            int64_t b = br.bitpos();
            if (c.target.kind == S_BLOCK) {
                if (b == c.target.bit) {
                    c.stop = STOP_REACHED;
                    c.end = c.target;
                    return;
                }
                if (b > c.target.bit) {
                    c.stop = STOP_PASSED;
                    c.end.bit = b;
                    c.end.kind = S_BLOCK;
                    return;
                }
            } else if (c.target.kind == S_STORED) {
                int64_t q8 = c.target.bit;
                if (b > q8 - 3) {
                    c.stop = STOP_PASSED;
                    c.end.bit = b;
                    c.end.kind = S_BLOCK;
                    return;
                }
                if (b >= q8 - 10) {
                    br.refill();
                    if (br.bits(3) == 0 && ((b + 3 + 7) >> 3) << 3 == q8) {
                        c.stop = STOP_REACHED;
                        c.end = c.target;
                        return;
                    }
                }
            }
            br.refill();
            if (br.over > 8) { c.status = E_TRUNC; return; }
            final_blk = br.bits(1);
            type = (int)(br.bits(3) >> 1);
            br.drop(3);
            if (type == 3) { c.status = E_DATA; return; }
            if (type == 0) {
                br.drop(br.cnt & 7);
                st = S_STORED;
            } else {
                if (type == 2) {
                    int r = read_dynamic(br, lit, dist);
                    if (r) { c.status = r == R_TRUNC ? E_TRUNC : E_DATA; return; }
                }
                const uint32_t* lt = type == 1 ? F.lit : lit;
                const uint32_t* dt = type == 1 ? F.dist : dist;
                for (;;) {
                    int r;
                    if (wide) {
                        ws.o = c.w.out();
                        ws.pos = c.w.len;
                        ws.cap = c.w.cap - 8;
                        ws.floor = member_at == INT64_MIN ? -kWin : member_at;
                        ws.min_ref = c.min_ref;
                        r = huff<uint16_t>(br, lt, dt, ws);
                        c.w.len = ws.pos;
                        c.min_ref = ws.min_ref;
                    } else {
                        ns.o = c.nb.out();
                        ns.pos = c.nb.len;
                        ns.cap = c.nb.cap - c.nb.pre - 8;
                        int64_t f = member_at == INT64_MIN
                                        ? -c.nb.pre : member_at - c.w.len;
                        ns.floor = std::max(f, -c.nb.pre);
                        ns.min_ref = 0;
                        r = huff<uint8_t>(br, lt, dt, ns);
                        c.nb.len = ns.pos;
                    }
                    if (r == R_EOB) break;
                    if (r == R_SPACE) {
                        int64_t t = total();
                        if (c.limit && t > c.limit) { c.status = R_CAP; return; }
                        bool ok = wide ? c.w.reserve(c.w.len + (c.w.len >> 1) + 65536)
                                       : c.nb.reserve(c.nb.len + (c.nb.len >> 1) + 65536);
                        if (!ok) { c.status = E_NOMEM; return; }
                        continue;
                    }
                    c.status = r == R_TRUNC ? E_TRUNC : E_DATA;
                    return;
                }
                if (wide && marker_free(c.w) && !go_narrow(false)) {
                    c.status = E_NOMEM;
                    return;
                }
                st = final_blk ? -1 : S_BLOCK;
            }
        }
        if (st == S_STORED) {
            int64_t bp = br.bitpos() >> 3;  // byte aligned here
            if (bp + 4 > n) { c.status = E_TRUNC; return; }
            uint32_t len = in[bp] | (in[bp + 1] << 8);
            uint32_t nlen = in[bp + 2] | (in[bp + 3] << 8);
            if (len != (~nlen & 0xFFFF)) { c.status = E_DATA; return; }
            if (bp + 4 + len > n) { c.status = E_TRUNC; return; }
            const uint8_t* src = in + bp + 4;
            if (wide) {
                if (!c.w.reserve(c.w.len + len)) { c.status = E_NOMEM; return; }
                uint16_t* o = c.w.out() + c.w.len;
                for (uint32_t i = 0; i < len; i++) o[i] = src[i];
                c.w.len += len;
                if (marker_free(c.w) && !go_narrow(false)) {
                    c.status = E_NOMEM;
                    return;
                }
            } else {
                if (!c.nb.reserve(c.nb.len + len)) { c.status = E_NOMEM; return; }
                memcpy(c.nb.out() + c.nb.len, src, len);
                c.nb.len += len;
            }
            if (c.limit && total() > c.limit) { c.status = R_CAP; return; }
            br.seek((bp + 4 + len) * 8);
            st = final_blk ? -1 : S_BLOCK;
        }
        if (st == -1) {  // the member's trailer, zero padding, what follows
            int64_t bp = (br.bitpos() + 7) >> 3;
            if (bp + 8 > n) { c.status = E_TRUNC; return; }
            c.ends.push_back({total(), le32(in + bp), le32(in + bp + 4)});
            int64_t p = bp + 8;
            while (p < n && in[p] == 0) p++;
            if (p == n) {
                c.stop = STOP_END;
                c.end.bit = 8 * n;
                c.end.kind = S_NONE;
                return;
            }
            hb = p;
            st = S_HEADER;
        }
    }
}

// --- the block finder ----------------------------------------------------
static inline uint64_t bits_at(const uint8_t* in, int64_t n, int64_t bit) {
    int64_t b = bit >> 3;
    uint64_t w = 0;
    if (b + 8 <= n) memcpy(&w, in + b, 8);
    else
        for (int64_t i = 0; b + i < n && i < 8; i++)
            w |= (uint64_t)in[b + i] << (8 * i);
    return w >> (bit & 7);  // at least 57 bits valid
}

// Does a dynamic block header at bit p build codes zlib accepts?  The
// code lengths are summed as they are read (in units of 2^-15), so most
// false starts stop at their first oversubscribed length.  A lone
// length-1 literal/length code, which zlib accepts, is not guessed.
static bool dynamic_at(const uint8_t* in, int64_t n, int64_t p) {
    uint64_t w = bits_at(in, n, p);
    if (((w >> 1) & 3) != 2) return false;
    int hlit = (int)((w >> 3) & 31) + 257, hdist = (int)((w >> 8) & 31) + 1;
    if (hlit > 286 || hdist > 30) return false;
    int hclen = (int)((w >> 13) & 15) + 4;
    uint64_t w2 = bits_at(in, n, p + 17);
    uint8_t cl[19] = {0};
    int kraft = 0;
    for (int i = 0; i < hclen; i++) {
        int l = (int)((w2 >> (3 * i)) & 7);
        cl[kClOrder[i]] = (uint8_t)l;
        if (l) kraft += 128 >> l;
    }
    if (kraft != 128) return false;
    uint32_t clt[1 << kClRoot];
    if (build_table(cl, 19, T_CL, kClRoot, clt, 1 << kClRoot)) return false;
    Bits br;
    br.in = in;
    br.n = n;
    br.seek(p + 17 + 3 * hclen);
    int total = hlit + hdist, i = 0, prev = -1;
    int32_t sum[2] = {0, 0};
    bool eob = false;
    while (i < total) {
        br.refill();
        if (br.over > 8) return false;
        uint32_t e = clt[br.bits(kClRoot)];
        br.drop(e & 15);
        int sym = (int)(e >> 16), rep = 1, v = sym;
        if (sym == 16) {
            if (prev < 0) return false;
            v = prev;
            rep = 3 + (int)br.bits(2);
            br.drop(2);
        } else if (sym == 17) {
            v = 0;
            rep = 3 + (int)br.bits(3);
            br.drop(3);
        } else if (sym == 18) {
            v = 0;
            rep = 11 + (int)br.bits(7);
            br.drop(7);
        }
        if (i + rep > total) return false;
        for (; rep; rep--, i++) {
            int part = i >= hlit;
            if (v) sum[part] += 32768 >> v;
            if (i == 256) eob = v != 0;
        }
        if (sum[0] > 32768 || sum[1] > 32768) return false;
        prev = v;
    }
    return eob && sum[0] == 32768
           && (sum[1] == 32768 || sum[1] == 16384 || sum[1] == 0);
}

// Is there a non-final stored block whose LEN is at byte q?  LEN ==
// ~NLEN passes at random about once in 2^16 bytes, so the block must
// also fit the input and be followed by a header that checks: a
// dynamic one that builds its codes, or another stored block (a fixed
// block after it is a start the finder does not guess).
static bool stored_at(const uint8_t* in, int64_t n, int64_t q) {
    if (q + 4 > n || (in[q - 1] & 0xE0) != 0) return false;
    int64_t len = in[q] | (in[q + 1] << 8);
    if (len != (~(in[q + 2] | (in[q + 3] << 8)) & 0xFFFF)) return false;
    int64_t next = q + 4 + len;
    if (next >= n) return false;
    int type = (int)((in[next] >> 1) & 3);
    if (type == 2) return dynamic_at(in, n, next * 8);
    if (type == 0) {
        int64_t r = next + 1;
        return r + 4 <= n && (in[r] | (in[r + 1] << 8))
                                 == (~(in[r + 2] | (in[r + 3] << 8)) & 0xFFFF);
    }
    return false;
}

// The first block start at or after byte lo and before byte hi.
static bool find_start(const uint8_t* in, int64_t n, int64_t lo, int64_t hi,
                       Start* s) {
    for (int64_t p = lo * 8; p < hi * 8 && (p >> 3) < n; p++) {
        if ((p & 7) == 5) {  // a stored block's LEN at byte q = (p+3)/8
            int64_t q = (p + 3) >> 3;
            if (stored_at(in, n, q)) {
                s->bit = q * 8;
                s->kind = S_STORED;
                return true;
            }
        }
        if ((bits_at(in, n, p) & 6) == 4 && dynamic_at(in, n, p)) {
            s->bit = p;
            s->kind = S_BLOCK;
            return true;
        }
    }
    return false;
}

// --- the whole input -----------------------------------------------------
struct Result {
    ByteBuf out;          // the result (mapped); in discard mode only the
    int64_t base_abs = 0; // window: out.out()[0] is byte base_abs
    bool discard = false;
    int64_t total() const { return base_abs + out.len; }
    uint8_t* at(int64_t abs) { return out.out() + (abs - base_abs); }
    bool room(int64_t abs_end) { return out.reserve(abs_end - base_abs); }
    void compact() {  // discard mode: keep the last kWin bytes
        if (!discard || out.len <= kWin) return;
        int64_t drop = out.len - kWin;
        memmove(out.out(), out.out() + drop, (size_t)kWin);
        base_abs += drop;
        out.len = kWin;
    }
};

struct Stats {
    int64_t team = 1, chunks = 0, joined = 0, redone = 0, marker_bytes = 0,
            members = 0, bgzf_members = 0, waves = 0;
};

struct MemberCheck {      // the member being checked, across chunks
    uint32_t crc = 0;
    uint64_t len = 0;
    int64_t start = 0;    // its first byte's position in the output
};

// A run of BGZF members from byte b, inflated a member a thread.
// Returns the byte after the last member taken (b if none).
static int64_t bgzf_run(const uint8_t* in, int64_t n, int64_t b, int team,
                        Result& res, Stats& st) {
    struct M { int64_t at, data, end; uint32_t isize; int64_t off; };
    std::vector<M> ms;
    int64_t out = res.total();
    for (int64_t p = b; p < n;) {
        int64_t bsize;
        int64_t d = parse_header(in, n, p, &bsize);
        if (d < 0 || bsize < 0) break;
        int64_t e = p + bsize + 1;
        if (e > n || e - 8 < d) break;
        uint32_t isize = le32(in + e - 4);
        if ((int64_t)isize > 1040 * (e - d) + 1024) break;  // not plausible
        ms.push_back({p, d, e, isize, out});
        out += isize;
        p = e;
    }
    if (ms.size() < 2) return b;
    if (!res.discard && !res.room(out)) return b;
    int64_t nm = (int64_t)ms.size();
    std::vector<int> ok(nm, 0);
#pragma omp parallel num_threads(team) if (team > 1)
    {
        Chunk c;
#pragma omp for schedule(dynamic, 4)
        for (int64_t i = 0; i < nm; i++) {
            const M& m = ms[i];
            c.start.bit = m.data * 8;
            c.start.kind = S_BLOCK;
            c.target.kind = S_NONE;
            c.floor0 = 0;
            c.w.len = 0;
            c.nb.len = 0;
            c.nb.pre = 0;
            c.ends.clear();
            c.status = c.stop = 0;
            c.limit = m.isize + 65536;
            // decode this member alone: the input cut at its end
            run_chunk(in, m.end, c);
            if (c.status || c.stop != STOP_END || c.ends.size() != 1
                || c.nb.len != (int64_t)m.isize || c.ends[0].out != c.nb.len)
                continue;
            // the trailer must sit at the end BSIZE states
            const uint8_t* o = c.nb.out();
            uint32_t crc = crc32_update(0, o, c.nb.len);
            if (crc != c.ends[0].crc || m.isize != c.ends[0].isize) continue;
            if (!res.discard) memcpy(res.at(m.off), o, (size_t)c.nb.len);
            ok[i] = 1;
        }
        c.release();
    }
    // a member is taken when its deflate stream, its trailer and any
    // zero bytes after it end where BSIZE says (STOP_END in the cut
    // input, one trailer) with the size and CRC32 its trailer states;
    // the run stops before the first member that is not
    int64_t taken = 0;
    while (taken < nm && ok[taken]) taken++;
    if (taken == 0) return b;
    st.bgzf_members += taken;
    st.members += taken;
    int64_t end_abs = taken < nm ? ms[taken].off : out;
    if (res.discard) {
        // the window is all discard mode keeps: the last member's bytes
        // are not held, so a following chunk takes its window afresh
        res.base_abs = end_abs;
        res.out.len = 0;
    } else {
        res.out.len = end_abs - res.base_abs;
    }
    return ms[taken - 1].end;
}

static int64_t default_chunk(int64_t bytes, int team) {
    if (team <= 1) return bytes > 0 ? bytes : 1;
    const int64_t cap = 2 << 20, lo = 64 << 10;
    int64_t waves = (bytes + (int64_t)team * cap - 1) / ((int64_t)team * cap);
    int64_t nch = std::max<int64_t>(1, waves * team);
    return std::max(lo, (bytes + nch - 1) / nch);
}

// The chunked decode from a confirmed start to the end of the input.
static int chunked(const uint8_t* in, int64_t n, Start cur, int team,
                   int64_t chunk_bytes, Result& res, MemberCheck& mc,
                   Stats& st) {
    int64_t lo = cur.bit >> 3;
    int64_t C = chunk_bytes > 0 ? chunk_bytes : default_chunk(n - lo, team);
    int64_t nominal = std::max<int64_t>(1, (n - lo + C - 1) / C);
    // guesses: chunk 0 is cur; a chunk with no start found joins the
    // one before it
    std::vector<Start> g(nominal);
    std::vector<char> found(nominal, 0);
    found[0] = 1;
    g[0] = cur;
#pragma omp parallel for schedule(dynamic, 1) num_threads(team) if (team > 1)
    for (int64_t k = 1; k < nominal; k++)
        found[k] = find_start(in, n, lo + k * C, std::min(n, lo + (k + 1) * C),
                              &g[k]);
    std::vector<Start> guess;
    for (int64_t k = 0; k < nominal; k++) {
        if (found[k]) guess.push_back(g[k]);
        else st.joined++;
    }
    int64_t nch = (int64_t)guess.size();
    st.chunks += nch;
    // a wave's chunks: slot j - i holds chunk j, its buffers kept for
    // the next wave's
    std::vector<Chunk> slots(std::min<int64_t>(team, nch));
    for (int64_t i = 0; i < nch;) {
        int64_t w1 = std::min(nch, i + team);
        st.waves++;
        int64_t A0 = res.total();
        auto chunk_at = [&](int64_t j) -> Chunk& { return slots[j - i]; };
        // the wave's first chunk writes into the result with the window
        // behind it; the rest guess
        for (int64_t j = i; j < w1; j++) {
            Chunk& c = chunk_at(j);
            c.reset();
            c.expect = 4 * C;
            c.start = j == i ? cur : guess[j];
            c.target = j + 1 < nch ? guess[j + 1] : Start{};
            c.spec = j != i;
            c.direct = j == i;
            c.limit = c.spec ? 1040 * std::max<int64_t>(C, 1) + (1 << 20) : 0;
            if (c.direct) {
                c.nb = res.out;
                c.nb.pre = res.out.pre + res.out.len;
                c.nb.len = 0;
                c.floor0 = mc.start - A0;
                if (cur.kind == S_HEADER) c.floor0 = 0;
            }
        }
#pragma omp parallel for schedule(static, 1) num_threads(team) if (team > 1)
        for (int64_t j = i; j < w1; j++) run_chunk(in, n, chunk_at(j));
        {   // the result's mapping may have moved or grown
            Chunk& c = chunk_at(i);
            int64_t l = c.nb.len;
            res.out.base = c.nb.base;
            res.out.cap = c.nb.cap;
            res.out.len += l;
            c.nb = ByteBuf();
            c.nb.len = l;   // its length, for the positions below
        }
        // confirm the chain; decode again what was guessed wrong
        int64_t last = w1 - 1;
        bool end = false;
        for (int64_t j = i; j < w1; j++) {
            Chunk& c = chunk_at(j);
            bool confirmed = j == i || chunk_at(j - 1).stop == STOP_REACHED;
            if (!confirmed || c.status == R_CAP) {
                c.reset();
                c.start = confirmed ? c.start : chunk_at(j - 1).end;
                c.limit = 0;
                st.redone++;
                run_chunk(in, n, c);
            }
            if (c.status) return c.status;
            if (c.stop == STOP_END) { last = j; end = true; break; }
        }
        // positions, the member floor of markers, the windows in order
        std::vector<int64_t> A(last + 2);
        A[i] = A0;
        for (int64_t j = i; j <= last; j++)
            A[j + 1] = A[j] + chunk_at(j).len();
        if (!res.room(A[last + 1])) return E_NOMEM;
        {
            int64_t ms = mc.start;
            for (int64_t j = i; j <= last; j++) {
                Chunk& c = chunk_at(j);
                if (c.spec && A[j] + c.min_ref < ms) return E_DATA;
                for (auto& e : c.ends) ms = A[j] + e.out;
            }
        }
        // a chunk's symbols into place: a byte, or its window's byte
        // (256 + i: the window's byte i) looked up in a 33 KiB table
        auto put = [&](Chunk& c, int64_t Aj, int64_t a, int64_t b) {
            uint8_t* F = res.at(Aj);
            int64_t wl = c.w.len, e = std::min(b, wl);
            if (a < e) {
                // the window's bytes that exist (markers before the
                // output's first byte were refused above)
                std::vector<uint8_t> lut(256 + kWin, 0);
                for (int v = 0; v < 256; v++) lut[v] = (uint8_t)v;
                int64_t have = std::min(kWin, Aj - res.base_abs);
                memcpy(lut.data() + 256 + kWin - have, F - have, (size_t)have);
                const uint16_t* w = c.w.out();
                const uint8_t* L = lut.data();
                for (int64_t p = a; p < e; p++) F[p] = L[w[p]];
            }
            int64_t s = std::max(a, wl);
            if (b > s) memcpy(F + s, c.nb.out() + (s - wl), (size_t)(b - s));
        };
        for (int64_t j = i + 1; j <= last; j++) {
            Chunk& c = chunk_at(j);
            put(c, A[j], std::max<int64_t>(0, c.len() - kWin), c.len());
        }
        // every thread: its chunk's head, then the CRC32 of each member's
        // part of it
        std::vector<std::vector<uint32_t>> crcs(last + 1);
#pragma omp parallel for schedule(static, 1) num_threads(team) if (team > 1)
        for (int64_t j = i; j <= last; j++) {
            Chunk& c = chunk_at(j);
            int64_t L = c.len();
            if (j > i) put(c, A[j], 0, std::max<int64_t>(0, L - kWin));
            const uint8_t* F = res.at(A[j]);
            int64_t a = 0;
            for (auto& e : c.ends) {
                crcs[j].push_back(crc32_update(0, F + a, e.out - a));
                a = e.out;
            }
            crcs[j].push_back(crc32_update(0, F + a, L - a));
        }
        for (int64_t j = i; j <= last; j++) {
            Chunk& c = chunk_at(j);
            st.marker_bytes += c.w.len;
            int64_t a = 0;
            for (size_t k = 0; k <= c.ends.size(); k++) {
                int64_t b = k < c.ends.size() ? c.ends[k].out : c.len();
                mc.crc = crc32_combine(mc.crc, crcs[j][k], (uint64_t)(b - a));
                mc.len += (uint64_t)(b - a);
                if (k < c.ends.size()) {
                    if (mc.crc != c.ends[k].crc) return E_CRC;
                    if ((uint32_t)mc.len != c.ends[k].isize) return E_SIZE;
                    st.members++;
                    mc.crc = 0;
                    mc.len = 0;
                    mc.start = A[j] + b;
                }
                a = b;
            }
        }
        res.out.len = A[last + 1] - res.base_abs;
        res.compact();
        if (end) return 0;
        cur = chunk_at(last).end;
        i = last + 1;
    }
    return E_TRUNC;  // the input ended inside a member
}

static int inflate_all(const uint8_t* in, int64_t n, int team,
                       int64_t chunk_bytes, Result& res, Stats& st) {
    if (n < 2 || in[0] != 0x1f || in[1] != 0x8b) return E_HEADER;
    int64_t b = 0;
    MemberCheck mc;
    for (;;) {
        int64_t e = bgzf_run(in, n, b, team, res, st);
        if (e == b) break;
        while (e < n && in[e] == 0) e++;
        if (e == n) return 0;
        b = e;
        mc.start = res.total();
    }
    mc.start = res.total();
    Start cur;
    cur.bit = b * 8;
    cur.kind = S_HEADER;
    return chunked(in, n, cur, team, chunk_bytes, res, mc, st);
}

}  // namespace gzi

extern "C" {

static const int64_t kInflateParMinBytes = 1 << 20;  // below: one thread

// Threads gz_inflate runs an n-byte input on: nthreads when > 0, else
// one below kInflateParMinBytes and the OpenMP team from there up.
int64_t inflate_team(int64_t n, int64_t nthreads) {
    int64_t t = nthreads;
    if (t <= 0) {
        t = 1;
#ifdef _OPENMP
        if (n >= kInflateParMinBytes) t = omp_get_max_threads();
#endif
    }
    return t < 1 ? 1 : t;
}

// Inflate a gzip file's bytes.  Returns 0 and the output (an anonymous
// mapping *out of *out_cap bytes holding *out_len; gz_free it), or a
// negative code when the input is refused (nothing to free).
// chunk_bytes: compressed bytes a chunk (0: from the input and the
// team).  flags & 1: keep only the last 32 KiB of output (sizes and
// checks only; *out_len is the whole length).  stats (8): team, chunks,
// chunks joined, chunks decoded again, bytes decoded with markers,
// members, BGZF members inflated a member a thread, waves.
int64_t gz_inflate(const uint8_t* in, int64_t n, int64_t nthreads,
                   int64_t chunk_bytes, int64_t flags, uint8_t** out,
                   int64_t* out_len, int64_t* out_cap, int64_t* stats) {
    gzi::Result res;
    res.discard = flags & 1;
    gzi::Stats st;
    st.team = inflate_team(n, nthreads);
    // one member's ISIZE ends the input: when it is plausible (1 to 16
    // times the input, a sequence file's ratio), the output's first
    // mapping is that size, populated
    int64_t hint = n >= 4 ? gzi::le32(in + n - 4) : 0;
    bool sized = !res.discard && hint >= n && hint <= 16 * n;
    int64_t first = res.discard ? gzi::kWin : sized ? hint : 4 * n;
    int rc = res.out.reserve(first, sized)
                 ? gzi::inflate_all(in, n, (int)st.team, chunk_bytes, res, st)
                 : gzi::E_NOMEM;
    int64_t s[8] = {st.team, st.chunks, st.joined, st.redone, st.marker_bytes,
                    st.members, st.bgzf_members, st.waves};
    if (stats) memcpy(stats, s, sizeof(s));
    if (rc) {
        res.out.release();
        return rc;
    }
    *out = res.out.base;
    *out_len = res.total();
    *out_cap = res.out.cap;
    return 0;
}

void gz_free(uint8_t* p, int64_t cap) {
    if (p) munmap(p, (size_t)cap);
}

uint32_t gz_crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2) {
    return gzi::crc32_combine(crc1, crc2, len2);
}

}  // extern "C"
