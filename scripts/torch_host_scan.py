#!/usr/bin/env python3
"""The host feed and drain of classify timed on the machine it runs on:
the record scan (`cuclark_tpu_torch.native`) by team size, the file
read with the scan, the 2-bit wire pack against its plain version, the
CSV row writer by team size, the pack and the writer run together at
several splits of the cores, and a table of the host stages against the
host's copy rate.

    python3 scripts/torch_host_scan.py [--reads 500000] [--pairs 12]
        [--copy-mb 512] [--mate-pairs 500000,1048576]
        [--inflate-reads 1048576] [--inflate-rounds 12]
        [--sections scan,read,map,format,pack,teams,mate,writer,inflate,
                    stages]
        [--out FILE]

It writes a FASTQ of bench_torch.py's e2e shape and format (`--reads`
reads of 150 bp, `@r<i>` names, quality all 'I'), reads it once so the
page cache holds it, then:

  - scan: the one-thread `scan_fastq` (`native.scan_records_serial`, the
    plain version) and the parallel scan at teams 1, 2, 4, 8 and the
    default (OMP_NUM_THREADS, else every core), `--reps` timings each in
    turns; min and median ms and reads/s; every team's offsets must
    equal the plain version's;
  - read: `--pairs` pairs of `np.fromfile` and `native.read_file`
    (default team), the order alternating from pair to pair; each
    pair's two times and which was faster (the same 11-of-12 gate;
    the threaded read did not pass it on the H100's host);
  - map: `--pairs` pairs of read + scan, `np.fromfile` then the scan
    against a read-only `np.memmap` then the scan (the map moves the
    page faults into the scan's threads, so the two are timed
    together), in turns; `pipeline._read_file_bytes` maps a plain file
    only if the map wins at least 11 of 12 pairs;
  - format: the CSV rows of every read (bench_torch.py's synthetic
    results, chunks of `--chunk` rows) through the row writer
    (`native.format_rows`) at teams 1, 2, 4, 8 and the default, and
    through the snprintf plain version (`format_rows_printf`) at its
    own default team and at teams 1 and 8 (omp_set_num_threads); every
    team's bytes must equal the plain version's; the minor page faults
    of one more pass of each;
  - pack: `--pairs` pairs of the eight-bases-a-step pack
    (`native.pack_block2`, every core) against its plain version
    (`pack_block2_plain`, every core: its default) over every read in
    classify's batches of
    `--chunk` at bin 152, in turns, the first of each pair alternating;
    the same for the paired pack (`pack_block2_paired` against
    `pack_block2_paired_plain`, each read cut into mates of 75 + 75 as
    bench_torch.py's light_paired, mate 2 at position 76); the new
    pack's bytes must equal the plain version's; min and median ms;
  - teams: the pack and the row writer of every read run at the same
    time on two threads, as classify's producer and writer threads run
    them, at pack + writer teams of T + T (every core for both),
    T/2 + T/2 (the default split, `native.pack_team` and
    `format_team`), 3T/4 + T/4 and T/4 + 3T/4 (T the host's cores), in
    turns, `--reps` rounds; then T + T again in a process of its own
    with OMP_WAIT_POLICY=passive, and T + T in one with the default
    policy beside it; each configuration's wall time of both and each
    side's own time;
  - mate: the mate-id check of paired classify's head: two mate files
    of the largest `--mate-pairs` pairs of 150 bp mates, in each name
    style (`SRR1234567.<i>/1` and `/2`; Casava 1.8's `<...>:<i>
    1:N:0:ATCACG` and ` 2:...`, which the scan's cut leaves equal), and
    for each size the first n pairs: `--pairs` rounds in turns of the
    plain version (`fast_parse.first_mate_mismatch_plain`, numpy) and
    the native check (`native.first_mate_mismatch`) at teams 1, 4 and
    every core, each team's wins against the plain version of its
    round; then a mismatch planted at record 0, n - 1 and a random
    record, every version required to find it, one time each;
  - writer: the writer's batch over the largest `--mate-pairs` rows
    (mate 1's names, seeded results rows of 150 bp reads) in chunks of
    `--chunk`: the results entry (`native.format_results`, gamma and
    confidence in the writer) against the parent's path
    (`score.gamma_confidence` + `native.format_rows`), both at the
    writer's default team, `--pairs` pairs in turns; equal bytes
    required, single and paired;
  - inflate: a gzip classify input inflated by the plain version
    (`pipeline._inflate_plain`, `gzip.GzipFile(...).read()`, one
    thread) and by the native inflater (`native.inflate`) at teams 1,
    4, 8 and the default, `--inflate-rounds` rounds in turns (the order
    rotating from round to round), each native team's wins against the
    plain version of its round, equal bytes required; the input is
    `--inflate-reads` 150 bp reads with Illumina's binned qualities
    ('#,:F', 'F' most often) and SRR names, at gzip levels 1, 6 and 9,
    each as one member (levels 1 and 6 as `gzip` writes it, zlib on one
    thread; level 9 as pigz writes one member, 128 KiB pieces each
    primed with the 32 KiB before it and sync-flushed, as zlib's level
    9 takes minutes a file on one core), as BGZF members (as bgzip
    writes them) and as concatenated members (a member every 16 MiB of
    the FASTQ); the counters of the default team's call (chunks,
    joined, redone, bytes decoded with markers, members); then the peak
    RSS of a process that inflates the level-6 one-member file, by each
    version (`inflate_rss`: resident pages sampled while it runs);
  - stages: the host's copy rate (a `np.copyto` of `--copy-mb` MB, more
    than the last-level cache, split over T threads; bytes read plus
    bytes written a second) and, for the scan, the pack, the paired
    pack, the rows, the extended rows (64 count columns), the mate
    check (s per 1M pairs: every core against the plain version) and
    the rows from results rows (against gamma_confidence + rows), the
    inflate of the level-6 one-member file (per 1M reads: the default
    team against the plain version; bytes in = the compressed file,
    out = the FASTQ), calls
    and s per 1M reads of the new and the plain version, the bytes each
    reads and writes, the least time those bytes take at the copy rate
    (the bound) and the share of it each version reaches; each stage at
    the team classify runs it on (the scan and the check every core,
    the pack half, the rows the rest; the plain versions every core).
    A section left out of `--sections` gives no row.

Prints the host's cores, the default team, the card's name and power
limit where `nvidia-smi` answers, and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEAMS = (1, 2, 4, 8)


def fastq_bytes(n: int, seed: int, read_len: int = 150,
                qual: bytes = b"I", name: bytes = b"r%d") -> bytes:
    """n random reads in bench_torch.py's record format; quality bytes
    drawn from `qual`; header i is `name % i`."""
    rng = np.random.default_rng(seed)
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n, read_len))]
    quals = np.frombuffer(qual, np.uint8)[
        rng.integers(0, len(qual), (n, read_len))]
    return b"".join(b"@%s\n%s\n+\n%s\n" % (name % i, seqs[i].tobytes(),
                                          quals[i].tobytes())
                    for i in range(n))


def fasta_bytes(n: int, seed: int, read_len: int = 150,
                width: int = 60) -> bytes:
    """n random sequences as a multi-line FASTA (`width` bases a line)."""
    rng = np.random.default_rng(seed)
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n, read_len))]
    out = []
    for i in range(n):
        s = seqs[i].tobytes()
        out.append(b">s%d desc\n" % i + b"".join(
            s[j:j + width] + b"\n" for j in range(0, read_len, width)))
    return b"".join(out)


def times_ms(fns: dict, reps: int) -> dict:
    """Each function `reps` times, in turns, after one warm-up call each:
    name -> list of ms."""
    for fn in fns.values():
        fn()
    out = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def _same(a, b) -> bool:
    return (all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4]))
            and a[4] == b[4])


def scan_serial_vs_parallel(buf: np.ndarray, fasta: bool, reps: int = 3):
    """The plain one-thread entry and the parallel scan (default team)
    on one buffer: raises unless their offsets, count and stop offset
    are equal; returns (records, serial ms, parallel ms, team), min of
    `reps` timings each in turns."""
    from cuclark_tpu_torch import native

    serial = native.scan_records_serial(buf, fasta)
    par = native.scan_records(buf, fasta)
    if not _same(serial, par):
        raise AssertionError(f"parallel scan differs from scan_"
                             f"{'fasta' if fasta else 'fastq'}")
    t = times_ms({"serial": lambda: native.scan_records_serial(buf, fasta),
                  "parallel": lambda: native.scan_records(buf, fasta)},
                 reps)
    return (len(serial[0]), min(t["serial"]), min(t["parallel"]),
            native.scan_team(len(buf)))


def format_inputs(buf: np.ndarray, n_targets: int = 120, seed: int = 7):
    """bench_torch.py host_pipeline's synthetic results for the records
    of `buf` (150 bp reads, gamma and confidence uniform in [0, 1),
    targets `T<i>`): the fields `native.format_rows` takes, whole."""
    from cuclark_tpu_torch import native

    ns, ne, _, _ = native.scan(buf)
    n = len(ns)
    rng = np.random.default_rng(seed)
    tnb, tno = native.pack_target_names(["NA"] + [f"T{i}" for i in
                                                  range(n_targets)])
    return (np.full(n, 150, np.int64), rng.random(n),
            rng.integers(0, n_targets + 1, n).astype(np.int32),
            rng.integers(0, 120, n).astype(np.int32),
            np.zeros(n, np.int32), np.zeros(n, np.int32), rng.random(n),
            buf, ns, ne, tnb, tno)


def format_chunks(fn, fields, chunk: int, **kw) -> list:
    """`fn` (format_rows or format_rows_printf) over the rows in chunks
    of `chunk`, as CsvSink writes batches: each chunk's bytes."""
    n = len(fields[0])
    out = []
    for i in range(0, n, chunk):
        s = slice(i, i + chunk)
        got = fn(*(f[s] for f in fields[:7]), fields[7], fields[8][s],
                 fields[9][s], *fields[10:], **kw)
        out.append(got[0] if isinstance(got, tuple) else got)
    return out


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def map_gate(path: Path, want, pairs: int) -> list:
    """`pairs` pairs of read + scan (default team) of the page-cached
    file at `path`: `np.fromfile` then the scan against a read-only map
    then the scan, the first of each pair alternating; each pair's two
    times.  Both must give `want`'s offsets."""
    from cuclark_tpu_torch import native

    reads = {"fromfile": lambda: np.fromfile(path, np.uint8),
             "map": lambda: np.memmap(path, np.uint8, mode="r")}
    out = []
    for i in range(pairs):
        order = ("fromfile", "map")[::1 if i % 2 == 0 else -1]
        t = {}
        for name in order:
            t0 = time.perf_counter()
            b = reads[name]()
            got = native.scan_records(b, False)
            t[name] = (time.perf_counter() - t0) * 1e3
            if not _same(got, want):
                raise AssertionError(f"{name} + scan: offsets differ")
            del b, got
        out.append({"first": order[0], **{f"{k}_ms": v
                                           for k, v in t.items()}})
        print(f"map pair {i + 1}: {order[0]} first, np.fromfile + scan "
              f"{t['fromfile']:.3f} ms, map + scan {t['map']:.3f} ms",
              flush=True)
    return out


def _printf_on(team: int, fn):
    """`fn` with the OpenMP team of this thread's parallel regions set to
    `team` (the printf version takes no team of its own: it runs
    omp_get_max_threads() threads), restored after."""
    import ctypes

    gomp = ctypes.CDLL("libgomp.so.1")
    before = gomp.omp_get_max_threads()

    def run():
        gomp.omp_set_num_threads(team)
        try:
            return fn()
        finally:
            gomp.omp_set_num_threads(before)
    return run


def format_rates(buf: np.ndarray, chunk: int, reps: int) -> dict:
    """Rows a second of the row writer at teams 1, 2, 4, 8 and the
    default, and of the printf plain version at teams 1, 8 and its
    default, over every record of `buf` in chunks of `chunk` (min and
    median of `reps` in turns); raises unless every team's bytes equal
    the plain version's."""
    from cuclark_tpu_torch import native

    fields = format_inputs(buf)
    n = len(fields[0])
    want = b"".join(a.tobytes() for a in format_chunks(
        native.format_rows_printf, fields, chunk))

    def printf():
        return format_chunks(native.format_rows_printf, fields, chunk)

    fns = {"printf": printf, "printf_team_1": _printf_on(1, printf),
           "printf_team_8": _printf_on(8, printf)}
    for t in TEAMS + (0,):
        got = format_chunks(native.format_rows, fields, chunk, threads=t)
        if b"".join(a.tobytes() for a in got) != want:
            raise AssertionError(f"format_rows at team {t} differs from "
                                 f"format_rows_printf")
        fns[f"team_{t or 'default'}"] = (
            lambda t=t: format_chunks(native.format_rows, fields, chunk,
                                      threads=t))
    out = {"default_team": native.format_team(chunk)}
    for name, ts in times_ms(fns, reps).items():
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        fns[name]()
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults
        out[name] = {"min_ms": min(ts), "median_ms": statistics.median(ts),
                     "rows_per_sec": n / min(ts) * 1e3,
                     "minor_faults": faults}
        print(f"format {name}: min {min(ts):.3f} ms, median "
              f"{statistics.median(ts):.3f} ms, "
              f"{out[name]['rows_per_sec']:,.0f} rows/s; {faults} minor "
              f"page faults in one more pass", flush=True)
    return out


PACK_BIN = 152   # classify's bin for 150 bp reads and 75 + 75 pairs


def pack_offsets(buf: np.ndarray):
    """(seq_s, seq_e) of every read of `buf`, and the light_paired cut of
    each into mates of 75 + 75: (s1, e1, s2, e2)."""
    from cuclark_tpu_torch import native

    _, _, ss, se = native.scan(buf)
    mid = ss + (se - ss) // 2
    return (ss, se), (ss, mid, mid, se)


def pack_chunks(fn, buf, offs, chunk: int, **kw) -> list:
    """`fn` (a pack entry) over every read in batches of `chunk` at bin
    PACK_BIN, as classify's producer packs them: each batch's arrays.
    `offs` is (s, e) or, for a paired entry, (s1, e1, s2, e2)."""
    n = len(offs[0])
    out = []
    for i in range(0, n, chunk):
        o = [a[i:i + chunk] for a in offs]
        args = ((buf, *o) if len(o) == 2
                else (buf, o[0], o[1], buf, o[2], o[3]))
        out.append(fn(*args, PACK_BIN, n_rows=len(o[0]), **kw))
    return out


def _same_packs(a: list, b: list) -> bool:
    return all(np.array_equal(x, y) for u, v in zip(a, b)
               for x, y in zip(u, v))


def ab_pairs(fns: dict, pairs: int, label: str) -> list:
    """`pairs` pairs of the two functions of `fns` (name -> function),
    the first of each pair alternating: each pair's two times (ms)."""
    names = list(fns)
    for fn in fns.values():
        fn()
    out = []
    for i in range(pairs):
        order = names[::1 if i % 2 == 0 else -1]
        t = {}
        for name in order:
            t0 = time.perf_counter()
            fns[name]()
            t[name] = (time.perf_counter() - t0) * 1e3
        out.append({"first": order[0], **{f"{k}_ms": v
                                           for k, v in t.items()}})
        print(f"{label} pair {i + 1}: {order[0]} first, "
              + ", ".join(f"{k} {t[k]:.3f} ms" for k in names), flush=True)
    return out


def pack_rates(buf: np.ndarray, chunk: int, pairs: int) -> dict:
    """The pack and the paired pack against their plain versions:
    `pairs` pairs each in turns (`ab_pairs`); raises unless the bytes
    are equal.  Per entry: the pairs, the new pack's wins, min and
    median ms of each."""
    from cuclark_tpu_torch import native

    single, paired = pack_offsets(buf)
    cores = len(os.sched_getaffinity(0))
    out = {"team": cores, "default_team": native.pack_team(chunk)}
    for label, offs, new, plain in (
            ("pack", single, native.pack_block2, native.pack_block2_plain),
            ("pack_paired", paired, native.pack_block2_paired,
             native.pack_block2_paired_plain)):
        if not _same_packs(pack_chunks(new, buf, offs, chunk),
                           pack_chunks(plain, buf, offs, chunk)):
            raise AssertionError(f"{label}: the new pack differs from the "
                                 f"plain version")
        ps = ab_pairs({"plain": lambda: pack_chunks(plain, buf, offs,
                                                     chunk),
                       "new": lambda: pack_chunks(new, buf, offs, chunk,
                                                  threads=cores)},
                      pairs, label)
        wins = sum(p["new_ms"] < p["plain_ms"] for p in ps)
        row = {"pairs": ps, "wins": wins}
        at_default = times_ms({"new_default": lambda: pack_chunks(
            new, buf, offs, chunk)}, pairs)
        for name in ("new", "plain", "new_default"):
            ts = at_default[name] if name in at_default else [
                p[f"{name}_ms"] for p in ps]
            row[name] = {"min_ms": min(ts),
                         "median_ms": statistics.median(ts),
                         "reads_per_sec": len(offs[0]) / min(ts) * 1e3}
        print(f"{label}: new won {wins} of {pairs} pairs; new min "
              f"{row['new']['min_ms']:.3f} ms (median "
              f"{row['new']['median_ms']:.3f}), plain min "
              f"{row['plain']['min_ms']:.3f} ms (median "
              f"{row['plain']['median_ms']:.3f}); "
              f"{row['new']['reads_per_sec']:,.0f} against "
              f"{row['plain']['reads_per_sec']:,.0f} reads/s at team "
              f"{cores}; new at its default team "
              f"{out['default_team']}: min "
              f"{row['new_default']['min_ms']:.3f} ms", flush=True)
        out[label] = row
    return out


def team_splits(cores: int) -> list:
    """(name, pack team, writer team): T + T, T/2 + T/2 (the default
    split), 3T/4 + T/4 and T/4 + 3T/4 for T cores."""
    T = max(cores, 1)
    q = max(T // 4, 1)
    return [(f"{a}+{b}", a, b) for a, b in
            ((T, T), (max(T // 2, 1), max(T // 2, 1)),
             (max(T - q, 1), q), (q, max(T - q, 1)))]


def together(buf, offs, fields, chunk: int, pack_team: int,
             fmt_team: int) -> dict:
    """The pack of every read and the rows of every read at the same
    time on two threads, at the given teams: the wall time of both and
    each side's own time (ms)."""
    import threading

    from cuclark_tpu_torch import native

    start = threading.Barrier(3)
    t = {}

    def side(name, fn):
        start.wait()
        t0 = time.perf_counter()
        fn()
        t[name] = (time.perf_counter() - t0) * 1e3

    th = [threading.Thread(target=side, args=("pack_ms", lambda: pack_chunks(
              native.pack_block2, buf, offs, chunk, threads=pack_team))),
          threading.Thread(target=side, args=("rows_ms", lambda: format_chunks(
              native.format_rows, fields, chunk, threads=fmt_team)))]
    for x in th:
        x.start()
    start.wait()
    t0 = time.perf_counter()
    for x in th:
        x.join()
    t["wall_ms"] = (time.perf_counter() - t0) * 1e3
    return t


def team_rates(buf: np.ndarray, chunk: int, reps: int,
               splits: list) -> dict:
    """`together` at each (name, pack team, writer team) of `splits`,
    `reps` rounds in turns after a warm-up round: per split each round's
    times and the min and median wall."""
    offs, _ = pack_offsets(buf)
    fields = format_inputs(buf)
    out = {name: [] for name, _, _ in splits}
    for r in range(reps + 1):
        for name, a, b in splits:
            got = together(buf, offs, fields, chunk, a, b)
            if r:
                out[name].append(got)
    res = {}
    for name, ts in out.items():
        walls = [t["wall_ms"] for t in ts]
        res[name] = {"rounds": ts, "min_wall_ms": min(walls),
                     "median_wall_ms": statistics.median(walls)}
        print(f"teams {name} (pack + writer): wall min {min(walls):.3f} "
              f"ms, median {statistics.median(walls):.3f}; pack median "
              f"{statistics.median(t['pack_ms'] for t in ts):.3f}, rows "
              f"median {statistics.median(t['rows_ms'] for t in ts):.3f}",
              flush=True)
    return res


def team_rates_in_process(path: Path, chunk: int, reps: int, cores: int,
                          policy: str | None) -> dict:
    """`team_rates` at T + T in a fresh process with OMP_WAIT_POLICY set
    to `policy` (unset for None): its JSON result."""
    env = dict(os.environ)
    env.pop("OMP_WAIT_POLICY", None)
    if policy:
        env["OMP_WAIT_POLICY"] = policy
    code = (f"import json, sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'scripts')!r}]; import numpy as np; "
            f"import torch_host_scan as hs; "
            f"print(json.dumps(hs.team_rates(np.fromfile({str(path)!r}, "
            f"np.uint8), {chunk}, {reps}, [('{cores}+{cores}', {cores}, "
            f"{cores})])))")
    run = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=1200)
    print(run.stdout.strip().splitlines()[0] if run.stdout else "",
          flush=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


# mate 1's and mate 2's header of pair i: an SRA run's `.i/1` and `/2`,
# and Casava 1.8's, which the scan's cut at the space leaves equal
MATE_STYLES = {
    "srr": (b"SRR1234567.%d/1", b"SRR1234567.%d/2"),
    "casava": (b"EAS139:136:FC706VJ:2:2104:15343:%d 1:N:0:ATCACG",
               b"EAS139:136:FC706VJ:2:2104:15343:%d 2:N:0:ATCACG")}
MATE_SIZES = (500_000, 1 << 20)


def mate_buffers(n: int, style: str, seed: int = 31):
    """Two mate files of n pairs of 150 bp mates named in `style`
    (`MATE_STYLES`), scanned: (buf1, ns1, ne1, buf2, ns2, ne2); buf2 a
    writeable copy, for mismatches planted and taken out again."""
    from cuclark_tpu_torch import native

    a, b = MATE_STYLES[style]
    b1 = np.frombuffer(fastq_bytes(n, seed, name=a), np.uint8)
    b2 = np.frombuffer(fastq_bytes(n, seed + 1, name=b), np.uint8).copy()
    ns1, ne1, _, _ = native.scan(b1)
    ns2, ne2, _, _ = native.scan(b2)
    return b1, ns1, ne1, b2, ns2, ne2


def mate_teams(cores: int) -> list:
    """The check's teams timed: 1, 4 and every core."""
    return sorted({1, min(4, cores), cores})


def mate_fns(mates, n: int, teams) -> dict:
    """The plain check and the native one at each team over the first n
    pairs of `mates` (`mate_buffers`): name -> function."""
    from cuclark_tpu_torch import native
    from cuclark_tpu_torch.io import fast_parse

    b1, ns1, ne1, b2, ns2, ne2 = mates
    args = (b1, ns1[:n], ne1[:n], b2, ns2[:n], ne2[:n])
    fns = {"plain": lambda: fast_parse.first_mate_mismatch_plain(*args)}
    for t in teams:
        fns[f"team_{t}"] = (
            lambda t=t: native.first_mate_mismatch(*args, threads=t))
    return fns


def planted_mates(mates, n: int, teams, seed: int = 5) -> dict:
    """Each version of the check (`mate_fns`) on equal ids and with one
    mismatch planted in mate 2's id (its first byte changed, then put
    back) at record 0, n - 1 and a random record: raises unless every
    version gives the planted index (-1 on equal ids).  Per case the
    index and each version's time of one call (ms)."""
    b2, ns2 = mates[3], mates[4]
    at_random = int(np.random.default_rng(seed).integers(n))
    fns = mate_fns(mates, n, teams)
    out = {}
    for case, at in (("equal", -1), ("first", 0), ("last", n - 1),
                     ("random", at_random)):
        pos = int(ns2[at]) if at >= 0 else None
        if pos is not None:
            old = int(b2[pos])
            b2[pos] = ord("X") if old != ord("X") else ord("Y")
        try:
            row = {"at": at}
            for name, fn in fns.items():
                t0 = time.perf_counter()
                got = fn()
                row[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
                if got != at:
                    raise AssertionError(f"mate check {name}, {case}: "
                                         f"{got}, planted {at}")
        finally:
            if pos is not None:
                b2[pos] = old
        out[case] = row
    return out


def mate_rates(sizes, pairs: int, styles=tuple(MATE_STYLES)) -> dict:
    """The native mate-id check at teams 1, 4 and every core against its
    plain version (`first_mate_mismatch_plain`), for each name style and
    each size in `sizes` (the first n pairs of one pair of files):
    `pairs` rounds in turns (`ab_pairs`), each team's wins against the
    plain version of its round, min and median ms; then the planted
    mismatches (`planted_mates`)."""
    from cuclark_tpu_torch import native

    cores = len(os.sched_getaffinity(0))
    teams = mate_teams(cores)
    out = {"teams": teams, "default_team": native.mate_team(max(sizes))}
    for style in styles:
        mates = mate_buffers(max(sizes), style)
        names_b = float((mates[2] - mates[1]).sum()
                        + (mates[5] - mates[4]).sum()) / len(mates[1])
        for n in sizes:
            ps = ab_pairs(mate_fns(mates, n, teams), pairs,
                          f"mate {style} {n}")
            row = {"pairs": ps, "name_bytes_per_pair": names_b,
                   "planted": planted_mates(mates, n, teams)}
            for name in ["plain"] + [f"team_{t}" for t in teams]:
                ts = [p[f"{name}_ms"] for p in ps]
                row[name] = {"min_ms": min(ts),
                             "median_ms": statistics.median(ts)}
                if name != "plain":
                    row[name]["wins"] = sum(p[f"{name}_ms"] < p["plain_ms"]
                                            for p in ps)
            print(f"mate {style} {n} pairs: plain min "
                  f"{row['plain']['min_ms']:.3f} ms (median "
                  f"{row['plain']['median_ms']:.3f}); "
                  + "; ".join(f"team {t} min {row[f'team_{t}']['min_ms']:.3f}"
                              f" (median {row[f'team_{t}']['median_ms']:.3f}"
                              f"), won {row[f'team_{t}']['wins']} of {pairs}"
                              for t in teams)
                  + "; planted " + ", ".join(
                      f"{c} {v['at']}: plain {v['plain_ms']:.3f}, team "
                      f"{cores} {v[f'team_{cores}_ms']:.3f} ms"
                      for c, v in row["planted"].items()), flush=True)
            out[f"{style}_{n}"] = row
        del mates
    return out


def results_inputs(mates, k: int = 31, n_targets: int = 1024,
                   seed: int = 17):
    """Seeded results rows of 150 bp reads (P = 150 - k + 1 windows: total
    <= P, best <= total, second <= total - best) for mate 1's records of
    `mates` (`mate_buffers`), its names, and n_targets targets:
    (results int32 [n, 5], lengths, k, buf, ns, ne, tname bytes,
    offsets)."""
    from cuclark_tpu_torch import native

    buf, ns, ne = mates[:3]
    n = len(ns)
    rng = np.random.default_rng(seed)
    total = rng.integers(0, 150 - k + 2, n)
    best = rng.integers(0, total + 1)
    second = rng.integers(0, total - best + 1)
    results = np.stack([total, rng.integers(0, n_targets + 1, n), best,
                        rng.integers(0, n_targets + 1, n), second],
                       1).astype(np.int32)
    tnb, tno = native.pack_target_names(
        ["NA"] + [f"T{i}" for i in range(1, n_targets + 1)])
    return (results, np.full(n, 150, np.int64), k, buf, ns, ne, tnb, tno)


def parent_rows(results, lengths, k, paired, buf, ns, ne, tnb, tno):
    """A batch's rows as the parent tree's `CsvSink.flush` makes them:
    `score.gamma_confidence` in numpy, then `native.format_rows` on the
    field arrays (the plain version of `native.format_results`)."""
    from cuclark_tpu_torch import native, score

    total, ibest, best, isecond, second = (results[:, i] for i in range(5))
    norm, gamma, conf = score.gamma_confidence(total, best, second, lengths,
                                               k, paired)
    return native.format_rows(norm, gamma, ibest, best, isecond, second,
                              conf, buf, ns, ne, tnb, tno)


def results_chunks(fn, inputs, chunk: int, paired: bool = False) -> list:
    """`fn` (`native.format_results` or `parent_rows`) over the rows in
    chunks of `chunk`, as classify's writer writes batches: each chunk's
    bytes."""
    results, lengths, k, buf, ns, ne, tnb, tno = inputs
    out = []
    for i in range(0, len(results), chunk):
        s = slice(i, i + chunk)
        got = fn(results[s], lengths[s], k, paired, buf, ns[s], ne[s], tnb,
                 tno)
        out.append(got[0])
    return out


def writer_batch(mates, chunk: int, pairs: int) -> dict:
    """The writer's batch: the results entry (`native.format_results`,
    gamma and confidence in the writer) against `gamma_confidence` +
    `format_rows` (`parent_rows`) over mate 1's records in chunks of
    `chunk`, both at the writer's default team; raises unless the bytes
    are equal (single and paired); `pairs` pairs in turns."""
    from cuclark_tpu_torch import native

    inputs = results_inputs(mates)
    for paired in (False, True):
        a = results_chunks(native.format_results, inputs, chunk, paired)
        b = results_chunks(parent_rows, inputs, chunk, paired)
        if b"".join(x.tobytes() for x in a) != b"".join(
                x.tobytes() for x in b):
            raise AssertionError(f"format_results != gamma_confidence + "
                                 f"format_rows (paired {paired})")
    ps = ab_pairs({"parent": lambda: results_chunks(parent_rows, inputs,
                                                    chunk),
                   "new": lambda: results_chunks(native.format_results,
                                                 inputs, chunk)},
                  pairs, "writer batch")
    n = len(inputs[0])
    row = {"rows": n, "chunk": chunk, "team": native.format_team(chunk),
           "pairs": ps, "wins": sum(p["new_ms"] < p["parent_ms"]
                                    for p in ps),
           "row_bytes": sum(len(x) for x in results_chunks(
               native.format_results, inputs, chunk)) / n,
           "name_bytes": float((inputs[5] - inputs[4]).sum()) / n}
    for name in ("parent", "new"):
        ts = [p[f"{name}_ms"] for p in ps]
        row[name] = {"min_ms": min(ts), "median_ms": statistics.median(ts),
                     "batch_ms": min(ts) * chunk / n}
    print(f"writer batch ({n} rows, {chunk} a batch, team {row['team']}): "
          f"new won {row['wins']} of {pairs}; new min "
          f"{row['new']['min_ms']:.3f} ms ({row['new']['batch_ms']:.4f} a "
          f"batch; median {row['new']['median_ms']:.3f}), parent min "
          f"{row['parent']['min_ms']:.3f} ms "
          f"({row['parent']['batch_ms']:.4f} a batch; median "
          f"{row['parent']['median_ms']:.3f})", flush=True)
    return row


INFLATE_READS = 1 << 20
INFLATE_LEVELS = (1, 6, 9)
INFLATE_TEAMS = (1, 4, 8, 0)       # 0: the default team
BINNED_QUALS = (b"#,:F", (0.05, 0.10, 0.15, 0.70))


def binned_fastq(n: int, seed: int = 23) -> bytes:
    """n 150 bp reads named `SRR1234567.<i> length=150`, qualities from
    Illumina's four bins ('#,:F', 'F' most often): the kind of FASTQ a
    sequencer's `.fastq.gz` holds (3.6:1 at gzip level 6)."""
    rng = np.random.default_rng(seed)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, 150))]
    qual, p = BINNED_QUALS
    quals = rng.choice(np.frombuffer(qual, np.uint8), (n, 150), p=p)
    return b"".join(b"@SRR1234567.%d length=150\n%s\n+\n%s\n"
                    % (i, seqs[i].tobytes(), quals[i].tobytes())
                    for i in range(n))


def _raw_deflate(data: bytes, level: int, zdict: bytes = b"",
                 last: bool = True) -> bytes:
    import zlib

    co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
          else zlib.compressobj(level, zlib.DEFLATED, -15))
    return co.compress(data) + co.flush(zlib.Z_FINISH if last
                                        else zlib.Z_SYNC_FLUSH)


def _gz_piece(args) -> bytes:
    """One piece of a gzip file (a pool task; the FASTQ read from
    `path`, bytes [lo, hi)): a BGZF member, a whole member, or a pigz
    piece of one member's deflate stream (primed with the 32 KiB before
    it, sync-flushed unless it is the last)."""
    import struct
    import zlib

    path, lo, hi, level, kind = args
    pre = min(lo, 32768)
    with open(path, "rb") as f:
        f.seek(lo - pre)
        data = f.read(hi - lo + pre)
    zdict, data = data[:pre], data[pre:]
    if kind == "pigz":
        return _raw_deflate(data, level, zdict, last=False)
    d = _raw_deflate(data, level)
    tail = struct.pack("<II", zlib.crc32(data), len(data))
    if kind == "bgzf":
        return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC"
                b"\x02\x00" + struct.pack("<H", 18 + len(d) + 8 - 1) + d
                + tail)
    return b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff" + d + tail


BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")


def gzip_files(fq: Path, levels=INFLATE_LEVELS,
               kinds=("member", "bgzfs", "members")) -> dict:
    """The FASTQ at `fq` gzipped at each level as one member, as BGZF
    members and as concatenated members (see the `inflate` section;
    `kinds` of them), written beside it: name -> path
    (`l<level>_<kind>`).  The pieces compress on every core (a process
    pool: a caller's script must guard its own code under `__main__`);
    a level-1 or 6 one-member file takes one core."""
    import gzip
    import multiprocessing as mp
    import struct
    import zlib

    n = fq.stat().st_size
    out, jobs = {}, []
    for level in levels:
        for kind, step in (("bgzf", 65280), ("member", 16 << 20)):
            if kind + "s" not in kinds:
                continue
            jobs.append((f"l{level}_{kind}s", [
                (str(fq), lo, min(n, lo + step), level, kind)
                for lo in range(0, n, step)]))
    with mp.get_context("spawn").Pool(len(os.sched_getaffinity(0))) as pool:
        singles = {}
        for level in levels if "member" in kinds else ():
            if level == 9:
                step = 128 << 10
                pieces = [(str(fq), lo, min(n, lo + step), level, "pigz")
                          for lo in range(0, n, step)]
                singles[level] = ("pigz", pool.map_async(_gz_piece, pieces,
                                                         chunksize=16))
            else:
                singles[level] = ("gzip", pool.apply_async(
                    gzip.compress, (fq.read_bytes(), level),
                    {"mtime": 0}))
        for name, tasks in jobs:
            parts = pool.map(_gz_piece, tasks, chunksize=16)
            if name.endswith("bgzfs"):
                parts.append(BGZF_EOF)
            out[name] = fq.with_name(f"{fq.name}.{name}.gz")
            out[name].write_bytes(b"".join(parts))
        for level, (kind, res) in singles.items():
            path = fq.with_name(f"{fq.name}.l{level}_member.gz")
            if kind == "gzip":
                path.write_bytes(res.get())
            else:
                body = res.get()
                body[-1] = body[-1] + _raw_deflate(b"", level)  # BFINAL
                data = fq.read_bytes()
                path.write_bytes(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00"
                                 b"\xff" + b"".join(body) + struct.pack(
                                     "<II", zlib.crc32(data), len(data)))
            out[f"l{level}_member"] = path
    return dict(sorted(out.items()))


def inflate_rates(files: dict, want_len: int, rounds: int,
                  teams=INFLATE_TEAMS) -> dict:
    """Each file inflated by the plain version and by the native
    inflater at `teams`, `rounds` rounds in turns (the order rotating):
    min and median ms, each team's wins against the plain version of its
    round, the default team's counters; equal bytes required."""
    from cuclark_tpu_torch import native, pipeline

    out = {}
    for name, path in files.items():
        buf = np.memmap(path, np.uint8, mode="r")
        want = pipeline._inflate_plain(buf)
        if len(want) != want_len:
            raise AssertionError(f"{name}: {len(want)} bytes inflated, "
                                 f"{want_len} expected")
        fns = {"plain": lambda: pipeline._inflate_plain(buf)}
        for t in teams:
            got = native.inflate(buf, threads=t)
            if got.tobytes() != want:
                raise AssertionError(f"{name}: team {t} != the plain bytes")
            del got
            fns[f"team_{t or 'default'}"] = (
                lambda t=t: native.inflate(buf, threads=t))
        native.inflate(buf)
        counters = native.inflate_counters()
        del want
        names = list(fns)
        ts = {k: [] for k in names}
        for r in range(rounds):
            for k in names[r % len(names):] + names[:r % len(names)]:
                t0 = time.perf_counter()
                got = fns[k]()
                ts[k].append((time.perf_counter() - t0) * 1e3)
                del got
        row = {"compressed_bytes": int(len(buf)), "counters": counters}
        for k in names:
            row[k] = {"min_ms": min(ts[k]),
                      "median_ms": statistics.median(ts[k]), "ms": ts[k]}
            if k != "plain":
                row[k]["wins"] = sum(a < b for a, b in zip(ts[k],
                                                           ts["plain"]))
        out[name] = row
        print(f"inflate {name} ({len(buf):,} B, "
              f"{want_len / len(buf):.2f}:1): plain min "
              f"{row['plain']['min_ms']:.1f} ms (median "
              f"{row['plain']['median_ms']:.1f}); "
              + "; ".join(f"{k} {row[k]['min_ms']:.1f} ms (median "
                          f"{row[k]['median_ms']:.1f}, "
                          f"{row['plain']['min_ms'] / row[k]['min_ms']:.2f}x"
                          f", won {row[k]['wins']} of {rounds})"
                          for k in names[1:])
              + f"; counters {counters}", flush=True)
        del buf
    return out


_RSS_MAIN = """
import os, sys, threading
import numpy as np
sys.path.insert(0, sys.argv[1])
from cuclark_tpu_torch import native, pipeline

PAGE = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE // 1024


native.available()
before, peak, done = rss(), [0], threading.Event()


def sample():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        done.wait(0.0005)


t = threading.Thread(target=sample)
t.start()
buf = np.memmap(sys.argv[2], np.uint8, mode="r")
out = (pipeline._inflate_plain(buf) if sys.argv[3] == "plain"
       else native.inflate(buf))
done.set()
t.join()
print(before, max(peak[0], rss()), len(out))
"""


def inflate_rss(path: Path) -> dict:
    """Peak RSS (KiB) of a process that maps `path` and inflates it, by
    each version, beside its RSS before the inflate and the bytes it
    gives.  The peak is the largest of `/proc/self/statm`'s resident
    pages sampled every 0.5 ms while the inflate runs (both versions
    release the interpreter lock while they inflate); `ru_maxrss` and
    VmHWM do not serve here: the first keeps the parent's peak across
    fork and exec, and the card's host has no second."""
    out = {}
    for version in ("plain", "native"):
        got = subprocess.run([sys.executable, "-c", _RSS_MAIN, str(ROOT),
                              str(path), version], capture_output=True,
                             text=True, check=True).stdout.split()
        before, peak, n = map(int, got)
        out[version] = {"peak_kib": peak, "before_kib": before,
                        "out_bytes": n}
        print(f"inflate peak RSS, {version}: {peak:,} KiB ({before:,} before"
              f" the inflate; {n:,} bytes out, {n / 1024:,.0f} KiB)",
              flush=True)
    return out


def copy_rate(mb: int, team: int, reps: int = 5) -> float:
    """Bytes read plus bytes written a second by a `np.copyto` of `mb`
    MB split over `team` threads (numpy copies without the interpreter
    lock), best of `reps`."""
    import threading

    src = np.ones(mb << 20, np.uint8)
    dst = np.zeros_like(src)
    cuts = np.linspace(0, len(src), team + 1).astype(np.int64)
    best = float("inf")
    for _ in range(reps):
        start = threading.Barrier(team + 1)

        def part(lo, hi):
            start.wait()
            np.copyto(dst[lo:hi], src[lo:hi])

        th = [threading.Thread(target=part, args=(cuts[i], cuts[i + 1]))
              for i in range(team)]
        for x in th:
            x.start()
        start.wait()
        t0 = time.perf_counter()
        for x in th:
            x.join()
        best = min(best, time.perf_counter() - t0)
    return 2 * len(src) / best


def ext_inputs(fields, n_targets: int = 64, seed: int = 9):
    """Count columns for `format_rows_ext` (n_targets a row) beside the
    fields of `format_inputs`."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 40, (len(fields[0]), n_targets)).astype(np.uint32)


def stage_table(buf: np.ndarray, chunk: int, reps: int, rate: float,
                scan: dict | None, pack: dict | None, fmt: dict | None,
                mate: dict | None = None,
                writer: dict | None = None,
                inflate: dict | None = None) -> dict:
    """The host stages against the copy rate: per stage the calls and
    the s per 1M reads (pairs) of the new and the plain version, the
    bytes it reads and writes a read, the bound (those bytes at `rate`)
    and the share of it each version reaches; a section not run (None)
    gives no row."""
    from cuclark_tpu_torch import native

    ns, ne, ss, se = native.scan(buf)
    n = len(ss)
    per_m = 1e6 / n
    seq = float((se - ss).sum()) / n
    name_b = float((ne - ns).sum()) / n
    field_b = 8 + 8 + 16 + 8 + 16 + name_b       # format_rows' inputs
    wire = sum(native.wire_shape(PACK_BIN)) + 8  # packed2, vbits, length
    rows = {}  # name -> (calls, in bytes, out bytes, new s, plain s) / 1M
    if scan is not None:
        rows["scan"] = (per_m * 1, len(buf) / n, 32,
                        scan["team_default"]["min_ms"] * 1e-3 * per_m,
                        scan["serial"]["min_ms"] * 1e-3 * per_m)
    if pack is not None:
        for label, extra in (("pack", 16), ("pack_paired", 32)):
            rows[label] = (per_m * n / chunk, seq + extra, wire,
                           pack[label]["new_default"]["min_ms"] * 1e-3 * per_m,
                           pack[label]["plain"]["min_ms"] * 1e-3 * per_m)
    if fmt is not None:
        fields = format_inputs(buf)
        rows_b = sum(len(a) for a in format_chunks(native.format_rows,
                                                   fields, chunk)) / n
        counts = ext_inputs(fields)

        def ext(fn, **kw):
            out = []
            for i in range(0, n, chunk):
                s = slice(i, i + chunk)
                got = fn(counts[s], *(f[s] for f in fields[:7]), fields[7],
                         fields[8][s], fields[9][s], *fields[10:], **kw)
                out.append(got[0] if isinstance(got, tuple) else got)
            return out

        if b"".join(a.tobytes() for a in ext(native.format_rows_ext)) != \
                b"".join(a.tobytes()
                         for a in ext(native.format_rows_ext_printf)):
            raise AssertionError("format_rows_ext differs from its printf "
                                 "version")
        ext_b = sum(len(a) for a in ext(native.format_rows_ext)) / n
        t_ext = times_ms({"new": lambda: ext(native.format_rows_ext),
                          "plain": lambda: ext(
                              native.format_rows_ext_printf)}, reps)
        rows["rows"] = (per_m * n / chunk, field_b, rows_b,
                        fmt["team_default"]["min_ms"] * 1e-3 * per_m,
                        fmt["printf"]["min_ms"] * 1e-3 * per_m)
        rows["rows_extended"] = (per_m * n / chunk,
                                 field_b + 4 * counts.shape[1], ext_b,
                                 min(t_ext["new"]) * 1e-3 * per_m,
                                 min(t_ext["plain"]) * 1e-3 * per_m)
    if mate is not None:
        # the check reads the four offsets and both names of a pair
        cores = len(os.sched_getaffinity(0))
        key = max((k for k in mate if k.startswith("srr_")),
                  key=lambda k: int(k.split("_")[1]))
        m = mate[key]
        pairs_n = int(key.split("_")[1])
        rows["mate_check"] = (
            1e6 / pairs_n, 32 + m["name_bytes_per_pair"], 0,
            m[f"team_{cores}"]["min_ms"] * 1e-3 * 1e6 / pairs_n,
            m["plain"]["min_ms"] * 1e-3 * 1e6 / pairs_n)
    if writer is not None:
        # results row, length, two name offsets and the name in; the row
        # out
        w = writer
        rows["rows_results"] = (
            1e6 / w["chunk"], 20 + 8 + 16 + w["name_bytes"], w["row_bytes"],
            w["new"]["min_ms"] * 1e-3 * 1e6 / w["rows"],
            w["parent"]["min_ms"] * 1e-3 * 1e6 / w["rows"])
    if inflate is not None:
        # one call a file: the compressed bytes in, the FASTQ out
        f = inflate["files"]["l6_member"]
        per = 1e6 / inflate["reads"]
        rows["inflate"] = (per, f["compressed_bytes"] / inflate["reads"],
                           inflate["fastq_bytes"] / inflate["reads"],
                           f["team_default"]["min_ms"] * 1e-3 * per,
                           f["plain"]["min_ms"] * 1e-3 * per)
    out = {"copy_bytes_per_sec": rate, "reads": n}
    for name, (calls, b_in, b_out, new_s, plain_s) in rows.items():
        bound_s = (b_in + b_out) * 1e6 / rate
        out[name] = {"calls_per_1m": calls, "in_bytes": b_in,
                     "out_bytes": b_out, "new_s_per_1m": new_s,
                     "plain_s_per_1m": plain_s, "bound_s_per_1m": bound_s,
                     "new_share": bound_s / new_s,
                     "plain_share": bound_s / plain_s}
        print(f"stage {name}: {calls:.1f} calls per 1M reads, "
              f"{b_in:.1f} B in + {b_out:.1f} B out a read; per 1M reads "
              f"new {new_s:.4f} s, plain {plain_s:.4f} s, bound "
              f"{bound_s:.4f} s ({bound_s / new_s:.1%} / "
              f"{bound_s / plain_s:.1%})", flush=True)
    return out


SECTIONS = ("scan", "read", "map", "format", "pack", "teams", "mate",
            "writer", "inflate", "stages")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=16384,
                    help="rows a format call (bench_torch.py's chunk)")
    ap.add_argument("--copy-mb", type=int, default=512,
                    help="MB of the copy-rate buffer (above the host's "
                         "last-level cache)")
    ap.add_argument("--mate-pairs", default=",".join(
        str(n) for n in MATE_SIZES),
        help="sizes of the mate check and the writer's batch (pairs, "
             "comma-separated; the largest also the writer's rows)")
    ap.add_argument("--inflate-reads", type=int, default=INFLATE_READS,
                    help="reads of the inflate section's FASTQ")
    ap.add_argument("--inflate-rounds", type=int, default=12)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ",".join(SECTIONS))
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    if not sections <= set(SECTIONS):
        ap.error(f"unknown sections {sorted(sections - set(SECTIONS))}")
    mate_sizes = tuple(int(x) for x in args.mate_pairs.split(","))

    from cuclark_tpu_torch import native

    if not native.available():
        print("torch_host_scan: the native host module did not build",
              file=sys.stderr)
        return 2
    smi = card()
    cores = len(os.sched_getaffinity(0))
    line = {"card": smi, "cores": cores, "reads": args.reads,
            "sections": sorted(sections)}
    scan = fmt = pack = mate = writer = inflate = None
    with tempfile.TemporaryDirectory(prefix="host_scan_") as td:
        path = Path(td) / "bench.fq"
        path.write_bytes(fastq_bytes(args.reads, 0))
        buf = np.fromfile(path, np.uint8)  # and into the page cache
        team = native.scan_team(len(buf))
        line.update(default_team=team, bytes=int(len(buf)))
        print(f"host: {cores} cores (os.cpu_count {os.cpu_count()}), "
              f"default team {team}, OMP_NUM_THREADS="
              f"{os.environ.get('OMP_NUM_THREADS')}; card: {smi}; "
              f"{len(buf):,} bytes, {args.reads:,} reads; sections "
              f"{','.join(sorted(sections))}", flush=True)

        want = native.scan_records_serial(buf, False)
        if len(want[0]) != args.reads:
            raise AssertionError(f"{len(want[0])} records of {args.reads}")
        if "scan" in sections:
            fns = {"serial": lambda: native.scan_records_serial(buf, False)}
            for t in TEAMS + (0,):
                if not _same(native.scan_records(buf, False, t), want):
                    raise AssertionError(f"team {t}: offsets differ from "
                                         f"scan_fastq's")
                fns[f"team_{t or 'default'}"] = (
                    lambda t=t: native.scan_records(buf, False, t))
            scan = {}
            for name, ts in times_ms(fns, args.reps).items():
                scan[name] = {"min_ms": min(ts),
                              "median_ms": statistics.median(ts),
                              "reads_per_sec": args.reads / min(ts) * 1e3}
                print(f"scan {name}: min {min(ts):.3f} ms, median "
                      f"{statistics.median(ts):.3f} ms, "
                      f"{scan[name]['reads_per_sec']:,.0f} reads/s",
                      flush=True)
            line["scan"] = scan

        if "read" in sections:
            if not np.array_equal(native.read_file(path), buf):
                raise AssertionError("read_file differs from np.fromfile")
            pairs = []
            for i in range(args.pairs):
                order = ("fromfile", "threaded")[::1 if i % 2 == 0 else -1]
                t = {}
                for name in order:
                    t0 = time.perf_counter()
                    got = (np.fromfile(path, np.uint8) if name == "fromfile"
                           else native.read_file(path))
                    t[name] = (time.perf_counter() - t0) * 1e3
                    del got
                pairs.append({"first": order[0], **{f"{k}_ms": v
                                                     for k, v in t.items()}})
                print(f"read pair {i + 1}: {order[0]} first, np.fromfile "
                      f"{t['fromfile']:.3f} ms, threaded "
                      f"{t['threaded']:.3f} ms", flush=True)
            wins = sum(p["threaded_ms"] < p["fromfile_ms"] for p in pairs)
            print(f"threaded read won {wins} of {args.pairs} pairs",
                  flush=True)
            line.update(read_pairs=pairs, threaded_read_wins=wins,
                        threaded_read_passes_gate=wins >= 11 * args.pairs
                        / 12)

        if "map" in sections:
            map_pairs = map_gate(path, want, args.pairs)
            map_wins = sum(p["map_ms"] < p["fromfile_ms"]
                           for p in map_pairs)
            print(f"map + scan won {map_wins} of {args.pairs} pairs",
                  flush=True)
            line.update(map_pairs=map_pairs, map_wins=map_wins,
                        map_passes_gate=map_wins >= 11 * args.pairs / 12)

        if "format" in sections:
            fmt = format_rates(buf, args.chunk, args.reps)
            line.update(format_chunk=args.chunk,
                        format_default_team=fmt.pop("default_team"),
                        format=fmt)
        if "pack" in sections:
            pack = line["pack"] = pack_rates(buf, args.chunk, args.pairs)
        if "teams" in sections:
            splits = team_splits(cores)
            teams = team_rates(buf, args.chunk, args.reps, splits)
            full = splits[0]
            for policy in (None, "passive"):
                got = team_rates_in_process(path, args.chunk, args.reps,
                                            full[1], policy)
                teams[f"{full[0]} {policy or 'default'} policy, own "
                      f"process"] = got[full[0]]
            line["teams"] = teams
        if "mate" in sections:
            mate = line["mate"] = mate_rates(mate_sizes, args.pairs)
        if "writer" in sections:
            writer = line["writer_batch"] = writer_batch(
                mate_buffers(max(mate_sizes), "srr"), args.chunk,
                args.pairs)
        if "inflate" in sections:
            ifq = Path(td) / "binned.fq"
            ifq.write_bytes(binned_fastq(args.inflate_reads))
            t0 = time.perf_counter()
            files = gzip_files(ifq)
            print(f"inflate: {len(files)} gzip files of "
                  f"{ifq.stat().st_size:,} bytes written in "
                  f"{time.perf_counter() - t0:.1f} s; default team "
                  f"{native.inflate_team(files['l6_member'].stat().st_size)}",
                  flush=True)
            inflate = line["inflate"] = {
                "reads": args.inflate_reads,
                "fastq_bytes": ifq.stat().st_size,
                "rounds": args.inflate_rounds,
                "files": inflate_rates(files, ifq.stat().st_size,
                                       args.inflate_rounds),
                "rss_l6_member": inflate_rss(files["l6_member"])}
            for path in files.values():
                path.unlink()
        if "stages" in sections:
            rate = copy_rate(args.copy_mb, cores)
            print(f"copy rate: {rate / 1e9:.2f} GB/s read + written "
                  f"({args.copy_mb} MB, {cores} threads)", flush=True)
            line["stages"] = stage_table(buf, args.chunk, args.reps, rate,
                                         scan, pack, fmt, mate, writer,
                                         inflate)
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
