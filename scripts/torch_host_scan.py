#!/usr/bin/env python3
"""The host feed and drain of classify timed on the machine it runs on:
the record scan (`cuclark_tpu_torch.native`) by team size, the file
read with the scan, and the CSV row writer by team size.

    python3 scripts/torch_host_scan.py [--reads 500000] [--pairs 12]
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
    of one more pass of each.

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
                qual: bytes = b"I") -> bytes:
    """n random reads in bench_torch.py's record format; quality bytes
    drawn from `qual`."""
    rng = np.random.default_rng(seed)
    seqs = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n, read_len))]
    quals = np.frombuffer(qual, np.uint8)[
        rng.integers(0, len(qual), (n, read_len))]
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=16384,
                    help="rows a format call (bench_torch.py's chunk)")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    from cuclark_tpu_torch import native

    if not native.available():
        print("torch_host_scan: the native host module did not build",
              file=sys.stderr)
        return 2
    smi = card()
    cores = len(os.sched_getaffinity(0))
    with tempfile.TemporaryDirectory(prefix="host_scan_") as td:
        path = Path(td) / "bench.fq"
        path.write_bytes(fastq_bytes(args.reads, 0))
        buf = np.fromfile(path, np.uint8)  # and into the page cache
        team = native.scan_team(len(buf))
        print(f"host: {cores} cores (os.cpu_count {os.cpu_count()}), "
              f"default team {team}, OMP_NUM_THREADS="
              f"{os.environ.get('OMP_NUM_THREADS')}; card: {smi}; "
              f"{len(buf):,} bytes, {args.reads:,} reads", flush=True)

        want = native.scan_records_serial(buf, False)
        if len(want[0]) != args.reads:
            raise AssertionError(f"{len(want[0])} records of {args.reads}")
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
                  f"{t['fromfile']:.3f} ms, threaded {t['threaded']:.3f} "
                  f"ms", flush=True)
        wins = sum(p["threaded_ms"] < p["fromfile_ms"] for p in pairs)
        print(f"threaded read won {wins} of {args.pairs} pairs",
              flush=True)

        map_pairs = map_gate(path, want, args.pairs)
        map_wins = sum(p["map_ms"] < p["fromfile_ms"] for p in map_pairs)
        print(f"map + scan won {map_wins} of {args.pairs} pairs",
              flush=True)

        fmt = format_rates(buf, args.chunk, args.reps)
    line = {"card": smi, "cores": cores, "default_team": team,
            "reads": args.reads, "bytes": int(len(buf)), "scan": scan,
            "read_pairs": pairs, "threaded_read_wins": wins,
            "threaded_read_passes_gate": wins >= 11 * args.pairs / 12,
            "map_pairs": map_pairs, "map_wins": map_wins,
            "map_passes_gate": map_wins >= 11 * args.pairs / 12,
            "format_chunk": args.chunk,
            "format_default_team": fmt.pop("default_team"),
            "format": fmt}
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
