#!/usr/bin/env python3
"""The host feed of classify timed on the machine it runs on: the
record scan (`cuclark_tpu_torch.native`) by team size, and the file
read, `np.fromfile` against the threaded read by byte range.

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
    pair's two times and which was faster.  The threaded read replaces
    np.fromfile in `pipeline._read_file_bytes` only if it wins at least
    11 of 12 pairs.

Prints the host's cores, the default team, the card's name and power
limit where `nvidia-smi` answers, and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
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


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=7)
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
    line = {"card": smi, "cores": cores, "default_team": team,
            "reads": args.reads, "bytes": int(len(buf)), "scan": scan,
            "read_pairs": pairs, "threaded_read_wins": wins,
            "threaded_read_passes_gate": wins >= 11 * args.pairs / 12}
    print(f"threaded read won {wins} of {args.pairs} pairs", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
