#!/usr/bin/env python3
"""File -> CSV on the tree's host path and on its parent's, timed in
turns in one process, each pass split by thread: what the gzip inflate
on the OpenMP team moves end to end.

    N=500000 ROUNDS=12 python3 scripts/torch_e2e_ab.py [--out FILE]

It draws torch_profile_e2e.py's data (numpy seed 0): a qs table of KMERS
(default 4M) random 31-mers over 1,024 targets, N (default 500,000)
150 bp reads named `r<i>` and N pairs of 75 + 75 bp mates named
`SRR1234567.<i>/1` and `/2`, substrings of a random 2 Mb genome, and a
gzip copy of each file (level 6, one member, as `gzip` writes it).  One
resident `Classifier` on the card runs ROUNDS rounds; a round is one
pass of each job (the reads, the pairs, the gzip reads, the gzip pairs)
under each configuration, the order alternating from round to round:

  new     the tree as it is: a gzip input mapped and inflated on the
          OpenMP team (`native.inflate` through `pipeline._inflate`);
  parent  the parent's path: the inflate on one thread
          (`pipeline._inflate_plain`, `gzip.GzipFile(...).read()`, over
          the mapped bytes: a copy of the compressed bytes more than the
          parent's `gzip.open(path).read()`).

The parent's path is set by swapping `pipeline._inflate` for the pass;
the package is not changed.  The plain jobs do not inflate: they are the
control (no pass of theirs should move).  Every pass's CSV must equal
the plain job's first pass's, byte for byte (a hard failure).  Prints
each configuration's median, quartiles, passes and rounds won against
`parent`, its median pass split by thread (the head before the first
batch: the main thread's `read_scan` with `inflate` and `mate_check`
inside it), and one JSON line last.  Without a card it exits 2 (DEV=cpu
runs it on the CPU).
"""

import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

CONFIGS = ("new", "parent")


def fastq(path: Path, rows: np.ndarray, name: bytes = b"r%d") -> None:
    seq = np.frombuffer(b"ACGT", np.uint8)[rows]
    qual = b"I" * rows.shape[1]
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (name % i, seq[i].tobytes(),
                                                 qual)
                         for i in range(len(rows))))


def parent_inflate(data) -> np.ndarray:
    """`pipeline._inflate` as the parent tree has it: one thread."""
    from cuclark_tpu_torch import pipeline

    return np.frombuffer(pipeline._inflate_plain(data), np.uint8)


def _gzip_file(args) -> None:
    import gzip

    src, dst = args
    Path(dst).write_bytes(gzip.compress(Path(src).read_bytes(), 6,
                                        mtime=0))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from cuclark_tpu_torch import codec, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from torch_thread_split import ThreadSplit

    dev = torch.device(os.environ.get("DEV", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_e2e_ab: no CUDA device", file=sys.stderr)
        return 2
    n = int(os.environ.get("N", 500_000))
    n_kmers = int(os.environ.get("KMERS", 4_000_000))
    rounds = int(os.environ.get("ROUNDS", 12))
    rng = np.random.default_rng(0)
    km = np.unique(codec.canonical_np(rng.integers(
        0, 1 << 62, size=int(n_kmers * 1.05), dtype=np.uint64), 31))[:n_kmers]
    labels = rng.integers(1, 1025, size=len(km)).astype(np.uint32)
    db = build_table(km, labels, ["NA"] + [f"T{i}" for i in range(1, 1025)],
                     DBConfig(k=31, target_load=0.85))
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    td = Path(tempfile.mkdtemp(prefix="e2e_ab_"))
    st = rng.integers(0, len(genome) - 150, size=n)
    fastq(td / "r.fq", genome[st[:, None] + np.arange(150)])
    st = rng.integers(0, len(genome) - 150, size=n)
    fastq(td / "m1.fq", genome[st[:, None] + np.arange(75)],
          b"SRR1234567.%d/1")
    fastq(td / "m2.fq", genome[st[:, None] + np.arange(75, 150)],
          b"SRR1234567.%d/2")
    import multiprocessing as mp

    names = ("r.fq", "m1.fq", "m2.fq")
    with mp.get_context("spawn").Pool(len(names)) as pool:
        pool.map(_gzip_file, [(td / f, td / (f + ".gz")) for f in names])
    clf = pipeline.Classifier(db, ClassifyConfig(batch_reads=16384),
                              device=dev)
    T = len(os.sched_getaffinity(0))
    real = pipeline._inflate

    def setup(cfg):
        if cfg == "parent":
            pipeline._inflate = parent_inflate

    def reset():
        pipeline._inflate = real

    jobs = {"single": (td / "r.fq", None),
            "paired": (td / "m1.fq", td / "m2.fq"),
            "gzip single": (td / "r.fq.gz", None),
            "gzip paired": (td / "m1.fq.gz", td / "m2.fq.gz")}
    out_csv = td / "o.csv"
    want = {}
    for job, (a, b) in jobs.items():
        clf.classify_file_to_csv(a, out_csv, b)
        want[job] = out_csv.read_bytes()
        if job.startswith("gzip") and want[job] != want[job[5:]]:
            raise AssertionError(f"{job}: another CSV than the plain "
                                 f"input's")
    times = {(j, c): [] for j in jobs for c in CONFIGS}
    splits = {(j, c): [] for j in jobs for c in CONFIGS}
    batches = -(-n // 16384)
    for r in range(rounds):
        for cfg in (CONFIGS if r % 2 == 0 else CONFIGS[::-1]):
            for job, (a, b) in jobs.items():
                setup(cfg)
                try:
                    with ThreadSplit() as sp:
                        t0 = time.perf_counter()
                        clf.classify_file_to_csv(a, out_csv, b)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        dt = time.perf_counter() - t0
                finally:
                    reset()
                if out_csv.read_bytes() != want[job]:
                    raise AssertionError(f"{job} under {cfg}: another CSV")
                times[(job, cfg)].append(dt)
                splits[(job, cfg)].append(sp.report(batches))
    clf.close()
    shutil.rmtree(td, ignore_errors=True)
    line = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), "cores": T, "reads": n,
            "rounds": rounds, "configs": {}}
    for job in jobs:
        base = times[(job, "parent")]
        for cfg in CONFIGS:
            ts = times[(job, cfg)]
            med = sorted(splits[(job, cfg)],
                         key=lambda r: r["wall_s"])[len(ts) // 2]
            wins = sum(t < b for t, b in zip(ts, base))
            q1, q3 = np.percentile(ts, (25, 75))
            print(f"{job} {cfg}: median {statistics.median(ts):.4f} s "
                  f"({n / statistics.median(ts):,.0f} a second), quartiles "
                  f"{q1:.4f}-{q3:.4f}, beats parent in {wins} of "
                  f"{len(ts)} rounds; passes "
                  + " ".join(f"{t:.4f}" for t in ts), flush=True)
            roles = {row["role"]: {k: round(v["s"], 4) for k, v in {
                **row["stages"], **row["waits"]}.items()}
                for row in med["threads"].values()}
            print(f"    median pass split: {json.dumps(roles)}", flush=True)
            head = roles.get("main", {})
            print(f"    head before the first batch: "
                  f"{sum(head.get(k, 0) for k in ('read_scan', 'inflate', 'mate_check')):.4f} s (inflate "
                  f"{head.get('inflate', 0):.4f})", flush=True)
            line["configs"][f"{job} {cfg}"] = {"pass_s": ts,
                                               "median_split": med}
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
