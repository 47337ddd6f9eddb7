#!/usr/bin/env python3
"""File -> CSV on the tree's host path and on its parent's, timed in
turns in one process, each pass split by thread: what the native mate-id
check and the row writer's own gamma move end to end.

    N=500000 ROUNDS=12 python3 scripts/torch_e2e_ab.py [--out FILE]

It draws torch_profile_e2e.py's data (numpy seed 0): a qs table of KMERS
(default 4M) random 31-mers over 1,024 targets, N (default 500,000)
150 bp reads named `r<i>` and N pairs of 75 + 75 bp mates named
`SRR1234567.<i>/1` and `/2`, substrings of a random 2 Mb genome.  One
resident `Classifier` on the card runs ROUNDS rounds; a round is one
pass of the reads and one of the pairs under each configuration, the
order alternating from round to round:

  new     the tree as it is: the mate ids checked natively on the
          OpenMP team (`native.first_mate_mismatch`), the rows written
          from the card's results rows with gamma and confidence
          computed by the writer (`native.format_results`);
  parent  the parent's path: the numpy check
          (`fast_parse.first_mate_mismatch_plain`), and `CsvSink.flush`
          computing gamma and confidence in numpy
          (`score.gamma_confidence`) before the fields writer
          (`native.format_rows`).

The parent's path is set by swapping those two functions for the pass;
the package is not changed.  Every pass's CSV must equal the first
pass's, byte for byte (a hard failure).  Prints each configuration's
median, quartiles, passes and rounds won against `parent`, its median
pass split by thread, and one JSON line last.  Without a card it exits
2 (DEV=cpu runs it on the CPU).
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


def parent_flush(self, results, labels_np, buf, ns, ne, lengths, cnt):
    """`CsvSink.flush` as the parent tree has it: gamma and confidence
    in numpy, then the writer of the field arrays."""
    from cuclark_tpu_torch import native, score
    from cuclark_tpu_torch.pipeline import accumulate_hit_stats, dense_counts

    results = results[:cnt]
    lengths = lengths[:cnt]
    total, ibest, best, isecond, second = (results[:, i] for i in range(5))
    norm, gamma, conf = score.gamma_confidence(
        total, best, second, lengths, self.db.k, self.paired)
    if self.extended:
        counts = dense_counts(labels_np[:cnt], self.db.num_targets)[:, 1:]
        accumulate_hit_stats(self.hstats, (counts > 0).sum(axis=1))
        rows, _ = native.format_rows_ext(
            counts, norm, gamma, ibest, best, isecond, second, conf, buf,
            ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off)
    else:
        rows, _ = native.format_rows(
            norm, gamma, ibest, best, isecond, second, conf, buf, ns[:cnt],
            ne[:cnt], self.tname_bytes, self.tname_off)
    self.f.write(rows)
    self.total_rows += cnt


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from cuclark_tpu_torch import codec, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.io import fast_parse
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
    clf = pipeline.Classifier(db, ClassifyConfig(batch_reads=16384),
                              device=dev)
    T = len(os.sched_getaffinity(0))
    real = (fast_parse.first_mate_mismatch, pipeline.CsvSink.flush)

    def setup(cfg):
        if cfg == "parent":
            fast_parse.first_mate_mismatch = \
                fast_parse.first_mate_mismatch_plain
            pipeline.CsvSink.flush = parent_flush

    def reset():
        fast_parse.first_mate_mismatch, pipeline.CsvSink.flush = real

    jobs = {"single": (td / "r.fq", None), "paired": (td / "m1.fq",
                                                      td / "m2.fq")}
    out_csv = td / "o.csv"
    want = {}
    for job, (a, b) in jobs.items():
        clf.classify_file_to_csv(a, out_csv, b)
        want[job] = out_csv.read_bytes()
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
            line["configs"][f"{job} {cfg}"] = {"pass_s": ts,
                                               "median_split": med}
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
