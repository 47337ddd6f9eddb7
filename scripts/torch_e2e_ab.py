#!/usr/bin/env python3
"""File -> CSV configurations of the host feed timed in turns in one
process, each pass split by thread: which part of the pack's redesign
moves the pass.

    N=500000 ROUNDS=10 python3 scripts/torch_e2e_ab.py [--out FILE]

It draws torch_profile_e2e.py's data (numpy seed 0): a qs table of KMERS
(default 4M) random 31-mers over 1,024 targets, N (default 500,000)
150 bp reads and N pairs of 75 + 75 bp mates, substrings of a random
2 Mb genome.  One resident `Classifier` on the card runs ROUNDS rounds;
a round is one pass of the reads and one of the pairs under each
configuration, the order rotated and reversed from round to round:

  new         the tree as it is: the pinned ring, the eight-bases-a-step
              pack on half the cores, the row writer on the rest;
  parentlike  the path before the redesign: no ring (fresh arrays, a
              `.pin_memory()` copy), the plain one-base pack on every
              core, the writer on every core;
  new_8+8     the ring and the new pack, both teams on every core;
  noring      the new pack and the default teams without the ring.

The configurations are set by swapping the classifier's ring and
wrapping the native entries for the pass; the package is not changed.
Every pass's CSV must equal the first pass's, byte for byte (a hard
failure).  Prints each configuration's median, quartiles, passes and
rounds won against `parentlike`, its median pass split by thread, how
many ring slots were found with their copy not done, and one JSON line
last.  Without a card it exits 2 (DEV=cpu runs it on the CPU, with no
ring).
"""

import functools
import json
import os
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

CONFIGS = ("new", "parentlike", "new_8+8", "noring")


def fastq(path: Path, rows: np.ndarray) -> None:
    seq = np.frombuffer(b"ACGT", np.uint8)[rows]
    qual = b"I" * rows.shape[1]
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(), qual)
                         for i in range(len(rows))))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)

    import torch

    from cuclark_tpu_torch import codec, native, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from torch_thread_split import ThreadSplit

    dev = torch.device(os.environ.get("DEV", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_e2e_ab: no CUDA device", file=sys.stderr)
        return 2
    n = int(os.environ.get("N", 500_000))
    n_kmers = int(os.environ.get("KMERS", 4_000_000))
    rounds = int(os.environ.get("ROUNDS", 10))
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
    fastq(td / "m1.fq", genome[st[:, None] + np.arange(75)])
    fastq(td / "m2.fq", genome[st[:, None] + np.arange(75, 150)])
    clf = pipeline.Classifier(db, ClassifyConfig(batch_reads=16384),
                              device=dev)
    ring = clf._ring
    T = len(os.sched_getaffinity(0))
    entries = ("pack_block2", "pack_block2_paired", "format_rows")
    real = {name: getattr(native, name) for name in entries}

    def plain(name):
        fn = getattr(native, name + "_plain")

        def call(*a, out=None, threads=0, **kw):
            return fn(*a, **kw)
        return call

    def setup(cfg):
        clf._ring = None if cfg in ("parentlike", "noring") else ring
        if cfg == "parentlike":
            native.pack_block2 = plain("pack_block2")
            native.pack_block2_paired = plain("pack_block2_paired")
        if cfg in ("parentlike", "new_8+8"):
            for name in entries:
                if name.startswith("format") or cfg == "new_8+8":
                    setattr(native, name, functools.partial(real[name],
                                                            threads=T))

    def reset():
        clf._ring = ring
        for name, fn in real.items():
            setattr(native, name, fn)

    waited = [0, 0]
    acquire = pipeline._WireRing.acquire

    def counting(self, *a):
        waited[0] += 1
        i = self._next
        waited[1] += bool(self._pending[i] and not self._events[i].query())
        return acquire(self, *a)

    pipeline._WireRing.acquire = counting
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
        order = list(CONFIGS[r % len(CONFIGS):] + CONFIGS[:r % len(CONFIGS)])
        for cfg in (order if r % 2 == 0 else order[::-1]):
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
    pipeline._WireRing.acquire = acquire
    clf.close()
    line = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), "cores": T, "reads": n,
            "rounds": rounds, "ring_acquires": waited[0],
            "ring_copy_not_done": waited[1], "configs": {}}
    for job in jobs:
        base = times[(job, "parentlike")]
        for cfg in CONFIGS:
            ts = times[(job, cfg)]
            med = sorted(splits[(job, cfg)],
                         key=lambda r: r["wall_s"])[len(ts) // 2]
            wins = sum(t < b for t, b in zip(ts, base))
            q1, q3 = np.percentile(ts, (25, 75))
            print(f"{job} {cfg}: median {statistics.median(ts):.4f} s "
                  f"({n / statistics.median(ts):,.0f} a second), quartiles "
                  f"{q1:.4f}-{q3:.4f}, beats parentlike in {wins} of "
                  f"{len(ts)} rounds; passes "
                  + " ".join(f"{t:.4f}" for t in ts), flush=True)
            roles = {row["role"]: {k: round(v["s"], 4) for k, v in {
                **row["stages"], **row["waits"]}.items()}
                for row in med["threads"].values()}
            print(f"    median pass split: {json.dumps(roles)}", flush=True)
            line["configs"][f"{job} {cfg}"] = {"pass_s": ts,
                                               "median_split": med}
    print(f"ring acquires: {waited[0]}, found the slot's copy not done: "
          f"{waited[1]}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
