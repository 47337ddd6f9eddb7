#!/usr/bin/env python3
"""File -> CSV on the card at several splits of the host's cores between
the pack's OpenMP team (the producer thread) and the row writer's (the
writer thread), on the shapes of bench_torch.py's e2e_scale, e2e_small
and light_paired blocks.

    python3 scripts/torch_teams_e2e.py [--rounds 2] [--out FILE]

The parent process draws the data with bench_torch.py's recipes: 500,000
reads of 150 bp and 1,000,000 pairs of 75 + 75 bp mates (substrings of a
random 2 Mb genome, numpy seed 0), the 64M-k-mer qs table of e2e_scale
(16,384 targets), the 4M table of e2e_small (1,024) and the k=27, gap 4,
32M table of light_paired (1,024); it saves them in a temporary
directory.  Then it runs four processes of itself, with OMP_WAIT_POLICY
unset, passive, passive, unset.  Each loads the tables, makes a resident
`Classifier` for each block on the card, and runs `--rounds` rounds; a
round is one pass of each block at each split (pack team + writer team:
T + T, every core for both; T/2 + T/2, the default split of
`native.pack_team` and `format_team`; 3T/4 + T/4; T/4 + 3T/4; T the
host's cores) in turns.  The teams are set by wrapping
`native.pack_block2`, `pack_block2_paired` and the row writer's
entries (`format_results`, `format_results_ext`, `format_rows`,
`format_rows_ext`) with `threads=`; the package is not changed.

Exactness, a hard failure: every pass's CSV equals, byte for byte, the
block's CSV from a pass that packs into fresh arrays and copies them to
pinned memory (the classifier's pinned ring taken away), so the ring is
checked against the path it replaced.

Prints each pass, each split's median rate by block and policy, the
card's name and power limit and the host's cores, and one JSON line
last.  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import functools
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
for _p in (ROOT, ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from torch_host_scan import card, team_splits  # noqa: E402

E2E_READS = 500_000
PAIRS = 1_000_000
READ_LEN = 150
# block -> (k-mers, targets, k, gap, load)
TABLES = {"e2e_scale": (64_000_000, 16384, 31, None, 0.85),
          "e2e_small": (4_000_000, 1024, 31, None, 0.7),
          "light_paired": (32_000_000, 1024, 27, 4, 0.7)}
POLICIES = (None, "passive", "passive", None)
DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu" (no ring there)


def make_data(td: Path) -> None:
    """The FASTQ files and the three tables, saved under td."""
    from bench_torch import bench_reads, synth_kmers
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.hashdb import build_table

    rng = np.random.default_rng(0)
    genome, _ = bench_reads(rng, 1, READ_LEN)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def fastq(path, rows):
        qual = b"I" * rows.shape[1]
        seqs = acgt[rows]
        with open(path, "wb") as f:
            for lo in range(0, len(rows), 65536):
                f.write(b"".join(b"@r%d\n%s\n+\n%s\n"
                                 % (i, seqs[i].tobytes(), qual)
                                 for i in range(lo, min(lo + 65536,
                                                        len(rows)))))

    st = rng.integers(0, len(genome) - READ_LEN, size=E2E_READS)
    fastq(td / "reads.fq", genome[st[:, None] + np.arange(READ_LEN)])
    st = rng.integers(0, len(genome) - READ_LEN, size=PAIRS)
    half = READ_LEN // 2
    fastq(td / "r1.fq", genome[st[:, None] + np.arange(half)])
    fastq(td / "r2.fq", genome[st[:, None] + np.arange(half, READ_LEN)])
    for block, (n, targets, k, gap, load) in TABLES.items():
        t0 = time.time()
        km, labels, names = synth_kmers(n, targets, k)
        cfg = (DBConfig(k=k, gap=gap, target_load=load) if gap
               else DBConfig(k=k, target_load=load))
        build_table(km, labels, names, cfg).save(td / f"{block}.npz")
        print(f"{block}: {n} k-mers built and saved in "
              f"{time.time() - t0:.1f} s", flush=True)


class Teams:
    """The pack's and the writer's teams, set by wrapping the native
    entries for the length of a `with` block."""

    NAMES = {"pack_block2": 0, "pack_block2_paired": 0, "format_rows": 1,
             "format_rows_ext": 1, "format_results": 1,
             "format_results_ext": 1}

    def __init__(self, pack: int, writer: int):
        self.teams = (pack, writer)

    def __enter__(self):
        from cuclark_tpu_torch import native

        self.old = {n: getattr(native, n) for n in self.NAMES}
        for n, side in self.NAMES.items():
            setattr(native, n, functools.partial(
                self.old[n], threads=self.teams[side]))
        return self

    def __exit__(self, *exc):
        from cuclark_tpu_torch import native

        for n, fn in self.old.items():
            setattr(native, n, fn)
        return False


def child(td: Path, rounds: int) -> dict:
    """One process's rounds: {block: {split: [pass s]}}."""
    import torch

    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.pipeline import Classifier

    dev = torch.device(DEVICE)
    cores = len(os.sched_getaffinity(0))
    jobs = {"e2e_scale": (td / "reads.fq", None, E2E_READS),
            "e2e_small": (td / "reads.fq", None, E2E_READS),
            "light_paired": (td / "r1.fq", td / "r2.fq", PAIRS)}
    clfs, want = {}, {}
    for block, (fq, r2, _) in jobs.items():
        clf = Classifier(KmerDB.load(td / f"{block}.npz"),
                         ClassifyConfig(batch_reads=16384), device=dev)
        ring, clf._ring = clf._ring, None
        out = td / f"want_{block}.csv"
        clf.classify_file_to_csv(fq, out, r2)  # fresh arrays, pinned copy
        want[block] = out.read_bytes()
        clf._ring = ring
        clf.classify_file_to_csv(fq, td / f"got_{os.getpid()}.csv", r2)
        clfs[block] = clf
    splits = team_splits(cores)
    times = {b: {name: [] for name, _, _ in splits} for b in jobs}
    for r in range(rounds):
        for name, p, w in splits[::1 if r % 2 == 0 else -1]:
            for block, (fq, r2, n_expect) in jobs.items():
                out = td / f"got_{os.getpid()}.csv"
                with Teams(p, w):
                    t0 = time.perf_counter()
                    n = clfs[block].classify_file_to_csv(fq, out, r2)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                if n != n_expect:
                    raise AssertionError(f"{block}: {n} of {n_expect}")
                if out.read_bytes() != want[block]:
                    raise AssertionError(f"{block} at {p}+{w}: the CSV "
                                         f"differs from the pinned-copy "
                                         f"path's")
                times[block][name].append(dt)
                print(f"round {r + 1} {block} {name}: {dt:.4f} s, "
                      f"{n_expect / dt:,.1f} a second", flush=True)
    for clf in clfs.values():
        clf.close()
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_teams_e2e: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(Path(args.child), args.rounds)))
        return 0
    cores = len(os.sched_getaffinity(0))
    smi = card()
    print(f"card: {smi}; host: {cores} cores", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="teams_e2e_") as d:
        td = Path(d)
        make_data(td)
        for policy in POLICIES:
            env = dict(os.environ)
            env.pop("OMP_WAIT_POLICY", None)
            if policy:
                env["OMP_WAIT_POLICY"] = policy
            t0 = time.time()
            run = subprocess.run(
                [sys.executable, __file__, "--child", str(td),
                 "--rounds", str(args.rounds)], env=env, text=True,
                stdout=subprocess.PIPE, check=True, timeout=1800)
            lines = run.stdout.strip().splitlines()
            print("\n".join(f"  [{policy or 'default'}] {x}"
                            for x in lines[:-1]), flush=True)
            runs.append({"policy": policy or "default",
                         "times": json.loads(lines[-1]),
                         "s": time.time() - t0})
    n_of = {"e2e_scale": E2E_READS, "e2e_small": E2E_READS,
            "light_paired": PAIRS}
    summary = {}
    for policy in ("default", "passive"):
        for block in n_of:
            for split, _, _ in team_splits(cores):
                ts = [t for r in runs if r["policy"] == policy
                      for t in r["times"][block][split]]
                rate = n_of[block] / statistics.median(ts)
                summary[f"{block} {split} {policy}"] = {
                    "median_per_sec": rate, "pass_s": ts}
                print(f"{block} {split} {policy} policy: median "
                      f"{rate:,.1f} a second over {len(ts)} passes",
                      flush=True)
    line = {"card": smi, "cores": cores, "rounds": args.rounds,
            "summary": summary, "exact": True}
    if args.out:
        Path(args.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
