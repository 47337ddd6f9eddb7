"""Where the host time of cuclark_tpu_torch's file -> CSV path goes:
cProfile over `Classifier.classify_file_to_csv` on a synthetic FASTQ,
then the same pass split by thread.

Counterpart of `scripts/profile_e2e.py`, with its knobs: N reads of
150 bp (substrings of a random 2 Mb genome, numpy seed 0) against a
synthetic qs table of KMERS random k-mers (k=31, load 0.85) over TARGETS
targets.  It prints the table, one timed pass's rate, and the 25 most
expensive calls by cumulative time.  cProfile adds a cost to every
Python call and none to native code or the card, and it sees the main
thread only, so the shares it prints are for finding candidates;
`bench_torch.py` measures.

Then SPLIT_PASSES (default 3) passes run without cProfile, split by
the program's spans as `scripts/torch_thread_split.py` sums them (the pack,
the pinned copy and H2D issue, the launch, the readback wait, the rows,
the write, the queue and future waits;
per thread: main, producer, writer): a line of each pass's split, and
the split of the median pass as the JSON line last.

Run from the repository root, on the card (the default) or on the CPU:

    N=500000 python3 scripts/torch_profile_e2e.py
    N=20000 KMERS=100000 python3 scripts/torch_profile_e2e.py --device cpu

Without a card and without `--device cpu` (or CUCLARK_BENCH_DEVICE=cpu)
it exits 2.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device",
                    default=os.environ.get("CUCLARK_BENCH_DEVICE", "cuda"),
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_profile_e2e: no CUDA device (torch.cuda.is_available() "
              "is False); pass --device cpu to profile the CPU path",
              file=sys.stderr)
        return 2
    for p in (ROOT, ROOT / "scripts"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from cuclark_tpu_torch import codec
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.pipeline import Classifier

    n_reads = int(os.environ.get("N", 200_000))
    n_kmers = int(os.environ.get("KMERS", 4_000_000))
    n_targets = int(os.environ.get("TARGETS", 1024))
    split_passes = int(os.environ.get("SPLIT_PASSES", 3))
    rng = np.random.default_rng(0)
    km = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=int(n_kmers * 1.05), dtype=np.uint64),
        31))[:n_kmers]
    labels = rng.integers(1, n_targets + 1, size=len(km)).astype(np.uint32)
    db = build_table(km, labels,
                     ["NA"] + [f"T{i}" for i in range(1, n_targets + 1)],
                     DBConfig(k=31, target_load=0.85))
    print(f"db: {db.table.nbytes / 1e6:.0f} MB, layout {db.layout}, "
          f"nb_bits {db.nb_bits}, stash_bits {db.stash_bits}; device "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)

    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - 150, size=n_reads)
    rows = genome[starts[:, None] + np.arange(150)[None, :]]
    seq = np.frombuffer(b"ACGT", np.uint8)[rows]

    with tempfile.TemporaryDirectory() as td:
        fq = Path(td) / "r.fq"
        qual = b"I" * 150
        with open(fq, "wb") as f:
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n"
                             % (i, seq[i].tobytes(), qual)
                             for i in range(n_reads)))
        clf = Classifier(db, ClassifyConfig(batch_reads=16384), device=dev)
        out = Path(td) / "o.csv"
        clf.classify_file_to_csv(fq, out)  # warm-up: kernels' build, pools

        t0 = time.time()
        pr = cProfile.Profile()
        pr.enable()
        n = clf.classify_file_to_csv(fq, out)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        pr.disable()
        dt = time.time() - t0
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
        print(f"e2e: {n} reads in {dt:.4f} s = {n / dt:,.1f} reads/s "
              f"(under cProfile)", flush=True)
        print(s.getvalue(), flush=True)

        from torch_thread_split import ThreadSplit, summary

        batches = -(-n_reads // clf.cfg.batch_reads)
        splits = []
        for _ in range(split_passes):
            with ThreadSplit() as split:
                clf.classify_file_to_csv(fq, out)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            splits.append(split.report(batches))
            print(summary(splits[-1]), flush=True)
        clf.close()
    if splits:
        med = sorted(splits, key=lambda r: r["wall_s"])[len(splits) // 2]
        print(json.dumps({"reads": n_reads, "device": str(dev),
                          "split": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
