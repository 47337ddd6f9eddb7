#!/usr/bin/env python3
"""The random-gather ceiling of the query's main rows on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_gather_ceiling.py

It builds `scripts/csrc/gather_ceiling.cu` with the package's nvcc flags
into `build/gather_ceiling/`, builds chip_smoke.py's headline qs table
(64M 31-mers, 2^25 main rows of 32 B: 1.07 GB) and one [65,536, 152]
batch of its 150 bp reads, and takes the main bucket l2 & (NB - 1) of
every valid window in window order, repeats kept.  Then it times
gather-only kernels over those buckets, each reading a main row as the
query kernel does (two 16 B loads, evict-first) and folding it into a
checksum:

  1. window: the buckets in window order (the query's gathers without
     its front half);
  2. pair64: the same buckets, each reading its aligned 64 B row pair;
  3. sorted: the buckets fully sorted;
  4. binned s: bins of 2^s rows (s in --bins), window order inside a bin;
  5. the binning: window indices grouped by bin, (radix) a count pass,
     one scan and a scatter, or (fixed) bins of fixed capacity with an
     overflow list, one warp-aggregated atomic per job, also (fixed_keys)
     with each job's Feistel halves written beside its index;
  6. the gather pass over the fixed bins: per job the k-mer recomputed
     from the wire bytes (jobs_wire) or read as (h1, l2) from the bins
     (jobs_keys), the main row compared, the label added;
  7. for the q4 and s2 tables of the same k-mers, their main
     rows read as their query kernels read them, in window order:
     <layout>_exact, the rows an exact probe needs (every window's
     choice-0 row, and its choice-1 row only where choice 0 gives label
     0: what the kernel gathers), and <layout>_both, both choices' rows
     of every window.

Each line is the median of --timings CUDA-event timings (each the mean
of --reps launches after a warm-up), with rows/s and useful GB/s (32 B a
job).  The decision: the best binned gather plus the fixed binning at
the same s against the window-order gather; at most 2/3 of it means the
gathers gain from bucket order.  Prints the card's name and power limit
and one JSON object last, also written to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "scripts" / "csrc" / "gather_ceiling.cu"


def build() -> ctypes.CDLL:
    """nvcc gather_ceiling.cu with kernels.NVCC_FLAGS into build/, named
    by a hash of the source and the flags; load and bind it."""
    from cuclark_tpu_torch import kernels

    h = hashlib.sha256("\0".join(kernels.NVCC_FLAGS).encode())
    h.update(SRC.read_bytes())
    path = ROOT / "build" / "gather_ceiling" / f"lib_{h.hexdigest()[:16]}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                               str(path), str(SRC)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_uint32)
    for fn, args in (
            ("gc_gather", [vp, vp, i64, i32, vp, vp]),
            ("gc_gather_layout", [vp, vp, i64, i32, i32, vp, vp]),
            ("gc_gather_qs", [vp, vp, vp, i64, vp, vp]),
            ("gc_partition_radix", [vp, vp, i64, i32, i32, vp, vp, vp, vp]),
            ("gc_partition_fixed", [vp, vp, vp, vp, i64, i32, i32, u32, vp,
                                    vp, vp, vp, vp, vp, vp, i32, vp]),
            ("gc_gather_jobs", [vp, i32, i32, i32, i32, u32, u32, u32, vp,
                                vp, vp, i32, u32, vp, vp, vp, vp, vp, vp,
                                i32, i32, vp, vp])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i32
    return lib


def bin_capacity(windows: int, s: int, nb_bits: int) -> int:
    """Slots of a bin of 2^s rows: the mean jobs of a bin if every one of
    `windows` windows made one, plus four standard deviations, plus 8."""
    mean = windows * 2.0 ** (s - nb_bits)
    return int(np.ceil(mean + 4 * np.sqrt(mean))) + 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--bins", type=int, nargs="+", default=[8, 10, 12, 14])
    ap.add_argument("--timings", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "gather_ceiling.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_gather_ceiling: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch_measure as tm
    from cuclark_tpu_torch import codec, probe
    from cuclark_tpu_torch.hashdb import (feistel_mix_torch,
                                          feistel_seed_consts,
                                          table_to_device)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    lib = build()
    print(f"built {SRC.relative_to(ROOT)} in {time.time() - t0:.1f} s",
          flush=True)

    t0 = time.time()
    genomes, dbs = cs.build_headline_db(args.genomes, None,
                                        ("qs", "q4", "s2"))
    db = dbs.pop("qs")
    with tempfile.TemporaryDirectory(prefix="gather_ceiling_") as td:
        codes, _ = cs.write_reads(genomes, args.reads, Path(td) / "r.fq")
    del genomes
    print(f"table and reads in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    k, R, L = cs.K, args.reads, 152
    P = L - k + 1
    padded = np.full((R, L), codec.INVALID, np.uint8)
    padded[:, :cs.READ_LEN] = codes
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(padded))
    codes_t = torch.from_numpy(padded).to(dev).to(torch.int32)
    main_t, _ = table_to_device(db, dev)
    spec, nb_bits = db.spec, db.nb_bits
    del db

    # every valid window's main bucket and Feistel halves, window order
    kmers, valid = codec.extract_kmers(codes_t, k)
    km = codec.canonical(kmers, k)[valid]
    h1, l2 = feistel_mix_torch(codec.shr(km, 32), km & 0xFFFFFFFF, spec.seed)
    del kmers, km
    idx = valid.reshape(-1).nonzero().squeeze(1)
    bucket = l2 & ((1 << nb_bits) - 1)
    want = torch.zeros(R * P, dtype=torch.int32, device=dev)
    want[idx] = probe._match_labels(main_t, bucket, l2, h1, nb_bits, 0)
    n = int(idx.numel())

    def u32(t):
        return t.to(torch.int32).contiguous()

    b32, idx32, h1_32, l2_32 = u32(bucket), u32(idx), u32(h1), u32(l2)
    del valid, h1, l2
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr = lambda t: t.data_ptr()  # noqa: E731

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(args.timings):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(args.reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b) / args.reps)
        return ts

    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "reads": R, "P": P, "jobs": n,
              "distinct_rows": int(torch.unique(b32).numel()),
              "nb_bits": nb_bits, "timings": args.timings, "reps": args.reps,
              "cases": {}}
    print(f"{n} valid windows of [{R}, {L}] reads, "
          f"{result['distinct_rows']} distinct main rows of 2^{nb_bits}",
          flush=True)

    def record(name, ts, extra="", rows=n, row_bytes=32):
        med = statistics.median(ts)
        result["cases"][name] = {"median_ms": med, "ms": ts, "rows": rows}
        print(f"{name}: {med:.4f} ms (min {min(ts):.4f}, max {max(ts):.4f})"
              f", {rows / med / 1e6:.3f}G rows/s, "
              f"{row_bytes * rows / med / 1e6:.1f} GB/s useful{extra}",
              flush=True)
        return med

    most_slots = max((1 << (nb_bits - s)) * bin_capacity(R * P, s, nb_bits)
                     for s in args.bins)
    xor_out = torch.empty(max(n, most_slots) // 128 + 1025,
                          dtype=torch.int32, device=dev)

    def gather(b, pair=0):
        check(lib.gc_gather(ptr(main_t), ptr(b), n, pair, ptr(xor_out),
                            st()), "gc_gather")

    def checksum(b, pair=0):
        gather(b, pair)
        torch.cuda.synchronize()
        x = xor_out[:(n + 127) // 128].cpu().numpy().view(np.uint32)
        return int(np.bitwise_xor.reduce(x))

    orders = {"window": b32, "sorted": torch.sort(b32).values}
    for s in args.bins:
        order = torch.sort(b32 >> s, stable=True).indices
        orders[f"binned_{s}"] = b32[order]
    sums = {name: checksum(b) for name, b in orders.items()}
    if len(set(sums.values())) != 1:
        raise AssertionError(f"row checksums differ by order: {sums}")

    window_ms = record("window", timed(lambda: gather(b32)))
    record("pair64", timed(lambda: gather(b32, 1)))
    record("sorted", timed(lambda: gather(orders["sorted"])))
    binned = {}
    for s in args.bins:
        binned[s] = record(f"binned_{s}",
                           timed(lambda s=s: gather(orders[f"binned_{s}"])))

    consts = feistel_seed_consts(spec.seed)
    fixed, passes = {}, {}
    for s in args.bins:
        nbins = 1 << (nb_bits - s)
        counts = torch.empty(nbins + 1, dtype=torch.int32, device=dev)
        cursor = torch.empty(nbins, dtype=torch.int32, device=dev)
        jobs = torch.empty(n, dtype=torch.int32, device=dev)

        def radix():
            check(lib.gc_partition_radix(ptr(b32), ptr(idx32), n, s, nbins,
                                         ptr(counts), ptr(cursor), ptr(jobs),
                                         st()), "gc_partition_radix")
        radix()
        torch.cuda.synchronize()
        if not torch.equal(torch.sort(jobs).values, idx32):
            raise AssertionError(f"radix partition at s={s} lost or doubled "
                                 f"a job")
        bin_of = torch.zeros(R * P, dtype=torch.int32, device=dev)
        bin_of[idx] = b32 >> s
        bj = bin_of[jobs.long()]
        if not bool((bj[1:] >= bj[:-1]).all()):
            raise AssertionError(f"radix partition at s={s} is not by bin")
        record(f"radix_{s}", timed(radix))

        cap = bin_capacity(R * P, s, nb_bits)
        slots = nbins * cap
        fj = torch.empty((3, slots), dtype=torch.int32, device=dev)
        fo = torch.empty((3, n), dtype=torch.int32, device=dev)

        def part(keys):
            check(lib.gc_partition_fixed(
                ptr(b32), ptr(idx32), ptr(h1_32), ptr(l2_32), n, s, nbins,
                cap, ptr(counts), ptr(fj[0]), ptr(fj[1]), ptr(fj[2]),
                ptr(fo[0]), ptr(fo[1]), ptr(fo[2]), keys, st()),
                "gc_partition_fixed")
        labels = torch.zeros(R * P, dtype=torch.int32, device=dev)

        def gather_pass(keys):
            check(lib.gc_gather_jobs(
                ptr(p2), P, p2.shape[1], k, nb_bits, *consts, ptr(main_t),
                ptr(labels), ptr(counts), nbins, cap, ptr(fj[0]), ptr(fj[1]),
                ptr(fj[2]), ptr(fo[0]), ptr(fo[1]), ptr(fo[2]), keys, 1024,
                ptr(xor_out), st()), "gc_gather_jobs")
        for keys, name in ((0, "fixed"), (1, "fixed_keys")):
            part(keys)
            torch.cuda.synchronize()
            filled = torch.clamp(counts[:nbins], max=cap)
            n_ovf = int(counts[nbins])
            if int(filled.sum()) + n_ovf != n:
                raise AssertionError(f"{name} partition at s={s} holds "
                                     f"{int(filled.sum())} + {n_ovf} jobs "
                                     f"of {n}")
            labels.zero_()
            gather_pass(keys)
            torch.cuda.synchronize()
            if not torch.equal(labels, want):
                raise AssertionError(f"gather pass ({name}) at s={s} != "
                                     f"the main rows' labels")
            ms = record(f"{name}_{s}", timed(lambda keys=keys: part(keys)),
                        f"; cap {cap}, {n_ovf} jobs overflowed")
            if keys == 0:
                fixed[s] = ms
            passes[(s, keys)] = record(
                f"jobs_{'keys' if keys else 'wire'}_{s}",
                timed(lambda keys=keys: gather_pass(keys)))
        del fj, fo, labels, counts, cursor, jobs, bin_of, bj

    best = min(args.bins, key=lambda s: binned[s] + fixed[s])
    total = binned[best] + fixed[best]
    pays = total <= 2 / 3 * window_ms
    design = {s: min(passes[(s, 0)], passes[(s, 1)]) + fixed[s]
              for s in args.bins}
    result["decision"] = {
        "best_s": best, "binned_plus_binning_ms": total,
        "window_ms": window_ms, "ratio": total / window_ms,
        "binning_pays": pays,
        "gather_pass_plus_binning_ms": design}
    verdict = ("binning pays" if pays else "binning does not pay: the "
               "window-order gather is the ceiling")
    print(f"decision: binned at s={best} {binned[best]:.4f} + binning "
          f"{fixed[best]:.4f} = {total:.4f} ms, {total / window_ms:.1%} of "
          f"the window-order gather {window_ms:.4f} ms -> {verdict}; "
          f"gather pass + binning by s: "
          + ", ".join(f"{s}: {v:.4f}" for s, v in design.items()),
          flush=True)
    del main_t, b32, idx32, h1_32, l2_32, orders, want, xor_out
    for lay in ("q4", "s2"):
        ldb = dbs.pop(lay)
        lmain, _ = table_to_device(ldb, dev)
        choices = tm.choice_rows(codes_t, lmain, ldb.spec, k)
        rows0, rows1, has1, zero = choices
        lists = {"exact": tm.exact_rows(choices),
                 "both": tm.exact_rows((rows0, rows1, has1,
                                        torch.ones_like(zero)))}
        # s2 reads the low key words of a row (8 B at 2 slots), q4 32 B
        row_bytes = 32 if lay == "q4" else 4 * ldb.slots
        for name, rows in lists.items():
            rows = rows.to(torch.int32).contiguous()
            m = int(rows.numel())
            out = torch.empty(m // 128 + 1, dtype=torch.int32, device=dev)
            record(f"{lay}_{name}", timed(
                lambda rows=rows, m=m, out=out: check(lib.gc_gather_layout(
                    ptr(lmain), ptr(rows), m, 1 if lay == "q4" else 2,
                    ldb.slots, ptr(out), st()), "gc_gather_layout")),
                f"; {int((has1 & zero).sum())} second gathers of "
                f"{int(rows0.numel())} windows", m, row_bytes)
        del lmain, ldb, choices, rows0, rows1, has1, zero, lists
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps({"decision": result["decision"],
                      "median_ms": {c: v["median_ms"]
                                    for c, v in result["cases"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
