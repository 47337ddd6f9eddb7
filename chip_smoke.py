#!/usr/bin/env python3
"""Smoke test of cuclark_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from `cuclark_tpu_torch/csrc`, holds each
kernel against its plain PyTorch version on the card, reproduces the
golden example through the port's CLI, and classifies 131,072 simulated
150 bp reads against the repository's headline database shape (k=31,
64M target-specific k-mers, 16,384 targets, target load 0.85: a 1.107 GB
qs table) through `cuclark-tpu-torch classify --device cuda`, each path
against `--device cpu`:

  - resident: the table on the card (the fused query-and-score kernel
    for these one-tile reads, beside the query and score kernels, and
    the gather-only ceiling of the query's main-row gathers, alone and
    with the stash rows it reads, scripts/torch_gather_ceiling.py's
    kernel); the fused kernel also at
    the paired shape (65,536 joined pairs, three tiles a read), and on
    small tables at every width of two to eight tiles;
  - streamed: `--max-table-mb 600`, the table in 4 bucket-range parts of
    268 MB uploaded per group of batches (the range query kernel, the qs
    stash split over the parts, each batch's last part the fused range
    launch through the range kernel's queue, range_query_score_kernel,
    timed beside query_score_kernel over the same part, its bound and
    ceiling); the range kernel against plain on every part of 2, 4 and 8
    (q4 too; s2 in 8) and every db shard of 2 and 4, and one streamed
    group of `stream_group_eff` batches (the group a file streams in)
    taken apart: its wall time, the part uploads' time and the part
    calls' device time;
  - paired: 131,072 pairs of 150 bp mates from 400 bp fragments (-P),
    the fused query and score alone; the joined batch and the mate files
    also on the q4 and s2 tables (each CSV equal to the qs CSV);
  - extended: 1,024 reads with one count column per target, resident
    and streamed (--extended: the query and score kernels);
  - layouts: the same k-mers in a q4 table (1.074 GB) and an s2 table
    (2 slots, 2 hash choices: 1.611 GB), resident (the fused query and
    score of that layout) and streamed (4 and 8 parts at `--max-table-mb
    600`), each CSV equal to the qs CSV, and --extended (the layout's
    query and score kernels); the query kernel also on an all-miss batch,
    beside the gather-only ceiling of the rows an exact probe reads;
  - long_reads: 256 reads of 33,000 to 100,000 bases (the score
    kernel's `score_long` entry for rows over 32,768 windows);
  - classify_step: the 131,072 reads as unpacked codes through
    `pipeline.classify_step` (the query kernel's codes front half);
  - mesh: a 2 data x 2 db mesh of four handles of the one card, each db
    shard (a main range and a stash range) against plain; the sharded
    steps, each block ending in the fused range launch of the query and
    score (resident, and a streamed batch's last part; 150 bp reads and
    paired reads) or in the score kernel (with labels), against plain
    and the resident results; a
    1 x 1 mesh's step timed in turns with the resident fused step; the
    q4 and s2 tables' sharded steps on 2 db shards (shard 0's fused
    launch against plain and resident, timed beside query_score_kernel
    with its bound and ceiling); and
    `Classifier(db, mesh=...)` resident and streamed (each device's
    shard in 4 parts), and on the mate files, each CSV equal to the
    resident CSV;
  - multiprocess: two ranks of `classify --coordinator` over gloo on the
    card (each a 1 x 1 mesh: one fused launch a batch), then in the same
    two processes the host-spanning step (a db axis of 2 across them,
    half the table each, its labels all-reduced over gloo) on one
    batch, equal to the resident results; and two `--num-hosts 2` runs,
    each pair's CSVs concatenating to the resident CSV.
  - example_sh: examples/example.sh (build, golden CSV, accuracy loop,
    abundance) with `CUCLARK_TPU=cuclark-tpu-torch`;
  - accuracy: simulate-reads of 131,072 reads from the 16,384 genomes as
    FASTA files, classify on the card, evaluate with floors (recall >=
    0.95, precision >= 0.98), abundance -D and density, each timed;
  - clark_interop: export-clark --light and import-clark of the
    headline table (the same pairs; the imported table's CSV equal to
    the resident one), export-ht / import-ht and set-targets on the
    example genomes;
  - profile: classify --profile, the trace's kernel events against the
    launch counts, the card's busy share; then one more profiler session
    over the resident q4 and s2 runs (the fused kernel of each alone)
    and the kernels' durations against their launch rate;
  - bench: bench_torch.py in a subprocess at reduced knobs (BENCH_KNOBS),
    every block of bench.py, its exactness checks passing;
  - host_scan (first, before the tables): a seeded 1,048,576-read 150 bp
    FASTQ, its CRLF copy and a multi-line FASTA, each read as classify
    reads it and scanned by the one-thread scan_fastq/scan_fasta and by
    the parallel scan on the OpenMP team (equal offsets required), both
    times printed with the team and the host's cores;
  - host_pack (after host_format): 1,048,576 seeded 150 bp reads,
    1,048,576 pairs of 150 bp mates and a multi-line FASTA of 1,048,576
    sequences packed into the 2-bit wire format in classify's batches by
    the eight-bases-a-step pack and by its plain version, at team 1 and
    at every core (the new pack also at its default team): equal bytes
    required, every time, the host's copy rate, the team and the cores;
  - host_inflate (after host_pack): 1,048,576 seeded 150 bp reads with
    Illumina's binned qualities gzipped at level 6 as one member and as
    BGZF members, each mapped as classify maps it and inflated by the
    plain version (`GzipFile`) and by `native.inflate` on the OpenMP
    team: equal bytes required, both times, the native call's counters
    (chunks, joined, redone, bytes decoded with markers, members), the
    team and the cores;
  - file_to_csv also prints one more pass split by thread (the main,
    producer and writer threads' stages, waits and uncovered time;
    scripts/torch_thread_split.py), then one pass of a gzip copy of the
    reads split the same way: its CSV must be the plain reads' and its
    inflate native (`inflate` among the main thread's stages);
    classify_paired does the same with gzip copies of both mate files;
  - host_mate (after host_scan): 1,048,576 seeded pairs of 150 bp mates
    named `SRR1234567.<i>/1` and `/2`, and in Casava 1.8's style; the
    native mate-id check (team 1, every core, classify's dispatch)
    against its numpy plain version on equal ids and with a mismatch
    planted at record 0, n - 1 and a random record: the same index
    required, both times, the team and the cores;
  - host_format (after host_mate): 1,048,576 seeded result rows (ratios,
    -nan, -0, +-inf, ties at the sixth digit and their neighbours,
    doubles of every magnitude) through the CSV row writer and its
    snprintf plain version in classify's batches: equal bytes required,
    both times, the values handed to snprintf, the team and the cores;
    then the results entry (gamma and confidence computed by the
    writer) against `gamma_confidence` + the printf version on seeded
    results rows with reads of k - 2 to k + 1 bases, single and paired:
    equal bytes, both times;
  - classify_paired also prints one more paired pass split by thread
    (its head's `mate_check` among the main thread's stages).

Each phase prints one line; any failure raises and exits non-zero.  The
last three lines are the card's name and power limit, a JSON object of
the kernels, and `{"ok": true, "device": ...}`.

Without a CUDA device, or outside a checkout of the repository, it
prints no result and exits 2.  `--genomes` and `--reads` shrink the
real-size phase for a quick run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if str(ROOT / "scripts") not in sys.path:
    sys.path.insert(0, str(ROOT / "scripts"))
try:
    import torch_measure as tm  # the kernel rows' measures
except ImportError:  # not a checkout: main() says so
    tm = None
K = 31
READ_LEN = 150
FRAGMENT = 400             # paired: mate 1 = [0, 150), mate 2 = [250, 400)
GENOME_LEN = 3936          # 3,906 31-mers per genome: 64.0M for 16,384
SUB_RATE = 0.01
STREAM_MB = 600            # cuCLARK-l's "< 600 MB DB" budget: 4 parts
STREAM_PARTS = {"qs": 4, "q4": 4, "s2": 8}   # at STREAM_MB, full size
S2_SLOTS, S2_CHOICES = 2, 2
N_LONG, LONG_MIN, LONG_MAX = 256, 33_000, 100_000
HOST_SCAN_READS = 1 << 20
HOST_FORMAT_ROWS = 1 << 20
HOST_PACK_READS = 1 << 20
HOST_MATE_PAIRS = 1 << 20
HOST_INFLATE_READS = 1 << 20
PHRED = bytes(range(33, 75))  # '!'..'J': quality lines may open '@', '+'


def _phase(name: str, t0: float, detail: str) -> None:
    print(f"phase {name}: ok, {detail} ({time.time() - t0:.2f} s)",
          flush=True)


def range_calls(main_t, stash_t, n: int):
    """The calls of a pass over a resident table's main rows in n bucket
    ranges, [(main rows, stash rows or None, bucket_start, stash_start)],
    a qs stash split over them (`probe.stash_range`): the parts of a table
    that one device streams in n parts, and the db shards of a mesh of
    n."""
    from cuclark_tpu_torch import probe

    rows = main_t.shape[0] // n
    calls = []
    for j in range(n):
        s, sstart = probe.stash_range(stash_t, j, n)
        calls.append((main_t[j * rows:(j + 1) * rows], s, j * rows, sstart))
    return calls


def later_hits(p2, vb, calls, k: int, spec) -> int:
    """The windows that the calls after the first of a pass (range_calls)
    answer, summed: what their accumulator reads and writes (the plain
    range query's labels)."""
    from cuclark_tpu_torch import probe

    return sum(int((probe.query_part_labels_plain(
        p2, vb, m, s, bucket_start=start, nb_local=m.shape[0], k=k,
        spec=spec, stash_start=sstart) != 0).sum())
        for m, s, start, sstart in calls[1:])


def _planted_reads(rng, km: np.ndarray, k: int, R: int, L: int):
    """Random reads with stored k-mers planted on the forward strand in
    every other read, 1% Ns, and one read padded with Ns past half."""
    from cuclark_tpu_torch import codec

    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            v = km[rng.integers(len(km))]
            codes[r, p:p + k] = (v >> shifts) & np.uint64(3)
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[1, L // 2:] = codec.INVALID
    return codec.pack_codes(codes)


def check_small_query(dev, k: int) -> int:
    """Query kernel vs plain on a small qs table with stash entries, and
    the fused query and score on the same reads."""
    import torch

    from cuclark_tpu_torch import codec, hashdb, probe
    from cuclark_tpu_torch.config import DBConfig

    rng = np.random.default_rng(k)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=310_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))
    km = km[:300_000]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=k), nb_bits=17)
    p2, vb = (torch.from_numpy(a).to(dev)
              for a in _planted_reads(rng, km, k, 1024, 152))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec)
    got = probe.query_labels(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    want = probe.query_labels_plain(p2, vb, main, stash, **args)
    from_stash = probe.query_labels_plain(p2, vb, torch.zeros_like(main),
                                          stash, **args)
    if not torch.equal(got, want):
        raise AssertionError(f"query kernel != plain at k={k}: "
                             f"{int((got != want).sum())} windows differ")
    n_hit, n_stash = int((want > 0).sum()), int((from_stash > 0).sum())
    if n_hit < 1024 or n_stash == 0:
        raise AssertionError(f"too few hits to check k={k}: {n_hit} "
                             f"windows, {n_stash} from the stash")
    res = probe.query_score_results(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    res_plain = probe.query_score_results_plain(p2, vb, main, stash, **args)
    if not torch.equal(res, res_plain):
        raise AssertionError(f"fused query and score != plain at k={k}")
    err = {"query": tm.max_abs_err(got, want),
           "query_score": tm.max_abs_err(res, res_plain),
           "build_sharded_classify": check_stash_ranges(p2, vb, main, stash,
                                                        got, **args),
           "classify_step": check_codes(p2, vb, main, stash, got, **args),
           "query_score_part": check_fused_range(p2, vb, main, stash,
                                                 **args)}
    print(f"  k={k}: {got.numel()} windows bit-identical, {n_hit} hits, "
          f"{n_stash} from the stash; the fused query and score, resident "
          f"and over parts and db shards with acc_in, 2 and 4 db shards "
          f"with stash ranges and the codes front half bit-identical",
          flush=True)
    return err


def check_stash_ranges(p2, vb, main, stash, resident, *, k, spec) -> int:
    """The range query kernel on each db shard of a qs table, 2 and 4
    shards (a main range and a stash range) against plain; with the main
    rows zeroed every shard must answer hits from its stash range alone,
    and the shards must add up to the resident labels."""
    import torch

    from cuclark_tpu_torch import probe

    zero = torch.zeros_like(main)
    err = 0
    for num_db in (2, 4):
        nbl, nbsl = main.shape[0] // num_db, stash.shape[0] // num_db
        total = None
        for j in range(num_db):
            args = dict(bucket_start=j * nbl, nb_local=nbl, k=k, spec=spec,
                        stash_start=j * nbsl)
            s_j, m_j = stash[j * nbsl:(j + 1) * nbsl], main[j * nbl:(j + 1)
                                                             * nbl]
            only = probe.query_part_labels(p2, vb, zero[:nbl], s_j, **args)
            got = probe.query_part_labels(p2, vb, m_j, s_j, **args)
            torch.cuda.synchronize()
            for a, m in ((only, zero[:nbl]), (got, m_j)):
                want = probe.query_part_labels_plain(p2, vb, m, s_j, **args)
                if not torch.equal(a, want):
                    raise AssertionError(f"range kernel != plain on shard "
                                         f"{j} of {num_db} at k={k}")
                err = max(err, tm.max_abs_err(a, want))
            if int((only > 0).sum()) == 0:
                raise AssertionError(f"no hit from the stash range of shard "
                                     f"{j} of {num_db} at k={k}")
            total = got if total is None else total + got
        if not torch.equal(total, resident):
            raise AssertionError(f"{num_db} db shards != resident at k={k}")
    return err


def fused_range_key(spec, nb_local: int, P: int) -> str:
    """The launch key of a fused range launch of reads of P windows over
    nb_local main rows (`kernels.queue_score_windows`): the queued launch,
    query_score_queue[_q4|_s2], or query_score_part[_q4|_s2]."""
    from cuclark_tpu_torch import kernels

    base = ("query_score_queue" if kernels.queue_score_windows(
        spec.nb_bits, nb_local, spec.layout, P) > 1 else "query_score_part")
    return base if spec.layout == "qs" else f"{base}_{spec.layout}"


def check_fused_range(p2, vb, main, stash, *, k, spec) -> int:
    """The fused range entry (`probe.query_score_part_results`, the last
    launch of a mesh block or of a streamed batch: the queued launch
    where the route takes it) against its plain version: each of 4 parts
    and each of 2 db shards (`range_calls`: a qs stash split over them),
    acc_in None or random labels on half the windows
    the range misses (a key lives in one range, so the other launches
    give 0 where it hits), each call one launch under the route's key;
    the queued launch (`kernels.query_score_queue`) at W 2 and 4 on the
    same calls; then 3 parts accumulated by the range kernel and the
    last one fused with their sum give the resident fused results."""
    import torch

    from cuclark_tpu_torch import kernels, probe

    rng = np.random.default_rng(spec.nb_bits + k)
    R, P = p2.shape[0], 4 * p2.shape[1] - k + 1
    a = rng.integers(1, 65536, size=(R, P)).astype(np.int32)
    a[rng.random(a.shape) < 0.5] = 0
    rand = torch.from_numpy(a).to(p2.device)
    err = 0
    for m, s, start, sstart in (range_calls(main, stash, 4)
                                + range_calls(main, stash, 2)):
        args = dict(bucket_start=start, nb_local=m.shape[0], k=k, spec=spec,
                    stash_start=sstart)
        own = probe.query_part_labels_plain(p2, vb, m, s, **args)
        missed = torch.where(own > 0, 0, rand)
        key = fused_range_key(spec, m.shape[0], P)
        for acc_in in (None, missed):
            before = dict(kernels.LAUNCHES)
            got = probe.query_score_part_results(p2, vb, m, s, **args,
                                                 acc_in=acc_in)
            torch.cuda.synchronize()
            want = probe.query_score_part_results_plain(p2, vb, m, s, **args,
                                                        acc_in=acc_in)
            if (not torch.equal(got, want)
                    or kernels.LAUNCHES[key] != before[key] + 1
                    or sum(kernels.LAUNCHES.values())
                    != sum(before.values()) + 1):
                raise AssertionError(f"{spec.layout} fused range entry != "
                                     f"plain on rows [{start}, "
                                     f"{start + m.shape[0]}) at k={k}")
            err = max(err, tm.max_abs_err(got, want))
            qargs = dict(args, acc_in=acc_in)
            del qargs["nb_local"]
            for W in (2, 4):
                got = kernels.query_score_queue(p2, vb, m, s, windows=W,
                                                **qargs)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{spec.layout} queued fused range "
                                         f"launch at W {W} != plain on rows "
                                         f"[{start}, {start + m.shape[0]}) "
                                         f"at k={k}, P={P}")
        if not torch.equal(missed, torch.where(own > 0, 0, rand)):
            raise AssertionError("the fused range entry wrote its acc_in")
    acc = None
    for j, (m, s, start, sstart) in enumerate(range_calls(main, stash, 4)):
        args = dict(bucket_start=start, nb_local=m.shape[0], k=k, spec=spec,
                    stash_start=sstart)
        if j < 3:
            acc = probe.query_part_labels(p2, vb, m, s, acc=acc, **args)
        else:
            last = probe.query_score_part_results(p2, vb, m, s, acc_in=acc,
                                                  **args)
    resident = probe.query_score_results(p2, vb, main, stash, k=k, spec=spec)
    torch.cuda.synchronize()
    if not torch.equal(last, resident):
        raise AssertionError(f"{spec.layout} parts ending in the fused range "
                             f"entry != resident at k={k}")
    return err


def check_codes(p2, vb, main, stash, wire_labels, *, k, spec) -> int:
    """The query kernel's codes front half on the unpacked batch (one
    byte set to 200, an N) against plain, and against the wire labels."""
    import torch

    from cuclark_tpu_torch import codec, probe

    codes = codec.unpack_codes(p2, vb).to(torch.uint8)
    got = probe.query_codes_labels(codes, main, stash, k=k, spec=spec)
    torch.cuda.synchronize()
    if not torch.equal(got, wire_labels):
        raise AssertionError(f"{spec.layout} codes kernel != wire kernel at "
                             f"k={k}")
    codes[5, 17] = 200
    got = probe.query_codes_labels(codes, main, stash, k=k, spec=spec)
    torch.cuda.synchronize()
    want = probe.query_codes_labels_plain(codes, main, stash, k=k, spec=spec)
    if not torch.equal(got, want):
        raise AssertionError(f"{spec.layout} codes kernel != plain at k={k}")
    return tm.max_abs_err(got, want)


def check_small_layout(dev, layout: str, k: int) -> dict:
    """The q4 or s2 query kernel vs plain on a small table, resident and
    on 4 bucket-range parts written and accumulated, and the fused query
    and score vs plain, on the full table and on one with hits from the
    second hash choice alone.  Returns max_abs_err per launch name."""
    import torch

    from cuclark_tpu_torch import codec, hashdb, probe
    from cuclark_tpu_torch.config import DBConfig

    rng = np.random.default_rng(100 + k)
    n, nb_bits = (300_000, 17) if layout == "q4" else (90_000, 16)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=n + 10_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))[:n]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(
        k=k, layout=layout, slots=S2_SLOTS, num_choices=S2_CHOICES),
        nb_bits=nb_bits)
    p2, vb = (torch.from_numpy(a).to(dev)
              for a in _planted_reads(rng, km, k, 1024, 152))
    fused = f"query_score_{layout}"
    err = {f"query_{layout}": 0, f"query_part_{layout}": 0, fused: 0}
    n_second = 0
    for table in (db.table, db.second_choice_only()):
        main = torch.from_numpy(table.view(np.int32)).to(dev)
        got = probe.query_labels(p2, vb, main, None, k=k, spec=db.spec)
        torch.cuda.synchronize()
        want = probe.query_labels_plain(p2, vb, main, None, k=k,
                                        spec=db.spec)
        if not torch.equal(got, want):
            raise AssertionError(f"{layout} query kernel != plain at k={k}")
        err[f"query_{layout}"] = max(err[f"query_{layout}"],
                                     tm.max_abs_err(got, want))
        res = probe.query_score_results(p2, vb, main, None, k=k,
                                        spec=db.spec)
        torch.cuda.synchronize()
        res_plain = probe.query_score_results_plain(p2, vb, main, None, k=k,
                                                    spec=db.spec)
        if not torch.equal(res, res_plain):
            raise AssertionError(f"fused {layout} query and score != plain "
                                 f"at k={k}")
        err[fused] = max(err[fused], tm.max_abs_err(res, res_plain))
        err["classify_step"] = max(err.get("classify_step", 0), check_codes(
            p2, vb, main, None, got, k=k, spec=db.spec))
        err["query_score_part"] = max(
            err.get("query_score_part", 0),
            check_fused_range(p2, vb, main, None, k=k, spec=db.spec))
        rows = db.nb // 4
        acc = acc_plain = None
        for p in range(4):
            part = main[p * rows:(p + 1) * rows]
            args = dict(bucket_start=p * rows, nb_local=rows, k=k,
                        spec=db.spec)
            one = probe.query_part_labels(p2, vb, part, None, **args)
            acc = probe.query_part_labels(p2, vb, part, None, acc=acc,
                                          **args)
            torch.cuda.synchronize()
            one_plain = probe.query_part_labels_plain(p2, vb, part, None,
                                                      **args)
            acc_plain = probe.query_part_labels_plain(
                p2, vb, part, None, acc=acc_plain, **args)
            if not (torch.equal(one, one_plain)
                    and torch.equal(acc, acc_plain)):
                raise AssertionError(f"{layout} part kernel != plain at "
                                     f"k={k} on part {p}")
            err[f"query_part_{layout}"] = max(
                err[f"query_part_{layout}"], tm.max_abs_err(one, one_plain),
                tm.max_abs_err(acc, acc_plain))
        if not torch.equal(acc, got):
            raise AssertionError(f"{layout} parts != resident at k={k}")
        n_second = int((want > 0).sum())
    if n_second == 0:
        raise AssertionError(f"no {layout} hit from the second hash choice "
                             f"alone at k={k}")
    print(f"  {layout} k={k}: {got.numel()} windows bit-identical resident, "
          f"in 4 parts, from codes and fused with the score (resident and "
          f"over parts and db shards with acc_in), {n_second} hits from "
          f"the second choice alone", flush=True)
    return err


# (k, read length): the fused kernel's widths past one tile, P = L - k + 1
# (L a multiple of 8): the 160, 192, 256, 320, 512 and 1024 bins at k 27
# and 31 (P 130 to 998; 290 the joined pairs at k 31), then P 129, 256 and
# 1,024 (the first width past one tile, two tiles full, the widest)
FUSED_WIDTHS = [(k, L) for k in (27, 31)
                for L in (160, 192, 256, 320, 512, 1024)] + [
    (32, 160), (25, 280), (25, 1048)]


def check_fused_widths(dev) -> int:
    """The fused query and score on reads of two to eight tiles against its
    plain version and against the query then score kernels, on a small qs
    (with stash entries), q4 and s2 table at each k of FUSED_WIDTHS:
    resident, then in range mode (check_fused_range: 4 parts and 2 db
    shards, acc_in None or random labels on the windows each range
    misses, and 3 parts accumulated ending in the fused range launch ==
    resident).  Returns the largest error."""
    import torch

    from cuclark_tpu_torch import codec, hashdb, probe, score
    from cuclark_tpu_torch.config import DBConfig

    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    err, checked = 0, 0
    for k in sorted({k for k, _ in FUSED_WIDTHS}):
        rng = np.random.default_rng(500 + k)
        for layout, n, nb_bits in (("qs", 300_000, 17), ("q4", 300_000, 17),
                                   ("s2", 90_000, 16)):
            km = rng.integers(0, np.iinfo(np.uint64).max, size=n + 10_000,
                              dtype=np.uint64, endpoint=True)
            km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k),
                                              k))[:n]
            labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
            db = hashdb.build_table(km, labels, names, DBConfig(
                k=k, layout=layout, slots=S2_SLOTS, num_choices=S2_CHOICES),
                nb_bits=nb_bits)
            main, stash = hashdb.table_to_device(db, dev)
            args = dict(k=k, spec=db.spec)
            for _, L in (c for c in FUSED_WIDTHS if c[0] == k):
                p2, vb = (torch.from_numpy(a).to(dev)
                          for a in _planted_reads(rng, km, k, 256, L))
                got = probe.query_score_results(p2, vb, main, stash, **args)
                torch.cuda.synchronize()
                want = probe.query_score_results_plain(p2, vb, main, stash,
                                                       **args)
                two = score.score_labels(probe.query_labels(
                    p2, vb, main, stash, **args))
                torch.cuda.synchronize()
                P = 4 * p2.shape[1] - k + 1
                if not (torch.equal(got, want) and torch.equal(got, two)):
                    raise AssertionError(f"fused {layout} query and score != "
                                         f"plain or != query then score at "
                                         f"P={P}, k={k}")
                if int((want[:, 2] > 0).sum()) < 64:
                    raise AssertionError(f"too few hits to check {layout} at "
                                         f"P={P}, k={k}")
                err = max(err, tm.max_abs_err(got, want),
                          check_fused_range(p2, vb, main, stash, **args))
                checked += 1
    print(f"  fused query and score at {checked} (layout, width) pairs of "
          f"2 to 8 tiles (P 129 to 1,024): resident, and over parts and db "
          f"shards with acc_in, bit-identical", flush=True)
    return err


def check_score(dev, R: int, P: int, seed: int) -> int:
    """Score kernel vs plain on random labels with ties and empty rows,
    and, where R allows, rows across both label ranges of the histogram
    path (random labels over 1..65,535, a tie between a label below
    32,768 and one above, the best above with the second below, 65,535
    the best) and rows of 6 to 40 distinct labels (the warp path's rounds
    and its sort)."""
    import torch

    from cuclark_tpu_torch import score

    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 6, size=(R, P)).astype(np.int32)
    lab[rng.random((R, P)) < 0.3] = 0
    lab[0] = 0                                        # all miss
    if P >= 2:
        lab[1, :P // 2], lab[1, P // 2:] = 9, 2       # tie when P is even
    lab[2 % R] = 65535
    q = P // 4
    ranges = np.zeros((4, P), np.int32)
    ranges[0] = rng.integers(1, 65536, size=P)
    ranges[1, :q], ranges[1, q:2 * q] = 40000, 1234   # tie: 1234 wins
    ranges[2, :2 * q], ranges[2, 2 * q:3 * q] = 50000, 77
    ranges[3, :2 * q], ranges[3, 2 * q:] = 65535, 32768
    n = max(0, min(4, R - 3))
    lab[3:3 + n] = ranges[:n]
    for r in range(7, min(R, 64)):                    # 6 to 40 labels
        lab[r] = rng.integers(0, 6 + r % 35, size=P) * 37
    t = torch.from_numpy(lab).to(dev)
    got = score.score_labels(t)
    torch.cuda.synchronize()
    want = score.score_labels_plain(t)
    if not torch.equal(got, want):
        raise AssertionError(f"score kernel != plain at [{R}, {P}]")
    print(f"  score [{R}, {P}]: bit-identical", flush=True)
    return tm.max_abs_err(got, want)


def check_host_scan(tmp: Path, n: int = HOST_SCAN_READS) -> str:
    """The record scan of classify's input: a seeded n-read 150 bp FASTQ
    (Phred quality bytes), its CRLF copy and a multi-line FASTA of n
    sequences, each written, read back as classify reads it
    (`pipeline._read_file_bytes`) and scanned by the one-thread entry
    and the parallel scan, whose offsets must be equal; both times (min
    of 3, in turns), the team and the host's cores."""
    import torch_host_scan as hs
    from cuclark_tpu_torch.pipeline import _read_file_bytes

    fq = hs.fastq_bytes(n, 11, READ_LEN, PHRED)
    inputs = (("fastq", lambda: fq, False),
              ("fastq_crlf", lambda: fq.replace(b"\n", b"\r\n"), False),
              ("fasta", lambda: hs.fasta_bytes(n, 12, READ_LEN), True))
    out = []
    for name, data, fasta in inputs:
        path = tmp / f"host_scan_{name}"
        path.write_bytes(data())
        buf = _read_file_bytes(path)
        recs, serial_ms, par_ms, team = hs.scan_serial_vs_parallel(buf,
                                                                    fasta)
        if recs != n:
            raise AssertionError(f"{name}: {recs} records of {n}")
        out.append(f"{name} {recs} records, {len(buf)} bytes: serial "
                   f"{serial_ms:.3f} ms, parallel {par_ms:.3f} ms "
                   f"({serial_ms / par_ms:.2f}x)")
        del buf
        path.unlink()
    return (f"{'; '.join(out)}; parallel == serial offsets; team {team}, "
            f"{len(os.sched_getaffinity(0))} host cores")


def check_host_mate(n: int = HOST_MATE_PAIRS) -> str:
    """The mate-id check of paired classify's head: n seeded pairs of
    150 bp mates in each name style of `scripts/torch_host_scan.py`
    (`SRR1234567.<i>/1` and `/2`; Casava 1.8, whose ids the scan's cut
    at the space leaves equal), checked by the plain version
    (`fast_parse.first_mate_mismatch_plain`), by the native check at
    team 1, at every core and through classify's dispatch, on equal ids
    and with a mismatch planted at record 0, n - 1 and a random record:
    every version must give the same index (a hard failure); the plain
    and the native times (min of 3, in turns), the team and the host's
    cores."""
    import torch_host_scan as hs
    from cuclark_tpu_torch import native
    from cuclark_tpu_torch.io import fast_parse

    cores = len(os.sched_getaffinity(0))
    out = []
    for style in hs.MATE_STYLES:
        mates = hs.mate_buffers(n, style)
        args = (mates[0], mates[1], mates[2], mates[3], mates[4], mates[5])
        planted = hs.planted_mates(mates, n, sorted({1, cores}))
        if fast_parse.first_mate_mismatch(*args) != -1:
            raise AssertionError(f"{style}: classify's check found a "
                                 f"mismatch in equal ids")
        t = hs.times_ms({
            "plain": lambda: fast_parse.first_mate_mismatch_plain(*args),
            "native": lambda: native.first_mate_mismatch(*args)}, 3)
        out.append(f"{style} {n} pairs: plain {min(t['plain']):.3f} ms, "
                   f"native {min(t['native']):.4f} ms "
                   f"({min(t['plain']) / min(t['native']):.1f}x); planted "
                   + ", ".join(f"{case} {v['at']}" for case, v in
                               planted.items()))
        del mates, args
    return (f"{'; '.join(out)}; native == plain at every case; team "
            f"{native.mate_team(n)}, {cores} host cores")


def check_host_inflate(tmp: Path, n: int = HOST_INFLATE_READS) -> str:
    """A gzip classify input inflated on the OpenMP team: n seeded 150 bp
    reads with Illumina's binned qualities (`scripts/torch_host_scan.py`
    `binned_fastq`) gzipped at level 6 as one member (as `gzip` writes
    it) and as BGZF members (as bgzip writes them), each mapped as
    classify maps it and inflated by the plain version
    (`pipeline._inflate_plain`) and by `native.inflate`: equal bytes
    required (a hard failure); both times (min of 3, in turns), the
    native call's counters, the team and the host's cores."""
    import torch_host_scan as hs
    from cuclark_tpu_torch import native, pipeline

    fq = tmp / "host_inflate.fq"
    fq.write_bytes(hs.binned_fastq(n))
    size = fq.stat().st_size
    files = hs.gzip_files(fq, levels=(6,), kinds=("member", "bgzfs"))
    fq.unlink()
    out = []
    for name, label in (("l6_member", "one member"),
                        ("l6_bgzfs", "BGZF members")):
        buf = np.memmap(files[name], np.uint8, mode="r")
        want = pipeline._inflate_plain(buf)
        got = native.inflate(buf)
        if len(want) != size or got.tobytes() != want:
            raise AssertionError(f"host_inflate {name}: the native bytes "
                                 f"differ from the plain version's")
        counters = native.inflate_counters()
        del got, want
        t = hs.times_ms({"plain": lambda: pipeline._inflate_plain(buf),
                         "native": lambda: native.inflate(buf)}, 3)
        p, q = min(t["plain"]), min(t["native"])
        out.append(f"{label} (level 6) {len(buf)} B: plain {p:.1f} ms, "
                   f"native {q:.1f} ms ({p / q:.2f}x), counters "
                   f"{counters}")
        del buf
        files[name].unlink()
    return (f"fastq {n} reads, {size} bytes; {'; '.join(out)}; equal "
            f"bytes; team {native.inflate_team(1 << 30)}, "
            f"{len(os.sched_getaffinity(0))} host cores")


def gzip_copy(path: Path) -> Path:
    """A level-6 one-member gzip copy of `path` beside it."""
    import gzip

    gz = path.with_name(path.name + ".gz")
    gz.write_bytes(gzip.compress(path.read_bytes(), 6, mtime=0))
    return gz


def gzip_pass_split(clf, label: str, csv: Path, want: Path, batches: int,
                    path: Path, paired: Path | None = None) -> None:
    """One `classify_file_to_csv` pass of gzip copies of the inputs,
    split by thread: the CSV must be the plain inputs' and the inflate
    native (its stage in the main thread's split)."""
    import torch

    from cuclark_tpu_torch import native
    from torch_thread_split import ThreadSplit, summary

    gz = gzip_copy(path)
    gz2 = gzip_copy(paired) if paired is not None else None
    with ThreadSplit() as split:
        clf.classify_file_to_csv(gz, csv, gz2)
        torch.cuda.synchronize()
    report = split.report(batches)
    print(f"  {label} gzip " + summary(report), flush=True)
    if csv.read_bytes() != want.read_bytes():
        raise AssertionError(f"{label}: the gzip inputs' CSV differs from "
                             f"the plain inputs'")
    calls = report["threads"]["MainThread"]["stages"].get("inflate", {})
    if calls.get("calls") != (2 if paired is not None else 1) or \
            native.inflate_counters()["members"] != 1:
        raise AssertionError(f"{label}: the gzip pass did not inflate "
                             f"natively: {calls}")


def host_format_fields(n: int, seed: int = 13):
    """n seeded result rows whose gamma and confidence hold what the row
    writer must print as glibc's %g does: ratios t/d (d up to 2,048),
    0/0 (-nan on x86), -0, +-inf, exact ties at the sixth significant
    digit (123456.5, 12345.25, ... 999999.5) and their neighbours,
    neighbours of 1e-4, 1e-5 and 9.999995e-5, and doubles of every
    magnitude (subnormals too); names of 1-60 bytes (cut at 39), target
    names of 0-24 bytes, norms up to 2^40.  The fields
    `native.format_rows` takes."""
    from cuclark_tpu_torch import native

    rng = np.random.default_rng(seed)
    d = rng.integers(1, 2049, n)
    ratio = rng.integers(0, d + 1) / d
    with np.errstate(divide="ignore", invalid="ignore"):
        special = np.array([0.0, -0.0, np.inf, -np.inf,
                            np.float64(0) / np.float64(0), -0.0 / 1.0])
    ties = np.array([123456.5, 12345.25, 1234.125, 123.0625, 12.03125,
                     1.015625, 999999.5, 999998.5, 100000.5, 9999995.0,
                     1234565.0, 0.5, 1e-4, 1e-5, 9.999995e-5, 1e6])
    near = np.concatenate([np.nextafter(ties, np.inf),
                           np.nextafter(ties, -np.inf), ties, -ties])
    bits = rng.integers(0, 1 << 63, n, dtype=np.int64).astype(np.uint64)
    anyd = (bits | (rng.integers(0, 2, n).astype(np.uint64) << 63)).view(
        np.float64)
    pool = np.concatenate([special, near])

    def column():
        kind = rng.integers(0, 8, n)
        v = ratio.copy()
        v[kind == 5] = pool[rng.integers(0, len(pool), (kind == 5).sum())]
        v[kind == 6] = anyd[kind == 6]
        v[kind == 7] = (ratio * 10.0 ** rng.integers(-8, 9, n))[kind == 7]
        return v

    names = [b"r%d" % i + b"x" * int(rng.integers(0, 58)) for i in
             range(n)]
    buf = np.frombuffer(b"".join(names), np.uint8)
    ne = np.cumsum([len(x) for x in names], dtype=np.int64)
    ns = ne - np.array([len(x) for x in names], np.int64)
    tnb, tno = native.pack_target_names(
        ["NA", ""] + ["T" * int(rng.integers(1, 25)) for _ in range(62)])
    return (rng.integers(0, 1 << 40, n), column(),
            rng.integers(0, 64, n).astype(np.int32),
            rng.integers(0, 1 << 31, n).astype(np.int32),
            rng.integers(0, 64, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32), column(),
            buf, ns, ne, tnb, tno)


def check_host_format(n: int = HOST_FORMAT_ROWS,
                      chunk: int = 16384) -> str:
    """The CSV row writer against its printf plain version: n seeded
    rows (`host_format_fields`) formatted in chunks of `chunk` rows (a
    classify batch) by `native.format_rows` and by
    `native.format_rows_printf` must give equal bytes; both times (min
    of 3, in turns), the values the writer handed to snprintf, the team
    and the host's cores."""
    import torch_host_scan as hs
    from cuclark_tpu_torch import native

    fields = host_format_fields(n)
    new = hs.format_chunks(native.format_rows, fields, chunk)
    plain = hs.format_chunks(native.format_rows_printf, fields, chunk)
    got = b"".join(a.tobytes() for a in new)
    if got != b"".join(a.tobytes() for a in plain):
        raise AssertionError("format_rows != format_rows_printf")
    handed = sum(c for _, c in (native.format_rows(
        *(f[i:i + chunk] for f in fields[:7]), fields[7],
        fields[8][i:i + chunk], fields[9][i:i + chunk], *fields[10:])
        for i in range(0, n, chunk)))
    t = hs.times_ms({
        "printf": lambda: hs.format_chunks(native.format_rows_printf,
                                           fields, chunk),
        "writer": lambda: hs.format_chunks(native.format_rows, fields,
                                           chunk)}, 3)
    nan_rows = got.count(b",-nan,") + got.count(b",-nan\n")
    res = check_host_results(fields, chunk)
    return (f"{n} rows, {len(got)} bytes ({nan_rows} -nan fields): "
            f"printf {min(t['printf']):.3f} ms, writer "
            f"{min(t['writer']):.3f} ms "
            f"({min(t['printf']) / min(t['writer']):.2f}x), equal bytes; "
            f"{handed} values handed to snprintf; {res}; team "
            f"{native.format_team(chunk)}, "
            f"{len(os.sched_getaffinity(0))} host cores")


def host_results(fields, seed: int = 19):
    """Seeded results rows for the names of `host_format_fields`: totals
    up to 65,535 (0 for most reads of k bases or fewer), best + second = 0 in
    a seventh of the rows, lengths k - 2 to k + 1 beside 150 (gamma -0,
    -nan, +-inf): the inputs of `torch_host_scan.results_chunks`."""
    buf, ns, ne, tnb, tno = fields[7:]
    n = len(ns)
    rng = np.random.default_rng(seed)
    short = K + np.arange(-2, 2)
    lengths = np.where(rng.random(n) < 0.3,
                       short[rng.integers(0, len(short), n)],
                       READ_LEN).astype(np.int64)
    total = rng.integers(0, 65536, n)
    total[(lengths <= K) & (rng.random(n) < 0.9)] = 0  # paired: norm < k
    best = rng.integers(0, total + 1)
    second = rng.integers(0, total - best + 1)
    zero = rng.random(n) < 1 / 7
    best[zero] = second[zero] = 0
    nt = len(tno) - 1
    results = np.stack([total, rng.integers(0, nt, n), best,
                        rng.integers(0, nt, n), second], 1).astype(np.int32)
    return results, lengths, K, buf, ns, ne, tnb, tno


def printf_results(results, lengths, k, paired, buf, ns, ne, tnb, tno):
    """The plain version of `native.format_results`: numpy's
    `gamma_confidence`, then the printf formatter (a tuple, as the
    writer returns)."""
    from cuclark_tpu_torch import native, score

    total, ibest, best, isecond, second = (results[:, i] for i in range(5))
    norm, gamma, conf = score.gamma_confidence(total, best, second, lengths,
                                               k, paired)
    return native.format_rows_printf(norm, gamma, ibest, best, isecond,
                                     second, conf, buf, ns, ne, tnb,
                                     tno), 0


def check_host_results(fields, chunk: int) -> str:
    """The results entry (`native.format_results`: gamma and confidence
    computed by the row writer) against `gamma_confidence` +
    `format_rows_printf` on `host_results` rows, single and paired, in
    chunks of `chunk`: equal bytes required; both times (min of 3, in
    turns)."""
    import torch_host_scan as hs
    from cuclark_tpu_torch import native

    inputs = host_results(fields)
    for paired in (False, True):
        got = b"".join(a.tobytes() for a in hs.results_chunks(
            native.format_results, inputs, chunk, paired))
        want = b"".join(a.tobytes() for a in hs.results_chunks(
            printf_results, inputs, chunk, paired))
        if got != want:
            raise AssertionError(f"format_results != gamma_confidence + "
                                 f"format_rows_printf (paired {paired})")
        for field in (b",-nan,", b",-0,"):
            if field not in got:
                raise AssertionError(f"no {field!r} gamma in the results "
                                     f"rows")
    t = hs.times_ms({
        "plain": lambda: hs.results_chunks(printf_results, inputs, chunk),
        "results": lambda: hs.results_chunks(native.format_results, inputs,
                                             chunk)}, 3)
    return (f"results entry on {len(inputs[0])} rows (lengths k - 2 to "
            f"k + 1 and {READ_LEN}), single and paired: gamma_confidence + "
            f"printf {min(t['plain']):.3f} ms, results entry "
            f"{min(t['results']):.3f} ms "
            f"({min(t['plain']) / min(t['results']):.2f}x), equal bytes")


def check_host_pack(tmp: Path, n: int = HOST_PACK_READS,
                    chunk: int = 16384) -> str:
    """The 2-bit wire pack against its plain version: n seeded 150 bp
    reads (Phred quality bytes), n pairs of 150 bp mates (two such
    files, packed as classify joins them, bin 320) and a multi-line
    FASTA of n sequences, each read as classify reads it and packed in
    classify's batches of `chunk` by `native.pack_block2` /
    `pack_block2_paired` and by their plain versions at team 1 and at
    every core, at every team asked (1, every core, the default):
    equal bytes required; every time (min of 3, in turns; the new pack
    also at its default team, half the cores), the host's copy rate,
    the team and the cores."""
    import torch_host_scan as hs
    from cuclark_tpu_torch import native
    from cuclark_tpu_torch.pipeline import _read_file_bytes

    def read(name, data):
        path = tmp / f"host_pack_{name}"
        path.write_bytes(data)
        return path, _read_file_bytes(path)

    cores = len(os.sched_getaffinity(0))
    r1, b1 = read("r1.fq", hs.fastq_bytes(n, 21, READ_LEN, PHRED))
    r2, b2 = read("r2.fq", hs.fastq_bytes(n, 22, READ_LEN, PHRED))
    fa, bf = read("fa", hs.fasta_bytes(n, 23, READ_LEN))
    _, _, s1, e1 = native.scan(b1)
    _, _, s2, e2 = native.scan(b2)
    _, _, sf, ef = native.scan(bf)
    if not len(s1) == len(s2) == len(sf) == n:
        raise AssertionError(f"host_pack: {len(s1)}, {len(s2)}, {len(sf)} "
                             f"records of {n}")

    def batches(fn, args, L, **kw):
        return [fn(*(a if isinstance(a, np.ndarray) and a.dtype == np.uint8
                     else a[i:i + chunk] for a in args), L,
                   n_rows=min(chunk, n - i), **kw)
                for i in range(0, n, chunk)]

    cases = (("fastq", native.pack_block2, native.pack_block2_plain,
              (b1, s1, e1), 152),
             ("pairs", native.pack_block2_paired,
              native.pack_block2_paired_plain, (b1, s1, e1, b2, s2, e2),
              320),
             ("fasta", native.pack_block2, native.pack_block2_plain,
              (bf, sf, ef), 152))
    out = []
    for name, new, plain, args, L in cases:
        want = batches(plain, args, L)
        for team in (1, cores, 0):
            got = batches(new, args, L, threads=team)
            if not all(np.array_equal(a, b) for u, v in zip(got, want)
                       for a, b in zip(u, v)):
                raise AssertionError(f"host_pack {name}: pack at team "
                                     f"{team} != its plain version")
        t = hs.times_ms({
            "plain_1": hs._printf_on(1, lambda: batches(plain, args, L)),
            "new_1": lambda: batches(new, args, L, threads=1),
            "plain": hs._printf_on(cores, lambda: batches(plain, args, L)),
            "new": lambda: batches(new, args, L, threads=cores),
            "new_default": lambda: batches(new, args, L)}, 3)
        m = {k: min(v) for k, v in t.items()}
        out.append(f"{name} {n}: plain {m['plain_1']:.1f} ms, new "
                   f"{m['new_1']:.1f} ms ({m['plain_1'] / m['new_1']:.2f}x) "
                   f"at team 1, plain {m['plain']:.1f} ms, new "
                   f"{m['new']:.1f} ms ({m['plain'] / m['new']:.2f}x) at "
                   f"team {cores}, new {m['new_default']:.1f} ms at its "
                   f"default team")
    del b1, b2, bf
    for path in (r1, r2, fa):
        path.unlink()
    rate = hs.copy_rate(512, cores)
    return (f"{'; '.join(out)}; equal bytes; copy rate "
            f"{rate / 1e9:.2f} GB/s read + written; pack team "
            f"{native.pack_team(chunk)}, {cores} host cores")


def golden_example(tmp: Path) -> None:
    from cuclark_tpu_torch import cli

    ex = ROOT / "examples"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["build-db", "-T", str(ex / "targets.txt"),
                       "-D", str(tmp / "exdb"), "-k", "27"])
    if rc:
        raise AssertionError(f"build-db returned {rc}")
    out = tmp / "example.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["classify", "-D", str(tmp / "exdb"),
                       "-O", str(ex / "reads.fq"), "-R", str(out),
                       "--device", "cuda"])
    if rc:
        raise AssertionError(f"classify returned {rc}")
    if out.read_bytes() != (ex / "expected_results.csv").read_bytes():
        raise AssertionError("example CSV differs from expected_results.csv")


def build_headline_db(n_genomes: int, tmp: Path | None,
                      layouts=("qs", "q4", "s2")):
    """Random genomes (numpy, seed 0) -> canonical 31-mers -> keep the
    target-specific ones (builder.discriminate) -> a qs, a q4 and an s2
    table (or those of `layouts`) of those k-mers through the port's
    build_table -> the .npz files that `classify -D` loads, in
    tmp/db_<layout> (none when tmp is None).  Returns the genomes and
    the tables by layout."""
    from cuclark_tpu_torch import codec
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.db_build.builder import db_name, discriminate
    from cuclark_tpu_torch.hashdb import build_table

    rng = np.random.default_rng(0)
    genomes = rng.integers(0, 4, size=(n_genomes, GENOME_LEN),
                           dtype=np.uint8)
    W = GENOME_LEN - K + 1
    parts, labs = [], []
    for lo in range(0, n_genomes, 1024):
        g = genomes[lo:lo + 1024].astype(np.uint64)
        km = np.zeros((len(g), W), np.uint64)
        for j in range(K):
            km = (km << np.uint64(2)) | g[:, j:j + W]
        parts.append(codec.canonical_np(km.ravel(), K))
        labs.append(np.repeat(np.arange(lo + 1, lo + len(g) + 1,
                                        dtype=np.uint32), W))
    kmers, labels, _ = discriminate(np.concatenate(parts),
                                    np.concatenate(labs))
    del parts, labs
    names = ["NA"] + [f"T{i}" for i in range(1, n_genomes + 1)]
    dbs = {}
    # the saves (zlib, which releases the GIL) run beside the next builds
    with ThreadPoolExecutor(3) as pool:
        saves = []
        for layout in layouts:
            cfg = DBConfig(k=K, target_load=0.85, layout=layout,
                           slots=S2_SLOTS, num_choices=S2_CHOICES)
            dbs[layout] = build_table(kmers, labels, names, cfg)
            if tmp is None:
                continue
            dbdir = tmp / f"db_{layout}"
            dbdir.mkdir(parents=True, exist_ok=True)
            saves.append(pool.submit(dbs[layout].save,
                                     dbdir / db_name(cfg, n_genomes)))
        for f in saves:
            f.result()
    return genomes, dbs


def _substitute(rng, codes: np.ndarray) -> np.ndarray:
    """SUB_RATE of the bases replaced by one of the other three."""
    sub = rng.random(codes.shape) < SUB_RATE
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()),
                                            dtype=np.uint8)) % 4
    return codes


def _write_fastq(path: Path, names, codes: np.ndarray) -> None:
    ascii_ = np.frombuffer(b"TGCA", np.uint8)[codes]   # A=3 C=2 G=1 T=0
    qual = "I" * codes.shape[1]
    with open(path, "w") as f:
        f.write("".join(f"@{n}\n{row.tobytes().decode()}\n+\n{qual}\n"
                        for n, row in zip(names, ascii_)))


def write_reads(genomes: np.ndarray, n_reads: int, path: Path):
    """150 bp reads sampled from the genomes with 1% substitutions,
    named r<i>_T<source>; returns their codes [n, 150] and sources."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, len(genomes), size=n_reads)
    pos = rng.integers(0, GENOME_LEN - READ_LEN + 1, size=n_reads)
    codes = _substitute(rng, genomes[src[:, None],
                                     pos[:, None] + np.arange(READ_LEN)])
    _write_fastq(path, (f"r{i}_T{s + 1}" for i, s in enumerate(src)), codes)
    return codes, src


def write_pairs(genomes: np.ndarray, n_pairs: int, r1: Path, r2: Path):
    """Pairs of 150 bp mates from 400 bp fragments of the genomes: mate 1
    the fragment's first 150 bases, mate 2 the reverse complement of its
    last 150, each with 1% substitutions, named p<i>_T<source>/1 and /2."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, len(genomes), size=n_pairs)
    pos = rng.integers(0, GENOME_LEN - FRAGMENT + 1, size=n_pairs)
    frag = genomes[src[:, None], pos[:, None] + np.arange(FRAGMENT)]
    m1 = _substitute(rng, frag[:, :READ_LEN].copy())
    m2 = _substitute(rng, (3 - frag[:, FRAGMENT - READ_LEN:])[:, ::-1].copy())
    for path, mate, codes in ((r1, 1, m1), (r2, 2, m2)):
        _write_fastq(path, (f"p{i}_T{s + 1}/{mate}" for i, s in
                            enumerate(src)), codes)


def joined_pairs(genomes: np.ndarray, n: int) -> np.ndarray:
    """The first n pairs of write_pairs (the same seed and draws) joined as
    the pipeline packs them: mate 1, an N, mate 2 as the file holds it
    (the reverse complement of the fragment's last 150 bases), padded
    with Ns to the 320 bin (P = 290 at k=31)."""
    from cuclark_tpu_torch import codec

    rng = np.random.default_rng(2)
    src = rng.integers(0, len(genomes), size=n)
    pos = rng.integers(0, GENOME_LEN - FRAGMENT + 1, size=n)
    frag = genomes[src[:, None], pos[:, None] + np.arange(FRAGMENT)]
    m1 = _substitute(rng, frag[:, :READ_LEN].copy())
    m2 = _substitute(rng, (3 - frag[:, FRAGMENT - READ_LEN:])[:, ::-1].copy())
    out = np.full((n, 320), codec.INVALID, np.uint8)
    out[:, :READ_LEN] = m1
    out[:, READ_LEN + 1:2 * READ_LEN + 1] = m2
    return out


def bin_reads(genomes: np.ndarray, n: int, length_bin: int) -> np.ndarray:
    """n reads of length_bin - 1 bases (the longest reads of that length
    bin) sampled from the genomes with 1% substitutions, padded with an N
    to the bin."""
    from cuclark_tpu_torch import codec

    rng = np.random.default_rng(length_bin)
    ln = length_bin - 1
    src = rng.integers(0, len(genomes), size=n)
    pos = rng.integers(0, GENOME_LEN - ln + 1, size=n)
    out = np.full((n, length_bin), codec.INVALID, np.uint8)
    out[:, :ln] = _substitute(rng, genomes[src[:, None],
                                           pos[:, None] + np.arange(ln)])
    return out


def head_fastq(src: Path, dst: Path, n: int) -> Path:
    """The first n records of a 4-line FASTQ file."""
    with open(src) as f:
        lines = [next(f) for _ in range(4 * n)]
    dst.write_text("".join(lines))
    return dst


def run_tool(argv) -> tuple[str, str, float]:
    """cuclark-tpu-torch in this process, its output captured ->
    (stdout, stderr, seconds).  Raises on a non-zero return."""
    from cuclark_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t1 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    dt = time.time() - t1
    if rc:
        raise AssertionError(f"{' '.join(argv[:1] + argv[-4:])} returned "
                             f"{rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), dt


def run_cli(argv, launches_of=None):
    """run_tool with the kernel launches counted from 0 -> (stderr,
    kernel launches of this run).  Raises on a non-zero return, and when
    a kernel of launches_of never launched."""
    from cuclark_tpu_torch import kernels

    import torch

    kernels.reset_launches()
    _, err, _ = run_tool(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in launches_of or ():
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} of the path never "
                                 f"launched: {launches}")
    return err, launches


def assigned_right(csv: Path) -> float:
    """Share of CSV rows whose first assignment is the T<source> named in
    the read's id (r<i>_T<s> or p<i>_T<s>/1)."""
    rows = csv.read_text().splitlines()[1:]
    return sum(r.split(",")[0].split("/")[0].rsplit("_", 1)[1]
               == r.split(",")[-5] for r in rows) / max(len(rows), 1)


def stream_budget_mb(db) -> float:
    """STREAM_MB, which plans the headline tables in STREAM_PARTS parts;
    for the smaller tables of a quick run (--genomes), a budget that
    plans them in as many: the stash and 2.4/parts of the main rows,
    which needs streaming and so halves to 1.2/parts for the double
    buffer."""
    from cuclark_tpu_torch.memplan import plan_stream_parts

    parts = STREAM_PARTS[db.layout]
    main, stash = db.split_tables()
    stash_mb = stash.nbytes / 1e6 if stash is not None else 0.0
    if plan_stream_parts(main.nbytes, (STREAM_MB - stash_mb) / 2, 1,
                         db.nb) == parts:
        return STREAM_MB
    return round(stash_mb + 2.4 * main.nbytes / 1e6 / parts, 3)


def check_stream_kernels(main_t, stash_t, wire, k, spec, parts, more=()):
    """The range query kernel against its plain version on each call of a
    pass over a resident headline table in n bucket ranges, a qs stash
    split over them (`range_calls`), for n = `parts` (as one device
    streams the table), each count of `more`, and 2 and 4 (the db shards
    of meshes of 2 and 4), each call written and accumulated; every
    pass's accumulated labels equal the resident query.  Then the fused last
    part: the fused range launch over part parts-1 with the other parts'
    sum (acc_in, the route's kernel: the queued launch) against plain and
    the resident results, and query_score_kernel over the same part (the
    route before the queued launch) beside it.  Returns (max_abs_err, ms,
    plain ms, bound ms) per part call of the `parts` pass (the times over
    a whole pass), and (max_abs_err, ms, plain ms, bound ms,
    query_score_kernel ms) of the fused last part."""
    import torch

    from cuclark_tpu_torch import codec, kernels, probe

    p2, vb = wire

    def one(fn, call, acc=None):
        m, s, start, sstart = call
        return fn(p2, vb, m, s, bucket_start=start, nb_local=m.shape[0],
                  stash_start=sstart, acc=acc, k=k, spec=spec)

    def all_calls(fn, calls):
        acc = None
        for c in calls:
            acc = one(fn, c, acc)
        return acc

    resident = probe.query_labels(p2, vb, main_t, stash_t, k=k, spec=spec)
    err = 0
    for n in sorted({parts, *more, 2, 4}):
        calls = range_calls(main_t, stash_t, n)
        what = f"{spec.layout} range {{}} of {n}"
        for j, c in enumerate(calls):
            got = one(probe.query_part_labels, c)
            torch.cuda.synchronize()
            want = one(probe.query_part_labels_plain, c)
            if not torch.equal(got, want):
                raise AssertionError(f"range kernel != plain on "
                                     f"{what.format(j)}: "
                                     f"{int((got != want).sum())} windows "
                                     f"differ")
            err = max(err, tm.max_abs_err(got, want))
        acc = all_calls(probe.query_part_labels, calls)
        torch.cuda.synchronize()
        acc_plain = all_calls(probe.query_part_labels_plain, calls)
        if not (torch.equal(acc, acc_plain) and torch.equal(acc, resident)):
            raise AssertionError(f"{spec.layout}: accumulated ranges of "
                                 f"{n} != plain or != resident labels")
        err = max(err, tm.max_abs_err(acc, acc_plain))
    calls = range_calls(main_t, stash_t, parts)
    ms = tm.cuda_ms(lambda: all_calls(probe.query_part_labels, calls), 10)
    plain_ms = tm.cuda_ms(lambda: all_calls(probe.query_part_labels_plain,
                                          calls), 2)
    unpacked = codec.unpack_codes(p2, vb)
    # a part call reads the stash row of every window it holds one of
    touched = tm.touched_rows(unpacked, spec, k,
                              None if spec.layout == "qs" else main_t)
    bound = tm.bound_ms(tm.query_bytes(
        touched, spec, p2.numel() + vb.numel(), 4 * resident.numel(), parts,
        later_hits(p2, vb, calls, k, spec)))

    # the fused last part: acc_in is the earlier parts' sum
    m, s, start, sstart = calls[-1]
    acc_in = all_calls(probe.query_part_labels, calls[:-1])
    fargs = dict(bucket_start=start, nb_local=m.shape[0], k=k, spec=spec,
                 stash_start=sstart, acc_in=acc_in)
    fused = probe.query_score_part_results(p2, vb, m, s, **fargs)
    torch.cuda.synchronize()
    fused_plain = probe.query_score_part_results_plain(p2, vb, m, s, **fargs)
    whole = probe.query_score_results_plain(p2, vb, main_t, stash_t, k=k,
                                            spec=spec)
    if not (torch.equal(fused, fused_plain) and torch.equal(fused, whole)):
        raise AssertionError(f"{spec.layout} fused last part != plain or != "
                             f"the resident results")
    # the same launch through query_score_kernel (a thread a window)
    old_args = dict(fargs)
    del old_args["nb_local"], old_args["acc_in"]
    fused_old = kernels._launch_query_score(p2, vb, m, s, acc_in,
                                            **old_args)
    torch.cuda.synchronize()
    if not torch.equal(fused_old, fused):
        raise AssertionError(f"{spec.layout} query_score_kernel over the "
                             f"last part != the routed launch")
    fused_ms = tm.cuda_ms(lambda: probe.query_score_part_results(
        p2, vb, m, s, **fargs), 20)
    fused_old_ms = tm.cuda_ms(lambda: kernels._launch_query_score(
        p2, vb, m, s, acc_in, **old_args), 20)
    fused_plain_ms = tm.cuda_ms(lambda: probe.query_score_part_results_plain(
        p2, vb, m, s, **fargs), 2)
    # it reads the wire and acc_in, writes [R, 5], and its ranges' rows
    main_rows, stash_rows = touched
    in_range = (main_rows[(main_rows >= start)
                          & (main_rows < start + m.shape[0])],
                None if s is None else stash_rows[
                    (stash_rows >= sstart)
                    & (stash_rows < sstart + s.shape[0])])
    fused_bound = tm.bound_ms(tm.query_bytes(
        in_range, spec, p2.numel() + vb.numel() + 4 * resident.numel(),
        20 * p2.shape[0]))
    return (err, ms / parts, plain_ms / parts, bound,
            (tm.max_abs_err(fused, fused_plain), fused_ms, fused_plain_ms,
             fused_bound, fused_old_ms))


def stream_group_breakdown(clf, wires) -> dict:
    """One streamed group at the size that classify_file_to_csv streams
    the table over, `clf.stream_group_eff` batches (the wire batches
    `wires`, on the card, repeated to that count), through a streaming
    Classifier's `_stream_group_dev`: its wall time on the host clock (to
    the card's last result), the part uploads' summed time (copy-stream
    events), and the summed device time of its part calls (CUDA events
    around each probe.query_part_labels and query_score_part_results
    call, on the compute stream after each part's upload wait).  The
    uploads and the calls run on two streams, so the larger sum sets the
    group's device time.  Each batch's results must equal the resident
    fused step's."""
    import torch

    from cuclark_tpu_torch import probe

    n = clf.stream_group_eff
    group = [wires[i % len(wires)] for i in range(n)]
    events = []

    def timed(fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((start, end))
            return out
        return call

    saved = probe.query_part_labels, probe.query_score_part_results
    probe.query_part_labels, probe.query_score_part_results = map(timed,
                                                                  saved)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = clf._stream_group_dev(group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    finally:
        probe.query_part_labels, probe.query_score_part_results = saved
    main = torch.from_numpy(clf.np_table.view(np.int32)).to(
        wires[0][0].device)
    want = [probe.query_score_results(p2, vb, main, clf.stash, k=clf.db.k,
                                      spec=clf.spec) for p2, vb in wires]
    del main
    for i, (res, _) in enumerate(out):
        if not torch.equal(res, want[i % len(wires)]):
            raise AssertionError(f"batch {i} of a streamed group's results "
                                 f"!= the resident results")
    del out
    uploads = [s.elapsed_time(e) for _, st in clf._streams
               for s, e in st._uploads]
    call_ms = float(sum(s.elapsed_time(e) for s, e in events))
    return {"batches": n, "wall_ms": wall, "uploads": len(uploads),
            "upload_ms": float(sum(uploads)), "calls": len(events),
            "call_ms": call_ms, "call_ms_per_batch": call_ms / n}


def write_long_reads(genomes: np.ndarray, path: Path) -> list:
    """N_LONG reads of LONG_MIN to LONG_MAX bases cut from the genomes
    laid end to end, with 1% substitutions, named l<i>; returns their
    codes."""
    rng = np.random.default_rng(3)
    flat = genomes.ravel()
    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=N_LONG)
    starts = rng.integers(0, len(flat) - LONG_MAX, size=N_LONG)
    reads = [_substitute(rng, flat[s:s + n].copy())
             for s, n in zip(starts, lens)]
    ascii_ = np.frombuffer(b"TGCA", np.uint8)
    with open(path, "w") as f:
        for i, c in enumerate(reads):
            f.write(f"@l{i}\n{ascii_[c].tobytes().decode()}\n+\n"
                    f"{'I' * len(c)}\n")
    return reads


def miss_batch(R: int, length_bin: int = 152):
    """R random reads (numpy seed 4) as wire arrays: 150 bp reads in the
    152 bin, or in the 320 bin two 150 bp mates joined by an N: the
    all-miss batch (the caller checks that no window hits)."""
    from cuclark_tpu_torch import codec

    codes = np.full((R, length_bin), codec.INVALID, np.uint8)
    ln = 2 * READ_LEN + 1 if length_bin == 320 else READ_LEN
    codes[:, :ln] = np.random.default_rng(4).integers(
        0, 4, size=(R, ln), dtype=np.uint8)
    if length_bin == 320:
        codes[:, READ_LEN] = codec.INVALID
    return codec.pack_codes(codes)


def chimeric_pairs(genomes: np.ndarray, n: int) -> np.ndarray:
    """n joined pairs in the 320 bin (numpy seed 6) whose mates are random
    bases with 8 pieces of 32 bases from random genomes laid in, 4 a
    mate: 8 distinct labels of 2 windows a pair, the most that windows of
    31 bases from different genomes give, beside windows that miss: the
    busiest table of the fused kernel's realistic inputs."""
    from cuclark_tpu_torch import codec

    rng = np.random.default_rng(6)
    out = rng.integers(0, 4, size=(n, 320), dtype=np.uint8)
    out[:, READ_LEN] = codec.INVALID
    out[:, 2 * READ_LEN + 1:] = codec.INVALID
    for lo in (0, 32, 64, 96, 151, 183, 215, 247):
        src = rng.integers(0, len(genomes), size=n)
        pos = rng.integers(0, GENOME_LEN - 32 + 1, size=n)
        out[:, lo:lo + 32] = genomes[src[:, None],
                                     pos[:, None] + np.arange(32)]
    return out


def check_paired_layout(db, pwire, qs_res, r1: Path, r2: Path, out: Path,
                        ceiling_lib, dev) -> dict:
    """The paired batch ([65536, 320] joined pairs at full size) on a q4 or
    s2 headline table: a resident Classifier on the mate files (the fused
    query and score of the layout alone, its launches counted, its CSV
    written to `out`), then the fused kernel's row on the batch
    (`torch_measure.fused_row`: against plain, against the layout's query
    then score and against the qs results qs_res, timed, with its bytes
    bound and the gather-only ceiling of the rows an exact probe reads).
    Returns the row."""
    from cuclark_tpu_torch import kernels, pipeline

    fused_name = f"query_score_{db.layout}"
    clf = pipeline.Classifier(db, device=dev)
    kernels.reset_launches()
    clf.classify_file_to_csv(r1, out, r2)
    launches = _launched(kernels.LAUNCHES)
    if launches.keys() != {fused_name}:
        raise AssertionError(f"the paired {db.layout} run did not take the "
                             f"fused kernel alone: {launches}")
    row, _ = tm.fused_row(*pwire, clf.table, None, k=db.k, spec=db.spec,
                          ceiling_lib=ceiling_lib, two=True, also=(qs_res,))
    row["launches"] = launches[fused_name]
    clf.close()
    return row


def check_layout(db, tmp: Path, fq: Path, head: Path, ext_fq: Path,
                 ext_csv: Path, wire, qs_csv: Path, ceiling_lib, dev,
                 card: str):
    """A q4 or s2 headline table: on one main-path batch ([65536, 152] at
    full size) the query kernel resident, per part call and on an
    all-miss batch, and the fused query and score, against plain, with
    the gather-only ceilings of the rows an exact probe reads; then the
    CLI on the card, resident (the fused kernel alone) and streamed, each
    CSV equal to the qs CSV; two timed file->CSV passes; --extended on
    ext_fq (the query and score kernels) equal to the qs CSV ext_csv; and
    --device cpu on the head of the reads.
    Returns (max_abs_err, ms, launches, phase detail, bound ms, ceiling
    ms) keyed by launch name."""
    import torch

    from cuclark_tpu_torch import codec, kernels, pipeline, probe
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import table_to_device

    layout, parts = db.layout, STREAM_PARTS[db.layout]
    res_name, part_name = f"query_{layout}", f"query_part_{layout}"
    fused_name = f"query_score_{layout}"
    dbdir = str(tmp / f"db_{layout}")
    stream_mb = stream_budget_mb(db)
    p2, vb = wire
    qargs = dict(k=db.k, spec=db.spec)
    t_step = time.time()
    main_t, _ = table_to_device(db, dev)
    lab = probe.query_labels(p2, vb, main_t, None, **qargs)
    torch.cuda.synchronize()
    lab_plain = probe.query_labels_plain(p2, vb, main_t, None, **qargs)
    if not torch.equal(lab, lab_plain):
        raise AssertionError(f"{layout} query kernel != plain on the "
                             f"real-size table")
    err = {res_name: tm.max_abs_err(lab, lab_plain)}
    res = probe.query_score_results(p2, vb, main_t, None, **qargs)
    torch.cuda.synchronize()
    res_plain = probe.query_score_results_plain(p2, vb, main_t, None,
                                                **qargs)
    if not torch.equal(res, res_plain):
        raise AssertionError(f"fused {layout} query and score != plain on "
                             f"the real-size batch")
    err[fused_name] = tm.max_abs_err(res, res_plain)
    lab_shape = lab.shape
    hits = int((lab > 0).sum())
    del lab_plain, res, res_plain
    unpacked = codec.unpack_codes(p2, vb)
    choices = tm.choice_rows(unpacked, main_t, db.spec, db.k)
    rows0, _, has1, zero = choices
    windows, seconds = int(rows0.numel()), int((has1 & zero).sum())
    touched = torch.unique(tm.exact_rows(choices)), None
    bound = {res_name: tm.bound_ms(tm.query_bytes(
                 touched, db.spec, p2.numel() + vb.numel(), 4 * lab.numel())),
             fused_name: tm.bound_ms(tm.query_bytes(
                 touched, db.spec, p2.numel() + vb.numel(),
                 20 * p2.shape[0]))}
    ceiling = {}
    # a streamed batch's fused last part: the queued launch where the
    # route takes it (its launch key names the kernel's row)
    last_key = fused_range_key(db.spec, db.nb // parts,
                               4 * p2.shape[1] - db.k + 1)
    last_name = (last_key if last_key.startswith("query_score_queue")
                 else f"query_score_part_stream_{layout}")
    ceiling[res_name], ceiling[part_name], ceiling[last_name] = (
        tm.layout_ceilings(ceiling_lib, main_t, choices, db.spec, parts))
    ceiling[fused_name] = ceiling[res_name]
    stored, first = db.first_choice_slots()
    share0 = int(first.sum()) / max(int(stored.sum()), 1)
    del stored, first
    del lab, unpacked, touched, choices, rows0, has1, zero
    ms = {res_name: tm.cuda_ms(lambda: probe.query_labels(
              p2, vb, main_t, None, **qargs), 20),
          f"{res_name}_plain": tm.cuda_ms(lambda: probe.query_labels_plain(
              p2, vb, main_t, None, **qargs), 5),
          fused_name: tm.cuda_ms(lambda: probe.query_score_results(
              p2, vb, main_t, None, **qargs), 20),
          f"{fused_name}_plain": tm.cuda_ms(
              lambda: probe.query_score_results_plain(
                  p2, vb, main_t, None, **qargs), 5)}

    # every window misses: each takes its second gather after the first
    m2, mv = (torch.from_numpy(a).to(dev) for a in miss_batch(p2.shape[0]))
    miss = probe.query_labels(m2, mv, main_t, None, **qargs)
    torch.cuda.synchronize()
    miss_plain = probe.query_labels_plain(m2, mv, main_t, None, **qargs)
    if not torch.equal(miss, miss_plain) or int(miss_plain.count_nonzero()):
        raise AssertionError(f"{layout} all-miss batch: kernel != plain, or "
                             f"a window hit")
    ms[f"{res_name}_miss"] = tm.cuda_ms(lambda: probe.query_labels(
        m2, mv, main_t, None, **qargs), 20)
    del miss, miss_plain, m2, mv
    (err[part_name], ms[part_name], ms[f"{part_name}_plain"],
     bound[part_name], last) = check_stream_kernels(
        main_t, None, wire, db.k, db.spec, parts,
        more=(2, 8) if layout == "q4" else ())
    (err[last_name], ms[last_name], ms[f"{last_name}_plain"],
     bound[last_name], last_old_ms) = last
    del main_t
    torch.cuda.empty_cache()
    secs = {"kernels": time.time() - t_step}

    t_step = time.time()
    # the resident 150 bp run launches the fused kernel alone (phase
    # profile traces it)
    csv, stream_csv = tmp / f"{layout}.csv", tmp / f"{layout}_stream.csv"
    _, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq), "-R",
                           str(csv), "--device", "cuda"], (fused_name,))
    if _launched(launches).keys() != {fused_name}:
        raise AssertionError(f"resident {layout} classify did not take the "
                             f"fused kernel alone: {_launched(launches)}")
    if csv.read_bytes() != qs_csv.read_bytes():
        raise AssertionError(f"{layout} CSV differs from the qs CSV")
    stderr, launches_stream = run_cli(
        ["classify", "-D", dbdir, "-O", str(fq), "-R", str(stream_csv),
         "--device", "cuda", "--max-table-mb", str(stream_mb)],
        (part_name, last_key))
    if launches_stream["score"]:
        raise AssertionError(f"{layout} streamed batches did not end in the "
                             f"fused last part: {launches_stream}")
    if f"{parts} bucket-range parts" not in stderr:
        raise AssertionError(f"{layout} --max-table-mb {stream_mb} did not "
                             f"stream in {parts} parts: {stderr}")
    if stream_csv.read_bytes() != qs_csv.read_bytes():
        raise AssertionError(f"{layout} streamed CSV differs from the qs "
                             f"CSV")
    secs["cli"] = time.time() - t_step
    t_step = time.time()
    rates = {}
    for name, cfg in (("resident", None),
                      ("streamed", ClassifyConfig(max_table_mb=stream_mb))):
        clf = pipeline.Classifier(db, cfg, device=dev)
        rates[name] = []
        for _ in range(2):
            t1 = time.time()
            n = clf.classify_file_to_csv(fq, tmp / "again.csv")
            torch.cuda.synchronize()
            rates[name].append(n / (time.time() - t1))
        clf.close()
        del clf
        if (tmp / "again.csv").read_bytes() != qs_csv.read_bytes():
            raise AssertionError(f"a second {layout} {name} classify wrote "
                                 f"another CSV")
    secs["file_to_csv"] = time.time() - t_step
    # --extended keeps the labels: the query kernel, then the score
    t_step = time.time()
    clf = pipeline.Classifier(db, ClassifyConfig(extended=True), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with contextlib.redirect_stderr(io.StringIO()):
        clf.classify_file_to_csv(ext_fq, tmp / "ext_layout.csv")
    torch.cuda.synchronize()
    launches_ext = dict(kernels.LAUNCHES)
    clf.close()
    del clf
    if not (launches_ext[res_name] and launches_ext["score"]):
        raise AssertionError(f"{layout} --extended never launched "
                             f"{res_name} and score: {launches_ext}")
    if (tmp / "ext_layout.csv").read_bytes() != ext_csv.read_bytes():
        raise AssertionError(f"{layout} --extended CSV differs from qs's")
    secs["extended"] = time.time() - t_step
    t_step = time.time()
    cpu_csv = tmp / f"{layout}_cpu.csv"
    run_cli(["classify", "-D", dbdir, "-O", str(head), "-R", str(cpu_csv),
             "--device", "cpu"])
    n_head = len(cpu_csv.read_bytes().split(b"\n")) - 2
    want = b"\n".join(qs_csv.read_bytes().split(b"\n")[:n_head + 1]) + b"\n"
    if cpu_csv.read_bytes() != want:
        raise AssertionError(f"{layout} --device cpu CSV of the first "
                             f"{n_head} reads differs from the card's")
    torch.cuda.empty_cache()
    secs["cpu"] = time.time() - t_step
    part_mb = db.table.nbytes / parts / 1e6
    detail = (f"{db.table.nbytes / 1e9:.3f} GB table, nb_bits "
              f"{db.nb_bits}, {share0:.6f} of stored keys at choice 0; "
              f"labels {list(lab_shape)} bit-identical, {hits} of {windows} "
              f"valid windows hit ({hits / windows:.6f}), {seconds} took the "
              f"second gather; query {ms[res_name]:.4f} ms (plain "
              f"{ms[res_name + '_plain']:.4f}, ceiling "
              f"{ceiling[res_name]:.4f}), fused query and score "
              f"{ms[fused_name]:.4f} ms (plain "
              f"{ms[fused_name + '_plain']:.4f}), all-miss batch "
              f"bit-identical, query {ms[res_name + '_miss']:.4f} ms; "
              f"range kernel == plain on each part of "
              f"{'2, 4 and 8' if layout == 'q4' else parts} and each db "
              f"shard of 2 and 4; {ms[part_name]:.4f} ms per part call of "
              f"{parts} (plain {ms[part_name + '_plain']:.4f}, ceiling "
              f"{ceiling[part_name]:.4f}); fused last part ({last_key}) "
              f"{ms[last_name]:.4f} ms (plain {ms[last_name + '_plain']:.4f},"
              f" bound {bound[last_name]:.4f}, ceiling "
              f"{ceiling[last_name]:.4f}; query_score_kernel over the same "
              f"part {last_old_ms:.4f} ms); resident CSV == qs CSV, "
              f"launches "
              f"{_launched(launches)}; {parts} parts of {part_mb:.1f} MB, "
              f"CSV == qs CSV, launches {_launched(launches_stream)}; "
              f"--extended == qs, launches {_launched(launches_ext)}; "
              f"file->CSV resident "
              f"{', '.join(f'{r:.1f}' for r in rates['resident'])}, streamed "
              f"{', '.join(f'{r:.1f}' for r in rates['streamed'])} reads/s; "
              f"first {n_head} reads identical to --device cpu; seconds: "
              + ", ".join(f"{n} {t:.2f}" for n, t in secs.items())
              + f"; on {card}")
    return (err, ms, {fused_name: launches[fused_name],
                      res_name: launches_ext[res_name],
                      part_name: launches_stream[part_name],
                      last_name: launches_stream[last_key]}, detail, bound,
            ceiling)


def check_long_reads(tmp: Path, db, dbdir: str, long_fq: Path, long_codes,
                     dev, card: str):
    """Reads of LONG_MIN to LONG_MAX bases against the qs headline table:
    the score kernel's `score_long` entry, and its `score_bounded` entry
    at the table's label bound, against plain on the labels of the batch
    the main path gives it, then `classify --device cuda` (which must
    launch the bounded entry, or score_long for a bound above
    SCORE_BOUND_CAP) equal to --device cpu byte for byte.  Returns
    (max_abs_err, ms, plain ms, launches, phase detail, bound ms)."""
    import torch

    from cuclark_tpu_torch import codec, kernels, probe, score
    from cuclark_tpu_torch.hashdb import table_to_device

    L = int(np.ceil((max(len(c) for c in long_codes) + 1) / 128) * 128)
    padded = np.full((len(long_codes), L), codec.INVALID, np.uint8)
    for i, c in enumerate(long_codes):
        padded[i, :len(c)] = c
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(padded))
    del padded
    main_t, stash_t = table_to_device(db, dev)
    lab = probe.query_labels(p2, vb, main_t, stash_t, k=db.k, spec=db.spec)
    del main_t, stash_t, p2, vb
    label_bound = db.spec.label_bound
    entry = ("score_bounded" if label_bound <= kernels.SCORE_BOUND_CAP
             else "score_long")
    res = score.score_labels(lab)
    res_bounded = score.score_labels(lab, label_bound)
    torch.cuda.synchronize()
    res_plain = score.score_labels_plain(lab)
    if not (torch.equal(res, res_plain) and torch.equal(res_bounded,
                                                        res_plain)):
        raise AssertionError(f"score_long or score_bounded kernel != plain "
                             f"at {list(lab.shape)}")
    err = tm.max_abs_err(res, res_plain)
    ms = tm.cuda_ms(lambda: score.score_labels(lab, label_bound), 5)
    plain_ms = tm.cuda_ms(lambda: score.score_labels_plain(lab), 2)
    shape = list(lab.shape)
    bound = tm.bound_ms(4 * lab.numel() + 20 * lab.shape[0])
    del lab, res, res_bounded, res_plain
    torch.cuda.empty_cache()
    gpu_csv, cpu_csv = tmp / "long_gpu.csv", tmp / "long_cpu.csv"
    _, launches = run_cli(["classify", "-D", dbdir, "-O", str(long_fq),
                           "-R", str(gpu_csv), "--device", "cuda"],
                          ("query", entry))
    run_cli(["classify", "-D", dbdir, "-O", str(long_fq), "-R",
             str(cpu_csv), "--device", "cpu"])
    if gpu_csv.read_bytes() != cpu_csv.read_bytes():
        raise AssertionError("long-read CSV of --device cuda differs from "
                             "--device cpu")
    rows = gpu_csv.read_text().splitlines()[1:]
    if len(rows) != len(long_codes) or any(r.split(",")[-5] == "NA" for r in rows):
        raise AssertionError(f"{len(rows)} long-read rows, or an "
                             f"unassigned one, for {len(long_codes)} reads")
    detail = (f"{N_LONG} reads, score_long and {entry} (label bound "
              f"{label_bound}) on {shape} bit-identical, {entry} "
              f"{ms:.4f} ms (plain {plain_ms:.4f}); CSV identical to "
              f"--device cpu, launches {launches}; on {card}")
    return err, ms, plain_ms, launches[entry], detail, bound


def check_classify_step(codes_np: np.ndarray, B: int, main_t, stash_t,
                        wire, lab0, db, dev, card: str):
    """The main-path reads as unpacked codes through
    `pipeline.classify_step`, batch by batch, with the counts reset just
    before: the same results as the wire step, and the first batch's
    labels equal to the wire labels; the codes kernel against plain on
    that batch, and both timed.  Returns (max_abs_err, ms, plain ms,
    launches, detail)."""
    import torch

    from cuclark_tpu_torch import kernels, pipeline, probe, score

    qargs = dict(k=db.k, spec=db.spec)
    codes = [torch.from_numpy(codes_np[i:i + B]).to(dev)
             for i in range(0, len(codes_np) - B + 1, B)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [pipeline.classify_step(main_t, c, stash=stash_t, **qargs)
            for c in codes]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in ("query_codes", "score"):
        if launches[name] < 1:
            raise AssertionError(f"classify_step never launched {name}: "
                                 f"{launches}")
    for (res, lab), (p2, vb) in zip(outs, wire):
        want, _ = pipeline.classify_step_packed(main_t, p2, vb, stash=stash_t,
                                                with_labels=False, **qargs)
        if not torch.equal(res, want):
            raise AssertionError("classify_step results != the wire step's")
    if not torch.equal(outs[0][1], lab0):
        raise AssertionError("classify_step labels != the wire labels")
    want = probe.query_codes_labels_plain(codes[0], main_t, stash_t, **qargs)
    if not torch.equal(outs[0][1], want):
        raise AssertionError("codes kernel != plain at real size")
    err = tm.max_abs_err(outs[0][1], want)
    del outs, want
    ms = tm.cuda_ms(lambda: pipeline.classify_step(
        main_t, codes[0], stash=stash_t, with_labels=False, **qargs), 20)
    plain_ms = tm.cuda_ms(lambda: score.score_labels_plain(
        probe.query_codes_labels_plain(codes[0], main_t, stash_t, **qargs)),
        5)
    detail = (f"{len(codes)} batches of {list(codes[0].shape)} codes, "
              f"results == the wire step's, labels bit-identical to plain; "
              f"classify_step {ms:.4f} ms (plain {plain_ms:.4f}), launches "
              f"{launches} on {card}")
    return err, ms, plain_ms, launches["query_codes"], detail


def mesh_stream_budget_mb(db, num_db: int, parts: int) -> float:
    """A per-device budget that streams each device's shard of the table
    in `parts` parts on a mesh of num_db db shards: its stash shard and
    2.4 / parts of its main rows, which needs streaming and so halves to
    1.2 / parts for the double buffer."""
    main, stash = db.split_tables()
    stash_mb = stash.nbytes / 1e6 if stash is not None else 0.0
    return round((stash_mb + 2.4 * main.nbytes / 1e6 / parts) / num_db, 3)


def _turns(fns: dict, reps: int, rounds: int = 3) -> dict:
    """CUDA-event ms of each callable in turns (a, b, b, a, ...), `rounds`
    times -> name -> list of times."""
    names = list(fns)
    order = names + names[::-1]
    out = {n: [] for n in names}
    for _ in range(rounds):
        for n in order:
            out[n].append(tm.cuda_ms(fns[n], reps))
    return out


def check_mesh_layout(db, m, wire, ceiling_lib, dev) -> tuple[int, str]:
    """A q4 or s2 headline table on the 2 x 2 mesh m: the sharded resident
    step without labels (each block's shard 1 a range launch, then its
    shard 0 the fused range launch with that sum: the queued launch where
    the route takes it, at W 2) against plain and the resident fused
    results, its launches counted; then shard 0's launch alone, acc_in
    shard 1's labels, == resident, timed in turns with query_score_kernel
    over the same shard, beside its bound and the gather-only ceiling of
    the rows it gathers.  Returns (max_abs_err, detail)."""
    import statistics

    import torch

    from cuclark_tpu_torch import codec, kernels, probe
    from cuclark_tpu_torch.hashdb import table_to_device
    from cuclark_tpu_torch.parallel import mesh

    p2, vb = wire
    lay, spec, k = db.layout, db.spec, db.k
    P = 4 * p2.shape[1] - k + 1
    main_t, _ = table_to_device(db, dev)
    nb, half = main_t.shape[0], main_t.shape[0] // 2
    resident = probe.query_score_results(p2, vb, main_t, None, k=k,
                                         spec=spec)
    smain, sstash = mesh.shard_db_table(db, m)
    wires = mesh.place_wire(m, p2.cpu().numpy(), vb.cpu().numpy())
    step, plain = (mesh.build_sharded_classify(
        m, nb_total=nb, with_labels=False, plain=pl, k=k, spec=spec)
        for pl in (False, True))
    kernels.reset_launches()
    res, _ = step(smain, sstash, wires)
    torch.cuda.synchronize()
    route = _launched(kernels.LAUNCHES)
    key = fused_range_key(spec, half, P)
    pres, _ = plain(smain, sstash, wires)
    res, pres = torch.cat(res), torch.cat(pres)
    if route != {f"query_part_{lay}": 2, key: 2} or not (
            torch.equal(res, pres) and torch.equal(res, resident)):
        raise AssertionError(f"{lay} sharded step on 2 db shards: launches "
                             f"{route}, or != plain or != resident")
    err = tm.max_abs_err(res, pres)
    step_ms = tm.cuda_ms(lambda: step(smain, sstash, wires), 10)
    del res, pres, smain, sstash, wires
    acc = probe.query_part_labels(p2, vb, main_t[half:], None,
                                  bucket_start=half, nb_local=half, k=k,
                                  spec=spec)
    shard0 = main_t[:half]
    args = dict(bucket_start=0, k=k, spec=spec, stash_start=0)
    fns = {"routed": lambda: probe.query_score_part_results(
               p2, vb, shard0, None, nb_local=half, acc_in=acc, **args),
           "query_score_kernel": lambda: kernels._launch_query_score(
               p2, vb, shard0, None, acc, **args)}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, resident):
            raise AssertionError(f"{lay} shard 0 of 2 ({name}) with shard "
                                 f"1's labels != resident")
    t = _turns(fns, 20)
    gathered = tm.range_rows(codec.unpack_codes(p2, vb), main_t, spec, k, 0,
                             half)
    bound = tm.bound_ms(tm.query_bytes(
        (torch.unique(gathered[0]), None), spec,
        p2.numel() + vb.numel() + 4 * acc.numel(), 20 * p2.shape[0]))
    ceiling = tm.range_ceiling_ms(ceiling_lib, main_t, None, gathered, spec)
    med = {n: statistics.median(v) for n, v in t.items()}
    wins = sum(a < b for a, b in zip(t["routed"], t["query_score_kernel"]))
    del main_t, shard0, acc, gathered, resident
    torch.cuda.empty_cache()
    return err, (f"{lay} on 2 db shards: sharded step ({route} a batch) "
                 f"{step_ms:.4f} ms == plain and resident; shard 0's launch "
                 f"({key}) {med['routed']:.4f} ms, query_score_kernel over "
                 f"it {med['query_score_kernel']:.4f} ms in turns (routed "
                 f"faster in {wins} of {len(t['routed'])}), bound "
                 f"{bound:.4f}, ceiling {ceiling:.4f}")


def check_mesh(db, tmp: Path, fq: Path, wire, gpu_csv: Path, paired,
               dev, card: str, layout_dbs=(), ceiling_lib=None):
    """A 2 data x 2 db mesh of four handles of the card: each db shard's
    labels of the main-path batch against plain, their sum against the
    resident labels; the sharded resident step without labels (each
    block's shard 1, then its shard 0 as the fused range launch with the
    sum) and with labels (range launches, sum, score), and the sharded
    part step (4 parts, each shard's stash split over them) with its
    last part fused or accumulated then scored, each against its plain
    version and the resident results; a 1 x 1 mesh's step (one fused
    launch over the whole table) timed in turns with the resident fused
    step; the q4 and s2 tables of layout_dbs on 2 db shards
    (check_mesh_layout); then
    `Classifier(db, mesh=...)` file->CSV, resident and with each device's
    shard streamed in 4 parts, twice each, every CSV equal to the
    resident one, the counts reset just before each Classifier's runs and
    held to the fused route's.  The paired batch (`paired`: its wire
    arrays, its resident fused results, the mate files and the resident
    paired CSV) takes the sharded step and the sharded part step, each
    block ending fused (P = 290, three tiles), == plain and resident, and
    Classifier(mesh) on the mate files writes the paired CSV with range
    and fused launches only.  Returns (max_abs_err, ms, launches, phase
    detail, bound ms) keyed by the JAX function."""
    import statistics

    import torch

    from cuclark_tpu_torch import codec, kernels, pipeline, probe, score
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import table_to_device
    from cuclark_tpu_torch.parallel import mesh

    m = mesh.make_mesh(2, 2, [dev] * 4)
    p2, vb = wire
    B = p2.shape[0]
    main_t, stash_t = table_to_device(db, dev)
    qargs = dict(k=db.k, spec=db.spec)
    resident = probe.query_labels(p2, vb, main_t, stash_t, **qargs)
    resident_res = probe.query_score_results(p2, vb, main_t, stash_t,
                                             **qargs)
    nb, nbs = main_t.shape[0], stash_t.shape[0]
    unpacked = codec.unpack_codes(p2, vb)
    # the shard and part launches read every window's stash row in their
    # range; the 1 x 1 mesh's fused launch holds every main row and reads
    # a stash row only where its main row needs it, as the resident step
    touched = tm.touched_rows(unpacked, db.spec, db.k)
    wire_b, lab_b = p2.numel() + vb.numel(), 4 * resident.numel()
    fused_bound = tm.bound_ms(tm.query_bytes(touched, db.spec, wire_b, 20 * B))
    bound = {"build_sharded_classify": fused_bound,
             "query_score_part": tm.bound_ms(tm.query_bytes(
                 tm.touched_rows(unpacked, db.spec, db.k, main_t), db.spec,
                 wire_b, 20 * B)),
             "build_sharded_probe_part": tm.bound_ms(tm.query_bytes(
                 touched, db.spec, wire_b, lab_b, 4, later_hits(
                     p2, vb, range_calls(main_t, stash_t, 4), db.k,
                     db.spec)))}
    smain, sstash = mesh.shard_db_table(db, m)
    err = {"build_sharded_classify": 0, "build_sharded_probe_part": 0,
           "query_score_part": 0}
    ms = {}
    total = None
    for j in range(2):
        args = dict(bucket_start=j * nb // 2, nb_local=nb // 2,
                    stash_start=j * nbs // 2, **qargs)
        got = probe.query_part_labels(p2, vb, smain[0][j], sstash[0][j],
                                      **args)
        torch.cuda.synchronize()
        want = probe.query_part_labels_plain(p2, vb, smain[0][j],
                                             sstash[0][j], **args)
        if not torch.equal(got, want):
            raise AssertionError(f"db shard {j} of 2 != plain")
        err["build_sharded_classify"] = max(err["build_sharded_classify"],
                                            tm.max_abs_err(got, want))
        total = got if total is None else total + got
    if not torch.equal(total, resident):
        raise AssertionError("the 2 db shards' labels != resident labels")
    del got, want, total

    def launched_by(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, _launched(kernels.LAUNCHES)

    # the sharded resident step: fused without labels, range with them
    wires = mesh.place_wire(m, p2.cpu().numpy(), vb.cpu().numpy())
    steps = {(labels, plain): mesh.build_sharded_classify(
        m, nb_total=nb, nbs_total=nbs, with_labels=labels, plain=plain,
        **qargs) for labels in (False, True) for plain in (False, True)}
    (res, lab), route_f = launched_by(
        lambda: steps[(False, False)](smain, sstash, wires))
    if lab is not None or route_f != {"query_part": 2, "query_score_part": 2}:
        raise AssertionError(f"sharded step without labels: {route_f}")
    pres, _ = steps[(False, True)](smain, sstash, wires)
    res, pres = torch.cat(res), torch.cat(pres)
    if not (torch.equal(res, pres) and torch.equal(res, resident_res)):
        raise AssertionError("fused sharded step != plain or != resident")
    err["build_sharded_classify"] = max(err["build_sharded_classify"],
                                        tm.max_abs_err(res, pres))
    (res, lab), route_l = launched_by(
        lambda: steps[(True, False)](smain, sstash, wires))
    pres, plab = steps[(True, True)](smain, sstash, wires)
    lab, plab = torch.cat(lab), torch.cat(plab)
    res, pres = torch.cat(res), torch.cat(pres)
    if not (torch.equal(lab, plab) and torch.equal(res, pres)
            and torch.equal(lab, resident)
            and torch.equal(res, resident_res)):
        raise AssertionError("sharded step with labels != plain or != "
                             "resident")
    err["build_sharded_classify"] = max(err["build_sharded_classify"],
                                        tm.max_abs_err(lab, plab),
                                        tm.max_abs_err(res, pres))
    del lab, plab, res, pres
    (pp2, pvb), pair_res, r1, r2, paired_csv = paired
    pwires = mesh.place_wire(m, pp2.cpu().numpy(), pvb.cpu().numpy())
    (res, _), route_pf = launched_by(
        lambda: steps[(False, False)](smain, sstash, pwires))
    pres, _ = steps[(False, True)](smain, sstash, pwires)
    res, pres = torch.cat(res), torch.cat(pres)
    if route_pf != {"query_part": 2, "query_score_part": 2} or not (
            torch.equal(res, pres) and torch.equal(res, pair_res)):
        raise AssertionError(f"sharded step of the paired batch: launches "
                             f"{route_pf}, or != plain or != resident")
    err["build_sharded_classify"] = max(err["build_sharded_classify"],
                                        tm.max_abs_err(res, pres))
    del res, pres
    t = _turns({"fused": lambda: steps[(False, False)](smain, sstash, wires),
                "range": lambda: steps[(True, False)](smain, sstash, wires)},
               20)
    ms["build_sharded_classify"] = statistics.median(t["fused"])
    ms["build_sharded_classify_range"] = statistics.median(t["range"])
    ms["build_sharded_classify_plain"] = tm.cuda_ms(
        lambda: steps[(False, True)](smain, sstash, wires), 3)

    # a 1 x 1 mesh: one fused launch over the whole table, in turns with
    # the resident fused step
    m1 = mesh.make_mesh(1, 1, [dev])
    w1 = mesh.place_wire(m1, p2.cpu().numpy(), vb.cpu().numpy())
    one, one_plain = (mesh.build_sharded_classify(
        m1, nb_total=nb, nbs_total=nbs, with_labels=False, plain=plain,
        **qargs) for plain in (False, True))
    (res1, _), route_1 = launched_by(lambda: one([[main_t]], [[stash_t]], w1))
    pres1, _ = one_plain([[main_t]], [[stash_t]], w1)
    if route_1 != {"query_score_part": 1} or not (
            torch.equal(res1[0], resident_res)
            and torch.equal(res1[0], pres1[0])):
        raise AssertionError(f"1 x 1 mesh step: launches {route_1}, or != "
                             f"resident or != plain")
    err["query_score_part"] = tm.max_abs_err(res1[0], pres1[0])
    del res1, pres1
    t_one = _turns({"resident": lambda: probe.query_score_results(
                     p2, vb, main_t, stash_t, **qargs),
                 "mesh_1x1": lambda: one([[main_t]], [[stash_t]], w1)}, 20)
    ms["query_score_part"] = statistics.median(t_one["mesh_1x1"])
    ms["query_score_part_plain"] = tm.cuda_ms(
        lambda: one_plain([[main_t]], [[stash_t]], w1), 3)
    one_vs = {n: statistics.median(v) for n, v in t_one.items()}

    # the sharded part step: the last part fused, or accumulated then
    # scored (the route before the fused one)
    rows = nb // 4
    pstep, plain_pstep = (mesh.build_sharded_probe_part(
        m, nb_part=rows, plain=plain, **qargs) for plain in (False, True))

    def part(p):
        return [[main_t[p * rows + j * rows // 2:p * rows + (j + 1) * rows
                        // 2] for j in range(2)] for _ in range(2)]

    def all_parts(fn, route="accumulate", batch=None):
        acc = None
        for p in range(4):
            last = p == 3
            out = fn(part(p), batch or wires, p * rows, stash=sstash,
                     acc=acc, scored=last and route == "fused",
                     split=(p, 4))
            if last and route == "fused":
                return out
            acc = out
        return acc if route == "accumulate" else [
            score.score_labels(a) for a in acc]

    for p in range(4):
        got = pstep(part(p), wires, p * rows, stash=sstash, split=(p, 4))
        torch.cuda.synchronize()
        want = plain_pstep(part(p), wires, p * rows, stash=sstash,
                           split=(p, 4))
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded part step != plain on part {p}")
            err["build_sharded_probe_part"] = max(
                err["build_sharded_probe_part"], tm.max_abs_err(a, b))
    if not torch.equal(torch.cat(all_parts(pstep)), resident):
        raise AssertionError("sharded parts' sum != resident labels")
    fres, route_p = launched_by(lambda: all_parts(pstep, "fused"))
    pfres = all_parts(plain_pstep, "fused")
    fres, pfres = torch.cat(fres), torch.cat(pfres)
    # each block's last launch: shard 0 of the last part, an eighth of
    # the table (the queued launch where the route takes it)
    last_key = fused_range_key(db.spec, rows // 2, 4 * p2.shape[1] - db.k + 1)
    if route_p != {"query_part": 14, last_key: 2} or not (
            torch.equal(fres, pfres) and torch.equal(fres, resident_res)):
        raise AssertionError(f"sharded parts ending in the fused launch: "
                             f"launches {route_p}, or != plain or != "
                             f"resident")
    err["build_sharded_probe_part"] = max(err["build_sharded_probe_part"],
                                          tm.max_abs_err(fres, pfres))
    fres, route_pp = launched_by(lambda: all_parts(pstep, "fused", pwires))
    pfres = all_parts(plain_pstep, "fused", pwires)
    fres, pfres = torch.cat(fres), torch.cat(pfres)
    if route_pp != route_p or not (torch.equal(fres, pfres)
                                   and torch.equal(fres, pair_res)):
        raise AssertionError(f"sharded parts of the paired batch ending in "
                             f"the fused launch: launches {route_pp}, or != "
                             f"plain or != resident")
    err["build_sharded_probe_part"] = max(err["build_sharded_probe_part"],
                                          tm.max_abs_err(fres, pfres))
    del fres, pfres, pwires
    tp = _turns({"fused": lambda: all_parts(pstep, "fused"),
                 "range": lambda: all_parts(pstep, "range"),
                 "accumulate": lambda: all_parts(pstep)}, 10)
    ms["build_sharded_probe_part"] = statistics.median(tp["fused"]) / 4
    ms["build_sharded_probe_part_range"] = statistics.median(tp["range"]) / 4
    ms["build_sharded_probe_part_accumulate"] = statistics.median(
        tp["accumulate"]) / 4
    ms["build_sharded_probe_part_plain"] = tm.cuda_ms(
        lambda: all_parts(plain_pstep, "fused"), 2) / 4
    del main_t, stash_t, smain, sstash, resident, wires, w1
    torch.cuda.empty_cache()
    layout_details = []
    for ldb in layout_dbs:
        e, d = check_mesh_layout(ldb, m, wire, ceiling_lib, dev)
        err["build_sharded_classify"] = max(err["build_sharded_classify"], e)
        layout_details.append(d)

    launches, rates, gbps = {}, {}, []
    budget = mesh_stream_budget_mb(db, 2, 4)
    n_reads = len(gpu_csv.read_text().splitlines()) - 1
    batches = 2 * -(-n_reads // ClassifyConfig().batch_reads)
    for name, cfg, jax_fn, route in (
            ("resident", None, "build_sharded_classify", route_f),
            ("streamed", ClassifyConfig(max_table_mb=budget),
             "build_sharded_probe_part", route_p)):
        out = tmp / f"mesh_{name}.csv"
        kernels.reset_launches()
        clf = pipeline.Classifier(db, cfg, mesh=m)
        if clf.stream_parts != (1 if cfg is None else 4):
            raise AssertionError(f"mesh {name}: {clf.stream_parts} parts")
        rates[name] = []
        for _ in range(2):
            t1 = time.time()
            n = clf.classify_file_to_csv(fq, out)
            torch.cuda.synchronize()
            rates[name].append(n / (time.time() - t1))
            if out.read_bytes() != gpu_csv.read_bytes():
                raise AssertionError(f"mesh {name} CSV differs from the "
                                     f"resident CSV")
        gbps = gbps or clf.part_upload_gbps()
        clf.close()
        del clf
        launches[jax_fn] = _launched(kernels.LAUNCHES)
        if launches[jax_fn] != {n: batches * c for n, c in route.items()}:
            raise AssertionError(f"mesh {name}: launches {launches[jax_fn]} "
                                 f"for {batches} batches of {route}")
        torch.cuda.empty_cache()
    kernels.reset_launches()
    clf = pipeline.Classifier(db, mesh=m)
    out = tmp / "mesh_paired.csv"
    clf.classify_file_to_csv(r1, out, r2)
    torch.cuda.synchronize()
    clf.close()
    del clf
    paired_launches = _launched(kernels.LAUNCHES)
    if out.read_bytes() != paired_csv.read_bytes() or (
            paired_launches.keys() != {"query_part", "query_score_part"}
            or paired_launches["query_part"]
            != paired_launches["query_score_part"]):
        raise AssertionError(f"mesh paired CSV differs from the resident "
                             f"paired CSV, or launches {paired_launches}")
    detail = (f"2 data x 2 db, four handles of the one card ({card}); db "
              f"shards of [{B}, {4 * p2.shape[1]}] bit-identical, sum == "
              f"resident; sharded step, route fused ({route_f} a batch) "
              f"{ms['build_sharded_classify']:.4f} ms, route range + score "
              f"({route_l}) {ms['build_sharded_classify_range']:.4f} ms "
              f"(plain {ms['build_sharded_classify_plain']:.4f}); 1 x 1 "
              f"mesh step ({route_1}) {one_vs['mesh_1x1']:.4f} ms against "
              f"the resident fused step {one_vs['resident']:.4f} ms in turns "
              f"({', '.join(f'{x:.4f}' for x in t_one['mesh_1x1'])} against "
              f"{', '.join(f'{x:.4f}' for x in t_one['resident'])}); sharded "
              f"part step per part of 4, last part fused ({route_p} a "
              f"batch) {ms['build_sharded_probe_part']:.4f} ms, accumulated "
              f"then scored {ms['build_sharded_probe_part_range']:.4f}, "
              f"accumulation alone "
              f"{ms['build_sharded_probe_part_accumulate']:.4f} (plain "
              f"{ms['build_sharded_probe_part_plain']:.4f}); all == resident "
              f"results; Classifier(mesh) CSV == resident CSV, file->CSV "
              f"{', '.join(f'{r:.1f}' for r in rates['resident'])} reads/s, "
              f"launches {launches['build_sharded_classify']}; streamed at "
              f"--max-table-mb {budget} (4 parts per device), CSV == "
              f"resident CSV, {', '.join(f'{r:.1f}' for r in rates['streamed'])}"
              f" reads/s, part uploads "
              f"{', '.join(f'{g:.2f}' for g in gbps)} GB/s, launches "
              f"{launches['build_sharded_probe_part']}; paired [{B}, "
              f"{4 * pp2.shape[1]}] batch: sharded step ({route_pf}) and "
              f"parts ending fused ({route_pp}) == plain and resident, "
              f"Classifier(mesh) paired CSV == resident paired CSV, "
              f"launches {paired_launches}" + "".join(
                  f"; {d}" for d in layout_details))
    counts = {k: v.get("query_part", 0) for k, v in launches.items()}
    counts["query_score_part"] = launches["build_sharded_classify"][
        "query_score_part"]
    return err, ms, counts, detail, bound, resident_res


# A rank of phase multiprocess: `classify --coordinator` through the CLI,
# then the host-spanning step on the table that run loaded (kept here so
# that a rank loads it once): the same batch on a mesh whose db axis
# spans both ranks (num_db 2, each rank one column, half the table), over
# a second gloo group.  argv: the second group's port, the batch's .npz,
# the .npz to write, then the CLI's arguments.  The last stdout line is a
# JSON object: the CLI run's kernel launches and the step's numbers.
_RANK_MAIN = """
import json, statistics, sys, time
import numpy as np
import torch
from cuclark_tpu_torch import cli, kernels
from cuclark_tpu_torch.hashdb import KmerDB
from cuclark_tpu_torch.parallel import mesh, multihost

loaded = []
_load = KmerDB.load
KmerDB.load = staticmethod(
    lambda path, **kw: loaded.append(_load(path, **kw)) or loaded[-1])
port, wire_npz, out_npz, *argv = sys.argv[1:]
rc = cli.main(argv)
torch.cuda.synchronize()
launches = dict(kernels.LAUNCHES)
multihost.initialize(f"127.0.0.1:{port}", 2,
                     int(argv[argv.index("--process-id") + 1]))
db = loaded[0]
m = mesh.make_global_mesh(2, [torch.device("cuda")])
assert m.spans_processes
sc = mesh.ShardedClassifier(db, m, with_labels=False)
z = np.load(wire_npz)
wires = sc.put_wire(z["p2"], z["vb"])
sc.step_placed(wires)
torch.cuda.synchronize()
kernels.reset_launches()
res = sc.step_placed(wires)[0][0]
torch.cuda.synchronize()
step_launches = {n: c for n, c in kernels.LAUNCHES.items() if c}


def timed(fn, reps=5):
    ts = []
    for _ in range(reps):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


step_ms = timed(lambda: sc.step_placed(wires))
labels = torch.zeros((z["p2"].shape[0], 4 * z["p2"].shape[1] - db.k + 1),
                     dtype=torch.int32, device="cuda")
allreduce_ms = timed(lambda: torch.distributed.all_reduce(labels))
main_np, stash_np = db.split_tables()
plain = mesh.build_sharded_classify(
    m, k=db.k, spec=db.spec, nb_total=main_np.shape[0],
    nbs_total=0 if stash_np is None else stash_np.shape[0],
    with_labels=False, plain=True)
plain_res = []
plain_ms = timed(lambda: plain_res.append(
    plain(sc.table, sc.stash, wires)[0][0]), 1)
np.savez(out_npz, res=res.cpu().numpy(), plain=plain_res[0].cpu().numpy())
multihost.shutdown()
print(json.dumps({"launches": launches, "step_launches": step_launches,
                  "step_ms": step_ms, "allreduce_ms": allreduce_ms,
                  "plain_ms": plain_ms[0], "column": m.db_start}))
raise SystemExit(rc)
"""


def check_multiprocess(tmp: Path, dbdir: str, fq: Path, gpu_csv: Path,
                       card: str, wire, resident_res):
    """Two ranks of `classify --device cuda --coordinator` on the card,
    over gloo: .h000 + .h001 must equal the resident CSV, and each rank,
    a 1 x 1 mesh of the card, must have launched the fused range launch
    once a batch and nothing else.  Then, in the same two processes, on
    the table each loaded once: the host-spanning step, a db axis of 2
    across the ranks (`make_global_mesh(2)`: each holds half the table),
    on the main-path batch `wire`: each rank's results must equal the
    resident results `resident_res` and the step's plain version; its
    time, and the gloo all_reduce of the [R, P] labels alone, are
    recorded.  Then `--num-hosts 2 --host-id 0|1`: the two CSVs' rows
    concatenate to the resident CSV's.  Returns (phase detail, the
    host-spanning step's numbers)."""
    import re
    import socket
    import statistics

    ports = []
    socks = [socket.socket() for _ in range(2)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
        ports.append(sk.getsockname()[1])
    for sk in socks:
        sk.close()
    wire_npz = tmp / "span_wire.npz"
    np.savez(wire_npz, p2=wire[0].cpu().numpy(), vb=wire[1].cpu().numpy())
    out = tmp / "mp.csv"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, str(ports[1]), str(wire_npz),
         str(tmp / f"span{r}.npz"), "classify", "-D", dbdir, "-O",
         str(fq), "-R", str(out), "--device", "cuda", "--coordinator",
         f"127.0.0.1:{ports[0]}", "--num-processes", "2", "--process-id",
         str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=400))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    want = resident_res.cpu().numpy()
    rank_rates, rank_launches, spans = [], [], []
    for r, (pr, (so, se)) in enumerate(zip(procs, outs)):
        if pr.returncode:
            raise AssertionError(f"rank {r} returned {pr.returncode}: "
                                 f"{se[-2000:]}")
        info = json.loads(so.strip().splitlines()[-1])
        t = re.search(r"Assignment time: ([\d.e+-]+) s\..*\((\d+) objects",
                      so)
        n = int(t.group(2))
        rank_rates.append(n / float(t.group(1)))
        batches = -(-n // 65536)
        launched = _launched(info["launches"])
        if launched != {"query_score_part": batches}:
            raise AssertionError(f"rank {r} ({n} reads, {batches} batches, "
                                 f"a 1 x 1 mesh) launches {launched}")
        rank_launches.append(launched)
        got = np.load(tmp / f"span{r}.npz")
        if not (np.array_equal(got["res"], want)
                and np.array_equal(got["plain"], want)):
            raise AssertionError(f"host-spanning step on rank {r} != "
                                 f"resident results or != plain")
        info["max_abs_err"] = int(np.abs(got["res"].astype(np.int64)
                                         - got["plain"]).max())
        if info["step_launches"] != {"query_part": 1, "score": 1} or (
                info["column"] != r):
            raise AssertionError(f"host-spanning step on rank {r}: "
                                 f"launches {info['step_launches']}, "
                                 f"column {info['column']}")
        spans.append(info)
    merged = (tmp / "mp.csv.h000").read_bytes() + (
        tmp / "mp.csv.h001").read_bytes()
    if merged != gpu_csv.read_bytes():
        raise AssertionError(".h000 + .h001 differ from the resident CSV")
    rows = []
    host_launches = []
    for h in range(2):
        part = tmp / f"host{h}.csv"
        _, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq), "-R",
                               str(part), "--device", "cuda", "--num-hosts",
                               "2", "--host-id", str(h)], ("query_score",))
        host_launches.append(launches["query_score"])
        lines = part.read_bytes().split(b"\n")
        rows += lines[:-1] if h == 0 else lines[1:-1]
    if b"\n".join(rows) + b"\n" != gpu_csv.read_bytes():
        raise AssertionError("--num-hosts 2 shards differ from the resident "
                             "CSV")
    span = {"ms": statistics.median(t for x in spans for t in x["step_ms"]),
            "allreduce_ms": statistics.median(
                t for x in spans for t in x["allreduce_ms"]),
            "plain_ms": statistics.median(x["plain_ms"] for x in spans),
            "launches": spans[0]["step_launches"]["query_part"],
            "max_abs_err": max(x["max_abs_err"] for x in spans)}
    detail = (f"two ranks on one card ({card}) over gloo: .h000 + .h001 == "
              f"resident CSV, {', '.join(f'{x:.1f}' for x in rank_rates)} "
              f"reads/s per rank (each rank's file->CSV incl. its scan), "
              f"launches {rank_launches} (a 1 x 1 mesh each); host-spanning "
              f"step (db 2 across the ranks, half the table each, "
              f"[{wire[0].shape[0]}, {4 * wire[0].shape[1]}]): results == "
              f"resident and plain on both ranks, launches "
              f"{spans[0]['step_launches']} a rank, step "
              f"{', '.join(f'{t:.3f}' for t in spans[0]['step_ms'])} ms "
              f"(rank 0), {', '.join(f'{t:.3f}' for t in spans[1]['step_ms'])}"
              f" ms (rank 1), gloo all_reduce of the [R, P] labels alone "
              f"{', '.join(f'{t:.3f}' for t in spans[0]['allreduce_ms'])} "
              f"ms, plain step {span['plain_ms']:.3f} ms; --num-hosts 2 "
              f"shards == resident CSV, query_score launches "
              f"{host_launches}")
    return detail, span


def _launched(launches: dict) -> dict:
    """The kernels of a run's launch counts that launched."""
    return {name: n for name, n in launches.items() if n}


def check_example_sh(tmp: Path) -> str:
    """examples/example.sh, run from a copy in tmp against the port: a
    one-word `cuclark-tpu-torch` wrapper on PATH (example.sh falls back to
    the JAX CLI when `command -v $CUCLARK_TPU` fails).  Its classify calls
    take the CLI's default --device cuda.  It must exit 0 and print its
    three OK: lines."""
    import shutil

    ex = tmp / "examples_copy"
    shutil.copytree(ROOT / "examples", ex)
    bindir = tmp / "bin"
    bindir.mkdir()
    wrapper = bindir / "cuclark-tpu-torch"
    wrapper.write_text(
        "#!/bin/sh\n"
        f'PYTHONPATH="{ROOT}${{PYTHONPATH:+:$PYTHONPATH}}" exec '
        f'"{sys.executable}" -m cuclark_tpu_torch.cli "$@"\n')
    wrapper.chmod(0o755)
    env = {**os.environ, "CUCLARK_TPU": "cuclark-tpu-torch",
           "PATH": f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"}
    proc = subprocess.run(["bash", str(ex / "example.sh")], env=env,
                          capture_output=True, text=True, timeout=600)
    oks = [ln for ln in proc.stdout.splitlines() if ln.startswith("OK:")]
    if proc.returncode or len(oks) != 3:
        raise AssertionError(f"example.sh returned {proc.returncode} with "
                             f"{len(oks)} OK: lines: {proc.stdout[-1500:]}"
                             f"{proc.stderr[-1500:]}")
    return "; ".join(oks)


def write_genome_files(genomes: np.ndarray, tmp: Path) -> Path:
    """Each genome as a FASTA file g<i>.fa (bases spelled as the reads
    and the table spell them) and a targets.txt naming it T<i>, the
    database's target names."""
    gdir = tmp / "genomes"
    gdir.mkdir()
    ascii_ = np.frombuffer(b"TGCA", np.uint8)   # A=3 C=2 G=1 T=0
    lines = []
    for i, g in enumerate(genomes, 1):
        p = gdir / f"g{i}.fa"
        p.write_bytes(b">g%d\n" % i + ascii_[g].tobytes() + b"\n")
        lines.append(f"{p} T{i}")
    targets = tmp / "targets_headline.txt"
    targets.write_text("\n".join(lines) + "\n")
    return targets


def check_accuracy(genomes: np.ndarray, targets: Path, tmp: Path,
                   dbdir: str, n_reads: int, card: str):
    """The accuracy loop at the headline size: simulate-reads at the CLI's
    default error rates from the genome files, classify on the card
    against the resident qs table, evaluate with floors, abundance -D
    and density of the CSV; the first reads' rows equal to --device
    cpu's.  Returns the phase's detail."""
    sim, sim_csv = tmp / "sim.fq", tmp / "sim.csv"
    secs = {}
    _, _, secs["simulate-reads"] = run_tool([
        "simulate-reads", "-T", str(targets), "-O", str(sim), "-n",
        str(n_reads), "-l", str(READ_LEN)])
    t1 = time.time()
    _, launches = run_cli(["classify", "-D", dbdir, "-O", str(sim), "-R",
                           str(sim_csv), "--device", "cuda"],
                          ("query_score",))
    secs["classify"] = time.time() - t1
    out, _, secs["evaluate"] = run_tool(
        ["evaluate", "-R", str(sim_csv), "--min-recall", "0.95",
         "--min-precision", "0.98"])
    overall = out.splitlines()[-1].split(",")
    if overall[:2] != ["OVERALL", str(n_reads)]:
        raise AssertionError(f"evaluate's last line: {out.splitlines()[-1]}")
    recall, precision = float(overall[3]), float(overall[4])
    out, _, secs["abundance"] = run_tool(
        ["abundance", "-R", str(sim_csv), "-D", dbdir])
    names = [ln.split(",", 1)[0] for ln in out.splitlines()[1:]]
    n_na = sum(r.split(",")[3] == "NA"
               for r in sim_csv.read_text().splitlines()[1:])
    want = {f"T{i}" for i in range(1, len(genomes) + 1)} | (
        {"NA"} if n_na else set())
    if len(names) != len(want) or set(names) != want:
        raise AssertionError(f"abundance -D listed {len(names)} names, "
                             f"expected the {len(genomes)} targets"
                             f"{' and NA' if n_na else ''}")
    for by in ("confidence", "gamma"):
        out, _, secs[f"density --by {by}"] = run_tool(
            ["density", "-R", str(sim_csv), "--by", by])
        if len(out.splitlines()) != 21:
            raise AssertionError(f"density --by {by}: {out[:500]}")
    n_cpu = min(16384, n_reads)
    cpu_csv = tmp / "sim_cpu.csv"
    run_cli(["classify", "-D", dbdir, "-O",
             str(head_fastq(sim, tmp / "sim_head.fq", n_cpu)), "-R",
             str(cpu_csv), "--device", "cpu"])
    head = sim_csv.read_bytes().split(b"\n")[:n_cpu + 1]
    if b"\n".join(head) + b"\n" != cpu_csv.read_bytes():
        raise AssertionError(f"the first {n_cpu} rows of the simulated "
                             f"reads' CSV differ from --device cpu's")
    detail = (f"{n_reads} simulated {READ_LEN} bp reads (sub 0.01, ins "
              f"0.001, del 0.001) from {len(genomes)} genome files: "
              f"recall {recall:.4f}, precision {precision:.4f} (floors 0.95, "
              f"0.98), {n_na} unassigned; abundance -D lists "
              f"{len(names)} names; first {n_cpu} rows == --device cpu; "
              f"launches {_launched(launches)}; seconds on the "
              f"{n_reads}-row CSV: "
              + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
              + f"; on {card}")
    return detail


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 words (wrapping)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def pair_fingerprint(kmers: np.ndarray, labels: np.ndarray) -> tuple:
    """An order-free fingerprint of (k-mer, label) pairs: their count and
    the wrapping sum of a 64-bit mix of each pair.  Two tables hold the
    same pairs iff (up to a 2^-64 chance) their fingerprints agree,
    whatever order their rows keep them in."""
    with np.errstate(over="ignore"):
        z = _mix64(_mix64(kmers.astype(np.uint64))
                   + labels.astype(np.uint64))
    return len(kmers), int(z.sum(dtype=np.uint64))


def write_taxonomy(d: Path) -> None:
    """A small NCBI taxonomy for the example genomes: phylum 2, genera 10
    and 20, species 11, 12 and 21 named `Species 1-3` (the example's
    labels), and the example genomes' accessions NC_EX0001-3 mapped to
    them, the third through merged taxid 99."""
    d.mkdir()
    (d / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tphylum\t|\n"
        "10\t|\t2\t|\tgenus\t|\n11\t|\t10\t|\tspecies\t|\n"
        "12\t|\t10\t|\tspecies\t|\n20\t|\t2\t|\tgenus\t|\n"
        "21\t|\t20\t|\tspecies\t|\n")
    (d / "names.dmp").write_text("".join(
        f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in (
            (10, "GenusA"), (11, "Species 1"), (12, "Species 2"),
            (20, "GenusB"), (21, "Species 3"))))
    (d / "merged.dmp").write_text("99\t|\t21\t|\n")
    (d / "nucl.accession2taxid").write_text(
        "accession\taccession.version\ttaxid\tgi\n"
        "NC_EX0001\tNC_EX0001.1\t11\t1\n"
        "NC_EX0002\tNC_EX0002.1\t12\t2\n"
        "NC_EX0003\tNC_EX0003.1\t99\t3\n")


def check_clark_interop(db, dbdir: str, targets: Path, tmp: Path, fq: Path,
                        gpu_csv: Path, card: str):
    """export-clark --light of the headline qs database, import-clark of
    those files: the imported table holds the same (k-mer, label) pairs
    in the same geometry, and classify on the card against it writes the
    resident CSV.  Then export-ht / import-ht of the example database,
    and set-targets on a taxonomy written here, whose .settings classify
    on the card honours.  Returns the phase's detail."""
    import shutil

    from cuclark_tpu_torch import cli
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.io import clark_db

    ck = tmp / "clark"
    secs = {}
    _, _, secs["export-clark"] = run_tool(
        ["export-clark", "-D", dbdir, "-o", str(ck), "--light"])
    sizes = {ext: Path(f"{ck}{ext}").stat().st_size
             for ext in (".sz", ".ky", ".lb")}
    if sizes[".sz"] != clark_db.HTSIZE_LIGHT:
        raise AssertionError(f".sz holds {sizes['.sz']} buckets")
    imp = tmp / "db_imported"
    _, _, secs["import-clark"] = run_tool(
        ["import-clark", "-i", str(ck), "-T", str(targets), "-D", str(imp),
         "-k", str(K)])
    idb = KmerDB.load(next(imp.glob("db_k*.npz")))
    fp = pair_fingerprint(*db.items())
    if (pair_fingerprint(*clark_db.import_clark_db(ck, K)) != fp
            or pair_fingerprint(*idb.items()) != fp):
        raise AssertionError("the CLARK files or the imported table hold "
                             "other (k-mer, label) pairs than the headline "
                             "table")
    if ((idb.layout, idb.nb_bits, idb.stash_bits, idb.num_kmers,
         idb.target_names) != (db.layout, db.nb_bits, db.stash_bits,
                               db.num_kmers, db.target_names)):
        raise AssertionError("the imported table's geometry or names differ")
    checksum = ("equal" if idb.checksum() == db.checksum() else
                "differs (the files list keys in bucket order)")
    del idb
    imp_csv = tmp / "imported.csv"
    _, launches = run_cli(["classify", "-D", str(imp), "-O", str(fq), "-R",
                           str(imp_csv), "--device", "cuda"],
                          ("query_score",))
    if imp_csv.read_bytes() != gpu_csv.read_bytes():
        raise AssertionError("classify on the imported table wrote another "
                             "CSV than the resident one")

    # .ht sets of the example database (built by golden_example)
    ex = ROOT / "examples"
    expected = (ex / "expected_results.csv").read_bytes()
    _, _, secs["export-ht"] = run_tool(
        ["export-ht", "-D", str(tmp / "exdb"), "-o", str(tmp / "ht")])
    _, _, secs["import-ht"] = run_tool(
        ["import-ht", "-i", str(tmp / "ht"), "-D", str(tmp / "exdb_ht")])
    exdb = KmerDB.load(next((tmp / "exdb").glob("db_k*.npz")))
    htdb = KmerDB.load(next((tmp / "exdb_ht").glob("db_k*.npz")))
    if (pair_fingerprint(*htdb.items()) != pair_fingerprint(*exdb.items())
            or htdb.target_names != exdb.target_names):
        raise AssertionError("import-ht of export-ht lost pairs or names")
    run_cli(["classify", "-D", str(tmp / "exdb_ht"), "-O",
             str(ex / "reads.fq"), "-R", str(tmp / "ht.csv"), "--device",
             "cuda"], ("query_score",))
    if (tmp / "ht.csv").read_bytes() != expected:
        raise AssertionError(".ht round trip: CSV differs from "
                             "expected_results.csv")

    # set-targets from the example genomes under a taxonomy
    refs = tmp / "refs"
    refs.mkdir()
    for g in ("genome1.fa", "genome2.fa", "genome3.fa"):
        shutil.copy(ex / g, refs / g)
    write_taxonomy(tmp / "taxonomy")
    st = tmp / "db_set_targets"
    _, _, secs["set-targets"] = run_tool(
        ["set-targets", str(st), str(refs), "--rank", "species",
         "--taxonomy-dir", str(tmp / "taxonomy")])
    settings = json.loads((st / ".settings").read_text())
    if settings["targets"] != str(st / "targets.txt"):
        raise AssertionError(f".settings: {settings}")
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["classify", "-D", str(st), "-T",
                       str(ex / "targets.txt"), "-O", str(ex / "reads.fq"),
                       "-R", str(tmp / "st_refused.csv"), "--device", "cuda"])
    if rc != 1 or "managed by set-targets" not in err.getvalue():
        raise AssertionError(f"classify took a -T that conflicts with "
                             f".settings: rc {rc}")
    run_cli(["classify", "-D", str(st), "-O", str(ex / "reads.fq"), "-R",
             str(tmp / "st.csv"), "-k", "27", "--device", "cuda"],
            ("query_score",))
    if (tmp / "st.csv").read_bytes() != expected:
        raise AssertionError("set-targets database: CSV differs from "
                             "expected_results.csv")
    detail = (f"export-clark --light {fp[0]} {K}-mers: .sz "
              f"{sizes['.sz']} B, .ky {sizes['.ky']} B, .lb {sizes['.lb']}"
              f" B; import-clark: same pairs, geometry and names, checksum "
              f"{checksum}; classify of the imported table == resident "
              f"CSV, launches {_launched(launches)}; .ht round trip and "
              f"set-targets (species, .settings honoured, conflicting -T "
              f"refused) == "
              f"expected_results.csv; seconds: "
              + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
              + f"; on {card}")
    return detail


# bench_torch.py's knobs for the smoke: every block of bench.py runs, each
# at a size that takes seconds
BENCH_KNOBS = {"READS": 65536, "CHUNK": 16384, "KMERS": 1_000_000,
               "SCALE_KMERS": 4_000_000, "4G_KMERS": 8_000_000,
               "E2E_READS": 65536, "ACC_READS": 5000, "PAIRED_READS": 65536,
               "LIGHT_KMERS": 2_000_000, "BUILD_MB": 16, "BUILD_RAM_MB": 64,
               "REPS": 3, "CACHE": 0}
BENCH_BLOCKS = ("scaling_model", "small", "e2e_scale", "e2e_small",
                "host_pipeline", "accuracy", "stream_ratio", "mesh_e2e",
                "light_paired", "scale4g", "build_spill")
BENCH_EXACT = ("at-scale_step_vs_plain", "small_step_vs_plain",
               "stream_csv_eq_resident", "mesh_csv_eq_e2e_scale",
               "light_paired_step_vs_plain", "scale4g_step_vs_plain")


def check_bench(tmp: Path, card: str) -> str:
    """bench_torch.py on the card at BENCH_KNOBS, in a subprocess: its
    last line must hold every block of bench.py, no build error, every
    exactness check, the card's name, and in each device-step block fused
    launches and a hit in every read of its planted chunk."""
    env = dict(os.environ, TMPDIR=str(tmp),
               **{f"CUCLARK_BENCH_{k}": str(v)
                  for k, v in BENCH_KNOBS.items()})
    env.pop("CUCLARK_BENCH_DEVICE", None)
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line["detail"]
    missing = [b for b in BENCH_BLOCKS if b not in d]
    if missing or "error" in d["build_spill"]:
        raise AssertionError(f"bench_torch.py: blocks missing {missing}, "
                             f"build_spill {d.get('build_spill')}")
    if [c for c in BENCH_EXACT if d["exact"].get(c) is not True]:
        raise AssertionError(f"bench_torch.py exactness: {d['exact']}")
    if d["device"]["name"] != card:
        raise AssertionError(f"bench_torch.py ran on {d['device']}")
    for name, blk in (("at-scale", d), ("small", d["small"]),
                      ("scale4g", d["scale4g"]),
                      ("light_paired", d["light_paired"])):
        if not blk["launches"].get("query_score"):
            raise AssertionError(f"bench_torch.py {name}: no fused launch, "
                                 f"{blk['launches']}")
        planted = blk["planted"]
        if not 0 < planted["hit_reads"] == planted["reads"]:
            raise AssertionError(f"bench_torch.py {name}: planted reads "
                                 f"missed, {planted}")
        if not {"ms", "ceiling_ms", "ceiling_stash_ms",
                "stash_share"} <= set(blk["kernel"]):
            raise AssertionError(f"bench_torch.py {name}: kernel row "
                                 f"{blk['kernel']}")
    rows = "; ".join(
        f"{name} kernel {blk['kernel']['ms']:.4f} ms, ceiling "
        f"{blk['kernel']['ceiling_ms']:.4f} (main rows), "
        f"{blk['kernel']['ceiling_stash_ms']:.4f} (with the stash rows, "
        f"read for {blk['kernel']['stash_share']:.2%} of the windows)"
        for name, blk in (("at-scale", d), ("small", d["small"]),
                          ("scale4g", d["scale4g"]),
                          ("light_paired", d["light_paired"])))
    return (f"every block of bench.py and {len(BENCH_EXACT)} exactness "
            f"checks; step {line['value']} reads/s (small "
            f"{d['small']['reads_per_sec']}, scale4g "
            f"{d['scale4g']['reads_per_sec']}), e2e "
            f"{d['e2e_scale']['reads_per_sec']} reads/s, light paired "
            f"{d['light_paired']['reads_per_sec']} pairs/s, stream "
            f"{d['stream_ratio']['reads_per_sec']} reads/s in "
            f"{d['stream_ratio']['stream_parts']} parts, host chain "
            f"{d['host_pipeline']['serial_chain_reads_per_sec']} reads/s; "
            f"{rows}; {d['device']['nvidia_smi']}")


# Kernel names in a trace, by launch count: the query kernel's template
# instances, its fused query-and-score instance (one event a call), and
# the score kernel's warp and histogram entries
TRACE_KERNELS = {"query": ("query_kernel",),
                 "query_score": ("query_score_kernel",),
                 "score": ("score_warp_kernel", "score_hist_kernel")}


def trace_kernels(path: Path) -> tuple[dict, float, float]:
    """From a Chrome trace of torch.profiler: each TRACE_KERNELS entry's
    kernel events (start, duration in us, sorted), the card's busy share
    of the traced window (the union of kernel, copy and memset time over
    the first to last event of the trace), and the window in ms."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    found = {name: sorted((float(e["ts"]), float(e["dur"])) for e in events
                          if e.get("cat") == "kernel"
                          and any(m in e["name"] for m in marks))
             for name, marks in TRACE_KERNELS.items()}
    busy_iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in busy_iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return found, busy / (hi - lo), (hi - lo) / 1e3


def check_profile(db, dbdir: str, fq: Path, gpu_csv: Path, codes, tmp: Path,
                  dev, card: str):
    """classify --device cuda --profile on the headline reads, resident:
    the CSV is the resident one, the trace parses, and it holds as many
    events of each TRACE_KERNELS entry as kernels.LAUNCHES counted (the
    fused query and score alone on this path).  Then one more profiler
    session: the resident q4 and s2 runs of the CLI on the same reads
    (each CSV the resident one, the layout's fused kernel alone), and 20
    back-to-back wrapper calls of each kernel on one main-path batch,
    beside CUDA-event times of the same calls without the profiler: the
    kernels' own durations against the rate the host launches them at.
    That trace holds one kernel event for each launch of both.  Returns
    the phase's detail."""
    import torch

    from cuclark_tpu_torch import codec, kernels, probe, score
    from cuclark_tpu_torch.hashdb import table_to_device

    tdir, prof_csv = tmp / "trace", tmp / "profile.csv"
    stderr, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq), "-R",
                                str(prof_csv), "--device", "cuda",
                                "--profile", str(tdir)], ("query_score",))
    if f"Profiler trace in {tdir}" not in stderr:
        raise AssertionError(f"no profiler line on stderr: {stderr[-500:]}")
    if prof_csv.read_bytes() != gpu_csv.read_bytes():
        raise AssertionError("--profile changed the CSV")
    traces = list(tdir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} traces in {tdir}")
    found, share, window_ms = trace_kernels(traces[0])
    for name, evs in found.items():
        if len(evs) != launches[name]:
            raise AssertionError(f"the trace holds {len(evs)} {name} kernel "
                                 f"events for {launches[name]} launches")
    mean = {name: np.mean([d for _, d in evs]) / 1e3
            for name, evs in found.items() if evs}

    # launch pacing: one batch, 20 calls of each wrapper after a warm-up
    B = min(65536, len(codes))
    padded = np.full((B, 152), codec.INVALID, np.uint8)
    padded[:, :READ_LEN] = codes[:B]
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(padded))
    main_t, stash_t = table_to_device(db, dev)
    qargs = dict(k=db.k, spec=db.spec)
    lab = probe.query_labels(p2, vb, main_t, stash_t, **qargs)
    calls = {"query": lambda: probe.query_labels(p2, vb, main_t, stash_t,
                                                 **qargs),
             "query_score": lambda: probe.query_score_results(
                 p2, vb, main_t, stash_t, **qargs),
             "score": lambda: score.score_labels(lab)}
    event_ms = {name: tm.cuda_ms(fn, 20) for name, fn in calls.items()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fused = {}
    with torch.profiler.profile(activities=acts) as prof:
        for layout in ("q4", "s2"):
            name, lcsv = f"query_score_{layout}", tmp / f"profile_{layout}.csv"
            _, lay = run_cli(["classify", "-D", str(tmp / f"db_{layout}"),
                              "-O", str(fq), "-R", str(lcsv), "--device",
                              "cuda"], (name,))
            if (_launched(lay).keys() != {name}
                    or lcsv.read_bytes() != gpu_csv.read_bytes()):
                raise AssertionError(f"traced resident {layout} run: "
                                     f"launches {_launched(lay)}, or its CSV "
                                     f"differs from the resident one")
            fused[name] = lay[name]
        kernels.reset_launches()
        traced_ms = {name: tm.cuda_ms(fn, 20) for name, fn in calls.items()}
        torch.cuda.synchronize()
        paced_launches = dict(kernels.LAUNCHES)
    prof.export_chrome_trace(str(tmp / "pacing.json"))
    paced, _, _ = trace_kernels(tmp / "pacing.json")
    for name, evs in paced.items():
        want = paced_launches[name] + (sum(fused.values())
                                       if name == "query_score" else 0)
        if len(evs) != want:
            raise AssertionError(f"the second trace holds {len(evs)} {name} "
                                 f"kernel events for {want} launches (q4 and "
                                 f"s2 runs {fused}, then {paced_launches})")
    del main_t, stash_t, lab, p2, vb
    torch.cuda.empty_cache()
    pacing = []
    for name, evs in paced.items():
        evs = evs[-20:]
        if len(evs) != 20:
            raise AssertionError(f"the pacing trace holds {len(evs)} {name} "
                                 f"kernels")
        dur = np.mean([d for _, d in evs]) / 1e3
        gap = np.mean(np.diff([t for t, _ in evs])) / 1e3
        pacing.append(f"{name} {event_ms[name]:.4f} ms by CUDA events "
                      f"({traced_ms[name]:.4f} traced), kernel {dur:.4f} ms,"
                      f" one start every {gap:.4f} ms")
    return (f"CSV == resident CSV; trace {traces[0].name}: "
            + ", ".join(f"{len(found[name])} {name} kernels of mean {m:.4f} "
                        f"ms" for name, m in mean.items())
            + f" (launches {_launched(launches)}); card busy {share:.4%} of "
            f"the {window_ms:.1f} ms traced window (kernels and copies); a "
            f"second session: resident q4 and s2 CSVs == resident, launches "
            f"and kernel events {fused} alone, then 20 "
            f"back-to-back wrapper calls on [{B}, 152]: "
            + "; ".join(pacing) + f"; on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=16384,
                    help="genomes (targets) of the real-size phase [16384]")
    ap.add_argument("--reads", type=int, default=131072,
                    help="reads of the real-size phase [131072]")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if tm is None or not (ROOT / "cuclark_tpu_torch" / "__init__.py"
                          ).is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no cuclark_tpu_torch package)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import cuclark_tpu_torch
    from cuclark_tpu_torch import codec, kernels, pipeline, probe, score
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import table_to_device

    if Path(cuclark_tpu_torch.__file__).resolve().parent != ROOT / "cuclark_tpu_torch":
        raise AssertionError(f"imported {cuclark_tpu_torch.__file__}, not "
                             f"the checkout's package")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # 1. the card, the versions, the kernels' build
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    cached = kernels.library_path().exists()
    import torch_gather_ceiling
    with ThreadPoolExecutor(2) as pool:
        ceiling_lib = pool.submit(torch_gather_ceiling.build)
        kernels.load()
        ceiling_lib = ceiling_lib.result()
    _phase("build", t0, f"{'loaded' if cached else 'built'} "
           f"{kernels.library_path().relative_to(ROOT)} and "
           f"{torch_gather_ceiling.SRC.relative_to(ROOT)}")

    # 2. each kernel against its plain version on the card
    t0 = time.time()
    err = {"query": 0, "query_score": 0, "score": 0, "score_long": 0}
    for k in (27, 32):
        checks = [check_small_query(dev, k)] + [
            check_small_layout(dev, layout, k) for layout in ("q4", "s2")]
        for one in checks:
            for name, e in one.items():
                err[name] = max(err.get(name, 0), e)
    err["query_score"] = max(err["query_score"], check_fused_widths(dev))
    for i, (R, P) in enumerate(((65536, 122), (65536, 290), (64, 16354),
                                (33, 1000), (64, 1), (5, 2), (16, 1025),
                                (8, 32768))):
        err["score"] = max(err["score"], check_score(dev, R, P, i))
    for i, (R, P) in enumerate(((4, 40000), (2, 100000))):
        launched = kernels.LAUNCHES["score_long"]
        err["score_long"] = max(err["score_long"],
                                check_score(dev, R, P, 10 + i))
        if kernels.LAUNCHES["score_long"] != launched + 1:
            raise AssertionError(f"score [{R}, {P}] did not take the "
                                 f"score_long entry")
    _phase("kernels_vs_plain", t0, "query (qs, q4, s2, resident, part, "
           "qs db shards with stash ranges, codes front half), the fused "
           "query and score (qs, q4, s2; one to eight tiles, resident and "
           "in range mode with acc_in), and score (warp and histogram "
           "paths, both label ranges) bit-identical")

    with tempfile.TemporaryDirectory(prefix="cuclark_smoke_") as td:
        tmp = Path(td)

        # the host feed's record scan, before the tables fill the host
        t0 = time.time()
        _phase("host_scan", t0, check_host_scan(tmp))
        t0 = time.time()
        _phase("host_mate", t0, check_host_mate())
        t0 = time.time()
        _phase("host_format", t0, check_host_format())
        t0 = time.time()
        _phase("host_pack", t0, check_host_pack(tmp))
        t0 = time.time()
        _phase("host_inflate", t0, check_host_inflate(tmp))

        # 3. golden example through the CLI on the card
        t0 = time.time()
        golden_example(tmp)
        _phase("golden_example", t0,
               "examples/expected_results.csv reproduced byte for byte")

        # 4. real size
        t0 = time.time()
        genomes, dbs = build_headline_db(args.genomes, tmp)
        db = dbs["qs"]
        dbdir = str(tmp / "db_qs")
        stream_mb = stream_budget_mb(db)
        _phase("build_db", t0,
               f"{db.num_kmers} k-mers, {db.num_targets} targets; qs: "
               f"nb_bits {db.nb_bits}, stash_bits {db.stash_bits}, table "
               f"{db.table.nbytes / 1e9:.3f} GB; q4: nb_bits "
               f"{dbs['q4'].nb_bits}, table {dbs['q4'].table.nbytes / 1e9:.3f}"
               f" GB; s2 ({S2_SLOTS} slots, {S2_CHOICES} choices): nb_bits "
               f"{dbs['s2'].nb_bits}, table "
               f"{dbs['s2'].table.nbytes / 1e9:.3f} GB")
        t0 = time.time()
        fq, r1, r2 = tmp / "reads.fq", tmp / "r1.fq", tmp / "r2.fq"
        long_fq = tmp / "long.fq"
        codes, src = write_reads(genomes, args.reads, fq)
        write_pairs(genomes, args.reads, r1, r2)
        long_codes = write_long_reads(genomes, long_fq)
        _phase("write_reads", t0, f"{args.reads} reads of {READ_LEN} bp, "
               f"{args.reads} pairs of {READ_LEN} bp mates, {N_LONG} reads "
               f"of {LONG_MIN}-{LONG_MAX} bp")

        # the main-path batch shape: 65,536 reads in the 152 bin
        t0 = time.time()
        B = min(65536, args.reads)
        L = 152
        padded = np.full((args.reads, L), codec.INVALID, np.uint8)
        padded[:, :READ_LEN] = codes
        wire = [tuple(torch.from_numpy(a).to(dev)
                      for a in codec.pack_codes(padded[i:i + B]))
                for i in range(0, args.reads - B + 1, B)]
        main_t, stash_t = table_to_device(db, dev)
        qargs = dict(k=db.k, spec=db.spec)
        p2, vb = wire[0]
        lab = probe.query_labels(p2, vb, main_t, stash_t, **qargs)
        torch.cuda.synchronize()
        lab_plain = probe.query_labels_plain(p2, vb, main_t, stash_t,
                                             **qargs)
        if not torch.equal(lab, lab_plain):
            raise AssertionError("query kernel != plain on the real-size "
                                 "table")
        err["query"] = max(err["query"], tm.max_abs_err(lab, lab_plain))
        res = score.score_labels(lab)
        torch.cuda.synchronize()
        res_plain = score.score_labels_plain(lab)
        if not torch.equal(res, res_plain):
            raise AssertionError("score kernel != plain on the real-size "
                                 "labels")
        err["score"] = max(err["score"], tm.max_abs_err(res, res_plain))
        fused = probe.query_score_results(p2, vb, main_t, stash_t, **qargs)
        torch.cuda.synchronize()
        fused_plain = probe.query_score_results_plain(p2, vb, main_t,
                                                      stash_t, **qargs)
        if not (torch.equal(fused, fused_plain) and torch.equal(fused, res)):
            raise AssertionError("fused query and score != plain or != the "
                                 "query then score kernels on the real-size "
                                 "batch")
        err["query_score"] = max(err["query_score"],
                                 tm.max_abs_err(fused, fused_plain))
        del lab_plain, res_plain, fused, fused_plain
        unpacked = codec.unpack_codes(p2, vb)
        touched = tm.touched_rows(unpacked, db.spec, db.k, main_t)
        bound = {
            "query": tm.bound_ms(tm.query_bytes(touched, db.spec,
                                           p2.numel() + vb.numel(),
                                           4 * lab.numel())),
            "query_score": tm.bound_ms(tm.query_bytes(touched, db.spec,
                                                 p2.numel() + vb.numel(),
                                                 20 * B)),
            "score": tm.bound_ms(4 * lab.numel() + 20 * B),
            "classify_step": tm.bound_ms(tm.query_bytes(
                touched, db.spec, B * L, 20 * B)),
        }
        # the practical ceiling of the qs query's main-row gathers: the
        # gather-only kernel over this batch's main buckets, window order;
        # a part call gathers those of its range.  ceiling_stash: the same
        # over the main rows and the stash rows the query reads
        qs_rows = tm.qs_window_rows(unpacked, db.spec, db.k)
        buckets = qs_rows[:, 0].contiguous()
        ceiling = {"query": tm.gather_ceiling_ms(ceiling_lib, main_t, buckets)}
        read_rows = tm.qs_window_rows(unpacked, db.spec, db.k, main_t)
        stash_share = float((read_rows[:, 1] >= 0).float().mean())
        ceiling_stash = {"query": tm.gather_ceiling_stash_ms(
            ceiling_lib, main_t, stash_t, read_rows)}
        del read_rows
        rows = db.nb // STREAM_PARTS["qs"]
        part_main = [tm.gather_ceiling_ms(
            ceiling_lib, main_t, buckets[(buckets // rows) == j].contiguous())
            for j in range(STREAM_PARTS["qs"])]
        # the parts also gather the stash row of nearly every valid window
        # (a part holds both rows of few windows; the same gather-only
        # kernel over the stash rows, window order), split over the parts
        # as a table streams: a part's share is in its ceiling
        stash_ms = tm.gather_ceiling_ms(ceiling_lib, stash_t,
                                        qs_rows[:, 1].contiguous())
        ceiling["query_part_main"] = float(np.mean(part_main))
        ceiling["query_part"] = ceiling["query_part_main"] + (
            stash_ms / STREAM_PARTS["qs"])
        # a streamed batch's fused last part: the queued launch where the
        # route takes it (its launch key names the kernel's row)
        stream_key = fused_range_key(db.spec, rows, L - db.k + 1)
        stream_last = (stream_key if stream_key == "query_score_queue"
                       else "query_score_part_stream")
        ceiling[stream_last] = part_main[-1] + (
            stash_ms / STREAM_PARTS["qs"])
        del touched, unpacked
        for name in ("query_score", "classify_step", "build_sharded_classify",
                     "query_score_part", "build_sharded_classify_spanning"):
            ceiling[name] = ceiling["query"]
        # the calls over every main row read the stash as the query does
        for name in ("query_score", "classify_step", "query_score_part"):
            ceiling_stash[name] = ceiling_stash["query"]
        ceiling["build_sharded_probe_part"] = ceiling["query_part"]
        del buckets, qs_rows
        ms = {
            "query": tm.cuda_ms(lambda: probe.query_labels(
                p2, vb, main_t, stash_t, **qargs), 20),
            "query_plain": tm.cuda_ms(lambda: probe.query_labels_plain(
                p2, vb, main_t, stash_t, **qargs), 5),
            "query_score": tm.cuda_ms(lambda: probe.query_score_results(
                p2, vb, main_t, stash_t, **qargs), 20),
            "query_score_plain": tm.cuda_ms(
                lambda: probe.query_score_results_plain(
                    p2, vb, main_t, stash_t, **qargs), 5),
            "score": tm.cuda_ms(lambda: score.score_labels(lab), 20),
            "score_plain": tm.cuda_ms(lambda: score.score_labels_plain(lab),
                                    5),
        }

        def step_all():
            for a, b in wire:
                pipeline.classify_step_packed(
                    main_t, a, b, stash=stash_t, with_labels=False, **qargs)

        def two_kernels():
            for a, b in wire:
                score.score_labels(probe.query_labels(a, b, main_t, stash_t,
                                                      **qargs))

        kernels.reset_launches()
        step_ms = tm.cuda_ms(step_all, 10)
        if kernels.LAUNCHES["query_score"] != 11 * len(wire) or (
                kernels.LAUNCHES["query"] or kernels.LAUNCHES["score"]):
            raise AssertionError(f"the device step did not take the fused "
                                 f"kernel alone: {_launched(kernels.LAUNCHES)}")
        step_rps = len(wire) * B / (step_ms / 1e3)
        two_ms = tm.cuda_ms(two_kernels, 10)
        _phase("real_size_kernels", t0,
               f"[{B}, {L}] batch bit-identical; query {ms['query']:.4f} ms "
               f"(plain {ms['query_plain']:.4f}), score {ms['score']:.4f} "
               f"ms (plain {ms['score_plain']:.4f}), fused query and score "
               f"{ms['query_score']:.4f} ms (plain "
               f"{ms['query_score_plain']:.4f}); gather-only ceiling "
               f"{ceiling['query']:.4f} ms resident (main rows; "
               f"{ceiling_stash['query']:.4f} ms with the stash rows, read "
               f"for {stash_share:.2%} of the windows), "
               f"{ceiling['query_part']:.4f} ms per part of "
               f"{STREAM_PARTS['qs']} with its share of the stash "
               f"gathers ({stash_ms:.4f} ms in all), "
               f"{ceiling['query_part_main']:.4f} ms of main rows alone; "
               f"device step {step_rps:.1f} reads/s "
               f"fused, {len(wire) * B / (two_ms / 1e3):.1f} reads/s as "
               f"query then score, on {card}")

        # the paired shape: the first pairs of r1/r2 joined in the 320 bin
        # (P = 290, three tiles), the fused kernel of the paired path
        t0 = time.time()
        pwire = tuple(torch.from_numpy(a).to(dev)
                      for a in codec.pack_codes(joined_pairs(genomes, B)))
        # the fused kernel's row on the qs table, then on the q4 and s2
        # tables of the same k-mers, each beside the mate files through a
        # resident Classifier of the layout
        paired_rows = {}
        paired_rows["qs"], pres = tm.fused_row(
            *pwire, main_t, stash_t, k=db.k, spec=db.spec,
            ceiling_lib=ceiling_lib, two=True)
        for layout in ("q4", "s2"):
            paired_rows[layout] = check_paired_layout(
                dbs[layout], pwire, pres, r1, r2,
                tmp / f"paired_{layout}.csv", ceiling_lib, dev)
        layout_paired_launches = {}
        for layout, row in paired_rows.items():
            name = "query_score_290" + ("" if layout == "qs"
                                        else f"_{layout}")
            if layout != "qs":
                layout_paired_launches[name] = row["launches"]
            err[name] = row["max_abs_err"]
            ms[name], ms[f"{name}_plain"] = row["ms"], row["plain_ms"]
            bound[name], ceiling[name] = row["bound_ms"], row["ceiling_ms"]
            if "ceiling_stash_ms" in row:
                ceiling_stash[name] = row["ceiling_stash_ms"]
        torch.cuda.empty_cache()
        _phase("real_size_paired", t0,
               f"[{B}, 320] joined pairs (P = "
               f"{4 * pwire[0].shape[1] - db.k + 1})"
               f" bit-identical to plain and to query then score; fused "
               f"query and score {ms['query_score_290']:.4f} ms (plain "
               f"{ms['query_score_290_plain']:.4f}), query then score "
               f"{paired_rows['qs']['two_ms']:.4f} ms; gather-only ceiling "
               f"{ceiling['query_score_290']:.4f} ms (main rows; "
               f"{ceiling_stash['query_score_290']:.4f} ms with the stash "
               f"rows, read for {paired_rows['qs']['stash_share']:.2%} of "
               f"the windows), bytes bound "
               f"{bound['query_score_290']:.4f} ms; " + "; ".join(
                   f"{lay}: == qs, fused {r['ms']:.4f} ms (plain "
                   f"{r['plain_ms']:.4f}), query then score "
                   f"{r['two_ms']:.4f}, ceiling {r['ceiling_ms']:.4f}, "
                   f"bound {r['bound_ms']:.4f}, {r['launches']} launches on "
                   f"the mate files" for lay, r in paired_rows.items()
                   if lay != "qs")
               + f"; on {card}")

        # the same reads as unpacked codes through classify_step
        t0 = time.time()
        (err["classify_step"], ms["classify_step"],
         ms["classify_step_plain"], launches_codes, detail) = (
            check_classify_step(padded, B, main_t, stash_t, wire, lab, db,
                                dev, card))
        del padded
        _phase("classify_step", t0, detail)

        # the range query on the headline table cut in 4 parts (and in 2
        # and 8, and in db shards of 2 and 4), and the fused last part
        t0 = time.time()
        (err["query_part"], ms["query_part"], ms["query_part_plain"],
         bound["query_part"], last) = check_stream_kernels(
            main_t, stash_t, wire[0], db.k, db.spec, STREAM_PARTS["qs"],
            more=(2, 8))
        (err[stream_last], ms[stream_last], ms[f"{stream_last}_plain"],
         bound[stream_last], stream_old_ms) = last
        wire0 = wire[0]
        del main_t, stash_t, lab, res
        torch.cuda.empty_cache()
        _phase("stream_kernels_vs_plain", t0,
               f"range kernel bit-identical to plain on each part of "
               f"{STREAM_PARTS['qs']}, 2 and 8 of [{B}, {L}] (the stash "
               f"split over the parts, as a table streams; 2 and 4 are "
               f"also the db shards of a mesh), accumulated "
               f"== resident labels; {ms['query_part']:.4f} ms per part call "
               f"of {STREAM_PARTS['qs']} (plain "
               f"{ms['query_part_plain']:.4f}, bound "
               f"{bound['query_part']:.4f}, ceiling "
               f"{ceiling['query_part']:.4f}); fused last part "
               f"({stream_key}) {ms[stream_last]:.4f} ms (plain "
               f"{ms[stream_last + '_plain']:.4f}, bound "
               f"{bound[stream_last]:.4f}, ceiling "
               f"{ceiling[stream_last]:.4f}; query_score_kernel over the "
               f"same part {stream_old_ms:.4f} ms) == the resident "
               f"results; on {card}")

        # the resident main path, through the CLI: counts from this run
        t0 = time.time()
        gpu_csv, cpu_csv = tmp / "gpu.csv", tmp / "cpu.csv"
        _, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq),
                               "-R", str(gpu_csv), "--device", "cuda"],
                              ("query_score",))
        _phase("classify_cuda", t0, f"launches {launches}")
        launches.update(layout_paired_launches)

        # file -> CSV with the DB resident, timed apart from the DB load
        t0 = time.time()
        clf = pipeline.Classifier(db, device=dev)
        e2e = []
        for _ in range(2):
            t1 = time.time()
            n = clf.classify_file_to_csv(fq, tmp / "again.csv")
            torch.cuda.synchronize()
            e2e.append(n / (time.time() - t1))
        if (tmp / "again.csv").read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("a second classify wrote another CSV")
        # one more pass split by thread (scripts/torch_thread_split.py)
        from torch_thread_split import ThreadSplit, summary

        with ThreadSplit() as split:
            clf.classify_file_to_csv(fq, tmp / "again.csv")
            torch.cuda.synchronize()
        print("  file_to_csv " + summary(split.report(
            -(-args.reads // clf.cfg.batch_reads))), flush=True)
        if (tmp / "again.csv").read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("the split pass wrote another CSV")
        gzip_pass_split(clf, "file_to_csv", tmp / "again.csv", gpu_csv,
                        -(-args.reads // clf.cfg.batch_reads), fq)
        _phase("file_to_csv", t0,
               f"{', '.join(f'{r:.1f}' for r in e2e)} reads/s on {card}")

        t0 = time.time()
        run_cli(["classify", "-D", dbdir, "-O", str(fq), "-R", str(cpu_csv),
                 "--device", "cpu"])
        if cpu_csv.read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("--device cuda CSV differs from --device "
                                 "cpu CSV")
        n_rows = len(gpu_csv.read_text().splitlines()) - 1
        if n_rows != args.reads:
            raise AssertionError(f"{n_rows} CSV rows for {args.reads} reads")
        acc = assigned_right(gpu_csv)
        if acc < 0.99:
            raise AssertionError(f"only {acc:.4%} of reads assigned to "
                                 f"their source genome")
        _phase("classify_cpu_parity", t0,
               f"CSV identical to --device cpu; {acc:.6f} of reads "
               f"assigned to their source genome")

        # the streamed path: --max-table-mb 600 -> 4 parts of 268 MB
        # (a smaller budget for the smaller table of a quick run)
        t0 = time.time()
        stream_csv = tmp / "stream.csv"
        stderr, launches_stream = run_cli(
            ["classify", "-D", dbdir, "-O", str(fq), "-R", str(stream_csv),
             "--device", "cuda", "--max-table-mb", str(stream_mb)],
            ("query_part", stream_key))
        if launches_stream["score"] or launches_stream[
                stream_key] != -(-args.reads
                                 // ClassifyConfig().batch_reads):
            raise AssertionError(f"the streamed batches did not end in the "
                                 f"fused last part: {launches_stream}")
        if f"{STREAM_PARTS['qs']} bucket-range parts" not in stderr:
            raise AssertionError(f"--max-table-mb {stream_mb} did not stream "
                                 f"in {STREAM_PARTS['qs']} parts: {stderr}")
        if stream_csv.read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("streamed CSV differs from the resident "
                                 "CSV")
        sclf = pipeline.Classifier(db, ClassifyConfig(max_table_mb=stream_mb),
                                   device=dev)
        stream_e2e = []
        for _ in range(2):
            t1 = time.time()
            n = sclf.classify_file_to_csv(fq, tmp / "stream_again.csv")
            torch.cuda.synchronize()
            stream_e2e.append(n / (time.time() - t1))
        gbps = sclf.part_upload_gbps()
        group = [stream_group_breakdown(sclf, wire) for _ in range(2)][-1]
        sets = ("part calls" if group["call_ms"] > group["upload_ms"]
                else "part uploads")
        sclf.close()
        del sclf, wire
        if (tmp / "stream_again.csv").read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("a second streamed classify wrote another "
                                 "CSV")
        _phase("classify_stream", t0,
               f"{STREAM_PARTS['qs']} parts of "
               f"{db.nb // STREAM_PARTS['qs'] * 32 / 1e6:.1f}"
               f" MB, CSV identical to the resident CSV, launches "
               f"{launches_stream}; part upload "
               f"{', '.join(f'{g:.2f}' for g in gbps)} GB/s; one group of "
               f"{group['batches']} batches (stream_group_eff): wall "
               f"{group['wall_ms']:.4f} ms, {group['uploads']} part uploads "
               f"{group['upload_ms']:.4f} ms, {group['calls']} part calls "
               f"{group['call_ms']:.4f} ms on the card "
               f"({group['call_ms_per_batch']:.4f} ms a batch, "
               f"{group['call_ms'] / group['wall_ms']:.2%} of the wall): "
               f"the {sets} set the group's device time; results == "
               f"resident; "
               f"file->CSV "
               f"{', '.join(f'{r:.1f}' for r in stream_e2e)} reads/s on "
               f"{card}")

        # paired: mate 1 + N + mate 2 in the 320 bin, P = 290: the fused
        # query and score alone
        t0 = time.time()
        paired_csv = tmp / "paired.csv"
        _, launches_paired = run_cli(
            ["classify", "-D", dbdir, "-P", str(r1), str(r2),
             "-R", str(paired_csv), "--device", "cuda"], ("query_score",))
        if _launched(launches_paired).keys() != {"query_score"}:
            raise AssertionError(f"the paired run did not take the fused "
                                 f"kernel alone: {launches_paired}")
        acc_paired = assigned_right(paired_csv)
        if acc_paired < 0.99:
            raise AssertionError(f"only {acc_paired:.4%} of pairs assigned "
                                 f"to their source genome")
        n_cpu = min(16384, args.reads)
        sub_csv = tmp / "paired_cpu.csv"
        run_cli(["classify", "-D", dbdir, "-P",
                 str(head_fastq(r1, tmp / "s1.fq", n_cpu)),
                 str(head_fastq(r2, tmp / "s2.fq", n_cpu)),
                 "-R", str(sub_csv), "--device", "cpu"])
        for layout in ("q4", "s2"):
            if (tmp / f"paired_{layout}.csv").read_bytes() != (
                    paired_csv.read_bytes()):
                raise AssertionError(f"the paired CSV of the {layout} table "
                                     f"differs from the qs table's")
        head = paired_csv.read_bytes().split(b"\n")[:n_cpu + 1]
        if b"\n".join(head) + b"\n" != sub_csv.read_bytes():
            raise AssertionError(f"paired CSV of the first {n_cpu} pairs "
                                 f"differs from --device cpu's")
        paired_e2e = []
        for _ in range(2):
            t1 = time.time()
            n = clf.classify_file_to_csv(r1, tmp / "paired_again.csv", r2)
            torch.cuda.synchronize()
            paired_e2e.append(n / (time.time() - t1))
        if (tmp / "paired_again.csv").read_bytes() != paired_csv.read_bytes():
            raise AssertionError("a second paired classify wrote another "
                                 "CSV")
        # one more paired pass split by thread: the head's mate_check
        with ThreadSplit() as split:
            clf.classify_file_to_csv(r1, tmp / "paired_again.csv", r2)
            torch.cuda.synchronize()
        report = split.report(-(-args.reads // clf.cfg.batch_reads))
        print("  classify_paired " + summary(report), flush=True)
        if "mate_check" not in report["threads"]["MainThread"]["stages"]:
            raise AssertionError("the paired pass ran no mate-id check")
        if (tmp / "paired_again.csv").read_bytes() != paired_csv.read_bytes():
            raise AssertionError("the split paired pass wrote another CSV")
        gzip_pass_split(clf, "classify_paired", tmp / "paired_again.csv",
                        paired_csv, -(-args.reads // clf.cfg.batch_reads),
                        r1, r2)
        del clf
        torch.cuda.empty_cache()
        _phase("classify_paired", t0,
               f"{acc_paired:.6f} of {args.reads} pairs assigned to their "
               f"source genome, first {n_cpu} identical to --device cpu, "
               f"the q4 and s2 tables' paired CSVs identical, "
               f"launches {_launched(launches_paired)}; file->CSV "
               f"{', '.join(f'{r:.1f}' for r in paired_e2e)} pairs/s on "
               f"{card}")

        # extended: one count column per target, resident and streamed
        t0 = time.time()
        n_ext = min(1024, args.reads)
        ext_fq = head_fastq(fq, tmp / "ext.fq", n_ext)
        ext, ext_launches = {}, {}
        for name, device, flags, path_kernels in (
                ("cuda", "cuda", [], ("query", "score")),
                ("cuda_stream", "cuda", ["--max-table-mb", str(stream_mb)],
                 ("query_part", "score")),
                ("cpu", "cpu", [], ())):
            out = tmp / f"ext_{name}.csv"
            _, ext_launches[name] = run_cli(
                ["classify", "-D", dbdir, "-O", str(ext_fq), "-R", str(out),
                 "--device", device, "--extended", *flags], path_kernels)
            ext[name] = out.read_bytes()
        if not ext["cuda"] == ext["cuda_stream"] == ext["cpu"]:
            raise AssertionError("--extended CSVs differ between resident, "
                                 "streamed and --device cpu")
        cols = ext["cpu"].split(b"\n", 1)[0].count(b",") + 1
        _phase("extended", t0,
               f"{n_ext} reads x {cols} columns, {len(ext['cpu']) / 1e6:.1f} "
               f"MB of CSV identical resident, streamed and --device cpu")

        # a 2 x 2 mesh of four handles of the card: the sharded steps,
        # then Classifier(mesh) resident and streamed
        t0 = time.time()
        (mesh_err, mesh_ms, launches_mesh, detail, mesh_bound,
         resident_res) = check_mesh(
            db, tmp, fq, wire0, gpu_csv,
            (pwire, pres, r1, r2, paired_csv), dev, card,
            (dbs["q4"], dbs["s2"]), ceiling_lib)
        del pwire, pres
        bound.update(mesh_bound)
        for name, e in mesh_err.items():
            err[name] = max(err.get(name, 0), e)
        ms.update(mesh_ms)
        _phase("mesh", t0, detail)

        # two ranks over gloo, and two --num-hosts shards
        t0 = time.time()
        detail, span = check_multiprocess(tmp, dbdir, fq, gpu_csv, card,
                                          wire0, resident_res)
        del resident_res
        _phase("multiprocess", t0, detail)

        # the q4 and s2 tables of the same k-mers: kernels at real size,
        # then resident and streamed classify through the CLI
        head = head_fastq(fq, tmp / "head.fq", min(16384, args.reads))
        layout_last = {}
        for layout in ("q4", "s2"):
            t0 = time.time()
            (lay_err, lay_ms, lay_launches, detail, lay_bound,
             lay_ceiling) = check_layout(
                dbs.pop(layout), tmp, fq, head, ext_fq, tmp / "ext_cuda.csv",
                wire0, gpu_csv, ceiling_lib, dev, card)
            bound.update(lay_bound)
            ceiling.update(lay_ceiling)
            for name, e in lay_err.items():
                err[name] = max(err.get(name, 0), e)
            ms.update(lay_ms)
            launches.update(lay_launches)
            # the row of a streamed batch's last part (check_layout)
            layout_last[layout] = next(n for n in lay_launches if n.startswith(
                ("query_score_queue", "query_score_part_stream")))
            _phase(f"layouts_{layout}", t0, detail)
        del wire0
        torch.cuda.empty_cache()

        # reads over 32,768 bases: the score kernel's score_long entry
        t0 = time.time()
        (err["score_long"], ms["score_long"], ms["score_long_plain"],
         launches["score_long"], detail, bound["score_long"]) = (
            check_long_reads(tmp, db, dbdir, long_fq, long_codes, dev, card))
        _phase("long_reads", t0, detail)

        # examples/example.sh against the port, through its CLI on PATH
        t0 = time.time()
        _phase("example_sh", t0, check_example_sh(tmp))

        # the accuracy loop at the headline size, and the result tools
        t0 = time.time()
        targets = write_genome_files(genomes, tmp)
        detail = check_accuracy(genomes, targets, tmp, dbdir, args.reads,
                                card)
        del genomes
        _phase("accuracy", t0, detail)

        # CLARK .sz/.ky/.lb and .ht round trips, set-targets
        t0 = time.time()
        _phase("clark_interop", t0, check_clark_interop(
            db, dbdir, targets, tmp, fq, gpu_csv, card))

        # classify --profile: the trace against the launch counts
        t0 = time.time()
        _phase("profile", t0, check_profile(db, dbdir, fq, gpu_csv, codes,
                                            tmp, dev, card))

        # bench_torch.py at reduced knobs, in a process of its own
        t0 = time.time()
        del db, dbs
        torch.cuda.empty_cache()
        _phase("bench", t0, check_bench(tmp, card))

    # the resident 150 bp and the paired paths run the fused query and
    # score alone; the query and score kernels' own path is --extended
    kern = [
        {"name": "query_score", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/pipeline.py:71",
         "launches": launches["query_score"],
         "max_abs_err": err["query_score"], "ms": ms["query_score"],
         "plain_ms": ms["query_score_plain"]},
        {"name": "query_score_290", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/pipeline.py:71",
         "launches": launches_paired["query_score"],
         "max_abs_err": err["query_score_290"],
         "ms": ms["query_score_290"],
         "plain_ms": ms["query_score_290_plain"]},
        {"name": "query", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/probe.py:198",
         "launches": ext_launches["cuda"]["query"],
         "max_abs_err": err["query"],
         "ms": ms["query"], "plain_ms": ms["query_plain"]},
        {"name": "query_part", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/pipeline.py:96",
         "launches": launches_stream["query_part"],
         "max_abs_err": err["query_part"],
         "ms": ms["query_part"], "plain_ms": ms["query_part_plain"]},
        # each streamed batch's last part: the fused range launch with the
        # earlier parts' sum (acc_in), queued where the route takes it
        {"name": stream_last, "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/pipeline.py:96",
         "launches": launches_stream[stream_key],
         "max_abs_err": err[stream_last],
         "ms": ms[stream_last],
         "plain_ms": ms[f"{stream_last}_plain"]},
        {"name": "score", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/score.cu",
         "replaces": "cuclark_tpu/score.py:28",
         "launches": ext_launches["cuda"]["score"],
         "max_abs_err": err["score"],
         "ms": ms["score"], "plain_ms": ms["score_plain"]},
    ]
    for name, replaces in (("query_score_q4", "cuclark_tpu/pipeline.py:71"),
                           ("query_score_290_q4",
                            "cuclark_tpu/pipeline.py:71"),
                           ("query_q4", "cuclark_tpu/probe.py:236"),
                           ("query_part_q4", "cuclark_tpu/probe.py:236"),
                           (layout_last["q4"], "cuclark_tpu/pipeline.py:96"),
                           ("query_score_s2", "cuclark_tpu/pipeline.py:71"),
                           ("query_score_290_s2",
                            "cuclark_tpu/pipeline.py:71"),
                           ("query_s2", "cuclark_tpu/probe.py:131"),
                           ("query_part_s2", "cuclark_tpu/probe.py:131"),
                           (layout_last["s2"], "cuclark_tpu/pipeline.py:96")):
        kern.append({"name": name, "route": "cuda",
                     "source": "cuclark_tpu_torch/csrc/query.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": ms[f"{name}_plain"]})
    kern.append({"name": "score_long", "route": "cuda",
                 "source": "cuclark_tpu_torch/csrc/score.cu",
                 "replaces": "cuclark_tpu/score.py:28",
                 "launches": launches["score_long"],
                 "max_abs_err": err["score_long"], "ms": ms["score_long"],
                 "plain_ms": ms["score_long_plain"]})
    # the mesh's steps: launches are their range launches on the main
    # path's mesh run; query_score_part is each block's last launch there,
    # timed as the 1 x 1 mesh's one launch over the whole table
    ms["build_sharded_classify_spanning"] = span["ms"]
    ms["build_sharded_classify_spanning_plain"] = span["plain_ms"]
    err["build_sharded_classify_spanning"] = span["max_abs_err"]
    # the two ranks together query the whole table into labels, once
    bound["build_sharded_classify_spanning"] = bound["query"]
    for name, replaces, n in (
            ("query_score_part", "cuclark_tpu/parallel/mesh.py:96",
             launches_mesh["query_score_part"]),
            ("build_sharded_classify", "cuclark_tpu/parallel/mesh.py:96",
             launches_mesh["build_sharded_classify"]),
            ("build_sharded_probe_part", "cuclark_tpu/parallel/mesh.py:164",
             launches_mesh["build_sharded_probe_part"]),
            ("build_sharded_classify_spanning",
             "cuclark_tpu/parallel/mesh.py:96", span["launches"]),
            ("classify_step", "cuclark_tpu/pipeline.py:48", launches_codes)):
        kern.append({"name": name, "route": "cuda",
                     "source": "cuclark_tpu_torch/csrc/query.cu",
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": ms[f"{name}_plain"]})
    for entry in kern:
        # no single PyTorch call computes any of these functions; the
        # gather ceiling is that of the rows an exact probe of the
        # kernel's table gathers (a resident qs step's main rows, and
        # with ceiling_stash_ms both its rows a window)
        entry.update(bound_ms=bound[entry["name"]], bound_by="bytes",
                     library_ms=None,
                     ceiling_ms=ceiling.get(entry["name"]),
                     ceiling_stash_ms=ceiling_stash.get(entry["name"]))
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
