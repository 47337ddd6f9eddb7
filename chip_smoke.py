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

  - resident: the table on the card (query and score kernels);
  - streamed: `--max-table-mb 600`, the table in 4 bucket-range parts of
    268 MB uploaded per group of batches (part-mode query kernel);
  - paired: 131,072 pairs of 150 bp mates from 400 bp fragments (-P);
  - extended: 1,024 reads with one count column per target, resident
    and streamed (--extended);
  - layouts: the same k-mers in a q4 table (1.074 GB) and an s2 table
    (2 slots, 2 hash choices: 1.611 GB), resident and streamed (4 and 8
    parts at `--max-table-mb 600`), each CSV equal to the qs CSV;
  - long_reads: 256 reads of 33,000 to 100,000 bases (the score
    kernel's `score_long` entry for rows over 32,768 windows);
  - classify_step: the 131,072 reads as unpacked codes through
    `pipeline.classify_step` (the query kernel's codes front half);
  - mesh: a 2 data x 2 db mesh of four handles of the one card, each db
    shard (a main range and a stash range) against plain, and
    `Classifier(db, mesh=...)` resident and streamed (each device's
    shard in 4 parts), each CSV equal to the resident CSV;
  - multiprocess: two ranks of `classify --coordinator` over gloo on the
    card, and two `--num-hosts 2` runs, each pair's CSVs concatenating
    to the resident CSV.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
K = 31
READ_LEN = 150
FRAGMENT = 400             # paired: mate 1 = [0, 150), mate 2 = [250, 400)
GENOME_LEN = 3936          # 3,906 31-mers per genome: 64.0M for 16,384
SUB_RATE = 0.01
STREAM_MB = 600            # cuCLARK-l's "< 600 MB DB" budget: 4 parts
STREAM_PARTS = {"qs": 4, "q4": 4, "s2": 8}   # at STREAM_MB, full size
S2_SLOTS, S2_CHOICES = 2, 2
N_LONG, LONG_MIN, LONG_MAX = 256, 33_000, 100_000


def _phase(name: str, t0: float, detail: str) -> None:
    print(f"phase {name}: ok, {detail} ({time.time() - t0:.2f} s)",
          flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype) - b).abs().max().item()) if a.numel() else 0


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)


def _bound_ms(nbytes: float) -> float:
    """The least time to move nbytes through device memory, in ms: the
    bound of every kernel here (bytes; their integer operations need far
    less time at the card's rates)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def touched_rows(codes, spec, k: int):
    """The rows that the valid windows of codes [R, L] on the card make a
    query read: (distinct global main buckets, sorted; distinct stash
    buckets of a qs table, else None), each row read once."""
    import torch

    from cuclark_tpu_torch import codec
    from cuclark_tpu_torch.hashdb import (feistel_mix_torch, mix1_torch,
                                          mix2_torch)

    kmers, valid = codec.extract_kmers(codes, k)
    km = codec.canonical(kmers, k)[valid]
    hi, lo = codec.shr(km, 32), km & 0xFFFFFFFF
    mask = (1 << spec.nb_bits) - 1
    stash = None
    if spec.layout == "s2":
        main = [mix1_torch(hi, lo) & mask]
        if spec.num_choices == 2:
            main.append(mix2_torch(hi, lo) & mask)
    else:
        h1, l2 = feistel_mix_torch(hi, lo, spec.seed)
        main = [l2 & mask] + ([h1 & mask] if spec.layout == "q4" else [])
        if spec.layout == "qs":
            stash = torch.unique(h1 & ((1 << spec.stash_bits) - 1))
    return torch.unique(torch.cat(main)), stash


def query_bytes(touched, spec, in_bytes: int, out_bytes: int,
                parts: int = 1) -> float:
    """Least bytes of a query per call: its input (wire or codes) and its
    output once, and each table row it needs once (qs stash rows 32 B).
    Over a pass of `parts` part calls, every call reads the input and
    the first writes the labels, each later one reads and writes them
    (the accumulator); the table rows split over the parts."""
    main, stash = touched
    rows = spec.row_words * 4 * len(main) + (32 * len(stash)
                                             if stash is not None else 0)
    return (parts * in_bytes + (2 * parts - 1) * out_bytes + rows) / parts


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
    """Query kernel vs plain on a small qs table with stash entries."""
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
    err = {"query": _max_abs_err(got, want),
           "build_sharded_classify": check_stash_ranges(p2, vb, main, stash,
                                                        got, **args),
           "classify_step": check_codes(p2, vb, main, stash, got, **args)}
    print(f"  k={k}: {got.numel()} windows bit-identical, {n_hit} hits, "
          f"{n_stash} from the stash; 2 and 4 db shards with stash ranges "
          f"and the codes front half bit-identical", flush=True)
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
                err = max(err, _max_abs_err(a, want))
            if int((only > 0).sum()) == 0:
                raise AssertionError(f"no hit from the stash range of shard "
                                     f"{j} of {num_db} at k={k}")
            total = got if total is None else total + got
        if not torch.equal(total, resident):
            raise AssertionError(f"{num_db} db shards != resident at k={k}")
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
    return _max_abs_err(got, want)


def _second_choice_only(db) -> np.ndarray:
    """A q4 or s2 table with every entry stored at its first hash choice
    removed: what remains answers from the second choice alone."""
    from cuclark_tpu_torch import hashdb

    t = db.table.copy()
    if db.layout == "q4":
        first = ((t[:, 4:] >> np.uint32(16)) & np.uint32(1)) == 0
        t[:, :4][first] = 0
        t[:, 4:][first] = 0
        return t
    S = db.slots
    with np.errstate(over="ignore"):
        b1 = hashdb.mix1(t[:, S:2 * S], t[:, :S]) & np.uint32(db.nb - 1)
    first = b1 == np.arange(db.nb, dtype=np.uint32)[:, None]
    t[:, :2 * S][np.concatenate([first, first], axis=1)] = hashdb.EMPTY
    return t


def check_small_layout(dev, layout: str, k: int) -> dict:
    """The q4 or s2 query kernel vs plain on a small table, resident and
    on 4 bucket-range parts written and accumulated, with hits from the
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
    err = {f"query_{layout}": 0, f"query_part_{layout}": 0}
    n_second = 0
    for table in (db.table, _second_choice_only(db)):
        main = torch.from_numpy(table.view(np.int32)).to(dev)
        got = probe.query_labels(p2, vb, main, None, k=k, spec=db.spec)
        torch.cuda.synchronize()
        want = probe.query_labels_plain(p2, vb, main, None, k=k,
                                        spec=db.spec)
        if not torch.equal(got, want):
            raise AssertionError(f"{layout} query kernel != plain at k={k}")
        err[f"query_{layout}"] = max(err[f"query_{layout}"],
                                     _max_abs_err(got, want))
        err["classify_step"] = max(err.get("classify_step", 0), check_codes(
            p2, vb, main, None, got, k=k, spec=db.spec))
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
                err[f"query_part_{layout}"], _max_abs_err(one, one_plain),
                _max_abs_err(acc, acc_plain))
        if not torch.equal(acc, got):
            raise AssertionError(f"{layout} parts != resident at k={k}")
        n_second = int((want > 0).sum())
    if n_second == 0:
        raise AssertionError(f"no {layout} hit from the second hash choice "
                             f"alone at k={k}")
    print(f"  {layout} k={k}: {got.numel()} windows bit-identical resident, "
          f"in 4 parts and from codes, {n_second} hits from the second "
          f"choice alone", flush=True)
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
    return _max_abs_err(got, want)


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


def build_headline_db(n_genomes: int, tmp: Path | None):
    """Random genomes (numpy, seed 0) -> canonical 31-mers -> keep the
    target-specific ones (builder.discriminate) -> a qs, a q4 and an s2
    table of those k-mers through the port's build_table -> the .npz
    files that `classify -D` loads, in tmp/db_<layout> (none when tmp is
    None).  Returns the genomes and the tables by layout."""
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
    for layout in ("qs", "q4", "s2"):
        cfg = DBConfig(k=K, target_load=0.85, layout=layout,
                       slots=S2_SLOTS, num_choices=S2_CHOICES)
        dbs[layout] = build_table(kmers, labels, names, cfg)
        if tmp is None:
            continue
        dbdir = tmp / f"db_{layout}"
        dbdir.mkdir(parents=True, exist_ok=True)
        dbs[layout].save(dbdir / db_name(cfg, n_genomes))
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


def head_fastq(src: Path, dst: Path, n: int) -> Path:
    """The first n records of a 4-line FASTQ file."""
    with open(src) as f:
        lines = [next(f) for _ in range(4 * n)]
    dst.write_text("".join(lines))
    return dst


def run_cli(argv, launches_of=None):
    """cuclark-tpu-torch with stdout and stderr captured -> (stderr,
    kernel launches of this run).  Raises on a non-zero return."""
    from cuclark_tpu_torch import cli, kernels

    import torch

    err = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if rc:
        raise AssertionError(f"{' '.join(argv[:1] + argv[-4:])} returned "
                             f"{rc}: {err.getvalue()[-2000:]}")
    for name in launches_of or ():
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} of the path never "
                                 f"launched: {launches}")
    return err.getvalue(), launches


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


def check_stream_kernels(main_t, stash_t, wire, k, spec, parts):
    """The part-mode query kernel against its plain version on each of
    `parts` bucket-range parts of a resident headline table, a qs stash
    on part 0 only, writing and accumulating; the accumulated parts equal
    the resident query.  Returns (max_abs_err, ms, plain ms, bound ms)
    per part call, the times over a whole pass of the parts."""
    import torch

    from cuclark_tpu_torch import codec, probe

    p2, vb = wire
    rows = main_t.shape[0] // parts
    pieces = [main_t[p * rows:(p + 1) * rows] for p in range(parts)]

    def one(fn, p, acc=None):
        return fn(p2, vb, pieces[p], stash_t if p == 0 else None,
                  bucket_start=p * rows, nb_local=rows, acc=acc, k=k,
                  spec=spec)

    def all_parts(fn):
        acc = None
        for p in range(parts):
            acc = one(fn, p, acc)
        return acc

    err = 0
    for p in range(parts):
        got = one(probe.query_part_labels, p)
        torch.cuda.synchronize()
        want = one(probe.query_part_labels_plain, p)
        if not torch.equal(got, want):
            raise AssertionError(f"{spec.layout} part kernel != plain on "
                                 f"part {p}: {int((got != want).sum())} "
                                 f"windows differ")
        err = max(err, _max_abs_err(got, want))
    acc = all_parts(probe.query_part_labels)
    torch.cuda.synchronize()
    acc_plain = all_parts(probe.query_part_labels_plain)
    resident = probe.query_labels(p2, vb, main_t, stash_t, k=k, spec=spec)
    torch.cuda.synchronize()
    if not (torch.equal(acc, acc_plain) and torch.equal(acc, resident)):
        raise AssertionError(f"{spec.layout} accumulated parts != plain or "
                             f"!= resident labels")
    err = max(err, _max_abs_err(acc, acc_plain))
    ms = _cuda_ms(lambda: all_parts(probe.query_part_labels), 10)
    plain_ms = _cuda_ms(lambda: all_parts(probe.query_part_labels_plain), 2)
    bound = _bound_ms(query_bytes(
        touched_rows(codec.unpack_codes(p2, vb), spec, k), spec,
        p2.numel() + vb.numel(), 4 * acc.numel(), parts))
    return err, ms / parts, plain_ms / parts, bound


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


def check_layout(db, tmp: Path, fq: Path, head: Path, wire, qs_csv: Path,
                 dev, card: str):
    """A q4 or s2 headline table: the query kernel on one main-path
    batch ([65536, 152] at full size), resident and per part call,
    against plain; then the CLI on the
    card, resident and streamed, each CSV equal to the qs CSV; two timed
    file->CSV passes; and --device cpu on the head of the reads.  Returns
    (max_abs_err, ms, launches, phase detail, bound ms) keyed by launch
    name."""
    import torch

    from cuclark_tpu_torch import codec, pipeline, probe
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import table_to_device

    layout, parts = db.layout, STREAM_PARTS[db.layout]
    res_name, part_name = f"query_{layout}", f"query_part_{layout}"
    dbdir = str(tmp / f"db_{layout}")
    stream_mb = stream_budget_mb(db)
    p2, vb = wire
    main_t, _ = table_to_device(db, dev)
    lab = probe.query_labels(p2, vb, main_t, None, k=db.k, spec=db.spec)
    torch.cuda.synchronize()
    lab_plain = probe.query_labels_plain(p2, vb, main_t, None, k=db.k,
                                         spec=db.spec)
    if not torch.equal(lab, lab_plain):
        raise AssertionError(f"{layout} query kernel != plain on the "
                             f"real-size table")
    err = {res_name: _max_abs_err(lab, lab_plain)}
    lab_shape = lab.shape
    bound = {res_name: _bound_ms(query_bytes(
        touched_rows(codec.unpack_codes(p2, vb), db.spec, db.k), db.spec,
        p2.numel() + vb.numel(), 4 * lab.numel()))}
    del lab, lab_plain
    ms = {res_name: _cuda_ms(lambda: probe.query_labels(
              p2, vb, main_t, None, k=db.k, spec=db.spec), 20),
          f"{res_name}_plain": _cuda_ms(lambda: probe.query_labels_plain(
              p2, vb, main_t, None, k=db.k, spec=db.spec), 5)}
    (err[part_name], ms[part_name], ms[f"{part_name}_plain"],
     bound[part_name]) = check_stream_kernels(main_t, None, wire, db.k,
                                              db.spec, parts)
    del main_t
    torch.cuda.empty_cache()

    csv, stream_csv = tmp / f"{layout}.csv", tmp / f"{layout}_stream.csv"
    _, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq), "-R",
                           str(csv), "--device", "cuda"], (res_name, "score"))
    if csv.read_bytes() != qs_csv.read_bytes():
        raise AssertionError(f"{layout} CSV differs from the qs CSV")
    stderr, launches_stream = run_cli(
        ["classify", "-D", dbdir, "-O", str(fq), "-R", str(stream_csv),
         "--device", "cuda", "--max-table-mb", str(stream_mb)],
        (part_name, "score"))
    if f"{parts} bucket-range parts" not in stderr:
        raise AssertionError(f"{layout} --max-table-mb {stream_mb} did not "
                             f"stream in {parts} parts: {stderr}")
    if stream_csv.read_bytes() != qs_csv.read_bytes():
        raise AssertionError(f"{layout} streamed CSV differs from the qs "
                             f"CSV")
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
    cpu_csv = tmp / f"{layout}_cpu.csv"
    run_cli(["classify", "-D", dbdir, "-O", str(head), "-R", str(cpu_csv),
             "--device", "cpu"])
    n_head = len(cpu_csv.read_bytes().split(b"\n")) - 2
    want = b"\n".join(qs_csv.read_bytes().split(b"\n")[:n_head + 1]) + b"\n"
    if cpu_csv.read_bytes() != want:
        raise AssertionError(f"{layout} --device cpu CSV of the first "
                             f"{n_head} reads differs from the card's")
    torch.cuda.empty_cache()
    part_mb = db.table.nbytes / parts / 1e6
    detail = (f"{db.table.nbytes / 1e9:.3f} GB table, nb_bits "
              f"{db.nb_bits}; labels {list(lab_shape)} bit-identical, query "
              f"{ms[res_name]:.4f} ms (plain {ms[res_name + '_plain']:.4f}),"
              f" {ms[part_name]:.4f} ms per part call of {parts} (plain "
              f"{ms[part_name + '_plain']:.4f}); resident CSV == qs CSV, "
              f"launches {launches}; {parts} parts of {part_mb:.1f} MB, CSV "
              f"== qs CSV, launches {launches_stream}; file->CSV resident "
              f"{', '.join(f'{r:.1f}' for r in rates['resident'])}, streamed "
              f"{', '.join(f'{r:.1f}' for r in rates['streamed'])} reads/s; "
              f"first {n_head} reads identical to --device cpu; on {card}")
    return (err, ms, {res_name: launches[res_name],
                      part_name: launches_stream[part_name]}, detail, bound)


def check_long_reads(tmp: Path, db, dbdir: str, long_fq: Path, long_codes,
                     dev, card: str):
    """Reads of LONG_MIN to LONG_MAX bases against the qs headline table:
    the score kernel's `score_long` entry against plain on the labels of
    the batch the main path gives it, then `classify --device cuda` (which
    must launch score_long) equal to --device cpu byte for byte.  Returns
    (max_abs_err, ms, plain ms, launches, phase detail, bound ms)."""
    import torch

    from cuclark_tpu_torch import codec, probe, score
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
    res = score.score_labels(lab)
    torch.cuda.synchronize()
    res_plain = score.score_labels_plain(lab)
    if not torch.equal(res, res_plain):
        raise AssertionError(f"score_long kernel != plain at "
                             f"{list(lab.shape)}")
    err = _max_abs_err(res, res_plain)
    ms = _cuda_ms(lambda: score.score_labels(lab), 5)
    plain_ms = _cuda_ms(lambda: score.score_labels_plain(lab), 2)
    shape = list(lab.shape)
    bound = _bound_ms(4 * lab.numel() + 20 * lab.shape[0])
    del lab, res, res_plain
    torch.cuda.empty_cache()
    gpu_csv, cpu_csv = tmp / "long_gpu.csv", tmp / "long_cpu.csv"
    _, launches = run_cli(["classify", "-D", dbdir, "-O", str(long_fq),
                           "-R", str(gpu_csv), "--device", "cuda"],
                          ("query", "score_long"))
    run_cli(["classify", "-D", dbdir, "-O", str(long_fq), "-R",
             str(cpu_csv), "--device", "cpu"])
    if gpu_csv.read_bytes() != cpu_csv.read_bytes():
        raise AssertionError("long-read CSV of --device cuda differs from "
                             "--device cpu")
    rows = gpu_csv.read_text().splitlines()[1:]
    if len(rows) != len(long_codes) or any(r.split(",")[-5] == "NA" for r in rows):
        raise AssertionError(f"{len(rows)} long-read rows, or an "
                             f"unassigned one, for {len(long_codes)} reads")
    detail = (f"{N_LONG} reads, score_long on {shape} bit-identical, "
              f"{ms:.4f} ms (plain {plain_ms:.4f}); CSV identical to "
              f"--device cpu, launches {launches}; on {card}")
    return err, ms, plain_ms, launches["score_long"], detail, bound


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
    err = _max_abs_err(outs[0][1], want)
    del outs, want
    ms = _cuda_ms(lambda: pipeline.classify_step(
        main_t, codes[0], stash=stash_t, with_labels=False, **qargs), 20)
    plain_ms = _cuda_ms(lambda: score.score_labels_plain(
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


def check_mesh(db, tmp: Path, fq: Path, wire, gpu_csv: Path, dev,
               card: str):
    """A 2 data x 2 db mesh of four handles of the card: each db shard's
    labels of the main-path batch against plain, their sum against the
    resident labels; the sharded resident step and the sharded part step
    (4 parts, the stash on part 0) against their plain versions; then
    `Classifier(db, mesh=...)` file->CSV, resident and with each device's
    shard streamed in 4 parts, twice each, every CSV equal to the
    resident one.  The counts reset just before each Classifier's runs.
    Returns (max_abs_err, ms, launches, phase detail, bound ms) keyed by
    the JAX function."""
    import torch

    from cuclark_tpu_torch import codec, kernels, pipeline, probe, score
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import table_to_device
    from cuclark_tpu_torch.parallel import mesh

    m = mesh.make_mesh(2, 2, [dev] * 4)
    p2, vb = wire
    main_t, stash_t = table_to_device(db, dev)
    qargs = dict(k=db.k, spec=db.spec)
    resident = probe.query_labels(p2, vb, main_t, stash_t, **qargs)
    nb, nbs = main_t.shape[0], stash_t.shape[0]
    touched = touched_rows(codec.unpack_codes(p2, vb), db.spec, db.k)
    wire_b, lab_b = p2.numel() + vb.numel(), 4 * resident.numel()
    bound = {"build_sharded_classify": _bound_ms(query_bytes(
                 touched, db.spec, wire_b, lab_b + 20 * p2.shape[0])),
             "build_sharded_probe_part": _bound_ms(query_bytes(
                 touched, db.spec, wire_b, lab_b, 4))}
    smain, sstash = mesh.shard_db_table(db, m)
    err = {"build_sharded_classify": 0, "build_sharded_probe_part": 0}
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
                                            _max_abs_err(got, want))
        total = got if total is None else total + got
    if not torch.equal(total, resident):
        raise AssertionError("the 2 db shards' labels != resident labels")
    del got, want, total

    wires = mesh.place_wire(m, p2.cpu().numpy(), vb.cpu().numpy())
    step, plain_step = (mesh.build_sharded_classify(
        m, nb_total=nb, nbs_total=nbs, plain=plain, **qargs)
        for plain in (False, True))
    res, lab = step(smain, sstash, wires)
    torch.cuda.synchronize()
    pres, plab = plain_step(smain, sstash, wires)
    lab, plab = torch.cat(lab), torch.cat(plab)
    res, pres = torch.cat(res), torch.cat(pres)
    if not (torch.equal(lab, plab) and torch.equal(res, pres)
            and torch.equal(lab, resident)
            and torch.equal(res, score.score_labels(resident))):
        raise AssertionError("sharded step != plain or != resident")
    err["build_sharded_classify"] = max(err["build_sharded_classify"],
                                        _max_abs_err(lab, plab),
                                        _max_abs_err(res, pres))
    del lab, plab, res, pres
    ms["build_sharded_classify"] = _cuda_ms(
        lambda: step(smain, sstash, wires), 20)
    ms["build_sharded_classify_plain"] = _cuda_ms(
        lambda: plain_step(smain, sstash, wires), 3)

    rows = nb // 4
    pstep, plain_pstep = (mesh.build_sharded_probe_part(
        m, nb_part=rows, plain=plain, **qargs) for plain in (False, True))

    def part(p):
        return [[main_t[p * rows + j * rows // 2:p * rows + (j + 1) * rows
                        // 2] for j in range(2)] for _ in range(2)]

    def all_parts(fn):
        acc = None
        for p in range(4):
            acc = fn(part(p), wires, p * rows,
                     stash=sstash if p == 0 else None, acc=acc)
        return acc

    for p in range(4):
        got = pstep(part(p), wires, p * rows, stash=sstash if p == 0 else None)
        torch.cuda.synchronize()
        want = plain_pstep(part(p), wires, p * rows,
                           stash=sstash if p == 0 else None)
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded part step != plain on part {p}")
            err["build_sharded_probe_part"] = max(
                err["build_sharded_probe_part"], _max_abs_err(a, b))
    if not torch.equal(torch.cat(all_parts(pstep)), resident):
        raise AssertionError("sharded parts' sum != resident labels")
    ms["build_sharded_probe_part"] = _cuda_ms(lambda: all_parts(pstep), 10) / 4
    ms["build_sharded_probe_part_plain"] = _cuda_ms(
        lambda: all_parts(plain_pstep), 2) / 4
    del main_t, stash_t, smain, sstash, resident, wires
    torch.cuda.empty_cache()

    launches, rates, gbps = {}, {}, []
    budget = mesh_stream_budget_mb(db, 2, 4)
    for name, cfg, jax_fn in (
            ("resident", None, "build_sharded_classify"),
            ("streamed", ClassifyConfig(max_table_mb=budget),
             "build_sharded_probe_part")):
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
        launches[jax_fn] = dict(kernels.LAUNCHES)
        if (launches[jax_fn]["query_part"] < 1 or launches[jax_fn]["score"] < 1
                or launches[jax_fn]["query"]):
            raise AssertionError(f"mesh {name} launches {launches[jax_fn]}")
        torch.cuda.empty_cache()
    detail = (f"2 data x 2 db, four handles of the one card ({card}); db "
              f"shards of [{p2.shape[0]}, {4 * p2.shape[1]}] bit-identical, "
              f"sum == resident; sharded step "
              f"{ms['build_sharded_classify']:.4f} ms (plain "
              f"{ms['build_sharded_classify_plain']:.4f}), sharded part "
              f"step {ms['build_sharded_probe_part']:.4f} ms per part of 4 "
              f"(plain {ms['build_sharded_probe_part_plain']:.4f}); "
              f"Classifier(mesh) CSV == resident CSV, file->CSV "
              f"{', '.join(f'{r:.1f}' for r in rates['resident'])} reads/s, "
              f"launches {launches['build_sharded_classify']}; streamed at "
              f"--max-table-mb {budget} (4 parts per device), CSV == "
              f"resident CSV, {', '.join(f'{r:.1f}' for r in rates['streamed'])}"
              f" reads/s, part uploads "
              f"{', '.join(f'{g:.2f}' for g in gbps)} GB/s, launches "
              f"{launches['build_sharded_probe_part']}")
    return (err, ms, {k: v["query_part"] for k, v in launches.items()},
            detail, bound)


_RANK_MAIN = ("import json, sys\n"
                "from cuclark_tpu_torch import cli, kernels\n"
                "rc = cli.main(sys.argv[1:])\n"
                "print(json.dumps(kernels.LAUNCHES))\n"
                "raise SystemExit(rc)\n")


def check_multiprocess(tmp: Path, dbdir: str, fq: Path, gpu_csv: Path,
                       card: str) -> str:
    """Two ranks of `classify --device cuda --coordinator` on the card,
    over gloo: .h000 + .h001 must equal the resident CSV, and each rank
    (whose last stdout line is its kernel launches) must have launched
    the query and score kernels.  Then `--num-hosts 2 --host-id 0|1`:
    the two CSVs' rows concatenate to the resident CSV's."""
    import re
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    out = tmp / "mp.csv"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, "classify", "-D", dbdir, "-O",
         str(fq), "-R", str(out), "--device", "cuda", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
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
    rank_rates, rank_launches = [], []
    for r, (pr, (so, se)) in enumerate(zip(procs, outs)):
        if pr.returncode:
            raise AssertionError(f"rank {r} returned {pr.returncode}: "
                                 f"{se[-2000:]}")
        launches = json.loads(so.strip().splitlines()[-1])
        if launches["query_part"] < 1 or launches["score"] < 1:
            raise AssertionError(f"rank {r} launches {launches}")
        rank_launches.append(launches)
        t = re.search(r"Assignment time: ([\d.e+-]+) s\..*\((\d+) objects",
                      so)
        rank_rates.append(int(t.group(2)) / float(t.group(1)))
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
                               "2", "--host-id", str(h)], ("query", "score"))
        host_launches.append(launches["query"])
        lines = part.read_bytes().split(b"\n")
        rows += lines[:-1] if h == 0 else lines[1:-1]
    if b"\n".join(rows) + b"\n" != gpu_csv.read_bytes():
        raise AssertionError("--num-hosts 2 shards differ from the resident "
                             "CSV")
    return (f"two ranks on one card ({card}) over gloo: .h000 + .h001 == "
            f"resident CSV, {', '.join(f'{x:.1f}' for x in rank_rates)} "
            f"reads/s per rank (each rank's file->CSV incl. its scan), "
            f"query_part/score launches "
            f"{[(x['query_part'], x['score']) for x in rank_launches]}; "
            f"--num-hosts 2 shards == resident CSV, query launches "
            f"{host_launches}")


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
    if not (ROOT / "cuclark_tpu_torch" / "__init__.py").is_file():
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
    kernels.load()
    _phase("build", t0, f"{'loaded' if cached else 'built'} "
           f"{kernels.library_path().relative_to(ROOT)}")

    # 2. each kernel against its plain version on the card
    t0 = time.time()
    err = {"query": 0, "score": 0, "score_long": 0}
    for k in (27, 32):
        checks = [check_small_query(dev, k)] + [
            check_small_layout(dev, layout, k) for layout in ("q4", "s2")]
        for one in checks:
            for name, e in one.items():
                err[name] = max(err.get(name, 0), e)
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
           "qs db shards with stash ranges, codes front half) and score "
           "(warp and histogram paths, both label ranges) bit-identical")

    with tempfile.TemporaryDirectory(prefix="cuclark_smoke_") as td:
        tmp = Path(td)

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
        del genomes
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
        err["query"] = max(err["query"], _max_abs_err(lab, lab_plain))
        res = score.score_labels(lab)
        torch.cuda.synchronize()
        res_plain = score.score_labels_plain(lab)
        if not torch.equal(res, res_plain):
            raise AssertionError("score kernel != plain on the real-size "
                                 "labels")
        err["score"] = max(err["score"], _max_abs_err(res, res_plain))
        del lab_plain, res_plain
        touched = touched_rows(codec.unpack_codes(p2, vb), db.spec, db.k)
        bound = {
            "query": _bound_ms(query_bytes(touched, db.spec,
                                           p2.numel() + vb.numel(),
                                           4 * lab.numel())),
            "score": _bound_ms(4 * lab.numel() + 20 * B),
            "classify_step": _bound_ms(query_bytes(touched, db.spec, B * L,
                                                   20 * B)),
        }
        del touched
        ms = {
            "query": _cuda_ms(lambda: probe.query_labels(
                p2, vb, main_t, stash_t, **qargs), 20),
            "query_plain": _cuda_ms(lambda: probe.query_labels_plain(
                p2, vb, main_t, stash_t, **qargs), 5),
            "score": _cuda_ms(lambda: score.score_labels(lab), 20),
            "score_plain": _cuda_ms(lambda: score.score_labels_plain(lab),
                                    5),
        }

        def step_all():
            for a, b in wire:
                pipeline.classify_step_packed(
                    main_t, a, b, stash=stash_t, with_labels=False, **qargs)

        step_ms = _cuda_ms(step_all, 10)
        step_rps = len(wire) * B / (step_ms / 1e3)
        _phase("real_size_kernels", t0,
               f"[{B}, {L}] batch bit-identical; query {ms['query']:.4f} ms "
               f"(plain {ms['query_plain']:.4f}), score {ms['score']:.4f} "
               f"ms (plain {ms['score_plain']:.4f}); device step "
               f"{step_rps:.1f} reads/s on {card}")

        # the same reads as unpacked codes through classify_step
        t0 = time.time()
        (err["classify_step"], ms["classify_step"],
         ms["classify_step_plain"], launches_codes, detail) = (
            check_classify_step(padded, B, main_t, stash_t, wire, lab, db,
                                dev, card))
        del padded
        _phase("classify_step", t0, detail)

        # the part-mode query on the headline table cut in 4 parts
        t0 = time.time()
        (err["query_part"], ms["query_part"], ms["query_part_plain"],
         bound["query_part"]) = check_stream_kernels(
            main_t, stash_t, wire[0], db.k, db.spec, STREAM_PARTS["qs"])
        wire0 = wire[0]
        del main_t, stash_t, wire, lab, res
        torch.cuda.empty_cache()
        _phase("stream_kernels_vs_plain", t0,
               f"{STREAM_PARTS['qs']} parts of [{B}, {L}] bit-identical, "
               f"stash on "
               f"part 0, accumulated parts == resident labels; "
               f"{ms['query_part']:.4f} ms per part call (plain "
               f"{ms['query_part_plain']:.4f}) on {card}")

        # the resident main path, through the CLI: counts from this run
        t0 = time.time()
        gpu_csv, cpu_csv = tmp / "gpu.csv", tmp / "cpu.csv"
        _, launches = run_cli(["classify", "-D", dbdir, "-O", str(fq),
                               "-R", str(gpu_csv), "--device", "cuda"],
                              ("query", "score"))
        _phase("classify_cuda", t0, f"launches {launches}")

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
            ("query_part", "score"))
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
        sclf.close()
        del sclf
        if (tmp / "stream_again.csv").read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("a second streamed classify wrote another "
                                 "CSV")
        _phase("classify_stream", t0,
               f"{STREAM_PARTS['qs']} parts of "
               f"{db.nb // STREAM_PARTS['qs'] * 32 / 1e6:.1f}"
               f" MB, CSV identical to the resident CSV, launches "
               f"{launches_stream}; part upload "
               f"{', '.join(f'{g:.2f}' for g in gbps)} GB/s; file->CSV "
               f"{', '.join(f'{r:.1f}' for r in stream_e2e)} reads/s on "
               f"{card}")

        # paired: mate 1 + N + mate 2 in the 320 bin, P = 290
        t0 = time.time()
        paired_csv = tmp / "paired.csv"
        _, launches_paired = run_cli(
            ["classify", "-D", dbdir, "-P", str(r1), str(r2),
             "-R", str(paired_csv), "--device", "cuda"], ("query", "score"))
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
        del clf
        torch.cuda.empty_cache()
        _phase("classify_paired", t0,
               f"{acc_paired:.6f} of {args.reads} pairs assigned to their "
               f"source genome, first {n_cpu} identical to --device cpu, "
               f"launches {launches_paired}; file->CSV "
               f"{', '.join(f'{r:.1f}' for r in paired_e2e)} pairs/s on "
               f"{card}")

        # extended: one count column per target, resident and streamed
        t0 = time.time()
        n_ext = min(1024, args.reads)
        ext_fq = head_fastq(fq, tmp / "ext.fq", n_ext)
        ext = {}
        for name, device, flags, path_kernels in (
                ("cuda", "cuda", [], ("query", "score")),
                ("cuda_stream", "cuda", ["--max-table-mb", str(stream_mb)],
                 ("query_part", "score")),
                ("cpu", "cpu", [], ())):
            out = tmp / f"ext_{name}.csv"
            run_cli(["classify", "-D", dbdir, "-O", str(ext_fq), "-R",
                     str(out), "--device", device, "--extended", *flags],
                    path_kernels)
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
        mesh_err, mesh_ms, launches_mesh, detail, mesh_bound = check_mesh(
            db, tmp, fq, wire0, gpu_csv, dev, card)
        bound.update(mesh_bound)
        for name, e in mesh_err.items():
            err[name] = max(err.get(name, 0), e)
        ms.update(mesh_ms)
        _phase("mesh", t0, detail)

        # two ranks over gloo, and two --num-hosts shards
        t0 = time.time()
        _phase("multiprocess", t0, check_multiprocess(tmp, dbdir, fq,
                                                      gpu_csv, card))

        # the q4 and s2 tables of the same k-mers: kernels at real size,
        # then resident and streamed classify through the CLI
        head = head_fastq(fq, tmp / "head.fq", min(16384, args.reads))
        for layout in ("q4", "s2"):
            t0 = time.time()
            lay_err, lay_ms, lay_launches, detail, lay_bound = check_layout(
                dbs.pop(layout), tmp, fq, head, wire0, gpu_csv, dev, card)
            bound.update(lay_bound)
            err.update(lay_err)
            ms.update(lay_ms)
            launches.update(lay_launches)
            _phase(f"layouts_{layout}", t0, detail)
        del wire0
        torch.cuda.empty_cache()

        # reads over 32,768 bases: the score kernel's score_long entry
        t0 = time.time()
        (err["score_long"], ms["score_long"], ms["score_long_plain"],
         launches["score_long"], detail, bound["score_long"]) = (
            check_long_reads(tmp, db, dbdir, long_fq, long_codes, dev, card))
        _phase("long_reads", t0, detail)

    kern = [
        {"name": "query", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/probe.py:198",
         "launches": launches["query"], "max_abs_err": err["query"],
         "ms": ms["query"], "plain_ms": ms["query_plain"]},
        {"name": "query_part", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/pipeline.py:96",
         "launches": launches_stream["query_part"],
         "max_abs_err": err["query_part"],
         "ms": ms["query_part"], "plain_ms": ms["query_part_plain"]},
        {"name": "score", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/score.cu",
         "replaces": "cuclark_tpu/score.py:28",
         "launches": launches["score"], "max_abs_err": err["score"],
         "ms": ms["score"], "plain_ms": ms["score_plain"]},
    ]
    for name, replaces in (("query_q4", "cuclark_tpu/probe.py:236"),
                           ("query_part_q4", "cuclark_tpu/probe.py:236"),
                           ("query_s2", "cuclark_tpu/probe.py:131"),
                           ("query_part_s2", "cuclark_tpu/probe.py:131")):
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
    for name, replaces, n in (
            ("build_sharded_classify", "cuclark_tpu/parallel/mesh.py:96",
             launches_mesh["build_sharded_classify"]),
            ("build_sharded_probe_part", "cuclark_tpu/parallel/mesh.py:164",
             launches_mesh["build_sharded_probe_part"]),
            ("classify_step", "cuclark_tpu/pipeline.py:48", launches_codes)):
        kern.append({"name": name, "route": "cuda",
                     "source": "cuclark_tpu_torch/csrc/query.cu",
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err[name], "ms": ms[name],
                     "plain_ms": ms[f"{name}_plain"]})
    for entry in kern:
        # no single PyTorch call computes any of these functions
        entry.update(bound_ms=bound[entry["name"]], bound_by="bytes",
                     library_ms=None)
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
