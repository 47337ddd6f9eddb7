#!/usr/bin/env python3
"""Smoke test of cuclark_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from `cuclark_tpu_torch/csrc`, holds each
kernel against its plain PyTorch version on the card, reproduces the
golden example through the port's CLI, and classifies 131,072 simulated
150 bp reads against the repository's headline database shape (k=31,
64M target-specific k-mers, 16,384 targets, target load 0.85: a 1.107 GB
qs table resident on the card) through `cuclark-tpu-torch classify
--device cuda`.  Each phase prints one line; any failure raises and
exits non-zero.  The last three lines are the card's name and power
limit, a JSON object of the kernels, and `{"ok": true, "device": ...}`.

Without a CUDA device, or outside a checkout of the repository, it
prints no result and exits 2.  `--genomes` and `--reads` shrink the
real-size phase for a quick run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
K = 31
READ_LEN = 150
GENOME_LEN = 3936          # 3,906 31-mers per genome: 64.0M for 16,384
SUB_RATE = 0.01


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
    args = dict(k=k, nb_bits=db.nb_bits, stash_bits=db.stash_bits,
                seed=db.seed)
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
    print(f"  k={k}: {got.numel()} windows bit-identical, {n_hit} hits, "
          f"{n_stash} from the stash", flush=True)
    return _max_abs_err(got, want)


def check_score(dev, R: int, P: int, seed: int) -> int:
    """Score kernel vs plain on random labels with ties and empty rows."""
    import torch

    from cuclark_tpu_torch import score

    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 6, size=(R, P)).astype(np.int32)
    lab[rng.random((R, P)) < 0.3] = 0
    lab[0] = 0                                        # all miss
    if P >= 2:
        lab[1, :P // 2], lab[1, P // 2:] = 9, 2       # tie when P is even
    lab[2 % R] = 65535
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


def build_headline_db(n_genomes: int, dbdir: Path):
    """Random genomes (numpy, seed 0) -> canonical 31-mers -> keep the
    target-specific ones (builder.discriminate) -> qs table through the
    port's build_table -> the .npz that `classify -D` loads."""
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
    cfg = DBConfig(k=K, target_load=0.85)
    names = ["NA"] + [f"T{i}" for i in range(1, n_genomes + 1)]
    db = build_table(kmers, labels, names, cfg)
    dbdir.mkdir(parents=True, exist_ok=True)
    db.save(dbdir / db_name(cfg, n_genomes))
    return genomes, db


def write_reads(genomes: np.ndarray, n_reads: int, path: Path):
    """150 bp reads sampled from the genomes with 1% substitutions,
    named r<i>_T<source>; returns their codes [n, 150] and sources."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, len(genomes), size=n_reads)
    pos = rng.integers(0, GENOME_LEN - READ_LEN + 1, size=n_reads)
    codes = genomes[src[:, None], pos[:, None] + np.arange(READ_LEN)]
    sub = rng.random(codes.shape) < SUB_RATE
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()),
                                            dtype=np.uint8)) % 4
    ascii_ = np.frombuffer(b"TGCA", np.uint8)[codes]   # A=3 C=2 G=1 T=0
    qual = "I" * READ_LEN
    with open(path, "w") as f:
        f.write("".join(f"@r{i}_T{s + 1}\n{row.tobytes().decode()}\n+\n"
                        f"{qual}\n" for i, (s, row) in
                        enumerate(zip(src, ascii_))))
    return codes, src


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
    from cuclark_tpu_torch import cli, codec, kernels, pipeline, probe, score
    from cuclark_tpu_torch.hashdb import KmerDB, table_to_device

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
    err = {"query": 0, "score": 0}
    for k in (27, 32):
        err["query"] = max(err["query"], check_small_query(dev, k))
    for i, (R, P) in enumerate(((65536, 122), (64, 16354), (33, 1000),
                                (64, 1), (5, 2))):
        err["score"] = max(err["score"], check_score(dev, R, P, i))
    _phase("kernels_vs_plain", t0, "query and score bit-identical")

    with tempfile.TemporaryDirectory(prefix="cuclark_smoke_") as td:
        tmp = Path(td)

        # 3. golden example through the CLI on the card
        t0 = time.time()
        golden_example(tmp)
        _phase("golden_example", t0,
               "examples/expected_results.csv reproduced byte for byte")

        # 4. real size
        t0 = time.time()
        genomes, db = build_headline_db(args.genomes, tmp / "db")
        _phase("build_db", t0,
               f"{db.num_kmers} k-mers, {db.num_targets} targets, "
               f"nb_bits {db.nb_bits}, stash_bits {db.stash_bits}, "
               f"table {db.table.nbytes / 1e9:.3f} GB")
        t0 = time.time()
        fq = tmp / "reads.fq"
        codes, src = write_reads(genomes, args.reads, fq)
        del genomes
        _phase("write_reads", t0, f"{args.reads} reads of {READ_LEN} bp")

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
        qargs = dict(k=db.k, nb_bits=db.nb_bits, stash_bits=db.stash_bits,
                     seed=db.seed)
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
        del main_t, stash_t, wire, lab, res
        torch.cuda.empty_cache()
        _phase("real_size_kernels", t0,
               f"[{B}, {L}] batch bit-identical; query {ms['query']:.4f} ms "
               f"(plain {ms['query_plain']:.4f}), score {ms['score']:.4f} "
               f"ms (plain {ms['score_plain']:.4f}); device step "
               f"{step_rps:.1f} reads/s on {card}")

        # the main path, through the CLI: counts from this run only
        t0 = time.time()
        gpu_csv, cpu_csv = tmp / "gpu.csv", tmp / "cpu.csv"
        kernels.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["classify", "-D", str(tmp / "db"), "-O", str(fq),
                           "-R", str(gpu_csv), "--device", "cuda"])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if rc:
            raise AssertionError(f"classify --device cuda returned {rc}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        _phase("classify_cuda", t0, f"launches {launches}")

        # file -> CSV with the DB resident, timed apart from the DB load
        t0 = time.time()
        clf = pipeline.Classifier(KmerDB.load(next((tmp / "db").glob(
            "db_k*.npz"))), device=dev)
        e2e = []
        for _ in range(2):
            t1 = time.time()
            n = clf.classify_file_to_csv(fq, tmp / "again.csv")
            torch.cuda.synchronize()
            e2e.append(n / (time.time() - t1))
        if (tmp / "again.csv").read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("a second classify wrote another CSV")
        del clf
        torch.cuda.empty_cache()
        _phase("file_to_csv", t0,
               f"{', '.join(f'{r:.1f}' for r in e2e)} reads/s on {card}")

        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["classify", "-D", str(tmp / "db"), "-O", str(fq),
                           "-R", str(cpu_csv), "--device", "cpu"])
        if rc:
            raise AssertionError(f"classify --device cpu returned {rc}")
        if cpu_csv.read_bytes() != gpu_csv.read_bytes():
            raise AssertionError("--device cuda CSV differs from --device "
                                 "cpu CSV")
        rows = gpu_csv.read_text().splitlines()[1:]
        if len(rows) != args.reads:
            raise AssertionError(f"{len(rows)} CSV rows for {args.reads} "
                                 f"reads")
        right = sum(r.split(",")[0].rsplit("_", 1)[1] == r.split(",")[3]
                    for r in rows)
        acc = right / len(rows)
        if acc < 0.99:
            raise AssertionError(f"only {acc:.4%} of reads assigned to "
                                 f"their source genome")
        _phase("classify_cpu_parity", t0,
               f"CSV identical to --device cpu; {acc:.6f} of reads "
               f"assigned to their source genome")

    kern = [
        {"name": "query", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/query.cu",
         "replaces": "cuclark_tpu/probe.py:198",
         "launches": launches["query"], "max_abs_err": err["query"],
         "ms": ms["query"], "plain_ms": ms["query_plain"]},
        {"name": "score", "route": "cuda",
         "source": "cuclark_tpu_torch/csrc/score.cu",
         "replaces": "cuclark_tpu/score.py:28",
         "launches": launches["score"], "max_abs_err": err["score"],
         "ms": ms["score"], "plain_ms": ms["score_plain"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
