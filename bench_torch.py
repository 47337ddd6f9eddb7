#!/usr/bin/env python3
"""Benchmark of cuclark_tpu_torch: classified reads/s on one NVIDIA GPU.

The counterpart of `bench.py`, block by block, with its environment
knobs, defaults, seeds and the shape of its one JSON line.  The headline
is the device step on the RefSeq-bacteria-shaped table of `bench.py`
(k=31, 64M target-specific k-mers in a qs table of about 1.1 GB, 16,384
targets).  The blocks of `detail`:

  (top level)   the headline device step: 131,072 reads of 150 bp in
                chunks of 16,384, `pipeline.classify_step_packed`
                without labels (the fused query and score kernel), min
                of CUCLARK_BENCH_REPS passes
  scaling_model the db-axis merge's payload against an assumed link rate
  small         the same step on a 4M-k-mer table
  e2e_scale,    file -> CSV through `Classifier.classify_file_to_csv`,
  e2e_small     500,000 reads, median of 3 passes; e2e_scale then one
                more pass split by thread (`thread_split`,
                the program's spans, scripts/torch_thread_split.py)
  host_pipeline the host stages alone: scan, the read with the scan
                (np.fromfile, and the read-only map classify takes),
                pack (at its default team, half the cores, and at
                every core; and its plain version), CSV formatting (the
                row writer, and its printf plain version), tally
  accuracy      8 random genomes of 200 kb, 50,000 reads with 1%
                substitutions and 0.2% indels, built and classified
  stream_ratio  the headline table streamed in parts against resident
  mesh_e2e      `multihost.GlobalClassifier` in one process, a 1 x 1
                mesh of one card, against `e2e_scale`
  light_paired  the light preset (k=27, gap 4, 32M k-mers) with 1M pairs
                of 75 + 75 bp mates
  scale4g       the device step on a 256M-k-mer table, resident (8.6 GB:
                the qs build widens it to 2^28 main rows so that its
                stash stays small); its build cached in the temporary
                directory
  build_spill   the out-of-core DB build, 320 Mbases under a 4 GB
                occurrence budget (scripts/torch_bench_build_scale.py,
                in a subprocess)

The reads of the device-step blocks are substrings of a random 2 Mb
genome and the tables' k-mers are random, so those steps take the miss
path: almost no window hits (`hit_share`).  Their exactness is checked
on an untimed chunk with planted hits (`planted`).

Timing: a device-step pass ends in `torch.cuda.synchronize()` and is
timed by the host clock (min over the passes) and by CUDA events
(`pass_event_ms`); the e2e blocks take the median of 3 passes.  Every
pass time and each block's spread (max / min - 1) is in `detail`, and
`detail.device` names the card, its power limit (nvidia-smi) and the
torch and CUDA versions.  On the card each device-step block also times
its kernel alone on its first chunk against its plain PyTorch version,
with the least time its bytes need and the gather-only ceiling
(`kernel`, `scripts/torch_measure.py`).

Exactness, each a hard failure: in every device-step block, a chunk of
reads whose first k bases are k-mers stored in the upper half of the
table's main rows and in its last rows (past 2^32 bytes on the scale4g
table) must hit in every read, and the step's results and the fused
kernel's must equal `probe.query_score_results_plain` on the same
device; the streamed CSV equals a resident classifier's CSV of the same
file; the mesh CSV equals `e2e_scale`'s.

Prints ONE JSON line on stdout:

  {"metric": "reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": R, "detail": {...}}

vs_baseline: the reference publishes no rate in its tree; the CuCLARK
paper's headline setup classifies about 1M reads a minute on one 6 GB
GTX-class GPU against the bacteria DB, BASELINE_READS_PER_SEC = 16667
reads/s.  vs_baseline is the headline rate over that.

Run from the repository root:

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # the plain versions on the CPU

Without a card and without `--device cpu` (or CUCLARK_BENCH_DEVICE=cpu)
it prints no result and exits 2.

Env knobs (bench.py's): CUCLARK_BENCH_READS, CUCLARK_BENCH_KMERS,
CUCLARK_BENCH_READLEN, CUCLARK_BENCH_TARGETS, CUCLARK_BENCH_REPS,
CUCLARK_BENCH_CHUNK, CUCLARK_BENCH_SCALE_KMERS,
CUCLARK_BENCH_SCALE_TARGETS, CUCLARK_BENCH_E2E_READS,
CUCLARK_BENCH_4G_KMERS (0 disables scale4g), CUCLARK_BENCH_CACHE (0: no
build cache), CUCLARK_BENCH_HOST (0 disables host_pipeline),
CUCLARK_BENCH_ACC_READS (0 disables accuracy), CUCLARK_BENCH_STREAM (0
disables stream_ratio), CUCLARK_BENCH_MESH (0 disables mesh_e2e),
CUCLARK_BENCH_PAIRED_READS (0 disables light_paired),
CUCLARK_BENCH_LIGHT_KMERS, CUCLARK_BENCH_BUILD_MB (0 disables
build_spill), CUCLARK_BENCH_BUILD_RAM_MB; and CUCLARK_BENCH_DEVICE,
CUCLARK_BENCH_LINK_GBS (scaling_model's link rate).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BASELINE_READS_PER_SEC = 16667.0
# NVLink 4 of the H100 SXM: 900 GB/s in both directions together (NVIDIA
# data sheet), so 450 GB/s each way, the rate a ring all-reduce sends at.
# Not measured: the machine has one card.
LINK_GBS = 450.0

_T0 = time.time()


def _log(msg: str) -> None:
    print(f"[bench_torch +{time.time() - _T0:.0f}s] {msg}", file=sys.stderr,
          flush=True)


def _spread(ts) -> float:
    """Max over min of a block's pass times, less 1."""
    return max(ts) / min(ts) - 1 if min(ts) > 0 else float("inf")


def _device_info(dev) -> dict:
    """The card's name and power limit as nvidia-smi prints them, and the
    torch and CUDA versions."""
    import torch

    info = {"platform": dev.type, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if dev.type != "cuda":
        info["name"] = "cpu"
        return info
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line = smi.splitlines()[0]
    info.update(name=torch.cuda.get_device_name(dev),
                count=torch.cuda.device_count(), nvidia_smi=line,
                power_limit=line.rsplit(",", 1)[-1].strip())
    return info


def synth_kmers(num_kmers: int, num_targets: int, k: int):
    """bench.py's synthetic k-mers and labels: a config-seeded draw of
    random canonical k-mers, sorted and unique, each with a random label
    in 1..num_targets.  Returns (k-mers uint64, labels uint32, target
    names)."""
    from cuclark_tpu_torch import codec

    t0 = time.time()
    rng_db = np.random.default_rng((num_kmers, num_targets, k))
    km = rng_db.integers(0, 1 << 62, size=int(num_kmers * 1.05),
                         dtype=np.uint64)
    km = codec.canonical_np(km, k)
    t1 = time.time()
    km = np.unique(km)[:num_kmers]
    labels = rng_db.integers(1, num_targets + 1,
                             size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, num_targets + 1)]
    _log(f"drew {len(km)} canonical k-mers in {time.time() - t0:.1f} s "
         f"(draw and canonical form {t1 - t0:.1f}, unique and labels "
         f"{time.time() - t1:.1f})")
    return km, labels, names


def bench_reads(rng, n_reads: int, read_len: int):
    """bench.py's reads: substrings of a random 2 Mb genome, drawn from
    the bench's shared generator `rng` (seed 0, its first draws) ->
    (genome, codes uint8 [n_reads, read_len])."""
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    return genome, genome[starts[:, None] + np.arange(read_len)[None, :]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device",
                    default=os.environ.get("CUCLARK_BENCH_DEVICE", "cuda"),
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); pass --device cpu to run the plain versions on the "
              "CPU", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"bench_torch: unsupported device {dev}", file=sys.stderr)
        return 2
    on_card = dev.type == "cuda"
    for p in (ROOT, ROOT / "scripts"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from cuclark_tpu_torch import codec, kernels
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import KmerDB, build_table, table_to_device
    from cuclark_tpu_torch.memplan import device_memory_budget_mb
    from cuclark_tpu_torch.pipeline import Classifier, classify_step_packed

    n_reads = int(os.environ.get("CUCLARK_BENCH_READS", 131072))
    n_kmers = int(os.environ.get("CUCLARK_BENCH_KMERS", 4_000_000))
    read_len = int(os.environ.get("CUCLARK_BENCH_READLEN", 150))
    n_targets = int(os.environ.get("CUCLARK_BENCH_TARGETS", 1024))
    reps = int(os.environ.get("CUCLARK_BENCH_REPS", 3))
    chunk = int(os.environ.get("CUCLARK_BENCH_CHUNK", 16384))
    scale_kmers = int(os.environ.get("CUCLARK_BENCH_SCALE_KMERS",
                                     64_000_000))
    scale_targets = int(os.environ.get("CUCLARK_BENCH_SCALE_TARGETS", 16384))
    g4_kmers = int(os.environ.get("CUCLARK_BENCH_4G_KMERS", 256_000_000))
    k = 31
    n_reads = (n_reads // chunk) * chunk or chunk

    ceiling_lib = None
    if on_card:
        # the kernels and the gather-only ceiling kernel, built in parallel
        import torch_gather_ceiling

        with ThreadPoolExecutor(2) as pool:
            ceiling = pool.submit(torch_gather_ceiling.build)
            kernels.load()
            ceiling_lib = ceiling.result()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def launched() -> dict:
        return {name: n for name, n in kernels.LAUNCHES.items() if n}

    rng = np.random.default_rng(0)
    detail = {
        "device": _device_info(dev),
        "read_len": read_len,
        "timing": {"device_step": f"min_of_{reps}",
                   "e2e": "median_of_3",
                   "clock": ("host clock to torch.cuda.synchronize(); CUDA "
                             "events per device-step pass" if on_card else
                             "host clock; the plain versions on the CPU")},
    }
    exact = {}

    # --- synthetic reads: substrings of a synthetic genome ---
    genome, codes = bench_reads(rng, n_reads, read_len)
    # every window of these reads is valid (no N): the hit share's base
    windows = n_reads * max(read_len - k + 1, 0)
    # the production wire format: 2-bit packed codes + validity bitmask
    dev_chunks = [tuple(torch.from_numpy(a).to(dev)
                        for a in codec.pack_codes(codes[i: i + chunk]))
                  for i in range(0, n_reads, chunk)]

    def timed_pass(fn):
        """(host seconds, CUDA-event ms or None) of fn() to its end on
        the device."""
        if not on_card:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        sync()
        return time.perf_counter() - t0, start.elapsed_time(end)

    def kernel_row(db, main_t, stash_t, p2, vb) -> dict:
        """The fused query and score kernel alone on one chunk, held to
        its plain version: its time and its plain version's (CUDA
        events), the least time of the bytes it must move and the
        gather-only ceiling of its gathers (`torch_measure.fused_row`)."""
        import torch_measure

        row, _ = torch_measure.fused_row(p2, vb, main_t, stash_t, k=db.k,
                                         spec=db.spec,
                                         ceiling_lib=ceiling_lib)
        return {"name": "query_score",
                "shape": [p2.shape[0], 4 * p2.shape[1]], **row,
                "bound_by": "bytes"}

    def planted_check(db, main_t, stash_t, rows_np, what: str) -> dict:
        """The device step on an untimed chunk of reads `rows_np` [n, L]
        (codes) whose first k bases are each a k-mer the table stores in
        its upper main rows (from row NB / 2, and its last rows): every
        read must hit, and the step's results and the fused kernel's must
        equal the plain version's.  Returns what was planted."""
        import torch_measure

        half = db.nb // 2
        m = max(1, min(half, 1024))
        spans = [(half, half + m), (db.nb - m, db.nb)]
        km = np.concatenate([db.items(rows=s)[0] for s in spans])
        # a read's window is looked up in canonical form: a stored k-mer
        # that is not canonical (the light table's draw of 62 random bits
        # for k=27, as bench.py draws it, leaves half so) is never hit
        km = km[codec.canonical_np(km, db.k) == km]
        if not len(km):
            raise AssertionError(f"{what}: no k-mer stored in main rows "
                                 f"{spans}")
        pick = np.random.default_rng(5).choice(km, size=len(rows_np))
        shifts = np.uint64(2) * np.arange(db.k - 1, -1, -1, dtype=np.uint64)
        rows_np = rows_np.copy()
        rows_np[:, :db.k] = (pick[:, None] >> shifts) & np.uint64(3)
        p2, vb = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_codes(rows_np))
        got, _ = classify_step_packed(main_t, p2, vb, k=db.k, spec=db.spec,
                                      stash=stash_t, with_labels=False)
        hit = int((got[:, 0] > 0).sum())
        if hit != len(rows_np):
            raise AssertionError(f"{what}: {hit} of {len(rows_np)} reads "
                                 f"with a stored k-mer hit")
        torch_measure.check_fused(p2, vb, main_t, stash_t, k=db.k,
                                  spec=db.spec, also=(got,))
        row_bytes = 4 * db.spec.row_words
        return {"reads": len(rows_np), "hit_reads": hit,
                "main_rows": [list(s) for s in spans],
                "row_bytes": row_bytes, "first_byte": half * row_bytes,
                "last_byte": db.nb * row_bytes}

    def synth_db(num_kmers, num_targets, load, kcfg=None, cache_tag=None):
        """bench.py's synthetic DB: the same seeded k-mers and labels.
        cache_tag: keep the built DB in the temporary directory and load
        it on a later run (the one-time build cost in a sidecar; build_s
        < 0 only when the sidecar is missing).  Returns (db, build_s,
        cached)."""
        cfg = kcfg or DBConfig(k=k, target_load=load)
        cache = None
        if cache_tag and int(os.environ.get("CUCLARK_BENCH_CACHE", 1)):
            cache = (Path(tempfile.gettempdir())
                     / f"cuclark_bench_torch_{cache_tag}_{num_kmers}"
                       f"_{num_targets}_{cfg.k}.npz")
            if cache.exists():
                try:
                    db = KmerDB.load(cache)
                    meta = cache.with_suffix(".meta.json")
                    build_s = -1.0
                    if meta.exists():
                        build_s = float(json.loads(
                            meta.read_text()).get("build_s", -1.0))
                    return db, build_s, True
                except (OSError, ValueError, KeyError) as e:
                    _log(f"unreadable cache {cache} ({e}): rebuilding")
                    cache.unlink()
        # a dedicated, config-seeded rng: a cache hit skips the draws, so
        # the shared stream stays the same for every later block
        km, labels, names = synth_kmers(num_kmers, num_targets, cfg.k)
        t0 = time.time()
        db = build_table(km, labels, names, cfg)
        dt = time.time() - t0
        del km, labels
        if cache is not None:
            try:
                db.save(cache)
                cache.with_suffix(".meta.json").write_text(
                    json.dumps({"build_s": dt}))
            except OSError as e:
                _log(f"could not cache the DB at {cache}: {e}")
                cache.unlink(missing_ok=True)
        return db, dt, False

    def step_block(db, build_s, n_label, cached=False):
        """The device step on the production probe mode, the table
        resident on the device."""
        budget = device_memory_budget_mb(dev)
        main_t, stash_t = table_to_device(db, dev)

        def run(keep=False):
            out = []
            for p2, vb in dev_chunks:
                results, _ = classify_step_packed(
                    main_t, p2, vb, k=db.k, spec=db.spec, stash=stash_t,
                    with_labels=False)
                if keep:
                    out.append(results)
            return out

        first = run(keep=True)  # warm-up; hits counted
        sync()
        hits = sum(int(r[:, 0].sum()) for r in first)
        del first
        planted = planted_check(db, main_t, stash_t, codes[:chunk], n_label)
        kernels.reset_launches()
        passes = [timed_pass(run) for _ in range(reps)]
        launches = launched()
        ts = [p[0] for p in passes]
        dt = min(ts)
        rps = n_reads / dt
        block = {
            "db_kmers": int(db.num_kmers),
            "nb_bits": db.nb_bits,
            "stash_bits": db.stash_bits,
            "table_mb": round(db.table.nbytes / 1e6, 1),
            "db_build_s": round(build_s, 1),
            "split_probe": stash_t is not None,
            "step_ms": round(dt / len(dev_chunks) * 1e3, 2),
            "reads_per_sec": round(rps, 1),
            "pass_s": ts,
            "pass_event_ms": [p[1] for p in passes],
            "spread": _spread(ts),
            "hit_share": hits / windows if windows else 0.0,
            "planted": planted,
            "launches": launches,
            "device_budget_mb": budget,
        }
        if cached:
            # table construction skipped this run; db_build_s is the
            # one-time cost recorded when the cache was built
            block["db_build_cached"] = True
        if on_card:
            block["kernel"] = kernel_row(db, main_t, stash_t,
                                         *dev_chunks[0])
            block["kernel"]["launches"] = launches.get("query_score", 0)
        exact[f"{n_label}_step_vs_plain"] = True
        _log(f"{n_label}: {rps:,.0f} reads/s ({block['table_mb']} MB "
             f"table, hit share {block['hit_share']:.6f})")
        del main_t, stash_t
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return rps, block

    # --- HEADLINE: the device step at scale (RefSeq-bacteria-shaped) ---
    _log(f"building at-scale table ({scale_kmers} kmers)")
    db_s, scale_build, _ = synth_db(scale_kmers, scale_targets, 0.85)
    _log("at-scale step")
    rps_scale, blk = step_block(db_s, scale_build, "at-scale")
    detail.update({
        "n_reads": n_reads,
        "n_targets": scale_targets,
        "layout": db_s.layout,
        "kmer_probes_per_sec": round(rps_scale * (read_len - k + 1), 0),
    })
    detail.update({k_: v for k_, v in blk.items()
                   if k_ != "reads_per_sec"})
    detail["step_reads_per_sec"] = blk["reads_per_sec"]

    # A model of the db-axis merge on several cards: one sum of the
    # per-window label matrix a chunk (parallel/mesh.py _sum_shards; the
    # reference's cudaMemcpyPeer merge tree, CuClarkDB.cu:929-994).  A
    # ring all-reduce sends about twice the payload from each card; the
    # overhead is that traffic at the assumed link rate over this run's
    # chunk step.
    W_sc = read_len - k + 1
    psum_mb = chunk * W_sc * 4 / 1e6  # int32 labels [chunk, windows]
    link_gbs = float(os.environ.get("CUCLARK_BENCH_LINK_GBS", LINK_GBS))
    step_s_sc = blk["step_ms"] / 1e3
    psum_s = 2 * psum_mb / 1e3 / link_gbs
    detail["scaling_model"] = {
        "psum_payload_mb_per_chunk": round(psum_mb, 2),
        "chunk_step_ms": blk["step_ms"],
        "assumed_link_gb_per_s": link_gbs,
        "link_source": "NVLink 4 data sheet, not measured (one card)",
        "ring_allreduce_ms": round(psum_s * 1e3, 3),
        "overhead_fraction": round(psum_s / step_s_sc, 4),
        "model_scaling_efficiency": round(1 / (1 + psum_s / step_s_sc), 4),
    }

    # --- small-table device step ---
    _log("small-table step")
    db, build_s, _ = synth_db(n_kmers, n_targets, 0.7)
    _, small_blk = step_block(db, build_s, "small")
    small_blk["n_targets"] = n_targets
    detail["small"] = small_blk

    # --- end-to-end file -> CSV (host scan/pack/format included) ---
    e2e_reads = int(os.environ.get("CUCLARK_BENCH_E2E_READS", 500_000))
    td_ctx = tempfile.TemporaryDirectory()
    td = Path(td_ctx.name)
    base = "ACGT"

    def write_fastq(path, rows):
        seq_bytes = np.frombuffer(base.encode(), np.uint8)[rows]
        qual = b"I" * rows.shape[1]
        with open(path, "wb") as f:
            blocks = []
            for i in range(rows.shape[0]):
                blocks.append(b"@r%d\n%s\n+\n%s\n"
                              % (i, seq_bytes[i].tobytes(), qual))
                if len(blocks) == 65536:
                    f.write(b"".join(blocks))
                    blocks = []
            f.write(b"".join(blocks))

    def e2e_times(clf, fq, out_csv, n_expect, passes=3, paired=None,
                  split=False):
        """The median of `passes` timed passes; with `split`, one more
        pass split by the program's spans (scripts/torch_thread_split.py; by
        thread in `thread_split`, not in the rates)."""
        clf.classify_file_to_csv(fq, out_csv, paired)  # warm-up
        kernels.reset_launches()
        ts = []
        for _ in range(passes):
            t0 = time.perf_counter()
            n = clf.classify_file_to_csv(fq, out_csv, paired)
            sync()
            ts.append(time.perf_counter() - t0)
            if n != n_expect:
                raise AssertionError(f"{n} reads classified of {n_expect}")
        med = statistics.median(ts)
        launches = launched()
        thread_split = None
        if split:
            from torch_thread_split import ThreadSplit

            with ThreadSplit() as timers:
                clf.classify_file_to_csv(fq, out_csv, paired)
                sync()
            thread_split = timers.report(-(-n_expect // chunk))
        return {
            "reads_per_sec": round(n_expect / med, 1),
            "objects_per_min": int(n_expect / med * 60),
            "best_reads_per_sec": round(n_expect / min(ts), 1),
            "pass_s": ts,
            "spread": _spread(ts),
            "launches": launches,
            **({"thread_split": thread_split} if split else {}),
        }

    def h2d_mb_per_s(mb: int):
        """A host-to-device copy of mb MB from a fresh pageable buffer,
        to its end on the card, in MB/s (None on the CPU, which has no
        copy).  The buffer is drawn on every device, so that the reads
        drawn after it are those of bench.py."""
        big = rng.integers(0, 256, (mb, 1 << 20), dtype=np.uint8)
        if not on_card:
            return None
        sync()
        t0 = time.perf_counter()
        torch.from_numpy(big).to(dev)
        sync()
        return mb / (time.perf_counter() - t0)

    def new_classifier(db_, **cfg):
        return Classifier(db_, ClassifyConfig(batch_reads=chunk, **cfg),
                          device=dev)

    fq = td / "bench.fq"
    if e2e_reads:
        rate = h2d_mb_per_s(32)
        detail["h2d_mb_per_s_at_e2e"] = (round(rate, 1) if rate is not None
                                         else None)
        starts_e = rng.integers(0, len(genome) - read_len, size=e2e_reads)
        write_fastq(fq, genome[starts_e[:, None]
                               + np.arange(read_len)[None, :]])
        # e2e_small's CSV is out.csv, as in bench.py (host_pipeline tallies
        # it); e2e_scale's is kept apart for the mesh check
        for tag, e2e_db, out in (("e2e_scale", db_s, "out_scale.csv"),
                                 ("e2e_small", db, "out.csv")):
            _log(tag)
            clf = new_classifier(e2e_db)
            detail[tag] = e2e_times(clf, fq, td / out, e2e_reads,
                                    split=tag == "e2e_scale")
            clf.close()
            del clf
            gc.collect()
        detail["e2e_reads_per_sec"] = detail["e2e_scale"]["reads_per_sec"]

    # --- the host stages alone, without the device: scan and pack (the
    #     feed side), CSV formatting (the drain side) and the abundance
    #     tally.  The reference's overlap machinery is
    #     src/CuCLARK_hh.hh:1738-1761. ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_HOST", 1)):
        _log("host_pipeline (scan/pack/format/tally, no device)")
        from cuclark_tpu_torch import native as _native
        from cuclark_tpu_torch.io import fast_parse

        raw = np.fromfile(fq, np.uint8)

        def _min_time(fn, reps_h=3):
            fn()  # warm-up (allocations, lazy native build)
            best = float("inf")
            for _ in range(reps_h):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best

        scan_s = _min_time(lambda: fast_parse.scan_file(raw))
        ns_h, ne_h, ss_h, se_h = fast_parse.scan_file(raw)
        # the read with the scan: a copy, or the read-only map classify
        # takes (pipeline._read_file_bytes), whose page faults land in
        # the scan's threads
        read_scan_s = {
            "fromfile": _min_time(lambda: fast_parse.scan_file(
                np.fromfile(fq, np.uint8))),
            "map": _min_time(lambda: fast_parse.scan_file(
                np.memmap(fq, np.uint8, mode="r")))}
        nrec = len(ss_h)

        def _pack_all():
            for i in range(0, nrec, chunk):
                fast_parse.pack_block2_dispatch(
                    raw, ss_h[i: i + chunk], se_h[i: i + chunk],
                    read_len, n_rows=chunk)

        pack_s = _min_time(_pack_all)
        pack_plain_s = pack_cores_s = float("inf")
        if _native.available():
            # the pack at every core, as its plain version runs
            pack_cores_s = _min_time(lambda: [_native.pack_block2(
                raw, ss_h[i: i + chunk], se_h[i: i + chunk], read_len,
                n_rows=chunk, threads=os.cpu_count())
                for i in range(0, nrec, chunk)])

            # the one-base-a-step plain version, whose bytes it must equal
            def _pack_plain_all(fn=_native.pack_block2_plain):
                return [fn(raw, ss_h[i: i + chunk], se_h[i: i + chunk],
                           read_len, n_rows=chunk)
                        for i in range(0, nrec, chunk)]

            pack_plain_s = _min_time(_pack_plain_all)
            if not all(np.array_equal(a, b) for u, v in zip(
                    _pack_plain_all(_native.pack_block2), _pack_plain_all())
                    for a, b in zip(u, v)):
                raise AssertionError("pack_block2 != pack_block2_plain")

        # drain side: format synthetic but plausible results for every
        # read through the production formatter
        rng_h = np.random.default_rng(7)
        norm_h = np.full(nrec, read_len, np.int64)
        gamma_h = rng_h.random(nrec)
        ibest_h = rng_h.integers(0, scale_targets + 1,
                                 nrec).astype(np.int32)
        best_h = rng_h.integers(0, 120, nrec).astype(np.int32)
        isecond_h = np.zeros(nrec, np.int32)
        second_h = np.zeros(nrec, np.int32)
        conf_h = rng_h.random(nrec)
        use_native_h = _native.available()
        if use_native_h:
            tnb, tno = _native.pack_target_names(db_s.target_names)

            def _format_all(fn):
                out = []
                for i in range(0, nrec, chunk):
                    s = slice(i, min(i + chunk, nrec))
                    out.append(fn(
                        norm_h[s], gamma_h[s], ibest_h[s], best_h[s],
                        isecond_h[s], second_h[s], conf_h[s],
                        raw, ns_h[s], ne_h[s], tnb, tno))
                return out

            # the row writer (the production formatter) and its printf
            # plain version, whose bytes it must equal
            fmt_s = _min_time(lambda: _format_all(_native.format_rows))
            printf_s = _min_time(
                lambda: _format_all(_native.format_rows_printf))
            new_rows = _format_all(_native.format_rows)
            if (b"".join(r.tobytes() for r, _ in new_rows)
                    != b"".join(r.tobytes() for r in _format_all(
                        _native.format_rows_printf))):
                raise AssertionError("format_rows != format_rows_printf")
            printf_values = sum(c for _, c in new_rows)
        else:
            fmt_s = printf_s = float("inf")
            printf_values = None

        chain_s = scan_s + pack_s + fmt_s
        host_block = {
            "native": use_native_h,
            "n_reads": nrec,
            "scan_reads_per_sec": round(nrec / scan_s, 1),
            "pack_reads_per_sec": round(nrec / pack_s, 1),
            "pack_all_cores_reads_per_sec": round(nrec / pack_cores_s, 1),
            "pack_plain_reads_per_sec": round(nrec / pack_plain_s, 1),
            "pack_team": (_native.pack_team(chunk) if use_native_h
                          else None),
            "format_rows_per_sec": round(nrec / fmt_s, 1),
            "format_printf_rows_per_sec": round(nrec / printf_s, 1),
            # values the row writer handed to snprintf (outside the
            # magnitudes its exact rounding covers)
            "format_printf_values": printf_values,
            "format_team": (_native.format_team(chunk) if use_native_h
                            else None),
            "read_scan_fromfile_reads_per_sec": round(
                nrec / read_scan_s["fromfile"], 1),
            "read_scan_map_reads_per_sec": round(
                nrec / read_scan_s["map"], 1),
            # serial worst case: the pipeline overlaps these stages
            # across threads, so its capacity is at least this
            "serial_chain_reads_per_sec": round(nrec / chain_s, 1),
            "vs_device_step": round(
                nrec / chain_s / detail["step_reads_per_sec"], 2),
            "stage_s": {"scan": scan_s, "pack": pack_s,
                        "pack_all_cores": pack_cores_s,
                        "pack_plain": pack_plain_s, "format": fmt_s,
                        "format_printf": printf_s,
                        "read_fromfile_scan": read_scan_s["fromfile"],
                        "read_map_scan": read_scan_s["map"]},
            "threads": os.cpu_count(),
            # the record scan's OpenMP team on this file (scan_team)
            "scan_team": (_native.scan_team(len(raw)) if use_native_h
                          else None),
        }
        # downstream summarization rate (the abundance tally over the
        # e2e CSV written above)
        if use_native_h:
            csv_bytes = np.fromfile(td / "out.csv", np.uint8)
            nl0 = int(np.argmax(csv_bytes == ord("\n"))) + 1
            body = csv_bytes[nl0:]
            t_t = _min_time(lambda: _native.csv_tally(
                body, 8, 3, 7, 2, 0.0, 0.0), 2)
            _, _, rows_t = _native.csv_tally(body, 8, 3, 7, 2, 0.0, 0.0)
            host_block["tally_rows_per_min"] = int(rows_t / t_t * 60)
        detail["host_pipeline"] = host_block
        _log(f"host chain {host_block['serial_chain_reads_per_sec']:,.0f}"
             f" reads/s serial ({host_block['vs_device_step']}x device"
             f" step)")
        del raw
        gc.collect()

    # --- classification accuracy on wgsim-style error reads (the
    #     reference's QA inputs are the HiSeq/MiSeq accuracy sets,
    #     data/README.md:1-21) ---
    acc_reads = int(os.environ.get("CUCLARK_BENCH_ACC_READS", 50_000))
    if acc_reads:
        _log(f"accuracy ({acc_reads} simulated reads, 1% sub + 0.2% "
             f"indel)")
        import random as _random

        from cuclark_tpu_torch import simulate as _sim
        from cuclark_tpu_torch.db_build.builder import (build_db,
                                                        parse_targets_file)

        _rng_py = _random.Random(13)
        acc_genomes = {
            f"G{t}": "".join(_rng_py.choice("ACGT")
                             for _ in range(200_000))
            for t in range(1, 9)}
        tlines = []
        for t, g in acc_genomes.items():
            p = td / f"acc_{t}.fa"
            p.write_text(f">{t}\n{g}\n")
            tlines.append(f"{p} {t}")
        (td / "acc_targets.txt").write_text("\n".join(tlines) + "\n")
        db_a = build_db(parse_targets_file(td / "acc_targets.txt"),
                        DBConfig(k=31, target_load=0.7))
        names_a, seqs_a = _sim.simulate_reads(
            acc_genomes, acc_reads, read_len, sub_rate=0.01,
            ins_rate=0.001, del_rate=0.001, seed=99)
        _sim.write_fastq(td / "acc.fq", names_a, seqs_a)
        clf_a = new_classifier(db_a)
        kernels.reset_launches()
        clf_a.classify_file_to_csv(td / "acc.fq", td / "acc.csv")
        acc_launches = launched()
        res_a = _sim.evaluate_assignments(td / "acc.csv")
        o = res_a["overall"]
        detail["accuracy"] = {
            "n_reads": acc_reads,
            "sub_rate": 0.01, "indel_rate": 0.002,
            "db_kmers": int(db_a.num_kmers),
            "recall": round(o["recall"], 4),
            "precision": round(o["precision"], 4),
            "unclassified": round(o["unclassified"], 4),
            "min_target_recall": round(
                min(d["recall"] for d in res_a["per_target"].values()),
                4),
            "launches": acc_launches,
        }
        _log(f"accuracy: recall={o['recall']:.4f} "
             f"precision={o['precision']:.4f}")
        clf_a.close()
        del db_a, clf_a
        gc.collect()

    # --- resident against streamed, the at-scale table in parts ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_STREAM", 1)):
        _log("stream_ratio (host-streamed parts)")
        s_reads = min(e2e_reads, 262144)
        fq_s = td / "stream.fq"
        starts_s = rng.integers(0, len(genome) - read_len, size=s_reads)
        write_fastq(fq_s, genome[starts_s[:, None]
                                 + np.arange(read_len)[None, :]])
        main_np, stash_np = db_s.split_tables()
        budget = (main_np.nbytes / 8
                  + (stash_np.nbytes if stash_np is not None else 0)) / 1e6
        # the resident CSV of the same file, untimed: the streamed one
        # must equal it
        clf = new_classifier(db_s)
        clf.classify_file_to_csv(fq_s, td / "outs_resident.csv")
        clf.close()
        del clf
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        clf = new_classifier(db_s, max_table_mb=budget + 1)

        # the pageable copy rate right before and after the timed
        # passes, each the better of two copies of fresh buffers
        def h2d_rate():
            rates = [h2d_mb_per_s(64) for _ in range(2)]
            return None if rates[0] is None else max(rates)

        rate_before = h2d_rate()
        blk = e2e_times(clf, fq_s, td / "outs.csv", s_reads, passes=3)
        rate_after = h2d_rate()
        if (td / "outs.csv").read_bytes() != (
                td / "outs_resident.csv").read_bytes():
            raise AssertionError("stream_ratio: the streamed CSV differs "
                                 "from the resident CSV")
        exact["stream_csv_eq_resident"] = True
        blk["stream_parts"] = clf.stream_parts
        blk["ratio_vs_resident"] = round(
            detail["e2e_scale"]["reads_per_sec"] / blk["reads_per_sec"], 2)
        rate = (None if rate_before is None
                else min(rate_before, rate_after))
        blk["h2d_mb_per_s"] = None if rate is None else round(rate, 1)
        blk["h2d_mb_per_s_before"] = (None if rate_before is None
                                      else round(rate_before, 1))
        blk["h2d_mb_per_s_after"] = (None if rate_after is None
                                     else round(rate_after, 1))
        blk["part_upload_gb_per_s"] = clf.part_upload_gbps()
        blk["stream_group"] = clf.stream_group_eff
        groups = -(-s_reads // (chunk * clf.stream_group_eff))
        blk["upload_gb_per_pass"] = round(groups * main_np.nbytes / 1e9, 2)
        # a floor at the slowest part upload of the last group: the parts
        # go from page-locked rows on a copy stream, not at the pageable
        # rate above
        up = blk["part_upload_gb_per_s"]
        blk["upload_bound_s"] = (
            round(groups * main_np.nbytes / 1e9 / min(up), 4) if up
            else None)
        blk["ratio_to_upload_bound"] = (
            None if blk["upload_bound_s"] is None
            else round(min(blk["pass_s"]) / max(blk["upload_bound_s"],
                                                1e-9), 2))
        detail["stream_ratio"] = blk
        clf.close()
        del clf, main_np, stash_np
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # --- the multi-process engine in one process against the plain
    #     path ---
    if e2e_reads and int(os.environ.get("CUCLARK_BENCH_MESH", 1)):
        _log("mesh_e2e (GlobalClassifier, one process, a 1 x 1 mesh)")
        from cuclark_tpu_torch.parallel import multihost
        from cuclark_tpu_torch.parallel.mesh import make_global_mesh

        mesh = make_global_mesh(1, devices=[dev])
        engine = multihost.GlobalClassifier(
            db_s, ClassifyConfig(batch_reads=chunk), mesh=mesh)
        engine.classify_file_to_csv(fq, td / "outm.csv")  # warm-up
        kernels.reset_launches()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = engine.classify_file_to_csv(fq, td / "outm.csv")
            sync()
            ts.append(time.perf_counter() - t0)
            if n != e2e_reads:
                raise AssertionError(f"{n} reads classified of {e2e_reads}")
        m_launches = launched()
        if (td / "outm.csv").read_bytes() != (
                td / "out_scale.csv").read_bytes():
            raise AssertionError("mesh_e2e: the mesh CSV differs from "
                                 "e2e_scale's")
        exact["mesh_csv_eq_e2e_scale"] = True
        med = statistics.median(ts)
        detail["mesh_e2e"] = {
            "reads_per_sec": round(e2e_reads / med, 1),
            "pass_s": ts,
            "spread": _spread(ts),
            "ratio_vs_plain": round(
                detail["e2e_scale"]["reads_per_sec"] / (e2e_reads / med),
                2),
            "mesh": (f"one process, a 1 x 1 mesh of one "
                     f"{'card' if on_card else 'CPU'}"),
            "launches": m_launches,
        }
        engine.close()
        del engine
        gc.collect()

    del db
    gc.collect()

    # --- the light preset with paired mates, file -> CSV ---
    paired_reads = int(os.environ.get("CUCLARK_BENCH_PAIRED_READS",
                                      1_000_000))
    if paired_reads:
        _log(f"light_paired ({paired_reads} mate pairs)")
        lk = 27
        lcfg = DBConfig(k=lk, gap=4, target_load=0.7)
        db_l, build_l, _ = synth_db(
            int(os.environ.get("CUCLARK_BENCH_LIGHT_KMERS", 32_000_000)),
            1024, 0.7, kcfg=lcfg)
        mlen = read_len // 2
        starts_p = rng.integers(0, len(genome) - read_len,
                                size=paired_reads)
        m1 = genome[starts_p[:, None] + np.arange(mlen)[None, :]]
        m2 = genome[starts_p[:, None] + np.arange(mlen, read_len)[None, :]]
        write_fastq(td / "r1.fq", m1)
        write_fastq(td / "r2.fq", m2)
        clf = new_classifier(db_l)
        blk = e2e_times(clf, td / "r1.fq", td / "outp.csv", paired_reads,
                        paired=td / "r2.fq")
        blk.update({"k": lk, "gap": 4,
                    "db_kmers": int(db_l.num_kmers),
                    "table_mb": round(db_l.table.nbytes / 1e6, 1),
                    "db_build_s": round(build_l, 1),
                    "pairs_per_min": blk.pop("objects_per_min")})
        # the first chunk of pairs as the pipeline joins them (mate 1, an
        # N, mate 2; the file's bases read back as codes) in its length
        # bin: the fused kernel's shape on this path
        n_j = min(chunk, paired_reads)
        width = clf._bin_for(2 * mlen + 1)
        joined = np.full((n_j, width), codec.INVALID, np.uint8)
        joined[:, :mlen] = 3 - m1[:n_j]
        joined[:, mlen + 1:2 * mlen + 1] = 3 - m2[:n_j]
        blk["planted"] = planted_check(db_l, clf.table, clf.stash, joined,
                                       "light_paired")
        exact["light_paired_step_vs_plain"] = True
        blk["length_bin"] = width
        if on_card:
            p2, vb = (torch.from_numpy(a).to(dev)
                      for a in codec.pack_codes(joined))
            blk["kernel"] = kernel_row(db_l, clf.table, clf.stash, p2, vb)
            blk["kernel"]["launches"] = blk["launches"].get("query_score", 0)
            del p2, vb
        detail["light_paired"] = blk
        clf.close()
        del clf, db_l
        gc.collect()

    del db_s
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # --- the 256M-k-mer table (about 4.4 GB), resident ---
    if g4_kmers:
        _log(f"scale4g: {g4_kmers} kmers (widened qs table)")
        db4, build4, cached4 = synth_db(g4_kmers, scale_targets, 0.85,
                                        cache_tag="4g")
        _log("scale4g step")
        _, blk4 = step_block(db4, build4, "scale4g", cached=cached4)
        blk4["n_targets"] = scale_targets
        detail["scale4g"] = blk4
        del db4
        gc.collect()

    td_ctx.cleanup()

    # --- the out-of-core build probe (spill path; a fresh process's
    #     RSS): 320M occurrences under a 4 GB occurrence budget (16 B
    #     each: 5.1 GB > budget, so the disk-shard path runs) ---
    build_mb = int(os.environ.get("CUCLARK_BENCH_BUILD_MB", 320))
    if build_mb:
        ram_mb = int(os.environ.get("CUCLARK_BENCH_BUILD_RAM_MB", 4096))
        _log(f"spill-path build probe ({build_mb} Mbases / {ram_mb} MB "
             f"budget, subprocess)")
        from torch_bench_build_scale import run_subprocess as build_run

        try:
            detail["build_spill"] = build_run(build_mb, ram_mb=ram_mb)
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            detail["build_spill"] = {"error": str(e)}

    detail["exact"] = exact
    out = {
        "metric": "reads_per_sec",
        "value": round(rps_scale, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps_scale / BASELINE_READS_PER_SEC, 3),
        "detail": detail,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
