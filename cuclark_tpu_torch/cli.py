"""Command-line interface of the PyTorch port.

Counterpart of `cuclark_tpu/cli.py`, with every subcommand and flag of
`cuclark-tpu` under one `cuclark-tpu-torch` entry point:

  cuclark-tpu-torch build-db  -T targets.txt -D dbdir [-k 31] [--light] ...
  cuclark-tpu-torch classify  -D dbdir -O reads.fq -R out.csv [--device cuda]
  cuclark-tpu-torch set-targets <dbdir> <refdir...> --rank species
  cuclark-tpu-torch abundance -R out.csv [-D dbdir]
  cuclark-tpu-torch density | simulate-reads | evaluate | analyze | clean
  cuclark-tpu-torch info | export-clark | import-clark | export-ht | import-ht

`classify` runs single-end (-O) or paired (-P) reads against a qs, q4
or s2 database on one device (`--device`, default `cuda`; `cpu` runs the
kernels' plain PyTorch versions) or a mesh of devices (`-d`), with
default or --extended CSV output.  The table stays resident when it
fits the device's free memory (or --max-table-mb), else it streams in
bucket-range parts.  `--num-hosts`/`--host-id` classify one host's share
of the input; `--coordinator`/`--num-processes`/`--process-id` run one
job over several processes (torch.distributed, gloo), each writing
<results>.h<rank>.  `--profile DIR` writes a torch.profiler trace of the
single-process job loop, with the program's spans (`spans`, category
`cuclark_span`) on the trace's clock.  `classify` builds the database
first when it is missing, as the reference's CuCLARK constructor does
(src/CuCLARK_hh.hh:221-310).  The other subcommands are host code: the
same output as `cuclark-tpu`'s, byte for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from cuclark_tpu_torch.config import (
    ClassifyConfig,
    DBConfig,
    DEFAULT_GAP_LIGHT,
    DEFAULT_K_LIGHT,
)


def _db_path(dbdir: Path, cfg: DBConfig, num_targets: int) -> Path:
    from cuclark_tpu_torch.db_build.builder import db_name

    return dbdir / db_name(cfg, num_targets)


def _find_db(dbdir: Path) -> Path | None:
    cands = sorted(dbdir.glob("db_k*.npz"))
    return cands[0] if cands else None


def _build_cfg(args) -> DBConfig:
    k = args.k
    gap = args.gap
    if getattr(args, "light", False):
        # cuCLARK-l preset: k=27, every-4th-k-mer DB (src/main.cc:241-249)
        k = DEFAULT_K_LIGHT
        if gap == 1:
            gap = DEFAULT_GAP_LIGHT
    return DBConfig(k=k, gap=gap, min_count=args.min_freq_target,
                    slots=args.slots, num_choices=args.choices,
                    target_load=args.load, layout=args.layout,
                    build_ram_mb=getattr(args, "build_ram_mb", 4096),
                    widen_for_warm_stash=not getattr(args, "no_widen_stash",
                                                     False))


def cmd_build_db(args) -> int:
    from cuclark_tpu_torch.db_build.builder import build_db, parse_targets_file

    cfg = _build_cfg(args)
    file_labels = parse_targets_file(args.targets)
    t0 = time.time()
    tsk_dir = Path(args.db_dir) / "tsk" if getattr(args, "tsk", False) else None
    db = build_db(
        file_labels, cfg,
        progress=lambda fp, lb: print(f"  {fp} -> {lb}", file=sys.stderr),
        tsk_dir=tsk_dir,
    )
    dbdir = Path(args.db_dir)
    dbdir.mkdir(parents=True, exist_ok=True)
    out = _db_path(dbdir, cfg, db.num_targets)
    db.save(out)
    print(
        f"Built DB: {db.num_kmers} target-specific {cfg.k}-mers, "
        f"{db.num_targets} targets, {1 << db.nb_bits} buckets x {db.slots} slots "
        f"({db.table.nbytes / 1e6:.1f} MB) in {time.time() - t0:.1f}s -> {out}",
        file=sys.stderr,
    )
    return 0


def _build_jobs(args):
    """(input, paired_mate, output) triples from -O/-P/-R, honoring the
    list modes (src/CuCLARK_hh.hh:382-506).  Raises ValueError when an
    input or output file is missing from the flags."""
    from cuclark_tpu_torch.io import fasta

    jobs = []
    if args.paired:
        # paired list mode: -P may name two lists of mate files with -R
        # a matching list of result paths
        triples = fasta.parse_paired_file_lists(
            args.paired[0], args.paired[1], args.results)
        if triples is None:
            jobs.append((args.paired[0], args.paired[1], args.results))
        else:
            jobs.extend(triples)
    elif args.objects:
        pairs = fasta.parse_file_list(args.objects)
        if pairs is None:
            jobs.append((args.objects, None, args.results))
        else:
            # multi-file mode: the list names each job's result path
            jobs.extend((obj, None, res) for obj, res in pairs)
    else:
        raise ValueError("classify needs -O <reads> (or -P <R1> <R2>)")
    for path, _, out_path in jobs:
        if not out_path:
            raise ValueError(
                f"no result path for {path}: pass -R (or use an "
                f"objects list with '<reads> <results>' lines)")
    return jobs


def _profiler(trace_dir: str | None, device: str, since: int = 0):
    """A torch.profiler context over the classify jobs (the reference's
    jax.profiler.trace): host operations, and the card's kernels and
    copies when `device` is a CUDA device.  On exit it writes a Chrome
    trace (`<host>_<pid>.<ns>.pt.trace.json`) into trace_dir, with the
    program's spans begun after the mark `since` (the command's set-up
    spans and the profiled loop's spans) as events of category
    `cuclark_span`, and the process's counters as its
    `cuclark_counters` entry.  A null context when trace_dir is None."""
    if trace_dir is None:
        return contextlib.nullcontext()
    import os
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuclark_tpu_torch import spans

    def write(prof):
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / (f"{socket.gethostname()}_{os.getpid()}."
                      f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(str(path))
        snap = spans.snapshot(since)
        spans.add_to_chrome_trace(path, snap["spans"], os.getpid(),
                                  snap["counters"])

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=write)


def cmd_classify(args) -> int:
    from cuclark_tpu_torch import spans
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.pipeline import Classifier

    since = spans.mark()  # the spans a --profile trace holds begin here
    if args.sfactor != 1 and not 2 <= args.sfactor <= 30:
        # reference bound: [2, SFACTORMAX=30] (src/main.cc:214-218)
        print("error: the sampling factor value should be in the "
              "interval [2,30].", file=sys.stderr)
        return 1
    dbdir = Path(args.db_dir)
    settings = _read_settings(dbdir)
    if settings and settings.get("targets"):
        # a set-targets database: refuse a conflicting -T
        # (classify_metagenome.sh:60-87 forbids -T/-D override) and use
        # the recorded targets for implicit builds
        rec = str(Path(settings["targets"]))
        if args.targets and str(Path(args.targets)) != rec:
            print(f"error: this database is managed by set-targets "
                  f"(.settings records -T {rec}); omit -T or use that "
                  f"file.", file=sys.stderr)
            return 1
        args.targets = rec
    dbp = _find_db(dbdir)
    if dbp is None:
        if not args.targets:
            print(f"No database in {dbdir} and no -T targets to build one.",
                  file=sys.stderr)
            return 1
        print("Database not found; building it first...", file=sys.stderr)
        rc = cmd_build_db(args)
        if rc:
            return rc
        dbp = _find_db(dbdir)

    db = KmerDB.load(dbp, sample_factor=args.sfactor)
    cfg = ClassifyConfig(batch_reads=args.batch, extended=args.extended,
                         sample_factor=args.sfactor,
                         max_table_mb=args.max_table_mb,
                         stream_group=args.stream_group)
    if args.num_processes or args.coordinator:
        if args.resume:
            print("warning: --resume is not supported on the "
                  "multi-process path (per-process record blocks shift as "
                  "shards fill); re-running the file from the start.",
                  file=sys.stderr)
        return _classify_multiprocess(args, db, cfg)
    mesh = _choose_mesh(args.devices, db, args.max_table_mb, args.device)
    if mesh is not None:
        print(f" - Mesh: {mesh.shape['data']} data x {mesh.shape['db']} db "
              f"devices", file=sys.stderr)
    clf = Classifier(db, cfg, device=args.device, mesh=mesh)
    try:
        if clf.stream_parts > 1:
            # swap-cycle analog: the table exceeds the device budget
            src = (f"--max-table-mb {args.max_table_mb}"
                   if args.max_table_mb is not None
                   else f"auto device budget {clf.table_budget_mb:.0f} MB")
            print(f" - Streaming DB in {clf.stream_parts} bucket-range "
                  f"parts ({src})", file=sys.stderr)
        jobs = _build_jobs(args)  # (path, paired_path, out_path)
        with _profiler(args.profile, args.device, since):
            for path, paired_path, out_path in jobs:
                t0 = time.time()
                skip = 0
                if args.resume:
                    skip = _count_csv_rows(out_path)
                    if skip:
                        print(f"Resuming after {skip} already-classified "
                              f"reads.", file=sys.stderr)
                n = clf.classify_file_to_csv(
                    path, out_path, paired_path, skip=skip,
                    num_hosts=args.num_hosts, host_id=args.host_id,
                    append=bool(skip))
                n += skip
                dt = time.time() - t0
                # reference prints objects/min (src/CuCLARK_hh.hh:1940-1943)
                print(
                    f" - Assignment time: {dt:.6g} s. Speed: "
                    f"{int(n / dt * 60.0) if dt > 0 else 0} objects/min. "
                    f"({n} objects).",
                )
                print(f" - Results stored in {out_path}")
    finally:
        clf.close()
    if args.profile is not None:
        print(f" - Profiler trace in {args.profile}", file=sys.stderr)
    return 0


def _classify_multiprocess(args, db, cfg) -> int:
    """One classify job over several processes (the JAX package's
    global-mesh path, cuclark_tpu/cli.py:217-267): bring up
    torch.distributed (gloo), build this process's mesh of its own
    devices, and run the multi-process engine.  Each process writes
    <results>.h<rank>; concatenating the shards in rank order gives the
    single-process CSV byte for byte."""
    import dataclasses

    import torch

    from cuclark_tpu_torch.memplan import plan_db_axis, resolve_table_budget_mb
    from cuclark_tpu_torch.parallel import multihost
    from cuclark_tpu_torch.parallel.mesh import local_devices, make_global_mesh

    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id)
    try:
        nproc = multihost.process_count()
        devices = local_devices(torch.device(args.device).type)
        if not devices:
            raise RuntimeError(f"--device {args.device}: no device of that "
                               f"type is visible to this process")
        # every process must plan the SAME mesh shape: agree on the
        # global minimum budget before deriving num_db from it (live
        # per-process memory differs; two ranks on one card each see the
        # other's table)
        budget_mb = multihost.agree_budget_mb(
            resolve_table_budget_mb(args.max_table_mb, devices[0]))
        if budget_mb is not None:
            cfg = dataclasses.replace(cfg, max_table_mb=budget_mb)
        # db axis capped at this process's device count; if a device's
        # shard still exceeds the budget, the engine streams bucket-range
        # parts on top (cycles x devices x parts, src/CuClarkDB.cu:540-574)
        num_db = plan_db_axis(db.table.nbytes, budget_mb, len(devices))
        mesh = make_global_mesh(num_db, devices)
        print(f" - Global mesh: {mesh.shape['data']} data x "
              f"{mesh.shape['db']} db per process, {nproc} process(es)",
              file=sys.stderr)
        jobs = _build_jobs(args)
        # one engine for all files: the table goes to the devices once
        engine = multihost.GlobalClassifier(db, cfg, num_db=num_db, mesh=mesh)
        try:
            for path, paired_path, out_path in jobs:
                t0 = time.time()
                n = engine.classify_file_to_csv(path, out_path, paired_path)
                dt = time.time() - t0
                print(f" - Assignment time: {dt:.6g} s. Speed: "
                      f"{int(n / dt * 60.0) if dt > 0 else 0} objects/min. "
                      f"({n} objects on process "
                      f"{multihost.process_index()}).")
        finally:
            engine.close()
    finally:
        multihost.shutdown()
    return 0


def _choose_mesh(devices: int, db, max_table_mb, device: str):
    """A (data x db) device mesh for classify (-d, reference '-d <number
    of GPU devices>'; cuclark_tpu/cli.py:270-303), or None for one
    device.

    devices: 0 = all of `device`'s type available (every visible card;
    CUCLARK_CPU_DEVICES handles for the CPU), 1 = no mesh, N = the first
    N.  The db axis grows (powers of two) only while the per-device table
    shard exceeds the memory budget; the other devices go to the data
    axis, so reads shard instead of being replicated to every device as
    the reference does (src/CuClarkDB.cu:886-895)."""
    if devices == 1:
        return None
    import torch

    from cuclark_tpu_torch.memplan import plan_db_axis, resolve_table_budget_mb
    from cuclark_tpu_torch.parallel.mesh import local_devices, make_mesh

    avail_devs = local_devices(torch.device(device).type)
    avail = len(avail_devs)
    n = avail if devices in (0, None) else min(devices, avail)
    if devices not in (0, None) and devices > avail:
        print(f" - Requested {devices} devices, only {avail} available.",
              file=sys.stderr)
    if n < 1:
        return None
    # largest power of two <= n keeps both axes power-of-two (nb % db == 0)
    pow2 = 1 << (n.bit_length() - 1)
    if pow2 != n:
        print(f" - Using {pow2} of {n} devices (mesh axes must be "
              f"powers of two so bucket ranges divide evenly).",
              file=sys.stderr)
    n = pow2
    if n < 2:
        return None
    budget_mb = resolve_table_budget_mb(max_table_mb, avail_devs[0])
    num_db = plan_db_axis(db.table.nbytes, budget_mb, n)
    return make_mesh(num_db, n // num_db, avail_devs[:n])


def _read_settings(dbdir: Path) -> dict | None:
    p = dbdir / ".settings"
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (ValueError, OSError):
        return None


def _count_csv_rows(path) -> int:
    """Completed data rows in a (possibly crash-truncated) result CSV.

    A process killed mid-write can leave a final line without its
    trailing '\\n'.  Counting that partial line as done would make
    --resume skip the read it belongs to, leaving one permanently
    corrupt row; instead the dangling tail is truncated here so the
    resumed run re-emits that read's row and the final file is
    byte-identical to an uninterrupted run."""
    try:
        with open(path, "r+b") as f:
            f.seek(0, 2)
            size = f.tell()
            if size == 0:
                return 0
            f.seek(size - 1)
            if f.read(1) != b"\n":
                # scan backwards for the last complete line's newline
                pos, last_nl = size - 1, -1
                while pos > 0 and last_nl < 0:
                    start = max(0, pos - (1 << 16))
                    f.seek(start)
                    last_nl_rel = f.read(pos - start).rfind(b"\n")
                    if last_nl_rel >= 0:
                        last_nl = start + last_nl_rel
                    pos = start
                f.truncate(last_nl + 1)  # 0 when no newline exists at all
                f.seek(0, 2)
                size = f.tell()
            if size == 0:
                return 0
        # count repaired-complete lines; one native memchr pass when
        # available (a multi-GB CSV is not re-read line by line in
        # Python before classification even starts)
        from cuclark_tpu_torch import native

        if native.available():
            import numpy as _np

            return max(0, native.count_lines(
                _np.memmap(path, dtype=_np.uint8, mode="r")) - 1)
        with open(path, "rb") as f:
            return max(0, sum(1 for _ in f) - 1)
    except PermissionError:
        # readable-but-not-writable file: count only COMPLETE lines
        # (no truncation possible — the later append will fail with a
        # clear error anyway, but the count itself must not be 0)
        try:
            with open(path, "rb") as f:
                return max(0, sum(1 for line in f
                                  if line.endswith(b"\n")) - 1)
        except OSError:
            return 0
    except OSError:
        return 0


def _read_csv_header(path):
    """(header fields, header byte length) of a result CSV."""
    with open(path, "rb") as f:
        header_b = f.readline()
    return header_b.decode("utf-8", "replace").rstrip("\r\n").split(","), \
        len(header_b)


def _iter_complete_rows(path, ncols: int):
    """Data rows of a result CSV via the csv module (the no-compiler
    fallback shared by abundance and density): skips the header and
    blank lines, raises ValueError on a row with the wrong field
    count, and silently drops a crash-truncated FINAL row — matching
    the native csv_tally/csv_values semantics.  The final row counts
    as fully written (and is therefore validated, not dropped) when
    the file ends with a newline."""
    import csv as _csv

    with open(path, "rb") as fb:
        fb.seek(0, 2)
        size = fb.tell()
        tail_complete = True
        if size:
            fb.seek(size - 1)
            tail_complete = fb.read(1) == b"\n"

    def checked(row):
        if len(row) != ncols:
            raise ValueError("malformed result CSV row "
                             f"(fields {len(row)} != {ncols})")
        return row

    with open(path) as f:
        reader = _csv.reader(f)
        next(reader, None)
        prev = None  # delay one row so the tail rule can apply
        for row in reader:
            if not row:
                continue
            if prev is not None:
                yield checked(prev)
            prev = row
        if prev is not None and (tail_complete or len(prev) == ncols):
            yield checked(prev)


def _csv_body_mmap(path, header_len: int):
    """Memory-map the data rows of a result CSV (None when empty or the
    native module is unavailable).  mmap instead of a read(): a ladder-4
    result file is GBs — the tally streams it through page cache without
    holding it in RSS."""
    import os as _os

    from cuclark_tpu_torch import native

    if not native.available():
        return None
    size = _os.path.getsize(path)
    if size <= header_len:
        return None
    import numpy as np

    return np.memmap(path, dtype=np.uint8, mode="r", offset=header_len)


def cmd_abundance(args) -> int:
    """Per-target read counts + proportions from a result CSV — the
    CLARK-side estimate_abundance summary (README.md:58-80 notes CLARK's
    scripts consume this CSV format).  With -D, the database's full
    target list seeds the report so unhit targets appear with count 0
    (CLARK's estimate_abundance reports every DB target).

    Ingestion is one native pass (csrc/host_ops.cpp csv_tally) —
    per-row Python parsing would take minutes of single-core work on a
    100M-row ladder-4 CSV downstream of a ~30 s classify; the csv
    module path remains as the no-compiler fallback."""
    counts: dict[str, int] = {}
    if getattr(args, "db_dir", None):
        dbp = _find_db(Path(args.db_dir))
        if dbp is None:
            print(f"no database found in {args.db_dir}", file=sys.stderr)
            return 1
        from cuclark_tpu_torch.hashdb import load_target_names

        # meta-only read: the table array (possibly GBs) is not needed
        counts = {name: 0 for name in load_target_names(dbp)[1:]}
    total = 0
    min_conf = args.min_confidence
    min_gamma = args.min_gamma
    if args.highconfidence:
        # CLARK estimate_abundance --highconfidence preset:
        # confidence >= 0.75 and gamma >= 0.03
        min_conf = max(min_conf, 0.75)
        min_gamma = max(min_gamma, 0.03)
    header, header_len = _read_csv_header(args.results)
    try:
        col = header.index("1st_assignment")
    except ValueError:
        print("not a cuclark result CSV", file=sys.stderr)
        return 1
    conf_col = header.index("confidence") if "confidence" in header else -1
    gamma_col = header.index("Gamma") if "Gamma" in header else -1
    buf = _csv_body_mmap(args.results, header_len) \
        if len(header) <= 4096 else None
    if buf is not None:
        from cuclark_tpu_torch import native

        try:
            names, cnts, total = native.csv_tally(
                buf, len(header), col, conf_col, gamma_col,
                min_conf, min_gamma, offset0=header_len)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        for name, c in zip(names, cnts.tolist()):
            if c == 0 and name not in counts:
                continue  # the pre-interned NA id when no row was NA
            counts[name] = counts.get(name, 0) + c
    else:
        for row in _iter_complete_rows(args.results, len(header)):
            t = row[col]
            # low-confidence assignments are counted as unclassified,
            # like CLARK's estimate_abundance -c
            if t != "NA":
                if (min_conf > 0 and conf_col >= 0
                        and float(row[conf_col]) < min_conf):
                    t = "NA"
                elif (min_gamma > 0 and gamma_col >= 0
                        and float(row[gamma_col]) < min_gamma):
                    t = "NA"
            counts[t] = counts.get(t, 0) + 1
            total += 1
    classified = total - counts.get("NA", 0)
    print("Name,Count,Proportion_All(%),Proportion_Classified(%)")
    # tie-break by name so the report is deterministic and identical
    # across the native and csv-fallback paths (their dict insertion
    # orders differ; a bare -count sort would leak that into ties)
    for name, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        pc = "-" if name == "NA" else (
            f"{100.0 * c / classified:.4f}" if classified else "0.0000")
        pa = f"{100.0 * c / total:.4f}" if total else "0.0000"
        print(f"{name},{c},{pa},{pc}")
    return 0


def cmd_density(args) -> int:
    """Distribution of the confidence or gamma column of a result CSV —
    the CLARK-side evaluate_density_confidence.sh /
    evaluate_density_gamma.sh companions (reference README.md:77-80),
    computed natively: prints `bin_start,count,fraction` histogram rows
    for assigned reads."""
    import numpy as np

    colname = {"confidence": "confidence", "gamma": "Gamma"}[args.by]
    header, header_len = _read_csv_header(args.results)
    try:
        col = header.index(colname)
        acol = header.index("1st_assignment")
    except ValueError:
        print("not a cuclark result CSV", file=sys.stderr)
        return 1
    buf = _csv_body_mmap(args.results, header_len) \
        if len(header) <= 4096 else None
    if buf is not None:
        from cuclark_tpu_torch import native

        try:
            v = native.csv_values(buf, len(header), col, acol,
                                  offset0=header_len)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
    else:
        vals = [float(row[col])
                for row in _iter_complete_rows(args.results, len(header))
                if row[acol] != "NA"]
        v = np.asarray(vals, np.float64)
    if len(v) == 0:
        print("no assigned reads", file=sys.stderr)
        return 1
    lo, hi = (0.5, 1.0) if args.by == "confidence" else (0.0, 1.0)
    hist, edges = np.histogram(v, bins=args.bins, range=(lo, hi))
    print(f"{args.by}_bin,count,fraction")
    for c, e in zip(hist, edges[:-1]):
        print(f"{e:.4f},{c},{c / len(v):.4f}")
    print(f"# assigned={len(v)} mean={v.mean():.4f} median="
          f"{np.median(v):.4f}", file=sys.stderr)
    return 0


def cmd_simulate_reads(args) -> int:
    """wgsim-style synthetic accuracy reads (the reference's sanctioned
    QA inputs — data/README.md:1-21 ships HiSeq/MiSeq accuracy sets and
    wgsim-simulated reads with truth in the names)."""
    from cuclark_tpu_torch import simulate
    from cuclark_tpu_torch.db_build.builder import parse_targets_file
    from cuclark_tpu_torch.io import fast_parse
    from cuclark_tpu_torch.pipeline import _read_file_bytes

    genomes: dict[str, list[str]] = {}
    for fpath, label, _ in parse_targets_file(args.targets):
        buf = _read_file_bytes(fpath)
        _, _, ss, se = fast_parse.scan_file(buf)
        genomes.setdefault(label, []).extend(
            buf[s:e].tobytes().decode("ascii", "replace")
            for s, e in zip(ss, se))
    if args.paired_output:
        names, s1, s2 = simulate.simulate_reads(
            genomes, args.num_reads, args.read_len, args.sub_rate,
            args.ins_rate, args.del_rate, args.seed, paired=True)
        simulate.write_fastq(args.output, names, s1)
        simulate.write_fastq(args.paired_output, names, s2)
    else:
        names, seqs = simulate.simulate_reads(
            genomes, args.num_reads, args.read_len, args.sub_rate,
            args.ins_rate, args.del_rate, args.seed)
        simulate.write_fastq(args.output, names, seqs)
    print(f"Wrote {args.num_reads} simulated reads "
          f"(sub={args.sub_rate}, ins={args.ins_rate}, "
          f"del={args.del_rate}) to {args.output}", file=sys.stderr)
    return 0


def cmd_evaluate(args) -> int:
    """Classification accuracy vs name-embedded truth: per-target
    precision/recall/unclassified of a result CSV produced from
    simulate-reads input (or any reads whose Object_IDs end in
    '|<truth_label>')."""
    from cuclark_tpu_torch import simulate

    res = simulate.evaluate_assignments(args.results)
    print("Target,Reads,Assigned,Recall,Precision,Unclassified")
    for t, d in res["per_target"].items():
        print(f"{t},{d['reads']},{d['assigned']},{d['recall']:.4f},"
              f"{d['precision']:.4f},{d['unclassified']:.4f}")
    o = res["overall"]
    print(f"OVERALL,{o['reads']},,{o['recall']:.4f},{o['precision']:.4f},"
          f"{o['unclassified']:.4f}")
    rc = 0
    if args.min_recall is not None and o["recall"] < args.min_recall:
        print(f"FAIL: overall recall {o['recall']:.4f} < "
              f"{args.min_recall}", file=sys.stderr)
        rc = 1
    if args.min_precision is not None and o["precision"] < args.min_precision:
        print(f"FAIL: overall precision {o['precision']:.4f} < "
              f"{args.min_precision}", file=sys.stderr)
        rc = 1
    return rc


def cmd_analyze(args) -> int:
    """Spectrum bump-interval analysis (the reference's analyser,
    src/analyser.cc:46-137, wired live): prints the multiplicity
    histogram summary and the detected solid-kmer interval, with the
    suggested -t for build-db on this spectrum."""
    from cuclark_tpu_torch import analyser

    freq = analyser.spectrum_histogram(args.input)
    total = int(freq.sum())
    found, lo, hi = analyser.bump_interval(freq, div=args.div)
    print(f"spectrum: {total} k-mers, multiplicities 1..{len(freq) - 1}")
    if found:
        print(f"bump interval: [{lo}, {hi}]")
        print(f"suggested build-db min multiplicity: -t {max(lo - 1, 0)} "
              f"(keeps counts >= {lo})")
    else:
        print(f"no bump detected; nonzero range [{lo}, {hi}]")
    return 0


def cmd_clean(args) -> int:
    """Remove database artifacts (resetCustomDB.sh / clean.sh analog):
    by default keeps targets.txt and the tsk archive; --all removes
    everything produced in the db dir."""
    import shutil

    d = Path(args.db_dir)
    if not d.exists():
        return 0
    removed = []
    for p in d.glob("db_k*.npz"):
        p.unlink()
        removed.append(p.name)
    if args.all:
        for name in ("tsk", "targets.txt", ".settings", "files_excluded.txt"):
            p = d / name
            if p.is_dir():
                shutil.rmtree(p)
                removed.append(name + "/")
            elif p.exists():
                p.unlink()
                removed.append(name)
    print(f"removed: {', '.join(removed) if removed else 'nothing'}",
          file=sys.stderr)
    return 0


def cmd_export_clark(args) -> int:
    """Write the database in the CLARK-family .sz/.ky/.lb layout so a
    CLARK/CuCLARK installation can cross-validate it
    (src/hashTable_hh.hh:590-663)."""
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.io import clark_db

    dbp = _find_db(Path(args.db_dir))
    if dbp is None:
        print("no database found", file=sys.stderr)
        return 1
    db = KmerDB.load(dbp)
    htsize = args.htsize or (clark_db.HTSIZE_LIGHT if args.light
                             else clark_db.HTSIZE_FULL)
    kmers, labels = db.items()
    n = clark_db.export_clark_db(kmers, labels, args.output, db.k, htsize)
    print(f"exported {n} {db.k}-mers -> {args.output}.sz/.ky/.lb "
          f"(HTSIZE={htsize})", file=sys.stderr)
    return 0


def cmd_import_clark(args) -> int:
    """Build a database from CLARK .sz/.ky/.lb files + the targets
    definition that names its label indices."""
    from cuclark_tpu_torch.db_build.builder import LabelSpace, db_name, parse_targets_file
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.io import clark_db

    space = LabelSpace(parse_targets_file(args.targets))
    kmers, labels = clark_db.import_clark_db(args.input, args.k)
    cfg = _build_cfg(args)
    db = build_table(kmers, labels, space.names, cfg)
    dbdir = Path(args.db_dir)
    dbdir.mkdir(parents=True, exist_ok=True)
    out = dbdir / db_name(cfg, db.num_targets)
    db.save(out)
    print(f"imported {db.num_kmers} {args.k}-mers, "
          f"{db.num_targets} targets -> {out}", file=sys.stderr)
    return 0


def cmd_export_ht(args) -> int:
    """Dump per-target `.ht` text files (reference --tsk artifacts,
    EHashtable::SaveMultiple, src/HashTableStorage_hh.hh:295-343) that a
    CLARK/CuCLARK install can consume or rebuild from."""
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.io import clark_ht

    dbp = _find_db(Path(args.db_dir))
    if dbp is None:
        print("no database found", file=sys.stderr)
        return 1
    db = KmerDB.load(dbp)
    kmers, labels = db.items()
    n = clark_ht.export_ht_dir(kmers, labels, db.target_names,
                               args.output, db.k, light=args.light)
    print(f"exported {len(kmers)} {db.k}-mers into {n} .ht files -> "
          f"{args.output}", file=sys.stderr)
    return 0


def cmd_import_ht(args) -> int:
    """Build a database from a directory of `.ht` target-specific sets
    (the reference's rebuild-from-.ht resume path,
    src/CuCLARK_hh.hh:638-684 + EHashtable::Load)."""
    from cuclark_tpu_torch.db_build.builder import db_name
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.io import clark_ht

    kmers, labels, names, k_seen = clark_ht.import_ht_dir(
        args.input, min_count=args.min_freq_target)
    if k_seen is not None and args.k != 31 and args.k != k_seen:
        print(f"warning: -k {args.k} overridden by .ht header k={k_seen}",
              file=sys.stderr)
    if k_seen is not None:
        args.k = k_seen
    cfg = _build_cfg(args)
    db = build_table(kmers, labels, names, cfg)
    dbdir = Path(args.db_dir)
    dbdir.mkdir(parents=True, exist_ok=True)
    out = dbdir / db_name(cfg, db.num_targets)
    db.save(out)
    print(f"imported {db.num_kmers} {cfg.k}-mers, {db.num_targets} "
          f"targets from .ht -> {out}", file=sys.stderr)
    return 0


def cmd_set_targets(args) -> int:
    from cuclark_tpu_torch.taxonomy.targets import set_targets

    return set_targets(args)


def cmd_info(args) -> int:
    from cuclark_tpu_torch.hashdb import KmerDB

    dbp = _find_db(Path(args.db_dir))
    if dbp is None:
        print("no database found", file=sys.stderr)
        return 1
    db = KmerDB.load(dbp)
    info = {
        "path": str(dbp),
        "layout": db.layout,
        "k": db.k,
        "num_kmers": db.num_kmers,
        "num_targets": db.num_targets,
        "buckets": db.nb,
        "slots": db.slots,
        "num_choices": db.num_choices,
        "gap": db.gap,
        "stash_rows": db.total_rows - db.nb,
        "table_mb": round(db.table.nbytes / 1e6, 2),
        "load_factor": round(db.num_kmers / (db.total_rows * db.slots), 4),
    }
    print(json.dumps(info, indent=2))
    return 0


def _add_db_args(p):
    p.add_argument("-k", type=int, default=31, help="k-mer length [31]")
    p.add_argument("-t", "--min-freq-target", type=int, default=0,
                   help="minimum k-mer frequency in target [0]")
    p.add_argument("-g", "--gap", type=int, default=1,
                   help="k-mer sampling stride for DB build [1; light=4]")
    p.add_argument("--light", action="store_true",
                   help="light preset: k=27, gap=4 (cuCLARK-l)")
    p.add_argument("--layout", default="qs", choices=("qs", "q4", "s2"),
                   help="hash table layout: qs (quotient-compressed 32 B "
                        "rows with a small stash section), q4 (the same "
                        "rows, both hash choices in the main table) or "
                        "s2 (full-key rows of --slots slots) [qs]")
    p.add_argument("--slots", type=int, default=2,
                   help="hash bucket slots (s2 layout) [2]")
    p.add_argument("--choices", type=int, default=2, choices=(1, 2),
                   help="hash choices per key (s2 layout) [2]")
    p.add_argument("--load", type=float, default=0.7,
                   help="target hash load factor [0.7]")
    p.add_argument("--no-widen-stash", action="store_true",
                   help="qs: do NOT widen the main table when the "
                        "stash would grow past 2^20 rows (halves table "
                        "memory at GB scale)")
    p.add_argument("--build-ram-mb", type=int, default=4096,
                   help="host RAM budget for raw k-mer occurrences during "
                        "DB build; larger inputs spill to disk shards and "
                        "reduce out-of-core [4096]")
    p.add_argument("--tsk", action="store_true",
                   help="dump/resume target-specific k-mer sets "
                        "(<dbdir>/tsk) so the DB can be rebuilt without "
                        "re-streaming genomes")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ("--version", "--VERSION"):
        from cuclark_tpu_torch import __version__
        print(f"cuclark-tpu-torch {__version__} "
              f"(PyTorch/CUDA port of cuclark-tpu)")
        return 0
    ap = argparse.ArgumentParser(
        prog="cuclark-tpu-torch",
        description="metagenomic read classifier (CuCLARK capabilities) "
                    "on PyTorch and CUDA",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-db", help="build target-specific k-mer database")
    b.add_argument("-T", "--targets", required=True, help="targets definition file")
    b.add_argument("-D", "--db-dir", required=True, help="database directory")
    _add_db_args(b)
    b.set_defaults(fn=cmd_build_db)

    c = sub.add_parser("classify", help="classify reads against a database")
    c.add_argument("-T", "--targets", help="targets definition (for implicit build)")
    c.add_argument("-D", "--db-dir", required=True)
    c.add_argument("-O", "--objects", help="reads file (or objects/results list)")
    c.add_argument("-R", "--results", help="output CSV")
    c.add_argument("--device", default="cuda",
                   help="torch device to classify on: cuda, cuda:N or cpu "
                        "[cuda]")
    c.add_argument("-P", "--paired", nargs=2, metavar=("R1", "R2"),
                   help="paired-end mates (or two lists of mate files, "
                        "with -R a list of result paths)")
    c.add_argument("-s", "--sfactor", type=int, default=1,
                   help="query-time bucket sampling factor [1]")
    c.add_argument("-b", "--batch", type=int, default=65536,
                   help="reads per device batch; long-read batches "
                        "auto-shrink to the device cell budget [65536]")
    c.add_argument("-d", "--devices", type=int, default=1,
                   help="number of devices of --device's type to use; 0 = "
                        "all available (reads shard over a data axis, DB "
                        "bucket ranges over a db axis when the table "
                        "exceeds --max-table-mb); the CPU counts "
                        "CUCLARK_CPU_DEVICES devices [1]")
    c.add_argument("-n", "--threads", type=int, default=1,
                   help="accepted for reference CLI compatibility; host "
                        "packing already overlaps device compute")
    c.add_argument("--extended", action="store_true",
                   help="emit dense per-target hit columns")
    c.add_argument("--max-table-mb", type=float, default=None,
                   help="device memory budget for the DB table; larger "
                        "tables stream in bucket-range parts (swap-cycle "
                        "analog) [default: the device's free memory "
                        "minus a reserve]")
    c.add_argument("--stream-group", type=int, default=8,
                   help="minimum batches classified per DB-part upload "
                        "cycle when streaming; auto-grows to fill free "
                        "device memory [8]")
    c.add_argument("--resume", action="store_true",
                   help="append to an existing result CSV, skipping reads "
                        "already classified (crash recovery)")
    c.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the run into "
                        "DIR (host operations, and the card's kernels and "
                        "copies on a CUDA device); not taken on the "
                        "multi-process path (--coordinator)")
    c.add_argument("--num-hosts", type=int, default=1,
                   help="total hosts sharding this input for INDEPENDENT "
                        "per-host runs (no collectives) [1]")
    c.add_argument("--host-id", type=int, default=0,
                   help="this host's rank in [0, num-hosts)")
    c.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous address (rank 0 "
                        "listens there); enables the multi-process path, "
                        "each process writing <results>.h<rank>")
    c.add_argument("--num-processes", type=int, default=None,
                   help="total processes of the job")
    c.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes)")
    _add_db_args(c)
    c.set_defaults(fn=cmd_classify)

    a = sub.add_parser("abundance", help="summarize a result CSV")
    a.add_argument("-R", "--results", required=True)
    a.add_argument("-D", "--db-dir", default=None,
                   help="database directory; lists every DB target "
                        "(including unhit ones with count 0)")
    a.add_argument("--min-confidence", type=float, default=0.0)
    a.add_argument("--min-gamma", type=float, default=0.0)
    a.add_argument("--highconfidence", action="store_true",
                   help="count only assignments with confidence >= 0.75 "
                        "and gamma >= 0.03 (CLARK estimate_abundance "
                        "--highconfidence)")
    a.set_defaults(fn=cmd_abundance)

    de = sub.add_parser("density",
                        help="confidence/gamma distribution of a result "
                             "CSV (evaluate_density_* analog)")
    de.add_argument("-R", "--results", required=True)
    de.add_argument("--by", choices=("confidence", "gamma"),
                    default="confidence")
    de.add_argument("--bins", type=int, default=20)
    de.set_defaults(fn=cmd_density)

    st = sub.add_parser("set-targets", help="build targets.txt from reference dirs")
    st.add_argument("db_dir")
    st.add_argument("ref_dirs", nargs="+")
    st.add_argument("--rank", default="species",
                    choices=["species", "genus", "family", "order", "class", "phylum", "custom"])
    st.add_argument("--taxonomy-dir", help="dir with nodes.dmp / accession2taxid")
    st.set_defaults(fn=cmd_set_targets)

    sr = sub.add_parser("simulate-reads",
                        help="generate wgsim-style error-bearing reads "
                             "from target genomes (truth in read names)")
    sr.add_argument("-T", "--targets", required=True,
                    help="targets definition file: '<seqfile> <label>'")
    sr.add_argument("-O", "--output", required=True, help="output FASTQ")
    sr.add_argument("--paired-output", default=None,
                    help="mate-2 FASTQ (enables paired simulation)")
    sr.add_argument("-n", "--num-reads", type=int, default=10000)
    sr.add_argument("-l", "--read-len", type=int, default=100)
    sr.add_argument("--sub-rate", type=float, default=0.01,
                    help="per-base substitution rate [0.01]")
    sr.add_argument("--ins-rate", type=float, default=0.001,
                    help="per-base insertion rate [0.001]")
    sr.add_argument("--del-rate", type=float, default=0.001,
                    help="per-base deletion rate [0.001]")
    sr.add_argument("--seed", type=int, default=0)
    sr.set_defaults(fn=cmd_simulate_reads)

    ev = sub.add_parser("evaluate",
                        help="precision/recall of a result CSV against "
                             "name-embedded truth labels")
    ev.add_argument("-R", "--results", required=True)
    ev.add_argument("--min-recall", type=float, default=None,
                    help="exit 1 when overall recall is below this")
    ev.add_argument("--min-precision", type=float, default=None,
                    help="exit 1 when overall precision is below this")
    ev.set_defaults(fn=cmd_evaluate)

    an = sub.add_parser("analyze",
                        help="detect the solid-kmer multiplicity bump of "
                             "a spectrum file")
    an.add_argument("-i", "--input", required=True,
                    help="spectrum file: '<kmer> <count>' lines")
    an.add_argument("--div", type=int, default=2,
                    help="interval half-width divisor [2]")
    an.set_defaults(fn=cmd_analyze)

    cl = sub.add_parser("clean", help="remove database artifacts")
    cl.add_argument("-D", "--db-dir", required=True)
    cl.add_argument("--all", action="store_true",
                    help="also remove targets.txt, settings, and tsk sets")
    cl.set_defaults(fn=cmd_clean)

    i = sub.add_parser("info", help="print database info")
    i.add_argument("-D", "--db-dir", required=True)
    i.set_defaults(fn=cmd_info)

    ec = sub.add_parser("export-clark",
                        help="export database as CLARK .sz/.ky/.lb")
    ec.add_argument("-D", "--db-dir", required=True)
    ec.add_argument("-o", "--output", required=True,
                    help="output path base (writes base.sz/.ky/.lb)")
    ec.add_argument("--htsize", type=int, default=None,
                    help="CLARK hash table size [1610612741; light "
                         "preset 57777779]")
    ec.add_argument("--light", action="store_true",
                    help="use the cuCLARK-l HTSIZE")
    ec.set_defaults(fn=cmd_export_clark)

    eh = sub.add_parser("export-ht",
                        help="dump per-target .ht text sets (--tsk "
                             "interop)")
    eh.add_argument("-D", "--db-dir", required=True)
    eh.add_argument("-o", "--output", required=True,
                    help="output directory for <label>_k<k>.ht files")
    eh.add_argument("--light", action="store_true",
                    help="use the _light filename suffix")
    eh.set_defaults(fn=cmd_export_ht)

    ih = sub.add_parser("import-ht",
                        help="build database from a directory of .ht "
                             "target-specific sets")
    ih.add_argument("-i", "--input", required=True,
                    help="directory holding <label>_k<k>.ht files")
    ih.add_argument("-D", "--db-dir", required=True)
    _add_db_args(ih)
    ih.set_defaults(fn=cmd_import_ht)

    ic = sub.add_parser("import-clark",
                        help="build database from CLARK .sz/.ky/.lb")
    ic.add_argument("-i", "--input", required=True,
                    help="input path base (reads base.sz/.ky/.lb)")
    ic.add_argument("-T", "--targets", required=True,
                    help="targets definition naming the label indices")
    ic.add_argument("-D", "--db-dir", required=True)
    _add_db_args(ic)
    ic.set_defaults(fn=cmd_import_clark)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
