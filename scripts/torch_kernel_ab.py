#!/usr/bin/env python3
"""Old against new: two builds of the port's CUDA kernels timed in turns.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_kernel_ab.py --old DIR [DIR ...]

Each DIR holds an earlier `query.cu` and `score.cu` of
`cuclark_tpu_torch/csrc` (for example the parent commit's, from `git show
HEAD~1:<path>`).  Every set is built with `cuclark_tpu_torch.kernels`'
nvcc flags, an old one into `build/kernel_ab/<DIR name>/`, the new one by
`kernels.load()`, and called through its C entries on the same tensors.
The shapes are the main path's, from chip_smoke.py's headline tables (qs,
q4 and s2 of the same 64M 31-mers) and reads:

  - query_qs, query_q4, query_s2: the resident query of a [65,536, 152]
    wire batch of 150 bp reads;
  - query_part_qs, query_part_q4, query_part_s2: a pass over the table
    in 4 bucket-range parts (s2: 8, as chip_smoke.py streams them; the qs
    stash split over the parts, the labels accumulated), per part call;
    query_part_qs_2, query_part_qs_8: the same in 2 and 8 parts, which
    are also the ranges of a qs table's db shards on a mesh of 2 and 4;
    query_shard_{q4,s2}_{2,4}: a pass over the db shards of a mesh of 2
    and 4;
  - classify_step: the codes front half on the same reads as unpacked
    codes, then the score kernel;
  - query_q4_miss, query_s2_miss: the resident q4 and s2 query of
    65,536 random 150 bp reads, none of whose windows hits (each takes
    both hash choices);
  - step_packed, step_packed_q4, step_packed_s2: the device step of
    `pipeline.classify_step_packed` without labels on the qs, q4 and s2
    tables: a build with the fused query and score of that layout for
    the batch's width launches it alone (`cuclark_query_score_range` over
    the whole table; in an older build `cuclark_query_score` for qs and
    `cuclark_query_score_layout` for q4 and s2), a build without it the
    wire query then the score kernel;
  - step_packed_miss: the qs step on 16,384 random 150 bp reads, none of
    whose windows hits: bench_torch.py's headline chunk (its reads take
    the miss path) on a table of its geometry (64M k-mers, 2^25 main and
    2^20 stash rows);
  - step_packed_wide, step_packed_miss_wide: the same reads and the
    150 bp batch on the headline k-mers in a qs table one main bit wider
    (0.95 keys a main row, a small stash: the geometry the build widens
    large tables to, bench_torch.py's scale4g);
  - query_290_qs, query_290_q4, query_290_s2, step_packed_290,
    step_packed_290_q4, step_packed_290_s2: the same at the paired shape,
    65,536 joined 2 x 150 bp pairs from 400 bp fragments in the 320 bin
    (P = 290, three tiles a read); step_packed_290_many: pairs of 8
    pieces of 32 bases from random genomes (8 labels a pair: the busiest
    distinct-label table), step_packed_290_miss[_q4|_s2]: random pairs
    that miss every table; step_packed_160[_q4|_s2] to
    step_packed_1024[_q4|_s2]: steps of single-end reads one base
    shorter than the bins 160, 192, 256, 320, 512 and 1024 (P = 130 to
    994).  A build's fused entry takes the widths its source allows
    (kMaxTiles tiles of 128 windows, one tile before it); wider rows
    take the query then the score;
  - score_122, score_290: the score kernel on the labels of the 150 bp
    reads and of 65,536 joined 301 bp pairs (bin 320); score_122_many on
    [65,536, 122] random labels over 1..65,535 with 30% misses (rows of
    many distinct labels: the warp path's sort);
  - score_long: the labels of 256 reads of 33-100 kb, [256, 98,402];
  - query_score_part_{qs,q4,s2}: a streamed batch's fused last launch
    (the last part of STREAM_PARTS, the qs stash split over the parts,
    acc_in the earlier parts' label sum) of the 150 bp batch; a build
    with `cuclark_query_score_queue` takes it wherever the range query
    queues the range (`kernels.range_windows` > 1, whatever the
    package's route holds), an older one `cuclark_query_score_range`; query_score_part_290_{layout}: the same
    at the paired shape; query_score_shard_{q4,s2}_2: a mesh block's
    shard-0 launch of 2 db shards, acc_in shard 1's labels
    (query_score_shard_290_{q4,s2}_2: of the paired batch);
    query_score_part_{160,512,1024}_{layout}: the same on the single-end
    reads of those bins (two, four and eight tiles);
    query_score_part_two_{layout}: the yardstick of two launches, the
    range query of the last part into a copy of acc_in, then the score.
    Each with its bound (its rows in range, the wire and acc_in read
    once, [R, 5] written), the gather-only ceiling of the rows it
    gathers (`torch_measure.range_rows`, `range_ceiling_ms`) and, but
    for the yardstick, its plain version's time on the same call.

`--groups LAYOUT ...` then times a streamed group of each layout's table
(`chip_smoke.stream_group_breakdown`: `stream_group_eff` of the 150 bp
batch through a streaming Classifier's `_stream_group_dev`, its part
calls' device time by CUDA events) with the new build and each old one
in turns (old, new, new, old, 3 times): an old build is
loaded in place of the package's library with the queued fused route
off (`kernels.QUEUE_SCORE_TILES` empty), the route of its sources.

`--pair A B` times cases A and B of the new build against each other in
turns (A, B, B, A).  `nvcc -Xptxas -v` prints each build's kernels'
registers and shared memory first.

Each case runs old, new, new, old for each old build, `--turns` times
(12 timings of each old build at the default 6), a timing being the mean
of CUDA events over `--reps` launches after a warm-up; every build's
outputs must equal the new one's.  Each case's least time (device-memory
bytes at 3.35 TB/s, `torch_measure.query_bytes`) stands beside
its medians.  Prints a line per
case, the card's name and power limit, and one JSON object last, also
written to `--out`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


_vp, _i32, _i64, _u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint32)
# The fused query and score's entries of earlier builds, which the
# package's one entry (cuclark_query_score_range) replaced.
OLD_ENTRIES = {
    "cuclark_query_score": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32,
                            _i32, _i32, _i32, _u32, _u32, _u32, _vp],
    "cuclark_query_score_layout": [_i32, _vp, _vp, _vp, _vp, _i64, _i32,
                                   _i32, _i32, _i32, _i32, _u32, _u32, _u32,
                                   _i32, _i32, _vp],
}


def fused_max(query_cu: str) -> int:
    """The widest row (windows) a build's fused query and score takes: its
    kMaxTiles tiles of 128 windows, or one tile in a source without
    kMaxTiles."""
    m = re.search(r"constexpr int kMaxTiles = (\d+);", query_cu)
    return 128 * (int(m.group(1)) if m else 1)


# The entries that take a table's `sampled` flag before the stream.
SAMPLED_ENTRIES = ("cuclark_query", "cuclark_query_score_range")


def takes_sampled(query_cu: str) -> bool:
    """Whether a build's query and fused entries take the `sampled` flag
    (sources before it end their arguments with num_choices, stream)."""
    return "int num_choices, int sampled" in query_cu


def build_old(src: Path) -> tuple[ctypes.CDLL, bool, int, bool]:
    """Build DIR's query.cu and score.cu into build/kernel_ab/ and bind
    the C entries it has, the package's and those of OLD_ENTRIES (before
    the fused query and score, none of them).  Returns the library,
    whether its score_long entry takes a scratch buffer (the sorting
    design did), the widest row of its fused entry and whether its
    entries take the `sampled` flag."""
    from cuclark_tpu_torch import kernels

    path = ROOT / "build" / "kernel_ab" / src.resolve().name / "libold.so"
    kernels.compile_library(src, path)
    lib = ctypes.CDLL(str(path))
    kernels.bind(lib, [n for n in kernels.ENTRIES if hasattr(lib, n)])
    query_cu = (src / "query.cu").read_text()
    sampled = takes_sampled(query_cu)
    if not sampled:
        for name in SAMPLED_ENTRIES:
            if hasattr(lib, name):
                types = kernels.ENTRIES[name]
                getattr(lib, name).argtypes = types[:-2] + types[-1:]
    for name, argtypes in OLD_ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _i32, argtypes
    scratch = "void* scratch" in (src / "score.cu").read_text()
    if scratch:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.cuclark_score_long.argtypes = [vp, vp, vp, i64, i32, i32, vp]
    return lib, scratch, fused_max(query_cu), sampled


class Kernels:
    """The C entries of one build, called on torch tensors on the card."""

    def __init__(self, lib, score_scratch: bool, fused_windows: int,
                 sampled_arg: bool = True):
        self.lib, self.score_scratch = lib, score_scratch
        self.fused_windows = fused_windows
        self.sampled_arg = sampled_arg

    def _sampled(self, spec) -> tuple:
        """The `sampled` argument where the build takes it."""
        return (int(spec.sampled),) if self.sampled_arg else ()

    def query(self, x, vb, main, stash, out, *, spec, k, bucket_start=0,
              stash_start=0, accumulate=False):
        """x: packed2 [R, L/4] with vb [R, L/8], or codes [R, L] with vb
        None; out int32 [R, P]."""
        import torch

        from cuclark_tpu_torch import kernels
        from cuclark_tpu_torch.hashdb import feistel_seed_consts

        R, s2 = x.shape
        s8 = 0 if vb is None else vb.shape[1]
        P = out.shape[1]
        c1, c2, c3 = feistel_seed_consts(spec.seed)
        lay = kernels._LAYOUT_CODE[spec.layout]
        st = torch.cuda.current_stream().cuda_stream
        common = (main.data_ptr(), None if stash is None else
                  stash.data_ptr(), out.data_ptr(), R, P, s2, s8, k,
                  spec.nb_bits, spec.stash_bits, bucket_start, main.shape[0],
                  stash_start, 0 if stash is None else stash.shape[0],
                  int(accumulate), c1, c2, c3, spec.slots, spec.num_choices)
        # a build with the range kernel takes it as kernels._launch_query
        # does: wire batches over a range of at most half the table
        W = (kernels.range_windows(spec.nb_bits, main.shape[0],
                                   spec.layout)
             if vb is not None and hasattr(self.lib, "cuclark_query_range")
             else 1)
        if W == 1:
            err = self.lib.cuclark_query(
                lay, int(vb is None), x.data_ptr(),
                None if vb is None else vb.data_ptr(), *common,
                *self._sampled(spec), st)
        else:
            g = kernels.range_geometry(R, P, W)
            for base, gy in g.launches:
                err = self.lib.cuclark_query_range(
                    lay, x.data_ptr(), vb.data_ptr(), *common, W,
                    g.reads_per_block, g.tiles_per_block, g.grid_x, gy, base,
                    st)
                if err:
                    break
        if err:
            raise RuntimeError(f"query launch failed: CUDA error {err}")
        return out

    def step_packed(self, p2, vb, main, stash, labels, out, *, spec, k):
        """The device step without labels: the fused query and score where
        the build has it for the table's layout and the batch's width,
        else the query into `labels` then the score."""
        import torch

        from cuclark_tpu_torch import kernels
        from cuclark_tpu_torch.hashdb import feistel_seed_consts

        R, s2 = p2.shape
        P, s8 = 4 * s2 - k + 1, vb.shape[1]
        consts = feistel_seed_consts(spec.seed)
        st = torch.cuda.current_stream().cuda_stream
        lay = kernels._LAYOUT_CODE[spec.layout]
        if P > self.fused_windows:
            self.query(p2, vb, main, stash, labels, spec=spec, k=k)
            return self.score(labels, out)
        if hasattr(self.lib, "cuclark_query_score_range"):
            err = self.lib.cuclark_query_score_range(
                lay, p2.data_ptr(), vb.data_ptr(), main.data_ptr(),
                None if stash is None else stash.data_ptr(), None,
                out.data_ptr(), R, P, s2, s8, k, spec.nb_bits,
                spec.stash_bits, 0, main.shape[0], 0,
                0 if stash is None else stash.shape[0], *consts, spec.slots,
                spec.num_choices, *self._sampled(spec), st)
        elif spec.layout == "qs" and hasattr(self.lib, "cuclark_query_score"):
            err = self.lib.cuclark_query_score(
                p2.data_ptr(), vb.data_ptr(), main.data_ptr(),
                stash.data_ptr(), out.data_ptr(), R, P, s2, s8, k,
                spec.nb_bits, spec.stash_bits, *consts, st)
        elif spec.layout != "qs" and hasattr(self.lib,
                                             "cuclark_query_score_layout"):
            err = self.lib.cuclark_query_score_layout(
                lay, p2.data_ptr(), vb.data_ptr(), main.data_ptr(),
                out.data_ptr(), R, P, s2, s8, k, spec.nb_bits, *consts,
                spec.slots, spec.num_choices, st)
        else:
            self.query(p2, vb, main, stash, labels, spec=spec, k=k)
            return self.score(labels, out)
        if err:
            raise RuntimeError(f"query_score launch failed: CUDA error {err}")
        return out

    def query_score_part(self, p2, vb, main, stash, acc_in, out, *, spec,
                         k, bucket_start, stash_start=0):
        """The fused range launch with acc_in added before the score: the
        queued one where the build has it and the range query queues the
        range (`kernels.range_windows` > 1), whatever the package's route
        (`kernels.QUEUE_SCORE_TILES`) holds, so that the A/B decides the
        route; else `cuclark_query_score_range`."""
        import torch

        from cuclark_tpu_torch import kernels
        from cuclark_tpu_torch.hashdb import feistel_seed_consts

        R, s2 = p2.shape
        P, s8 = 4 * s2 - k + 1, vb.shape[1]
        st = torch.cuda.current_stream().cuda_stream
        args = (kernels._LAYOUT_CODE[spec.layout], p2.data_ptr(),
                vb.data_ptr(), main.data_ptr(),
                None if stash is None else stash.data_ptr(),
                acc_in.data_ptr(), out.data_ptr(), R, P, s2, s8, k,
                spec.nb_bits, spec.stash_bits, bucket_start, main.shape[0],
                stash_start, 0 if stash is None else stash.shape[0],
                *feistel_seed_consts(spec.seed), spec.slots,
                spec.num_choices)
        W = (kernels.range_windows(spec.nb_bits, main.shape[0], spec.layout)
             if hasattr(self.lib, "cuclark_query_score_queue") else 1)
        if W > 1:
            err = self.lib.cuclark_query_score_queue(
                *args, W, kernels.queue_geometry(R, P, W).grid_x, st)
        else:
            err = self.lib.cuclark_query_score_range(
                *args, *self._sampled(spec), st)
        if err:
            raise RuntimeError(f"query_score_part launch failed: CUDA error "
                               f"{err}")
        return out

    def score(self, labels, out, scratch=None):
        import torch

        R, P = labels.shape
        st = torch.cuda.current_stream().cuda_stream
        if P <= 32768:
            err = self.lib.cuclark_score(labels.data_ptr(), out.data_ptr(),
                                         R, P, st)
        elif self.score_scratch:
            err = self.lib.cuclark_score_long(
                labels.data_ptr(), out.data_ptr(), scratch.data_ptr(), R, P,
                scratch.shape[1], st)
        else:
            err = self.lib.cuclark_score_long(labels.data_ptr(),
                                              out.data_ptr(), R, P, st)
        if err:
            raise RuntimeError(f"score launch failed: CUDA error {err}")
        return out


def ptxas_report(src: Path) -> dict:
    """Registers and static shared memory of each kernel of src/query.cu
    and src/score.cu, from nvcc -Xptxas -v with the package's flags:
    {kernel (demangled by c++filt where it exists): (registers, smem
    bytes)}."""
    import shutil

    from cuclark_tpu_torch import kernels

    flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="ptxas_") as td:
        for name in kernels.SOURCES:
            proc = subprocess.run(
                [kernels._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o",
                 str(Path(td) / "k.o"), str(src / name)],
                capture_output=True, text=True, check=True)
            entry = None
            for line in proc.stderr.splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    entry = m.group(1)
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                              line)
                if m and entry:
                    out[entry] = (int(m.group(1)), int(m.group(2)))
                    entry = None
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(out),
                               capture_output=True, text=True).stdout
        out = dict(zip((n.replace("(anonymous namespace)::", "")
                        .removeprefix("void ").split("(")[0]
                        for n in names.splitlines()), out.values()))
    return out


def timed(fn, reps: int) -> float:
    """Mean ms per call over reps calls, after one warm-up call."""
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


# single-end bins of the wide step cases (reads one base shorter)
WIDE_BINS = (160, 192, 256, 320, 512, 1024)
# the bins of the wide fused last-part cases: two, four and eight tiles
LAST_BINS = (160, 512, 1024)
# rounds of (old, new, new, old) streamed groups a layout of --groups
GROUP_TURNS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, nargs="*", default=[],
                    help="directories of earlier query.cu and score.cu")
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="time only these cases (default: all)")
    ap.add_argument("--unchecked", type=Path, nargs="*", default=[],
                    help="old dirs timed without comparing their outputs: "
                         "timing-only copies of a kernel with a stage cut "
                         "out, which no path runs")
    ap.add_argument("--pair", nargs=2, action="append", default=[],
                    metavar=("A", "B"),
                    help="also time cases A and B of the new build in "
                         "turns (A, B, B, A), 2 x --turns timings each")
    ap.add_argument("--groups", nargs="*", default=[],
                    choices=("qs", "q4", "s2"),
                    help="also time a streamed group of these layouts' "
                         "tables, the new build against each old one")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_ab.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch_gather_ceiling
    import torch_measure as tm
    from cuclark_tpu_torch import codec, kernels, probe
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.hashdb import build_table, table_to_device

    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    new = Kernels(kernels.load(), False, kernels.QUERY_SCORE_MAX_WINDOWS)
    olds = {d.resolve().name: Kernels(*build_old(d))
            for d in [*args.old, *args.unchecked]}
    unchecked = {d.resolve().name for d in args.unchecked}
    print(f"built {len(olds) + 1} sets in {time.time() - t0:.1f} s",
          flush=True)
    ptxas = {"new": ptxas_report(kernels._CSRC)}
    ptxas.update((d.resolve().name, ptxas_report(d))
                 for d in [*args.old, *args.unchecked])
    for which, rep in ptxas.items():
        for name, (regs, smem) in rep.items():
            print(f"ptxas {which}: {name}: {regs} registers, {smem} bytes "
                  f"smem", flush=True)

    t0 = time.time()
    genomes, dbs = cs.build_headline_db(args.genomes, None)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as td:
        codes, _ = cs.write_reads(genomes, args.reads, Path(td) / "r.fq")
        long_codes = cs.write_long_reads(genomes, Path(td) / "l.fq")
    pairs = cs.joined_pairs(genomes, args.reads)
    wide = {"290": pairs, "290_many": cs.chimeric_pairs(genomes,
                                                         args.reads)}
    wide.update((str(b), cs.bin_reads(genomes, args.reads, b))
                for b in WIDE_BINS)
    del genomes
    print(f"tables and reads in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    k, R = cs.K, args.reads
    padded = np.full((R, 152), codec.INVALID, np.uint8)
    padded[:, :cs.READ_LEN] = codes
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(padded))
    codes_t = torch.from_numpy(padded).to(dev)
    mp2, mvb = (torch.from_numpy(a).to(dev) for a in cs.miss_batch(R))
    # the bench's chunk of all-miss reads
    R16 = min(R, 16384)
    m16p2, m16vb = (t[:R16].contiguous() for t in (mp2, mvb))
    P = 152 - k + 1
    L_long = int(np.ceil((max(len(c) for c in long_codes) + 1) / 128) * 128)
    lpad = np.full((len(long_codes), L_long), codec.INVALID, np.uint8)
    for i, c in enumerate(long_codes):
        lpad[i, :len(c)] = c
    lp2, lvb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(lpad))
    pp2, pvb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(pairs))
    # the wide batches: name -> (packed2, vbits, codes on the card)
    wide = {n: (*(torch.from_numpy(a).to(dev) for a in codec.pack_codes(c)),
                torch.from_numpy(c).to(dev)) for n, c in wide.items()}
    wide["290_miss"] = (*(torch.from_numpy(a).to(dev)
                          for a in cs.miss_batch(R, 320)), None)
    del lpad, pairs

    tables = {lay: table_to_device(db, dev) for lay, db in dbs.items()}
    spec = {lay: db.spec for lay, db in dbs.items()}
    qs_main, qs_stash = tables["qs"]
    # the headline k-mers in a qs table one main bit wider
    km_w, lab_w = dbs["qs"].items()
    order = np.argsort(km_w)
    wide_db = build_table(km_w[order], lab_w[order], dbs["qs"].target_names,
                          DBConfig(k=k, target_load=0.85),
                          nb_bits=dbs["qs"].nb_bits + 1)
    del km_w, lab_w, order
    wide_main, wide_stash = table_to_device(wide_db, dev)
    print(f"wide qs table: nb_bits {wide_db.nb_bits}, stash_bits "
          f"{wide_db.stash_bits}", flush=True)

    def labels_of(x, v, L):
        out = torch.empty((x.shape[0], L - k + 1), dtype=torch.int32,
                          device=dev)
        return new.query(x, v, qs_main, qs_stash, out, spec=spec["qs"], k=k)

    lab122 = labels_of(p2, vb, 152)
    lab290 = labels_of(pp2, pvb, 320)
    rng = np.random.default_rng(5)
    many = rng.integers(1, 65536, size=tuple(lab122.shape)).astype(np.int32)
    many[rng.random(many.shape) < 0.3] = 0
    lab_many = torch.from_numpy(many).to(dev)
    del many
    lab_long = labels_of(lp2, lvb, L_long)
    del lp2, lvb
    Pp_long = 1 << (lab_long.shape[1] - 1).bit_length()
    scratch = torch.empty((lab_long.shape[0], Pp_long), dtype=torch.int32,
                          device=dev) if any(
        o.score_scratch for o in olds.values()) else None

    touched = {lay: tm.touched_rows(codes_t, spec[lay], k, tables[lay][0])
               for lay in dbs}
    wire_b, lab_b = p2.numel() + vb.numel(), 4 * R * P
    bound = {f"query_{lay}": tm.bound_ms(tm.query_bytes(
        touched[lay], spec[lay], wire_b, lab_b)) for lay in dbs}
    for lay in ("q4", "s2"):
        bound[f"step_packed_{lay}"] = tm.bound_ms(tm.query_bytes(
            touched[lay], spec[lay], wire_b, 20 * R))
        miss = tm.touched_rows(codec.unpack_codes(mp2, mvb), spec[lay], k,
                               tables[lay][0])
        bound[f"query_{lay}_miss"] = tm.bound_ms(tm.query_bytes(
            miss, spec[lay], wire_b, lab_b))
        del miss
    # the range passes (`chip_smoke.range_calls`: a qs stash split over
    # the ranges): streamed parts of each layout as chip_smoke.py streams
    # them, qs in 2 and 8 parts too, and q4 and s2 db shards at 2 and 4
    passes = {f"query_part_{lay}": (lay, cs.STREAM_PARTS[lay])
              for lay in dbs}
    passes.update({"query_part_qs_2": ("qs", 2),
                   "query_part_qs_8": ("qs", 8)})
    passes.update((f"query_shard_{lay}_{n}", (lay, n))
                  for lay in ("q4", "s2") for n in (2, 4))
    pass_calls = {name: cs.range_calls(*tables[lay], n)
                  for name, (lay, n) in passes.items()}
    # a qs part call reads the stash row of every window it holds one of
    touched_parts = dict(touched, qs=tm.touched_rows(codes_t, spec["qs"], k))
    for name, (lay, n) in passes.items():
        hits = cs.later_hits(p2, vb, pass_calls[name], k, spec[lay])
        bound[name] = tm.bound_ms(tm.query_bytes(
            touched_parts[lay], spec[lay], wire_b, lab_b, n, hits))
    # the wide batches' touched rows: the pairs on every table, the rest
    # on qs's; an all-miss batch reads each window's rows as a miss does
    for n, (x, v, c) in wide.items():
        lays = ("qs",) if n == "290_many" else dbs
        cw = c if c is not None else codec.unpack_codes(x, v)
        P_w = 4 * x.shape[1] - k + 1
        for lay in lays:
            t = tm.touched_rows(cw, spec[lay], k, tables[lay][0])
            suffix = "" if lay == "qs" else f"_{lay}"
            if n == "290":
                bound[f"query_290_{lay}"] = tm.bound_ms(tm.query_bytes(
                    t, spec[lay], x.numel() + v.numel(), 4 * R * P_w))
            bound[f"step_packed_{n}{suffix}"] = tm.bound_ms(
                tm.query_bytes(t, spec[lay], x.numel() + v.numel(), 20 * R))
            del t
        del cw
    bound["classify_step"] = tm.bound_ms(tm.query_bytes(
        touched["qs"], spec["qs"], R * 152, 20 * R))
    bound["step_packed"] = tm.bound_ms(tm.query_bytes(
        touched["qs"], spec["qs"], wire_b, 20 * R))
    for suffix, (main_, sp_) in (("", (qs_main, spec["qs"])),
                                 ("_wide", (wide_main, wide_db.spec))):
        bound[f"step_packed_miss{suffix}"] = tm.bound_ms(tm.query_bytes(
            tm.touched_rows(codec.unpack_codes(m16p2, m16vb), sp_, k, main_),
            sp_, m16p2.numel() + m16vb.numel(), 20 * R16))
    bound["step_packed_wide"] = tm.bound_ms(tm.query_bytes(
        tm.touched_rows(codes_t, wide_db.spec, k, wide_main), wide_db.spec,
        wire_b, 20 * R))
    for name, lab in (("score_122", lab122), ("score_290", lab290),
                      ("score_122_many", lab_many),
                      ("score_long", lab_long)):
        bound[name] = tm.bound_ms(4 * lab.numel() + 20 * lab.shape[0])
    del touched, touched_parts

    # the fused last launches: name -> (layout, wire, its range call,
    # acc_in: the label sum of the pass's other calls), each with its
    # bound and the ceiling of the rows it gathers
    ceiling_lib = torch_gather_ceiling.build()
    ceiling = {}
    last = {}
    pair_codes = codec.unpack_codes(pp2, pvb)
    for lay in dbs:
        for tag, (x, v, c) in (("", (p2, vb, codes_t)),
                               ("_290", (pp2, pvb, pair_codes))):
            calls = cs.range_calls(*tables[lay], cs.STREAM_PARTS[lay])
            last[f"query_score_part{tag}_{lay}"] = (lay, x, v, c, calls[-1],
                                                    calls[:-1])
        for b in LAST_BINS:
            x, v, c = wide[str(b)]
            last[f"query_score_part_{b}_{lay}"] = (lay, x, v, c, calls[-1],
                                                   calls[:-1])
    for lay in ("q4", "s2"):
        calls = cs.range_calls(*tables[lay], 2)
        last[f"query_score_shard_{lay}_2"] = (lay, p2, vb, codes_t, calls[0],
                                              calls[1:])
        last[f"query_score_shard_290_{lay}_2"] = (lay, pp2, pvb, pair_codes,
                                                  calls[0], calls[1:])
    last_acc = {}
    for name, (lay, x, v, c, call, others) in last.items():
        P_l = 4 * x.shape[1] - k + 1
        acc_l = torch.zeros((x.shape[0], P_l), dtype=torch.int32,
                            device=dev)
        for m, s_, start, sstart in others:
            new.query(x, v, m, s_, acc_l, spec=spec[lay], k=k,
                      bucket_start=start, stash_start=sstart,
                      accumulate=True)
        last_acc[name] = acc_l
        m, s_, start, sstart = call
        gathered = tm.range_rows(c, tables[lay][0], spec[lay], k, start,
                                 m.shape[0], sstart,
                                 0 if s_ is None else s_.shape[0])
        uniq = (torch.unique(gathered[0]), None if gathered[1] is None
                else torch.unique(gathered[1]))
        bound[name] = tm.bound_ms(tm.query_bytes(
            uniq, spec[lay], x.numel() + v.numel() + 4 * acc_l.numel(),
            20 * x.shape[0]))
        ceiling[name] = tm.range_ceiling_ms(ceiling_lib, tables[lay][0],
                                            tables[lay][1], gathered,
                                            spec[lay])
        if name.count("_") == 3 and name.startswith("query_score_part"):
            two = name.replace("query_score_part", "query_score_part_two")
            bound[two], ceiling[two] = bound[name], ceiling[name]
        del gathered, uniq
    del pair_codes
    for name in ("query_score_part_two_qs", "query_score_part_two_q4",
                 "query_score_part_two_s2"):
        lay = name.rsplit("_", 1)[1]
        last[name] = last[f"query_score_part_{lay}"]
        last_acc[name] = last_acc[f"query_score_part_{lay}"]

    def make_cases(kern: Kernels):
        """name -> (callable, launches per call, output tensor)."""
        out = torch.empty((R, P), dtype=torch.int32, device=dev)
        res = {n: torch.empty((lab.shape[0], 5), dtype=torch.int32,
                              device=dev)
               for n, lab in (("122", lab122), ("290", lab290),
                              ("122_many", lab_many), ("long", lab_long))}
        cases = {}
        for lay in dbs:
            main, stash = tables[lay]
            cases[f"query_{lay}"] = (
                lambda main=main, stash=stash, lay=lay: kern.query(
                    p2, vb, main, stash, out, spec=spec[lay], k=k), 1, out)
        for lay in ("q4", "s2"):
            main, _ = tables[lay]
            cases[f"query_{lay}_miss"] = (
                lambda main=main, lay=lay: kern.query(
                    mp2, mvb, main, None, out, spec=spec[lay], k=k), 1, out)
        acc = torch.empty((R, P), dtype=torch.int32, device=dev)

        def range_pass(name):
            lay = passes[name][0]
            for i, (m, s, start, sstart) in enumerate(pass_calls[name]):
                kern.query(p2, vb, m, s, acc, spec=spec[lay], k=k,
                           bucket_start=start, stash_start=sstart,
                           accumulate=i > 0)
            return acc
        for name in passes:
            cases[name] = (lambda name=name: range_pass(name),
                           len(pass_calls[name]), acc)
        step_out = torch.empty((R, 5), dtype=torch.int32, device=dev)
        codes_lab = torch.empty((R, P), dtype=torch.int32, device=dev)

        def classify_step():
            kern.query(codes_t, None, qs_main, qs_stash, codes_lab,
                       spec=spec["qs"], k=k)
            return kern.score(codes_lab, step_out)
        cases["classify_step"] = (classify_step, 1, step_out)
        packed_out = torch.empty((R, 5), dtype=torch.int32, device=dev)
        wire_lab = torch.empty((R, P), dtype=torch.int32, device=dev)

        def step_packed():
            return kern.step_packed(p2, vb, qs_main, qs_stash, wire_lab,
                                    packed_out, spec=spec["qs"], k=k)
        cases["step_packed"] = (step_packed, 1, packed_out)
        miss_lab = torch.empty((R16, P), dtype=torch.int32, device=dev)
        miss_out = torch.empty((R16, 5), dtype=torch.int32, device=dev)
        cases["step_packed_miss"] = (
            lambda: kern.step_packed(m16p2, m16vb, qs_main, qs_stash,
                                     miss_lab, miss_out, spec=spec["qs"],
                                     k=k), 1, miss_out)
        cases["step_packed_miss_wide"] = (
            lambda: kern.step_packed(m16p2, m16vb, wide_main, wide_stash,
                                     miss_lab, miss_out, spec=wide_db.spec,
                                     k=k), 1, miss_out)
        wide_out = torch.empty((R, 5), dtype=torch.int32, device=dev)
        cases["step_packed_wide"] = (
            lambda: kern.step_packed(p2, vb, wide_main, wide_stash, wire_lab,
                                     wide_out, spec=wide_db.spec, k=k), 1,
            wide_out)
        for lay in ("q4", "s2"):
            main, _ = tables[lay]
            cases[f"step_packed_{lay}"] = (
                lambda main=main, lay=lay: kern.step_packed(
                    p2, vb, main, None, wire_lab, packed_out, spec=spec[lay],
                    k=k), 1, packed_out)
        for n, (x, v, _) in wide.items():
            P_w = 4 * x.shape[1] - k + 1
            w_lab = torch.empty((R, P_w), dtype=torch.int32, device=dev)
            w_out = torch.empty((R, 5), dtype=torch.int32, device=dev)
            for lay in (("qs",) if n == "290_many" else dbs):
                main, stash = tables[lay]
                suffix = "" if lay == "qs" else f"_{lay}"
                if n == "290":
                    cases[f"query_290_{lay}"] = (
                        lambda x=x, v=v, main=main, stash=stash, lay=lay,
                        o=w_lab: kern.query(x, v, main, stash, o,
                                            spec=spec[lay], k=k), 1, w_lab)
                cases[f"step_packed_{n}{suffix}"] = (
                    lambda x=x, v=v, main=main, stash=stash, lay=lay,
                    lab=w_lab, o=w_out: kern.step_packed(
                        x, v, main, stash, lab, o, spec=spec[lay], k=k), 1,
                    w_out)
        for n, lab in (("122", lab122), ("290", lab290),
                       ("122_many", lab_many), ("long", lab_long)):
            cases[f"score_{n}"] = (
                lambda lab=lab, o=res[n]: kern.score(lab, o, scratch), 1,
                res[n])
        for name, (lay, x, v, _, (m, s_, start, sstart), _o) in last.items():
            o = torch.empty((x.shape[0], 5), dtype=torch.int32, device=dev)
            acc_l = last_acc[name]
            if name.startswith("query_score_part_two"):
                lab_l = torch.empty_like(acc_l)

                def two(x=x, v=v, m=m, s_=s_, start=start, sstart=sstart,
                        lay=lay, acc_l=acc_l, lab_l=lab_l, o=o):
                    lab_l.copy_(acc_l)
                    kern.query(x, v, m, s_, lab_l, spec=spec[lay], k=k,
                               bucket_start=start, stash_start=sstart,
                               accumulate=True)
                    return kern.score(lab_l, o)
                cases[name] = (two, 1, o)
            else:
                cases[name] = (
                    lambda x=x, v=v, m=m, s_=s_, start=start, sstart=sstart,
                    lay=lay, acc_l=acc_l, o=o: kern.query_score_part(
                        x, v, m, s_, acc_l, o, spec=spec[lay], k=k,
                        bucket_start=start, stash_start=sstart), 1, o)
        return cases

    builds = {"new": make_cases(new)}
    builds.update((name, make_cases(o)) for name, o in olds.items())
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "reads": R, "turns": args.turns,
              "reps": args.reps, "cases": {}}
    for name in args.cases or builds["new"]:
        outs = {}
        for which, cases in builds.items():
            fn, _, out = cases[name]
            fn()
            torch.cuda.synchronize()
            outs[which] = out.clone()
            if which not in unchecked and not torch.equal(outs[which],
                                                          outs["new"]):
                raise AssertionError(f"{name}: {which} and new outputs "
                                     f"differ")
        # per old build: its timings and the new build's beside them
        pair = {o: {"old": [], "new": []} for o in olds}
        reps = max(2, args.reps // 4) if name == "score_long" else args.reps
        for _ in range(args.turns):
            for o in olds:
                for which in ("old", "new", "new", "old"):
                    fn, per_call, _ = builds[o if which == "old" else
                                              "new"][name]
                    pair[o][which].append(timed(fn, reps) / per_call)
        new_ms = [t for o in olds for t in pair[o]["new"]]
        new_med = statistics.median(new_ms)
        case = {"bound_ms": bound[name], "new_ms": new_ms,
                "new_median_ms": new_med,
                "share_of_bound_new": bound[name] / new_med}
        line = [f"{name}: new {new_med:.4f} ms"]
        if name in ceiling:
            case["ceiling_ms"] = ceiling[name]
            case["share_of_ceiling_new"] = ceiling[name] / new_med
            line.append(f"ceiling {ceiling[name]:.4f} ms "
                        f"({ceiling[name] / new_med:.1%})")
        if name in last and not name.startswith("query_score_part_two"):
            # the fused range entry's plain version on the same call
            lay, x, v, _, (m, s_, start, sstart), _o = last[name]
            case["plain_ms"] = tm.cuda_ms(
                lambda: probe.query_score_part_results_plain(
                    x, v, m, s_, bucket_start=start, nb_local=m.shape[0],
                    k=k, spec=spec[lay], stash_start=sstart,
                    acc_in=last_acc[name]), 2)
            line.append(f"plain {case['plain_ms']:.4f} ms")
        for o in olds:
            t_old, t_new = pair[o]["old"], pair[o]["new"]
            wins = sum(n < t for n, t in zip(t_new, t_old))
            case[o] = {"ms": t_old, "median_ms": statistics.median(t_old),
                       "new_ms": t_new,
                       "new_median_ms": statistics.median(t_new),
                       "new_faster_in": wins}
            line.append(f"{o} {case[o]['median_ms']:.4f} (new "
                        f"{case[o]['new_median_ms']:.4f} beside it, faster "
                        f"in {wins} of {len(t_old)})")
        result["cases"][name] = case
        print(", ".join(line) + f"; bound {bound[name]:.4f} ms, new at "
              f"{bound[name] / new_med:.1%} of it", flush=True)
    result["ptxas"] = ptxas
    result["pairs"] = {}
    for a, b in args.pair:
        times = {a: [], b: []}
        for _ in range(args.turns):
            for name in (a, b, b, a):
                fn, per_call, _ = builds["new"][name]
                times[name].append(timed(fn, args.reps) / per_call)
        wins = sum(tb < ta for ta, tb in zip(times[a], times[b]))
        med = {n: statistics.median(t) for n, t in times.items()}
        result["pairs"][f"{a} vs {b}"] = {
            "ms": times, "median_ms": med, "b_faster_in": wins}
        print(f"pair {a} {med[a]:.4f} ms vs {b} {med[b]:.4f} ms (new build, "
              f"in turns): {b} faster in {wins} of {len(times[a])}",
              flush=True)
    if args.groups:
        result["groups"] = time_groups(args, dbs, (p2, vb), olds, unchecked,
                                       dev)
    for name, c in result["cases"].items():
        if not name.startswith(("classify_step", "step_packed")):
            continue
        n = R16 if name.startswith("step_packed_miss") else R
        c["new_reads_per_s"] = n / (c["new_median_ms"] / 1e3)
        for o in olds:
            c[o]["reads_per_s"] = n / (c[o]["median_ms"] / 1e3)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps({n: {"new_median_ms": c["new_median_ms"],
                          "bound_ms": c["bound_ms"],
                          **{o: c[o]["median_ms"] for o in olds}}
                      for n, c in result["cases"].items()}))
    return 0


def time_groups(args, dbs, wire, olds, unchecked, dev) -> dict:
    """A streamed group of each layout of args.groups
    (`chip_smoke.stream_group_breakdown` on the wire batch, through a
    streaming Classifier of the layout's table in STREAM_PARTS parts)
    with the new build and each checked old build in turns (old, new,
    new, old, GROUP_TURNS times): an old build's library stands in
    for the package's, the queued fused route off.  Prints a line a
    layout and old build -> {layout: {build: [breakdowns]}}."""
    import chip_smoke as cs
    from cuclark_tpu_torch import kernels, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig

    new_lib, new_tiles = kernels.load(), dict(kernels.QUEUE_SCORE_TILES)
    off = {lay: frozenset() for lay in new_tiles}
    out = {}
    try:
        for lay in args.groups:
            db = dbs[lay]
            clf = pipeline.Classifier(db, ClassifyConfig(
                max_table_mb=cs.stream_budget_mb(db)), device=dev)
            if clf.stream_parts != cs.STREAM_PARTS[lay]:
                raise AssertionError(f"{lay}: {clf.stream_parts} parts")
            runs = {"new": []}
            for o in (o for o in olds if o not in unchecked):
                runs[o] = []
                for _ in range(GROUP_TURNS):
                    for which in (o, "new", "new", o):
                        kernels._LIB = (olds[o].lib if which == o
                                        else new_lib)
                        kernels.QUEUE_SCORE_TILES.update(
                            off if which == o else new_tiles)
                        runs[which].append(cs.stream_group_breakdown(
                            clf, [wire]))
                t_old = [g["call_ms"] for g in runs[o]]
                t_new = [g["call_ms"] for g in runs["new"][-len(t_old):]]
                wins = sum(n < t for n, t in zip(t_new, t_old))
                print(f"group {lay}: {runs[o][0]['batches']} batches of "
                      f"{cs.STREAM_PARTS[lay]} parts, part calls new "
                      f"{statistics.median(t_new):.4f} ms "
                      f"({statistics.median(t_new) / runs[o][0]['batches']:.4f}"
                      f" a batch), {o} {statistics.median(t_old):.4f} ms "
                      f"({statistics.median(t_old) / runs[o][0]['batches']:.4f}"
                      f" a batch); new faster in {wins} of {len(t_old)}; "
                      f"wall new {statistics.median(g['wall_ms'] for g in runs['new']):.4f}"
                      f" ms, {o} "
                      f"{statistics.median(g['wall_ms'] for g in runs[o]):.4f}"
                      f" ms", flush=True)
            clf.close()
            del clf
            out[lay] = runs
    finally:
        kernels._LIB = new_lib
        kernels.QUEUE_SCORE_TILES.update(new_tiles)
    return out


if __name__ == "__main__":
    sys.exit(main())
