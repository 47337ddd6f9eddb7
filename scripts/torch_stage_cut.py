#!/usr/bin/env python3
"""The fused query-and-score kernel's time above its gather ceiling, taken
apart by stage on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_stage_cut.py [--out FILE] [--cuts ...] [--shapes ...]
                                       [--src DIR]

`cuclark_tpu_torch/csrc/query.cu` marks the stages of the query kernels
with region comments, `// cut <tag> begin` and `// cut <tag> end`.  A cut
replaces the lines of some regions with other code (`CUTS`, `apply_cut`)
and is written, with the tree's `score.cu` and `warp_score.cuh`, to
`build/stage_cut/<cut>/`, built there with the package's nvcc flags
(`kernels.compile_library`), and called through the same C entry
(`cuclark_query_score_range`, the resident fused step) on the same
tensors as the tree's own build.  A cut copy is for timing only: its
results are not checked, and no path of the package ever loads it.  A
cut whose region is missing from the source raises, so a cut never
silently times the tree's kernel.  cold_stash alone replaces no region:
it times the tree's own build, handed another copy of the stash at each
launch.  `--src DIR` cuts and times DIR's `query.cu` (with the same
regions marked) instead of the tree's: its own build, built like a cut
with no region replaced, stands for the tree.

The cuts:

  no_stash    the qs stash row's load and compare removed (the main row
              still loads with the streaming hint)
  stash_b17,  the stash bucket masked to 17, 18 or 19 bits: the same
  _b18, _b19  access pattern over a footprint 8, 4 or 2 times smaller
              (the labels are wrong)
  cold_stash  the tree's kernel, its stash rows taken from
              COLD_COPIES copies of the stash, a copy a launch in turn,
              so that no copy stays in L2 from one launch to the next
  no_score    the score cut: each warp folds its labels into one
              checksum word of its read's results
  front_only  no gathers either: each window's Feistel halves (s2: its
              two bucket hashes) folded into that checksum
  s2_low_only s2 only: a slot pair's high key words and labels are not
              loaded; a low-word match counts as a hit

The shapes (each also held to the plain version with the tree's build):

  headline    chip_smoke.py's headline qs table (64M 31-mers of 16,384
              random genomes, 2^25 main and 2^20 stash rows) and 65,536
              of its 150 bp reads (1% substitutions), [65,536, 152]
  bench_miss  bench_torch.py's headline: its 64M random k-mers
              (`bench_torch.synth_kmers`, the same geometry) and the
              first chunk of its reads (`bench_torch.bench_reads`),
              [16,384, 152], the miss path
  paired      65,536 joined pairs of the headline genomes, [65,536, 320]
              (three tiles a read)
  s2_headline the headline reads on the s2 table of the same k-mers
              (2 slots, 2 choices)

Each cut runs against the tree's build in turns (cut, tree, tree, cut),
--turns times (12 timings a side at the default 6), a timing being the
mean of CUDA events over --reps launches after one.  Beside each shape:
its bytes bound (`torch_measure.query_bytes`), the gather-only ceiling
of its main rows (qs) or of an exact probe's rows (s2), and for qs the
ceiling of both rows a window (`torch_measure.gather_ceiling_stash_ms`).
Each cut's saving (tree less cut, per pair of medians) stands beside the
shape's gap, the tree's time less its main-row ceiling.  With --sass,
`cuobjdump -sass` of the tree's and each cut's library counts the
instructions of the fused kernel's qs and s2 instances at one and three
tiles (a static count: at one tile the front half runs no loop, so it
is the count a thread issues for its window).  Prints a line a cut and
shape, the card's name, power limit and SM clocks, and one JSON object
last, also written to --out.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "cuclark_tpu_torch" / "csrc"
OUT_DIR = ROOT / "build" / "stage_cut"

# Copies of the stash that cold_stash's launches rotate over: 8 x 33.6 MB
# of a 2^20-row stash pass through L2 before a copy is read again.
COLD_COPIES = 8

_BEGIN = re.compile(r"^([ \t]*)// cut (\w+) begin$")
_END = re.compile(r"^[ \t]*// cut (\w+) end$")

# no_score's replacement of the score: a warp's labels folded into one
# word of its read's results (atomic, so that no store is elided)
_CHECKSUM = """{
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < kWin; ++i) x ^= static_cast<uint32_t>(lab[i]);
  x = __reduce_xor_sync(kFull, x);
  if ((threadIdx.x & 31) == 0)
    atomicXor(reinterpret_cast<unsigned int*>(results + r * 5), x);
}"""


@dataclass(frozen=True)
class Cut:
    """Region tag -> the code that replaces the region's lines (indented
    as its begin marker; no region: the tree's build); the layouts whose
    fused kernel it changes; the stash copies its launches take in
    turn."""

    what: str
    edits: dict
    layouts: tuple = ("qs",)
    stash_copies: int = 1


CUTS = {
    "no_stash": Cut("no window has a stash row: its loads and compare go",
                    {"gathers": "lab = qs_label<LATE>(rows, b0 - bucket_start, "
                                "in0, rows1, b1 - start1,\n"
                                "                     false, h1, l2, nb_bits, "
                                "bits1, sampled);"}),
    **{f"stash_b{b}": Cut(
        f"the stash bucket masked to {b} bits (footprint "
        f"{32 << b >> 20} MiB)", {"stash_bucket":
                                  f"b1 = h1 & ((1u << {b}) - 1);"})
       for b in (17, 18, 19)},
    "cold_stash": Cut(
        f"the tree's kernel, its stash rows from {COLD_COPIES} copies of "
        f"the stash, a copy a launch", {}, stash_copies=COLD_COPIES),
    "no_score": Cut("the score cut: a checksum of the labels a warp",
                    {"score": _CHECKSUM}, layouts=("qs", "s2")),
    "front_only": Cut(
        "no gathers and no score: the Feistel halves (s2: the bucket "
        "hashes) folded into a checksum a warp",
        {"gathers": "lab = static_cast<int32_t>(h1 ^ l2);",
         "s2_gathers": "lab = static_cast<int32_t>(b1 ^ mix2(hi, lo));",
         "score": _CHECKSUM}, layouts=("qs", "s2")),
    "s2_low_only": Cut(
        "s2: no high key word or label loads; a low-word match counts",
        {"s2_high": "lab += static_cast<int32_t>(m0) + "
                    "static_cast<int32_t>(m1);"}, layouts=("s2",)),
}


def regions(src: str) -> dict:
    """tag -> (first line, end line) of the lines between its markers
    (0-based, end exclusive).  Raises on a marker without its partner or
    a tag marked twice."""
    out, open_ = {}, {}
    for i, line in enumerate(src.splitlines()):
        m = _BEGIN.match(line)
        if m:
            tag = m.group(2)
            if tag in open_ or tag in out:
                raise ValueError(f"region {tag!r} begins twice (line "
                                 f"{i + 1})")
            open_[tag] = i
            continue
        m = _END.match(line)
        if m:
            tag = m.group(1)
            if tag not in open_:
                raise ValueError(f"region {tag!r} ends without a begin "
                                 f"(line {i + 1})")
            out[tag] = (open_.pop(tag) + 1, i)
    if open_:
        raise ValueError(f"regions {sorted(open_)} never end")
    return out


def apply_cut(src: str, cut: Cut) -> str:
    """The source with each of the cut's regions' lines replaced by its
    code, indented as the region's begin marker; the markers stay.
    Raises when a region is missing or two of the cut's regions
    overlap."""
    lines = src.splitlines(keepends=True)
    spans = regions(src)
    missing = [t for t in cut.edits if t not in spans]
    if missing:
        raise ValueError(f"query.cu has no region {missing}: the cut would "
                         f"time the tree's own kernel")
    order = sorted((spans[t], t) for t in cut.edits)
    for ((_, end), a), ((start, _), b) in zip(order, order[1:]):
        if start <= end:
            raise ValueError(f"regions {a!r} and {b!r} overlap")
    for (start, end), tag in reversed(order):
        indent = _BEGIN.match(lines[start - 1].rstrip("\n")).group(1)
        code = [(indent + c).rstrip() + "\n" if c.strip() else "\n"
                for c in cut.edits[tag].splitlines()]
        lines[start:end] = code
    return "".join(lines)


def write_cut(name: str, out_dir: Path = OUT_DIR, src: Path = SRC) -> Path:
    """out_dir/<name>/ with src's query.cu cut (name "tree": as it is)
    and src's other kernel sources."""
    from cuclark_tpu_torch import kernels

    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    text = (src / "query.cu").read_text()
    (d / "query.cu").write_text(text if name == "tree"
                                else apply_cut(text, CUTS[name]))
    for f in kernels.SOURCES + kernels.HEADERS:
        if f != "query.cu":
            shutil.copyfile(src / f, d / f)
    return d


def build_cut(name: str, src: Path = SRC):
    """Write and build cut `name` of src; load it with its C entries
    bound -> (library, whether its fused entry takes the `sampled`
    flag: sources before it end their arguments with num_choices,
    stream)."""
    import ctypes

    from cuclark_tpu_torch import kernels

    d = write_cut(name, src=src)
    path = d / "libcut.so"
    path.unlink(missing_ok=True)
    kernels.compile_library(d, path)
    lib = kernels.bind(ctypes.CDLL(str(path)))
    sampled = "int num_choices, int sampled" in (d / "query.cu").read_text()
    if not sampled:
        types = kernels.ENTRIES["cuclark_query_score_range"]
        lib.cuclark_query_score_range.argtypes = types[:-2] + types[-1:]
    return lib, sampled


@dataclass
class Shape:
    what: str
    layout: str
    p2: object
    vb: object
    main: object
    stash: object
    spec: object
    k: int
    row: dict


def stash_pointers(stash, copies: int):
    """The stash address of each launch in turn: stash [copies * NBS,
    ...] holds `copies` copies of a table's stash, and launch i reads
    copy i % copies (None: no stash)."""
    if stash is None:
        return itertools.repeat(None)
    step = stash.numel() * stash.element_size() // copies
    return (stash.data_ptr() + step * (i % copies) for i in itertools.count())


def fused_call(lib, s: Shape, stash, out, sampled_arg: bool = True,
               copies: int = 1):
    """One launch of lib's fused query and score over the whole table:
    the C entry the package's `kernels.query_score` calls, stash rows
    taken from `stash` (the shape's, or `copies` copies of it, one a
    launch in turn: `stash_pointers`); sampled_arg: the build's entry
    takes the table's `sampled` flag."""
    import torch

    from cuclark_tpu_torch import kernels
    from cuclark_tpu_torch.hashdb import feistel_seed_consts

    R, s2 = s.p2.shape
    P = 4 * s2 - s.k + 1
    consts = feistel_seed_consts(s.spec.seed)
    nbs = 0 if s.stash is None else s.stash.shape[0]
    ptrs = stash_pointers(stash, copies)

    def run():
        err = lib.cuclark_query_score_range(
            kernels._LAYOUT_CODE[s.layout], s.p2.data_ptr(), s.vb.data_ptr(),
            s.main.data_ptr(), next(ptrs),
            None, out.data_ptr(), R, P, s2, s.vb.shape[1], s.k,
            s.spec.nb_bits, s.spec.stash_bits, 0, s.main.shape[0], 0, nbs,
            *consts, s.spec.slots, s.spec.num_choices,
            *((int(s.spec.sampled),) if sampled_arg else ()),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cuclark_query_score_range failed: CUDA "
                               f"error {err}")
    return run


_SASS_FN = re.compile(r"^\s*Function : (\S+)")
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+\S")


def sass_counts(lib_path: Path) -> dict:
    """{fused kernel instance (demangled, e.g. query_score_kernel<0, 1,
    true>): SASS instructions} of the library, by cuobjdump -sass: its
    qs (0) and s2 (2) instances at one and three tiles."""
    from cuclark_tpu_torch import kernels

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = _SASS_FN.match(line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and _SASS_INSN.match(line):
            counts[fn] += 1
    names = subprocess.run(["c++filt"], input="\n".join(counts),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for name, n in zip(names, counts.values()):
        m = re.search(r"query_score_kernel<(\d), (\d)(, (true|false))?>",
                      name)
        if m and m.group(1) in "02" and m.group(2) in "13":
            out[m.group(0)] = n
    return out


def shape_row(s: Shape, ceiling_lib):
    """The package's fused kernel on shape s held to plain, with its
    bound and ceilings (`torch_measure.fused_row`) and its windows' hit
    share -> (row, results)."""
    import torch

    import torch_measure as tm
    from cuclark_tpu_torch import codec, probe

    row, res = tm.fused_row(s.p2, s.vb, s.main, s.stash, k=s.k,
                            spec=s.spec, ceiling_lib=ceiling_lib,
                            plain_reps=1)
    lab = probe.query_labels(s.p2, s.vb, s.main, s.stash, k=s.k,
                             spec=s.spec)
    valid = codec.extract_kmers(codec.unpack_codes(s.p2, s.vb), s.k)[1]
    row["hit_share"] = float((lab > 0).sum()) / max(int(valid.sum()), 1)
    row["shape"] = list(s.p2.shape[:1]) + [4 * s.p2.shape[1]]
    del lab, valid
    torch.cuda.empty_cache()
    return row, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuts", nargs="*", default=list(CUTS),
                    choices=list(CUTS))
    ap.add_argument("--shapes", nargs="*",
                    default=["headline", "bench_miss", "paired",
                             "s2_headline"],
                    choices=["headline", "bench_miss", "paired",
                             "s2_headline"])
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--bench-kmers", type=int, default=64_000_000)
    ap.add_argument("--bench-chunk", type=int, default=16384)
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--src", type=Path, default=SRC,
                    help="directory of the query.cu, score.cu and "
                         "warp_score.cuh to cut (default: the tree's)")
    ap.add_argument("--sass", action="store_true",
                    help="count the fused kernel's SASS instructions")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "stage_cut.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_stage_cut: no CUDA device", file=sys.stderr)
        return 2
    for p in (ROOT, ROOT / "scripts"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import bench_torch
    import chip_smoke as cs
    import torch_gather_ceiling
    import torch_measure as tm
    from cuclark_tpu_torch import codec, kernels
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.hashdb import build_table, table_to_device

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; SM clock, max: {clocks}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    layouts = {"headline": "qs", "bench_miss": "qs", "paired": "qs",
               "s2_headline": "s2"}
    cuts = [c for c in args.cuts
            if any(layouts[s] in CUTS[c].layouts for s in args.shapes)]
    built = [c for c in cuts if CUTS[c].edits]

    def bench_table():
        km, labels, names = bench_torch.synth_kmers(args.bench_kmers, 16384,
                                                    31)
        return build_table(km, labels, names,
                           DBConfig(k=31, target_load=0.85))

    # the builds (nvcc subprocesses) and the bench's draw run beside the
    # headline tables' build
    src = args.src.resolve()
    with ThreadPoolExecutor(len(built) + 3) as pool:
        libs = {c: pool.submit(build_cut, c, src) for c in built}
        ceiling = pool.submit(torch_gather_ceiling.build)
        tree = pool.submit((lambda: (kernels.load(), True))
                           if src == SRC.resolve()
                           else lambda: build_cut("tree", src))
        bench_db = (pool.submit(bench_table)
                    if "bench_miss" in args.shapes else None)
        genomes, dbs = cs.build_headline_db(
            args.genomes, None,
            ("qs", "s2") if "s2_headline" in args.shapes else ("qs",))
        libs = {c: f.result() for c, f in libs.items()}
        ceiling_lib, tree = ceiling.result(), tree.result()
        libs.update((c, tree) for c in cuts if c not in libs)
        bench_db = bench_db.result() if bench_db is not None else None
    print(f"built {len(built)} cuts, the tree and the tables in "
          f"{time.time() - t0:.1f} s", flush=True)
    sass = {}
    if args.sass:
        tree_path = (kernels.library_path() if src == SRC.resolve()
                     else OUT_DIR / "tree" / "libcut.so")
        for which, path in (("tree", tree_path),
                            *((c, OUT_DIR / c / "libcut.so") for c in built)):
            sass[which] = sass_counts(path)
            print(f"sass {which}: " + ", ".join(
                f"{n} {v} instructions" for n, v in sass[which].items()),
                flush=True)

    with tempfile.TemporaryDirectory(prefix="stage_cut_") as td:
        codes, _ = cs.write_reads(genomes, args.reads, Path(td) / "r.fq")
    padded = np.full((len(codes), 152), codec.INVALID, np.uint8)
    padded[:, :cs.READ_LEN] = codes

    def wire(a):
        return tuple(torch.from_numpy(x).to(dev) for x in codec.pack_codes(a))

    tables = {lay: table_to_device(db, dev) for lay, db in dbs.items()}
    shapes = {}
    for name in args.shapes:
        if name == "bench_miss":
            _, bcodes = bench_torch.bench_reads(np.random.default_rng(0),
                                                args.bench_chunk, 150)
            p2, vb = wire(bcodes)
            main, stash = table_to_device(bench_db, dev)
            spec, what = bench_db.spec, (
                f"bench_torch.py's headline chunk, {args.bench_kmers} "
                f"random k-mers")
        else:
            lay = layouts[name]
            p2, vb = wire(cs.joined_pairs(genomes, args.reads)
                          if name == "paired" else padded)
            main, stash = tables[lay]
            spec = dbs[lay].spec
            what = {"headline": "chip_smoke.py's headline reads",
                    "paired": "joined pairs of the headline genomes",
                    "s2_headline": "the headline reads on the s2 table"
                    }[name]
        shapes[name] = Shape(what, layouts[name], p2, vb, main, stash, spec,
                             31, {})
    del genomes, padded, codes
    for name, s in shapes.items():
        s.row, res = shape_row(s, ceiling_lib)
        # the build timed as the tree gives the package's results
        out = torch.empty_like(res)
        fused_call(tree[0], s, s.stash, out, tree[1])()
        torch.cuda.synchronize()
        if not torch.equal(out, res):
            raise AssertionError(f"{name}: the build of {src} differs from "
                                 f"the package's kernel")
        del out, res
        print(f"{name}: {s.what} {s.row['shape']} on {s.layout}; package "
              f"kernel {s.row['ms']:.4f} ms == plain, hit share "
              f"{s.row['hit_share']:.4f}, bound {s.row['bound_ms']:.4f}, "
              f"ceiling {s.row['ceiling_ms']:.4f} (main rows)"
              + (f", {s.row['ceiling_stash_ms']:.4f} (with the stash rows)"
                 if "ceiling_stash_ms" in s.row else ""), flush=True)

    result = {"card": smi, "sm_clocks": clocks, "src": str(src),
              "torch": torch.__version__,
              "cuda": torch.version.cuda, "turns": args.turns,
              "reps": args.reps, "sass": sass,
              "shapes": {n: {"what": s.what, "layout": s.layout, **s.row}
                         for n, s in shapes.items()},
              "cuts": {c: {"what": CUTS[c].what, "layouts":
                           list(CUTS[c].layouts), "shapes": {}}
                       for c in cuts}}
    tree_ms = {n: [] for n in shapes}
    for name, s in shapes.items():
        out = torch.empty((s.p2.shape[0], 5), dtype=torch.int32, device=dev)
        run_tree = fused_call(tree[0], s, s.stash, out, tree[1])
        for c in cuts:
            cut = CUTS[c]
            if s.layout not in cut.layouts:
                continue
            stash = s.stash
            if cut.stash_copies > 1:
                stash = s.stash.repeat(cut.stash_copies, 1)
            run_cut = fused_call(libs[c][0], s, stash, out, libs[c][1],
                                 cut.stash_copies)
            t = {"cut": [], "tree": []}
            for _ in range(args.turns):
                for which in ("cut", "tree", "tree", "cut"):
                    t[which].append(tm.cuda_ms(
                        run_cut if which == "cut" else run_tree, args.reps))
            del stash
            med = {w: statistics.median(v) for w, v in t.items()}
            tree_ms[name] += t["tree"]
            gap = med["tree"] - s.row["ceiling_ms"]
            saving = med["tree"] - med["cut"]
            wins = sum(a < b for a, b in zip(t["cut"], t["tree"]))
            result["cuts"][c]["shapes"][name] = {
                "ms": t["cut"], "tree_ms": t["tree"],
                "median_ms": med["cut"], "tree_median_ms": med["tree"],
                "saving_ms": saving, "gap_ms": gap,
                "share_of_gap": saving / gap if gap > 0 else None,
                "cut_faster_in": wins}
            print(f"{c} on {name}: {med['cut']:.4f} ms against the tree's "
                  f"{med['tree']:.4f} (cut faster in {wins} of "
                  f"{len(t['cut'])}); saves {saving:+.4f} ms of a "
                  f"{gap:.4f} ms gap above the main-row ceiling"
                  + (f" ({saving / gap:.1%})" if gap > 0 else ""),
                  flush=True)
        del out
    for name, ts in tree_ms.items():
        if ts:
            result["shapes"][name]["tree_median_ms"] = statistics.median(ts)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi, clocks)
    print(json.dumps({c: {n: round(v["median_ms"], 5) for n, v in
                          r["shapes"].items()}
                      for c, r in result["cuts"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
