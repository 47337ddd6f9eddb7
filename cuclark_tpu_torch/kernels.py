"""Build, load and launch the hand-written Hopper kernels.

The CUDA C++ sources in `csrc/` (`query.cu`, `score.cu`, and the header
`warp_score.cuh` both include) have a plain C interface.  At first use
they are compiled with nvcc for `sm_90a`, one nvcc per source side by
side, and linked into one shared library under `build/cuclark_tpu_torch/`
at the repository root, named by a hash of the sources and the flags (as
`native.py` keys its host library), and loaded with ctypes.  Nothing is
built when the module is imported, so the CPU tests import it without
nvcc.

Each launch function takes CUDA tensors, checks them, launches on
PyTorch's current stream, raises if the launch reports an error, and
adds one to its entry of `LAUNCHES`; each ctypes call into a C entry
is a `step.launch` span (`spans`), and the library's first load a
`kernels.load` span (with `kernels.compile` where nvcc runs, counted
in `kernels.builds`).  The callers are the wrappers
`probe.query_labels`, `probe.query_part_labels`,
`probe.query_codes_labels`, `probe.query_score_results`,
`probe.query_score_part_results` and `score.score_labels`, which take
the plain PyTorch versions for CPU tensors.  `query`, `query_part` and
`query_codes` launch the query kernel (`csrc/query.cu`) of the table's
layout: the resident query over
the whole table; the range query over one bucket range of main rows and
one range of stash rows (a part of a streamed table, or the db shard of
a mesh, `parallel/mesh.py`), through the kernel's queued range instance
(`range_query_kernel`, its blocks laid out by `range_geometry`) where
the range holds at most half the table; and the resident query over
unpacked codes (`pipeline.classify_step`).  Their counts are kept per layout: `query`,
`query_part` and `query_codes` for qs, the same names with `_q4` or `_s2`
for the others.  `query_score` launches the query kernel's fused
instance for reads of up to QUERY_SCORE_MAX_WINDOWS windows against the
resident table of any layout, which scores each read's labels on chip
and returns the [R, 5] results (`pipeline.classify_step_packed` without
labels), counted as `query_score` for qs and `query_score_q4` or
`query_score_s2`.  `query_score_part` launches the same instance over
one range of rows, with the int32 [R, P] label sum of the batch's other
range launches added before the score: the last launch of a data block
of a mesh step, or of the last part of a streamed step, on a mesh
(`parallel/mesh.py`) or on one device (`pipeline.Classifier`), counted
as `query_score_part[_q4|_s2]`; over a range that the range query takes
queued (`queue_score_windows`), through the queued fused instance
(`range_query_score_kernel`, laid out by `queue_geometry`) instead,
counted as `query_score_queue[_q4|_s2]`.  The fused instance goes through
the C entry `cuclark_query_score_range`, the queued one through
`cuclark_query_score_queue`.  `score`
launches the score kernel (`csrc/score.cu`), counted as `score_bounded`
for rows over 1,024 windows whose labels have a bound of at most
SCORE_BOUND_CAP, else as `score` for rows of up to MAX_SCORE_WINDOWS
windows and `score_long` for longer ones.

A launch runs with its tensors' device made current, on that device's
current stream, so the devices of a mesh may be different cards or
handles of one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from cuclark_tpu_torch import spans
from cuclark_tpu_torch.hashdb import TableSpec, feistel_seed_consts

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("query.cu", "score.cu")
HEADERS = ("warp_score.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuclark_tpu_torch"

# Longest label row of the score kernel's `score` entry; longer rows
# (reads over 32,798 bases at k=31) go to its `score_long` entry.
MAX_SCORE_WINDOWS = 32768

# Largest label bound of the score kernel's `score_bounded` entry
# (csrc/score.cu kBoundBins - 1): bound + 1 counters, rounded up to 32,
# in at most 115,328 bytes of shared memory, the most at which two
# blocks still share an H100 SM.  The bounded histogram beats the wide
# one at every bound up to it (csrc/score.cu's header).
SCORE_BOUND_CAP = 28831

# Longest label row of `query_score`: kMaxTiles tiles of the query kernel
# (csrc/query.cu), the rows of the score kernel's warp path (csrc/score.cu
# kWarpMax): every read length bin up to 1024, paired 2 x 150 bp reads
# (P = 290) among them.
QUERY_SCORE_MAX_WINDOWS = 1024

# The query kernel's tile (csrc/query.cu kTile) and gridDim.y's limit.
TILE = 128
GRID_Y_MAX = 65535

# Most tile-units a block of the range query (csrc/query.cu,
# range_query_kernel) covers: W windows a lane.  On an H100 the s2 pass of
# 8 parts ran 11% faster at 4 than at 8 (and qs's 4% faster): a warp's
# queue of W * 32 windows holds about one gather a lane at 4 parts.
RANGE_MAX_WINDOWS = 4


@dataclass(frozen=True)
class RangeGeometry:
    """The blocks of a range query launch over R reads of P windows:
    each block covers reads_per_block reads of tiles_per_block tiles of
    TILE windows (their product at most `windows`, the tile-units a block
    covers, W windows a thread), grid_x blocks on x over the reads, and
    on y the tile groups, in launches of (tile_base, grid_y) with grid_y
    at most GRID_Y_MAX; block (x, y) of a launch covers reads from x *
    reads_per_block and tiles from (tile_base + y) * tiles_per_block.
    windows 1 is query_kernel's geometry: a block a (read, tile)."""

    windows: int
    reads_per_block: int
    tiles_per_block: int
    grid_x: int
    launches: tuple[tuple[int, int], ...]


# The least W at which a layout's range calls take range_query_kernel:
# on an H100 qs's db shards of 2 ran 0.5% slower in it than in
# query_kernel (0 of 12 timings), q4's and s2's faster (12 of 12).
RANGE_MIN_WINDOWS = {"qs": 4, "q4": 2, "s2": 2}


def range_windows(nb_bits: int, nb_local: int, layout: str) -> int:
    """W of a range call of `layout` over nb_local of the table's
    2^nb_bits main rows: the table's rows over the range's, floored to a
    power of two and capped at RANGE_MAX_WINDOWS, so that about one window
    a thread has a row in the range (a streamed part of 4 or more: 4; a
    2-shard mesh's shard: 2).  1, query_kernel's geometry, below the
    layout's RANGE_MIN_WINDOWS (a range of more than half the table
    always)."""
    share = min((1 << nb_bits) // max(nb_local, 1), RANGE_MAX_WINDOWS)
    w = 1
    while 2 * w <= share:
        w *= 2
    return w if w >= RANGE_MIN_WINDOWS[layout] else 1


@functools.lru_cache(maxsize=64)
def range_geometry(R: int, P: int, windows: int) -> RangeGeometry:
    """The launches of a range query of R reads of P windows at W =
    `windows` tile-units a block: reads of at least W tiles take W of
    their tiles a block, shorter ones W // tiles whole reads (a 122-window
    read: W reads a block; a 290-window read of 3 tiles at W 4: one)."""
    T = -(-P // TILE)
    if T >= windows:
        G, Tb = 1, windows
    else:
        G, Tb = windows // T, T
    gy = -(-T // Tb)
    return RangeGeometry(windows, G, Tb, -(-R // G), tuple(
        (base, min(GRID_Y_MAX, gy - base))
        for base in range(0, gy, GRID_Y_MAX)))


# The reads whose fused range launch takes range_query_score_kernel
# (csrc/query.cu): by layout and the range's W (`range_windows`), the
# tile counts T = ceil(P / TILE) at which it beat query_score_kernel in
# at least 11 of 12 timings on an H100 (scripts/torch_kernel_ab.py,
# PERF.md section 6); every other read keeps query_score_kernel.
# Tile counts 5 to 7 (no default length bin gives them) were not timed.
QUEUE_SCORE_TILES = {("qs", 4): frozenset({1, 3, 4, 8}),
                     ("q4", 2): frozenset({1}),
                     ("q4", 4): frozenset({1, 3, 4}),
                     ("s2", 2): frozenset(),
                     ("s2", 4): frozenset({1, 2, 3, 4})}


def queue_score_windows(nb_bits: int, nb_local: int, layout: str,
                        P: int) -> int:
    """W of the fused range launch of reads of P windows over nb_local of
    the table's 2^nb_bits main rows: `range_windows` where
    QUEUE_SCORE_TILES[(layout, W)] holds the reads' tile count
    (range_query_score_kernel, W reads a block of one tile), else 1
    (query_score_kernel, a thread a window)."""
    W = range_windows(nb_bits, nb_local, layout)
    tiles = QUEUE_SCORE_TILES.get((layout, W), frozenset())
    return W if -(-P // TILE) in tiles else 1


@dataclass(frozen=True)
class QueueGeometry:
    """The blocks of a range_query_score_kernel launch over R reads:
    reads_per_block reads a block (W = `windows` for reads of one tile,
    one for wider reads: the score needs a read's windows in one block),
    grid_x blocks on x, block x covering reads from x * reads_per_block."""

    windows: int
    reads_per_block: int
    grid_x: int


@functools.lru_cache(maxsize=64)
def queue_geometry(R: int, P: int, windows: int) -> QueueGeometry:
    """The launch of a queued fused range call of R reads of P windows at
    W = `windows`: never a read split over blocks."""
    G = windows if P <= TILE else 1
    return QueueGeometry(windows, G, -(-R // G))


# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"query": 0, "query_part": 0, "query_codes": 0, "query_q4": 0,
            "query_part_q4": 0, "query_codes_q4": 0, "query_s2": 0,
            "query_part_s2": 0, "query_codes_s2": 0, "query_score": 0,
            "query_score_q4": 0, "query_score_s2": 0, "query_score_part": 0,
            "query_score_part_q4": 0, "query_score_part_s2": 0,
            "query_score_queue": 0, "query_score_queue_q4": 0,
            "query_score_queue_s2": 0, "score": 0, "score_long": 0,
            "score_bounded": 0}

# The query kernel's layout argument (csrc/query.cu, enum Layout).
_LAYOUT_CODE = {"qs": 0, "q4": 1, "s2": 2}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    return BUILD_DIR / f"libcuclark_kernels_{h.hexdigest()[:16]}.so"


def compile_library(src_dir: Path, path: Path) -> None:
    """nvcc SOURCES of src_dir into the shared library `path`: one nvcc
    -c per source, all started together, then one link, through
    per-process temp names and an atomic rename, so concurrent first
    builds never publish a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [path.with_suffix(f".{Path(s).stem}.tmp{os.getpid()}.o")
            for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o),
                               str(src_dir / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(SOURCES, objs)]
    try:
        errs = [p.communicate()[1] for p in procs]
        for p, err in zip(procs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)


_vp, _i32, _i64, _u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint32)
# The C entries' argument types; each returns a CUDA error code (int).
ENTRIES = {
    "cuclark_query": [_i32, _i32, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32,
                      _i32, _i32, _i32, _i32, _i64, _i64, _i64, _i64, _i32,
                      _u32, _u32, _u32, _i32, _i32, _i32, _vp],
    "cuclark_query_range": [_i32, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32,
                            _i32, _i32, _i32, _i32, _i64, _i64, _i64, _i64,
                            _i32, _u32, _u32, _u32, _i32, _i32, _i32, _i32,
                            _i32, _i64, _i32, _i32, _vp],
    "cuclark_query_score_range": [_i32, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
                                  _i32, _i32, _i32, _i32, _i32, _i32, _i64,
                                  _i64, _i64, _i64, _u32, _u32, _u32, _i32,
                                  _i32, _i32, _vp],
    "cuclark_query_score_queue": [_i32, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
                                  _i32, _i32, _i32, _i32, _i32, _i32, _i64,
                                  _i64, _i64, _i64, _u32, _u32, _u32, _i32,
                                  _i32, _i32, _i64, _vp],
    "cuclark_score": [_vp, _vp, _i64, _i32, _vp],
    "cuclark_score_long": [_vp, _vp, _i64, _i32, _vp],
    "cuclark_score_bounded": [_vp, _vp, _i64, _i32, _i32, _vp],
}


def bind(lib: ctypes.CDLL, names=tuple(ENTRIES)) -> ctypes.CDLL:
    """Set the argument and return types of the C entries `names` on a
    loaded library."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype = _i32
        fn.argtypes = ENTRIES[name]
    return lib


def load() -> ctypes.CDLL:
    """Build the kernels' library if needed, load it once, and bind the
    C functions' argument types."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            with spans.span("kernels.load", always=True):
                path = library_path()
                if not path.exists():
                    with spans.span("kernels.compile", always=True):
                        compile_library(_CSRC, path)
                    spans.count("kernels.builds")
                _LIB = bind(ctypes.CDLL(str(path)))
        return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_reads(packed2, vbits) -> tuple[int, int, int, int]:
    """Check a wire batch (packed2 uint8 [R, s2], vbits uint8 [R, s8]) or,
    with vbits None, unpacked codes uint8 [R, L] on a CUDA device ->
    (R, s2, s8, padded read length L)."""
    dev = packed2.device
    if dev.type != "cuda":
        raise ValueError(f"query kernel needs CUDA tensors, got {dev}")
    _check(packed2, "codes" if vbits is None else "packed2", torch.uint8, dev)
    R, s2 = packed2.shape
    if vbits is None:
        return R, s2, 0, s2
    _check(vbits, "vbits", torch.uint8, dev)
    s8 = vbits.shape[1]
    if vbits.shape[0] != R or 8 * s8 < 4 * s2:
        raise ValueError(f"vbits {tuple(vbits.shape)} does not cover "
                         f"packed2 {tuple(packed2.shape)}")
    return R, s2, s8, 4 * s2


def _check_table_range(main, stash, *, dev, spec: TableSpec,
                       bucket_start: int, stash_start: int):
    """Check a range of a table on `dev`: main holds global main rows
    [bucket_start, bucket_start + len(main)) of 2^nb_bits rows, [rows, 8]
    for qs and q4 and [rows, 3 * slots] for s2; a qs stash holds global
    stash rows [stash_start, stash_start + len(stash)) of 2^stash_bits,
    and None skips the stash probe; q4 and s2 have none.  Returns
    (nb_local, stash pointer or None, nbs_local)."""
    _check(main, "main", torch.int32, dev)
    nb_local = main.shape[0]
    if (main.shape[1] != spec.row_words or nb_local < 1 or bucket_start < 0
            or bucket_start + nb_local > 1 << spec.nb_bits):
        raise ValueError(f"main rows {tuple(main.shape)} from bucket "
                         f"{bucket_start} do not lie in 2^{spec.nb_bits} "
                         f"rows of {spec.row_words} words")
    _check_align(main, spec)
    if stash is None:
        return nb_local, None, 0
    if spec.layout != "qs":
        raise ValueError(f"a {spec.layout} table has no stash")
    _check(stash, "stash", torch.int32, dev)
    nbs_local = stash.shape[0]
    if (stash.shape[1] != 8 or nbs_local < 1 or stash_start < 0
            or stash_start + nbs_local > 1 << spec.stash_bits):
        raise ValueError(f"stash rows {tuple(stash.shape)} from "
                         f"{stash_start} do not lie in "
                         f"2^{spec.stash_bits} rows of 8 words")
    if stash.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    return nb_local, stash.data_ptr(), nbs_local


def _check_acc(acc, name: str, dev, R: int, P: int) -> None:
    _check(acc, name, torch.int32, dev)
    if acc.shape != (R, P):
        raise ValueError(f"{name} {tuple(acc.shape)}, expected {(R, P)}")


def _launch_query(packed2, vbits, main, stash, acc, *, k, spec: TableSpec,
                  bucket_start, stash_start=0) -> torch.Tensor:
    """Check the query kernel's operands and launch the kernel of
    `spec.layout` on the current stream over the table range that main
    and stash hold (`_check_table_range`).  vbits None: packed2 is
    unpacked codes uint8 [R, L] (the codes front half).  Returns new
    labels int32 [R, P], or `acc` with the labels added in place."""
    dev = packed2.device
    spec.check()
    R, s2, s8, L = _check_reads(packed2, vbits)
    if not 2 <= k <= 32 or L < k:
        raise ValueError(f"padded read length {L} < k={k} or k out of range")
    P = L - k + 1
    if acc is not None:
        _check_acc(acc, "acc", dev, R, P)
    nb_local, stash_ptr, nbs_local = _check_table_range(
        main, stash, dev=dev, spec=spec, bucket_start=bucket_start,
        stash_start=stash_start)
    out = acc if acc is not None else torch.empty(
        (R, P), dtype=torch.int32, device=dev)
    lib = load()
    c1, c2, c3 = feistel_seed_consts(spec.seed)
    W = (1 if vbits is None
         else range_windows(spec.nb_bits, nb_local, spec.layout))
    args = (main.data_ptr(), stash_ptr, out.data_ptr(), R, P, s2, s8, k,
            spec.nb_bits, spec.stash_bits, bucket_start, nb_local,
            stash_start, nbs_local, int(acc is not None), c1, c2, c3,
            spec.slots, spec.num_choices)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if W == 1:
            with spans.span("step.launch"):
                err = lib.cuclark_query(
                    _LAYOUT_CODE[spec.layout], int(vbits is None),
                    packed2.data_ptr(),
                    None if vbits is None else vbits.data_ptr(), *args,
                    int(spec.sampled), stream)
            _raise_on(err, "query")
            return out
        g = range_geometry(R, P, W)
        for base, gy in g.launches:
            with spans.span("step.launch"):
                err = lib.cuclark_query_range(
                    _LAYOUT_CODE[spec.layout], packed2.data_ptr(),
                    vbits.data_ptr(), *args, W, g.reads_per_block,
                    g.tiles_per_block, g.grid_x, gy, base, stream)
            _raise_on(err, "query")
    return out


def _check_align(main: torch.Tensor, spec: TableSpec) -> None:
    """qs and q4 rows are read as two 16 B loads; s2 rows as 8 B loads
    when the slots are even, else 4 B loads."""
    align = 16 if spec.layout != "s2" else 8 if spec.slots % 2 == 0 else 4
    if main.data_ptr() % align:
        raise ValueError(f"table rows must be {align}-byte aligned")


def _count(name: str, layout: str) -> None:
    LAUNCHES[name if layout == "qs" else f"{name}_{layout}"] += 1


def _check_resident(main: torch.Tensor, stash: torch.Tensor | None,
                    spec: TableSpec) -> None:
    if main.shape[0] != 1 << spec.nb_bits or (
            (stash is None) != (spec.layout != "qs")) or (
            stash is not None and stash.shape[0] != 1 << spec.stash_bits):
        raise ValueError("main/stash shapes do not match the table")


def query(packed2: torch.Tensor, vbits: torch.Tensor, main: torch.Tensor,
          stash: torch.Tensor | None, *, k: int,
          spec: TableSpec) -> torch.Tensor:
    """Launch the query kernel (csrc/query.cu) on the resident table:
    main [2^nb_bits, row words] and, for qs, stash [2^stash_bits, 8] ->
    labels int32 [R, P]."""
    _check_resident(main, stash, spec)
    labels = _launch_query(packed2, vbits, main, stash, None, k=k,
                           spec=spec, bucket_start=0)
    _count("query", spec.layout)
    return labels


def query_part(packed2: torch.Tensor, vbits: torch.Tensor,
               main_part: torch.Tensor, stash: torch.Tensor | None, *,
               bucket_start: int, k: int, spec: TableSpec,
               stash_start: int = 0,
               acc: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the query kernel (csrc/query.cu) on one range of rows:
    main_part holds main rows [bucket_start, bucket_start +
    len(main_part)), a qs stash holds stash rows [stash_start,
    stash_start + len(stash)) and None skips the stash probe.  Returns
    new labels int32 [R, P], or adds them into `acc` in place and
    returns it.  A range of at most half the table's main rows (a
    streamed part, a db shard) takes `range_query_kernel` at W =
    `range_windows` tile-units a block (`range_geometry`): each warp's
    front half of W windows a lane queues its windows with a row in the
    range, and all its lanes then gather from the queue; a wider range
    takes `query_kernel`, a thread a window.  One launch a call, past
    65,535 tile groups a row one a group of them."""
    out = _launch_query(packed2, vbits, main_part, stash, acc, k=k,
                        spec=spec, bucket_start=bucket_start,
                        stash_start=stash_start)
    _count("query_part", spec.layout)
    return out


def query_codes(codes: torch.Tensor, main: torch.Tensor,
                stash: torch.Tensor | None, *, k: int,
                spec: TableSpec) -> torch.Tensor:
    """Launch the query kernel's codes front half (csrc/query.cu) on the
    resident table: codes uint8 [R, L] (0..3, >= 4 invalid) -> labels
    int32 [R, L - k + 1]."""
    _check_resident(main, stash, spec)
    labels = _launch_query(codes, None, main, stash, None, k=k, spec=spec,
                           bucket_start=0)
    _count("query_codes", spec.layout)
    return labels


def _launch_query_score(packed2, vbits, main, stash, acc_in, *, k,
                        spec: TableSpec, bucket_start: int,
                        stash_start: int, windows: int = 1) -> torch.Tensor:
    """Check the fused query and score's operands and launch it on the
    current stream over the table range that main and stash hold
    (`_check_table_range`), acc_in int32 [R, P] or None -> results int32
    [R, 5]: windows 1 through `cuclark_query_score_range`
    (query_score_kernel), W = 2 or 4 through `cuclark_query_score_queue`
    (range_query_score_kernel, laid out by `queue_geometry`)."""
    spec.check()
    P = 4 * packed2.shape[-1] - k + 1
    if not 2 <= k <= 32 or not 1 <= P <= QUERY_SCORE_MAX_WINDOWS:
        raise ValueError(f"fused query and score needs 1 <= P <= "
                         f"{QUERY_SCORE_MAX_WINDOWS} windows and k in 2..32,"
                         f" got P={P}, k={k}")
    dev = packed2.device
    R, s2, s8, _ = _check_reads(packed2, vbits)
    if vbits is None:
        raise ValueError("the fused query and score takes a wire batch")
    nb_local, stash_ptr, nbs_local = _check_table_range(
        main, stash, dev=dev, spec=spec, bucket_start=bucket_start,
        stash_start=stash_start)
    if acc_in is not None:
        _check_acc(acc_in, "acc_in", dev, R, P)
    if windows != 1 and (windows not in (2, 4) or spec.nb_bits > 31
                         or spec.stash_bits > 31):
        raise ValueError(f"the queued fused range launch takes W 2 or 4 "
                         f"and nb_bits, stash_bits <= 31, got W={windows}")
    results = torch.empty((R, 5), dtype=torch.int32, device=dev)
    lib = load()
    c1, c2, c3 = feistel_seed_consts(spec.seed)
    args = (_LAYOUT_CODE[spec.layout], packed2.data_ptr(), vbits.data_ptr(),
            main.data_ptr(), stash_ptr,
            None if acc_in is None else acc_in.data_ptr(),
            results.data_ptr(), R, P, s2, s8, k, spec.nb_bits,
            spec.stash_bits, bucket_start, nb_local, stash_start, nbs_local,
            c1, c2, c3, spec.slots, spec.num_choices)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if windows == 1:
            with spans.span("step.launch"):
                err = lib.cuclark_query_score_range(
                    *args, int(spec.sampled), stream)
        else:
            grid_x = queue_geometry(R, P, windows).grid_x
            with spans.span("step.launch"):
                err = lib.cuclark_query_score_queue(*args, windows, grid_x,
                                                    stream)
        _raise_on(err, "query_score")
    return results


def query_score(packed2: torch.Tensor, vbits: torch.Tensor,
                main: torch.Tensor, stash: torch.Tensor | None, *, k: int,
                spec: TableSpec) -> torch.Tensor:
    """Launch the query kernel's fused instance (csrc/query.cu,
    query_score_kernel) on a resident table: main [2^nb_bits, row words]
    and, for qs, stash [2^stash_bits, 8] (None for q4 and s2); the wire
    batch's labels scored on chip -> results int32 [R, 5], as
    score(query(...)) gives them.  Rows of at most
    QUERY_SCORE_MAX_WINDOWS windows (a block of ceil(P / 128) tiles per
    read)."""
    if (spec.layout == "qs") != (stash is not None):
        raise ValueError("the fused query and score takes a qs table with "
                         "its stash, a q4 or s2 table without one")
    _check_resident(main, stash, spec)
    results = _launch_query_score(packed2, vbits, main, stash, None, k=k,
                                  spec=spec, bucket_start=0, stash_start=0)
    _count("query_score", spec.layout)
    return results


def query_score_part(packed2: torch.Tensor, vbits: torch.Tensor,
                     main_part: torch.Tensor, stash: torch.Tensor | None, *,
                     bucket_start: int, k: int, spec: TableSpec,
                     stash_start: int = 0,
                     acc_in: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the query kernel's fused instance on one range of rows
    (query_part's ranges: main_part holds main rows [bucket_start,
    bucket_start + len(main_part)), a qs stash holds stash rows
    [stash_start, stash_start + len(stash)) and None skips the stash
    probe), with acc_in, int32 [R, P] or None, added to the labels before
    the score -> results int32 [R, 5], as score(query_part(..., acc=
    acc_in)) gives them; acc_in is only read.  Rows of at most
    QUERY_SCORE_MAX_WINDOWS windows.  Where `queue_score_windows` gives
    W > 1 (a range the range query takes queued, reads of a tile count in
    QUEUE_SCORE_TILES), the launch is range_query_score_kernel
    (`query_score_queue`), counted as query_score_queue[_q4|_s2]; else
    query_score_kernel, counted as query_score_part[_q4|_s2]."""
    P = 4 * packed2.shape[-1] - k + 1
    W = queue_score_windows(spec.nb_bits, main_part.shape[0], spec.layout, P)
    if W > 1:
        return query_score_queue(packed2, vbits, main_part, stash,
                                 bucket_start=bucket_start, k=k, spec=spec,
                                 stash_start=stash_start, acc_in=acc_in,
                                 windows=W)
    results = _launch_query_score(packed2, vbits, main_part, stash, acc_in,
                                  k=k, spec=spec, bucket_start=bucket_start,
                                  stash_start=stash_start)
    _count("query_score_part", spec.layout)
    return results


def query_score_queue(packed2: torch.Tensor, vbits: torch.Tensor,
                      main_part: torch.Tensor, stash: torch.Tensor | None, *,
                      bucket_start: int, k: int, spec: TableSpec,
                      stash_start: int = 0,
                      acc_in: torch.Tensor | None = None,
                      windows: int) -> torch.Tensor:
    """query_score_part's launch through range_query_score_kernel at W =
    `windows` (2 or 4) reads a block of one tile (one read a block of 2
    to 8 tiles), whatever the route: the windows with a row in the range
    are queued a block, then every thread gathers from the queue.
    Counted as query_score_queue[_q4|_s2]."""
    results = _launch_query_score(packed2, vbits, main_part, stash, acc_in,
                                  k=k, spec=spec, bucket_start=bucket_start,
                                  stash_start=stash_start, windows=windows)
    _count("query_score_queue", spec.layout)
    return results


def score(labels: torch.Tensor, label_bound: int | None = None
          ) -> torch.Tensor:
    """Launch the score kernel (csrc/score.cu) -> results int32 [R, 5]:
    for rows over 1,024 windows whose labels are at most a label_bound
    of at most SCORE_BOUND_CAP, its `score_bounded` entry (a histogram
    of label_bound + 1 counters); else its `score` entry for rows of up
    to MAX_SCORE_WINDOWS windows, its `score_long` entry for longer
    ones.  None needs scratch."""
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"score kernel needs CUDA tensors, got {dev}")
    _check(labels, "labels", torch.int32, dev)
    R, P = labels.shape
    if P < 1:
        raise ValueError(f"labels need at least one window per read, got {P}")
    if label_bound is not None and label_bound < 0:
        raise ValueError(f"label bound {label_bound} is negative")
    results = torch.empty((R, 5), dtype=torch.int32, device=dev)
    bound = ()
    if (P > QUERY_SCORE_MAX_WINDOWS and label_bound is not None
            and label_bound <= SCORE_BOUND_CAP):
        name, bound = "score_bounded", (label_bound,)
    else:
        name = "score" if P <= MAX_SCORE_WINDOWS else "score_long"
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = getattr(lib, f"cuclark_{name}")
        with spans.span("step.launch"):
            err = entry(labels.data_ptr(), results.data_ptr(), R, P, *bound,
                        stream)
        _raise_on(err, name)
    LAUNCHES[name] += 1
    return results
