"""ctypes bindings to the port's native host module (csrc/host_ops.cpp).

Counterpart of `cuclark_tpu/native.py`. It compiles the port's own copy
of the host module, `cuclark_tpu_torch/csrc/host_ops.cpp` (the JAX
package's `csrc/host_ops.cpp` plus a record scan on the OpenMP team),
and caches the library under its own `cuclark_tpu_torch` subdirectory.
`scan` runs that parallel scan (`scan_records`); the JAX package's
one-thread scan stays beside it as the plain version
(`scan_records_serial`), and both give the same offsets.
`format_rows`/`format_rows_ext` write classify's CSV rows without
printf, byte for byte the rows of the JAX package's snprintf formatter,
which stays beside them as the plain version (`format_rows_printf`,
`format_rows_ext_printf`); `format_results`/`format_results_ext` write
the same rows from the card's results rows, computing gamma and
confidence themselves (held to `score.gamma_confidence` + the printf
versions).  `first_mate_mismatch` checks the mate ids of two scanned
files on the OpenMP team (held to
`fast_parse.first_mate_mismatch_plain`).  `pack_block2`/
`pack_block2_paired` pack eight bases a step into arrays the caller may
give (`out`); the one-base loops stay as
`pack_block2_plain`/`pack_block2_paired_plain`.  `inflate` inflates a
gzip input on the OpenMP team (BGZF members a thread each, anything
else in chunks decoded speculatively), byte for byte
`gzip.GzipFile(...).read()`, which stays as `pipeline._inflate_plain`,
the plain version.

Compiled lazily with g++ on first use and cached in the user's cache
directory (`_cache_dir`); everything degrades gracefully to the numpy
implementations when no compiler is available (`native.available()` ->
False).  The first load is a `native.load` span (`spans`), with
`native.compile` where g++ runs, counted in `native.builds`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from cuclark_tpu_torch import spans

_SRC = Path(__file__).resolve().parent / "csrc" / "host_ops.cpp"
_LIB = None
_TRIED = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U64P = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def _cache_dir() -> Path:
    """User-owned 0700 cache directory for the compiled library.

    NOT the world-writable tempdir: the cache path is predictable (a
    public hash of the source), so on a shared host another local user
    could pre-plant a malicious .so there and ctypes.CDLL would execute
    its constructor with this process's privileges."""
    d = Path(os.environ.get("XDG_CACHE_HOME")
             or Path.home() / ".cache") / "cuclark_tpu_torch" / "native"
    try:
        d.mkdir(parents=True, exist_ok=True)
        os.chmod(d, 0o700)
        return d
    except OSError:
        # no usable home: fall back to a per-uid tempdir subdirectory
        d = Path(tempfile.gettempdir()) / f"cuclark_tpu_torch_{os.getuid()}"
        d.mkdir(mode=0o700, parents=True, exist_ok=True)
        if d.stat().st_uid != os.getuid():
            raise RuntimeError(f"native cache dir {d} owned by another "
                               f"user")
        return d


def _build() -> ctypes.CDLL | None:
    if not _SRC.exists():
        return None
    src = _SRC.read_bytes()
    flags = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
    # cache tag covers source AND compile command: a flag-only change
    # must not silently reuse a binary built with the old flags
    tag = hashlib.sha256(src + "\0".join(flags).encode()).hexdigest()[:16]
    try:
        cache = _cache_dir() / f"cuclark_host_ops_{tag}.so"
    except (RuntimeError, OSError):
        return None
    if not cache.exists():
        # per-process temp name: concurrent first-use builds (parallel
        # CLI runs / multi-process hosts) must not interleave writes
        # into one file and publish a corrupt library
        tmp = cache.with_suffix(f".tmp{os.getpid()}.so")
        cmd = flags + [str(_SRC), "-o", str(tmp)]
        try:
            with spans.span("native.compile", always=True):
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
            spans.count("native.builds")
            os.replace(tmp, cache)  # atomic publish
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(cache))
    except OSError:  # corrupt/unreadable cache: degrade to numpy
        return None

    lib.scan_fastq.restype = ctypes.c_int64
    lib.scan_fastq.argtypes = [_U8P, ctypes.c_int64, _I64P, _I64P, _I64P,
                               _I64P, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.scan_fasta.restype = ctypes.c_int64
    lib.scan_fasta.argtypes = lib.scan_fastq.argtypes
    lib.scan_team.restype = ctypes.c_int64
    lib.scan_team.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.scan_plan.restype = ctypes.c_int64
    lib.scan_plan.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int32,
                              ctypes.c_int64, _I64P, ctypes.c_int64]
    lib.scan_fastq_par.restype = ctypes.c_int64
    lib.scan_fastq_par.argtypes = [_U8P, ctypes.c_int64, _I64P, _I64P,
                                   _I64P, _I64P, _I64P, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.scan_fasta_par.restype = ctypes.c_int64
    lib.scan_fasta_par.argtypes = lib.scan_fastq_par.argtypes
    lib.mate_team.restype = ctypes.c_int64
    lib.mate_team.argtypes = [ctypes.c_int64, ctypes.c_int64]
    mate = [_U8P, ctypes.c_int64, _I64P, _I64P]
    lib.first_mate_mismatch.restype = ctypes.c_int64
    lib.first_mate_mismatch.argtypes = mate + mate + [ctypes.c_int64,
                                                      ctypes.c_int64]
    lib.read_file_par.restype = ctypes.c_int64
    lib.read_file_par.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.pack_block.restype = None
    lib.pack_block.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64, _U8P,
                               ctypes.c_int64, _I64P]
    pack2 = [_U8P, _I64P, _I64P, ctypes.c_int64, _U8P, _U8P,
             ctypes.c_int64, ctypes.c_int64, _I64P]
    pack2_paired = [_U8P, _I64P, _I64P, _U8P, _I64P, _I64P,
                    ctypes.c_int64, _U8P, _U8P, ctypes.c_int64,
                    ctypes.c_int64, _I64P]
    for name, args in (("pack_block2_plain", pack2),
                       ("pack_block2", pack2 + [ctypes.c_int64]),
                       ("pack_block2_paired_plain", pack2_paired),
                       ("pack_block2_paired",
                        pack2_paired + [ctypes.c_int64])):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = args
    lib.pack_team.restype = ctypes.c_int64
    lib.pack_team.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.extract_canonical.restype = ctypes.c_int64
    lib.extract_canonical.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int32,
                                      _U64P]
    lib.extract_canonical_light.restype = ctypes.c_int64
    lib.extract_canonical_light.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), _U64P]
    lib.kmer_bound.restype = ctypes.c_int64
    lib.kmer_bound.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.build_cuckoo.restype = ctypes.c_int64
    lib.build_cuckoo.argtypes = [
        _U64P, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        _U8P, ctypes.c_int64]
    _F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    _I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    rows = [ctypes.c_int64, _I64P, _F64P, _I32P, _I32P, _I32P, _I32P,
            _F64P, _U8P, _I64P, _I64P, _U8P, _I64P, _U8P, ctypes.c_int64]
    lib.format_rows_printf.restype = ctypes.c_int64
    lib.format_rows_printf.argtypes = rows
    lib.format_rows.restype = ctypes.c_int64
    lib.format_rows.argtypes = rows + [ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int64)]
    _U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.build_q4.restype = ctypes.c_int64
    lib.build_q4.argtypes = [
        _U64P, _U32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        _U32P, _U8P, ctypes.c_int64]
    lib.spill_partition.restype = None
    lib.spill_partition.argtypes = [
        _U64P, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _U64P, _I64P]
    lib.reduce_occurrences.restype = ctypes.c_int64
    lib.reduce_occurrences.argtypes = [
        _U64P, _U32P, _U32P, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        _U64P, _U64P, _U64P, _U32P, _U32P]
    lib.format_rows_team.restype = ctypes.c_int64
    lib.format_rows_team.argtypes = [ctypes.c_int64, ctypes.c_int64]
    rows_ext = [ctypes.c_int64, ctypes.c_int64, _U32P] + rows[1:]
    lib.format_rows_ext_printf.restype = ctypes.c_int64
    lib.format_rows_ext_printf.argtypes = rows_ext
    lib.format_rows_ext.restype = ctypes.c_int64
    lib.format_rows_ext.argtypes = rows_ext + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    results = [_I32P, _I64P, ctypes.c_int64, ctypes.c_int64] + rows[8:]
    lib.format_results.restype = ctypes.c_int64
    lib.format_results.argtypes = [ctypes.c_int64] + results + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.format_results_ext.restype = ctypes.c_int64
    lib.format_results_ext.argtypes = rows_ext[:3] + results + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.csv_tally.restype = ctypes.c_int64
    lib.csv_tally.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        _I64P, ctypes.c_int32, _U8P, ctypes.c_int64, _I64P,
        ctypes.POINTER(ctypes.c_int64)]
    lib.count_lines.restype = ctypes.c_int64
    lib.count_lines.argtypes = [_U8P, ctypes.c_int64]
    lib.csv_values.restype = ctypes.c_int64
    lib.csv_values.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _F64P, ctypes.c_int64]
    lib.inflate_team.restype = ctypes.c_int64
    lib.inflate_team.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.gz_inflate.restype = ctypes.c_int64
    lib.gz_inflate.argtypes = [
        _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        _I64P]
    lib.gz_free.restype = None
    lib.gz_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gz_crc32_combine.restype = ctypes.c_uint32
    lib.gz_crc32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                     ctypes.c_uint64]
    return lib


def _lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("CUCLARK_NO_NATIVE"):
            _LIB = None
        else:
            with spans.span("native.load", always=True):
                _LIB = _build()
    return _LIB


def available() -> bool:
    return _lib() is not None


# chunks a scan may cut its buffer into (scan_plan's plan length - 2)
_SCAN_MAX_CHUNKS = 1024


def scan_team(n: int, threads: int = 0) -> int:
    """Chunks (one a thread) the scanner cuts an n-byte buffer into:
    `threads` when > 0, else one below 1 MiB and the OpenMP team
    (OMP_NUM_THREADS, else every core) from there up."""
    return min(int(_lib().scan_team(n, threads)), _SCAN_MAX_CHUNKS)


def scan_records(buf: np.ndarray, fasta: bool, threads: int = 0,
                 max_rec: int | None = None):
    """The record scan on the OpenMP team, unchecked: (name_s, name_e,
    seq_s, seq_e, consumed) of at most max_rec records, equal to the
    one-thread scan_fastq/scan_fasta's (`scan_records_serial`) for
    every input and team size.  A first pass counts each chunk's
    record starts, so the offset arrays are allocated once."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    n = len(buf)
    plan = np.zeros(_SCAN_MAX_CHUNKS + 2, np.int64)
    cap = lib.scan_plan(buf, n, int(fasta), threads, plan, len(plan))
    if max_rec is not None:
        cap = max(0, min(cap, max_rec))
    ns, ne, ss, se = (np.empty(cap, np.int64) for _ in range(4))
    consumed = ctypes.c_int64(0)
    fn = lib.scan_fasta_par if fasta else lib.scan_fastq_par
    r = fn(buf, n, plan, ns, ne, ss, se, cap, ctypes.byref(consumed))
    return ns[:r], ne[:r], ss[:r], se[:r], consumed.value


def scan_records_serial(buf: np.ndarray, fasta: bool,
                        max_rec: int | None = None):
    """`scan_records` through the one-thread scan_fastq/scan_fasta, the
    plain versions the parallel scan is held to (tests, chip_smoke.py).
    The offset arrays grow when the minimum-record-size guess
    undershoots (header-only records)."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    n = len(buf)
    limit = max(0, max_rec) if max_rec is not None else None
    cap = n // 4 + 2 if fasta else n // 8 + 2
    if limit is not None:
        cap = min(cap, limit)
    fn = lib.scan_fasta if fasta else lib.scan_fastq
    consumed = ctypes.c_int64(0)
    while True:
        ns, ne, ss, se = (np.empty(cap, np.int64) for _ in range(4))
        r = fn(buf, n, ns, ne, ss, se, cap, ctypes.byref(consumed))
        if r < cap or cap == limit:
            break
        cap *= 4  # tiny records beat the size guess: rescan larger
        if limit is not None:
            cap = min(cap, limit)
    return ns[:r], ne[:r], ss[:r], se[:r], consumed.value


def scan(buf: np.ndarray, threads: int = 0):
    """Scan FASTA/FASTQ bytes -> (name_s, name_e, seq_s, seq_e), on the
    OpenMP team (`scan_records`; `threads` as `scan_team`).

    Raises ValueError on malformed FASTQ (a mid-file line that is not a
    record header) instead of silently dropping the remainder; a
    trailing partial record (truncated file) is dropped like the numpy
    scanner's."""
    n = len(buf)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    if buf[0] == ord("@"):
        fasta = False
    elif buf[0] == ord(">"):
        fasta = True
    else:
        raise ValueError("Failed to recognize the format of the file.")
    *offsets, c = scan_records(buf, fasta, threads)
    if c < n and buf[c:].tobytes().strip():
        raise ValueError(
            f"malformed FASTQ record at byte {c}: line does not start "
            f"with '@' (remainder would be silently skipped)")
    return tuple(offsets)


def mate_team(n: int, threads: int = 0) -> int:
    """Threads `first_mate_mismatch` runs n records on: `threads` when
    > 0, else one below 16,384 records and the OpenMP team
    (OMP_NUM_THREADS, else every core) from there up; never more than
    n."""
    return int(_lib().mate_team(n, threads))


def first_mate_mismatch(buf1: np.ndarray, ns1, ne1, buf2: np.ndarray, ns2,
                        ne2, threads: int = 0) -> int:
    """The index of the first of the first min(len(ns1), len(ns2))
    records whose mate ids differ, or -1: the numpy check's answer
    (`fast_parse.first_mate_mismatch_plain`, the plain version), on the
    OpenMP team (`threads` as `mate_team`).  A name is buf[s:e] as the
    scan cut it, its id the bytes before its first '/', else all of it.
    Raises ValueError when a name lies outside its buffer."""
    n = min(len(ns1), len(ns2))
    if n == 0:
        return -1
    if len(ne1) < n or len(ne2) < n:
        raise ValueError(f"first_mate_mismatch: {len(ne1)}/{len(ne2)} name "
                         f"ends for {n} records")
    args = [a for buf, s, e in ((buf1, ns1, ne1), (buf2, ns2, ne2))
            for a in (np.ascontiguousarray(buf, np.uint8), len(buf),
                      np.ascontiguousarray(s[:n], np.int64),
                      np.ascontiguousarray(e[:n], np.int64))]
    r = _lib().first_mate_mismatch(*args, n, threads)
    if r == -2:
        raise ValueError("first_mate_mismatch: a name offset lies outside "
                         "its buffer")
    return int(r)


def read_file(path, threads: int = 0) -> np.ndarray:
    """A plain file's bytes, read by byte range on the team (pread a
    chunk a thread into one array; `threads` as `scan_team`).  Not on
    classify's path: on the H100's 8-core host it did not beat
    `np.fromfile` in 11 of 12 pairs (`scripts/torch_host_scan.py`, the
    instrument that times it)."""
    n = os.path.getsize(path)
    out = np.empty(n, np.uint8)
    got = _lib().read_file_par(os.fsencode(os.fspath(path)), out, n,
                               scan_team(n, threads))
    if got != n:
        raise OSError(f"read {got} of {n} bytes of {path}")
    return out


def pack_block(buf: np.ndarray, seq_s, seq_e, max_len: int,
               n_rows: int | None = None):
    lib = _lib()
    nrec = len(seq_s)
    R = n_rows if n_rows is not None else nrec
    if R < nrec or len(seq_e) != nrec:
        raise ValueError("pack_block: output rows/offsets mismatch")
    codes = np.empty((R, max_len), np.uint8)
    if R > nrec:
        codes[nrec:] = 4
    lengths = np.zeros(R, np.int64)
    if nrec:
        lib.pack_block(
            np.ascontiguousarray(buf),
            np.ascontiguousarray(seq_s, np.int64),
            np.ascontiguousarray(seq_e, np.int64),
            nrec, codes, max_len, lengths,
        )
    return codes, lengths


def pack_team(n: int, threads: int = 0) -> int:
    """Threads `pack_block2` runs n rows on: `threads` when > 0, else
    one below 256 rows and half the OpenMP team (rounded down, at least
    one) from there up: classify's writer runs its rows at the same
    time on the rest (`format_team`)."""
    return int(_lib().pack_team(n, threads))


def wire_shape(max_len: int) -> tuple[int, int]:
    """(packed2, vbits) bytes a row of the wire format for reads of up
    to max_len bases: Lp / 4 and Lp / 8, Lp = max_len rounded up to a
    multiple of 8."""
    Lp = -(-max_len // 8) * 8
    return Lp // 4, Lp // 8


def _wire_out(R: int, nrec: int, max_len: int, out, zero: bool):
    """The (packed2, vbits, lengths) arrays a pack writes: `out` checked,
    else new ones (zeroed whole for a plain version, which ORs into its
    rows); the padding rows past nrec zeroed either way."""
    w2, wv = wire_shape(max_len)
    if out is None:
        make = np.zeros if zero else np.empty
        out = (make((R, w2), np.uint8), make((R, wv), np.uint8),
               make(R, np.int64))
    packed2, vbits, lengths = out
    for a, shape, dt in ((packed2, (R, w2), np.uint8),
                         (vbits, (R, wv), np.uint8),
                         (lengths, (R,), np.int64)):
        if (a.shape != shape or a.dtype != dt
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"pack: out array {a.shape} {a.dtype} is not "
                             f"a writeable C-contiguous {shape} {dt}")
    if not zero:
        packed2[nrec:] = 0
        vbits[nrec:] = 0
        lengths[nrec:] = 0
    return packed2, vbits, lengths


def _pack2(fn, mates: tuple, max_len: int, n_rows, out, zero: bool,
           extra: tuple = ()):
    """Run one wire pack entry on `mates`, a (buffer, starts, ends) per
    mate; the entries take them in that order, then the record count."""
    nrec = len(mates[0][1])
    R = n_rows if n_rows is not None else nrec
    if R < nrec or any(len(o) != nrec for _, s, e in mates for o in (s, e)):
        raise ValueError(f"{fn.__name__}: output rows/offsets mismatch")
    packed2, vbits, lengths = _wire_out(R, nrec, max_len, out, zero)
    if nrec:
        args = [a for buf, s, e in mates
                for a in (np.ascontiguousarray(buf),
                          np.ascontiguousarray(s, np.int64),
                          np.ascontiguousarray(e, np.int64))]
        fn(*args, nrec, packed2, vbits, wire_shape(max_len)[0] * 4, max_len,
           lengths, *extra)
    return packed2, vbits, lengths


def pack_block2(buf: np.ndarray, seq_s, seq_e, max_len: int,
                n_rows: int | None = None, out=None, threads: int = 0):
    """Pack records straight into the device wire format.

    Returns (packed2 uint8 [R, Lp/4], vbits uint8 [R, Lp/8],
    lengths int64 [R]) with Lp = max_len rounded up to a multiple of 8;
    padding rows/positions have all-zero validity bits.  Bit-identical
    to pack_block + codec.pack_codes and to `pack_block2_plain`, one
    native sweep of eight bases a step.  `out`: the three arrays to
    write (a ring slot's pinned buffers), else new ones; only the
    padding rows are zeroed here.  `threads` as `pack_team`."""
    return _pack2(_lib().pack_block2, ((buf, seq_s, seq_e),), max_len,
                  n_rows, out, False, (threads,))


def pack_block2_plain(buf: np.ndarray, seq_s, seq_e, max_len: int,
                      n_rows: int | None = None):
    """`pack_block2`'s bytes one base a step into zeroed rows, the plain
    version it is held to (tests, chip_smoke.py, the host scripts)."""
    return _pack2(_lib().pack_block2_plain, ((buf, seq_s, seq_e),),
                  max_len, n_rows, None, True)


def pack_block2_paired(buf1: np.ndarray, s1, e1, buf2: np.ndarray, s2, e2,
                       max_len: int, n_rows: int | None = None, out=None,
                       threads: int = 0):
    """Fused paired-end wire packing: mate1 + joining invalid + mate2
    straight into (packed2, vbits, lengths) — the native replacement
    for the pack + numpy shift-merge + re-pack detour (reference
    mergePairedFiles parity, src/file.cc:205-268).  `out` and `threads`
    as `pack_block2`."""
    return _pack2(_lib().pack_block2_paired, ((buf1, s1, e1), (buf2, s2, e2)),
                  max_len, n_rows, out, False, (threads,))


def pack_block2_paired_plain(buf1: np.ndarray, s1, e1, buf2: np.ndarray,
                             s2, e2, max_len: int,
                             n_rows: int | None = None):
    """`pack_block2_paired`'s plain version."""
    return _pack2(_lib().pack_block2_paired_plain,
                  ((buf1, s1, e1), (buf2, s2, e2)), max_len, n_rows, None,
                  True)


def _as_u8(seq) -> np.ndarray:
    buf = (np.frombuffer(seq, np.uint8)
           if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, np.uint8))
    return np.ascontiguousarray(buf)


def extract_canonical(seq: bytes | np.ndarray, k: int) -> np.ndarray:
    """Every overlapping canonical k-mer (full-mode build walk)."""
    lib = _lib()
    buf = _as_u8(seq)
    cap = lib.kmer_bound(len(buf), k, 1)
    out = np.empty(max(cap, 1), np.uint64)
    cnt = lib.extract_canonical(buf, len(buf), k, out)
    return out[:cnt]


def extract_canonical_light(seq: bytes | np.ndarray, k: int, gap: int,
                            iter0: int = 0):
    """Non-overlapping light-mode walk; returns (kmers, iter)."""
    lib = _lib()
    buf = _as_u8(seq)
    cap = lib.kmer_bound(len(buf), k, 1) // k + 2
    out = np.empty(max(cap, 1), np.uint64)
    it = ctypes.c_int64(iter0)
    cnt = lib.extract_canonical_light(buf, len(buf), k, gap,
                                      ctypes.byref(it), out)
    return out[:cnt], it.value


def pack_target_names(target_names) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate target names into (bytes, offsets) for format_rows."""
    blobs = [n.encode("ascii", "replace") for n in target_names]
    offs = np.zeros(len(blobs) + 1, np.int64)
    offs[1:] = np.cumsum([len(b) for b in blobs])
    return np.frombuffer(b"".join(blobs), np.uint8).copy(), offs


def _row_args(norm, gamma, ibest, best, isecond, second, conf, buf,
              name_s, name_e, tname_bytes, tname_off):
    """The row fields as the C entries take them (contiguous, typed)."""
    return (np.ascontiguousarray(norm, np.int64),
            np.ascontiguousarray(gamma, np.float64),
            np.ascontiguousarray(ibest, np.int32),
            np.ascontiguousarray(best, np.int32),
            np.ascontiguousarray(isecond, np.int32),
            np.ascontiguousarray(second, np.int32),
            np.ascontiguousarray(conf, np.float64),
            np.ascontiguousarray(buf, np.uint8),
            np.ascontiguousarray(name_s, np.int64),
            np.ascontiguousarray(name_e, np.int64),
            np.ascontiguousarray(tname_bytes, np.uint8),
            np.ascontiguousarray(tname_off, np.int64))


def _row_cap(n: int, n_targets: int, tname_off) -> int:
    """Bytes that hold n rows by the C entries' room check: at most 39
    name bytes, 12 a count column, 160 and the two target names."""
    max_tl = int(np.diff(tname_off).max(initial=0))
    return n * (39 + 12 * (n_targets + 1) + 160 + 2 * max_tl) + 64


def _format(fn, lead: tuple, n_targets: int, fields: tuple,
            extra: tuple = ()) -> np.ndarray:
    """Run one formatter (leading arguments `lead`, n = lead[0]; the
    `_row_args` fields) into an uninitialised buffer; a view of the
    bytes it wrote."""
    cap = _row_cap(lead[0], n_targets, fields[-1])
    out = np.empty(cap, np.uint8)
    w = fn(*lead, *fields, out, cap, *extra)
    if w < 0:
        raise RuntimeError(f"{fn.__name__} buffer overflow")
    return out[:w]


def format_team(n: int, threads: int = 0) -> int:
    """Threads `format_rows` runs n rows on: `threads` when > 0, else
    one below 4,096 rows and, from there up, the OpenMP team less the
    pack's half (`pack_team`; at least one, at most 16)."""
    return int(_lib().format_rows_team(n, threads))


def format_rows(norm, gamma, ibest, best, isecond, second, conf,
                buf, name_s, name_e, tname_bytes, tname_off,
                threads: int = 0) -> tuple[np.ndarray, int]:
    """CLARK CSV rows for one batch through the native row writer
    (`format_rows` in host_ops.cpp, no printf): (a uint8 view of the
    rows, for `f.write`; the count of gamma and confidence values it
    handed to snprintf, those outside the magnitudes its exact rounding
    covers).  The bytes equal `format_rows_printf`'s.  `threads`: the
    team, 0 = one thread below 4,096 rows, else `format_team`'s."""
    n_printf = ctypes.c_int64(0)
    rows = _format(_lib().format_rows, (len(norm),), 0,
                   _row_args(norm, gamma, ibest, best, isecond, second,
                             conf, buf, name_s, name_e, tname_bytes,
                             tname_off),
                   (threads, ctypes.byref(n_printf)))
    return rows, n_printf.value


def format_rows_printf(norm, gamma, ibest, best, isecond, second, conf,
                       buf, name_s, name_e, tname_bytes,
                       tname_off) -> np.ndarray:
    """`format_rows`' rows through the one-snprintf-a-row formatter, the
    plain version it is held to (tests, chip_smoke.py)."""
    return _format(_lib().format_rows_printf, (len(norm),), 0,
                   _row_args(norm, gamma, ibest, best, isecond, second,
                             conf, buf, name_s, name_e, tname_bytes,
                             tname_off))


def _ext_lead(counts, n: int) -> tuple:
    """(n, n_targets, counts) of the extended entries."""
    counts = np.ascontiguousarray(counts, np.uint32)
    return n, (counts.shape[1] if counts.ndim == 2 else 0), counts


def format_rows_ext(counts, norm, gamma, ibest, best, isecond, second,
                    conf, buf, name_s, name_e, tname_bytes, tname_off,
                    threads: int = 0) -> tuple[np.ndarray, int]:
    """Extended-mode CSV rows: dense per-target count columns between
    the name and Length (reference --extended), through the row writer;
    returns and `threads` as `format_rows` (one thread while rows x
    (targets + 8) < 65,536)."""
    lead = _ext_lead(counts, len(norm))
    n_printf = ctypes.c_int64(0)
    rows = _format(_lib().format_rows_ext, lead, lead[1],
                   _row_args(norm, gamma, ibest, best, isecond, second,
                             conf, buf, name_s, name_e, tname_bytes,
                             tname_off),
                   (threads, ctypes.byref(n_printf)))
    return rows, n_printf.value


def format_rows_ext_printf(counts, norm, gamma, ibest, best, isecond,
                           second, conf, buf, name_s, name_e, tname_bytes,
                           tname_off) -> np.ndarray:
    """`format_rows_ext`' rows through snprintf, its plain version."""
    lead = _ext_lead(counts, len(norm))
    return _format(_lib().format_rows_ext_printf, lead, lead[1],
                   _row_args(norm, gamma, ibest, best, isecond, second,
                             conf, buf, name_s, name_e, tname_bytes,
                             tname_off))


def _result_args(results, lengths, k: int, paired: bool, buf, name_s,
                 name_e, tname_bytes, tname_off) -> tuple:
    """The results entries' arguments after n (contiguous, typed,
    checked: results [n, 5], n lengths and names)."""
    results = np.ascontiguousarray(results, np.int32)
    n = len(results)
    if results.ndim != 2 or results.shape[1] != 5:
        raise ValueError(f"results {results.shape} is not [n, 5]")
    if not len(lengths) == len(name_s) == len(name_e) == n:
        raise ValueError(f"{n} results rows, {len(lengths)} lengths, "
                         f"{len(name_s)}/{len(name_e)} names")
    return (results, np.ascontiguousarray(lengths, np.int64), int(k),
            int(bool(paired)), np.ascontiguousarray(buf, np.uint8),
            np.ascontiguousarray(name_s, np.int64),
            np.ascontiguousarray(name_e, np.int64),
            np.ascontiguousarray(tname_bytes, np.uint8),
            np.ascontiguousarray(tname_off, np.int64))


def format_results(results, lengths, k: int, paired: bool, buf, name_s,
                   name_e, tname_bytes, tname_off,
                   threads: int = 0) -> tuple[np.ndarray, int]:
    """A batch's CSV rows straight from the card's results rows (int32
    [n, 5]: total, best index, best, second index, second) and the
    reads' lengths: `format_rows`' rows of `score.gamma_confidence`'s
    norm, gamma and confidence, which the row writer computes itself,
    row by row on its team, bit for bit as numpy does.  Returns and
    `threads` as `format_rows`."""
    n_printf = ctypes.c_int64(0)
    rows = _format(_lib().format_results, (len(results),), 0,
                   _result_args(results, lengths, k, paired, buf, name_s,
                                name_e, tname_bytes, tname_off),
                   (threads, ctypes.byref(n_printf)))
    return rows, n_printf.value


def format_results_ext(counts, results, lengths, k: int, paired: bool, buf,
                       name_s, name_e, tname_bytes, tname_off,
                       threads: int = 0) -> tuple[np.ndarray, int]:
    """`format_rows_ext`' rows from results rows, as `format_results`;
    `counts` the dense count columns."""
    lead = _ext_lead(counts, len(results))
    n_printf = ctypes.c_int64(0)
    rows = _format(_lib().format_results_ext, lead, lead[1],
                   _result_args(results, lengths, k, paired, buf, name_s,
                                name_e, tname_bytes, tname_off),
                   (threads, ctypes.byref(n_printf)))
    return rows, n_printf.value


def spill_partition(kmers: np.ndarray, labels: np.ndarray,
                    counts: np.ndarray | None, shift: int, nshards: int):
    """Order occurrence records by k-mer-range shard in one native
    count+scatter pass.  Returns (records u64 [n, 2] = {km,
    (lb<<32)|ct} grouped by shard, bounds int64 [nshards+1])."""
    lib = _lib()
    n = len(kmers)
    out = np.empty((n, 2), np.uint64)
    bounds = np.empty(nshards + 1, np.int64)
    has_ct = counts is not None
    ct = (np.ascontiguousarray(counts, np.uint32) if has_ct
          else np.empty(1, np.uint32))
    lib.spill_partition(
        np.ascontiguousarray(kmers, np.uint64),
        np.ascontiguousarray(labels, np.uint32), ct,
        1 if has_ct else 0, n, shift, nshards, out.reshape(-1), bounds)
    return out, bounds


def reduce_occurrences(kmers: np.ndarray, labels: np.ndarray,
                       counts: np.ndarray | None, min_count: int):
    """Sort-reduce (kmer, label, count) occurrences to target-specific
    k-mers (RemoveCommon multiplicity==1 semantics) via the native
    radix sort — the hot path of the DB build.  counts None = 1 each.

    Returns (kmers u64 ascending, labels u32, counts u32)."""
    lib = _lib()
    n = len(kmers)
    if n == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.uint32),
                np.empty(0, np.uint32))
    kmers = np.ascontiguousarray(kmers, np.uint64)
    key_bits = int(int(kmers.max()).bit_length())
    A = np.empty(2 * n, np.uint64)
    B = np.empty(2 * n, np.uint64)
    out_km = np.empty(n, np.uint64)
    out_lb = np.empty(n, np.uint32)
    out_ct = np.empty(n, np.uint32)
    has_ct = counts is not None
    ct = (np.ascontiguousarray(counts, np.uint32) if has_ct
          else np.empty(1, np.uint32))
    m = lib.reduce_occurrences(
        kmers, np.ascontiguousarray(labels, np.uint32), ct,
        1 if has_ct else 0, n, key_bits, min_count,
        A, B, out_km, out_lb, out_ct)
    # in-place shrink (realloc) instead of slicing, which would either
    # copy or pin the full n-sized buffers alive via views
    for a in (out_km, out_lb, out_ct):
        a.resize(m, refcheck=False)
    return out_km, out_lb, out_ct


def build_q4(kmers: np.ndarray, labels: np.ndarray, nb_bits: int,
             seed_consts: tuple[int, int, int], max_kicks: int = 500,
             stash_bits: int = 0):
    """q4/qs-layout table build (C++ Feistel + cuckoo insert loop).

    stash_bits == 0 builds classic q4 ([NB, 8]); stash_bits > 0 builds
    the qs layout with choice-1 buckets in a stash section appended
    below the main rows ([NB + NBS, 8]).  Returns the uint32 table, or
    None on overflow (caller reseeds / grows)."""
    lib = _lib()
    rows = (1 << nb_bits) + ((1 << stash_bits) if stash_bits else 0)
    table = np.zeros((rows, 8), dtype=np.uint32)
    occ = np.zeros(rows, dtype=np.uint8)
    c1, c2, c3 = seed_consts
    rc = lib.build_q4(
        np.ascontiguousarray(kmers, np.uint64),
        np.ascontiguousarray(labels, np.uint32),
        len(kmers), nb_bits, stash_bits, c1, c2, c3, table, occ, max_kicks,
    )
    if rc != 0:
        return None
    return table


def csv_tally(buf: np.ndarray, ncols: int, col_assign: int,
              col_conf: int, col_gamma: int,
              min_conf: float, min_gamma: float,
              max_names: int = 1 << 20, offset0: int = 0):
    """One-pass abundance tally over result-CSV bytes (header already
    stripped): per-assignment counts with the low-confidence/low-gamma
    -> NA filter applied natively.  Returns (names list with names[0]
    == 'NA', counts int64 [len(names)], total_rows).

    Raises ValueError on a malformed row (wrong field count, or an
    unparseable value in a filtered column); offset0 is added to the
    reported byte position so it points into the FILE, not the
    header-stripped body."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    counts = np.zeros(max_names, np.int64)
    # blob scales with max_names: long accession-style names must not
    # exhaust the byte budget before the name-count budget
    names_cap = max(4 << 20, 64 * max_names)
    names = np.empty(names_cap, np.uint8)
    name_off = np.zeros(max_names + 1, np.int64)
    total = ctypes.c_int64(0)
    r = lib.csv_tally(buf, len(buf), ncols, col_assign, col_conf,
                      col_gamma, min_conf, min_gamma, counts, max_names,
                      names, names_cap, name_off, ctypes.byref(total))
    if r == -(len(buf) + 2):
        raise ValueError("csv_tally: too many distinct assignment names")
    if r < 0:
        raise ValueError(
            f"malformed result CSV row at byte {-r - 1 + offset0}")
    # slice BEFORE tobytes: only the used prefix (KBs) copies, not the
    # whole scratch blob (64 MB at the default max_names)
    blob = names[:int(name_off[r])].tobytes()
    out_names = [blob[name_off[i]:name_off[i + 1]].decode("utf-8",
                                                          "replace")
                 for i in range(r)]
    return out_names, counts[:r], total.value


def count_lines(buf: np.ndarray) -> int:
    """Number of '\\n' bytes (one native memchr pass)."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    return int(lib.count_lines(buf, len(buf)))


def csv_values(buf: np.ndarray, ncols: int, col_val: int,
               col_assign: int, offset0: int = 0) -> np.ndarray:
    """Float column col_val of every assigned (non-NA) row of result-CSV
    bytes (header stripped) — the density histogram input."""
    lib = _lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    cap = lib.count_lines(buf, len(buf)) + 1
    out = np.empty(cap, np.float64)
    r = lib.csv_values(buf, len(buf), ncols, col_val, col_assign, out,
                       cap)
    if r == -(len(buf) + 2):
        raise ValueError("csv_values: bad column arguments or row "
                         "capacity exceeded")
    if r < 0:
        raise ValueError(
            f"malformed result CSV row at byte {-r - 1 + offset0}")
    out.resize(r, refcheck=False)
    return out


def build_cuckoo(kmers: np.ndarray, labels: np.ndarray, nb_bits: int,
                 slots: int, num_choices: int, max_kicks: int = 500):
    """Two-choice cuckoo table build (C++ insert loop).

    Returns (keys_lo, keys_hi, labs) as [NB, S] uint32 arrays, or None
    on overflow (caller grows the table)."""
    lib = _lib()
    nb = 1 << nb_bits
    keys_lo = np.full((nb, slots), 0xFFFFFFFF, dtype=np.uint32)
    keys_hi = np.full((nb, slots), 0xFFFFFFFF, dtype=np.uint32)
    labs = np.zeros((nb, slots), dtype=np.uint32)
    occ = np.zeros(nb, dtype=np.uint8)
    rc = lib.build_cuckoo(
        np.ascontiguousarray(kmers, np.uint64),
        np.ascontiguousarray(labels, np.uint32),
        len(kmers), nb_bits, slots, num_choices,
        keys_lo, keys_hi, labs, occ, max_kicks,
    )
    if rc != 0:
        return None
    return keys_lo, keys_hi, labs


class InflateRefused(ValueError):
    """`inflate` refused its input: the reference's reader rejects it
    too, and its error says why (`pipeline._inflate_plain`)."""


_INFLATE_REASONS = {-1: "a member header", -2: "deflate data",
                    -3: "the input ended inside a member",
                    -4: "a CRC32", -5: "a length (ISIZE)",
                    -7: "no memory"}
_INFLATE_KEYS = ("team", "chunks", "joined", "redone", "marker_bytes",
                 "members", "bgzf_members", "waves")
_INFLATE_LAST: dict = {}


def inflate_team(n: int, threads: int = 0) -> int:
    """Threads `inflate` runs an n-byte gzip input on: `threads` when
    > 0, else one below 1 MiB and the OpenMP team (OMP_NUM_THREADS, else
    every core) from there up."""
    return int(_lib().inflate_team(n, threads))


def inflate_counters() -> dict:
    """The last `inflate`/`inflate_check` call's counters: team;
    chunks (speculative chunks after joins); joined (chunks where no
    block start was found, joined to the one before); redone (chunks
    decoded again after a wrong guess or past their output cap);
    marker_bytes (bytes decoded as 16-bit symbols, before their window
    was known); members; bgzf_members (inflated a member a thread);
    waves (rounds of one chunk a thread)."""
    return dict(_INFLATE_LAST)


class _Pages:
    """The anonymous mapping `gz_inflate` returned, read-only through
    numpy's array interface and unmapped with the last array over it."""

    def __init__(self, lib, base: int, n: int, cap: int):
        self._free = (lib.gz_free, base, cap)
        self.__array_interface__ = {"shape": (n,), "typestr": "|u1",
                                    "data": (base, True), "version": 3}

    def __del__(self):
        free, base, cap = self._free
        free(base, cap)


def _gz_inflate(data, threads: int, chunk: int, flags: int):
    global _INFLATE_LAST
    lib = _lib()
    a = np.ascontiguousarray(np.frombuffer(data, np.uint8)
                             if isinstance(data, (bytes, bytearray))
                             else data, np.uint8)
    base, n, cap = ctypes.c_void_p(), ctypes.c_int64(), ctypes.c_int64()
    stats = np.zeros(len(_INFLATE_KEYS), np.int64)
    rc = lib.gz_inflate(a, len(a), threads, chunk, flags,
                        ctypes.byref(base), ctypes.byref(n),
                        ctypes.byref(cap), stats)
    _INFLATE_LAST = dict(zip(_INFLATE_KEYS, map(int, stats)))
    if rc:
        raise InflateRefused(f"gzip input refused at "
                             f"{_INFLATE_REASONS.get(rc, rc)}")
    return lib, base.value, n.value, cap.value


def inflate(data, threads: int = 0, chunk: int = 0) -> np.ndarray:
    """A gzip file's bytes (uint8, read-only), inflated on the OpenMP
    team: the bytes `gzip.GzipFile(fileobj=io.BytesIO(data)).read()`
    gives, every member's CRC32 and ISIZE checked.  `threads` as
    `inflate_team`; `chunk`: compressed bytes a speculative chunk (0:
    from the input and the team; tests force many).  Raises
    InflateRefused on an input that reader rejects."""
    lib, base, n, cap = _gz_inflate(data, threads, chunk, 0)
    return np.asarray(_Pages(lib, base, n, cap))


def inflate_check(data, threads: int = 0, chunk: int = 0) -> int:
    """`inflate` keeping only a 32 KiB window of its output: the length
    it would give, with every check made (an output over memory, as a
    stream of more than 4 GiB, in tests)."""
    lib, base, n, cap = _gz_inflate(data, threads, chunk, 1)
    lib.gz_free(base, cap)
    return n


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC32 of A then B from crc(A), crc(B) and len(B), as zlib's
    crc32_combine (the inflater's, exposed for tests)."""
    return int(_lib().gz_crc32_combine(crc1, crc2, len2))
