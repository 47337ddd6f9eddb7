"""CLARK-family on-disk database interop (.sz/.ky/.lb).

The reference persists its table as three files
(hTable::write, src/hashTable_hh.hh:590-663):

  <base>.sz  HTSIZE uint8 bucket sizes (bucket = kmer % HTSIZE)
  <base>.ky  per bucket, ascending quotient keys (kmer / HTSIZE) in the
             key width picked by k (src/main.cc:278-284:
             k <= log4(HTSIZE)+8 -> u16, <= +16 -> u32, else u64)
  <base>.lb  matching uint16 labels, 0-based target index

Buckets over 255 entries abort in the reference (hashTable_hh.hh:
616-624); we enforce the same.  Labels here are 1-based (0 = NA), so
export subtracts 1 and import adds 1.

This lets a CLARK/CuCLARK installation validate a database built by
this framework (and vice versa) — the cross-implementation oracle the
reference ecosystem relies on (README.md:58-80).

Counterpart of `cuclark_tpu/io/clark_db.py`, carried over unchanged.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

HTSIZE_FULL = 1610612741   # src/parameters.hh:39
HTSIZE_LIGHT = 57777779    # src/parameters_light_hh:40

_CHUNK_BUCKETS = 1 << 24   # .sz streamed in 16M-bucket chunks


def key_dtype(k: int, htsize: int) -> np.dtype:
    """Reference key-width dispatch (src/main.cc:278-284)."""
    t_b = int(math.log(htsize) / math.log(4.0))
    if k <= t_b + 8:
        return np.dtype(np.uint16)
    if k <= t_b + 16:
        return np.dtype(np.uint32)
    return np.dtype(np.uint64)


def export_clark_db(kmers: np.ndarray, labels: np.ndarray, base,
                    k: int, htsize: int = HTSIZE_FULL) -> int:
    """Write <base>.sz/.ky/.lb from canonical k-mers + 1-based labels.

    Returns the number of elements written."""
    base = str(base)
    kmers = np.asarray(kmers, dtype=np.uint64)
    labels = np.asarray(labels, dtype=np.uint32)
    if labels.size and labels.min() < 1:
        raise ValueError("labels must be 1-based (0 = NA is not stored)")
    if labels.size and labels.max() > 65536:
        raise ValueError("CLARK labels are uint16")
    hts = np.uint64(htsize)
    bucket = kmers % hts
    quot = kmers // hts
    kdt = key_dtype(k, htsize)
    if quot.size and int(quot.max()) > np.iinfo(kdt).max:
        raise ValueError(
            f"quotient overflows {kdt} keys: k={k} htsize={htsize}")
    order = np.lexsort((quot, bucket))
    bucket = bucket[order]
    quot = quot[order]
    labs = (labels[order] - 1).astype(np.uint16)

    # validate the 255-entry bucket cap BEFORE writing anything — the
    # reference aborts the same way (hashTable_hh.hh:616-624), but
    # failing after .ky/.lb hit the disk would leave a corrupt partial
    # export behind
    if len(bucket):
        run_starts = np.flatnonzero(np.r_[True, bucket[1:] != bucket[:-1]])
        run_len = np.diff(np.r_[run_starts, len(bucket)])
        if int(run_len.max()) > 255:
            raise ValueError(
                "This table can not be stored on disk: Some bucket "
                "list size exceeds 255.")  # hashTable_hh.hh:616-624

    # tofile() streams without the second whole-array bytes copy that
    # tobytes() would build (~2.4 GB extra at RefSeq scale)
    with open(base + ".ky", "wb") as f:
        quot.astype(kdt).tofile(f)
    with open(base + ".lb", "wb") as f:
        labs.tofile(f)
    with open(base + ".sz", "wb") as f:
        for lo in range(0, htsize, _CHUNK_BUCKETS):
            hi = min(htsize, lo + _CHUNK_BUCKETS)
            a = np.searchsorted(bucket, lo)
            b = np.searchsorted(bucket, hi)
            cnt = np.bincount((bucket[a:b] - lo).astype(np.int64),
                              minlength=hi - lo)
            cnt.astype(np.uint8).tofile(f)
    return len(kmers)


def import_clark_db(base, k: int, htsize: int | None = None):
    """Read <base>.sz/.ky/.lb -> (kmers u64, labels u32 1-based).

    htsize defaults to the .sz file's length (one byte per bucket)."""
    base = str(base)
    sz = np.fromfile(base + ".sz", dtype=np.uint8)
    if htsize is None:
        htsize = len(sz)
    elif len(sz) != htsize:
        raise ValueError(f".sz has {len(sz)} buckets, expected {htsize}")
    kdt = key_dtype(k, htsize)
    quot = np.fromfile(base + ".ky", dtype=kdt).astype(np.uint64)
    labs = np.fromfile(base + ".lb", dtype=np.uint16)
    n = int(sz.sum())
    if len(quot) != n or len(labs) != n:
        raise ValueError(
            f"inconsistent CLARK db: sz says {n} elements, "
            f".ky has {len(quot)}, .lb has {len(labs)}")
    bucket = np.repeat(
        np.flatnonzero(sz).astype(np.uint64), sz[sz > 0].astype(np.int64))
    kmers = bucket + quot * np.uint64(htsize)
    return kmers, labs.astype(np.uint32) + 1
