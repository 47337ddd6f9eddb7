"""k-mer database: the qs, q4 and s2 hash tables, their build and I/O.

Counterpart of `cuclark_tpu/hashdb.py`, carried over as numpy for all
three layouts: `_fmix`, `mix1`/`mix2`, `feistel_seed_consts`,
`feistel_mix`, `KmerDB` (save, load, checksum, items, probe_np, verify),
`probe_np_q4`, `probe_np_qs`, `check_q_bits`, `choose_nb_bits`,
`choose_stash_bits`, `build_table` with `_try_build_qs`,
`_try_build_q4`, `_try_build`/`_try_build_np` and `_cuckoo_place`.  A
port builds, from the same k-mers, a table with the same bytes (the same
`KmerDB.checksum()`), and loads the JAX package's `.npz` files unchanged
(format `cuclark-tpu-db-v1`).

New here: `feistel_mix_torch`, `mix1_torch` and `mix2_torch`, the plain
PyTorch versions of the hashes that the query kernel (`csrc/query.cu`)
computes; `TableSpec` (`KmerDB.spec`), the layout fields a probe reads,
as one record; and `table_to_device`, which places the table on a torch
device as the (main, stash) pair the probe takes.  The port always
probes a qs table in split form; the JAX package's fused/split switch
(`KmerDB.use_split_probe`) only steered XLA's gather and gives identical
labels.

Layouts (rows of uint32; stored labels are 1-based, 0 = "NA" / miss,
matching the reference's result indexing, src/CuClarkDB.cu:1449):

  qs: [NB + NBS, 8] rows = [other x 4 | meta x 4] with meta =
      (quotient15 << 17) | (choice << 16) | label16.  Keys are
      Feistel-mixed so the bucket index pins nb_bits (main) or
      stash_bits (stash) of the mixed key; the choice-0 bucket is
      l2 & (NB-1) among the NB main rows, the choice-1 bucket
      h1 & (NBS-1) among the NBS stash rows appended below them.
  q4: [NB, 8], the qs row format with both choices among the main rows:
      choice 0 at l2 & (NB-1), choice 1 at h1 & (NB-1), both quotients
      against nb_bits.
  s2: [NB, 3 * S] rows = [klo x S | khi x S | label x S] of full 64-bit
      keys, S slots, buckets mix1 & (NB-1) and, with two hash choices,
      mix2 & (NB-1); empty slots hold EMPTY in both key words.
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path

import numpy as np
import torch

from cuclark_tpu_torch.config import DBConfig, MTRGTS

# Empty-slot sentinel of the s2 layout.  An all-ones uint64 can never be
# a canonical k-mer: its reverse complement is 0, which is always smaller.
EMPTY = np.uint32(0xFFFFFFFF)

_M32 = np.uint32
_MASK32 = 0xFFFFFFFF


def _fmix(h):
    """murmur3 fmix32 finalizer (public-domain constant mix)."""
    h = h ^ (h >> _M32(16))
    h = h * _M32(0x85EBCA6B)
    h = h ^ (h >> _M32(13))
    h = h * _M32(0xC2B2AE35)
    h = h ^ (h >> _M32(16))
    return h


def mix1(hi, lo):
    """First s2 bucket hash of a (hi, lo) uint32 k-mer pair -> uint32."""
    return _fmix(lo ^ (hi * _M32(0x9E3779B9)))


def mix2(hi, lo):
    """Second, independent s2 bucket hash."""
    return _fmix(hi ^ (lo * _M32(0x85EBCA6B)) ^ _M32(0x5BD1E995))


def feistel_seed_consts(seed: int):
    """Three u32 round constants derived from a build seed (host-side)."""
    s = np.uint32(seed & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        c1 = _fmix(s * _M32(2) + _M32(0x9E3779B9))
        c2 = _fmix(s * _M32(2) + _M32(0x85EBCA6B))
        c3 = _fmix(s * _M32(2) + _M32(0xC2B2AE35))
    return int(c1), int(c2), int(c3)


def feistel_mix(hi, lo, seed: int = 0):
    """Invertible 3-round Feistel mix of a (hi, lo) u32 k-mer pair.

    The q layouts store only the bits of the mixed key that the bucket
    index does not already pin (quotienting — the same storage-saving
    idea as the reference's kmer/HTSIZE quotient-remainder split,
    src/dataType.hh IKMER + src/CuClarkDB.cu:1264-1274, redone as a
    bijection so 64-bit exactness survives).  numpy u32 wraparound
    arithmetic.  Returns (h1, l2): bucket1 = l2 & mask, bucket2 =
    h1 & mask."""
    c1, c2, c3 = feistel_seed_consts(seed)
    with np.errstate(over="ignore"):  # u32 wrap is the point
        l1 = lo ^ _fmix(hi + _M32(c1))
        h1 = hi ^ _fmix(l1 + _M32(c2))
        l2 = l1 ^ _fmix(h1 + _M32(c3))
    return h1, l2


def _fmix_torch(h: torch.Tensor) -> torch.Tensor:
    """_fmix on u32 values held in int64 (products wrap in int64 and
    keep their low 32 bits exact)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def feistel_mix_torch(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0):
    """feistel_mix on int64 tensors holding u32 values -> (h1, l2), the
    plain version of the query kernel's Feistel step."""
    c1, c2, c3 = feistel_seed_consts(seed)
    l1 = lo ^ _fmix_torch((hi + c1) & _MASK32)
    h1 = hi ^ _fmix_torch((l1 + c2) & _MASK32)
    l2 = l1 ^ _fmix_torch((h1 + c3) & _MASK32)
    return h1, l2


def mix1_torch(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """mix1 on int64 tensors holding u32 values: the plain version of
    the s2 query kernel's first bucket hash."""
    return _fmix_torch(lo ^ ((hi * 0x9E3779B9) & _MASK32))


def mix2_torch(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """mix2 on int64 tensors holding u32 values."""
    return _fmix_torch(hi ^ ((lo * 0x85EBCA6B) & _MASK32) ^ 0x5BD1E995)


def _split64(kmers: np.ndarray):
    kmers = np.asarray(kmers, dtype=np.uint64)
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """The fields of a table's layout that a probe reads besides its
    rows (built from a database by `KmerDB.spec`): the layout, its
    bucket bits, the qs stash bits, the Feistel seed (qs, q4), and the
    s2 slots and hash choices."""

    layout: str
    nb_bits: int
    stash_bits: int = 0
    seed: int = 0
    slots: int = 4
    num_choices: int = 2

    @property
    def row_words(self) -> int:
        """u32 words per table row: 8 (qs, q4) or 3 * slots (s2)."""
        return 3 * self.slots if self.layout == "s2" else 8

    def check(self) -> None:
        """Raise ValueError on a layout the probes do not take."""
        if self.layout not in ("qs", "q4", "s2"):
            raise ValueError(f"unknown table layout {self.layout!r}")
        check_q_bits(self.layout, self.nb_bits, self.stash_bits)
        if self.layout == "s2" and not (1 <= self.slots <= 255
                                        and self.num_choices in (1, 2)):
            raise ValueError(f"s2 needs 1 <= slots <= 255 and 1 or 2 hash "
                             f"choices, got slots={self.slots} "
                             f"num_choices={self.num_choices}")


@dataclasses.dataclass
class KmerDB:
    """An immutable, device-loadable k-mer database in one of three
    layouts (see the module docstring): "qs" (requires 17 <= stash_bits
    <= nb_bits), "q4" (17 <= nb_bits) or "s2"."""

    k: int
    slots: int
    num_choices: int
    nb_bits: int                 # NB = 1 << nb_bits main buckets
    target_names: list[str]      # index 0 == "NA", 1..T real targets
    table: np.ndarray            # u32 [NB(+NBS), 8] / [NB, 3*slots] (s2)
    num_kmers: int
    gap: int = 1                 # build-time k-mer stride used
    layout: str = "s2"
    seed: int = 0                # q4/qs Feistel seed
    stash_bits: int = 0          # qs: NBS = 1 << stash_bits stash rows

    @property
    def nb(self) -> int:
        return 1 << self.nb_bits

    @property
    def total_rows(self) -> int:
        """All gatherable bucket rows (main + stash)."""
        return self.table.shape[0]

    @property
    def spec(self) -> TableSpec:
        """The layout fields the probes read, as one record."""
        return TableSpec(self.layout, self.nb_bits, self.stash_bits,
                         self.seed, self.slots, self.num_choices)

    def split_tables(self) -> tuple[np.ndarray, np.ndarray | None]:
        """(main, stash) host views: rows [0, NB) and [NB, NB + NBS) of
        a qs table; (table, None) for q4 and s2, which have no stash."""
        if self.layout != "qs":
            return self.table, None
        return self.table[:self.nb], self.table[self.nb:]

    @property
    def num_targets(self) -> int:
        return len(self.target_names) - 1

    # ---------- persistence ----------

    # Above this, save uncompressed: zlib on table bytes costs more time
    # than the disk it saves (ratio < 1.5x on random keys).  np.load
    # reads both forms.
    COMPRESS_MAX_BYTES = int(1.5e9)

    def save(self, path: str | Path) -> None:
        meta = {
            "format": "cuclark-tpu-db-v1",
            "k": self.k,
            "slots": self.slots,
            "num_choices": self.num_choices,
            "nb_bits": self.nb_bits,
            "num_kmers": self.num_kmers,
            "gap": self.gap,
            "layout": self.layout,
            "seed": self.seed,
            "stash_bits": self.stash_bits,
            "target_names": self.target_names,
        }
        saver = (np.savez_compressed
                 if self.table.nbytes <= self.COMPRESS_MAX_BYTES
                 else np.savez)
        saver(
            path,
            table=self.table,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path: str | Path, sample_factor: int = 1) -> "KmerDB":
        """Load a DB; sample_factor s keeps every s-th bucket only
        (query-time subsampling, the analog of the reference -s flag,
        src/CuClarkDB.cu:508-524)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            table = z["table"]
        if meta.get("format") != "cuclark-tpu-db-v1":
            raise ValueError(f"not a cuclark-tpu database: {path}")
        db = cls(
            k=meta["k"],
            slots=meta["slots"],
            num_choices=meta["num_choices"],
            nb_bits=meta["nb_bits"],
            target_names=list(meta["target_names"]),
            table=table,
            num_kmers=meta["num_kmers"],
            gap=meta.get("gap", 1),
            layout=meta.get("layout", "s2"),
            seed=meta.get("seed", 0),
            stash_bits=meta.get("stash_bits", 0),
        )
        if sample_factor > 1:
            keep = (np.arange(db.total_rows) % sample_factor) == 0
            # in place: np.load already materialized a fresh writable
            # array — a .copy() would transiently DOUBLE peak RAM on a
            # multi-GB table just to zero rows
            # q4/qs empty slots are all-zero (label 0); s2 uses EMPTY
            db.table[~keep] = 0 if db.layout in ("q4", "qs") else EMPTY
        return db

    def checksum(self) -> int:
        return zlib.crc32(self.table.tobytes())

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """Recover every stored (canonical k-mer, label) pair.

        s2 rows store full keys; q4/qs entries reconstruct (h1, l2) from
        (bucket, other, quotient, choice) and run the Feistel backwards
        (it is a bijection)."""
        if self.layout in ("q4", "qs"):
            rows = self.total_rows
            other = self.table[:, :4].ravel()
            meta = self.table[:, 4:].ravel()
            lab = (meta & _M32(0xFFFF)).astype(np.uint32)
            keep = lab > 0
            other, meta, lab = other[keep], meta[keep], lab[keep]
            bidx = np.repeat(np.arange(rows, dtype=np.uint32), 4)[keep]
            q = meta >> _M32(17)
            choice = (meta >> _M32(16)) & _M32(1)
            if self.layout == "qs":
                # stash rows sit at [NB, NB+NBS); their bucket pins
                # stash_bits of h1, main rows pin nb_bits of l2
                local = np.where(choice == 0, bidx, bidx - _M32(self.nb))
                own = np.where(
                    choice == 0,
                    (q << _M32(self.nb_bits)) | local,
                    (q << _M32(self.stash_bits)) | local)
            else:
                own = (q << _M32(self.nb_bits)) | bidx
            h1 = np.where(choice == 0, other, own)
            l2 = np.where(choice == 0, own, other)
            # inverse 3-round Feistel (forward fmix only)
            c1, c2, c3 = feistel_seed_consts(self.seed)
            with np.errstate(over="ignore"):
                l1 = l2 ^ _fmix(h1 + _M32(c3))
                hi = h1 ^ _fmix(l1 + _M32(c2))
                lo = l1 ^ _fmix(hi + _M32(c1))
            kmers = ((hi.astype(np.uint64) << np.uint64(32))
                     | lo.astype(np.uint64))
            return kmers, lab
        S = self.slots
        klo = self.table[:, :S].ravel()
        khi = self.table[:, S:2 * S].ravel()
        lab = self.table[:, 2 * S:].ravel().astype(np.uint32)
        keep = (klo != EMPTY) | (khi != EMPTY)
        kmers = ((khi[keep].astype(np.uint64) << np.uint64(32))
                 | klo[keep].astype(np.uint64))
        return kmers, lab[keep]

    # ---------- host-side probe / self-check ----------

    def probe_np(self, kmers: np.ndarray) -> np.ndarray:
        """Pure-numpy probe (debug/verification twin of the device
        probe)."""
        hi, lo = _split64(np.asarray(kmers, dtype=np.uint64))
        if self.layout == "qs":
            return probe_np_qs(self.table, self.nb_bits, self.stash_bits,
                               self.seed, hi, lo)
        if self.layout == "q4":
            return probe_np_q4(self.table, self.nb_bits, self.seed, hi, lo)
        mask = _M32(self.nb - 1)
        S = self.slots
        label = np.zeros(len(hi), dtype=np.int32)
        with np.errstate(over="ignore"):
            b1 = mix1(hi, lo) & mask
            for choice in range(self.num_choices):
                b = b1 if choice == 0 else (mix2(hi, lo) & mask)
                rows = self.table[b.astype(np.int64)]
                m = ((rows[:, :S] == lo[:, None])
                     & (rows[:, S:2 * S] == hi[:, None]))
                if choice == 1:
                    m &= (b != b1)[:, None]
                label += np.where(m, rows[:, 2 * S:].astype(np.int32),
                                  0).sum(axis=1)
        return label

    def verify(self, kmers: np.ndarray, labels: np.ndarray,
               sample: int | None = 100_000) -> None:
        """Build self-check: every stored k-mer must probe back to its
        label (the role of the reference's write-time asserts,
        src/hashTable_hh.hh:616-629).  Raises on mismatch."""
        n = len(kmers)
        if sample is not None and n > sample:
            idx = np.random.default_rng(0).choice(n, sample, replace=False)
            kmers, labels = kmers[idx], labels[idx]
        got = self.probe_np(kmers)
        bad = got != np.asarray(labels, dtype=np.int32)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise AssertionError(
                f"DB self-check failed: kmer {kmers[i]:#x} -> {got[i]} "
                f"(want {labels[i]}); {int(bad.sum())}/{len(kmers)} bad")


def table_to_device(db: KmerDB, device
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(main, stash) of a table on `device`, the uint32 rows viewed as
    int32 with the bit pattern unchanged: int32 [NB, 8] and [NBS, 8] for
    qs; (int32 [NB, 8], None) for q4 and (int32 [NB, 3 * slots], None)
    for s2.  On the CPU they share memory with `db.table`."""
    db.spec.check()
    return tuple(
        None if t is None else
        torch.from_numpy(np.ascontiguousarray(t).view(np.int32)).to(device)
        for t in db.split_tables())


def probe_np_q4(table, nb_bits: int, seed: int, hi, lo) -> np.ndarray:
    """Numpy q4 probe: Feistel-mix, gather both choice rows, exact
    64-bit reconstruct-compare."""
    mask = _M32((1 << nb_bits) - 1)
    h1, l2 = feistel_mix(hi, lo, seed)
    b1 = (l2 & mask).astype(np.int64)
    b2 = (h1 & mask).astype(np.int64)
    nbb = _M32(nb_bits)
    label = np.zeros(len(h1), dtype=np.int32)
    for choice, b, own, other in ((0, b1, l2, h1), (1, b2, h1, l2)):
        rows = table[b]
        meta = rows[:, 4:]
        m = ((rows[:, :4] == other[:, None])
             & ((meta >> _M32(17)) == (own >> nbb)[:, None])
             & (((meta >> _M32(16)) & _M32(1)) == choice))
        label += np.where(m, (meta & _M32(0xFFFF)).astype(np.int32),
                          0).sum(axis=1)
    return label


def probe_np_qs(table, nb_bits: int, stash_bits: int, seed: int,
                hi, lo) -> np.ndarray:
    """Numpy qs probe: Feistel-mix, gather the main-choice row and the
    stash row, exact 64-bit reconstruct-compare (verification twin of
    the device probe)."""
    mask = _M32((1 << nb_bits) - 1)
    smask = _M32((1 << stash_bits) - 1)
    nb = 1 << nb_bits
    h1, l2 = feistel_mix(hi, lo, seed)
    label = np.zeros(len(h1), dtype=np.int32)
    for choice, own, b, bits in (
            (0, l2, (l2 & mask).astype(np.int64), nb_bits),
            (1, h1, nb + (h1 & smask).astype(np.int64), stash_bits)):
        other = h1 if choice == 0 else l2
        rows = table[b]
        meta = rows[:, 4:]
        m = ((rows[:, :4] == other[:, None])
             & ((meta >> _M32(17)) == (own >> _M32(bits))[:, None])
             & (((meta >> _M32(16)) & _M32(1)) == choice))
        label += np.where(m, (meta & _M32(0xFFFF)).astype(np.int32),
                          0).sum(axis=1)
    return label


# The reference package computes q4/qs row indices in int32 on device,
# so NB + NBS must stay below 2^31.  The query kernel here uses 64-bit
# row offsets, but keeps the same limit so both packages accept the
# same databases.
MAX_NB_BITS_Q = 30


def check_q_bits(layout: str, nb_bits: int,
                 stash_bits: int | None = None) -> None:
    """Reject q4/qs geometries whose global row indices overflow int32
    (gathers would silently wrap negative and probe wrong rows).

    stash_bits None = not chosen yet (build-time nb_bits-only check).
    A concrete qs stash_bits below 17 — INCLUDING 0, the dataclass
    default a hand-built or meta-corrupted artifact could carry — is
    rejected: stash quotients would silently truncate into the 15-bit
    meta field and every stash entry would miss."""
    if layout not in ("q4", "qs"):
        if nb_bits > 31:
            # s2 bucket indices are also int32 on device
            raise ValueError(
                f"{layout} layout supports nb_bits <= 31 (got "
                f"{nb_bits}): bucket indices are int32 on device")
        return
    if nb_bits < 17 or (layout == "qs" and stash_bits is not None
                        and stash_bits < 17):
        # the 15-bit quotient field requires 32 - bits <= 15
        raise ValueError(
            f"{layout} layout requires nb_bits >= 17 (and stash_bits "
            f">= 17): got nb_bits={nb_bits} stash_bits={stash_bits}")
    if nb_bits > MAX_NB_BITS_Q:
        raise ValueError(
            f"{layout} layout supports nb_bits <= {MAX_NB_BITS_Q} "
            f"(got {nb_bits}): row indices are int32 on device. "
            f"Shard the table over a db mesh axis instead.")
    if (layout == "qs" and stash_bits is not None
            and (1 << nb_bits) + (1 << stash_bits) > 2 ** 31 - 1):
        raise ValueError(
            f"qs stash rows overflow int32 indexing: nb_bits={nb_bits} "
            f"stash_bits={stash_bits}")


# Largest stash (log2 rows) the build allows before widening the main
# table instead: 2^20 rows = 33.6 MB.  Part of the shared DB build, so
# both packages choose the same geometry.
WARM_STASH_MAX_BITS = 20


def load_target_names(path) -> list[str]:
    """Target names from a DB artifact WITHOUT materializing the table
    array (npz members load lazily; summaries like `abundance -D` must
    not pay a multi-GB decompress for a name list)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
    if meta.get("format") != "cuclark-tpu-db-v1":
        raise ValueError(f"not a cuclark-tpu database: {path}")
    return list(meta["target_names"])


def choose_nb_bits(n_kmers: int, cfg: DBConfig) -> int:
    """Smallest power-of-two bucket count achieving <= target_load.

    qs + widen_for_warm_stash: additionally widen while the Poisson
    overflow tail would need a stash past WARM_STASH_MAX_BITS — each
    extra main bit halves lambda and shrinks the required stash ~9x, so
    one widening step always suffices in practice.  Capped at
    MAX_NB_BITS_Q."""
    slots = 4 if cfg.layout in ("q4", "qs") else cfg.slots
    need = max(1, int(np.ceil(n_kmers / (slots * cfg.target_load))))
    bits = max(4, int(np.ceil(np.log2(need))))
    if cfg.layout in ("q4", "qs"):
        # quotient must fit 15 bits: 32 - nb_bits <= 15
        bits = max(bits, 17)
    if cfg.layout == "qs" and getattr(cfg, "widen_for_warm_stash", True):
        while (bits < MAX_NB_BITS_Q
               and choose_stash_bits(n_kmers, bits) > WARM_STASH_MAX_BITS):
            bits += 1
    return bits


def choose_stash_bits(n_kmers: int, nb_bits: int) -> int:
    """qs stash sizing: expected choice-1 overflow is the Poisson tail
    of 4-slot main buckets at lambda = n/NB; size the stash to hold it
    at ~60% load (cuckoo evictions back into main absorb the variance).
    Floored at 17 so stash quotients fit 15 bits."""
    import math

    lam = n_kmers / float(1 << nb_bits)
    # E[(X - 4)+] for X ~ Poisson(lam)
    p = math.exp(-lam)
    excess = 0.0
    for x in range(1, 64):
        p *= lam / x
        if x > 4:
            excess += (x - 4) * p
    exp_overflow = excess * (1 << nb_bits)
    need_rows = max(1.0, exp_overflow * 1.6 / 4.0)
    return max(17, int(np.ceil(np.log2(need_rows))))


def build_table(
    kmers: np.ndarray,
    labels: np.ndarray,
    target_names: list[str],
    cfg: DBConfig,
    nb_bits: int | None = None,
) -> KmerDB:
    """Assemble the hash table from unique canonical k-mers + labels.

    kmers:  uint64 [N] unique canonical k-mers.
    labels: int    [N] 1-based target labels (1..T).
    target_names: T+1 names, index 0 == "NA".
    """
    kmers = np.asarray(kmers, dtype=np.uint64)
    labels = np.asarray(labels, dtype=np.uint32)
    n = len(kmers)
    if len(labels) != n:
        raise ValueError("kmers and labels length mismatch")
    if labels.size and (labels.min() < 1 or labels.max() > MTRGTS):
        raise ValueError("labels must be 1-based and <= MTRGTS")
    # builder outputs arrive sorted ascending (sort-reduce), where
    # uniqueness is a diff check; a sorted copy (8 B/key — GBs at RefSeq
    # scale) is only the fallback for unsorted callers (CLARK and .ht
    # imports).  np.sort, not np.unique: the hash-based unique of newer
    # numpy releases is many times slower than a sort on tens of
    # millions of keys.
    if n > 1 and not np.all(kmers[1:] > kmers[:-1]):
        s = np.sort(kmers)
        if not np.all(s[1:] != s[:-1]):
            raise ValueError("k-mers must be unique (target-specific)")
        del s

    if nb_bits is None:
        nb_bits = choose_nb_bits(n, cfg)

    for attempt in range(8):
        check_q_bits(cfg.layout, nb_bits)
        db = None
        if cfg.layout == "qs":
            sb0 = choose_stash_bits(n, nb_bits)
            # reject int32-overflowing stash geometry BEFORE the build,
            # not at first classify (the artifact would be unusable)
            check_q_bits("qs", nb_bits, min(sb0 + 1, nb_bits))
            for sb in (sb0, sb0 + 1):  # grow the stash before the main
                for seed in range(2):  # fresh Feistel constants per retry
                    db = _try_build_qs(kmers, labels, target_names, cfg,
                                       nb_bits, min(sb, nb_bits), seed)
                    if db is not None:
                        break
                if db is not None:
                    break
        elif cfg.layout == "q4":
            for seed in range(4):  # fresh Feistel constants per retry
                db = _try_build_q4(kmers, labels, target_names, cfg,
                                   nb_bits, seed)
                if db is not None:
                    break
        else:
            db = _try_build(kmers, labels, target_names, cfg, nb_bits)
        if db is not None:
            db.verify(kmers, labels)
            return db
        nb_bits += 1  # overflow: double the table and retry
    raise RuntimeError("hash table construction failed to converge")


def _try_build_qs(kmers, labels, target_names, cfg, nb_bits, stash_bits,
                  seed):
    """qs layout build: two-choice cuckoo placement with choice-1
    confined to the stash section (rows [NB, NB+NBS)).  Native C++
    insert loop when available, vectorized numpy otherwise."""
    from cuclark_tpu_torch import native

    if native.available():
        table = native.build_q4(kmers, labels, nb_bits,
                                feistel_seed_consts(seed),
                                stash_bits=stash_bits)
        if table is None:
            return None
        return KmerDB(
            k=cfg.k, slots=4, num_choices=2, nb_bits=nb_bits,
            target_names=list(target_names), table=table,
            num_kmers=len(kmers), gap=cfg.gap, layout="qs", seed=seed,
            stash_bits=stash_bits,
        )
    hi, lo = _split64(kmers)
    h1, l2 = feistel_mix(hi, lo, seed)
    nb = 1 << nb_bits
    nbs = 1 << stash_bits
    mask = _M32(nb - 1)
    smask = _M32(nbs - 1)
    b1 = (l2 & mask).astype(np.int64)
    b2 = nb + (h1 & smask).astype(np.int64)
    placed = _cuckoo_place(b1, b2, nb + nbs, 4)
    if placed is None:
        return None
    bucket, slot, choice = placed
    table = np.zeros((nb + nbs, 8), dtype=np.uint32)
    other = np.where(choice == 0, h1, l2)
    quot = np.where(choice == 0, l2 >> _M32(nb_bits), h1 >> _M32(stash_bits))
    meta = ((quot.astype(np.uint32) << _M32(17))
            | (choice.astype(np.uint32) << _M32(16))
            | labels.astype(np.uint32))
    table[bucket, slot] = other
    table[bucket, slot + 4] = meta
    return KmerDB(
        k=cfg.k, slots=4, num_choices=2, nb_bits=nb_bits,
        target_names=list(target_names), table=table,
        num_kmers=len(kmers), gap=cfg.gap, layout="qs", seed=seed,
        stash_bits=stash_bits,
    )


def _try_build_q4(kmers, labels, target_names, cfg, nb_bits, seed):
    """q4 layout build: Feistel-mix keys, two-choice C=4 cuckoo
    placement over the main rows, pack [other x4 | meta x4] rows.
    Native C++ insert loop when available, vectorized numpy otherwise."""
    from cuclark_tpu_torch import native

    if native.available():
        table = native.build_q4(kmers, labels, nb_bits,
                                feistel_seed_consts(seed))
        if table is None:
            return None
        return KmerDB(
            k=cfg.k, slots=4, num_choices=2, nb_bits=nb_bits,
            target_names=list(target_names), table=table,
            num_kmers=len(kmers), gap=cfg.gap, layout="q4", seed=seed,
        )
    hi, lo = _split64(kmers)
    h1, l2 = feistel_mix(hi, lo, seed)
    mask = _M32((1 << nb_bits) - 1)
    b1 = (l2 & mask).astype(np.int64)
    b2 = (h1 & mask).astype(np.int64)
    placed = _cuckoo_place(b1, b2, 1 << nb_bits, 4)
    if placed is None:
        return None
    bucket, slot, choice = placed
    table = np.zeros((1 << nb_bits, 8), dtype=np.uint32)
    own = np.where(choice == 0, l2, h1)
    other = np.where(choice == 0, h1, l2)
    meta = (((own >> _M32(nb_bits)).astype(np.uint32) << _M32(17))
            | (choice.astype(np.uint32) << _M32(16))
            | labels.astype(np.uint32))
    table[bucket, slot] = other
    table[bucket, slot + 4] = meta
    return KmerDB(
        k=cfg.k, slots=4, num_choices=2, nb_bits=nb_bits,
        target_names=list(target_names), table=table,
        num_kmers=len(kmers), gap=cfg.gap, layout="q4", seed=seed,
    )


def _greedy_fill(idx, buckets, occ, S: int):
    """Vectorized greedy bucket fill shared by the cuckoo builders:
    rank each item within its bucket run (stable argsort), accept those
    whose slot = occupancy + rank lands below S.  Updates `occ` in
    place.  Returns (placed_buckets, placed_slots, placed_idx,
    leftover_idx)."""
    if len(idx) == 0:
        z = np.empty(0, np.int64)
        return z, z, z, idx
    order = np.argsort(buckets, kind="stable")
    sidx = idx[order]
    sbuck = buckets[order]
    first = np.r_[True, sbuck[1:] != sbuck[:-1]]
    run_start = np.flatnonzero(first)
    rank = np.arange(len(sbuck)) - run_start[np.cumsum(first) - 1]
    sl = occ[sbuck] + rank
    fits = sl < S
    pb = sbuck[fits]
    occ += np.bincount(pb, minlength=len(occ)).astype(occ.dtype)
    return pb, sl[fits], sidx[fits], sidx[~fits]


def _cuckoo_place(b1, b2, nb: int, S: int):
    """Two-choice bucketed cuckoo placement.

    Returns (bucket, slot, choice) int arrays per key, or None when the
    random-walk fails (caller grows the table / reseeds).  Bulk greedy
    fill first (vectorized), random-walk eviction for the tail."""
    n = len(b1)
    occ = np.zeros(nb, dtype=np.int32)
    bucket = np.zeros(n, dtype=np.int64)
    slot = np.zeros(n, dtype=np.int32)
    choice = np.zeros(n, dtype=np.uint8)

    def place_bulk(idx, buckets, ch):
        pb, ps, pi, left = _greedy_fill(idx, buckets, occ, S)
        bucket[pi] = pb
        slot[pi] = ps
        choice[pi] = ch
        return left

    all_idx = np.arange(n)
    rest = place_bulk(all_idx, b1[all_idx], 0)
    if len(rest):
        rest = place_bulk(rest, b2[rest], 1)

    # slot-holder map for eviction bookkeeping
    holder = np.full((nb, S), -1, dtype=np.int64)
    mask_ok = np.ones(n, dtype=bool)
    mask_ok[rest] = False
    hb = bucket[mask_ok]
    hs = slot[mask_ok]
    holder[hb, hs] = np.flatnonzero(mask_ok)

    rng = np.random.default_rng(0x5EED ^ nb)
    for i in rest:
        cur = int(i)
        cur_choice = 0
        for _step in range(400):
            cb = int(b1[cur] if cur_choice == 0 else b2[cur])
            if occ[cb] < S:
                s = int(occ[cb])
                bucket[cur], slot[cur], choice[cur] = cb, s, cur_choice
                holder[cb, s] = cur
                occ[cb] += 1
                cur = -1
                break
            s = int(rng.integers(S))
            victim = int(holder[cb, s])
            bucket[cur], slot[cur], choice[cur] = cb, s, cur_choice
            holder[cb, s] = cur
            # victim re-inserts at its other choice
            cur_choice = 1 - int(choice[victim]) if victim >= 0 else 0
            if victim < 0:
                cur = -1
                break
            cur = victim
        if cur != -1:
            return None
    return bucket, slot, choice


def _try_build(kmers, labels, target_names, cfg, nb_bits):
    """s2 layout build: native C++ cuckoo insert loop when available,
    vectorized numpy otherwise."""
    from cuclark_tpu_torch import native

    if native.available():
        built = native.build_cuckoo(kmers, labels, nb_bits, cfg.slots,
                                    cfg.num_choices)
        if built is None:
            return None
        keys_lo, keys_hi, labs = built
        table = np.concatenate([keys_lo, keys_hi, labs], axis=1)
        return KmerDB(
            k=cfg.k, slots=cfg.slots, num_choices=cfg.num_choices,
            nb_bits=nb_bits, target_names=list(target_names),
            table=np.ascontiguousarray(table, np.uint32),
            num_kmers=len(kmers), gap=cfg.gap,
        )
    return _try_build_np(kmers, labels, target_names, cfg, nb_bits)


def _try_build_np(kmers, labels, target_names, cfg, nb_bits):
    """s2 layout build in numpy: greedy fill of the first, then the
    second choice, a cuckoo random walk for the leftovers."""
    S = cfg.slots
    nb = 1 << nb_bits
    mask = _M32(nb - 1)
    hi, lo = _split64(kmers)
    b1 = (mix1(hi, lo) & mask).astype(np.int64)
    b2 = ((mix2(hi, lo) & mask).astype(np.int64) if cfg.num_choices == 2
          else b1)

    keys_lo = np.full((nb, S), EMPTY, dtype=np.uint32)
    keys_hi = np.full((nb, S), EMPTY, dtype=np.uint32)
    labs = np.zeros((nb, S), dtype=np.uint32)
    occ = np.zeros(nb, dtype=np.int32)

    def place_bulk(idx, buckets):
        pb, ps, pi, left = _greedy_fill(idx, buckets, occ, S)
        keys_lo[pb, ps] = lo[pi]
        keys_hi[pb, ps] = hi[pi]
        labs[pb, ps] = labels[pi]
        return left

    all_idx = np.arange(len(kmers))
    rest = place_bulk(all_idx, b1[all_idx])
    if cfg.num_choices == 2 and len(rest):
        rest = place_bulk(rest, b2[rest])

    if len(rest) and cfg.num_choices == 1:
        return None  # single-choice: overflow means the table is too small

    # Cuckoo random-walk eviction for the leftovers (rare at sane loads).
    rng = np.random.default_rng(0x5EED)
    max_steps = 200
    with np.errstate(over="ignore"):  # uint32 mix wraps by design
        for i in rest:
            cur = (np.uint64(kmers[i]), np.uint32(labels[i]))
            placed = False
            for step in range(max_steps):
                chi, clo = _split64(cur[0])
                cb = int((mix1(chi, clo) if step % 2 == 0
                          else mix2(chi, clo)) & mask)
                if occ[cb] < S:
                    s = occ[cb]
                    keys_lo[cb, s] = clo
                    keys_hi[cb, s] = chi
                    labs[cb, s] = cur[1]
                    occ[cb] += 1
                    placed = True
                    break
                s = int(rng.integers(S))
                ev = ((np.uint64(keys_hi[cb, s]) << np.uint64(32))
                      | np.uint64(keys_lo[cb, s]),
                      np.uint32(labs[cb, s]))
                keys_lo[cb, s] = clo
                keys_hi[cb, s] = chi
                labs[cb, s] = cur[1]
                cur = ev
            if not placed:
                return None  # table effectively full: grow and retry

    table = np.concatenate([keys_lo, keys_hi, labs], axis=1).astype(np.uint32)
    return KmerDB(
        k=cfg.k, slots=S, num_choices=cfg.num_choices, nb_bits=nb_bits,
        target_names=list(target_names), table=table,
        num_kmers=len(kmers), gap=cfg.gap,
    )
