"""Offline database construction: target-specific canonical k-mers.

Counterpart of `cuclark_tpu/db_build/builder.py`, carried over
unchanged (host-only numpy and native code).

The equivalent of the reference DB-build path
(makeSpecificTargetSets, src/CuCLARK_hh.hh:690-1329 + EHashtable
RemoveCommon, src/HashTableStorage_hh.hh:242-292): stream every
reference genome, extract canonical k-mers, keep exactly those k-mers
that occur in a single target, and lay them out as the flat two-choice
hash table.

Instead of a 146 GB chained mother-table, discrimination is a
sort-reduce over (kmer, label) occurrence arrays — vectorized numpy
here, with the same algorithm designed to shard by hash prefix for
out-of-core scale (each hash-prefix shard reduces independently).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cuclark_tpu_torch import codec, native
from cuclark_tpu_torch.config import DBConfig
from cuclark_tpu_torch.hashdb import KmerDB, build_table
from cuclark_tpu_torch.io import fasta


def _strip_newlines(seq: bytes | np.ndarray) -> np.ndarray:
    """Drop '\\n'/'\\r' bytes so the numpy extractors match the native
    ones, which SKIP newlines instead of breaking the k-mer window — a
    caller passing raw multi-line FASTA bytes must get the same
    database whichever implementation runs."""
    buf = (np.frombuffer(seq, np.uint8)
           if isinstance(seq, (bytes, bytearray))
           else np.asarray(seq, np.uint8))
    return buf[(buf != 10) & (buf != 13)]


def extract_canonical_np(seq: bytes | np.ndarray, k: int) -> np.ndarray:
    """All overlapping canonical k-mers of one sequence (uint64),
    honoring part semantics (no k-mer spans a non-ACGT char) — the full
    mode build walk (src/CuCLARK_hh.hh:1100-1163)."""
    codes = codec.encode_ascii(_strip_newlines(seq)).astype(np.int64)
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)

    valid = codes < codec.INVALID
    # window is valid iff it contains no invalid char
    cs = np.concatenate([[0], np.cumsum(~valid)])
    wvalid = (cs[k:] - cs[:-k]) == 0           # [n-k+1]

    vals = np.where(valid, codes, 0).astype(np.uint64)
    km = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        km = (km << np.uint64(2)) | vals[j: j + n - k + 1]
    km = km[wvalid]
    return codec.canonical_np(km, k)


def extract_canonical_light_np(seq: bytes | np.ndarray, k: int, gap: int,
                               iter0: int = 0):
    """Light-mode build walk: NON-overlapping k-mer blocks (the rolling
    k-mer resets after each complete k-mer, src/CuCLARK_hh.hh:725-731),
    keeping every gap-th block.  The block counter `iter` persists
    across parts and sequences of one genome file (it is only reset per
    file in the reference).  Returns (kmers, iter)."""
    codes = codec.encode_ascii(_strip_newlines(seq)).astype(np.int64)
    valid = codes < codec.INVALID
    out = []
    it = iter0
    # part boundaries: runs of valid codes
    starts = np.flatnonzero(np.diff(np.r_[0, valid.view(np.int8)]) == 1)
    ends = np.flatnonzero(np.diff(np.r_[valid.view(np.int8), 0]) == -1) + 1
    for s, e in zip(starts, ends):
        nblocks = (e - s) // k
        if nblocks == 0:
            continue
        offs = s + np.arange(nblocks) * k
        km = np.zeros(nblocks, dtype=np.uint64)
        for j in range(k):
            km = (km << np.uint64(2)) | codes[offs + j].astype(np.uint64)
        sel = ((it + np.arange(nblocks)) % gap) == 0
        out.append(km[sel])
        it += nblocks
    if not out:
        return np.empty(0, np.uint64), it
    return codec.canonical_np(np.concatenate(out), k), it


def parse_targets_file(path) -> list[tuple[str, str, str | None]]:
    """targets.txt lines: '<seqfile> <label> [label2]'
    (reference getTargetsData parses up to 3 columns,
    src/CuCLARK_hh.hh:1822-1850).  Returns [(file, label, label2|None)];
    label2 is the chromosome/centromere paired label consumed by the
    multiplicity==2 RemoveCommon path."""
    out = []
    base = Path(path).parent
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"targets line needs '<file> <label>': {line!r}")
        fp = parts[0]
        if not Path(fp).exists() and (base / fp).exists():
            fp = str(base / fp)
        out.append((fp, parts[1], parts[2] if len(parts) > 2 else None))
    return out


def _norm_entry(entry):
    """Accept (file, label) or (file, label, label2) target entries."""
    if len(entry) == 2:
        return entry[0], entry[1], None
    return entry[0], entry[1], entry[2]


class LabelSpace:
    """Target-name/label-id bookkeeping, including centromere label2s.

    Mirrors getTargetsData + the EHashtable ctor label maps
    (src/CuCLARK_hh.hh:1879-1887, src/HashTableStorage_hh.hh:215-238):
    m_targetsName = ["NA"] + label1s (first-seen order) + label2s
    (first-seen order), so label2 ids follow all label1 ids.

    sibling_class: two labels are "siblings" iff same length and equal
    up to the last character (addElement's upLbl test,
    src/HashTableStorage_hh.hh:509-513).  relabel maps a label1 id to
    the id of the first label2 in declaration order that is its sibling
    by the same test (RemoveCommon, src/HashTableStorage_hh.hh:262-283)
    — or to itself when none matches (the reference still keeps the
    k-mer under its original label in that case)."""

    def __init__(self, file_labels):
        entries = [_norm_entry(e) for e in file_labels]
        self.names = ["NA"]
        self.ids: dict[str, int] = {}
        for _, label, _ in entries:
            if label not in self.ids:
                self.ids[label] = len(self.names)
                self.names.append(label)
        self.labels_c: list[str] = []
        self.c_ids: dict[str, int] = {}
        for _, _, label2 in entries:
            if label2 is not None and label2 not in self.c_ids:
                self.labels_c.append(label2)
                self.c_ids[label2] = len(self.names)
                self.names.append(label2)
        # sibling-class id per target id (index 0 = NA, own class)
        cls_keys: dict[tuple, int] = {}
        self.cls = np.zeros(len(self.names), dtype=np.int64)
        for i, name in enumerate(self.names):
            # upLbl checks char 0 AND chars [1, len-1) — for 1-char
            # labels that is the whole string, so no distinct siblings
            key = (len(name), name[:-1]) if len(name) >= 2 else (1, name)
            self.cls[i] = cls_keys.setdefault(key, len(cls_keys))
        # relabel map for the multiplicity==2 path
        self.relabel = np.arange(len(self.names), dtype=np.uint32)
        for label, i in self.ids.items():
            for c in self.labels_c:
                if len(c) == len(label) and c[:-1] == label[:-1]:
                    self.relabel[i] = self.c_ids[c]
                    break

    @property
    def has_centromeres(self) -> bool:
        return bool(self.labels_c)


def is_spectrum_file(path) -> bool:
    """Spectrum input: lines '<kmer-string> <count>' — the reference
    build's third input branch (src/CuCLARK_hh.hh:845-905)."""
    try:
        with open(path, "rb") as f:
            first = f.readline().split()
    except OSError:
        return False
    if len(first) != 2:
        return False
    try:
        codec.string_to_kmer(first[0].decode())
        int(first[1])
        return True
    except (ValueError, UnicodeDecodeError):
        return False


def read_spectrum(path, k: int, gap: int = 1, min_count: int = 0):
    """Parse a spectrum file -> (canonical kmers u64, counts u32).

    Light mode keeps every gap-th line, and entries at or below
    min_count are dropped BEFORE the table — both per the reference's
    insert condition `counter % iterKmers == 0 && val > minCount`
    (src/CuCLARK_hh.hh:868)."""
    kms, cnts = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            # validate BEFORE the gap filter: a corrupt line must raise
            # regardless of whether its index happens to be gap-skipped
            # (the same broken file must not build or fail by parity)
            if len(parts) != 2:
                raise ValueError(f"bad spectrum line in {path}: {line!r}")
            if len(parts[0]) != k:
                raise ValueError(
                    f"spectrum k-mer length {len(parts[0])} != k={k}")
            if gap > 1 and i % gap != 0:
                continue
            if int(parts[1]) <= min_count:
                continue
            kms.append(codec.string_to_kmer(parts[0]))
            cnts.append(int(parts[1]))
    km = codec.canonical_np(np.array(kms, dtype=np.uint64), k)
    return km, np.array(cnts, dtype=np.uint32)


class _SpillStore:
    """Disk shards for out-of-core occurrence reduction.

    Occurrences partition by k-mer range (top bits of the 2k-bit
    canonical value), so every duplicate of a k-mer lands in the same
    shard and each shard reduces independently — the external-sort
    answer to the reference's 146 GB in-RAM mother table
    (README.md:93-94).  Shards concatenated in order are globally
    sorted after per-shard sorting."""

    SHARD_BITS = 6  # 64 shards

    def __init__(self, base_dir, k: int):
        import tempfile

        if base_dir is not None:  # e.g. the (not-yet-created) db dir
            Path(base_dir).mkdir(parents=True, exist_ok=True)
        self.dir = Path(tempfile.mkdtemp(prefix="cuclark_build_",
                                         dir=base_dir))
        self.k = k
        self.nshards = 1 << self.SHARD_BITS
        self.shift = np.uint64(max(0, 2 * k - self.SHARD_BITS))
        self._files = [None] * self.nshards

    def _fh(self, s: int):
        if self._files[s] is None:
            self._files[s] = open(self.dir / f"shard_{s:03d}.bin", "wb")
        return self._files[s]

    def add(self, km: np.ndarray, lb: np.ndarray, ct: np.ndarray) -> None:
        if native.available():
            # one native count+scatter pass groups records by shard
            rec, bounds = native.spill_partition(
                km, lb, ct, int(self.shift), self.nshards)
            for s in range(self.nshards):
                lo, hi = int(bounds[s]), int(bounds[s + 1])
                if hi > lo:
                    self._fh(s).write(rec[lo:hi].tobytes())
            return
        shard = (km >> self.shift).astype(np.int64)
        order = np.argsort(shard, kind="stable")
        sk, sl, sc = km[order], lb[order], ct[order]
        ss = shard[order]
        starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
        bounds = np.r_[starts, len(ss)]
        for i, s in enumerate(ss[starts]):
            lo, hi = bounds[i], bounds[i + 1]
            rec = np.empty((hi - lo, 2), dtype=np.uint64)
            rec[:, 0] = sk[lo:hi]
            # pack label+count into the second u64 word
            rec[:, 1] = (sl[lo:hi].astype(np.uint64) << np.uint64(32)) | sc[lo:hi]
            self._fh(int(s)).write(rec.tobytes())

    def reduce(self, min_count: int, label_space=None,
               budget_bytes: int | None = None):
        """Close shards; yield (kmers, labels, counts) per shard,
        reduced, in ascending k-mer-range order.

        budget_bytes bounds the per-shard reduce footprint: loading +
        sorting a shard costs ~4x its record bytes (records + the
        native sort's A/B scratch + outputs), so any shard whose file
        exceeds budget/4 is first SPLIT by the next 3 k-mer bits into
        8 sub-shards (streamed through a small chunk buffer, preserving
        occurrence order) and those reduce independently — the
        recursive step that keeps the out-of-core build's RSS bounded
        by the budget instead of by the biggest shard."""
        for f in self._files:
            if f is not None:
                f.close()
        if budget_bytes is not None:
            budget_bytes = max(budget_bytes, 1 << 20)  # 1 MB floor
        from collections import deque

        queue = deque()
        for s in range(self.nshards):
            p = self.dir / f"shard_{s:03d}.bin"
            if p.exists():
                queue.append((p, self.SHARD_BITS))
        while queue:
            p, bits = queue.popleft()
            if (budget_bytes is not None
                    and p.stat().st_size * 4 > budget_bytes
                    and 2 * self.k - bits >= 3):
                subs = self._split(p, bits, budget_bytes)
                queue.extendleft(reversed(subs))  # keep ascending order
                continue
            rec = np.fromfile(p, dtype=np.uint64).reshape(-1, 2)
            p.unlink()
            km = rec[:, 0].copy()
            lb = (rec[:, 1] >> np.uint64(32)).astype(np.uint32)
            ct = (rec[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            del rec
            yield discriminate(km, lb, min_count, ct, label_space)

    def _split(self, p: Path, bits: int, budget_bytes: int):
        """Stream-split one shard file into 8 sub-shards by the next 3
        top k-mer bits.  Chunked reads keep RAM at ~budget/4."""
        sub_shift = np.uint64(max(0, 2 * self.k - bits - 3))
        paths = [p.with_name(f"{p.stem}_{i}.bin") for i in range(8)]
        outs = [open(sp, "wb") for sp in paths]
        chunk_rec = max(budget_bytes // 4 // 16, 65536)
        with open(p, "rb") as f:
            while True:
                rec = np.fromfile(f, dtype=np.uint64, count=2 * chunk_rec)
                if rec.size == 0:
                    break
                rec = rec.reshape(-1, 2)
                sub = ((rec[:, 0] >> sub_shift) & np.uint64(7)).astype(
                    np.int64)
                for i in range(8):
                    part = rec[sub == i]
                    if len(part):
                        outs[i].write(part.tobytes())
        for o in outs:
            o.close()
        p.unlink()
        out = []
        for sp in paths:
            if sp.stat().st_size:
                out.append((sp, bits + 3))
            else:
                sp.unlink()
        return out

    def cleanup(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


def collect_target_kmers(file_labels, cfg: DBConfig, progress=None,
                         spill_dir=None):
    """Stream genomes; return (kmers, labels, counts, label_space,
    spill).

    label_space.names[0] == 'NA'; label ids are first-seen order,
    1-based, with centromere label2 ids after all label1 ids (matching
    getTargetsData, src/CuCLARK_hh.hh:1879-1887).  counts is either an
    explicit per-occurrence multiplicity array (spectrum inputs) or the
    None sentinel meaning one occurrence each (sequence inputs; also
    always None on the spill and empty paths) — callers must treat
    None as all-ones, and discriminate() then counts run lengths
    instead of materializing the array.

    When the accumulated occurrences exceed cfg.build_ram_mb, they spill
    to a _SpillStore (returned as `spill`, with the in-RAM arrays empty);
    the caller reduces shard by shard."""
    from cuclark_tpu_torch import native

    space = LabelSpace(file_labels)
    km_chunks = []
    lb_chunks = []
    ct_chunks = []
    use_native = native.available()
    limit = (None if cfg.build_ram_mb is None
             else int(cfg.build_ram_mb * 1e6))
    held = 0  # bytes of occurrences held in RAM (16 B each)
    spill = None

    def push(km, lid_or_lb, ct):
        """ct None = one occurrence each (sequence inputs); kept as a
        sentinel so the all-ones counts array is never materialized on
        the in-RAM path (discriminate counts run lengths instead)."""
        nonlocal held, spill
        lb = (np.full(len(km), lid_or_lb, dtype=np.uint32)
              if np.isscalar(lid_or_lb) else lid_or_lb)
        km_chunks.append(km)
        lb_chunks.append(lb)
        ct_chunks.append(ct)
        held += 16 * len(km)
        if limit is not None and held > limit:
            if spill is None:
                spill = _SpillStore(spill_dir, cfg.k)
            for a, b, c in zip(km_chunks, lb_chunks, ct_chunks):
                spill.add(a, b,
                          np.ones(len(a), np.uint32) if c is None else c)
            km_chunks.clear(), lb_chunks.clear(), ct_chunks.clear()
            held = 0

    for entry in file_labels:
        fp, label, _label2 = _norm_entry(entry)
        lid = space.ids[label]
        if is_spectrum_file(fp):
            km, ct = read_spectrum(fp, cfg.k, cfg.gap, cfg.min_count)
            if len(km):
                push(km, lid, ct)
            if progress:
                progress(fp, label)
            continue
        it = 0  # light-mode block counter, reset per genome file
        for _name, seq in fasta.read_records(fp):
            if cfg.gap > 1:
                if use_native:
                    km, it = native.extract_canonical_light(seq, cfg.k,
                                                            cfg.gap, it)
                else:
                    km, it = extract_canonical_light_np(seq, cfg.k,
                                                        cfg.gap, it)
            elif use_native:
                km = native.extract_canonical(seq, cfg.k)
            else:
                km = extract_canonical_np(seq, cfg.k)
            if len(km):
                push(km, lid, None)
        if progress:
            progress(fp, label)

    if spill is not None:
        for a, b, c in zip(km_chunks, lb_chunks, ct_chunks):
            spill.add(a, b, np.ones(len(a), np.uint32) if c is None else c)
        km_chunks.clear(), lb_chunks.clear(), ct_chunks.clear()
        return (np.empty(0, np.uint64), np.empty(0, np.uint32),
                None, space, spill)
    if not km_chunks:
        return (np.empty(0, np.uint64), np.empty(0, np.uint32),
                None, space, None)
    if all(c is None for c in ct_chunks):
        cts = None  # pure sequence input: counts are the run lengths
    else:
        cts = np.concatenate([
            np.ones(len(a), np.uint32) if c is None else c
            for a, c in zip(km_chunks, ct_chunks)])
    return (np.concatenate(km_chunks), np.concatenate(lb_chunks),
            cts, space, None)


def discriminate(kmers: np.ndarray, labels: np.ndarray, min_count: int = 0,
                 counts: np.ndarray | None = None,
                 label_space: "LabelSpace | None" = None):
    """Keep k-mers occurring in exactly one target (RemoveCommon
    semantics, src/HashTableStorage_hh.hh:242-292) with occurrence
    count strictly greater than min_count (reference -t filter is
    `GetCount() > _minCount`).

    counts: optional per-occurrence multiplicities (spectrum inputs
    carry explicit counts); defaults to 1 each.

    label_space: when it declares centromere label2s, reproduce the
    reference multiplicity bookkeeping exactly (addElement,
    src/HashTableStorage_hh.hh:483-523): the k-mer keeps its FIRST-seen
    label L0; each later occurrence adds +0 if its label == L0, +1 if a
    sibling of L0 (same length, equal up to the last char), +2
    otherwise, starting from multiplicity 1.  multiplicity==1 k-mers
    are specific; multiplicity==2 k-mers (one extra occurrence in one
    sibling target) are ALSO kept, relabeled to the matching label2
    when one exists (RemoveCommon:262-283 marks them regardless and
    relabels only on a prefix match).

    Occurrence order matters for L0; callers append occurrences in
    stream order and the stable k-mer sort preserves it per run.

    Returns (unique_kmers u64, labels u32, counts u32)."""
    if len(kmers) == 0:
        return kmers, labels, np.empty(0, np.uint32)
    centromeres = label_space is not None and label_space.has_centromeres
    if not centromeres and native.available():
        # hot path: native radix sort + run sweep in place of the numpy
        # argsort/gather/reduceat chain; centromere label2 bookkeeping
        # stays below in numpy
        return native.reduce_occurrences(kmers, labels, counts, min_count)
    order = np.argsort(kmers, kind="stable")
    sk = kmers[order]
    sl = labels[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    runlen = np.diff(np.r_[starts, len(sk)])
    first = sl[starts]  # first-seen label per k-mer (stable sort)
    if counts is None:
        cnt = runlen.astype(np.uint32)
    else:
        cnt = np.add.reduceat(counts[order].astype(np.uint64), starts)
        cnt = np.minimum(cnt, 0xFFFFFFFF).astype(np.uint32)

    if centromeres:
        run_id = np.cumsum(np.r_[False, sk[1:] != sk[:-1]])
        l0 = first[run_id]
        cls = label_space.cls
        inc = np.where(sl == l0, 0,
                       np.where(cls[sl] == cls[l0], 1, 2)).astype(np.int64)
        mult = 1 + np.add.reduceat(inc, starts)
        mult = np.minimum(mult, 255)
        keep1 = mult == 1
        keep2 = mult == 2
        if min_count > 0:
            passing = cnt > min_count
            keep1 &= passing
            keep2 &= passing
        out_label = np.where(keep2, label_space.relabel[first], first)
        keep = keep1 | keep2
        return sk[starts[keep]], out_label[keep].astype(np.uint32), cnt[keep]

    lmin = np.minimum.reduceat(sl, starts)
    lmax = np.maximum.reduceat(sl, starts)
    specific = lmin == lmax
    if min_count > 0:
        specific &= cnt > min_count
    return sk[starts[specific]], lmin[specific], cnt[specific]


def build_db(file_labels, cfg: DBConfig, progress=None,
             tsk_dir=None) -> KmerDB:
    """Build the database; optionally resume from / dump to a
    target-specific-set archive (reference --tsk, SaveMultiple/Load,
    src/HashTableStorage_hh.hh:295-405, 697-737)."""
    if tsk_dir is not None and (Path(tsk_dir) / "tsk.npz").exists():
        kmers, labels, names = load_tsk(tsk_dir, cfg)
        return build_table(kmers, labels, names, cfg)
    spill_dir = str(Path(tsk_dir).parent) if tsk_dir is not None else None
    kmers, labels, counts, space, spill = collect_target_kmers(
        file_labels, cfg, progress, spill_dir=spill_dir)
    if spill is not None:
        # Out-of-core: reduce each k-mer-range shard independently under
        # the same RAM budget, staging survivors back to disk so peak
        # RSS is bounded by (final arrays + one shard's reduce), not by
        # holding every shard's survivors alive through a concatenate.
        budget = (None if cfg.build_ram_mb is None
                  else int(cfg.build_ram_mb * 1e6))
        try:
            red = spill.dir / "reduced"
            red.mkdir()
            sizes = []
            for km_r, lb_r, _ct in spill.reduce(cfg.min_count, space,
                                                budget):
                i = len(sizes)
                km_r.tofile(red / f"km_{i:04d}.bin")
                lb_r.tofile(red / f"lb_{i:04d}.bin")
                sizes.append(len(km_r))
            total = int(sum(sizes))
            kmers = np.empty(total, np.uint64)
            labels = np.empty(total, np.uint32)
            off = 0
            for i, nsz in enumerate(sizes):
                kmers[off:off + nsz] = np.fromfile(
                    red / f"km_{i:04d}.bin", np.uint64)
                labels[off:off + nsz] = np.fromfile(
                    red / f"lb_{i:04d}.bin", np.uint32)
                off += nsz
        finally:
            spill.cleanup()
    else:
        kmers, labels, counts = discriminate(kmers, labels, cfg.min_count,
                                             counts, space)
    if tsk_dir is not None:
        save_tsk(tsk_dir, kmers, labels, space.names, cfg)
    return build_table(kmers, labels, space.names, cfg)


def save_tsk(tsk_dir, kmers, labels, names, cfg: DBConfig) -> None:
    """Dump the discriminative (target-specific) k-mer sets so a DB can
    be rebuilt with different HASH parameters without re-streaming the
    genomes — the role of the reference's per-target .ht files.  The
    k-mer-defining parameters (k/gap/min_count) are recorded: a resume
    under different ones would silently build a DB of the wrong
    k-mers."""
    d = Path(tsk_dir)
    d.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        d / "tsk.npz", kmers=kmers, labels=labels,
        names=np.array(names, dtype=object),
        params=np.array([cfg.k, cfg.gap, cfg.min_count], np.int64),
    )


def load_tsk(tsk_dir, cfg: DBConfig | None = None):
    with np.load(Path(tsk_dir) / "tsk.npz", allow_pickle=True) as z:
        if cfg is not None and "params" in z:
            k, gap, mc = (int(v) for v in z["params"])
            if (k, gap, mc) != (cfg.k, cfg.gap, cfg.min_count):
                raise ValueError(
                    f"tsk archive was built with k={k} gap={gap} "
                    f"min_count={mc}, which defines DIFFERENT k-mers "
                    f"than the requested k={cfg.k} gap={cfg.gap} "
                    f"min_count={cfg.min_count}; delete {tsk_dir} or "
                    f"match the parameters")
        return (z["kmers"], z["labels"], [str(x) for x in z["names"]])


def db_name(cfg: DBConfig, num_targets: int) -> str:
    """Database artifact name, mirroring the reference's encoding of its
    parameters into the filename (getdbName, src/CuCLARK_hh.hh:579-591)."""
    light = f"_g{cfg.gap}" if cfg.gap > 1 else ""
    lay = (cfg.layout if cfg.layout in ("qs", "q4")
           else f"s{cfg.slots}c{cfg.num_choices}")
    return f"db_k{cfg.k}_t{num_targets}_{lay}_m{cfg.min_count}{light}.npz"
