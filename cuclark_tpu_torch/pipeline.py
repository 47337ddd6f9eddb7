"""End-to-end classification pipeline on one torch device.

Counterpart of `cuclark_tpu/pipeline.py`: `classify_step_packed` (:71),
the resident single-device path of `Classifier` (`__init__` :281-293,
`_put_wire` :370, `_device_step` :383, `classify_file_to_csv` :571,
`_emit` :841, and the single-end `classify_file` and `classify_records`
iterators), and the host helpers `CsvSink`, `_prefetch`, `dense_counts`,
`DEFAULT_LEN_BINS`, carried over.

The host scans and packs reads into the 2-bit wire format in a
background thread, which also starts the host-to-device copy from
pinned memory; the main thread launches the query and score kernels
(`probe.query_labels`, `score.score_labels`) on the current stream and
starts the copy of the [R, 5] results back into pinned memory; a writer
thread waits for that copy and formats the CSV natively.  With
`device="cpu"` the same path runs the kernels' plain PyTorch versions.

Outside this slice, and refused with NotImplementedError: extended
output, DB-part streaming (a table larger than the device's free
memory, or `max_table_mb`), and q4/s2 tables.  Paired reads and
multi-device runs are refused by the CLI.
"""

from __future__ import annotations

import numpy as np
import torch

from cuclark_tpu_torch import probe, score
from cuclark_tpu_torch.config import ClassifyConfig
from cuclark_tpu_torch.hashdb import KmerDB, table_to_device

# Length bins: a read is packed into the smallest bin holding it, so a
# batch of short reads never pays for a rare long read; the 152 bin
# puts Illumina-length reads at 122 windows instead of 160's 130.
DEFAULT_LEN_BINS = (128, 152, 160, 192, 256, 320, 512, 1024, 2048, 4096,
                    16384)

_TODO_EXTENDED = ("--extended output is not ported yet "
                  "(ROADMAP.md, Queue 1: paired and --extended)")
_TODO_STREAM = ("DB-part streaming is not ported yet (ROADMAP.md, "
                "Queue 1: DB-part streaming)")

# Device memory kept free beside the table for the batches in flight:
# four batches of labels, results and wire bytes at MAX_BATCH_CELLS.
_DEVICE_RESERVE_BYTES = 1 << 30


def classify_step_packed(table, packed2, vbits, *, k, nb_bits, stash_bits,
                         seed=0, stash, with_labels=True):
    """One device step on the 2-bit wire format: packed2 uint8
    [R, Lp/4], vbits uint8 [R, Lp/8] -> (results int32 [R, 5], labels
    int32 [R, P] or None).  `table` is the qs main rows [NB, 8] and
    `stash` the stash rows [NBS, 8], both int32 (hashdb.table_to_device).
    """
    labels = probe.query_labels(packed2, vbits, table, stash, k=k,
                                nb_bits=nb_bits, stash_bits=stash_bits,
                                seed=seed)
    results = score.score_labels(labels)
    return results, (labels if with_labels else None)


class CsvSink:
    """CLARK-CSV output sink: native OpenMP row formatting
    (csrc/host_ops.cpp format_rows/format_rows_ext), extended-mode
    hit-stat accumulation, and the reference header
    (src/CuCLARK_hh.hh:1956-1972).  The file handle must be opened in
    binary mode; call flush() from a single (writer) thread so rows stay
    ordered."""

    def __init__(self, f, db, extended: bool, paired: bool):
        from cuclark_tpu_torch import native

        self.f = f
        self.db = db
        self.extended = extended
        self.paired = paired
        self.tname_bytes, self.tname_off = native.pack_target_names(
            db.target_names)
        self.total_rows = 0
        self.hstats = [None, 0, 0]  # min, max, sum of distinct hit targets

    def write_header(self) -> None:
        from cuclark_tpu_torch.io.csv_out import header_line

        self.f.write(header_line(self.db.target_names,
                                 self.extended).encode())

    def flush(self, results, labels_np, buf, ns, ne, lengths, cnt) -> None:
        """Format + write one batch: results [R,5] np, labels_np [R,P]
        np or None, read names as (buf, ns, ne) byte offsets."""
        from cuclark_tpu_torch import native

        results = results[:cnt]
        lengths = lengths[:cnt]
        total, ibest, best, isecond, second = (
            results[:, i] for i in range(5))
        norm, gamma, conf = score.gamma_confidence(
            total, best, second, lengths, self.db.k, self.paired)
        if self.extended:
            counts = dense_counts(labels_np[:cnt],
                                  self.db.num_targets)[:, 1:]
            accumulate_hit_stats(self.hstats, (counts > 0).sum(axis=1))
            self.f.write(native.format_rows_ext(
                counts, norm, gamma, ibest, best, isecond, second, conf,
                buf, ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off))
        else:
            self.f.write(native.format_rows(
                norm, gamma, ibest, best, isecond, second, conf,
                buf, ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off))
        self.total_rows += cnt

    def print_hit_stats(self) -> None:
        """Reference extended-mode hit stats (CuCLARK_hh.hh:2075-2080)."""
        if self.extended and self.total_rows:
            import sys

            print(f"MIN targets: {self.hstats[0] or 0}, MAX targets: "
                  f"{self.hstats[1]}, AVG targets: "
                  f"{self.hstats[2] / self.total_rows:g}", file=sys.stderr)


def accumulate_hit_stats(hstats, distinct) -> None:
    """Fold a batch's distinct-hit-target counts into the [min, max,
    sum] triple (reference extended-mode stats, CuCLARK_hh.hh:2075-
    2080)."""
    if len(distinct) == 0:
        return
    lo = int(distinct.min())
    hstats[0] = lo if hstats[0] is None else min(hstats[0], lo)
    hstats[1] = max(hstats[1], int(distinct.max()))
    hstats[2] += int(distinct.sum())


def _to_host_async(t: torch.Tensor):
    """Start the copy of a device tensor into pinned host memory; returns
    (host tensor, event to wait on, or None for a CPU tensor)."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host_numpy(pending) -> np.ndarray:
    """Wait for a copy started by _to_host_async and return it as numpy."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


class Classifier:
    """Holds the device-resident DB and runs batched classification on
    one torch device ("cuda", "cuda:N" or "cpu")."""

    # Device-memory guard: batch_rows x padded_length is capped so a
    # stretch of very long reads (nanopore-scale) shrinks the batch
    # instead of exploding the padded code matrix / label arrays.
    MAX_BATCH_CELLS = 65536 * 512

    def __init__(self, db: KmerDB, cfg: ClassifyConfig | None = None,
                 len_bins=DEFAULT_LEN_BINS, device="cuda"):
        from cuclark_tpu_torch.hashdb import _Q4_S2_TODO

        self.db = db
        self.cfg = cfg or ClassifyConfig()
        self.len_bins = tuple(sorted(len_bins))
        self.device = torch.device(device)
        if self.cfg.extended:
            raise NotImplementedError(_TODO_EXTENDED)
        if self.cfg.max_table_mb is not None:
            raise NotImplementedError(_TODO_STREAM)
        if db.layout != "qs":
            raise NotImplementedError(_Q4_S2_TODO)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.device} requested but "
                    f"torch.cuda.is_available() is False")
            free, _ = torch.cuda.mem_get_info(self.device)
            if db.table.nbytes + _DEVICE_RESERVE_BYTES > free:
                raise NotImplementedError(
                    f"table of {db.table.nbytes / 1e6:.0f} MB does not fit "
                    f"the {free / 1e6:.0f} MB free on {self.device}: "
                    f"{_TODO_STREAM}")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.table, self.stash = table_to_device(db, self.device)

    def _bin_for(self, max_len: int) -> int:
        for b in self.len_bins:
            if max_len + 1 <= b:  # +1 so L >= k always and P >= 1
                return b
        return int(np.ceil((max_len + 1) / 128) * 128)

    def _bin_for_range(self, s, e) -> int:
        mx = int((e - s).max(initial=1))
        return max(self._bin_for(mx), self.db.k)

    def _put_wire(self, wire):
        """Start the host->device transfer of a wire batch, from pinned
        memory without blocking.  Called from the producer (prefetch)
        thread so the copy overlaps formatting of earlier batches."""
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(a) for a in wire)
        return tuple(torch.from_numpy(a).pin_memory().to(
            self.device, non_blocking=True) for a in wire)

    def _device_step(self, wire):
        """Launch one device step on a wire batch already on the device
        -> results int32 [R, 5] on the device."""
        db = self.db
        packed2, vbits = wire
        results, _ = classify_step_packed(
            self.table, packed2, vbits, k=db.k, nb_bits=db.nb_bits,
            stash_bits=db.stash_bits, seed=db.seed, stash=self.stash,
            with_labels=False)
        return results

    # ---------- file fast path ----------

    def _scan_for_classify(self, path, skip):
        """Scan a classify job's input file -> (buf, name_s, name_e,
        seq_s, seq_e), skipping the first `skip` records."""
        from cuclark_tpu_torch.io import fast_parse

        buf = _read_file_bytes(path)
        name_s, name_e, seq_s, seq_e = fast_parse.scan_file(buf)
        if skip:
            name_s, name_e = name_s[skip:], name_e[skip:]
            seq_s, seq_e = seq_s[skip:], seq_e[skip:]
        return buf, name_s, name_e, seq_s, seq_e

    def _packed_batches(self, buf, name_s, name_e, seq_s, seq_e):
        """Yield ((packed2, vbits), (ns, ne), lengths, cnt) batches in
        the 2-bit wire format (codec.pack_codes layout)."""
        from cuclark_tpu_torch.io import fast_parse

        B = self.cfg.batch_reads
        raw_len = seq_e - seq_s
        lo = 0
        n_rec = len(seq_s)
        while lo < n_rec:
            hi = min(lo + B, n_rec)
            # shrink the batch while its padded bin would blow the cell cap
            while hi - lo > 1:
                bin_len = self._bin_for(int(raw_len[lo:hi].max(initial=1)))
                if (hi - lo) * bin_len <= self.MAX_BATCH_CELLS:
                    break
                hi = lo + max(1, self.MAX_BATCH_CELLS // bin_len)
            cnt = hi - lo
            L = self._bin_for_range(seq_s[lo:hi], seq_e[lo:hi])
            p2, vb, lengths = fast_parse.pack_block2_dispatch(
                buf, seq_s[lo:hi], seq_e[lo:hi], L, n_rows=cnt)
            yield (p2, vb), (name_s[lo:hi], name_e[lo:hi]), lengths, cnt
            lo = hi

    def classify_file(self, path, skip: int = 0):
        """Yield result rows (dicts, see _emit) for a whole single-end
        FASTA/FASTQ file.  skip: number of leading records to skip."""
        from collections import deque

        from cuclark_tpu_torch.io import fast_parse

        buf, *scan = self._scan_for_classify(path, skip)

        def packed():
            for wire, (ns, ne), lengths, cnt in self._packed_batches(
                    buf, *scan):
                names = fast_parse.names_of(buf, ns, ne)
                yield self._put_wire(wire), names, lengths, cnt

        # keep a few batches in flight so host packing/formatting and
        # transfers overlap device compute (the reference's pipeline
        # scheduler role, src/CuCLARK_hh.hh:1738-1761)
        inflight = deque()
        for wire, names, lengths, cnt in _prefetch(packed()):
            inflight.append((_to_host_async(self._device_step(wire)),
                             names, lengths, cnt))
            if len(inflight) > 3:
                yield from self._emit(*inflight.popleft())
        while inflight:
            yield from self._emit(*inflight.popleft())

    def classify_file_to_csv(self, path, out_path, skip: int = 0,
                             append: bool = False) -> int:
        """Classify a single-end FASTA/FASTQ file straight into a CLARK
        CSV using the native row formatter — the fast path for the CLI.
        Falls back to the per-row dict path when the native module is
        unavailable.  skip: number of leading records to skip (resume
        support).  Returns the number of reads written."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from cuclark_tpu_torch import native

        if not native.available():
            from cuclark_tpu_torch.io.csv_out import format_row, header_line

            names = self.db.target_names
            n = 0
            with open(out_path, "a" if append else "w") as f:
                if not append:
                    f.write(header_line(names))
                for row in self.classify_file(path, skip=skip):
                    f.write(format_row(row, names))
                    n += 1
            return n

        buf, *scan = self._scan_for_classify(path, skip)

        with open(out_path, "ab" if append else "wb") as f:
            sink = CsvSink(f, self.db, extended=False, paired=False)
            if not append:
                sink.write_header()

            def flush_one(pending, ns, ne, lengths, cnt):
                sink.flush(_host_numpy(pending), None, buf, ns, ne,
                           lengths, cnt)

            def put_batches():
                for wire, nsne, lengths, cnt in self._packed_batches(
                        buf, *scan):
                    yield self._put_wire(wire), nsne, lengths, cnt

            # Third pipeline stage: the D2H wait + CSV formatting + file
            # write run on a single writer thread (in submission order,
            # so rows stay ordered), overlapping the main thread's
            # kernel launches — the reference's "one thread starts
            # writing results while others still feed batches"
            # (src/CuCLARK_hh.hh:1755-1761).
            with ThreadPoolExecutor(1) as writer:
                futs = deque()
                for wire, (ns, ne), lengths, cnt in _prefetch(
                        put_batches()):
                    pending = _to_host_async(self._device_step(wire))
                    futs.append(writer.submit(
                        flush_one, pending, ns, ne, lengths, cnt))
                    if len(futs) > 3:
                        futs.popleft().result()
                while futs:
                    futs.popleft().result()
        return sink.total_rows

    def _emit(self, pending, names, lengths, count):
        """Result dicts of one batch whose [R, 5] copy was started by
        _to_host_async."""
        results = _host_numpy(pending)[:count]
        lengths = lengths[:count]
        total, ibest, best, isecond, second = (results[:, i] for i in range(5))
        norm, gamma, conf = score.gamma_confidence(
            total, best, second, lengths, self.db.k, False)
        for i in range(count):
            yield {
                "name": names[i],
                "length": int(norm[i]),
                "gamma": float(gamma[i]),
                "total": int(total[i]),
                "index_best": int(ibest[i]),
                "best": int(best[i]),
                "index_second": int(isecond[i]),
                "second": int(second[i]),
                "confidence": float(conf[i]),
            }

    # ---------- record-iterator path ----------

    def _record_batches(self, records):
        """Group records into batches honoring BOTH caps: count
        (batch_reads) and padded cells (MAX_BATCH_CELLS) — long records
        shrink the batch instead of exploding the padded device arrays,
        matching the file path's shrink loop."""
        batch, max_len = [], 1
        for rec in records:
            new_max = max(max_len, len(rec[1]), 1)
            if batch and (len(batch) >= self.cfg.batch_reads
                          or (len(batch) + 1) * self._bin_for(new_max)
                          > self.MAX_BATCH_CELLS):
                yield batch
                batch, new_max = [], max(len(rec[1]), 1)
            batch.append(rec)
            max_len = new_max
        if batch:
            yield batch

    def _wire_records(self, batch):
        """Pack (name, seq) records straight to the wire format through
        the fused native packer (one concat buffer + offset arrays);
        the numpy fallback inside pack_block2_dispatch is bit-identical."""
        from cuclark_tpu_torch.io import fast_parse

        max_len = max((len(s) for _, s in batch), default=1)
        L = max(self._bin_for(max_len), self.db.k)
        seqs = [s if isinstance(s, bytes) else bytes(s)
                for _, s in batch]
        buf = np.frombuffer(b"".join(seqs), np.uint8)
        ln = np.array([len(s) for s in seqs], dtype=np.int64)
        ends = np.cumsum(ln)
        p2, vb, lengths = fast_parse.pack_block2_dispatch(
            buf, ends - ln, ends, L, n_rows=len(batch))
        names = [n for n, _ in batch]
        return (p2, vb), names, lengths, len(batch)

    def classify_records(self, records):
        """records: iterable of single-end (name, seq_bytes).

        Yields per-read result dicts in input order, one batch behind
        the device so packing overlaps the step."""
        inflight = None
        for batch in self._record_batches(records):
            wire, names, lengths, count = self._wire_records(batch)
            pending = _to_host_async(self._device_step(self._put_wire(wire)))
            if inflight is not None:
                yield from self._emit(*inflight)
            inflight = (pending, names, lengths, count)
        if inflight is not None:
            yield from self._emit(*inflight)


def dense_counts(labels_np: np.ndarray, n_targets: int) -> np.ndarray:
    """Per-read dense target hit counts, vectorized for a whole batch.

    labels_np: int32 [R, P] per-window labels (0 = miss).  Returns
    uint32 [R, n_targets+1] (column 0 unused) — the dense columns the
    reference reconstructs per read from sparse rows
    (src/CuCLARK_hh.hh:2014-2031), built here with ONE bincount over
    the batch instead of a per-read unique loop."""
    R, P = labels_np.shape
    T1 = n_targets + 1
    out = np.empty((R, T1), np.uint32)
    # block the rows so the int64 bincount intermediate stays bounded
    # (~128 MB) even at MTRGTS-scale target sets; the uint32 output is
    # the inherent cost of extended mode's dense columns
    block = max(1, (1 << 24) // T1)
    for lo in range(0, R, block):
        sub = labels_np[lo:lo + block]
        r = sub.shape[0]
        flat = sub.ravel()
        m = flat > 0
        rid = np.repeat(np.arange(r, dtype=np.int64), P)[m]
        key = rid * T1 + flat[m].astype(np.int64)
        c = np.bincount(key, minlength=r * T1)
        out[lo:lo + r] = c.reshape(r, T1).astype(np.uint32)
    return out


def _prefetch(gen, depth: int = 2):
    """Run a generator in a background thread with a bounded queue.

    The packer's hot loops (numpy/native) release the GIL, so scanning
    and packing batch i+1 genuinely overlaps device compute and CSV
    formatting of batch i — the role of the reference's OpenMP batch
    threads (src/CuCLARK_hh.hh:1609-1763)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        # bounded put that gives up once the consumer is gone, so an
        # abandoned generator cannot pin the worker thread (and the
        # file-sized buffers its frames hold) forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # propagate into the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _read_file_bytes(path) -> np.ndarray:
    # plain files read straight into the array (one copy less than
    # read()+frombuffer); gzip goes through the decompressing reader
    with open(path, "rb") as probe_f:
        is_gz = probe_f.read(2) == b"\x1f\x8b"
    if not is_gz:
        return np.fromfile(path, dtype=np.uint8)
    from cuclark_tpu_torch.io.fasta import _open

    with _open(path) as f:
        data = f.read()
    return np.frombuffer(data, dtype=np.uint8)
