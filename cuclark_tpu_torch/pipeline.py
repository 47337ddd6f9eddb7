"""End-to-end classification pipeline on one torch device or a mesh.

Counterpart of `cuclark_tpu/pipeline.py`: `classify_step` (:48),
`classify_step_packed` (:71), the `Classifier` on one device or on a
mesh (`parallel.mesh`; resident and DB-part streaming: `_plan_parts`
:339, `_effective_stream_group` :310, `_stream_group_dev` :689, the
scan with per-host sharding and paired packing :417-521, `classify_file`
:524, `classify_file_to_csv` :571, `classify_records` :896), and the
host helpers `CsvSink`, `_prefetch`, `dense_counts`, `DEFAULT_LEN_BINS`,
carried over.

The host scans and packs reads (single-end, or mate 1 + N + mate 2) into
the 2-bit wire format in a background thread, which also starts the
host-to-device copy from pinned memory; the main thread launches the
kernels on the current stream and starts the copy of the [R, 5] results
(and, in extended mode, the [R, P] labels) back into pinned memory; a
writer thread waits for those copies and formats the CSV natively.

A table that fits the device budget (memplan) is resident and each batch
runs the query and score kernels.  A larger one streams: its main rows
go to the card in power-of-two bucket-range parts per group of batches,
each part probed by the part-mode query kernel into label accumulators
on the device, then the score kernel runs on the sums (`_PartStream`).
With `device="cpu"` the same paths run the kernels' plain PyTorch
versions.  Every layout (qs, q4, s2) takes both paths; only qs has a
stash, which stays resident while its main rows stream.

On a mesh the table's rows shard over the db axis and each batch's rows
over the data axis (`parallel.mesh`); when even a device's shard exceeds
the budget, each device streams its shard of every part (the reference's
cycles x devices x parts).  A batch's device results are then a list of
blocks, one per data index, which the readback concatenates.  Without
labels, a batch of reads of up to 1,024 windows (`probe.fuses_score`)
ends in the fused query and score: resident, in each block of a mesh,
and on a streamed table's last part, on a mesh or on one device.
"""

from __future__ import annotations

import functools
import os
import stat

import numpy as np
import torch

from cuclark_tpu_torch import probe, score, spans
from cuclark_tpu_torch.config import ClassifyConfig
from cuclark_tpu_torch.hashdb import KmerDB, TableSpec, table_to_device

# Length bins: a read is packed into the smallest bin holding it, so a
# batch of short reads never pays for a rare long read; the 152 bin
# puts Illumina-length reads at 122 windows instead of 160's 130.
DEFAULT_LEN_BINS = (128, 152, 160, 192, 256, 320, 512, 1024, 2048, 4096,
                    16384)


def classify_step(table, codes, *, k, spec: TableSpec, stash=None,
                  with_labels=True):
    """One device step on unpacked codes: codes uint8 [R, L] (0..3, >= 4
    an N or padding) -> (results int32 [R, 5], labels int32 [R, L-k+1]
    or None), against the resident table as for classify_step_packed.
    A `step` span, as classify_step_packed's."""
    with spans.span("step") as s:
        if s:
            s.attrs = {"rows": codes.shape[0],
                       "windows": codes.shape[1] - k + 1,
                       "wire_bytes": codes.numel(), "fused": 0}
        labels = probe.query_codes_labels(codes, table, stash, k=k,
                                          spec=spec)
        results = score.score_labels(labels, spec.label_bound)
    return results, (labels if with_labels else None)


def classify_step_packed(table, packed2, vbits, *, k, spec: TableSpec,
                         stash=None, with_labels=True):
    """One device step on the 2-bit wire format: packed2 uint8
    [R, Lp/4], vbits uint8 [R, Lp/8] -> (results int32 [R, 5], labels
    int32 [R, P] or None).  `table` and `stash` are what
    hashdb.table_to_device gives for the layout `spec` (KmerDB.spec):
    the qs main rows [NB, 8] and stash rows [NBS, 8], or the q4 or s2
    rows with stash None.  Without labels, reads of up to 1,024 windows
    take the fused query and score (`probe.fuses_score`), on every
    layout: the same results, the labels never leaving the chip.

    Recorded, while per-batch spans are (`spans`), as a `step` span
    with attributes rows, windows (a row), wire_bytes and fused; each
    kernel launch in it is a `step.launch` child, so the step's self
    time is the routing, the operand checks and the results' allocation.
    """
    with spans.span("step") as s:
        fused = not with_labels and probe.fuses_score(packed2, k)
        if s:
            s.attrs = {"rows": packed2.shape[0],
                       "windows": 4 * packed2.shape[1] - k + 1,
                       "wire_bytes": packed2.numel() + vbits.numel(),
                       "fused": int(fused)}
        if fused:
            return probe.query_score_results(packed2, vbits, table, stash,
                                             k=k, spec=spec), None
        labels = probe.query_labels(packed2, vbits, table, stash, k=k,
                                    spec=spec)
        results = score.score_labels(labels, spec.label_bound)
    return results, (labels if with_labels else None)


class CsvSink:
    """CLARK-CSV output sink: native OpenMP row writing without printf
    from the card's results rows (csrc/host_ops.cpp
    format_results/format_results_ext), extended-mode
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

        # gamma and confidence are computed by the row writer itself
        # (`native.format_results`), as score.gamma_confidence would
        args = (results[:cnt], lengths[:cnt], self.db.k, self.paired, buf,
                ns[:cnt], ne[:cnt], self.tname_bytes, self.tname_off)
        if self.extended:
            counts = dense_counts(labels_np[:cnt],
                                  self.db.num_targets)[:, 1:]
            accumulate_hit_stats(self.hstats, (counts > 0).sum(axis=1))
            with spans.span("rows"):
                rows, _ = native.format_results_ext(counts, *args)
        else:
            with spans.span("rows"):
                rows, _ = native.format_results(*args)
        self.f.write(rows)
        self.total_rows += cnt

def print_hit_stats(hstats, rows: int) -> None:
    """The reference's extended-mode hit-stats line for `rows` reads
    from the [min, max, sum] triple (CuCLARK_hh.hh:2075-2080)."""
    if rows:
        import sys

        print(f"MIN targets: {hstats[0] or 0}, MAX targets: {hstats[1]}, "
              f"AVG targets: {hstats[2] / rows:g}", file=sys.stderr)


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


def _to_host_async(t):
    """Start the copy of a device tensor into pinned host memory; returns
    (host tensor, event to wait on, or None for a CPU tensor).  A list of
    a mesh's blocks gives a list."""
    if isinstance(t, list):
        return [_to_host_async(b) for b in t]
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _readback(out):
    """Start the copies to the host of a device step's (results, labels
    or None)."""
    results, labels = out
    return (_to_host_async(results),
            _to_host_async(labels) if labels is not None else None)


def _host_numpy(pending) -> np.ndarray:
    """Wait for a copy started by _to_host_async and return it as numpy
    (a mesh's blocks concatenated)."""
    if isinstance(pending, list):
        return np.concatenate([_host_numpy(b) for b in pending])
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


class _PinnedRows:
    """The host main rows of a streamed table, page-locked once in place
    with cudaHostRegister (portable: every card's uploads read them at
    the page-locked rate; no second host copy of the table)."""

    def __init__(self, main_np: np.ndarray):
        self.rows = torch.from_numpy(main_np.view(np.int32))
        nbytes = self.rows.numel() * 4
        err = int(torch.cuda.cudart().cudaHostRegister(
            self.rows.data_ptr(), nbytes, 1))  # cudaHostRegisterPortable
        if err != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes / 1e6:.0f} MB "
                               f"of main rows failed: CUDA error {err}")

    def close(self) -> None:
        torch.cuda.cudart().cudaHostUnregister(self.rows.data_ptr())


class _PartStream:
    """The card's side of DB-part streaming for one device: two
    preallocated device buffers and a dedicated copy stream.  Part p's
    rows are host rows [p * rows + offset, p * rows + offset + nrows) of
    the page-locked main rows (the whole part on one device, or one db
    shard of it on a mesh).  Part p+2 uploads into the buffer part p was
    read from; CUDA events order the two streams: an upload into a buffer
    waits for the last kernel that read it, and a probe waits for its
    upload.  The host thread never blocks on either (the reference's
    async swap of DB parts, src/CuClarkDB.cu:813-858)."""

    def __init__(self, host: torch.Tensor, parts: int, device,
                 offset: int = 0, nrows: int | None = None):
        self.device = torch.device(device)
        self.host = host
        self.parts = parts
        self.rows = host.shape[0] // parts
        self.offset = offset
        self.nrows = self.rows if nrows is None else nrows
        self.row_words = host.shape[1]
        self.copy_stream = torch.cuda.Stream(self.device)
        self.bufs = [torch.empty((self.nrows, self.row_words),
                                 dtype=torch.int32, device=self.device)
                     for _ in range(2)]
        for b in self.bufs:
            # written on the copy stream, read on the compute stream
            b.record_stream(self.copy_stream)
        self._read_done = [None, None]   # event after the last probe
        self._uploads = []               # (start, end) events per part

    def _upload(self, p: int) -> torch.cuda.Event:
        i = p % 2
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        lo = p * self.rows + self.offset
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream), \
                spans.span("part_upload") as s:
            if s:
                s.attrs = {"part": p,
                           "bytes": self.nrows * self.row_words * 4}
            if self._read_done[i] is not None:
                self.copy_stream.wait_event(self._read_done[i])
            start.record(self.copy_stream)
            self.bufs[i].copy_(self.host[lo:lo + self.nrows],
                               non_blocking=True)
            done.record(self.copy_stream)
        self._uploads.append((start, done))
        return done

    def parts_on_device(self):
        """Yield (part index, device rows) for every part, in order; the
        caller launches its probes of a part on the current stream
        before asking for the next."""
        compute = torch.cuda.current_stream(self.device)
        self._uploads = []
        pending = [self._upload(p) for p in range(min(2, self.parts))]
        for p in range(self.parts):
            compute.wait_event(pending[p])
            yield p, self.bufs[p % 2]
            done = torch.cuda.Event()
            done.record(compute)
            self._read_done[p % 2] = done
            if p + 2 < self.parts:
                pending.append(self._upload(p + 2))

    def upload_gbps(self) -> list[float]:
        """Host-to-device rate of each part upload of the last group,
        GB/s from the copy stream's events (waits for them)."""
        nbytes = self.nrows * self.row_words * 4
        out = []
        for start, done in self._uploads:
            done.synchronize()
            out.append(nbytes / (start.elapsed_time(done) * 1e6))
        return out

    def close(self) -> None:
        torch.cuda.synchronize(self.device)
        self.bufs = []


def _pad_rows(wire, multiple: int):
    """A wire batch padded with zero rows (zero validity bits:
    all-invalid reads, which score all zeros) to a multiple of
    `multiple` rows; the caller trims results by the real count."""
    p2, vb = wire
    pad = -p2.shape[0] % multiple
    if not pad:
        return p2, vb
    return (np.pad(p2, ((0, pad), (0, 0))), np.pad(vb, ((0, pad), (0, 0))))


# batches in `_prefetch`'s queue
PREFETCH_DEPTH = 2
# wire batches a card's producer packs without waiting on a copy: those
# in the prefetch queue, the one the consumer took last and the one
# being packed (a slot whose copy is still queued behind device steps is
# waited for)
WIRE_RING_SLOTS = PREFETCH_DEPTH + 1 + 1


class _WireRing:
    """The host buffers a producer packs wire batches into, a ring of
    `slots`: pinned on a card, so that the host-to-device copy reads the
    pack's output in place, with no second host copy.  A slot holds a
    batch's packed2 and vbits back to back in one buffer, so one copy
    uploads both.  `acquire` hands a slot out again only after the event
    recorded behind its last copy has completed, and waits for it on
    the calling (producer) thread.  `stream` gives the stream the copies
    are issued on; `pin=False` gives plain tensors and `event` makes the
    events (stand-ins in tests)."""

    def __init__(self, slots: int, stream, pin: bool = True, event=None):
        self._stream = stream
        self._pin = pin
        self._event = event or torch.cuda.Event
        self._bufs = [None] * slots     # a flat uint8 buffer a slot
        self._views = [None] * slots    # ((rows, w2, wv), packed2, vbits)
        self._events = [None] * slots   # made at a slot's first copy
        self._pending = [False] * slots  # a copy not yet waited for
        self._next = 0

    def acquire(self, rows: int, w2: int, wv: int):
        """(slot, packed2 [rows, w2], vbits [rows, wv]): numpy views of the
        next slot's buffer, grown to fit, once its last copy has
        completed.  A batch of the last shape reuses the slot's views."""
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._pending[slot]:
            ev = self._events[slot]
            if not ev.query():
                ev.synchronize()
            self._pending[slot] = False
        views = self._views[slot]
        if views is None or views[0] != (rows, w2, wv):
            n2, nv = rows * w2, rows * wv
            buf = self._bufs[slot]
            if buf is None or buf.numel() < n2 + nv:
                buf = self._bufs[slot] = torch.empty(
                    n2 + nv, dtype=torch.uint8, pin_memory=self._pin)
            flat = buf[:n2 + nv].numpy()
            views = self._views[slot] = ((rows, w2, wv),
                                         flat[:n2].reshape(rows, w2),
                                         flat[n2:].reshape(rows, wv))
        return slot, views[1], views[2]

    def upload(self, slot: int, device):
        """(packed2, vbits) on `device`: the slot's batch in one
        non-blocking copy, with the event `acquire` waits for recorded
        behind it on the copy stream."""
        (rows, w2, wv), _, _ = self._views[slot]
        n2 = rows * w2
        dev = self._bufs[slot][:n2 + rows * wv].to(device, non_blocking=True)
        if self._events[slot] is None:
            self._events[slot] = self._event()
        self._events[slot].record(self._stream())
        self._pending[slot] = True
        return dev[:n2].view(rows, w2), dev[n2:].view(rows, wv)


class Classifier:
    """Holds the DB on one torch device ("cuda", "cuda:N" or "cpu") or on
    a mesh of them (`parallel.mesh.Mesh`; `device` is then its first
    device), and runs batched classification: the table resident when it
    (or, on a mesh, each device's db shard) fits the device budget, else
    streamed in bucket-range parts."""

    # Device-memory guard: batch_rows x padded_length is capped so a
    # stretch of very long reads (nanopore-scale) shrinks the batch
    # instead of exploding the padded code matrix / label arrays.
    MAX_BATCH_CELLS = 65536 * 512

    def __init__(self, db: KmerDB, cfg: ClassifyConfig | None = None,
                 len_bins=DEFAULT_LEN_BINS, device="cuda", mesh=None):
        self.db = db
        self.cfg = cfg or ClassifyConfig()
        self.len_bins = tuple(sorted(len_bins))
        self.mesh = mesh
        self.device = torch.device(
            device if mesh is None else mesh.devices[0][0])
        self.stream_parts = 1
        self.stream_group_eff = self.cfg.stream_group
        self._sharded = None  # parallel.mesh.ShardedClassifier, resident
        self._pinned = None   # _PinnedRows of a streamed table on a card
        self._streams = []    # ((device, db column), _PartStream) on a card
        # the pinned buffers a card's file path packs into (no mesh: the
        # mesh pads and places its batches from plain arrays)
        self._ring = None
        self.spec = db.spec
        self.spec.check()
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.device} requested but "
                    f"torch.cuda.is_available() is False")
            if mesh is None:
                self._ring = _WireRing(WIRE_RING_SLOTS, functools.partial(
                    torch.cuda.current_stream, self.device))
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        with spans.span("classifier.place", always=True):
            self._place(db, mesh)

    def _place(self, db: KmerDB, mesh) -> None:
        """The table on the device, resident or set up to stream (the
        `classifier.place` span: memplan and table_to_device)."""
        from cuclark_tpu_torch.memplan import resolve_table_budget_mb

        # Explicit --max-table-mb, else the device's free memory less a
        # reserve (the reference's free-VRAM probe + RESERVED,
        # src/CuClarkDB.cu:540-574); None = unbounded (the CPU).  On a
        # mesh the budget is per device.
        self.table_budget_mb = resolve_table_budget_mb(self.cfg.max_table_mb,
                                                       self.device)
        num_db = mesh.num_db if mesh is not None else 1
        main_np, stash_np = db.split_tables()
        self.stream_parts = self._plan_parts(main_np, stash_np, num_db)
        if self.stream_parts == 1:
            if mesh is None:
                self.table, self.stash = table_to_device(db, self.device)
                return
            from cuclark_tpu_torch.parallel.mesh import ShardedClassifier

            self._sharded = ShardedClassifier(db, mesh,
                                              with_labels=self.cfg.extended)
            self.table, self.stash = self._sharded.table, self._sharded.stash
            return
        # DB streaming (reference swap-cycle analog): the main rows stay
        # on the host and stream in power-of-two bucket-range parts per
        # batch group; a qs table's small stash stays resident (on a
        # mesh, row-sharded over the db axis)
        self.table = None
        self.np_table = np.ascontiguousarray(main_np)
        self.np_stash = (np.ascontiguousarray(stash_np)
                         if stash_np is not None else None)
        self.stream_group_eff = self._effective_stream_group()
        rows = self.np_table.shape[0] // self.stream_parts
        if mesh is None:
            self.stash = (torch.from_numpy(self.np_stash.view(np.int32)).to(
                self.device) if self.np_stash is not None else None)
        else:
            from cuclark_tpu_torch.parallel.mesh import (
                build_sharded_probe_part, shard_rows)

            self.stash = (shard_rows(self.np_stash, mesh)
                          if self.np_stash is not None else None)
            self._mesh_part_step = build_sharded_probe_part(
                mesh, k=db.k, spec=self.spec, nb_part=rows)
        if self.device.type == "cuda":
            self._pinned = _PinnedRows(self.np_table)
            if mesh is None:
                self._streams = [((self.device, 0), _PartStream(
                    self._pinned.rows, self.stream_parts, self.device))]
            else:
                # one pair of buffers and a copy stream for each (device,
                # db column): handles of one card in two columns need both
                # shards of every part
                nb_local = rows // num_db
                keys = dict.fromkeys((dev, j) for row in mesh.devices
                                     for j, dev in enumerate(row))
                self._streams = [(key, _PartStream(
                    self._pinned.rows, self.stream_parts, key[0],
                    (mesh.db_start + key[1]) * nb_local, nb_local))
                    for key in keys]

    def close(self) -> None:
        """Wait for the card, then release the streamed table's device
        buffers and the page-locking of its host rows."""
        for _, st in self._streams:
            st.close()
        self._streams = []
        self._ring = None
        if self._pinned is not None:
            self._pinned.close()
            self._pinned = None

    def __del__(self):  # best effort; close() is the deliberate path
        try:
            self.close()
        except Exception:
            pass

    def _effective_stream_group(self) -> int:
        """Batch-group size for DB-part streaming: at least
        cfg.stream_group, grown to fill the device's free memory with
        on-device label accumulators so the table restreams as rarely
        as possible.  The reference re-queries ALL prepared batches per
        swap cycle (src/CuCLARK_hh.hh:1766-1774); this is the same idea
        bounded by device memory.  Sized against the worst-case
        per-batch footprint (MAX_BATCH_CELLS int32 accumulator + wire
        bytes), so mixed length bins can never overshoot; the CPU keeps
        the configured value."""
        from cuclark_tpu_torch.memplan import device_memory_budget_mb

        base = self.cfg.stream_group
        dev_mb = device_memory_budget_mb(self.device)
        if dev_mb is None:
            return base
        per_batch = int(self.MAX_BATCH_CELLS * 4.5)  # acc + wire, bytes
        # PER-DEVICE residency: on a db-mesh each device holds only its
        # row shard of a part (and of the stash)
        num_db = self.mesh.num_db if self.mesh is not None else 1
        part = self.np_table.nbytes // self.stream_parts // num_db
        stash = (self.np_stash.nbytes // num_db
                 if self.np_stash is not None else 0)
        avail = dev_mb * 1e6 - 2 * part - stash
        # NOT np.clip: with base > 512 numpy's a_min > a_max rule would
        # silently return 512 and break the "at least cfg.stream_group"
        # contract; an explicitly larger configured group is honored
        return max(base, min(int(avail // per_batch), 512))

    def _plan_parts(self, main_np, stash_np, num_db: int) -> int:
        """Streaming-part plan honoring the REAL device footprint: the
        part uploads are double-buffered (part p+1 transfers while part
        p computes, so TWO parts are resident at once) and a qs stash
        (stash_np; None for q4 and s2) stays resident on top; both come
        off the budget and only the main rows are planned against the
        rest.  On a mesh of num_db db shards each device holds 1/num_db
        of the stash and of every part."""
        from cuclark_tpu_torch.memplan import plan_stream_parts

        budget = self.table_budget_mb
        if budget is not None:
            if stash_np is not None:
                left = budget - stash_np.nbytes / num_db / 1e6
                # stash alone past the stated budget: the plan is
                # infeasible either way; keep the unadjusted budget
                # (best effort)
                budget = left if left > 0 else budget
            # halve for the double-buffered part uploads, but only when
            # streaming is needed at all (a resident table has none)
            if plan_stream_parts(main_np.nbytes, budget, num_db,
                                 main_np.shape[0]) > 1:
                budget = budget / 2
        return plan_stream_parts(main_np.nbytes, budget, num_db,
                                 main_np.shape[0])

    def part_upload_gbps(self) -> list[float]:
        """GB/s of each part upload of the last streamed group on the
        card, device by device (empty for a resident table or the
        CPU)."""
        return [g for _, st in self._streams for g in st.upload_gbps()]

    def _bin_for(self, max_len: int) -> int:
        for b in self.len_bins:
            if max_len + 1 <= b:  # +1 so L >= k always and P >= 1
                return b
        return int(np.ceil((max_len + 1) / 128) * 128)

    def _bin_for_range(self, s, e, s2=None, e2=None) -> int:
        if s2 is not None:
            # max of the PER-RECORD combined lengths, the same metric
            # the MAX_BATCH_CELLS shrink loop uses; summing separate
            # maxima could pick a bin up to 2x larger and overshoot the
            # cell cap when mate lengths vary
            mx = int(((e - s) + (e2 - s2) + 1).max(initial=1))
        else:
            mx = int((e - s).max(initial=1))
        return max(self._bin_for(mx), self.db.k)

    def _put_wire(self, wire, slot=None):
        """Start the host->device transfer of a wire batch, from pinned
        memory without blocking.  Called from the producer (prefetch)
        thread so the copy overlaps formatting of earlier batches.  A
        batch packed into ring slot `slot` (`wire` is its views) is copied
        from there in one copy (`_WireRing.upload`); another batch is
        copied into pinned memory first.  On a
        mesh the batch pads with all-invalid rows to the data axis and
        its row blocks go to their devices (`parallel.mesh.place_wire`)."""
        if slot is not None:
            return self._ring.upload(slot, self.device)
        if self.mesh is not None:
            from cuclark_tpu_torch.parallel.mesh import place_wire

            return place_wire(self.mesh, *_pad_rows(wire,
                                                    self.mesh.num_data))
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(a) for a in wire)
        return tuple(torch.from_numpy(a).pin_memory().to(
            self.device, non_blocking=True) for a in wire)

    def _device_step(self, wire):
        """Launch one device step on a wire batch already on the device
        against the resident table -> (results int32 [R, 5], labels
        int32 [R, P] in extended mode else None) on the device; on a mesh
        each is a list of data blocks."""
        if self._sharded is not None:
            return self._sharded.step_placed(wire)
        packed2, vbits = wire
        return classify_step_packed(
            self.table, packed2, vbits, k=self.db.k, spec=self.spec,
            stash=self.stash, with_labels=self.cfg.extended)

    def _stream_group_dev(self, wires):
        """Stream DB parts over a group of wire batches already on the
        device (the reference multi-cycle path: swap part, re-query
        every batch, src/CuCLARK_hh.hh:1766-1774) and merge partial
        labels by sum: every k-mer lives in exactly one part (each hash
        choice is range-checked on its own), and a qs table's resident
        stash is split over the parts (`probe.stash_range`; on a mesh
        each db shard's stash range).  The labels
        accumulate in place on the device, and on the card part p+1
        uploads while part p probes (_PartStream).  Without labels, the
        last part of a batch that fuses (`probe.fuses_score`) is the
        fused range launch, which adds the earlier parts' sum and scores
        it: no score launch for that batch.  Returns (results, labels in
        extended mode else None) per batch, on the device."""
        rows = self.np_table.shape[0] // self.stream_parts
        ext = self.cfg.extended
        acc = [None] * len(wires)
        last = self.stream_parts - 1
        if self.mesh is not None:
            # each part row-sharded over 'db', each batch over 'data'
            # (cycles x devices x parts): the sharded part step sums a
            # batch's shards into its blocks' accumulators; the last part
            # of a batch that fuses, without labels, ends each block in
            # the fused launch, which scores the sum
            fused = [not ext and not self.mesh.spans_processes
                     and probe.fuses_score(w[0][0][0], self.db.k)
                     for w in wires]
            out = [None] * len(wires)
            for p, part in self._mesh_parts():
                for gi, w in enumerate(wires):
                    res = self._mesh_part_step(
                        part, w, p * rows, stash=self.stash, acc=acc[gi],
                        scored=p == last and fused[gi],
                        split=(p, self.stream_parts))
                    if p == last and fused[gi]:
                        out[gi] = (res, None)
                    else:
                        acc[gi] = res
            return [out[gi] or ([score.score_labels(a, self.spec.label_bound)
                                 for a in blocks], blocks if ext else None)
                    for gi, blocks in enumerate(acc)]
        if self._streams:
            parts = self._streams[0][1].parts_on_device()
        else:
            parts = ((p, torch.from_numpy(
                self.np_table[p * rows:(p + 1) * rows].view(np.int32)))
                for p in range(self.stream_parts))
        fused = [not ext and probe.fuses_score(p2, self.db.k)
                 for p2, _ in wires]
        out = [None] * len(wires)
        for p, part in parts:
            stash, stash_start = probe.stash_range(self.stash, p,
                                                   self.stream_parts)
            for gi, (p2, vb) in enumerate(wires):
                args = dict(bucket_start=p * rows, nb_local=rows,
                            k=self.db.k, spec=self.spec,
                            stash_start=stash_start)
                if p == last and fused[gi]:
                    out[gi] = (probe.query_score_part_results(
                        p2, vb, part, stash, acc_in=acc[gi], **args), None)
                else:
                    acc[gi] = probe.query_part_labels(p2, vb, part, stash,
                                                      acc=acc[gi], **args)
        return [out[gi] or (score.score_labels(a, self.spec.label_bound),
                            a if ext else None)
                for gi, a in enumerate(acc)]

    def _mesh_parts(self):
        """Yield (part index, [d][j] device rows of the part's db shards)
        for every part: on the card from each (device, column)'s
        _PartStream, stepped together; on the CPU as views of the host
        rows."""
        from cuclark_tpu_torch.parallel.mesh import place_columns

        rows = self.np_table.shape[0] // self.stream_parts
        nb_local = rows // self.mesh.num_db
        if not self._streams:
            for p in range(self.stream_parts):
                lo = p * rows
                yield p, place_columns(self.mesh, lambda j: self.np_table[
                    lo + j * nb_local:lo + (j + 1) * nb_local])
            return
        gens = [(key, st.parts_on_device()) for key, st in self._streams]
        for p in range(self.stream_parts):
            bufs = {key: next(g)[1] for key, g in gens}
            yield p, [[bufs[(dev, j)] for j, dev in enumerate(row)]
                      for row in self.mesh.devices]
        for _, g in gens:
            next(g, None)  # records the last part's read-done event

    def _grouped(self, batches):
        """Group (wire, ...) items by stream_group_eff for streaming."""
        group = []
        for item in batches:
            group.append(item)
            if len(group) >= self.stream_group_eff:
                yield group
                group = []
        if group:
            yield group

    # ---------- file fast path ----------

    def _scan_for_classify(self, path, paired_path, skip: int,
                           num_hosts: int = 1, host_id: int = 0):
        """Scan a classify job's input file(s) -> (buf, buf2, name_s,
        name_e, seq_s, seq_e, seq_s2, seq_e2), skipping the first `skip`
        records; buf2 and the mate offsets are None without a mate file.
        With num_hosts > 1 only host `host_id`'s records: a plain input
        is read by byte range (`parallel.multihost.read_host_slice`), a
        paired one is scanned whole and sharded by record index, so mate
        files stay aligned."""
        from cuclark_tpu_torch.io import fast_parse

        rec_lo = 0
        n1_total = None  # full record count of file 1 (paired check)
        if num_hosts > 1 and paired_path is None:
            from cuclark_tpu_torch.parallel import multihost

            buf, name_s, name_e, seq_s, seq_e = multihost.read_host_slice(
                path, num_hosts, host_id)
        else:
            buf = _read_file_bytes(path)
            name_s, name_e, seq_s, seq_e = fast_parse.scan_file(buf)
            n1_total = len(name_s)
            if num_hosts > 1:
                per = n1_total // num_hosts
                rec_lo = per * host_id
                rec_hi = (n1_total if host_id == num_hosts - 1
                          else per * (host_id + 1))
                name_s, name_e = name_s[rec_lo:rec_hi], name_e[rec_lo:rec_hi]
                seq_s, seq_e = seq_s[rec_lo:rec_hi], seq_e[rec_lo:rec_hi]
        if skip:
            name_s, name_e = name_s[skip:], name_e[skip:]
            seq_s, seq_e = seq_s[skip:], seq_e[skip:]
        if paired_path is None:
            return buf, None, name_s, name_e, seq_s, seq_e, None, None
        buf2 = _read_file_bytes(paired_path)
        ns2, ne2, seq_s2, seq_e2 = fast_parse.scan_file(buf2)
        # mergePairedFiles parity (src/file.cc:205-268): hard error on
        # differing record counts or mismatched mate ids instead of
        # silently zipping by order; FULL file counts, so truncation
        # hard-errors on sharded and resumed runs too
        if n1_total != len(seq_s2):
            raise ValueError(
                f"paired files have different record counts: {path} has "
                f"{n1_total}, {paired_path} has {len(seq_s2)}")
        first = rec_lo + skip
        with spans.span("mate_check"):
            bad = fast_parse.first_mate_mismatch(buf, name_s, name_e, buf2,
                                                 ns2[first:], ne2[first:])
        if bad >= 0:
            n1 = buf[name_s[bad]:name_e[bad]].tobytes().decode(
                "ascii", "replace")
            i2 = first + bad
            n2 = buf2[ns2[i2]:ne2[i2]].tobytes().decode("ascii", "replace")
            raise ValueError(f"read id does not match between files at "
                             f"record {i2}: {n1!r} vs {n2!r}")
        n = len(seq_s)
        seq_s2, seq_e2 = seq_s2[first:first + n], seq_e2[first:first + n]
        return buf, buf2, name_s, name_e, seq_s, seq_e, seq_s2, seq_e2

    def _packed_batches(self, buf, buf2, name_s, name_e, seq_s, seq_e,
                        seq_s2, seq_e2):
        """Yield (wire, (ns, ne), lengths, cnt, batch id) batches, the
        wire in the 2-bit wire format (codec.pack_codes layout) and its
        transfer to the device started (`_put_wire`); a pair is packed as
        mate 1, a joining N, mate 2.  On a card (no mesh) each batch is
        packed straight into a slot of the pinned ring.  The batch id
        (`spans.new_batch`, None while no span records) is carried by the
        batch's `ring_acquire`, `pack` and `put_wire` spans here and by
        its spans on the other threads."""
        from cuclark_tpu_torch import native
        from cuclark_tpu_torch.io import fast_parse

        paired = buf2 is not None
        B = self.cfg.batch_reads
        raw_len = seq_e - seq_s
        if paired:
            raw_len = raw_len + (seq_e2 - seq_s2) + 1
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
            if paired:
                L = self._bin_for_range(seq_s[lo:hi], seq_e[lo:hi],
                                        seq_s2[lo:hi], seq_e2[lo:hi])
            else:
                L = self._bin_for_range(seq_s[lo:hi], seq_e[lo:hi])
            slot = out = None
            bid = spans.new_batch()
            if self._ring is not None:
                with spans.span("ring_acquire", bid):
                    slot, p2, vb = self._ring.acquire(
                        cnt, *native.wire_shape(L))
                out = (p2, vb, np.empty(cnt, np.int64))
            with spans.span("pack", bid):
                if paired:
                    p2, vb, lengths = fast_parse.pack_block2_paired_dispatch(
                        buf, seq_s[lo:hi], seq_e[lo:hi],
                        buf2, seq_s2[lo:hi], seq_e2[lo:hi], L, n_rows=cnt,
                        out=out)
                else:
                    p2, vb, lengths = fast_parse.pack_block2_dispatch(
                        buf, seq_s[lo:hi], seq_e[lo:hi], L, n_rows=cnt,
                        out=out)
            with spans.span("put_wire", bid):
                wire = self._put_wire((p2, vb), slot)
            yield wire, (name_s[lo:hi], name_e[lo:hi]), lengths, cnt, bid
            lo = hi

    def classify_file(self, path, paired_path=None, skip: int = 0,
                      num_hosts: int = 1, host_id: int = 0):
        """Yield result rows (dicts, see _emit_np) for a whole
        FASTA/FASTQ file, optionally with a mate file merged with a
        joining N.  skip: number of leading records to skip.
        num_hosts/host_id: only this host's record shard (shards
        concatenate in rank order)."""
        from collections import deque

        from cuclark_tpu_torch.io import fast_parse

        with spans.span("read_scan"):
            buf, buf2, *scan = self._scan_for_classify(
                path, paired_path, skip, num_hosts, host_id)
        paired = buf2 is not None

        def packed():
            for wire, (ns, ne), lengths, cnt, _ in self._packed_batches(
                    buf, buf2, *scan):
                yield wire, fast_parse.names_of(buf, ns, ne), lengths, cnt

        if self.stream_parts > 1:
            for group in self._grouped(_prefetch(packed())):
                yield from self._classify_group_streaming(group, paired)
            return
        # keep a few batches in flight so host packing/formatting and
        # transfers overlap device compute (the reference's pipeline
        # scheduler role, src/CuCLARK_hh.hh:1738-1761)
        inflight = deque()
        for wire, names, lengths, cnt in _prefetch(packed()):
            inflight.append((_readback(self._device_step(wire)), names,
                             lengths, cnt))
            if len(inflight) > 3:
                yield from self._emit(*inflight.popleft(), paired)
        while inflight:
            yield from self._emit(*inflight.popleft(), paired)

    def classify_file_to_csv(self, path, out_path, paired_path=None,
                             skip: int = 0, num_hosts: int = 1,
                             host_id: int = 0, append: bool = False,
                             print_stats: bool = True) -> int:
        """Classify a file (optionally with a mate file) straight into a
        CLARK CSV using the native row formatter, the fast path for the
        CLI.  Falls back to the per-row dict path when the native module
        is unavailable.  skip: number of leading records to skip (resume
        support).  num_hosts/host_id: only this host's record shard.
        In extended mode the hit stats of the file are kept in
        `self.hit_stats` ([min, max, sum], rows) and printed unless
        print_stats is False (a multi-process job prints one line for
        every rank).  Returns the number of reads written."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from cuclark_tpu_torch import native

        extended = self.cfg.extended
        if not native.available():
            return self._classify_file_to_csv_rows(
                path, out_path, paired_path, skip, num_hosts, host_id,
                append, print_stats)

        with spans.span("read_scan"):
            buf, buf2, *scan = self._scan_for_classify(
                path, paired_path, skip, num_hosts, host_id)

        with open(out_path, "ab" if append else "wb") as f:
            sink = CsvSink(f, self.db, extended, buf2 is not None)
            if not append:
                sink.write_header()

            def flush_one(pending, ns, ne, lengths, cnt, bid):
                res, lab = pending
                with spans.span("readback_wait", bid):
                    res = _host_numpy(res)
                    lab = _host_numpy(lab) if lab is not None else None
                with spans.span("flush_write", bid):
                    sink.flush(res, lab, buf, ns, ne, lengths, cnt)

            # Third pipeline stage: the D2H wait + CSV formatting + file
            # write run on a single writer thread (in submission order,
            # so rows stay ordered), overlapping the main thread's
            # kernel launches: the reference's "one thread starts
            # writing results while others still feed batches"
            # (src/CuCLARK_hh.hh:1755-1761).
            with ThreadPoolExecutor(1) as writer:
                futs = deque()

                def submit(out, ns, ne, lengths, cnt, bid):
                    with spans.span("readback_issue", bid):
                        pending = _readback(out)
                    futs.append(writer.submit(flush_one, pending, ns, ne,
                                              lengths, cnt, bid))

                def wait_writer():
                    with spans.span("writer_future_wait"):
                        futs.popleft().result()

                if self.stream_parts > 1:
                    # streaming on the same native writer path: stream
                    # the parts over a group, then flush its batches
                    for group in self._grouped(_prefetch(
                            self._packed_batches(buf, buf2, *scan))):
                        with spans.span("device_step"):
                            outs = self._stream_group_dev(
                                [item[0] for item in group])
                        for (_, (ns, ne), lengths, cnt, bid), out in zip(
                                group, outs):
                            submit(out, ns, ne, lengths, cnt, bid)
                        while len(futs) > 3:
                            wait_writer()
                else:
                    for wire, (ns, ne), lengths, cnt, bid in _prefetch(
                            self._packed_batches(buf, buf2, *scan)):
                        with spans.span("device_step", bid):
                            out = self._device_step(wire)
                        submit(out, ns, ne, lengths, cnt, bid)
                        if len(futs) > 3:
                            wait_writer()
                while futs:
                    wait_writer()
        self.hit_stats = (sink.hstats, sink.total_rows)
        if extended and print_stats:
            print_hit_stats(*self.hit_stats)
        return sink.total_rows

    def _classify_file_to_csv_rows(self, path, out_path, paired_path, skip,
                                   num_hosts, host_id, append,
                                   print_stats) -> int:
        """classify_file_to_csv without the native module: the per-row
        dict path and Python formatting, with the same extended-mode hit
        stats as CsvSink."""
        from cuclark_tpu_torch.io.csv_out import format_row, write_results

        n = 0
        hstats = [None, 0, 0]  # same triple CsvSink accumulates

        def counted(rows):
            nonlocal n
            for r in rows:
                n += 1
                if "target_counts" in r:
                    accumulate_hit_stats(
                        hstats, np.array([len(r["target_counts"])]))
                yield r

        rows = counted(self.classify_file(path, paired_path, skip=skip,
                                          num_hosts=num_hosts,
                                          host_id=host_id))
        names, extended = self.db.target_names, self.cfg.extended
        if append:
            with open(out_path, "a") as f:
                for row in rows:
                    f.write(format_row(row, names, extended))
        else:
            write_results(out_path, rows, names, extended=extended)
        self.hit_stats = (hstats, n)
        if extended and print_stats:
            print_hit_stats(hstats, n)
        return n

    def _classify_group_streaming(self, group, paired: bool):
        """Dict rows of a streamed group of (wire, names, lengths, cnt)."""
        outs = [_readback(o) for o in self._stream_group_dev(
            [w for w, _, _, _ in group])]
        for (_, names, lengths, cnt), pending in zip(group, outs):
            yield from self._emit(pending, names, lengths, cnt, paired)

    def _emit(self, pending, names, lengths, count, paired: bool):
        """Result dicts of one batch whose copies to the host were
        started by _readback."""
        res, lab = pending
        yield from self._emit_np(
            _host_numpy(res), _host_numpy(lab) if lab is not None else None,
            names, lengths, count, paired)

    def _emit_np(self, results, labels_np, names, lengths, count,
                 paired: bool):
        results = results[:count]  # drops a mesh's data-axis padding rows
        lengths = lengths[:count]
        total, ibest, best, isecond, second = (results[:, i] for i in range(5))
        norm, gamma, conf = score.gamma_confidence(
            total, best, second, lengths, self.db.k, paired)
        counts = (dense_counts(labels_np[:count], self.db.num_targets)
                  if labels_np is not None else None)
        for i in range(count):
            row = {
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
            if counts is not None:
                (t,) = np.nonzero(counts[i])
                row["target_counts"] = dict(
                    zip(t.tolist(), counts[i, t].tolist()))
            yield row

    # ---------- record-iterator path ----------

    def _record_batches(self, records):
        """Group records into batches honoring BOTH caps: count
        (batch_reads) and padded cells (MAX_BATCH_CELLS); long records
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

    def classify_records(self, records, paired: bool = False):
        """records: iterable of (name, seq_bytes); with paired=True each
        record is a merged pair (mate 1 + b"N" + mate 2, as
        io.fasta.read_paired_records yields them).

        Yields per-read result dicts in input order, one batch behind
        the device so packing overlaps the step."""
        batches = ((self._put_wire(wire), names, lengths, count)
                   for wire, names, lengths, count in map(
                       self._wire_records, self._record_batches(records)))
        if self.stream_parts > 1:
            for group in self._grouped(batches):
                yield from self._classify_group_streaming(group, paired)
            return
        inflight = None
        for wire, names, lengths, count in batches:
            pending = _readback(self._device_step(wire))
            if inflight is not None:
                yield from self._emit(*inflight, paired)
            inflight = (pending, names, lengths, count)
        if inflight is not None:
            yield from self._emit(*inflight, paired)


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


def _prefetch(gen, depth: int = PREFETCH_DEPTH):
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
        with spans.span("prefetch_put_wait"):
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
            with spans.span("prefetch_get_wait"):
                item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _inflate_plain(data) -> bytes:
    """The reference's inflate of a gzip input
    (`gzip.GzipFile(...).read()`, cuclark_tpu/pipeline.py's
    `_read_file_bytes`): the plain version `native.inflate` is held to,
    raising the reference's error on an input it rejects."""
    import gzip
    import io

    return gzip.GzipFile(fileobj=io.BytesIO(data)).read()


def _inflate(data) -> np.ndarray:
    """A gzip input's bytes, read-only, inflated on the OpenMP team
    (`native.inflate`).  An input the native inflater refuses goes to
    the plain version for the reference's error; were that version to
    read it, the two disagree and RuntimeError is raised (its bytes are
    never returned).  Without the native module (no compiler) the plain
    version inflates, as every native stage degrades to numpy."""
    from cuclark_tpu_torch import native

    if not native.available():
        return np.frombuffer(_inflate_plain(data), np.uint8)
    try:
        return native.inflate(data)
    except native.InflateRefused as refused:
        _inflate_plain(data)
        raise RuntimeError(f"the native inflater refused a gzip input "
                           f"the reference reads ({refused})") from refused


def _read_file_bytes(path) -> np.ndarray:
    """A classify input's bytes, read-only.  A regular uncompressed file
    is mapped (`np.memmap`, no copy: the scan's threads take its page
    faults), an empty one is an empty array (a map of 0 bytes raises),
    a gzip file is mapped and inflated on the OpenMP team (`_inflate`),
    and a FIFO or a device is read whole in one pass (it can be read
    only once: no probe, and `np.fromfile` cannot size it), then
    inflated the same way when it carries gzip.  The choice follows
    `os.stat`.  A mapped file that is truncated while the array lives
    ends the process with SIGBUS."""
    st = os.stat(path)
    if not stat.S_ISREG(st.st_mode):
        with open(path, "rb") as f:
            data = f.read()
        if data[:2] == b"\x1f\x8b":
            return _inflate_spanned(np.frombuffer(data, np.uint8))
        return np.frombuffer(data, dtype=np.uint8)
    if st.st_size == 0:
        return np.zeros(0, np.uint8)
    with open(path, "rb") as probe_f:
        is_gz = probe_f.read(2) == b"\x1f\x8b"
    buf = np.memmap(path, np.uint8, mode="r")
    return _inflate_spanned(buf) if is_gz else buf


def _inflate_spanned(data) -> np.ndarray:
    """`_inflate` in an `inflate` span whose attributes are the native
    inflater's counters (`native.inflate_counters`)."""
    from cuclark_tpu_torch import native

    with spans.span("inflate") as s:
        out = _inflate(data)
        if s and native.available():
            s.attrs = native.inflate_counters()
    return out
