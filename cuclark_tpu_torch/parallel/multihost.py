"""Multi-host execution: per-host input sharding + a multi-process engine.

Counterpart of `cuclark_tpu/parallel/multihost.py`.  The host-only
functions (`host_byte_range`, the FASTA and FASTQ record aligners,
`host_record_slice`, `shard_reads_for_host`, `_align_in_window`,
`read_host_slice`) are carried over unchanged: each host reads only its
byte range of a plain input file and scans forward to the first record
boundary (the reference's OpenMP byte-range scan,
src/CuCLARK_hh.hh:1339-1471, across hosts).

The JAX package runs one program over a global mesh of every process's
devices, so its processes step through the batches in lockstep.  Here
each process classifies its own record block on a mesh of its own
devices (`mesh.make_global_mesh`): the db axis stays inside a process, no
batch needs another process, and the only traffic between processes is
a few numbers: the agreed memory budget and the extended-mode hit
statistics.  Those go over `torch.distributed` with the gloo backend, as
all_gathers of small CPU tensors, on the main thread only and in the
same order on every rank.  No NCCL is needed.  The one mesh whose db
axis spans processes (`make_global_mesh` with num_db equal to the job's
device count) all-reduces each batch's labels over the same group; it
serves `mesh.ShardedClassifier` with replicated reads, and the engine
here rejects it, as the reference's does.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

# How long a rank waits for the others at start-up and in a collective.
COLLECTIVE_TIMEOUT_S = 300


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """torch.distributed bring-up with the gloo backend on
    tcp://<coordinator> (HOST:PORT; rank 0 listens there), no-op when
    single-process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("--num-processes above 1 needs --coordinator "
                         "HOST:PORT and --process-id")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def shutdown() -> None:
    """Leave the process group, so that no rank hangs at exit."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def process_count() -> int:
    return (torch.distributed.get_world_size()
            if torch.distributed.is_initialized() else 1)


def process_index() -> int:
    return (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)


def host_byte_range(file_size: int, num_hosts: int, host_id: int):
    """Even byte split; the scan then aligns each start to a record."""
    per = file_size // num_hosts
    start = per * host_id
    end = file_size if host_id == num_hosts - 1 else per * (host_id + 1)
    return start, end


def align_to_fasta_record(buf: np.ndarray, offset: int) -> int:
    """Scan forward from offset to the next '>' at a line start
    (reference FASTA batch split, src/CuCLARK_hh.hh:1363-1365).
    Vectorized: a Python per-byte loop costs ~135 ns/byte — minutes on
    the chromosome-scale records a pod shards."""
    n = len(buf)
    if offset == 0:
        return 0
    if offset >= n:
        return n
    cand = np.flatnonzero((buf[offset:] == ord(">"))
                          & (buf[offset - 1:n - 1] == ord("\n")))
    return int(offset + cand[0]) if len(cand) else n


def align_to_fastq_record(buf: np.ndarray, offset: int) -> int:
    """Scan forward from offset to the next FASTQ record start using the
    reference's lookahead heuristic (src/CuCLARK_hh.hh:1405-1471): among
    upcoming newline-following lines, a line starting with '@' whose
    line-after-next starts with '+' is a record header (quality lines
    may also start with '@', but never two rows before a '+').  A
    candidate whose '+' line cannot be verified (fewer than 3 lines
    remain) cannot begin a COMPLETE 4-line record either, so it is
    never accepted on faith — a final quality line starting with '@'
    (Q31) near a shard boundary must not be mistaken for a header."""
    n = len(buf)
    if offset == 0:
        return 0
    if offset >= n:
        return n
    # line starts at/after offset = newline positions + 1 (vectorized;
    # the per-byte Python walk took ~135 ns/byte on large records)
    nl = np.flatnonzero(buf[offset - 1:] == ord("\n"))
    starts = (offset - 1 + nl + 1)[:12]
    starts = starts[starts < n]
    for idx in range(len(starts)):
        s = int(starts[idx])
        if (buf[s] == ord("@") and idx + 2 < len(starts)
                and buf[int(starts[idx + 2])] == ord("+")):
            return s
    return n


def host_record_slice(buf: np.ndarray, num_hosts: int, host_id: int):
    """The [start, end) byte range of records owned by this host."""
    fmt_fastq = len(buf) > 0 and buf[0] == ord("@")
    align = align_to_fastq_record if fmt_fastq else align_to_fasta_record
    s0, e0 = host_byte_range(len(buf), num_hosts, host_id)
    start = align(buf, s0)
    end = align(buf, e0) if e0 < len(buf) else len(buf)
    return start, end


def shard_reads_for_host(buf: np.ndarray, num_hosts: int, host_id: int):
    """Scan only this host's record slice.

    Returns (name_s, name_e, seq_s, seq_e) absolute offsets into buf."""
    from cuclark_tpu_torch.io import fast_parse

    start, end = host_record_slice(buf, num_hosts, host_id)
    if start >= end:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    sub = buf[start:end]
    ns, ne, ss, se = fast_parse.scan_file(sub)
    return ns + start, ne + start, ss + start, se + start


def _align_in_window(path, size: int, pos: int, fmt_fastq: bool,
                     slack: int) -> int:
    """Absolute offset of the next record start at/after byte `pos`,
    reading only a window of the file.  The FASTQ heuristic looks ahead
    several lines, so a candidate found too close to the window edge is
    re-checked with a doubled window (a cut-off lookahead must never
    change the answer vs a whole-file scan)."""
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    align = align_to_fastq_record if fmt_fastq else align_to_fasta_record
    retries = 0
    while True:
        lo = pos - 1  # previous byte needed for the line-start check
        hi = min(size, pos + slack)
        w = np.fromfile(path, np.uint8, count=hi - lo, offset=lo)
        r = align(w, pos - lo)
        margin = slack // 2 if fmt_fastq else 0
        if hi >= size or r < len(w) - margin:
            return min(lo + r, size)
        # no verifiable record start inside the window (malformed input
        # near the boundary): doubling retries each re-read the window
        # from `pos`, so cap them — after a few misses one full-tail
        # read settles the answer instead of O(size log size) re-scans
        retries += 1
        slack = size if retries >= 3 else slack * 2


def read_host_slice(path, num_hosts: int, host_id: int,
                    slack: int = 1 << 25):
    """Read ONLY this host's record slice of a plain file from disk
    (+ bounded boundary slack) — the per-host byte-range I/O the
    multi-host design promises (a 16-host pod must not do 16 full-file
    reads).  Returns (buf_window, name_s, name_e, seq_s, seq_e) with
    offsets INTO the window.  Gzip streams are not range-addressable
    and fall back to a full read; partitioning is identical to
    shard_reads_for_host over the whole buffer."""
    import os

    from cuclark_tpu_torch.io import fast_parse

    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"\x1f\x8b":  # gzip
        from cuclark_tpu_torch.pipeline import _read_file_bytes

        buf = _read_file_bytes(path)
        return (buf,) + shard_reads_for_host(buf, num_hosts, host_id)
    size = os.path.getsize(path)
    fmt_fastq = head[:1] == b"@"
    s0, e0 = host_byte_range(size, num_hosts, host_id)
    start = _align_in_window(path, size, s0, fmt_fastq, slack)
    end = (size if e0 >= size
           else _align_in_window(path, size, e0, fmt_fastq, slack))
    if start >= end:
        z = np.zeros(0, np.int64)
        return np.zeros(0, np.uint8), z, z, z, z
    w = np.fromfile(path, np.uint8, count=end - start, offset=start)
    return (w,) + fast_parse.scan_file(w)


def _gather(values: np.ndarray) -> np.ndarray:
    """all_gather of a small vector over the process group -> [nproc,
    len] (single-process: [1, len])."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    if process_count() <= 1:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t)
    return torch.stack(out).numpy()


def _gather_rows_i64(values: np.ndarray) -> np.ndarray:
    """Allgather a small int64 vector: returns [nproc, len(values)]
    (single-process: [1, len])."""
    return _gather(np.asarray(values, np.int64))


def agree_budget_mb(budget_mb: float | None) -> float | None:
    """Global MIN of the per-process device memory budgets (None =
    unbounded).  Live per-process memory stats differ (two ranks on one
    card each see the other's table); agreeing on the tightest budget
    once gives every process the same memory plan: mesh shape, stream
    parts and group size."""
    if process_count() <= 1:
        return budget_mb
    inf = float(1 << 60)
    g = _gather(np.array([budget_mb if budget_mb is not None else inf],
                         np.float64))
    m = float(g.min())
    return None if m >= inf else m


class GlobalClassifier:
    """Reusable multi-process classification engine
    (`cuclark_tpu.parallel.multihost.GlobalClassifier`).

    Holds this process's `pipeline.Classifier` on its own mesh, so
    classifying MANY files pays the table upload once, not per file.
    Each process classifies its own record block of every file
    (`Classifier.classify_file_to_csv` with num_hosts = the process
    count, host_id = the rank) and writes it to its own shard file."""

    def __init__(self, db, cfg, num_db: int = 1, mesh=None,
                 device: str = "cuda"):
        from cuclark_tpu_torch.parallel.mesh import (local_devices,
                                                     make_global_mesh)
        from cuclark_tpu_torch.pipeline import Classifier

        self.nproc = process_count()
        self.pid = process_index()
        if mesh is None:
            mesh = make_global_mesh(
                num_db, local_devices(torch.device(device).type))
        if mesh.spans_processes:
            raise ValueError(
                f"data axis {mesh.num_data} not divisible by {self.nproc} "
                f"processes: the lockstep engine feeds per-process data "
                f"rows, so num_db must not exceed the per-process device "
                f"count (the host-spanning num_db == total-devices mesh "
                f"is for replicated-read ShardedClassifier use only)")
        self.mesh = mesh
        self.clf = Classifier(db, cfg, mesh=mesh)

    @property
    def stream_parts(self) -> int:
        return self.clf.stream_parts

    @property
    def sc(self):
        """The resident ShardedClassifier (None in streaming mode)."""
        return self.clf._sharded

    def close(self) -> None:
        self.clf.close()

    def classify_file_to_csv(self, path, out_path,
                             paired_path: str | None = None) -> int:
        """Classify this process's records of one file into out_path
        (suffixed .h<rank> when multi-process; rank 0's shard alone
        carries the header, so the shards concatenate in rank order to
        the single-process CSV).  In extended mode every rank takes part
        in one gather of the hit stats and rank 0 prints the one global
        line.  Returns rows written by THIS process."""
        nproc, pid = self.nproc, self.pid
        if nproc > 1:
            # pad width grows past 3 digits with the process count so
            # lexicographic shard order == rank order at any scale
            out_path = f"{out_path}.h{pid:0{max(3, len(str(nproc - 1)))}d}"
        if pid > 0:
            open(out_path, "wb").close()  # appended to without a header
        written = self.clf.classify_file_to_csv(
            path, out_path, paired_path, num_hosts=nproc, host_id=pid,
            append=pid > 0, print_stats=False)
        if self.clf.cfg.extended:
            # reference prints ONE global MIN/MAX/AVG hit-stats line
            # (CuCLARK_hh.hh:2075-2080) covering every rank's rows
            from cuclark_tpu_torch.pipeline import print_hit_stats

            (lo, hi, total), rows = self.clf.hit_stats
            sentinel = 1 << 40
            g = _gather_rows_i64(np.array(
                [sentinel if lo is None else lo, hi, total, rows]))
            if pid == 0:
                lo = int(g[:, 0].min())
                print_hit_stats([None if lo >= sentinel else lo,
                                 int(g[:, 1].max()), int(g[:, 2].sum())],
                                int(g[:, 3].sum()))
        return written


def classify_file_to_csv(db, cfg, path, out_path, num_db: int = 1,
                         paired_path: str | None = None, mesh=None,
                         device: str = "cuda") -> int:
    """Classify one file with every process of the job
    (`cuclark_tpu.parallel.multihost.classify_file_to_csv`).

    One-shot wrapper over GlobalClassifier (multi-file jobs should
    construct that once: the table upload is per engine, not per file).
    Each process scans ONLY its byte range of the input file
    (read_host_slice; paired mode shards by record index so mates stay
    aligned), classifies those records on its own mesh (streaming
    bucket-range parts when even a device's shard exceeds the memory
    budget, src/CuClarkDB.cu:540-574) and writes them to out_path,
    suffixed .h<rank> when multi-process.  Returns rows written by THIS
    process."""
    engine = GlobalClassifier(db, cfg, num_db=num_db, mesh=mesh,
                              device=device)
    try:
        return engine.classify_file_to_csv(path, out_path, paired_path)
    finally:
        engine.close()
