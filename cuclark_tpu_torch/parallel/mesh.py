"""Multi-device execution: DB sharding + data parallelism over a mesh.

Counterpart of `cuclark_tpu/parallel/mesh.py`.  There a `Mesh` is a
(data, db) grid of devices in one process, and one jitted SPMD program
runs over it with a psum over the db axis.  Here the grid holds torch
devices and the sharded steps are loops over it:

  axis "db":   the main rows (and, for qs, the stash rows) split into
               num_db contiguous ranges; the devices of column j hold
               range j.  For each data block d and db shard j the
               range-mode query kernel (`csrc/query.cu` through
               `probe.query_part_labels`) runs on device (d, j) with
               bucket_start = j * nb_local (plus a part's start) and
               stash_start = j * nbs_local, and the shards' int32 labels
               are summed on the block's column-0 device.  That takes the
               place of the psum and is exact: a k-mer lives in one shard
               only.  A shard on the same device as column 0 adds into
               the sum in place; one on another card is copied across (a
               peer copy) and added.
  axis "data": a read batch splits into num_data contiguous row blocks;
               each block's results are scored once, on its column-0
               device (the JAX results are replicated along db; here
               each block's results exist once).

Without labels (default CSV output), a block of reads of up to 1,024
windows (`probe.fuses_score`: 150 bp reads, paired 2 x 150 bp reads)
ends in one launch of the query
kernel's fused instance: shards 1..num_db-1 run first and sum on the
column-0 device, then column 0's own shard runs as the fused range
launch (`probe.query_score_part_results`), which adds that sum to its
labels and scores them on chip.  A block so costs num_db - 1 range
launches and one fused launch, and no score launch; a 1 x 1 mesh makes
one launch a batch.  A streamed table's last part ends the same way.
Extended output and wider rows (reads over 1,024 windows) keep the
range launches, the sum and the score kernel.

The devices of a mesh may repeat: eight handles of `cpu` stand in for
the JAX tests' eight CPU devices, and four handles of `cuda:0` make a
2 x 2 mesh on one card.  Nothing here assumes that the devices differ,
or that they are the same: a table shard or a wire block is placed once
for each distinct device that needs it.

The db axis may also span the processes of a job (`make_global_mesh`
with num_db equal to the job's device count, a data axis of 1): each
process holds its own columns and feeds every batch whole, the reads
replicated, and `build_sharded_classify` sums its local shards, then
all-reduces the [R, P] labels over the process group (gloo), then
scores; every process gets the full results.

The JAX package shards a fused main+stash qs table below 256 MB of main
rows (its fused-vs-split switch); the port always shards the split form,
main rows and stash rows each in num_db ranges.  The rows each shard
answers differ between the two forms; the labels and CSVs are the same.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from cuclark_tpu_torch import codec, probe, score
from cuclark_tpu_torch.hashdb import KmerDB, TableSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, db) grid of torch devices: devices[d][j] is the device of
    data block d and db shard db_start + j.  On a db axis that spans
    processes (`make_global_mesh`) a process holds columns db_start ..
    db_start + len(devices[0]) of db_total; otherwise db_start is 0 and
    db_total 0 (every column is here)."""

    devices: tuple[tuple[torch.device, ...], ...]
    db_start: int = 0
    db_total: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.num_data, "db": self.num_db}

    @property
    def num_data(self) -> int:
        return len(self.devices)

    @property
    def num_db(self) -> int:
        """The db shards of the table, over every process."""
        return self.db_total or len(self.devices[0])

    @property
    def spans_processes(self) -> bool:
        return self.num_db != len(self.devices[0])


def local_devices(kind: str) -> list[torch.device]:
    """This process's devices of one type: every visible card for
    "cuda"; for "cpu", CUCLARK_CPU_DEVICES handles of the CPU (default
    1), which stands in for the XLA flag that splits the JAX package's
    CPU into devices."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        n = int(os.environ.get("CUCLARK_CPU_DEVICES", "1"))
        return [torch.device("cpu")] * n
    raise ValueError(f"unsupported device type {kind!r}")


def make_mesh(num_db: int, num_data: int | None = None,
              devices=None) -> Mesh:
    """The devices (default: every visible card), in order, as a
    num_data x num_db grid, row by row."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else local_devices("cuda"))]
    total = len(devices)
    if num_data is None:
        if num_db < 1 or total % num_db:
            raise ValueError(f"{total} devices not divisible by db={num_db}")
        num_data = total // num_db
    if num_db < 1 or num_data < 1 or num_data * num_db != total:
        raise ValueError(f"{total} devices do not make {num_data} data x "
                         f"{num_db} db")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {devices}")
    return Mesh(tuple(tuple(devices[d * num_db:(d + 1) * num_db])
                      for d in range(num_data)))


def make_global_mesh(num_db: int = 1, devices=None) -> Mesh:
    """The mesh of one process of a multi-process job
    (`cuclark_tpu.parallel.mesh.make_global_mesh`): its own devices
    (default: every visible card) as data x num_db, so that the db axis
    and its sum stay inside the process.  The one host-spanning case of
    the reference: num_db equal to the job's device count (the process
    count times this process's devices, the same on every process), a
    data axis of 1, and this process's devices as global db columns
    process_index * local ..; every process then feeds the same
    (replicated) reads (`ShardedClassifier`; the lockstep
    `multihost.GlobalClassifier` rejects it)."""
    from cuclark_tpu_torch.parallel import multihost

    devices = [torch.device(d) for d in (
        devices if devices is not None else local_devices("cuda"))]
    local = len(devices)
    nproc = multihost.process_count()
    total = local * nproc
    if nproc > 1 and num_db == total:
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{devices}")
        return Mesh((tuple(devices),),
                    db_start=multihost.process_index() * local,
                    db_total=total)
    if num_db < 1 or local % num_db:
        raise ValueError(
            f"num_db={num_db} must divide per-process devices {local} or "
            f"equal the total device count {total} (a host-spanning db "
            f"axis takes num_db == the total device count, data axis 1)")
    return make_mesh(num_db, local // num_db, devices)


def place_columns(mesh: Mesh, column_rows) -> list[list[torch.Tensor]]:
    """[d][j] -> the int32 view of the uint32 rows `column_rows(global
    column db_start + j)` on device (d, j), placed once for each distinct
    (column, device); on the CPU they share memory with the host rows."""
    placed: dict = {}
    grid = []
    for row in mesh.devices:
        out = []
        for j, dev in enumerate(row):
            if (j, dev) not in placed:
                rows = np.ascontiguousarray(
                    column_rows(mesh.db_start + j)).view(np.int32)
                placed[(j, dev)] = torch.from_numpy(rows).to(dev)
            out.append(placed[(j, dev)])
        grid.append(out)
    return grid


def shard_rows(arr: np.ndarray, mesh: Mesh) -> list[list[torch.Tensor]]:
    """Row-shard a host table over 'db', repeated down 'data': [d][j]
    holds rows [g * n, (g + 1) * n) of global column g = db_start + j,
    n = rows / num_db."""
    num_db = mesh.num_db
    if arr.shape[0] % num_db:
        raise ValueError(f"table rows {arr.shape[0]} not divisible by "
                         f"db={num_db}")
    n = arr.shape[0] // num_db
    return place_columns(mesh, lambda j: arr[j * n:(j + 1) * n])


def shard_db_table(db: KmerDB, mesh: Mesh):
    """(main, stash) of the table on the mesh, each [d][j] row-sharded
    over 'db' (`cuclark_tpu.parallel.mesh.shard_db_table`); stash None
    for q4 and s2."""
    main_np, stash_np = db.split_tables()
    return (shard_rows(main_np, mesh),
            shard_rows(stash_np, mesh) if stash_np is not None else None)


def place_wire(mesh: Mesh, packed2, vbits) -> list[list[tuple]]:
    """Split a wire batch (numpy) into num_data row blocks and place each
    on the devices of its mesh row: [d][j] = (packed2 block, vbits
    block), one copy per distinct device, from pinned memory without
    blocking on a card.  Rows must be divisible by num_data: pad with
    zero rows (zero validity bits, all-invalid reads) first."""
    R = packed2.shape[0]
    if R % mesh.num_data:
        raise ValueError(f"{R} rows not divisible by data={mesh.num_data}")
    rb = R // mesh.num_data
    grid = []
    for d, row in enumerate(mesh.devices):
        block = [torch.from_numpy(np.ascontiguousarray(a[d * rb:(d + 1) * rb]))
                 for a in (packed2, vbits)]
        placed: dict = {}
        for dev in row:
            if dev not in placed:
                placed[dev] = tuple(
                    t if dev.type == "cpu"
                    else t.pin_memory().to(dev, non_blocking=True)
                    for t in block)
        grid.append([placed[dev] for dev in row])
    return grid


def _sum_shards(query, mesh: Mesh, wires, main, stash, *, k: int,
                spec: TableSpec, nb_local: int, nbs_local: int,
                part_start: int, acc, first: int = 0, stash_offset: int = 0):
    """Per data block: the labels of its db shards from local column
    `first` on summed on the block's column-0 device (added into acc[d]
    when acc is given; None for a block with neither).  stash[d][j] holds
    shard g's stash rows from stash_offset on (g * nbs_local + its
    offset in the table's stash)."""
    out = []
    for d, row in enumerate(mesh.devices):
        home = row[0]
        a = None if acc is None else acc[d]
        for j in range(first, len(row)):
            dev, (p2, vb) = row[j], wires[d][j]
            g = mesh.db_start + j
            args = dict(bucket_start=part_start + g * nb_local,
                        nb_local=nb_local, k=k, spec=spec,
                        stash_start=g * nbs_local + stash_offset)
            s = None if stash is None else stash[d][j]
            if dev == home:
                a = query(p2, vb, main[d][j], s, acc=a, **args)
            else:
                lab = query(p2, vb, main[d][j], s, **args).to(
                    home, non_blocking=True)
                a = lab if a is None else a.add_(lab)
        out.append(a)
    return out


def _fused_blocks(fused, wires, main, stash, sums, *, k: int,
                  spec: TableSpec, nb_local: int, part_start: int,
                  stash_offset: int = 0):
    """Per data block: column 0's shard as the fused range launch, which
    adds the block's sum of the other launches (sums[d], None: none) to
    its labels and scores them -> results [Rb, 5] on the column-0
    device.  Not for a db axis that spans processes (column 0 is shard
    0, its stash rows from stash_offset on)."""
    return [fused(p2, vb, main[d][0], None if stash is None else stash[d][0],
                  bucket_start=part_start, nb_local=nb_local, k=k, spec=spec,
                  stash_start=stash_offset, acc_in=sums[d])
            for d, (p2, vb) in enumerate(w[0] for w in wires)]


def _step_fns(plain: bool, label_bound: int | None = None):
    """(range query, score, fused range query and score): the kernels'
    wrappers, the score's given the table's label bound, or with
    plain=True their plain versions."""
    if plain:
        return (probe.query_part_labels_plain, score.score_labels_plain,
                probe.query_score_part_results_plain)
    return (probe.query_part_labels,
            functools.partial(score.score_labels, label_bound=label_bound),
            probe.query_score_part_results)


def build_sharded_classify(mesh: Mesh, *, k: int, spec: TableSpec,
                           nb_total: int, nbs_total: int = 0,
                           with_labels: bool = True, plain: bool = False):
    """The sharded resident step (`cuclark_tpu.parallel.mesh.
    build_sharded_classify`, mesh.py:96): step(main, stash, wires) ->
    (results, labels or None), each a list of num_data blocks, int32
    [R/num_data, 5] and [R/num_data, P] on the block's column-0 device.
    main and stash (qs; None for q4 and s2) are `shard_db_table`'s, nb_total
    and nbs_total the table's main and stash rows, wires `place_wire`'s.
    with_labels=False drops the labels (only extended output needs them);
    a batch that fuses then ends each block in the fused range
    launch (the module's docstring), any other in the score kernel.
    On a db axis that spans processes the local shards' sum is
    all-reduced over the process group before the score, so every
    process gets the whole results; the fused launch cannot end such a
    step, because the sum must be whole before the score.
    plain=True runs the kernels' plain versions on the same devices, the
    version the step is held against on the card."""
    num_db = mesh.num_db
    if nb_total % num_db or nbs_total % num_db:
        raise ValueError(f"table rows {nb_total} (+{nbs_total} stash) not "
                         f"divisible by db={num_db}")
    kw = dict(k=k, spec=spec, nb_local=nb_total // num_db, part_start=0)
    nbs_local = nbs_total // num_db
    query, score_fn, fused = _step_fns(plain, spec.label_bound)

    def step(main, stash, wires):
        if (not with_labels and not mesh.spans_processes
                and probe.fuses_score(wires[0][0][0], k)):
            sums = _sum_shards(query, mesh, wires, main, stash, acc=None,
                               first=1, nbs_local=nbs_local, **kw)
            return _fused_blocks(fused, wires, main, stash, sums,
                                 **kw), None
        labels = _sum_shards(query, mesh, wires, main, stash, acc=None,
                             nbs_local=nbs_local, **kw)
        if mesh.spans_processes:
            for lab in labels:
                torch.distributed.all_reduce(lab)
        results = [score_fn(lab) for lab in labels]
        return results, (labels if with_labels else None)

    return step


def build_sharded_probe_part(mesh: Mesh, *, k: int, spec: TableSpec,
                             nb_part: int, plain: bool = False):
    """The sharded step of one streamed part (`cuclark_tpu.parallel.mesh.
    build_sharded_probe_part`, mesh.py:164): step(part, wires, part_start,
    stash=None, acc=None, scored=False, split=(0, 1)) -> labels, a list of
    num_data blocks.  `part` is [d][j] main rows: global rows [part_start,
    part_start + nb_part) row-sharded over 'db'.  A qs stash ([d][j],
    `shard_rows`) is probed over each shard's range p of `parts`
    (`probe.stash_range`, split=(p, parts)), as one device splits its
    stash over the parts: the parts' sum equals the reference's, which
    probes the stash on part 0 only; split=(0, 1) probes each shard's
    whole stash.  With acc (a list
    of blocks), the labels add into it in place.  scored=True, for the last
    part of a batch that fuses and whose labels nobody needs
    (`probe.fuses_score`), ends each block in the fused range launch and
    returns its results [Rb, 5] instead: the other shards add into acc
    (or a new sum), column 0's shard adds that sum and scores.  On a db
    axis that spans processes each part's local sum is all-reduced over
    the process group before it adds into acc (the reference's psum of
    each part), and scored=True is refused: the sum must be whole before
    the score.  plain as for build_sharded_classify."""
    num_db = mesh.num_db
    if nb_part % num_db:
        raise ValueError(f"part rows {nb_part} not divisible by db={num_db}")
    nb_local = nb_part // num_db
    query, _, fused = _step_fns(plain)

    def step(part, wires, part_start: int, stash=None, acc=None,
             scored=False, split=(0, 1)):
        kw = dict(k=k, spec=spec, nb_local=nb_local, part_start=part_start)
        nbs_local = 0 if stash is None else stash[0][0].shape[0]
        if stash is not None:
            kw["stash_offset"] = probe.stash_range(stash[0][0], *split)[1]
            stash = [[probe.stash_range(s, *split)[0] for s in row]
                     for row in stash]
            if stash[0][0] is None:  # a part past the shard's stash rows
                stash = None
        if mesh.spans_processes:
            if scored:
                raise ValueError("a db axis that spans processes cannot end "
                                 "in the fused launch")
            labels = _sum_shards(query, mesh, wires, part, stash, acc=None,
                                 nbs_local=nbs_local, **kw)
            for lab in labels:
                torch.distributed.all_reduce(lab)
            return labels if acc is None else [
                a.add_(lab) for a, lab in zip(acc, labels)]
        if not scored:
            return _sum_shards(query, mesh, wires, part, stash, acc=acc,
                               nbs_local=nbs_local, **kw)
        sums = _sum_shards(query, mesh, wires, part, stash, acc=acc,
                           first=1, nbs_local=nbs_local, **kw)
        return _fused_blocks(fused, wires, part, stash, sums, **kw)

    return step


class ShardedClassifier:
    """Mesh-parallel version of pipeline.Classifier's device step
    (`cuclark_tpu.parallel.mesh.ShardedClassifier`): the table sharded on
    the mesh once, and the sharded resident step on wire batches.  In a
    multi-process job each process has a mesh of its own devices and feeds
    it only its own reads (`multihost.GlobalClassifier`); on a db axis
    that spans the processes (`make_global_mesh`) every process feeds the
    same reads and gets the whole results."""

    def __init__(self, db: KmerDB, mesh: Mesh, with_labels: bool = True):
        self.db = db
        self.mesh = mesh
        self.with_labels = with_labels
        self.table, self.stash = shard_db_table(db, mesh)
        main_np, stash_np = db.split_tables()
        self._step = build_sharded_classify(
            mesh, k=db.k, spec=db.spec, nb_total=main_np.shape[0],
            nbs_total=stash_np.shape[0] if stash_np is not None else 0,
            with_labels=with_labels)

    @property
    def num_data(self) -> int:
        return self.mesh.num_data

    def put_wire(self, packed2: np.ndarray, vbits: np.ndarray):
        """Place one wire batch on the mesh (`place_wire`).  Safe to call
        from a prefetch thread: it only starts copies."""
        return place_wire(self.mesh, packed2, vbits)

    def step_placed(self, wires):
        """The sharded step on a placed batch, launched without waiting ->
        (results blocks, labels blocks or None)."""
        return self._step(self.table, self.stash, wires)

    def step_packed(self, packed2: np.ndarray, vbits: np.ndarray):
        """step_placed on a wire batch from the host; rows must be
        divisible by the data axis (pad with zero rows first)."""
        return self.step_placed(self.put_wire(packed2, vbits))

    @staticmethod
    def local_rows(blocks, n_local: int | None = None) -> np.ndarray:
        """This process's rows of a data-sharded result, read back to the
        host: its blocks, one per data index, in order.  The JAX results
        are replicated along 'db' and its local_rows keeps one shard per
        data block; here each block exists once, so no replica can hand
        later reads earlier reads' rows."""
        rows = np.concatenate([b.cpu().numpy() for b in blocks])
        return rows if n_local is None else rows[:n_local]

    def classify_codes(self, codes: np.ndarray):
        """codes: [R, L] uint8 -> (results [R, 5], labels [R, P] or None)
        as numpy.  Rows pad to the data axis with INVALID codes and the
        batch is packed to the wire format first, as the JAX package
        does."""
        R = codes.shape[0]
        if R % self.num_data:
            codes = np.pad(codes, ((0, self.num_data - R % self.num_data),
                                   (0, 0)), constant_values=codec.INVALID)
        results, labels = self.step_packed(*codec.pack_codes(codes))
        return (self.local_rows(results, R),
                None if labels is None else self.local_rows(labels, R))
