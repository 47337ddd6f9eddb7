"""Device-side query: wire batch -> per-window labels.

Counterpart of `cuclark_tpu/probe.py` (`_probe_qs_split` :198 with
`_q_match_labels` :73, `_probe_q4` :236, and the s2 branch of `probe`
:131-155) together with the chain that feeds them in
`cuclark_tpu/pipeline.py:classify_step_packed` (unpack, k-mer
extraction, canonical form, hash, mask by validity), and of
`cuclark_tpu/pipeline.py:probe_part_step` (:96), the same chain over one
bucket-range part of a streamed table or one db shard of a mesh (a range
of main rows and a range of stash rows, `cuclark_tpu/parallel/mesh.py`),
and of the front of `cuclark_tpu/pipeline.py:classify_step` (:48), the
chain from unpacked codes.  `query_score_results` is the resident query
of reads of up to `kernels.QUERY_SCORE_MAX_WINDOWS` windows, of any
layout, fused with `score.score_labels`, and `query_score_part_results`
the same over one range of rows with the label sum of the batch's other
range calls added before the score (the last launch of a mesh step's
data block, or of a streamed batch's last part).  On
a CUDA tensor each is one launch of the hand-written kernel
`csrc/query.cu`;
the plain PyTorch versions here are what the wrappers run on CPU
tensors and what the kernel is held against.

The table's layout reaches the query as one record, `hashdb.TableSpec`
(`KmerDB.spec`).  The port always probes the qs table in split form,
main rows [NB, 8] and stash rows [NBS, 8] as two tensors: the JAX
package's fused probe (`_probe_qs`) reads the same rows and gives
identical labels.  q4 and s2 tables have no stash.  The TPU-only
`spread_invalid` and `_spread_oob` have no counterpart: invalid windows
and buckets outside a part's range are masked (the plain versions) or
skipped (the kernel).
"""

from __future__ import annotations

import torch

from cuclark_tpu_torch import codec, kernels, score
from cuclark_tpu_torch.hashdb import (TableSpec, check_q_bits,
                                      feistel_mix_torch, mix1_torch,
                                      mix2_torch)

_MASK32 = 0xFFFFFFFF


def _localize(b: torch.Tensor, bucket_start: int, table: torch.Tensor,
              nb_bits: int):
    """(row of `table`, in-range mask) of global buckets b, the range
    mask of `cuclark_tpu.probe._localize`: `table` holds rows
    [bucket_start, bucket_start + len(table)), and a bucket out of that
    range reads row 0 and is masked by the caller.  (b, None) when
    `table` is the whole table."""
    nb_local = table.shape[0]
    if bucket_start == 0 and nb_local == 1 << nb_bits:
        return b, None
    loc = b - bucket_start
    in_range = (loc >= 0) & (loc < nb_local)
    return torch.where(in_range, loc, 0), in_range


def _masked(lab: torch.Tensor, in_range) -> torch.Tensor:
    return lab if in_range is None else torch.where(in_range, lab, 0)


def _match_labels(tbl: torch.Tensor, b: torch.Tensor, own: torch.Tensor,
                  other: torch.Tensor, bits: int, choice: int) -> torch.Tensor:
    """One row gather per key and the exact 64-bit reconstruct-compare
    of `cuclark_tpu.probe._q_match_labels`, summing matched labels.
    u32 words are compared as int64 values in [0, 2^32)."""
    rows = tbl[b].to(torch.int64) & _MASK32                 # [N, 8]
    meta = rows[:, 4:]
    m = ((rows[:, :4] == other[:, None])
         & ((meta >> 17) == (own >> bits)[:, None])
         & (((meta >> 16) & 1) == choice))
    return torch.where(m, meta & 0xFFFF, 0).sum(dim=1).to(torch.int32)


def _split_kmers(kmers: torch.Tensor):
    km = kmers.reshape(-1)
    return codec.shr(km, 32), km & _MASK32


def probe_qs_split(main: torch.Tensor, stash: torch.Tensor | None,
                   nb_bits: int, stash_bits: int, seed: int,
                   kmers: torch.Tensor, bucket_start: int = 0,
                   stash_start: int = 0) -> torch.Tensor:
    """Labels of canonical k-mers (int64 [...], the u64 bit pattern) in a
    qs table given as int32 main [NB, 8] and stash [NBS, 8]: the main row
    l2 & (NB-1) and the stash row h1 & (NBS-1), label = meta & 0xFFFF on
    a match, 0 on a miss.  Plain version of the qs probe in
    csrc/query.cu (`cuclark_tpu.probe._probe_qs_split`).

    For a part of a streamed table or a db shard of a mesh, `main` holds
    the main rows [bucket_start, bucket_start + len(main)) only and
    `stash` the stash rows [stash_start, stash_start + len(stash)): a
    bucket outside its side's range contributes 0
    (`cuclark_tpu.probe._localize`), and stash None probes no stash."""
    check_q_bits("qs", nb_bits, stash_bits)
    hi, lo = _split_kmers(kmers)
    h1, l2 = feistel_mix_torch(hi, lo, seed)
    loc, in_range = _localize(l2 & ((1 << nb_bits) - 1), bucket_start,
                              main, nb_bits)
    lab = _masked(_match_labels(main, loc, l2, h1, nb_bits, 0), in_range)
    if stash is not None:
        sloc, s_in = _localize(h1 & ((1 << stash_bits) - 1), stash_start,
                               stash, stash_bits)
        lab += _masked(_match_labels(stash, sloc, h1, l2, stash_bits, 1),
                       s_in)
    return lab.reshape(kmers.shape)


def probe_q4(table: torch.Tensor, nb_bits: int, seed: int,
             kmers: torch.Tensor, bucket_start: int = 0) -> torch.Tensor:
    """Labels of canonical k-mers (int64 [...]) in a q4 table, int32
    [NB, 8] (`cuclark_tpu.probe._probe_q4`): choice 0 at main row
    l2 & (NB-1) with other h1, choice 1 at main row h1 & (NB-1) with
    other l2, both quotients against nb_bits.  Plain version of the q4
    probe in csrc/query.cu, summing both choices as the reference does
    (the kernel gathers choice 1 only when choice 0 gives label 0, which
    gives the same sum on a table of unique keys and 1-based labels).
    For a part, `table` holds rows [bucket_start, bucket_start +
    len(table)) and each choice counts only when its own bucket lies in
    that range."""
    check_q_bits("q4", nb_bits)
    hi, lo = _split_kmers(kmers)
    h1, l2 = feistel_mix_torch(hi, lo, seed)
    mask = (1 << nb_bits) - 1
    lab = torch.zeros(h1.shape, dtype=torch.int32, device=h1.device)
    for choice, own, other in ((0, l2, h1), (1, h1, l2)):
        loc, in_range = _localize(own & mask, bucket_start, table,
                                  nb_bits)
        lab += _masked(_match_labels(table, loc, own, other, nb_bits,
                                     choice), in_range)
    return lab.reshape(kmers.shape)


def probe_s2(table: torch.Tensor, nb_bits: int, slots: int,
             num_choices: int, kmers: torch.Tensor,
             bucket_start: int = 0) -> torch.Tensor:
    """Labels of canonical k-mers (int64 [...]) in an s2 table, int32
    [NB, 3 * slots] rows [klo x S | khi x S | label x S] (the s2 branch
    of `cuclark_tpu.probe.probe`): bucket mix1 & (NB-1), and with two
    choices mix2 & (NB-1) when it differs from the first as a global
    bucket; the labels of the slots whose two key words match are
    summed.  Plain version of the s2 probe in csrc/query.cu, summing
    both choices as the reference does (the kernel probes choice 1 only
    when choice 0 gives label 0).  For a part, `table` holds rows
    [bucket_start, bucket_start + len(table)) and each choice counts
    only when its own bucket lies in range."""
    S = slots
    hi, lo = _split_kmers(kmers)
    mask = (1 << nb_bits) - 1
    b1 = mix1_torch(hi, lo) & mask
    lab = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    for choice in range(num_choices):
        b = b1 if choice == 0 else mix2_torch(hi, lo) & mask
        loc, in_range = _localize(b, bucket_start, table, nb_bits)
        rows = table[loc]                                    # [N, 3S]
        words = rows[:, :2 * S].to(torch.int64) & _MASK32
        m = (words[:, :S] == lo[:, None]) & (words[:, S:] == hi[:, None])
        if in_range is not None:
            m &= in_range[:, None]
        if choice == 1:
            m &= (b != b1)[:, None]
        lab += torch.where(m, rows[:, 2 * S:], 0).sum(dim=1)
    # int32 sums wrap as the JAX probe's do
    return lab.to(torch.int32).reshape(kmers.shape)


def probe_table(main: torch.Tensor, stash: torch.Tensor | None,
                spec: TableSpec, kmers: torch.Tensor, bucket_start: int = 0,
                stash_start: int = 0) -> torch.Tensor:
    """Labels of canonical k-mers in a table of any layout: the plain
    probe of `spec.layout` (stash None for q4 and s2)."""
    if spec.layout == "qs":
        return probe_qs_split(main, stash, spec.nb_bits, spec.stash_bits,
                              spec.seed, kmers, bucket_start, stash_start)
    if spec.layout == "q4":
        return probe_q4(main, spec.nb_bits, spec.seed, kmers, bucket_start)
    return probe_s2(main, spec.nb_bits, spec.slots, spec.num_choices,
                    kmers, bucket_start)


def _check_table(main: torch.Tensor, stash: torch.Tensor | None,
                 spec: TableSpec, resident: bool) -> None:
    spec.check()
    if main.dim() != 2 or main.shape[1] != spec.row_words:
        raise ValueError(f"{spec.layout} rows must be [rows, "
                         f"{spec.row_words}], got {tuple(main.shape)}")
    if spec.layout != "qs" and stash is not None:
        raise ValueError(f"a {spec.layout} table has no stash")
    if resident and (main.shape[0] != 1 << spec.nb_bits
                     or (spec.layout == "qs" and (
                         stash is None
                         or stash.shape[0] != 1 << spec.stash_bits))):
        raise ValueError("resident query needs the whole table: "
                         f"2^{spec.nb_bits} main rows and, for qs, the "
                         f"2^{spec.stash_bits} stash rows")


def _code_labels(codes, main, stash, spec, k, bucket_start=0,
                 stash_start=0):
    """Labels of every k-mer window of codes [R, L] (0..3, >= 4 invalid),
    0 on an invalid window."""
    kmers, valid = codec.extract_kmers(codes, k)
    canon = codec.canonical(kmers, k)
    labels = probe_table(main, stash, spec, canon, bucket_start, stash_start)
    return torch.where(valid, labels, 0)


def _window_labels(packed2, vbits, main, stash, spec, k, bucket_start=0,
                   stash_start=0):
    return _code_labels(codec.unpack_codes(packed2, vbits), main, stash,
                        spec, k, bucket_start, stash_start)


def query_labels_plain(packed2: torch.Tensor, vbits: torch.Tensor,
                       main: torch.Tensor, stash: torch.Tensor | None, *,
                       k: int, spec: TableSpec) -> torch.Tensor:
    """Plain PyTorch version of the query kernel: packed2 uint8 [R, L/4]
    and vbits uint8 [R, L/8] -> labels int32 [R, L-k+1], 0 where the
    window holds an N or padding or misses the table."""
    _check_table(main, stash, spec, resident=True)
    return _window_labels(packed2, vbits, main, stash, spec, k)


def query_labels(packed2: torch.Tensor, vbits: torch.Tensor,
                 main: torch.Tensor, stash: torch.Tensor | None, *, k: int,
                 spec: TableSpec) -> torch.Tensor:
    """Per-window labels of a wire batch against a resident table (main
    rows and, for qs, the stash; see `hashdb.table_to_device`): the
    query kernel for CUDA tensors, its plain version for CPU tensors."""
    if packed2.device.type == "cpu":
        return query_labels_plain(packed2, vbits, main, stash, k=k,
                                  spec=spec)
    return kernels.query(packed2, vbits, main, stash, k=k, spec=spec)


def fuses_score(packed2: torch.Tensor, k: int) -> bool:
    """Whether a step of this wire batch without labels ends in the fused
    query and score (`query_score_results`, or `query_score_part_results`
    on a mesh or at a streamed batch's last part), on a table of any
    layout: reads of at most kernels.QUERY_SCORE_MAX_WINDOWS windows
    (every length bin up to 1024, paired 2 x 150 bp reads among them)."""
    P = 4 * packed2.shape[1] - k + 1
    return 1 <= P <= kernels.QUERY_SCORE_MAX_WINDOWS


def query_score_results_plain(packed2: torch.Tensor, vbits: torch.Tensor,
                              main: torch.Tensor, stash: torch.Tensor | None,
                              *, k: int, spec: TableSpec) -> torch.Tensor:
    """Plain PyTorch version of the fused query and score: the plain
    query's labels, scored by the plain score -> results int32 [R, 5]."""
    return score.score_labels_plain(query_labels_plain(
        packed2, vbits, main, stash, k=k, spec=spec))


def query_score_results(packed2: torch.Tensor, vbits: torch.Tensor,
                        main: torch.Tensor, stash: torch.Tensor | None, *,
                        k: int, spec: TableSpec) -> torch.Tensor:
    """Per-read results int32 [R, 5] of a wire batch of reads that fuse
    (see `fuses_score`) against a resident table (main rows and, for qs,
    the stash), the labels never leaving the chip: the query kernel's
    fused instance for CUDA tensors, its plain version for CPU
    tensors."""
    if packed2.device.type == "cpu":
        return query_score_results_plain(packed2, vbits, main, stash, k=k,
                                         spec=spec)
    return kernels.query_score(packed2, vbits, main, stash, k=k, spec=spec)


def query_score_part_results_plain(
        packed2: torch.Tensor, vbits: torch.Tensor, main_part: torch.Tensor,
        stash: torch.Tensor | None, *, bucket_start: int, nb_local: int,
        k: int, spec: TableSpec, stash_start: int = 0,
        acc_in: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the fused query and score over one range
    of rows: the plain range query's labels plus acc_in (left as it is),
    scored by the plain score -> results int32 [R, 5]."""
    labels = query_part_labels_plain(
        packed2, vbits, main_part, stash, bucket_start=bucket_start,
        nb_local=nb_local, k=k, spec=spec, stash_start=stash_start)
    if acc_in is not None:
        labels += acc_in
    return score.score_labels_plain(labels)


def query_score_part_results(
        packed2: torch.Tensor, vbits: torch.Tensor, main_part: torch.Tensor,
        stash: torch.Tensor | None, *, bucket_start: int, nb_local: int,
        k: int, spec: TableSpec, stash_start: int = 0,
        acc_in: torch.Tensor | None = None) -> torch.Tensor:
    """Per-read results int32 [R, 5] of a wire batch of reads that fuse
    (see `fuses_score`) against one range of a table (the ranges of
    `query_part_labels`), the labels of the batch's other range calls,
    acc_in (int32 [R, P], only read; None: none), added before the
    score: the last launch of a data block of a mesh step, or of a
    streamed batch's last part, whose labels never leave the chip.  A qs stash of None skips the stash probe, which
    is exact only when another call of the same batch probes it.  The
    query kernel's fused instance for CUDA tensors (its queued instance,
    range_query_score_kernel, where `kernels.queue_score_windows` routes
    the range and the reads' width), its plain version for CPU
    tensors."""
    if packed2.device.type == "cpu":
        return query_score_part_results_plain(
            packed2, vbits, main_part, stash, bucket_start=bucket_start,
            nb_local=nb_local, k=k, spec=spec, stash_start=stash_start,
            acc_in=acc_in)
    _check_part(main_part, stash, spec, bucket_start, nb_local, stash_start)
    return kernels.query_score_part(
        packed2, vbits, main_part, stash, bucket_start=bucket_start, k=k,
        spec=spec, stash_start=stash_start, acc_in=acc_in)


def query_codes_labels_plain(codes: torch.Tensor, main: torch.Tensor,
                             stash: torch.Tensor | None, *, k: int,
                             spec: TableSpec) -> torch.Tensor:
    """Plain PyTorch version of the query kernel's codes front half: codes
    uint8 [R, L] (0..3, >= 4 an N or padding) -> labels int32
    [R, L-k+1] against the resident table (`extract_kmers`, `canonical`,
    `probe_table`: `cuclark_tpu.pipeline.classify_step` up to the
    labels)."""
    _check_table(main, stash, spec, resident=True)
    return _code_labels(codes, main, stash, spec, k)


def query_codes_labels(codes: torch.Tensor, main: torch.Tensor,
                       stash: torch.Tensor | None, *, k: int,
                       spec: TableSpec) -> torch.Tensor:
    """Per-window labels of unpacked codes uint8 [R, L] against a
    resident table: the query kernel's codes front half for CUDA
    tensors, its plain version for CPU tensors."""
    if codes.device.type == "cpu":
        return query_codes_labels_plain(codes, main, stash, k=k, spec=spec)
    return kernels.query_codes(codes, main, stash, k=k, spec=spec)


def stash_range(stash: torch.Tensor | None, p: int, parts: int):
    """(stash rows, offset of its first row) that part p of a streamed qs
    table's `parts` probes: rows [p * n // parts, (p + 1) * n // parts) of
    the n stash rows given (the whole stash on one device, a db shard's
    on a mesh), so every part call gathers about as many stash rows (a
    pass of 4 parts on an H100 80GB HBM3 at 700 W: 0.1157 -> 0.1074 ms a
    part call against the whole stash on part 0, PERF.md section 6);
    where the parts outnumber the stash rows, the whole stash on part 0.
    Every key lives in one stash row, so the parts' labels sum to those
    of the reference's part-0 stash probe (cuclark_tpu/pipeline.py:
    808-810).  (None, 0) without a stash."""
    if stash is None:
        return None, 0
    n = stash.shape[0]
    if parts > n:
        return (stash if p == 0 else None), 0
    lo, hi = p * n // parts, (p + 1) * n // parts
    return stash[lo:hi], lo


def query_part_labels_plain(packed2: torch.Tensor, vbits: torch.Tensor,
                            main_part: torch.Tensor,
                            stash: torch.Tensor | None, *, bucket_start: int,
                            nb_local: int, k: int, spec: TableSpec,
                            stash_start: int = 0,
                            acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the range-mode query kernel: the labels
    of main rows [bucket_start, bucket_start + nb_local) and, when a qs
    stash is given, of stash rows [stash_start, stash_start + len(stash)),
    0 on invalid windows; added into `acc` in place when it is given."""
    _check_part(main_part, stash, spec, bucket_start, nb_local, stash_start)
    labels = _window_labels(packed2, vbits, main_part, stash, spec, k,
                            bucket_start, stash_start)
    if acc is None:
        return labels
    return acc.add_(labels)


def query_part_labels(packed2: torch.Tensor, vbits: torch.Tensor,
                      main_part: torch.Tensor, stash: torch.Tensor | None, *,
                      bucket_start: int, nb_local: int, k: int,
                      spec: TableSpec, stash_start: int = 0,
                      acc: torch.Tensor | None = None) -> torch.Tensor:
    """Per-window labels of a wire batch against one range of a table: a
    bucket-range part of a streamed table
    (`cuclark_tpu.pipeline.probe_part_step`) or the db shard of a mesh
    (`cuclark_tpu.parallel.mesh`).  A main bucket b counts only when
    bucket_start <= b < bucket_start + nb_local, and then reads row
    b - bucket_start of `main_part`; each hash choice of q4 and s2 is
    range-checked on its own.  The qs stash is probed only when it is
    passed, over its own range [stash_start, stash_start + len(stash)).
    With `acc`, the labels are
    added into it in place (the `acc + lab` of the JAX streaming loop, the
    psum of the mesh) and `acc` is returned.  The range-mode query kernel
    for CUDA tensors, its plain version for CPU tensors."""
    if packed2.device.type == "cpu":
        return query_part_labels_plain(
            packed2, vbits, main_part, stash, bucket_start=bucket_start,
            nb_local=nb_local, k=k, spec=spec, stash_start=stash_start,
            acc=acc)
    _check_part(main_part, stash, spec, bucket_start, nb_local, stash_start)
    return kernels.query_part(packed2, vbits, main_part, stash,
                              bucket_start=bucket_start, k=k, spec=spec,
                              stash_start=stash_start, acc=acc)


def _check_part(main_part: torch.Tensor, stash: torch.Tensor | None,
                spec: TableSpec, bucket_start: int, nb_local: int,
                stash_start: int = 0) -> None:
    _check_table(main_part, stash, spec, resident=False)
    if main_part.shape[0] != nb_local:
        raise ValueError(f"part holds {main_part.shape[0]} rows, "
                         f"nb_local is {nb_local}")
    if bucket_start < 0 or bucket_start + nb_local > 1 << spec.nb_bits:
        raise ValueError(f"part rows [{bucket_start}, "
                         f"{bucket_start + nb_local}) exceed "
                         f"2^{spec.nb_bits}")
    if stash is None:
        return
    if stash_start < 0 or stash_start + stash.shape[0] > 1 << spec.stash_bits:
        raise ValueError(f"stash part holds {stash.shape[0]} rows from "
                         f"{stash_start}, of 2^{spec.stash_bits}")
