"""Device-side query: wire batch -> per-window labels.

Counterpart of `cuclark_tpu/probe.py` (`_probe_qs_split` :198 with
`_q_match_labels` :73) together with the chain that feeds it in
`cuclark_tpu/pipeline.py:classify_step_packed` (unpack, k-mer
extraction, canonical form, Feistel mix, mask by validity), and of
`cuclark_tpu/pipeline.py:probe_part_step` (:96), the same chain over one
bucket-range part of a streamed table.  On a CUDA tensor each is one
launch of the hand-written kernel `csrc/query.cu`; the plain PyTorch
versions here are what the wrappers run on CPU tensors and what the
kernel is held against.

The port always probes the qs table in split form, main rows [NB, 8] and
stash rows [NBS, 8] as two tensors: the JAX package's fused probe
(`_probe_qs`) reads the same rows and gives identical labels.  The
TPU-only `spread_invalid` and `_spread_oob` have no counterpart: invalid
windows and main buckets outside a part's range are masked (the plain
versions) or skipped (the kernel).
"""

from __future__ import annotations

import torch

from cuclark_tpu_torch import codec, kernels
from cuclark_tpu_torch.hashdb import (check_q_bits, feistel_mix_torch,
                                      feistel_seed_consts)

_MASK32 = 0xFFFFFFFF


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


def probe_qs_split(main: torch.Tensor, stash: torch.Tensor | None,
                   nb_bits: int, stash_bits: int, seed: int,
                   kmers: torch.Tensor,
                   bucket_start: int = 0) -> torch.Tensor:
    """Labels of canonical k-mers (int64 [...], the u64 bit pattern) in a
    qs table given as int32 main [NB, 8] and stash [NBS, 8]: the main row
    l2 & (NB-1) and the stash row h1 & (NBS-1), label = meta & 0xFFFF on
    a match, 0 on a miss.  Plain version of the probe in csrc/query.cu.

    For a part of a streamed table, `main` holds the main rows
    [bucket_start, bucket_start + len(main)) only: a bucket outside that
    range contributes 0 (`cuclark_tpu.probe._localize`), and stash None
    probes no stash."""
    check_q_bits("qs", nb_bits, stash_bits)
    shape = kmers.shape
    km = kmers.reshape(-1)
    hi = codec.shr(km, 32)
    lo = km & _MASK32
    h1, l2 = feistel_mix_torch(hi, lo, seed)
    b = l2 & ((1 << nb_bits) - 1)
    nb_local = main.shape[0]
    if bucket_start == 0 and nb_local == 1 << nb_bits:
        lab = _match_labels(main, b, l2, h1, nb_bits, 0)
    else:
        loc = b - bucket_start
        in_range = (loc >= 0) & (loc < nb_local)
        lab = torch.where(in_range, _match_labels(
            main, torch.where(in_range, loc, 0), l2, h1, nb_bits, 0), 0)
    if stash is not None:
        lab += _match_labels(stash, h1 & ((1 << stash_bits) - 1), h1, l2,
                             stash_bits, 1)
    return lab.reshape(shape)


def query_labels_plain(packed2: torch.Tensor, vbits: torch.Tensor,
                       main: torch.Tensor, stash: torch.Tensor, *, k: int,
                       nb_bits: int, stash_bits: int,
                       seed: int) -> torch.Tensor:
    """Plain PyTorch version of the query kernel: packed2 uint8 [R, L/4]
    and vbits uint8 [R, L/8] -> labels int32 [R, L-k+1], 0 where the
    window holds an N or padding or misses the table."""
    codes = codec.unpack_codes(packed2, vbits)
    kmers, valid = codec.extract_kmers(codes, k)
    canon = codec.canonical(kmers, k)
    labels = probe_qs_split(main, stash, nb_bits, stash_bits, seed, canon)
    return torch.where(valid, labels, 0)


def query_labels(packed2: torch.Tensor, vbits: torch.Tensor,
                 main: torch.Tensor, stash: torch.Tensor, *, k: int,
                 nb_bits: int, stash_bits: int, seed: int) -> torch.Tensor:
    """Per-window labels of a wire batch: the query kernel for CUDA
    tensors, its plain version for CPU tensors."""
    check_q_bits("qs", nb_bits, stash_bits)
    if packed2.device.type == "cpu":
        return query_labels_plain(packed2, vbits, main, stash, k=k,
                                  nb_bits=nb_bits, stash_bits=stash_bits,
                                  seed=seed)
    return kernels.query(packed2, vbits, main, stash, k=k, nb_bits=nb_bits,
                         stash_bits=stash_bits,
                         consts=feistel_seed_consts(seed))


def query_part_labels_plain(packed2: torch.Tensor, vbits: torch.Tensor,
                            main_part: torch.Tensor,
                            stash: torch.Tensor | None, *, bucket_start: int,
                            nb_local: int, k: int, nb_bits: int,
                            stash_bits: int, seed: int,
                            acc: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the part-mode query kernel: the labels
    of one bucket-range part (main rows [bucket_start, bucket_start +
    nb_local), and the stash when it is given), 0 on invalid windows;
    added into `acc` in place when it is given."""
    _check_part(main_part, bucket_start, nb_local, nb_bits)
    codes = codec.unpack_codes(packed2, vbits)
    kmers, valid = codec.extract_kmers(codes, k)
    canon = codec.canonical(kmers, k)
    labels = probe_qs_split(main_part, stash, nb_bits, stash_bits, seed,
                            canon, bucket_start)
    labels = torch.where(valid, labels, 0)
    if acc is None:
        return labels
    return acc.add_(labels)


def query_part_labels(packed2: torch.Tensor, vbits: torch.Tensor,
                      main_part: torch.Tensor, stash: torch.Tensor | None, *,
                      bucket_start: int, nb_local: int, k: int, nb_bits: int,
                      stash_bits: int, seed: int,
                      acc: torch.Tensor | None = None) -> torch.Tensor:
    """Per-window labels of a wire batch against one bucket-range part
    of a streamed qs table (`cuclark_tpu.pipeline.probe_part_step`):
    main-row bucket b = l2 & (NB-1) counts only when bucket_start <= b <
    bucket_start + nb_local, and then reads row b - bucket_start of
    `main_part`; the stash is probed only when it is passed (one part per
    batch).  With `acc`, the labels are added into it in place (the
    `acc + lab` of the JAX streaming loop) and `acc` is returned.  The
    part-mode query kernel for CUDA tensors, its plain version for CPU
    tensors."""
    check_q_bits("qs", nb_bits, stash_bits)
    if packed2.device.type == "cpu":
        return query_part_labels_plain(
            packed2, vbits, main_part, stash, bucket_start=bucket_start,
            nb_local=nb_local, k=k, nb_bits=nb_bits, stash_bits=stash_bits,
            seed=seed, acc=acc)
    _check_part(main_part, bucket_start, nb_local, nb_bits)
    return kernels.query_part(packed2, vbits, main_part, stash,
                              bucket_start=bucket_start, k=k,
                              nb_bits=nb_bits, stash_bits=stash_bits,
                              consts=feistel_seed_consts(seed), acc=acc)


def _check_part(main_part: torch.Tensor, bucket_start: int, nb_local: int,
                nb_bits: int) -> None:
    if main_part.shape[0] != nb_local:
        raise ValueError(f"part holds {main_part.shape[0]} rows, "
                         f"nb_local is {nb_local}")
    if bucket_start < 0 or bucket_start + nb_local > 1 << nb_bits:
        raise ValueError(f"part rows [{bucket_start}, "
                         f"{bucket_start + nb_local}) exceed 2^{nb_bits}")
