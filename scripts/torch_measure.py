"""The measures that the port's card scripts share: a kernel's time by CUDA
events, the least time of the bytes it must move, the rows a query
reads, and the gather-only ceiling of those rows.  `chip_smoke.py`,
`bench_torch.py` and the scripts in this directory take their kernel
rows from here, so that one definition of each measure holds everywhere.

`fused_row` is the row of the fused query and score kernel on one wire
batch: it holds the kernel to its plain version (`check_fused`), then
times both and gives the batch's bound and ceiling.  The gather-only
ceiling kernel is `scripts/csrc/gather_ceiling.cu`, built by
`torch_gather_ceiling.build()`.

The timing functions (`cuda_ms`, the two gathers, `layout_ceilings`,
`fused_row`) need the card; the others run on the CPU as well.
"""

from __future__ import annotations

import numpy as np


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    if not a.numel():
        return 0
    return int((a.to(dtype=b.dtype) - b).abs().max().item())


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)


def bound_ms(nbytes: float) -> float:
    """The least time to move nbytes through device memory, in ms: the
    bound of every kernel here (bytes; their integer operations need far
    less time at the card's rates)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def choice_rows(codes, main, spec, k: int):
    """For a q4 or s2 table (main rows on the card): per valid window of
    codes [R, L], in window order, its choice-0 main row, its choice-1
    main row, whether it has a choice 1 at all (s2: two choices and
    another bucket than choice 0's) and whether choice 0 gave label 0.
    The query kernel gathers the choice-1 row where both hold."""
    import torch

    from cuclark_tpu_torch import codec, probe
    from cuclark_tpu_torch.hashdb import (feistel_mix_torch, mix1_torch,
                                          mix2_torch)

    kmers, valid = codec.extract_kmers(codes, k)
    km = codec.canonical(kmers, k)[valid]
    hi, lo = codec.shr(km, 32), km & 0xFFFFFFFF
    mask = (1 << spec.nb_bits) - 1
    if spec.layout == "q4":
        h1, l2 = feistel_mix_torch(hi, lo, spec.seed)
        rows0, rows1 = l2 & mask, h1 & mask
        lab0 = probe._match_labels(main, rows0, l2, h1, spec.nb_bits, 0)
        return rows0, rows1, torch.ones_like(rows0, dtype=torch.bool), \
            lab0 == 0
    rows0 = mix1_torch(hi, lo) & mask
    rows1 = mix2_torch(hi, lo) & mask if spec.num_choices == 2 else rows0
    lab0 = probe.probe_s2(main, spec.nb_bits, spec.slots, 1, km)
    return rows0, rows1, rows1 != rows0, lab0 == 0


def exact_rows(choices):
    """The main rows an exact probe of a q4 or s2 table reads for
    choice_rows' windows, in window order: each window's choice-0 row,
    then its choice-1 row where it has one and choice 0 gave label 0."""
    import torch

    rows0, rows1, has1, zero = choices
    return torch.stack([rows0, rows1], 1)[
        torch.stack([torch.ones_like(has1), has1 & zero], 1)]


def touched_rows(codes, spec, k: int, main=None):
    """The rows that the valid windows of codes [R, L] on the card make a
    query read: (distinct global main buckets, sorted; distinct stash
    buckets of a qs table, else None), each row read once.  A q4 or s2
    table's main rows `main` are needed: an exact probe reads the
    choice-0 row of every window and the choice-1 row only of the
    windows that choice 0 does not answer.  Given a qs table's `main`,
    the stash rows are those a resident query reads (`qs_window_rows`);
    without it, every window's (a range call's)."""
    import torch

    from cuclark_tpu_torch import codec
    from cuclark_tpu_torch.hashdb import feistel_mix_torch

    if spec.layout != "qs":
        return torch.unique(exact_rows(choice_rows(codes, main, spec,
                                                   k))), None
    rows = qs_window_rows(codes, spec, k, main)
    return torch.unique(rows[:, 0]), torch.unique(rows[rows[:, 1] >= 0, 1])


def qs_window_rows(codes, spec, k: int, main=None):
    """The rows of a qs table that every valid window of codes [R, L]
    has, in window order with repeats: int32 [n, 2] of (main bucket
    l2 & (NB - 1), stash bucket h1 & (NBS - 1)).  Given the table's main
    rows `main`, the stash bucket is -1 where a query over every main row
    reads no stash row (csrc/query.cu, qs_label): the main row gives a
    label or is not full (in a `spec.sampled` table: neither full nor
    empty)."""
    import torch

    from cuclark_tpu_torch import codec, probe
    from cuclark_tpu_torch.hashdb import feistel_mix_torch

    kmers, valid = codec.extract_kmers(codes, k)
    km = codec.canonical(kmers, k)[valid]
    h1, l2 = feistel_mix_torch(codec.shr(km, 32), km & 0xFFFFFFFF, spec.seed)
    b0 = l2 & ((1 << spec.nb_bits) - 1)
    b1 = h1 & ((1 << spec.stash_bits) - 1)
    if main is not None:
        lab = probe._match_labels(main, b0, l2, h1, spec.nb_bits, 0)
        used = ((main[b0][:, 4:] & 0xFFFF) != 0).sum(1)
        may_hold = (used == 4) | ((used == 0) & spec.sampled)
        b1 = torch.where((lab == 0) & may_hold, b1, -1)
    return torch.stack([b0, b1], 1).to(torch.int32)


def gather_ceiling_ms(lib, main_t, buckets) -> float:
    """Milliseconds of the gather-only kernel (scripts/csrc/
    gather_ceiling.cu, gc_gather) over `buckets` in their order: each a
    qs main row read as the query reads it, nothing else: the practical
    ceiling of the query's main-row gathers."""
    import torch

    n = int(buckets.numel())
    out = torch.empty(n // 128 + 1, dtype=torch.int32, device=main_t.device)

    def run():
        err = lib.gc_gather(main_t.data_ptr(), buckets.data_ptr(), n, 0,
                            out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gc_gather failed: CUDA error {err}")
    return cuda_ms(run, 20)


def gather_ceiling_stash_ms(lib, main_t, stash_t, rows) -> float:
    """Milliseconds of the gather-only kernel (scripts/csrc/
    gather_ceiling.cu, gc_gather_qs) over `rows`, int32 [n, 2] of (main
    bucket, stash bucket or -1) in their order (`qs_window_rows`): each
    window's main row read as gather_ceiling_ms reads it and its stash
    row, where it has one, as the query reads it, nothing else: the
    practical ceiling of the qs query's gathers of both tables."""
    import torch

    n = int(rows.shape[0])
    rows = rows.contiguous()
    out = torch.empty(n // 128 + 1, dtype=torch.int32, device=main_t.device)

    def run():
        err = lib.gc_gather_qs(main_t.data_ptr(), stash_t.data_ptr(),
                               rows.data_ptr(), n, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gc_gather_qs failed: CUDA error {err}")
    return cuda_ms(run, 20)


def layout_gathers(lib, main_t, rows, spec) -> float:
    """Milliseconds of the gather-only kernel (scripts/csrc/
    gather_ceiling.cu, gc_gather_layout) over q4 or s2 main rows `rows`
    in their order, each read as the query reads it (q4: two 16 B loads;
    s2: the low key words, 8 B loads at even slots)."""
    import torch

    n = int(rows.numel())
    rows = rows.to(torch.int32).contiguous()
    out = torch.empty(n // 128 + 1, dtype=torch.int32, device=main_t.device)
    layout = {"q4": 1, "s2": 2}[spec.layout]

    def run():
        err = lib.gc_gather_layout(main_t.data_ptr(), rows.data_ptr(), n,
                                   layout, spec.slots, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gc_gather_layout failed: CUDA error {err}")
    return cuda_ms(run, 20)


def layout_ceilings(lib, main_t, choices, spec, parts: int):
    """The practical ceiling of a q4 or s2 query's gathers (choice_rows'
    output for one batch): the gather-only kernel over the rows an exact
    probe reads, in window order (a window's choice-0 row, then its
    choice-1 row where choice 0 gave label 0) -> (resident ms, mean ms
    of a part call of `parts`, in which a window whose choice 0 lies in
    another part gathers its choice-1 row too, ms of the last part's
    call)."""
    import torch

    rows0, rows1, has1, zero = choices
    resident = layout_gathers(lib, main_t, exact_rows(choices), spec)
    pair = torch.stack([rows0, rows1], 1)
    prow = main_t.shape[0] // parts
    part_ms = []
    for j in range(parts):
        in0, in1 = rows0 // prow == j, rows1 // prow == j
        part_ms.append(layout_gathers(lib, main_t, pair[torch.stack(
            [in0, in1 & has1 & (zero | ~in0)], 1)], spec))
    return resident, float(np.mean(part_ms)), part_ms[-1]


def range_rows(codes, main_t, spec, k: int, start: int, rows: int,
               sstart: int = 0, srows: int = 0):
    """The rows a range call (main rows [start, start + rows) and, for
    qs, stash rows [sstart, sstart + srows)) gathers for the valid
    windows of codes [R, L], in window order with repeats: a q4 or s2
    window's choice-0 row where it lies in the range, its choice-1 row
    where that lies in the range and choice 0 lies outside or gives label
    0 -> (main rows, None); a qs window's main row and its stash row
    where each lies in its range -> (main buckets, stash buckets)."""
    import torch

    def within(b, lo, n):
        return (b >= lo) & (b < lo + n)

    if spec.layout == "qs":
        both = qs_window_rows(codes, spec, k).to(torch.int64)
        return (both[within(both[:, 0], start, rows), 0],
                both[within(both[:, 1], sstart, srows), 1])
    rows0, rows1, has1, zero = choice_rows(codes, main_t, spec, k)
    in0, in1 = within(rows0, start, rows), within(rows1, start, rows)
    pair = torch.stack([rows0, rows1], 1)
    return pair[torch.stack([in0, in1 & has1 & (zero | ~in0)], 1)], None


def range_ceiling_ms(lib, main_t, stash_t, gathered, spec) -> float:
    """The practical ceiling of a range call's gathers: the gather-only
    kernel over range_rows' rows in window order (a qs call's main rows,
    then its stash rows: two launches whose times add)."""
    import torch

    main, stash = gathered
    if spec.layout != "qs":
        return layout_gathers(lib, main_t, main, spec)
    ms = gather_ceiling_ms(lib, main_t, main.to(torch.int32).contiguous())
    if stash is not None and stash.numel():
        ms += gather_ceiling_ms(lib, stash_t,
                                stash.to(torch.int32).contiguous())
    return ms


def query_bytes(touched, spec, in_bytes: int, out_bytes: int,
                parts: int = 1, later_hits: int = 0) -> float:
    """Least bytes of a query per call: its input (wire or codes) and its
    output once, and each table row it needs once (qs stash rows 32 B).
    Over a pass of `parts` range calls, every call reads the input and
    the first writes the labels; a later call adds into them and leaves
    every window it does not answer as it is, so it reads and writes the
    4 B accumulator of its hits only (later_hits: the windows that calls
    1.. answer, summed); the table rows split over the calls."""
    main, stash = touched
    rows = spec.row_words * 4 * len(main) + (32 * len(stash)
                                             if stash is not None else 0)
    return (parts * in_bytes + out_bytes + 8 * later_hits + rows) / parts


def check_fused(p2, vb, main_t, stash_t, *, k: int, spec, two: bool = False,
                also=()):
    """The fused query and score kernel's results on the wire batch
    (p2, vb) (`probe.query_score_results`) held to its plain version, with
    two=True also to the query then score kernels, and to each tensor of
    `also`; raises on a difference.  Returns (results, max abs error
    against plain)."""
    import torch

    from cuclark_tpu_torch import probe, score

    qargs = dict(k=k, spec=spec)
    res = probe.query_score_results(p2, vb, main_t, stash_t, **qargs)
    if res.is_cuda:
        torch.cuda.synchronize()
    want = {"plain": probe.query_score_results_plain(p2, vb, main_t,
                                                     stash_t, **qargs)}
    if two:
        want["query then score"] = score.score_labels(probe.query_labels(
            p2, vb, main_t, stash_t, **qargs))
    for i, other in enumerate(also):
        want[f"also[{i}]"] = other
    bad = [name for name, w in want.items() if not torch.equal(res, w)]
    if bad:
        raise AssertionError(f"the fused {spec.layout} query and score "
                             f"differs from {', '.join(bad)} on "
                             f"{tuple(p2.shape)} wire bytes")
    return res, max_abs_err(res, want["plain"])


def fused_row(p2, vb, main_t, stash_t, *, k: int, spec, ceiling_lib,
              two: bool = False, also=(), reps: int = 20,
              plain_reps: int = 3):
    """The fused query and score kernel on the wire batch (p2, vb) on the
    card: `check_fused` (two, also as there), then its row: max_abs_err;
    bound_ms, the least time of the batch's wire bytes, 20 B a read out
    and each table row it needs once (`query_bytes`); ceiling_ms, the
    gather-only kernel over the rows the probe reads, in window order (a
    qs table's main buckets; a q4 or s2 table's rows of an exact probe);
    for qs also ceiling_stash_ms, the same over the main row of every
    window and the stash rows the query reads (`qs_window_rows` with the
    table, `gather_ceiling_stash_ms`), and stash_share, the share of valid
    windows whose stash row it reads;
    ms and plain_ms by CUDA events (reps, plain_reps calls), and two_ms,
    the query then score kernels, where two.  Returns (row, results)."""
    import torch

    from cuclark_tpu_torch import codec, probe, score

    res, err = check_fused(p2, vb, main_t, stash_t, k=k, spec=spec, two=two,
                           also=also)
    unpacked = codec.unpack_codes(p2, vb)
    extra = {}
    if spec.layout == "qs":
        touched = touched_rows(unpacked, spec, k, main_t)
        rows = qs_window_rows(unpacked, spec, k, main_t)
        ceiling = gather_ceiling_ms(ceiling_lib, main_t,
                                    rows[:, 0].contiguous())
        extra["ceiling_stash_ms"] = gather_ceiling_stash_ms(
            ceiling_lib, main_t, stash_t, rows)
        extra["stash_share"] = float((rows[:, 1] >= 0).float().mean())
        del rows
    else:
        rows = exact_rows(choice_rows(unpacked, main_t, spec, k))
        touched = (torch.unique(rows), None)
        ceiling = layout_gathers(ceiling_lib, main_t, rows, spec)
        del rows
    row = {"max_abs_err": err,
           "bound_ms": bound_ms(query_bytes(touched, spec,
                                            p2.numel() + vb.numel(),
                                            20 * p2.shape[0])),
           "ceiling_ms": ceiling, **extra}
    del unpacked, touched
    qargs = dict(k=k, spec=spec)
    row["ms"] = cuda_ms(lambda: probe.query_score_results(
        p2, vb, main_t, stash_t, **qargs), reps)
    row["plain_ms"] = cuda_ms(lambda: probe.query_score_results_plain(
        p2, vb, main_t, stash_t, **qargs), plain_reps)
    if two:
        row["two_ms"] = cuda_ms(lambda: score.score_labels(probe.query_labels(
            p2, vb, main_t, stash_t, **qargs)), reps)
    return row, res
