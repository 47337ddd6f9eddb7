"""Vectorized FASTA/FASTQ scanning and read packing.

Counterpart of `cuclark_tpu/io/fast_parse.py` (`scan_file`,
`pack_block2_dispatch`), carried over; the mate-id check
(`first_mate_mismatch`) goes native, and the numpy check stays as its
plain version (`first_mate_mismatch_plain`).

The equivalent of the reference's OpenMP record scanner +
container packer (src/CuCLARK_hh.hh:1335-1551 boundary scan;
:1608-1763 per-batch 2-bit packing).  Instead of per-byte character
loops across host threads, whole-buffer numpy passes find newlines and
record boundaries, and one fancy-index gather builds the padded
[reads, max_len] code matrix the device step consumes.

A native C++ scanner (csrc/host_ops.cpp) replaces the numpy passes
when it builds; the numpy passes are the bit-identical fallback.
"""

from __future__ import annotations

import numpy as np

from cuclark_tpu_torch import codec


def _newlines(buf: np.ndarray) -> np.ndarray:
    return np.flatnonzero(buf == ord("\n"))


def scan_fastq(buf: np.ndarray):
    """buf: uint8 array of a whole FASTQ file.

    Returns (name_starts, name_ends, seq_starts, seq_ends) int64 arrays.
    Record = 4 lines; name = token after '@' up to first space/tab.
    """
    nl = _newlines(buf)
    if len(buf) and buf[-1] != ord("\n"):
        nl = np.r_[nl, len(buf)]
    n_rec = len(nl) // 4
    if n_rec == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    line_starts = np.r_[0, nl[:-1] + 1]
    hdr0 = line_starts[0::4][:n_rec]
    ok = buf[np.minimum(hdr0, len(buf) - 1)] == ord("@")
    if not ok.all():
        bad = int(hdr0[np.flatnonzero(~ok)[0]])
        raise ValueError(
            f"malformed FASTQ record at byte {bad}: line does not "
            f"start with '@' (remainder would be silently skipped)")
    hdr_s = hdr0 + 1                               # skip '@'
    hdr_e = nl[0::4][:n_rec]
    seq_s = line_starts[1::4][:n_rec]
    seq_e = nl[1::4][:n_rec]
    name_e = _token_ends(buf, hdr_s, hdr_e)
    return hdr_s, name_e, seq_s, seq_e


def scan_fasta(buf: np.ndarray):
    """buf: uint8 array of a whole FASTA file (multi-line sequences OK).

    Returns (name_starts, name_ends, seq_starts, seq_ends) where the
    sequence range may contain newlines (the packer drops them, exactly
    like the reference packer skips '\\n', src/CuCLARK_hh.hh:1674-1678).
    """
    starts = np.flatnonzero(buf == ord(">"))
    # keep only '>' at line starts
    at_bol = (starts == 0) | (buf[np.maximum(starts - 1, 0)] == ord("\n"))
    starts = starts[at_bol]
    if len(starts) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    nl = _newlines(buf)
    if len(buf) and buf[-1] != ord("\n"):
        nl = np.r_[nl, len(buf)]  # virtual newline: truncated tail
    hdr_s = starts + 1
    hdr_e = nl[np.searchsorted(nl, starts)]
    # a final header-only record without its newline has hdr_e at the
    # virtual end-of-buffer newline; clamp so seq_s never exceeds
    # seq_e (a negative-length range would crash the packer)
    seq_e = np.r_[starts[1:], len(buf)]
    seq_s = np.minimum(hdr_e + 1, seq_e)
    name_e = _token_ends(buf, hdr_s, hdr_e)
    return hdr_s, name_e, seq_s, seq_e


def _token_ends(buf, starts, ends):
    """First space/tab/CR position in [start, end), else end — the
    reference's separator table (src/CuCLARK_hh.hh:300) plus CR so
    Windows line endings never leak into CSV names."""
    sep_pos = np.flatnonzero((buf == ord(" ")) | (buf == ord("\t"))
                             | (buf == ord("\r")))
    if len(sep_pos) == 0:
        return np.asarray(ends).copy()
    i0 = np.searchsorted(sep_pos, starts)
    cand = sep_pos[np.minimum(i0, len(sep_pos) - 1)]
    return np.where((i0 < len(sep_pos)) & (cand < ends), cand, ends)


def pack_block(buf: np.ndarray, seq_s, seq_e, max_len: int,
               n_rows: int | None = None):
    """Encode+pad sequences into a codes matrix in one gather.

    Returns (codes uint8 [R, max_len], lengths int64 [R]) where lengths
    count sequence characters excluding newlines (reference readsLength
    semantics, src/CuCLARK_hh.hh:1380-1390).  Newlines inside a
    sequence range become INVALID codes, which the part semantics of
    the k-mer extractor already treat as boundaries... except newlines
    must NOT break parts; the packer therefore compacts them away.
    """
    R = n_rows if n_rows is not None else len(seq_s)
    seq_s = np.asarray(seq_s, np.int64)
    seq_e = np.asarray(seq_e, np.int64)
    codes = np.full((R, max_len), codec.INVALID, dtype=np.uint8)
    n = len(seq_s)
    if n == 0:
        return codes, np.zeros(R, np.int64)

    # all whole-buffer passes below run on the batch's byte span only —
    # per-batch calls over a multi-GB file must not redo file-sized
    # LUT/newline/cumsum work every time
    lo_span = int(seq_s.min())
    sub = buf[lo_span:int(seq_e.max())]
    seq_s = seq_s - lo_span
    seq_e = seq_e - lo_span
    raw_len = seq_e - seq_s
    enc = codec.BASE_LUT[sub]
    is_nl = (sub == ord("\n")) | (sub == ord("\r"))

    # per-record newline counts via prefix sums -> true lengths
    nl_cs = np.r_[0, np.cumsum(is_nl)]
    lengths = raw_len - (nl_cs[seq_e] - nl_cs[seq_s])

    if (raw_len == lengths).all():
        # fast path: no embedded newlines (FASTQ, single-line FASTA)
        L = min(max_len, int(raw_len.max(initial=0)))
        pos = seq_s[:, None] + np.arange(L)[None, :]
        mask = np.arange(L)[None, :] < raw_len[:, None]
        codes[:n, :L] = np.where(mask, enc[np.minimum(pos, len(sub) - 1)],
                                 codec.INVALID)
    else:
        # compact newlines away with a span-local compress, then gather
        keep = ~is_nl
        comp = enc[keep]
        # map span offset -> compacted offset
        keep_cs = np.r_[0, np.cumsum(keep)]
        cs = keep_cs[seq_s]
        L = min(max_len, int(lengths.max(initial=0)))
        pos = cs[:, None] + np.arange(L)[None, :]
        mask = np.arange(L)[None, :] < lengths[:, None]
        codes[:n, :L] = np.where(mask, comp[np.minimum(pos, len(comp) - 1)],
                                 codec.INVALID)

    full_lengths = np.zeros(R, np.int64)
    full_lengths[:n] = lengths
    return codes, full_lengths


def first_mate_mismatch(buf1, ns1, ne1, buf2, ns2, ne2) -> int:
    """Mate-id validation for the file fast path: the native check on
    the OpenMP team (`native.first_mate_mismatch`) when the native module
    is available, else `first_mate_mismatch_plain`; both give the same
    index."""
    from cuclark_tpu_torch import native

    if native.available():
        return native.first_mate_mismatch(buf1, ns1, ne1, buf2, ns2, ne2)
    return first_mate_mismatch_plain(buf1, ns1, ne1, buf2, ns2, ne2)


def first_mate_mismatch_plain(buf1, ns1, ne1, buf2, ns2, ne2) -> int:
    """Vectorized mate-id validation, the plain version the native check
    is held to (tests, chip_smoke.py, the host scripts).

    Names (already cut at space/tab by the scan) are further cut at '/'
    — the reference merger's separator set (src/file.cc:210-214) — and
    compared row by row.  Returns the index of the first mismatching
    record, or -1 if all match."""
    n = min(len(ns1), len(ns2))
    if n == 0:
        return -1

    def id_matrix(buf, s, e):
        s = np.asarray(s[:n], np.int64)
        e = np.asarray(e[:n], np.int64)
        ln = e - s
        L = int(ln.max(initial=1))
        pos = s[:, None] + np.arange(L)[None, :]
        m = buf[np.minimum(pos, len(buf) - 1)]
        valid = np.arange(L)[None, :] < ln[:, None]
        m = np.where(valid, m, 0)
        # cut at the first '/' per row
        slash = m == ord("/")
        idlen = np.where(slash.any(axis=1), slash.argmax(axis=1), ln)
        m = np.where(np.arange(L)[None, :] < idlen[:, None], m, 0)
        return m, idlen

    m1, l1 = id_matrix(buf1, ns1, ne1)
    m2, l2 = id_matrix(buf2, ns2, ne2)
    L = max(m1.shape[1], m2.shape[1])
    if m1.shape[1] < L:
        m1 = np.pad(m1, ((0, 0), (0, L - m1.shape[1])))
    if m2.shape[1] < L:
        m2 = np.pad(m2, ((0, 0), (0, L - m2.shape[1])))
    ok = (l1 == l2) & (m1 == m2).all(axis=1)
    if ok.all():
        return -1
    return int(np.flatnonzero(~ok)[0])


def names_of(buf: np.ndarray, name_s, name_e) -> list[str]:
    if len(name_s) == 0:
        return []
    # copy only this batch's name span — buf is the whole file, and a
    # full tobytes() per batch would be O(batches x file_size)
    lo = int(min(name_s))
    b = buf[lo:int(max(name_e))].tobytes()
    return [b[s - lo:e - lo].decode("ascii", "replace")
            for s, e in zip(name_s, name_e)]


def scan_file(buf: np.ndarray):
    """Dispatch on leading byte like the reference
    (src/CuCLARK_hh.hh:1340, 1403).  Uses the native C++ scanner when
    available (cuclark_tpu_torch.native), these numpy passes otherwise."""
    from cuclark_tpu_torch import native

    if len(buf) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    if native.available():
        return native.scan(buf)
    if buf[0] == ord(">"):
        return scan_fasta(buf)
    if buf[0] == ord("@"):
        return scan_fastq(buf)
    raise ValueError("Failed to recognize the format of the file.")


def pack_block_dispatch(buf, seq_s, seq_e, max_len, n_rows=None):
    """Native packer when available, numpy otherwise."""
    from cuclark_tpu_torch import native

    if native.available():
        return native.pack_block(buf, seq_s, seq_e, max_len, n_rows)
    return pack_block(buf, seq_s, seq_e, max_len, n_rows)


def _into(out, packed2, vbits, lengths):
    """The fallback's arrays, copied into `out` when the caller gave it."""
    if out is None:
        return packed2, vbits, lengths
    for dst, src in zip(out, (packed2, vbits, lengths)):
        np.copyto(dst, src)
    return out


def pack_block2_dispatch(buf, seq_s, seq_e, max_len, n_rows=None,
                         out=None):
    """Pack records straight into the 2-bit wire format (packed2,
    vbits, lengths), into `out` when given (`native.pack_block2`).  One
    fused native sweep when available; the two-pass numpy fallback
    (pack_block + codec.pack_codes) is bit-identical."""
    from cuclark_tpu_torch import native

    if native.available():
        return native.pack_block2(buf, seq_s, seq_e, max_len, n_rows,
                                  out=out)
    codes, lengths = pack_block(buf, seq_s, seq_e, max_len, n_rows)
    return _into(out, *codec.pack_codes(codes), lengths)


def pack_block2_paired_dispatch(buf1, s1, e1, buf2, s2, e2, max_len,
                                n_rows=None, out=None):
    """Paired-end mates -> one wire-format row per pair: mate1, a
    joining invalid position (the 'N' of the reference mergePairedFiles,
    src/file.cc:205-268), mate2; into `out` when given.  One fused
    native sweep when available; the numpy fallback (pack + shift-merge
    + re-pack) is bit-identical.  lengths = len1 + 1 + len2 (true char
    counts)."""
    from cuclark_tpu_torch import native

    if native.available():
        return native.pack_block2_paired(buf1, s1, e1, buf2, s2, e2,
                                         max_len, n_rows, out=out)
    codes1, len1 = pack_block(buf1, s1, e1, max_len, n_rows)
    codes, lengths = merge_paired_codes(codes1, len1, buf2, s2, e2,
                                        codes1.shape[1])
    lengths[len(s1):] = 0  # padding rows carry no joining 'N'
    return _into(out, *codec.pack_codes(codes), lengths)


def merge_paired_codes(codes1, len1, buf2, s2, e2, width):
    """Append mate-2 codes after a joining INVALID (numpy fallback of
    the fused paired packer; mergePairedFiles parity)."""
    codes2, len2 = pack_block(buf2, s2, e2, width, n_rows=codes1.shape[0])
    L = width
    out = codes1.copy()
    # place mate 2 at offset len1 + 1 per row (vectorized shift-gather)
    col = np.arange(L)[None, :]
    src_col = col - (len1[:, None] + 1)
    take = np.clip(src_col, 0, L - 1)
    shifted = np.take_along_axis(codes2, take, axis=1)
    use = (src_col >= 0) & (src_col < len2[:, None])
    out = np.where(use, shifted, out).astype(np.uint8)
    return out, len1 + len2 + 1
