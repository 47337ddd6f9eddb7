"""FASTA/FASTQ reading and paired-end merging.

Counterpart of `cuclark_tpu/io/fasta.py`, carried over unchanged.

Parity notes vs the reference host scanner
(src/CuCLARK_hh.hh:1335-1551, src/file.cc:205-268):
 - record name = token after '>'/'@' up to the first space/tab/newline
   (m_separators, src/CuCLARK_hh.hh:300), truncated by the writer to
   OBJECTNAMEMAX-1 chars;
 - FASTA sequences may span multiple lines; length = sequence chars
   (newlines excluded);
 - FASTQ = 4-line records, sequence on line 2;
 - paired-end mates are joined with a single 'N' (mergePairedFiles,
   src/file.cc:205-268) so no k-mer spans the junction; the joined
   length is normalized by NBN=1 when writing results;
 - gzipped inputs are transparently decompressed (the reference shell
   wrapper's --gzipped staging, classify_metagenome.sh:103-120).

The reference's OpenMP byte-range boundary scan exists to parallelize
mmap scanning; here record iteration is a single linear pass feeding
the packer (a native C scanner can replace it; profile first — the
device probe is the designed bottleneck).
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path


def _open(path):
    p = str(path)
    raw = open(p, "rb")
    head = raw.read(2)
    raw.seek(0)
    if head == b"\x1f\x8b":
        # reopen by PATH: GzipFile(fileobj=raw).close() would not close
        # raw, leaking one fd per gzipped genome until GC
        raw.close()
        return gzip.open(p, "rb")
    return raw


def sniff_format(path) -> str:
    with _open(path) as f:
        first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"unrecognized sequence file format: {path}")


def _name_of(header: bytes) -> str:
    """Token after the marker char up to the first space/tab."""
    for sep in (b" ", b"\t"):
        idx = header.find(sep)
        if idx >= 0:
            header = header[:idx]
    return header.decode("ascii", "replace")


def read_records(path):
    """Yield (name, seq_bytes) from a FASTA or FASTQ file."""
    fmt = sniff_format(path)
    with _open(path) as f:
        bio = io.BufferedReader(f) if not isinstance(f, io.BufferedReader) else f
        if fmt == "fasta":
            name = None
            chunks = []
            for line in bio:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(chunks)
                    name = _name_of(line[1:])
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield name, b"".join(chunks)
        else:
            while True:
                header = bio.readline()
                if not header:
                    break
                if not header.strip():
                    # blank line: tolerated at EOF only (an editor-
                    # appended trailing newline must not crash what the
                    # fast scanner accepts), but a MID-file blank
                    # desyncs the 4-line frame and errors there too
                    rest = bio.read()
                    if rest.strip():
                        raise ValueError(
                            f"malformed FASTQ record in {path}: blank "
                            f"line inside the file")
                    break
                if not header.startswith(b"@"):
                    raise ValueError(
                        f"malformed FASTQ record in {path}: line does "
                        f"not start with '@'")
                name = _name_of(header[1:].rstrip(b"\r\n"))
                seq = bio.readline().rstrip(b"\r\n")
                plus = bio.readline()
                quals = bio.readline()
                if not plus.startswith(b"+") or not quals:
                    # truncated / 3-line record would desync every
                    # following record into garbage
                    raise ValueError(
                        f"truncated or malformed FASTQ record in "
                        f"{path} (read {name!r})")
                yield name, seq


def mate_id(name: str) -> str:
    """The read-pair identity token: the name cut at the first of
    ' ', '/', '\\t' — the separator set the reference merger splits
    headers on before comparing mates (src/file.cc:210-214, 239-244),
    so 'read1/1' and 'read1/2' are the same pair."""
    for sep in (" ", "/", "\t"):
        idx = name.find(sep)
        if idx >= 0:
            name = name[:idx]
    return name


def read_paired_records(path1, path2):
    """Yield (name, seq1 + b'N' + seq2) — mergePairedFiles semantics
    (src/file.cc:205-268): walk both files in lockstep, require the
    mate ids to match record by record (hard error on mismatch, like
    the reference's "read id does not match between files!"), and on
    one file ending before the other.  Names come from file 1.
    """
    import itertools

    it1 = read_records(path1)
    it2 = read_records(path2)
    _MISSING = object()
    for i, (r1, r2) in enumerate(
            itertools.zip_longest(it1, it2, fillvalue=_MISSING)):
        if r1 is _MISSING or r2 is _MISSING:
            short = path1 if r1 is _MISSING else path2
            raise ValueError(
                f"paired files have different record counts: {short} "
                f"ends at record {i}")
        (n1, s1), (n2, s2) = r1, r2
        if mate_id(n1) != mate_id(n2):
            raise ValueError(
                f"read id does not match between files at record {i}: "
                f"{n1!r} vs {n2!r}")
        yield n1, s1 + b"N" + s2


def parse_paired_file_lists(path1, path2, results_path):
    """Reference paired list mode (-P <list1> <list2> -R <list>,
    src/CuCLARK_hh.hh:482-506): when the -P arguments are not sequence
    files, they are lists of mate-file paths, one per line, and -R is a
    matching list of result paths.  Returns [(r1, r2, out), ...] triples
    (stopping at the shortest list, like the reference's lockstep
    getline loop) or None when path1 is itself a sequence file."""
    try:
        sniff_format(path1)
        return None  # plain sequence file: direct paired mode
    except (ValueError, UnicodeDecodeError):
        pass

    if results_path is None:
        raise ValueError("paired list mode needs -R: a matching list "
                         "of result paths")

    def lines(p):
        return [ln.strip() for ln in Path(p).read_text(errors="replace")
                .splitlines() if ln.strip()]

    l1, l2, lr = lines(path1), lines(path2), lines(results_path)
    triples = list(zip(l1, l2, lr))
    if not triples:
        raise ValueError(
            f"Failed to recognize the format of {path1}: not FASTA/FASTQ "
            f"and not a list of mate files")
    for r1, r2, _ in triples:
        for p in (r1, r2):
            if not Path(p).exists():
                raise FileNotFoundError(f"paired list entry not found: {p}")
    return triples


def parse_file_list(path) -> list[tuple[str, str]] | None:
    """Reference multi-file mode (-O/-R lists, src/CuCLARK_hh.hh:382-506):
    if the first line of the objects file has two whitespace-separated
    columns that both name readable files... here: a '.list'/'.txt' file
    whose lines are '<objects> <results>' pairs.  Returns None if `path`
    is itself a sequence file."""
    try:
        fmt = sniff_format(path)
        return None  # plain sequence file
    except (ValueError, UnicodeDecodeError):
        pass
    pairs = []
    for line in Path(path).read_text(errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 2 or not Path(parts[0]).exists():
            # neither a sequence file nor an objects/results list —
            # reference: "Failed to recognize the format of the file."
            raise ValueError(
                f"Failed to recognize the format of {path}: not FASTA/FASTQ "
                f"and not an '<objects> <results>' list (bad line: {line!r})"
            )
        pairs.append((parts[0], parts[1]))
    if not pairs:
        raise ValueError(
            f"Failed to recognize the format of {path}: empty file "
            f"(not FASTA/FASTQ and no '<objects> <results>' lines)")
    return pairs
