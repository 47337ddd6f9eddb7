"""NCBI taxonomy utilities.

Rebuilds the three reference taxonomy tool binaries as one module:
 - accession -> taxid join with merged-id remapping
   (getAccssnTaxID, src/getAccssnTaxID.cc:47-189)
 - nodes.dmp ancestry walk to the six standard ranks
   (getfilesToTaxNodes getSGFOCP, src/getfilesToTaxNodes.cc:39-153)
 - rank-column projection into targets.txt
   (getTargetsDef, src/getTargetsDef.cc:38-96)

All of this is I/O-bound dictionary work; Python dicts replace the
reference's 20M-slot parent/rank arrays.

Counterpart of `cuclark_tpu/taxonomy/ncbi.py`, carried over with its
one import pointed at this package's `io/fasta.py`.
"""

from __future__ import annotations

import gzip
from pathlib import Path

RANKS = ["species", "genus", "family", "order", "class", "phylum"]


def _open_maybe_gz(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")
    return open(p, "rt")


def load_merged(path) -> dict[int, int]:
    """merged.dmp: old_taxid -> new_taxid."""
    out = {}
    with _open_maybe_gz(path) as f:
        for line in f:
            parts = [t.strip() for t in line.split("|")]
            if len(parts) >= 2 and parts[0] and parts[1]:
                out[int(parts[0])] = int(parts[1])
    return out


def load_nodes(path):
    """nodes.dmp -> (parent: {taxid: taxid}, rank: {taxid: str})."""
    parent, rank = {}, {}
    with _open_maybe_gz(path) as f:
        for line in f:
            parts = [t.strip() for t in line.split("|")]
            if len(parts) >= 3:
                tid = int(parts[0])
                parent[tid] = int(parts[1])
                rank[tid] = parts[2]
    return parent, rank


def load_names(path) -> dict[int, str]:
    """names.dmp scientific names: taxid -> name."""
    out = {}
    with _open_maybe_gz(path) as f:
        for line in f:
            parts = [t.strip() for t in line.split("|")]
            if len(parts) >= 4 and parts[3] == "scientific name":
                out[int(parts[0])] = parts[1]
    return out


def first_accession(seq_file) -> str | None:
    """Accession from the first FASTA header of a genome file
    (reference reads only the first header, src/getAccssnTaxID.cc:80-110).
    Strips the version suffix ('NC_000913.3' -> 'NC_000913')."""
    from cuclark_tpu_torch.io.fasta import _open

    with _open(seq_file) as f:
        line = f.readline()
    if not line.startswith((b">", b"@")):
        return None
    tokens = line[1:].split()
    if not tokens:  # bare '>' marker with no name
        return None
    token = tokens[0].decode("ascii", "replace")
    # strip trailing |-delimited formats like gi|...|ref|ACC.V|
    if "|" in token:
        fields = [t for t in token.split("|") if t]
        token = fields[-1]
    return token.split(".")[0]


def accession_to_taxid(accessions, accession2taxid_files, merged=None):
    """Join accessions against accession2taxid table(s).

    accession2taxid format: header + rows
    'accession\taccession.version\ttaxid\tgi'.  Returns {accession: taxid}
    with merged.dmp remapping applied.
    """
    want = set(accessions)
    out: dict[str, int] = {}
    for path in accession2taxid_files:
        if len(out) == len(want):
            break
        with _open_maybe_gz(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3 or parts[0] == "accession":
                    continue
                acc = parts[0]
                if acc in want and acc not in out:
                    tid = int(parts[2])
                    if merged:
                        tid = merged.get(tid, tid)
                    out[acc] = tid
                    if len(out) == len(want):
                        # tables are tens of GB: stop once every wanted
                        # accession resolved
                        break
    return out


def lineage_ranks(taxid: int, parent, rank) -> dict[str, int]:
    """Walk ancestry collecting the six standard rank taxids
    (getSGFOCP semantics; missing ranks stay absent)."""
    out = {}
    seen = set()
    t = taxid
    while t and t not in seen:
        seen.add(t)
        r = rank.get(t)
        if r in RANKS and r not in out:
            out[r] = t
        p = parent.get(t)
        if p is None or p == t:
            break
        t = p
    return out


def files_to_tax_nodes(file_taxids, parent, rank):
    """[(file, taxid)] -> [(file, {rank: taxid})]."""
    return [(fp, lineage_ranks(tid, parent, rank)) for fp, tid in file_taxids]


def targets_def_lines(file_ranks, rank_name: str, names=None):
    """Project one rank column into targets.txt lines
    '<file> <label>'; files without that rank are excluded
    (files_excluded.txt in the reference, src/getTargetsDef.cc:60-90).

    Returns (lines, excluded_files)."""
    lines, excluded = [], []
    for fp, ranks in file_ranks:
        tid = ranks.get(rank_name)
        if tid is None:
            excluded.append(fp)
            continue
        label = names.get(tid, str(tid)) if names else str(tid)
        label = label.replace(" ", "_")
        lines.append(f"{fp} {label}")
    return lines, excluded
