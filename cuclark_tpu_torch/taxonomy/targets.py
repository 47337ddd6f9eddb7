"""set-targets workflow: reference dirs -> targets.txt.

Rebuilds the shell workflow set_targets.sh + make_metadata.sh
(set_targets.sh:88-126, make_metadata.sh:91-123): scan reference
genome directories, resolve each file's accession to a taxid, walk the
taxonomy to the requested rank, and write <db_dir>/targets.txt plus a
.settings file recording the choice (classify_metagenome.sh:84-87
prepends these settings to the classify call).

Counterpart of `cuclark_tpu/taxonomy/targets.py`, carried over
unchanged; `cuclark-tpu-torch classify` honours the `.settings` it
writes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from cuclark_tpu_torch.taxonomy import ncbi

SEQ_SUFFIXES = {".fa", ".fna", ".fasta", ".ffn", ".fq", ".fastq"}


def find_sequence_files(ref_dirs):
    out = []
    for d in ref_dirs:
        for p in sorted(Path(d).rglob("*")):
            s = p.name.lower()
            base = s[:-3] if s.endswith(".gz") else s
            if (p.is_file()
                    and any(base.endswith(suf) for suf in SEQ_SUFFIXES)):
                out.append(p)
    return out


def set_targets(args) -> int:
    db_dir = Path(args.db_dir)
    db_dir.mkdir(parents=True, exist_ok=True)
    files = find_sequence_files(args.ref_dirs)
    if not files:
        print("no sequence files found", file=sys.stderr)
        return 1

    if args.rank != "custom" and not args.taxonomy_dir:
        print(f"error: --rank {args.rank} needs --taxonomy-dir (with "
              f"nodes.dmp and accession2taxid); use --rank custom for "
              f"per-file labels", file=sys.stderr)
        return 1
    if args.rank == "custom":
        # custom mode: label = file stem (reference custom DB workflow,
        # README.md custom targets); strip a trailing .gz BEFORE the
        # suffix so compressed and plain copies of a genome get the
        # SAME label (Path('x.fna.gz').stem is 'x.fna')
        def label_of(p: Path) -> str:
            name = p.name[:-3] if p.name.lower().endswith(".gz") else p.name
            return Path(name).stem

        lines = [f"{p} {label_of(p)}" for p in files]
        excluded = []
    else:
        tax = Path(args.taxonomy_dir)

        def dump(name: str) -> Path | None:
            # the ncbi loaders read gzipped dumps transparently
            # (_open_maybe_gz); resolve either form here
            for cand in (tax / name, tax / f"{name}.gz"):
                if cand.exists():
                    return cand
            return None

        nodes_p = dump("nodes.dmp")
        if nodes_p is None:
            print(f"error: no nodes.dmp (or nodes.dmp.gz) in {tax}",
                  file=sys.stderr)
            return 1
        parent, rank = ncbi.load_nodes(nodes_p)
        names_p = dump("names.dmp")
        names = ncbi.load_names(names_p) if names_p else None
        merged_p = dump("merged.dmp")
        a2t_files = sorted(tax.glob("*accession2taxid*"))
        accs = {}
        for p in files:
            acc = ncbi.first_accession(p)
            if acc:
                accs[str(p)] = acc
        acc2tid = ncbi.accession_to_taxid(
            set(accs.values()), a2t_files,
            merged=ncbi.load_merged(merged_p) if merged_p else None,
        )
        file_taxids = [
            (fp, acc2tid[acc]) for fp, acc in accs.items() if acc in acc2tid
        ]
        file_ranks = ncbi.files_to_tax_nodes(file_taxids, parent, rank)
        lines, excluded = ncbi.targets_def_lines(file_ranks, args.rank, names)
        resolved = {fp for fp, _ in file_taxids}
        excluded += [str(p) for p in files if str(p) not in resolved]

    if not lines:
        print(f"error: no target could be labeled at rank "
              f"{args.rank!r} ({len(excluded)} file(s) excluded — is "
              f"the taxonomy dir missing accession2taxid tables?)",
              file=sys.stderr)
        return 1
    # targets.txt columns are whitespace-separated (reference
    # getTargetsData): a path containing whitespace cannot be recorded
    bad = [ln for ln in lines if len(ln.split()) != 2]
    if bad:
        print(f"error: sequence path contains whitespace and cannot be "
              f"written to targets.txt: {bad[0].rsplit(None, 1)[0]!r}",
              file=sys.stderr)
        return 1

    (db_dir / "targets.txt").write_text("\n".join(lines) + "\n")
    if excluded:
        (db_dir / "files_excluded.txt").write_text("\n".join(excluded) + "\n")
    # classify consumes this: the recorded targets definition is
    # authoritative for the database directory, and a conflicting -T is
    # refused, like classify_metagenome.sh prepending .settings and
    # forbidding -T/-D override (classify_metagenome.sh:60-87)
    (db_dir / ".settings").write_text(
        json.dumps({
            "rank": args.rank,
            "num_targets_files": len(lines),
            "targets": str(db_dir / "targets.txt"),
            "db_dir": str(db_dir),
        }) + "\n"
    )
    print(
        f"targets.txt: {len(lines)} files ({len(excluded)} excluded) -> {db_dir}",
        file=sys.stderr,
    )
    return 0
