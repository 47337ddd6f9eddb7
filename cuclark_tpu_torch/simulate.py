"""Synthetic-read simulation + classification-accuracy evaluation.

The reference's sanctioned QA is accuracy-oriented: its data bundle
ships "HiSeq_accuracy.fa"/"MiSeq_accuracy.fa" and wgsim/art-simulated
reads with the truth encoded in the read names
(the reference's data/README.md:1-21), scored for precision/recall of
the assignments.  Everything else in this repo verifies *parity*
(oracle + byte-identical CSVs); this module is the independent check
that the classifier is actually *right* on reads with sequencing
errors:

 - simulate_reads: wgsim-style fixed-length reads sampled from target
   genomes with substitution + indel errors, truth label embedded in
   the read name ("sim<i>|<label>");
 - evaluate_assignments: per-target precision/recall/unclassified from
   a result CSV against the name-embedded truth.

Wired as `cuclark-tpu-torch simulate-reads` / `cuclark-tpu-torch
evaluate`.  Counterpart of `cuclark_tpu/simulate.py`, carried over
unchanged: the generator's calls keep their order, so both packages
write the same FASTQ for the same seed.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)

TRUTH_SEP = "|"


def _code_of_seq(seq: str) -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate("ACGT"):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    codes = lut[np.frombuffer(seq.encode(), np.uint8)]
    return codes[codes != 255]  # drop Ns/newlines for sampling purposes


def mutate_codes(rows: np.ndarray, read_len: int, rng,
                 sub_rate: float, ins_rate: float, del_rate: float):
    """Apply wgsim-style errors to [n, read_len + pad] 2-bit code rows.

    Substitutions replace a base with one of the OTHER three uniformly
    (wgsim's model).  Each indel event deletes one base (the row shifts
    left, pulling genuine downstream genome bases from the pad) or
    inserts one random base (shifting right).  Returns [n, read_len].
    """
    n, w = rows.shape
    pad = w - read_len
    out = rows.copy()
    if sub_rate > 0:
        m = rng.random(out.shape) < sub_rate
        # +1..3 mod 4 is always a different base
        out = np.where(m, (out + rng.integers(1, 4, out.shape)) % 4, out)
    n_events = rng.binomial(read_len, ins_rate + del_rate, size=n) \
        if (ins_rate or del_rate) else np.zeros(n, np.int64)
    p_del = del_rate / (ins_rate + del_rate) if (ins_rate or del_rate) \
        else 0.0
    for i in np.nonzero(n_events)[0]:
        row = out[i]
        for _ in range(min(int(n_events[i]), pad)):
            pos = int(rng.integers(0, read_len))
            if rng.random() < p_del:
                row[pos:-1] = row[pos + 1:]
            else:
                row[pos + 1:] = row[pos:-1]
                row[pos] = rng.integers(0, 4)
        out[i] = row
    return out[:, :read_len].astype(np.uint8)


def simulate_reads(genomes: dict[str, str], n_reads: int, read_len: int,
                   sub_rate: float = 0.01, ins_rate: float = 0.001,
                   del_rate: float = 0.001, seed: int = 0,
                   paired: bool = False, insert_len: int | None = None):
    """Sample error-bearing reads from labeled genomes.

    genomes: {label: sequence | list of sequences}.  Returns
    (names, seqs) — or (names, seqs1, seqs2) when paired — where names
    embed the truth as "sim<i>|<label>".  Reads are fixed-length (wgsim
    convention); the sampling window carries a pad so deletions pull
    real genome bases.  Targets are sampled uniformly; within a target,
    records are sampled by usable length (windows never span record
    boundaries — no chimeric junction reads).

    Each read's template strand is a coin flip (wgsim samples both
    strands), so the harness genuinely exercises reverse-complement
    canonicalization — forward-only sampling would let an RC-side bug
    classify perfectly.  Paired mates share ONE insert in FR
    orientation: mate 1 reads the template 5' end, mate 2 the REVERSE
    COMPLEMENT from the insert's other end (Illumina convention).
    """
    rng = np.random.default_rng(seed)
    labels = sorted(genomes)
    span = (insert_len or 2 * read_len + 20) if paired else read_len
    pad = 12
    if paired and span < read_len + pad:
        raise ValueError(f"insert_len {span} shorter than read_len + "
                         f"indel pad ({read_len + pad})")
    segs: list[np.ndarray] = []       # per-record code arrays
    seg_of_target: list[list[int]] = []
    for t in labels:
        v = genomes[t]
        mine = []
        for s in ([v] if isinstance(v, str) else list(v)):
            a = _code_of_seq(s)
            if len(a) >= span + pad:
                mine.append(len(segs))
                segs.append(a)
        if not mine:
            raise ValueError(f"genome {t!r} has no record of at least "
                             f"the read span {span + pad}")
        seg_of_target.append(mine)
    which = rng.integers(0, len(labels), n_reads)
    names = [f"sim{i}{TRUTH_SEP}{labels[which[i]]}" for i in range(n_reads)]
    # per-read record choice, length-weighted within the chosen target
    seg_pick = np.empty(n_reads, np.int64)
    for gi, mine in enumerate(seg_of_target):
        idx = np.nonzero(which == gi)[0]
        if not len(idx):
            continue
        w = np.array([len(segs[s]) - span - pad + 1 for s in mine], float)
        seg_pick[idx] = rng.choice(mine, size=len(idx), p=w / w.sum())

    # ONE genome window per read (paired mates derive from it)
    win = span + pad
    windows = np.empty((n_reads, win), np.uint8)
    for si, a in enumerate(segs):
        idx = np.nonzero(seg_pick == si)[0]
        if not len(idx):
            continue
        starts = rng.integers(0, len(a) - win + 1, len(idx))
        windows[idx] = a[starts[:, None] + np.arange(win)[None, :]]
    # template strand coin flip; complement is 3 - code (A<->T, C<->G)
    strand = rng.integers(0, 2, n_reads).astype(bool)
    tpl = np.where(strand[:, None], (3 - windows)[:, ::-1], windows)

    def to_str(codes):
        return [_BASES[c].tobytes().decode() for c in codes]

    m1 = mutate_codes(np.ascontiguousarray(tpl[:, :read_len + pad]),
                      read_len, rng, sub_rate, ins_rate, del_rate)
    if not paired:
        return names, to_str(m1)
    # mate 2: reverse complement of the SAME insert, read from the
    # other end (FR orientation)
    tpl2 = np.ascontiguousarray((3 - tpl)[:, ::-1][:, :read_len + pad])
    m2 = mutate_codes(tpl2, read_len, rng, sub_rate, ins_rate, del_rate)
    return names, to_str(m1), to_str(m2)


def write_fastq(path, names, seqs) -> None:
    with open(path, "wb") as f:
        out = []
        for n, s in zip(names, seqs):
            out.append(f"@{n}\n{s}\n+\n{'I' * len(s)}\n".encode())
            if len(out) >= 65536:
                f.write(b"".join(out))
                out = []
        f.write(b"".join(out))


def truth_of_name(name: str) -> str:
    """Truth label embedded by simulate_reads (text after the last
    TRUTH_SEP; the reference accuracy sets encode truth in names the
    same way, data/README.md:16-18)."""
    return name.rsplit(TRUTH_SEP, 1)[-1]


def evaluate_assignments(csv_path) -> dict:
    """Precision / recall / unclassified per target from a result CSV
    whose Object_IDs embed the truth label.

    Conventions (CLARK paper-style):
      recall_T    = correct / all reads whose truth is T (unclassified
                    reads count as misses);
      precision_T = correct / all reads ASSIGNED to T;
      unclassified = NA fraction over all reads.

    Returns {"per_target": {T: {...}}, "overall": {...}}.
    """
    import csv as _csv

    per: dict[str, dict[str, int]] = {}
    total = correct = classified = 0
    with open(csv_path) as f:
        reader = _csv.reader(f)
        header = next(reader)
        try:
            acol = header.index("1st_assignment")
        except ValueError as e:
            raise ValueError("not a cuclark result CSV") from e
        for row in reader:
            if not row:
                continue
            truth = truth_of_name(row[0])
            assign = row[acol]
            pt = per.setdefault(truth, {"n": 0, "tp": 0, "na": 0})
            pt["n"] += 1
            total += 1
            if assign == "NA":
                pt["na"] += 1
                continue
            classified += 1
            pa = per.setdefault(assign, {"n": 0, "tp": 0, "na": 0})
            pa["assigned"] = pa.get("assigned", 0) + 1
            if assign == truth:
                pt["tp"] += 1
                correct += 1
    per_target = {}
    for t, d in sorted(per.items()):
        if d["n"] == 0 and "assigned" not in d:
            continue
        assigned = d.get("assigned", 0)
        per_target[t] = {
            "reads": d["n"],
            "assigned": assigned,
            "recall": d["tp"] / d["n"] if d["n"] else 0.0,
            "precision": d["tp"] / assigned if assigned else 0.0,
            "unclassified": d["na"] / d["n"] if d["n"] else 0.0,
        }
    overall = {
        "reads": total,
        "recall": correct / total if total else 0.0,
        "precision": correct / classified if classified else 0.0,
        "unclassified": (total - classified) / total if total else 0.0,
    }
    return {"per_target": per_target, "overall": overall}
