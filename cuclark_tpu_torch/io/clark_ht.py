"""CLARK-family `.ht` target-specific-set interop.

The reference's --tsk mode dumps per-target text files that a
CLARK/CuCLARK install can consume or rebuild a database from
(EHashtable::SaveMultiple writes, ::Load reads,
src/HashTableStorage_hh.hh:295-405, 697-737; filenames
`<label>_k<k>[_light].ht` per CuCLARK::createTargetFilesNames,
src/CuCLARK_hh.hh:342-377).  Format per file:

  #Target specific k-mers labeled <label> and appearing strictly more than <minCount> times.
  #IKMER ICOUNT <k>-MER \\n#\\n
  <kmer-as-u64>\\t<count>\\t<KMERSTRING>\\n ...

KMERSTRING is the reference IndexTovector spelling
(src/kmersConversion.cc:88-131): most-significant 2-bit digit first
with digit->base mapping 3=A 2=C 1=G 0=T — exactly this package's
codec (codec.py), so decoding is a table lookup on the 2-bit digits.

Counterpart of `cuclark_tpu/io/clark_ht.py`, carried over unchanged.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# digit value -> base char, per IndexTovector (3->A, 2->C, 1->G, 0->T)
_DIGIT_BASE = np.frombuffer(b"TGCA", np.uint8)


def kmer_strings(kmers: np.ndarray, k: int) -> np.ndarray:
    """uint64 [N] -> |S{k}| byte-string array of base characters."""
    kmers = np.asarray(kmers, np.uint64)
    mat = np.empty((len(kmers), k), np.uint8)
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        mat[:, j] = _DIGIT_BASE[
            ((kmers >> shift) & np.uint64(3)).astype(np.uint8)]
    return mat.view(f"S{k}").ravel()


def ht_filename(label: str, k: int, light: bool = False) -> str:
    # labels may carry path separators (NCBI names contain slashes);
    # the export layout is FLAT — a separator would either crash the
    # open() or hide the file from import_ht_dir's glob
    safe = label.replace("/", "_").replace("\\", "_")
    return f"{safe}_k{k}{'_light' if light else ''}.ht"


def export_ht_dir(kmers: np.ndarray, labels: np.ndarray,
                  target_names: list[str], out_dir, k: int,
                  counts: np.ndarray | None = None, min_count: int = 0,
                  light: bool = False) -> int:
    """Write one `.ht` file per target holding its specific k-mers.

    counts None writes 1 per k-mer (occurrence totals are not retained
    in the final table artifact).  Returns number of files written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kmers = np.asarray(kmers, np.uint64)
    labels = np.asarray(labels, np.uint32)
    if labels.size and (labels.min() < 1
                        or labels.max() >= len(target_names)):
        # silently dropping out-of-range labels would re-import as a
        # smaller database with no diagnostic
        raise ValueError(
            f"labels must be in [1, {len(target_names) - 1}]: got "
            f"range [{labels.min()}, {labels.max()}]")
    if counts is None:
        counts = np.ones(len(kmers), np.uint32)
    order = np.argsort(labels, kind="stable")
    kmers, labels, counts = kmers[order], labels[order], counts[order]
    bounds = np.searchsorted(labels, np.arange(1, len(target_names) + 1))
    written = 0
    for t in range(1, len(target_names)):
        lo, hi = bounds[t - 1], bounds[t]
        name = target_names[t]
        p = out_dir / ht_filename(name, k, light)
        with open(p, "wb") as f:
            f.write((f"#Target specific k-mers labeled {name} and "
                     f"appearing strictly more than {min_count} times.\n"
                     f"#IKMER ICOUNT {k}-MER \n#\n").encode())
            if hi > lo:
                km, ct = kmers[lo:hi], counts[lo:hi]
                ks = kmer_strings(km, k)
                dec = np.char.mod("%d", km).astype("S")
                cnt = np.char.mod("%d", ct).astype("S")
                tab = np.full(hi - lo, b"\t", "S1")
                nl = np.full(hi - lo, b"\n", "S1")
                lines = np.char.add(np.char.add(np.char.add(np.char.add(
                    np.char.add(dec, tab), cnt), tab), ks), nl)
                f.write(b"".join(lines.tolist()))
        written += 1
    return written


def import_ht_file(path, min_count: int = 0):
    """Read one `.ht` file -> (kmers u64, counts u32, k, label).

    The label comes from the first header line when present, else the
    filename stem."""
    path = Path(path)
    label = None
    k = None
    kmers, counts = [], []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b"#"):
                txt = line.decode("ascii", "replace")
                if "labeled" in txt:
                    # '#Target specific k-mers labeled X and appearing...'
                    label = txt.split("labeled", 1)[1].split(" and")[0].strip()
                if "-MER" in txt:
                    tok = txt.lstrip("#").split("-MER")[0].split()[-1]
                    try:
                        k = int(tok)
                    except ValueError:
                        pass
                continue
            parts = line.split(b"\t")
            if len(parts) < 2:
                continue
            kmers.append(int(parts[0]))
            counts.append(int(parts[1]))
    if label is None:
        stem = path.name
        for suff in (".ht",):
            if stem.endswith(suff):
                stem = stem[: -len(suff)]
        label = stem.split("_k")[0]
    km = np.asarray(kmers, np.uint64)
    ct = np.asarray(counts, np.uint32)
    if min_count > 0:
        keep = ct > min_count
        km, ct = km[keep], ct[keep]
    return km, ct, k, label


def import_ht_dir(dir_path, min_count: int = 0):
    """Read every `.ht` in a directory -> (kmers, labels, target_names).

    Labels are 1-based in file-name order (deterministic); k is taken
    from the headers and must agree across files."""
    files = sorted(Path(dir_path).glob("*.ht"))
    if not files:
        raise FileNotFoundError(f"no .ht files in {dir_path}")
    names = ["NA"]
    all_km, all_lb = [], []
    k_seen = None
    for p in files:
        km, ct, k, label = import_ht_file(p, min_count)
        if k is not None:
            if k_seen is not None and k != k_seen:
                raise ValueError(
                    f"mixed k in .ht files: {k_seen} vs {k} ({p})")
            k_seen = k
        names.append(label)
        all_km.append(km)
        all_lb.append(np.full(len(km), len(names) - 1, np.uint32))
    return (np.concatenate(all_km), np.concatenate(all_lb), names,
            k_seen)
