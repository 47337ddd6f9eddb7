"""CLARK-format CSV result writer.

Counterpart of `cuclark_tpu/io/csv_out.py`, carried over unchanged.

Format parity with printExtendedResultsSynced
(src/CuCLARK_hh.hh:1950-2139):

  header: Object_ID[,<target names...>],Length,Gamma,1st_assignment,
          score1,2nd_assignment,score2,confidence
  row:    %s,%u,%g,%s,%u,%s,%u,%g   (name truncated to 39 chars)

Extended mode inserts one dense hit-count column per target (names from
index 1; reconstructed zeros included), matching src/CuCLARK_hh.hh:
2014-2031.  Python's %-formatting of %g/%u matches C's for these value
ranges, giving byte-identical rows.
"""

from __future__ import annotations

from cuclark_tpu_torch.config import OBJECTNAMEMAX

HEADER_TAIL = ["Length", "Gamma", "1st_assignment", "score1",
               "2nd_assignment", "score2", "confidence"]


def header_line(target_names, extended: bool = False) -> str:
    """The one header-string builder every writer shares."""
    cols = ["Object_ID"]
    if extended:
        cols += target_names[1:]
    cols += HEADER_TAIL
    return ",".join(cols) + "\n"


def write_results(out_path, rows, target_names, extended: bool = False):
    """rows: iterable of dicts from Classifier.classify_records."""
    with open(out_path, "w") as f:
        f.write(header_line(target_names, extended))
        for row in rows:
            f.write(format_row(row, target_names, extended))


def format_row(row, target_names, extended: bool = False) -> str:
    name = row["name"][: OBJECTNAMEMAX - 1]
    parts = [name]
    if extended:
        counts = row.get("target_counts", {})
        for t in range(1, len(target_names)):
            parts.append("%u" % counts.get(t, 0))
    parts.append("%u" % row["length"])
    parts.append("%g" % row["gamma"])
    parts.append(target_names[row["index_best"]])
    parts.append("%u" % row["best"])
    parts.append(target_names[row["index_second"]])
    parts.append("%u" % row["second"])
    parts.append("%g" % row["confidence"])
    return ",".join(parts) + "\n"
