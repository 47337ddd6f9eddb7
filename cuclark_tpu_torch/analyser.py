"""k-mer multiplicity spectrum analysis (bump-interval detection).

Live equivalent of the reference's vestigial analyser
(src/analyser.cc:46-171): CLARK's heuristic for picking the "solid"
k-mer multiplicity band of a spectrum.  A sequencing-error spectrum has
a spike at multiplicity 1-2 (errors), a valley, then a coverage bump;
the detector finds the valley minimum and the bump maximum over a
plateau-compacted histogram and reports the interval
[max - (max-min)/div, max + (max-min)/div].

In the reference this class is compiled but never instantiated (CLARK's
removed default mode used it to pick `-t`); here it is wired into the
CLI as `cuclark-tpu-torch analyze`, which prints the interval and the
suggested `-t` (min multiplicity) for `build-db` on spectrum inputs.

Counterpart of `cuclark_tpu/analyser.py`, carried over unchanged.
"""

from __future__ import annotations

import numpy as np


def spectrum_histogram(path) -> np.ndarray:
    """Histogram of k-mer multiplicities from a '<kmer> <count>' file.

    Returns int64 [max_count + 1]: hist[c] = number of spectrum lines
    with count c (the reference constructor's m_frequency,
    src/analyser.cc:141-171).
    """
    counts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"bad spectrum line in {path}: {line!r}")
            counts.append(int(parts[1]))
    if not counts:
        return np.zeros(1, dtype=np.int64)
    c = np.asarray(counts, dtype=np.int64)
    # the histogram allocates max(count)+1 bins: one corrupt count
    # (wrong column, concatenated digits) must raise, not MemoryError
    hi, lo = int(c.max()), int(c.min())
    if hi > 100_000_000 or lo < 0:
        bad = hi if hi > 100_000_000 else lo
        raise ValueError(
            f"implausible spectrum count {bad} in {path}: corrupt line?")
    return np.bincount(c, minlength=int(c.max()) + 1)


def compact_plateaus(freq: np.ndarray):
    """Drop histogram entries equal to their predecessor.

    The reference's freqTable construction keeps point (i, freq[i]) only
    when the value changed from i-1 (src/analyser.cc:53-80; its
    `unchanged` counter never exceeds the threshold that would re-admit
    a plateau point, so the net effect is plain change-compaction).
    Returns (indices int64 [M], values int64 [M]).
    """
    freq = np.asarray(freq, dtype=np.int64)
    if freq.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    keep = np.ones(freq.size, dtype=bool)
    keep[1:] = freq[1:] != freq[:-1]
    idx = np.nonzero(keep)[0]
    return idx, freq[idx]


def bump_interval(freq: np.ndarray, div: int = 2):
    """Find the coverage-bump multiplicity interval of a spectrum.

    freq: histogram as from spectrum_histogram.
    Returns (found, lo, hi).  When no bump is detected, (lo, hi) fall
    back to (first multiplicity with nonzero frequency among compacted
    points, last compacted multiplicity) — the reference's L<=4 /
    not-maxDone behavior (src/analyser.cc:81-137).
    """
    pts_i, pts_v = compact_plateaus(freq)
    if pts_i.size == 0:
        return False, 0, 0
    pos = np.nonzero(pts_v > 0)[0]
    index_s = int(pts_i[pos[0]]) if pos.size else 0
    index_e = int(pts_i[-1])
    n = pts_i.size
    if n <= 4:
        return False, index_s, index_e

    # Sequential valley->bump scan over the (tiny) compacted table:
    # running min until the scan has moved max(2, min_idx/2) columns past
    # it, then running max until it has moved (max-min) past the max.
    min_val, min_idx = 999999999, 1
    max_val, max_idx = 0, 1
    min_done = max_done = False
    for cpt in range(1, n):
        if max_done:
            break
        i, v = int(pts_i[cpt]), int(pts_v[cpt])
        if not min_done and min_val >= v:
            min_val, min_idx = v, i
        step = int(0.5 * min_idx) if 0.5 * min_idx >= 2 else 2
        min_done = (i - min_idx) >= step
        if not max_done and min_done and max_val < v:
            max_val, max_idx = v, i
        max_done = min_done and (i - max_idx >= max_idx - min_idx)
    if max_done:
        half = (max_idx - min_idx) // div
        return True, max_idx - half, max_idx + half
    return False, index_s, index_e
