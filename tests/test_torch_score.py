"""Parity of the port's `score_labels` (the CPU wrapper, i.e. the score
kernel's plain version) with the JAX package's `score.score_labels`,
with forced ties and all-miss rows, up to rows longer than the score
kernel's shared memory holds, and a classify of reads over 32,768
bases; and of numpy models of the score kernel's two paths
(csrc/score.cu: the warp's per-lane top two run keys, the two-range
label histogram) with the JAX package's `score.score_labels`.  Every
comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import score as jscore
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu.db_build.builder import build_db as jbuild_db
from cuclark_tpu_torch import pipeline, score
from cuclark_tpu_torch.config import DBConfig
from cuclark_tpu_torch.db_build.builder import build_db


def _labels(seed, R, P, n_labels):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n_labels + 1, size=(R, P)).astype(np.int32)
    lab[rng.random((R, P)) < 0.4] = 0
    lab[0] = 0                                   # an all-miss row
    if R > 2:
        half = P // 2
        lab[1, :half], lab[1, half:2 * half] = 7, 3   # exact tie: 3 wins
        lab[1, 2 * half:] = 0
        lab[2] = 65535                           # the largest label
    return lab


@pytest.mark.parametrize("R,P,n_labels", [
    (64, 122, 4),        # Illumina 150 bp in the 152 bin, k=31
    (32, 1, 3),          # one window per read
    (16, 97, 60000),     # sparse labels, mostly single hits
    (8, 1000, 12),       # non-power-of-two, wider row
    (4, 16354, 40),      # the 16384 bin at k=31
    (3, 32769, 5),       # one window past the shared-memory sort
    (2, 40000, 30),      # a 40 kb read: the device-memory sort
])
def test_score_labels_matches_jax(R, P, n_labels):
    lab = _labels(R * P, R, P, n_labels)
    want = np.asarray(jscore.score_labels(jnp.asarray(lab)))
    got = score.score_labels(torch.from_numpy(lab))
    assert got.dtype == torch.int32 and got.shape == (R, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0], [0, 0, 0, 0, 0])


def test_score_tie_breaks_to_smallest_label():
    lab = np.array([[5, 5, 2, 2, 9, 0, 0, 9],
                    [4, 4, 4, 1, 1, 1, 1, 0]], np.int32)
    got = score.score_labels(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(got, [[6, 2, 2, 5, 2], [7, 1, 4, 4, 3]])
    np.testing.assert_array_equal(
        got, np.asarray(jscore.score_labels(jnp.asarray(lab))))


def test_gamma_confidence_is_carried_over():
    args = (np.array([10, 0, 3]), np.array([8, 0, 2]), np.array([2, 0, 0]),
            np.array([150, 30, 26]), 27, False)
    for a, b in zip(score.gamma_confidence(*args),
                    jscore.gamma_confidence(*args)):
        np.testing.assert_array_equal(a, b)


def test_classifier_long_reads_match_jax(tmp_path):
    """Reads of 33,000 to 50,000 bases (score rows of more than 32,768
    windows), with substitutions and Ns, beside short ones: the rows of
    the JAX package's Classifier."""
    rng = random.Random(17)
    genomes, file_labels = [], []
    for t in (1, 2):
        g = "".join(rng.choice("ACGT") for _ in range(60_000))
        genomes.append(g)
        (tmp_path / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        file_labels.append((str(tmp_path / f"g{t}.fa"), f"T{t}"))
    db = build_db(file_labels, DBConfig(k=31))
    jdb = jbuild_db(file_labels, JDBConfig(k=31))
    assert db.checksum() == jdb.checksum()
    reads = []
    for i, n in enumerate((33_000, 41_234, 50_000, 36_500, 150)):
        g = genomes[i % 2]
        pos = rng.randrange(0, len(g) - n)
        seq = list(g[pos:pos + n])
        for _ in range(n // 100):
            seq[rng.randrange(n)] = rng.choice("ACGTN")
        reads.append((f"long{i}", "".join(seq)))
    fq = tmp_path / "long.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in reads))
    got = list(pipeline.Classifier(db, device="cpu").classify_file(str(fq)))
    want = list(jpipeline.Classifier(jdb).classify_file(str(fq)))
    assert got == want
    assert [r["index_best"] for r in got] == [1, 2, 1, 2, 1]


# ---- numpy models of the score kernel's two paths (csrc/score.cu) ----

BINS = 32768           # kBins: histogram counters per label range
HIST_THREADS = 1024    # kHistThreads: thread t scans counters t + 1024 j


def _key(count, label):
    """run_key: count << 32 | ~label, as uint64."""
    return (np.asarray(count, np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - np.asarray(label, np.uint64))


def _key_label(key):
    return np.where(key > 0, np.uint64(0xFFFFFFFF) - (key & np.uint64(
        0xFFFFFFFF)), 0).astype(np.int64)


def _reduce(keys, total):
    """keys [n, threads]: each thread keeps its top two (keep_top2), the
    best is the maximum over threads, the second the maximum of each
    thread's best other than the best label (best_other)."""
    top = np.sort(keys, axis=0)
    b1 = top[-1]
    b2 = top[-2] if len(top) > 1 else np.zeros_like(b1)
    best = b1.max()
    other = np.where((b1 > 0) & (_key_label(b1) == _key_label(best)), b2, b1)
    second = other.max()
    return [total, int(_key_label(best)), int(best >> np.uint64(32)),
            int(_key_label(second)), int(second >> np.uint64(32))]


ROUNDS = 8             # kRounds: labels counted before the sort


def _warp_model(row):
    """score_warp_kernel: the row padded with 0 to Pp = 32 E, lane l
    holding positions e 32 + l.  Up to ROUNDS rounds count the first
    positive label left (the lowest lane's first register) and zero it;
    what is left is sorted, lane l then holding sorted positions l E ..
    l E + E - 1 and keeping the keys of the run ends of positive labels
    among them; the counted labels' top two merge in."""
    P = len(row)
    Pp = max(32, 1 << (P - 1).bit_length())
    A = np.concatenate([row, np.zeros(Pp - P, row.dtype)]).reshape(-1, 32)
    counted = []
    for _ in range(ROUNDS):
        pos = A > 0
        lanes = np.flatnonzero(pos.any(axis=0))
        if not len(lanes):
            break
        cand = A[np.flatnonzero(pos[:, lanes[0]])[0], lanes[0]]
        counted.append(_key((A == cand).sum(), cand))
        A = np.where(A == cand, 0, A)
    s = np.sort(A.ravel())
    i = np.arange(Pp)
    change = s[1:] != s[:-1]
    first = np.concatenate([[True], change])
    last = np.concatenate([change, [True]])
    start = np.maximum.accumulate(np.where(first, i, -1))
    key = np.where(last & (s > 0), _key(i - start + 1, np.maximum(s, 0)), 0)
    rounds = np.array(counted + [0, 0], np.uint64)[:, None]
    # the counted keys are one more "lane" whose top two are r1, r2
    lanes = np.concatenate([key.reshape(32, Pp // 32).T, np.zeros(
        (max(0, len(rounds) - Pp // 32), 32), np.uint64)])
    keys = np.concatenate([lanes, np.zeros((len(lanes), 1), np.uint64)],
                          axis=1)
    keys[:len(rounds), -1] = rounds[:, 0]
    return _reduce(keys, int((row > 0).sum()))


def _hist_model(row):
    """score_hist_kernel: counters for labels [0, BINS), then [BINS,
    2 BINS) only when the row holds such a label; thread t keeps the top
    two keys of counters t, t + 1024, ... across both ranges."""
    keys = []
    for lo in (0, BINS):
        if lo and not (row >= BINS).any():
            break
        mine = row[(row > 0) & (row >= lo) & (row - lo < BINS)] - lo
        n = np.bincount(mine, minlength=BINS)
        keys.append(np.where(n > 0, _key(n, lo + np.arange(BINS)), 0)
                    .reshape(BINS // HIST_THREADS, HIST_THREADS))
    return _reduce(np.concatenate(keys), int((row > 0).sum()))


def _range_labels(seed, P):
    """Rows that test the label ranges: all miss; random labels over
    1..65535; a tie between a label below 32,768 and one above (the lower
    wins); the best above 32,768 and the second below; only labels above
    with a tie there; a long read that mostly hits one target; 65,535
    the best beside 32,767 and 32,768."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((7, P), np.int32)
    lab[1] = rng.integers(1, 65536, size=P)
    lab[1, rng.random(P) < 0.3] = 0
    q = P // 4
    lab[2, :q], lab[2, q:2 * q] = 40000, 1234
    lab[3, :2 * q], lab[3, 2 * q:3 * q] = 50000, 77
    lab[4, :q], lab[4, q:2 * q], lab[4, 2 * q:] = 65535, 32768, 40001
    lab[5] = np.where(rng.random(P) < 0.8, 4321, rng.integers(0, 9, size=P))
    lab[6, :2 * q], lab[6, 2 * q:3 * q], lab[6, 3 * q:] = 65535, 32767, 32768
    return lab


@pytest.mark.parametrize("P", [1025, 16354, 40000])
def test_score_histogram_model_matches_jax(P):
    """The histogram path's two-range top two against JAX, and the plain
    version on the same rows."""
    lab = _range_labels(P, P)
    want = np.asarray(jscore.score_labels(jnp.asarray(lab)))
    got = np.array([_hist_model(row) for row in lab])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        score.score_labels(torch.from_numpy(lab)).numpy(), want)
    np.testing.assert_array_equal(want[0], [0, 0, 0, 0, 0])
    assert want[2, 1] == 1234 and want[3, 1] == 50000 and want[3, 3] == 77


@pytest.mark.parametrize("P", [1, 2, 31, 32, 33, 98, 122, 128, 129, 290,
                               994, 1024])
def test_score_warp_model_matches_jax(P):
    """The warp path's per-lane top two run keys against JAX, on random
    labels with forced ties and all-miss rows, and on the label-range
    rows."""
    lab = np.concatenate([_labels(P, 16, P, 6), _range_labels(P, P)])
    want = np.asarray(jscore.score_labels(jnp.asarray(lab)))
    got = np.array([_warp_model(row) for row in lab])
    np.testing.assert_array_equal(got, want)
