"""Parity of the port's `score_labels` (the CPU wrapper, i.e. the score
kernel's plain version) with the JAX package's `score.score_labels`,
with forced ties and all-miss rows, up to rows longer than the score
kernel's shared memory holds, and a classify of reads over 32,768
bases.  Every comparison is exact."""

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
