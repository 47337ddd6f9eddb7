"""The plain reference against a brute force in Python strings and a
dict, on tiny genomes; and its control, which the check must fail."""

import numpy as np
import pytest
import torch
from conftest import tiny

import generator
from reference import classify as reference

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CODE = {"A": 3, "C": 2, "G": 1, "T": 0}


def canon(s: str) -> int:
    rc = "".join(COMP[c] for c in reversed(s))
    val = lambda t: sum(CODE[c] << (2 * (len(t) - 1 - i))  # noqa: E731
                        for i, c in enumerate(t))
    return min(val(s), val(rc))


def brute_db(genomes, n_db: int, k: int, gap: int) -> dict:
    """{canonical k-mer: label} under the CLARK rule, from base strings."""
    seen = {}
    for row in range(n_db):
        g = genomes[row]
        if gap == 1:
            kms = {canon(g[i:i + k]) for i in range(len(g) - k + 1)}
        else:
            kms = {canon(g[b * k:(b + 1) * k])
                   for b in range(0, len(g) // k, gap)}
        for km in kms:
            seen.setdefault(km, set()).add(row + 1)
    return {km: next(iter(s)) for km, s in seen.items() if len(s) == 1}


def brute_row(read: str, k: int, db: dict) -> list:
    counts = {}
    total = 0
    for i in range(len(read) - k + 1):
        w = read[i:i + k]
        if any(c not in CODE for c in w):
            continue
        lab = db.get(canon(w), 0)
        if lab:
            total += 1
            counts[lab] = counts.get(lab, 0) + 1
    ranked = sorted(counts.items(), key=lambda t: (-t[1], t[0]))
    best = ranked[0] if ranked else (0, 0)
    second = ranked[1] if len(ranked) > 1 else (0, 0)
    return [total, best[0], best[1], second[0], second[1]]


@pytest.mark.parametrize("workload", ["full_se150", "light_pe2x150",
                                      "full_ont_long"])
def test_reference_matches_brute_force(workload):
    cell = tiny(workload)
    cfg = dict(cell.config, genome_bp=3000, genomes=4 if cell.config["gap"]
               == 1 else 8)
    tr = dict(cell.traffic)
    if tr["kind"] == "long":
        tr.update(reads=40, length={"mean": 500, "sd": 400, "min": 60,
                                    "max": 1500})
    else:
        tr.update(batch_reads=48, pool_batches=2)
    k, gap = cfg["k"], cfg["gap"]
    u = generator.make_universe(cfg, 3, "cpu")
    keys, labels = generator.make_db(u, cfg)
    bases = np.frombuffer(generator.BASES, np.uint8)
    strings = [bases[g].tobytes().decode() for g in u.genomes.numpy()]
    db = brute_db(strings, u.n_db, k, gap)
    assert sorted(db) == keys.tolist()
    assert [db[x] for x in keys.tolist()] == labels.tolist()
    r = generator.make_reads(u, cfg, tr, 3)
    rows = np.arange(r.n_reads)
    got = reference.classify(reference.read_codes(r.bufs, r.starts, r.ends,
                                                  0, r.n_reads), k,
                             reference.KeySet(keys, labels))
    for i in rows:
        read = r.bufs[0][r.starts[0][i]:r.ends[0][i]].tobytes().decode()
        if r.paired:
            read += "N" + r.bufs[1][r.starts[1][i]:r.ends[1][i]].tobytes(
            ).decode()
        assert got[i].tolist() == brute_row(read, k, db), i
    assert int(got[:, 0].sum()) > 0


def test_top_two_ties_keep_the_smaller_label():
    lab = torch.tensor([[3, 5, 5, 3, 0, 9], [0, 0, 0, 0, 0, 0],
                        [7, 7, 7, 2, 0, 0]], dtype=torch.int32)
    assert reference.top_two(lab).tolist() == [[5, 3, 2, 5, 2],
                                               [0, 0, 0, 0, 0],
                                               [4, 7, 3, 2, 1]]


@pytest.mark.parametrize("workload", ["full_se150", "light_pe2x150",
                                      "full_ont_long"])
def test_control_fails_the_check(workload):
    """The reference with keys compared on a fingerprint, in the
    program's place, is not correct at a size a test holds."""
    import control

    cell = tiny(workload)
    out = control.control_readings(cell, 2**32 + 9, torch.device("cpu"))
    assert not out["correct"], out
    assert out["mismatched_rows"] > 0
