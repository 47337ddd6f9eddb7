"""The q4 and s2 query kernels gather the second hash choice only when
the first gives label 0 (csrc/query.cu, kmer_label).  A numpy model of
that early-exit probe, here and not in the package, against the JAX
package's probes, which sum both choices (`cuclark_tpu.probe._probe_q4`
and the s2 branch of `cuclark_tpu.probe.probe`): on built tables at k 15,
21, 31 and 32, on tables holding second-choice entries alone, on an s2
table whose keys' two buckets coincide, on sampled tables (`-s`: zeroed
q4 rows, EMPTY s2 rows) and on tables from `import-clark`, resident and
in bucket-range parts, for stored k-mers, misses, poly-A and poly-T.  And
the premise that makes the skip exact: no stored key of these tables
gets a nonzero label from both choices.  Every comparison is exact."""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu import probe as jprobe
from cuclark_tpu_torch import cli, hashdb
from cuclark_tpu_torch.config import DBConfig
from cuclark_tpu_torch.io import clark_db
from tests.test_torch_layouts import NAMES, _keys, _labels

_M32 = np.uint32

# (name, layout, slots, choices, keys, nb_bits): q4 at 57% of 2^17 x 4
# slots, s2 two slots at 73% and four at 88% (both with second-choice
# entries), and a one-choice s2 table
VARIANTS = {"q4": ("q4", 4, 2, 300_000, 17), "s2_2x2": ("s2", 2, 2, 1500, 10),
            "s2_4x2": ("s2", 4, 2, 900, 8), "s2_4x1": ("s2", 4, 1, 1000, 10)}


def _choice_labels(table, db, keys, start=0, nb_local=None):
    """Per key: the label of its choice-0 row and of its choice-1 row
    (each 0 when its bucket lies outside [start, start + nb_local)), and
    whether choice 1 is probed at all (s2: two choices and a bucket
    other than choice 0's)."""
    nb_local = len(table) if nb_local is None else nb_local
    hi, lo = jhashdb._split64(keys)
    mask = _M32((1 << db.nb_bits) - 1)

    def at(b, words):
        loc = b.astype(np.int64) - start
        ok = (loc >= 0) & (loc < nb_local)
        rows = table[np.where(ok, loc, 0)]
        return np.where(ok, words(rows), 0).astype(np.int32)

    with np.errstate(over="ignore"):
        if db.layout == "q4":
            h1, l2 = jhashdb.feistel_mix(hi, lo, db.seed)

            def q4_words(own, other, choice):
                def words(rows):
                    meta = rows[:, 4:]
                    m = ((rows[:, :4] == other[:, None])
                         & ((meta >> _M32(17))
                            == (own >> _M32(db.nb_bits))[:, None])
                         & (((meta >> _M32(16)) & _M32(1)) == choice))
                    return np.where(m, meta & _M32(0xFFFF), 0).sum(axis=1)
                return words
            return (at(l2 & mask, q4_words(l2, h1, 0)),
                    at(h1 & mask, q4_words(h1, l2, 1)),
                    np.ones(len(keys), bool))
        S = db.slots

        def s2_words(rows):
            m = (rows[:, :S] == lo[:, None]) & (rows[:, S:2 * S] == hi[:, None])
            # int32 sums wrap as the reference's do
            return np.where(m, rows[:, 2 * S:].astype(np.int64), 0).sum(
                axis=1).astype(np.int32)
        b1 = jhashdb.mix1(hi, lo) & mask
        if db.num_choices == 1:
            return at(b1, s2_words), np.zeros(len(keys), np.int32), \
                np.zeros(len(keys), bool)
        b2 = jhashdb.mix2(hi, lo) & mask
        return at(b1, s2_words), at(b2, s2_words), b2 != b1


def early_exit_model(table, db, keys, start=0, nb_local=None):
    """The kernel's probe: choice 0's label, and choice 1's only where
    choice 0 gave 0 -> (labels int32, which keys gathered choice 1)."""
    lab0, lab1, has1 = _choice_labels(table, db, keys, start, nb_local)
    second = has1 & (lab0 == 0)
    return np.where(second, lab1, lab0), second


def jax_probe(table, db, keys, start=None, nb_local=None):
    khi, klo = (jnp.asarray(a) for a in jhashdb._split64(keys))
    bs = None if start is None else jnp.int32(start)
    if db.layout == "q4":
        out = jprobe._probe_q4(jnp.asarray(table), db.nb_bits, db.seed, khi,
                               klo, bs, nb_local)
    else:
        out = jprobe.probe(jnp.asarray(table), db.nb_bits, db.slots,
                           db.num_choices, khi, klo, bucket_start=bs,
                           nb_local=nb_local, layout="s2")
    return np.asarray(out)


def _build(name, k):
    layout, slots, choices, n, nb_bits = VARIANTS[name]
    km, lab = _keys(k, n, k), _labels(k, n)
    db = hashdb.build_table(km, lab, NAMES, DBConfig(
        k=k, layout=layout, slots=slots, num_choices=choices),
        nb_bits=nb_bits)
    return km, db


def _probe_keys(km, k, seed):
    """Stored k-mers, misses, and the poly-A / poly-T k-mer (canonical 0)
    with its complement pattern (all ones, A = 3) -> (keys, the slice of
    the misses)."""
    rng = np.random.default_rng(seed)
    stored = km[rng.choice(len(km), min(len(km), 20_000), replace=False)]
    misses = np.setdiff1d(_keys(seed + 100, 3000, k), km)
    poly = np.array([0, (1 << (2 * k)) - 1], np.uint64)
    return (np.concatenate([stored, misses, poly]),
            slice(len(stored), len(stored) + len(misses)))


def _coinciding():
    """An s2 table of 40 keys whose mix1 and mix2 buckets coincide and
    100 whose do not (as test_s2_coinciding_buckets_count_once)."""
    k, nb_bits = 31, 6
    cand = _keys(21, 40_000, k)
    hi, lo = jhashdb._split64(cand)
    mask = _M32((1 << nb_bits) - 1)
    with np.errstate(over="ignore"):
        same = (jhashdb.mix1(hi, lo) & mask) == (jhashdb.mix2(hi, lo) & mask)
    km = np.sort(np.concatenate([cand[same][:40], cand[~same][:100]]))
    db = hashdb.build_table(km, _labels(21, len(km)), NAMES, DBConfig(
        k=k, layout="s2", slots=4, num_choices=2), nb_bits=nb_bits)
    return km, db


def _sampled(name, tmp_path):
    """The table saved and loaded with -s 4: every fourth row kept, the
    others zero (q4) or EMPTY in every word (s2)."""
    km, db = _build(name, 31)
    db.save(tmp_path / "db.npz")
    return km, hashdb.KmerDB.load(tmp_path / "db.npz", sample_factor=4)


def _imported(name, tmp_path):
    """The k-mers of a built table exported as CLARK files and brought
    back by `import-clark --layout` (the port's CLI)."""
    layout, slots, choices, _, _ = VARIANTS[name]
    km, db = _build(name, 31)
    clark_db.export_clark_db(*db.items(), tmp_path / "ck", 31, 7919)
    (tmp_path / "targets.txt").write_text(
        "".join(f"f{i}.fa {n}\n" for i, n in enumerate(NAMES[1:])))
    flags = ["--layout", layout]
    if layout == "s2":
        flags += ["--slots", str(slots), "--choices", str(choices)]
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["import-clark", "-i", str(tmp_path / "ck"), "-T",
                         str(tmp_path / "targets.txt"), "-D",
                         str(tmp_path / "db"), "-k", "31", *flags]) == 0
    got = hashdb.KmerDB.load(next((tmp_path / "db").glob("*.npz")))
    return km, got


def _case(case, tmp_path):
    """-> (stored k-mers, db, the table probed)."""
    kind, name, k = case
    if kind == "built":
        km, db = _build(name, k)
        return km, db, db.table
    if kind == "second":
        km, db = _build(name, k)
        return km, db, db.second_choice_only()
    if kind == "coinciding":
        km, db = _coinciding()
        return km, db, db.table
    km, db = (_sampled if kind == "sampled" else _imported)(name, tmp_path)
    return km, db, db.table


CASES = ([("built", name, k) for name in VARIANTS for k in (15, 21, 31, 32)]
         + [("second", name, 31) for name in ("q4", "s2_2x2", "s2_4x2")]
         + [("coinciding", "s2", 31)]
         + [(kind, name, 31) for kind in ("sampled", "imported")
            for name in ("q4", "s2_2x2")])
CASE_IDS = [f"{kind}-{name}-k{k}" for kind, name, k in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_early_exit_model_matches_jax(case, tmp_path):
    """The early-exit probe gives the reference's labels, resident and
    on each of 4 bucket-range parts (a key whose choice 0 lies in
    another part probes choice 1 there), and skips choice 1 for the
    windows that choice 0 answers."""
    km, db, table = _case(case, tmp_path)
    keys, misses = _probe_keys(km, db.k, 1)
    got, second = early_exit_model(table, db, keys)
    want = jax_probe(table, db, keys)
    np.testing.assert_array_equal(got, want)
    assert int((want > 0).sum()) > 0 and not want[misses].any()
    if db.layout == "q4" or db.num_choices == 2:
        # choice 1 is gathered for every miss and for no window that
        # choice 0 answered
        lab0, _, _ = _choice_labels(table, db, keys)
        assert not (second & (lab0 > 0)).any()
        assert (second == (lab0 == 0)).all() or db.layout == "s2"
        if case[0] != "second":
            assert int(second.sum()) < len(keys)
    rows = db.nb // 4
    total = 0
    for p in range(4):
        part = table[p * rows:(p + 1) * rows]
        got_p, _ = early_exit_model(part, db, keys, p * rows, rows)
        np.testing.assert_array_equal(
            got_p, jax_probe(part, db, keys, p * rows, rows))
        total = total + got_p
    np.testing.assert_array_equal(total, want)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_no_key_answers_from_both_choices(case, tmp_path):
    """The premise of the skip: every stored key gets its label from one
    choice only, and the other gives 0."""
    _, db, table = _case(case, tmp_path)
    km, lab = dataclasses.replace(db, table=table).items()
    lab0, lab1, has1 = _choice_labels(table, db, km)
    lab1 = np.where(has1, lab1, 0)
    assert not ((lab0 != 0) & (lab1 != 0)).any()
    np.testing.assert_array_equal(lab0 + lab1, lab.astype(np.int32))
    if case[0] == "second":
        assert (lab0 == 0).all() and (lab1 > 0).all()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_first_choice_slots(name):
    """KmerDB.first_choice_slots marks every stored key, and as first
    choice exactly the keys that their choice-0 row answers; the table
    second_choice_only leaves answers no key from choice 0."""
    km, db = _build(name, 31)
    stored, first = db.first_choice_slots()
    lab0, _, _ = _choice_labels(db.table, db, km)
    assert int(stored.sum()) == len(km)
    assert int(first.sum()) == int((lab0 > 0).sum())
    assert 0 < int(first.sum()) <= len(km)
    lab0, lab1, has1 = _choice_labels(db.second_choice_only(), db, km)
    assert not lab0.any()
    assert int((np.where(has1, lab1, 0) > 0).sum()) == len(km) - int(
        first.sum())
