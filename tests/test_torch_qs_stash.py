"""The premise of the qs query's stash skip (`csrc/query.cu`, `qs_label`):
a key lies in a qs table's stash only when its main row is full, in
every table the builds make (the port's native and numpy placements and
the JAX package's), and a table loaded with a sample factor zeroes whole
rows, so a main row with one to three occupied slots rules the stash
out.  The rule, emulated in numpy, gives the JAX reference probe's
labels on built and sampled tables."""

import json

import numpy as np
import pytest

from cuclark_tpu import codec as jcodec
from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu_torch import hashdb, native
from cuclark_tpu_torch.config import DBConfig

K = 31
# (keys, nb_bits): a light stash, and main rows two thirds full
SIZES = [(300_000, 17), (600_000, 17)]


def _keys(n):
    rng = np.random.default_rng(n)
    km = rng.integers(0, 1 << 62, size=n + 1000, dtype=np.uint64)
    km = np.unique(jcodec.canonical_np(km, K))[:n]
    labels = rng.integers(1, 60000, size=len(km)).astype(np.uint32)
    return km, labels, ["NA"] + [f"T{i}" for i in range(1, 60000)]


def _main_used(table, nb):
    """Occupied slots (nonzero label field) of each main row."""
    return ((table[:nb, 4:] & np.uint32(0xFFFF)) != 0).sum(1)


def _stash_main_rows(db):
    """The main bucket of every key the stash holds: a stash slot's
    `other` word is the key's l2, whose low nb_bits are its main row."""
    stash = db.table[db.nb:]
    used = (stash[:, 4:] & np.uint32(0xFFFF)) != 0
    return (stash[:, :4][used] & np.uint32(db.nb - 1)).astype(np.int64)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}")
def built(request):
    n, nb_bits = request.param
    km, labels, names = _keys(n)
    port = hashdb.build_table(km, labels, names, DBConfig(k=K),
                              nb_bits=nb_bits)
    ref = jhashdb.build_table(km, labels, names, JDBConfig(k=K),
                              nb_bits=nb_bits)
    return km, labels, names, nb_bits, port, ref


@pytest.mark.parametrize("which", ["port", "reference", "port_numpy"])
def test_stash_keys_have_full_main_rows(built, which, monkeypatch):
    km, labels, names, nb_bits, port, ref = built
    if which == "port_numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        db = hashdb.build_table(km, labels, names, DBConfig(k=K),
                                nb_bits=nb_bits)
    else:
        db = port if which == "port" else ref
    rows = _stash_main_rows(db)
    assert len(rows) > 1000
    used = _main_used(db.table, db.nb)
    assert (used[rows] == 4).all()
    # the rule skips the stash behind most main rows
    assert ((used > 0) & (used < 4)).mean() > 0.25


def _rule_labels(db, kmers):
    """The kernel's qs probe in numpy: the main row's label; the stash
    row's only where the main row gives 0 and is full (or, in a table
    loaded with a sample factor, empty)."""
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h1, l2 = jhashdb.feistel_mix(hi, lo, db.seed)
    t, nb = db.table, db.nb
    b0 = (l2 & np.uint32(nb - 1)).astype(np.int64)
    b1 = nb + (h1 & np.uint32((1 << db.stash_bits) - 1)).astype(np.int64)

    def row_label(rows, other, own, bits, choice):
        r = t[rows]
        meta = r[:, 4:]
        m = ((r[:, :4] == other[:, None])
             & ((meta >> np.uint32(17)) == (own >> np.uint32(bits))[:, None])
             & (((meta >> np.uint32(16)) & np.uint32(1)) == choice))
        return np.where(m, (meta & np.uint32(0xFFFF)).astype(np.int64),
                        0).sum(1)

    lab = row_label(b0, h1, l2, db.nb_bits, 0)
    used = _main_used(t, nb)[b0]
    need = (lab == 0) & ((used == 4) | (db.sampled & (used == 0)))
    lab[need] = row_label(b1[need], l2[need], h1[need], db.stash_bits, 1)
    return lab


@pytest.mark.parametrize("sample", [1, 2, 3])
def test_stash_rule_gives_reference_labels(built, sample, tmp_path):
    """Every stored k-mer (main and stash) and as many random ones: the
    rule's labels equal the JAX package's probe on the same table, loaded
    whole or with a sample factor (both packages' loads zero the same
    rows)."""
    km, labels, _, _, port, ref = built
    path = tmp_path / "db.npz"
    ref.save(path)
    jdb = jhashdb.KmerDB.load(path, sample_factor=sample)
    db = hashdb.KmerDB.load(path, sample_factor=sample)
    assert db.checksum() == jdb.checksum()
    assert db.spec.sampled == db.sampled == (sample > 1)
    if sample > 1:
        # zeroed main rows in front of kept stash keys
        rows = _stash_main_rows(db)
        assert (_main_used(db.table, db.nb)[rows] == 0).any()
    rng = np.random.default_rng(sample)
    probes = np.concatenate([km, jcodec.canonical_np(
        rng.integers(0, 1 << 62, size=len(km), dtype=np.uint64), K)])
    want = np.asarray(jdb.probe_np(probes)).astype(np.int64)
    assert (want > 0).sum() > len(km) // (2 * sample)
    np.testing.assert_array_equal(_rule_labels(db, probes), want)


def test_save_refuses_a_sampled_table(built, tmp_path):
    """A table as built is not sampled and saves as the reference writes
    it; a table loaded with a sample factor is marked sampled and is not
    saved, so its zeroed main rows are never taken for a built table's."""
    port = built[4]
    assert not port.sampled and not port.spec.sampled
    whole = tmp_path / "whole.npz"
    port.save(whole)
    with np.load(whole) as z:
        assert "sampled" not in json.loads(bytes(z["meta"]).decode())
    again = hashdb.KmerDB.load(whole)
    assert not again.sampled and again.checksum() == port.checksum()
    sampled = hashdb.KmerDB.load(whole, sample_factor=2)
    assert sampled.sampled and sampled.spec.sampled
    with pytest.raises(ValueError):
        sampled.save(tmp_path / "sampled.npz")
    assert not (tmp_path / "sampled.npz").exists()
