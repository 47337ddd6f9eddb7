"""Parity of the port's Feistel mix, qs probe and query chain with the
JAX package's `hashdb.feistel_mix`, `probe._probe_qs_split` and
`probe._probe_qs`, on a table with nb_bits 17 and stash_bits 17 holding
keys in both main and stash rows.  Every comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import codec as jcodec
from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu import probe as jprobe
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu_torch import hashdb, probe
from cuclark_tpu_torch.config import DBConfig

K = 31
N_KEYS = 300_000  # 57% of 2^17 x 4 main slots: the overflow fills the stash


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)
    km = rng.integers(0, 1 << 62, size=N_KEYS + 1000, dtype=np.uint64)
    km = np.unique(jcodec.canonical_np(km, K))[:N_KEYS]
    labels = rng.integers(1, 200, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 200)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=K), nb_bits=17)
    jdb = jhashdb.build_table(km, labels, names, JDBConfig(k=K), nb_bits=17)
    return km, labels, db, jdb


def _split(kmers):
    kmers = np.asarray(kmers, np.uint64)
    return ((kmers >> np.uint64(32)).astype(np.uint32),
            (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_feistel_mix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    h1, l2 = jhashdb.feistel_mix(jnp.asarray(hi), jnp.asarray(lo), seed)
    th1, tl2 = hashdb.feistel_mix_torch(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), seed)
    np.testing.assert_array_equal(th1.numpy(), np.asarray(h1).astype(np.int64))
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(l2).astype(np.int64))


def test_port_table_has_jax_bytes(table):
    _, _, db, jdb = table
    assert (db.nb_bits, db.stash_bits, db.seed) == (17, 17, jdb.seed)
    assert jdb.stash_bits == 17
    assert db.checksum() == jdb.checksum()


def test_table_to_device_views_split_rows(table):
    _, _, db, _ = table
    main, stash = hashdb.table_to_device(db, "cpu")
    assert main.dtype == torch.int32 and main.shape == (1 << 17, 8)
    assert stash.shape == (1 << 17, 8)
    np.testing.assert_array_equal(main.numpy().view(np.uint32),
                                  db.table[:db.nb])
    np.testing.assert_array_equal(stash.numpy().view(np.uint32),
                                  db.table[db.nb:])


def test_qs_probe_matches_jax_split_and_fused(table):
    km, labels, db, _ = table
    rng = np.random.default_rng(3)
    hits = km[rng.choice(len(km), 20_000, replace=False)]
    misses = jcodec.canonical_np(
        rng.integers(0, 1 << 62, size=5_000, dtype=np.uint64), K)
    keys = np.concatenate([hits, misses])
    khi, klo = _split(keys)
    main, stash = hashdb.table_to_device(db, "cpu")
    got = probe.probe_qs_split(main, stash, db.nb_bits, db.stash_bits,
                               db.seed, torch.from_numpy(keys.view(np.int64)))
    want_split = np.asarray(jprobe._probe_qs_split(
        jnp.asarray(db.table[:db.nb]), jnp.asarray(db.table[db.nb:]),
        db.nb_bits, db.stash_bits, db.seed, jnp.asarray(khi),
        jnp.asarray(klo)))
    want_fused = np.asarray(jprobe._probe_qs(
        jnp.asarray(db.table), db.nb_bits, db.stash_bits, db.seed,
        jnp.asarray(khi), jnp.asarray(klo)))
    np.testing.assert_array_equal(got.numpy(), want_split)
    np.testing.assert_array_equal(got.numpy(), want_fused)
    np.testing.assert_array_equal(got.numpy()[:len(hits)],
                                  db.probe_np(hits))
    assert (got.numpy()[:len(hits)] > 0).all()
    # both sides answer: some hits come from the stash alone
    from_stash = probe.probe_qs_split(
        torch.zeros_like(main), stash, db.nb_bits, db.stash_bits, db.seed,
        torch.from_numpy(hits.view(np.int64)))
    n_stash = int((from_stash > 0).sum())
    assert 0 < n_stash < len(hits)


def test_query_labels_matches_jax_chain(table):
    """The CPU wrapper (plain version of the query kernel) against the
    JAX chain unpack -> extract -> canonical -> split probe -> mask, on
    reads that hold stored k-mers, Ns and padding."""
    km, _, db, _ = table
    rng = np.random.default_rng(4)
    R, L = 48, 157
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    # plant stored k-mers (forward strand) into half of the reads
    for r in range(0, R, 2):
        for p in range(0, L - K, 40):
            v = int(km[rng.integers(len(km))])
            codes[r, p:p + K] = [(v >> (2 * (K - 1 - j))) & 3
                                 for j in range(K)]
    codes[rng.random((R, L)) < 0.01] = jcodec.INVALID
    codes[5, 100:] = jcodec.INVALID
    p2, vb = jcodec.pack_codes(codes)
    main, stash = hashdb.table_to_device(db, "cpu")
    got = probe.query_labels(torch.from_numpy(p2), torch.from_numpy(vb),
                             main, stash, k=K, spec=db.spec)
    jcodes = jcodec.unpack_codes(jnp.asarray(p2), jnp.asarray(vb))
    (hi, lo), valid = jcodec.extract_kmers(jcodes, K)
    chi, clo = jcodec.canonical((hi, lo), K)
    lab = jprobe._probe_qs_split(
        jnp.asarray(db.table[:db.nb]), jnp.asarray(db.table[db.nb:]),
        db.nb_bits, db.stash_bits, db.seed, chi.reshape(-1),
        clo.reshape(-1)).reshape(chi.shape)
    want = np.asarray(jnp.where(valid, lab, 0))
    assert got.shape == (R, 4 * p2.shape[1] - K + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() >= R // 2


def test_query_labels_rejects_bad_stash_bits(table):
    _, _, db, _ = table
    main, stash = hashdb.table_to_device(db, "cpu")
    p2 = torch.zeros((1, 10), dtype=torch.uint8)
    vb = torch.zeros((1, 5), dtype=torch.uint8)
    spec = dataclasses.replace(db.spec, stash_bits=0)
    with pytest.raises(ValueError, match="stash_bits"):
        probe.query_labels(p2, vb, main, stash, k=K, spec=spec)
