"""The q4 and s2 table layouts of the port against the JAX package on the
CPU: the table build (checksums, `items()`), the plain q4 and s2 probes
against `cuclark_tpu.probe.probe` (resident, in parts, hits from the
second hash choice alone, s2 keys whose two buckets coincide),
`classify_step_packed`, and the CLI (`build-db --layout`, `classify`
resident, streamed, paired, --extended and -s 4).  Every comparison is
exact."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import cli as jcli
from cuclark_tpu import codec as jcodec
from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu import native as jnative
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import probe as jprobe
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu_torch import cli, hashdb, native, pipeline, probe
from cuclark_tpu_torch.config import DBConfig

NAMES = ["NA"] + [f"T{i}" for i in range(1, 300)]


def _keys(seed: int, n: int, k: int) -> np.ndarray:
    """n distinct canonical k-mers, sorted, from a numpy seed."""
    rng = np.random.default_rng(seed)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=n + n // 50 + 100,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(jcodec.canonical_np(km >> np.uint64(64 - 2 * k), k))
    return np.sort(rng.permutation(km)[:n])


def _labels(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(
        1, len(NAMES), size=n).astype(np.uint32)


# (layout, slots, choices, keys, nb_bits): q4 at 57% of 2^17 x 4 slots
# (the overflow takes the second choice); s2 one-choice single slots
# (build_table grows the table until no two keys share a bucket), two
# slots at 73% and four at 88% (cuckoo evictions)
BUILDS = [("q4", 4, 2, 300_000, 17), ("s2", 1, 1, 20, None),
          ("s2", 2, 2, 1500, 10), ("s2", 4, 2, 900, 8)]
BUILD_IDS = ["q4", "s2_1x1", "s2_2x2", "s2_4x2"]


def _build_both(layout, slots, choices, n, nb_bits, k=31, seed=3):
    km, lab = _keys(seed, n, k), _labels(seed, n)
    cfg = dict(k=k, layout=layout, slots=slots, num_choices=choices)
    db = hashdb.build_table(km, lab, NAMES, DBConfig(**cfg), nb_bits=nb_bits)
    jdb = jhashdb.build_table(km, lab, NAMES, JDBConfig(**cfg),
                              nb_bits=nb_bits)
    return km, lab, db, jdb


def _sorted_items(db):
    km, lab = db.items()
    order = np.argsort(km)
    return km[order], lab[order]


@pytest.mark.parametrize("case", BUILDS, ids=BUILD_IDS)
@pytest.mark.parametrize("use_native", [True, False])
def test_build_table_matches_jax(case, use_native, monkeypatch):
    """The port's table has the JAX package's bytes.  Without the native
    builder (patched off in the port), the numpy build places overflowing
    keys in another order than the native insert loop, so its bytes are
    held to the JAX package's own numpy build, and its stored pairs to
    the native-built JAX table."""
    layout, slots, choices, n, nb_bits = case
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    km, lab, db, jdb = _build_both(*case)
    assert (db.layout, db.nb_bits, db.seed, db.slots, db.num_choices) == (
        jdb.layout, jdb.nb_bits, jdb.seed, jdb.slots, jdb.num_choices)
    assert db.table.shape == (1 << db.nb_bits,
                              3 * slots if layout == "s2" else 8)
    if use_native:
        assert db.checksum() == jdb.checksum()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        jdb_np = jhashdb.build_table(km, lab, NAMES, JDBConfig(
            k=31, layout=layout, slots=slots, num_choices=choices),
            nb_bits=nb_bits)
        assert db.checksum() == jdb_np.checksum()
    for a, b in zip(_sorted_items(db), _sorted_items(jdb)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(db.probe_np(km), lab.astype(np.int32))
    np.testing.assert_array_equal(db.probe_np(km), jdb.probe_np(km))
    assert db.spec.label_bound == db.max_label() == int(lab.max())


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_spec_refuses_labels_above_its_bound(layout, tmp_path):
    """A table file is held to its target names where it is loaded: a
    stored label above them raises ValueError, and the labels' largest
    is the loaded spec's bound.  A table that neither build_table nor
    load made takes the wide bound, MTRGTS.  A sampled s2 table's
    emptied rows hold no label."""
    n, nb_bits = (100_000, 17) if layout != "s2" else (1500, 10)
    km, lab = _keys(5, n, 31), np.minimum(_labels(5, n), 250)
    db = hashdb.build_table(km, lab, NAMES, DBConfig(
        k=31, layout=layout, slots=2, num_choices=2), nb_bits=nb_bits)
    assert db.spec.label_bound == 250 < len(NAMES) - 1
    unbound = dataclasses.replace(db, label_bound=None)
    assert unbound.spec.label_bound == hashdb.MTRGTS
    short = dataclasses.replace(db, target_names=NAMES[:3])
    good, bad = tmp_path / "good.npz", tmp_path / "bad.npz"
    db.save(good)
    short.save(bad)
    assert hashdb.KmerDB.load(good).spec.label_bound == 250
    loaded = hashdb.KmerDB.load(good, sample_factor=3)
    assert loaded.spec.label_bound == 250
    assert loaded.max_label() <= 250
    with pytest.raises(ValueError, match="above"):
        hashdb.KmerDB.load(bad)


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_items_match_jax(layout):
    n = 300_000 if layout != "s2" else 1500
    nb_bits = 17 if layout != "s2" else 10
    km, lab, db, jdb = _build_both(layout, 2, 2, n, nb_bits)
    got, want = db.items(), jdb.items()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    order = np.argsort(got[0])
    np.testing.assert_array_equal(got[0][order], km)
    np.testing.assert_array_equal(got[1][order], lab)


@pytest.mark.parametrize("seed", [0, 7])
def test_mix_torch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    hi, lo = (rng.integers(0, 1 << 32, size=4096,
                           dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    th, tl = (torch.from_numpy(a.astype(np.int64)) for a in (hi, lo))
    for mix, jmix in ((hashdb.mix1_torch, jhashdb.mix1),
                      (hashdb.mix2_torch, jhashdb.mix2)):
        want = np.asarray(jmix(jnp.asarray(hi), jnp.asarray(lo)))
        np.testing.assert_array_equal(mix(th, tl).numpy(),
                                      want.astype(np.int64))


# ---------- the plain probes against cuclark_tpu.probe.probe ----------


def _jax_probe(table, db, keys, bucket_start=None, nb_local=None):
    khi, klo = (jnp.asarray(a) for a in jhashdb._split64(keys))
    start = None if bucket_start is None else jnp.int32(bucket_start)
    return np.asarray(jprobe.probe(
        jnp.asarray(table), db.nb_bits, db.slots, db.num_choices, khi, klo,
        bucket_start=start, nb_local=nb_local, layout=db.layout,
        seed=db.seed))


def _port_probe(table, db, keys, bucket_start=0):
    return probe.probe_table(
        torch.from_numpy(np.ascontiguousarray(table).view(np.int32)), None,
        db.spec, torch.from_numpy(keys.view(np.int64)),
        bucket_start).numpy()


def _probe_keys(km, k, seed):
    rng = np.random.default_rng(seed)
    misses = _keys(seed + 100, 3000, k)
    return np.concatenate([km[rng.choice(len(km), min(len(km), 20_000),
                                         replace=False)], misses])


PROBE_CASES = [("q4", 4, 2, 300_000, 17), ("s2", 2, 2, 1500, 10),
               ("s2", 4, 1, 1000, 10), ("s2", 4, 2, 900, 8)]
PROBE_IDS = ["q4", "s2_2x2", "s2_4x1", "s2_4x2"]


@pytest.fixture(scope="module", params=[27, 31, 32], ids=lambda k: f"k{k}")
def tables(request):
    """Per k, a table of each PROBE_CASES layout built from the same
    seed by the port."""
    k = request.param
    out = {}
    for case, name in zip(PROBE_CASES, PROBE_IDS):
        layout, slots, choices, n, nb_bits = case
        km, lab = _keys(k, n, k), _labels(k, n)
        db = hashdb.build_table(km, lab, NAMES, DBConfig(
            k=k, layout=layout, slots=slots, num_choices=choices),
            nb_bits=nb_bits)
        out[name] = (km, lab, db)
    return k, out


@pytest.mark.parametrize("name", PROBE_IDS)
def test_probe_matches_jax(tables, name):
    k, out = tables
    km, lab, db = out[name]
    keys = _probe_keys(km, k, 1)
    got = _port_probe(db.table, db, keys)
    np.testing.assert_array_equal(got, _jax_probe(db.table, db, keys))
    n_hit = min(len(km), 20_000)
    assert (got[:n_hit] > 0).all() and (got[n_hit:] == 0).all()


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("name", PROBE_IDS)
def test_probe_parts_match_jax(tables, name, parts):
    """Part by part (bucket_start, nb_local) equal to the JAX probe of
    the same rows, and the parts sum to the resident labels: a key is
    found in exactly one part."""
    k, out = tables
    km, lab, db = out[name]
    keys = _probe_keys(km, k, 2)
    rows = db.nb // parts
    total = 0
    for p in range(parts):
        part = db.table[p * rows:(p + 1) * rows]
        got = _port_probe(part, db, keys, p * rows)
        np.testing.assert_array_equal(
            got, _jax_probe(part, db, keys, p * rows, rows))
        total = total + got
    np.testing.assert_array_equal(total, _port_probe(db.table, db, keys))


@pytest.mark.parametrize("name", ["q4", "s2_2x2", "s2_4x2"])
def test_probe_second_choice_alone(tables, name):
    """Hits from second-choice rows alone, resident and in parts."""
    k, out = tables
    km, lab, db = out[name]
    t = db.second_choice_only()
    keys = _probe_keys(km, k, 3)
    got = _port_probe(t, db, keys)
    np.testing.assert_array_equal(got, _jax_probe(t, db, keys))
    assert 0 < int((got > 0).sum()) < len(km)
    rows = db.nb // 4
    for p in range(4):
        part = t[p * rows:(p + 1) * rows]
        np.testing.assert_array_equal(
            _port_probe(part, db, keys, p * rows),
            _jax_probe(part, db, keys, p * rows, rows))


def test_s2_coinciding_buckets_count_once():
    """Keys whose mix1 and mix2 buckets are one global bucket count once,
    resident and in parts."""
    k = 31
    nb_bits = 6
    cand = _keys(21, 40_000, k)
    hi, lo = jhashdb._split64(cand)
    mask = np.uint32((1 << nb_bits) - 1)
    with np.errstate(over="ignore"):
        same = (jhashdb.mix1(hi, lo) & mask) == (jhashdb.mix2(hi, lo) & mask)
    km = np.sort(np.concatenate([cand[same][:40], cand[~same][:100]]))
    lab = _labels(21, len(km))
    db = hashdb.build_table(km, lab, NAMES, DBConfig(
        k=k, layout="s2", slots=4, num_choices=2), nb_bits=nb_bits)
    assert db.nb_bits == nb_bits
    got = _port_probe(db.table, db, km)
    np.testing.assert_array_equal(got, lab.astype(np.int32))
    np.testing.assert_array_equal(got, _jax_probe(db.table, db, km))
    rows = db.nb // 4
    total = 0
    for p in range(4):
        part = db.table[p * rows:(p + 1) * rows]
        got_p = _port_probe(part, db, km, p * rows)
        np.testing.assert_array_equal(
            got_p, _jax_probe(part, db, km, p * rows, rows))
        total = total + got_p
    np.testing.assert_array_equal(total, lab.astype(np.int32))


def _planted_wire(km, k, R, L, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = jcodec.INVALID
    codes[1, L // 2:] = jcodec.INVALID
    return jcodec.pack_codes(codes)


@pytest.mark.parametrize("name", ["q4", "s2_2x2"])
def test_query_part_labels_match_probe_part_step(tables, name):
    """The part query of the wire batch against the JAX part step, and
    accumulated parts equal to the resident query."""
    k, out = tables
    km, _, db = out[name]
    p2, vb = _planted_wire(km, k, 48, 152, 4)
    tp2, tvb = torch.from_numpy(p2), torch.from_numpy(vb)
    main, stash = hashdb.table_to_device(db, "cpu")
    assert stash is None and main.shape == (db.nb, db.spec.row_words)
    rows = db.nb // 4
    acc = None
    for p in range(4):
        part = main[p * rows:(p + 1) * rows]
        got = probe.query_part_labels(tp2, tvb, part, None,
                                      bucket_start=p * rows, nb_local=rows,
                                      k=k, spec=db.spec)
        want = jpipeline.probe_part_step(
            jnp.asarray(db.table[p * rows:(p + 1) * rows]), jnp.asarray(p2),
            jnp.asarray(vb), jnp.int32(p * rows), k=k, nb_bits=db.nb_bits,
            slots=db.slots, num_choices=db.num_choices, nb_local=rows,
            layout=db.layout, seed=db.seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        acc = probe.query_part_labels(tp2, tvb, part, None,
                                      bucket_start=p * rows, nb_local=rows,
                                      k=k, spec=db.spec, acc=acc)
    resident = probe.query_labels(tp2, tvb, main, None, k=k, spec=db.spec)
    assert torch.equal(acc, resident) and int((resident > 0).sum()) > 48


@pytest.mark.parametrize("name", ["q4", "s2_2x2", "s2_4x1"])
def test_classify_step_packed_matches_jax(tables, name):
    k, out = tables
    km, _, db = out[name]
    p2, vb = _planted_wire(km, k, 40, 160, 5)
    jres, jlab = jpipeline.classify_step_packed(
        jnp.asarray(db.table), jnp.asarray(p2), jnp.asarray(vb), k=k,
        nb_bits=db.nb_bits, slots=db.slots, num_choices=db.num_choices,
        layout=db.layout, seed=db.seed, stash_bits=db.stash_bits)
    main, stash = hashdb.table_to_device(db, "cpu")
    res, lab = pipeline.classify_step_packed(
        main, torch.from_numpy(p2), torch.from_numpy(vb), k=k,
        spec=db.spec, stash=stash)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    assert (res.numpy()[::2, 2] > 0).all()


def test_query_rejects_wrong_row_width(tables):
    _, out = tables
    _, _, db = out["s2_2x2"]
    main, _ = hashdb.table_to_device(db, "cpu")
    p2 = torch.zeros((1, 40), dtype=torch.uint8)
    vb = torch.zeros((1, 20), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rows must be"):
        probe.query_labels(p2, vb, main[:, :4], None, k=31, spec=db.spec)
    with pytest.raises(ValueError, match="no stash"):
        probe.query_labels(p2, vb, main, main, k=31, spec=db.spec)


# ---------- the CLI against cuclark-tpu ----------


LAYOUT_FLAGS = {"qs": [], "q4": ["--layout", "q4"],
                "s2": ["--layout", "s2", "--slots", "4", "--choices", "1"]}


@pytest.fixture(scope="module")
def cli_dbs(tmp_path_factory):
    """Three genomes, 70 reads and 30 pairs, and a qs, q4 and s2
    database built by each package's CLI."""
    tmp = tmp_path_factory.mktemp("torch_layouts")
    rng = random.Random(5)
    genomes, lines = [], []
    for t in (1, 2, 3):
        g = "".join(rng.choice("ACGT") for _ in range(3000))
        genomes.append(g)
        (tmp / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp / f'g{t}.fa'} T{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    reads, r1, r2 = [], [], []
    for i in range(70):
        g = genomes[i % 3]
        pos = rng.randrange(0, 2800)
        seq = list(g[pos:pos + 120])
        for _ in range(rng.randrange(4)):
            seq[rng.randrange(120)] = rng.choice("ACGTN")
        reads.append((f"r{i}", "".join(seq)))
        if i < 30:
            r1.append((f"p{i}", g[pos:pos + 80]))
            r2.append((f"p{i}", g[pos + 100:pos + 170]))
    for path, recs, sfx in ((tmp / "reads.fq", reads, ""),
                            (tmp / "r1.fq", r1, "/1"),
                            (tmp / "r2.fq", r2, "/2")):
        path.write_text("".join(f"@{n}{sfx}\n{s}\n+\n{'I' * len(s)}\n"
                                for n, s in recs))
    for layout, flags in LAYOUT_FLAGS.items():
        build = ["build-db", "-T", str(tmp / "targets.txt"), "-k", "25",
                 *flags]
        assert jcli.main(build + ["-D", str(tmp / f"j{layout}")]) == 0
        assert cli.main(build + ["-D", str(tmp / f"t{layout}")]) == 0
    return tmp


def _db(d, cls):
    return cls.load(next(d.glob("db_k*.npz")))


@pytest.mark.parametrize("layout", ["q4", "s2"])
def test_cli_build_db_matches_jax(cli_dbs, layout, capsys):
    tmp = cli_dbs
    db = _db(tmp / f"t{layout}", hashdb.KmerDB)
    jdb = _db(tmp / f"j{layout}", jhashdb.KmerDB)
    assert db.layout == layout and db.num_kmers == jdb.num_kmers > 0
    assert db.checksum() == jdb.checksum()
    assert (next((tmp / f"t{layout}").glob("*.npz")).name
            == next((tmp / f"j{layout}").glob("*.npz")).name)
    capsys.readouterr()
    assert cli.main(["info", "-D", str(tmp / f"t{layout}")]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["info", "-D", str(tmp / f"j{layout}")]) == 0
    want = capsys.readouterr().out
    assert got.replace(f"/t{layout}/", "/") == want.replace(
        f"/j{layout}/", "/")
    assert '"stash_rows": 0' in got


MODES = {
    "resident": lambda t: ["-O", str(t / "reads.fq")],
    "streamed": lambda t: ["-O", str(t / "reads.fq"), "--max-table-mb",
                           "0.2", "-b", "16", "--stream-group", "2"],
    "paired": lambda t: ["-P", str(t / "r1.fq"), str(t / "r2.fq")],
    "extended": lambda t: ["-O", str(t / "reads.fq"), "--extended"],
    "sampled": lambda t: ["-O", str(t / "reads.fq"), "-s", "4"],
}


def _csv(db_dir, out, flags, run):
    assert run(["classify", "-D", str(db_dir), "-R", str(out), *flags]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["q4", "s2"])
def test_cli_classify_matches_jax(cli_dbs, tmp_path, capsys, layout, mode):
    """`classify --device cpu` on the port's q4 or s2 database writes
    `cuclark-tpu classify`'s bytes.  Every layout stores the same k-mers,
    so the CSV is also the qs database's; with -s 4 the kept buckets
    hold other k-mers in each layout, so that CSV is held to the JAX
    package's only."""
    tmp = cli_dbs
    flags = MODES[mode](tmp)
    port = _csv(tmp / f"t{layout}", tmp_path / "t.csv",
                flags + ["--device", "cpu"], cli.main)
    if mode == "streamed":
        err = capsys.readouterr().err
        assert "bucket-range parts (--max-table-mb" in err
    jax_ = _csv(tmp / f"j{layout}", tmp_path / "j.csv", flags, jcli.main)
    assert port == jax_
    # the JAX package's own .npz, loaded by the port
    assert _csv(tmp / f"j{layout}", tmp_path / "tj.csv",
                flags + ["--device", "cpu"], cli.main) == jax_
    if mode != "sampled":
        qs = _csv(tmp / "tqs", tmp_path / "qs.csv",
                  flags + ["--device", "cpu"], cli.main)
        assert port == qs
    assert port.count(b"\n") == (31 if mode == "paired" else 71)


def test_db_without_layout_key_loads_as_s2(cli_dbs, tmp_path):
    """The oldest databases carry no "layout" in their metadata: both
    packages load them as s2, and classify them alike."""
    import json

    src = next((cli_dbs / "js2").glob("db_k*.npz"))
    with np.load(src) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        table = z["table"]
    del meta["layout"]
    old = tmp_path / "db" / src.name
    old.parent.mkdir()
    np.savez(old, table=table,
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    db = hashdb.KmerDB.load(old)
    assert db.layout == jhashdb.KmerDB.load(old).layout == "s2"
    assert db.checksum() == _db(cli_dbs / "js2", jhashdb.KmerDB).checksum()
    flags = MODES["resident"](cli_dbs)
    assert (_csv(tmp_path / "db", tmp_path / "t.csv",
                 flags + ["--device", "cpu"], cli.main)
            == _csv(cli_dbs / "js2", tmp_path / "j.csv", flags, jcli.main))
