"""The port's mesh (`cuclark_tpu_torch.parallel.mesh`), the range query
with a stash range, `pipeline.classify_step` and the mesh branches of
`pipeline.Classifier` against the JAX package on the CPU.  The JAX side
runs on the eight XLA CPU devices of tests/conftest.py; the torch side
on eight handles of `cpu`.  Every comparison is exact."""

import collections
import copy
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cuclark_tpu import cli as jcli
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import probe as jprobe
from cuclark_tpu import score as jscore
from cuclark_tpu.config import ClassifyConfig as JClassifyConfig
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu.db_build.builder import build_db as jbuild_db
from cuclark_tpu.parallel import mesh as jmesh
from cuclark_tpu_torch import (cli, codec, hashdb, kernels, pipeline, probe,
                               score)
from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
from cuclark_tpu_torch.db_build.builder import build_db, db_name
from cuclark_tpu_torch.parallel import mesh
from tests.test_torch_cuda import fused_case

K = 21
CPU8 = ["cpu"] * 8
# Handles that compare unequal (`cpu` and `cpu:0`) in every mesh row: the
# code paths of a mesh over distinct cards (a peer copy before the db sum,
# one placement per distinct device) run on the CPU.
MIXED8 = [torch.device("cpu"), torch.device("cpu", 0)] * 4
HANDLES = {"same": CPU8, "mixed": MIXED8}
SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def _db_cfg(layout):
    return dict(k=K, slots=4, layout=layout)


@pytest.fixture(scope="module", params=["qs", "q4", "s2"])
def dbs(request, tmp_path_factory):
    """tests/test_parallel.py's four 2,000 bp genomes as a qs, q4 or s2
    database built by each package (the same bytes), and the genomes."""
    layout = request.param
    tmp = tmp_path_factory.mktemp(f"mesh_{layout}")
    rng = random.Random(3)
    file_labels, genomes = [], []
    for t in range(4):
        seq = "".join(rng.choice("ACGT") for _ in range(2000))
        genomes.append(seq)
        p = tmp / f"g{t}.fa"
        p.write_text(f">g{t}\n{seq}\n")
        file_labels.append((str(p), f"T{t}"))
    db = build_db(file_labels, DBConfig(**_db_cfg(layout)))
    jdb = jbuild_db(file_labels, JDBConfig(**_db_cfg(layout)))
    assert db.checksum() == jdb.checksum()
    return db, jdb, genomes


def _codes(genomes, R, L, seed, n_every=4):
    """R reads of L codes: substrings of the genomes with a few random
    bases, Ns in every n_every-th read, and variable lengths padded with
    INVALID."""
    rng = random.Random(seed)
    codes = np.full((R, L), codec.INVALID, np.uint8)
    for i in range(R):
        g = genomes[i % len(genomes)]
        n = rng.randint(K - 3, L)
        pos = rng.randrange(0, len(g) - n)
        seq = list(g[pos:pos + n])
        for _ in range(3):
            seq[rng.randrange(n)] = rng.choice("ACGTN" if i % n_every == 0
                                               else "ACGT")
        codes[i, :n] = codec.encode_ascii("".join(seq).encode())
    return codes


def _jax_classify_step(jdb, codes):
    res, lab = jpipeline.classify_step(
        jnp.asarray(jdb.table), jnp.asarray(codes), k=jdb.k,
        nb_bits=jdb.nb_bits, slots=jdb.slots, num_choices=jdb.num_choices,
        layout=jdb.layout, seed=jdb.seed, stash_bits=jdb.stash_bits)
    return np.asarray(res), np.asarray(lab)


@pytest.mark.parametrize("num_db,num_data", SHAPES)
def test_classify_codes_matches_jax(dbs, num_db, num_data):
    """ShardedClassifier.classify_codes equals JAX classify_step and the
    JAX ShardedClassifier on the same mesh shape, labels and results."""
    db, jdb, genomes = dbs
    codes = _codes(genomes, 32, 96, 5)
    want_res, want_lab = _jax_classify_step(jdb, codes)
    jgot = jmesh.ShardedClassifier(
        jdb, jmesh.make_mesh(num_db=num_db, num_data=num_data)
    ).classify_codes(codes)
    sc = mesh.ShardedClassifier(db, mesh.make_mesh(num_db, num_data, CPU8))
    got_res, got_lab = sc.classify_codes(codes)
    np.testing.assert_array_equal(got_lab, want_lab)
    np.testing.assert_array_equal(got_res, want_res)
    np.testing.assert_array_equal(got_res, jgot[0])
    assert int((want_lab > 0).sum()) > 100


@pytest.mark.parametrize("k", [27, 31, 32])
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_classify_step_matches_jax(layout, k):
    """pipeline.classify_step (unpacked codes) equals JAX classify_step
    at k 27, 31 and 32 on a table with hits from its second hash choice
    or stash, labels and results."""
    rng = np.random.default_rng(k)
    n, nb_bits = {"qs": (300_000, 17), "q4": (300_000, 17),
                  "s2": (90_000, 16)}[layout]
    km = rng.integers(0, np.iinfo(np.uint64).max, size=n + 10_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))[:n]
    labels = rng.integers(1, 300, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 300)]
    db = hashdb.build_table(km, labels, names, DBConfig(
        k=k, layout=layout, slots=2, num_choices=2), nb_bits=nb_bits)
    R, L = 48, 100
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[1, 60:] = codec.INVALID
    codes[3, 7] = 9  # any byte >= 4 is an N
    main, stash = hashdb.table_to_device(db, "cpu")
    res, lab = pipeline.classify_step(main, torch.from_numpy(codes), k=k,
                                      spec=db.spec, stash=stash)
    want_res, want_lab = jpipeline.classify_step(
        jnp.asarray(db.table), jnp.asarray(codes), k=k, nb_bits=db.nb_bits,
        slots=db.slots, num_choices=db.num_choices, layout=layout,
        seed=db.seed, stash_bits=db.stash_bits)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(res.numpy(), np.asarray(want_res))
    assert int((lab > 0).sum()) > R
    # the wire step on the packed codes gives the same
    p2, vb = (torch.from_numpy(a) for a in codec.pack_codes(codes))
    pres, plab = pipeline.classify_step_packed(main, p2, vb, k=k,
                                               spec=db.spec, stash=stash)
    assert torch.equal(plab[:, :lab.shape[1]], lab) and torch.equal(pres,
                                                                    res)
    assert pipeline.classify_step(main, torch.from_numpy(codes), k=k,
                                  spec=db.spec, stash=stash,
                                  with_labels=False)[1] is None


def _jax_put(jm, arr, spec):
    return jax.device_put(arr, NamedSharding(jm, spec))


@pytest.mark.parametrize("handles", ["same", "mixed"])
@pytest.mark.parametrize("num_db,num_data", [(2, 4), (4, 2)])
def test_sharded_steps_match_jax(dbs, num_db, num_data, handles):
    """The sharded resident step and the sharded part step (stash on
    part 0 only) equal build_sharded_classify and build_sharded_probe_part
    of the JAX package on the same split table and wire batch; the parts'
    sum equals the resident step.  With mixed handles a row's shards lie
    on devices that differ from its column-0 device."""
    db, jdb, genomes = dbs
    codes = _codes(genomes, 40, 96, 7)
    p2, vb = codec.pack_codes(codes)
    m = mesh.make_mesh(num_db, num_data, HANDLES[handles])
    jm = jmesh.make_mesh(num_db=num_db, num_data=num_data)
    main_np, stash_np = db.split_tables()
    nbs = stash_np.shape[0] if stash_np is not None else 0
    jkw = dict(k=db.k, nb_bits=db.nb_bits, slots=db.slots,
               num_choices=db.num_choices, layout=db.layout, seed=db.seed,
               stash_bits=db.stash_bits)
    rows_sh, data_sh = P("db", None), P("data", None)
    jp2, jvb = _jax_put(jm, p2, data_sh), _jax_put(jm, vb, data_sh)
    jstep = jmesh.build_sharded_classify(jm, nb_total=main_np.shape[0],
                                         nbs_total=nbs, **jkw)
    jmain = _jax_put(jm, main_np, rows_sh)
    jstash = _jax_put(jm, stash_np, rows_sh) if nbs else None
    jres, jlab = (jstep(jmain, jstash, jp2, jvb) if nbs
                  else jstep(jmain, jp2, jvb))

    main, stash = mesh.shard_db_table(db, m)
    step = mesh.build_sharded_classify(m, k=db.k, spec=db.spec,
                                       nb_total=main_np.shape[0],
                                       nbs_total=nbs)
    wires = mesh.place_wire(m, p2, vb)
    res, lab = step(main, stash, wires)
    assert len(res) == len(lab) == num_data
    lab = np.concatenate([b.numpy() for b in lab])
    np.testing.assert_array_equal(lab, np.asarray(jlab))
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in res]),
                                  np.asarray(jres))

    parts = 4
    rows = main_np.shape[0] // parts
    pstep = mesh.build_sharded_probe_part(m, k=db.k, spec=db.spec,
                                          nb_part=rows)
    jpart = jmesh.build_sharded_probe_part(jm, nb_part=rows,
                                           skip_stash=bool(nbs), **jkw)
    jpart0 = (jmesh.build_sharded_probe_part(jm, nb_part=rows,
                                             with_stash=True, **jkw)
              if nbs else jpart)
    acc = None
    for p in range(parts):
        part_np = main_np[p * rows:(p + 1) * rows]
        jp = _jax_put(jm, part_np, rows_sh)
        if p == 0 and nbs:
            (want,) = jpart0(jp, jstash, jp2, jvb, jnp.int32(0))
        else:
            (want,) = jpart(jp, jp2, jvb, jnp.int32(p * rows))
        part = mesh.shard_rows(part_np, m)
        s = stash if p == 0 else None
        got = pstep(part, wires, p * rows, stash=s)
        np.testing.assert_array_equal(
            np.concatenate([b.numpy() for b in got]), np.asarray(want))
        acc = pstep(part, wires, p * rows, stash=s, acc=acc)
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in acc]),
                                  lab)


@pytest.fixture(scope="module")
def stash_case():
    """A qs table of 300,000 31-mers at nb_bits 17 (the overflow fills a
    2^17-row stash) and 256 reads of 152 bases with stored k-mers
    planted."""
    k = 31
    rng = np.random.default_rng(11)
    km = rng.integers(0, 1 << 62, size=301_000, dtype=np.uint64)
    km = np.unique(codec.canonical_np(km, k))[:300_000]
    labels = rng.integers(1, 300, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 300)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=k), nb_bits=17)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(R):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    return db, codes


@pytest.mark.parametrize("num_db", [2, 4, 8])
def test_stash_only_hits_in_every_shard(stash_case, num_db):
    """Main rows zeroed: every stash shard of a db-sharded qs table
    answers hits of its own (range checked like JAX
    `_probe_qs_split`'s stash_start/nbs_local), the shards' sum equals
    the whole stash, and the full table's shards sum to its labels."""
    db, codes = stash_case
    k, spec = db.k, db.spec
    main, stash = hashdb.table_to_device(db, "cpu")
    nbl, nbsl = db.nb // num_db, stash.shape[0] // num_db
    p2, vb = (torch.from_numpy(a) for a in codec.pack_codes(codes))
    kmers, valid = codec.extract_kmers(torch.from_numpy(codes), k)
    canon = codec.canonical(kmers, k)
    khi = (codec.shr(canon, 32)).numpy().astype(np.uint32)
    klo = (canon & 0xFFFFFFFF).numpy().astype(np.uint32)
    zero = torch.zeros_like(main)
    only_stash, total = None, None
    for j in range(num_db):
        args = dict(bucket_start=j * nbl, nb_local=nbl, k=k, spec=spec,
                    stash_start=j * nbsl)
        s_j = stash[j * nbsl:(j + 1) * nbsl]
        got = probe.query_part_labels(p2, vb, zero[j * nbl:(j + 1) * nbl],
                                      s_j, **args)
        assert int((got > 0).sum()) > 0, j
        want = jprobe.probe(
            jnp.asarray(db.table[:db.nb][j * nbl:(j + 1) * nbl] * 0),
            db.nb_bits, db.slots, db.num_choices, jnp.asarray(khi),
            jnp.asarray(klo), bucket_start=jnp.int32(j * nbl), nb_local=nbl,
            layout="qs", seed=db.seed, stash_bits=db.stash_bits,
            stash=jnp.asarray(db.table[db.nb:][j * nbsl:(j + 1) * nbsl]),
            stash_start=jnp.int32(j * nbsl), nbs_local=nbsl)
        np.testing.assert_array_equal(
            got.numpy(), np.where(valid.numpy(), np.asarray(want), 0))
        only_stash = got if only_stash is None else only_stash + got
        total = probe.query_part_labels(p2, vb, main[j * nbl:(j + 1) * nbl],
                                        s_j, acc=total, **args)
    full = probe.query_labels(p2, vb, main, stash, k=k, spec=spec)
    assert torch.equal(only_stash, probe.query_part_labels(
        p2, vb, zero, stash, bucket_start=0, nb_local=db.nb, k=k, spec=spec))
    assert torch.equal(total, full)


@pytest.mark.parametrize("start,rows", [(-1, 4), ((1 << 17) - 2, 4),
                                        ((1 << 17) - 3, 4)])
def test_stash_range_rejects_bad_range(stash_case, start, rows):
    db, codes = stash_case
    main, stash = hashdb.table_to_device(db, "cpu")
    p2, vb = (torch.from_numpy(a) for a in codec.pack_codes(codes[:4]))
    with pytest.raises(ValueError, match="stash"):
        probe.query_part_labels(p2, vb, main, stash[:rows], bucket_start=0,
                                nb_local=db.nb, k=db.k, spec=db.spec,
                                stash_start=start)


@pytest.mark.parametrize("num_db,parts", [(2, 2), (2, 8), (4, 4)])
def test_part_step_splits_stash_matches_jax(stash_case, num_db, parts):
    """The sharded part step with each shard's stash split over the parts
    (split=(p, parts), as `Classifier` streams on a mesh): with the main
    rows zeroed every part answers stash hits of its own; the parts'
    labels sum to the JAX package's build_sharded_probe_part steps (the
    stash on part 0), and a last part that ends in the fused launch
    (scored=True) equals their score."""
    db, codes = stash_case
    p2, vb = codec.pack_codes(codes)
    m = mesh.make_mesh(num_db, 1, CPU8[:num_db])
    jm = jmesh.make_mesh(num_db=num_db, num_data=1,
                         devices=jax.devices()[:num_db])
    main_np, stash_np = db.split_tables()
    jkw = dict(k=db.k, nb_bits=db.nb_bits, slots=db.slots,
               num_choices=db.num_choices, layout=db.layout, seed=db.seed,
               stash_bits=db.stash_bits)
    rows = main_np.shape[0] // parts
    jpart = jmesh.build_sharded_probe_part(jm, nb_part=rows, skip_stash=True,
                                           **jkw)
    jpart0 = jmesh.build_sharded_probe_part(jm, nb_part=rows,
                                            with_stash=True, **jkw)
    jp2, jvb = (_jax_put(jm, a, P("data", None)) for a in (p2, vb))
    jstash = _jax_put(jm, stash_np, P("db", None))
    want = 0
    for p in range(parts):
        jp = _jax_put(jm, main_np[p * rows:(p + 1) * rows], P("db", None))
        (lab,) = (jpart0(jp, jstash, jp2, jvb, jnp.int32(0)) if p == 0
                  else jpart(jp, jp2, jvb, jnp.int32(p * rows)))
        want = want + np.asarray(lab)

    _, stash = mesh.shard_db_table(db, m)
    wires = mesh.place_wire(m, p2, vb)
    pstep = mesh.build_sharded_probe_part(m, k=db.k, spec=db.spec,
                                          nb_part=rows)
    zero = mesh.shard_rows(np.zeros_like(main_np[:rows]), m)
    acc, only = None, None
    for p in range(parts):
        part = mesh.shard_rows(main_np[p * rows:(p + 1) * rows], m)
        (got,) = pstep(zero, wires, p * rows, stash=stash, split=(p, parts))
        assert int((got > 0).sum()) > 0, p
        only = got if only is None else only + got
        if p < parts - 1:
            acc = pstep(part, wires, p * rows, stash=stash, acc=acc,
                        split=(p, parts))
    (whole,) = pstep(zero, wires, 0, stash=stash)
    assert torch.equal(only, whole)
    (res,) = pstep(part, wires, (parts - 1) * rows, stash=stash,
                   acc=[a.clone() for a in acc], scored=True,
                   split=(parts - 1, parts))
    (lab,) = pstep(part, wires, (parts - 1) * rows, stash=stash, acc=acc,
                   split=(parts - 1, parts))
    np.testing.assert_array_equal(lab.numpy(), want)
    np.testing.assert_array_equal(
        res.numpy(), np.asarray(jscore.score_labels(jnp.asarray(want))))


@pytest.mark.parametrize("R", [30, 53])
def test_uneven_batch_padding(dbs, R):
    """Batches that the data axis does not divide pad and trim."""
    db, jdb, genomes = dbs
    codes = _codes(genomes, R, 96, 9)
    got_res, got_lab = mesh.ShardedClassifier(
        db, mesh.make_mesh(2, 4, CPU8)).classify_codes(codes)
    want_res, want_lab = _jax_classify_step(jdb, codes)
    np.testing.assert_array_equal(got_res, want_res)
    np.testing.assert_array_equal(got_lab, want_lab)


def _reads_file(path, genomes, n, seed):
    """n FASTA reads of 40-180 bases (Ns in every 7th), a count no mesh
    axis divides."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            g = genomes[rng.randrange(len(genomes))]
            ln = rng.randint(40, 180)
            pos = rng.randrange(0, len(g) - ln)
            seq = list(g[pos:pos + ln])
            if i % 7 == 0:
                seq[rng.randrange(ln)] = "N"
            f.write(f">r{i}\n{''.join(seq)}\n")
    return path


@pytest.mark.parametrize("extended", [False, True])
def test_mesh_classifier_matches_single(dbs, tmp_path, extended):
    """Classifier(mesh=...) rows and CSV equal the single-device port's
    and the JAX mesh Classifier's (53 reads, batch 16)."""
    db, jdb, genomes = dbs
    reads = _reads_file(tmp_path / "reads.fa", genomes, 53, 11)
    cfg = ClassifyConfig(batch_reads=16, extended=extended)
    single = pipeline.Classifier(db, cfg, device="cpu")
    m = mesh.make_mesh(2, 4, CPU8)
    clf = pipeline.Classifier(db, cfg, mesh=m)
    assert clf.stream_parts == 1 and clf._sharded is not None
    rows = list(clf.classify_file(str(reads)))
    assert rows == list(single.classify_file(str(reads)))
    jclf = jpipeline.Classifier(jdb, JClassifyConfig(batch_reads=16,
                                                     extended=extended),
                                mesh=jmesh.make_mesh(num_db=2, num_data=4))
    assert rows == list(jclf.classify_file(str(reads)))
    out, jout = tmp_path / "mesh.csv", tmp_path / "jax.csv"
    assert clf.classify_file_to_csv(str(reads), out) == 53
    jclf.classify_file_to_csv(str(reads), jout)
    assert out.read_bytes() == jout.read_bytes()
    recs = [(f"q{i}", g[i * 7:i * 7 + 30 + i].encode())
            for i, g in enumerate(genomes * 5)]
    assert list(clf.classify_records(iter(recs))) == list(
        single.classify_records(iter(recs)))


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("num_db,num_data", [(2, 4), (4, 2)])
def test_mesh_streaming_matches_jax(dbs, tmp_path, num_db, num_data,
                                    extended):
    """A budget under each device's shard streams every shard in parts
    (cycles x devices x parts); the CSV equals the JAX package's resident
    and mesh-streamed CSVs."""
    db, jdb, genomes = dbs
    reads = _reads_file(tmp_path / "reads.fa", genomes, 53, 13)
    budget = db.table.nbytes / num_db / 4 / 1e6
    cfg = ClassifyConfig(batch_reads=16, extended=extended, stream_group=2,
                         max_table_mb=budget)
    clf = pipeline.Classifier(db, cfg,
                              mesh=mesh.make_mesh(num_db, num_data, CPU8))
    assert clf.stream_parts >= 4 and clf.table is None
    out = tmp_path / "mesh_stream.csv"
    assert clf.classify_file_to_csv(str(reads), out) == 53
    jres, jstr = tmp_path / "jres.csv", tmp_path / "jstr.csv"
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended)).classify_file_to_csv(
            str(reads), jres)
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended, stream_group=2,
        max_table_mb=budget), mesh=jmesh.make_mesh(
            num_db=num_db, num_data=num_data)).classify_file_to_csv(
                str(reads), jstr)
    assert out.read_bytes() == jres.read_bytes() == jstr.read_bytes()
    assert list(clf.classify_file(str(reads))) == list(
        pipeline.Classifier(db, ClassifyConfig(
            batch_reads=16, extended=extended), device="cpu").classify_file(
                str(reads)))


@pytest.mark.parametrize("streamed", [False, True])
def test_mixed_handles_classifier_matches_jax(dbs, tmp_path, streamed):
    """Classifier on a 2 data x 4 db mesh whose rows mix unequal handles
    (`cpu`, `cpu:0`): each table shard and wire block is placed once per
    distinct device, the shards' labels cross devices before the sum, and
    the CSV, resident and streamed, equals the JAX package's."""
    db, jdb, genomes = dbs
    reads = _reads_file(tmp_path / "reads.fa", genomes, 53, 29)
    m = mesh.make_mesh(4, 2, MIXED8)
    assert m.devices[0][0] != m.devices[0][1] == m.devices[0][3]
    budget = db.table.nbytes / 4 / 4 / 1e6 if streamed else None
    cfg = ClassifyConfig(batch_reads=16, extended=True, stream_group=2,
                         max_table_mb=budget)
    clf = pipeline.Classifier(db, cfg, mesh=m)
    assert (clf.stream_parts > 1) == streamed
    wires = clf._put_wire(codec.pack_codes(_codes(genomes, 6, 96, 31)))
    assert wires[0][1] is wires[0][3] and wires[0][0] is not wires[0][1]
    if not streamed:
        assert clf.table[0][0] is clf.table[1][0]
        assert clf.table[0][1] is not clf.table[0][3]
    out, jout = tmp_path / "mixed.csv", tmp_path / "jax.csv"
    assert clf.classify_file_to_csv(str(reads), out) == 53
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=True)).classify_file_to_csv(str(reads), jout)
    assert out.read_bytes() == jout.read_bytes()


def test_mesh_plan_divides_budget_by_db(dbs):
    """On a mesh each device holds 1/num_db of the stash and of every
    part: the plan equals cuclark_tpu.pipeline.Classifier's on the split
    table (the JAX package's split form forced for a small qs table)."""
    db, jdb, _ = dbs
    jdb = copy.copy(jdb)
    jdb.SPLIT_MIN_MAIN_MB = 0.0
    budget = db.table.nbytes / 6 / 1e6
    plans = []
    for num_db, num_data in SHAPES:
        clf = pipeline.Classifier(db, ClassifyConfig(max_table_mb=budget),
                                  mesh=mesh.make_mesh(num_db, num_data, CPU8))
        jclf = jpipeline.Classifier(jdb, JClassifyConfig(max_table_mb=budget),
                                    mesh=jmesh.make_mesh(num_db=num_db,
                                                         num_data=num_data))
        assert clf.stream_parts == jclf.stream_parts, num_db
        plans.append(clf.stream_parts)
    assert max(plans) > 1


def test_cli_devices_flag(dbs, tmp_path, monkeypatch, capsys):
    """classify -d 0 --device cpu with CUCLARK_CPU_DEVICES=8 makes an
    8-device mesh (and a db axis under a budget) and writes the JAX CLI's
    -d 0 bytes; -d 2 on one device prints 'only 1 available'."""
    db, jdb, genomes = dbs
    dbdir = tmp_path / "db"
    dbdir.mkdir()
    db.save(dbdir / db_name(DBConfig(**_db_cfg(db.layout)), db.num_targets))
    reads = _reads_file(tmp_path / "reads.fa", genomes, 41, 17)
    base = ["classify", "-D", str(dbdir), "-O", str(reads)]
    jout = tmp_path / "jax.csv"
    assert jcli.main([*base, "-R", str(jout), "-d", "0"]) == 0
    capsys.readouterr()
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", "8")
    budget = str(db.table.nbytes / 3 / 1e6)
    for flags, shape in ((["-d", "0"], "8 data x 1 db"),
                         (["-d", "0", "--max-table-mb", budget],
                          "2 data x 4 db"),
                         (["-d", "8", "-b", "5", "--extended"], None)):
        out = tmp_path / "torch.csv"
        assert cli.main([*base, "-R", str(out), "--device", "cpu",
                         *flags]) == 0
        err = capsys.readouterr().err
        if shape is not None:
            assert f" - Mesh: {shape} devices" in err
            assert out.read_bytes() == jout.read_bytes()
    jext = tmp_path / "jext.csv"
    assert jcli.main([*base, "-R", str(jext), "--extended"]) == 0
    assert out.read_bytes() == jext.read_bytes()
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", "1")
    assert cli.main([*base, "-R", str(out), "--device", "cpu", "-d",
                     "2"]) == 0
    err = capsys.readouterr().err
    assert "Requested 2 devices, only 1 available." in err
    assert "Mesh" not in err and out.read_bytes() == jout.read_bytes()


def test_local_rows_keeps_one_block_per_data_index(dbs):
    """The step gives one result block per data index (no db replicas),
    and local_rows concatenates them in order and trims: variable-length
    reads so that a duplicated block could not pass."""
    db, jdb, genomes = dbs
    codes = _codes(genomes, 16, 96, 19)
    sc = mesh.ShardedClassifier(db, mesh.make_mesh(4, 2, CPU8))
    res, lab = sc.step_packed(*codec.pack_codes(codes))
    assert len(res) == len(lab) == 2
    want_res, want_lab = _jax_classify_step(jdb, codes)
    assert len(np.unique(want_res, axis=0)) > 8
    np.testing.assert_array_equal(sc.local_rows(res), want_res)
    np.testing.assert_array_equal(sc.local_rows(res, 10), want_res[:10])
    np.testing.assert_array_equal(sc.local_rows(lab, 13), want_lab[:13])
    jm = jmesh.make_mesh(num_db=4, num_data=2)
    arr = jax.device_put(want_res, NamedSharding(jm, P("data", None)))
    np.testing.assert_array_equal(jmesh.ShardedClassifier.local_rows(arr),
                                  sc.local_rows(res))


def test_padding_rows_score_zero(dbs):
    """Rows added to fill the data axis have zero validity bits: their
    labels and results are all zero, and the emitted rows stop at the
    batch's count (the JAX package's pipeline.py:394-398, :850)."""
    db, _, genomes = dbs
    codes = _codes(genomes, 5, 96, 23)
    p2, vb = codec.pack_codes(codes)
    clf = pipeline.Classifier(db, ClassifyConfig(extended=True),
                              mesh=mesh.make_mesh(2, 4, CPU8))
    wires = clf._put_wire((p2, vb))
    assert [w[0][0].shape[0] for w in wires] == [2, 2, 2, 2]
    res, lab = clf._device_step(wires)
    res = np.concatenate([b.numpy() for b in res])
    lab = np.concatenate([b.numpy() for b in lab])
    assert res.shape[0] == 8 and not res[5:].any() and not lab[5:].any()
    assert res[:5, 0].sum() > 0
    names = [f"r{i}" for i in range(5)]
    rows = list(clf._emit_np(res, lab, names, np.full(8, 96), 5, False))
    assert [r["name"] for r in rows] == names


def test_mesh_shapes_and_errors():
    m = mesh.make_mesh(2, devices=CPU8)
    assert m.shape == {"data": 4, "db": 2}
    assert mesh.make_global_mesh(4, CPU8).shape == {"data": 2, "db": 4}
    with pytest.raises(ValueError, match="host-spanning db axis"):
        mesh.make_global_mesh(3, CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(3, devices=CPU8)
    with pytest.raises(ValueError, match="do not make"):
        mesh.make_mesh(2, 3, CPU8)
    with pytest.raises(ValueError, match="not divisible by db=4"):
        mesh.shard_rows(np.zeros((6, 8), np.uint32), mesh.make_mesh(4, 2,
                                                                   CPU8))
    with pytest.raises(ValueError, match="not divisible by data=4"):
        mesh.place_wire(m, np.zeros((6, 4), np.uint8),
                        np.zeros((6, 2), np.uint8))
    with pytest.raises(ValueError, match="part rows"):
        mesh.build_sharded_probe_part(mesh.make_mesh(4, 2, CPU8), k=K,
                                      spec=hashdb.TableSpec("q4", 17),
                                      nb_part=6)


# (num_data, num_db) of the fused route's meshes
FUSED_SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2)]


@functools.lru_cache(maxsize=None)
def _fused_case(layout, k, L):
    """tests/test_torch_cuda.fused_case's table and 48 reads of L bases,
    and the wire batch of the reads."""
    db, codes = fused_case(k, L, layout)
    return db, codes, codec.pack_codes(codes)


def _counting(monkeypatch):
    """Count the calls of the wrappers a mesh step can take (patched
    before the step is built, which looks them up)."""
    calls = collections.Counter()
    for mod, name in ((probe, "query_part_labels"),
                      (probe, "query_score_part_results"),
                      (score, "score_labels")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _jax_sharded_results(db, p2, vb, num_data, num_db):
    """cuclark_tpu.parallel.mesh.build_sharded_classify(with_labels=False)
    on a num_data x num_db mesh of the XLA CPU devices."""
    jm = jmesh.make_mesh(num_db=num_db, num_data=num_data,
                         devices=jax.devices()[:num_data * num_db])
    main_np, stash_np = db.split_tables()
    nbs = stash_np.shape[0] if stash_np is not None else 0
    jstep = jmesh.build_sharded_classify(
        jm, k=db.k, nb_bits=db.nb_bits, slots=db.slots,
        num_choices=db.num_choices, layout=db.layout, seed=db.seed,
        stash_bits=db.stash_bits, nb_total=main_np.shape[0], nbs_total=nbs,
        with_labels=False)
    rows_sh, data_sh = P("db", None), P("data", None)
    args = [_jax_put(jm, main_np, rows_sh)]
    if nbs:
        args.append(_jax_put(jm, stash_np, rows_sh))
    (res,) = jstep(*args, _jax_put(jm, p2, data_sh), _jax_put(jm, vb, data_sh))
    return np.asarray(res)


def _port_sharded(db, p2, vb, m, **kw):
    main_np, stash_np = db.split_tables()
    main, stash = mesh.shard_db_table(db, m)
    step = mesh.build_sharded_classify(
        m, k=db.k, spec=db.spec, nb_total=main_np.shape[0],
        nbs_total=stash_np.shape[0] if stash_np is not None else 0, **kw)
    return step(main, stash, mesh.place_wire(m, p2, vb))


@pytest.mark.parametrize("k", [27, 31, 32])
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("handles", ["same", "mixed"])
@pytest.mark.parametrize("num_data,num_db", FUSED_SHAPES)
def test_fused_sharded_step_matches_jax(num_data, num_db, handles, layout, k,
                                        monkeypatch):
    """Without labels, a batch of one-tile reads (150 bp, P 121-126) ends
    each data block in the fused range launch (num_db - 1 range calls and
    one fused call a block, no score call), and the results equal the JAX
    package's build_sharded_classify(with_labels=False) on a mesh of the
    same shape, and the port's step with labels."""
    db, codes, (p2, vb) = _fused_case(layout, k, 152)
    m = mesh.make_mesh(num_db, num_data,
                       HANDLES[handles][:num_data * num_db])
    calls = _counting(monkeypatch)
    res, lab = _port_sharded(db, p2, vb, m, with_labels=False)
    assert lab is None and len(res) == num_data
    assert calls == {"query_part_labels": (num_db - 1) * num_data,
                     "query_score_part_results": num_data} or (
        num_db == 1 and calls == {"query_score_part_results": num_data})
    got = np.concatenate([b.numpy() for b in res])
    np.testing.assert_array_equal(
        got, _jax_sharded_results(db, p2, vb, num_data, num_db))
    two, _ = _port_sharded(db, p2, vb, m)
    np.testing.assert_array_equal(got, np.concatenate([b.numpy()
                                                       for b in two]))
    assert (got[8:, 2] > 0).all()


# (P, k, L): the fused route's edges (one window, one tile, two tiles,
# the joined pairs' three, the widest) and the first width past it
EDGE_P = [(1, 32, 32), (122, 31, 152), (128, 25, 152), (129, 24, 152),
          (290, 31, 320), (1024, 25, 1048), (1025, 32, 1056)]


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("P_,k,L", EDGE_P)
def test_sharded_step_route_by_width(P_, k, L, layout, monkeypatch):
    """On a 2 x 2 mesh of mixed handles, rows of 1 to 1,024 windows take
    the fused range launch and 1,025 the range launches, the sum and the
    score; the results equal the JAX package's either way."""
    db, codes, (p2, vb) = _fused_case(layout, k, L)
    assert 4 * p2.shape[1] - k + 1 == P_
    m = mesh.make_mesh(2, 2, MIXED8[:4])
    calls = _counting(monkeypatch)
    res, _ = _port_sharded(db, p2, vb, m, with_labels=False)
    fused = P_ <= kernels.QUERY_SCORE_MAX_WINDOWS
    assert calls == ({"query_part_labels": 2, "query_score_part_results": 2}
                     if fused else {"query_part_labels": 4,
                                    "score_labels": 2})
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in res]),
                                  _jax_sharded_results(db, p2, vb, 2, 2))


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("handles", ["same", "mixed"])
@pytest.mark.parametrize("num_data,num_db", [(2, 2), (1, 4)])
def test_fused_stream_last_part_matches_jax(num_data, num_db, handles,
                                            layout, monkeypatch):
    """The sharded part step over 4 parts (the stash on part 0), the last
    part ending each block in the fused range launch (scored=True),
    against the JAX package's build_sharded_probe_part on each part,
    summed, then cuclark_tpu.score.score_labels."""
    db, codes, (p2, vb) = _fused_case(layout, 31, 152)
    m = mesh.make_mesh(num_db, num_data, HANDLES[handles][:num_data * num_db])
    jm = jmesh.make_mesh(num_db=num_db, num_data=num_data,
                         devices=jax.devices()[:num_data * num_db])
    main_np, stash_np = db.split_tables()
    nbs = stash_np.shape[0] if stash_np is not None else 0
    jkw = dict(k=db.k, nb_bits=db.nb_bits, slots=db.slots,
               num_choices=db.num_choices, layout=db.layout, seed=db.seed,
               stash_bits=db.stash_bits)
    rows_sh, data_sh = P("db", None), P("data", None)
    jp2, jvb = _jax_put(jm, p2, data_sh), _jax_put(jm, vb, data_sh)
    parts = 4
    rows = main_np.shape[0] // parts
    jpart = jmesh.build_sharded_probe_part(jm, nb_part=rows,
                                           skip_stash=bool(nbs), **jkw)
    jpart0 = (jmesh.build_sharded_probe_part(jm, nb_part=rows,
                                             with_stash=True, **jkw)
              if nbs else jpart)
    jstash = _jax_put(jm, stash_np, rows_sh) if nbs else None
    want = 0
    for p in range(parts):
        jp = _jax_put(jm, main_np[p * rows:(p + 1) * rows], rows_sh)
        if p == 0 and nbs:
            (lab,) = jpart0(jp, jstash, jp2, jvb, jnp.int32(0))
        else:
            (lab,) = jpart(jp, jp2, jvb, jnp.int32(p * rows))
        want = want + np.asarray(lab)
    want = np.asarray(jscore.score_labels(jnp.asarray(want)))

    _, stash = mesh.shard_db_table(db, m)
    wires = mesh.place_wire(m, p2, vb)
    calls = _counting(monkeypatch)
    pstep = mesh.build_sharded_probe_part(m, k=db.k, spec=db.spec,
                                          nb_part=rows)
    acc = None
    for p in range(parts - 1):
        acc = pstep(mesh.shard_rows(main_np[p * rows:(p + 1) * rows], m),
                    wires, p * rows, stash=stash if p == 0 else None,
                    acc=acc)
    res = pstep(mesh.shard_rows(main_np[(parts - 1) * rows:], m), wires,
                (parts - 1) * rows, acc=acc, scored=True)
    assert calls == {"query_part_labels": (parts * num_db - 1) * num_data,
                     "query_score_part_results": num_data}
    np.testing.assert_array_equal(np.concatenate([b.numpy() for b in res]),
                                  want)


def _pairs_files(tmp, genomes, n, seed):
    """n FASTQ pairs of 150 bp mates from 400 bp fragments of the genomes
    (mate 2 reverse-complemented; joined, 301 bases in the 320 bin: P =
    300 at K = 21, three tiles), an N in every 5th fragment."""
    rng = random.Random(seed)
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = tmp / "r1.fq", tmp / "r2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(n):
            g = genomes[rng.randrange(len(genomes))]
            pos = rng.randrange(0, len(g) - 400)
            frag = list(g[pos:pos + 400])
            if i % 5 == 0:
                frag[rng.randrange(400)] = "N"
            m1 = "".join(frag[:150])
            m2 = "".join(frag[250:]).translate(comp)[::-1]
            f1.write(f"@p{i}/1\n{m1}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}/2\n{m2}\n+\n{'I' * 150}\n")
    return r1, r2


@pytest.mark.parametrize("streamed", [False, True])
def test_mesh_classifier_paired_matches_resident(dbs, tmp_path, streamed,
                                                 monkeypatch):
    """Classifier on a 2 x 2 mesh of CPU handles on paired reads (three
    tiles a pair), resident and streamed in parts: every batch's blocks
    end in the fused range launch, no score call runs, and the CSV equals
    the single-device resident CSV and the JAX package's."""
    db, jdb, genomes = dbs
    r1, r2 = _pairs_files(tmp_path, genomes, 37, 41)
    budget = db.table.nbytes / 2 / 4 / 1e6 if streamed else None
    cfg = ClassifyConfig(batch_reads=16, stream_group=2, max_table_mb=budget)
    single = tmp_path / "single.csv"
    pipeline.Classifier(db, ClassifyConfig(batch_reads=16),
                        device="cpu").classify_file_to_csv(str(r1), single,
                                                           str(r2))
    calls = _counting(monkeypatch)
    clf = pipeline.Classifier(db, cfg, mesh=mesh.make_mesh(2, 2, CPU8[:4]))
    assert (clf.stream_parts > 1) == streamed
    out = tmp_path / "mesh.csv"
    assert clf.classify_file_to_csv(str(r1), out, str(r2)) == 37
    batches = 3
    assert calls["query_score_part_results"] == batches * 2
    assert calls["score_labels"] == 0
    assert calls["query_part_labels"] == batches * 2 * (
        clf.stream_parts * 2 - 1)
    jout = tmp_path / "jax.csv"
    jpipeline.Classifier(jdb, JClassifyConfig(batch_reads=16)
                         ).classify_file_to_csv(str(r1), jout, str(r2))
    assert out.read_bytes() == single.read_bytes() == jout.read_bytes()


def _short_reads_file(path, genomes, n, seed):
    """n FASTQ reads of 80-127 bases (the 128 bin: one tile at K = 21),
    Ns in every 5th."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            g = genomes[rng.randrange(len(genomes))]
            ln = rng.randint(80, 127)
            pos = rng.randrange(0, len(g) - ln)
            seq = list(g[pos:pos + ln])
            if i % 5 == 0:
                seq[rng.randrange(ln)] = "N"
            f.write(f"@s{i}\n{''.join(seq)}\n+\n{'I' * ln}\n")
    return path


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("num_db,num_data", [(1, 1), (2, 2), (4, 2)])
def test_mesh_classifier_fused_matches_jax(dbs, tmp_path, num_db, num_data,
                                           streamed, monkeypatch):
    """Classifier(mesh=...) on one-tile reads, resident and streamed in
    parts, ends every batch's blocks in the fused launch and writes the
    JAX package's CSV (a 1 x 1 mesh: one fused call a batch)."""
    db, jdb, genomes = dbs
    reads = _short_reads_file(tmp_path / "short.fq", genomes, 53, 37)
    budget = db.table.nbytes / num_db / 4 / 1e6 if streamed else None
    cfg = ClassifyConfig(batch_reads=16, stream_group=2, max_table_mb=budget)
    calls = _counting(monkeypatch)
    clf = pipeline.Classifier(db, cfg, mesh=mesh.make_mesh(
        num_db, num_data, CPU8[:num_db * num_data]))
    assert (clf.stream_parts > 1) == streamed
    out = tmp_path / "mesh.csv"
    assert clf.classify_file_to_csv(str(reads), out) == 53
    batches = 4
    assert calls["query_score_part_results"] == batches * num_data
    assert calls["score_labels"] == 0
    assert calls["query_part_labels"] == batches * num_data * (
        clf.stream_parts * num_db - 1)
    jout = tmp_path / "jax.csv"
    jpipeline.Classifier(jdb, JClassifyConfig(batch_reads=16)
                         ).classify_file_to_csv(str(reads), jout)
    assert out.read_bytes() == jout.read_bytes()
