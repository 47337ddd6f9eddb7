"""DB-part streaming of the port against the JAX package on the CPU: the
part query (`probe.query_part_labels`) against
`cuclark_tpu.pipeline.probe_part_step` part by part, and the streamed
`Classifier` (rows, CSV bytes, extended output, the record iterator, the
CLI) against the JAX package's resident and streamed runs.  Every
comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import cli as jcli
from cuclark_tpu import codec as jcodec
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu.config import ClassifyConfig as JClassifyConfig
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu.db_build.builder import build_db as jbuild_db
from cuclark_tpu_torch import cli, hashdb, pipeline, probe
from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
from cuclark_tpu_torch.db_build.builder import build_db

K = 31


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_streaming.py's three genomes and 70 reads, a DB built
    by each package, and the targets file for the CLI."""
    tmp = tmp_path_factory.mktemp("torch_stream")
    rng = random.Random(21)
    genomes, file_labels, lines = {}, [], []
    for t in (1, 2, 3):
        g = "".join(rng.choice("ACGT") for _ in range(3000))
        genomes[t] = g
        p = tmp / f"g{t}.fa"
        p.write_text(f">g{t}\n{g}\n")
        file_labels.append((str(p), f"T{t}"))
        lines.append(f"{p} T{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    db = build_db(file_labels, DBConfig(k=21))
    jdb = jbuild_db(file_labels, JDBConfig(k=21))
    assert db.checksum() == jdb.checksum()
    reads = []
    for i in range(70):
        t = rng.randrange(1, 4)
        pos = rng.randrange(0, 2900 - 100)
        reads.append((f"r{i}", genomes[t][pos: pos + 100].encode()))
    fq = tmp / "reads.fq"
    fq.write_text("".join(
        f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n" for n, s in reads))
    return tmp, db, jdb, reads, fq


def _streaming(db, div: float, **kw) -> pipeline.Classifier:
    """A CPU Classifier whose budget is 1/div of the table."""
    clf = pipeline.Classifier(db, ClassifyConfig(
        max_table_mb=db.table.nbytes / div / 1e6, **kw), device="cpu")
    assert clf.stream_parts >= 4 and clf.table is None
    return clf


def test_streaming_matches_resident(setup):
    _, db, jdb, _, fq = setup
    want = list(jpipeline.Classifier(
        jdb, JClassifyConfig(batch_reads=16)).classify_file(fq))
    got = list(_streaming(db, 4, batch_reads=16,
                          stream_group=2).classify_file(fq))
    assert got == want
    resident = pipeline.Classifier(db, ClassifyConfig(batch_reads=16),
                                   device="cpu")
    assert resident.stream_parts == 1
    assert list(resident.classify_file(fq)) == want


def test_streaming_records_path(setup):
    _, db, jdb, reads, _ = setup
    want = list(jpipeline.Classifier(
        jdb, JClassifyConfig(batch_reads=32)).classify_records(iter(reads)))
    got = list(_streaming(db, 4, batch_reads=32).classify_records(
        iter(reads)))
    assert got == want


def test_streaming_extended(setup):
    _, db, jdb, _, fq = setup
    want = list(jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=True)).classify_file(fq))
    got = list(_streaming(db, 4, batch_reads=16,
                          extended=True).classify_file(fq, skip=0))
    assert got == want
    assert all("target_counts" in r for r in got)


@pytest.mark.parametrize("extended", [False, True])
def test_streaming_csv_matches_jax(setup, tmp_path, extended):
    """The native CSV writer on the streamed path writes the JAX
    package's resident and streamed bytes."""
    _, db, jdb, _, fq = setup
    jres, jstr, out = (tmp_path / n for n in ("jres.csv", "jstr.csv",
                                               "torch.csv"))
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended)).classify_file_to_csv(fq, jres)
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended,
        max_table_mb=jdb.table.nbytes / 4e6,
        stream_group=2)).classify_file_to_csv(fq, jstr)
    clf = _streaming(db, 4, batch_reads=16, extended=extended,
                     stream_group=2)
    assert clf.classify_file_to_csv(fq, out) == 70
    assert out.read_bytes() == jres.read_bytes() == jstr.read_bytes()


def test_streaming_csv_without_native_module(setup, tmp_path, monkeypatch,
                                             capsys):
    """The per-row fallback writes the native path's bytes on the
    streamed path too, with the reference's extended hit stats."""
    from cuclark_tpu_torch import native

    _, db, _, _, fq = setup
    want = tmp_path / "native.csv"
    _streaming(db, 4, batch_reads=16, extended=True).classify_file_to_csv(
        fq, want)
    native_stats = capsys.readouterr().err
    monkeypatch.setattr(native, "available", lambda: False)
    out = tmp_path / "rows.csv"
    assert _streaming(db, 4, batch_reads=16,
                      extended=True).classify_file_to_csv(fq, out) == 70
    assert out.read_bytes() == want.read_bytes()
    err = capsys.readouterr().err
    assert "MIN targets:" in err and err == native_stats


@pytest.mark.parametrize("flags", [
    ["--max-table-mb", "2"],
    ["--max-table-mb", "1", "--stream-group", "1", "-b", "16"],
    ["--max-table-mb", "2", "--extended"],
])
def test_cli_streamed_csv_matches_jax(setup, tmp_path, capsys, flags):
    tmp, _, _, _, fq = setup
    jout, out = tmp_path / "jax.csv", tmp_path / "torch.csv"
    targets = ["-T", str(tmp / "targets.txt"), "-k", "21"]
    assert jcli.main(["classify", "-D", str(tmp_path / "jdb"), "-O",
                      str(fq), "-R", str(jout), *targets, *flags]) == 0
    capsys.readouterr()
    assert cli.main(["classify", "-D", str(tmp_path / "tdb"), "-O", str(fq),
                     "-R", str(out), "--device", "cpu", *targets,
                     *flags]) == 0
    assert "bucket-range parts (--max-table-mb" in capsys.readouterr().err
    assert out.read_bytes() == jout.read_bytes()


@pytest.fixture(scope="module")
def wide_reads(setup):
    """Reads of the 320 bin from the setup's genomes: 40 pairs of 150 bp
    mates from 400 bp fragments (mate 2 reverse-complemented; joined with
    an N, 301 bases: P = 300 at k = 21, three tiles) and 40 single-end
    reads of 300 bp, an N in every 7th."""
    tmp = setup[0]
    genomes = [(tmp / f"g{t}.fa").read_text().split("\n")[1]
               for t in (1, 2, 3)]
    comp = str.maketrans("ACGT", "TGCA")
    rng = random.Random(5)
    files = {n: tmp / f"{n}.fq" for n in ("r1", "r2", "long")}
    recs = {n: [] for n in files}
    for i in range(40):
        g = genomes[rng.randrange(3)]
        pos = rng.randrange(0, len(g) - 400)
        frag = list(g[pos:pos + 400])
        if i % 7 == 0:
            frag[rng.randrange(400)] = "N"
        m2 = "".join(frag[250:]).translate(comp)[::-1]
        recs["r1"].append((f"p{i}/1", "".join(frag[:150])))
        recs["r2"].append((f"p{i}/2", m2))
        recs["long"].append((f"l{i}", "".join(frag[:300])))
    for n, path in files.items():
        path.write_text("".join(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
                                for name, seq in recs[n]))
    return files


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("reads", ["paired", "300bp"])
def test_streaming_wide_reads_csv_matches_jax(setup, wide_reads, tmp_path,
                                              monkeypatch, reads, extended):
    """Paired 2 x 150 bp reads and single-end 300 bp reads (the 320 bin,
    three tiles), streamed in 4 parts on one device: without --extended
    each batch's last part is the fused range launch
    (`probe.query_score_part_results`, with the earlier parts' sum) and
    no score call runs; with it, the part query and the score.  The CSV
    equals the JAX package's resident and streamed bytes."""
    from cuclark_tpu_torch import score

    _, db, jdb, _, _ = setup
    path, mate = ((wide_reads["r1"], wide_reads["r2"]) if reads == "paired"
                  else (wide_reads["long"], None))
    jres, jstr, out = (tmp_path / n for n in ("jres.csv", "jstr.csv",
                                               "torch.csv"))
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended)).classify_file_to_csv(
        path, jres, mate)
    jpipeline.Classifier(jdb, JClassifyConfig(
        batch_reads=16, extended=extended,
        max_table_mb=jdb.table.nbytes / 4e6,
        stream_group=2)).classify_file_to_csv(path, jstr, mate)
    calls = {"query_score_part_results": 0, "score_labels": 0}
    for mod, name in ((probe, "query_score_part_results"),
                      (score, "score_labels")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    clf = _streaming(db, 4, batch_reads=16, extended=extended,
                     stream_group=2)
    assert clf.classify_file_to_csv(path, out, mate) == 40
    assert out.read_bytes() == jres.read_bytes() == jstr.read_bytes()
    batches = 3
    assert calls == ({"query_score_part_results": 0, "score_labels": batches}
                     if extended else
                     {"query_score_part_results": batches, "score_labels": 0})


def test_effective_stream_group(setup, monkeypatch):
    """At least cfg.stream_group, grown to fill the device budget, capped
    at 512 unless the configured group is larger ("NOT np.clip")."""
    _, db, _, _, _ = setup
    monkeypatch.setenv("CUCLARK_DEVICE_MB", "1e9")
    assert _streaming(db, 4).stream_group_eff == 512
    assert _streaming(db, 4, stream_group=600).stream_group_eff == 600
    monkeypatch.setenv("CUCLARK_DEVICE_MB", "100")
    assert _streaming(db, 4, stream_group=3).stream_group_eff == 3
    monkeypatch.delenv("CUCLARK_DEVICE_MB")
    assert _streaming(db, 4, stream_group=5).stream_group_eff == 5


def test_plan_parts_takes_stash_and_double_buffer(setup):
    """The plan halves the budget left after the resident stash when it
    streams at all, as cuclark_tpu.pipeline.Classifier._plan_parts."""
    _, db, _, _, _ = setup
    main, stash = db.split_tables()
    stash_mb = stash.nbytes / 1e6
    for parts in (2, 4, 8):
        # a little over one part's worth left over the stash: streaming
        # halves it, so each part must be half that size
        budget = stash_mb + 1.01 * main.nbytes / parts / 1e6
        clf = pipeline.Classifier(db, ClassifyConfig(max_table_mb=budget),
                                  device="cpu")
        assert clf.stream_parts == 2 * parts
    clf = pipeline.Classifier(db, ClassifyConfig(
        max_table_mb=stash_mb + main.nbytes / 1e6), device="cpu")
    assert clf.stream_parts == 1 and clf.table is not None


# ---------- the part query against probe_part_step ----------


@pytest.fixture(scope="module")
def part_case():
    """A qs table of 300,000 31-mers at nb_bits 17 (the overflow fills the
    stash) and 96 reads of 152 bases with stored k-mers planted, Ns and
    an all-N tail."""
    rng = np.random.default_rng(11)
    km = rng.integers(0, 1 << 62, size=301_000, dtype=np.uint64)
    km = np.unique(jcodec.canonical_np(km, K))[:300_000]
    labels = rng.integers(1, 300, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 300)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=K), nb_bits=17)
    R, L = 96, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (K - 1 - np.arange(K, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - K + 1, K):
            codes[r, p:p + K] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = jcodec.INVALID
    codes[1, 70:] = jcodec.INVALID
    p2, vb = jcodec.pack_codes(codes)
    return db, p2, vb


@pytest.mark.parametrize("parts", [2, 4, 16])
def test_query_part_labels_match_probe_part_step(part_case, parts):
    """Part by part, the stash on part 0 only, equal to the JAX part
    step; the parts' sum equals the resident labels, and accumulating
    in place gives the same sum."""
    db, p2, vb = part_case
    main, stash = hashdb.table_to_device(db, "cpu")
    rows = db.nb // parts
    args = dict(k=K, spec=db.spec)
    tp2, tvb = torch.from_numpy(p2), torch.from_numpy(vb)
    total, acc = None, None
    for p in range(parts):
        part = main[p * rows:(p + 1) * rows]
        got = probe.query_part_labels(
            tp2, tvb, part, stash if p == 0 else None, bucket_start=p * rows,
            nb_local=rows, **args)
        want = jpipeline.probe_part_step(
            jnp.asarray(db.table[p * rows:(p + 1) * rows]), jnp.asarray(p2),
            jnp.asarray(vb), jnp.int32(p * rows), k=K, nb_bits=db.nb_bits,
            slots=db.slots, num_choices=db.num_choices, nb_local=rows,
            layout="qs", seed=db.seed, stash_bits=db.stash_bits,
            stash=jnp.asarray(db.table[db.nb:]) if p == 0 else None,
            skip_stash=p > 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        total = got if total is None else total + got
        acc = probe.query_part_labels(
            tp2, tvb, part, stash if p == 0 else None, bucket_start=p * rows,
            nb_local=rows, acc=acc, **args)
    resident = probe.query_labels(tp2, tvb, main, stash, **args)
    assert torch.equal(total, resident) and torch.equal(acc, resident)
    assert int((resident > 0).sum()) > 100


@pytest.mark.parametrize("parts", [2, 4, 16])
def test_stash_split_over_parts_matches_probe_part_step(part_case, parts):
    """The qs stash split over the parts (`probe.stash_range`, as one
    device streams a table): the parts' labels, written and accumulated,
    sum to the JAX part steps' with the stash on part 0 and to the
    resident labels, at the smallest stash_bits (17)."""
    db, p2, vb = part_case
    assert db.stash_bits == 17
    main, stash = hashdb.table_to_device(db, "cpu")
    rows = db.nb // parts
    args = dict(k=K, spec=db.spec)
    tp2, tvb = torch.from_numpy(p2), torch.from_numpy(vb)
    total, acc, want = None, None, None
    for p in range(parts):
        part = main[p * rows:(p + 1) * rows]
        s, sstart = probe.stash_range(stash, p, parts)
        assert s.shape[0] == stash.shape[0] // parts
        assert sstart == p * s.shape[0]
        got = probe.query_part_labels(tp2, tvb, part, s,
                                      bucket_start=p * rows, nb_local=rows,
                                      stash_start=sstart, **args)
        total = got if total is None else total + got
        acc = probe.query_part_labels(tp2, tvb, part, s,
                                      bucket_start=p * rows, nb_local=rows,
                                      stash_start=sstart, acc=acc, **args)
        j = np.asarray(jpipeline.probe_part_step(
            jnp.asarray(db.table[p * rows:(p + 1) * rows]), jnp.asarray(p2),
            jnp.asarray(vb), jnp.int32(p * rows), k=K, nb_bits=db.nb_bits,
            slots=db.slots, num_choices=db.num_choices, nb_local=rows,
            layout="qs", seed=db.seed, stash_bits=db.stash_bits,
            stash=jnp.asarray(db.table[db.nb:]) if p == 0 else None,
            skip_stash=p > 0))
        want = j if want is None else want + j
    np.testing.assert_array_equal(total.numpy(), want)
    resident = probe.query_labels(tp2, tvb, main, stash, **args)
    assert torch.equal(total, resident) and torch.equal(acc, resident)
    assert int((resident > 0).sum()) > 100


def test_stash_range_edges():
    """The whole stash on part 0 where the parts outnumber its rows; no
    stash, no range."""
    stash = torch.zeros((4, 8), dtype=torch.int32)
    assert probe.stash_range(None, 1, 4) == (None, 0)
    s, start = probe.stash_range(stash, 0, 8)
    assert s is stash and start == 0
    assert probe.stash_range(stash, 3, 8) == (None, 0)
    s, start = probe.stash_range(stash, 3, 4)
    assert s.shape == (1, 8) and start == 3


def test_query_part_labels_stash_side(part_case):
    """A part of zeroed main rows answers the stash side alone, and a
    part without the stash answers none of it."""
    db, p2, vb = part_case
    main, stash = hashdb.table_to_device(db, "cpu")
    args = dict(bucket_start=0, nb_local=db.nb, k=K, spec=db.spec)
    tp2, tvb = torch.from_numpy(p2), torch.from_numpy(vb)
    only_stash = probe.query_part_labels(tp2, tvb, torch.zeros_like(main),
                                         stash, **args)
    no_stash = probe.query_part_labels(tp2, tvb, main, None, **args)
    both = probe.query_labels(tp2, tvb, main, stash, k=K, spec=db.spec)
    assert int((only_stash > 0).sum()) > 0
    assert torch.equal(only_stash + no_stash, both)


@pytest.mark.parametrize("start,rows", [(-1, 4), (1 << 17, 1), (0, 3)])
def test_query_part_labels_rejects_bad_range(part_case, start, rows):
    db, p2, vb = part_case
    main, _ = hashdb.table_to_device(db, "cpu")
    with pytest.raises(ValueError, match="part"):
        probe.query_part_labels(
            torch.from_numpy(p2), torch.from_numpy(vb), main[:4], None,
            bucket_start=start, nb_local=rows, k=K, spec=db.spec)
