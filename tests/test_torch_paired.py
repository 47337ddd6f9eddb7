"""Paired-end classify of the port against the JAX package on the CPU
(tests/test_paired.py): mate-id and record-count errors, direct and list
mode, and paired combined with --extended and DB streaming, each held to
`cuclark-tpu classify`'s CSV bytes."""

import random

import pytest

from cuclark_tpu import cli as jcli
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu.config import ClassifyConfig as JClassifyConfig
from cuclark_tpu.hashdb import KmerDB as JKmerDB
from cuclark_tpu.io import fasta as jfasta
from cuclark_tpu_torch import cli, pipeline
from cuclark_tpu_torch.config import ClassifyConfig
from cuclark_tpu_torch.hashdb import KmerDB
from cuclark_tpu_torch.io import fasta


@pytest.fixture(scope="module")
def paired_demo(tmp_path_factory):
    """Two genomes, 40 pairs of mates (80 and 60-90 bases, mate 2 from
    120 bases on), a DB built by each package."""
    tmp = tmp_path_factory.mktemp("torch_paired")
    rng = random.Random(7)
    lines = []
    genomes = []
    for t in (1, 2):
        g = "".join(rng.choice("ACGT") for _ in range(3000))
        genomes.append(g)
        (tmp / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp / f'g{t}.fa'} T{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    r1, r2 = [], []
    for i in range(40):
        g = genomes[i % 2]
        pos = rng.randrange(0, 2700)
        r1.append((f"p{i}", g[pos: pos + 80]))
        r2.append((f"p{i}", g[pos + 120: pos + 180 + rng.randrange(31)]))
    for mate, rr in ((1, r1), (2, r2)):
        (tmp / f"r{mate}.fq").write_text("".join(
            f"@{n}/{mate}\n{s}\n+\n{'I' * len(s)}\n" for n, s in rr))
    build = ["build-db", "-T", str(tmp / "targets.txt"), "-k", "21"]
    assert jcli.main(build + ["-D", str(tmp / "jdb")]) == 0
    assert cli.main(build + ["-D", str(tmp / "tdb")]) == 0
    return tmp


def _classify_both(tmp, out_dir, flags):
    """(JAX CSV bytes, port CSV bytes) of `classify <flags> -R <out>`."""
    jout, out = out_dir / "jax.csv", out_dir / "torch.csv"
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), "-R", str(jout),
                      *flags]) == 0
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-R", str(out),
                     "--device", "cpu", *flags]) == 0
    return jout.read_bytes(), out.read_bytes()


def test_mate_id_separators():
    for name in ("read1/1", "read1/2", "read1 extra", "read1\tx", "read1"):
        assert fasta.mate_id(name) == jfasta.mate_id(name) == "read1"


@pytest.mark.parametrize("r2,match", [
    ("@a/2\nTTTT\n+\nIIII\n@c/2\nTTTT\n+\nIIII\n", "read id does not match"),
    ("@a/2\nTTTT\n+\nIIII\n", "different record counts"),
])
def test_read_paired_records_errors(tmp_path, r2, match):
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    p1.write_text("@a/1\nACGT\n+\nIIII\n@b/1\nACGT\n+\nIIII\n")
    p2.write_text(r2)
    with pytest.raises(ValueError, match=match):
        list(fasta.read_paired_records(p1, p2))


@pytest.mark.parametrize("edit", ["id", "count"])
def test_cli_paired_mismatch_is_an_error(paired_demo, tmp_path, capsys,
                                         edit):
    """A mate id that differs, or a mate file one record short, is an
    error (rc 1) in both packages, and the port writes no CSV."""
    tmp = paired_demo
    bad = tmp_path / "bad2.fq"
    lines = (tmp / "r2.fq").read_text().splitlines()
    if edit == "id":
        lines[4] = "@WRONG/2"
    else:
        lines = lines[:-4]
    bad.write_text("\n".join(lines) + "\n")
    flags = ["-P", str(tmp / "r1.fq"), str(bad)]
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), *flags,
                      "-R", str(tmp_path / "jax.csv")]) == 1
    jerr = capsys.readouterr().err
    assert cli.main(["classify", "-D", str(tmp / "tdb"), *flags, "--device",
                     "cpu", "-R", str(tmp_path / "torch.csv")]) == 1
    err = capsys.readouterr().err
    assert err == jerr and err.startswith("error: ")
    assert not (tmp_path / "torch.csv").exists()


@pytest.mark.parametrize("flags", [
    [],
    ["-b", "7"],
    ["--extended"],
    ["--max-table-mb", "2"],
    ["--extended", "--max-table-mb", "2", "--stream-group", "2", "-b", "16"],
])
def test_cli_paired_direct_matches_jax(paired_demo, tmp_path, flags):
    tmp = paired_demo
    want, got = _classify_both(
        tmp, tmp_path, ["-P", str(tmp / "r1.fq"), str(tmp / "r2.fq"),
                        *flags])
    assert got == want
    rows = got.decode().splitlines()
    assert len(rows) == 41
    assert sum(r.split(",")[-5] == f"T{i % 2 + 1}"
               for i, r in enumerate(rows[1:])) >= 38


def test_cli_paired_list_mode_matches_jax(paired_demo, tmp_path):
    tmp = paired_demo
    l1, l2 = tmp_path / "list1.txt", tmp_path / "list2.txt"
    l1.write_text(f"{tmp / 'r1.fq'}\n{tmp / 'r1.fq'}\n")
    l2.write_text(f"{tmp / 'r2.fq'}\n{tmp / 'r2.fq'}\n")
    for pkg in ("jax", "torch"):
        (tmp_path / f"{pkg}.list").write_text("".join(
            f"{tmp_path / f'{pkg}{i}.csv'}\n" for i in (0, 1)))
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), "-P", str(l1),
                      str(l2), "-R", str(tmp_path / "jax.list")]) == 0
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-P", str(l1),
                     str(l2), "-R", str(tmp_path / "torch.list"),
                     "--device", "cpu"]) == 0
    for i in (0, 1):
        got = (tmp_path / f"torch{i}.csv").read_bytes()
        assert got == (tmp_path / f"jax{i}.csv").read_bytes()
        rows = got.decode().splitlines()
        assert len(rows) == 41
        # paired normalization: length excludes the joining N
        assert rows[1].split(",")[1] == str(80 + len(
            (tmp / "r2.fq").read_text().splitlines()[1]))


def test_cli_paired_resume_completes_csv(paired_demo, tmp_path):
    tmp = paired_demo
    flags = ["-P", str(tmp / "r1.fq"), str(tmp / "r2.fq")]
    want, _ = _classify_both(tmp, tmp_path, flags)
    out = tmp_path / "resumed.csv"
    out.write_bytes(want[:len(want) // 3])
    assert cli.main(["classify", "-D", str(tmp / "tdb"), *flags, "-R",
                     str(out), "--resume", "--device", "cpu"]) == 0
    assert out.read_bytes() == want


@pytest.mark.parametrize("max_table_mb", [None, 2.0])
def test_paired_row_iterators_match_jax(paired_demo, max_table_mb):
    """classify_file with a mate file, and classify_records on merged
    pairs, yield the JAX package's rows, resident and streamed."""
    tmp = paired_demo
    db = KmerDB.load(next((tmp / "tdb").glob("db_k*.npz")))
    jdb = JKmerDB.load(next((tmp / "jdb").glob("db_k*.npz")))
    clf = pipeline.Classifier(db, ClassifyConfig(
        batch_reads=16, extended=True, max_table_mb=max_table_mb),
        device="cpu")
    assert (clf.stream_parts > 1) == (max_table_mb is not None)
    jclf = jpipeline.Classifier(jdb, JClassifyConfig(batch_reads=16,
                                                     extended=True))
    r1, r2 = str(tmp / "r1.fq"), str(tmp / "r2.fq")
    assert list(clf.classify_file(r1, r2, skip=5)) == list(
        jclf.classify_file(r1, r2, skip=5))
    recs = list(fasta.read_paired_records(r1, r2))
    assert list(clf.classify_records(iter(recs), paired=True)) == list(
        jclf.classify_records(iter(recs), paired=True))
