"""The port's CLARK interop and taxonomy against the JAX package on the
CPU: `io/clark_db.py` and `export-clark`/`import-clark` (.sz/.ky/.lb),
`io/clark_ht.py` and `export-ht`/`import-ht` (.ht text sets),
`taxonomy/ncbi.py`, and `set-targets` with the `.settings` that
`classify` honours.  Each case runs the same seeded inputs through both
packages and requires equal exit codes and output, byte-identical
exported files, and imported databases with the same checksum and
items.  `.settings` records absolute paths, so it is compared as JSON
with each package's directory put back.  Taxonomy dumps are written
into the test's temp dir."""

import contextlib
import gzip
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cuclark_tpu import cli as jcli
from cuclark_tpu import codec as jcodec
from cuclark_tpu.config import DBConfig as JDBConfig
from cuclark_tpu.hashdb import KmerDB as JKmerDB
from cuclark_tpu.hashdb import build_table as jbuild_table
from cuclark_tpu.io import clark_db as jclark_db
from cuclark_tpu.io import clark_ht as jclark_ht
from cuclark_tpu.taxonomy import ncbi as jncbi
from cuclark_tpu.taxonomy import targets as jtargets
from cuclark_tpu_torch import cli
from cuclark_tpu_torch.config import DBConfig
from cuclark_tpu_torch.hashdb import KmerDB, build_table
from cuclark_tpu_torch.io import clark_db, clark_ht
from cuclark_tpu_torch.taxonomy import ncbi, targets

K = 27
SMALL_HTSIZE = 1_000_003


def run(main, argv):
    """main(argv) with stdout and stderr captured -> (rc, out, err)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def assert_same(argv, tmp: Path):
    """argv through both CLIs; {X} in an argument becomes 'j' for the JAX
    package and 't' for the port.  Equal rc, stdout and stderr (with
    each package's paths put back) -> (rc, out, err)."""
    got = []
    for main, x in ((jcli.main, "j"), (cli.main, "t")):
        rc, out, err = run(main, [a.replace("{X}", x) for a in argv])
        got.append((rc, out.replace(f"{tmp}/{x}_", "{X}_"),
                    err.replace(f"{tmp}/{x}_", "{X}_")))
    assert got[1] == got[0]
    return got[1]


def _db_file(d: Path) -> Path:
    return next(d.glob("db_k*.npz"))


def _sorted_items(db):
    km, lab = db.items()
    o = np.argsort(km)
    return km[o], lab[o]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three random genomes (numpy seed 9) with targets.txt, reads from
    them, a qs database built by the port and its CSV of the reads."""
    tmp = tmp_path_factory.mktemp("torch_interop")
    rng = np.random.default_rng(9)
    seqs = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2500)]
            .tobytes().decode() for _ in range(3)]
    lines = []
    for t, g in enumerate(seqs, 1):
        p = tmp / f"g{t}.fa"
        p.write_text(f">g{t}\n{g}\n")
        lines.append(f"{p} S{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    src = rng.integers(0, 3, 40)
    pos = rng.integers(0, 2400, 40)
    (tmp / "r.fq").write_text("".join(
        f"@r{i}\n{seqs[s][p:p + 100]}\n+\n{'I' * 100}\n"
        for i, (s, p) in enumerate(zip(src, pos))))
    assert run(cli.main, ["build-db", "-T", str(tmp / "targets.txt"), "-D",
                          str(tmp / "db"), "-k", str(K)])[0] == 0
    assert run(cli.main, ["classify", "-D", str(tmp / "db"), "-O",
                          str(tmp / "r.fq"), "-R", str(tmp / "a.csv"),
                          "--device", "cpu"])[0] == 0
    return tmp


def _table(layout: str, seed: int = 3, n: int = 20000):
    """A table of n random canonical 31-mers with labels 1..499, built by
    the port, and the arrays it was built from."""
    rng = np.random.default_rng(seed)
    km = np.unique(jcodec.canonical_np(
        rng.integers(0, 1 << 62, size=n, dtype=np.uint64), 31))
    lab = rng.integers(1, 500, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 500)]
    db = build_table(km, lab, names, DBConfig(k=31, layout=layout))
    return km, lab, names, db


@pytest.mark.parametrize("k", [11, 20, 21, 23, 24, 27, 28, 29, 31, 32])
@pytest.mark.parametrize("htsize", [clark_db.HTSIZE_FULL,
                                    clark_db.HTSIZE_LIGHT, 97])
def test_key_dtype_matches_jax(k, htsize):
    assert clark_db.key_dtype(k, htsize) == jclark_db.key_dtype(k, htsize)
    assert (clark_db.HTSIZE_FULL, clark_db.HTSIZE_LIGHT) == (
        jclark_db.HTSIZE_FULL, jclark_db.HTSIZE_LIGHT)


@pytest.mark.parametrize("k,htsize", [(27, SMALL_HTSIZE), (31, 7919),
                                      (32, clark_db.HTSIZE_LIGHT)])
def test_clark_arrays_match_jax(tmp_path, k, htsize):
    """export_clark_db writes the JAX package's bytes (u16, u32 and u64
    keys) and import_clark_db reads back the same arrays."""
    rng = np.random.default_rng(k)
    km = np.unique(rng.integers(0, 1 << (2 * k - 1), size=5000,
                                dtype=np.uint64))
    lab = rng.integers(1, 40, size=len(km)).astype(np.uint32)
    assert clark_db.export_clark_db(km, lab, tmp_path / "t", k, htsize) == \
        jclark_db.export_clark_db(km, lab, tmp_path / "j", k, htsize)
    for ext in (".sz", ".ky", ".lb"):
        assert (tmp_path / f"t{ext}").read_bytes() == (
            tmp_path / f"j{ext}").read_bytes()
    got, want = (clark_db.import_clark_db(tmp_path / "t", k),
                 jclark_db.import_clark_db(tmp_path / "j", k))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    o = np.argsort(got[0])
    np.testing.assert_array_equal(got[0][o], km)
    np.testing.assert_array_equal(got[1][o], lab)


def test_clark_export_refusals_match_jax(tmp_path):
    """Over 255 keys in a bucket, a label of 0, or a quotient that
    overflows its keys: both packages refuse before writing a file."""
    full = (np.arange(300, dtype=np.uint64) * np.uint64(97) + np.uint64(5),
            np.ones(300, np.uint32), 27, 97)
    cases = [(full, "exceeds 255"),
             ((np.arange(3, dtype=np.uint64), np.zeros(3, np.uint32), 27,
               97), "1-based"),
             ((np.array([1 << 60], np.uint64), np.ones(1, np.uint32), 20,
               clark_db.HTSIZE_LIGHT), "overflows")]
    for (km, lab, k, hts), msg in cases:
        for mod, x in ((clark_db, "t"), (jclark_db, "j")):
            with pytest.raises(ValueError, match=msg):
                mod.export_clark_db(km, lab, tmp_path / x, k, hts)
        assert not list(tmp_path.iterdir())
    with open(tmp_path / "bad.sz", "wb") as f:
        np.array([2, 0, 1], np.uint8).tofile(f)
    (tmp_path / "bad.ky").write_bytes(b"\0" * 4)
    (tmp_path / "bad.lb").write_bytes(b"\0" * 4)
    for mod in (clark_db, jclark_db):
        with pytest.raises(ValueError, match="inconsistent"):
            mod.import_clark_db(tmp_path / "bad", 27)
        with pytest.raises(ValueError, match="expected 5"):
            mod.import_clark_db(tmp_path / "bad", 27, htsize=5)


@pytest.mark.parametrize("layout,flags", [
    ("qs", ["--light"]), ("qs", ["--htsize", str(SMALL_HTSIZE)]),
    ("q4", ["--htsize", "7919"]), ("s2", ["--htsize", str(SMALL_HTSIZE)])])
def test_export_clark_cli_matches_jax(tmp_path, layout, flags):
    """export-clark of one database by both CLIs: the same .sz/.ky/.lb
    bytes and the same stderr line."""
    _, _, _, db = _table(layout)
    (tmp_path / "db").mkdir()
    db.save(tmp_path / "db" / "db_k31.npz")
    rc, _, err = assert_same(["export-clark", "-D", str(tmp_path / "db"),
                              "-o", str(tmp_path / "{X}_ck"), *flags],
                             tmp_path)
    assert rc == 0 and err.startswith(f"exported {db.num_kmers} 31-mers")
    for ext in (".sz", ".ky", ".lb"):
        assert (tmp_path / f"t_ck{ext}").read_bytes() == (
            tmp_path / f"j_ck{ext}").read_bytes()
    want = clark_db.HTSIZE_LIGHT if "--light" in flags else int(flags[1])
    assert (tmp_path / "t_ck.sz").stat().st_size == want


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_import_clark_cli_matches_jax(tmp_path, layout):
    """import-clark of the same files by both CLIs: tables with the same
    checksum and the exported database's items."""
    km, lab, names, db = _table(layout, seed=5, n=8000)
    clark_db.export_clark_db(*db.items(), tmp_path / "ck", 31,
                             SMALL_HTSIZE)
    (tmp_path / "targets.txt").write_text(
        "".join(f"f{i}.fa {n}\n" for i, n in enumerate(names[1:])))
    flags = ["--layout", layout] + (["--slots", "4"] if layout == "s2"
                                    else [])
    rc, _, err = assert_same(["import-clark", "-i", str(tmp_path / "ck"),
                              "-T", str(tmp_path / "targets.txt"), "-D",
                              str(tmp_path / "{X}_db"), "-k", "31", *flags],
                             tmp_path)
    assert rc == 0 and err.startswith(f"imported {len(km)} 31-mers")
    got = KmerDB.load(_db_file(tmp_path / "t_db"))
    want = JKmerDB.load(_db_file(tmp_path / "j_db"))
    assert got.checksum() == want.checksum()
    assert got.target_names == want.target_names == names
    assert (got.layout, got.nb_bits, got.stash_bits, got.seed) == (
        want.layout, want.nb_bits, want.stash_bits, want.seed)
    for a, b in zip(_sorted_items(got), (km, lab)):
        np.testing.assert_array_equal(a, b)


def test_clark_round_trip_classifies_identically(genomes):
    """build -> export-clark --light -> import-clark -> classify: the
    port's CSV equals the original database's and the JAX package's
    after its own import."""
    tmp = genomes
    for main, x in ((cli.main, "t"), (jcli.main, "j")):
        assert run(main, ["export-clark", "-D", str(tmp / "db"), "-o",
                          str(tmp / f"{x}_ck"), "--light"])[0] == 0
        assert run(main, ["import-clark", "-i", str(tmp / f"{x}_ck"), "-T",
                          str(tmp / "targets.txt"), "-D",
                          str(tmp / f"{x}_db2"), "-k", str(K)])[0] == 0
    assert run(cli.main, ["classify", "-D", str(tmp / "t_db2"), "-O",
                          str(tmp / "r.fq"), "-R", str(tmp / "b.csv"),
                          "--device", "cpu"])[0] == 0
    assert run(jcli.main, ["classify", "-D", str(tmp / "j_db2"), "-O",
                           str(tmp / "r.fq"), "-R",
                           str(tmp / "jb.csv")])[0] == 0
    a = (tmp / "a.csv").read_bytes()
    assert (tmp / "b.csv").read_bytes() == a == (tmp / "jb.csv").read_bytes()
    assert KmerDB.load(_db_file(tmp / "t_db2")).checksum() == JKmerDB.load(
        _db_file(tmp / "j_db2")).checksum()


def test_kmer_strings_match_jax():
    rng = np.random.default_rng(0)
    for k in (1, 9, 27, 31, 32):
        km = rng.integers(0, 1 << (2 * k - 1), size=200, dtype=np.uint64)
        np.testing.assert_array_equal(clark_ht.kmer_strings(km, k),
                                      jclark_ht.kmer_strings(km, k))
    for light in (False, True):
        assert clark_ht.ht_filename("A b", 27, light) == \
            jclark_ht.ht_filename("A b", 27, light)


@pytest.mark.parametrize("light", [False, True])
def test_export_ht_matches_jax(tmp_path, light):
    """export-ht by both CLIs: the same .ht files, byte for byte."""
    km = np.unique(jcodec.canonical_np(np.random.default_rng(9).integers(
        0, 1 << 53, size=3000, dtype=np.uint64), K))
    lab = (np.arange(len(km)) % 3 + 1).astype(np.uint32)
    db = build_table(km, lab, ["NA", "T1", "T2", "T 3"], DBConfig(k=K))
    (tmp_path / "db").mkdir()
    db.save(tmp_path / "db" / f"db_k{K}.npz")
    rc, _, err = assert_same(["export-ht", "-D", str(tmp_path / "db"), "-o",
                              str(tmp_path / "{X}_ht"),
                              *(["--light"] if light else [])], tmp_path)
    assert rc == 0 and "into 3 .ht files" in err
    files = sorted(p.name for p in (tmp_path / "j_ht").iterdir())
    assert sorted(p.name for p in (tmp_path / "t_ht").iterdir()) == files
    assert len(files) == 3
    for name in files:
        assert (tmp_path / "t_ht" / name).read_bytes() == (
            tmp_path / "j_ht" / name).read_bytes()


@pytest.mark.parametrize("min_freq", ["0", "2"])
def test_import_ht_matches_jax(tmp_path, min_freq):
    """import-ht of the same .ht files (counts 1-4) by both CLIs: the
    same tables and names; -t drops counts at or below it."""
    rng = np.random.default_rng(4)
    km = np.unique(jcodec.canonical_np(rng.integers(
        0, 1 << 53, size=4000, dtype=np.uint64), K))
    lab = rng.integers(1, 4, size=len(km)).astype(np.uint32)
    cnt = rng.integers(1, 5, size=len(km))
    names = ["NA", "A", "B", "C"]
    hdir = tmp_path / "ht"
    hdir.mkdir()
    for t in (1, 2, 3):
        sel = lab == t
        body = "".join(f"{int(v)}\t{c}\t{s.decode()}\n" for v, c, s in zip(
            km[sel], cnt[sel], clark_ht.kmer_strings(km[sel], K)))
        (hdir / clark_ht.ht_filename(names[t], K)).write_text(
            f"#Target specific k-mers labeled {names[t]} and appearing "
            f"strictly more than 0 times.\n#IKMER ICOUNT {K}-MER \n#\n"
            + body)
    rc, _, err = assert_same(["import-ht", "-i", str(hdir), "-D",
                              str(tmp_path / "{X}_db"), "-t", min_freq],
                             tmp_path)
    assert rc == 0 and "from .ht" in err
    got = KmerDB.load(_db_file(tmp_path / "t_db"))
    want = JKmerDB.load(_db_file(tmp_path / "j_db"))
    assert got.checksum() == want.checksum() and got.k == K
    assert got.target_names == want.target_names == names
    keep = cnt > int(min_freq)
    for a, b in zip(_sorted_items(got), (km[keep], lab[keep])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(clark_ht.import_ht_dir(hdir, 2)[:3],
                    jclark_ht.import_ht_dir(hdir, 2)[:3]):
        np.testing.assert_array_equal(a, b)


def test_ht_round_trip_matches_jax(genomes):
    """export-ht -> import-ht of a database built from genomes keeps its
    items, in both packages, with equal tables."""
    tmp = genomes
    for main, x in ((cli.main, "t"), (jcli.main, "j")):
        assert run(main, ["export-ht", "-D", str(tmp / "db"), "-o",
                          str(tmp / f"{x}_ht")])[0] == 0
        assert run(main, ["import-ht", "-i", str(tmp / f"{x}_ht"), "-D",
                          str(tmp / f"{x}_htdb")])[0] == 0
    db = KmerDB.load(_db_file(tmp / "db"))
    got = KmerDB.load(_db_file(tmp / "t_htdb"))
    assert got.checksum() == JKmerDB.load(_db_file(tmp / "j_htdb")).checksum()
    for a, b in zip(_sorted_items(got), _sorted_items(db)):
        np.testing.assert_array_equal(a, b)


def write_taxonomy(d: Path, gz: bool = False) -> None:
    """A tiny NCBI taxonomy: root 1, phylum 2, genera 10 and 20, species
    11, 12 and 21; taxid 99 merged into 21.  gz: gzipped dumps."""
    files = {
        "nodes.dmp": "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tphylum\t|\n"
                     "10\t|\t2\t|\tgenus\t|\n11\t|\t10\t|\tspecies\t|\n"
                     "12\t|\t10\t|\tspecies\t|\n20\t|\t2\t|\tgenus\t|\n"
                     "21\t|\t20\t|\tspecies\t|\n",
        "names.dmp": "2\t|\tFirmi\t|\t\t|\tscientific name\t|\n"
                     "10\t|\tGenusA\t|\t\t|\tscientific name\t|\n"
                     "11\t|\tSpecies A1\t|\t\t|\tscientific name\t|\n"
                     "12\t|\tSpecies A2\t|\t\t|\tscientific name\t|\n"
                     "20\t|\tGenusB\t|\t\t|\tscientific name\t|\n"
                     "21\t|\tSpecies B1\t|\t\t|\tscientific name\t|\n",
        "merged.dmp": "99\t|\t21\t|\n",
        "nucl.accession2taxid": "accession\taccession.version\ttaxid\tgi\n"
                                "NC_0001\tNC_0001.1\t11\t1\n"
                                "NC_0002\tNC_0002.1\t12\t2\n"
                                "NC_0003\tNC_0003.1\t99\t3\n",
    }
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        if gz:
            with gzip.open(d / f"{name}.gz", "wt") as f:
                f.write(text)
        else:
            (d / name).write_text(text)


@pytest.mark.parametrize("gz", [False, True])
def test_ncbi_functions_match_jax(tmp_path, gz):
    write_taxonomy(tmp_path, gz)
    sfx = ".gz" if gz else ""
    nodes = ncbi.load_nodes(tmp_path / f"nodes.dmp{sfx}")
    assert nodes == jncbi.load_nodes(tmp_path / f"nodes.dmp{sfx}")
    names = ncbi.load_names(tmp_path / f"names.dmp{sfx}")
    assert names == jncbi.load_names(tmp_path / f"names.dmp{sfx}")
    merged = ncbi.load_merged(tmp_path / f"merged.dmp{sfx}")
    assert merged == jncbi.load_merged(tmp_path / f"merged.dmp{sfx}") == {
        99: 21}
    a2t = sorted(tmp_path.glob("*accession2taxid*"))
    accs = {"NC_0001", "NC_0003", "NC_9999"}
    got = ncbi.accession_to_taxid(accs, a2t, merged)
    assert got == jncbi.accession_to_taxid(accs, a2t, merged) == {
        "NC_0001": 11, "NC_0003": 21}
    for t in (11, 12, 21, 2, 1):
        assert ncbi.lineage_ranks(t, *nodes) == jncbi.lineage_ranks(t, *nodes)
    ft = [("a.fa", 11), ("b.fa", 12), ("c.fa", 21)]
    fr = ncbi.files_to_tax_nodes(ft, *nodes)
    assert fr == jncbi.files_to_tax_nodes(ft, *nodes)
    for rank in ("species", "genus", "family", "phylum"):
        for nm in (names, None):
            assert ncbi.targets_def_lines(fr, rank, nm) == \
                jncbi.targets_def_lines(fr, rank, nm)


def test_first_accession_matches_jax(tmp_path):
    heads = [">NC_0001.1 Some organism", ">gi|123|ref|NC_0042.3|", "@read7",
             ">", "ACGT", ">lcl|x y"]
    for i, h in enumerate(heads):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f"{h}\nACGT\n")
        assert ncbi.first_accession(p) == jncbi.first_accession(p)
        with gzip.open(tmp_path / f"g{i}.fa.gz", "wt") as f:
            f.write(f"{h}\nACGT\n")
        assert ncbi.first_accession(tmp_path / f"g{i}.fa.gz") == \
            jncbi.first_accession(p)
    assert ncbi.first_accession(tmp_path / "g0.fa") == "NC_0001"


def _refs(tmp: Path) -> Path:
    refs = tmp / "refs"
    (refs / "sub").mkdir(parents=True)
    for acc, name in [("NC_0001", "a1.fna"), ("NC_0002", "sub/a2.fa"),
                      ("NC_0003", "b1.fasta"), ("NC_7777", "u.fa")]:
        (refs / name).write_text(f">{acc}.1 x\nACGTACGT\n")
    with gzip.open(refs / "c.fna.gz", "wt") as f:
        f.write(">NC_0002.2 y\nACGT\n")
    (refs / "notes.txt").write_text("not a genome\n")
    return refs


@pytest.mark.parametrize("rank,taxonomy", [
    ("species", "plain"), ("genus", "plain"), ("phylum", "gz"),
    ("family", "plain"), ("custom", None), ("species", None)])
def test_set_targets_matches_jax(tmp_path, rank, taxonomy):
    """set-targets by both CLIs on the same reference dirs: equal rc and
    output, the same targets.txt and files_excluded.txt bytes, and the
    same .settings as JSON once each package's db dir is put back."""
    refs = _refs(tmp_path)
    argv = ["set-targets", str(tmp_path / "{X}_db"), str(refs), "--rank",
            rank]
    if taxonomy:
        write_taxonomy(tmp_path / "tax", taxonomy == "gz")
        argv += ["--taxonomy-dir", str(tmp_path / "tax")]
    rc, _, err = assert_same(argv, tmp_path)
    if rank == "family":          # no node of that rank: nothing labelled
        assert rc == 1 and "no target could be labeled" in err
        return
    if taxonomy is None and rank != "custom":
        assert rc == 1 and "needs --taxonomy-dir" in err
        return
    assert rc == 0
    for name in ("targets.txt", "files_excluded.txt"):
        j, t = tmp_path / "j_db" / name, tmp_path / "t_db" / name
        assert t.exists() == j.exists()
        if j.exists():
            assert t.read_bytes() == j.read_bytes()
    settings = [json.loads((tmp_path / f"{x}_db" / ".settings").read_text())
                for x in ("j", "t")]
    for s, x in zip(settings, ("j", "t")):
        assert s["db_dir"] == str(tmp_path / f"{x}_db")
        assert s["targets"] == str(tmp_path / f"{x}_db" / "targets.txt")
        s["db_dir"] = s["targets"] = None
    assert settings[1] == settings[0]
    assert settings[1]["rank"] == rank


def test_set_targets_function_matches_jax(tmp_path):
    """targets.set_targets called directly, as the CLI does, and the
    sequence-file scan."""
    refs = _refs(tmp_path)
    assert targets.find_sequence_files([refs]) == \
        jtargets.find_sequence_files([refs])
    assert targets.SEQ_SUFFIXES == jtargets.SEQ_SUFFIXES
    write_taxonomy(tmp_path / "tax")
    for mod, x in ((targets, "t"), (jtargets, "j")):
        assert mod.set_targets(SimpleNamespace(
            db_dir=str(tmp_path / f"{x}_db"), ref_dirs=[str(refs)],
            rank="genus", taxonomy_dir=str(tmp_path / "tax"))) == 0
    assert (tmp_path / "t_db" / "targets.txt").read_bytes() == (
        tmp_path / "j_db" / "targets.txt").read_bytes()
    labels = {ln.split()[1] for ln in
              (tmp_path / "t_db" / "targets.txt").read_text().splitlines()}
    assert labels == {"GenusA", "GenusB"}


def test_settings_enforced_at_classify(tmp_path):
    """A set-targets database through the port: classify refuses a
    conflicting -T, builds from the recorded targets without one, and
    writes the JAX package's CSV."""
    ref = tmp_path / "refs"
    ref.mkdir()
    g = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(17).integers(
        0, 4, 2500)].tobytes().decode()
    (ref / "org1.fa").write_text(f">org1\n{g}\n")
    (tmp_path / "r.fq").write_text(
        "".join(f"@r{i}\n{g[i * 100:i * 100 + 100]}\n+\n{'I' * 100}\n"
                for i in range(20)))
    for main, x in ((cli.main, "t"), (jcli.main, "j")):
        assert run(main, ["set-targets", str(tmp_path / f"{x}_db"),
                          str(ref), "--rank", "custom"])[0] == 0
    other = tmp_path / "other_targets.txt"
    other.write_text(f"{ref}/org1.fa X1\n")
    dev = ["--device", "cpu"]
    rc, _, err = run(cli.main, ["classify", "-D", str(tmp_path / "t_db"),
                                "-T", str(other), "-O", str(tmp_path / "r.fq"),
                                "-R", str(tmp_path / "o.csv"), *dev])
    assert rc == 1 and "managed by set-targets" in err
    assert not (tmp_path / "o.csv").exists()
    for main, x, extra in ((cli.main, "t", dev), (jcli.main, "j", [])):
        assert run(main, ["classify", "-D", str(tmp_path / f"{x}_db"), "-O",
                          str(tmp_path / "r.fq"), "-R",
                          str(tmp_path / f"{x}.csv"), *extra])[0] == 0
    rows = (tmp_path / "t.csv").read_text().splitlines()
    assert all(r.split(",")[3] == "org1" for r in rows[1:])
    assert (tmp_path / "t.csv").read_bytes() == (
        tmp_path / "j.csv").read_bytes()


def test_jax_package_tables_agree(tmp_path):
    """Guard of the comparison above: the two packages' build_table give
    one checksum for the same arrays (so an equal import means an equal
    table)."""
    km, lab, names, db = _table("qs", seed=8, n=5000)
    jdb = jbuild_table(km, lab, names, JDBConfig(k=31))
    assert db.checksum() == jdb.checksum()


@pytest.mark.parametrize("order", ["sorted", "bucket_order", "duplicate"])
def test_build_table_uniqueness_check_matches_jax(order):
    """build_table takes unique keys in any order (imports hand them over
    in bucket order) with the JAX package's table, and refuses a
    repeated key as it does."""
    rng = np.random.default_rng(12)
    km = np.unique(jcodec.canonical_np(rng.integers(
        0, 1 << 62, size=6000, dtype=np.uint64), 31))
    lab = rng.integers(1, 9, size=len(km)).astype(np.uint32)
    if order != "sorted":
        o = np.argsort(km % np.uint64(SMALL_HTSIZE), kind="stable")
        km, lab = km[o], lab[o]
    if order == "duplicate":
        km[-1], lab[-1] = km[3], lab[3]
    names = ["NA"] + [f"T{i}" for i in range(1, 9)]
    if order == "duplicate":
        for build, cfg in ((build_table, DBConfig), (jbuild_table,
                                                     JDBConfig)):
            with pytest.raises(ValueError, match="must be unique"):
                build(km, lab, names, cfg(k=31))
        return
    db = build_table(km, lab, names, DBConfig(k=31))
    assert db.checksum() == jbuild_table(km, lab, names,
                                         JDBConfig(k=31)).checksum()
