"""The port's host tools against the JAX package on the CPU: `abundance`
and `density` (native pass and csv-module fallback), `simulate-reads`,
`evaluate`, `analyze`, `clean` and `hashdb.load_target_names`.  Each
case runs the same seeded inputs through `cuclark_tpu.cli.main` and
`cuclark_tpu_torch.cli.main` (or the two modules' functions) and
requires equal exit codes, equal stdout and stderr, and equal written
files.  Every comparison is exact."""

import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest

from cuclark_tpu import analyser as janalyser
from cuclark_tpu import cli as jcli
from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu import native as jnative
from cuclark_tpu import simulate as jsimulate
from cuclark_tpu_torch import analyser, cli, hashdb, native, simulate

HEADER = ("Object_ID,Length,Gamma,1st_assignment,score1,2nd_assignment,"
          "score2,confidence\n")
K = 27


def run(main, argv):
    """main(argv) with stdout and stderr captured -> (rc, out, err)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def run_both(argv):
    """The same argv through both CLIs; {X} in an argument becomes 'j'
    for the JAX package and 't' for the port, so each writes its own
    files.  Returns the two (rc, out, err) triples with {X} in the
    output put back."""
    got = []
    for main, x in ((jcli.main, "j"), (cli.main, "t")):
        rc, out, err = run(main, [a.replace("{X}", x) for a in argv])
        got.append((rc, out.replace(f"/{x}_", "/{X}_"),
                    err.replace(f"/{x}_", "/{X}_")))
    return got


def assert_same(argv):
    (jrc, jout, jerr), (rc, out, err) = run_both(argv)
    assert (rc, out, err) == (jrc, jout, jerr)
    return rc, out, err


def _genomes(n: int, length: int, seed: int = 11) -> dict[str, str]:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, length))
    return {f"G{t + 1}": np.frombuffer(b"ACGT", np.uint8)[c].tobytes().decode()
            for t, c in enumerate(codes)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four random genomes (numpy seed 11) and their targets.txt, a DB
    built by each package, simulated reads (1% substitutions, 0.1%
    insertions and deletions) and the port's result CSV for them, and a
    small hand-made CSV with every filter's edge."""
    tmp = tmp_path_factory.mktemp("torch_tools")
    lines = []
    for t, g in _genomes(4, 6000).items():
        p = tmp / f"{t}.fa"
        p.write_text(f">{t}\n{g}\n")
        lines.append(f"{p} {t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    for main, d in ((jcli.main, "jdb"), (cli.main, "tdb")):
        rc, _, _ = run(main, ["build-db", "-T", str(targets), "-D",
                              str(tmp / d), "-k", str(K)])
        assert rc == 0
    sim = tmp / "sim.fq"
    rc, _, _ = run(cli.main, ["simulate-reads", "-T", str(targets), "-O",
                              str(sim), "-n", "1500", "-l", "100",
                              "--seed", "5"])
    assert rc == 0
    sim_csv = tmp / "sim.csv"
    rc, _, _ = run(cli.main, ["classify", "-D", str(tmp / "tdb"), "-O",
                              str(sim), "-R", str(sim_csv), "--device",
                              "cpu"])
    assert rc == 0
    rows = [("r0", 0.9, "T1", 1.0), ("r1", 0.8, "T1", 0.9),
            ("r2", 0.02, "T1", 0.9), ("r3", 0.7, "T2", 0.6),
            ("r4", 0.7, "T2", 0.8), ("r5", 0, "NA", 0)]
    small = tmp / "small.csv"
    small.write_text(HEADER + "".join(
        f"{n},100,{g},{t},50,NA,0,{c}\n" for n, g, t, c in rows))
    return {"tmp": tmp, "targets": targets, "sim": sim_csv, "small": small}


@pytest.fixture(params=["native", "fallback"])
def csv_path_kind(request, monkeypatch):
    """Run a case on the native csv pass and on the csv-module fallback
    of both packages."""
    if request.param == "native":
        if not (native.available() and jnative.available()):
            pytest.skip("no native module")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


ABUNDANCE_FLAGS = [[], ["--highconfidence"], ["--min-confidence", "0.75"],
                   ["--min-gamma", "0.1"], ["-D", "tdb"]]


@pytest.mark.parametrize("csv", ["small", "sim"])
@pytest.mark.parametrize("flags", ABUNDANCE_FLAGS,
                         ids=["plain", "highconf", "minconf", "mingamma",
                              "dbdir"])
def test_abundance_matches_jax(data, csv, flags):
    flags = [str(data["tmp"] / f) if f == "tdb" else f for f in flags]
    rc, out, _ = assert_same(["abundance", "-R", str(data[csv]), *flags])
    assert rc == 0
    assert out.startswith("Name,Count,Proportion_All(%),"
                          "Proportion_Classified(%)\n")
    if "-D" in flags:
        # every DB target listed, unhit ones with count 0
        names = {ln.split(",")[0] for ln in out.splitlines()[1:]}
        assert {"G1", "G2", "G3", "G4"} <= names


@pytest.mark.parametrize("flags", ABUNDANCE_FLAGS[:3],
                         ids=["plain", "highconf", "minconf"])
def test_abundance_native_equals_fallback(data, flags, monkeypatch):
    """The port's native csv_tally and its csv-module fallback print the
    same report, and the JAX package's."""
    if not native.available():
        pytest.skip("no native module")
    argv = ["abundance", "-R", str(data["sim"]), *flags]
    nat = run(cli.main, argv)
    monkeypatch.setattr(native, "available", lambda: False)
    assert run(cli.main, argv) == nat == run(jcli.main, argv)


@pytest.mark.parametrize("by", ["confidence", "gamma"])
@pytest.mark.parametrize("bins", ["20", "7"])
def test_density_matches_jax(data, by, bins, csv_path_kind):
    rc, out, err = assert_same(["density", "-R", str(data["sim"]), "--by",
                                by, "--bins", bins])
    assert rc == 0 and out.startswith(f"{by}_bin,count,fraction\n")
    assert len(out.splitlines()) == 1 + int(bins)
    assert err.startswith("# assigned=")


def test_density_native_equals_fallback(data, monkeypatch):
    if not native.available():
        pytest.skip("no native module")
    for by in ("confidence", "gamma"):
        argv = ["density", "-R", str(data["sim"]), "--by", by]
        nat = run(cli.main, argv)
        monkeypatch.setattr(native, "available", lambda: False)
        assert run(cli.main, argv) == nat
        monkeypatch.undo()


# (file bytes, tool and flags): malformed and truncated rows, CRLF, ties,
# a file that is not a result CSV, one with no assigned read
EDGE_CASES = {
    "malformed_row": (HEADER + "r0,100,0.9,T1,50,NA,0,1.0\nr1,100,garbage\n"
                      "r2,100,0.9,T1,50,NA,0,1.0\n", ["abundance"]),
    "garbage_filter_field": (HEADER + "r0,100,0.9,T1,50,NA,0,garbage\n",
                             ["abundance", "--highconfidence"]),
    "density_malformed": (HEADER + "r0,100,0.9,T1,50,NA,0,1.0\nr1,100\n"
                          "r2,100,0.9,T1,50,NA,0,1.0\n", ["density"]),
    "truncated_tail": (HEADER + "r0,100,0.9,T1,50,NA,0,1.0\nr1,100,0.",
                       ["abundance"]),
    "complete_final_malformed": (HEADER + "r0,100,0.9,T1,50,NA,0,1.0\n"
                                 "r1,100\n", ["abundance"]),
    "crlf": (HEADER.replace("\n", "\r\n") + "r0,100,0.9,T1,50,NA,0,1.0\r\n"
             "r1,100,0.9,T2,50,NA,0,0.5\r\n",
             ["abundance", "--highconfidence"]),
    "ties": (HEADER + "r0,100,0.9,T1,50,NA,0,1.0\nr1,100,0,NA,0,NA,0,0\n"
             "r2,100,0.9,A9,50,NA,0,1.0\n", ["abundance"]),
    "not_a_csv": ("a,b\n1,2\n", ["density"]),
    "nothing_assigned": (HEADER + "r0,100,0,NA,0,NA,0,0\n",
                         ["density", "--by", "gamma"]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_result_tool_edge_cases_match_jax(tmp_path, case, csv_path_kind):
    body, (tool, *flags) = EDGE_CASES[case]
    p = tmp_path / "edge.csv"
    p.write_bytes(body.encode())
    rc, out, err = assert_same([tool, "-R", str(p), *flags])
    if case in ("truncated_tail", "crlf", "ties"):
        assert rc == 0
    else:
        assert rc == 1 and err


def test_abundance_fuzz_matches_jax(tmp_path, monkeypatch):
    """Random CSVs (odd names, float spellings, blank lines, CRLF, with
    and without a final newline) give the JAX package's report on the
    native and fallback paths under each filter."""
    rng = np.random.default_rng(5)
    name_pool = (["NA"] + [f"T{i}" for i in range(6)]
                 + ["x y", "Acc_01.2", "zz-9", ""])
    gammas = ["0", "1", "0.5", "0.123456", "1e-05", "-0"]
    confs = ["0", "1", "0.75", "0.9999", "5e-01"]
    for trial in range(8):
        rows = []
        for i in range(int(rng.integers(1, 60))):
            rows.append(f"r{i},100,{rng.choice(gammas)},"
                        f"{rng.choice(name_pool)},50,NA,0,{rng.choice(confs)}")
            if rng.random() < 0.1:
                rows.append("")
        eol = "\r\n" if trial % 3 == 0 else "\n"
        body = eol.join(rows) + (eol if trial % 2 == 0 else "")
        p = tmp_path / f"f{trial}.csv"
        p.write_bytes(HEADER.replace("\n", eol).encode() + body.encode())
        for flags in ([], ["--highconfidence"], ["--min-gamma", "0.1"]):
            argv = ["abundance", "-R", str(p), *flags]
            for fallback in (False, True):
                if fallback:
                    monkeypatch.setattr(native, "available", lambda: False)
                    monkeypatch.setattr(jnative, "available", lambda: False)
                assert run(cli.main, argv) == run(jcli.main, argv), (
                    trial, flags, fallback)
                monkeypatch.undo()


SIM_CASES = {
    "default": ["-n", "700"],
    "long_seed": ["-n", "300", "-l", "150", "--seed", "3"],
    "error_free": ["-n", "200", "-l", "80", "--sub-rate", "0",
                   "--ins-rate", "0", "--del-rate", "0"],
    "high_error": ["-n", "400", "--sub-rate", "0.05", "--ins-rate",
                   "0.01", "--del-rate", "0.02", "--seed", "9"],
    "paired": ["-n", "300", "-l", "90", "--paired-output", "{P}"],
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_reads_matches_jax(data, tmp_path, case):
    """The same FASTQ bytes for the same seed: the generator's calls
    keep their order."""
    flags = [str(tmp_path / "{X}_m2.fq") if f == "{P}" else f
             for f in SIM_CASES[case]]
    rc, _, err = assert_same(["simulate-reads", "-T", str(data["targets"]),
                              "-O", str(tmp_path / "{X}_sim.fq"), *flags])
    assert rc == 0 and err.startswith("Wrote ")
    names = ["sim.fq"] + (["m2.fq"] if case == "paired" else [])
    for name in names:
        want = (tmp_path / f"j_{name}").read_bytes()
        assert (tmp_path / f"t_{name}").read_bytes() == want
        assert want.count(b"\n") == 4 * int(flags[1])


def test_simulate_functions_match_jax():
    """simulate_reads (multi-record genomes, paired with an insert
    length), mutate_codes and truth_of_name, called directly."""
    genomes = {"A": ["AC" * 200, "GT" * 300], **_genomes(2, 3000, seed=4)}
    for kw in ({}, {"paired": True, "insert_len": 150}):
        got = simulate.simulate_reads(genomes, 120, 60, 0.02, 0.01, 0.01,
                                      seed=7, **kw)
        assert got == jsimulate.simulate_reads(genomes, 120, 60, 0.02,
                                               0.01, 0.01, seed=7, **kw)
    rows = np.random.default_rng(0).integers(0, 4, (50, 112)).astype(
        np.uint8)
    a = simulate.mutate_codes(rows, 100, np.random.default_rng(1), 0.05,
                              0.02, 0.03)
    b = jsimulate.mutate_codes(rows, 100, np.random.default_rng(1), 0.05,
                               0.02, 0.03)
    np.testing.assert_array_equal(a, b)
    assert simulate.truth_of_name("sim3|G|x") == jsimulate.truth_of_name(
        "sim3|G|x") == "x"
    with pytest.raises(ValueError, match="read span"):
        simulate.simulate_reads({"S": "ACGT" * 10}, 5, 100)


@pytest.mark.parametrize("floors", [[], ["--min-recall", "0.95",
                                         "--min-precision", "0.98"],
                                    ["--min-recall", "1.01"],
                                    ["--min-precision", "1.01"]],
                         ids=["none", "passing", "recall_fails",
                              "precision_fails"])
def test_evaluate_matches_jax(data, floors):
    rc, out, err = assert_same(["evaluate", "-R", str(data["sim"]),
                                *floors])
    assert out.splitlines()[0] == ("Target,Reads,Assigned,Recall,"
                                   "Precision,Unclassified")
    assert out.splitlines()[-1].startswith("OVERALL,1500,,")
    assert rc == (1 if "1.01" in floors else 0)
    assert ("FAIL" in err) == (rc == 1)


def test_evaluate_functions_match_jax(data):
    got = simulate.evaluate_assignments(data["sim"])
    assert got == jsimulate.evaluate_assignments(data["sim"])
    assert got["overall"]["recall"] >= 0.97
    assert got["overall"]["precision"] >= 0.99


SPECTRA = {
    # error spike at 1, valley near 6, coverage bump near 12
    "bump": [0, 1000, 400, 150, 60, 30, 20, 18, 25, 40, 60, 80, 90, 80,
             60, 40, 20, 10, 5, 2, 1],
    "no_bump": [0, 3, 2, 1],
    "flat": [0, 5, 5, 5, 5, 5, 5],
}


@pytest.mark.parametrize("name", sorted(SPECTRA))
@pytest.mark.parametrize("div", ["2", "3"])
def test_analyze_matches_jax(tmp_path, name, div):
    sp = tmp_path / "spec.txt"
    lines = [f"K{c}_{i} {c}" for c, n in enumerate(SPECTRA[name])
             for i in range(n)]
    sp.write_text("\n".join(lines) + "\n")
    rc, out, _ = assert_same(["analyze", "-i", str(sp), "--div", div])
    assert rc == 0 and out.startswith(f"spectrum: {len(lines)} k-mers")
    assert ("bump interval" in out) == (name == "bump")


def test_analyser_functions_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    for _ in range(200):
        freq = rng.integers(0, 8, size=int(rng.integers(1, 60)))
        if len(freq) > 4:
            freq[2:5] = freq[1]
        for div in (1, 2, 3):
            assert analyser.bump_interval(freq, div) == \
                janalyser.bump_interval(freq, div)
        for a, b in zip(analyser.compact_plateaus(freq),
                        janalyser.compact_plateaus(freq)):
            np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.txt"
    bad.write_text("AAAA 1 2\n")
    for mod in (analyser, janalyser):
        with pytest.raises(ValueError, match="bad spectrum line"):
            mod.spectrum_histogram(bad)


@pytest.mark.parametrize("flags", [[], ["--all"]], ids=["default", "all"])
def test_clean_matches_jax(data, tmp_path, flags):
    """Both packages remove the same artifacts and report them alike."""
    src = data["tmp"] / "tdb"
    for x in ("j", "t"):
        d = tmp_path / f"{x}_db"
        shutil.copytree(src, d)
        (d / "tsk").mkdir()
        (d / "tsk" / "tsk.npz").write_bytes(b"x")
        for name in ("targets.txt", ".settings", "files_excluded.txt",
                     "notes.txt"):
            (d / name).write_text(name)
    rc, _, err = assert_same(["clean", "-D", str(tmp_path / "{X}_db"),
                              *flags])
    assert rc == 0 and err.startswith("removed: db_k")
    left = [sorted(str(p.relative_to(tmp_path / f"{x}_db"))
                   for p in (tmp_path / f"{x}_db").rglob("*"))
            for x in ("j", "t")]
    assert left[0] == left[1]
    assert ("targets.txt" in left[1]) == (not flags)
    assert "notes.txt" in left[1]
    assert assert_same(["clean", "-D", str(tmp_path / "none")])[0] == 0


@pytest.mark.parametrize("writer", ["jdb", "tdb"])
def test_load_target_names_matches_jax(data, writer):
    """A DB written by either package gives the same names through both,
    without loading its table."""
    path = next((data["tmp"] / writer).glob("db_k*.npz"))
    names = hashdb.load_target_names(path)
    assert names == jhashdb.load_target_names(path)
    assert names == ["NA", "G1", "G2", "G3", "G4"]
    assert names == hashdb.KmerDB.load(path).target_names


def test_load_target_names_rejects_other_npz(tmp_path):
    p = tmp_path / "x.npz"
    np.savez(p, meta=np.frombuffer(b'{"format": "other"}', np.uint8))
    for mod in (hashdb, jhashdb):
        with pytest.raises(ValueError, match="not a cuclark-tpu database"):
            mod.load_target_names(p)


def test_accuracy_loop_on_port(data, tmp_path):
    """simulate-reads -> classify --device cpu -> evaluate with floors,
    all through the port: the accuracy loop users run (README)."""
    sim, csv = tmp_path / "a.fq", tmp_path / "a.csv"
    assert run(cli.main, ["simulate-reads", "-T", str(data["targets"]),
                          "-O", str(sim), "-n", "800", "-l", "100",
                          "--sub-rate", "0.02", "--seed", "7"])[0] == 0
    assert run(cli.main, ["classify", "-D", str(data["tmp"] / "tdb"),
                          "-O", str(sim), "-R", str(csv), "--device",
                          "cpu"])[0] == 0
    rc, out, _ = run(cli.main, ["evaluate", "-R", str(csv), "--min-recall",
                                "0.93", "--min-precision", "0.99"])
    assert rc == 0 and "OVERALL,800,," in out
    assert Path(csv).read_bytes().count(b"\n") == 801
