"""The port's record scan on the OpenMP team (`native.scan`,
`native.scan_records`) against the JAX package's `native.scan`, the
port's one-thread entries (`scan_records_serial`: the plain versions)
and the numpy scanners of `io.fast_parse`, at team sizes 1, 2, 3, 7 and
8; and file->CSV at two team sizes against the JAX package's CSV.
Every comparison is exact: offsets, record count, where the scan
stopped, and the ValueError of malformed input."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cuclark_tpu import cli as jcli
from cuclark_tpu import native as jnative
from cuclark_tpu_torch import native, pipeline
from cuclark_tpu_torch.hashdb import KmerDB
from cuclark_tpu_torch.io import fast_parse
from tests.test_end2end import make_genomes, sample_reads

ROOT = Path(__file__).resolve().parent.parent
TEAMS = (1, 2, 3, 7, 8)

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="no C++ toolchain")


def _buf(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def _fastq(seed: int, n: int, eol: str = "\n", qual: str = "I") -> bytes:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, 40))
        seq = "".join(rng.choice(list("ACGTN"), size=ln))
        q = "".join(rng.choice(list(qual), size=ln))
        name = f"r{i}" + (" desc x" if i % 3 == 0 else "")
        recs.append(f"@{name}{eol}{seq}{eol}+{eol}{q}{eol}")
    return "".join(recs).encode()


def _fasta(seed: int, n: int, eol: str = "\n") -> bytes:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        lines = ["".join(rng.choice(list("ACGTN"), size=int(
            rng.integers(1, 30)))) for _ in range(int(rng.integers(0, 4)))]
        recs.append(f">s{i}\tdesc{eol}" + "".join(s + eol for s in lines))
    return "".join(recs).encode()


CASES = {
    "fastq_lf": _fastq(1, 60),
    "fastq_crlf": _fastq(2, 60, "\r\n"),
    # quality lines that open with '@' or '+' (a resync heuristic could
    # take either for a record start)
    "fastq_qual_at_plus": _fastq(3, 60, qual="@+I"),
    "fastq_crlf_qual_at": _fastq(4, 40, "\r\n", qual="@+"),
    "fastq_no_final_newline": _fastq(5, 30)[:-1],
    "fastq_header_only_tail": _fastq(6, 20) + b"@tail",
    "fastq_malformed_mid": _fastq(7, 20) + b"\njunk\n" + _fastq(8, 20),
    "fastq_blank_tail": _fastq(9, 20) + b"\n\n  \n",
    "fasta_lf": _fasta(10, 60),
    "fasta_crlf": _fasta(11, 60, "\r\n"),
    # '>' inside a sequence line starts no record
    "fasta_gt_mid_line": b">a\nAC>GT\nT>\n>b x\nGG\n>c\n>>\nA",
    "fasta_empty_seqs": b">a\n>b\n\n>c\r\n>d\nACGT\n>e\n",
    "fasta_header_only_tail": _fasta(12, 20) + b">last desc",
    "neither": b"ACGT\n@r\nA\n+\nI\n",
}


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _scan_or_error(fn, buf):
    try:
        return fn(buf)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", list(CASES))
def test_scan_matches_jax(case, team):
    """native.scan on a pinned team gives the JAX package's offsets, or
    its ValueError word for word."""
    buf = _buf(CASES[case])
    got = _scan_or_error(functools.partial(native.scan, threads=team), buf)
    want = _scan_or_error(jnative.scan, buf)
    if isinstance(want, str):
        assert got == want
    else:
        _equal(got, want)
        assert len(want[0]) > 0


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", list(CASES))
def test_scan_records_match_serial(case, team):
    """Offsets, count and the stop offset equal the one-thread entries'
    in both formats, whatever the first byte says."""
    buf = _buf(CASES[case])
    for fasta in (False, True):
        _equal(native.scan_records(buf, fasta, team),
               native.scan_records_serial(buf, fasta))


def _cuts(n: int, team: int) -> list:
    return [n * t // team for t in range(1, team)]


@pytest.mark.parametrize("team", TEAMS[1:])
@pytest.mark.parametrize("fasta", [False, True], ids=["fastq", "fasta"])
def test_chunk_cuts_inside_crlf_and_headers(fasta, team):
    """A CRLF file whose first header grows a byte at a time moves every
    chunk boundary through every byte of the records around it; the
    sweep cuts between '\\r' and '\\n' and inside a header line."""
    body = _fasta(13, 12, "\r\n") if fasta else _fastq(14, 12, "\r\n")
    lead = b">" if fasta else b"@"
    inside_crlf = inside_header = 0
    for pad in range(0, 400):
        data = lead + b"x" * pad + body[1:]
        buf = _buf(data)
        for c in _cuts(len(data), team):
            inside_crlf += data[c - 1:c + 1] == b"\r\n"
            line_start = data.rfind(b"\n", 0, c) + 1
            inside_header += (data[line_start:line_start + 1] == lead
                              and c > line_start)
        _equal(native.scan_records(buf, fasta, team),
               native.scan_records_serial(buf, fasta))
        _equal(native.scan(buf, team), jnative.scan(buf))
    assert inside_crlf > 0 and inside_header > 0


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("fasta", [False, True], ids=["fastq", "fasta"])
def test_every_truncation_of_the_last_record(fasta, team):
    """The file cut at every byte of its last record: the same records
    (a partial FASTQ tail dropped, a FASTA tail clamped) as the JAX
    package and, in record count and name offsets, as numpy."""
    data = _fasta(15, 8, "\r\n") if fasta else _fastq(16, 8, "\r\n")
    last = data.rfind(b"\n>" if fasta else b"\n@") + 1
    numpy_scan = fast_parse.scan_fasta if fasta else fast_parse.scan_fastq
    for end in range(last, len(data) + 1):
        buf = _buf(data[:end])
        got = native.scan(buf, team)
        _equal(got, jnative.scan(buf))
        _equal(native.scan_records(buf, fasta, team),
               native.scan_records_serial(buf, fasta))
        ref = numpy_scan(buf)
        _equal(got[:2], ref[:2])


@pytest.mark.parametrize("team", TEAMS)
def test_malformed_header_same_stop_and_error(team):
    """A line that is no header in the middle of a FASTQ stops the scan
    at that line on every team (the same `consumed`), and native.scan
    raises the JAX package's ValueError, naming that byte."""
    good = _fastq(17, 30)
    data = good + b"+junk\n" + _fastq(18, 30)
    buf = _buf(data)
    par = native.scan_records(buf, False, team)
    _equal(par, native.scan_records_serial(buf, False))
    assert par[4] == len(good) and len(par[0]) == 30
    with pytest.raises(ValueError) as got:
        native.scan(buf, team)
    with pytest.raises(ValueError) as want:
        jnative.scan(buf)
    assert str(got.value) == str(want.value)
    assert f"at byte {len(good)}" in str(got.value)


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("fasta", [False, True], ids=["fastq", "fasta"])
def test_max_rec_cap(fasta, team):
    """max_rec caps the count and leaves `consumed` at the next record's
    start, as the one-thread entries do (0, 1, inside, at and past the
    count; a negative cap is 0)."""
    data = _fasta(19, 25) if fasta else _fastq(20, 25)
    buf = _buf(data)
    for cap in (-1, 0, 1, 7, 24, 25, 26, 1000):
        got = native.scan_records(buf, fasta, team, cap)
        _equal(got, native.scan_records_serial(buf, fasta, cap))
        assert len(got[0]) == max(0, min(cap, 25))


@pytest.mark.parametrize("team", TEAMS)
def test_junk_before_the_first_fasta_header(team):
    """scan_fasta skips bytes before the first '>' (which needs no '\\n'
    before it); native.scan refuses such a file as the JAX package
    does."""
    for data in (b"junk>a\nAC\n>b\nGT\n", b"\n\n>a\nAC\n", b"x>a",
                 b"no header at all\n", b"ab\nc>d\n>e\nA\n"):
        buf = _buf(data)
        _equal(native.scan_records(buf, True, team),
               native.scan_records_serial(buf, True))
        assert (_scan_or_error(functools.partial(native.scan, threads=team),
                               buf) == _scan_or_error(jnative.scan, buf))


@pytest.mark.parametrize("case", ["fastq_lf", "fastq_crlf",
                                  "fastq_qual_at_plus", "fasta_lf",
                                  "fasta_crlf"])
def test_matches_numpy_scanners(case):
    """The numpy scanners (the fallback without a compiler) give the
    same records: names and sequence starts exactly, and the same packed
    codes and lengths (they keep a sequence's trailing CR or newlines,
    which the packer drops)."""
    buf = _buf(CASES[case])
    fasta = case.startswith("fasta")
    ref = (fast_parse.scan_fasta if fasta else fast_parse.scan_fastq)(buf)
    for team in TEAMS:
        got = native.scan(buf, team)
        _equal(got[:3], ref[:3])
        _equal(fast_parse.pack_block(buf, got[2], got[3], 160),
               fast_parse.pack_block(buf, ref[2], ref[3], 160))


_LINE = st.text(alphabet="ACGTN@+>I \t\r", max_size=12)


@st.composite
def _records(draw, fasta: bool):
    """Well-formed records (CRLF or LF, line contents that open with '@',
    '+' or '>'), then a cut and a corrupted byte, each maybe."""
    eol = draw(st.sampled_from(["\n", "\r\n"]))
    out = []
    for name, lines in draw(st.lists(st.tuples(_LINE, st.lists(
            _LINE, min_size=0 if fasta else 3, max_size=3)), max_size=12)):
        if fasta:
            out.append(">" + name + eol + "".join(s + eol for s in lines))
        else:
            out.append("@" + name + eol + eol.join(lines[:1] + ["+"]
                                                   + lines[2:3]) + eol)
    data = bytearray("".join(out).encode())
    if data and draw(st.booleans()):
        data = data[:draw(st.integers(0, len(data)))]
    if data and draw(st.booleans()):
        data[draw(st.integers(0, len(data) - 1))] = draw(
            st.sampled_from(b"@+>\n\rX"))
    return bytes(data)


@settings(max_examples=150, deadline=None, database=None)
@given(st.data())
def test_hypothesis_every_team(data):
    """Drawn files, both formats, every team: native.scan equals the
    JAX package's (offsets or error), and scan_records the one-thread
    entries' under a drawn cap."""
    fasta = data.draw(st.booleans())
    raw = data.draw(_records(fasta))
    cap = data.draw(st.none() | st.integers(-1, 14))
    buf = _buf(raw)
    want = _scan_or_error(jnative.scan, buf)
    for team in TEAMS:
        got = _scan_or_error(functools.partial(native.scan, threads=team),
                             buf)
        if isinstance(want, str):
            assert got == want
        else:
            _equal(got, want)
        _equal(native.scan_records(buf, fasta, team, cap),
               native.scan_records_serial(buf, fasta, cap))


def test_default_team_honours_omp_num_threads():
    """With no pinned team the scan takes one thread below 1 MiB and the
    OpenMP team (OMP_NUM_THREADS) from there; the offsets of a 2 MiB
    file are the one-thread entry's."""
    code = (
        "import numpy as np\n"
        "from cuclark_tpu_torch import native\n"
        "print(native.scan_team((1 << 20) - 1), native.scan_team(1 << 21),"
        " native.scan_team(1 << 21, 2))\n"
        "rec = " + repr(_fastq(21, 40)) + "\n"
        "buf = np.frombuffer(rec * ((1 << 21) // len(rec) + 1), np.uint8)\n"
        "a = native.scan_records(buf, False)\n"
        "b = native.scan_records_serial(buf, False)\n"
        "print(len(buf) >= 1 << 21, all(np.array_equal(x, y) for x, y in"
        " zip(a[:4], b[:4])) and a[4] == b[4])\n")
    env = dict(os.environ, OMP_NUM_THREADS="3", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["1", "3", "2", "True", "True"]


@pytest.mark.parametrize("team", TEAMS)
def test_read_file_equals_fromfile(tmp_path, team):
    """The threaded read (pread by byte range) gives np.fromfile's
    bytes."""
    p = tmp_path / "r.fq"
    p.write_bytes(CASES["fastq_crlf"] * 7)
    np.testing.assert_array_equal(native.read_file(p, team),
                                  np.fromfile(p, np.uint8))
    with pytest.raises(OSError):
        native.read_file(tmp_path / "missing.fq", team)


@pytest.fixture(scope="module")
def csv_inputs(tmp_path_factory):
    """Synthetic genomes and reads (tests/test_end2end.py) as a CRLF
    FASTQ, a DB built by the JAX package, and its CSV."""
    tmp = tmp_path_factory.mktemp("torch_scan_csv")
    genomes = make_genomes()
    lines = []
    for t, seqs in genomes.items():
        p = tmp / f"g{t}.fa"
        p.write_text(f">genome{t}\n" + "\n".join(seqs) + "\n")
        lines.append(f"{p} TAX{t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    reads = tmp / "reads.fq"
    reads.write_bytes("".join(
        f"@{n} d\r\n{s}\r\n+\r\n{'@' * len(s)}\r\n"
        for n, s in sample_reads(genomes)).encode())
    assert jcli.main(["build-db", "-T", str(targets), "-k", "27", "-D",
                      str(tmp / "jdb")]) == 0
    jcsv = tmp / "jax.csv"
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), "-O", str(reads),
                      "-R", str(jcsv)]) == 0
    return tmp, reads, jcsv


@pytest.mark.parametrize("team", [2, 7])
def test_classify_file_to_csv_matches_jax(csv_inputs, team, monkeypatch):
    """classify_file_to_csv, its input scanned on a team of 2 and of 7,
    writes the JAX package's CSV byte for byte."""
    tmp, reads, jcsv = csv_inputs
    teams = []
    scan = native.scan

    def pinned(buf, threads=0):
        teams.append(team)
        return scan(buf, team)

    monkeypatch.setattr(native, "scan", pinned)
    db = KmerDB.load(next((tmp / "jdb").glob("db_k*.npz")))
    clf = pipeline.Classifier(db, device="cpu")
    out = tmp / f"torch_{team}.csv"
    clf.classify_file_to_csv(str(reads), str(out))
    clf.close()
    assert teams == [team]
    assert out.read_bytes() == jcsv.read_bytes()
