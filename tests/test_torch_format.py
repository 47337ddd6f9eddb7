"""The port's CSV row writer (`native.format_rows`/`format_rows_ext`, no
printf) byte for byte against its snprintf plain versions
(`format_rows_printf`/`format_rows_ext_printf`) and the JAX package's
`native.format_rows`/`format_rows_ext`, at teams 1, 2, 3 and 8, below
and above 4,096 rows: every ratio t/d for d up to 2,048, random double
bit patterns, exact ties at the sixth significant digit and the
neighbours of ties and notation boundaries, NaN of either sign, +-0 and
+-inf, long names and empty target names; the results entries
(`native.format_results`/`format_results_ext`, gamma and confidence
computed by the writer) against `score.gamma_confidence` + the printf
versions and the JAX package's, at 1, 4,095, 4,096 and 16,384 rows and
teams 1, 2 and 4, reads of k - 2 to k + 1 bases; and classify's CSV on
the read-only mapped input (`pipeline._read_file_bytes`) against the JAX
package's: plain, --extended and paired with reads of length k - 1 (the
-nan rows), with no numpy gamma on the path, an empty file, a FIFO,
simulate-reads and --num-hosts on the mate files."""

import contextlib
import functools
import io
import os
import threading
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cuclark_tpu import cli as jcli
from cuclark_tpu import native as jnative
from cuclark_tpu_torch import cli, native, pipeline
from tests.test_end2end import make_genomes, sample_reads

TEAMS = (1, 2, 3, 8)
SIZES = ("below", "above")  # 4,095 rows (one thread by default), all

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="no C++ toolchain")


def _fields(values: np.ndarray, conf=None, seed: int = 0,
            targets=("NA", "T1", "", "a-long-target-name-of-30-bytes")):
    """One row a value (gamma = the value, confidence = `conf` or the
    values reversed): names of 1-60 bytes, target indices, norms and
    scores drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = len(values)
    names = [b"r%d" % i + b"n" * int(rng.integers(0, 58))
             for i in range(n)]
    ne = np.cumsum([len(x) for x in names], dtype=np.int64)
    ns = ne - np.array([len(x) for x in names], np.int64)
    tnb, tno = native.pack_target_names(list(targets))
    nt = len(targets)
    return (rng.integers(-5, 1 << 40, n), np.asarray(values, np.float64),
            rng.integers(0, nt, n).astype(np.int32),
            rng.integers(-10, 1 << 31, n).astype(np.int32),
            rng.integers(0, nt, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32),
            (np.asarray(values[::-1], np.float64) if conf is None
             else np.asarray(conf, np.float64)),
            np.frombuffer(b"".join(names), np.uint8), ns, ne, tnb, tno)


def _head(fields, rows: int):
    return (*(f[:rows] for f in fields[:7]), fields[7], fields[8][:rows],
            fields[9][:rows], *fields[10:])


def _ratios() -> np.ndarray:
    d = np.concatenate([np.full(d + 1, d) for d in range(1, 2049)])
    t = np.concatenate([np.arange(d + 1) for d in range(1, 2049)])
    return t / d


def _ties() -> np.ndarray:
    """Exact ties at the sixth significant digit: M / 2^j whose decimal
    expansion has seven significant digits ending in 5 (M * 5^j of seven
    digits, M odd), and seven-digit integers ending in 5 times 10^e."""
    rng = np.random.default_rng(5)
    out = []
    for j in range(1, 11):
        lo, hi = -(-10 ** 6 // 5 ** j), 10 ** 7 // 5 ** j
        ms = {m | 1 for m in rng.integers(lo, max(lo + 1, hi), 300)}
        out += [m / 2 ** j for m in ms if 10 ** 6 <= (m * 5 ** j) < 10 ** 7]
    for e in range(0, 10):
        out += [float(d * 10 ** e) for d in
                rng.integers(100000, 1000000, 50) * 10 + 5]
    out += [999999.5, 9999995.0, 99999.95, 0.5, 100000.5]
    for x in out[:-3]:  # each a tie, decided on the exact value
        digits = Decimal(x).normalize().as_tuple().digits
        assert len(digits) == 7 and digits[-1] == 5, x
    return np.array(out)


def _neighbours(x: np.ndarray, k: int = 40) -> np.ndarray:
    """x and its k nextafter neighbours on each side, both signs."""
    out = [x]
    up, down = x.copy(), x.copy()
    for _ in range(k):
        up, down = np.nextafter(up, np.inf), np.nextafter(down, -np.inf)
        out += [up, down]
    v = np.concatenate(out)
    return np.concatenate([v, -v])


def _boundaries() -> np.ndarray:
    tens = 10.0 ** np.arange(-20, 26)
    base = np.concatenate([
        [1e-4, 1e-5, 9.999995e-5, 9.9999949999e-5, 999999.5, 1e6,
         99999.95, 0.000099999949999],
        0.5 * 10.0 ** -np.arange(0, 26), tens, 9.999995 * tens,
        9.9999949999 * tens, _ties()])
    return _neighbours(base)


def _specials() -> np.ndarray:
    nan = np.float64("nan")
    with np.errstate(invalid="ignore"):
        minus_nan = np.float64(0) / np.float64(0)  # sign bit set on x86
    v = np.array([np.copysign(nan, 1.0), np.copysign(nan, -1.0), minus_nan,
                  0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 0.5])
    rng = np.random.default_rng(3)
    return v[rng.integers(0, len(v), 6000)]


def _random_bits(n: int = 100_000) -> np.ndarray:
    """Doubles of every bit pattern: NaN payloads, subnormals, both
    signs, every exponent."""
    rng = np.random.default_rng(9)
    return rng.integers(0, 1 << 64, n, dtype=np.uint64).view(np.float64)


CASES = {"ratios": _ratios, "boundaries": _boundaries,
         "specials": _specials, "random_bits": _random_bits}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """The case's rows, the JAX package's bytes for all of them and for
    the first 4,095."""
    fields = _fields(CASES[name]())
    want = {"above": jnative.format_rows(*fields),
            "below": jnative.format_rows(*_head(fields, 4095))}
    return fields, want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_printf_version_matches_jax(case, size):
    """The plain version is the JAX package's formatter byte for byte."""
    fields, want = _case(case)
    if size == "below":
        fields = _head(fields, 4095)
    assert native.format_rows_printf(*fields).tobytes() == want[size]


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_row_writer_matches_printf(case, size, team):
    """The row writer's bytes equal the JAX package's (which are the
    plain version's) at every team; values handed to snprintf are those
    outside the exact rounding's magnitudes only."""
    fields, want = _case(case)
    if size == "below":
        fields = _head(fields, 4095)
    got, handed = native.format_rows(*fields, threads=team)
    assert got.tobytes() == want[size]
    if case in ("ratios", "specials"):
        assert handed == 0
    if case == "random_bits":
        assert handed > 0


def test_writer_prints_the_hazards():
    """0/0 (a read of k - 1 bases), -0, +-inf, ties and the notation
    boundaries print as glibc's %g prints them."""
    with np.errstate(invalid="ignore"):
        v = np.array([np.float64(0) / np.float64(0), -0.0, 0.0, np.inf,
                      -np.inf, 999999.5, 999998.5, 100000.5, 1e-5,
                      9.999995e-5, 123456.5, 0.0001])
    fields = _fields(v, conf=np.zeros(len(v)), targets=("NA",))
    got, _ = native.format_rows(*fields, threads=1)
    gammas = [row.split(b",")[2] for row in got.tobytes().splitlines()]
    assert gammas == [b"-nan", b"-0", b"0", b"inf", b"-inf", b"1e+06",
                      b"999998", b"100000", b"1e-05", b"0.0001", b"123456",
                      b"0.0001"]


@pytest.mark.parametrize("team", TEAMS)
@settings(max_examples=60, deadline=None)
@given(values=st.lists(st.floats(allow_nan=False, allow_infinity=False,
                                 allow_subnormal=True),
                       min_size=1, max_size=64))
def test_hypothesis_finite_doubles(team, values):
    """Drawn finite doubles, subnormals included, as gamma and
    confidence."""
    fields = _fields(np.array(values), seed=len(values))
    want = jnative.format_rows(*fields)
    assert native.format_rows_printf(*fields).tobytes() == want
    assert native.format_rows(*fields, threads=team)[0].tobytes() == want


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("size", SIZES)
def test_names_cut_at_39_bytes_and_nul(team, size):
    """Names past 39 bytes are cut, a NUL byte ends a name or a target
    name early (as "%.*s" does), and an empty target name is empty."""
    n = 4095 if size == "below" else 9000
    rng = np.random.default_rng(11)
    names = [(b"x" * int(rng.integers(30, 90))) if i % 7 else
             b"ab\0cd" for i in range(n)]
    ne = np.cumsum([len(x) for x in names], dtype=np.int64)
    ns = ne - np.array([len(x) for x in names], np.int64)
    fields = list(_fields(rng.random(n), targets=("NA", "", "T\0U", "V")))
    fields[7:10] = np.frombuffer(b"".join(names), np.uint8), ns, ne
    want = jnative.format_rows(*fields)
    assert b"ab," in want and b",T," in want and b",," in want
    assert native.format_rows_printf(*fields).tobytes() == want
    assert native.format_rows(*fields, threads=team)[0].tobytes() == want


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("n_targets", [0, 1000])
def test_extended_rows(n_targets, size, team):
    """Extended rows (a count column a target, 0 and 1,000 targets) on
    ratios, ties and specials."""
    n = 4095 if size == "below" else (5000 if n_targets else 20000)
    rng = np.random.default_rng(n_targets + n)
    pool = np.concatenate([_boundaries(), _specials()])
    v = np.where(rng.random(n) < 0.5, rng.integers(0, 200, n) / 199,
                 pool[rng.integers(0, len(pool), n)])
    fields = _fields(v, seed=n_targets)
    counts = rng.integers(0, 1 << 32, (n, n_targets), dtype=np.uint64)
    counts[:, ::3] = 0
    counts = counts.astype(np.uint32)
    want = jnative.format_rows_ext(counts, *fields)
    assert native.format_rows_ext_printf(counts, *fields).tobytes() == want
    got, _ = native.format_rows_ext(counts, *fields, threads=team)
    assert got.tobytes() == want


def test_default_team():
    """One thread below 4,096 rows, the pinned team when asked."""
    assert native.format_team(4095) == 1
    assert native.format_team(4095, 3) == 3
    assert native.format_team(4096) >= 1


def test_csv_format_locale_independent():
    """A de_DE LC_NUMERIC changes nothing: the writer prints no locale
    digits and its snprintf hand-offs run in the C locale."""
    import locale

    try:
        locale.setlocale(locale.LC_NUMERIC, "de_DE.UTF-8")
    except locale.Error:
        pytest.skip("de_DE.UTF-8 locale not installed")
    try:
        buf = np.frombuffer(b"@r0\nACGT\n+\nIIII\n", np.uint8)
        ns, ne, _, _ = native.scan(buf)
        tnb, tno = native.pack_target_names(["NA", "T1"])
        for g in (0.125, 1e-300):
            args = (np.array([4], np.int64), np.array([g]),
                    np.array([1], np.int32), np.array([3], np.int32),
                    np.array([0], np.int32), np.array([0], np.int32),
                    np.array([0.75]), buf, ns, ne, tnb, tno)
            want = b"r0,4,%s,T1,3,NA,0,0.75\n" % (b"%g" % g)
            assert native.format_rows(*args)[0].tobytes() == want
            assert native.format_rows_printf(*args).tobytes() == want
    finally:
        locale.setlocale(locale.LC_NUMERIC, "C")


# ---- the rows from the card's results rows ----

K_RES = 27
RESULT_ROWS = (1, 4095, 4096, 16384)
RESULT_TEAMS = (1, 2, 4)
RES_TARGETS = ("NA", "T1", "", "a-long-target-name-of-30-bytes", "T4")


@functools.lru_cache(maxsize=None)
def _results_case(n: int, paired: bool):
    """n seeded results rows and lengths: lengths k - 2, k - 1, k, k + 1
    (and k + 2 for a pair, whose norm is its length less one) beside
    longer reads, totals up to 65,535, a seventh of the rows with best +
    second = 0; names and target names as `_fields`, count columns for
    the extended rows."""
    rng = np.random.default_rng(n + paired)
    short = K_RES + np.arange(-2, 3 if paired else 2)
    lengths = np.where(rng.random(n) < 0.5, short[rng.integers(
        0, len(short), n)], rng.integers(K_RES, 2000, n)).astype(np.int64)
    total = rng.integers(0, 65536, n)
    # a read with no window hits nothing (most of them: a few keep a
    # total, whose gamma is +-inf)
    total[(lengths - paired < K_RES) & (rng.random(n) < 0.9)] = 0
    best = rng.integers(0, total + 1)
    second = rng.integers(0, best + 1)
    zero = rng.random(n) < 1 / 7
    best[zero] = second[zero] = 0
    nt = len(RES_TARGETS)
    results = np.stack([total, rng.integers(0, nt, n), best,
                        rng.integers(0, nt, n), second], 1).astype(np.int32)
    names = [b"r%d" % i + b"n" * int(rng.integers(0, 50)) for i in range(n)]
    ne = np.cumsum([len(x) for x in names], dtype=np.int64)
    ns = ne - np.array([len(x) for x in names], np.int64)
    tnb, tno = native.pack_target_names(list(RES_TARGETS))
    counts = rng.integers(0, 1 << 20, (n, nt - 1)).astype(np.uint32)
    return (results, lengths, np.frombuffer(b"".join(names), np.uint8), ns,
            ne, tnb, tno, counts)


def _results_want(n: int, paired: bool, extended: bool) -> bytes:
    """`score.gamma_confidence` + the printf plain version's bytes, which
    must equal the JAX package's gamma_confidence + formatter's."""
    from cuclark_tpu import score as jscore
    from cuclark_tpu_torch import score

    results, lengths, buf, ns, ne, tnb, tno, counts = _results_case(
        n, paired)
    cols = [results[:, i] for i in range(5)]
    out = []
    for gc, fmt in ((score.gamma_confidence,
                     native.format_rows_ext_printf if extended
                     else native.format_rows_printf),
                    (jscore.gamma_confidence,
                     jnative.format_rows_ext if extended
                     else jnative.format_rows)):
        norm, gamma, conf = gc(cols[0], cols[2], cols[4], lengths, K_RES,
                               paired)
        fields = (norm, gamma, cols[1], cols[2], cols[3], cols[4], conf, buf,
                  ns, ne, tnb, tno)
        got = fmt(counts, *fields) if extended else fmt(*fields)
        out.append(got.tobytes() if hasattr(got, "tobytes") else got)
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("extended", [False, True],
                         ids=["default", "extended"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("team", RESULT_TEAMS)
@pytest.mark.parametrize("rows", RESULT_ROWS)
def test_results_entry_matches_gamma_confidence_printf(rows, team, paired,
                                                       extended):
    """The results entries' rows (gamma and confidence computed by the
    writer) equal `gamma_confidence` + the printf version's and the JAX
    package's, -nan (a read of k - 1 bases) and -0 (shorter) included."""
    results, lengths, buf, ns, ne, tnb, tno, counts = _results_case(
        rows, paired)
    args = (results, lengths, K_RES, paired, buf, ns, ne, tnb, tno)
    if extended:
        got, handed = native.format_results_ext(counts, *args, threads=team)
    else:
        got, handed = native.format_results(*args, threads=team)
    want = _results_want(rows, paired, extended)
    assert got.tobytes() == want
    assert handed == 0
    if rows >= 4095:
        for field in (b",-nan,", b",-0,", b",inf,", b",0\n"):
            assert field in want


def test_results_entry_short_reads():
    """Lengths k - 2 .. k + 1, unpaired and paired: gamma -0, -nan, a
    ratio, and confidence 0 where best + second = 0."""
    tnb, tno = native.pack_target_names(["NA", "T1"])
    buf = np.frombuffer(b"abcd", np.uint8)
    ns, ne = np.arange(4, dtype=np.int64), np.arange(1, 5, dtype=np.int64)
    results = np.array([[0, 0, 0, 0, 0], [0, 1, 0, 0, 0], [1, 1, 1, 0, 0],
                        [2, 1, 2, 0, 1]], np.int32)
    lengths = K_RES + np.arange(-2, 2, dtype=np.int64)
    got = native.format_results(results, lengths, K_RES, False, buf, ns, ne,
                                tnb, tno, threads=1)[0].tobytes()
    assert got.splitlines() == [b"a,25,-0,NA,0,NA,0,0", b"b,26,-nan,T1,0,NA,0,0",
                                b"c,27,1,T1,1,NA,0,1",
                                b"d,28,1,T1,2,NA,1,0.666667"]
    got = native.format_results(results, lengths + 1, K_RES, True, buf, ns,
                                ne, tnb, tno, threads=1)[0].tobytes()
    assert [r.split(b",")[1:3] for r in got.splitlines()] == [
        [b"25", b"-0"], [b"26", b"-nan"], [b"27", b"1"], [b"28", b"1"]]


def test_results_entry_checks_its_arrays():
    """Rows that are not [n, 5], or lengths and names of another count,
    raise."""
    tnb, tno = native.pack_target_names(["NA"])
    buf = np.zeros(8, np.uint8)
    z = np.zeros(3, np.int64)
    with pytest.raises(ValueError):
        native.format_results(np.zeros((3, 4), np.int32), z, K_RES, False,
                              buf, z, z, tnb, tno)
    with pytest.raises(ValueError):
        native.format_results(np.zeros((3, 5), np.int32), z[:2], K_RES,
                              False, buf, z, z, tnb, tno)


# ---- classify's CSV on the mapped input ----

def _run(main, argv) -> int:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Genomes, a DB built by the JAX package, and reads whose lengths
    include k - 1 = 26 (gamma 0/0: -nan) and shorter (gamma -0), single
    and as mate files (mates of 13 bases join to k = 27)."""
    tmp = tmp_path_factory.mktemp("torch_format_csv")
    genomes = make_genomes()
    lines = []
    for t, seqs in genomes.items():
        p = tmp / f"g{t}.fa"
        p.write_text(f">genome{t}\n" + "\n".join(seqs) + "\n")
        lines.append(f"{p} TAX{t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    reads = sample_reads(genomes, n_reads=80)
    g = genomes[1][0]
    reads += [(f"short{i}", g[i * 5:i * 5 + ln]) for i, ln in
              enumerate((26, 26, 25, 1, 26, 27, 40))]
    fq = tmp / "reads.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in reads))
    r1, r2 = tmp / "r1.fq", tmp / "r2.fq"
    mates = [(n, s[:60], s[-60:]) for n, s in sample_reads(genomes, 50)]
    mates += [(f"m{i}", g[i:i + 13], g[i + 20:i + 33]) for i in range(4)]
    r1.write_text("".join(f"@{n}/1\n{a}\n+\n{'I' * len(a)}\n"
                          for n, a, _ in mates))
    r2.write_text("".join(f"@{n}/2\n{b}\n+\n{'I' * len(b)}\n"
                          for n, _, b in mates))
    empty = tmp / "empty.fq"
    empty.write_bytes(b"")
    assert _run(jcli.main, ["build-db", "-T", str(targets), "-k", "27",
                            "-D", str(tmp / "jdb")]) == 0
    return tmp, targets, fq, r1, r2, empty


@pytest.fixture
def mapped(monkeypatch):
    """Records the type of every buffer `_read_file_bytes` returns."""
    kinds = []
    read = pipeline._read_file_bytes

    def spy(path):
        buf = read(path)
        kinds.append(type(buf).__name__)
        return buf

    monkeypatch.setattr(pipeline, "_read_file_bytes", spy)
    return kinds


def _jax_csv(tmp, name, argv):
    out = tmp / f"jax_{name}.csv"
    if not out.exists():
        assert _run(jcli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                                str(out), *argv]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("mode", ["plain", "extended", "paired"])
def test_classify_csv_on_mapped_input(inputs, mapped, mode):
    """The CSV from the mapped input is the JAX package's, -nan and -0
    rows included."""
    tmp, _, fq, r1, r2, _ = inputs
    argv = {"plain": ["-O", str(fq)],
            "extended": ["-O", str(fq), "--extended"],
            "paired": ["-P", str(r1), str(r2)]}[mode]
    out = tmp / f"torch_{mode}.csv"
    assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                           str(out), "--device", "cpu", *argv]) == 0
    want = _jax_csv(tmp, mode, argv)
    assert out.read_bytes() == want
    assert b",-nan," in want
    assert (b",-0," in want) == (mode != "paired")  # no mate under k
    assert mapped and set(mapped) == {"memmap"}, mapped


@pytest.mark.parametrize("mode", ["plain", "extended", "paired"])
def test_csv_rows_need_no_numpy_gamma(inputs, monkeypatch, tmp_path, mode):
    """classify's CSV path leaves gamma and confidence to the row writer:
    with `score.gamma_confidence` made to raise, the CSV is still the
    JAX package's."""
    from cuclark_tpu_torch import score

    def refuse(*a, **kw):
        raise AssertionError("gamma_confidence called on the CSV path")

    monkeypatch.setattr(score, "gamma_confidence", refuse)
    tmp, _, fq, r1, r2, _ = inputs
    argv = {"plain": ["-O", str(fq)],
            "extended": ["-O", str(fq), "--extended"],
            "paired": ["-P", str(r1), str(r2)]}[mode]
    out = tmp_path / "t.csv"
    assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                           str(out), "--device", "cpu", *argv]) == 0
    assert out.read_bytes() == _jax_csv(tmp, mode, argv)


def _classifier(tmp):
    from cuclark_tpu_torch.hashdb import KmerDB

    return pipeline.Classifier(KmerDB.load(next((tmp / "jdb").glob(
        "db_k*.npz"))), device="cpu")


def test_empty_input(inputs, mapped):
    """An empty file is an empty array (a map of 0 bytes raises):
    `classify_file_to_csv` writes the header alone, as the JAX package's
    does; both CLIs refuse the file with the same message."""
    from cuclark_tpu import pipeline as jpipeline
    from cuclark_tpu.hashdb import KmerDB as JKmerDB

    tmp, _, _, _, _, empty = inputs
    clf = _classifier(tmp)
    assert clf.classify_file_to_csv(str(empty), str(tmp / "t0.csv")) == 0
    clf.close()
    assert mapped == ["ndarray"]
    jclf = jpipeline.Classifier(JKmerDB.load(next((tmp / "jdb").glob(
        "db_k*.npz"))))
    jclf.classify_file_to_csv(str(empty), str(tmp / "j0.csv"))
    assert (tmp / "t0.csv").read_bytes() == (tmp / "j0.csv").read_bytes()
    errs = []
    for main, dev in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(["classify", "-D", str(tmp / "jdb"), "-R",
                         str(tmp / "e.csv"), "-O", str(empty), *dev]) == 1
        errs.append(err.getvalue())
    assert errs[0] == errs[1] and "empty file" in errs[0]


@pytest.fixture
def plain_inflates(monkeypatch):
    """Records every call of the plain inflater (`_inflate_plain`)."""
    calls = []
    plain = pipeline._inflate_plain

    def spy(data):
        calls.append(len(data))
        return plain(data)

    monkeypatch.setattr(pipeline, "_inflate_plain", spy)
    return calls


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_fifo_input(inputs, mapped, plain_inflates, tmp_path, gz):
    """A FIFO is read once, whole (neither probed nor mapped), and
    inflated on the OpenMP team when it carries gzip (the plain
    inflater never called): its CSV is the JAX package's CSV of
    the same reads in a regular file.  Through
    `Classifier.classify_file_to_csv`: the CLI's list-mode check reads
    an -O path before classify does, in both packages."""
    import gzip

    tmp, _, fq, _, _, _ = inputs
    fifo = tmp_path / "reads.fifo"
    os.mkfifo(fifo)
    data = gzip.compress(fq.read_bytes()) if gz else fq.read_bytes()
    out = tmp_path / "torch_fifo.csv"
    clf = _classifier(tmp)
    done = []

    def feed():
        with open(fifo, "wb") as f:
            f.write(data)

    def classify():
        done.append(clf.classify_file_to_csv(str(fifo), str(out)))

    threads = [threading.Thread(target=fn, daemon=True)
               for fn in (feed, classify)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    clf.close()
    assert done and out.read_bytes() == _jax_csv(tmp, "plain",
                                                 ["-O", str(fq)])
    assert mapped == ["ndarray"]
    assert plain_inflates == []
    if gz:
        assert native.inflate_counters()["members"] == 1


def test_gzip_input_not_mapped(inputs, mapped, plain_inflates, tmp_path):
    """A gzip input goes through the inflating reader: the file mapped
    and inflated on the OpenMP team (`native.inflate`), the plain
    inflater never called."""
    import gzip

    tmp, _, fq, _, _, _ = inputs
    gz = tmp_path / "reads.fq.gz"
    gz.write_bytes(gzip.compress(fq.read_bytes()))
    out = tmp_path / "torch_gz.csv"
    assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                           str(out), "--device", "cpu", "-O",
                           str(gz)]) == 0
    assert out.read_bytes() == _jax_csv(tmp, "plain", ["-O", str(fq)])
    assert mapped == ["ndarray"]
    assert plain_inflates == []
    assert native.inflate_counters()["members"] == 1


def test_mapped_buffer_is_read_only(inputs):
    """A caller that wrote into the input would raise, not corrupt the
    file: the map is read-only."""
    _, _, fq, _, _, _ = inputs
    buf = pipeline._read_file_bytes(fq)
    assert isinstance(buf, np.memmap) and not buf.flags.writeable
    with pytest.raises(ValueError):
        buf[0] = 0


def test_simulate_reads_on_mapped_genomes(inputs, mapped, tmp_path):
    """simulate-reads reads its genomes through the map and writes the
    JAX package's reads."""
    _, targets, _, _, _, _ = inputs
    argv = ["simulate-reads", "-T", str(targets), "-n", "300", "-l", "80"]
    assert _run(cli.main, argv + ["-O", str(tmp_path / "t.fq")]) == 0
    assert _run(jcli.main, argv + ["-O", str(tmp_path / "j.fq")]) == 0
    assert (tmp_path / "t.fq").read_bytes() == \
        (tmp_path / "j.fq").read_bytes()
    assert mapped and set(mapped) == {"memmap"}


def test_num_hosts_paired_on_mapped_input(inputs, mapped, tmp_path):
    """--num-hosts 2 on the mate files (scanned whole, sharded by record
    index): each host's CSV is the JAX package's, and the two rows
    concatenate to the unsharded paired CSV."""
    tmp, _, _, r1, r2, _ = inputs
    rows = []
    for h in range(2):
        argv = ["-P", str(r1), str(r2), "--num-hosts", "2", "--host-id",
                str(h)]
        out = tmp_path / f"torch_h{h}.csv"
        assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                               str(out), "--device", "cpu", *argv]) == 0
        got = out.read_bytes()
        jout = tmp_path / f"jax_h{h}.csv"
        assert _run(jcli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                                str(jout), *argv]) == 0
        assert got == jout.read_bytes()
        rows.append(got)
    full = _jax_csv(tmp, "paired", ["-P", str(r1), str(r2)])
    assert rows[0] + rows[1].split(b"\n", 1)[1] == full
    assert mapped and set(mapped) == {"memmap"}
