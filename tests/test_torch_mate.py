"""The port's native mate-id check (`native.first_mate_mismatch`, on the
OpenMP team) against its numpy plain version
(`fast_parse.first_mate_mismatch_plain`) and the JAX package's
`fast_parse.first_mate_mismatch`, at teams 1, 2, 3 and 8: drawn names
(slashes, several slashes, none, empty names, NUL bytes, ids of unequal
length with an equal prefix), mismatches at the first and last record
and on each side of every team range's boundary, files of unequal
record counts, the offsets as classify slices them for a resumed run
and for --num-hosts, and the paired CLI: its error on a mismatch and its
CSV on equal mates, each against `cuclark-tpu classify`."""

import contextlib
import io
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cuclark_tpu import cli as jcli
from cuclark_tpu import native as jnative
from cuclark_tpu.io import fast_parse as jfast_parse
from cuclark_tpu_torch import cli, native
from cuclark_tpu_torch.io import fast_parse

TEAMS = (1, 2, 3, 8)

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="no C++ toolchain")


def _layout(names, sep: bytes = b"\n") -> tuple:
    """(buffer, starts, ends) of `names` laid out one after another with
    `sep` between them."""
    ends, pos = [], 0
    for x in names:
        pos += len(x)
        ends.append(pos)
        pos += len(sep)
    buf = np.frombuffer(sep.join(names) + sep, np.uint8)
    ne = np.array(ends, np.int64)
    ns = ne - np.array([len(x) for x in names], np.int64)
    return buf, ns, ne


def _answers(a, b, teams=TEAMS) -> set:
    """Every answer for the mates `a` and `b`, each a (buffer, starts,
    ends): the native check's at each team, the plain version's and the
    JAX package's."""
    args = (*a, *b)
    got = {native.first_mate_mismatch(*args, threads=t) for t in teams}
    got.add(native.first_mate_mismatch(*args))
    got.add(fast_parse.first_mate_mismatch_plain(*args))
    got.add(fast_parse.first_mate_mismatch(*args))
    got.add(jfast_parse.first_mate_mismatch(*args))
    return got


def _srr(n: int, mate: int) -> list:
    return [b"SRR1234567.%d/%d" % (i, mate) for i in range(n)]


# ---- drawn names ----

_BYTES = st.sampled_from(list(b"ab/\0.:1"))
_NAME = st.lists(_BYTES, max_size=10).map(bytes)
_PAIR = st.one_of(
    st.tuples(_NAME, _NAME),  # unrelated
    st.builds(lambda i, s1, s2: (i + b"/" + s1, i + b"/" + s2),
              _NAME, _NAME, _NAME),  # one id, any suffixes
    st.builds(lambda i, x: (i, i + x), _NAME, _NAME.filter(
        lambda x: b"/" not in x and x != b"")),  # an equal prefix
    _NAME.map(lambda x: (x, x)),  # equal names
)


@pytest.mark.parametrize("team", TEAMS)
@settings(max_examples=80, deadline=None)
@given(pairs=st.lists(_PAIR, min_size=1, max_size=40))
def test_drawn_names(team, pairs):
    """Names of slashes, several slashes, none, empty, NUL bytes and ids
    of unequal length with an equal prefix: one index from all."""
    a = _layout([p[0] for p in pairs])
    b = _layout([p[1] for p in pairs], b"\t\t")
    got = _answers(a, b, (team,))
    assert len(got) == 1, got


def test_separators_and_nul():
    """The id ends at the first '/', a name without one is its id, an
    empty name matches only an empty id, and a NUL is an ordinary byte."""
    cases = [((b"r1/1", b"r1/2"), -1), ((b"r1/1/x", b"r1/2/y"), -1),
             ((b"r1", b"r1/2"), -1), ((b"", b"/2"), -1), ((b"", b""), -1),
             ((b"r1", b"r12"), 0), ((b"r1/1", b"r12/1"), 0),
             ((b"a\0b/1", b"a\0b/2"), -1), ((b"a\0b/1", b"a\0c/1"), 0),
             ((b"a\0/1", b"a/1"), 0), ((b"", b"a"), 0)]
    for (x, y), want in cases:
        assert _answers(_layout([x]), _layout([y])) == {want}, (x, y)


# ---- planted mismatches ----

N_PLANT = 5000


@pytest.fixture(scope="module")
def mates():
    """N_PLANT pairs named SRR....i/1 and /2 (both files), and Casava 1.8
    names (the scan's cut at the space leaves equal ids)."""
    casava = [b"EAS139:136:FC706VJ:2:2104:%d:%d" % (i % 97, i)
              for i in range(N_PLANT)]
    return {"srr": (_srr(N_PLANT, 1), _srr(N_PLANT, 2)),
            "casava": (casava, list(casava))}


def _plant(names, at) -> list:
    """`names` with the id of each record in `at` changed (its last id
    byte replaced)."""
    out = list(names)
    for i in at:
        x = out[i]
        cut = x.find(b"/")
        j = (cut if cut >= 0 else len(x)) - 1
        out[i] = x[:j] + (b"Z" if x[j:j + 1] != b"Z" else b"Y") + x[j + 1:]
    return out


def _boundaries(n: int) -> list:
    """Each side of every team range's first record, for every team."""
    out = set()
    for T in TEAMS:
        for t in range(1, T):
            lo = n * t // T
            out |= {lo - 1, lo}
    return sorted(out)


@pytest.mark.parametrize("style", ["srr", "casava"])
def test_planted_mismatches(mates, style):
    """A mismatch at the first record, the last, on each side of every
    team range's boundary, at a random record; two mismatches give the
    lower; equal mates give -1."""
    m1, m2 = mates[style]
    a = _layout(m1)
    assert _answers(a, _layout(m2)) == {-1}
    rng = np.random.default_rng(1)
    for at in ([0], [N_PLANT - 1], [int(rng.integers(N_PLANT))],
               *([b] for b in _boundaries(N_PLANT))):
        assert _answers(a, _layout(_plant(m2, at))) == {at[0]}, at
    for lo, hi in ((10, 4000), (1200, 1300), (2499, 2500), (0, N_PLANT - 1)):
        assert _answers(a, _layout(_plant(m2, [hi, lo]))) == {lo}


def test_team_ranges_above_the_step():
    """Ranges longer than the check's step between looks at the shared
    minimum: a mismatch deep in a high range and one early in a low
    range give the low one at every team; many mismatches give the
    first."""
    n = 40_000
    m1, m2 = _srr(n, 1), _srr(n, 2)
    a = _layout(m1)
    for at in ([39_000, 2_100], [30_001, 20_000], [5, 39_999],
               list(range(7_000, n, 3))):
        got = {native.first_mate_mismatch(*a, *_layout(_plant(m2, at)),
                                          threads=t)
               for t in (1, 2, 3, 8, 16, 64)}
        got.add(fast_parse.first_mate_mismatch_plain(
            *a, *_layout(_plant(m2, at))))
        assert got == {min(at)}, at


def test_unequal_record_counts():
    """n = the shorter file's records: a mismatch past it is not seen."""
    m1, m2 = _srr(300, 1), _srr(200, 2)
    a, b = _layout(m1), _layout(m2)
    assert _answers(a, b) == {-1}
    assert _answers(b, a) == {-1}
    assert _answers(a, _layout(_plant(m2, [199]))) == {199}
    assert _answers(_layout(_plant(m1, [250])), b) == {-1}
    empty = (np.zeros(0, np.uint8), np.zeros(0, np.int64),
             np.zeros(0, np.int64))
    assert _answers(empty, b) == {-1}


def test_default_team():
    """One thread below 16,384 records and never more than the records;
    a pinned team as asked."""
    assert native.mate_team(16_383) == 1
    assert native.mate_team(5, 8) == 5
    assert native.mate_team(100_000, 3) == 3
    assert native.mate_team(1 << 20) >= 1


def test_offsets_outside_the_buffer():
    """A name past its buffer raises instead of being read."""
    buf, ns, ne = _layout([b"r1/1", b"r2/1"])
    with pytest.raises(ValueError, match="outside"):
        native.first_mate_mismatch(buf, ns, ne + 100, buf, ns, ne)


@pytest.mark.parametrize("num_hosts", [1, 2, 3])
@pytest.mark.parametrize("skip", [0, 7])
def test_sliced_as_classify_slices(num_hosts, skip):
    """The offsets as `_scan_for_classify` slices them: a host's record
    shard of mate 1 (less `skip`) against mate 2 from record rec_lo +
    skip on; a mismatch inside the shard, before it and after it."""
    n = 3000
    f1 = b"".join(b"@%s\nACGT\n+\nIIII\n" % x for x in _srr(n, 1))
    buf1 = np.frombuffer(f1, np.uint8)
    ns1, ne1, _, _ = native.scan(buf1)
    for host_id in range(num_hosts):
        per = n // num_hosts
        rec_lo = per * host_id
        rec_hi = n if host_id == num_hosts - 1 else per * (host_id + 1)
        first = rec_lo + skip
        for at in (first, (first + rec_hi) // 2, rec_hi - 1, rec_lo - 1,
                   rec_hi):
            if not 0 <= at < n:
                continue
            f2 = b"".join(b"@%s 2:N:0\nACGT\n+\nIIII\n" % x
                          for x in _plant(_srr(n, 2), [at]))
            buf2 = np.frombuffer(f2, np.uint8)
            ns2, ne2, _, _ = native.scan(buf2)
            a = (buf1, ns1[rec_lo:rec_hi][skip:], ne1[rec_lo:rec_hi][skip:])
            b = (buf2, ns2[first:], ne2[first:])
            want = at - first if first <= at < rec_hi else -1
            assert _answers(a, b) == {want}, (host_id, at)


# ---- the paired CLI ----

def _run(main, argv) -> tuple[int, str]:
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


N_CLI = 20_000  # above the check's one-thread floor


@pytest.fixture(scope="module")
def cli_demo(tmp_path_factory):
    """Two genomes, a DB built by the JAX package (k=21), and N_CLI pairs
    of 24-base mates named SRR....i/1 and /2."""
    tmp = tmp_path_factory.mktemp("torch_mate")
    rng = random.Random(5)
    lines = []
    genomes = []
    for t in (1, 2):
        g = "".join(rng.choice("ACGT") for _ in range(2000))
        genomes.append(g)
        (tmp / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp / f'g{t}.fa'} T{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    assert _run(jcli.main, ["build-db", "-T", str(tmp / "targets.txt"),
                            "-k", "21", "-D", str(tmp / "jdb")])[0] == 0
    pos = [rng.randrange(0, 1900) for _ in range(N_CLI)]
    for mate in (1, 2):
        off = 0 if mate == 1 else 60
        (tmp / f"r{mate}.fq").write_text("".join(
            f"@SRR1234567.{i}/{mate}\n"
            f"{genomes[i % 2][p + off // 2:p + off // 2 + 24]}\n+\n"
            f"{'I' * 24}\n" for i, p in enumerate(pos)))
    return tmp


@pytest.mark.parametrize("flags", [[], ["--num-hosts", "2", "--host-id",
                                        "1"]], ids=["whole", "host_1"])
def test_cli_mismatch_error_matches_jax(cli_demo, tmp_path, flags):
    """A mate id planted at a random record (in host 1's shard): the same
    error (rc 1) as `cuclark-tpu classify`, and no CSV."""
    tmp = cli_demo
    lines = (tmp / "r2.fq").read_text().splitlines()
    at = random.Random(3).randrange(N_CLI // 2, N_CLI)
    lines[4 * at] = f"@SRR7654321.{at}/2"
    bad = tmp_path / "bad2.fq"
    bad.write_text("\n".join(lines) + "\n")
    argv = ["classify", "-D", str(tmp / "jdb"), "-P", str(tmp / "r1.fq"),
            str(bad), *flags]
    jrc, jerr = _run(jcli.main, argv + ["-R", str(tmp_path / "j.csv")])
    rc, err = _run(cli.main, argv + ["-R", str(tmp_path / "t.csv"),
                                     "--device", "cpu"])
    assert (rc, err) == (jrc, jerr) == (1, err)
    assert f"at record {at}:" in err and "SRR7654321" in err
    assert not (tmp_path / "t.csv").exists()


def test_cli_equal_mates_csv_matches_jax(cli_demo, tmp_path):
    """Equal mate ids: the port's paired CSV is `cuclark-tpu`'s, byte for
    byte."""
    tmp = cli_demo
    argv = ["classify", "-D", str(tmp / "jdb"), "-P", str(tmp / "r1.fq"),
            str(tmp / "r2.fq")]
    assert _run(jcli.main, argv + ["-R", str(tmp_path / "j.csv")])[0] == 0
    assert _run(cli.main, argv + ["-R", str(tmp_path / "t.csv"),
                                  "--device", "cpu"])[0] == 0
    got = (tmp_path / "t.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes()
    assert got.count(b"\n") == N_CLI + 1
