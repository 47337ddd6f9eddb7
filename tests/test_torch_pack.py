"""The 2-bit wire pack of eight bases a step (`native.pack_block2`,
`native.pack_block2_paired`) byte for byte in packed2, vbits and lengths
against its one-base plain versions (`pack_block2_plain`,
`pack_block2_paired_plain`), the JAX package's native pack and its
dispatchers: every byte value, \\n and \\r\\n line ends, multi-line FASTA,
records of length 0, 1, 7, 8, 9, 31, 32, 33 and longer than maxw, Lp
equal to and above the longest record, padding rows, mate-1 lengths of
every residue mod 8 and teams 1, 2 and the default; the pack into
caller-given arrays; the pinned ring's slot discipline with a stand-in
event; and classify's CSV on the CPU against the JAX CLI's for
single-end, paired and multi-line FASTA input."""

import contextlib
import io
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from cuclark_tpu import cli as jcli
from cuclark_tpu import native as jnative
from cuclark_tpu.io import fast_parse as jfast_parse
from cuclark_tpu_torch import cli, native, pipeline
from cuclark_tpu_torch.io import fast_parse
from tests.test_end2end import make_genomes, sample_reads

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="no C++ toolchain")

ROOT = Path(__file__).resolve().parent.parent
LENGTHS = (0, 1, 7, 8, 9, 31, 32, 33, 150, 300)
TEAMS = (1, 2, 0)


def _join(recs: list) -> tuple:
    """(buf, seq_s, seq_e) of byte strings laid out one after another,
    each behind a one-byte gap."""
    buf, s, e, pos = [], [], [], 0
    for r in recs:
        buf.append(b"@" + r)
        s.append(pos + 1)
        pos += 1 + len(r)
        e.append(pos)
    return (np.frombuffer(b"".join(buf) or b"\0", np.uint8)[:pos].copy(),
            np.array(s, np.int64), np.array(e, np.int64))


def _records(kind: str, seed: int = 0) -> list:
    """Records of one kind (byte strings)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGTacgtUuN", np.uint8)

    def bases(n, alphabet=acgt):
        return alphabet[rng.integers(0, len(alphabet), n)].tobytes()

    if kind == "all_bytes":
        # every byte value at every offset of an 8-byte step, inside
        # runs of bases and alone
        out = [bytes(range(256)), bytes(range(255, -1, -1))]
        for v in range(256):
            out.append(bases(int(rng.integers(0, 40))) + bytes([v])
                       + bases(int(rng.integers(0, 40))))
        out += [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in LENGTHS]
        return out
    if kind == "lf":
        return [bases(60) + b"\n" + bases(n) for n in LENGTHS]
    if kind == "crlf":
        return [bases(n) + b"\r\n" + bases(33) + b"\r\n" for n in LENGTHS]
    if kind == "fasta":
        # multi-line records of 60 and 80 bases a line, and newlines at
        # every offset of a step, runs of them included
        out = []
        for width in (60, 80, 7, 1):
            s = bases(int(rng.integers(100, 400)))
            out.append(b"\n".join(s[i:i + width]
                                  for i in range(0, len(s), width)) + b"\n")
        for off in range(16):
            out.append(bases(off) + b"\n\n\r\n" + bases(40 - off) + b"\n")
        return out
    if kind == "lengths":
        return [bases(n) for n in LENGTHS for _ in range(3)]
    raise ValueError(kind)


KINDS = ("all_bytes", "lf", "crlf", "fasta", "lengths")


def _widths(recs: list) -> dict:
    """maxw equal to the longest record's length, above it, and below
    it (records longer than maxw)."""
    longest = max(max(len(r) for r in recs), 1)
    return {"equal": longest, "above": longest + 37, "below": 33}


def _eq(got, *wants):
    for want in wants:
        assert len(got) == len(want) == 3
        for g, w, name in zip(got, want, ("packed2", "vbits", "lengths")):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("width", ["equal", "above", "below"])
@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("kind", KINDS)
def test_pack_matches_plain_and_jax(kind, team, width, pad):
    """pack_block2 == pack_block2_plain == the JAX package's pack and
    dispatcher, padding rows (n_rows above nrec) all zero."""
    recs = _records(kind)
    buf, s, e = _join(recs)
    L = _widths(recs)[width]
    R = len(recs) + pad
    got = native.pack_block2(buf, s, e, L, R, threads=team)
    _eq(got, native.pack_block2_plain(buf, s, e, L, R),
        jnative.pack_block2(buf, s, e, L, R),
        jfast_parse.pack_block2_dispatch(buf, s, e, L, R),
        fast_parse.pack_block2_dispatch(buf, s, e, L, R))
    assert not got[0][len(recs):].any() and not got[1][len(recs):].any()
    assert not got[2][len(recs):].any()


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("residue", range(8))
def test_paired_pack_every_mate2_offset(residue, team):
    """pack_block2_paired == its plain version == the JAX package's for
    mate-1 lengths of every residue mod 8, so mate 2 starts at every
    offset of a step (len1 + 1), with mates of every kind and length."""
    rng = np.random.default_rng(residue)
    m2 = [r for k in KINDS for r in _records(k, residue + 1)]
    m1 = [bytes(np.frombuffer(b"ACGTN\n", np.uint8)[
        rng.integers(0, 5, 8 * int(rng.integers(0, 20)) + residue)])
        for _ in m2]
    b1, s1, e1 = _join(m1)
    b2, s2, e2 = _join(m2)
    for L in (max(len(a) + len(b) for a, b in zip(m1, m2)) + 1, 64, 152):
        R = len(m1) + 2
        got = native.pack_block2_paired(b1, s1, e1, b2, s2, e2, L, R,
                                        threads=team)
        _eq(got,
            native.pack_block2_paired_plain(b1, s1, e1, b2, s2, e2, L, R),
            jnative.pack_block2_paired(b1, s1, e1, b2, s2, e2, L, R),
            jfast_parse.pack_block2_paired_dispatch(b1, s1, e1, b2, s2, e2,
                                                    L, R))


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("seed", range(4))
def test_random_records(seed, team):
    """Random records over bases, newlines and other bytes, at random
    offsets and widths, single-end and paired."""
    rng = np.random.default_rng(100 + seed)
    alpha = np.frombuffer(b"ACGTACGTACGTacgtN\n\r\x00\xff-", np.uint8)
    buf = alpha[rng.integers(0, len(alpha), 20000)]
    n = 200
    s = np.sort(rng.integers(0, len(buf), n))
    e = np.minimum(s + rng.integers(0, 500, n), len(buf))
    s2 = rng.permutation(s)
    e2 = np.minimum(s2 + rng.integers(0, 500, n), len(buf))
    for L in (8, 152, 333, 520):
        _eq(native.pack_block2(buf, s, e, L, n + 1, threads=team),
            native.pack_block2_plain(buf, s, e, L, n + 1),
            jnative.pack_block2(buf, s, e, L, n + 1))
        _eq(native.pack_block2_paired(buf, s, e, buf, s2, e2, L, n,
                                      threads=team),
            native.pack_block2_paired_plain(buf, s, e, buf, s2, e2, L, n),
            jnative.pack_block2_paired(buf, s, e, buf, s2, e2, L, n))


@pytest.mark.parametrize("paired", [False, True])
def test_pack_into_given_arrays(paired):
    """With `out`, the pack writes every byte of the given arrays (they
    start as garbage) and returns them; wrong shapes or dtypes raise."""
    recs = _records("lengths")
    buf, s, e = _join(recs)
    L, R = 152, len(recs) + 5
    w2, wv = native.wire_shape(L)
    out = (np.full((R, w2), 0xAA, np.uint8), np.full((R, wv), 0x55, np.uint8),
           np.full(R, -7, np.int64))
    args = (buf, s, e, buf, e, e) if paired else (buf, s, e)
    fn = native.pack_block2_paired if paired else native.pack_block2
    got = fn(*args, L, R, out=out)
    assert all(g is o for g, o in zip(got, out))
    _eq(got, fn(*args, L, R))
    via = (fast_parse.pack_block2_paired_dispatch if paired
           else fast_parse.pack_block2_dispatch)
    out2 = tuple(np.ones_like(a) for a in out)
    _eq(via(*args, L, R, out=out2), got)
    with pytest.raises(ValueError):
        fn(*args, L, R, out=(out[0][:, :-1], out[1], out[2]))
    with pytest.raises(ValueError):
        fn(*args, L, R, out=(out[0], out[1], out[2].astype(np.int32)))


def test_pack_team():
    """pack_team: the team asked for, else one thread below 256 rows."""
    assert native.pack_team(10, 3) == 3
    assert native.pack_team(255) == 1
    assert native.pack_team(256) >= 1


@pytest.mark.parametrize("omp", [1, 2, 3, 8, 40])
def test_default_teams_split_the_cores(omp):
    """The pack's default team is half of OMP_NUM_THREADS (rounded down,
    at least one) and the row writer's the rest (at most 16): the two
    run at the same time in classify."""
    code = ("import ctypes; from cuclark_tpu_torch import native; "
            "print(ctypes.CDLL('libgomp.so.1').omp_get_max_threads(), "
            "native.pack_team(16384), native.format_team(16384))")
    env = {**os.environ, "OMP_NUM_THREADS": str(omp)}
    T, pack, rows = (int(x) for x in subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT,
        capture_output=True, text=True, check=True,
        timeout=120).stdout.split())
    assert T == omp or omp > os.cpu_count()  # libgomp may cap at the cores
    assert pack == max(T // 2, 1)
    assert rows == min(max(T - pack, 1), 16)


# ---- the pinned ring ----

class _Event:
    """A stand-in for torch.cuda.Event: not done until released."""

    def __init__(self):
        self.done = threading.Event()
        self.recorded = None

    def record(self, stream=None):
        self.recorded = stream

    def query(self) -> bool:
        return self.done.is_set()

    def synchronize(self):
        assert self.done.wait(30)


def test_ring_waits_for_a_pending_copy():
    """A slot whose copy event is pending is never handed out: acquire
    blocks until that event completes, then returns the slot, with its
    event done; slots go round in order."""
    events = []

    def make():
        events.append(_Event())
        return events[-1]

    ring = pipeline._WireRing(2, lambda: "copy stream", pin=False,
                              event=make)
    s0, p0, v0 = ring.acquire(4, 38, 19)
    ring.upload(s0, "cpu")
    s1, _, _ = ring.acquire(4, 38, 19)
    ring.upload(s1, "cpu")
    assert (s0, s1) == (0, 1) and events[0].recorded == "copy stream"
    assert p0.shape == (4, 38) and v0.shape == (4, 19)
    got = []
    t = threading.Thread(target=lambda: got.append(ring.acquire(4, 38, 19)))
    t.start()
    time.sleep(0.3)
    assert not got and t.is_alive()   # slot 0's copy is pending
    events[1].done.set()              # slot 1's copy is not the one
    time.sleep(0.1)
    assert not got
    events[0].done.set()
    t.join(10)
    assert not t.is_alive()
    assert got[0][0] == 0 and events[0].query()
    # slot 1's event is done: handed out at once, its buffer grown
    s, p, v = ring.acquire(9, 80, 40)
    assert s == 1 and p.shape == (9, 80) and v.shape == (9, 40)
    ring.upload(s, "cpu")             # the slot's event is made once
    assert len(events) == 2 and events[1].recorded == "copy stream"


def test_ring_buffers_and_upload():
    """A slot keeps its buffer while it fits (the same memory each time
    round; the same views for the same shape), holds vbits right after
    packed2, and uploads both in one copy."""
    ring = pipeline._WireRing(pipeline.WIRE_RING_SLOTS, lambda: None,
                              pin=False, event=_DoneEvent)
    first = [ring.acquire(16, 38, 19) for _ in range(
        pipeline.WIRE_RING_SLOTS)]
    again = [ring.acquire(8, 38, 19) for _ in range(
        pipeline.WIRE_RING_SLOTS)]
    base = [a[1].ctypes.data for a in first]
    assert base == [a[1].ctypes.data for a in again]
    assert len(set(base)) == pipeline.WIRE_RING_SLOTS
    assert pipeline.WIRE_RING_SLOTS == pipeline.PREFETCH_DEPTH + 2
    s, p2, vb = ring.acquire(8, 38, 19)
    assert p2 is again[0][1] and vb is again[0][2]
    assert vb.ctypes.data == p2.ctypes.data + p2.nbytes
    p2[:] = 7
    vb[:] = 9
    d2, dv = ring.upload(s, "cpu")
    assert d2.shape == (8, 38) and dv.shape == (8, 19)
    assert (d2 == 7).all() and (dv == 9).all()


class _DoneEvent(_Event):
    def __init__(self):
        super().__init__()
        self.done.set()


# ---- classify's CSV on the CPU ----

def _run(main, argv) -> int:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Genomes, a DB built by the JAX package, reads as FASTQ, as mate
    files and as a multi-line FASTA (and its CRLF copy)."""
    tmp = tmp_path_factory.mktemp("torch_pack_csv")
    genomes = make_genomes()
    lines = []
    for t, seqs in genomes.items():
        p = tmp / f"g{t}.fa"
        p.write_text(f">genome{t}\n" + "\n".join(seqs) + "\n")
        lines.append(f"{p} TAX{t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    reads = sample_reads(genomes, n_reads=300)
    (tmp / "reads.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    fa = "".join(f">{n} x\n" + "".join(s[i:i + 37] + "\n"
                                       for i in range(0, len(s), 37))
                 for n, s in reads)
    (tmp / "reads.fa").write_text(fa)
    (tmp / "reads_crlf.fa").write_bytes(fa.replace("\n", "\r\n").encode())
    mates = [(n, s[:70], s[-61:]) for n, s in sample_reads(genomes, 200)]
    (tmp / "r1.fq").write_text("".join(
        f"@{n}/1\n{a}\n+\n{'I' * len(a)}\n" for n, a, _ in mates))
    (tmp / "r2.fq").write_text("".join(
        f"@{n}/2\n{b}\n+\n{'I' * len(b)}\n" for n, _, b in mates))
    assert _run(jcli.main, ["build-db", "-T", str(targets), "-k", "27",
                            "-D", str(tmp / "jdb")]) == 0
    return tmp


MODES = {"single": ["-O", "reads.fq"], "fasta": ["-O", "reads.fa"],
         "fasta_crlf": ["-O", "reads_crlf.fa"],
         "paired": ["-P", "r1.fq", "r2.fq"]}


def _argv(tmp, mode):
    return [str(tmp / a) if a.endswith((".fq", ".fa")) else a
            for a in MODES[mode]]


@pytest.mark.parametrize("mode", list(MODES))
def test_csv_matches_jax_cli(inputs, mode):
    """`classify --device cpu` writes the JAX CLI's CSV byte for byte."""
    tmp = inputs
    want, got = tmp / f"jax_{mode}.csv", tmp / f"torch_{mode}.csv"
    assert _run(jcli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                            str(want), *_argv(tmp, mode)]) == 0
    assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                           str(got), "--device", "cpu",
                           *_argv(tmp, mode)]) == 0
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("mode", list(MODES))
def test_csv_through_the_ring(inputs, mode, monkeypatch):
    """`Classifier.classify_file_to_csv` packing into a ring of plain
    tensors (the card's path, with stand-in events and small batches, so
    that every slot is used many times round) writes the JAX CLI's CSV
    byte for byte."""
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import KmerDB

    tmp = inputs
    want = tmp / f"jax_ring_{mode}.csv"
    assert _run(jcli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                            str(want), *_argv(tmp, mode)]) == 0
    clf = pipeline.Classifier(
        KmerDB.load(next((tmp / "jdb").glob("db_k*.npz"))),
        ClassifyConfig(batch_reads=16), device="cpu")
    clf._ring = pipeline._WireRing(pipeline.WIRE_RING_SLOTS, lambda: None,
                                   pin=False, event=_DoneEvent)
    acquired = []
    acquire = clf._ring.acquire
    monkeypatch.setattr(clf._ring, "acquire",
                        lambda *a: acquired.append(1) or acquire(*a))
    args = _argv(tmp, mode)
    paths = args[1:]
    got = tmp / f"ring_{mode}.csv"
    n = clf.classify_file_to_csv(paths[0], got,
                                 paths[1] if len(paths) > 1 else None)
    assert n == len(acquired) * 16 - (-n % 16) and len(acquired) > 8
    assert got.read_bytes() == want.read_bytes()
