"""The gzip inflater on the OpenMP team (`native.inflate`), against the
reference's reader (`pipeline._inflate_plain`: `gzip.GzipFile(...)
.read()`, what `cuclark_tpu/pipeline.py` reads a gzip input with).

Every case is inflated at teams 1, 2, 3 and 8 and at chunk sizes that
cut it into many speculative chunks, through `pipeline._read_file_bytes`
on a regular file (mapped) and on a FIFO's bytes: the bytes must be the
plain version's, and the plain version must never be called on a valid
input.  A bad input raises the plain version's exception and message.
The classify CSV of gzip inputs is the JAX package's CSV of the same
reads, single-end, paired, from a FIFO, on two hosts and resumed.
"""

import contextlib
import functools
import gzip
import io
import os
import struct
import threading
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cuclark_tpu import cli as jcli
from cuclark_tpu_torch import cli, native, pipeline
from tests.test_end2end import make_genomes, sample_reads

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native module (g++)")

TEAMS = (1, 2, 3, 8)
CHUNKS = (0, 1500, 9000)   # 0: from the input and the team


# ---- inputs ----

def fastq(n: int, seed: int) -> bytes:
    """150 bp reads with Illumina's binned qualities ('#,:F')."""
    rng = np.random.default_rng(seed)
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (n, 150))
    quals = rng.choice(np.frombuffer(b"#,:F", np.uint8), (n, 150),
                       p=[.05, .1, .15, .7])
    return b"".join(b"@SRR1234567.%d length=150\n%s\n+\n%s\n"
                    % (i, seqs[i].tobytes(), quals[i].tobytes())
                    for i in range(n))


def raw_deflate(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def member(data: bytes, level: int = 6, flags: int = 0, extra: bytes = b"",
           name: bytes = b"", comment: bytes = b"") -> bytes:
    """One gzip member (RFC 1952) with the header fields `flags` asks
    for; FHCRC holds the header's CRC16 (the reader skips it)."""
    h = b"\x1f\x8b\x08" + bytes([flags]) + b"\x00\x00\x00\x00\x00\xff"
    if flags & 4:
        h += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        h += name + b"\x00"
    if flags & 16:
        h += comment + b"\x00"
    if flags & 2:
        h += struct.pack("<H", zlib.crc32(h) & 0xFFFF)
    return h + raw_deflate(data, level) + struct.pack(
        "<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")


def bgzf(data: bytes, level: int = 6, size: int = 65280) -> bytes:
    """BGZF as htslib's bgzip writes it: members of at most `size` bytes,
    each with the 'BC' subfield (BSIZE = member size - 1), then the
    empty EOF member."""
    out = []
    for i in range(0, len(data), size):
        piece = data[i:i + size]
        d = raw_deflate(piece, level)
        bsize = 18 + len(d) + 8 - 1
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02"
                   b"\x00" + struct.pack("<H", bsize) + d
                   + struct.pack("<II", zlib.crc32(piece), len(piece)))
    return b"".join(out) + BGZF_EOF


def _payloads() -> dict:
    rng = np.random.default_rng(11)
    fq = fastq(1200, 3)
    unit = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    return {
        "fastq": fq,
        "empty": b"",
        "tiny": b"ACGTTGCAAC" * 2,          # a 20-byte payload
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        # matches of 258 at distance 1,000 across every chunk start
        "repeats": unit * 300,
        "run": b"A" * 400_000 + fq[:30_000],
    }


def _cases() -> dict:
    p = _payloads()
    fq = p["fastq"]
    cases = {}
    for name, data in p.items():
        for level in (0, 1, 6, 9):
            cases[f"{name}-{level}"] = gzip.compress(data, level, mtime=0)
    h = len(fq) // 3
    cases["concatenated"] = (member(fq[:h], 6) + member(b"") + member(
        fq[h:2 * h], 1) + member(fq[2 * h:], 9) + member(p["tiny"], 0))
    # a final block inside a chunk, another member right after it
    cases["short-then-long"] = member(fq[:3000]) + member(fq, 9)
    cases["bgzf"] = bgzf(fq)
    cases["bgzf-small"] = bgzf(fq, 6, 9000)
    cases["bgzf-then-member"] = bgzf(fq[:100_000], 6, 7000) + member(fq)
    cases["member-then-bgzf"] = member(fq[:5000]) + bgzf(fq, 1, 20_000)
    cases["all-flags"] = member(fq, 6, 2 | 4 | 8 | 16, extra=b"ab\x02\x00xy",
                                name=b"reads.fq", comment=b"a comment")
    for f in (1, 2, 4, 8, 16, 0xE0):
        cases[f"flag-{f}"] = member(fq[:50_000], 6, f, extra=b"BC\x02\x00\x00"
                                    b"\x00", name=b"n", comment=b"")
    cases["zero-padding"] = gzip.compress(fq, mtime=0) + b"\x00" * 513
    cases["padding-between"] = member(fq[:h]) + b"\x00" * 7 + member(fq[h:])
    cases["empty-member"] = member(b"")
    cases["stored-over-64k"] = member(p["random"][:150_000], 0)
    return cases


CASES = _cases()


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain version's calls from the route."""
    calls = []
    plain = pipeline._inflate_plain

    def spy(data):
        calls.append(len(data))
        return plain(data)

    monkeypatch.setattr(pipeline, "_inflate_plain", spy)
    return calls


_INFLATE = native.inflate
PLAIN = pipeline._inflate_plain   # the reference's reader, never spied


def _pinned(monkeypatch, team: int, chunk: int):
    """`native.inflate` as the route calls it, pinned to a team and a
    chunk size."""
    monkeypatch.setattr(native, "inflate", functools.partial(
        _INFLATE, threads=team, chunk=chunk))


def _fifo_bytes(path, data: bytes) -> np.ndarray:
    os.mkfifo(path)
    t = threading.Thread(target=lambda: open(path, "wb").write(data),
                         daemon=True)
    t.start()
    try:
        return pipeline._read_file_bytes(path)
    finally:
        t.join(timeout=60)


# ---- equal bytes ----

@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_inflate_equals_plain(case, team, tmp_path, monkeypatch, plain_calls):
    """Each case's bytes through the route (the file mapped) at every
    chunk size equal the plain version's; the plain version is never
    called."""
    gz = CASES[case]
    want = PLAIN(gz)
    path = tmp_path / "in.gz"
    path.write_bytes(gz)
    for chunk in CHUNKS:
        _pinned(monkeypatch, team, chunk)
        got = pipeline._read_file_bytes(path)
        assert got.dtype == np.uint8 and not got.flags.writeable
        assert got.tobytes() == want, (case, team, chunk)
        c = native.inflate_counters()
        assert c["team"] == team
        assert c["members"] == _members(gz)
    assert plain_calls == []


def _members(gz: bytes) -> int:
    """Members in a valid gzip file, found as GzipFile finds them."""
    n, p = 0, 0
    while p < len(gz):
        flg, p = gz[p + 3], p + 10
        if flg & 4:
            p += 2 + int.from_bytes(gz[p:p + 2], "little")
        for f in (8, 16):
            if flg & f:
                p = gz.index(b"\x00", p) + 1
        p += 2 if flg & 2 else 0
        o = zlib.decompressobj(-15)
        o.decompress(gz[p:])
        p = len(gz) - len(o.unused_data) + 8
        while p < len(gz) and gz[p] == 0:
            p += 1
        n += 1
    return n


@pytest.mark.parametrize("case", ["fastq-6", "concatenated", "bgzf",
                                  "repeats-9", "random-1"])
def test_fifo_bytes_equal_plain(case, tmp_path, monkeypatch, plain_calls):
    """A FIFO's gzip bytes inflate on the team to the plain version's."""
    _pinned(monkeypatch, 3, 1500)
    got = _fifo_bytes(tmp_path / "in.fifo", CASES[case])
    assert got.tobytes() == PLAIN(CASES[case])
    assert plain_calls == []


def test_chunks_are_guessed_and_confirmed():
    """Small chunks cut a large member into many speculative chunks:
    some are joined (no block start in them), and the bytes decoded
    before their window was known are counted; a BGZF file goes a
    member a thread."""
    gz = CASES["fastq-6"]
    want = gzip.decompress(gz)
    assert native.inflate(gz, threads=4, chunk=1500).tobytes() == want
    c = native.inflate_counters()
    assert c["chunks"] > 1 and c["joined"] > 0 and c["marker_bytes"] > 0
    assert c["waves"] >= c["chunks"] // 4
    native.inflate(CASES["bgzf"], threads=4)
    c = native.inflate_counters()
    assert c["bgzf_members"] == c["members"] == _members(CASES["bgzf"])
    assert native.inflate(gz).tobytes() == want
    assert native.inflate_counters()["team"] == native.inflate_team(len(gz))


def test_default_team():
    assert native.inflate_team(1000) == 1
    assert native.inflate_team(1000, 3) == 3
    assert native.inflate_team(1 << 20) == (os.cpu_count() if not os.environ
                                            .get("OMP_NUM_THREADS") else
                                            int(os.environ["OMP_NUM_THREADS"]))


@settings(max_examples=40, deadline=None)
@given(data=st.binary(max_size=3000), reps=st.integers(1, 60),
       level=st.sampled_from([0, 1, 6, 9]), team=st.sampled_from(TEAMS),
       chunk=st.integers(64, 5000), members=st.integers(1, 3))
def test_hypothesis_payloads(data, reps, level, team, chunk, members):
    """Random payloads, repeated (long matches across chunk starts), in
    one to three members, at random chunk sizes."""
    payload = data * reps
    gz = b"".join(member(payload[i::members], level) for i in range(members))
    got = native.inflate(gz, threads=team, chunk=chunk).tobytes()
    assert got == PLAIN(gz)


# ---- refused inputs ----

def _bad_cases() -> dict:
    gz = CASES["fastq-6"]
    n = len(gz)
    bad = {f"truncated-at-{o}": gz[:o]
           for o in (2, 9, 10, 11, 100, n // 3, n // 2, n - 9, n - 8, n - 5,
                     n - 1)}
    bad["truncated-flags"] = CASES["all-flags"][:14]
    crc = bytearray(gz)
    crc[-7] ^= 0x40
    bad["crc-flipped"] = bytes(crc)
    size = bytearray(gz)
    size[-4] ^= 1
    bad["isize-wrong"] = bytes(size)
    data = bytearray(gz)
    data[n // 2] ^= 0x08
    bad["data-flipped"] = bytes(data)
    bad["trailing-garbage"] = gz + b"\x00\x00garbage"
    bad["trailing-byte"] = gz + b"\x1f"
    bad["trailing-magic"] = gz + b"\x1f\x8b"
    bad["second-member-magic"] = gz + b"\x1f\x8c" + gz[2:]
    bad["bad-method"] = b"\x1f\x8b\x07" + gz[3:]
    bad["second-bad-method"] = gz + b"\x1f\x8b\x09" + gz[3:]
    bgz = bytearray(CASES["bgzf"])
    bgz[len(bgz) // 2] ^= 0x20
    bad["bgzf-flipped"] = bytes(bgz)
    bad["block-type-3"] = gz[:10] + b"\x07" + gz[11:]
    return bad


BAD = _bad_cases()


@pytest.mark.parametrize("team,chunk", [(1, 0), (3, 1500), (8, 9000)])
@pytest.mark.parametrize("case", sorted(BAD))
def test_refused_input_raises_plain_error(case, team, chunk, tmp_path,
                                          monkeypatch, plain_calls):
    """A bad input raises the plain version's exception, message and
    all, once the native inflater refuses it."""
    gz = BAD[case]
    with pytest.raises(Exception) as want:
        PLAIN(gz)
    path = tmp_path / "bad.gz"
    path.write_bytes(gz)
    _pinned(monkeypatch, team, chunk)
    with pytest.raises(Exception) as got:
        pipeline._read_file_bytes(path)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    assert len(plain_calls) == 1
    with pytest.raises(native.InflateRefused):
        _INFLATE(gz, threads=team, chunk=chunk)


def test_disagreement_is_a_fault(tmp_path, monkeypatch):
    """Were the native inflater to refuse an input the plain version
    reads, the route raises RuntimeError, not the plain bytes."""
    def refuse(data, **kw):
        raise native.InflateRefused("refused for the test")

    monkeypatch.setattr(native, "inflate", refuse)
    path = tmp_path / "ok.gz"
    path.write_bytes(CASES["fastq-6"])
    with pytest.raises(RuntimeError, match="refused a gzip input"):
        pipeline._read_file_bytes(path)


# ---- sizes past 4 GiB ----

class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):          # LSB first
        self.bits += [(value >> i) & 1 for i in range(n)]

    def code(self, code: int, n: int):          # Huffman: MSB first
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]


def _run_block(final: bool, literal: bool, matches: int) -> np.ndarray:
    """A dynamic block: 'A' (1 bit), end-of-block and length 258 (2 bits
    each), one distance code (distance 1, the lone length-1 code zlib
    allows); optionally a literal 'A', then `matches` copies of 258."""
    w = _BitWriter()
    w.put(int(final), 1)
    w.put(2, 2)
    w.put(286 - 257, 5)
    w.put(0, 5)
    w.put(18 - 4, 4)
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1]
    cl = {1: 2, 2: 2, 18: 2, 0: 3, 17: 3}       # codes 1:00 2:01 18:10
    for s in order:                             # 0:110 17:111
        w.put(cl.get(s, 0), 3)
    codes = {1: (0, 2), 2: (1, 2), 18: (2, 2), 0: (6, 3), 17: (7, 3)}

    def zeros(n):
        w.code(*codes[18])
        w.put(n - 11, 7)

    zeros(65)
    w.code(*codes[1])       # 'A': 1
    zeros(138)
    zeros(52)
    w.code(*codes[2])       # 256: 2
    zeros(28)
    w.code(*codes[2])       # 285: 2
    w.code(*codes[1])       # distance 0: 1
    head = list(w.bits)
    if literal:
        head.append(0)      # 'A' = 0
    body = np.tile(np.array([1, 1, 0], np.uint8), matches)  # 285, dist 0
    return np.concatenate([np.array(head, np.uint8), body,
                           np.array([1, 0], np.uint8)])      # 256 = 10


def test_output_over_4gib_wraps_isize():
    """A synthetic member inflating to more than 2^32 bytes, checked at
    the C entry without holding the output (`inflate_check`): its
    ISIZE is the length mod 2^32, the CRC32 is combined over parts of
    any size, and an ISIZE one off is refused."""
    m = 45_000
    blocks = [_run_block(False, True, m)]
    blocks += [_run_block(False, False, m)] * 368
    blocks.append(_run_block(True, False, m))
    total = 1 + 258 * m * len(blocks)
    assert total > 1 << 32
    deflate = np.packbits(np.concatenate(blocks), bitorder="little")
    crc, unit, left = 0, b"A" * (1 << 26), total
    while left:
        k = min(left, len(unit))
        crc = zlib.crc32(unit if k == len(unit) else unit[:k], crc)
        left -= k
    head = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff" + deflate.tobytes()
    good = head + struct.pack("<II", crc, total & 0xFFFFFFFF)
    assert native.inflate_check(good, threads=8, chunk=1 << 16) == total
    c = native.inflate_counters()
    assert c["chunks"] > 8 and c["members"] == 1
    bad = head + struct.pack("<II", crc, (total + 1) & 0xFFFFFFFF)
    with pytest.raises(native.InflateRefused, match="ISIZE"):
        native.inflate_check(bad, threads=8, chunk=1 << 16)


def test_crc32_combine():
    """zlib's crc32_combine for parts of every size (any bytes)."""
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (1000, 70_001))
    for x, y in ((a, b), (b, a), (b"", a), (a, b"")):
        assert native.crc32_combine(zlib.crc32(x), zlib.crc32(y),
                                    len(y)) == zlib.crc32(x + y)
    # zeros: crc(x + 0^n) from crc(x) and crc(0^n)
    z = bytes(1 << 20)
    assert native.crc32_combine(zlib.crc32(a), zlib.crc32(z),
                                len(z)) == zlib.crc32(a + z)


# ---- classify's CSV of gzip inputs ----

def _run(main, argv) -> int:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A DB the JAX package built, reads and mate files, and gzip copies
    of each (one member, BGZF and concatenated members)."""
    tmp = tmp_path_factory.mktemp("torch_inflate_csv")
    genomes = make_genomes()
    lines = []
    for t, seqs in genomes.items():
        p = tmp / f"g{t}.fa"
        p.write_text(f">genome{t}\n" + "\n".join(seqs) + "\n")
        lines.append(f"{p} TAX{t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    fq = tmp / "reads.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'F' * len(s)}\n"
                          for n, s in sample_reads(genomes, n_reads=400)))
    r1, r2 = tmp / "r1.fq", tmp / "r2.fq"
    mates = [(n, s[:60], s[-60:]) for n, s in sample_reads(genomes, 300)]
    r1.write_text("".join(f"@{n}/1\n{a}\n+\n{'F' * len(a)}\n"
                          for n, a, _ in mates))
    r2.write_text("".join(f"@{n}/2\n{b}\n+\n{'F' * len(b)}\n"
                          for n, _, b in mates))
    gz = {}
    for p in (fq, r1, r2):
        data = p.read_bytes()
        gz[p.name] = tmp / (p.name + ".gz")
        gz[p.name].write_bytes(gzip.compress(data, mtime=0))
    (tmp / "reads.bgzf.gz").write_bytes(bgzf(fq.read_bytes(), 6, 4000))
    d = fq.read_bytes()
    (tmp / "reads.cat.gz").write_bytes(member(d[:9000]) + member(d[9000:]))
    assert _run(jcli.main, ["build-db", "-T", str(targets), "-k", "27",
                            "-D", str(tmp / "jdb")]) == 0
    return tmp, fq, r1, r2, gz


def _jax_csv(tmp, name, argv) -> bytes:
    out = tmp / f"jax_{name}.csv"
    if not out.exists():
        assert _run(jcli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                                str(out), *argv]) == 0
    return out.read_bytes()


def _torch_csv(tmp, out, argv) -> bytes:
    assert _run(cli.main, ["classify", "-D", str(tmp / "jdb"), "-R",
                           str(out), "--device", "cpu", *argv]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("kind", ["reads.fq.gz", "reads.bgzf.gz",
                                  "reads.cat.gz"])
def test_csv_of_gzip_single(reads, kind, tmp_path, plain_calls,
                            monkeypatch):
    """Single-end: the CSV of each gzip copy is the JAX package's CSV of
    the plain reads (at a team of 3 and small chunks too)."""
    tmp, fq, _, _, _ = reads
    want = _jax_csv(tmp, "single", ["-O", str(fq)])
    assert _torch_csv(tmp, tmp_path / "a.csv",
                      ["-O", str(tmp / kind)]) == want
    _pinned(monkeypatch, 3, 700)
    assert _torch_csv(tmp, tmp_path / "b.csv",
                      ["-O", str(tmp / kind)]) == want
    assert plain_calls == []


def test_csv_of_gzip_pairs(reads, tmp_path, plain_calls):
    """Paired, both mates gzip: the JAX package's CSV of the plain
    mates."""
    tmp, _, r1, r2, gz = reads
    want = _jax_csv(tmp, "paired", ["-P", str(r1), str(r2)])
    assert _torch_csv(tmp, tmp_path / "p.csv",
                      ["-P", str(gz["r1.fq"]), str(gz["r2.fq"])]) == want
    assert plain_calls == []


def test_csv_of_gzip_num_hosts(reads, tmp_path, plain_calls):
    """--num-hosts 2 on a gzip input (read whole, sharded by record):
    each host's CSV is the JAX package's on the plain reads."""
    tmp, fq, _, _, gz = reads
    for h in range(2):
        flags = ["--num-hosts", "2", "--host-id", str(h)]
        want = _jax_csv(tmp, f"host{h}", ["-O", str(fq), *flags])
        assert _torch_csv(tmp, tmp_path / f"h{h}.csv",
                          ["-O", str(gz["reads.fq"]), *flags]) == want
    assert plain_calls == []


def test_csv_of_gzip_resumed(reads, tmp_path, plain_calls):
    """--resume on a gzip input completes a cut CSV to the JAX
    package's."""
    tmp, fq, _, _, gz = reads
    want = _jax_csv(tmp, "single", ["-O", str(fq)])
    out = tmp_path / "r.csv"
    out.write_bytes(want[:len(want) // 3])
    assert _torch_csv(tmp, out, ["-O", str(gz["reads.fq"]),
                                 "--resume"]) == want
    assert plain_calls == []


def test_csv_of_gzip_fifo(reads, tmp_path, plain_calls):
    """A gzip FIFO (BGZF here) through `classify_file_to_csv`: the JAX
    package's CSV of the plain reads."""
    from cuclark_tpu_torch.hashdb import KmerDB

    tmp, fq, _, _, _ = reads
    fifo = tmp_path / "reads.fifo"
    os.mkfifo(fifo)
    data = (tmp / "reads.bgzf.gz").read_bytes()
    out = tmp_path / "f.csv"
    clf = pipeline.Classifier(KmerDB.load(next((tmp / "jdb").glob(
        "db_k*.npz"))), device="cpu")
    feeder = threading.Thread(target=lambda: open(fifo, "wb").write(data),
                              daemon=True)
    feeder.start()
    clf.classify_file_to_csv(str(fifo), str(out))
    feeder.join(timeout=60)
    clf.close()
    assert out.read_bytes() == _jax_csv(tmp, "single", ["-O", str(fq)])
    assert native.inflate_counters()["bgzf_members"] > 1
    assert plain_calls == []
