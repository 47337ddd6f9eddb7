"""Per-host input sharding and the multi-process engine of the port
(`cuclark_tpu_torch.parallel.multihost`, the CLI's --num-hosts and
--coordinator paths) against the JAX package and the single-process CSV
on the CPU.  The two-rank tests spawn real processes that meet over
torch.distributed (gloo) on a port picked by binding to port 0."""

import gzip
import json
import os
import random
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cuclark_tpu import cli as jcli
from cuclark_tpu.parallel import multihost as jmultihost
from cuclark_tpu_torch import cli, codec
from cuclark_tpu_torch.config import ClassifyConfig
from cuclark_tpu_torch.io import fast_parse
from cuclark_tpu_torch.parallel import mesh, multihost
from cuclark_tpu_torch.pipeline import Classifier

ROOT = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


def _partition_names(buf, num_hosts):
    got = []
    for h in range(num_hosts):
        ns, ne, _, _ = multihost.shard_reads_for_host(buf, num_hosts, h)
        got.append(fast_parse.names_of(buf, ns, ne))
    return got


@pytest.mark.parametrize("fmt,num_hosts", [("fastq", 1), ("fastq", 2),
                                           ("fastq", 3), ("fastq", 7),
                                           ("fasta", 2), ("fasta", 4)])
def test_partition_matches_jax(fmt, num_hosts):
    """Every read owned by exactly one host, in order, split exactly as
    the JAX package splits it (quality lines starting with '@' or '+',
    multi-line FASTA bodies)."""
    rng = random.Random(num_hosts + (10 if fmt == "fasta" else 0))
    recs = []
    for i in range(50):
        n = rng.randrange(30, 300)
        seq = "".join(rng.choice("ACGT") for _ in range(n))
        if fmt == "fastq":
            qual = ("@" if i % 3 == 0 else "+" if i % 3 == 1 else "I")
            recs.append(f"@read{i} x\n{seq}\n+\n{qual}{'I' * (n - 1)}\n")
        else:
            body = "\n".join(seq[j:j + 60] for j in range(0, n, 60))
            recs.append(f">seq{i} d\n{body}\n")
    buf = np.frombuffer("".join(recs).encode(), np.uint8)
    got = _partition_names(buf, num_hosts)
    full = fast_parse.scan_file(buf)
    assert sum(got, []) == fast_parse.names_of(buf, full[0], full[1])
    for h in range(num_hosts):
        ns, ne, _, _ = jmultihost.shard_reads_for_host(buf, num_hosts, h)
        assert got[h] == fast_parse.names_of(buf, ns, ne)


def test_more_hosts_than_records():
    buf = np.frombuffer(b"@a\nACGT\n+\nIIII\n@b\nGGGG\n+\nIIII\n", np.uint8)
    assert sum(_partition_names(buf, 6), []) == ["a", "b"]


def test_record_aligners_match_bruteforce():
    """The vectorized boundary aligners reproduce the per-byte reference
    algorithms at every offset of FASTA/FASTQ buffers whose quality bytes
    include '@' and '+'."""
    def brute_fasta(buf, offset):
        if offset == 0:
            return 0
        for i in range(offset, len(buf)):
            if buf[i] == ord(">") and buf[i - 1] == ord("\n"):
                return i
        return len(buf)

    def brute_fastq(buf, offset):
        n = len(buf)
        if offset == 0:
            return 0
        i = offset
        while i < n and buf[i - 1] != ord("\n"):
            i += 1
        starts, j = [], i
        while j < n and len(starts) < 12:
            starts.append(j)
            while j < n and buf[j] != ord("\n"):
                j += 1
            j += 1
        for idx, s in enumerate(starts):
            if (buf[s] == ord("@") and idx + 2 < len(starts)
                    and buf[starts[idx + 2]] == ord("+")):
                return s
        return n

    rng = random.Random(77)
    fa = "".join(f">rec{t} desc\n"
                 f"{''.join(rng.choice('ACGT') for _ in range(rng.randrange(5, 60)))}\n"
                 for t in range(12))
    fq = []
    for t in range(12):
        s = "".join(rng.choice("ACGT") for _ in range(rng.randrange(4, 40)))
        q = "".join(rng.choice("@+IJK") for _ in range(len(s)))
        fq.append(f"@r{t}\n{s}\n+\n{q}\n")
    fa_buf = np.frombuffer(fa.encode(), np.uint8)
    fq_buf = np.frombuffer("".join(fq).encode(), np.uint8)
    for off in range(len(fa_buf) + 1):
        assert multihost.align_to_fasta_record(fa_buf, off) == brute_fasta(
            fa_buf, off), off
    for off in range(len(fq_buf) + 1):
        assert multihost.align_to_fastq_record(fq_buf, off) == brute_fastq(
            fq_buf, off), off


@pytest.mark.parametrize("fmt", ["fastq", "fasta", "gzip"])
def test_read_host_slice_matches_full_scan(tmp_path, fmt):
    """Windowed per-host file reads partition records like a scan of the
    whole buffer, with a slack small enough to force window growth; a
    gzip input is read whole."""
    rng = random.Random(61)
    recs = []
    for i in range(60):
        n = rng.randrange(30, 400)
        seq = "".join(rng.choice("ACGT") for _ in range(n))
        if fmt == "fasta":
            body = "\n".join(seq[j:j + 60] for j in range(0, n, 60))
            recs.append(f">r{i} d\n{body}\n")
        else:
            recs.append(f"@r{i} x\n{seq}\n+\n{'@' if i % 2 else '+'}"
                        f"{'I' * (n - 1)}\n")
    data = "".join(recs).encode()
    p = tmp_path / f"in.{fmt}"
    p.write_bytes(gzip.compress(data) if fmt == "gzip" else data)
    buf = np.frombuffer(data, np.uint8)
    want = fast_parse.names_of(buf, *fast_parse.scan_file(buf)[:2])
    for num_hosts in (1, 2, 3, 5):
        for slack in (1 << 25, 64):
            got = []
            for h in range(num_hosts):
                w, ns, ne, ss, se = multihost.read_host_slice(
                    str(p), num_hosts, h, slack=slack)
                got.extend(fast_parse.names_of(w, ns, ne))
                assert len(ss) == len(ns)
                assert not len(se) or int(se.max()) <= len(w)
            assert got == want, (num_hosts, slack)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Two 2,500 bp genomes, a k=21 database of each package's build, 41
    single-end reads of 60-160 bases (a count no axis divides), 23 pairs,
    and the single-process CSVs of the port: plain, extended, paired."""
    tmp = tmp_path_factory.mktemp("multihost")
    rng = random.Random(91)
    genomes = {t: "".join(rng.choice("ACGT") for _ in range(2500))
               for t in (1, 2)}
    lines = []
    for t, g in genomes.items():
        (tmp / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp}/g{t}.fa S{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    reads, r1, r2 = [], [], []
    for i in range(41):
        t = rng.randrange(1, 3)
        n = rng.randrange(60, 160)
        pos = rng.randrange(0, 2500 - n)
        reads.append((f"r{i}_t{t}", genomes[t][pos:pos + n]))
    for i in range(23):
        pos = rng.randrange(0, 2300)
        r1.append((f"p{i}", genomes[1][pos:pos + 60]))
        r2.append((f"p{i}", genomes[1][pos + 60:pos + 120]))
    for name, rs in (("r.fq", reads), ("r1.fq", r1), ("r2.fq", r2)):
        (tmp / name).write_text("".join(
            f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in rs))
    assert cli.main(["build-db", "-T", str(tmp / "targets.txt"),
                     "-D", str(tmp / "db"), "-k", "21"]) == 0
    db = str(tmp / "db")
    for out, flags in (("plain.csv", ["-O", str(tmp / "r.fq")]),
                       ("ext.csv", ["-O", str(tmp / "r.fq"), "--extended"]),
                       ("paired.csv", ["-P", str(tmp / "r1.fq"),
                                       str(tmp / "r2.fq")])):
        assert cli.main(["classify", "-D", db, "--device", "cpu", "-R",
                         str(tmp / out), *flags]) == 0
    return tmp


@pytest.mark.parametrize("paired", [False, True])
def test_cli_host_shards_concatenate(job, tmp_path, paired):
    """--num-hosts 3: each host's CSV equals the JAX CLI's for that host,
    and the shards concatenate to the full CSV (byte ranges for a plain
    file, record indices for mates)."""
    inp = (["-P", str(job / "r1.fq"), str(job / "r2.fq")] if paired
           else ["-O", str(job / "r.fq")])
    full = (job / ("paired.csv" if paired else "plain.csv")).read_text()
    parts = []
    for h in range(3):
        out, jout = tmp_path / f"part{h}.csv", tmp_path / f"jpart{h}.csv"
        flags = ["--num-hosts", "3", "--host-id", str(h)]
        assert cli.main(["classify", "-D", str(job / "db"), "--device",
                         "cpu", *inp, "-R", str(out), *flags]) == 0
        assert jcli.main(["classify", "-D", str(job / "db"), *inp, "-R",
                          str(jout), *flags]) == 0
        assert out.read_bytes() == jout.read_bytes()
        rows = out.read_text().splitlines()[1:]
        assert rows
        parts.extend(rows)
    assert parts == full.splitlines()[1:]


@pytest.mark.parametrize("flags", [["--num-processes", "1", "-b", "16"],
                                   ["--num-processes", "1", "-b", "16",
                                    "--max-table-mb", "1"]])
def test_one_process_cli_matches_plain(job, tmp_path, flags, monkeypatch):
    """--num-processes 1 takes the multi-process engine (4 CPU devices: a
    4-data mesh, or under a tiny budget a 4-db mesh that streams) and
    writes the single-process CSV."""
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", "4")
    out = tmp_path / "global.csv"
    assert cli.main(["classify", "-D", str(job / "db"), "--device", "cpu",
                     "-O", str(job / "r.fq"), "-R", str(out), *flags]) == 0
    assert out.read_bytes() == (job / "plain.csv").read_bytes()


@pytest.fixture(scope="module")
def engine_db(job):
    from cuclark_tpu_torch.hashdb import KmerDB

    return KmerDB.load(next((job / "db").glob("db_k*.npz")))


@pytest.mark.parametrize("extended", [False, True])
def test_global_classifier_db_axis(job, engine_db, tmp_path, extended):
    """multihost.classify_file_to_csv on a 2 data x 4 db mesh (one
    process, eight CPU handles) writes the single-device CSV, extended
    mode included."""
    cfg = ClassifyConfig(batch_reads=8, extended=extended)
    out = tmp_path / "got.csv"
    n = multihost.classify_file_to_csv(
        engine_db, cfg, str(job / "r.fq"), out, num_db=4,
        mesh=mesh.make_global_mesh(4, CPU8))
    assert n == 41
    assert out.read_bytes() == (job / ("ext.csv" if extended
                                       else "plain.csv")).read_bytes()


def test_global_classifier_streaming(job, engine_db, tmp_path):
    """A budget under each device's shard composes streamed parts with
    the db axis and still writes the single-device CSV."""
    tiny = engine_db.table.nbytes / 2 / 4 / 1e6
    cfg = ClassifyConfig(batch_reads=8, stream_group=2, max_table_mb=tiny)
    engine = multihost.GlobalClassifier(engine_db, cfg, num_db=2,
                                        mesh=mesh.make_global_mesh(2, CPU8))
    assert engine.stream_parts > 1 and engine.sc is None
    out = tmp_path / "got.csv"
    assert engine.classify_file_to_csv(str(job / "r.fq"), out) == 41
    assert out.read_bytes() == (job / "plain.csv").read_bytes()


def test_global_classifier_engine_reuse(job, engine_db, tmp_path):
    """One engine serves several files (the table goes to the devices
    once); each output equals a one-shot run and the plain Classifier."""
    rng = random.Random(99)
    g = (job / "g1.fa").read_text().split("\n")[1]
    cfg = ClassifyConfig(batch_reads=8)
    engine = multihost.GlobalClassifier(engine_db, cfg, num_db=2,
                                        mesh=mesh.make_global_mesh(2, CPU8))
    single = Classifier(engine_db, cfg, device="cpu")
    for fi in range(3):
        fq = tmp_path / f"r{fi}.fq"
        fq.write_text("".join(
            f"@f{fi}r{i}\n{g[(p := rng.randrange(0, 2300)):p + 90]}\n+\n"
            f"{'I' * 90}\n" for i in range(11 + fi)))
        got, want = tmp_path / f"got{fi}.csv", tmp_path / f"want{fi}.csv"
        assert engine.classify_file_to_csv(str(fq), got) == 11 + fi
        single.classify_file_to_csv(str(fq), want)
        assert got.read_bytes() == want.read_bytes()
    engine.close()


def test_global_classifier_without_native_module(job, engine_db, tmp_path,
                                                 monkeypatch, capsys):
    """The per-row fallback of the engine writes the native bytes and the
    same extended hit stats."""
    from cuclark_tpu_torch import native

    cfg = ClassifyConfig(batch_reads=8, extended=True)
    monkeypatch.setattr(native, "available", lambda: False)
    out = tmp_path / "rows.csv"
    assert multihost.classify_file_to_csv(
        engine_db, cfg, str(job / "r.fq"), out,
        mesh=mesh.make_global_mesh(1, CPU8)) == 41
    assert out.read_bytes() == (job / "ext.csv").read_bytes()
    assert "MIN targets:" in capsys.readouterr().err


def test_collectives_single_process_identity():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    np.testing.assert_array_equal(
        multihost._gather_rows_i64(np.array([3, -2])), [[3, -2]])
    assert multihost.agree_budget_mb(None) is None
    assert multihost.agree_budget_mb(12.5) == 12.5
    multihost.initialize(None, 1, None)  # single-process: no group
    with pytest.raises(ValueError, match="--coordinator"):
        multihost.initialize(None, 2, 0)


def test_multiprocess_cli_without_card_raises(job, tmp_path, monkeypatch):
    """--device cuda on the multi-process path with no card visible raises
    instead of falling back to the CPU, and writes nothing."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    out = tmp_path / "never.csv"
    with pytest.raises(RuntimeError, match="no device"):
        cli.main(["classify", "-D", str(job / "db"), "--device", "cuda",
                  "-O", str(job / "r.fq"), "-R", str(out),
                  "--num-processes", "1"])
    assert not out.exists()


_CLI_MAIN = ("import sys; from cuclark_tpu_torch.cli import main; "
           "raise SystemExit(main(sys.argv[1:]))")


def _two_ranks(job, tmp_path, argv, device_mb=(None, None)):
    """Run `classify ... --coordinator` as two processes -> [(rc, stdout,
    stderr)] per rank and the merged .h000 + .h001 bytes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_csv = tmp_path / "mp.csv"
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        env["CUCLARK_CPU_DEVICES"] = "4"
        env["OMP_NUM_THREADS"] = "2"
        if device_mb[rank] is not None:
            env["CUCLARK_DEVICE_MB"] = device_mb[rank]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CLI_MAIN, "classify", "-D",
             str(job / "db"), "--device", "cpu", "-R", str(out_csv),
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(rank), "-b", "16", *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, err in outs:
        assert rc == 0, err.decode(errors="replace")[-2000:]
    merged = ((tmp_path / "mp.csv.h000").read_bytes()
              + (tmp_path / "mp.csv.h001").read_bytes())
    return outs, merged


def test_two_process_extended(job, tmp_path):
    """Two ranks over gloo, single-end --extended: the shards concatenate
    to the single-process CSV, and rank 0 alone prints ONE hit-stats line
    covering both ranks' rows."""
    outs, merged = _two_ranks(job, tmp_path,
                              ["-O", str(job / "r.fq"), "--extended"])
    assert merged == (job / "ext.csv").read_bytes()
    m0 = re.search(rb"MIN targets: (\d+), MAX targets: (\d+), "
                   rb"AVG targets: ([\d.]+)", outs[0][2])
    assert m0 and b"MIN targets" not in outs[1][2]
    rows = [r.split(",") for r in merged.decode().splitlines()[1:]]
    distinct = [sum(int(c) > 0 for c in r[1:3]) for r in rows]
    assert int(m0.group(1)) == min(distinct)
    assert int(m0.group(2)) == max(distinct)
    assert abs(float(m0.group(3)) - sum(distinct) / len(distinct)) < 1e-4
    assert all(b"process 1" in o[1] or b"process 0" in o[1] for o in outs)


def test_two_process_paired(job, tmp_path):
    """Mates through two ranks: record-index sharding keeps them aligned."""
    _, merged = _two_ranks(job, tmp_path, ["-P", str(job / "r1.fq"),
                                           str(job / "r2.fq")])
    assert merged == (job / "paired.csv").read_bytes()


def test_two_process_streaming_tiny_budget(job, tmp_path):
    """A tiny --max-table-mb: each rank streams its mesh's shards in
    parts, and the shards still concatenate byte for byte."""
    outs, merged = _two_ranks(job, tmp_path, ["-O", str(job / "r.fq"),
                                              "--max-table-mb", "1"])
    assert merged == (job / "plain.csv").read_bytes()
    assert all(b"4 db per process, 2 process(es)" in o[2] for o in outs)


def test_two_process_divergent_budgets_agree(job, tmp_path):
    """Ranks whose device budgets differ (2 MB and 5 MB) plan with the
    agreed minimum on both, so both ranks build the same mesh and the
    output stays byte-identical."""
    outs, merged = _two_ranks(job, tmp_path, ["-O", str(job / "r.fq")],
                              device_mb=("2", "5"))
    assert merged == (job / "plain.csv").read_bytes()
    meshes = {re.search(rb"Global mesh: .*", o[2]).group(0) for o in outs}
    assert len(meshes) == 1


_SPAN_MAIN = """
import json, sys
from pathlib import Path
import numpy as np
from cuclark_tpu_torch.config import ClassifyConfig
from cuclark_tpu_torch.hashdb import KmerDB
from cuclark_tpu_torch.parallel import mesh, multihost
from cuclark_tpu_torch.pipeline import Classifier

db_path, codes_path, reads, out, port, rank = sys.argv[1:7]
rank, out = int(rank), Path(out)
multihost.initialize(f"127.0.0.1:{port}", 2, rank)
db = KmerDB.load(db_path)
devs = mesh.local_devices("cpu")
total = 2 * len(devs)
m = mesh.make_global_mesh(total, devs)
assert m.spans_processes and m.shape == {"data": 1, "db": total}
assert m.db_start == rank * len(devs)
codes = np.load(codes_path)
res, lab = mesh.ShardedClassifier(db, m).classify_codes(codes)
res2, lab2 = mesh.ShardedClassifier(db, m, with_labels=False).classify_codes(
    codes)
assert lab2 is None
errors = {}
for bad in (0, 3, 2 * total):
    try:
        mesh.make_global_mesh(bad, devs)
        errors[bad] = None
    except ValueError as e:
        errors[bad] = str(e)
try:
    multihost.GlobalClassifier(db, ClassifyConfig(), num_db=total,
                               device="cpu")
    rejected = None
except ValueError as e:
    rejected = str(e)
cfg = ClassifyConfig(batch_reads=16)
Classifier(db, cfg, mesh=m).classify_file_to_csv(reads, out / f"res{rank}.csv")
tiny = db.table.nbytes / total / 4 / 1e6
scfg = ClassifyConfig(batch_reads=16, stream_group=2, max_table_mb=tiny)
clf = Classifier(db, scfg, mesh=m)
assert clf.stream_parts > 1
clf.classify_file_to_csv(reads, out / f"str{rank}.csv")
np.savez(out / f"rank{rank}.npz", res=res, lab=lab, res2=res2)
(out / f"rank{rank}.json").write_text(json.dumps(
    {"errors": {str(k): v for k, v in errors.items()}, "rejected": rejected,
     "parts": clf.stream_parts}))
multihost.shutdown()
"""


@pytest.fixture(scope="module", params=[1, 2])
def spanning(request, job, tmp_path_factory):
    """Two processes over gloo, each with CUCLARK_CPU_DEVICES handles of
    the CPU, on the mesh whose db axis spans both (num_db = 2 x the
    handles, data 1): each classifies the same 48 reads of unpacked codes
    through ShardedClassifier (with and without labels), tries bad num_db
    values and the lockstep engine, and writes the plain CSV of the job's
    reads through Classifier on that mesh, resident and streamed ->
    (handles, codes, each rank's outputs, the tmp dir)."""
    ndev = request.param
    tmp = tmp_path_factory.mktemp(f"span{ndev}")
    rng = random.Random(5 + ndev)
    genomes = [(job / f"g{t}.fa").read_text().split("\n")[1] for t in (1, 2)]
    codes = np.full((48, 96), codec.INVALID, np.uint8)
    for i in range(48):
        n = rng.randrange(30, 96)
        pos = rng.randrange(0, 2500 - n)
        seq = genomes[i % 2][pos:pos + n]
        if i % 6 == 0:
            seq = seq[:n // 2] + "N" + seq[n // 2 + 1:]
        codes[i, :n] = codec.encode_ascii(seq.encode())
    np.save(tmp / "codes.npy", codes)
    db_path = next((job / "db").glob("db_k*.npz"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUCLARK_CPU_DEVICES"] = str(ndev)
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SPAN_MAIN, str(db_path),
         str(tmp / "codes.npy"), str(job / "r.fq"), str(tmp), str(port),
         str(rank)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode(errors="replace")[-3000:]
    ranks = [(dict(np.load(tmp / f"rank{r}.npz")),
              json.loads((tmp / f"rank{r}.json").read_text()))
             for r in range(2)]
    return ndev, codes, ranks, tmp, db_path


def test_spanning_mesh_results_match_jax(spanning):
    """Every process's results and labels equal the JAX package's
    single-process ShardedClassifier on a num_db mesh and its resident
    classify_step; without labels the results are the same."""
    import jax
    import jax.numpy as jnp

    from cuclark_tpu import pipeline as jpipeline
    from cuclark_tpu.hashdb import KmerDB as JKmerDB
    from cuclark_tpu.parallel import mesh as jmesh

    ndev, codes, ranks, _, db_path = spanning
    jdb = JKmerDB.load(db_path)
    total = 2 * ndev
    jres, jlab = jmesh.ShardedClassifier(jdb, jmesh.make_mesh(
        num_db=total, num_data=1, devices=jax.devices()[:total])
    ).classify_codes(codes)
    rres, rlab = jpipeline.classify_step(
        jnp.asarray(jdb.table), jnp.asarray(codes), k=jdb.k,
        nb_bits=jdb.nb_bits, slots=jdb.slots, num_choices=jdb.num_choices,
        layout=jdb.layout, seed=jdb.seed, stash_bits=jdb.stash_bits)
    np.testing.assert_array_equal(jres, np.asarray(rres))
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["res"], jres)
        np.testing.assert_array_equal(arrays["lab"], jlab)
        np.testing.assert_array_equal(arrays["lab"], np.asarray(rlab))
        np.testing.assert_array_equal(arrays["res2"], jres)
    assert int((jlab > 0).sum()) > 100


def test_spanning_mesh_bad_num_db_raises(spanning):
    """num_db 0, 3 and twice the job's devices raise the reference's
    error (cuclark_tpu/parallel/mesh.py make_global_mesh) on every
    process."""
    ndev, _, ranks, _, _ = spanning
    for _, info in ranks:
        for bad, msg in info["errors"].items():
            assert msg is not None and msg.startswith(
                f"num_db={bad} must divide per-process devices {ndev} or "
                f"equal the total device count {2 * ndev}"), msg


def test_global_classifier_rejects_spanning_mesh(spanning):
    """The lockstep engine refuses the db axis across processes, with the
    reference's reason (cuclark_tpu/parallel/multihost.py)."""
    _, _, ranks, _, _ = spanning
    for _, info in ranks:
        assert info["rejected"].startswith(
            "data axis 1 not divisible by 2 processes")
        assert "replicated-read ShardedClassifier use only" in info[
            "rejected"]


def test_spanning_mesh_classifier_csv(job, spanning):
    """Classifier on the spanning mesh, every process reading the whole
    file: resident (labels all-reduced each batch) and streamed in parts
    (each part's labels all-reduced), each process's CSV is the
    single-process CSV."""
    _, _, ranks, tmp, _ = spanning
    want = (job / "plain.csv").read_bytes()
    for r, (_, info) in enumerate(ranks):
        assert info["parts"] > 1
        assert (tmp / f"res{r}.csv").read_bytes() == want
        assert (tmp / f"str{r}.csv").read_bytes() == want
