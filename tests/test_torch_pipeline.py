"""The port's slice end to end against the JAX package on the CPU:
`classify_step_packed`, the CLI's CSV bytes (golden example and
synthetic genomes, every classify flag), DB files shared both ways, and
that no module of the port imports JAX.  Every comparison is exact."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import cli as jcli
from cuclark_tpu import codec as jcodec
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu.hashdb import KmerDB as JKmerDB
from cuclark_tpu_torch import cli, pipeline
from cuclark_tpu_torch.hashdb import KmerDB, table_to_device
from tests.test_end2end import make_genomes, sample_reads

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
K = 27


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Synthetic genomes and reads (tests/test_end2end.py), a DB built
    by each package, and the JAX package's CSV for the reads."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    genomes = make_genomes()
    lines = []
    for t, seqs in genomes.items():
        p = tmp / f"g{t}.fa"
        p.write_text(f">genome{t}\n" + "\n".join(seqs) + "\n")
        lines.append(f"{p} TAX{t}")
    targets = tmp / "targets.txt"
    targets.write_text("\n".join(lines) + "\n")
    reads = tmp / "reads.fq"
    reads.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                             for n, s in sample_reads(genomes)))
    build = ["build-db", "-T", str(targets), "-k", str(K)]
    assert jcli.main(build + ["-D", str(tmp / "jdb")]) == 0
    assert cli.main(build + ["-D", str(tmp / "tdb")]) == 0
    jcsv = tmp / "jax.csv"
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), "-O", str(reads),
                      "-R", str(jcsv)]) == 0
    return tmp, reads, jcsv


def _db(d: Path, cls):
    return cls.load(next(d.glob("db_k*.npz")))


def test_port_db_has_jax_checksum(inputs):
    tmp, _, _ = inputs
    db, jdb = _db(tmp / "tdb", KmerDB), _db(tmp / "jdb", JKmerDB)
    assert db.num_kmers == jdb.num_kmers > 0
    assert (db.nb_bits, db.stash_bits, db.seed) == (
        jdb.nb_bits, jdb.stash_bits, jdb.seed)
    assert db.checksum() == jdb.checksum()


def test_port_csv_matches_jax_csv(inputs):
    tmp, reads, jcsv = inputs
    out = tmp / "torch.csv"
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-O", str(reads),
                     "-R", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == jcsv.read_bytes()


def test_jax_db_loads_and_classifies_identically(inputs):
    """A DB file saved by cuclark_tpu (probed fused there, split here)."""
    tmp, reads, jcsv = inputs
    out = tmp / "torch_jdb.csv"
    assert cli.main(["classify", "-D", str(tmp / "jdb"), "-O", str(reads),
                     "-R", str(out), "--device", "cpu", "-b", "16"]) == 0
    assert out.read_bytes() == jcsv.read_bytes()


def test_sampling_factor_matches_jax(inputs):
    tmp, reads, _ = inputs
    jout, out = tmp / "jax_s3.csv", tmp / "torch_s3.csv"
    assert jcli.main(["classify", "-D", str(tmp / "jdb"), "-O", str(reads),
                      "-R", str(jout), "-s", "3"]) == 0
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-O", str(reads),
                     "-R", str(out), "-s", "3", "--device", "cpu"]) == 0
    assert out.read_bytes() == jout.read_bytes()


def test_classify_step_packed_matches_jax(inputs):
    tmp, _, _ = inputs
    db = _db(tmp / "tdb", KmerDB)
    genomes = make_genomes()
    reads = [s.encode() for _, s in sample_reads(genomes, n_reads=40,
                                                 seed=5)]
    L = 160
    codes = np.full((len(reads), L), jcodec.INVALID, np.uint8)
    for i, s in enumerate(reads):
        codes[i, :len(s)] = jcodec.encode_ascii(s)
    p2, vb = jcodec.pack_codes(codes)
    jres, jlab = jpipeline.classify_step_packed(
        jnp.asarray(db.table), jnp.asarray(p2), jnp.asarray(vb), k=db.k,
        nb_bits=db.nb_bits, slots=db.slots, num_choices=db.num_choices,
        layout=db.layout, seed=db.seed, stash_bits=db.stash_bits)
    main, stash = table_to_device(db, "cpu")
    res, lab = pipeline.classify_step_packed(
        main, torch.from_numpy(p2), torch.from_numpy(vb), k=db.k,
        spec=db.spec, stash=stash)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    assert (res.numpy()[:, 2] > 0).sum() > len(reads) // 2


def test_example_reproduces_expected_csv(tmp_path):
    assert cli.main(["build-db", "-T", str(EXAMPLES / "targets.txt"),
                     "-D", str(tmp_path / "db"), "-k", "27"]) == 0
    out = tmp_path / "results.csv"
    assert cli.main(["classify", "-D", str(tmp_path / "db"),
                     "-O", str(EXAMPLES / "reads.fq"), "-R", str(out),
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == (EXAMPLES / "expected_results.csv").read_bytes()


def test_port_imports_no_jax():
    """In a process where `import jax` fails, every module of the port
    imports and the CLI runs; neither jax nor cuclark_tpu gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import cuclark_tpu_torch\n"
        "from cuclark_tpu_torch import (analyser, cli, codec, config, hashdb,"
        " kernels, memplan, native, pipeline, probe, score, simulate)\n"
        "from cuclark_tpu_torch.io import (clark_db, clark_ht, csv_out,"
        " fast_parse, fasta)\n"
        "from cuclark_tpu_torch.taxonomy import ncbi, targets\n"
        "from cuclark_tpu_torch.db_build import builder\n"
        "from cuclark_tpu_torch.parallel import mesh, multihost\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert sys.modules['jax'] is None\n"
        "bad = [m for m in sys.modules if m == 'cuclark_tpu'"
        " or m.startswith('cuclark_tpu.') or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout


def test_cuda_classifier_does_not_fall_back(inputs, monkeypatch):
    tmp, _, _ = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.Classifier(_db(tmp / "tdb", KmerDB), device="cuda")


@pytest.mark.parametrize("flags", [
    ["-d", "2"],
    ["--coordinator", "localhost:1234"],
    ["--num-processes", "1"],
    ["--num-hosts", "2"],
    ["--profile", "trace"],
])
def test_unported_flags_raise(inputs, flags):
    """No classify flag is refused any more (the name is kept from when
    some were): the multi-device, multi-process and --profile flags run,
    here on one CPU device, and write the whole CSV, or for --num-hosts
    host 0's share of it.  --profile also leaves a Chrome trace (JSON)
    in its directory."""
    tmp, reads, jcsv = inputs
    out = tmp / f"flags_{flags[0].strip('-')}.csv"
    argv = ["classify", "-D", str(tmp / "tdb"), "-O", str(reads), "-R",
            str(out), "--device", "cpu", *flags]
    if flags[0] == "--profile":
        argv[-1] = str(tmp / "trace")
    assert cli.main(argv) == 0
    got, want = out.read_bytes(), jcsv.read_bytes()
    if flags[0] == "--num-hosts":
        assert want.startswith(got) and 1 < got.count(b"\n") < 71
    else:
        assert got == want
    if flags[0] == "--profile":
        traces = list((tmp / "trace").glob("*.pt.trace.json"))
        assert len(traces) == 1
        events = json.loads(traces[0].read_text())["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)


def test_row_iterators_match_jax(inputs):
    """classify_file and classify_records yield the JAX package's rows."""
    tmp, reads, _ = inputs
    db, jdb = _db(tmp / "tdb", KmerDB), _db(tmp / "jdb", JKmerDB)
    clf = pipeline.Classifier(db, device="cpu")
    jclf = jpipeline.Classifier(jdb)
    recs = [(n, s.encode()) for n, s in sample_reads(make_genomes(),
                                                     seed=9)]
    assert list(clf.classify_file(str(reads), skip=3)) == list(
        jclf.classify_file(str(reads), skip=3))
    assert list(clf.classify_records(iter(recs))) == list(
        jclf.classify_records(iter(recs)))


def test_csv_without_native_module_matches_jax(inputs, monkeypatch):
    """The per-row fallback (numpy scan and pack, Python formatting)
    writes the native path's bytes."""
    from cuclark_tpu_torch import native

    tmp, reads, jcsv = inputs
    monkeypatch.setattr(native, "available", lambda: False)
    out = tmp / "torch_nonative.csv"
    clf = pipeline.Classifier(_db(tmp / "tdb", KmerDB), device="cpu")
    assert clf.classify_file_to_csv(str(reads), out) == 70
    assert out.read_bytes() == jcsv.read_bytes()


def test_multi_file_list_and_resume(inputs):
    """-O <list> writes one CSV per '<reads> <results>' line; --resume
    completes a truncated CSV to the same bytes."""
    tmp, reads, jcsv = inputs
    outs = [tmp / "list_a.csv", tmp / "list_b.csv"]
    lst = tmp / "jobs.txt"
    lst.write_text("".join(f"{reads} {o}\n" for o in outs))
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-O", str(lst),
                     "--device", "cpu"]) == 0
    for o in outs:
        assert o.read_bytes() == jcsv.read_bytes()
    cut = jcsv.read_bytes()[:len(jcsv.read_bytes()) // 2]
    outs[0].write_bytes(cut)
    assert cli.main(["classify", "-D", str(tmp / "tdb"), "-O", str(reads),
                     "-R", str(outs[0]), "--resume", "--device", "cpu"]) == 0
    assert outs[0].read_bytes() == jcsv.read_bytes()
