"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Marked `cuda`: they skip on a machine without a CUDA device,
and run there with `pytest -m cuda tests/test_torch_cuda.py`."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cuclark_tpu_torch import codec, hashdb, kernels, probe, score
from cuclark_tpu_torch.config import DBConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [27, 32])
def test_query_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=310_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))
    km = km[:300_000]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=k), nb_bits=17)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            v = int(km[rng.integers(len(km))])
            codes[r, p:p + k] = [(v >> (2 * (k - 1 - j))) & 3
                                 for j in range(k)]
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[3, 90:] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec)
    before = kernels.LAUNCHES["query"]
    got = probe.query_labels(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["query"] == before + 1
    want = probe.query_labels_plain(p2, vb, main, stash, **args)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > R


def _score_rows(seed, R, P):
    """R rows of labels for the score kernel: random small labels with
    misses; then, where R allows, all miss, random labels over 1..65,535,
    a tie between a label below 32,768 and one above (the lower wins),
    the best above 32,768 with the second below, 65,535 the best beside
    32,767 and 32,768, and a dozen distinct labels (more than the warp
    path counts before it sorts) with a tie between the first one seen
    and a later one; then rows of 6 to 40 distinct labels."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 6, size=(R, P)).astype(np.int32)
    lab[rng.random((R, P)) < 0.3] = 0
    q = P // 4
    special = np.zeros((6, P), np.int32)
    special[1] = rng.integers(1, 65536, size=P)
    special[2, :q], special[2, q:2 * q] = 40000, 1234
    special[3, :2 * q], special[3, 2 * q:3 * q] = 50000, 77
    special[4, :2 * q], special[4, 2 * q:3 * q] = 65535, 32767
    special[4, 3 * q:] = 32768
    special[5] = rng.integers(1, 13, size=P) * 1000
    special[5, :q], special[5, -q:] = 9000, 2000
    n = min(R, 6)
    lab[:n] = special[:n]
    for r in range(n, min(R, 64)):
        lab[r] = rng.integers(0, 6 + r % 35, size=P) * 37
    return lab


def _bounded_rows(seed, R, P, bound):
    """R rows of labels of at most `bound`: all miss; an exact tie (the
    smaller label wins); many distinct labels; the bound alone; runs of
    random lengths; two labels alternating; then rows of one label with
    misses and a few others, as a long read from one genome gives."""
    rng = np.random.default_rng(seed)
    lo = max(1, bound // 2)
    lab = np.zeros((R, P), np.int32)
    q = P // 4
    lab[1, :q], lab[1, q:2 * q] = bound, lo
    lab[2] = rng.integers(0, bound + 1, size=P)
    lab[3] = np.where(rng.random(P) < 0.6, bound, 0)
    runs = rng.integers(1, 40, size=P)
    lab[4] = np.repeat(rng.integers(0, bound + 1, size=P), runs)[:P]
    lab[5, ::2], lab[5, 1::3] = lo, bound
    for r in range(6, R):
        row = np.where(rng.random(P) < 0.6, rng.integers(1, bound + 1), 0)
        other = rng.random(P) < 0.02
        row[other] = rng.integers(1, bound + 1, size=int(other.sum()))
        lab[r] = row
    return lab


SCORE_P = [1, 2, 31, 32, 33, 98, 122, 128, 129, 290, 994, 1025, 2018, 16354,
           32768]
BOUNDS = [1, 76, 1072, kernels.SCORE_BOUND_CAP, kernels.SCORE_BOUND_CAP + 1]
# (P, label bound): without a bound, every path of the `score` entry;
# with one, rows over 1,024 windows at and above the cap, and warp-path
# rows that a bound leaves on the warp path
SCORE_CASES = ([(P, None) for P in SCORE_P]
               + [(P, b) for P in (1025, 2018, 16354, 32769, 40000, 138210)
                  for b in BOUNDS] + [(994, 76), (122, 76)])


@pytest.mark.parametrize("P,bound", SCORE_CASES)
def test_score_kernel_matches_plain(dev, P, bound):
    """Every path of the `score` entry: the warp path up to 1,024 windows
    (one E per power of two), the histogram above, both label ranges;
    and with a label bound the bounded histogram (`score_bounded`), one
    launch exactly where the rows are over 1,024 windows and the bound
    at most the cap, else the entry without a bound."""
    if bound is None:
        R = 4096 if P <= 1024 else 16
        t = torch.from_numpy(_score_rows(R + P, R, P)).to(dev)
        entry = "score"
    else:
        R = 16 if P <= 40000 else 8
        t = torch.from_numpy(_bounded_rows(P + bound, R, P, bound)).to(dev)
        entry = ("score_bounded"
                 if P > 1024 and bound <= kernels.SCORE_BOUND_CAP
                 else "score" if P <= kernels.MAX_SCORE_WINDOWS
                 else "score_long")
    before = dict(kernels.LAUNCHES)
    got = score.score_labels(t, bound)
    torch.cuda.synchronize()
    after = dict(kernels.LAUNCHES)
    assert after[entry] == before[entry] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert torch.equal(got, score.score_labels_plain(t))


def test_score_kernel_full_batch(dev):
    """A main-path batch: 65,536 reads of 122 windows."""
    t = torch.from_numpy(_score_rows(7, 65536, 122)).to(dev)
    got = score.score_labels(t)
    torch.cuda.synchronize()
    assert torch.equal(got, score.score_labels_plain(t))


@pytest.mark.parametrize("P", [32769, 40000, 100000])
def test_score_long_kernel_matches_plain(dev, P):
    """Rows over 32,768 windows take the `score_long` entry."""
    t = torch.from_numpy(_score_rows(P, 6, P)).to(dev)
    before = dict(kernels.LAUNCHES)
    got = score.score_labels(t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["score_long"] == before["score_long"] + 1
    assert kernels.LAUNCHES["score"] == before["score"]
    assert torch.equal(got, score.score_labels_plain(t))


def _layout_case(dev, layout, slots, choices, n, nb_bits, k):
    """A q4 or s2 table of n keys (those with two hash choices hold some
    at their second), and 256 reads of 152 bases with its keys planted,
    Ns and an N tail."""
    rng = np.random.default_rng(k + slots)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=n + 10_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))
    km = km[:n]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(
        k=k, layout=layout, slots=slots, num_choices=choices),
        nb_bits=nb_bits)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[3, 90:] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    return db, p2, vb


# (layout, slots, choices, keys, nb_bits): 57-69% loads, and a one-choice
# s2 table loose enough to build without eviction
LAYOUTS = [("q4", 4, 2, 300_000, 17), ("s2", 2, 2, 90_000, 16),
           ("s2", 4, 1, 20_000, 16), ("s2", 3, 2, 130_000, 16)]


@pytest.mark.parametrize("k", [27, 32])
@pytest.mark.parametrize("layout,slots,choices,n,nb_bits", LAYOUTS)
def test_layout_query_kernel_matches_plain(dev, layout, slots, choices, n,
                                           nb_bits, k):
    """The resident q4 or s2 query kernel against its plain version."""
    db, p2, vb = _layout_case(dev, layout, slots, choices, n, nb_bits, k)
    main, stash = hashdb.table_to_device(db, dev)
    assert stash is None
    name = f"query_{layout}"
    before = kernels.LAUNCHES[name]
    got = probe.query_labels(p2, vb, main, None, k=k, spec=db.spec)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = probe.query_labels_plain(p2, vb, main, None, k=k, spec=db.spec)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 256


@pytest.mark.parametrize("parts", [2, 4, 8, 16])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("layout,slots,choices,n,nb_bits", LAYOUTS)
def test_layout_query_part_kernel_matches_plain(dev, layout, slots, choices,
                                                n, nb_bits, accumulate,
                                                parts):
    """The part-mode q4 or s2 query kernel on each of 2 to 16
    bucket-range parts (the range kernel at W 2 and 4), writing or
    adding into an accumulator; the parts add up to the resident
    labels."""
    k = 31
    db, p2, vb = _layout_case(dev, layout, slots, choices, n, nb_bits, k)
    main, _ = hashdb.table_to_device(db, dev)
    rows = db.nb // parts
    rng = np.random.default_rng(9)
    name = f"query_part_{layout}"
    total = torch.zeros((p2.shape[0], 4 * p2.shape[1] - k + 1),
                        dtype=torch.int32, device=dev)
    for p in range(parts):
        part = main[p * rows:(p + 1) * rows].contiguous()
        acc = (torch.from_numpy(rng.integers(0, 1000, size=tuple(total.shape),
                                             dtype=np.int32)).to(dev)
               if accumulate else None)
        args = dict(bucket_start=p * rows, nb_local=rows, k=k, spec=db.spec)
        want = probe.query_part_labels_plain(
            p2, vb, part, None, acc=acc.clone() if accumulate else None,
            **args)
        before = kernels.LAUNCHES[name]
        got = probe.query_part_labels(p2, vb, part, None, acc=acc, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert torch.equal(got, want)
        if accumulate:
            assert got.data_ptr() == acc.data_ptr()
        else:
            total += got
    if not accumulate:
        assert torch.equal(total, probe.query_labels(p2, vb, main, None, k=k,
                                                     spec=db.spec))


def test_classifier_rows_match_cpu(dev, tmp_path):
    """The row iterators on the card give the CPU path's rows."""
    from pathlib import Path

    from cuclark_tpu_torch import cli, pipeline
    from cuclark_tpu_torch.hashdb import KmerDB

    ex = Path(__file__).resolve().parent.parent / "examples"
    assert cli.main(["build-db", "-T", str(ex / "targets.txt"),
                     "-D", str(tmp_path / "db"), "-k", "27"]) == 0
    db = KmerDB.load(next((tmp_path / "db").glob("db_k*.npz")))
    gpu = pipeline.Classifier(db, device=dev)
    cpu = pipeline.Classifier(db, device="cpu")
    reads = str(ex / "reads.fq")
    assert list(gpu.classify_file(reads)) == list(cpu.classify_file(reads))
    recs = [(f"r{i}", b"ACGT" * (10 + i)) for i in range(50)]
    assert list(gpu.classify_records(iter(recs))) == list(
        cpu.classify_records(iter(recs)))


@pytest.mark.parametrize("parts", [2, 4, 8, 16])
@pytest.mark.parametrize("with_stash", [True, False])
@pytest.mark.parametrize("accumulate", [False, True])
def test_query_part_kernel_matches_plain(dev, with_stash, accumulate, parts):
    """The part-mode query kernel on each of 2 to 16 bucket-range parts
    (the range kernel at W 2 and 4), with or without the stash,
    writing or adding into an accumulator whose invalid windows must keep
    their values."""
    k = 31
    rng = np.random.default_rng(5)
    km = rng.integers(0, 1 << 62, size=301_000, dtype=np.uint64)
    km = np.unique(codec.canonical_np(km, k))[:300_000]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=k), nb_bits=17)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[3, 90:] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    rows = db.nb // parts
    args = dict(nb_local=rows, k=k, spec=db.spec)
    hits = 0
    for p in range(parts):
        part = main[p * rows:(p + 1) * rows].contiguous()
        s = stash if with_stash else None
        acc = (torch.from_numpy(rng.integers(0, 1000, size=(R, L - k + 1),
                                             dtype=np.int32)).to(dev)
               if accumulate else None)
        want = probe.query_part_labels_plain(
            p2, vb, part, s, bucket_start=p * rows,
            acc=acc.clone() if accumulate else None, **args)
        before = kernels.LAUNCHES["query_part"]
        got = probe.query_part_labels(p2, vb, part, s, bucket_start=p * rows,
                                      acc=acc, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["query_part"] == before + 1
        assert torch.equal(got, want)
        if accumulate:
            assert got.data_ptr() == acc.data_ptr()
        hits += int((want > 0).sum())
    assert hits > R


def test_streamed_classifier_matches_cpu(dev, tmp_path):
    """A table streamed in 4 or more parts on the card: the rows and the
    extended CSV bytes of the CPU's resident run, through the part-mode
    kernel, with an upload rate for every part."""
    from pathlib import Path

    from cuclark_tpu_torch import cli, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import KmerDB

    ex = Path(__file__).resolve().parent.parent / "examples"
    assert cli.main(["build-db", "-T", str(ex / "targets.txt"),
                     "-D", str(tmp_path / "db"), "-k", "27"]) == 0
    db = KmerDB.load(next((tmp_path / "db").glob("db_k*.npz")))
    cfg = ClassifyConfig(extended=True, batch_reads=64, stream_group=2,
                         max_table_mb=db.table.nbytes / 8e6)
    gpu = pipeline.Classifier(db, cfg, device=dev)
    cpu = pipeline.Classifier(db, ClassifyConfig(extended=True,
                                                 batch_reads=64),
                              device="cpu")
    assert gpu.stream_parts >= 4 and cpu.stream_parts == 1
    reads = str(ex / "reads.fq")
    before = kernels.LAUNCHES["query_part"]
    try:
        assert list(gpu.classify_file(reads)) == list(
            cpu.classify_file(reads))
        assert kernels.LAUNCHES["query_part"] > before
        rates = gpu.part_upload_gbps()
        assert len(rates) == gpu.stream_parts and min(rates) > 0
        gpu.classify_file_to_csv(reads, tmp_path / "gpu.csv")
        cpu.classify_file_to_csv(reads, tmp_path / "cpu.csv")
        assert ((tmp_path / "gpu.csv").read_bytes()
                == (tmp_path / "cpu.csv").read_bytes())
    finally:
        gpu.close()


def _qs_case(dev, k, seed):
    """A qs table of 300,000 keys at nb_bits 17 (its overflow fills the
    stash) and 256 reads of 152 bases with stored keys planted."""
    rng = np.random.default_rng(seed)
    km = rng.integers(0, np.iinfo(np.uint64).max, size=310_000,
                      dtype=np.uint64, endpoint=True)
    km = np.unique(codec.canonical_np(km >> np.uint64(64 - 2 * k), k))
    km = km[:300_000]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(km, labels, names, DBConfig(k=k), nb_bits=17)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(R):
        for p in range(0, L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[3, 90:] = codec.INVALID
    return db, codes


@pytest.mark.parametrize("num_db", [2, 4])
@pytest.mark.parametrize("k", [27, 32])
def test_stash_range_kernel_matches_plain(dev, k, num_db):
    """The range query kernel on each db shard of a qs table (a main
    range and a stash range), written and accumulated, against its plain
    version; with the main rows zeroed every shard answers hits from its
    stash range alone; the shards add up to the resident labels."""
    db, codes = _qs_case(dev, k, 40 + k + num_db)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    zero = torch.zeros_like(main)
    nbl, nbsl = db.nb // num_db, stash.shape[0] // num_db
    total = None
    for j in range(num_db):
        args = dict(bucket_start=j * nbl, nb_local=nbl, k=k, spec=db.spec,
                    stash_start=j * nbsl)
        s_j = stash[j * nbsl:(j + 1) * nbsl]
        m_j = main[j * nbl:(j + 1) * nbl]
        before = kernels.LAUNCHES["query_part"]
        only = probe.query_part_labels(p2, vb, zero[j * nbl:(j + 1) * nbl],
                                       s_j, **args)
        got = probe.query_part_labels(p2, vb, m_j, s_j, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["query_part"] == before + 2
        assert torch.equal(only, probe.query_part_labels_plain(
            p2, vb, zero[j * nbl:(j + 1) * nbl], s_j, **args))
        assert torch.equal(got, probe.query_part_labels_plain(
            p2, vb, m_j, s_j, **args))
        assert int((only > 0).sum()) > 0, j
        total = probe.query_part_labels(p2, vb, m_j, s_j, acc=total, **args)
    torch.cuda.synchronize()
    assert torch.equal(total, probe.query_labels(p2, vb, main, stash, k=k,
                                                 spec=db.spec))


CODES_LAYOUTS = [("qs", 2, 2, 300_000, 17)] + LAYOUTS[:2]


@pytest.mark.parametrize("k", [27, 31, 32])
@pytest.mark.parametrize("layout,slots,choices,n,nb_bits", CODES_LAYOUTS)
def test_codes_kernel_matches_plain(dev, layout, slots, choices, n, nb_bits,
                                    k):
    """The query kernel's codes front half (pipeline.classify_step)
    against its plain version, and against the wire front half on the
    same reads."""
    db, p2, vb = _layout_case(dev, layout, slots, choices, n, nb_bits, k)
    codes = codec.unpack_codes(p2, vb).to(torch.uint8)
    codes[5, 17] = 200  # any byte >= 4 is an N
    main, stash = hashdb.table_to_device(db, dev)
    name = "query_codes" if layout == "qs" else f"query_codes_{layout}"
    before = kernels.LAUNCHES[name]
    got = probe.query_codes_labels(codes, main, stash, k=k, spec=db.spec)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got, probe.query_codes_labels_plain(
        codes, main, stash, k=k, spec=db.spec))
    codes[5, 17] = codec.INVALID
    wire = probe.query_labels(*(torch.from_numpy(a).to(dev) for a in
                                codec.pack_codes(codes.cpu().numpy())),
                              main, stash, k=k, spec=db.spec)
    assert torch.equal(probe.query_codes_labels(codes, main, stash, k=k,
                                                spec=db.spec), wire)
    assert int((got > 0).sum()) > 256


def test_mesh_classifier_matches_cpu(dev, tmp_path):
    """A 2 data x 2 db mesh of four handles of one card, resident and
    streamed, gives the CPU's rows through the range kernel."""
    from pathlib import Path

    from cuclark_tpu_torch import cli, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.hashdb import KmerDB
    from cuclark_tpu_torch.parallel import mesh

    ex = Path(__file__).resolve().parent.parent / "examples"
    assert cli.main(["build-db", "-T", str(ex / "targets.txt"),
                     "-D", str(tmp_path / "db"), "-k", "27"]) == 0
    db = KmerDB.load(next((tmp_path / "db").glob("db_k*.npz")))
    reads = str(ex / "reads.fq")
    m = mesh.make_mesh(2, 2, [dev] * 4)
    want = list(pipeline.Classifier(db, ClassifyConfig(
        extended=True, batch_reads=64), device="cpu").classify_file(reads))
    for budget in (None, db.table.nbytes / 2 / 4 / 1e6):
        clf = pipeline.Classifier(db, ClassifyConfig(
            extended=True, batch_reads=63, stream_group=2,
            max_table_mb=budget), mesh=m)
        assert (clf.stream_parts > 1) == (budget is not None)
        before = kernels.LAUNCHES["query_part"]
        try:
            assert list(clf.classify_file(reads)) == want
        finally:
            clf.close()
        assert kernels.LAUNCHES["query_part"] > before


TILE = 128  # csrc/query.cu kTile: windows per block


@pytest.mark.parametrize("k", [15, 16, 17, 27, 31, 32])
def test_query_kernel_tile_edges(dev, k):
    """The wire and codes front halves at P = TILE and TILE + 1 windows
    (one block and a block with one window), with an N on each side of
    every tile edge, against the plain versions on a qs table with a
    stash; the two front halves agree."""
    db, _ = _qs_case(dev, k, 70 + k)
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(k)
    km = db.items()[0]
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for P in (TILE, TILE + 1):
        L = P + k - 1
        R = 512
        codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
        for r in range(R):
            for p in range(int(rng.integers(k)), L - k + 1, k):
                codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
        edges = [q for q in (TILE - 1, TILE, TILE + k - 2, TILE + k - 1, L - 1)
                 if q < L]
        for i, q in enumerate(edges):
            codes[1 + 2 * i, q] = codec.INVALID
        codes[rng.random((R, L)) < 0.002] = codec.INVALID
        p2, vb = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_codes(codes))
        args = dict(k=k, spec=db.spec)
        got = probe.query_labels(p2, vb, main, stash, **args)
        torch.cuda.synchronize()
        want = probe.query_labels_plain(p2, vb, main, stash, **args)
        assert got.shape == (R, 4 * p2.shape[1] - k + 1)
        assert torch.equal(got, want)
        c = torch.from_numpy(codes).to(dev)
        got_c = probe.query_codes_labels(c, main, stash, **args)
        torch.cuda.synchronize()
        assert torch.equal(got_c, probe.query_codes_labels_plain(
            c, main, stash, **args))
        assert torch.equal(got_c, got[:, :P])
        assert int((want[:, :P] > 0).sum()) > R


def test_query_kernel_full_batch(dev):
    """A batch of exactly 65,536 reads of 152 bases (gridDim.x holds the
    reads): wire and codes front halves against plain."""
    k = 31
    db, _ = _qs_case(dev, k, 99)
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(3)
    km = db.items()[0]
    R, L = 65536, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    planted = (km[rng.integers(len(km), size=R)][:, None] >> shifts) & 3
    codes[:, 40:40 + k] = planted
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    args = dict(k=k, spec=db.spec)
    got = probe.query_labels(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert torch.equal(got, probe.query_labels_plain(p2, vb, main, stash,
                                                     **args))
    c = torch.from_numpy(codes).to(dev)
    got_c = probe.query_codes_labels(c, main, stash, **args)
    torch.cuda.synchronize()
    assert torch.equal(got_c, probe.query_codes_labels_plain(c, main, stash,
                                                             **args))
    assert int((got[:, 40] > 0).sum()) > R // 2


def test_query_kernel_rows_past_grid_limit(dev):
    """Rows of more than 65,535 tiles (an assembled genome classified as
    one record) take several launches of the query kernel; wire and codes
    front halves against plain, with hits past the first launch's tiles."""
    k = 31
    db, _ = _qs_case(dev, k, 123)
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(8)
    km = db.items()[0]
    first = 65535 * TILE
    R, L = 2, first + k + 1500
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    pos = np.arange(0, L - k + 1, 997)
    for r in range(R):
        planted = (km[rng.integers(len(km), size=len(pos))][:, None]
                   >> shifts) & 3
        codes[r, pos[:, None] + np.arange(k)] = planted
    codes[rng.random((R, L)) < 0.001] = codec.INVALID
    args = dict(k=k, spec=db.spec)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    got = probe.query_labels(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    want = probe.query_labels_plain(p2, vb, main, stash, **args)
    assert torch.equal(got, want)
    assert int((want[:, first:] > 0).sum()) > 0
    c = torch.from_numpy(codes).to(dev)
    got_c = probe.query_codes_labels(c, main, stash, **args)
    torch.cuda.synchronize()
    assert torch.equal(got_c, probe.query_codes_labels_plain(c, main, stash,
                                                             **args))


# nb_bits of fused_case's table by layout: qs and q4 at 57% of 2^17 x 4
# slots (the overflow fills the stash, or the second choice), s2 at 57%
# of 2^18 x 2 slots with two choices
FUSED_BITS = {"qs": 17, "q4": 17, "s2": 18}


def fused_case(k, L, layout="qs"):
    """For the fused query and score (here and in test_torch_fused.py):
    a table of `layout` (s2: 2 slots, 2 choices) of 300,000 random
    k-mers, the k-mers of 40 random reads and the poly-A k-mer, each with
    its own label; then 48 reads of L bases: the poly-A read, a read of
    Ns, a read shorter than k, a read whose every window is stored (one
    label a window), and reads of random bases with stored k-mers planted
    and a few Ns."""
    rng = np.random.default_rng(300 + k + L)
    R = 48
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    src = rng.integers(0, 4, size=(40, L)).astype(np.uint64)
    W = L - k + 1
    km = np.zeros((40, W), np.uint64)
    for j in range(k):
        km = (km << np.uint64(2)) | src[:, j:j + W]
    rand = rng.integers(0, np.iinfo(np.uint64).max, size=300_000,
                        dtype=np.uint64, endpoint=True)
    rand >>= np.uint64(64 - 2 * k)
    keys = np.unique(np.concatenate([codec.canonical_np(rand, k),
                                     codec.canonical_np(km.ravel(), k),
                                     np.zeros(1, np.uint64)]))
    labels = rng.integers(1, 65536, size=len(keys)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb.build_table(keys, labels, names, DBConfig(
        k=k, layout=layout, slots=2, num_choices=2),
        nb_bits=FUSED_BITS[layout])
    for r in range(8, R):
        for p in range(int(rng.integers(k)), L - k + 1, k):
            codes[r, p:p + k] = (keys[rng.integers(len(keys))] >> shifts) & 3
    codes[0] = 3                                  # poly-A (A is 3)
    codes[1] = codec.INVALID                      # no valid window
    codes[2, k - 1:] = codec.INVALID              # shorter than k
    codes[3] = src[0]                             # every window stored
    codes[4, ::17] = codec.INVALID
    noise = rng.random((R, L)) < 0.005
    noise[:4] = False
    codes[noise] = codec.INVALID
    return db, codes



# (k, L): the wire batch's P = Lp - k + 1 <= 128, Lp = L rounded up to 8
FUSED = [(15, 128), (17, 144), (27, 152), (31, 128), (31, 152), (32, 152)]
# reads of two to eight tiles: the 160, 256, 320 (joined 2 x 150 bp pairs)
# and 1024 bins at k 27 and 31 (P 130 to 998)
FUSED_WIDE = [(k, L) for L in (160, 256, 320, 1024) for k in (27, 31)]


@pytest.mark.parametrize("k,L", FUSED + FUSED_WIDE)
def test_query_score_kernel_matches_plain(dev, k, L):
    """The fused query and score (one launch) against its plain version
    and against the query kernel then the score kernel: a poly-A read, a
    read of Ns, a read shorter than k, a read of one label a window."""
    db, codes = fused_case(k, L)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec)
    before = dict(kernels.LAUNCHES)
    got = probe.query_score_results(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["query_score"] == before["query_score"] + 1
    assert kernels.LAUNCHES["query"] == before["query"]
    want = probe.query_score_results_plain(p2, vb, main, stash, **args)
    assert torch.equal(got, want)
    two = score.score_labels(probe.query_labels(p2, vb, main, stash, **args))
    assert torch.equal(got, two)
    assert int(got[0, 2]) == 4 * p2.shape[1] - k + 1
    assert int(got[1:3].abs().sum()) == 0


def test_query_score_kernel_full_batch(dev):
    """A batch of exactly 65,536 reads of 152 bases (the main path's
    shape, a block per read), then a batch of 65,536 poly-A reads (the
    whole batch one k-mer, one label) and one of 65,536 reads of Ns."""
    k = 31
    db, _ = _qs_case(dev, k, 98)
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(4)
    km = db.items()[0]
    R, L = 65536, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for p in (0, 40, 90):
        codes[:, p:p + k] = (km[rng.integers(len(km), size=R)][:, None]
                             >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    args = dict(k=k, spec=db.spec)
    hits = 0
    for batch in (codes, np.full((R, L), 3, np.uint8),
                  np.full((R, L), codec.INVALID, np.uint8)):
        p2, vb = (torch.from_numpy(a).to(dev)
                  for a in codec.pack_codes(batch))
        got = probe.query_score_results(p2, vb, main, stash, **args)
        torch.cuda.synchronize()
        want = probe.query_score_results_plain(p2, vb, main, stash, **args)
        assert torch.equal(got, want)
        hits += int((want[:, 2] > 0).sum())
    assert hits > R // 2


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_query_score_kernel_paired_full_batch(dev, layout):
    """A batch of exactly 65,536 joined pairs in the 320 bin (mate 1, an
    N, mate 2: P = 290, three tiles a read), fused_case's reads repeated
    with 1% of their bases changed, one launch against plain and against
    the query kernel then the score kernel."""
    k, L, R = 31, 320, 65536
    db, codes = fused_case(k, L, layout)
    rng = np.random.default_rng(11)
    batch = np.resize(codes, (R, L))
    change = rng.random((R, L)) < 0.01
    batch[change] = rng.integers(0, 4, size=int(change.sum()))
    batch[:, 150] = codec.INVALID                  # the joining N
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(batch))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec)
    name = "query_score" + ("" if layout == "qs" else f"_{layout}")
    before = dict(kernels.LAUNCHES)
    got = probe.query_score_results(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert torch.equal(got, probe.query_score_results_plain(
        p2, vb, main, stash, **args))
    assert torch.equal(got, score.score_labels(probe.query_labels(
        p2, vb, main, stash, **args)))
    assert int((got[:, 2] > 0).sum()) > R // 2


@pytest.mark.parametrize("L,fused", [(152, True), (160, True), (320, True),
                                     (1024, True), (1088, False)])
def test_classify_step_packed_takes_fused_kernel(dev, L, fused):
    """classify_step_packed without labels launches the fused kernel
    alone for reads of up to 1,024 windows (P = 122 at L 152, 130 at
    160, 290 at 320, 994 at 1024) and the query and score kernels for
    wider ones (P = 1,058 at L 1088); with labels, always the two.  The
    results are the same."""
    from cuclark_tpu_torch import pipeline

    k = 31
    db, codes = _qs_case(dev, k, 77)               # [256, 152]
    codes = np.concatenate([codes] * 8, axis=1)[:, :L]
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec, stash=stash)
    before = dict(kernels.LAUNCHES)
    res, lab = pipeline.classify_step_packed(main, p2, vb, with_labels=False,
                                             **args)
    torch.cuda.synchronize()
    after = dict(kernels.LAUNCHES)
    assert lab is None
    assert after["query_score"] - before["query_score"] == int(fused)
    assert after["query"] - before["query"] == int(not fused)
    assert after["score"] - before["score"] == int(not fused)
    res2, lab2 = pipeline.classify_step_packed(main, p2, vb, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["query"] == after["query"] + 1
    assert lab2.shape[1] == 4 * p2.shape[1] - k + 1
    assert torch.equal(res, res2)


def test_query_score_refuses_what_it_does_not_take(dev):
    """Rows over 1,024 windows, a table of another layout and a missing
    stash raise ValueError before anything launches."""
    k = 31
    db, codes = _qs_case(dev, k, 12)
    main, stash = hashdb.table_to_device(db, dev)
    wide = np.concatenate([codes] * 7, axis=1)                # P = 1,034
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(wide))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="P <= 1024"):
        kernels.query_score(p2, vb, main, stash, k=k, spec=db.spec)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    with pytest.raises(ValueError, match="stash"):
        kernels.query_score(p2, vb, main, None, k=k, spec=db.spec)
    q4 = hashdb.TableSpec(layout="q4", nb_bits=db.nb_bits, seed=db.seed)
    with pytest.raises(ValueError, match="qs table"):
        kernels.query_score(p2, vb, main, stash, k=k, spec=q4)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("k,L", FUSED + FUSED_WIDE)
@pytest.mark.parametrize("layout", ["q4", "s2"])
def test_layout_query_score_kernel_matches_plain(dev, layout, k, L):
    """The fused q4 or s2 query and score (one launch, counted as
    query_score_<layout>) against its plain version and against the
    query kernel then the score kernel, on the full table and on the
    table with its first-choice entries removed, where every hit comes
    from a second gather."""
    db, codes = fused_case(k, L, layout)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    args = dict(k=k, spec=db.spec)
    name = f"query_score_{layout}"
    hits = []
    for table in (db.table, db.second_choice_only()):
        main = torch.from_numpy(table.view(np.int32)).to(dev)
        before = dict(kernels.LAUNCHES)
        got = probe.query_score_results(p2, vb, main, None, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert kernels.LAUNCHES["score"] == before["score"]
        want = probe.query_score_results_plain(p2, vb, main, None, **args)
        assert torch.equal(got, want)
        two = score.score_labels(probe.query_labels(p2, vb, main, None,
                                                    **args))
        assert torch.equal(got, two)
        hits.append(int((want[:, 2] > 0).sum()))
    assert hits[0] > hits[1] > 0


def _choice_buckets(p2, vb, spec, k):
    """The choice-0 and choice-1 main buckets of every window of a wire
    batch (q4: l2 and h1; s2: mix1 and mix2 of the canonical k-mer),
    int64 [R, P] each, and the windows' validity."""
    kmers, valid = codec.extract_kmers(codec.unpack_codes(p2, vb), k)
    km = codec.canonical(kmers, k)
    hi, lo = codec.shr(km, 32), km & 0xFFFFFFFF
    mask = (1 << spec.nb_bits) - 1
    if spec.layout == "q4":
        h1, l2 = hashdb.feistel_mix_torch(hi, lo, spec.seed)
        return l2 & mask, h1 & mask, valid
    return (hashdb.mix1_torch(hi, lo) & mask,
            hashdb.mix2_torch(hi, lo) & mask, valid)


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("layout,slots,choices,n,nb_bits",
                         [c for c in LAYOUTS if c[2] == 2])
def test_layout_query_kernel_second_choice_only(dev, layout, slots, choices,
                                                n, nb_bits, parts,
                                                accumulate):
    """The q4 and s2 query kernels, resident and on 2 to 8 bucket-range
    parts, against plain on a table that holds its second-choice entries
    alone: every hit takes the second gather after a first-choice miss,
    in the range kernel's second round where both choices lie in the
    part, in its first where only choice 1 does; both kinds of hit
    occur."""
    k = 31
    db, p2, vb = _layout_case(dev, layout, slots, choices, n, nb_bits, k)
    main = torch.from_numpy(db.second_choice_only().view(np.int32)).to(dev)
    got = probe.query_labels(p2, vb, main, None, k=k, spec=db.spec)
    torch.cuda.synchronize()
    want = probe.query_labels_plain(p2, vb, main, None, k=k, spec=db.spec)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 0
    rows = db.nb // parts
    b0, b1, _ = _choice_buckets(p2, vb, db.spec, k)
    same = (b0 // rows) == (b1 // rows)
    assert int((same & (want > 0)).sum()) > 0
    assert int((~same & (want > 0)).sum()) > 0
    rng = np.random.default_rng(parts)
    for p in range(parts):
        args = dict(bucket_start=p * rows, nb_local=rows, k=k, spec=db.spec)
        part = main[p * rows:(p + 1) * rows].contiguous()
        acc = (torch.from_numpy(rng.integers(0, 1000, size=tuple(want.shape),
                                             dtype=np.int32)).to(dev)
               if accumulate else None)
        expect = probe.query_part_labels_plain(
            p2, vb, part, None, acc=None if acc is None else acc.clone(),
            **args)
        got = probe.query_part_labels(p2, vb, part, None, acc=acc, **args)
        torch.cuda.synchronize()
        assert torch.equal(got, expect)


# fused_case's table of each layout, built once for the width cases
_RANGE_DBS = {}

# read lengths of 1 to 9 tiles of range windows at k = 31 (P = L - 30):
# 122, 128 and 129 windows, paired 290, the 512 and 1024 bins, past 1,024
RANGE_WIDTHS = [152, 158, 159, 320, 542, 1054, 1100]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("parts", [4, 8])
@pytest.mark.parametrize("L", RANGE_WIDTHS)
@pytest.mark.parametrize("layout,split", [("qs", False), ("qs", True),
                                          ("q4", False), ("s2", False)],
                         ids=["qs", "qs-split", "q4", "s2"])
def test_range_query_kernel_widths(dev, layout, split, L, parts, accumulate):
    """The range kernel at reads of one to nine tiles (several reads a
    block, a read a block, several blocks a read) on each part of a
    table of every layout (qs with its stash on part 0, or split over the
    parts as a table is streamed: `probe.stash_range`, stash ranges that
    start past row 0), against plain, written and accumulated; the parts
    add up to the resident labels."""
    k = 31
    if layout not in _RANGE_DBS:
        _RANGE_DBS[layout] = fused_case(k, 152, layout)[0]
    db = _RANGE_DBS[layout]
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(L + parts)
    km = db.items()[0]
    R = 300
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(int(rng.integers(k)), L - k + 1, k):
            codes[r, p:p + k] = (km[rng.integers(len(km))] >> shifts) & 3
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    codes[5, L // 2:] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    P = 4 * p2.shape[1] - k + 1
    rows = db.nb // parts
    total = None
    for p in range(parts):
        s, sstart = (probe.stash_range(stash, p, parts) if split
                     else (stash if p == 0 else None, 0))
        args = dict(bucket_start=p * rows, nb_local=rows, k=k, spec=db.spec,
                    stash_start=sstart)
        part = main[p * rows:(p + 1) * rows]
        acc = (torch.from_numpy(rng.integers(0, 1000, size=(R, P),
                                             dtype=np.int32)).to(dev)
               if accumulate else None)
        want = probe.query_part_labels_plain(
            p2, vb, part, s, acc=None if acc is None else acc.clone(),
            **args)
        got = probe.query_part_labels(p2, vb, part, s, acc=acc, **args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p
        total = probe.query_part_labels(p2, vb, part, s, acc=total, **args)
    torch.cuda.synchronize()
    resident = probe.query_labels(p2, vb, main, stash, k=k, spec=db.spec)
    assert torch.equal(total, resident)
    assert int((resident > 0).sum()) > R


@pytest.mark.parametrize("layout,parts", [("qs", 4), ("q4", 2), ("s2", 4)])
def test_range_query_rows_past_grid_limit(dev, layout, parts):
    """A row of more than 65,535 tile groups of the range kernel (W
    tiles a group) takes several launches; each part against plain,
    written and accumulated, with hits past the first launch's tiles."""
    k = 31
    if layout == "qs":
        db, _ = _qs_case(dev, k, 124)
    else:
        db = _layout_case(dev, *next(c for c in LAYOUTS if c[0] == layout),
                          k)[0]
    main, stash = hashdb.table_to_device(db, dev)
    rng = np.random.default_rng(parts)
    km = db.items()[0]
    first = 65535 * parts * TILE
    L = first + k + 1500
    codes = rng.integers(0, 4, size=(1, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    pos = np.arange(0, L - k + 1, 997)
    planted = (km[rng.integers(len(km), size=len(pos))][:, None]
               >> shifts) & 3
    codes[0, pos[:, None] + np.arange(k)] = planted
    codes[rng.random((1, L)) < 0.001] = codec.INVALID
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    rows = db.nb // parts
    assert kernels.range_windows(db.nb_bits, rows, layout) == parts
    assert len(kernels.range_geometry(1, L - k + 1, parts).launches) == 2
    acc = None
    for p in range(parts):
        args = dict(bucket_start=p * rows, nb_local=rows, k=k, spec=db.spec)
        s = stash if p == 0 else None
        part = main[p * rows:(p + 1) * rows]
        want = probe.query_part_labels_plain(
            p2, vb, part, s, acc=None if acc is None else acc.clone(),
            **args)
        acc = probe.query_part_labels(p2, vb, part, s, acc=acc, **args)
        torch.cuda.synchronize()
        assert torch.equal(acc, want), p
    assert int((acc[:, first:] > 0).sum()) > 0
    assert torch.equal(acc, probe.query_labels(p2, vb, main, stash, k=k,
                                               spec=db.spec))


def test_profile_twice_in_one_process(dev, tmp_path):
    """Two `classify --device cuda --profile` runs in one process: each
    run's trace holds one kernel event for each kernel it launched (a
    profiler session leaves nothing behind that empties the next one's
    trace), and both write the same CSV."""
    from cuclark_tpu_torch import cli

    ex = Path(__file__).resolve().parents[1] / "examples"
    quiet = (contextlib.redirect_stdout(io.StringIO()),
             contextlib.redirect_stderr(io.StringIO()))
    with quiet[0], quiet[1]:
        assert cli.main(["build-db", "-T", str(ex / "targets.txt"), "-D",
                         str(tmp_path / "db"), "-k", "27"]) == 0
    for i in range(2):
        tdir = tmp_path / f"trace{i}"
        kernels.reset_launches()
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["classify", "-D", str(tmp_path / "db"), "-O",
                             str(ex / "reads.fq"), "-R",
                             str(tmp_path / f"{i}.csv"), "--device", "cuda",
                             "--profile", str(tdir)]) == 0
        torch.cuda.synchronize()
        launched = sum(kernels.LAUNCHES.values())
        (trace,) = tdir.glob("*.pt.trace.json")
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") == "kernel"]
        assert launched >= 1 and len(events) == launched
    assert (tmp_path / "0.csv").read_bytes() == (tmp_path / "1.csv"
                                                 ).read_bytes()


# (P, k, L) of the fused range entry's card tests: one tile, then two to
# eight (129 to 1,024 windows; 290 the joined 2 x 150 bp pairs)
FUSED_RANGE_P = [(1, 32, 32), (64, 25, 88), (122, 31, 152), (128, 25, 152),
                 (129, 32, 160), (130, 31, 160), (162, 31, 192),
                 (226, 31, 256), (256, 25, 280), (290, 31, 320),
                 (294, 27, 320), (482, 31, 512), (994, 31, 1024),
                 (998, 27, 1024), (1024, 25, 1048)]


@pytest.mark.parametrize("acc", ["random", "none"])
@pytest.mark.parametrize("P_,k,L", FUSED_RANGE_P)
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_query_score_part_kernel_matches_plain(dev, layout, P_, k, L, acc):
    """The fused range entry (`cuclark_query_score_range` through
    kernels.query_score_part) against its plain version: the whole
    table; each of 4 parts, the qs stash on part 0 and a null stash on
    the others; each of 2 db shards with its stash range; acc_in None,
    or random labels on half the windows the range misses (a key lives
    in one range only, so where the range hits the other launches give
    0); one launch a call, counted as query_score_part[_q4|_s2], or as
    query_score_queue[_q4|_s2] where the route takes the queued launch
    (kernels.queue_score_windows: parts, and q4's db shards, at the tile
    counts it routes).  Then 3 parts accumulated by the range kernel and the last
    one fused with their sum give the resident fused results."""
    db, codes = fused_case(k, L, layout)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    assert 4 * p2.shape[1] - k + 1 == P_
    main, stash = hashdb.table_to_device(db, dev)
    spec = db.spec
    suffix = "" if layout == "qs" else f"_{layout}"
    rng = np.random.default_rng(P_)
    a = rng.integers(1, 65536, size=(p2.shape[0], P_)).astype(np.int32)
    a[rng.random(a.shape) < 0.5] = 0
    nbs = 0 if stash is None else stash.shape[0]
    ranges = [(0, db.nb, stash, 0)]
    ranges += [(p * db.nb // 4, db.nb // 4, stash if p == 0 else None, 0)
               for p in range(4)]
    ranges += [(j * db.nb // 2, db.nb // 2,
                None if stash is None else stash[j * nbs // 2:
                                                 (j + 1) * nbs // 2],
                j * nbs // 2) for j in range(2)]
    for start, rows, s, sstart in ranges:
        part = main[start:start + rows]
        acc_in = None
        if acc == "random":
            own = probe.query_part_labels_plain(
                p2, vb, part, s, bucket_start=start, nb_local=rows, k=k,
                spec=spec, stash_start=sstart).cpu().numpy()
            acc_np = np.where(own > 0, 0, a)
            acc_in = torch.from_numpy(acc_np).to(dev)
        args = dict(bucket_start=start, nb_local=rows, k=k, spec=spec,
                    stash_start=sstart, acc_in=acc_in)
        name = ("query_score_queue" if kernels.queue_score_windows(
            db.nb_bits, rows, layout, P_) > 1 else "query_score_part") + suffix
        before = dict(kernels.LAUNCHES)
        got = probe.query_score_part_results(p2, vb, part, s, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
        want = probe.query_score_part_results_plain(p2, vb, part, s, **args)
        assert torch.equal(got, want), (start, rows)
        if acc_in is not None:
            assert torch.equal(acc_in.cpu(), torch.from_numpy(acc_np))
    rows = db.nb // 4
    sums = None
    for p in range(3):
        sums = probe.query_part_labels(
            p2, vb, main[p * rows:(p + 1) * rows], stash if p == 0 else None,
            bucket_start=p * rows, nb_local=rows, k=k, spec=spec, acc=sums)
    got = probe.query_score_part_results(
        p2, vb, main[3 * rows:], None, bucket_start=3 * rows, nb_local=rows,
        k=k, spec=spec, acc_in=sums)
    resident = probe.query_score_results(p2, vb, main, stash, k=k, spec=spec)
    torch.cuda.synchronize()
    assert torch.equal(got, resident)
    assert int((resident[:, 2] > 0).sum()) > 0


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("acc", ["random", "none"])
@pytest.mark.parametrize("P_,k,L", FUSED_RANGE_P)
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_query_score_queue_kernel_matches_plain(dev, layout, P_, k, L, acc,
                                                W):
    """The queued fused range launch (`cuclark_query_score_queue`,
    range_query_score_kernel, through kernels.query_score_queue at W 2
    and 4) against the fused range entry's plain version, on 47 reads (a
    ragged last block at either W): each of 4 parts, the qs stash split
    over them; each of 2 db shards with its stash range; acc_in None or
    random labels on half the windows the range misses; one launch a
    call, counted as query_score_queue[_q4|_s2]; acc_in is left as it
    was."""
    db, codes = fused_case(k, L, layout)
    p2, vb = (torch.from_numpy(a).to(dev)
              for a in codec.pack_codes(codes[:47]))
    assert 4 * p2.shape[1] - k + 1 == P_
    main, stash = hashdb.table_to_device(db, dev)
    spec = db.spec
    name = "query_score_queue" + ("" if layout == "qs" else f"_{layout}")
    rng = np.random.default_rng(P_ + W)
    a = rng.integers(1, 65536, size=(p2.shape[0], P_)).astype(np.int32)
    a[rng.random(a.shape) < 0.5] = 0
    ranges = []
    for n in (4, 2):
        rows = db.nb // n
        for j in range(n):
            s, sstart = probe.stash_range(stash, j, n)
            ranges.append((j * rows, rows, s, sstart))
    hits = 0
    for start, rows, s, sstart in ranges:
        part = main[start:start + rows]
        own = probe.query_part_labels_plain(
            p2, vb, part, s, bucket_start=start, nb_local=rows, k=k,
            spec=spec, stash_start=sstart).cpu().numpy()
        hits += int((own > 0).sum())
        acc_np = np.where(own > 0, 0, a)
        acc_in = torch.from_numpy(acc_np).to(dev) if acc == "random" else None
        args = dict(bucket_start=start, k=k, spec=spec, stash_start=sstart,
                    acc_in=acc_in)
        before = dict(kernels.LAUNCHES)
        got = kernels.query_score_queue(p2, vb, part, s, windows=W, **args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
        want = probe.query_score_part_results_plain(p2, vb, part, s,
                                                    nb_local=rows, **args)
        assert torch.equal(got, want), (start, rows, W)
        if acc_in is not None:
            assert torch.equal(acc_in.cpu(), torch.from_numpy(acc_np))
    assert hits > 0


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_resident_fused_step_unchanged(dev, layout):
    """The resident fused step (query_score, counted as before) is bit
    for bit the query kernel then the score kernel, and the fused range
    entry over the whole table without acc_in (or with a zero acc_in)
    gives the same results."""
    k, L = 31, 152
    db, codes = fused_case(k, L, layout)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))
    main, stash = hashdb.table_to_device(db, dev)
    args = dict(k=k, spec=db.spec)
    name = "query_score" + ("" if layout == "qs" else f"_{layout}")
    before = dict(kernels.LAUNCHES)
    got = probe.query_score_results(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    two = score.score_labels(probe.query_labels(p2, vb, main, stash, **args))
    assert torch.equal(got, two)
    rng = dict(bucket_start=0, nb_local=db.nb, **args)
    zero = torch.zeros((p2.shape[0], 4 * p2.shape[1] - k + 1),
                       dtype=torch.int32, device=dev)
    for acc_in in (None, zero):
        part = probe.query_score_part_results(p2, vb, main, stash,
                                              acc_in=acc_in, **rng)
        torch.cuda.synchronize()
        assert torch.equal(part, got)


@pytest.mark.parametrize("num_data,num_db", [(1, 1), (2, 2), (1, 4)])
def test_mesh_step_launches_fused(dev, num_data, num_db):
    """On a num_data x num_db mesh of handles of the card, a one-tile
    batch without labels launches (num_db - 1) x num_data range kernels
    and num_data fused ones (the queued fused launch where a qs shard is
    at most a quarter of the table: 4 db shards), and no score kernel;
    with labels, range kernels and a score a block.  Both give the
    resident results."""
    from cuclark_tpu_torch.parallel import mesh

    k = 31
    db, codes = _qs_case(dev, k, 55)
    p2, vb = codec.pack_codes(codes)
    main_t, stash_t = hashdb.table_to_device(db, dev)
    want = probe.query_score_results(*(torch.from_numpy(a).to(dev)
                                       for a in (p2, vb)), main_t, stash_t,
                                     k=k, spec=db.spec)
    m = mesh.make_mesh(num_db, num_data, [dev] * (num_data * num_db))
    sc = mesh.ShardedClassifier(db, m, with_labels=False)
    kernels.reset_launches()
    res, lab = sc.step_packed(p2, vb)
    torch.cuda.synchronize()
    assert lab is None
    fused = ("query_score_queue" if kernels.queue_score_windows(
        db.nb_bits, db.nb // num_db, "qs", 4 * p2.shape[1] - k + 1) > 1
        else "query_score_part")
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {
        fused: num_data, "query_part": (num_db - 1) * num_data
    } or (num_db == 1 and {n: c for n, c in kernels.LAUNCHES.items() if c}
          == {"query_score_part": num_data})
    assert torch.equal(torch.cat(res), want)
    kernels.reset_launches()
    res, lab = mesh.ShardedClassifier(db, m).step_packed(p2, vb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["query_part"] == num_db * num_data
    assert kernels.LAUNCHES["score"] == num_data
    assert kernels.LAUNCHES["query_score_part"] == 0
    assert kernels.LAUNCHES["query_score_queue"] == 0
    assert torch.equal(torch.cat(res), want)


@pytest.fixture(scope="module")
def stash20(dev):
    """A qs table of 2^17 main rows and 2^20 stash rows (the headline
    table's stash) holding 650,000 31-mers, the overflow of the main
    rows in the stash; the k-mers stored in the stash, and the table on
    the card."""
    k = 31
    rng = np.random.default_rng(20)
    km = rng.integers(0, 1 << 62, size=700_000, dtype=np.uint64)
    km = np.unique(codec.canonical_np(km, k))[:650_000]
    labels = rng.integers(1, 65536, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 65536)]
    db = hashdb._try_build_qs(km, labels, names, DBConfig(k=k), 17, 20, 0)
    assert db is not None and db.stash_bits == 20
    stash_km, _ = db.items(rows=(db.nb, db.total_rows))
    assert len(stash_km) > 50_000
    return db, stash_km, hashdb.table_to_device(db, dev)


def _stash_reads(km, k, R, L, seed):
    """R reads of L bases, every other one with stored k-mers planted on
    the forward strand a k-mer apart, 1% Ns."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.uint64))
    for r in range(0, R, 2):
        for p in range(0, L - 2 * k, k):
            v = km[rng.integers(len(km))]
            codes[r, p:p + k] = (v >> shifts) & np.uint64(3)
    codes[rng.random((R, L)) < 0.01] = codec.INVALID
    return codec.pack_codes(codes)


def _qs_paths_match_plain(db, main, stash, p2, vb):
    """The resident fused step, the query kernel, the range kernel on
    each of 4 parts with the stash split over them (as a streamed table
    and a mesh's db shards split it) and a streamed batch's last part
    fused with the earlier parts' sum, each bit-identical to plain.
    Returns the plain labels."""
    k, spec = db.k, db.spec
    args = dict(k=k, spec=spec)
    labels = probe.query_labels_plain(p2, vb, main, stash, **args)
    before = dict(kernels.LAUNCHES)
    fused = probe.query_score_results(p2, vb, main, stash, **args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["query_score"] == before["query_score"] + 1
    want = probe.query_score_results_plain(p2, vb, main, stash, **args)
    assert torch.equal(fused, want)
    assert torch.equal(probe.query_labels(p2, vb, main, stash, **args),
                       labels)
    rows, srows = db.nb // 4, (1 << db.stash_bits) // 4
    acc = None
    for p in range(4):
        part = dict(bucket_start=p * rows, nb_local=rows,
                    stash_start=p * srows, **args)
        m, s = main[p * rows:(p + 1) * rows], stash[p * srows:(p + 1) * srows]
        got = probe.query_part_labels(p2, vb, m, s, **part)
        torch.cuda.synchronize()
        assert torch.equal(got, probe.query_part_labels_plain(p2, vb, m, s,
                                                              **part)), p
        if p == 3:
            last = probe.query_score_part_results(p2, vb, m, s, acc_in=acc,
                                                  **part)
            torch.cuda.synchronize()
            assert torch.equal(last, probe.query_score_part_results_plain(
                p2, vb, m, s, acc_in=acc, **part))
            assert torch.equal(last, want)
        acc = got if acc is None else acc + got
    assert torch.equal(acc, labels)
    return labels


@pytest.mark.parametrize("L", [152, 320])
def test_stash_only_hits_match_plain(dev, stash20, L):
    """Hits that only the 2^20-row stash answers (a main-row miss whose
    row is full), bit-identical to plain on every qs path
    (`_qs_paths_match_plain`; one tile at L 152, three at L 320)."""
    db, stash_km, (main, stash) = stash20
    p2, vb = (torch.from_numpy(a).to(dev)
              for a in _stash_reads(stash_km, db.k, 2048, L, L))
    no_stash = probe.query_part_labels_plain(
        p2, vb, main, None, bucket_start=0, nb_local=db.nb, k=db.k,
        spec=db.spec)
    assert int((no_stash > 0).sum()) == 0
    labels = _qs_paths_match_plain(db, main, stash, p2, vb)
    assert int((labels > 0).sum()) >= 2048 // 2


@pytest.mark.parametrize("L", [152, 320])
def test_sampled_table_matches_plain(dev, stash20, tmp_path, L):
    """A table loaded with a sample factor (`KmerDB.load` zeroes every
    row but each third, main and stash alike) keeps stash keys whose
    main row it zeroed: the kernels read the stash behind an empty main
    row, bit-identical to plain on every qs path."""
    db, stash_km, _ = stash20
    path = tmp_path / "stash20.npz"
    db.save(path)
    sampled = hashdb.KmerDB.load(path, sample_factor=3)
    main, stash = hashdb.table_to_device(sampled, dev)
    p2, vb = (torch.from_numpy(a).to(dev)
              for a in _stash_reads(stash_km, db.k, 2048, L, L + 1))
    labels = _qs_paths_match_plain(sampled, main, stash, p2, vb)
    # some of those hits come from stash rows behind zeroed main rows
    kmers, valid = codec.extract_kmers(codec.unpack_codes(p2, vb), db.k)
    km = codec.canonical(kmers, db.k)
    _, l2 = hashdb.feistel_mix_torch(codec.shr(km, 32), km & 0xFFFFFFFF,
                                     db.seed)
    empty = (main[l2 & (db.nb - 1)] == 0).all(-1)
    assert int((valid & empty & (labels > 0)).sum()) > 0


def test_step_launch_spans_enclose_their_launches(dev, tmp_path):
    """In a CUDA-only torch.profiler trace (the benchmark's), each
    `step.launch` span of the program, mapped with `spans.trace_us`,
    encloses its kernel's `cudaLaunchKernel` event: the spans and the
    trace share one clock on the card's torch."""
    from torch.profiler import ProfilerActivity, profile

    from cuclark_tpu_torch import pipeline, spans

    rng = np.random.default_rng(22)
    km = np.unique(codec.canonical_np(rng.integers(
        0, 1 << 62, size=60_000, dtype=np.uint64), 31))
    labels = rng.integers(1, 100, size=len(km)).astype(np.uint32)
    db = hashdb.build_table(km, labels, ["NA"] + [f"T{i}" for i in
                                                  range(1, 100)],
                            DBConfig(k=31))
    main, stash = hashdb.table_to_device(db, dev)
    codes = rng.integers(0, 4, size=(4096, 152)).astype(np.uint8)
    p2, vb = (torch.from_numpy(a).to(dev) for a in codec.pack_codes(codes))

    def steps(n):
        for _ in range(n):
            for labels_too in (False, True):  # fused; query + score
                pipeline.classify_step_packed(main, p2, vb, k=31,
                                              spec=db.spec, stash=stash,
                                              with_labels=labels_too)

    steps(2)
    torch.cuda.synchronize()
    since = spans.mark()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    steps(20)
    torch.cuda.synchronize()
    prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    assert base == spans.BASE_NS, torch.__version__
    calls = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in trace["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "cuda_runtime"
             and e["name"].startswith("cudaLaunchKernel")]
    ours = [s for s in spans.snapshot(since)["spans"]
            if s.name == "step.launch"]
    assert len(ours) == 20 * 3
    inside = [any(spans.trace_us(s.start_ns, base) <= a
                  and b <= spans.trace_us(s.end_ns, base) for a, b in calls)
              for s in ours]
    assert all(inside), (f"{sum(inside)} of {len(ours)} step.launch spans "
                         f"enclose a launch, torch {torch.__version__}")
