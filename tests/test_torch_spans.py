"""The port's span-and-counter recorder (`cuclark_tpu_torch.spans`) on
the CPU: nesting, parents and self time; one batch id across a file→CSV
pass's three threads; what records outside a session; the buffer's
bound; the clock a torch.profiler Chrome trace uses; and the thread
split read from the spans.  Imports no JAX."""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cuclark_tpu_torch import hashdb, pipeline, spans
from cuclark_tpu_torch.config import ClassifyConfig, DBConfig

ROOT = Path(__file__).resolve().parent.parent
K = 31
PER_BATCH = {"read_scan", "inflate", "mate_check", "pack", "ring_acquire",
             "put_wire", "device_step", "readback_issue", "readback_wait",
             "rows", "flush_write", "prefetch_put_wait", "prefetch_get_wait",
             "writer_future_wait", "step", "step.launch", "part_upload"}


def _db(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    km = np.unique(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    labels = rng.integers(1, 4, size=len(km)).astype(np.uint32)
    return hashdb.build_table(km, labels, ["NA", "a", "b", "c"],
                              DBConfig(k=K))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """300 random 150 bp reads, paired mates of 75 bp, and a gzip copy of
    the reads."""
    import gzip

    tmp = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(5)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (300, 150))]
    out = {}
    for name, cut, tag in (("r.fq", slice(0, 150), b""),
                           ("m1.fq", slice(0, 75), b"/1"),
                           ("m2.fq", slice(75, 150), b"/2")):
        p = tmp / name
        p.write_bytes(b"".join(b"@r%d%s\n%s\n+\n%s\n" % (
            i, tag, s[cut].tobytes(), b"I" * len(s[cut].tobytes()))
            for i, s in enumerate(seqs)))
        out[name] = p
    gz = tmp / "r.fq.gz"
    gz.write_bytes(gzip.compress(out["r.fq"].read_bytes(), 6, mtime=0))
    out["r.fq.gz"] = gz
    out["tmp"] = tmp
    return out


def test_nesting_parents_and_self_time():
    with spans.session() as ss:
        with spans.span("outer", batch=7) as o:
            time.sleep(0.002)
            with spans.span("inner") as i1:
                time.sleep(0.002)
            with spans.span("inner", batch=8) as i2:
                with spans.span("leaf"):
                    time.sleep(0.001)
    got = {s.id: s for s in ss.snapshot()["spans"]}
    assert set(got) == {o.id, i1.id, i2.id, i2.id + 1}
    leaf = got[i2.id + 1]
    assert got[o.id].parent == 0
    assert got[i1.id].parent == got[i2.id].parent == o.id
    assert leaf.parent == i2.id
    # a child without a batch id takes its parent's
    assert got[i1.id].batch == 7 and got[i2.id].batch == 8
    assert leaf.batch == 8
    assert len({s.thread for s in got.values()}) == 1
    own = spans.self_ns(list(got.values()))
    dur = {i: s.end_ns - s.start_ns for i, s in got.items()}
    assert own[o.id] == dur[o.id] - dur[i1.id] - dur[i2.id]
    assert own[i2.id] == dur[i2.id] - dur[leaf.id]
    assert own[leaf.id] == dur[leaf.id] == leaf.end_ns - leaf.start_ns
    assert own[o.id] >= 2_000_000


def test_self_time_counts_overlapping_children_once():
    S = spans.Span
    rows = [S(1, 0, "p", 0, 100, 1, None, None),
            S(2, 1, "c", 10, 40, 1, None, None),
            S(3, 1, "c", 30, 60, 1, None, None),
            S(4, 1, "c", 90, 150, 1, None, None)]
    assert spans.self_ns(rows)[1] == 100 - 50 - 10


def test_self_time_among_names_reaches_through_other_spans():
    """With `names`, a span of another name counts inside its holder, and
    the holder's nearest named descendant is its child."""
    S = spans.Span
    rows = [S(1, 0, "stage", 0, 100, 1, None, None),
            S(2, 1, "step", 10, 90, 1, None, None),
            S(3, 2, "stage", 20, 30, 1, None, None),
            S(4, 3, "leaf", 22, 28, 1, None, None)]
    assert spans.self_ns(rows, {"stage"}) == {1: 90, 3: 10}
    assert spans.self_ns(rows) == {1: 20, 2: 70, 3: 4, 4: 6}


def test_spans_on_other_threads_have_no_parent():
    done = []
    with spans.session() as ss:
        with spans.span("main"):
            t = threading.Thread(target=lambda: done.append(
                spans.span("other").__enter__().__exit__(None, None, None)))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and done
    got = {s.name: s for s in ss.snapshot()["spans"]}
    assert got["other"].parent == 0
    assert got["other"].thread != got["main"].thread
    assert ss.snapshot()["threads"][got["other"].thread] == t.name


def test_nothing_per_batch_outside_a_session(reads):
    """With neither a session nor a profiler a span is the shared no-op
    (false, no state), and a whole pass records only its set-up spans."""
    a, b = spans.span("x"), spans.span("y", 3)
    assert a is b and not a and spans.new_batch() is None
    since = spans.mark()
    db = _db()
    clf = pipeline.Classifier(db, ClassifyConfig(batch_reads=64),
                              device="cpu")
    clf.classify_file_to_csv(reads["r.fq"], reads["tmp"] / "o.csv")
    names = {s.name for s in spans.snapshot(since)["spans"]}
    assert not names & PER_BATCH
    assert {"build_table", "build_table.check", "build_table.insert",
            "build_table.verify", "classifier.place"} <= names


def test_build_table_spans_and_attempts_always_recorded():
    rng = np.random.default_rng(1)
    km = np.unique(rng.integers(0, 1 << 60, size=3000, dtype=np.uint64))
    lab = rng.integers(1, 4, size=len(km)).astype(np.uint32)
    names = ["NA", "a", "b", "c"]
    since = spans.mark()
    hashdb.build_table(km, lab, names, DBConfig(k=K))
    assert spans.snapshot()["counters"]["build_table.attempts"] == 1
    # 64 rows of 4 slots cannot hold 3,000 keys: the table doubles
    # until a placement holds them all, an insert pass an attempt
    db = hashdb.build_table(km, lab, names,
                            DBConfig(k=K, layout="s2", slots=4),
                            nb_bits=6)
    snap = spans.snapshot(since)
    n = snap["counters"]["build_table.attempts"]
    assert n >= 2 and db.nb_bits == 6 + n - 1
    tops = [s for s in snap["spans"] if s.name == "build_table"]
    assert len(tops) == 2 and tops[-1].attrs == {"keys": len(km),
                                                 "attempts": n}
    inserts = [s for s in snap["spans"] if s.name == "build_table.insert"
               and s.parent == tops[-1].id]
    assert [s.attrs["nb_bits"] for s in inserts] == list(range(6, 6 + n))
    kids = {s.name for s in snap["spans"] if s.parent == tops[-1].id}
    assert kids == {"build_table.check", "build_table.insert",
                    "build_table.verify"}


def test_build_table_attempts_on_a_failed_build():
    with pytest.raises(ValueError):
        hashdb.build_table(np.array([3, 3], np.uint64),
                           np.array([1, 1], np.uint32), ["NA", "a"],
                           DBConfig(k=K))
    assert spans.snapshot()["counters"]["build_table.attempts"] == 0


@pytest.mark.parametrize("paired", [False, True])
def test_one_batch_id_across_three_threads(reads, paired):
    """Every batch of a file→CSV pass carries one id from the producer
    (pack, put_wire) through the main thread (device_step, its step,
    readback_issue) to the writer (readback_wait, flush_write, rows)."""
    clf = pipeline.Classifier(_db(), ClassifyConfig(batch_reads=64),
                              device="cpu")
    a, b = ((reads["m1.fq"], reads["m2.fq"]) if paired
            else (reads["r.fq"], None))
    with spans.session() as ss:
        n = clf.classify_file_to_csv(a, reads["tmp"] / "o.csv", b)
    assert n == 300
    snap = ss.snapshot()
    by_batch = {}
    for s in snap["spans"]:
        if s.batch is not None:
            by_batch.setdefault(s.batch, []).append(s)
    assert len(by_batch) == 5   # 300 reads, 64 a batch
    roles = {"producer": {"pack", "put_wire"},
             "main": {"device_step", "step", "readback_issue"},
             "writer": {"readback_wait", "flush_write", "rows"}}
    for bid, rows in by_batch.items():
        names = {s.name for s in rows}
        assert names == set().union(*roles.values()), (bid, names)
        threads = {role: {s.thread for s in rows if s.name in want}
                   for role, want in roles.items()}
        assert all(len(t) == 1 for t in threads.values())
        assert len(set().union(*threads.values())) == 3
        step = next(s for s in rows if s.name == "step")
        dev = next(s for s in rows if s.name == "device_step")
        assert step.parent == dev.id
        assert step.attrs == {"rows": 64 if bid != max(by_batch) else 44,
                              "windows": step.attrs["windows"],
                              "wire_bytes": step.attrs["wire_bytes"],
                              "fused": 1}
    names = [s.name for s in snap["spans"] if s.batch is None]
    assert "read_scan" in names and ("mate_check" in names) == paired
    main = {s.thread for s in snap["spans"] if s.name == "read_scan"}
    assert snap["threads"][main.pop()] == "MainThread"


def test_inflate_span_carries_the_counters(reads):
    from cuclark_tpu_torch import native

    if not native.available():
        pytest.skip("needs the native host library (g++)")
    clf = pipeline.Classifier(_db(), ClassifyConfig(batch_reads=64),
                              device="cpu")
    clf.classify_file_to_csv(reads["r.fq"], reads["tmp"] / "p.csv")
    with spans.session() as ss:
        clf.classify_file_to_csv(reads["r.fq.gz"], reads["tmp"] / "g.csv")
    assert (reads["tmp"] / "g.csv").read_bytes() == (
        reads["tmp"] / "p.csv").read_bytes()
    (inf,) = [s for s in ss.snapshot()["spans"] if s.name == "inflate"]
    assert inf.attrs == native.inflate_counters()
    assert inf.attrs["members"] == 1
    scan = next(s for s in ss.snapshot()["spans"] if s.name == "read_scan")
    assert inf.parent == scan.id


def test_buffer_bound_and_dropped(monkeypatch):
    rec = spans.Recorder(capacity=5)
    monkeypatch.setattr(spans, "RECORDER", rec)
    with spans.session() as ss:
        for _ in range(8):
            with spans.span("x"):
                pass
        with spans.span("setup", always=True):
            pass
    snap = ss.snapshot()
    assert len(snap["spans"]) == 5 and snap["dropped"] == 4
    assert len(rec.snapshot()["spans"]) == 5
    rec.clear()
    assert rec.snapshot()["dropped"] == 0 and not rec.snapshot()["spans"]


def test_recorded_spans_leave_no_object_for_the_collector():
    """20,000 spans with attributes, recorded: the collector's count of
    objects allocated and not freed does not move, so recording does not
    bring its collections forward (nor is any span object left behind)."""
    import gc

    gc.collect()
    gc.disable()
    try:
        n0, c0 = len(gc.get_objects()), gc.get_count()[0]
        with spans.session() as ss:
            for i in range(20_000):
                with spans.span("x", batch=i + 1) as s:
                    s.attrs = {"rows": i, "fused": 1}
        n1, c1 = len(gc.get_objects()), gc.get_count()[0]
    finally:
        gc.enable()
    assert n1 - n0 < 100 and c1 - c0 < 100
    got = [s for s in ss.snapshot()["spans"] if s.name == "x"]
    assert len(got) == 20_000
    assert got[-1].attrs == {"rows": 19_999, "fused": 1}
    assert got[-1].batch == 20_000


def test_capacity_holds_a_traced_window_of_batches():
    # a traced 5 s window of the se150 cell: about 14,000 batches, each
    # a step and its launch (more with the file path's dozen stages)
    assert spans.CAPACITY >= 14_000 * 12


def test_counters():
    spans.count("t.counted")
    spans.count("t.counted", 4)
    spans.set_counter("t.set", 9)
    c = spans.snapshot()["counters"]
    assert c["t.counted"] >= 5 and c["t.set"] == 9
    assert "launches.query_score" in c


def test_span_lands_on_the_profiler_trace_clock(tmp_path):
    """A span around a torch op, in a CPU profiler session started with
    .start() (as the benchmark starts its own), encloses the op's event
    once mapped with spans.trace_us, and the exported trace's base is
    the recorder's."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    torch.mm(a, a)
    since = spans.mark()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with spans.span("around_mm") as s:
        time.sleep(0.0002)
        torch.mm(a, a)
        time.sleep(0.0002)
    prof.stop()
    assert s and not spans.span("after")
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert int(trace["baseTimeNanoseconds"]) == spans.BASE_NS
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"
             and e.get("ph") == "X"]
    (got,) = [r for r in spans.snapshot(since)["spans"]
              if r.name == "around_mm"]
    lo, hi = spans.trace_us(got.start_ns), spans.trace_us(got.end_ns)
    assert lo <= float(mm["ts"]) and float(mm["ts"]) + float(mm["dur"]) <= hi
    assert hi - lo < 1e5   # the same clock, not merely an enclosing one
    # chrome_events puts the span at the same place on that trace's base
    (e,) = spans.chrome_events([got], 1, int(trace["baseTimeNanoseconds"]))
    assert e["cat"] == "cuclark_span" and e["ts"] == pytest.approx(lo)


def test_thread_split_reads_the_spans(reads):
    """scripts/torch_thread_split.py: the split of a pass by thread from
    the spans, with its report's keys; no function of the package is
    wrapped."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_thread_split as ts
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    clf = pipeline.Classifier(_db(), ClassifyConfig(batch_reads=64),
                              device="cpu")
    before = (pipeline.Classifier._device_step, pipeline._readback)
    with ts.ThreadSplit() as split:
        assert (pipeline.Classifier._device_step,
                pipeline._readback) == before
        clf.classify_file_to_csv(reads["r.fq"], reads["tmp"] / "s.csv")
    rep = split.report(5)
    assert set(rep) == {"wall_s", "batches", "threads"}
    roles = {row["role"]: row for row in rep["threads"].values()}
    assert set(roles) == {"main", "producer", "writer"}
    for row in roles.values():
        assert set(row) == {"role", "stages", "waits", "busy_s", "wait_s",
                            "outside_s", "uncovered_s", "per_batch_ms"}
        total = (row["busy_s"] + row["wait_s"] + row["outside_s"]
                 + row["uncovered_s"])
        assert total == pytest.approx(rep["wall_s"])
        assert row["busy_s"] + row["wait_s"] <= rep["wall_s"]
    assert roles["main"]["stages"]["device_step"]["calls"] == 5
    assert roles["main"]["stages"]["read_scan"]["calls"] == 1
    assert roles["producer"]["stages"]["pack"]["calls"] == 5
    assert roles["writer"]["stages"]["rows"]["calls"] == 5
    assert roles["writer"]["waits"]["readback_wait"]["calls"] == 5
    assert "step" not in roles["main"]["stages"]
    assert ts.summary(rep).startswith("split of a ")
