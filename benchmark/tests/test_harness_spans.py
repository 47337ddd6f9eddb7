"""The readers of the program's spans and counters (`program_span`,
`program_counter`) on synthetic spans and trace events whose numbers are
worked out here by hand, silent on a program without a recorder, and
reported by a traced run."""

import sys
import time

import pytest
from conftest import tiny

import harness
from harness import TraceRun
from cuclark_tpu_torch import spans

NEW = ("step_host_us", "idle_in_program_pct", "build_table_s",
       "build_attempts")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def at(us: float) -> int:
    """A span time (ns) that lands on trace time `us`."""
    return spans.BASE_NS + int(us * 1000)


def sp(i, name, a_us, b_us, parent=0, thread=1):
    return spans.Span(i, parent, name, at(a_us), at(b_us), thread, None,
                      None)


def synthetic():
    """A 1000 us window, the device busy 100-300 and 500-600 (idle
    0-100, 300-500 and 600-1000: 700 us); steps 50-150 and 350-450 (a
    launch inside the second), a writer's span 700-800 on another
    thread, a step before the window; a build_table of 2.5 s and two
    attempts."""
    events = [
        ev("cudaLaunchKernel", "cuda_runtime", 0, 20),
        ev("void query_score_kernel<(Layout)0, 1>(...)", "kernel", 100, 200),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 500, 100),
        ev("cudaEventSynchronize", "cuda_runtime", 980, 20),
    ]
    snap = {"spans": [
        sp(1, "build_table", -5e6, -2.5e6),
        sp(2, "step", -500, -200),
        sp(3, "step", 50, 150),
        sp(4, "step", 350, 450),
        sp(5, "step.launch", 360, 400, parent=4),
        sp(6, "rows", 700, 800, thread=2),
    ], "counters": {"build_table.attempts": 2, "launches.query_score": 3},
        "threads": {1: "MainThread", 2: "writer"}, "dropped": 0,
        "base_ns": spans.BASE_NS}
    return TraceRun(events, (0.0, 1000.0), [], [], 35.0), snap


@pytest.fixture
def run(monkeypatch):
    run, snap = synthetic()
    monkeypatch.setattr(spans, "snapshot", lambda since=0: snap)
    return run


def test_step_host_us_is_the_mean_step_in_the_window(run):
    # 50-150 and 350-450; the step before the window is left out
    assert harness.reader("step_host_us")(run) == pytest.approx(100.0)


def test_idle_in_program_pct(run):
    # idle inside spans: 50-100, 350-450, 700-800 = 250 us of 700
    assert harness.reader("idle_in_program_pct")(run) == pytest.approx(
        100 * 250 / 700)


def test_idle_outside_every_span_reads_zero(run, monkeypatch):
    _, snap = synthetic()
    snap["spans"] = [sp(1, "step", 120, 280), sp(2, "step", 510, 590)]
    monkeypatch.setattr(spans, "snapshot", lambda since=0: snap)
    assert harness.reader("idle_in_program_pct")(run) == 0.0
    snap["spans"] = [sp(1, "step", -10, 1010)]
    assert harness.reader("idle_in_program_pct")(run) == pytest.approx(100)


def test_build_table_readers(run):
    assert harness.reader("build_table_s")(run) == pytest.approx(2.5)
    assert harness.reader("build_attempts")(run) == 2


def test_readers_with_nothing_to_read_are_silent(monkeypatch):
    run, snap = synthetic()
    snap["spans"], snap["counters"] = [], {}
    monkeypatch.setattr(spans, "snapshot", lambda since=0: snap)
    for name in ("step_host_us", "build_table_s", "build_attempts"):
        assert harness.reader(name)(run) is None
    run.window = (0.0, 0.0)
    assert harness.reader("idle_in_program_pct")(run) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_recorder_is_silent(monkeypatch, name):
    """On a program without `cuclark_tpu_torch.spans` (a tree from before
    it) each reader returns None and raises nothing."""
    run, _ = synthetic()
    monkeypatch.setitem(sys.modules, "cuclark_tpu_torch.spans", None)
    assert harness.reader(name)(run) is None


def test_traced_run_reports_the_program_metrics(monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.1)
    r = harness.run_cell(tiny("full_se150"), 2**31 + 7, 0.5, True, "cpu",
                         time.perf_counter(), log=lambda *a: None)
    assert r["correct"]
    m = r["metrics"]
    assert set(NEW) <= set(m)
    assert m["step_host_us"]["value"] > 0
    assert 0 <= m["idle_in_program_pct"]["value"] <= 100
    assert m["build_table_s"]["value"] > 0
    assert m["build_attempts"]["value"] >= 1
