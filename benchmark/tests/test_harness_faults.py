"""A whole run at a tiny size on the CPU (the look for a card skipped),
with the timed path broken underneath: the check has to say not
correct for each fault a cell can have.  A sound run is correct; so is
a tiny run on the card."""

import time

import pytest
import torch
from conftest import tiny, tiny_streamed

import harness

CELLS = ["full_se150", "light_pe2x150", "full_ont_long"]


def run(cell, wrap_step=None, trace=False, device="cpu", seed=2**31 + 99):
    return harness.run_cell(cell, seed, 1.0, trace, device,
                            time.perf_counter(), wrap_step=wrap_step,
                            log=lambda *a: None)


def half_left_out(step):
    """Results only for the first half of each batch's reads."""
    def broken(p2, vb):
        h = (p2.shape[0] + 1) // 2
        res = step(p2[:h], vb[:h])
        return torch.cat([res, torch.zeros((p2.shape[0] - h, 5),
                                           dtype=res.dtype)])
    return broken


def answer_altered(step):
    """One read's best target changed where the step produces it."""
    def broken(p2, vb):
        res = step(p2, vb).clone()
        res[res.shape[0] // 3, 1] += 1
        return res
    return broken


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(tiny(workload))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_fault_is_not_correct(workload, fault):
    r = run(tiny(workload), wrap_step=fault)
    assert not r["correct"], r["checks"]
    assert r["checks"]["mismatched_rows"]["value"] > 0


def test_results_never_copied_back_is_not_correct(monkeypatch):
    def no_copy(res, device):
        return torch.zeros(res.shape, dtype=res.dtype), None
    monkeypatch.setattr(harness, "readback", no_copy)
    r = run(tiny("full_se150"))
    assert not r["correct"], r["checks"]


def test_window_that_lands_nothing_is_not_correct(monkeypatch):
    monkeypatch.setattr(harness, "run_window",
                        lambda *a, **k: harness.Window())
    r = run(tiny("full_se150"))
    assert not r["correct"]
    assert r["checks"]["missing_batches"]["value"] > 0


def test_traced_run_reports_per_layer_metrics(monkeypatch):
    # trace the window's first tenth of a second, time the host after
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.1)
    r = run(tiny("full_se150"), trace=True)
    assert r["correct"]
    assert "host_us_per_batch" in r["metrics"]
    assert "reads_per_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_on_the_card(card, workload):
    r = run(tiny(workload), device=card)
    assert r["correct"], r["checks"]
    t = run(tiny(workload), device=card, trace=True)
    assert t["correct"] and t["device"]["busy_s"] > 0
    kernel = ("query_roofline_pct" if workload == "full_ont_long"
              else "fused_roofline_pct")
    assert 0 < t["metrics"][kernel]["value"] <= 100


@pytest.mark.cuda
def test_tiny_streamed_run_on_the_card(card, monkeypatch):
    """A tiny table streamed in 4 parts on the card is correct, and its
    trace holds a range_query_kernel event for each of a traced batch's
    first 3 parts and a range_query_score_kernel event for its last."""
    import _trace

    cell = tiny_streamed()
    r = run(cell, device=card)
    assert r["correct"], r["checks"]
    assert (r["device"]["stream_parts"], r["device"]["stream_group"]) == (4, 2)
    runs = []
    breakdown = harness.breakdown

    def spy(trace_run):
        runs.append(trace_run)
        return breakdown(trace_run)
    monkeypatch.setattr(harness, "breakdown", spy)
    t = run(cell, device=card, trace=True)
    assert t["correct"] and t["device"]["busy_s"] > 0
    (tr,) = runs
    assert tr.launches and tr.part_bytes == [r["device"]["part_bytes"]] * 4
    assert len(_trace.kernels(tr.events, "range_query_kernel")) == \
        3 * len(tr.launches)
    assert len(_trace.kernels(tr.events, "range_query_score_kernel")) == \
        len(tr.launches)
    assert all(len(tr.batches[b].bytes["range"]) == 3 for b in tr.launches)
