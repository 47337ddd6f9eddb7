"""The per-layer readers on a synthetic Chrome trace, whose numbers are
worked out here by hand."""

import pytest
import torch

import harness
from harness import Batch, TraceRun


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    """A 1000 us window: two fused kernels (100 + 100 us), one query
    kernel (200 us) overlapping a copy, a score kernel (50 us), copies
    of 100 + 50 us, and the host's CUDA calls."""
    events = [
        ev("cudaMemcpyAsync", "cuda_runtime", 0, 30),
        ev("cudaLaunchKernel", "cuda_runtime", 280, 20),
        ev("cuLaunchKernel", "cuda_driver", 600, 10),
        ev("cudaEventSynchronize", "cuda_runtime", 700, 240),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 40, 100),
        ev("void query_score_kernel<(Layout)0, 1>(...)", "kernel", 140, 100),
        ev("void query_score_kernel<(Layout)0, 1>(...)", "kernel", 340, 100),
        ev("void query_kernel<(Layout)0>(...)", "kernel", 640, 200),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 800, 50),
        ev("void score_hist_kernel(...)", "kernel", 850, 50),
        ev("void range_query_kernel<(Layout)0, 4>(...)", "kernel", 950, 0),
    ]
    batches = [Batch(0, 10, None, 38, 19, 122, True,
                     {"fused": 335_000}),
               Batch(10, 4, None, 512, 256, 2018, False,
                     {"query": 670_000, "score": 33_500})]
    return TraceRun(events, (0.0, 1000.0), batches, [0, 0, 1], 35.0)


def test_device_idle_and_copies():
    run = synthetic()
    # busy: 40-240, 340-440, 640-900 (+ a 0 us kernel) = 560 us
    assert harness.reader("device_idle_pct")(run) == pytest.approx(44.0)
    # copies: 40-140 and 800-850 = 150 us
    assert harness.reader("copy_busy_pct")(run) == pytest.approx(15.0)


def test_host_us_per_batch():
    run = synthetic()
    assert harness.reader("host_us_per_batch")(run) == pytest.approx(35.0)
    run.issue_us = None
    assert harness.reader("host_us_per_batch")(run) is None


def test_rooflines():
    run = synthetic()
    # 2 x 335,000 B at 3.35 TB/s = 2 x 0.1 us ... over 200 us
    assert harness.reader("fused_roofline_pct")(run) == pytest.approx(
        100 * 0.2 / 200)
    assert harness.reader("query_roofline_pct")(run) == pytest.approx(
        100 * 0.2 / 200)
    assert harness.reader("score_roofline_pct")(run) == pytest.approx(
        100 * 0.01 / 50)


def test_a_reader_with_nothing_to_read_is_silent():
    run = synthetic()
    run.events = [e for e in run.events if "query" not in e["name"]]
    assert harness.reader("fused_roofline_pct")(run) is None
    assert harness.reader("query_roofline_pct")(run) is None
    run.launches = []
    assert harness.reader("score_roofline_pct")(run) is None


def test_lost_events_count_the_mean_launch():
    run = synthetic()
    run.launches = [0, 0, 0, 0, 1]   # 4 fused launches, 2 events traced
    assert harness.reader("fused_roofline_pct")(run) == pytest.approx(
        100 * 0.2 / 200)


def test_breakdown():
    out = harness.breakdown(synthetic())
    ops = dict(out["device_ops"])
    assert ops["void query_kernel<(Layout)0>(...)"] == pytest.approx(2e-4)
    assert len(out["device_ops"]) <= 10
    # idle gaps: 440-640, 240-340, 900-950 and 950-1000 (the 0 us
    # kernel splits them), 0-40
    assert out["idle_gaps"] == [
        ["host outside CUDA calls", pytest.approx(2e-4)],
        ["host in cudaLaunchKernel", pytest.approx(1e-4)],
        ["host outside CUDA calls", pytest.approx(5e-5)],
        ["host in cudaEventSynchronize", pytest.approx(5e-5)],
        ["host in cudaMemcpyAsync", pytest.approx(4e-5)]]


def test_qs_rows_reads_the_stash_behind_a_full_miss():
    """A key whose main row holds it reads no stash row; a key whose full
    main row misses reads its stash row; a half-empty row reads none."""
    import _bytes

    nb_bits, stash_bits, seed = 17, 17, 0
    keys = torch.tensor([123456789, 987654321, 555555555], dtype=torch.int64)
    h1, l2 = _bytes.feistel_mix(keys >> 32, keys & 0xFFFFFFFF, seed)
    b0 = (l2 & ((1 << nb_bits) - 1)).tolist()
    main = torch.zeros((1 << nb_bits, 8), dtype=torch.int32)
    # key 0 stored in its main row (slot 0, choice 0, label 7), row full
    meta0 = ((int(l2[0]) >> nb_bits) << 17) | 7
    main[b0[0]] = torch.tensor([int(h1[0]), 1, 2, 3, meta0, 1, 1, 1],
                               dtype=torch.int64).to(torch.int32)
    # key 1's main row full of others; key 2's row empty
    main[b0[1]] = torch.tensor([9, 9, 9, 9, 1, 1, 1, 1], dtype=torch.int32)
    m, s = _bytes.qs_rows(keys, main, nb_bits, stash_bits, seed)
    assert sorted(m.tolist()) == sorted(set(b0))
    assert s.tolist() == [int(h1[1]) & ((1 << stash_bits) - 1)]
