"""A streamed table through the harness at a tiny size on the CPU: the
configuration's settings, the group window, the faults planted around
the group step, and the range launches' least bytes."""

import os
import time

import pytest
import torch
from conftest import tiny, tiny_streamed

import harness

SEED = 2**31 + 99


def run(cell, wrap_step=None, trace=False, seed=SEED, log=None):
    return harness.run_cell(cell, seed, 1.0, trace, "cpu",
                            time.perf_counter(), wrap_step=wrap_step,
                            log=log or (lambda *a: None))


def half_left_out(step_group):
    """Results only for the first half of each batch's reads."""
    def broken(wires):
        halves = [(p2.shape[0] + 1) // 2 for p2, _ in wires]
        outs = step_group([(p2[:h], vb[:h])
                           for (p2, vb), h in zip(wires, halves)])
        return [torch.cat([res, torch.zeros((p2.shape[0] - h, 5),
                                            dtype=res.dtype)])
                for res, (p2, _), h in zip(outs, wires, halves)]
    return broken


def answer_altered(step_group):
    """One read's best target changed in each batch where the group step
    produces it."""
    def broken(wires):
        outs = [res.clone() for res in step_group(wires)]
        for res in outs:
            res[res.shape[0] // 3, 1] += 1
        return outs
    return broken


def all_bytes(monkeypatch):
    """Every pool batch's bytes, counted as a traced run counts them, by
    run: [{batch index: bytes}]; and the runs' Classifiers' plans."""
    seen, plans = [], []
    count = harness.count_bytes

    def spy(pool, launched, reads, clf, k):
        count(pool, range(len(pool)), reads, clf, k)
        seen.append({bi: dict(b.bytes) for bi, b in enumerate(pool)})
        plans.append((clf.stream_parts, clf.spec.nb_bits,
                      clf.spec.stash_bits))
    monkeypatch.setattr(harness, "count_bytes", spy)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 30.0)
    return seen, plans


def test_sound_streamed_run_is_correct():
    lines = []
    r = run(tiny_streamed(), log=lines.append)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["metrics"]["reads_per_s"]["value"] > 0
    dev = r["device"]
    assert (dev["stream_parts"], dev["stream_group"]) == (4, 2)
    assert dev["part_bytes"] == (1 << 17) * 32 // 4
    assert dev["table_budget_mb"] == 7.3
    assert any(line.startswith("plan: stream_parts 4, stream_group 2")
               for line in lines)
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_fault_around_the_group_step_is_not_correct(fault):
    r = run(tiny_streamed(), wrap_step=fault)
    assert not r["correct"], r["checks"]
    assert r["checks"]["mismatched_rows"]["value"] > 0


def test_a_group_is_issued_before_the_one_ahead_is_waited_for(monkeypatch):
    """The window issues group g + 1, then waits for group g's results."""
    order = []
    issue = harness.issue_group

    class Landed:
        """A batch's copy back, landed; a wait for it is recorded."""

        def __init__(self, bi):
            self.bi = bi

        def query(self):
            return True

    def issue_spy(pool, idx, step_group, device):
        order.append(("issue", tuple(idx)))
        return [(bi, h, Landed(bi)) for bi, h, _ in
                issue(pool, idx, step_group, device)]

    def wait_spy(ev):
        if ev is not None:
            order.append(("wait", ev.bi))
    monkeypatch.setattr(harness, "issue_group", issue_spy)
    monkeypatch.setattr(harness, "wait", wait_spy)
    r = run(tiny_streamed())
    assert r["correct"], r["checks"]
    # the window's issues after the warm-up's 3 groups: (0, 1), (2, 3), ...
    issues = [i for i, (what, _) in enumerate(order) if what == "issue"]
    w0 = issues[3]
    assert order[w0] == ("issue", (0, 1))
    assert order[w0 + 1] == ("issue", (2, 3))
    assert order[w0 + 2:w0 + 4] == [("wait", 0), ("wait", 1)]


def test_stated_parts_must_match_the_plan():
    cell = tiny_streamed()
    cell.config["stream_parts"] = 2
    with pytest.raises(RuntimeError, match="streams in 4 part"):
        run(cell)
    cell = tiny("full_se150")
    cell.config = dict(cell.config, stream_parts=4)
    with pytest.raises(RuntimeError, match="streams in 1 part"):
        run(cell)
    cell = tiny_streamed()
    del cell.config["stream_parts"]
    with pytest.raises(RuntimeError, match="states 1"):
        run(cell)


def test_a_pool_smaller_than_a_group_raises():
    cell = tiny_streamed()
    cell.config["classify"] = dict(cell.config["classify"], stream_group=5)
    with pytest.raises(RuntimeError, match="fewer than a group of 5"):
        run(cell)


def test_classify_sets_only_the_cli_fields():
    cell = tiny_streamed()
    cell.config["classify"] = dict(cell.config["classify"], extended=True)
    with pytest.raises(ValueError, match="extended"):
        run(cell)


def test_device_mb_is_restored(monkeypatch):
    monkeypatch.setenv(harness.DEVICE_MB_ENV, "12345")
    seen = []
    cls = harness.Window

    def window_spy(*a, **k):
        seen.append(os.environ.get(harness.DEVICE_MB_ENV))
        return cls()
    monkeypatch.setattr(harness, "run_window_groups", window_spy)
    run(tiny_streamed())
    assert seen == ["64"]
    assert os.environ[harness.DEVICE_MB_ENV] == "12345"
    monkeypatch.delenv(harness.DEVICE_MB_ENV)
    run(tiny_streamed())
    assert harness.DEVICE_MB_ENV not in os.environ


def test_range_rows_sum_to_the_resident_rows(monkeypatch):
    """Each row a batch needs lies in one part: summed over the parts,
    the range launches' rows are the resident launch's."""
    seen, plans = all_bytes(monkeypatch)
    assert run(tiny("full_se150"), trace=True)["correct"]
    assert run(tiny_streamed(), trace=True)["correct"]
    resident, streamed = seen
    assert plans[1][0] == 4
    pool = harness.build_pool(
        harness.generator.make_reads(
            harness.generator.make_universe(tiny("full_se150").config, SEED,
                                            torch.device("cpu")),
            tiny("full_se150").config, tiny("full_se150").traffic, SEED),
        31, torch.device("cpu"))
    for bi, b in enumerate(pool):
        wire = b.count * (b.w2 + b.wv)
        out, acc = b.count * 5 * 4, b.count * b.P * 4
        rows = resident[bi]["fused"] - wire - out
        got = streamed[bi]
        assert len(got["range"]) == 3
        assert got["range"][0] > wire + acc
        ranged = (sum(got["range"]) + got["range_fused"] - 4 * wire
                  - 6 * acc - out)
        assert ranged == rows > 0


def test_part_rows_split_the_resident_rows():
    """part_rows puts every distinct row in the part whose range holds it,
    the stash as the program splits it over the parts."""
    import _bytes

    nb_bits, stash_bits, seed = 12, 10, 5
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(0, 1 << 62, (5000,), generator=g)
    main = torch.randint(-(1 << 31), 1 << 31, (1 << nb_bits, 8),
                         generator=g, dtype=torch.int64).to(torch.int32)
    m, s = _bytes.qs_rows(keys, main, nb_bits, stash_bits, seed)
    mh, sh = _bytes.qs_rows_host(keys, main, nb_bits, stash_bits, seed)
    assert torch.equal(m, mh) and torch.equal(s, sh) and s.numel() > 0
    for parts in (2, 4, 8):
        rows = _bytes.part_rows(m, s, nb_bits, stash_bits, parts)
        assert sum(r[0] for r in rows) == m.numel()
        assert sum(r[1] for r in rows) == s.numel()
        n, nb = 1 << stash_bits, (1 << nb_bits) // parts
        for p, (mp, sp) in enumerate(rows):
            assert mp == int(((m >= p * nb) & (m < (p + 1) * nb)).sum())
            assert sp == int(((s >= p * n // parts)
                              & (s < (p + 1) * n // parts)).sum())
    # more parts than stash rows: the whole stash on part 0
    rows = _bytes.part_rows(m, s[:1] % 2, nb_bits, 1, 4)
    assert [r[1] for r in rows] == [1, 0, 0, 0]


def test_range_bytes():
    import _bytes

    rows = [(10, 1), (20, 0), (30, 2), (40, 3)]
    assert _bytes.range_bytes(rows, 100, 1000) == {"range": [
        100 + 1000 + 32 * 11, 100 + 2000 + 32 * 20, 100 + 2000 + 32 * 32,
        100 + 2000 + 32 * 43]}
    assert _bytes.range_bytes(rows, 100, 1000, 50) == {
        "range": [100 + 1000 + 32 * 11, 100 + 2000 + 32 * 20,
                  100 + 2000 + 32 * 32],
        "range_fused": 100 + 1000 + 50 + 32 * 43}


# the parent harness's counts of the tiny cells at SEED (commit c61579e)
PARENT_BYTES = {
    "full_se150": {0: {"fused": 840384}, 1: {"fused": 833696},
                   2: {"fused": 837504}, 3: {"fused": 843200}},
    "full_ont_long": {
        0: {"fused": 4528}, 1: {"fused": 37616}, 2: {"fused": 16308},
        3: {"fused": 35780}, 4: {"fused": 7770}, 5: {"fused": 532600},
        6: {"score": 130272, "query": 845920}, 7: {"fused": 6280},
        8: {"score": 161840, "query": 1066080},
        9: {"score": 65436, "query": 233448}, 10: {"fused": 161008}},
}


@pytest.mark.parametrize("workload", sorted(PARENT_BYTES))
def test_resident_bytes_are_the_parents(monkeypatch, workload):
    seen, plans = all_bytes(monkeypatch)
    assert run(tiny(workload), trace=True)["correct"]
    assert plans == [(1, 17, 17)]
    assert seen == [PARENT_BYTES[workload]]
