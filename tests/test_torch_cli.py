"""The port's CLI (`cuclark-tpu-torch`) on the CPU: what `classify
--profile DIR` writes besides torch.profiler's own events.  Imports no
JAX."""

import json
import random

import pytest

from cuclark_tpu_torch.cli import main


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """Two random 2 kb genomes, their targets file, and 30 reads of
    100 bp drawn from them."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = random.Random(22)
    genomes = {}
    lines = []
    for t in (1, 2):
        g = "".join(rng.choice("ACGT") for _ in range(2000))
        genomes[t] = g
        p = tmp / f"g{t}.fa"
        p.write_text(f">g{t}\n{g}\n")
        lines.append(f"{p} S{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    reads = []
    for i in range(30):
        t = rng.randrange(1, 3)
        pos = rng.randrange(0, 1900)
        reads.append((f"r{i}_t{t}", genomes[t][pos: pos + 100]))
    (tmp / "reads.fq").write_text("".join(
        f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads))
    return tmp


def test_profile_trace_holds_the_program_spans_and_counters(demo):
    """classify --profile DIR (the database built first from -T): the
    Chrome trace holds the command's set-up spans and the profiled loop's
    spans as `cuclark_span` events on the trace's own clock, each batch's
    step around its torch ops, and the process's counters."""
    tmp = demo
    assert main(["classify", "-D", str(tmp / "tdb"), "-T",
                 str(tmp / "targets.txt"), "-k", "21", "-O",
                 str(tmp / "reads.fq"), "-R", str(tmp / "t.csv"),
                 "--device", "cpu", "-b", "8",
                 "--profile", str(tmp / "trace")]) == 0
    (path,) = (tmp / "trace").glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    ours = [e for e in events if e.get("cat") == "cuclark_span"]
    names = [e["name"] for e in ours]
    for name in ("build_table", "build_table.check", "build_table.insert",
                 "build_table.verify", "classifier.place", "read_scan"):
        assert name in names, name
    assert names.count("step") == names.count("device_step") == 4
    place = next(e for e in ours if e["name"] == "classifier.place")
    first_step = min(e["ts"] for e in ours if e["name"] == "step")
    assert place["ts"] + place["dur"] <= first_step
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::")]
    for e in ours:
        assert e["ph"] == "X" and e["dur"] >= 0 and "id" in e["args"]
        if e["name"] == "step":
            # the step's own torch ops (the plain probe) lie inside it
            assert any(e["ts"] <= a and b <= e["ts"] + e["dur"]
                       for a, b in ops)
            assert set(e["args"]) >= {"batch", "rows", "windows",
                                      "wire_bytes", "fused"}
    counters = trace["cuclark_counters"]
    assert counters["build_table.attempts"] >= 1
    assert "launches.query" in counters and "launches.score" in counters
