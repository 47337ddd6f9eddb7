"""BENCHMARK.json against the benchmark's contract, the files it names,
and the rule that no run loads JAX or the JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line_ok(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(r) for r in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])


def test_files_and_cells():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    for c in configs.values():
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith(tuple(
            p + "/" for p in BENCH["paths"]))
        cfg = json.loads(f.read_text())
        assert cfg["reduced"] == c["reduced"]
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for w in cells.values():
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for name in cells:
        cell = harness.load_cell(name)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    four = sum(w["chips"] == 4 for w in cells.values())
    assert four <= max(1, len(cells) // 4)


def test_file_names_under_paths():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("rel", ["reference/classify.py", "generator.py",
                                 "metrics/_bytes.py", "metrics/_trace.py"])
def test_yardstick_imports_nothing_of_the_program(rel):
    assert imports(harness.HERE / rel) <= {"__future__", "dataclasses",
                                           "math", "statistics", "numpy",
                                           "scipy",
                                           "torch", "re"}


def test_a_run_loads_no_jax():
    """A whole run at a tiny size, in a fresh process, leaves no module
    whose top-level name is jax, jaxlib, flax or cuclark_tpu."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(harness.HERE / 'tests')!r})\n"
        "from conftest import tiny\n"
        "import harness\n"
        "r = harness.run_cell(tiny('full_se150'), 7, 0.2, True, 'cpu',\n"
        "                     time.perf_counter(), log=lambda *a: None)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'cuclark_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuclark_tpu_torch_x", sys)
    assert "cuclark_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cuclark_tpu.codec", sys)
    assert harness.forbidden_modules() == ["cuclark_tpu"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files a run ends with an error and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
