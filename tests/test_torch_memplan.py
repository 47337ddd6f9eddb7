"""Device-memory planning of the port (`cuclark_tpu_torch.memplan`)
against `cuclark_tpu.memplan` (tests/test_memplan.py): the budget from a
stubbed `torch.cuda.mem_get_info`, the planners on the same inputs, and
a table over the device budget streaming instead of raising."""

import numpy as np
import pytest
import torch

from cuclark_tpu import memplan as jmemplan
from cuclark_tpu_torch import codec, memplan, pipeline
from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
from cuclark_tpu_torch.hashdb import build_table
from cuclark_tpu_torch.memplan import (RESERVED_MB, device_memory_budget_mb,
                                       plan_db_axis, plan_stream_parts,
                                       resolve_table_budget_mb)


@pytest.fixture()
def fake_card(monkeypatch):
    """torch.cuda.mem_get_info stubbed: (free, total) bytes of the card,
    set through the returned dict; records the device asked about."""
    state = {"free": 2_000_000_000, "total": 80_000_000_000, "asked": []}

    def mem_get_info(device=None):
        state["asked"].append(device)
        return state["free"], state["total"]

    monkeypatch.delenv("CUCLARK_DEVICE_MB", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return state


def test_budget_from_mem_get_info(fake_card):
    got = device_memory_budget_mb("cuda:1")
    assert got == pytest.approx(2e9 / 1e6 - RESERVED_MB)
    assert fake_card["asked"] == [torch.device("cuda:1")]


def test_budget_floor(fake_card):
    fake_card["free"] = 100_000_000
    assert device_memory_budget_mb(torch.device("cuda")) == 64.0


def test_budget_cpu_is_unbounded(fake_card):
    assert device_memory_budget_mb("cpu") is None
    assert resolve_table_budget_mb(None, "cpu") is None
    assert fake_card["asked"] == []


def test_budget_env_override(fake_card, monkeypatch):
    monkeypatch.setenv("CUCLARK_DEVICE_MB", "321.5")
    assert device_memory_budget_mb("cuda") == 321.5
    assert device_memory_budget_mb("cpu") == 321.5
    assert fake_card["asked"] == []


def test_explicit_flag_wins(fake_card):
    assert resolve_table_budget_mb(123.0, "cuda") == 123.0
    assert resolve_table_budget_mb(None, "cuda") == pytest.approx(
        2e3 - RESERVED_MB)
    assert memplan.RESERVED_MB == jmemplan.RESERVED_MB


@pytest.mark.parametrize("table_bytes,budget_mb,num_db,nb", [
    (10 ** 9, 100.0, 1, 1 << 20),
    (10 ** 9, 100.0, 4, 1 << 20),
    (10 ** 9, None, 1, 1 << 20),
    (10 ** 6, 100.0, 1, 1 << 20),
    (10 ** 9, 0.001, 1, 1 << 10),
    (1_073_741_824, 283.2, 1, 1 << 25),
])
def test_plan_stream_parts_matches_jax(table_bytes, budget_mb, num_db, nb):
    got = plan_stream_parts(table_bytes, budget_mb, num_db, nb)
    assert got == jmemplan.plan_stream_parts(table_bytes, budget_mb, num_db,
                                             nb)
    assert got & (got - 1) == 0


def test_plan_stream_parts():
    # 1 GB table, 100 MB budget, no mesh: 16 parts of 64 MB fit
    assert plan_stream_parts(10 ** 9, 100.0, 1, 1 << 20) == 16
    # split 4 ways across a mesh first: 4 parts of 62.5 MB
    assert plan_stream_parts(10 ** 9, 100.0, 4, 1 << 20) == 4
    assert plan_stream_parts(10 ** 9, None, 1, 1 << 20) == 1
    assert plan_stream_parts(10 ** 6, 100.0, 1, 1 << 20) == 1


@pytest.mark.parametrize("table_bytes,budget_mb,devices", [
    (10 ** 9, 100.0, 8), (10 ** 9, 300.0, 8), (10 ** 9, None, 8),
    (10 ** 6, 100.0, 8), (10 ** 9, 100.0, 3)])
def test_plan_db_axis_matches_jax(table_bytes, budget_mb, devices):
    assert plan_db_axis(table_bytes, budget_mb, devices) == (
        jmemplan.plan_db_axis(table_bytes, budget_mb, devices))


def test_headline_plan_at_600_mb():
    """The 64M-k-mer headline table (2^25 main rows, 2^20 stash rows of
    32 B) under --max-table-mb 600: 566.4 MB after the stash needs 2
    parts, so the budget halves to 283.2 MB: 4 parts of 2^23 rows."""
    main_bytes, stash_bytes = (1 << 25) * 32, (1 << 20) * 32
    left = 600 - stash_bytes / 1e6
    assert plan_stream_parts(main_bytes, left, 1, 1 << 25) == 2
    assert plan_stream_parts(main_bytes, left / 2, 1, 1 << 25) == 4


@pytest.fixture()
def small_db():
    rng = np.random.default_rng(3)
    km = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=30_000, dtype=np.uint64), 31))
    labels = rng.integers(1, 17, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 17)]
    return build_table(km, labels, names, DBConfig(k=31))


def _reads(n=64):
    rng = np.random.default_rng(4)
    base = np.frombuffer(b"ACGT", np.uint8)
    return [(f"r{i}", base[rng.integers(0, 4, size=100)].tobytes())
            for i in range(n)]


def test_auto_budget_streams_oversized_table(monkeypatch, small_db):
    """A table larger than the device budget streams with NO
    --max-table-mb flag and classifies identically to resident mode."""
    resident = pipeline.Classifier(small_db, ClassifyConfig(batch_reads=32),
                                   device="cpu")
    assert resident.stream_parts == 1
    want = list(resident.classify_records(iter(_reads())))
    tiny = small_db.table.nbytes / 4 / 1e6
    monkeypatch.setattr(memplan, "device_memory_budget_mb",
                        lambda device: tiny)
    auto = pipeline.Classifier(small_db, ClassifyConfig(batch_reads=32),
                               device="cpu")
    assert auto.stream_parts >= 4 and auto.table_budget_mb == tiny
    assert list(auto.classify_records(iter(_reads()))) == want


def test_device_mb_env_streams_through_cli(monkeypatch, tmp_path, capsys,
                                           small_db):
    """CUCLARK_DEVICE_MB below the table's size: the CLI streams and says
    so on stderr (auto device budget), with the resident run's CSV."""
    from cuclark_tpu_torch import cli
    from cuclark_tpu_torch.config import DBConfig as Cfg
    from cuclark_tpu_torch.db_build.builder import db_name

    (tmp_path / "db").mkdir()
    small_db.save(tmp_path / "db" / db_name(Cfg(k=31), small_db.num_targets))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                          for n, s in _reads()))
    base = ["classify", "-D", str(tmp_path / "db"), "-O", str(fq),
            "--device", "cpu"]
    assert cli.main(base + ["-R", str(tmp_path / "res.csv")]) == 0
    assert "Streaming" not in capsys.readouterr().err
    monkeypatch.setenv("CUCLARK_DEVICE_MB",
                       str(small_db.table.nbytes / 4e6))
    assert cli.main(base + ["-R", str(tmp_path / "str.csv")]) == 0
    assert "bucket-range parts (auto device budget" in capsys.readouterr().err
    assert ((tmp_path / "str.csv").read_bytes()
            == (tmp_path / "res.csv").read_bytes())
