"""The benchmark's own tests: CPU tests at tiny sizes, and a card test
(marker `cuda`) that skips without a card.  Run from the repository's
root: python -m pytest benchmark/tests -q"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def tiny(workload: str) -> "harness.Cell":
    """The cell `workload` of BENCHMARK.json cut to a size a test holds:
    a few small genomes and a pool of a few small batches."""
    import harness

    cell = harness.load_cell(workload)
    cfg = dict(cell.config, genome_bp=30000, foreign_strains=1,
               foreign_species=1)
    cfg["genomes"] = 40 if cfg["gap"] > 1 else 6
    tr = dict(cell.traffic)
    if tr["kind"] == "long":
        tr.update(reads=80, length={"mean": 900, "sd": 900, "min": 100,
                                     "max": 20000})
        cfg["genome_bp"] = 60000
    else:
        tr.update(batch_reads=256, pool_batches=4)
    cell.config, cell.traffic = cfg, tr
    return cell


def tiny_streamed(workload: str = "full_se150") -> "harness.Cell":
    """`tiny(workload)` with its 4.2 MB main rows streamed in 4 parts (a
    table budget of 7.3 MB, the 4.2 MB stash taken off it and the rest
    halved for the double buffers), in groups of 2 batches (a card budget
    of 64 MB leaves no room to grow the group), so that the CPU and a
    card plan alike."""
    cell = tiny(workload)
    cell.config = dict(cell.config, stream_parts=4, device_mb=64,
                       classify={"max_table_mb": 7.3, "stream_group": 2})
    return cell


@pytest.fixture
def card():
    """The first card; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
