"""Out-of-core DB build probe of cuclark_tpu_torch: the spill path at
representative scale.

Counterpart of `scripts/bench_build_scale.py`, through the port's
`cuclark_tpu_torch.db_build.builder.build_db`.  It generates synthetic
genomes totalling BUILD_BENCH_MB megabases (about one occurrence per
base at k=31), builds the database with a BUILD_BENCH_RAM_MB host budget
for raw occurrences (16 B each; a budget below total_bases * 16 forces
the DB build's disk-spill path), and reports wall time and peak RSS.
Adjacent genomes share a 5% splice, so the discriminative filter (and
the multi-label run sweep) does real work.  Host work only: no card.

Run from the repository root:

    BUILD_BENCH_MB=320 BUILD_BENCH_RAM_MB=4096 python3 scripts/torch_bench_build_scale.py

It prints one JSON line.  `bench_torch.py` runs it in a subprocess
(`run_subprocess`), so that the peak RSS is the build's alone.
"""

import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _reset_peak_rss() -> None:
    """Clear the process's RSS high-water mark (Linux): ru_maxrss is
    inherited across fork+exec, so a subprocess started by a parent
    that once held tens of GB would report the parent's peak."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        pass


def _peak_rss_gb() -> float:
    """Current peak RSS: VmHWM (which _reset_peak_rss clears), else
    ru_maxrss."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def run(total_mb: int, ram_mb: int, k: int = 31, targets: int = 16,
        workdir=None):
    """Build a DB of `targets` synthetic genomes of total_mb Mbases in
    all under a ram_mb occurrence budget; the same genomes (numpy seed
    0) and fields as `scripts/bench_build_scale.py`'s `run`."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.db_build.builder import build_db

    _reset_peak_rss()

    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)
    per = int(total_mb * 1e6 / targets)
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        file_labels = []
        prev = None
        gen_t0 = time.time()
        for t in range(targets):
            seq = base[rng.integers(0, 4, size=per)]
            if prev is not None:  # 5% splice shared with the neighbour
                seq[: per // 20] = prev[: per // 20]
            p = Path(td) / f"g{t}.fa"
            with open(p, "wb") as f:
                f.write(b">g%d\n" % t)
                f.write(seq.tobytes())
                f.write(b"\n")
            file_labels.append((str(p), f"T{t + 1}", None))
            prev = seq
        gen_s = time.time() - gen_t0

        cfg = DBConfig(k=k, build_ram_mb=ram_mb)
        t0 = time.time()
        db = build_db(file_labels, cfg)
        build_s = time.time() - t0
    rss_gb = _peak_rss_gb()
    occ = total_mb * 1e6 - targets * (k - 1)
    table_gb = db.table.nbytes / 1e9
    return {
        "occurrences_m": round(occ / 1e6, 1),
        "ram_budget_mb": ram_mb,
        "spilled": occ * 16 > ram_mb * 1e6,
        "build_s": round(build_s, 1),
        "occ_per_sec_m": round(occ / build_s / 1e6, 1),
        "peak_rss_gb": round(rss_gb, 2),
        # peak RSS against 2 x (occurrence budget + final table)
        "rss_target_gb": round(2 * (ram_mb / 1e3 + table_gb), 2),
        # a full-RefSeq projection: about 596M raw occurrences (the
        # reference's README.md:93-94 scale) at this run's rate
        "projected_refseq_s": round(596e6 * build_s / occ, 1),
        "db_kmers": int(db.num_kmers),
        "table_mb": round(db.table.nbytes / 1e6, 1),
        "gen_s": round(gen_s, 1),
    }


def run_subprocess(total_mb: int, ram_mb: int, timeout: float = 3600):
    """`run` in a fresh process, so that its peak RSS is the build's
    alone (a call inside bench_torch.py would report the whole bench's
    peak).  Returns its JSON line as a dict, or {"error": ...}."""
    import subprocess

    env = dict(os.environ)
    env["BUILD_BENCH_MB"] = str(total_mb)
    env["BUILD_BENCH_RAM_MB"] = str(ram_mb)
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve())],
        env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        return {"error": out.stderr[-500:]}
    return json.loads(out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    total_mb = int(os.environ.get("BUILD_BENCH_MB", 320))
    ram_mb = int(os.environ.get("BUILD_BENCH_RAM_MB", 4096))
    print(json.dumps(run(total_mb, ram_mb)), flush=True)
    sys.exit(0)
