#!/usr/bin/env python3
"""Profiler sessions in one process: do kernel events survive a third?

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_profile_sessions.py [--genomes N] [--reads N]

In one process, on chip_smoke.py's headline qs table and reads: two
in-process `torch.profiler` sessions, each around a resident
`classify --device cuda` of the reads (as chip_smoke.py's layout phases
ran them); then the work of chip_smoke.py's phase `mesh` that touches
this process (a 2 data x 2 db mesh of four handles of the card:
`Classifier(mesh=...)` resident and with each device's shard streamed in
4 parts); then a third session, `classify --profile` through the CLI,
and a fourth in-process session around one more resident classify.
Each session's Chrome trace is read as chip_smoke.py's `profile` phase
reads it (`trace_kernels`), and its kernel events are held against the
launches `kernels.LAUNCHES` counted in it.  Prints a line per session,
the versions and the card, and one JSON object last (also written to
`--out`); exits 1 when a session's events differ from its launches.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("--reads", type=int, default=131072)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "profile_sessions.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_sessions: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cuclark_tpu_torch import kernels, pipeline
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.parallel import mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sessions = []

    def record(what, trace: Path, launches: dict) -> None:
        found, share, window_ms = cs.trace_kernels(trace)
        events = {n: len(evs) for n, evs in found.items()}
        want = {n: launches.get(n, 0) + launches.get(f"{n}_q4", 0)
                + launches.get(f"{n}_s2", 0) for n in found}
        sessions.append({"session": len(sessions) + 1, "what": what,
                         "launches": cs._launched(launches),
                         "kernel_events": events, "match": events == want,
                         "busy_share": share, "window_ms": window_ms})
        print(f"session {len(sessions)} ({what}): launches "
              f"{cs._launched(launches)}, kernel events {events}: "
              f"{'match' if events == want else 'DIFFER'}", flush=True)

    with tempfile.TemporaryDirectory(prefix="profile_sessions_") as td:
        tmp = Path(td)
        t0 = time.time()
        genomes, dbs = cs.build_headline_db(args.genomes, tmp,
                                            layouts=("qs",))
        db, dbdir = dbs["qs"], str(tmp / "db_qs")
        fq = tmp / "reads.fq"
        cs.write_reads(genomes, args.reads, fq)
        del genomes
        print(f"table and reads in {time.time() - t0:.1f} s", flush=True)
        classify = ["classify", "-D", dbdir, "-O", str(fq), "--device",
                    "cuda"]
        resident_csv = tmp / "resident.csv"
        cs.run_cli([*classify, "-R", str(resident_csv)], ("query_score",))

        def in_process(what, i):
            with torch.profiler.profile(activities=acts) as prof:
                _, launches = cs.run_cli([*classify, "-R",
                                          str(tmp / f"s{i}.csv")],
                                         ("query_score",))
            prof.export_chrome_trace(str(tmp / f"s{i}.json"))
            record(what, tmp / f"s{i}.json", launches)

        in_process("in-process session around a resident classify", 1)
        in_process("in-process session around a resident classify", 2)

        # phase mesh's work in this process: four handles of the card
        m = mesh.make_mesh(2, 2, [dev] * 4)
        for cfg in (None, ClassifyConfig(
                max_table_mb=cs.mesh_stream_budget_mb(db, 2, 4))):
            clf = pipeline.Classifier(db, cfg, mesh=m)
            clf.classify_file_to_csv(fq, tmp / "mesh.csv")
            torch.cuda.synchronize()
            clf.close()
            del clf
            if (tmp / "mesh.csv").read_bytes() != resident_csv.read_bytes():
                raise AssertionError("the mesh CSV differs from the "
                                     "resident one")
        torch.cuda.empty_cache()
        print("mesh: 2 x 2 of four handles, resident and streamed, CSVs == "
              "resident", flush=True)

        tdir = tmp / "trace"
        _, launches = cs.run_cli([*classify, "-R", str(tmp / "s3.csv"),
                                  "--profile", str(tdir)], ("query_score",))
        (trace,) = tdir.glob("*.pt.trace.json")
        record("classify --profile after the mesh", trace, launches)
        in_process("in-process session after that", 4)

    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "genomes": args.genomes,
              "reads": args.reads, "sessions": sessions,
              "all_match": all(s["match"] for s in sessions)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(json.dumps(result))
    return 0 if result["all_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
