#!/usr/bin/env python3
"""Trace of the sharded part step on a 2 x 2 mesh of one card's handles.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_mesh_trace.py

It builds chip_smoke.py's headline qs table (k=31, 64M 31-mers, 1.107
GB) and its 150 bp reads, puts the table on the card, and makes a 2 data
x 2 db mesh of four handles of `cuda:0` (`parallel.mesh`).  A streamed
batch there is 4 part steps of `mesh.build_sharded_probe_part` over the
table in 4 bucket-range parts (each db shard's stash split over the
parts, as `pipeline.Classifier` streams on a mesh), each part step 4
range launches of the query kernel (one per data block and db shard).
Two routes of a batch's last part are traced, 5 batches of 4 part steps
each (20 part steps a route), in one `torch.profiler` session:

  - range: every part accumulates, then the score kernel per block;
  - fused: the last part's column-0 launches are the fused range launch
    (`scored=True`), which adds the block's sum and scores.

For each route it prints the device's kernel time per part step (the
sum of its kernels' durations in the trace), the gaps between
consecutive kernels, the host's time per launch (`cudaLaunchKernel`
events and the interval between their starts) and the host's enqueue
time per part step, beside CUDA-event times of the same part steps
without the profiler.  A part step is paced by the host when its
enqueue time exceeds its kernels' time.  The card's name and power
limit, and one JSON object last (also written to `--out`), end the
output; the Chrome trace goes to `--trace`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PARTS = 4
BATCHES = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("--reads", type=int, default=65536)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "mesh_trace.json")
    ap.add_argument("--trace", type=Path,
                    default=ROOT / "build" / "mesh_trace.pt.trace.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from cuclark_tpu_torch import codec, kernels, score
    from cuclark_tpu_torch.hashdb import table_to_device
    from cuclark_tpu_torch.parallel import mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    kernels.load()
    genomes, dbs = cs.build_headline_db(args.genomes, None, layouts=("qs",))
    db = dbs["qs"]
    with tempfile.TemporaryDirectory(prefix="mesh_trace_") as td:
        codes, _ = cs.write_reads(genomes, args.reads, Path(td) / "r.fq")
    del genomes
    padded = np.full((args.reads, 152), codec.INVALID, np.uint8)
    padded[:, :cs.READ_LEN] = codes
    p2, vb = codec.pack_codes(padded)
    print(f"table and reads in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    m = mesh.make_mesh(2, 2, [dev] * 4)
    main_t, stash_t = table_to_device(db, dev)
    _, sstash = mesh.shard_db_table(db, m)
    wires = mesh.place_wire(m, p2, vb)
    rows = main_t.shape[0] // PARTS
    half = rows // 2
    parts = [[[main_t[p * rows + j * half:p * rows + (j + 1) * half]
               for j in range(2)]] * 2 for p in range(PARTS)]
    pstep = mesh.build_sharded_probe_part(m, k=db.k, spec=db.spec,
                                          nb_part=rows)

    def batch(route: str):
        acc = None
        for p in range(PARTS):
            last = p == PARTS - 1
            out = pstep(parts[p], wires, p * rows, stash=sstash, acc=acc,
                        scored=last and route == "fused",
                        split=(p, PARTS))
            if last and route == "fused":
                return out
            acc = out
        return [score.score_labels(a) for a in acc]

    want = torch.cat(batch("range"))
    if not torch.equal(torch.cat(batch("fused")), want):
        raise AssertionError("the fused last part != the range route")
    routes = ("range", "fused")
    launches = {}
    for route in routes:
        kernels.reset_launches()
        batch(route)
        torch.cuda.synchronize()
        launches[route] = {n: c for n, c in kernels.LAUNCHES.items() if c}

    def event_ms(route: str, reps: int = 10) -> float:
        batch(route)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            batch(route)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps / PARTS

    def enqueue_ms(route: str, reps: int = 10) -> float:
        """Host time to launch one batch's part steps (no wait), per
        part step."""
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t1 = time.perf_counter()
            batch(route)
            ts.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
        return statistics.median(ts) * 1e3 / PARTS

    untraced = {r: {"event_ms_per_part": [event_ms(r) for _ in range(3)],
                    "enqueue_ms_per_part": enqueue_ms(r)} for r in routes}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for route in routes:
            torch.cuda.synchronize()
            for _ in range(BATCHES):
                batch(route)
            torch.cuda.synchronize()
            time.sleep(0.05)
    args.trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(args.trace))
    events = [e for e in json.loads(args.trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kern = sorted((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") == "kernel")
    calls = sorted((float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("cat") == "cuda_runtime"
                   and e["name"] in ("cudaLaunchKernel", "cuLaunchKernel"))
    per_batch = {r: sum(launches[r].values()) for r in routes}
    if len(kern) != BATCHES * sum(per_batch.values()):
        raise AssertionError(f"{len(kern)} kernel events for "
                             f"{BATCHES} x {per_batch} launches")
    if len(calls) != len(kern):
        calls = []   # launch calls not one a kernel: no host intervals
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "reads": args.reads,
              "parts": PARTS, "batches": BATCHES, "mesh": "2 data x 2 db, "
              "four handles of cuda:0", "routes": {}}
    lo = 0
    for route in routes:
        n = BATCHES * per_batch[route]
        ev, lc = kern[lo:lo + n], calls[lo:lo + n]
        lo += n
        steps = np.array_split(np.arange(n), BATCHES)
        busy = [sum(ev[i][1] for i in s) / 1e3 / PARTS for s in steps]
        span = [(ev[s[-1]][0] + ev[s[-1]][1] - ev[s[0]][0]) / 1e3 / PARTS
                for s in steps]
        gaps = [(ev[i + 1][0] - ev[i][0] - ev[i][1]) / 1e3
                for s in steps for i in s[:-1]]
        launch_iv = [(lc[i + 1][0] - lc[i][0]) / 1e3
                     for s in steps for i in s[:-1]] if lc else []
        r = {"launches_per_batch": launches[route],
             "kernel_ms_per_part": busy,
             "device_span_ms_per_part": span,
             "gap_ms_median": statistics.median(gaps),
             "gap_ms_max": max(gaps),
             "host_launch_call_ms_median": statistics.median(
                 d / 1e3 for _, d in lc) if lc else None,
             "host_launch_interval_ms_median": statistics.median(
                 launch_iv) if launch_iv else None,
             **untraced[route]}
        r["host_paced"] = (r["enqueue_ms_per_part"]
                           > statistics.median(busy))
        result["routes"][route] = r
        print(f"{route}: launches a batch {launches[route]}; kernels "
              f"{statistics.median(busy):.4f} ms per part step (device span "
              f"{statistics.median(span):.4f}), gaps median "
              f"{r['gap_ms_median']:.4f} max {r['gap_ms_max']:.4f} ms; host "
              f"cudaLaunchKernel {r['host_launch_call_ms_median']} ms, one "
              f"every {r['host_launch_interval_ms_median']} ms, enqueue "
              f"{r['enqueue_ms_per_part']:.4f} ms per part step; CUDA events "
              f"untraced "
              f"{', '.join(f'{x:.4f}' for x in r['event_ms_per_part'])} ms "
              f"per part step; host-paced: {r['host_paced']}",
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps({r: {k: v for k, v in d.items()
                          if not isinstance(v, list)}
                      for r, d in result["routes"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
