#!/usr/bin/env python3
"""What the program's spans cost on this host, alone and in the
benchmark's window.

    python3 scripts/torch_span_cost.py [--pairs N] [--cell CELL]
        [--seed N] [--seconds S] [--reps N] [--out FILE]

1. Enter/exit pairs of `cuclark_tpu_torch.spans.span` timed in a loop
   (best of 5 rounds of N pairs, ns a pair): per-batch spans with
   recording off (the no-op), inside a `spans.session()`, inside a
   CUDA-only torch.profiler session (the benchmark's traced window), and
   a set-up span (`always=True`, recorded whatever the switch).
2. The benchmark's window (`benchmark/harness.py`'s set-up and
   `run_window`) on one cell, in one process, in windows of S seconds,
   each traced whole (CUDA-only, as the benchmark traces) and then
   untraced, under three variants in turns, REPS rounds:
     normal     the program as it is (`step` with its attributes and a
                `step.launch` a kernel call, recorded while traced);
     step_bare  only the `step` span, without its attributes;
     off        no per-batch span records (the profiler's switch hidden
                from `spans`: the parent's cost, one flag test a site).
   For each window: the host's issue time a batch (the harness's clock
   around upload, step and readback), the step's own host time a batch
   (a clock around `classify_step_packed`), the device's idle share
   (`device_idle_pct`'s arithmetic on the window's trace), the spans
   recorded and the collector's passes per generation (`gc.get_stats`;
   the set-up is frozen with `gc.freeze` as the harness freezes it).
   Medians over the rounds, by variant and traced or not.

Prints one JSON line (and writes it to --out).  Needs a card.
"""

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "benchmark", ROOT / "benchmark" / "metrics"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

VARIANTS = ("normal", "step_bare", "off")


def pair_ns(pairs: int, always: bool = False) -> float:
    from cuclark_tpu_torch import spans

    best = float("inf")
    for _ in range(5):
        spans.RECORDER.clear()
        t0 = time.perf_counter_ns()
        for _ in range(pairs):
            with spans.span("cost", always=always):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / pairs)
    spans.RECORDER.clear()
    return best


@contextlib.contextmanager
def variant(name: str):
    """The program's per-batch spans as the variant `name` has them."""
    from cuclark_tpu_torch import spans

    saved = spans._profiler, spans.span
    if name == "off":
        spans._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    elif name == "step_bare":
        class Bare(spans._Open):
            __slots__ = ()

            def __bool__(self):   # the step sets no attributes
                return False

        def span(n, batch=None, always=False):
            if n == "step":
                return Bare(spans.RECORDER, n, batch)
            return saved[1](n, batch, always) if always else spans._OFF

        spans.span = span
    try:
        yield
    finally:
        spans._profiler, spans.span = saved


def gc_passes() -> list[int]:
    return [g["collections"] for g in gc.get_stats()]


def window_ab(cell_name: str, seed: int, seconds: float, reps: int,
              device="cuda") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import _trace
    import generator
    import harness
    from cuclark_tpu_torch import spans
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.pipeline import Classifier, classify_step_packed

    device = torch.device(device)
    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    cell = harness.load_cell(cell_name)
    cfg, traffic = cell.config, cell.traffic
    k = cfg["k"]
    universe = generator.make_universe(cfg, seed, device)
    keys_d, labels_d = generator.make_db(universe, cfg)
    reads = generator.make_reads(universe, cfg, traffic, seed)
    del universe
    keys, labels = keys_d.cpu(), labels_d.cpu()
    del keys_d, labels_d
    torch.cuda.empty_cache()
    names = ["NA"] + [f"T{i}" for i in range(1, cfg["genomes"] + 1)]
    db = build_table(keys.numpy().view(np.uint64),
                     labels.numpy().view(np.uint32), names,
                     DBConfig(k=k, gap=cfg["gap"], layout=cfg["layout"],
                              target_load=cfg["target_load"]))
    clf = Classifier(db, ClassifyConfig(), device=device)
    table, stash, spec = clf.table, clf.stash, clf.spec
    step_ns = [0]

    def step(p2, vb):
        t0 = time.perf_counter_ns()
        res = classify_step_packed(table, p2, vb, k=k, spec=spec,
                                   stash=stash, with_labels=False)[0]
        step_ns[0] += time.perf_counter_ns() - t0
        return res

    pool = harness.build_pool(reads, k, device)
    harness.warm_up(pool, step, device)
    harness.TRACE_SECONDS = seconds + 60.0   # trace each traced window whole
    rows = []
    gc.collect()
    gc.freeze()
    for rep in range(reps):
        order = VARIANTS[rep % 3:] + VARIANTS[:rep % 3]
        for name in order:
            for traced in (True, False):
                spans.RECORDER.clear()
                step_ns[0] = 0
                g0 = gc_passes()
                prof = profile(activities=[act]) if traced else None
                with variant(name):
                    w = harness.run_window(pool, step, seconds, device, prof)
                g1 = gc_passes()   # before the snapshot allocates
                row = {"variant": name, "traced": traced, "round": rep,
                       "batches": w.issued,
                       "issue_us": w.issue_s / w.issued * 1e6,
                       "step_us": step_ns[0] / w.issued / 1e3,
                       "spans": len(spans.snapshot()["spans"]),
                       "gc_passes": [b - a for a, b in zip(g0, g1)]}
                if traced:
                    events = harness.read_trace(prof)
                    lo, hi = _trace.window_us(events)
                    row["idle_pct"] = 100.0 * (
                        1.0 - _trace.busy_us(events) / (hi - lo))
                rows.append(row)
    gc.unfreeze()
    spans.RECORDER.clear()
    summary = {}
    for name in VARIANTS:
        for traced in (True, False):
            mine = [r for r in rows
                    if r["variant"] == name and r["traced"] == traced]
            key = f"{name}.{'traced' if traced else 'untraced'}"
            summary[key] = {
                m: statistics.median(r[m] for r in mine)
                for m in ("issue_us", "step_us", "idle_pct", "spans")
                if m in mine[0]}
            summary[key]["gc_passes"] = [
                sum(r["gc_passes"][g] for r in mine) for g in range(3)]
    return {"cell": cell_name, "seed": seed, "seconds": seconds,
            "reps": reps, "summary": summary, "windows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--cell", default="full_se150")
    ap.add_argument("--seed", type=int, default=2_200_000_001)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuclark_tpu_torch import spans

    if not torch.cuda.is_available():
        print("torch_span_cost: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": smi, "pairs": args.pairs}
    out["pair_ns_off"] = pair_ns(args.pairs)
    with spans.session():
        out["pair_ns_session"] = pair_ns(args.pairs)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    out["pair_ns_profiler"] = pair_ns(args.pairs)
    prof.stop()
    out["pair_ns_setup"] = pair_ns(args.pairs, always=True)
    out["window"] = window_ab(args.cell, args.seed, args.seconds, args.reps)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
