"""Run one cell of the benchmark of cuclark_tpu_torch on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics with --trace 0, its per-layer metrics
from a torch.profiler trace with --trace 1), `device`, `breakdown`
(traced runs) and `checks`, the numbers the check compared with their
limits, which are also the last lines of standard error.  Exits 1
without a result where no card is visible or where the run loaded JAX
or the JAX package.  See harness.py for what a run does.
"""

import time

T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (0 where /proc says nothing)."""
    try:
        import os

        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START -= _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    cell = harness.load_cell(args.workload)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{visible} visible", file=sys.stderr)
        return 1
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: nothing it runs may "
              f"import JAX or the JAX package", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
