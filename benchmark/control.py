"""The control of the check: the plain reference put in the program's
place with its keys compared on a fingerprint (`harness.control_bits`)
instead of all 2k bits, which the configurations state.  The check has
to find it not correct.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

makes each seed's inputs at the cell's own size, as a run does, and
prints one JSON line a seed with the numbers the check compares for the
control's results on the run's sampled batches.  It runs the reference
only, on the card where there is one, and imports nothing of the
program.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import harness
from harness import generator, reference


def control_readings(cell, seed: int, device) -> dict:
    cfg = cell.config
    k = cfg["k"]
    universe = generator.make_universe(cfg, seed, device)
    keys, labels = generator.make_db(universe, cfg)
    reads = generator.make_reads(universe, cfg, cell.traffic, seed)
    del universe
    bits = harness.control_bits(keys.numel())
    fingerprint = reference.KeySet(keys, labels, key_bits=bits)

    def got(bi):
        first, count, _ = reads.batches[bi]
        codes = reference.read_codes(reads.bufs, reads.starts, reads.ends,
                                     first, count, device)
        return reference.classify(codes, k, fingerprint).cpu()

    sample = harness.check_sample(reads, seed)
    checks = harness.check(reads, sample, got, keys, labels, k, device)
    rows = sum(reads.batches[bi][1] for bi in sample)
    return {"workload": cell.name, "seed": seed, "key_bits": bits,
            "rows_compared": rows, "correct": harness.passed(checks),
            **{n: v for n, (v, _) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
