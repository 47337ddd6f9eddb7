"""Where each thread of a `Classifier.classify_file_to_csv` pass spends
it (main, producer, writer), read from the program's own spans.

A `with ThreadSplit()` block opens a `cuclark_tpu_torch.spans.session()`,
so the pass records its file-path spans (`read_scan`, `inflate`,
`mate_check`, `pack`, `ring_acquire`, `put_wire`, `device_step`,
`readback_issue`, `readback_wait`, `rows`, `flush_write` and the waits
`prefetch_put_wait`, `prefetch_get_wait`, `writer_future_wait`), and
`report()` sums them by thread.  Each stage is timed exclusive of the
stages nested in it on the same thread (`flush_write` less the rows is
mostly `f.write`; `read_scan` less `mate_check` and `inflate` is the
read and the scans of the head); spans of other names (`step`,
`step.launch`, `part_upload`) count within the stage that holds them.

    from torch_thread_split import ThreadSplit
    with ThreadSplit() as split:
        clf.classify_file_to_csv(fq, out_csv)
        torch.cuda.synchronize()
    report = split.report()

`report()` gives, per thread (keyed by its name, with its role: main,
producer, writer), the sum and count of each stage and wait, the time
before the thread's first stage and after its last (`outside`), and the
wall time no stage covers (`uncovered`); for every thread stages +
waits + outside + uncovered == the pass's wall time.  The writer's
uncovered time is mostly its executor's wait for the next batch to
write.  A span costs about 2 us recorded on the H100's host, a dozen a batch
(PERF.md section 6).  The sums are wall time: a stage's time includes
its thread's waits for the interpreter lock and for a core.
"""

from __future__ import annotations

import collections
import time

from cuclark_tpu_torch import spans

STAGES = ("read_scan", "inflate", "mate_check", "pack", "put_wire",
          "device_step", "readback_issue", "rows", "flush_write")
WAITS = ("ring_acquire", "readback_wait", "prefetch_put_wait",
         "prefetch_get_wait", "writer_future_wait")


class ThreadSplit:
    """Record the program's spans for a `with` block; `report()` after
    it."""

    def __init__(self):
        self._session = spans.session()
        self.snap = None
        self.t0 = self.t1 = None

    def __enter__(self):
        self._session.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self._session.__exit__(*exc)
        self.snap = self._session.snapshot()
        return False

    def report(self, batches: int | None = None) -> dict:
        """The split of the block's wall time, per thread; with
        `batches`, each sum also per batch (ms)."""
        wall = (self.t1 - self.t0) / 1e9
        out = {"wall_s": wall, "batches": batches, "threads": {}}
        kind = dict.fromkeys(STAGES, "stage") | dict.fromkeys(WAITS, "wait")
        own = spans.self_ns(self.snap["spans"], kind)
        by_thread = collections.defaultdict(list)
        for s in self.snap["spans"]:
            if s.name in kind:
                by_thread[s.thread].append(s)
        names = self.snap["threads"]
        for tid, rows in by_thread.items():
            sums = {}
            for s in rows:
                v = sums.setdefault((s.name, kind[s.name]), [0.0, 0])
                v[0] += own[s.id] / 1e9
                v[1] += 1
            stages = {n: {"s": v[0], "calls": v[1]}
                      for (n, k), v in sorted(sums.items()) if k == "stage"}
            waits = {n: {"s": v[0], "calls": v[1]}
                     for (n, k), v in sorted(sums.items()) if k == "wait"}
            busy = sum(v["s"] for v in stages.values())
            waiting = sum(v["s"] for v in waits.values())
            first = min(s.start_ns for s in rows)
            last = max(s.end_ns for s in rows)
            outside = (max(first - self.t0, 0) + max(self.t1 - last, 0)) / 1e9
            name = names.get(tid, str(tid))
            row = {"role": _role(name, stages), "stages": stages,
                   "waits": waits, "busy_s": busy, "wait_s": waiting,
                   "outside_s": outside,
                   "uncovered_s": wall - busy - waiting - outside}
            if batches:
                row["per_batch_ms"] = {
                    "busy": busy / batches * 1e3,
                    "wait": waiting / batches * 1e3,
                    "uncovered": row["uncovered_s"] / batches * 1e3}
            out["threads"][name] = row
        return out


def _role(name: str, stages: dict) -> str:
    if name == "MainThread":
        return "main"
    if "pack" in stages:
        return "producer"
    if "flush_write" in stages or "rows" in stages:
        return "writer"
    return "other"


def summary(report: dict) -> str:
    """One line of the split: per thread its role, busy, wait and
    uncovered seconds and its three largest stages and waits."""
    parts = []
    for name, row in sorted(report["threads"].items(),
                            key=lambda kv: kv[1]["role"]):
        items = sorted(((v["s"], s) for s, v in
                        {**row["stages"], **row["waits"]}.items()),
                       reverse=True)[:4]
        parts.append(
            f"{row['role']} ({name}): busy {row['busy_s']:.4f} s, wait "
            f"{row['wait_s']:.4f}, outside {row['outside_s']:.4f}, "
            f"uncovered {row['uncovered_s']:.4f} ["
            + ", ".join(f"{s} {t:.4f}" for t, s in items) + "]")
    return (f"split of a {report['wall_s']:.4f} s pass"
            + (f" ({report['batches']} batches)" if report["batches"]
               else "") + ": " + "; ".join(parts))
