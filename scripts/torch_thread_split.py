"""Wall-clock timers on each thread of a `Classifier.classify_file_to_csv`
pass: where each of the main, producer and writer threads spends a pass.

The timers wrap the package's own functions for the length of a `with`
block and restore them after; the package holds no timer or switch of
its own.  Each wrapped call is timed exclusive of the wrapped calls
nested in it on the same thread (`CsvSink.flush` less the rows is
mostly `f.write`; `read_scan` less `mate_check` is the read and the
scans of the head; a gzip input's inflate, `_inflate`, is timed
apart inside it).  The rows are the row writer's results entries
(`format_results`, which compute gamma and confidence themselves), so
on classify's CSV path `gamma_confidence` reads 0; a tree whose
`CsvSink` still calls it (an earlier one) times it there.

    from torch_thread_split import ThreadSplit
    with ThreadSplit() as split:
        clf.classify_file_to_csv(fq, out_csv)
        torch.cuda.synchronize()
    report = split.report()

`report()` gives, per thread (keyed by its name, with its role: main,
producer, writer), the sum and count of each stage and wait, the time
before the thread's first timed call and after its last (`outside`),
and the wall time no timer covers (`uncovered`); for every thread
stages + waits + outside + uncovered == the pass's wall time.  The
writer's uncovered time is mostly its executor's wait for the next
batch to write.  The timers cost about a microsecond a call, a few dozen
calls a batch.  The sums are wall time: a stage's time includes its
thread's waits for the interpreter lock and for a core.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time

# (module path, owner attribute or None, function, stage, kind)
TIMED = (
    ("cuclark_tpu_torch.native", None, "pack_block2", "pack", "stage"),
    ("cuclark_tpu_torch.native", None, "pack_block2_paired", "pack",
     "stage"),
    ("cuclark_tpu_torch.pipeline", "Classifier", "_scan_for_classify",
     "read_scan", "stage"),
    ("cuclark_tpu_torch.io.fast_parse", None, "first_mate_mismatch",
     "mate_check", "stage"),
    ("cuclark_tpu_torch.pipeline", None, "_inflate", "inflate", "stage"),
    ("cuclark_tpu_torch.pipeline", "_WireRing", "acquire", "ring_acquire",
     "wait"),
    ("cuclark_tpu_torch.pipeline", "Classifier", "_put_wire", "put_wire",
     "stage"),
    ("cuclark_tpu_torch.pipeline", "Classifier", "_device_step",
     "device_step", "stage"),
    ("cuclark_tpu_torch.pipeline", None, "_readback", "readback_issue",
     "stage"),
    ("cuclark_tpu_torch.pipeline", None, "_host_numpy", "readback_wait",
     "wait"),
    ("cuclark_tpu_torch.score", None, "gamma_confidence",
     "gamma_confidence", "stage"),
    ("cuclark_tpu_torch.native", None, "format_rows", "rows", "stage"),
    ("cuclark_tpu_torch.native", None, "format_rows_ext", "rows", "stage"),
    ("cuclark_tpu_torch.native", None, "format_results", "rows", "stage"),
    ("cuclark_tpu_torch.native", None, "format_results_ext", "rows",
     "stage"),
    ("cuclark_tpu_torch.pipeline", "CsvSink", "flush", "flush_write",
     "stage"),
)


class _Clock:
    """Per-thread sums of exclusive time by (stage, kind)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.threads = {}  # name -> {"first", "last", "sums", "stack"}

    def _mine(self):
        name = threading.current_thread().name
        rec = self.threads.get(name)
        if rec is None:
            with self.lock:
                rec = self.threads.setdefault(name, {
                    "first": None, "last": None, "sums": {}, "stack": []})
        return rec

    def timed(self, fn, stage: str, kind: str):
        def wrapper(*args, **kwargs):
            rec = self._mine()
            t0 = time.perf_counter()
            if rec["first"] is None:
                rec["first"] = t0
            rec["stack"].append(0.0)  # time of the calls nested in this one
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                inner = rec["stack"].pop()
                if rec["stack"]:
                    rec["stack"][-1] += t1 - t0
                s = rec["sums"].setdefault((stage, kind), [0.0, 0])
                s[0] += t1 - t0 - inner
                s[1] += 1
                rec["last"] = t1
        wrapper.__wrapped__ = fn
        return wrapper


class ThreadSplit:
    """Install the timers for a `with` block; `report()` after it."""

    def __init__(self):
        self.clock = _Clock()
        self._undo = []
        self.t0 = self.t1 = None

    def _patch(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, new)

    def __enter__(self):
        import importlib

        clock = self.clock
        for mod_name, cls, fn, stage, kind in TIMED:
            owner = importlib.import_module(mod_name)
            if cls is not None:  # a tree without the class times the rest
                owner = getattr(owner, cls, None)
            if owner is not None and fn in owner.__dict__:
                self._patch(owner, fn, clock.timed(owner.__dict__[fn],
                                                   stage, kind))

        # the producer's waits on a full prefetch queue, the consumer's on
        # an empty one (`pipeline._prefetch` makes a queue.Queue a pass)
        class TimedQueue(queue.Queue):
            put = clock.timed(queue.Queue.put, "prefetch_put_wait", "wait")
            get = clock.timed(queue.Queue.get, "prefetch_get_wait", "wait")

        self._patch(queue, "Queue", TimedQueue)
        # the main thread's waits on the writer's futures
        self._patch(concurrent.futures.Future, "result", clock.timed(
            concurrent.futures.Future.result, "writer_future_wait", "wait"))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)
        return False

    def report(self, batches: int | None = None) -> dict:
        """The split of the block's wall time, per thread; with
        `batches`, each sum also per batch (ms)."""
        wall = self.t1 - self.t0
        out = {"wall_s": wall, "batches": batches, "threads": {}}
        for name, rec in self.clock.threads.items():
            sums = rec["sums"]
            stages = {s: {"s": v[0], "calls": v[1]}
                      for (s, k), v in sorted(sums.items()) if k == "stage"}
            waits = {s: {"s": v[0], "calls": v[1]}
                     for (s, k), v in sorted(sums.items()) if k == "wait"}
            busy = sum(v["s"] for v in stages.values())
            waiting = sum(v["s"] for v in waits.values())
            first = rec["first"] if rec["first"] is not None else self.t1
            last = rec["last"] if rec["last"] is not None else self.t1
            outside = max(first - self.t0, 0.0) + max(self.t1 - last, 0.0)
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
