"""Spans and counters of the port's layers, on the torch.profiler trace's
clock.

A span is a named interval of one thread: its start and end
(`time.time_ns()`), the thread, the span open on that thread when it
began (its parent), a batch id that every span of one batch carries on
every thread (a span without one takes its parent's), and a few integer
attributes.  A counter is a named integer.  Both live in one bounded
in-memory recorder; once `CAPACITY` spans are held, further spans are
dropped and counted (`dropped`).  A recorded span is kept as words of
one list (integers, its name, one shared tuple for each set of attribute
keys), so recording leaves behind no object that the garbage collector
tracks: a container kept for each span would advance the collector's
generations, and a traced window would then take the full collection of
what torch.profiler's start allocated (one stall of 55-90 ms in a 5 s
window of `full_se150` on the card).

Per-batch spans (`span(name)`) are recorded only while a torch.profiler
session records (`torch.autograd.profiler._is_profiler_enabled`, which
the profiler sets whatever its activities) or a `session()` is open;
otherwise `span` returns a shared no-op, one flag test and no
allocation.  Set-up spans (`span(name, always=True)`: `build_table`,
`classifier.place`, `kernels.load`, `native.load`) are always recorded:
a handful a run.

The clock: a Chrome trace that torch.profiler exports gives each event's
`ts` in us after its `baseTimeNanoseconds`, and `ts` * 1000 + that base
is `time.time_ns()`; the base is the wall clock floored to Kineto's
7,889,238-second interval (`BASE_NS`).  `trace_us` maps a span's time
onto that `ts`, and `chrome_events` gives spans as trace events of
category `cuclark_span`.

Spans and the metrics that read them (PERF.md section 3):
  set-up   build_table (children build_table.check, build_table.insert
           a placement attempt, build_table.verify; counter
           build_table.attempts), classifier.place, kernels.load
           (child kernels.compile; counter kernels.builds), native.load
           (child native.compile; counter native.builds)
  device   step (pipeline.classify_step_packed / classify_step;
           attributes rows, windows, wire_bytes, fused), step.launch
           (each ctypes call into a kernel's C entry)
  file     read_scan, inflate, mate_check, pack, ring_acquire,
           put_wire, part_upload, device_step, readback_issue,
           readback_wait, rows, flush_write, and the waits
           prefetch_put_wait, prefetch_get_wait, writer_future_wait
`snapshot()` adds the kernels' launch counts (`kernels.LAUNCHES`) as
counters `launches.<entry>`.  The CLI's `classify --profile DIR` trace
holds the command's spans, set-up ones included, and the counters
(`cuclark_counters`).
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time

from torch.autograd import profiler as _profiler

# Spans held before further ones are dropped: a traced 5 s window of
# 14,000 batches with a few spans each fits many times over.
CAPACITY = 1 << 18

# Kineto's trace base interval (libkineto ChromeTraceBaseTime; torch's
# profiler/_chrome_trace_export.py _TRIMONTH_SECONDS).
TRACE_BASE_INTERVAL_S = 7889238
BASE_NS = (int(time.time()) // TRACE_BASE_INTERVAL_S
           * TRACE_BASE_INTERVAL_S * 1_000_000_000)

Span = collections.namedtuple(
    "Span", "id parent name start_ns end_ns thread batch attrs")


def trace_us(t_ns: int, base_ns: int = BASE_NS) -> float:
    """A span time (ns) as a torch.profiler Chrome trace's `ts` (us after
    the trace's `baseTimeNanoseconds`, BASE_NS unless given)."""
    return (t_ns - base_ns) / 1e3


class _Off(tuple):
    """The span handed out while nothing records: an empty tuple, so it
    holds nothing and tests false without a call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded; true, so a caller can test it before it
    computes attributes (`if s: s.attrs = {...}`)."""

    __slots__ = ("rec", "name", "batch", "attrs", "id", "parent", "start",
                 "thread")

    def __init__(self, rec, name, batch):
        self.rec = rec
        self.name = name
        self.batch = batch
        self.attrs = None

    def __enter__(self):
        rec = self.rec
        try:
            thread = rec._local.thread
        except AttributeError:
            thread = rec._new_thread()
        self.thread = thread
        stack = thread[0]
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.batch is None:
                self.batch = top.batch
        else:
            self.parent = 0
        self.id = next(rec._ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        stack, tid = self.thread
        stack.pop()
        rec = self.rec
        if next(rec._slots) >= rec.capacity:
            rec._drop()
            return False
        # id, parent, name, start, end, thread, batch, the attributes'
        # keys (one shared tuple for each set of keys), their values;
        # appended whole, so spans ending on other threads do not
        # interleave
        attrs = self.attrs
        if attrs:
            keys = tuple(attrs)
            rec._words.extend((self.id, self.parent, self.name, self.start,
                               end, tid, self.batch,
                               rec._keys.setdefault(keys, keys),
                               *attrs.values()))
        else:
            rec._words.extend((self.id, self.parent, self.name, self.start,
                               end, tid, self.batch, ()))
        return False


class Recorder:
    """The spans, counters and dropped count of the process."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.sessions = 0
        self._words = []
        self._slots = itertools.count()
        self._keys = {}
        self._counters = {}
        self._threads = {}
        self.dropped = 0
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _new_thread(self):
        """This thread's (stack of open spans, native id), made once."""
        tid = threading.get_native_id()
        self._local.thread = ([], tid)
        with self._lock:
            self._threads[tid] = threading.current_thread().name
        return self._local.thread

    def _drop(self) -> None:
        with self._lock:
            self.dropped += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_counter(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name] = int(value)

    def mark(self) -> int:
        """An id below every span begun from now on."""
        return next(self._ids)

    def snapshot(self, since: int = 0) -> dict:
        """The spans begun after `since` (a `mark()`), in the order they
        ended, the counters with the kernels' launch counts, the names of
        the threads by id, the dropped count and BASE_NS."""
        from cuclark_tpu_torch import kernels

        with self._lock:
            counters = dict(self._counters)
            threads = dict(self._threads)
            dropped = self.dropped
            words = list(self._words)
        counters.update((f"launches.{k}", v)
                        for k, v in kernels.LAUNCHES.items())
        spans = []
        i = 0
        while i < len(words):
            sid, parent, name, start, end, tid, batch, keys = words[i:i + 8]
            values = words[i + 8:i + 8 + len(keys)]
            i += 8 + len(keys)
            if sid > since:
                spans.append(Span(sid, parent, name, start, end, tid, batch,
                                  dict(zip(keys, values)) if keys else None))
        return {"spans": spans, "counters": counters, "threads": threads,
                "dropped": dropped, "base_ns": BASE_NS}

    def clear(self) -> None:
        """Forget every span, counter and dropped span."""
        with self._lock:
            self._words = []
            self._slots = itertools.count()
            self._counters = {}
            self.dropped = 0


RECORDER = Recorder()


def span(name: str, batch=None, always: bool = False):
    """A context manager that records the span `name` (with `batch`, else
    its parent's batch id) while a profiler or a session records, or
    with `always`; otherwise a shared no-op."""
    if always or RECORDER.sessions or _profiler._is_profiler_enabled:
        return _Open(RECORDER, name, batch)
    return _OFF


def new_batch():
    """A fresh batch id while recording, else None."""
    if RECORDER.sessions or _profiler._is_profiler_enabled:
        return next(RECORDER._batches)
    return None


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    RECORDER.count(name, n)


def set_counter(name: str, value: int) -> None:
    RECORDER.set_counter(name, value)


def snapshot(since: int = 0) -> dict:
    return RECORDER.snapshot(since)


def mark() -> int:
    return RECORDER.mark()


class Session:
    """Per-batch spans are recorded while a session is open; `snapshot()`
    gives what was recorded since it opened."""

    def __init__(self):
        self.rec = RECORDER
        self.since = None

    def __enter__(self):
        with self.rec._lock:
            self.rec.sessions += 1
        self.since = self.rec.mark()
        return self

    def __exit__(self, *exc):
        with self.rec._lock:
            self.rec.sessions -= 1
        return False

    def snapshot(self) -> dict:
        return self.rec.snapshot(self.since)


def session() -> Session:
    return Session()


def self_ns(spans, names=None) -> dict:
    """{span id: its duration less what its children cover} for the spans
    of `names` (every span when None).  A span's children are the spans
    whose parent it is; with `names`, those of `names` whose nearest
    enclosing span of `names` it is, so that a span of another name
    counts inside the span that holds it."""
    by_id = {s.id: s for s in spans}
    mine = [s for s in spans if names is None or s.name in names]
    kids = collections.defaultdict(list)
    for s in mine:
        p = s.parent
        while names is not None and p in by_id and by_id[p].name not in names:
            p = by_id[p].parent
        kids[p].append((s.start_ns, s.end_ns))
    out = {}
    for s in mine:
        covered = 0
        reach = s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def chrome_events(spans, pid, base_ns: int = BASE_NS) -> list[dict]:
    """Spans as complete events of category `cuclark_span` on the clock
    of a trace with base `base_ns`; args hold the span's id, parent,
    batch and attributes."""
    out = []
    for s in spans:
        args = {"id": s.id, "parent": s.parent}
        if s.batch is not None:
            args["batch"] = s.batch
        if s.attrs:
            args.update(s.attrs)
        out.append({"ph": "X", "cat": "cuclark_span", "name": s.name,
                    "pid": pid, "tid": s.thread,
                    "ts": trace_us(s.start_ns, base_ns),
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


def add_to_chrome_trace(path, spans, pid, counters=None) -> None:
    """Append spans to the Chrome trace at `path` as `cuclark_span`
    events on its own clock (its `baseTimeNanoseconds`, else BASE_NS),
    and `counters` (a snapshot's) as its `cuclark_counters` entry."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", BASE_NS))
    trace.setdefault("traceEvents", []).extend(
        chrome_events(spans, pid, base))
    if counters is not None:
        trace["cuclark_counters"] = dict(counters)
    with open(path, "w") as f:
        json.dump(trace, f)
