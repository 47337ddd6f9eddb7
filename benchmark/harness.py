"""One run of a benchmark cell: set-up, the measured window, the check.

A cell is a configuration (`configs/<name>.json`: the genomes, the
database rule, the table) under a traffic mix (`traffic/<name>.json`:
the reads and how they are batched), both named in BENCHMARK.json.  A
per-layer metric is a reader `metrics/<name>.py` with `read(run)`.
Nothing here names a cell, so a new cell, mix or metric is new files
and new entries.

The window drives the port's device path the way a caller with work
queued ahead does: batches packed ahead into pinned host memory by the
port's own packer (`io.fast_parse`), each copied to the card, stepped
by `pipeline.classify_step_packed` on the table and stash that
`pipeline.Classifier` placed, and its [R, 5] results copied back, the
copies issued as `Classifier._put_wire` and `_readback` issue them
(non-blocking, on the current stream), with `IN_FLIGHT` batches in
flight as `Classifier.classify_file` keeps them.

A configuration may state the settings of a streamed table (the
`classify` fields `max_table_mb` and `stream_group`, the card budget
`device_mb` that memplan reads, and the plan `stream_parts` it stands
for).  Where the table streams in parts, the window steps groups of
`Classifier.stream_group_eff` batches through the program's group step
(`Classifier._stream_group_dev`: every part uploaded once a group and
probed by every batch of it), each group issued before the one ahead of
it is waited for.

The check compares, once the window has closed and the program's state
is freed, the results that landed last in the window for a sample of
the pool's batches drawn from the seed (the batch of the longest reads
among them) with the plain reference (`reference/classify.py`) worked
out from the reads' bases and the (k-mer, label) set.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (HERE, HERE / "metrics", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import generator  # noqa: E402
from reference import classify as reference  # noqa: E402

# top-level module names that no run may load: JAX, and the JAX package
# the port was made from (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "cuclark_tpu")
# batches in flight, as Classifier.classify_file keeps them
IN_FLIGHT = 3
# share of the pool's batches the check compares
CHECK_SHARE = 0.25
# seconds at the start of a traced run's window that the profiler traces
TRACE_SECONDS = 5.0
# trace categories of the host's CUDA calls, which name an idle gap
HOST_CALLS = ("cuda_runtime", "cuda_driver")
# the ClassifyConfig fields a configuration's "classify" may set: those
# the CLI's --max-table-mb and --stream-group set
CLASSIFY_KEYS = ("max_table_mb", "stream_group")
# the program's stand-in for the card's free memory
# (memplan.device_memory_budget_mb), set from a configuration's device_mb
DEVICE_MB_ENV = "CUCLARK_DEVICE_MB"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its configuration and
    traffic files, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved
                              else [])]
    return Cell(name, w["chips"], load_json(root / cfg_entry["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"), e2e,
                layer)


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------- the pool of packed batches ----------


@dataclasses.dataclass
class Batch:
    first: int          # first read of the pool
    count: int          # reads (pairs) in the batch
    buf: torch.Tensor   # packed2 then vbits, flat uint8 (pinned on a card)
    w2: int
    wv: int
    P: int              # windows a row
    fused: bool         # the step ends in the fused query and score
    bytes: dict = dataclasses.field(default_factory=dict)


def build_pool(reads: generator.ReadSet, k: int, device) -> list[Batch]:
    """Pack every batch of the pool with the port's packer into host
    buffers (pinned on a card), packed2 and vbits back to back."""
    from cuclark_tpu_torch import probe
    from cuclark_tpu_torch.io import fast_parse

    pin = device.type == "cuda"
    pool = []
    for first, cnt, L in reads.batches:
        Lp = -(-L // 8) * 8
        w2, wv = Lp // 4, Lp // 8
        buf = torch.empty(cnt * (w2 + wv), dtype=torch.uint8, pin_memory=pin)
        flat = buf.numpy()
        out = (flat[:cnt * w2].reshape(cnt, w2),
               flat[cnt * w2:].reshape(cnt, wv), np.empty(cnt, np.int64))
        sl = slice(first, first + cnt)
        if reads.paired:
            fast_parse.pack_block2_paired_dispatch(
                reads.bufs[0], reads.starts[0][sl], reads.ends[0][sl],
                reads.bufs[1], reads.starts[1][sl], reads.ends[1][sl], L,
                n_rows=cnt, out=out)
        else:
            fast_parse.pack_block2_dispatch(
                reads.bufs[0], reads.starts[0][sl], reads.ends[0][sl], L,
                n_rows=cnt, out=out)
        fused = probe.fuses_score(torch.from_numpy(out[0][:1]), k)
        pool.append(Batch(first, cnt, buf, w2, wv, 4 * w2 - k + 1, fused))
    return pool


def upload(b: Batch, device):
    """(packed2, vbits) of a batch on the device: one non-blocking copy
    of its pinned buffer (`_WireRing.upload`)."""
    dev = b.buf if device.type == "cpu" else b.buf.to(device,
                                                       non_blocking=True)
    n2 = b.count * b.w2
    return dev[:n2].view(b.count, b.w2), dev[n2:].view(b.count, b.wv)


def readback(res: torch.Tensor, device):
    """(host results, event) once the copy back is started
    (`pipeline._to_host_async`)."""
    if device.type == "cpu":
        return res.clone(), None
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return host, ev


def wait(ev) -> None:
    if ev is not None:
        ev.synchronize()


# ---------- the window ----------


@dataclasses.dataclass
class Window:
    landed: int = 0        # reads whose results landed inside the window
    issued: int = 0        # batches issued
    issue_s: float = 0.0   # host time issuing copies and launches
    untraced: int = 0      # batches issued once the profiler stopped
    untraced_issue_s: float = 0.0   # their host time issuing
    attempted: int = 0     # reads of the batches issued in the window
    launches: list = dataclasses.field(default_factory=list)
    last: dict = dataclasses.field(default_factory=dict)


def run_window(pool, step, seconds: float, device, prof=None) -> Window:
    """Issue the pool's batches in order, cycling, for `seconds`; count
    the reads whose results landed on the host before the close; then
    wait for those still in flight (they count as issued, not landed).
    With a profiler `prof`, trace the first TRACE_SECONDS: the batches
    issued then (`launches`) and, after a wait for the device, every
    event they caused; the host's issue time of the later batches is
    kept apart (`untraced_issue_s`)."""
    w = Window()
    inflight = collections.deque()
    clock = time.perf_counter
    traced = prof is not None
    if traced:
        prof.start()
    t0 = clock()
    close = t0 + seconds
    i = 0
    while clock() < close:
        if traced and clock() >= t0 + TRACE_SECONDS:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.stop()
            traced = False
        bi = i % len(pool)
        i += 1
        b = pool[bi]
        t_issue = clock()
        p2, vb = upload(b, device)
        res = step(p2, vb)
        host, ev = readback(res, device)
        dt = clock() - t_issue
        w.issue_s += dt
        w.issued += 1
        inflight.append((bi, host, ev))
        if traced:
            w.launches.append(bi)
        else:
            w.untraced += 1
            w.untraced_issue_s += dt
        w.attempted += b.count
        if len(inflight) > IN_FLIGHT:
            bj, h, e = inflight.popleft()
            wait(e)
            if clock() <= close:
                w.landed += pool[bj].count
            w.last[bj] = h
    for bj, h, e in inflight:
        if e is None or e.query():
            w.landed += pool[bj].count
    for bj, h, e in inflight:
        wait(e)
        w.last[bj] = h
    if traced:
        prof.stop()
    return w


def warm_up(pool, step, device) -> None:
    """One pass over the pool and IN_FLIGHT + 1 batches more, holding
    the results as the window does (the last of each batch, IN_FLIGHT in
    flight): every shape, the kernels' build and the allocators' blocks,
    the pinned host blocks of the results included, outside the window."""
    inflight = collections.deque()
    last = {}
    for i in range(len(pool) + IN_FLIGHT + 1):
        bi = i % len(pool)
        host, ev = readback(step(*upload(pool[bi], device)), device)
        inflight.append((bi, host, ev))
        if len(inflight) > IN_FLIGHT:
            bj, h, e = inflight.popleft()
            wait(e)
            last[bj] = h
    for _, _, e in inflight:
        wait(e)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def issue_group(pool, idx, step_group, device) -> list:
    """[(batch index, host results, event)] of the batches `idx`: each
    uploaded, the group stepped once, each batch's results copied back."""
    outs = step_group([upload(pool[bi], device) for bi in idx])
    return [(bi, *readback(res, device)) for bi, res in zip(idx, outs)]


def group_indices(start: int, size: int, n: int) -> list[int]:
    """The pool's next `size` batches from `start`, taken cyclically."""
    return [(start + j) % n for j in range(size)]


def run_window_groups(pool, step_group, size: int, seconds: float, device,
                      prof=None) -> Window:
    """`run_window` for a streamed table: issue groups of `size` batches
    for `seconds`, each group before the one ahead of it is waited for,
    and count by batch as `run_window` does."""
    w = Window()
    inflight = collections.deque()
    clock = time.perf_counter
    traced = prof is not None
    if traced:
        prof.start()
    t0 = clock()
    close = t0 + seconds
    i = 0
    while clock() < close:
        if traced and clock() >= t0 + TRACE_SECONDS:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.stop()
            traced = False
        idx = group_indices(i, size, len(pool))
        i += size
        t_issue = clock()
        held = issue_group(pool, idx, step_group, device)
        dt = clock() - t_issue
        w.issue_s += dt
        w.issued += size
        inflight.append(held)
        if traced:
            w.launches.extend(idx)
        else:
            w.untraced += size
            w.untraced_issue_s += dt
        w.attempted += sum(pool[bi].count for bi in idx)
        if len(inflight) > 1:
            for bj, h, e in inflight.popleft():
                wait(e)
                if clock() <= close:
                    w.landed += pool[bj].count
                w.last[bj] = h
    for held in inflight:
        for bj, h, e in held:
            if e is None or e.query():
                w.landed += pool[bj].count
    for held in inflight:
        for bj, h, e in held:
            wait(e)
            w.last[bj] = h
    if traced:
        prof.stop()
    return w


def warm_up_groups(pool, step_group, size: int, device) -> None:
    """`warm_up` for a streamed table: one pass of groups over the pool
    and one group more, a group in flight behind the one issued, as the
    window holds them."""
    inflight = collections.deque()
    last = {}
    for g in range(-(-len(pool) // size) + 1):
        inflight.append(issue_group(pool, group_indices(g * size, size,
                                                        len(pool)),
                                    step_group, device))
        if len(inflight) > 1:
            for bj, h, e in inflight.popleft():
                wait(e)
                last[bj] = h
    for held in inflight:
        for _, _, e in held:
            wait(e)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------- the check ----------


def control_bits(n_keys: int) -> int:
    """The key bits the control compares: 12 bits past those that index
    a table of n_keys buckets, a fingerprint where the configurations
    state an exact 2k-bit match."""
    return max(1, n_keys - 1).bit_length() + 12


def check_sample(reads, seed: int) -> list[int]:
    """The pool batches the check compares: a share drawn from the seed,
    with the batch of the longest reads among them."""
    longest = max(range(len(reads.batches)), key=lambda i: reads.batches[i][2])
    return generator.sample_batches(len(reads.batches), CHECK_SHARE, seed,
                                    must=(longest,))


def check(reads, sample, got, keys, labels, k: int, device) -> dict:
    """{number: (value, limit)}: the result rows of the sampled batches
    (`got(batch index)`, None where the batch never landed) that differ
    from the reference's, and the sampled batches that never landed."""
    keyset = reference.KeySet(keys.to(device), labels.to(device))
    bad = missing = 0
    for bi in sample:
        res = got(bi)
        if res is None:
            missing += 1
            continue
        first, count, _ = reads.batches[bi]
        codes = reference.read_codes(reads.bufs, reads.starts, reads.ends,
                                     first, count, device)
        want = reference.classify(codes, k, keyset).cpu()
        bad += int((torch.as_tensor(res)[:count].cpu().to(torch.int32)
                    != want).any(1).sum())
    return {"mismatched_rows": (bad, 0), "missing_batches": (missing, 0)}


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


# ---------- the trace ----------


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader reads: the trace's complete events, the
    traced window (us), the pool's batches, the launches in order, and
    the host's mean time (us) to issue a batch once the profiler had
    stopped (None where the window issued none then)."""

    events: list
    window: tuple
    batches: list
    launches: list
    issue_us: float | None = None
    # a streamed table's part uploads: the bytes of each, in part order
    # (every group uploads every part once); empty for a resident table
    part_bytes: list = dataclasses.field(default_factory=list)


def count_bytes(pool, launched, reads, clf, k: int) -> None:
    """Each launched batch's least bytes by kernel kind (`metrics/_bytes`),
    counted on its reads against the program's table rows (qs only: the
    query readers are silent on another layout).  A streamed table's
    batch counts its range launches part by part against the host's
    main rows and the stash: "range", a list in part order, and, where
    its last part is fused with the score, "range_fused"."""
    import _bytes

    spec = clf.spec
    streamed = clf.table is None
    if streamed:
        host_main = torch.from_numpy(clf.np_table.view(np.int32))
    for bi in sorted(set(launched)):
        b = pool[bi]
        wire = b.count * (b.w2 + b.wv)
        out = b.count * 5 * 4
        labels = b.count * b.P * 4
        if not b.fused:
            b.bytes["score"] = labels + out
        if spec.layout != "qs":
            continue
        if streamed:
            codes = reference.read_codes(reads.bufs, reads.starts,
                                         reads.ends, b.first, b.count,
                                         clf.stash.device)
            q, valid = reference.window_keys(codes, k)
            m, s = _bytes.qs_rows_host(q[valid], host_main, spec.nb_bits,
                                       spec.stash_bits, spec.seed)
            rows = _bytes.part_rows(m, s, spec.nb_bits, spec.stash_bits,
                                    clf.stream_parts)
            b.bytes.update(_bytes.range_bytes(rows, wire, labels,
                                              out if b.fused else None))
            continue
        codes = reference.read_codes(reads.bufs, reads.starts, reads.ends,
                                     b.first, b.count, clf.table.device)
        q, valid = reference.window_keys(codes, k)
        m, s = _bytes.qs_rows(q[valid], clf.table, spec.nb_bits,
                              spec.stash_bits, spec.seed)
        kind, o = ("fused", out) if b.fused else ("query", labels)
        b.bytes[kind] = _bytes.query_bytes(m.numel(), s.numel(), wire, o)


def breakdown(run: TraceRun) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the host's CUDA call open at its middle."""
    import _trace

    tot = collections.Counter()
    for e in run.events:
        if e.get("cat") in _trace.DEVICE_CATS:
            tot[e["name"][:200]] += float(e["dur"]) / 1e6
    busy = _trace.union(_trace.intervals(run.events, _trace.DEVICE_CATS))
    lo, hi = run.window
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in run.events
                   if e.get("cat") in HOST_CALLS)
    starts = [c[0] for c in calls]
    idle = []
    for dur, at in gaps:
        mid = at + dur / 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        name = "host outside CUDA calls"
        if j >= 0 and calls[j][1] >= mid:
            name = f"host in {calls[j][2]}"
        idle.append([name[:200], dur / 1e6])
    return {"device_ops": [[n, s] for n, s in tot.most_common(10)],
            "idle_gaps": idle}


def read_trace(prof) -> list:
    import _trace

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return _trace.complete_events(load_json(Path(path)))
    finally:
        os.unlink(path)


# ---------- one run ----------


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def device_budget(mb):
    """The program's card budget set to `mb` MB (None: left as it is)
    until the block ends, then restored."""
    if mb is None:
        yield
        return
    before = os.environ.get(DEVICE_MB_ENV)
    os.environ[DEVICE_MB_ENV] = str(mb)
    try:
        yield
    finally:
        if before is None:
            del os.environ[DEVICE_MB_ENV]
        else:
            os.environ[DEVICE_MB_ENV] = before


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, wrap_step=None, log=print) -> dict:
    """One run of `cell` -> the result object (and its checks last).
    `wrap_step` wraps the step (tests plant faults with it): a batch's
    `step(packed2, vbits) -> results`, or on a streamed table the group's
    `step([(packed2, vbits), ...]) -> [results, ...]`."""
    classify = cell.config.get("classify", {})
    unknown = sorted(set(classify) - set(CLASSIFY_KEYS))
    if unknown:
        raise ValueError(f"the configuration's classify sets {unknown}; "
                         f"it may set only {list(CLASSIFY_KEYS)}")
    with device_budget(cell.config.get("device_mb")):
        return _run_cell(cell, seed, seconds, trace, device, t_start,
                         wrap_step, log, classify)


def _run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float, wrap_step, log, classify: dict) -> dict:
    from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
    from cuclark_tpu_torch.hashdb import build_table
    from cuclark_tpu_torch.pipeline import Classifier, classify_step_packed

    cfg, traffic = cell.config, cell.traffic
    device = torch.device(device)
    k = cfg["k"]
    phases = {"imports": time.perf_counter() - t_start}
    mark = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    universe = generator.make_universe(cfg, seed, device)
    keys_d, labels_d = generator.make_db(universe, cfg)
    reads = generator.make_reads(universe, cfg, traffic, seed)
    del universe
    keys = keys_d.cpu()
    labels = labels_d.cpu()
    del keys_d, labels_d
    phase("inputs")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    names = ["NA"] + [f"T{i}" for i in range(1, cfg["genomes"] + 1)]
    db = build_table(keys.numpy().view(np.uint64),
                     labels.numpy().view(np.uint32), names,
                     DBConfig(k=k, gap=cfg["gap"], layout=cfg["layout"],
                              target_load=cfg["target_load"]))
    phase("build_table")
    clf = Classifier(db, ClassifyConfig(**classify), device=device)
    phase("classifier")
    parts = cfg.get("stream_parts", 1)
    streamed = clf.stream_parts > 1
    if clf.stream_parts != parts:
        raise RuntimeError(f"the table streams in {clf.stream_parts} "
                           f"part(s); the configuration states {parts}")
    table, stash, spec = clf.table, clf.stash, clf.spec
    plan = {}
    if streamed:
        size = clf.stream_group_eff
        plan = {"stream_parts": clf.stream_parts, "stream_group": size,
                "part_bytes": clf.np_table.nbytes // clf.stream_parts,
                "table_budget_mb": clf.table_budget_mb}
        log("plan: " + ", ".join(f"{n} {v}" for n, v in plan.items())
            + f"; {DEVICE_MB_ENV}={os.environ.get(DEVICE_MB_ENV)}")
        if len(reads.batches) < size:
            raise RuntimeError(f"the pool holds {len(reads.batches)} "
                               f"batches, fewer than a group of {size}")
        # the program's group step (every part uploaded once, each batch
        # probing every part), under the public name `step_group` once
        # the program gives it one, which this file cannot follow later
        program_step = (getattr(clf, "step_group", None)
                        or clf._stream_group_dev)

        def step(wires):
            return [res for res, _ in program_step(wires)]
    else:
        def step(p2, vb):
            return classify_step_packed(table, p2, vb, k=k, spec=spec,
                                        stash=stash, with_labels=False)[0]

    if wrap_step is not None:
        step = wrap_step(step)
    pool = build_pool(reads, k, device)
    phase("pack")
    if streamed:
        warm_up_groups(pool, step, size, device)
    else:
        warm_up(pool, step, device)
    phase("warm_up")
    t_setup = time.perf_counter() - t_start
    log("set-up phases, s: " + ", ".join(f"{n} {v:.3f}"
                                         for n, v in phases.items()))
    log(f"set-up {t_setup:.3f} s: {len(keys)} k-mers, table "
        f"{db.table.nbytes / 1e6:.1f} MB (nb_bits {db.nb_bits}, stash_bits "
        f"{db.stash_bits}), {reads.n_reads} reads in {len(pool)} batches")
    prof = None
    if trace:
        # the device's activity and the host's CUDA calls; no host op is
        # recorded on a card, so the host issues as fast as untraced
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[
            act.CUDA if device.type == "cuda" else act.CPU])
    # the set-up's objects out of the collector's way in the window
    gc.collect()
    gc.freeze()
    if streamed:
        win = run_window_groups(pool, step, size, seconds, device, prof)
    else:
        win = run_window(pool, step, seconds, device, prof)
    gc.unfreeze()
    issue_us = (win.untraced_issue_s / win.untraced * 1e6 if win.untraced
                else None)
    log(f"window: {win.issued} batches, {len(win.launches)} traced, host "
        f"issue {win.issue_s / max(1, win.issued) * 1e6:.1f} us a batch "
        f"({issue_us} us untraced)")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # a batch whose step or copy fails raises: the run ends without a
    # result, so every issued batch that ends here has landed
    result = {"correct": False, "attempted": win.attempted, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": peak, **plan}}
    if streamed and device.type == "cuda":
        log("part uploads of the last group, GB/s: "
            + ", ".join(f"{g:.2f}" for g in clf.part_upload_gbps()))
    if trace:
        import _trace

        t_trace = time.perf_counter()
        events = read_trace(prof)
        run = TraceRun(events, _trace.window_us(events) if events else (0, 0),
                       pool, win.launches, issue_us,
                       [plan["part_bytes"]] * clf.stream_parts
                       if streamed else [])
        t_bytes = time.perf_counter()
        count_bytes(pool, win.launches, reads, clf, k)
        log(f"bytes: {len(set(win.launches))} batches counted in "
            f"{time.perf_counter() - t_bytes:.1f} s")
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        lo, hi = run.window
        result["device"]["busy_s"] = _trace.busy_us(events) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown(run)
        log(f"trace: {len(events)} events read in "
            f"{time.perf_counter() - t_trace:.1f} s")
        del events, run
    else:
        values = {"reads_per_s": win.landed / seconds, "setup_s": t_setup}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    # free the program's state before the reference runs on the card
    if streamed:
        clf.close()
    del clf, db, table, stash, step
    for b in pool:
        b.buf = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(reads, check_sample(reads, seed), win.last.get, keys,
                   labels, k, device)
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    result["correct"] = passed(checks)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result
