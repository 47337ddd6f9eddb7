"""idle_in_program_pct: of the traced window's device-idle time (the
window less the union of kernel, copy and memset events, as
`_trace.busy_us` takes it), the share during which a program span was
open on any thread: the idle gaps the program's own work (the step's
dispatch, a file path's stages) sits in, against the caller's."""

import _spans
import _trace


def idle(events, lo: float, hi: float) -> list:
    """The window [lo, hi] less the union of the device's events."""
    out, at = [], lo
    for a, b in _trace.union(_trace.intervals(events, _trace.DEVICE_CATS)):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    tot, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def read(run):
    got = _spans.program()
    lo, hi = run.window
    if got is None or hi <= lo:
        return None
    gaps = idle(run.events, lo, hi)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    open_ = _trace.union((a, b) for a, b, _ in _spans.in_trace(*got))
    return 100.0 * overlap_us(gaps, open_) / total
