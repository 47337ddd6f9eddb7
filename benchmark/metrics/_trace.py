"""Reading a torch.profiler Chrome trace: the device's busy time and the
kernels by name.

The busy share is `chip_smoke.trace_kernels`'s arithmetic (commit
5f9e300), frozen here: the union of kernel, copy and memset events over
the traced window, the first to the last event of the trace.
"""

from __future__ import annotations

import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def complete_events(trace: dict) -> list[dict]:
    """The trace's complete ("X") events that have a duration."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def window_us(events) -> tuple[float, float]:
    """(first start, last end) of the events, in us."""
    return (min(float(e["ts"]) for e in events),
            max(float(e["ts"]) + float(e["dur"]) for e in events))


def intervals(events, cats) -> list[tuple[float, float]]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") in cats)


def union(iv) -> list[tuple[float, float]]:
    """Sorted intervals merged where they overlap."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered_us(iv) -> float:
    return sum(b - a for a, b in union(iv))


def busy_us(events) -> float:
    """Time in which a kernel, a copy or a memset ran on the device."""
    return covered_us(intervals(events, DEVICE_CATS))


def kernels(events, name: str) -> list[dict]:
    """Kernel events of the kernel `name` (a whole identifier in the
    demangled name: `query_kernel` is not `range_query_kernel`)."""
    pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")
    return sorted((e for e in events
                   if e.get("cat") == "kernel" and pat.search(e["name"])),
                  key=lambda e: float(e["ts"]))
