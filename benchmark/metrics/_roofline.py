"""A kernel's share of its roofline over the traced window: the least
time of the bytes its launches need (`_bytes`) over the time its kernel
events took.  The launches are the harness's, in order; where the trace
holds another number of the kernel's events than there were launches
(lost profiler events), each event counts the mean launch's bytes."""

import sys

import _bytes
import _trace


def share(run, names, kind: str):
    """The share of the kernels `names` (a tuple of kernel names) for the
    launches whose batch has bytes of `kind`."""
    ev = sorted((e for n in names for e in _trace.kernels(run.events, n)),
                key=lambda e: float(e["ts"]))
    kernel = "/".join(names)
    need = [run.batches[b].bytes[kind] for b in run.launches
            if kind in run.batches[b].bytes]
    if not ev or not need:
        return None
    if len(ev) != len(need):
        print(f"{kernel}: {len(ev)} kernel events for {len(need)} "
              f"launches; each event counts the mean launch",
              file=sys.stderr)
        need = [sum(need) / len(need)] * len(ev)
    ms = sum(float(e["dur"]) for e in ev) / 1e3
    return 100.0 * sum(_bytes.bound_ms(b) for b in need) / ms
