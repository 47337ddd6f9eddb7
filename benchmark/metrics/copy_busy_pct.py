"""copy_busy_pct: the share of the traced window in which a host-device
copy ran (the union of the trace's gpu_memcpy events): the wire batches'
H2D and the results' D2H."""

import _trace


def read(run):
    lo, hi = run.window
    iv = _trace.intervals(run.events, ("gpu_memcpy",))
    if hi <= lo or not iv:
        return None
    return 100.0 * _trace.covered_us(iv) / (hi - lo)
