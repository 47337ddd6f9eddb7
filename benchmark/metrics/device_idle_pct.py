"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the device (100 less `chip_smoke.trace_kernels`'s
busy share)."""

import _trace


def read(run):
    lo, hi = run.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - _trace.busy_us(run.events) / (hi - lo))
