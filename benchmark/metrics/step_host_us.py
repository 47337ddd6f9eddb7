"""step_host_us: the host's time inside `pipeline.classify_step_packed`
(the program's `step` span: routing, operand checks, the results'
allocation and the kernels' ctypes launches), mean over the step spans
that began in the traced window; the harness's copies fall outside it."""

import _spans


def read(run):
    got = _spans.program()
    lo, hi = run.window
    if got is None or hi <= lo:
        return None
    d = [b - a for a, b, _ in _spans.in_trace(*got, ("step",))
         if lo <= a <= hi]
    return sum(d) / len(d) if d else None
