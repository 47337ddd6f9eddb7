"""The program's own spans and counters (`cuclark_tpu_torch.spans`) for
the `program_span` and `program_counter` readers, with span times mapped
onto the traced window's clock (`spans.trace_us`: a Chrome trace's `ts`,
us after the recorder's base, which is the trace's).  None where the
program has no recorder (a tree from before it), so that its readers
are silent there."""

import importlib


def program():
    """(the spans module, its snapshot), or None."""
    try:
        spans = importlib.import_module("cuclark_tpu_torch.spans")
    except ImportError:
        return None
    return spans, spans.snapshot()


def in_trace(spans, snap, names=None) -> list:
    """(start, end, span) in trace us of the snapshot's spans (of
    `names` only, when given)."""
    return [(spans.trace_us(s.start_ns), spans.trace_us(s.end_ns), s)
            for s in snap["spans"] if names is None or s.name in names]
