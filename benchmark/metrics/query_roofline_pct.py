"""query_roofline_pct: the unfused query kernel's (csrc/query.cu
query_kernel, reads of over 1,024 windows) share of its roofline: wire
in, labels out, each table row a batch needs once, at 3.35 TB/s, over
its kernel time."""

import _roofline


def read(run):
    return _roofline.share(run, ("query_kernel",), "query")
