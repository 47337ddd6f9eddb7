"""fused_roofline_pct: the fused query and score kernel's
(csrc/query.cu query_score_kernel) share of its roofline: wire in,
results out, each table row a batch needs once, at 3.35 TB/s, over its
kernel time."""

import _roofline


def read(run):
    return _roofline.share(run, ("query_score_kernel",), "fused")
