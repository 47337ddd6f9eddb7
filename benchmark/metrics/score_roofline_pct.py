"""score_roofline_pct: the score kernel's (csrc/score.cu,
score_warp_kernel and score_hist_kernel) share of its roofline: labels
in, results out, at 3.35 TB/s, over its kernel time."""

import _roofline


def read(run):
    return _roofline.share(run, ("score_warp_kernel", "score_hist_kernel"),
                           "score")
