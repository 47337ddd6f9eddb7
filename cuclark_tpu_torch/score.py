"""Per-read scoring: hit totals, best / second-best targets.

Counterpart of `cuclark_tpu/score.py`.  `score_labels` (score.py:28) is
a hand-written CUDA kernel, `csrc/score.cu`, for CUDA tensors and its
plain PyTorch version `score_labels_plain` for CPU tensors; the kernel
is held against the plain version.  `gamma_confidence` is host numpy,
carried over unchanged: the record path's, and the plain version of the
row writer's own arithmetic (`native.format_results`, classify's CSV).

Per read, the window labels are sorted, runs of equal labels are
counted at their run ends, and the best target is found as (max count,
then smallest label among count-ties), then the second best with the
best label excluded.  That reproduces the reference's tie-breaking:
resultKernel scans targets in ascending index order with strict '>'
(src/CuClarkDB.cu:1421-1471), so ties keep the smaller target index.
"""

from __future__ import annotations

import torch

from cuclark_tpu_torch import kernels

_LBL_MAX = 65535


def score_labels_plain(labels: torch.Tensor) -> torch.Tensor:
    """labels: int32 [R, P], 1-based target label per window, 0 = miss.

    Returns int32 [R, 5]: [total, index_best, best, index_2nd, second],
    the reference's [sumN, indexBest, best, index_sBest, s_best] row
    (src/CuClarkDB.cu:1460-1464).
    """
    R, P = labels.shape
    dev = labels.device
    s = torch.sort(labels.to(torch.int64), dim=-1).values     # ascending
    idx = torch.arange(P, dtype=torch.int64, device=dev).expand(R, P)
    change = s[:, 1:] != s[:, :-1]
    edge = torch.ones((R, 1), dtype=torch.bool, device=dev)
    first = torch.cat([edge, change], dim=-1)
    last = torch.cat([change, edge], dim=-1)
    # start index of each element's run, carried right by a running max
    run_start = torch.cummax(torch.where(first, idx, -1), dim=1).values
    count = idx - run_start + 1                             # valid at run ends
    is_run = last & (s > 0)

    def top(mask):
        """(max count, smallest label among count-ties) over runs in mask."""
        c = torch.where(mask, count, 0).max(dim=-1).values
        tie = mask & (count == c[:, None])
        lab = torch.where(tie, s, _LBL_MAX + 1).min(dim=-1).values
        return c, torch.where(c > 0, lab, 0)

    best, index_best = top(is_run)
    second, index_second = top(is_run & (s != index_best[:, None]))
    total = (labels > 0).sum(dim=-1)
    return torch.stack([total, index_best, best, index_second, second],
                       dim=-1).to(torch.int32)


def score_labels(labels: torch.Tensor,
                 label_bound: int | None = None) -> torch.Tensor:
    """Per-read results int32 [R, 5]: the score kernel for a CUDA tensor,
    its plain version for a CPU tensor.  label_bound, where given, is at
    least every label of `labels` (a table's `TableSpec.label_bound`):
    the kernel then counts rows over 1,024 windows in a histogram of that
    many labels (`kernels.score`); the results are the same."""
    if labels.device.type == "cpu":
        return score_labels_plain(labels)
    return kernels.score(labels, label_bound)


def gamma_confidence(total, best, second, length, k: int, paired: bool):
    """CSV math, reference src/CuCLARK_hh.hh:2054-2056, 2127-2135.

    gamma = total / (len - k + 1);  paired reads subtract NBN=1 from the
    merged length first (the joining 'N', src/CuCLARK_hh.hh:2044).
    confidence = best / (best + second), 0 when the sum is ~0.
    Computed in float64 on the host for bit-identical %g output.
    """
    import numpy as np

    norm = np.asarray(length, dtype=np.int64)
    if paired:
        norm = norm - 1  # NBN
    # reads with length <= k-1 divide by <= 0 exactly like the
    # reference's C expression (len == k-1 prints nan, shorter prints
    # -0 — parity quirks, kept); only numpy's per-batch RuntimeWarning
    # is suppressed, never the values
    with np.errstate(divide="ignore", invalid="ignore"):
        gamma = (np.asarray(total, dtype=np.float64)
                 / (norm.astype(np.float64) - k + 1.0))
    s = np.asarray(best, dtype=np.float64) + np.asarray(second, dtype=np.float64)
    conf = np.where(s < 0.001, 0.0, np.asarray(best, dtype=np.float64) / np.where(s == 0, 1.0, s))
    return norm, gamma, conf
