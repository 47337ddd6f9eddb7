"""The least bytes a query or score kernel moves for one batch, and the
least time of those bytes on the card.

Frozen copies, from commit 5f9e300, of `scripts/torch_measure.py`'s
`bound_ms`, `qs_window_rows`/`touched_rows` (qs layout) and
`query_bytes` (one resident call), with the Feistel mix of
`cuclark_tpu_torch.hashdb` (`feistel_seed_consts`, `feistel_mix_torch`)
and the row match of `probe._match_labels` that they use, so that a
change to the program cannot change the yardstick.  Each input byte is
counted once, each output byte once, and each table row a batch needs
once (32 B), whatever the kernel reads again.  A qs window needs its
main row, and its stash row only where the main row gives no label and
is full (csrc/query.cu, qs_label).  Other layouts give None.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
_MASK32 = 0xFFFFFFFF


def bound_ms(nbytes: float) -> float:
    """The least time to move nbytes through device memory, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _fmix_np(h):
    M = np.uint32
    h = h ^ (h >> M(16))
    h = h * M(0x85EBCA6B)
    h = h ^ (h >> M(13))
    h = h * M(0xC2B2AE35)
    return h ^ (h >> M(16))


def feistel_seed_consts(seed: int):
    s = np.uint32(seed & _MASK32)
    with np.errstate(over="ignore"):
        return tuple(int(_fmix_np(s * np.uint32(2) + np.uint32(c)))
                     for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35))


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def feistel_mix(hi: torch.Tensor, lo: torch.Tensor, seed: int):
    c1, c2, c3 = feistel_seed_consts(seed)
    l1 = lo ^ _fmix((hi + c1) & _MASK32)
    h1 = hi ^ _fmix((l1 + c2) & _MASK32)
    l2 = l1 ^ _fmix((h1 + c3) & _MASK32)
    return h1, l2


def _match_labels(tbl, b, own, other, bits: int, choice: int):
    rows = tbl[b].to(torch.int64) & _MASK32
    meta = rows[:, 4:]
    m = ((rows[:, :4] == other[:, None])
         & ((meta >> 17) == (own >> bits)[:, None])
         & (((meta >> 16) & 1) == choice))
    return torch.where(m, meta & 0xFFFF, 0).sum(dim=1)


def qs_rows(keys: torch.Tensor, main: torch.Tensor, nb_bits: int,
            stash_bits: int, seed: int):
    """(distinct main rows, distinct stash rows) that a resident qs query
    of the canonical keys (int64 [n], valid windows only) reads."""
    h1, l2 = feistel_mix(keys >> 32, keys & _MASK32, seed)
    b0 = l2 & ((1 << nb_bits) - 1)
    b1 = h1 & ((1 << stash_bits) - 1)
    lab = _match_labels(main, b0, l2, h1, nb_bits, 0)
    full = ((main[b0][:, 4:] & 0xFFFF) != 0).sum(1) == 4
    return torch.unique(b0), torch.unique(b1[(lab == 0) & full])


def query_bytes(n_main: int, n_stash: int, in_bytes: int,
                out_bytes: int) -> int:
    """Least bytes of one resident query call: input and output once,
    each needed 32 B row once."""
    return in_bytes + out_bytes + 32 * (n_main + n_stash)
