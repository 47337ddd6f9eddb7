"""The least bytes a query or score kernel moves for one batch, and the
least time of those bytes on the card.

Frozen copies, from commit 5f9e300, of `scripts/torch_measure.py`'s
`bound_ms`, `qs_window_rows`/`touched_rows` (qs layout) and
`query_bytes` (one resident call), with the Feistel mix of
`cuclark_tpu_torch.hashdb` (`feistel_seed_consts`, `feistel_mix_torch`)
and the row match of `probe._match_labels` that they use, and, from
commit c61579e, the split of a streamed table's stash over its parts
(`probe.stash_range`), so that a change to the program cannot change
the yardstick.  Each input byte is
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


def qs_rows_host(keys: torch.Tensor, main_host: torch.Tensor, nb_bits: int,
                 stash_bits: int, seed: int):
    """`qs_rows` where the main rows lie in host memory (a streamed
    table's) and the keys on any device: only the distinct rows that the
    keys index cross to the keys' device."""
    h1, l2 = feistel_mix(keys >> 32, keys & _MASK32, seed)
    b0 = l2 & ((1 << nb_bits) - 1)
    b1 = h1 & ((1 << stash_bits) - 1)
    rows, inv = torch.unique(b0, return_inverse=True)
    main = main_host[rows.cpu()].to(keys.device)
    lab = _match_labels(main, inv, l2, h1, nb_bits, 0)
    full = ((main[inv][:, 4:] & 0xFFFF) != 0).sum(1) == 4
    return rows, torch.unique(b1[(lab == 0) & full])


def part_rows(main_rows: torch.Tensor, stash_rows: torch.Tensor,
              nb_bits: int, stash_bits: int, parts: int) -> list:
    """[(main rows, stash rows)] that each part of a table streamed in
    `parts` bucket-range parts reads of the distinct rows given: main
    row b in part b // (2^nb_bits / parts); stash row r in the part whose
    range [p * n // parts, (p + 1) * n // parts) of the n stash rows
    holds it, or in part 0 where the parts outnumber the stash rows."""
    nb_part = (1 << nb_bits) // parts
    main = torch.bincount(main_rows // nb_part, minlength=parts).tolist()
    n = 1 << stash_bits
    if parts > n:
        return list(zip(main, [stash_rows.numel()] + [0] * (parts - 1)))
    edges = torch.tensor([p * n // parts for p in range(1, parts)],
                         dtype=stash_rows.dtype, device=stash_rows.device)
    stash = torch.bincount(torch.searchsorted(edges, stash_rows, right=True),
                           minlength=parts).tolist()
    return list(zip(main, stash))


def range_bytes(rows: list, in_bytes: int, acc_bytes: int,
                out_bytes: int | None = None) -> dict:
    """Least bytes of a streamed batch's launches, part by part, from
    `part_rows`: {"range": [one a range launch, in part order]} and,
    where the last part is fused with the score (out_bytes given),
    "range_fused".  A range launch reads the wire and its part's rows,
    and writes the labels: on the first part its own, on a later one the
    earlier parts' sum that it reads, with its own added.  The fused
    launch reads the wire, the earlier parts' sum and its rows, and
    writes the results."""
    calls = [in_bytes + (2 if p else 1) * acc_bytes + 32 * (m + s)
             for p, (m, s) in enumerate(rows)]
    if out_bytes is None:
        return {"range": calls}
    m, s = rows[-1]
    return {"range": calls[:-1],
            "range_fused": in_bytes + acc_bytes + out_bytes + 32 * (m + s)}
