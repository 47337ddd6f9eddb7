"""The plain reference of a classification: what each read's CLARK
result row must be, worked out again from the read's bases and the
(k-mer, label) set the benchmark made.

Plain PyTorch on integers, device-agnostic, in blocks of rows.  It
imports nothing of the program under test and reads nothing the program
made: no table, no wire batch.  A read (or a pair, mate 1, one N, mate
2) is split into its k-mer windows; a window holding a base other than
A, C, G or T has no k-mer.  Each window's canonical k-mer (the smaller
of the forward k-mer and its reverse complement, first base most
significant, A=3 C=2 G=1 T=0) is looked up in the sorted key set by
binary search.  The row is [total, index_best, best, index_second,
second]: the windows that hit, the target with the most hits (the
smallest target index among ties) and its hits, then the same over the
other targets (0, 0 where none).

`key_bits` compares keys on their low bits only: a lookup that breaks
the exactness the configurations state (the control of the check).
"""

from __future__ import annotations

import numpy as np
import torch

INVALID = 4
LUT = np.full(256, INVALID, np.uint8)
for _c, _v in zip(b"ACGTacgt", (3, 2, 1, 0, 3, 2, 1, 0)):
    LUT[_c] = _v
# windows a block of rows holds at most
BLOCK_WINDOWS = 1 << 25


def read_codes(bufs, starts, ends, first: int, count: int,
               device="cpu") -> torch.Tensor:
    """uint8 codes [count, longest] on `device` (INVALID past a read's
    end) of the reads first .. first + count - 1, which lie back to back
    in each buffer: the bases of bufs[0][starts[0][i]:ends[0][i]], and
    for a pair an N and mate 2 from bufs[1]."""
    lut = torch.from_numpy(LUT).to(device)
    sl = slice(first, first + count)
    lens = [torch.from_numpy(e[sl] - s[sl]).to(device)
            for s, e in zip(starts, ends)]
    total = lens[0] + (lens[1] + 1 if len(bufs) == 2 else 0)
    width = int(total.max()) if count else 1
    out = torch.full((count, width), INVALID, dtype=torch.uint8,
                     device=device)
    col = torch.arange(width, device=device)[None, :]
    off = torch.zeros_like(lens[0])
    for buf, s, e, ln in zip(bufs, starts, ends, lens):
        if not count:
            break
        lo = int(s[first])
        seg = torch.from_numpy(np.ascontiguousarray(
            buf[lo:int(e[first + count - 1])])).to(device)
        rel = torch.from_numpy(s[sl] - lo).to(device)
        take = col - off[:, None]
        ok = (take >= 0) & (take < ln[:, None])
        out[ok] = lut[seg[(rel[:, None] + take)[ok]].long()]
        off = off + ln + 1
    return out


def window_keys(codes: torch.Tensor, k: int):
    """(canonical k-mer int64 [R, P], valid bool [R, P]) of every window
    of codes [R, L]; k <= 31."""
    if not 1 <= k <= 31:
        raise ValueError(f"the reference takes k in [1, 31], got {k}")
    c = codes.to(torch.int64)
    R, L = c.shape
    P = max(L - k + 1, 0)
    bad = (c >= INVALID).to(torch.int32)
    run = torch.zeros((R, P), dtype=torch.int32, device=c.device)
    fwd = torch.zeros((R, P), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    c = torch.where(c >= INVALID, 0, c)
    for j in range(k):
        s = c[:, j:j + P]
        fwd = fwd * 4 + s
        rev = rev + (3 - s) * (4 ** j)
        run += bad[:, j:j + P]
    return torch.minimum(fwd, rev), run == 0


class KeySet:
    """The (k-mer, label) set, sorted for binary search, on one device."""

    def __init__(self, keys: torch.Tensor, labels: torch.Tensor,
                 key_bits: int | None = None):
        if key_bits is not None:
            keys = keys & ((1 << key_bits) - 1)
            keys, order = torch.sort(keys, stable=True)
            labels = labels[order]
        elif keys.numel() > 1 and not bool((keys[1:] > keys[:-1]).all()):
            raise ValueError("keys must be sorted and unique")
        self.keys, self.labels, self.key_bits = keys, labels, key_bits

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """Label (0 = none) of each key of q."""
        if self.key_bits is not None:
            q = q & ((1 << self.key_bits) - 1)
        if not self.keys.numel():
            return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        i = torch.searchsorted(self.keys, q).clamp(max=self.keys.numel() - 1)
        return torch.where(self.keys[i] == q, self.labels[i].to(torch.int32),
                           0)


def top_two(labels: torch.Tensor) -> torch.Tensor:
    """int32 [R, 5] result rows of window labels [R, P] (0 = no hit)."""
    R, P = labels.shape
    dev = labels.device
    out = torch.zeros((R, 5), dtype=torch.int64, device=dev)
    row = torch.arange(R, device=dev)[:, None].expand(R, P)
    hit = labels > 0
    out[:, 0] = hit.sum(1)
    pair = row[hit] * 65536 + labels[hit].to(torch.int64)
    keys, counts = torch.unique(pair, return_counts=True)
    r, lab = keys // 65536, keys % 65536
    for col in (1, 3):
        # the largest count, then the smallest label: one key to maximise
        score = counts * 65536 + (65535 - lab)
        best = torch.full((R,), -1, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, r, score, "amax")
        has = best >= 0
        out[:, col] = torch.where(has, 65535 - best % 65536, 0)
        out[:, col + 1] = torch.where(has, best // 65536, 0)
        drop = lab == out[r, col]
        r, lab, counts = r[~drop], lab[~drop], counts[~drop]
    return out.to(torch.int32)


def classify(codes: torch.Tensor, k: int, keyset: KeySet) -> torch.Tensor:
    """Result rows int32 [R, 5] of reads codes [R, L], in blocks of rows,
    on the key set's device."""
    dev = keyset.keys.device
    P = max(codes.shape[1] - k + 1, 1)
    step = max(1, BLOCK_WINDOWS // P)
    out = []
    for lo in range(0, codes.shape[0], step):
        q, valid = window_keys(codes[lo:lo + step].to(dev), k)
        lab = torch.where(valid, keyset.lookup(q), 0)
        out.append(top_two(lab))
    return torch.cat(out) if out else torch.zeros((0, 5), dtype=torch.int32)
