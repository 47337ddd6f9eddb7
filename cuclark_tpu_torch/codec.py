"""2-bit nucleotide codec and canonical k-mer extraction.

Counterpart of `cuclark_tpu/codec.py`.  The host half (`INVALID`,
`BASE_LUT`, `encode_ascii`, `kmer_to_string`, `string_to_kmer`,
`revcomp_np`, `canonical_np`, `pack_codes`) is carried over unchanged.
The device half (`unpack_codes`, `extract_kmers`, `revcomp`,
`canonical`) is plain PyTorch on int64 tensors: a k-mer (k <= 32) is
one int64 holding the unsigned 64-bit bit pattern, so
`cuclark_tpu/u64.py`'s (hi, lo) pairs fold away.  These are the plain versions that the query kernel
(`csrc/query.cu`) is held against; CPU torch lacks most `torch.uint32`
operations, so every shift and compare here is int64 with explicit
masks where a logical shift or an unsigned compare is meant.

Encoding parity with the reference (CLARK/Jellyfish convention,
src/kmersConversion.cc:49-68): A=3, C=2, G=1, T=0, case-insensitive;
any other character (N, IUPAC codes, ...) breaks the read into separate
"parts" — k-mers never span it (src/CuCLARK_hh.hh:1679-1698).
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel code for non-ACGT characters / padding.
INVALID = 4

# Host lookup table: ASCII byte -> 2-bit code (A=3 C=2 G=1 T=0), INVALID
# else; RNA 'U' maps to T like the reference's nucleotide tables
# (src/CuCLARK_hh.hh:287,295).
BASE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in (("A", 3), ("C", 2), ("G", 1), ("T", 0), ("U", 0)):
    BASE_LUT[ord(_ch)] = _code
    BASE_LUT[ord(_ch.lower())] = _code

_CODE_TO_BASE = {3: "A", 2: "C", 1: "G", 0: "T"}


def encode_ascii(buf: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence bytes -> uint8 codes (0..3, INVALID for non-ACGT)."""
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, dtype=np.uint8)
    return BASE_LUT[arr]


def kmer_to_string(kmer: int, k: int) -> str:
    """Integer k-mer -> base string (debug/tests)."""
    return "".join(_CODE_TO_BASE[(int(kmer) >> (2 * (k - 1 - i))) & 3] for i in range(k))


def string_to_kmer(s: str) -> int:
    """Base string -> integer k-mer (reference getKmers semantics)."""
    v = 0
    for ch in s:
        c = BASE_LUT[ord(ch)]
        if c == INVALID:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | int(c)
    return v


def revcomp_np(kmer: np.ndarray, k: int) -> np.ndarray:
    """Reference getReverse (src/kmersConversion.cc:39-47) on numpy uint64."""
    x = np.asarray(kmer, dtype=np.uint64)
    m = np.uint64
    x = ((x >> m(2)) & m(0x3333333333333333)) | ((x & m(0x3333333333333333)) << m(2))
    x = ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F)) | ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4))
    x = ((x >> m(8)) & m(0x00FF00FF00FF00FF)) | ((x & m(0x00FF00FF00FF00FF)) << m(8))
    x = ((x >> m(16)) & m(0x0000FFFF0000FFFF)) | ((x & m(0x0000FFFF0000FFFF)) << m(16))
    x = (x >> m(32)) | (x << m(32))
    return (~x) >> m(64 - 2 * k)


def canonical_np(kmer: np.ndarray, k: int) -> np.ndarray:
    """min(forward, revcomp) — reference addElement canonicalization
    (src/HashTableStorage_hh.hh:484-497)."""
    return np.minimum(np.asarray(kmer, dtype=np.uint64), revcomp_np(kmer, k))


def pack_codes(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a uint8 code matrix [R, L] (values 0..3 or INVALID) into the
    wire format shipped host->device:

      packed2: uint8 [R, Lp/4]  — 4 bases/byte, little-endian 2-bit
      vbits:   uint8 [R, Lp/8]  — validity bitmask, little-endian

    where Lp = L rounded up to a multiple of 8 (pad positions pack as
    INVALID, i.e. valid bit 0), so the unpacked length is always
    recoverable from the shapes alone (Lp = 4*packed2.shape[-1]).

    The reference ships reads to the GPU as 4-nt/byte containers for the
    same reason (src/CuCLARK_hh.hh:1630-1716): interconnect bytes are the
    scarce resource.  INVALID positions pack an arbitrary 2-bit value and
    a 0 valid bit; unpack_codes restores INVALID exactly.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    R, L = codes.shape
    Lp = -(-L // 8) * 8
    if Lp != L:
        pad = np.full((R, Lp - L), INVALID, np.uint8)
        codes = np.concatenate([codes, pad], axis=1)
    c2 = (codes & 3).reshape(R, -1, 4)
    packed2 = (c2[:, :, 0] | (c2[:, :, 1] << 2) | (c2[:, :, 2] << 4)
               | (c2[:, :, 3] << 6)).astype(np.uint8)
    vbits = np.packbits(codes < INVALID, axis=1, bitorder="little")
    return packed2, vbits


# ---------- device half: plain PyTorch, int64 ----------

_SIGN = -(1 << 63)  # int64 with only bit 63 set


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the unsigned bit pattern held in int64
    (torch's >> on int64 is arithmetic)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def _unsigned_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on the unsigned 64-bit patterns held in int64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def unpack_codes(packed2: torch.Tensor, vbits: torch.Tensor,
                 L: int | None = None) -> torch.Tensor:
    """Inverse of pack_codes -> int32 codes [R, L] (counterpart of
    `cuclark_tpu.codec.unpack_codes`).

    L defaults to the full padded length 4*packed2.shape[-1]; padding
    positions unpack to INVALID, so downstream k-mer windows over them
    are masked out exactly like host-side INVALID padding."""
    if L is None:
        L = 4 * packed2.shape[-1]
    R = packed2.shape[0]
    dev = packed2.device
    p = packed2.to(torch.int64)                                  # [R, L/4]
    shifts = torch.arange(4, dtype=torch.int64, device=dev) * 2
    c = ((p[:, :, None] >> shifts) & 3).reshape(R, -1)[:, :L]
    v = vbits.to(torch.int64)                                    # [R, L/8]
    bits = torch.arange(8, dtype=torch.int64, device=dev)
    val = ((v[:, :, None] >> bits) & 1).reshape(R, -1)[:, :L]
    return torch.where(val == 1, c, INVALID).to(torch.int32)


def extract_kmers(codes: torch.Tensor, k: int):
    """All k-mer windows of a batch of encoded reads (counterpart of
    `cuclark_tpu.codec.extract_kmers`).

    codes: int [..., L] with values 0..3 or INVALID (padding & Ns).
    Returns (kmers, valid): int64 [..., P] forward k-mers, first base
    most significant, and bool [..., P], P = L - k + 1.  valid[p] is
    True iff the window [p, p+k) contains no INVALID code — the
    reference's "part" semantics (src/CuCLARK_hh.hh:1679-1698).
    INVALID codes enter the k-mer as 0, as in the JAX version.
    """
    codes = codes.to(torch.int64)
    L = codes.shape[-1]
    if L < k:
        raise ValueError(f"padded read length {L} < k={k}")
    P = L - k + 1
    invalid = (codes >= INVALID).to(torch.int64)
    cs = torch.nn.functional.pad(torch.cumsum(invalid, dim=-1), (1, 0))
    valid = (cs[..., k:] - cs[..., :-k]) == 0
    masked = torch.where(codes < INVALID, codes, 0)
    km = torch.zeros(codes.shape[:-1] + (P,), dtype=torch.int64,
                     device=codes.device)
    for j in range(k):
        km = (km << 2) | masked[..., j:j + P]
    return km, valid


def revcomp(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Jellyfish reverse complement (reference getReverse,
    src/kmersConversion.cc:39-47; counterpart of
    `cuclark_tpu.codec.revcomp`) on int64 k-mers."""
    x = kmer
    x = ((x >> 2) & 0x3333333333333333) | ((x & 0x3333333333333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0F) | ((x & 0x0F0F0F0F0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF00FF00FF) | ((x & 0x00FF00FF00FF00FF) << 8)
    x = ((x >> 16) & 0x0000FFFF0000FFFF) | ((x & 0x0000FFFF0000FFFF) << 16)
    x = shr(x, 32) | (x << 32)
    return shr(~x, 64 - 2 * k)


def canonical(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """min(forward, revcomp) as unsigned 64-bit values (counterpart of
    `cuclark_tpu.codec.canonical`); the unsigned compare matters at
    k=32, where bit 63 can be set."""
    rc = revcomp(kmer, k)
    return torch.where(_unsigned_lt(rc, kmer), rc, kmer)
