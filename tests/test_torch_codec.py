"""Parity of the port's codec device half (plain PyTorch, int64 k-mers)
with the JAX package's `codec.unpack_codes`, `extract_kmers` and
`canonical` on the CPU, and of a numpy model of the query kernel's front
half (csrc/query.cu: staged bitstring words, funnel shifts, bit reversal)
with the same JAX functions.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import codec as jcodec
from cuclark_tpu_torch import codec as tcodec


def _codes(seed, R=12, L=61):
    """Random codes with N runs and rows padded with INVALID at the tail;
    L is not a multiple of 8, so pack_codes pads every row too."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.03] = jcodec.INVALID
    for r in range(0, R, 3):
        codes[r, rng.integers(L // 2, L):] = jcodec.INVALID
    return codes


def _u64(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))


@pytest.mark.parametrize("s", ["ACGTTGCAAACGT", "A", "T" * 32, "GATTACA" * 4])
def test_kmer_to_string_matches_jax(s):
    """kmer_to_string inverts string_to_kmer, as in tests/test_codec.py,
    and equals the JAX package's function on the same k-mer."""
    v = tcodec.string_to_kmer(s)
    assert v == jcodec.string_to_kmer(s)
    assert tcodec.kmer_to_string(v, len(s)) == s
    assert tcodec.kmer_to_string(v, len(s)) == jcodec.kmer_to_string(v, len(s))


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_codes_matches_jax(seed):
    p2, vb = jcodec.pack_codes(_codes(seed))
    want = np.asarray(jcodec.unpack_codes(jnp.asarray(p2), jnp.asarray(vb)))
    got = tcodec.unpack_codes(torch.from_numpy(p2), torch.from_numpy(vb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [2, 27, 31, 32])
def test_extract_kmers_matches_jax(k):
    codes = _codes(10 + k, L=64)
    (hi, lo), valid = jcodec.extract_kmers(jnp.asarray(codes), k)
    km, tvalid = tcodec.extract_kmers(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(km.numpy().view(np.uint64), _u64(hi, lo))
    assert tvalid.numpy().any() and not tvalid.numpy().all()


@pytest.mark.parametrize("k", [2, 27, 31, 32])
def test_canonical_matches_jax(k):
    codes = _codes(20 + k, L=64)
    (hi, lo), _ = jcodec.extract_kmers(jnp.asarray(codes), k)
    chi, clo = jcodec.canonical((hi, lo), k)
    km, _ = tcodec.extract_kmers(torch.from_numpy(codes), k)
    got = tcodec.canonical(km, k).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, _u64(chi, clo))
    np.testing.assert_array_equal(
        got, jcodec.canonical_np(km.numpy().view(np.uint64), k))
    if k == 32:
        # the unsigned compare: some forward k-mers have bit 63 set
        assert (km.numpy() < 0).any()


# ---- numpy model of the query kernel's front half (csrc/query.cu) ----

TILE = 128                 # kTile: windows per block
STAGE = TILE + 32          # kStage: bases a block stages
W2, WV = STAGE // 16, STAGE // 32


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low 32 bits of hi:lo >> s."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (both >> s.astype(np.uint64)) & np.uint64(0xFFFFFFFF)


def _brev64(x):
    """__brevll: reverse the 64 bits."""
    m = np.uint64
    for shift, mask in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                        (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                        (16, 0x0000FFFF0000FFFF)):
        x = ((x >> m(shift)) & m(mask)) | ((x & m(mask)) << m(shift))
    return (x >> m(32)) | (x << m(32))


def _stage_wire(p2, vb, t0):
    """stage_wire, every read at once: bytes [t0/4, +4*W2) of packed2 and
    [t0/8, +4*WV) of vbits, 0 past the row, as little-endian uint32
    words [R, W2] and [R, WV]."""
    def words(rows, start, n):
        b = np.zeros((len(rows), 4 * n), np.uint8)
        got = rows[:, start:start + 4 * n]
        b[:, :got.shape[1]] = got
        return b.view("<u4").astype(np.uint64)
    return words(p2, t0 // 4, W2), words(vb, t0 // 8, WV)


def _stage_codes(codes, t0):
    """stage_codes, every read at once: one byte a lane, 32 bases a
    chunk; the validity word by ballot, the two 2-bit words by an OR over
    each half-warp.  Positions past L stage as Ns."""
    R, L = codes.shape
    lane = np.arange(32, dtype=np.uint64)
    w2 = np.zeros((R, W2), np.uint64)
    wv = np.zeros((R, WV), np.uint64)
    for c in range(WV):
        q = t0 + 32 * c + np.arange(32)
        b = np.where(q < L, codes[:, np.minimum(q, L - 1)], 4).astype(
            np.uint64)
        wv[:, c] = np.bitwise_or.reduce((b < 4).astype(np.uint64) << lane,
                                        axis=1)
        v2 = (b & np.uint64(3)) << (np.uint64(2) * (lane & np.uint64(15)))
        w2[:, 2 * c] = np.bitwise_or.reduce(v2[:, :16], axis=1)
        w2[:, 2 * c + 1] = np.bitwise_or.reduce(v2[:, 16:], axis=1)
    return w2, wv


def _front_half(w2, wv, k):
    """window_kmer for the windows lp = 0..TILE-1 of one staged tile of
    every read -> (canonical uint64 [R, TILE], valid bool [R, TILE])."""
    m = np.uint64
    lp = np.arange(TILE, dtype=np.int64)
    assert (lp >> 5).max() + 1 < WV and (lp >> 4).max() + 2 < W2
    v = _funnel_r(wv[:, lp >> 5], wv[:, (lp >> 5) + 1], lp & 31)
    vmask = m(0xFFFFFFFF) >> m(32 - k)
    valid = (v & vmask) == vmask
    w, s = lp >> 4, (2 * lp) & 31
    lo = _funnel_r(w2[:, w], w2[:, w + 1], s)
    hi = _funnel_r(w2[:, w + 1], w2[:, w + 2], s)
    mask = m(0xFFFFFFFFFFFFFFFF) >> m(64 - 2 * k)
    x = ((hi << m(32)) | lo) & mask
    y = _brev64(x)
    y = ((y >> m(1)) & m(0x5555555555555555)) | (
        (y & m(0x5555555555555555)) << m(1))
    fwd = y >> m(64 - 2 * k)
    rc = ~x & mask
    return np.minimum(fwd, rc), valid


def _jax_canonical_windows(codes, k):
    pair, valid = jcodec.extract_kmers(codes, k)
    return jcodec.canonical(pair, k), valid


def _front_half_codes(k, L):
    """Random codes [R, L] with 3% Ns, one read all N, and one read per
    position q < min(L, 160) with its only N at q (Ns at every position
    of a tile, both tile edges included)."""
    rng = np.random.default_rng(1000 * k + L)
    R = 8 + min(L, 160)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[:8][rng.random((8, L)) < 0.03] = jcodec.INVALID
    codes[7] = jcodec.INVALID
    for q in range(min(L, 160)):
        codes[8 + q, q] = jcodec.INVALID
    return codes


@pytest.mark.parametrize("L", ["k", 33, 151, 152, 1000, "T", "T+1"])
@pytest.mark.parametrize("k", [2, 15, 16, 17, 27, 31, 32])
def test_query_front_half_model_matches_jax(k, L):
    """The kernel's front half, tile by tile as the blocks stage it, from
    the wire format and from unpacked codes, against
    `cuclark_tpu.codec.extract_kmers` + `canonical`: every window's
    canonical k-mer where it is valid, and its validity.  L "k" is one
    window; "T" and "T+1" give P = TILE and TILE + 1 windows."""
    L = {"k": k, "T": TILE + k - 1, "T+1": TILE + k}.get(L, L)
    codes = _front_half_codes(k, L)
    P = L - k + 1
    p2, vb = jcodec.pack_codes(codes)
    (hi, lo), valid = jax.jit(lambda c: _jax_canonical_windows(c, k))(
        jnp.asarray(codes))
    want, valid = _u64(hi, lo), np.asarray(valid)
    got_km = np.zeros(want.shape, np.uint64)
    got_ok = np.zeros(want.shape, bool)
    for t0 in range(0, P, TILE):
        n = min(TILE, P - t0)
        km, ok = _front_half(*_stage_wire(p2, vb, t0), k)
        ckm, cok = _front_half(*_stage_codes(codes, t0), k)
        np.testing.assert_array_equal(cok[:, :n], ok[:, :n])
        np.testing.assert_array_equal(ckm[:, :n][ok[:, :n]],
                                      km[:, :n][ok[:, :n]])
        got_km[:, t0:t0 + n], got_ok[:, t0:t0 + n] = km[:, :n], ok[:, :n]
    np.testing.assert_array_equal(got_ok, valid)
    np.testing.assert_array_equal(got_km[got_ok], want[got_ok])
    assert valid.any() and not valid.all()
