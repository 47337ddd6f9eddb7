"""Parity of the port's codec device half (plain PyTorch, int64 k-mers)
with the JAX package's `codec.unpack_codes`, `extract_kmers` and
`canonical` on the CPU.  Every comparison is exact."""

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
