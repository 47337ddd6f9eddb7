"""The fused query and score of one-tile qs reads (csrc/query.cu,
query_score_kernel; `probe.query_score_results`) against the JAX package:
a numpy model of the kernel's epilogue (a block's labels in shared
memory, scored by warp 0 with four labels a lane) against
`cuclark_tpu.score.score_labels`, and `pipeline.classify_step_packed`
without labels, which takes the fused path's plain version on the CPU,
against `cuclark_tpu.pipeline.classify_step_packed` at k 15 to 32, with a
poly-A read, reads without a valid window and reads of many labels.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import score as jscore
from cuclark_tpu_torch import codec, hashdb, kernels, pipeline, probe
from cuclark_tpu_torch.config import DBConfig
from tests.test_torch_cuda import FUSED, fused_case
from tests.test_torch_score import _labels, _range_labels, _warp_model

TILE = kernels.QUERY_SCORE_MAX_WINDOWS   # csrc/query.cu kTile


def _epilogue_model(row):
    """query_score_kernel's epilogue: thread p < P stores window p's label
    in lab_s[p], threads P .. TILE - 1 store 0; warp 0 takes lab_s[32 e +
    lane] as its register e (E = TILE / 32 whatever P is) and scores the
    row as score.cu's warp path does."""
    lab_s = np.zeros(TILE, row.dtype)
    lab_s[:len(row)] = row
    return _warp_model(lab_s)


@pytest.mark.parametrize("P", [1, 2, 31, 32, 33, 64, 98, 114, 121, 122, 127,
                               128])
def test_fused_epilogue_model_matches_jax(P):
    """The epilogue on rows of P <= TILE windows: random labels with ties
    and all-miss rows, the label-range rows, and rows of P distinct
    labels (more than the rounds count, so the warp sorts)."""
    rng = np.random.default_rng(P)
    distinct = rng.permutation(np.arange(1, 65536, dtype=np.int32))[:P]
    lab = np.concatenate([_labels(P + 1000, 16, P, 6), _range_labels(P, P),
                          distinct[None, :]])
    want = np.asarray(jscore.score_labels(jnp.asarray(lab)))
    got = np.array([_epilogue_model(row) for row in lab])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,L", FUSED)
def test_classify_step_packed_fused_matches_jax(k, L):
    """classify_step_packed without labels (the fused query and score's
    plain version here) against the JAX step's results, and against the
    port's own query then score."""
    db, codes = fused_case(k, L)
    p2, vb = codec.pack_codes(codes)
    assert probe.fuses_score(db.spec, torch.from_numpy(p2), k)
    jres, _ = jpipeline.classify_step_packed(
        jnp.asarray(db.table), jnp.asarray(p2), jnp.asarray(vb), k=db.k,
        nb_bits=db.nb_bits, slots=db.slots, num_choices=db.num_choices,
        layout=db.layout, seed=db.seed, stash_bits=db.stash_bits)
    main, stash = hashdb.table_to_device(db, "cpu")
    args = dict(k=k, spec=db.spec, stash=stash)
    res, lab = pipeline.classify_step_packed(
        main, torch.from_numpy(p2), torch.from_numpy(vb), with_labels=False,
        **args)
    assert lab is None
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    two, lab2 = pipeline.classify_step_packed(
        main, torch.from_numpy(p2), torch.from_numpy(vb), **args)
    assert torch.equal(res, two)
    got = res.numpy()
    P = lab2.shape[1]
    assert got[0, 0] == P and got[0, 2] == P      # poly-A: one label
    assert (got[1] == 0).all() and (got[2] == 0).all()
    assert got[3, 0] == P and got[3, 2] < P       # many labels
    assert (got[8:, 2] > 0).all()
    stash_only = probe.query_labels_plain(
        torch.from_numpy(p2), torch.from_numpy(vb), torch.zeros_like(main),
        stash, k=k, spec=db.spec)
    assert int((stash_only > 0).sum()) > 0


def test_fused_dispatch():
    """Which steps fuse: qs reads of 1 to TILE windows only."""
    spec = hashdb.TableSpec(layout="qs", nb_bits=17, stash_bits=17)
    for L, k, fused in ((128, 15, True), (152, 31, True), (160, 31, False),
                        (144, 17, True), (152, 24, False), (24, 31, False),
                        (32, 31, True)):
        p2 = torch.zeros((2, L // 4), dtype=torch.uint8)
        assert probe.fuses_score(spec, p2, k) == fused, (L, k)
    for layout in ("q4", "s2"):
        other = hashdb.TableSpec(layout=layout, nb_bits=17)
        assert not probe.fuses_score(other, torch.zeros((2, 38),
                                                        dtype=torch.uint8), 31)


def test_fused_kernel_refuses_cpu_and_wide_rows():
    """The kernel's wrapper takes CUDA tensors only, and refuses rows
    wider than one tile before it launches anything."""
    spec = hashdb.TableSpec(layout="qs", nb_bits=17, stash_bits=17)
    main = torch.zeros((1 << 17, 8), dtype=torch.int32)
    p2 = torch.zeros((2, 40), dtype=torch.uint8)
    vb = torch.zeros((2, 20), dtype=torch.uint8)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.query_score(p2, vb, main, main, k=31, spec=spec)
    assert kernels.LAUNCHES == before
