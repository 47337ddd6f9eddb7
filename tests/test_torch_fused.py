"""The fused query and score of reads of up to 1,024 windows
(csrc/query.cu, query_score_kernel, one instance per table layout and
tile count; `probe.query_score_results`) against the JAX package: a
numpy model of the kernel's epilogue (each warp's labels counted into a
block's distinct-label table in shared memory, the table's top two)
against `cuclark_tpu.score.score_labels`, and
`pipeline.classify_step_packed` without labels, which takes the fused
path's plain version on the CPU, against
`cuclark_tpu.pipeline.classify_step_packed` on qs, q4 and s2 tables at k
15 to 32 and read bins 128 to 1024 (paired 2 x 150 bp reads in the 320
bin), with a poly-A read, reads without a valid window and reads of
many labels.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import score as jscore
from cuclark_tpu_torch import codec, hashdb, kernels, pipeline, probe
from tests.test_torch_cuda import FUSED, FUSED_WIDE, fused_case
from tests.test_torch_score import (_key, _key_label, _labels,
                                    _range_labels, _warp_model)

TILE = 128                               # csrc/query.cu kTile
MAX_P = kernels.QUERY_SCORE_MAX_WINDOWS  # kMaxTiles * kTile


def _table_slots(tiles):
    """csrc/query.cu table_slots: a power of two >= twice the windows."""
    n = 1
    while n < 2 * TILE * tiles:
        n <<= 1
    return n


def _top2(keys):
    """The top two of distinct keys (0 for none), as keep_top2 and
    merge_top2 keep them."""
    top = sorted((int(x) for x in keys), reverse=True)[:2]
    return top + [0] * (2 - len(top))


def _epilogue_model(row, layout="qs"):
    """query_score_kernel<LAYOUT, T>'s epilogue, T = ceil(P / TILE).  One
    tile: thread p stores window p's label in lab_s[p] (0 past P), warp
    0 takes lab_s[32 e + lane] as its register e and scores the row as
    score.cu's warp path does.  Wider rows: a block of TILE * T threads
    (qs, q4; a window a thread) or of TILE (s2; thread t holds windows t
    + TILE i), and each 32 consecutive windows are one warp's lanes in
    one step: the lanes of one positive label are grouped
    (__match_any_sync) and the group's size is added once to the block's
    table of _table_slots(T) slots (count_label: the label times
    0x9E3779B1, its top log2(slots) bits, then linear probing).  Then
    (score_table) thread t keeps the top two run keys of slots t, t +
    threads, ..., each warp merges its threads' top two, warp 0 merges
    the warps'; total is the sum of the counts."""
    P = len(row)
    tiles = -(-P // TILE)
    if tiles == 1:
        lab_s = np.zeros(TILE, row.dtype)
        lab_s[:P] = row
        return _warp_model(lab_s)
    threads = TILE if layout == "s2" else TILE * tiles
    slots = _table_slots(tiles)
    bits = slots.bit_length() - 1
    keys = np.zeros(slots, np.int64)
    counts = np.zeros(slots, np.int64)
    lab = np.zeros(TILE * tiles, np.int64)
    lab[:P] = row
    for w in range(0, TILE * tiles, 32):
        lanes = lab[w:w + 32]
        for v in dict.fromkeys(lanes[lanes > 0].tolist()):
            h = ((v * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
            while keys[h] not in (0, v):
                h = (h + 1) & (slots - 1)
            keys[h] = v
            counts[h] += int((lanes == v).sum())
    key = np.where(keys > 0, _key(counts, np.maximum(keys, 0)), 0)
    thread_top = [_top2(key[t::threads]) for t in range(threads)]
    warp_top = [_top2(sum(thread_top[w:w + 32], []))
                for w in range(0, threads, 32)]
    best, second = _top2(sum(warp_top, []))
    best, second = np.uint64(best), np.uint64(second)
    return [int(counts.sum()), int(_key_label(best)),
            int(best >> np.uint64(32)), int(_key_label(second)),
            int(second >> np.uint64(32))]


@pytest.mark.parametrize("P", [1, 2, 31, 32, 33, 64, 98, 114, 121, 122, 127,
                               128, 129, 130, 162, 226, 256, 290, 482, 994,
                               1024])
def test_fused_epilogue_model_matches_jax(P):
    """The epilogue on rows of P <= MAX_P windows (one to eight tiles; the
    blocks of qs and q4, and of s2): random labels with ties and
    all-miss rows, the label-range rows, and rows of P distinct labels
    (more than the warp path's rounds; the table at its fullest)."""
    rng = np.random.default_rng(P)
    distinct = rng.permutation(np.arange(1, 65536, dtype=np.int32))[:P]
    lab = np.concatenate([_labels(P + 1000, 16, P, 6), _range_labels(P, P),
                          distinct[None, :]])
    want = np.asarray(jscore.score_labels(jnp.asarray(lab)))
    for layout in ("qs", "s2"):
        got = np.array([_epilogue_model(row, layout) for row in lab])
        np.testing.assert_array_equal(got, want)


# qs keeps its ids (k-L); q4 and s2 cases are named by their layout
STEP_CASES = [pytest.param("qs", k, L, id=f"{k}-{L}")
              for k, L in FUSED + FUSED_WIDE] + [
    pytest.param(layout, k, L, id=f"{layout}-{k}-{L}")
    for layout in ("q4", "s2") for k, L in FUSED + FUSED_WIDE]


@pytest.mark.parametrize("layout,k,L", STEP_CASES)
def test_classify_step_packed_fused_matches_jax(layout, k, L):
    """classify_step_packed without labels (the fused query and score's
    plain version here) against the JAX step's results, and against the
    port's own query then score; hits come from the qs stash alone, or
    from the second hash choice alone."""
    db, codes = fused_case(k, L, layout)
    p2, vb = codec.pack_codes(codes)
    assert probe.fuses_score(torch.from_numpy(p2), k)
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
    if layout == "qs":
        alone = (torch.zeros_like(main), stash)
    else:
        alone = (torch.from_numpy(db.second_choice_only().view(np.int32)),
                 None)
    only = probe.query_labels_plain(
        torch.from_numpy(p2), torch.from_numpy(vb), *alone, k=k,
        spec=db.spec)
    assert int((only > 0).sum()) > 0


def test_fused_dispatch():
    """Which steps fuse: reads of 1 to MAX_P windows (every bin up to
    1024, paired reads in the 320 bin), on a table of any layout (qs, q4
    and s2 alike), and no wider ones."""
    for L, k, fused in ((128, 15, True), (152, 31, True), (160, 31, True),
                        (144, 17, True), (152, 24, True), (24, 31, False),
                        (32, 31, True), (320, 31, True), (1024, 31, True),
                        (1048, 25, True), (1056, 32, False),
                        (2048, 31, False)):
        p2 = torch.zeros((2, L // 4), dtype=torch.uint8)
        assert probe.fuses_score(p2, k) == fused, (L, k)


def test_fused_kernel_refuses_cpu_and_wide_rows():
    """The kernel's wrapper takes CUDA tensors only, and refuses rows
    wider than MAX_P windows, and a stash passed with a q4 or s2 table,
    before it launches anything."""
    p2 = torch.zeros((2, 38), dtype=torch.uint8)            # P = 122
    vb = torch.zeros((2, 20), dtype=torch.uint8)
    wide = torch.zeros((2, 264), dtype=torch.uint8)         # P = 1,026
    before = dict(kernels.LAUNCHES)
    for layout, words in (("qs", 8), ("q4", 8), ("s2", 6)):
        spec = hashdb.TableSpec(layout=layout, nb_bits=17, slots=2,
                                stash_bits=17 if layout == "qs" else 0)
        main = torch.zeros((1 << 17, words), dtype=torch.int32)
        stash = main if layout == "qs" else None
        with pytest.raises(ValueError, match="CUDA"):
            kernels.query_score(p2, vb, main, stash, k=31, spec=spec)
        with pytest.raises(ValueError, match="P <= 1024"):
            kernels.query_score(wide, vb, main, stash, k=31, spec=spec)
    q4 = hashdb.TableSpec(layout="q4", nb_bits=17)
    main = torch.zeros((1 << 17, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="without one"):
        kernels.query_score(p2, vb, main, main, k=31, spec=q4)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("acc", ["random", "none"])
@pytest.mark.parametrize("part", [None, 0, 1, 3])
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_fused_range_epilogue_matches_jax(layout, part, acc):
    """The fused query and score over one range of rows with an incoming
    label sum (`probe.query_score_part_results`, the last launch of a
    mesh block; its plain version here): the whole table, or part 0 (with
    the qs stash), 1 or 3 of 4 (without it), and acc_in None or labels on
    windows the range misses (a key lives in one range only): random
    ones, and the row's own best label on others (sums that merge with
    the range's hits), against cuclark_tpu.score.score_labels of acc_in
    plus cuclark_tpu.pipeline.probe_part_step's labels; the kernel's
    epilogue model on the same sums agrees, and acc_in is left as it
    was."""
    _check_fused_range(layout, part, acc, 31, 152)


@pytest.mark.parametrize("acc", ["random", "none"])
@pytest.mark.parametrize("part", [None, 0, 3])
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("k,L", [(31, 320), (25, 1048)])
def test_fused_range_epilogue_wide_matches_jax(k, L, layout, part, acc):
    """test_fused_range_epilogue_matches_jax on reads of three tiles
    (joined 2 x 150 bp pairs in the 320 bin, P = 290) and of eight (P =
    1,024, the widest that fuses)."""
    _check_fused_range(layout, part, acc, k, L)


def _check_fused_range(layout, part, acc, k, L):
    db, codes = fused_case(k, L, layout)
    p2, vb = codec.pack_codes(codes)
    main, stash = hashdb.table_to_device(db, "cpu")
    parts = 1 if part is None else 4
    rows = db.nb // parts
    p = part or 0
    with_stash = stash is not None and p == 0
    jlab = jpipeline.probe_part_step(
        jnp.asarray(db.table[:db.nb][p * rows:(p + 1) * rows]),
        jnp.asarray(p2), jnp.asarray(vb), jnp.int32(p * rows), k=k,
        nb_bits=db.nb_bits, slots=db.slots, num_choices=db.num_choices,
        nb_local=rows, layout=layout, seed=db.seed,
        stash_bits=db.stash_bits,
        stash=jnp.asarray(db.table[db.nb:]) if with_stash else None,
        skip_stash=stash is not None and not with_stash)
    jlab = np.asarray(jlab)
    rng = np.random.default_rng(7 + p)
    acc_in = None
    if acc == "random":
        acc_in = rng.integers(1, 65536, size=jlab.shape).astype(np.int32)
        acc_in[rng.random(jlab.shape) < 0.4] = 0
        same = rng.random(jlab.shape) < 0.3      # the row's best label
        acc_in[same] = np.broadcast_to(jlab.max(axis=1)[:, None],
                                       jlab.shape)[same]
        acc_in[jlab > 0] = 0
    total = jlab if acc_in is None else jlab + acc_in
    want = np.asarray(jscore.score_labels(jnp.asarray(total)))
    acc_t = None if acc_in is None else torch.from_numpy(acc_in.copy())
    got = probe.query_score_part_results(
        torch.from_numpy(p2), torch.from_numpy(vb),
        main[p * rows:(p + 1) * rows], stash if with_stash else None,
        bucket_start=p * rows, nb_local=rows, k=k, spec=db.spec,
        acc_in=acc_t)
    np.testing.assert_array_equal(got.numpy(), want)
    if acc_t is not None:
        np.testing.assert_array_equal(acc_t.numpy(), acc_in)
    model = np.array([_epilogue_model(row, layout) for row in total])
    np.testing.assert_array_equal(model, want)
    assert int((jlab > 0).sum()) > 0
