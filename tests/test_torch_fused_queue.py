"""The queued fused range launch (csrc/query.cu, range_query_score_kernel;
`kernels.query_score_queue`, the route of `kernels.query_score_part` over
a range that the range query takes queued: a streamed batch's last part,
a mesh block's shard-0 launch) against the JAX package on the CPU.

A numpy model of the kernel (W reads of one tile a block, or one read of
2 to 8 tiles a block; acc_in loaded into a slot a window; the windows
with a row in the range queued and drained in any order, q4 and s2
choice 1 in a second round, qs main and stash rows together; one tile
scored a warp a read, wider reads through the block's distinct-label
table) is held against `cuclark_tpu.pipeline.probe_part_step` plus
`cuclark_tpu.score.score_labels` on parts 0, 1 and the last of 4 and of
8, with acc_in none, random labels on the windows the range misses, or
the read's own best label.  Then the launch geometry
(`kernels.queue_geometry`), the route (`kernels.queue_score_windows`,
`kernels.query_score_part`'s launch key) and streamed CSVs against the
JAX CLI's.  Every comparison is exact."""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuclark_tpu import cli as jcli
from cuclark_tpu import pipeline as jpipeline
from cuclark_tpu import score as jscore
from cuclark_tpu_torch import cli, codec, hashdb, kernels, probe
from tests.test_torch_cuda import fused_case
from tests.test_torch_fused import _epilogue_model
from tests.test_torch_score import _warp_model

TILE = kernels.TILE
M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _case(k, L, layout):
    """fused_case's table and reads (48 reads: a poly-A read, a read of
    Ns, one shorter than k, one whose every window is stored, reads with
    stored k-mers planted), cut to 47 reads so that no W of 2 or 4
    divides them: a ragged last block."""
    db, codes = fused_case(k, L, layout)
    return db, codes[:47]


def _windows(codes, k):
    """The canonical k-mer (uint64) and validity of each window, [R, P]."""
    kmers, valid = codec.extract_kmers(torch.from_numpy(codes), k)
    canon = codec.canonical(kmers, k).numpy().view(np.uint64)
    return canon, valid.numpy()


def _qrow_label(rows, local, other, quot, choice):
    """row_label of qs/q4 rows uint32 [n, 8] ([other x4 | meta x4]) at
    local rows `local`: the matching slots' labels summed."""
    r = rows[local].astype(np.int64)
    meta = r[:, 4:]
    m = ((r[:, :4] == other[:, None].astype(np.int64))
         & ((meta >> 17) == quot[:, None].astype(np.int64))
         & (((meta >> 16) & 1) == choice))
    return np.where(m, meta & 0xFFFF, 0).sum(1)


def _s2_row_label(rows, local, lo, hi, S):
    """s2_row_label: rows uint32 [n, 3 S] of [klo x S | khi x S | label x
    S]; the labels of the slots whose two key words match, summed."""
    r = rows[local].astype(np.int64)
    m = (r[:, :S] == lo[:, None]) & (r[:, S:2 * S] == hi[:, None])
    return np.where(m, r[:, 2 * S:], 0).sum(1)


def _entries(km, spec, start, nb_local, stash, sstart):
    """range_entry of each k-mer: (in0, in1, choice-0 label, choice-1
    label), the labels of the rows in the range (0 elsewhere), over the
    part's rows.  The range checks are the kernel's 32-bit ones: b -
    start wraps past every row count when b < start."""
    main, table = spec["main"], spec["spec"]
    hi = (km >> np.uint64(32)).astype(np.uint32)
    lo = (km & np.uint64(M32)).astype(np.uint32)
    mask = (1 << table.nb_bits) - 1
    n = len(km)
    if table.layout == "s2":
        b0 = hashdb.mix1(hi, lo).astype(np.int64) & mask
        b1 = hashdb.mix2(hi, lo).astype(np.int64) & mask
        has1 = (table.num_choices == 2) & (b1 != b0)
        start1, local1 = start, nb_local
    else:
        h1, l2 = hashdb.feistel_mix(hi, lo, table.seed)
        h1, l2 = h1.astype(np.int64), l2.astype(np.int64)
        b0, b1 = l2 & mask, h1 & mask
        has1 = np.ones(n, bool)
        start1, local1 = start, nb_local
        if table.layout == "qs":
            b1 = h1 & ((1 << table.stash_bits) - 1)
            has1 = np.full(n, stash is not None)
            start1 = sstart
            local1 = 0 if stash is None else len(stash)
    in0 = ((b0 - start) & M32) < nb_local
    in1 = has1 & (((b1 - start1) & M32) < local1)
    lab0, lab1 = np.zeros(n, np.int64), np.zeros(n, np.int64)
    i0, i1 = np.flatnonzero(in0), np.flatnonzero(in1)
    if table.layout == "s2":
        S = table.slots
        lo64, hi64 = lo.astype(np.int64), hi.astype(np.int64)
        lab0[i0] = _s2_row_label(main, b0[i0] - start, lo64[i0], hi64[i0], S)
        lab1[i1] = _s2_row_label(main, b1[i1] - start, lo64[i1], hi64[i1], S)
    else:
        lab0[i0] = _qrow_label(main, b0[i0] - start, h1[i0],
                               l2[i0] >> table.nb_bits, 0)
        rows1, bits1 = ((stash, table.stash_bits) if table.layout == "qs"
                        else (main, table.nb_bits))
        lab1[i1] = _qrow_label(rows1, b1[i1] - start1, l2[i1],
                               h1[i1] >> bits1, 1)
    return in0, in1, lab0, lab1


def _queue_kernel_model(codes, k, spec, start, nb_local, stash, sstart,
                        acc_in, W, rng, second_round=True):
    """range_query_score_kernel<LAYOUT, W, T> on the reads codes [R, L]
    over main rows [start, start + nb_local) (spec["main"]: the part's
    rows) and, for qs, the stash rows [sstart, sstart + len(stash)) (None:
    no stash probe) -> results [R, 5].  Per block of G reads (G = W at
    one tile, else 1) of N = G T TILE windows: lab_s takes acc_in (0 past
    P and past R); the valid windows with a row in range are queued,
    their ids in any order (rng); round 1 adds each queued window's label
    (qs: main and stash rows together; q4, s2: choice 0 if in range, else
    choice 1) to its slot; q4 and s2 windows whose choice 0 missed with
    choice 1 in range too go to round 2, in any order; then warp g
    scores read g of one tile (score.cu's warp path on lab_s[g TILE:(g +
    1) TILE]), or the block's distinct-label table scores the read's T
    TILE slots (a block of TILE threads, thread t holding windows t +
    TILE u).  second_round=False cuts round 2 out."""
    R, L = codes.shape
    P = L - k + 1
    T = -(-P // TILE)
    G = W if T == 1 else 1
    km, valid = _windows(codes, k)
    in0, in1, lab0, lab1 = (a.reshape(R, P) for a in _entries(
        km.ravel(), spec, start, nb_local, stash, sstart))
    queued = valid & (in0 | in1)
    qs = spec["spec"].layout == "qs"
    out = np.zeros((R, 5), np.int64)
    for r0 in range(0, R, G):
        lab_s = np.zeros((G, T * TILE), np.int64)
        reads = range(r0, min(R, r0 + G))
        for g, r in enumerate(reads):
            if acc_in is not None:
                lab_s[g, :P] = acc_in[r]
        ids = np.array([(g, p) for g, r in enumerate(reads)
                        for p in np.flatnonzero(queued[r])], np.int64)
        if len(ids):
            ids = ids[rng.permutation(len(ids))]
            g, p = ids[:, 0], ids[:, 1]
            r = r0 + g
            a0, a1 = in0[r, p], in1[r, p]
            if qs:
                lab = np.where(a0, lab0[r, p], 0) + np.where(a1, lab1[r, p],
                                                             0)
                again = np.zeros(len(ids), bool)
            else:
                lab = np.where(a0, lab0[r, p], lab1[r, p])
                again = a0 & a1 & (lab == 0)
            np.add.at(lab_s, (g, p), lab)
            second = np.flatnonzero(again & second_round)
            second = second[rng.permutation(len(second))]
            np.add.at(lab_s, (g[second], p[second]), lab1[r, p][second])
        for g, r in enumerate(reads):
            out[r] = (_warp_model(lab_s[g]) if T == 1
                      else _epilogue_model(lab_s[g], "s2"))
    return out


def _ranges(db, parts):
    """(main rows, stash rows or None, bucket_start, stash_start) of each
    part of `parts`: the qs stash split over the parts as a streamed
    table splits it (`probe.stash_range`)."""
    main, stash = hashdb.table_to_device(db, "cpu")
    rows = db.nb // parts
    out = []
    for p in range(parts):
        s, sstart = probe.stash_range(stash, p, parts)
        out.append((main[p * rows:(p + 1) * rows], s, p * rows, sstart))
    return out


def _jax_part_labels(db, codes, k, main_part, stash, start, sstart):
    """cuclark_tpu.pipeline.probe_part_step's labels of one range (the
    rows as the JAX package holds them, uint32).  Its stash probe reads
    the whole stash, so a qs stash range goes in as the
    whole stash with the rows outside [sstart, sstart + len(stash))
    zeroed (a zero row matches no stash key); None skips the stash."""
    p2, vb = codec.pack_codes(codes)
    rows = main_part.shape[0]
    full = None
    if stash is not None:
        full = np.zeros((1 << db.stash_bits, 8), np.uint32)
        full[sstart:sstart + stash.shape[0]] = stash.numpy().view(np.uint32)
    lab = jpipeline.probe_part_step(
        jnp.asarray(main_part.numpy().view(np.uint32)), jnp.asarray(p2),
        jnp.asarray(vb),
        jnp.int32(start), k=k, nb_bits=db.nb_bits, slots=db.slots,
        num_choices=db.num_choices, nb_local=rows, layout=db.layout,
        seed=db.seed, stash_bits=db.stash_bits,
        stash=None if full is None else jnp.asarray(full),
        skip_stash=db.layout == "qs" and stash is None)
    return np.asarray(lab)


def _acc_in(kind, jlab, seed):
    """acc_in of the launch: None; random labels on windows the range
    misses (a key lives in one range only); or the read's own best label
    on some of them and random ones on others (sums that merge with the
    range's hits)."""
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 65536, size=jlab.shape).astype(np.int32)
    a[rng.random(jlab.shape) < 0.4] = 0
    if kind == "best":
        same = rng.random(jlab.shape) < 0.5
        a[same] = np.broadcast_to(jlab.max(axis=1)[:, None],
                                  jlab.shape)[same]
    a[jlab > 0] = 0
    return a


# (parts, part): parts 0, 1 and the last of 4 and of 8
PARTS = [(4, 0), (4, 1), (4, 3), (8, 0), (8, 1), (8, 7)]


@pytest.mark.parametrize("acc", ["none", "random", "best"])
@pytest.mark.parametrize("parts,part", PARTS)
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("k,L", [(31, 152), (31, 320)], ids=["T1", "T3"])
def test_queue_kernel_model_matches_jax(k, L, layout, parts, part, acc):
    """The model at W 2 and 4 (one tile: 47 reads, a ragged last block),
    two drain orders each, and the plain fused range entry
    (`probe.query_score_part_results`, what the wrapper runs on CPU
    tensors) against cuclark_tpu.score.score_labels of acc_in plus
    cuclark_tpu.pipeline.probe_part_step's labels of the part; acc_in is
    left as it was."""
    db, codes = _case(k, L, layout)
    m, s, start, sstart = _ranges(db, parts)[part]
    jlab = _jax_part_labels(db, codes, k, m, s, start, sstart)
    acc_in = _acc_in(acc, jlab, 7 * parts + part)
    total = jlab if acc_in is None else jlab + acc_in
    want = np.asarray(jscore.score_labels(jnp.asarray(total)))
    spec = {"main": m.numpy().view(np.uint32), "spec": db.spec}
    stash_np = None if s is None else s.numpy().view(np.uint32)
    for W in (2, 4):
        for seed in (0, 1):
            got = _queue_kernel_model(codes, k, spec, start, m.shape[0],
                                      stash_np, sstart, acc_in, W,
                                      np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want, err_msg=f"W={W}")
    p2, vb = (torch.from_numpy(a) for a in codec.pack_codes(codes))
    acc_t = None if acc_in is None else torch.from_numpy(acc_in.copy())
    plain = probe.query_score_part_results(
        p2, vb, m, s, bucket_start=start, nb_local=m.shape[0], k=k,
        spec=db.spec, stash_start=sstart, acc_in=acc_t)
    np.testing.assert_array_equal(plain.numpy(), want)
    if acc_t is not None:
        np.testing.assert_array_equal(acc_t.numpy(), acc_in)
    assert int((jlab > 0).sum()) > 0


@pytest.mark.parametrize("layout", ["q4", "s2"])
def test_queue_model_second_round(layout):
    """On a table that holds only the keys stored at their second hash
    choice, the hits of windows whose two choices both lie in the range
    (shard 0 of 2, paired reads) come from the second round: the whole
    model matches the JAX probe's labels scored, the model with round 2
    cut out does not."""
    k, L = 31, 320
    db, codes = _case(k, L, layout)
    second = db.second_choice_only()
    m = torch.from_numpy(second.view(np.int32))[:db.nb // 2]
    jlab = _jax_part_labels(db, codes, k, m, None, 0, 0)
    want = np.asarray(jscore.score_labels(jnp.asarray(jlab)))
    spec = {"main": m.numpy().view(np.uint32), "spec": db.spec}
    args = (codes, k, spec, 0, m.shape[0], None, 0, None, 2)
    got = _queue_kernel_model(*args, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    cut = _queue_kernel_model(*args, np.random.default_rng(3),
                              second_round=False)
    assert (cut != want).any()
    km, valid = _windows(codes, k)
    in0, in1, lab0, lab1 = _entries(km.ravel(), spec, 0, m.shape[0], None,
                                    0)
    both = valid.ravel() & in0 & in1 & (lab0 == 0) & (lab1 > 0)
    assert int(both.sum()) > 0


@pytest.mark.parametrize("k,L", [(31, 152), (31, 320)], ids=["T1", "T3"])
def test_queue_model_reads_stash_with_main(k, L):
    """qs part 0 of 4 with its share of the stash: a window gathers its
    main and stash rows in one round, and hits from the stash alone
    count (the main rows zeroed)."""
    db, codes = _case(k, L, "qs")
    m, s, start, sstart = _ranges(db, 4)[0]
    zero = torch.zeros_like(m)
    jlab = _jax_part_labels(db, codes, k, zero, s, start, sstart)
    assert int((jlab > 0).sum()) > 0
    want = np.asarray(jscore.score_labels(jnp.asarray(jlab)))
    spec = {"main": zero.numpy().view(np.uint32), "spec": db.spec}
    got = _queue_kernel_model(codes, k, spec, start, m.shape[0],
                              s.numpy().view(np.uint32), sstart, None, 2,
                              np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)


# ---------- the launch geometry ----------


def queue_covered(R, P, g: kernels.QueueGeometry) -> np.ndarray:
    """How often the blocks of g's launch take each read of R, as int
    [R]: block x takes reads x G .. x G + G - 1 below R, each whole (all
    its T tiles: csrc/query.cu range_query_score_kernel)."""
    G = g.reads_per_block
    r = np.arange(g.grid_x)[:, None] * G + np.arange(G)[None, :]
    return np.bincount(r[r < R], minlength=R)


@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("which", ["1", "W-1", "W", "65537"])
def test_queue_geometry_covers_each_read_once(which, W, T):
    """Every read lies in exactly one block, whole, and no block is
    empty: W reads a block of one tile, one read a block of 2 to 8."""
    R = {"1": 1, "W-1": W - 1, "W": W, "65537": 65537}[which]
    for P in (max(1, (T - 1) * TILE + 1), T * TILE):
        g = kernels.queue_geometry(R, P, W)
        assert g.windows == W
        assert g.reads_per_block == (W if T == 1 else 1)
        assert (queue_covered(R, P, g) == 1).all()
        assert (g.grid_x - 1) * g.reads_per_block < R <= (
            g.grid_x * g.reads_per_block)
        assert 1 <= g.grid_x <= 2 ** 31 - 1


# ---------- the route ----------

# By layout and the range's W, the tile counts whose fused range launch
# takes range_query_score_kernel (kernels.QUEUE_SCORE_TILES)
PINNED = {("qs", 4): {1, 3, 4, 8}, ("q4", 2): {1}, ("q4", 4): {1, 3, 4},
          ("s2", 2): set(), ("s2", 4): {1, 2, 3, 4}}


@pytest.mark.parametrize("T", range(1, 9))
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_queue_route_pinned(layout, T):
    """The route of each layout, range W and tile count: the whole table
    and ranges the range query does not queue (qs's 2-shard range) keep
    query_score_kernel (W 1); a range it queues takes the queued launch
    at its W for the pinned tile counts."""
    assert {key: set(t) for key, t in kernels.QUEUE_SCORE_TILES.items()} \
        == PINNED
    nb_bits = 20
    for share, W in ((1, 1), (2, 2), (4, 4), (8, 4)):
        P = T * TILE - 5
        got = kernels.queue_score_windows(nb_bits, (1 << nb_bits) // share,
                                          layout, P)
        rw = kernels.range_windows(nb_bits, (1 << nb_bits) // share, layout)
        assert rw == (W if W >= kernels.RANGE_MIN_WINDOWS[layout] else 1)
        assert got == (rw if T in PINNED.get((layout, rw), ()) else 1)


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
@pytest.mark.parametrize("L", [152, 320, 1048])
def test_query_score_part_counts_its_route(monkeypatch, layout, L):
    """kernels.query_score_part launches with the route's W and counts
    the launch under its key: query_score_queue[_q4|_s2] for the queued
    launch, query_score_part[_q4|_s2] for the fused one; query_score_queue
    launches at the W it is given and counts under the queued key."""
    calls = []

    def launch(*args, windows=1, **kw):
        calls.append(windows)
        return torch.zeros((args[0].shape[0], 5), dtype=torch.int32)

    monkeypatch.setattr(kernels, "_launch_query_score", launch)
    k, nb_bits = 25, 18
    spec = hashdb.TableSpec(layout=layout, nb_bits=nb_bits,
                            stash_bits=17 if layout == "qs" else 0, slots=2)
    p2 = torch.zeros((3, L // 4), dtype=torch.uint8)
    vb = torch.zeros((3, L // 8), dtype=torch.uint8)
    P = L - k + 1
    suffix = "" if layout == "qs" else f"_{layout}"
    for share in (1, 2, 4, 16):
        rows = (1 << nb_bits) // share
        main = torch.zeros((rows, spec.row_words), dtype=torch.int32)
        before = dict(kernels.LAUNCHES)
        kernels.query_score_part(p2, vb, main, None, bucket_start=0, k=k,
                                 spec=spec)
        W = kernels.queue_score_windows(nb_bits, rows, layout, P)
        key = ("query_score_queue" if W > 1 else "query_score_part") + suffix
        assert calls[-1] == W
        assert {n: c - before[n] for n, c in kernels.LAUNCHES.items()
                if c != before[n]} == {key: 1}
    before = dict(kernels.LAUNCHES)
    kernels.query_score_queue(p2, vb, main, None, bucket_start=0, k=k,
                              spec=spec, windows=2)
    assert calls[-1] == 2
    assert kernels.LAUNCHES[f"query_score_queue{suffix}"] == before[
        f"query_score_queue{suffix}"] + 1


def test_queue_entry_refuses_before_launch():
    """The queued launch takes CUDA tensors only and rows of at most
    1,024 windows; nothing is counted when it refuses."""
    spec = hashdb.TableSpec(layout="s2", nb_bits=17, slots=2)
    main = torch.zeros((1 << 15, 6), dtype=torch.int32)
    p2 = torch.zeros((2, 38), dtype=torch.uint8)
    vb = torch.zeros((2, 20), dtype=torch.uint8)
    wide = torch.zeros((2, 264), dtype=torch.uint8)
    before = dict(kernels.LAUNCHES)
    for x, W, match in ((p2, 4, "CUDA"), (p2, 2, "CUDA"),
                        (wide, 4, "P <= 1024")):
        with pytest.raises(ValueError, match=match):
            kernels.query_score_queue(x, vb, main, None, bucket_start=0,
                                      k=31, spec=spec, windows=W)
    assert kernels.LAUNCHES == before


# ---------- streamed CSVs against the JAX CLI ----------


@pytest.fixture(scope="module")
def stream_dbs(tmp_path_factory):
    """Three genomes, 70 single-end reads and 30 pairs (80 + 70 bp mates:
    one tile) and 30 pairs of 150 bp mates from 400 bp fragments (joined
    in the 320 bin: three tiles), with a qs, a q4 and an s2 (2 slots, 2
    choices) database built by each package's CLI."""
    tmp = tmp_path_factory.mktemp("torch_fused_queue")
    rng = random.Random(17)
    genomes, lines = [], []
    for t in (1, 2, 3):
        g = "".join(rng.choice("ACGT") for _ in range(4000))
        genomes.append(g)
        (tmp / f"g{t}.fa").write_text(f">g{t}\n{g}\n")
        lines.append(f"{tmp / f'g{t}.fa'} T{t}")
    (tmp / "targets.txt").write_text("\n".join(lines) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    recs = {n: [] for n in ("reads", "a1", "a2", "b1", "b2")}
    for i in range(70):
        g = genomes[i % 3]
        pos = rng.randrange(0, len(g) - 400)
        seq = list(g[pos:pos + 120])
        for _ in range(rng.randrange(4)):
            seq[rng.randrange(120)] = rng.choice("ACGTN")
        recs["reads"].append((f"r{i}", "".join(seq)))
        if i < 30:
            recs["a1"].append((f"p{i}/1", g[pos:pos + 80]))
            recs["a2"].append((f"p{i}/2", g[pos + 100:pos + 170]))
            frag = g[pos:pos + 400]
            recs["b1"].append((f"q{i}/1", frag[:150]))
            recs["b2"].append((f"q{i}/2", frag[250:].translate(comp)[::-1]))
    for n, rs in recs.items():
        (tmp / f"{n}.fq").write_text("".join(
            f"@{name}\n{s}\n+\n{'I' * len(s)}\n" for name, s in rs))
    flags = {"qs": [], "q4": ["--layout", "q4"],
             "s2": ["--layout", "s2", "--slots", "2", "--choices", "2"]}
    for layout, f in flags.items():
        build = ["build-db", "-T", str(tmp / "targets.txt"), "-k", "25", *f]
        assert jcli.main(build + ["-D", str(tmp / f"j{layout}")]) == 0
        assert cli.main(build + ["-D", str(tmp / f"t{layout}")]) == 0
    return tmp


# chip_smoke.py's streamed part counts
STREAM_PARTS = {"qs": 4, "q4": 4, "s2": 8}


@pytest.mark.parametrize("reads", ["single", "paired", "paired_320"])
@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_streamed_csv_matches_jax_cli(stream_dbs, tmp_path, capsys, layout,
                                      reads):
    """`classify --device cpu --max-table-mb` on the port's database,
    streamed in 4 parts (qs, q4) or 8 (s2), each batch ending in the
    fused range launch's plain version, writes `cuclark-tpu classify`'s
    bytes with the same flags, and the resident run's."""
    tmp = stream_dbs
    db = hashdb.KmerDB.load(next((tmp / f"t{layout}").glob("db_k*.npz")))
    parts = STREAM_PARTS[layout]
    main, stash = db.split_tables()
    stash_mb = 0.0 if stash is None else stash.nbytes / 1e6
    budget = round(stash_mb + 2.4 * main.nbytes / 1e6 / parts, 6)
    inputs = {"single": ["-O", str(tmp / "reads.fq")],
              "paired": ["-P", str(tmp / "a1.fq"), str(tmp / "a2.fq")],
              "paired_320": ["-P", str(tmp / "b1.fq"), str(tmp / "b2.fq")]}
    flags = inputs[reads] + ["-b", "16", "--stream-group", "2"]
    out, jout, res = (tmp_path / n for n in ("t.csv", "j.csv", "r.csv"))
    capsys.readouterr()
    assert cli.main(["classify", "-D", str(tmp / f"t{layout}"), "-R",
                     str(out), "--device", "cpu", "--max-table-mb",
                     str(budget), *flags]) == 0
    assert f"Streaming DB in {parts} bucket-range parts" in (
        capsys.readouterr().err)
    assert jcli.main(["classify", "-D", str(tmp / f"j{layout}"), "-R",
                      str(jout), "--max-table-mb", str(budget),
                      *flags]) == 0
    assert cli.main(["classify", "-D", str(tmp / f"t{layout}"), "-R",
                     str(res), "--device", "cpu", *flags]) == 0
    assert out.read_bytes() == jout.read_bytes() == res.read_bytes()
    assert out.read_bytes().count(b"\n") == (71 if reads == "single"
                                             else 31)
