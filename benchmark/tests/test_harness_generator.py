"""The generator: a seed gives the same inputs, another seed other
inputs of the same sizes, and batches as the port's file path bins."""

import numpy as np
import pytest
import torch
from conftest import tiny

import generator


def make(cell, seed):
    u = generator.make_universe(cell.config, seed, "cpu")
    keys, labels = generator.make_db(u, cell.config)
    return u, keys, labels, generator.make_reads(u, cell.config,
                                                 cell.traffic, seed)


@pytest.mark.parametrize("workload", ["full_se150", "light_pe2x150",
                                      "full_ont_long"])
def test_same_seed_same_inputs(workload):
    cell = tiny(workload)
    seed = 2**33 + 17
    a, b = make(cell, seed), make(cell, seed)
    assert torch.equal(a[0].genomes, b[0].genomes)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    ra, rb = a[3], b[3]
    assert ra.batches == rb.batches
    for x, y in zip(ra.bufs + ra.starts, rb.bufs + rb.starts):
        assert np.array_equal(x, y)
    assert np.array_equal(ra.sources, rb.sources)


@pytest.mark.parametrize("workload", ["full_se150", "light_pe2x150",
                                      "full_ont_long"])
def test_other_seed_same_sizes(workload):
    cell = tiny(workload)
    # a mix with foreign reads too: their count is fixed as well
    cell.traffic = dict(cell.traffic, foreign_share=0.25)
    a, b = make(cell, 5), make(cell, 6)
    assert not torch.equal(a[0].genomes, b[0].genomes)
    ra, rb = a[3], b[3]
    assert not np.array_equal(ra.bufs[0], rb.bufs[0])
    # the same batch shapes and read lengths, in another order
    assert sorted((c, L) for _, c, L in ra.batches) == \
        sorted((c, L) for _, c, L in rb.batches)
    for s, e, s2, e2 in zip(ra.starts, ra.ends, rb.starts, rb.ends):
        assert np.array_equal(np.sort(e - s), np.sort(e2 - s2))
    share = cell.traffic["foreign_share"]
    for r in (ra, rb):
        assert (r.sources == 0).sum() == round(share * r.n_reads)


def test_bins_are_the_ports():
    from cuclark_tpu_torch.pipeline import DEFAULT_LEN_BINS, Classifier

    assert generator.LEN_BINS == DEFAULT_LEN_BINS
    assert generator.MAX_BATCH_CELLS == Classifier.MAX_BATCH_CELLS


def test_plan_batches_holds_the_cap():
    ln = generator.quantiles_gamma(20000, 15000, 13000, 200)
    order, batches = generator.plan_batches(ln, 31, 65536)
    assert sorted(order.tolist()) == list(range(len(ln)))
    i = 0
    for cnt, L in batches:
        part = ln[order[i:i + cnt]]
        assert generator.bin_for(int(part.max()), 31) == L
        assert cnt * L <= generator.MAX_BATCH_CELLS or cnt == 1
        i += cnt
    assert i == len(ln)


def test_gamma_lengths_keep_the_mean_and_leave_out_short_reads():
    ln = generator.quantiles_gamma(40000, 15000, 13000, 200)
    assert ln.min() >= 200 and ln.max() > 100_000
    assert abs(ln.mean() - 15000) < 150
    assert np.array_equal(ln, np.sort(ln))
    assert generator.quantiles_gamma(500, 3000, 4000, 100, 20000).max() \
        <= 20000


def test_specific_kmers_is_the_clark_rule():
    keys = torch.tensor([5, 3, 5, 9, 3, 7, 7], dtype=torch.int64)
    labels = torch.tensor([1, 2, 1, 1, 3, 2, 2], dtype=torch.int32)
    k, lab = generator.specific_kmers(keys, labels)
    assert k.tolist() == [5, 7, 9] and lab.tolist() == [1, 2, 1]


def test_reads_come_from_their_genome():
    """Error-free single reads are substrings of their source genome or
    of its reverse complement."""
    cell = tiny("full_se150")
    cell.traffic = dict(cell.traffic, errors={"sub": 0, "ins": 0, "del": 0},
                        foreign_share=0.25)
    u, _, _, r = make(cell, 11)
    bases = np.frombuffer(generator.BASES, np.uint8)
    for i in range(0, r.n_reads, 97):
        read = r.bufs[0][r.starts[0][i]:r.ends[0][i]].tobytes()
        src = int(r.sources[i])
        rows = [src - 1] if src else range(u.n_db, u.genomes.shape[0])
        hits = False
        for row in rows:
            g = u.genomes[row].numpy()
            fwd = bases[g].tobytes()
            rc = bases[3 - g[::-1]].tobytes()
            hits |= read in fwd or read in rc
        assert hits, i
