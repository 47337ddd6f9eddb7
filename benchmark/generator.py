"""The inputs of a benchmark cell, drawn from the seed on the device.

One general generator serves every configuration and traffic mix: a
configuration file gives the genomes and the database rule, a traffic
file the reads.  Nothing here imports the program under test.

Genomes are 2-bit codes (T=0, G=1, C=2, A=3: the CLARK and Jellyfish
convention that the port and the reference share).  Species are random
base genomes; each in-database strain is its species' base with
`strain_divergence` of its bases substituted, so strains of one species
share k-mers that the CLARK rule takes out of the database.  Foreign
genomes, whose reads the database does not hold, are new strains of the
first species and new species.

The database is every canonical k-mer of the in-database genomes (full
mode), or every `gap`-th non-overlapping k-mer block of each genome
(light mode, the `DBConfig.gap` rule), kept where it occurs in one
genome only: sorted unique int64 keys and 1-based int32 labels.

Reads are drawn at random positions and strands with substitutions,
insertions and deletions, single-end or as pairs of mates from a
fragment of normal length (mate 2 the reverse complement of the
fragment's end, as a FASTQ file holds it); long reads take gamma
lengths.  Every seed draws the same multiset of read
lengths and the same number of foreign reads, in another order, so the
work of a run does not change with the seed.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np
import torch

# code -> ASCII base, the codec's convention (A=3 C=2 G=1 T=0)
BASES = b"TGCA"
# length bins and the cap on padded cells of a batch: the port's
# pipeline.DEFAULT_LEN_BINS and Classifier.MAX_BATCH_CELLS, whose file
# path bins reads the same way
LEN_BINS = (128, 152, 160, 192, 256, 320, 512, 1024, 2048, 4096, 16384)
MAX_BATCH_CELLS = 65536 * 512

# the generator streams of one seed, kept apart so that a traffic mix
# never changes the database
_UNIVERSE, _READS, _ORDER, _SAMPLE = range(4)
_MASK64 = (1 << 64) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one stream of a seed (any
    integer, larger than 32 bits too)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
                   + 1) & _MASK64)
    return g


def np_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & _MASK64, stream])


# ---------- genomes and the database ----------


@dataclasses.dataclass
class Universe:
    """uint8 codes [n_db + n_foreign, genome_bp]; rows [0, n_db) are the
    database's genomes (label = row + 1), the rest foreign."""

    genomes: torch.Tensor
    n_db: int


def _mutate(g: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """A copy of codes g with `rate` of its bases replaced by one of the
    other three."""
    out = g.clone()
    hit = torch.rand(g.shape, generator=gen, device=g.device) < rate
    shift = torch.randint(1, 4, g.shape, generator=gen, device=g.device,
                          dtype=torch.uint8)
    out[hit] = (out[hit] + shift[hit]) % 4
    return out


def make_universe(cfg: dict, seed: int, device) -> Universe:
    gen = generator(seed, _UNIVERSE, device)
    n_db, bp = cfg["genomes"], cfg["genome_bp"]
    per = cfg["strains_per_species"]
    d = cfg["strain_divergence"]
    n_species = -(-n_db // per)
    n_fs, n_fsp = cfg["foreign_strains"], cfg["foreign_species"]
    out = torch.empty((n_db + n_fs + n_fsp, bp), dtype=torch.uint8,
                      device=device)
    row, foreign = 0, n_db
    for s in range(n_species):
        base = torch.randint(0, 4, (bp,), generator=gen, device=device,
                             dtype=torch.uint8)
        for _ in range(min(per, n_db - row)):
            out[row] = _mutate(base, d, gen)
            row += 1
        if s < n_fs:
            out[foreign] = _mutate(base, d, gen)
            foreign += 1
    for _ in range(n_fsp):
        out[foreign] = torch.randint(0, 4, (bp,), generator=gen,
                                     device=device, dtype=torch.uint8)
        foreign += 1
    return Universe(out, n_db)


def fold_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers (int64, k <= 31) of every window of codes
    [..., L] (all valid) -> [..., L - k + 1]: min(forward, reverse
    complement), the first base most significant."""
    c = codes.to(torch.int64)
    P = c.shape[-1] - k + 1
    fwd = torch.zeros(c.shape[:-1] + (P,), dtype=torch.int64,
                      device=c.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | c[..., j:j + P]
        rev = rev | ((3 - c[..., j:j + P]) << (2 * j))
    return torch.minimum(fwd, rev)


def genome_kmers(g: torch.Tensor, k: int, gap: int) -> torch.Tensor:
    """The canonical k-mers one genome contributes: every window (gap 1)
    or every gap-th of its non-overlapping k-mer blocks."""
    if gap == 1:
        return fold_kmers(g, k)
    starts = torch.arange(0, g.shape[0] // k, gap, device=g.device) * k
    blocks = g[starts[:, None] + torch.arange(k, device=g.device)]
    return fold_kmers(blocks, k)[:, 0]


def specific_kmers(keys: torch.Tensor, labels: torch.Tensor):
    """The CLARK rule: of (key, label) occurrences keep each key that
    occurs under one label only -> (sorted unique keys int64, labels
    int32)."""
    keys, order = torch.sort(keys)
    labels = labels[order]
    del order
    n = keys.numel()
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    run = torch.cumsum(start, 0) - 1
    first = labels[start][run]
    mixed = torch.zeros(int(run[-1]) + 1, dtype=torch.uint8,
                        device=keys.device)
    mixed.scatter_reduce_(0, run, (labels != first).to(torch.uint8), "amax")
    keep = mixed == 0
    return keys[start][keep], labels[start][keep].to(torch.int32)


def make_db(universe: Universe, cfg: dict):
    """(sorted unique canonical keys int64, labels int32 1-based) of the
    database's genomes under the CLARK rule."""
    k, gap = cfg["k"], cfg["gap"]
    keys, labels = [], []
    for i in range(universe.n_db):
        km = genome_kmers(universe.genomes[i], k, gap)
        keys.append(km)
        labels.append(torch.full_like(km, i + 1, dtype=torch.int32))
    keys, labels = torch.cat(keys), torch.cat(labels)
    return specific_kmers(keys, labels)


# ---------- reads ----------


def quantiles_gamma(n: int, mean: float, sd: float, lo: int,
                    hi: int | None = None) -> np.ndarray:
    """n lengths at the mid-quantiles of a gamma distribution of `mean`
    and `sd`, the reads under lo (and over hi) left out: the same
    multiset for every seed."""
    from scipy.special import gammainc, gammaincinv

    shape, scale = (mean / sd) ** 2, sd * sd / mean
    plo = gammainc(shape, lo / scale)
    phi = 1.0 if hi is None else gammainc(shape, hi / scale)
    q = plo + (np.arange(n) + 0.5) / n * (phi - plo)
    x = np.round(gammaincinv(shape, q) * scale)
    return np.clip(x, lo, hi).astype(np.int64)


def bin_for(length: int, k: int) -> int:
    """The port's length bin of a read (or joined pair) of `length`
    bases: the smallest bin that holds length + 1, else a multiple of
    128, never under k."""
    for b in LEN_BINS:
        if length + 1 <= b:
            return max(b, k)
    return max(int(math.ceil((length + 1) / 128) * 128), k)


def plan_batches(lengths: np.ndarray, k: int, batch_reads: int):
    """Group reads by length bin, the way a caller that sorts its reads
    by length feeds the port: within a bin of LEN_BINS, runs of up to
    min(batch_reads, MAX_BATCH_CELLS // bin) reads; above the largest
    bin, the reads in length order, each batch as long as its padded
    cells stay under the cap, at the bin of its longest read.  Returns
    (order of read indices, [(count, bin)])."""
    order = np.argsort(lengths, kind="stable")
    srt = lengths[order]
    batches = []
    i, n = 0, len(srt)
    while i < n:
        b = bin_for(int(srt[i]), k)
        if b <= LEN_BINS[-1]:
            j = int(np.searchsorted(srt, b - 1, side="right"))
            cap = min(batch_reads, MAX_BATCH_CELLS // b)
            for lo in range(i, j, cap):
                batches.append((min(cap, j - lo), b))
            i = j
            continue
        j = i + 1
        while (j < n and j - i < batch_reads
               and (j - i + 1) * bin_for(int(srt[j]), k) <= MAX_BATCH_CELLS):
            j += 1
        batches.append((j - i, bin_for(int(srt[j - 1]), k)))
        i = j
    return order, batches


def _draw(genomes, src, start, length, err, gen):
    """Reads of `length` bases (long [n]) from genomes[src] at `start`
    on the + strand with substitutions, insertions and deletions ->
    codes uint8 [n, max(length)] (rows past their length undefined)."""
    n, Lm = src.numel(), int(length.max())
    dev = genomes.device
    ins = torch.rand((n, Lm), generator=gen, device=dev) < err["ins"]
    dele = torch.rand((n, Lm), generator=gen, device=dev) < err["del"]
    pos = (start[:, None] + torch.arange(Lm, device=dev)
           - torch.cumsum(ins, 1) + torch.cumsum(dele, 1))
    pos.clamp_(0, genomes.shape[1] - 1)
    codes = genomes[src[:, None], pos]
    noise = torch.randint(0, 4, (n, Lm), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes = torch.where(ins, noise, codes)
    sub = (torch.rand((n, Lm), generator=gen, device=dev) < err["sub"]) & ~ins
    shift = torch.randint(1, 4, (n, Lm), generator=gen, device=dev,
                          dtype=torch.uint8)
    return torch.where(sub, (codes + shift) % 4, codes)


def _revcomp_rows(codes: torch.Tensor, length: torch.Tensor, flip):
    """Rows `flip` of codes [n, Lm] replaced by the reverse complement of
    their first length bases."""
    Lm = codes.shape[1]
    idx = (length[:, None] - 1 - torch.arange(Lm, device=codes.device))
    rc = 3 - torch.gather(codes, 1, idx.clamp(min=0))
    return torch.where(flip[:, None], rc, codes)


def _flat_ascii(codes: torch.Tensor, length: torch.Tensor) -> np.ndarray:
    """The rows' first length bases back to back, as ASCII on the host."""
    keep = (torch.arange(codes.shape[1], device=codes.device)[None, :]
            < length[:, None])
    lut = torch.tensor(list(BASES), dtype=torch.uint8, device=codes.device)
    return lut[codes.long()][keep].cpu().numpy()


@dataclasses.dataclass
class ReadSet:
    """A pool of reads on the host in batch order: ASCII bases of mate 1
    (single-end reads) back to back in bufs[0] at [starts[0][i],
    ends[0][i]), mate 2 in bufs[1] for pairs; batches are (first read,
    count, bin), and sources the 1-based genome of each read (0 for a
    foreign genome)."""

    bufs: list
    starts: list
    ends: list
    batches: list
    sources: np.ndarray

    @property
    def paired(self) -> bool:
        return len(self.bufs) == 2

    @property
    def n_reads(self) -> int:
        return len(self.sources)


def _sources(n: int, universe: Universe, traffic: dict, seed: int, gen):
    """Genome row of each of n reads: a fixed count of foreign reads at
    random places, the others from the database's genomes by log-normal
    abundance weights whose multiset is fixed and whose order the seed
    draws."""
    dev = universe.genomes.device
    n_db = universe.n_db
    n_for = universe.genomes.shape[0] - n_db
    k_for = int(round(traffic["foreign_share"] * n)) if n_for else 0
    nd = NormalDist()
    w = np.exp(traffic["abundance_sigma"] * np.array(
        [nd.inv_cdf((i + 0.5) / n_db) for i in range(n_db)]))
    w = torch.tensor(w[np_rng(seed, _READS).permutation(n_db)],
                     dtype=torch.float64, device=dev)
    src = torch.multinomial(w, n, replacement=True, generator=gen)
    if k_for:
        where = torch.randperm(n, generator=gen, device=dev)[:k_for]
        src[where] = n_db + torch.randint(0, n_for, (k_for,), generator=gen,
                                          device=dev)
    return src


def make_reads(universe: Universe, cfg: dict, traffic: dict,
               seed: int) -> ReadSet:
    """The cell's pool of reads, drawn on the genomes' device."""
    dev = universe.genomes.device
    gen = generator(seed, _READS, dev)
    rng = np_rng(seed, _ORDER)
    k, bp = cfg["k"], cfg["genome_bp"]
    err = traffic["errors"]
    paired = traffic["kind"] == "paired"
    if traffic["kind"] == "long":
        ln = traffic["length"]
        n = traffic["reads"]
        lengths = quantiles_gamma(n, ln["mean"], ln["sd"], ln["min"],
                                  ln.get("max"))
        lengths = lengths[rng.permutation(n)]
        order, batches = plan_batches(lengths, k, traffic["batch_reads"])
        perm = rng.permutation(len(batches))
        firsts = np.cumsum([0] + [c for c, _ in batches])
        order = np.concatenate([order[firsts[i]:firsts[i] + batches[i][0]]
                                for i in perm])
        batches = [batches[i] for i in perm]
        lengths = lengths[order]
    else:
        B, nb = traffic["batch_reads"], traffic["pool_batches"]
        n = B * nb
        mate = traffic["read_bp"]
        full = 2 * mate + 1 if paired else mate
        lengths = np.full(n, mate, np.int64)
        batches = [(B, bin_for(full, k))] * nb
    src = _sources(n, universe, traffic, seed, gen)
    sources = torch.where(src < universe.n_db, src + 1, 0).cpu().numpy()
    mates = [[] for _ in range(2 if paired else 1)]
    length_t = torch.from_numpy(lengths).to(dev)
    # a long-read batch at a time, else chunks of 2^18 reads, so that
    # the [reads, length] draws stay near 2^26 cells
    firsts = np.cumsum([0] + [c for c, _ in batches])
    if traffic["kind"] == "long":
        chunks = [(int(a), int(b)) for a, b in zip(firsts[:-1], firsts[1:])]
    else:
        chunks = [(lo, min(n, lo + (1 << 18))) for lo in range(0, n, 1 << 18)]
    for lo, hi in chunks:
        s, ln = src[lo:hi], length_t[lo:hi]
        m = hi - lo
        flip = torch.rand(m, generator=gen, device=dev) < 0.5
        if paired:
            fr = traffic["fragment"]
            flen = (torch.randn(m, generator=gen, device=dev,
                                dtype=torch.float64) * fr["sd"]
                    + fr["mean"]).round().long().clamp(mate, bp // 2)
            start = (torch.rand(m, generator=gen, device=dev,
                                dtype=torch.float64)
                     * (bp - flen - 64)).long()
            a = _draw(universe.genomes, s, start, ln, err, gen)
            b = _draw(universe.genomes, s, start + flen - ln, ln, err, gen)
            b = _revcomp_rows(b, ln, torch.ones_like(flip))
            m1 = torch.where(flip[:, None], b, a)
            m2 = torch.where(flip[:, None], a, b)
            mates[0].append(_flat_ascii(m1, ln))
            mates[1].append(_flat_ascii(m2, ln))
        else:
            room = bp - ln - (ln // 16 + 64)
            start = (torch.rand(m, generator=gen, device=dev,
                                dtype=torch.float64) * room).long()
            r = _revcomp_rows(_draw(universe.genomes, s, start, ln, err,
                                    gen), ln, flip)
            mates[0].append(_flat_ascii(r, ln))
    ends = np.cumsum(lengths)
    starts = ends - lengths
    bufs = [np.concatenate(x) for x in mates]
    return ReadSet(bufs, [starts] * len(bufs), [ends] * len(bufs),
                   [(int(f), c, b) for f, (c, b) in zip(firsts, batches)],
                   sources)


def sample_batches(n_batches: int, share: float, seed: int,
                   must=()) -> list[int]:
    """The pool batches the check compares, drawn from the seed: a share
    of them, with `must` among them."""
    rng = np_rng(seed, _SAMPLE)
    want = max(1, int(round(share * n_batches)))
    pick = set(int(i) for i in must)
    for i in rng.permutation(n_batches):
        if len(pick) >= want:
            break
        pick.add(int(i))
    return sorted(pick)
