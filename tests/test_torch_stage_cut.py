"""`scripts/torch_stage_cut.py`'s cut copies of `csrc/query.cu`, and the
row list of the qs gather ceiling (`scripts/torch_measure.py`).

A cut replaces the lines of its marked regions and nothing else, and a
cut whose region is missing raises, so a cut never times the tree's own
kernel.  The qs ceiling's (main bucket, stash bucket) list in window
order equals a numpy reckoning through the JAX package's `feistel_mix`
and `canonical_np`."""

import dataclasses
import difflib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuclark_tpu import codec as jcodec
from cuclark_tpu import hashdb as jhashdb
from cuclark_tpu_torch import kernels
from cuclark_tpu_torch.hashdb import TableSpec

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_measure as tm  # noqa: E402
import torch_stage_cut as sc  # noqa: E402

QUERY_CU = (ROOT / "cuclark_tpu_torch" / "csrc" / "query.cu").read_text()
# the cuts that edit query.cu (cold_stash times the tree's own build)
EDITS = sorted(c for c, cut in sc.CUTS.items() if cut.edits)


def _changed_lines(old: str, new: str) -> set:
    """0-based lines of `old` that a line diff to `new` replaces, deletes
    or inserts beside."""
    sm = difflib.SequenceMatcher(a=old.splitlines(), b=new.splitlines(),
                                 autojunk=False)
    out = set()
    for op, i1, i2, _, _ in sm.get_opcodes():
        if op != "equal":
            out.update(range(i1, max(i2, i1 + 1) if op == "insert"
                             else i2))
    return out


@pytest.mark.parametrize("name", EDITS)
def test_cut_changes_exactly_its_marked_lines(name):
    cut = sc.CUTS[name]
    spans = sc.regions(QUERY_CU)
    cut_src = sc.apply_cut(QUERY_CU, cut)
    marked = set()
    for tag in cut.edits:
        start, end = spans[tag]
        marked.update(range(start, end))
    changed = _changed_lines(QUERY_CU, cut_src)
    assert changed, f"{name} left query.cu as it is"
    assert changed <= marked, (f"{name} changed unmarked lines "
                               f"{sorted(changed - marked)[:5]}")
    # every region of the cut differs from the tree
    for tag in cut.edits:
        start, end = spans[tag]
        assert changed & set(range(start, end)), tag
    # the cut's own markers stay (a region nested in one it replaces goes)
    assert set(cut.edits) <= sc.regions(cut_src).keys()


@pytest.mark.parametrize("name", EDITS)
@pytest.mark.parametrize("which", ["begin", "end", "both"])
def test_cut_with_missing_marker_raises(name, which):
    tag = next(iter(sc.CUTS[name].edits))
    src = QUERY_CU
    for end in (("begin", "end") if which == "both" else (which,)):
        line = next(ln for ln in src.splitlines()
                    if ln.strip() == f"// cut {tag} {end}")
        src = src.replace(line + "\n", "", 1)
    with pytest.raises(ValueError):
        sc.apply_cut(src, sc.CUTS[name])


def test_only_cold_stash_times_the_tree():
    """Every cut but cold_stash edits query.cu; cold_stash, which edits
    nothing, is the one cut whose launches take several stash copies."""
    assert set(sc.CUTS) - set(EDITS) == {"cold_stash"}
    assert sc.CUTS["cold_stash"].stash_copies == sc.COLD_COPIES >= 4
    assert all(sc.CUTS[c].stash_copies == 1 for c in EDITS)
    assert sc.apply_cut(QUERY_CU, sc.CUTS["cold_stash"]) == QUERY_CU


@pytest.mark.parametrize("copies", [1, 2, 8])
def test_stash_pointers_rotate_over_the_copies(copies):
    nbs = 16
    stash = torch.arange(copies * nbs * 8, dtype=torch.int32).reshape(-1, 8)
    ptrs = sc.stash_pointers(stash, copies)
    got = [next(ptrs) for _ in range(3 * copies + 1)]
    step = nbs * 8 * 4
    want = [stash.data_ptr() + step * (i % copies)
            for i in range(3 * copies + 1)]
    assert got == want
    # each address starts a whole copy, equal to the first
    for p in set(got):
        i = (p - stash.data_ptr()) // (8 * 4)
        assert torch.equal(stash[i:i + nbs] - stash[i, 0],
                           stash[:nbs] - stash[0, 0])
    assert next(sc.stash_pointers(None, copies)) is None


def test_regions_reject_bad_markers():
    with pytest.raises(ValueError):
        sc.regions("// cut a begin\nx\n// cut a begin\n// cut a end\n")
    with pytest.raises(ValueError):
        sc.regions("x\n// cut a end\n")
    with pytest.raises(ValueError):
        sc.apply_cut("// cut a begin\n// cut b begin\nx\n// cut a end\n"
                     "// cut b end\n",
                     sc.Cut("overlap", {"a": "y", "b": "z"}))


def test_cut_indents_as_its_marker():
    src = "int f() {\n    // cut a begin\n    return 1;\n    // cut a end\n}\n"
    out = sc.apply_cut(src, sc.Cut("t", {"a": "int x = 2;\nreturn x;"}))
    assert out == ("int f() {\n    // cut a begin\n    int x = 2;\n"
                   "    return x;\n    // cut a end\n}\n")
    assert sc.apply_cut(src, sc.Cut("t", {"a": ""})) == (
        "int f() {\n    // cut a begin\n    // cut a end\n}\n")


def test_write_cut_copies_the_other_sources(tmp_path):
    d = sc.write_cut("no_stash", tmp_path)
    assert (d / "query.cu").read_text() == sc.apply_cut(
        QUERY_CU, sc.CUTS["no_stash"])
    for f in kernels.SOURCES + kernels.HEADERS:
        assert (d / f).is_file()
        if f != "query.cu":
            assert (d / f).read_bytes() == (kernels._CSRC / f).read_bytes()


def test_no_package_module_routes_to_a_cut():
    """Only the script builds and calls cut copies: no module of the
    package, nor chip_smoke.py or bench_torch.py, imports it or names a
    cut's directory or library."""
    pat = re.compile(r"import torch_stage_cut|from torch_stage_cut|"
                     r"stage_cut/|stage_cut\"|libcut|apply_cut|write_cut|"
                     r"build_cut")
    pkg = ROOT / "cuclark_tpu_torch"
    files = [*pkg.rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "bench_torch.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("k,nb_bits,stash_bits,seed", [
    (31, 17, 17, 0), (27, 20, 18, 7), (32, 25, 20, 12345), (15, 17, 17, 3)])
def test_qs_window_rows_match_reference(k, nb_bits, stash_bits, seed):
    rng = np.random.default_rng(k + nb_bits)
    R, L = 64, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.01] = jcodec.INVALID
    codes[5, 100:] = jcodec.INVALID
    codes[6, :] = jcodec.INVALID
    spec = TableSpec("qs", nb_bits, stash_bits, seed)
    got = tm.qs_window_rows(torch.from_numpy(codes), spec, k).numpy()
    # numpy: every valid window of every read, in window order
    want = []
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    for r in range(R):
        for p in range(L - k + 1):
            w = codes[r, p:p + k]
            if (w >= 4).any():
                continue
            want.append((w.astype(np.uint64) << shifts).sum(
                dtype=np.uint64))
    km = jcodec.canonical_np(np.array(want, np.uint64), k)
    hi = (km >> np.uint64(32)).astype(np.uint32)
    lo = (km & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h1, l2 = jhashdb.feistel_mix(hi, lo, seed)
    ref = np.stack([l2 & np.uint32((1 << nb_bits) - 1),
                    h1 & np.uint32((1 << stash_bits) - 1)], 1)
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref.astype(np.int32))


def test_qs_window_rows_follow_the_stash_rule():
    """With the table's main rows, a window keeps its stash bucket only
    where its main row gives label 0 and is full (or, in a sampled
    table, empty): the rows the query reads, as a numpy reckoning on the
    JAX package's table."""
    from cuclark_tpu.config import DBConfig as JDBConfig

    k = 31
    rng = np.random.default_rng(3)
    km = rng.integers(0, 1 << 62, size=610_000, dtype=np.uint64)
    km = np.unique(jcodec.canonical_np(km, k))[:600_000]
    labels = rng.integers(1, 200, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, 200)]
    jdb = jhashdb.build_table(km, labels, names, JDBConfig(k=k), nb_bits=17)
    R, L = 256, 152
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    for r in range(0, R, 2):
        v = km[rng.integers(len(km))]
        codes[r, :k] = (v >> shifts) & np.uint64(3)
    spec = TableSpec("qs", jdb.nb_bits, jdb.stash_bits, jdb.seed)
    main = torch.from_numpy(jdb.table[:jdb.nb].view(np.int32))
    got = tm.qs_window_rows(torch.from_numpy(codes), spec, k, main).numpy()
    both = tm.qs_window_rows(torch.from_numpy(codes), spec, k).numpy()
    np.testing.assert_array_equal(got[:, 0], both[:, 0])
    kmers = np.array([(codes[r, p:p + k].astype(np.uint64) << shifts).sum(
        dtype=np.uint64) for r in range(R) for p in range(L - k + 1)])
    kmers = jcodec.canonical_np(kmers, k)
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h1, l2 = jhashdb.feistel_mix(hi, lo, jdb.seed)
    rows = jdb.table[(l2 & np.uint32(jdb.nb - 1)).astype(np.int64)]
    meta = rows[:, 4:]
    used = ((meta & np.uint32(0xFFFF)) != 0).sum(1)
    hit0 = ((rows[:, :4] == h1[:, None])
            & ((meta >> np.uint32(17))
               == (l2 >> np.uint32(jdb.nb_bits))[:, None])
            & (((meta >> np.uint32(16)) & np.uint32(1)) == 0)).any(1)
    keep = ~hit0 & (used == 4)
    np.testing.assert_array_equal(got[:, 1], np.where(keep, both[:, 1], -1))
    assert 0 < keep.sum() < len(keep) and hit0.sum() >= R // 4
    # a sampled table reads the stash behind empty main rows too
    sampled = dataclasses.replace(spec, sampled=True)
    got_s = tm.qs_window_rows(torch.from_numpy(codes), sampled, k,
                              main).numpy()
    keep_s = ~hit0 & ((used == 4) | (used == 0))
    np.testing.assert_array_equal(got_s[:, 1],
                                  np.where(keep_s, both[:, 1], -1))
    assert keep_s.sum() > keep.sum()
    # the bytes bound counts those stash rows once (every window's
    # without the table, as a range call reads them)
    for m, rows in ((main, got), (None, both)):
        t_main, t_stash = tm.touched_rows(torch.from_numpy(codes), spec, k, m)
        np.testing.assert_array_equal(t_main.numpy(), np.unique(rows[:, 0]))
        np.testing.assert_array_equal(
            t_stash.numpy(), np.unique(rows[rows[:, 1] >= 0, 1]))
