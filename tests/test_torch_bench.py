"""The port's benchmark and entry points against the JAX package's on the
CPU: `bench_torch.py` against `bench.py` at the same tiny knobs (every
key of bench.py's `detail`, block by block, and every field that does
not time anything, equal), `scripts/torch_bench_build_scale.py` against
`scripts/bench_build_scale.py`, `cuclark_tpu_torch.entry` against
`__graft_entry__.py`, and that none of them imports JAX or runs without
a card unless asked for the CPU."""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "scripts"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import bench  # noqa: E402
import bench_build_scale  # noqa: E402
import bench_torch  # noqa: E402
import torch_profile_e2e  # noqa: E402
from cuclark_tpu_torch import entry  # noqa: E402

# bench.py's blocks at a size the CPU runs in seconds; the build probe is
# held apart (test_build_scale_matches_jax)
TINY = {"READS": 2048, "CHUNK": 1024, "KMERS": 20000, "SCALE_KMERS": 50000,
        "4G_KMERS": 80000, "E2E_READS": 4096, "ACC_READS": 2000,
        "PAIRED_READS": 2048, "LIGHT_KMERS": 20000, "BUILD_MB": 0,
        "REPS": 1, "CACHE": 0}
TINY_ENV = {f"CUCLARK_BENCH_{k}": str(v) for k, v in TINY.items()}
BUILD = (2, 16)  # Mbases, occurrence budget MB: the spill path runs

# In a process where `import jax` and `import cuclark_tpu` fail: the port's
# bench on the CPU, its build probe, and its entry step, as one JSON line
_NOJAX_MAIN = """
import contextlib, io, json, sys
sys.modules['jax'] = None
sys.modules['cuclark_tpu'] = None
sys.path[:0] = [{root!r}, {scripts!r}]
import bench_torch, torch_bench_build_scale, torch_profile_e2e
from cuclark_tpu_torch import entry
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = bench_torch.main(['--device', 'cpu'])
assert rc == 0, rc
fn, args = entry.entry('cpu')
bad = [m for m in sys.modules if m.startswith(('jax.', 'cuclark_tpu.'))]
assert not bad, bad
print(json.dumps({{'bench': json.loads(out.getvalue().splitlines()[-1]),
                  'build': torch_bench_build_scale.run(*{build!r}),
                  'entry': fn(*args).tolist()}}))
"""


@pytest.fixture(scope="module")
def port():
    """bench_torch, the build probe and entry() in one jax-free process."""
    import os

    env = dict(os.environ, **TINY_ENV)
    env.pop("CUCLARK_BENCH_DEVICE", None)
    code = _NOJAX_MAIN.format(root=str(ROOT), scripts=str(ROOT / "scripts"),
                              build=BUILD)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's JSON line with JAX on the CPU, at the same knobs."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY_ENV.items():
            mp.setenv(k, v)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


# The port's names for bench.py keys it renames: the link of the scaling
# model is the H100's NVLink, not the TPU's ICI.
RENAMED = {"assumed_ici_gb_per_s": "assumed_link_gb_per_s"}

# Per block, the fields that time nothing and so must be equal.
# `split_probe` is left out: the JAX package passes a qs table of under
# 256 MB of main rows as one fused table (KmerDB.SPLIT_MIN_MAIN_MB), the
# port always as main and stash rows (ROADMAP "Not to port"), so at these
# sizes JAX says False and the port True.  For the same reason
# `stream_parts` of stream_ratio may differ below 256 MB of main rows:
# the two packages plan their parts on different rows.
TABLE = ("db_kmers", "nb_bits", "stash_bits", "table_mb")
EQUAL = {
    None: TABLE + ("read_len", "n_reads", "n_targets", "layout"),
    "small": TABLE + ("n_targets",),
    "scale4g": TABLE + ("n_targets",),
    "accuracy": ("n_reads", "sub_rate", "indel_rate", "db_kmers", "recall",
                 "precision", "unclassified", "min_target_recall"),
    "light_paired": ("k", "gap", "db_kmers", "table_mb"),
    "host_pipeline": ("n_reads", "native"),
    "scaling_model": ("psum_payload_mb_per_chunk",),
    "e2e_scale": (),
    "e2e_small": (),
    "stream_ratio": (),
    "mesh_e2e": (),
}


@pytest.mark.parametrize("block", list(EQUAL), ids=lambda b: b or "top")
def test_bench_block_matches_jax(port, jax_bench, block):
    """Each block of bench_torch's detail has every key of bench.py's
    block, and the same value wherever the value times nothing."""
    mine, ref = port["bench"]["detail"], jax_bench["detail"]
    if block is not None:
        assert block in ref, f"bench.py has no block {block}"
        mine, ref = mine[block], ref[block]
    missing = [k for k in ref if RENAMED.get(k, k) not in mine]
    assert not missing, f"keys of bench.py missing: {missing}"
    for key in EQUAL[block]:
        assert mine[key] == ref[key], (block, key, mine[key], ref[key])


def test_bench_line_matches_jax(port, jax_bench):
    """The line's own keys and the port's exactness checks."""
    line = port["bench"]
    assert set(jax_bench) <= set(line)
    assert line["metric"] == "reads_per_sec" and line["unit"] == "reads/s"
    assert line["detail"]["device"]["name"] == "cpu"
    assert line["detail"]["exact"] == {
        "at-scale_step_vs_plain": True, "small_step_vs_plain": True,
        "stream_csv_eq_resident": True, "mesh_csv_eq_e2e_scale": True,
        "light_paired_step_vs_plain": True, "scale4g_step_vs_plain": True}
    # the reads are bench.py's: the same miss path at every table
    for blk in (line["detail"], line["detail"]["small"],
                line["detail"]["scale4g"]):
        assert blk["hit_share"] == 0.0


@pytest.mark.parametrize("block", [None, "small", "scale4g", "light_paired"],
                         ids=lambda b: b or "top")
def test_bench_planted_hits(port, block):
    """Each device-step block's exactness check ran on a chunk whose every
    read hits a k-mer stored in the upper half and the last rows of the
    table's main rows."""
    d = port["bench"]["detail"]
    blk = d if block is None else d[block]
    planted = blk["planted"]
    assert planted["reads"] == TINY["CHUNK"]
    assert planted["hit_reads"] == planted["reads"]
    nb = planted["last_byte"] // planted["row_bytes"]
    assert planted["main_rows"] == [[nb // 2, nb // 2 + 1024],
                                    [nb - 1024, nb]]
    assert planted["first_byte"] == nb // 2 * planted["row_bytes"]
    if block != "light_paired":
        assert nb == 1 << blk["nb_bits"]


@pytest.mark.parametrize("layout", ["qs", "q4", "s2"])
def test_items_of_row_ranges(layout):
    """KmerDB.items over row ranges that cut the table gives items() in
    order, and each range's pairs probe to their labels."""
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.hashdb import build_table

    rng = np.random.default_rng(4)
    km = np.unique(rng.integers(0, 1 << 60, size=5000, dtype=np.uint64))
    labels = rng.integers(1, 9, size=len(km)).astype(np.uint32)
    extra = {"s2": dict(slots=4, num_choices=2)}.get(layout, {})
    db = build_table(km, labels, ["NA"] + [f"T{i}" for i in range(1, 9)],
                     DBConfig(k=31, layout=layout, **extra))
    cuts = [0, 1, db.total_rows // 3, db.nb, db.total_rows]
    parts = [db.items(rows=(a, b)) for a, b in zip(cuts, cuts[1:])]
    whole = db.items()
    for got, want in zip((np.concatenate([p[i] for p in parts])
                          for i in range(2)), whole):
        np.testing.assert_array_equal(got, want)
    for kms, labs in parts[1:]:
        np.testing.assert_array_equal(db.probe_np(kms), labs)
    with pytest.raises(ValueError, match="outside"):
        db.items(rows=(0, db.total_rows + 1))


def test_build_scale_matches_jax(port):
    """The spill-path build probe builds the JAX script's table."""
    ref = bench_build_scale.run(*BUILD)
    mine = port["build"]
    assert set(ref) == set(mine)
    assert mine["spilled"] is True
    for key in ("occurrences_m", "ram_budget_mb", "spilled", "db_kmers",
                "table_mb", "rss_target_gb"):
        assert mine[key] == ref[key], key


def test_entry_matches_graft_entry(port):
    """entry()'s fn on the CPU gives the JAX entry's jitted results, bit
    for bit, on the same toy DB and reads."""
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = entry.entry("cpu")
    got = fn(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.array(port["entry"]), want)
    # those random reads miss the toy table; reads that start with its
    # canonical k-mers hit it, through both functions alike
    import jax.numpy as jnp

    from cuclark_tpu_torch import codec

    km = entry._toy_db().items()[0].astype(np.uint64)
    km = km[codec.canonical_np(km, 31) == km][:64]
    codes = np.random.default_rng(3).integers(0, 4, size=(64, 128)).astype(
        np.uint8)
    shifts = np.uint64(2) * np.arange(30, -1, -1, dtype=np.uint64)
    codes[:, :31] = (km[:, None] >> shifts) & np.uint64(3)
    p2, vb = codec.pack_codes(codes)
    want = np.asarray(jax.jit(jfn)(jargs[0], jnp.asarray(p2),
                                   jnp.asarray(vb)))
    got = fn(args[0], args[1], torch.from_numpy(p2), torch.from_numpy(vb))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] > 0).all()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_handles(n, monkeypatch):
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", str(n))
    entry.dryrun_multichip(n, device="cpu")


def test_entry_main_on_cpu_handles(monkeypatch, capsys):
    """`python -m cuclark_tpu_torch.entry --device cpu -n 2`: the entry
    step, then the dry run on two handles."""
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", "2")
    assert entry.main(["--device", "cpu", "-n", "2"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "entry ok: (64, 5)", "dryrun_multichip(2) ok"]


def test_dryrun_multichip_needs_the_handles(monkeypatch):
    monkeypatch.setenv("CUCLARK_CPU_DEVICES", "2")
    with pytest.raises(ValueError, match="need 4 devices"):
        entry.dryrun_multichip(4, device="cpu")


@pytest.mark.parametrize("run", [
    lambda: bench_torch.main([]),
    lambda: torch_profile_e2e.main([]),
    lambda: entry.entry(),
    lambda: entry.dryrun_multichip(1),
], ids=["bench_torch", "torch_profile_e2e", "entry", "dryrun_multichip"])
def test_no_card_no_fallback(run, monkeypatch, capsys):
    """Without a card and without a request for the CPU each entry point
    refuses: the scripts exit 2 and print no result, the functions
    raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CUCLARK_BENCH_DEVICE", raising=False)
    try:
        rc = run()
    except RuntimeError as e:
        assert "is_available" in str(e)
    else:
        assert rc == 2
        assert capsys.readouterr().out == ""
