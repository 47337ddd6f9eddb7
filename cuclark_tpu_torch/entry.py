"""Entry points of the port (counterpart of `__graft_entry__.py`).

entry():              the classify step on a synthetic DB, as (fn, args),
                      args on the card.
dryrun_multichip(n):  the sharded classify step on a mesh of n device
                      handles (db sharding x data parallel), the
                      multi-process file path (resident, and streamed
                      under a tiny budget), the host sharding helpers,
                      and shard concatenation then `abundance`, at tiny
                      sizes.

Both run on the card unless the caller passes device="cpu"; without a
card they raise.  On one card, n handles of it stand in for n devices
(`parallel.mesh`); the CPU gives CUCLARK_CPU_DEVICES handles.

    python -m cuclark_tpu_torch.entry [--device cpu] [-n N]

-n defaults to the number of cards (or CPU handles): on one card that is
a 1 x 1 mesh, with no db sharding; `-n 4` runs a 2 x 2 mesh of four
handles of the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           f"torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _toy_db(k=31, n_kmers=4096, n_targets=16, seed=0):
    """The synthetic DB of `__graft_entry__._toy_db`: the same k-mers,
    labels and table."""
    from cuclark_tpu_torch.config import DBConfig
    from cuclark_tpu_torch.hashdb import build_table

    rng = np.random.default_rng(seed)
    km = np.unique(rng.integers(0, 1 << (2 * k - 2), size=n_kmers * 2,
                                dtype=np.uint64))[:n_kmers]
    labels = rng.integers(1, n_targets + 1, size=len(km)).astype(np.uint32)
    names = ["NA"] + [f"T{i}" for i in range(1, n_targets + 1)]
    return build_table(km, labels, names, DBConfig(k=k, slots=8))


def entry(device="cuda"):
    """Returns (fn, args): fn(main, stash, packed2, vbits) -> results
    int32 [64, 5], the classify step without labels (the fused query
    and score on the card) on the toy DB; args are the table's main and
    stash rows and 64 reads of 120 bases (8 bases of padding) in the
    wire format, on `device`."""
    from cuclark_tpu_torch import codec
    from cuclark_tpu_torch.hashdb import table_to_device
    from cuclark_tpu_torch.pipeline import classify_step_packed

    dev = _check_device(device)
    db = _toy_db()
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=(64, 128)).astype(np.uint8)
    codes[:, 120:] = codec.INVALID
    packed2, vbits = codec.pack_codes(codes)
    main, stash = table_to_device(db, dev)

    def fn(main, stash, packed2, vbits):
        results, _ = classify_step_packed(main, packed2, vbits, k=db.k,
                                          spec=db.spec, stash=stash,
                                          with_labels=False)
        return results

    return fn, (main, stash, torch.from_numpy(packed2).to(dev),
                torch.from_numpy(vbits).to(dev))


def _handles(kind: str, n: int) -> list[torch.device]:
    """n device handles of one type: the cards in turn (one card gives n
    handles of itself), or the CPU's CUCLARK_CPU_DEVICES handles, of
    which there must be n."""
    from cuclark_tpu_torch.parallel.mesh import local_devices

    devices = local_devices(kind)
    if kind == "cpu" and len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)} (set "
                         f"CUCLARK_CPU_DEVICES)")
    if not devices:
        raise RuntimeError(f"no {kind} device")
    return [devices[i % len(devices)] for i in range(n)]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded classify step on a mesh of n_devices handles, then the
    multi-process file path on the same handles; raises on any
    mismatch."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from cuclark_tpu_torch.cli import main as cli_main
    from cuclark_tpu_torch.config import ClassifyConfig
    from cuclark_tpu_torch.parallel import multihost
    from cuclark_tpu_torch.parallel.mesh import (ShardedClassifier,
                                                 make_global_mesh, make_mesh)

    devices = _handles(_check_device(device).type, n_devices)
    # db sharding wants nb divisible by the axis; nb is a power of two,
    # so pick power-of-two axis sizes: db gets the larger factor.
    num_db = 1
    while num_db * 2 <= n_devices and n_devices % (num_db * 2) == 0:
        num_db *= 2
    num_data = n_devices // num_db
    if num_data == 1 and num_db > 1:
        num_db //= 2
        num_data = 2

    db = _toy_db(k=27, n_kmers=2048, n_targets=8)
    mesh = make_mesh(num_db=num_db, num_data=num_data, devices=devices)
    clf = ShardedClassifier(db, mesh)

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, size=(8 * num_data, 64)).astype(np.uint8)
    results, labels = clf.classify_codes(codes)
    if results.shape != (8 * num_data, 5) or labels.shape[0] != 8 * num_data:
        raise AssertionError(f"sharded step shapes {results.shape}, "
                             f"{labels.shape}")
    # totals equal the number of positive labels per read
    np.testing.assert_array_equal(results[:, 0], (labels > 0).sum(axis=1))
    # __graft_entry__.py also forces the JAX package's split qs probe on
    # this toy DB and requires the fused probe's results.  The port always
    # passes a qs table as main and stash rows (hashdb.KmerDB.split_tables),
    # so the step above is already the split one.

    # the multi-process path: this process's mesh, its own record block
    # of the file (all of it in one process), resident and streamed
    with tempfile.TemporaryDirectory() as td:
        fq = Path(td) / "r.fq"
        reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=60))
                 for _ in range(10)]
        fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                              for i, s in enumerate(reads)))
        gmesh = make_global_mesh(num_db, devices=devices)
        out = Path(td) / "out.csv"
        nrows = multihost.classify_file_to_csv(
            db, ClassifyConfig(batch_reads=8), fq, out, num_db=num_db,
            mesh=gmesh)
        if nrows != 10 or len(out.read_text().splitlines()) != 11:
            raise AssertionError(f"{nrows} rows written for 10 reads")
        # a tiny budget streams each device's shard in parts on the same
        # mesh; the CSV must not change
        out2 = Path(td) / "out2.csv"
        tiny = db.table.nbytes / 8 / 1e6
        nrows2 = multihost.classify_file_to_csv(
            db, ClassifyConfig(batch_reads=8, stream_group=2,
                               max_table_mb=tiny),
            fq, out2, num_db=num_db, mesh=gmesh)
        if nrows2 != 10 or out2.read_bytes() != out.read_bytes():
            raise AssertionError("the streamed CSV differs from the "
                                 "resident CSV")
        # per-host record sharding helpers stay consistent
        buf = np.frombuffer(fq.read_bytes(), dtype=np.uint8)
        tot = sum(len(multihost.shard_reads_for_host(buf, 2, h)[0])
                  for h in range(2))
        if tot != 10:
            raise AssertionError(f"host shards hold {tot} of 10 reads")

        # classify -> shard concatenation (rank order; one shard in one
        # process, the multi-process recipe) -> abundance
        shards = sorted(Path(td).glob(out.name + ".h*")) or [out]
        cat = Path(td) / "cat.csv"
        with open(cat, "wb") as fo:
            for s in shards:
                fo.write(Path(s).read_bytes())
        cap = io.StringIO()
        with contextlib.redirect_stdout(cap):
            rc = cli_main(["abundance", "-R", str(cat)])
        lines = cap.getvalue().splitlines()
        if rc != 0 or not lines[0].startswith("Name,Count"):
            raise AssertionError(f"abundance rc {rc}: {lines[:1]}")
        if sum(int(li.split(",")[1]) for li in lines[1:]) != 10:
            raise AssertionError("abundance counts do not sum to 10 reads")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-n", type=int, default=None,
                    help="device handles of the dry run [the cards, or "
                         "CUCLARK_CPU_DEVICES; one card: 1, a 1 x 1 mesh]")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", tuple(out.shape))
    from cuclark_tpu_torch.parallel.mesh import local_devices

    n = args.n or len(local_devices(torch.device(args.device).type))
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip({n}) ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
