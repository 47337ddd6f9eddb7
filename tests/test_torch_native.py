"""The port's native host module (`cuclark_tpu_torch.native`) builds from
the port's own copy of `host_ops.cpp`, under `cuclark_tpu_torch/csrc/`,
and gives the JAX package's native module's outputs on the CPU."""

from pathlib import Path

import numpy as np
import pytest

from cuclark_tpu import native as jnative
from cuclark_tpu_torch import native

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cuclark_tpu_torch"


def _function(src: str, name: str) -> str:
    """The text of C function `name` in src: its signature line to the
    first line that is a lone closing brace."""
    start = src.index(f"int64_t {name}(")
    return src[start:src.index("\n}\n", start) + 3]


def test_source_is_the_ports_own_copy():
    """native._SRC lies in the port's package and is the port's own copy
    (it holds the parallel scan the JAX package's lacks); the JAX
    package's scan_fastq and scan_fasta, the plain versions the parallel
    scan is held to, stand in it verbatim."""
    assert native._SRC.resolve().is_relative_to(PKG.resolve())
    assert native._SRC == PKG / "csrc" / "host_ops.cpp"
    mine = native._SRC.read_text()
    jax_src = (ROOT / "csrc" / "host_ops.cpp").read_text()
    assert mine != jax_src
    assert "scan_fastq_par" in mine and "scan_fastq_par" not in jax_src
    for name in ("scan_fastq", "scan_fasta"):
        body = _function(jax_src, name)
        assert body.count("\n") > 20
        assert body in mine, name


def _reads(rng, n):
    recs = []
    for i in range(n):
        ln = int(rng.integers(20, 90))
        seq = "".join(rng.choice(list("ACGTN"), size=ln))
        recs.append(f"@r{i} x\n{seq}\n+\n{'I' * len(seq)}\n")
    return np.frombuffer("".join(recs).encode(), np.uint8)


@pytest.mark.skipif(not jnative.available(), reason="no C++ toolchain")
def test_builds_from_its_copy_and_matches_jax(tmp_path, monkeypatch):
    """A fresh build into an empty cache compiles the port's copy (the
    library's name carries a hash of that source), loads, and scans,
    packs and extracts k-mers as the JAX package's native module does."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("CUCLARK_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()
    built = list((tmp_path / "cuclark_tpu_torch" / "native").glob("*.so"))
    assert len(built) == 1
    buf = _reads(np.random.default_rng(5), 40)
    got, want = native.scan(buf), jnative.scan(buf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, _, s, e = got
    for g, w in zip(native.pack_block2(buf, s, e, 96),
                    jnative.pack_block2(buf, s, e, 96)):
        np.testing.assert_array_equal(g, w)
    seq = buf[s[3]:e[3]].tobytes()
    np.testing.assert_array_equal(native.extract_canonical(seq, 15),
                                  jnative.extract_canonical(seq, 15))
