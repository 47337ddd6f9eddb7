"""Build, load and launch the hand-written Hopper kernels.

The CUDA C++ sources in `csrc/` (`query.cu`, `score.cu`) have a plain C
interface.  At first use they are compiled with nvcc for `sm_90a` into
one shared library under `build/cuclark_tpu_torch/` at the repository
root, named by a hash of the sources and the flags (as `native.py` keys
its host library), and loaded with ctypes.  Nothing is built when the
module is imported, so the CPU tests import it without nvcc.

Each launch function takes CUDA tensors, checks them, launches on
PyTorch's current stream, raises if the launch reports an error, and
adds one to its entry of `LAUNCHES`.  The callers are the wrappers
`probe.query_labels` and `score.score_labels`, which take the plain
PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("query.cu", "score.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuclark_tpu_torch"

# Largest label row the score kernel sorts in shared memory (128 KB).
MAX_SCORE_WINDOWS = 32768

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"query": 0, "score": 0}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (_CSRC / name).read_bytes())
    return BUILD_DIR / f"libcuclark_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build the kernels' library if needed, load it once, and bind the
    C functions' argument types."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # per-process temp name, then an atomic rename: concurrent
            # first builds never publish a half-written library
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(_CSRC / s) for s in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_uint32)
        lib.cuclark_query.restype = i32
        lib.cuclark_query.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                      i32, i32, i32, u32, u32, u32, vp]
        lib.cuclark_score.restype = i32
        lib.cuclark_score.argtypes = [vp, vp, i64, i32, vp]
        _LIB = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def query(packed2: torch.Tensor, vbits: torch.Tensor, main: torch.Tensor,
          stash: torch.Tensor, *, k: int, nb_bits: int, stash_bits: int,
          consts: tuple[int, int, int]) -> torch.Tensor:
    """Launch the query kernel (csrc/query.cu) -> labels int32 [R, P]."""
    dev = packed2.device
    if dev.type != "cuda":
        raise ValueError(f"query kernel needs CUDA tensors, got {dev}")
    _check(packed2, "packed2", torch.uint8, dev)
    _check(vbits, "vbits", torch.uint8, dev)
    _check(main, "main", torch.int32, dev)
    _check(stash, "stash", torch.int32, dev)
    R, s2 = packed2.shape
    s8 = vbits.shape[1]
    L = 4 * s2
    if vbits.shape[0] != R or 8 * s8 < L:
        raise ValueError(f"vbits {tuple(vbits.shape)} does not cover "
                         f"packed2 {tuple(packed2.shape)}")
    if not 2 <= k <= 32 or L < k:
        raise ValueError(f"padded read length {L} < k={k} or k out of range")
    if main.shape != (1 << nb_bits, 8) or stash.shape != (1 << stash_bits, 8):
        raise ValueError("main/stash shapes do not match nb_bits/stash_bits")
    if main.data_ptr() % 16 or stash.data_ptr() % 16:
        raise ValueError("table rows must be 16-byte aligned")
    P = L - k + 1
    labels = torch.empty((R, P), dtype=torch.int32, device=dev)
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    c1, c2, c3 = consts
    _raise_on(lib.cuclark_query(
        packed2.data_ptr(), vbits.data_ptr(), main.data_ptr(),
        stash.data_ptr(), labels.data_ptr(), R, P, s2, s8, k, nb_bits,
        stash_bits, c1, c2, c3, stream), "query")
    LAUNCHES["query"] += 1
    return labels


def score(labels: torch.Tensor) -> torch.Tensor:
    """Launch the score kernel (csrc/score.cu) -> results int32 [R, 5]."""
    dev = labels.device
    if dev.type != "cuda":
        raise ValueError(f"score kernel needs CUDA tensors, got {dev}")
    _check(labels, "labels", torch.int32, dev)
    R, P = labels.shape
    if not 1 <= P <= MAX_SCORE_WINDOWS:
        raise NotImplementedError(
            f"the score kernel sorts at most {MAX_SCORE_WINDOWS} windows "
            f"per read in shared memory, got {P} (reads longer than "
            f"{MAX_SCORE_WINDOWS} bases: ROADMAP.md, Queue 2)")
    results = torch.empty((R, 5), dtype=torch.int32, device=dev)
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.cuclark_score(labels.data_ptr(), results.data_ptr(), R, P,
                                stream), "score")
    LAUNCHES["score"] += 1
    return results
