"""cuclark_tpu_torch — the PyTorch and CUDA port of `cuclark_tpu`.

Beside the JAX package, which stays the reference, this package runs
the classifier on one NVIDIA GPU: build a database of target-specific
canonical k-mers (host code carried over from `cuclark_tpu`), then
classify single-end or paired reads against a qs, q4 or s2 table,
resident on the card or streamed to it in parts, with two hand-written
CUDA kernels, `csrc/query.cu` (wire batch -> per-window labels) and
`csrc/score.cu` (labels -> per-read top-2), and write CLARK-format CSV.  Module names follow `cuclark_tpu`, so each module's
counterpart has the same name there.  Nothing here imports JAX.
"""

from cuclark_tpu_torch.config import ClassifyConfig, DBConfig
from cuclark_tpu_torch.hashdb import KmerDB
from cuclark_tpu_torch.pipeline import Classifier

__version__ = "0.1.0"

__all__ = [
    "ClassifyConfig",
    "DBConfig",
    "KmerDB",
    "Classifier",
    "__version__",
]
