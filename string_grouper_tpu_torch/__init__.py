"""string_grouper_tpu_torch: the string grouper on PyTorch and CUDA.

The port of ``string_grouper_tpu`` (JAX on a TPU) to an NVIDIA H100: the
same host pipeline (native C++ TF-IDF encode, exact fp64 rescoring), with
the device path in PyTorch and hand-written CUDA kernels (csrc/).  It runs
on the GPU by default; ``device="cpu"`` selects the plain PyTorch path.
"""

from .api import match_strings
from .config import StringGrouperConfig
from .engine import StringGrouper
from .validation import StringGrouperNotFitException

__version__ = "0.1.0"

__all__ = [
    "match_strings",
    "StringGrouper",
    "StringGrouperConfig",
    "StringGrouperNotFitException",
]
