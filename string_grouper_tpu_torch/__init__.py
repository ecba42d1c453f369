"""string_grouper_tpu_torch: the string grouper on PyTorch and CUDA.

The port of ``string_grouper_tpu`` (JAX on a TPU) to an NVIDIA H100: the
same host pipeline (native C++ TF-IDF encode, exact fp64 rescoring), with
the device path in PyTorch and hand-written CUDA kernels (csrc/).  It runs
on the GPU by default; ``device="cpu"`` selects the plain PyTorch path.
"""

from .api import (
    compute_pairwise_similarities,
    group_similar_strings,
    match_most_similar,
    match_strings,
)
from .config import (
    DEFAULT_COLUMN_NAME,
    DEFAULT_FORCE_SYMMETRIES,
    DEFAULT_GROUP_REP,
    DEFAULT_ID_NAME,
    DEFAULT_IGNORE_CASE,
    DEFAULT_INCLUDE_ZEROES,
    DEFAULT_MASTER_ID_NAME,
    DEFAULT_MASTER_NAME,
    DEFAULT_MAX_N_MATCHES,
    DEFAULT_MIN_SIMILARITY,
    DEFAULT_N_BLOCKS,
    DEFAULT_N_PROCESSES,
    DEFAULT_NGRAM_SIZE,
    DEFAULT_NORMALIZE_TO_ASCII,
    DEFAULT_REGEX,
    DEFAULT_REPLACE_NA,
    DEFAULT_TFIDF_MATRIX_DTYPE,
    GROUP_REP_CENTROID,
    GROUP_REP_FIRST,
    StringGrouperConfig,
)
from .engine import StringGrouper
from .validation import StringGrouperNotFitException

__version__ = "0.1.0"

__all__ = [
    "compute_pairwise_similarities",
    "group_similar_strings",
    "match_most_similar",
    "match_strings",
    "StringGrouper",
    "StringGrouperConfig",
    "StringGrouperNotFitException",
]
