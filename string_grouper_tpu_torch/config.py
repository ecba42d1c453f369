"""Configuration of the PyTorch/CUDA string grouper.

The option surface of ``string_grouper_tpu.config`` (itself the reference
library's ``StringGrouperConfig``, string_grouper/string_grouper.py:17-202)
with the JAX-only ``mesh``/``multihost`` knobs replaced by ``device``.
"""

from __future__ import annotations

import multiprocessing
from typing import NamedTuple, Optional, Tuple

import numpy as np

# --- Reference-compatible defaults (string_grouper.py:17-37) -----------------
DEFAULT_NGRAM_SIZE: int = 3
DEFAULT_TFIDF_MATRIX_DTYPE: type = np.float64
DEFAULT_REGEX: str = r"[,-./]|\s"
DEFAULT_MAX_N_MATCHES: int = 20
DEFAULT_MIN_SIMILARITY: float = 0.8
DEFAULT_N_PROCESSES: int = multiprocessing.cpu_count() - 1
DEFAULT_IGNORE_CASE: bool = True
DEFAULT_DROP_INDEX: bool = False
DEFAULT_REPLACE_NA: bool = False
DEFAULT_INCLUDE_ZEROES: bool = True
GROUP_REP_CENTROID: str = "centroid"
GROUP_REP_FIRST: str = "first"
DEFAULT_GROUP_REP: str = GROUP_REP_CENTROID
DEFAULT_FORCE_SYMMETRIES: bool = True
DEFAULT_N_BLOCKS: Optional[Tuple[int, int]] = None
DEFAULT_NORMALIZE_TO_ASCII: bool = True

# --- Output column-naming constants (string_grouper.py:39-49) ----------------
DEFAULT_COLUMN_NAME: str = "side"
DEFAULT_ID_NAME: str = "id"
LEFT_PREFIX: str = "left_"
RIGHT_PREFIX: str = "right_"
MOST_SIMILAR_PREFIX: str = "most_similar_"
DEFAULT_MASTER_NAME: str = "master"
DEFAULT_MASTER_ID_NAME: str = f"{DEFAULT_MASTER_NAME}_{DEFAULT_ID_NAME}"
GROUP_REP_PREFIX: str = "group_rep_"

# --- Matcher defaults ---------------------------------------------------------
# Feature-hash width of the phase-1 upper-bound filter matmul (power of two).
# Results are exact for any value; the CUDA phase-1 kernel takes <= 512.
DEFAULT_HASH_DIM: int = 512
# DEPRECATED no-op kept for API stability (the adaptive matcher is complete).
DEFAULT_TOPN_SLACK: int = 8
# Rows per left-side chunk of the phase-1 filter.
DEFAULT_LEFT_CHUNK: int = 4096
# Right-side columns per phase-1 logical tile.
DEFAULT_RIGHT_TILE: int = 4096
# Where the matcher runs: "cuda" (default) or "cpu".  The CPU path is only
# taken when asked for; without a GPU the default raises.
DEFAULT_DEVICE: str = "cuda"


class StringGrouperConfig(NamedTuple):
    r"""Immutable configuration (reference: string_grouper.py:156-202).

    Reference options keep their names, defaults and semantics (see
    ``string_grouper_tpu.config.StringGrouperConfig``).  Port-specific:

    :param hash_dim: feature-hash width of the phase-1 filter matmul.
    :param topn_slack: DEPRECATED no-op knob.
    :param left_chunk: left-side rows per phase-1 chunk.
    :param right_tile: right-side columns per phase-1 logical tile.
    :param device: ``"cuda"`` (default; raises when no GPU is present) or
        ``"cpu"`` (the kernels' plain PyTorch versions run instead).
    """

    ngram_size: int = DEFAULT_NGRAM_SIZE
    tfidf_matrix_dtype: type = DEFAULT_TFIDF_MATRIX_DTYPE
    regex: str = DEFAULT_REGEX
    max_n_matches: Optional[int] = DEFAULT_MAX_N_MATCHES
    min_similarity: float = DEFAULT_MIN_SIMILARITY
    number_of_processes: int = DEFAULT_N_PROCESSES
    ignore_case: bool = DEFAULT_IGNORE_CASE
    ignore_index: bool = DEFAULT_DROP_INDEX
    include_zeroes: bool = DEFAULT_INCLUDE_ZEROES
    replace_na: bool = DEFAULT_REPLACE_NA
    group_rep: str = DEFAULT_GROUP_REP
    force_symmetries: bool = DEFAULT_FORCE_SYMMETRIES
    n_blocks: Optional[Tuple[int, int]] = DEFAULT_N_BLOCKS
    normalize_to_ascii: bool = DEFAULT_NORMALIZE_TO_ASCII
    hash_dim: int = DEFAULT_HASH_DIM
    topn_slack: int = DEFAULT_TOPN_SLACK
    left_chunk: int = DEFAULT_LEFT_CHUNK
    right_tile: int = DEFAULT_RIGHT_TILE
    device: str = DEFAULT_DEVICE
