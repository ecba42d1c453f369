"""Configuration of the PyTorch/CUDA string grouper.

The option surface of ``string_grouper_tpu.config`` (itself the reference
library's ``StringGrouperConfig``, string_grouper/string_grouper.py:17-202)
with ``device`` added; ``mesh`` and ``multihost`` name the port's own
tiers (``string_grouper_tpu_torch.parallel``).
"""

from __future__ import annotations

import multiprocessing
from typing import NamedTuple, Optional, Tuple, Union

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
    :param mesh: optional ``string_grouper_tpu_torch.parallel.Mesh`` with
        axes ('dp', 'mp') (see
        :func:`string_grouper_tpu_torch.parallel.make_mesh`), its slots
        devices of ``device``'s type; when set, encoding and matching run
        sharded across the mesh devices.  Beside the ``sharded``
        multi-process tier (forced or auto-selected) it gives each rank its
        device slots instead: the mesh's devices flattened in (dp, mp)
        row-major order, the same number on every rank.
    :param multihost: multi-process (multi-host) execution tier
        (parallel/multihost.py), over the ranks of a ``torch.distributed``
        group, one process per rank on ``device`` (or on its ``mesh``).
        ``None`` (default) turns it on when a group of more than one rank
        is initialized (``dist.get_world_size() > 1``); True/False force it.
        Under the tier every rank calls the same API with the same full
        inputs; encode and matching shard across the ranks and every rank
        returns the identical full output.  The string ``"replicated"``
        forces the fast tier (the exact corpus gathered to every rank --
        O(corpus) host memory per rank); ``"sharded"`` forces the
        memory-scalable tier (no rank holds the full corpus ELL; ~1/world
        host memory).  ``True``/auto picks ``replicated`` below
        ``SG_TPU_MH_SHARDED_ROWS`` corpus rows (default 2,000,000) and
        ``sharded`` at or above it.  The ``replicated`` tier composes with
        ``mesh`` (each rank's matcher then runs sharded over its mesh); the
        ``sharded`` tier takes the mesh as the rank's device slots and
        shards the right side over ``world x slots`` devices.
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
    mesh: Optional[object] = None
    multihost: Optional[Union[bool, str]] = None
