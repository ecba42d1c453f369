"""Stateful matching engine: the ``StringGrouper`` of the port.

API-compatible with ``string_grouper_tpu.engine.StringGrouper`` (itself the
reference class, string_grouper/string_grouper.py:224-1010) for the match
path: ``__init__ -> fit -> get_matches``.  Strings are encoded into ELL
TF-IDF on the host (corpus/), matched on the card by the two-phase matcher
(ops/matcher.py, CUDA kernels in csrc/) and assembled into the reference's
DataFrame layout (frame.py).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import pandas as pd

from .config import StringGrouperConfig
from .corpus import TfidfEncoder
from .frame import assemble_matches
from .native import set_native_threads
from .ops.matcher import (
    chunked_p1_will_engage,
    duplicate_codes,
    prefetch_corpus_hash,
    topn_cosine_matches,
)
from .utils.profiling import PhaseTimings
from .validation import (
    StringGrouperNotFitException,
    resolve_device,
    validate_group_rep,
    validate_hash_dim,
    validate_id_data,
    validate_input_data_combination,
    validate_is_fit,
    validate_n_blocks,
    validate_replace_na_and_drop,
    validate_series_of_strings,
    validate_tfidf_dtype,
)

__all__ = ["StringGrouper", "StringGrouperNotFitException"]


def _empty_matches_list() -> pd.DataFrame:
    return pd.DataFrame(
        {
            "master_side": pd.Series(dtype=np.int64),
            "dupe_side": pd.Series(dtype=np.int64),
            "similarity": pd.Series(dtype=np.float64),
        }
    )


class StringGrouper:
    """Holds master/duplicates Series and their match list.

    If ``duplicates`` is not given the master is matched against itself
    (self-join).  Call :meth:`fit` to build the match list.  The matcher
    runs on ``device`` (config; ``"cuda"`` by default, ``"cpu"`` only when
    asked for).
    """

    def __init__(
        self,
        master: pd.Series,
        duplicates: Optional[pd.Series] = None,
        master_id: Optional[pd.Series] = None,
        duplicates_id: Optional[pd.Series] = None,
        **kwargs,
    ):
        if "topn_slack" in kwargs:
            warnings.warn(
                "topn_slack is deprecated and has no effect: the adaptive "
                "matcher's selection is always complete.",
                DeprecationWarning,
                stacklevel=2,
            )
        self.is_build = False
        self._matches_list: pd.DataFrame = _empty_matches_list()
        self._true_max_n_matches: int = 0
        # Unknown kwargs raise here, before data validation (reference
        # constructor order, string_grouper.py:260-267).
        self._config: StringGrouperConfig = StringGrouperConfig(**kwargs)
        self._max_n_matches = self._config.max_n_matches
        #: per-phase wall times of the most recent fit
        self.timings = PhaseTimings()

        validate_series_of_strings(master, "Master")
        if duplicates is not None:
            validate_series_of_strings(duplicates, "Duplicates")
        validate_input_data_combination(duplicates, master_id, duplicates_id)
        validate_id_data(master, duplicates, master_id, duplicates_id)
        self._master = master
        self._duplicates = duplicates
        self._master_id = master_id
        self._duplicates_id = duplicates_id
        self._right_Series = master if duplicates is None else duplicates

        validate_group_rep(self._config)
        validate_tfidf_dtype(self._config)
        validate_replace_na_and_drop(self._config, master, duplicates)
        validate_n_blocks(self._config.n_blocks)
        validate_hash_dim(self._config)
        self._device = resolve_device(self._config.device)
        self._encoder = TfidfEncoder(self._config)

    def fit(self) -> "StringGrouper":
        """Build the matches list (reference fit(), string_grouper.py:380-431)."""
        # number_of_processes caps the native kernels' OpenMP threads (the
        # reference routes it to sp_matmul_topn's n_threads, :22, :731).
        set_native_threads(self._config.number_of_processes)
        self.timings.reset()
        is_self = self._duplicates is None
        cfg = self._config
        with self.timings.phase("encode"):
            # defer_fill: the ELL value fill runs on a worker thread while
            # the payload uploads and the device hash builds.
            master_ell, dupes_ell = self._encoder.fit_transform_pair(
                self._master,
                None if is_self else self._duplicates,
                defer_fill=True,
            )
            n_right = len(self._right_Series)
            max_n = n_right if self._max_n_matches is None else self._max_n_matches
            # Skipped when the matcher will pipeline column-chunked uploads
            # instead (opt-in, large self-joins): a full upload queued
            # ahead of the chunks would serialize the very head the
            # pipeline overlaps with the scan.
            if not chunked_p1_will_engage(
                master_ell, is_self, cfg.min_similarity, max_n, cfg.hash_dim,
                cfg.left_chunk, cfg.right_tile, self._device,
            ):
                prefetch_corpus_hash(master_ell, cfg.hash_dim, self._device)
                if not is_self:
                    prefetch_corpus_hash(dupes_ell, cfg.hash_dim, self._device)

        with self.timings.phase("match"):
            left_codes = duplicate_codes(self._master, master_ell)
            right_codes = None
            if not is_self:
                right_codes = duplicate_codes(self._duplicates, dupes_ell)
            pairs = topn_cosine_matches(
                master_ell,
                None if is_self else dupes_ell,
                cfg.min_similarity,
                max_n,
                force_symmetries=cfg.force_symmetries,
                hash_dim=cfg.hash_dim,
                left_chunk=cfg.left_chunk,
                right_tile=cfg.right_tile,
                score_dtype=cfg.tfidf_matrix_dtype,
                left_codes=left_codes,
                right_codes=right_codes,
                device=self._device,
            )
        for k, v in (pairs.stats or {}).items():
            self.timings.seconds[f"match.{k}"] = v
        self._true_max_n_matches = pairs.true_max_n_matches
        with self.timings.phase("assemble"):
            self._matches_list = pd.DataFrame(
                {
                    "master_side": pairs.rows.astype(np.int64),
                    "dupe_side": pairs.cols.astype(np.int64),
                    "similarity": pairs.sims.astype(cfg.tfidf_matrix_dtype),
                }
            )
        self.is_build = True
        return self

    @validate_is_fit
    def get_matches(
        self,
        ignore_index: Optional[bool] = None,
        include_zeroes: Optional[bool] = None,
    ) -> pd.DataFrame:
        """All matches with similarities (reference string_grouper.py:443-518)."""
        if ignore_index is None:
            ignore_index = self._config.ignore_index
        if include_zeroes is None:
            include_zeroes = self._config.include_zeroes
        if self._config.min_similarity > 0 or not include_zeroes:
            matches_list = self._matches_list
        else:
            non_matches = self._get_non_matches_list()
            matches_list = (
                self._matches_list
                if non_matches.empty
                else pd.concat([self._matches_list, non_matches], axis=0, ignore_index=True)
            )
        return assemble_matches(
            self._master,
            self._duplicates,
            self._master_id,
            self._duplicates_id,
            matches_list,
            ignore_index,
        )

    def _get_non_matches_list(self) -> pd.DataFrame:
        """Zero-similarity completion (reference string_grouper.py:765-781)."""
        m_sz = len(self._master)
        d_sz = len(self._right_Series)
        all_pairs = pd.MultiIndex.from_product(
            [range(m_sz), range(d_sz)], names=["master_side", "dupe_side"]
        )
        matched_pairs = pd.MultiIndex.from_frame(
            self._matches_list[["master_side", "dupe_side"]]
        )
        missing_pairs = all_pairs.difference(matched_pairs)
        if missing_pairs.empty:
            return pd.DataFrame()
        max_n = d_sz if self._max_n_matches is None else self._max_n_matches
        if max_n < self._true_max_n_matches:
            raise Exception(
                f"\nERROR: Cannot return zero-similarity matches since \n"
                f"\t\t max_n_matches={max_n} is too small!\n"
                f"\t\t Try setting max_n_matches={self._true_max_n_matches} (the \n"
                f"\t\t true maximum number of matches over all strings in master)\n"
                f"\t\t or greater or do not set this kwarg at all."
            )
        missing_pairs = missing_pairs.to_frame(index=False)
        missing_pairs["similarity"] = 0
        return missing_pairs
