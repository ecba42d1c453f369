"""Stateful matching engine: the ``StringGrouper`` of the port.

API-compatible with ``string_grouper_tpu.engine.StringGrouper`` (itself the
reference class, string_grouper/string_grouper.py:224-1010): the same
constructor, lifecycle (``__init__ -> fit -> get_matches / get_groups``),
data and option resets, interactive ``add_match`` / ``remove_match``
editing, method twins of the four high-level functions, the ``mesh``
option's sharded tier and the ``multihost`` option's multi-process tiers
over ``torch.distributed`` ranks (parallel/).  Strings are encoded into ELL
TF-IDF on the host (corpus/),
matched on the card by the two-phase matcher (ops/matcher.py, CUDA kernels
in csrc/), grouped by connected components
(ops/connected_components.py) and assembled into the reference's DataFrame
layout (frame.py).
"""

from __future__ import annotations

import os
import re
import warnings
from typing import List, Optional, Union
from unicodedata import normalize as _unicode_normalize

import numpy as np
import pandas as pd

from .config import StringGrouperConfig
from .corpus import TfidfEncoder
from .frame import assemble_groups, assemble_matches, assemble_nearest_matches
from .native import set_native_threads
from .ops.matcher import (
    duplicate_codes,
    prefetch_corpus_hash,
    topn_cosine_matches,
)
from .ops.rescore import row_dot_fp64
from .parallel.distributed import distributed_topn_cosine_matches, validate_mesh
from .parallel.multihost import (
    _world,
    multihost_fit_pairs,
    multihost_sharded_fit_pairs,
)
from .utils.profiling import PhaseTimings, span
from .validation import (
    StringGrouperNotFitException,
    resolve_device,
    validate_group_rep,
    validate_hash_dim,
    validate_id_data,
    validate_input_data_combination,
    validate_is_fit,
    validate_multihost,
    validate_n_blocks,
    validate_replace_na_and_drop,
    validate_series_of_strings,
    validate_strings_exist,
    validate_tfidf_dtype,
)

__all__ = ["StringGrouper", "StringGrouperNotFitException"]


def _warn_legacy_kwargs(kwargs: dict) -> None:
    """Deprecation warning for ``topn_slack``, which is accepted but inert
    (the adaptive matcher's selection is always complete).  Warn on
    EXPLICIT use only: the config default never warns."""
    if "topn_slack" in kwargs:
        warnings.warn(
            "topn_slack is deprecated and has no effect: the adaptive "
            "matcher's selection is always complete. The option will be "
            "removed in a future release.",
            DeprecationWarning,
            stacklevel=3,
        )


def _round3(v):
    """A match stat as ``timings`` keeps it: floats to 3 places (as the JAX
    package's engine), counts as they are."""
    return round(v, 3) if isinstance(v, float) else v


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
    (self-join).  Call :meth:`fit` to build the match list; matches can then
    be edited with :meth:`add_match` / :meth:`remove_match`.  The matcher
    and the grouping run on ``device`` (config; ``"cuda"`` by default,
    ``"cpu"`` only when asked for).
    """

    def __init__(
        self,
        master: pd.Series,
        duplicates: Optional[pd.Series] = None,
        master_id: Optional[pd.Series] = None,
        duplicates_id: Optional[pd.Series] = None,
        **kwargs,
    ):
        self.is_build = False
        self._master: Optional[pd.Series] = None
        self._duplicates: Optional[pd.Series] = None
        self._master_id: Optional[pd.Series] = None
        self._duplicates_id: Optional[pd.Series] = None
        self._matches_list: pd.DataFrame = _empty_matches_list()
        self._true_max_n_matches: int = 0
        self._max_n_matches: Optional[int] = 0

        # Unknown kwargs raise here, before data validation (reference
        # constructor order, string_grouper.py:260-267).
        _warn_legacy_kwargs(kwargs)
        self._config: StringGrouperConfig = StringGrouperConfig(**kwargs)
        #: per-phase wall times of the most recent fit, plus the matcher's
        #: stats as ``match.<name>`` (float stats rounded to 3 places); the
        #: output frames that get_matches / get_groups build after it add
        #: up under ``frame``.
        self.timings = PhaseTimings()

        self._set_data(master, duplicates, master_id, duplicates_id)
        self._set_options(**kwargs)  # ends with _build_corpus()

    # ------------------------------------------------------------------ data
    def _set_data(self, master, duplicates=None, master_id=None, duplicates_id=None):
        # the range sg.validate: the check of every input string runs on
        # the host before the fit, in time proportional to the lists
        with span("validate"):
            self.master = master
            self.duplicates = duplicates
            validate_input_data_combination(duplicates, master_id, duplicates_id)
            validate_id_data(master, duplicates, master_id, duplicates_id)
        self._master_id = master_id
        self._duplicates_id = duplicates_id
        self._right_Series = self._master if self._duplicates is None else self._duplicates
        self.is_build = False

    def _set_options(self, **kwargs):
        self._config = StringGrouperConfig(**kwargs)
        self._max_n_matches = self._config.max_n_matches
        validate_group_rep(self._config)
        validate_tfidf_dtype(self._config)
        validate_replace_na_and_drop(self._config, self._master, self._duplicates)
        validate_n_blocks(self._config.n_blocks)
        validate_hash_dim(self._config)
        # Resolved on every option change: update_options(device=...) and
        # the method twins move the next fit; without a GPU the default
        # raises here as it does in __init__.
        self._device = resolve_device(self._config.device)
        validate_mesh(self._config.mesh, self._device)
        validate_multihost(self._config)
        # Rebuild the encoder against the NEW config: options set via
        # update_options / method-twin kwargs (ngram_size, regex,
        # ignore_case, normalize_to_ascii, tfidf_matrix_dtype) must reach
        # the next fit's tokenization (the reference's vectorizer reads the
        # live config at fit time, string_grouper.py:699-707).
        self._build_corpus()

    def _build_corpus(self):
        # The encoder is (re)fit inside fit()/dot() on the then-current data
        # (the reference refits on every fit, string_grouper.py:685-707).
        self._encoder = TfidfEncoder(self._config)
        self.is_build = False

    def reset_data(self, master, duplicates=None, master_id=None, duplicates_id=None):
        """Swap the input Series without reconfiguring the engine
        (reference string_grouper.py:310-323)."""
        self._set_data(master, duplicates, master_id, duplicates_id)

    def clear_data(self):
        self._master = None
        self._duplicates = None
        self._master_id = None
        self._duplicates_id = None
        self._matches_list = None
        self._right_Series = None
        self.is_build = False

    def update_options(self, **kwargs):
        """Merge new options into the current config
        (reference string_grouper.py:335-343)."""
        _warn_legacy_kwargs(kwargs)
        _ = StringGrouperConfig(**kwargs)
        old_kwargs = self._config._asdict()
        old_kwargs.update(kwargs)
        self._set_options(**old_kwargs)

    @property
    def master(self):
        return self._master

    @master.setter
    def master(self, master):
        validate_series_of_strings(master, "Master")
        self._master = master

    @property
    def duplicates(self):
        return self._duplicates

    @duplicates.setter
    def duplicates(self, duplicates):
        if duplicates is not None:
            validate_series_of_strings(duplicates, "Duplicates")
        self._duplicates = duplicates

    # ------------------------------------------------------------- tokenizer
    def n_grams(self, string: str) -> List[str]:
        """Analyzer for a single string (reference string_grouper.py:365-378);
        the bulk path uses the vectorized corpus pipeline instead."""
        if self._config.ignore_case and string is not None:
            string = string.lower()
        if self._config.normalize_to_ascii:
            string = _unicode_normalize("NFKD", string).encode("ASCII", "ignore").decode()
        string = re.sub(self._config.regex, "", string)
        grams = zip(*[string[i:] for i in range(self._config.ngram_size)])
        return ["".join(g) for g in grams]

    # ------------------------------------------------------------------- fit
    def fit(self) -> "StringGrouper":
        """Build the matches list (reference fit(), string_grouper.py:380-431)."""
        # number_of_processes caps the native kernels' OpenMP threads (the
        # reference routes it to sp_matmul_topn's n_threads, :22, :731).
        set_native_threads(self._config.number_of_processes)
        self.timings.reset()
        if self._use_multihost():
            return self._fit_multihost()
        is_self = self._duplicates is None
        cfg = self._config
        # The ELL matrices (and the device hash prefetched onto the master's
        # payload) live only for this call: nothing of a fit's encode stays
        # on the engine, so a refit never holds the last fit's card memory.
        with self.timings.phase("encode"):
            # defer_fill: the ELL value fill runs on a worker thread while
            # the payload uploads and the device hash builds.  A mesh fit
            # encodes the same way: one controller holds the whole corpus.
            master_ell, dupes_ell = self._encoder.fit_transform_pair(
                self._master,
                None if is_self else self._duplicates,
                defer_fill=True,
            )
            n_right = len(self._right_Series)
            max_n = n_right if self._max_n_matches is None else self._max_n_matches
            # The hash builds where phase 1 reads it: on the device, or on
            # the mesh's first slot, whence the mesh tier moves its shards.
            hash_dev = self._device if cfg.mesh is None else cfg.mesh.devices[0, 0]
            prefetch_corpus_hash(master_ell, cfg.hash_dim, hash_dev)
            if not is_self:
                prefetch_corpus_hash(dupes_ell, cfg.hash_dim, hash_dev)

        with self.timings.phase("match"):
            left_codes = duplicate_codes(self._master, master_ell)
            right_codes = None
            if not is_self:
                right_codes = duplicate_codes(self._duplicates, dupes_ell)
            knobs = dict(
                force_symmetries=cfg.force_symmetries,
                hash_dim=cfg.hash_dim,
                left_chunk=cfg.left_chunk,
                right_tile=cfg.right_tile,
                score_dtype=cfg.tfidf_matrix_dtype,
                left_codes=left_codes,
                right_codes=right_codes,
            )
            args = (master_ell, None if is_self else dupes_ell,
                    cfg.min_similarity, max_n)
            if cfg.mesh is not None:
                pairs = distributed_topn_cosine_matches(*args, cfg.mesh, **knobs)
            else:
                pairs = topn_cosine_matches(*args, device=self._device, **knobs)
        stats_src = pairs.stats
        if stats_src is None:  # no attachment: read the module mirror
            from .ops.matcher import LAST_STATS as stats_src
        for k, v in stats_src.items():
            self.timings.seconds[f"match.{k}"] = _round3(v)
        self._store_pairs(pairs)
        return self

    def _store_pairs(self, pairs) -> None:
        """Shared tail of every fit tier: the matches-list DataFrame in the
        configured dtype."""
        self._true_max_n_matches = pairs.true_max_n_matches
        with self.timings.phase("assemble"):
            self._matches_list = pd.DataFrame(
                {
                    "master_side": pairs.rows.astype(np.int64),
                    "dupe_side": pairs.cols.astype(np.int64),
                    "similarity": pairs.sims.astype(
                        self._config.tfidf_matrix_dtype
                    ),
                }
            )
        self.is_build = True

    def _use_multihost(self) -> bool:
        """Multi-process tier selection: an explicit option wins; ``None``
        turns it on inside a ``torch.distributed`` group of more than one
        rank."""
        if self._config.multihost is not None:
            return bool(self._config.multihost)
        return _world()[1] > 1

    def _multihost_tier(self) -> str:
        """'replicated' (fast; the full exact corpus gathered to every
        rank) or 'sharded' (memory-scalable; ~1/world host memory).  An
        explicit string wins; True/auto switches to 'sharded' at the
        SG_TPU_MH_SHARDED_ROWS corpus-row threshold (default 2,000,000).
        Thresholdless fits (min_similarity <= 0: every pair qualifies) stay
        replicated in auto mode: the sharded tier's candidate width would
        be the whole corpus, and the output is corpus^2-sized anyway."""
        if isinstance(self._config.multihost, str):
            return self._config.multihost
        if self._config.min_similarity <= 0:
            return "replicated"
        n_docs = len(self._master) + (
            0 if self._duplicates is None else len(self._duplicates)
        )
        threshold = int(os.environ.get("SG_TPU_MH_SHARDED_ROWS", "2000000"))
        return "sharded" if n_docs >= threshold else "replicated"

    def _fit_multihost(self) -> "StringGrouper":
        """Multi-process fit (parallel/multihost.py): every rank calls fit()
        with the same full Series; encode and matching shard across the
        ranks; the gathered matches list (and so every get_* output) is
        identical on all ranks and equal to a single-process fit.  The
        tier's stages land in ``timings.seconds`` as ``match.mh_<stage>``
        and the tier's name in ``timings.labels["multihost_tier"]``."""
        tier = self._multihost_tier()
        fit_pairs = (
            multihost_sharded_fit_pairs if tier == "sharded"
            else multihost_fit_pairs
        )
        with self.timings.phase("match"):
            pairs, stages = fit_pairs(
                self._master, self._duplicates, self._config
            )
        self.timings.labels["multihost_tier"] = tier
        for k, v in stages.items():
            self.timings.seconds[f"match.mh_{k}"] = _round3(v)
        self._store_pairs(pairs)
        return self

    def dot(self) -> pd.Series:
        """Row-wise similarity of master vs duplicates
        (reference string_grouper.py:433-440): an encode and an exact host
        row-wise dot; nothing runs on the device."""
        set_native_threads(self._config.number_of_processes)
        if len(self._master) != len(self._duplicates):
            raise Exception("To perform this function, both input Series must have the same length.")
        master_ell, dupes_ell = self._encoder.fit_transform_pair(
            self._master, self._duplicates
        )
        sims = row_dot_fp64(
            master_ell, dupes_ell, acc_dtype=self._config.tfidf_matrix_dtype
        ).astype(self._config.tfidf_matrix_dtype)
        return pd.Series(sims, name="similarity", index=self._master.index)

    # --------------------------------------------------------------- outputs
    @validate_is_fit
    def get_matches(
        self,
        ignore_index: Optional[bool] = None,
        include_zeroes: Optional[bool] = None,
    ) -> pd.DataFrame:
        """All matches with similarities (reference string_grouper.py:443-518)."""
        with self.timings.phase("frame"):
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

    @validate_is_fit
    def get_groups(
        self,
        ignore_index: Optional[bool] = None,
        replace_na: Optional[bool] = None,
    ) -> Union[pd.DataFrame, pd.Series]:
        """Group representatives (self-join) or nearest matches (cross-join)
        (reference string_grouper.py:520-544)."""
        with self.timings.phase("frame"):
            if ignore_index is None:
                ignore_index = self._config.ignore_index
            if self._duplicates is None:
                return assemble_groups(
                    self._master,
                    self._master_id,
                    self._matches_list,
                    ignore_index,
                    self._config.group_rep,
                    self._device,
                )
            if replace_na is None:
                replace_na = self._config.replace_na
            return assemble_nearest_matches(
                self._master,
                self._duplicates,
                self._master_id,
                self._duplicates_id,
                self._matches_list,
                ignore_index,
                replace_na,
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

    # ----------------------------------------------------- interactive edits
    @validate_is_fit
    def add_match(self, master_side: str, dupe_side: str) -> "StringGrouper":
        """Manually add a match with similarity 1, propagating to prior
        matches of the dupe side (reference string_grouper.py:646-666)."""
        master_indices, dupe_indices = self._get_indices_of(master_side, dupe_side)
        prior_matches = self._matches_list.master_side[
            self._matches_list.dupe_side.isin(dupe_indices)
        ]
        dupe_indices = pd.concat([dupe_indices, prior_matches]).drop_duplicates()

        new_matches = _cross_join(dupe_indices, master_indices, [1])
        if self._duplicates is None:
            new_matches = _make_symmetric(new_matches)
        self._matches_list = pd.concat(
            [self._matches_list.drop_duplicates(), new_matches], ignore_index=True
        )
        return self

    @validate_is_fit
    def remove_match(self, master_side: str, dupe_side: str) -> "StringGrouper":
        """Remove a match (both directions for self-joins)
        (reference string_grouper.py:668-683)."""
        master_indices, dupe_indices = self._get_indices_of(master_side, dupe_side)
        if self._duplicates is None:
            master_indices = pd.concat([master_indices, dupe_indices])
            dupe_indices = master_indices
        self._matches_list = self._matches_list[
            ~(
                self._matches_list.master_side.isin(master_indices)
                & self._matches_list.dupe_side.isin(dupe_indices)
            )
        ]
        return self

    def _get_indices_of(self, master_side: str, dupe_side: str):
        """Positional indices of every occurrence of the two strings
        (reference string_grouper.py:906-914)."""
        master_strings = self._master
        dupe_strings = self._master if self._duplicates is None else self._duplicates
        validate_strings_exist(master_side, dupe_side, master_strings, dupe_strings)
        master_indices = pd.Series(
            np.flatnonzero(master_strings.to_numpy() == master_side)
        )
        dupe_indices = pd.Series(np.flatnonzero(dupe_strings.to_numpy() == dupe_side))
        return master_indices, dupe_indices

    # ------------------------------------------------------- method twins of
    # the high-level functions, reusing this instance (reference :546-644).
    # Unlike the API function, the match_most_similar twin does not force
    # max_n_matches=1 (as in the reference).
    def match_strings(
        self, master, duplicates=None, master_id=None, duplicates_id=None, **kwargs
    ) -> pd.DataFrame:
        self.reset_data(master, duplicates, master_id, duplicates_id)
        self.update_options(**kwargs)
        self.fit()
        return self.get_matches()

    def match_most_similar(
        self, master, duplicates, master_id=None, duplicates_id=None, **kwargs
    ):
        self.reset_data(master, duplicates, master_id, duplicates_id)
        self.update_options(**kwargs)
        self.fit()
        return self.get_groups()

    def group_similar_strings(self, strings_to_group, string_ids=None, **kwargs):
        self.reset_data(strings_to_group, master_id=string_ids)
        self.update_options(**kwargs)
        self.fit()
        return self.get_groups()

    def compute_pairwise_similarities(self, string_series_1, string_series_2, **kwargs):
        self.reset_data(string_series_1, string_series_2)
        self.update_options(**kwargs)
        return self.dot()


def _make_symmetric(new_matches: pd.DataFrame) -> pd.DataFrame:
    """(reference string_grouper.py:966-971)"""
    switched = pd.DataFrame(
        {
            "master_side": new_matches.dupe_side,
            "dupe_side": new_matches.master_side,
            "similarity": new_matches.similarity,
        }
    )
    return pd.concat([new_matches, switched])


def _cross_join(dupe_indices, master_indices, similarities) -> pd.DataFrame:
    """(reference string_grouper.py:973-978)"""
    mi = pd.MultiIndex.from_product(
        [master_indices, dupe_indices, similarities],
        names=["master_side", "dupe_side", "similarity"],
    )
    return pd.DataFrame(index=mi).reset_index()
