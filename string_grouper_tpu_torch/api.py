"""High-level one-shot API (reference string_grouper.py:55-153).

Each function builds a :class:`StringGrouper`, fits it, and extracts the
requested output.  They run on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Optional, Union

import pandas as pd

from .engine import StringGrouper


def compute_pairwise_similarities(
    string_series_1: pd.Series, string_series_2: pd.Series, **kwargs
) -> pd.Series:
    """Row-wise cosine similarity between two equal-length Series
    (reference string_grouper.py:55-67): an encode and an exact host
    row-wise dot."""
    return StringGrouper(string_series_1, string_series_2, **kwargs).dot()


def group_similar_strings(
    strings_to_group: pd.Series, string_ids: Optional[pd.Series] = None, **kwargs
) -> Union[pd.DataFrame, pd.Series]:
    """Deduplicate a Series: every member of a similarity group maps to the
    group representative (reference string_grouper.py:70-92)."""
    sg = StringGrouper(strings_to_group, master_id=string_ids, **kwargs)
    return sg.fit().get_groups()


def match_most_similar(
    master: pd.Series,
    duplicates: pd.Series,
    master_id: Optional[pd.Series] = None,
    duplicates_id: Optional[pd.Series] = None,
    **kwargs,
) -> Union[pd.DataFrame, pd.Series]:
    """For each duplicate, the most similar master string (or itself when no
    match clears the threshold) (reference string_grouper.py:95-127)."""
    kwargs["max_n_matches"] = 1
    sg = StringGrouper(
        master,
        duplicates=duplicates,
        master_id=master_id,
        duplicates_id=duplicates_id,
        **kwargs,
    )
    return sg.fit().get_groups()


def match_strings(
    master: pd.Series,
    duplicates: Optional[pd.Series] = None,
    master_id: Optional[pd.Series] = None,
    duplicates_id: Optional[pd.Series] = None,
    **kwargs,
) -> pd.DataFrame:
    """All highly-similar string pairs: self-join when only master is given,
    inner-join against duplicates otherwise (reference string_grouper.py:130-153)."""
    sg = StringGrouper(
        master,
        duplicates=duplicates,
        master_id=master_id,
        duplicates_id=duplicates_id,
        **kwargs,
    )
    return sg.fit().get_matches()
