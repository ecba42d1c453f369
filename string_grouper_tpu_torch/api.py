"""High-level one-shot API (reference string_grouper.py:130-153)."""

from __future__ import annotations

from typing import Optional

import pandas as pd

from .engine import StringGrouper


def match_strings(
    master: pd.Series,
    duplicates: Optional[pd.Series] = None,
    master_id: Optional[pd.Series] = None,
    duplicates_id: Optional[pd.Series] = None,
    **kwargs,
) -> pd.DataFrame:
    """All highly-similar string pairs: self-join when only master is given,
    inner-join against duplicates otherwise (reference string_grouper.py:130-153).
    Runs on the GPU unless ``device="cpu"`` is passed."""
    sg = StringGrouper(
        master,
        duplicates=duplicates,
        master_id=master_id,
        duplicates_id=duplicates_id,
        **kwargs,
    )
    return sg.fit().get_matches()
