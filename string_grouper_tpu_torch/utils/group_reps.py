"""Post-hoc group-representative re-selection utilities.

The port's own copy of ``string_grouper_tpu.utils.group_reps``, itself the
equivalent of the reference's ``string_grouper_utils`` package
(reference: string_grouper_utils/string_grouper_utils.py:11-191).  These
operate on the *output* DataFrame of ``group_similar_strings`` -- pure
host-side pandas, no device involvement -- re-picking each group's
representative by earliest timestamp, record completeness, or explicit
weight.
"""

from __future__ import annotations

import re
from datetime import datetime
from numbers import Number
from typing import List, Optional, Union

import pandas as pd
from dateutil.parser import parse
from dateutil.tz import UTC


def new_group_rep_by_earliest_timestamp(
    grouped_data: pd.DataFrame,
    group_col: Union[str, int],
    record_id_col: Union[str, int],
    timestamps: Union[pd.Series, str, int],
    record_name_col: Optional[Union[str, int]] = None,
    parserinfo=None,
    **kwargs,
) -> Union[pd.DataFrame, pd.Series]:
    """Pick the oldest record of each group as its representative
    (reference utils:11-41).

    :param grouped_data: grouped DataFrame (output of group_similar_strings)
    :param group_col: name or positional index of the group column
    :param record_id_col: name or positional index of the record-ID column
    :param timestamps: Series, or name/positional index of the timestamp
        column; values may be date-like strings, pandas Timestamps, python
        datetimes, or numbers
    :param record_name_col: optional name column to include in the output
    :param parserinfo, kwargs: forwarded to dateutil.parser.parse
    """
    if isinstance(timestamps, pd.Series):
        if len(grouped_data) != len(timestamps):
            raise Exception(
                "Both grouped_data and timestamps must be pandas.Series of the same length."
            )
    else:
        timestamps = get_column(timestamps, grouped_data)
    weights = parse_timestamps(timestamps, parserinfo, **kwargs)
    return group_rep_transform(
        "idxmin", weights, grouped_data, group_col, record_id_col, record_name_col
    )


def new_group_rep_by_completeness(
    grouped_data: pd.DataFrame,
    group_col: Union[str, int],
    record_id_col: Union[str, int],
    record_name_col: Optional[Union[str, int]] = None,
    tested_cols: Optional[Union[pd.DataFrame, List[Union[str, int]]]] = None,
) -> Union[pd.DataFrame, pd.Series]:
    """Pick the most filled-in record of each group as its representative
    (reference utils:44-78).  ``tested_cols`` selects which columns count
    toward completeness (default: all of grouped_data)."""
    if isinstance(tested_cols, pd.DataFrame):
        if len(grouped_data) != len(tested_cols):
            raise Exception(
                "Both grouped_data and tested_cols must be pandas.DataFrame of the same length."
            )
    elif tested_cols is not None:
        tested_cols = get_column(tested_cols, grouped_data)
    else:
        tested_cols = grouped_data

    def filled(x):
        return 0 if (x == "" or pd.isnull(x)) else 1

    weights = tested_cols.map(filled).sum(axis=1)
    return group_rep_transform(
        "idxmax", weights, grouped_data, group_col, record_id_col, record_name_col
    )


def new_group_rep_by_highest_weight(
    grouped_data: pd.DataFrame,
    group_col: Union[str, int],
    record_id_col: Union[str, int],
    weights: Union[pd.Series, str, int],
    record_name_col: Optional[Union[str, int]] = None,
) -> Union[pd.DataFrame, pd.Series]:
    """Pick the highest-weight record of each group as its representative
    (reference utils:81-103)."""
    if isinstance(weights, pd.Series):
        if len(grouped_data) != len(weights):
            raise Exception(
                "Both grouped_data and weights must be pandas.Series of the same length."
            )
    else:
        weights = get_column(weights, grouped_data)
    return group_rep_transform(
        "idxmax", weights, grouped_data, group_col, record_id_col, record_name_col
    )


def group_rep_transform(
    method: str,
    weights: pd.Series,
    grouped_data,
    group_col,
    record_id_col,
    record_name_col,
) -> Union[pd.Series, pd.DataFrame]:
    """Shared groupby-transform engine (reference utils:106-127): find the
    positional index of each group's representative per ``method`` over
    ``weights``, then gather the ID (and optionally name) columns."""
    stashed_index = grouped_data.index
    frame = pd.DataFrame(
        {
            "raw_group_id": get_column(group_col, grouped_data).reset_index(drop=True),
            "weight": weights.reset_index(drop=True),
        }
    )
    rep_pos = frame.groupby("raw_group_id", sort=False)["weight"].transform(method)
    record_ids = get_column(record_id_col, grouped_data)
    new_rep = record_ids.iloc[rep_pos].reset_index(drop=True).rename(None)
    if record_name_col is None:
        output = new_rep
    else:
        names = get_column(record_name_col, grouped_data)
        new_rep_name = names.iloc[rep_pos].reset_index(drop=True).rename(None)
        output = pd.concat([new_rep, new_rep_name], axis=1)
    output.index = stashed_index
    return output


def get_column(col: Union[str, int, List[Union[str, int]]], data: pd.DataFrame):
    """Resolve a column by name, positional index, or list thereof
    (reference utils:130-136)."""
    if isinstance(col, str):
        return data.loc[:, col]
    if isinstance(col, int):
        return data.iloc[:, col]
    if isinstance(col, List):
        return pd.concat([get_column(c, data) for c in col], axis=1)
    raise TypeError(f"cannot resolve column specifier {col!r}")


def parse_timestamps(timestamps: pd.Series, parserinfo=None, **kwargs) -> pd.Series:
    """Normalize a timestamp Series to comparable values
    (reference utils:139-155): date-like strings and datetimes resolve to
    UTC; pandas Timestamps to numpy datetime64; numbers pass through."""
    error_msg = (
        "timestamps must be a Series of date-like or datetime-like strings"
        " or datetime datatype or pandas Timestamp datatype or numbers"
    )
    if is_series_of_type(str, timestamps):
        if timestamps.map(lambda x: is_date(x, parserinfo, **kwargs)).all():
            return timestamps.transform(
                lambda x: parse(x, parserinfo, **kwargs).astimezone(UTC)
            )
    elif is_series_of_type(pd.Timestamp, timestamps):
        return timestamps.transform(lambda x: x.to_numpy())
    elif is_series_of_type(datetime, timestamps):
        return timestamps.transform(lambda x: x.astimezone(UTC))
    elif is_series_of_type(Number, timestamps):
        return timestamps
    raise Exception(error_msg)


def is_date(string, parserinfo=None, **kwargs) -> bool:
    """Whether a string parses as a date (reference utils:158-171)."""
    try:
        parse(string, parserinfo, **kwargs)
        return True
    except (ValueError, OverflowError):
        return False


def is_series_of_type(what: type, series_to_test: pd.Series) -> bool:
    """(reference utils:174-179)"""
    return not series_to_test.map(lambda x: not isinstance(x, what)).any()


# Append dateutil.parser.parse's kwargs documentation to the timestamp
# function's docstring, as the reference does (utils:182-191).
try:
    import pydoc

    _parse_doc = re.search(
        r":param parserinfo:.*?:return:", pydoc.render_doc(parse), flags=re.DOTALL
    )
    if _parse_doc:
        _doc = re.sub(
            "``timestr``",
            "the strings containing the date/time-stamps",
            _parse_doc.group(0),
        )
        new_group_rep_by_earliest_timestamp.__doc__ = (
            new_group_rep_by_earliest_timestamp.__doc__ + _doc[:-9]
        )
except Exception:  # pragma: no cover - doc grafting is best-effort
    pass
