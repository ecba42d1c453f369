"""Input/option validation (reference string_grouper.py:204-221, :916-1010):
the same exception types for the same misuse, plus the device check."""

from __future__ import annotations

from functools import wraps
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from .config import GROUP_REP_CENTROID, GROUP_REP_FIRST, StringGrouperConfig


class StringGrouperNotFitException(Exception):
    """Raised when a fit-requiring method is called before fit()
    (reference string_grouper.py:219-221)."""


def validate_is_fit(f):
    """Guard decorator (reference string_grouper.py:204-216)."""

    @wraps(f)
    def wrapper(*args, **kwargs):
        if args[0].is_build:
            return f(*args, **kwargs)
        raise StringGrouperNotFitException(
            f'{f.__name__} was called before the "fit" function was called. '
            f"Make sure to fit the StringGrouper first using StringGrouper.fit()"
        )

    return wrapper


def is_series_of_strings(series) -> bool:
    """(reference string_grouper.py:987-995)"""
    if not isinstance(series, pd.Series):
        return False
    return not series.map(lambda x: not isinstance(x, str)).any()


def validate_series_of_strings(series, what: str):
    if not is_series_of_strings(series):
        raise TypeError(
            f"{what} input does not consist of pandas.Series containing only Strings"
        )


def validate_input_data_combination(duplicates, master_id, duplicates_id):
    """(reference string_grouper.py:997-1003)"""
    invalid = (duplicates is None and duplicates_id is not None) or (
        duplicates is not None and ((master_id is None) ^ (duplicates_id is None))
    )
    if invalid:
        raise Exception("List of data Series options is invalid")


def validate_id_data(master, duplicates, master_id, duplicates_id):
    """(reference string_grouper.py:1005-1010)"""
    if master_id is not None and len(master) != len(master_id):
        raise Exception("Both master and master_id must be pandas.Series of the same length.")
    if duplicates is not None and duplicates_id is not None and len(duplicates) != len(duplicates_id):
        raise Exception(
            "Both duplicates and duplicates_id must be pandas.Series of the same length."
        )


def validate_group_rep(config: StringGrouperConfig):
    """(reference string_grouper.py:916-921)"""
    options = (GROUP_REP_FIRST, GROUP_REP_CENTROID)
    if config.group_rep not in options:
        raise Exception(
            f"Invalid option value for group_rep. The only permitted values are\n {options}"
        )


def validate_tfidf_dtype(config: StringGrouperConfig):
    """(reference string_grouper.py:923-928)"""
    options = (np.float32, np.float64)
    if config.tfidf_matrix_dtype not in options:
        raise Exception(
            f"Invalid option value for tfidf_matrix_dtype. The only permitted values are\n {options}"
        )


def validate_replace_na_and_drop(config: StringGrouperConfig, master, duplicates):
    """(reference string_grouper.py:930-937)"""
    if config.ignore_index and config.replace_na:
        raise Exception("replace_na can only be set to True when ignore_index=False.")
    if (
        config.replace_na
        and duplicates is not None
        and master.index.nlevels != duplicates.index.nlevels
    ):
        raise Exception(
            "replace_na=True: Cannot replace NaN values of index-columns with the values of "
            "another index if the number of index-levels does not equal the number of index-columns."
        )


def validate_n_blocks(n_blocks: Optional[Tuple[int, int]]):
    """(reference string_grouper.py:939-952)"""
    errmsg = (
        "Invalid option value for parameter n_blocks: n_blocks must be None "
        "or a tuple of 2 integers greater than 0."
    )
    if n_blocks is None:
        return
    if not isinstance(n_blocks, tuple) or len(n_blocks) != 2:
        raise Exception(errmsg)
    if not (isinstance(n_blocks[0], int) and isinstance(n_blocks[1], int)):
        raise Exception(errmsg)
    if n_blocks[0] < 1 or n_blocks[1] < 1:
        raise Exception(errmsg)


def validate_hash_dim(config: StringGrouperConfig):
    d = config.hash_dim
    if not isinstance(d, int) or d < 2 or (d & (d - 1)) != 0 or d > (1 << 15):
        raise Exception(
            "Invalid option value for hash_dim: must be a power-of-two "
            "integer between 2 and 32768."
        )


def validate_strings_exist(master_side, dupe_side, master_strings, dupe_strings):
    """(reference string_grouper.py:980-985)"""
    if not master_strings.isin([master_side]).any():
        raise ValueError(f"{master_side} not found in StringGrouper string series")
    if not dupe_strings.isin([dupe_side]).any():
        raise ValueError(f"{dupe_side} not found in StringGrouper dupe string series")


def resolve_device(device) -> torch.device:
    """The torch device the matcher runs on.  ``"cuda"`` (the default)
    without a visible GPU raises instead of quietly running on the CPU:
    the CPU path is taken only when the caller asks for it."""
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise ValueError(
            f"Invalid option value for device: {device!r} (use 'cuda' or 'cpu')"
        ) from e
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"Invalid option value for device: {device!r} (use 'cuda' or 'cpu')"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but no CUDA GPU is available; pass "
            "device='cpu' to run the matcher on the CPU"
        )
    return dev
