"""Host-side pandas output assembly of the match table (reference
get_matches, string_grouper.py:443-518): column layout, prefixes and index
handling byte-for-byte as ``string_grouper_tpu.frame.assemble_matches``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import pandas as pd

from .config import (
    DEFAULT_COLUMN_NAME,
    DEFAULT_ID_NAME,
    LEFT_PREFIX,
    RIGHT_PREFIX,
)


_TAKE_POOL: Optional[ThreadPoolExecutor] = None
# Below this many positions a single pyarrow take wins (thread dispatch +
# chunk assembly overheads outweigh the copy).
_PARALLEL_TAKE_MIN = 1 << 20


def _take_values(array, positions: np.ndarray):
    """``array.take(positions)`` with a thread-parallel fast path for
    Arrow-backed columns (pandas-3 default ``str`` dtype).

    ``pyarrow.compute.take`` releases the GIL and the gather is
    memory-bound, so chunking the index of a multi-million-row output
    across a small pool runs the takes in parallel.  Chunk results combine
    into one ChunkedArray;
    values and dtype are identical to the single take (only the internal
    chunking differs, which pandas equality does not observe)."""
    pa_arr = getattr(array, "_pa_array", None)
    n = len(positions)
    if pa_arr is None or n < _PARALLEL_TAKE_MIN:
        return array.take(positions)
    global _TAKE_POOL
    if _TAKE_POOL is None:
        _TAKE_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="sg-take",
        )
    import pyarrow as pa
    import pyarrow.compute as pc

    # Take from a plain Array, not the ChunkedArray: Array-sourced takes
    # return Arrays that reassemble zero-copy, while ChunkedArray-sourced
    # takes return ChunkedArrays whose reassembly copies (seconds at 6M).
    src = (
        pa_arr.chunk(0) if pa_arr.num_chunks == 1 else pa_arr.combine_chunks()
    )
    k = min(8, max(2, n >> 19))
    parts = list(
        _TAKE_POOL.map(
            lambda c: pc.take(src, pa.array(c)), np.array_split(positions, k)
        )
    )
    return pd.array(pa.chunked_array(parts), dtype=array.dtype)


def _gather_entries(
    series: pd.Series,
    positions: np.ndarray,
    fallback_name: str,
    prefix: str,
    drop_index: bool,
):
    """(column_name, values) pairs equivalent to
    ``series.iloc[positions].reset_index(drop=drop_index)`` with prefixed
    column names -- but via array takes (``.iloc`` is ~50x slower at
    millions of rows).  Extension dtypes (e.g. nullable Int64) are
    preserved via ``.array.take``; reset_index column naming ('index',
    'level_<i>') is replicated exactly."""
    entries = []
    if not drop_index:
        idx = series.index
        if isinstance(idx, pd.MultiIndex):
            for li in range(idx.nlevels):
                lname = idx.names[li] if idx.names[li] is not None else f"level_{li}"
                entries.append(
                    (f"{prefix}{lname}", idx.get_level_values(li).to_numpy()[positions])
                )
        else:
            lname = idx.name if idx.name is not None else "index"
            if (
                isinstance(idx, pd.RangeIndex)
                and idx.start == 0
                and idx.step == 1
            ):
                # Default index: the gathered labels ARE the positions --
                # skip materializing a corpus-sized to_numpy() per call.
                vals = positions.astype(np.int64, copy=True)
            else:
                vals = idx.to_numpy()[positions]
            entries.append((f"{prefix}{lname}", vals))
    name = series.name if series.name else fallback_name
    entries.append((f"{prefix}{name}", _take_values(series.array, positions)))
    return entries


def assemble_matches(
    master: pd.Series,
    duplicates: Optional[pd.Series],
    master_id: Optional[pd.Series],
    duplicates_id: Optional[pd.Series],
    matches_list: pd.DataFrame,
    ignore_index: bool,
) -> pd.DataFrame:
    """Long-format match table: left_*, similarity, right_* columns
    (reference get_matches, string_grouper.py:443-518)."""
    pos_l = matches_list.master_side.to_numpy()
    pos_r = matches_list.dupe_side.to_numpy()
    left = _gather_entries(
        master, pos_l, DEFAULT_COLUMN_NAME, LEFT_PREFIX, ignore_index
    )
    right_src = master if duplicates is None else duplicates
    # The right-hand block's column order is reversed (value first, then
    # index columns), matching the reference's layout.
    right = _gather_entries(
        right_src, pos_r, DEFAULT_COLUMN_NAME, RIGHT_PREFIX, ignore_index
    )[::-1]

    similarity = ("similarity", matches_list.similarity.to_numpy())
    if master_id is None:
        entries = left + [similarity] + right
    else:
        right_id_src = master_id if duplicates is None else duplicates_id
        left_id = _gather_entries(
            master_id, pos_l, DEFAULT_ID_NAME, LEFT_PREFIX, True
        )
        right_id = _gather_entries(
            right_id_src, pos_r, DEFAULT_ID_NAME, RIGHT_PREFIX, True
        )
        entries = left + left_id + [similarity] + right_id + right
    names = [n for n, _ in entries]
    if len(set(names)) == len(names):
        return pd.DataFrame(dict(entries), copy=False)
    # Duplicate column names (e.g. a value column literally named 'index'):
    # fall back to concat, which permits them like the reference's layout.
    return pd.concat(
        [pd.Series(v, name=n) for n, v in entries], axis=1
    )
