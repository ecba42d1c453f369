"""Host-side pandas output assembly.  Column layouts, prefixes, NaN/dtype
repair and tie-breaking byte-for-byte as ``string_grouper_tpu.frame``:

  * match table assembly  -- reference string_grouper.py:443-518
  * nearest-match (top-1) -- reference string_grouper.py:783-849
  * dedup group output    -- reference string_grouper.py:851-904
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Union

import numpy as np
import pandas as pd

from .config import (
    DEFAULT_COLUMN_NAME,
    DEFAULT_ID_NAME,
    DEFAULT_MASTER_ID_NAME,
    DEFAULT_MASTER_NAME,
    GROUP_REP_CENTROID,
    GROUP_REP_PREFIX,
    LEFT_PREFIX,
    MOST_SIMILAR_PREFIX,
    RIGHT_PREFIX,
)
from .ops.connected_components import connected_components


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


def assemble_nearest_matches(
    master: pd.Series,
    duplicates: pd.Series,
    master_id: Optional[pd.Series],
    duplicates_id: Optional[pd.Series],
    matches_list: pd.DataFrame,
    ignore_index: bool,
    replace_na: bool,
) -> Union[pd.DataFrame, pd.Series]:
    """Top-1 match per duplicate with unmatched-passthrough and NaN/dtype
    repair (reference _get_nearest_matches, string_grouper.py:783-849)."""
    prefix = MOST_SIMILAR_PREFIX
    master_label = f"{prefix}{master.name if master.name else DEFAULT_MASTER_NAME}"
    master_p = master.rename(master_label).reset_index(drop=ignore_index)
    dupes = duplicates.rename("duplicates").reset_index(drop=ignore_index)

    if isinstance(dupes, pd.DataFrame):
        master_p = master_p.rename(
            columns={
                c: f"{prefix}{c}" for c in master_p.columns if str(c) != master_label
            }
        )

    master_id_label = None
    if master_id is not None:
        master_id_label = (
            f"{prefix}{master_id.name if master_id.name else DEFAULT_MASTER_ID_NAME}"
        )
        master_p = pd.concat(
            [master_p, master_id.rename(master_id_label).reset_index(drop=True)], axis=1
        )
        dupes = pd.concat(
            [dupes, duplicates_id.rename("duplicates_id").reset_index(drop=True)], axis=1
        )

    # Highest similarity per duplicate; ties go to the smallest master index
    # (reference :803-807).
    best = matches_list.groupby("dupe_side").agg({"similarity": "max"}).reset_index()
    best = best.merge(matches_list, on=["dupe_side", "similarity"])
    best = best.groupby(["dupe_side"]).agg({"master_side": "min"}).reset_index()

    # Keep unmatched duplicates (outer), then attach master strings (left).
    best = best.merge(dupes, left_on="dupe_side", right_index=True, how="outer")
    best = best.merge(master_p, left_on="master_side", right_index=True, how="left")

    # Unmatched rows fall back to the duplicate string itself (:815-817).
    rows_to_update = best[master_label].isnull()
    best.loc[rows_to_update, master_label] = best[rows_to_update].duplicates
    if master_id is not None:
        best.loc[rows_to_update, master_id_label] = best[rows_to_update].duplicates_id
        # Undo pandas' NaN-driven dtype upcast when possible (:822-827).
        if (
            best[master_id_label].dtype != master_id.dtype
            and duplicates_id.dtype == master_id.dtype
        ):
            best[master_id_label] = best[master_id_label].astype(master_id.dtype)

    required = [master_label] if master_id is None else [master_id_label, master_label]
    index_cols: List = (
        [c for c in master_p.columns if c not in required]
        if isinstance(master_p, pd.DataFrame)
        else []
    )
    if replace_na:
        dupes_index_cols = [
            c for c in dupes.columns if str(c) not in ("duplicates", "duplicates_id")
        ]
        best.loc[rows_to_update, index_cols] = best.loc[
            rows_to_update, dupes_index_cols
        ].values
        for m, d in zip(index_cols, dupes_index_cols):
            if best[m].dtype != master_p[m].dtype and dupes[d].dtype == master_p[m].dtype:
                best[m] = best[m].astype(master_p[m].dtype)

    best = best.sort_values("dupe_side").set_index("dupe_side")
    output = best[index_cols + required]
    output.index = duplicates.index
    return output.squeeze(axis=1)


def group_representatives(
    matches_list: pd.DataFrame, n: int, group_rep: str, device
) -> np.ndarray:
    """Positional index of each row's group representative.

    Connected components come from ``ops.connected_components`` (the torch
    op runs on ``device`` when the native library is absent); the
    representative rule reproduces the reference exactly
    (string_grouper.py:863-886):
      'first'    -- smallest positional index in the component;
      'centroid' -- largest per-row sum of match similarities, ties to the
                    smallest positional index (pandas idxmax semantics).
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rows = matches_list.master_side.to_numpy()
    cols = matches_list.dupe_side.to_numpy()
    labels = connected_components(rows, cols, n, device)

    pos = np.arange(n, dtype=np.int64)
    if group_rep == GROUP_REP_CENTROID:
        weight = np.bincount(
            rows, weights=matches_list.similarity.to_numpy(dtype=np.float64), minlength=n
        )
        order = np.lexsort((pos, -weight, labels))
    else:  # 'first'
        order = np.lexsort((pos, labels))
    lab_sorted = labels[order]
    firsts_mask = np.r_[True, lab_sorted[1:] != lab_sorted[:-1]]
    rep_rows = order[firsts_mask]  # representative position per group
    rep_of_label = np.zeros(n, dtype=np.int64)
    rep_of_label[lab_sorted[firsts_mask]] = rep_rows
    return rep_of_label[labels]


def assemble_groups(
    master: pd.Series,
    master_id: Optional[pd.Series],
    matches_list: pd.DataFrame,
    ignore_index: bool,
    group_rep: str,
    device,
) -> Union[pd.DataFrame, pd.Series]:
    """Group-representative output (reference _deduplicate,
    string_grouper.py:851-904)."""
    n = len(master)
    rep = group_representatives(matches_list, n, group_rep, device)

    prefix = GROUP_REP_PREFIX
    label = f"{prefix}{master.name}" if master.name else prefix[:-1]
    entries = []
    if master_id is not None:
        id_label = f"{prefix}{master_id.name if master_id.name else DEFAULT_ID_NAME}"
        entries.append((id_label, _take_values(master_id.array, rep)))
    if not ignore_index:
        idx = master.index
        if isinstance(idx, pd.MultiIndex):
            for li in range(idx.nlevels):
                lname = idx.names[li] if idx.names[li] is not None else f"level_{li}"
                entries.append(
                    (f"{prefix}{lname}", idx.get_level_values(li).to_numpy()[rep])
                )
        else:
            lname = idx.name if idx.name is not None else "index"
            entries.append((f"{prefix}{lname}", idx.to_numpy()[rep]))
    entries.append((label, _take_values(master.array, rep)))
    if len(entries) == 1:
        return pd.Series(entries[0][1], name=label, index=master.index)
    output = pd.DataFrame(dict(entries), copy=False)
    output.index = master.index
    return output
